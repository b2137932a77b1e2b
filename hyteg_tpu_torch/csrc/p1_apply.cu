// Kernel B4: the general elementwise P1 apply of one macro cell, with an
// optional nodal coefficient (arithmetic, harmonic or geometric mean over
// each element's vertices).
//
// Replaces hyteg_tpu/kernels/p1_stencil.py::p1_apply_local_pallas_flat.
// The Pallas kernel scatters the 6 x 4 (class, vertex) rows with 8 read
// rolls and 8 write rolls of a VMEM-resident block. Here one thread per
// output slot gathers the same terms from the 24 element bases around it
// (the gather form of kernel B3, csrc/p1_diag.cu), reading the 15
// neighbouring src values (and coefficient terms) once into registers:
// no atomics, each slot written once. Interface rows hold partial sums;
// the additive exchange follows in the caller.
//
// Bound: device-memory bandwidth, 12 B per slot with a coefficient (read
// src and coeff, write dst), 8 B without; the 15-point neighbourhood
// reads hit L1/L2. Per slot in the tet: 24 base tests, 96 multiply-adds
// and, for the harmonic and geometric means, 15 divisions or logarithms
// and 24 divisions or exponentials. The 96 element-matrix entries of a
// cell sit in shared memory. Grid (ceil(N*L / 256), C), consecutive
// threads on consecutive lanes.
#include <cuda_runtime.h>

#include "p1_apply.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kElm = hyteg::kApplyClasses * hyteg::kApplyVerts *
                     hyteg::kApplyVerts;

__global__ void __launch_bounds__(kThreads)
p1_apply_kernel(const float* __restrict__ src, const float* __restrict__ coeff,
                const float* __restrict__ elmats, float* __restrict__ dst,
                int N, int pitch, int mode) {
  __shared__ float elm[kElm];
  const int c = blockIdx.y;
  for (int i = threadIdx.x; i < kElm; i += blockDim.x)
    elm[i] = elmats[(long long)c * kElm + i];
  __syncthreads();
  const int L = N * pitch;
  const long long cell = (long long)N * L;
  const long long q = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (q >= cell) return;
  const int x = (int)(q / L);
  const int lane = (int)(q - (long long)x * L);
  dst[c * cell + q] = hyteg::p1_apply_point(
      src + c * cell, coeff ? coeff + c * cell : nullptr, x, lane, N, pitch,
      elm, mode);
}

}  // namespace

// coeff may be null (then mode is ignored). Returns cudaGetLastError()
// after the launch.
extern "C" int hyteg_p1_apply(const float* src, const float* coeff,
                              const float* elmats, float* dst, int C, int N,
                              int pitch, int mode, void* stream) {
  const long long cell = (long long)N * N * pitch;
  const dim3 grid((unsigned)((cell + kThreads - 1) / kThreads), (unsigned)C);
  p1_apply_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      src, coeff, elmats, dst, N, pitch, mode);
  return (int)cudaGetLastError();
}
