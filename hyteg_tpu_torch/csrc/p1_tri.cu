// Kernels B3 and B4 in their 2D form: the partial diagonal (or lumped row
// sum) and the general elementwise P1 apply of one macro-face, each with
// an optional nodal coefficient (arithmetic, harmonic or geometric mean
// over each micro-triangle's 3 vertices).
//
// Replace the dim == 2 branches of
// hyteg_tpu/kernels/p1_stencil.py::p1_diagonal_local_pallas_flat and
// ::p1_apply_local_pallas_flat. The Pallas kernels scatter each (class,
// vertex) row with lane rolls of a VMEM-resident (N, N) block. Here, as in
// the 3D kernels (p1_diag.cu, p1_apply.cu), one thread per output slot
// gathers the same terms from the 6 (class, vertex) element bases around
// it: no atomics, each slot written once, the half of the block outside
// the triangle written 0.
//
// Bound: device-memory bandwidth. B3 writes the block (4 B per slot) and,
// with a coefficient, reads it (8 B); B4 reads src, writes dst and reads
// the coefficient (12 B, 1.61 GB at level 11 on 32 faces, 0.48 ms at 3.35
// TB/s); the neighbour reads hit L1/L2. Per slot in the triangle: 6 base
// tests, for B4 18 multiply-adds, and for the harmonic and geometric means
// 7 divisions or logarithms and 6 divisions or exponentials. The 18
// element-matrix entries of a face sit in shared memory. Grid
// (ceil(N*N / 256), C), consecutive threads on consecutive z.
#include <cuda_runtime.h>

#include "p1_tri.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kElm = hyteg::kTriClasses * hyteg::kTriVerts * hyteg::kTriVerts;

__global__ void __launch_bounds__(kThreads)
p1_diag_2d_kernel(const float* __restrict__ elmats,
                  const float* __restrict__ coeff, float* __restrict__ dst,
                  int N, int lumped, int mode) {
  using namespace hyteg;
  __shared__ float w[kTriClasses * kTriVerts];
  const int c = blockIdx.y;
  tri_diag_fold_weights(elmats + (long long)c * kElm, lumped, w, threadIdx.x,
                        blockDim.x);
  __syncthreads();
  const long long cell = (long long)N * N;
  const long long q = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (q >= cell) return;
  const int x = (int)(q / N);
  const int z = (int)(q - (long long)x * N);
  dst[c * cell + q] =
      diag_point_2d(coeff ? coeff + c * cell : nullptr, x, z, N, w, mode);
}

__global__ void __launch_bounds__(kThreads)
p1_apply_2d_kernel(const float* __restrict__ src,
                   const float* __restrict__ coeff,
                   const float* __restrict__ elmats, float* __restrict__ dst,
                   int N, int mode) {
  __shared__ float elm[kElm];
  const int c = blockIdx.y;
  for (int i = threadIdx.x; i < kElm; i += blockDim.x)
    elm[i] = elmats[(long long)c * kElm + i];
  __syncthreads();
  const long long cell = (long long)N * N;
  const long long q = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (q >= cell) return;
  const int x = (int)(q / N);
  const int z = (int)(q - (long long)x * N);
  dst[c * cell + q] = hyteg::p1_apply_point_2d(
      src + c * cell, coeff ? coeff + c * cell : nullptr, x, z, N, elm, mode);
}

dim3 face_grid(int C, int N) {
  const long long cell = (long long)N * N;
  return dim3((unsigned)((cell + kThreads - 1) / kThreads), (unsigned)C);
}

}  // namespace

// coeff may be null (then mode is ignored). Returns cudaGetLastError()
// after the launch.
extern "C" int hyteg_p1_diag_2d(const float* elmats, const float* coeff,
                                float* dst, int C, int N, int lumped, int mode,
                                void* stream) {
  p1_diag_2d_kernel<<<face_grid(C, N), kThreads, 0, (cudaStream_t)stream>>>(
      elmats, coeff, dst, N, lumped, mode);
  return (int)cudaGetLastError();
}

extern "C" int hyteg_p1_apply_2d(const float* src, const float* coeff,
                                 const float* elmats, float* dst, int C, int N,
                                 int mode, void* stream) {
  p1_apply_2d_kernel<<<face_grid(C, N), kThreads, 0, (cudaStream_t)stream>>>(
      src, coeff, elmats, dst, N, mode);
  return (int)cudaGetLastError();
}
