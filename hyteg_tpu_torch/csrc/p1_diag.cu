// Kernel B3: per-cell partial diagonal (or lumped row sum) of the P1
// elementwise operator, with an optional nodal coefficient.
//
// Replaces hyteg_tpu/kernels/p1_stencil.py::p1_diagonal_local_pallas_flat.
// The Pallas kernel scatters each (class, vertex) entry with a write roll;
// here one thread per output slot gathers the same entries from the 24
// element bases around it, which needs no atomics and writes each slot
// once. No valid base lies outside the tet, so the two forms agree.
//
// Bound: device-memory bandwidth. Without a coefficient the kernel only
// writes the f32 block (4 B per slot); with one it also reads the
// coefficient block (8 B per slot), the 24 x 4 neighbouring reads hitting
// L1/L2. The 96 element-matrix entries of a cell are folded once per
// block into 24 weights in shared memory.
#include <cuda_runtime.h>

#include "p1_diag.cuh"

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
p1_diag_kernel(const float* __restrict__ elmats,
               const float* __restrict__ coeff, float* __restrict__ dst,
               int N, int pitch, int lumped, int mode, hyteg::DiagTables t) {
  using namespace hyteg;
  __shared__ float w[kClasses * kVerts];
  const int c = blockIdx.y;
  diag_fold_weights(elmats + (long long)c * kClasses * kVerts * kVerts, lumped,
                    w, threadIdx.x, blockDim.x);
  __syncthreads();
  const int L = N * pitch;
  const long long cell = (long long)N * L;
  const long long q = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (q >= cell) return;
  const int x = (int)(q / L);
  const int lane = (int)(q - (long long)x * L);
  dst[c * cell + q] = diag_point(coeff ? coeff + c * cell : nullptr, x, lane,
                                 N, pitch, t, w, mode);
}

}  // namespace

// offs: host (6, 4, 3) int32 class vertex offsets; margins: host (6,)
// int32; coeff may be null (then mode is ignored). Returns
// cudaGetLastError() after the launch.
extern "C" int hyteg_p1_diag(const float* elmats, const float* coeff,
                             float* dst, int C, int N, int pitch, int lumped,
                             int mode, const int* offs, const int* margins,
                             void* stream) {
  hyteg::DiagTables t;
  for (int c = 0; c < hyteg::kClasses; ++c) {
    t.margin[c] = margins[c];
    for (int a = 0; a < hyteg::kVerts; ++a)
      for (int d = 0; d < 3; ++d) t.off[c][a][d] = offs[(c * 4 + a) * 3 + d];
  }
  const long long cell = (long long)N * N * pitch;
  const dim3 grid((unsigned)((cell + kThreads - 1) / kThreads), (unsigned)C);
  p1_diag_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      elmats, coeff, dst, N, pitch, lumped, mode, t);
  return (int)cudaGetLastError();
}
