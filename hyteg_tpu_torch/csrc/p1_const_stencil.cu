// Kernel B2: per-macro-cell constant-stencil P1 apply on flat blocks.
//
// Replaces hyteg_tpu/kernels/p1_const_stencil.py::p1_const_apply_pallas
// (the whole-cell and row-tiled Pallas kernels). Interface rows hold
// partial sums; the additive exchange follows in the caller.
//
// Bound: device-memory bandwidth. Each output slot reads 15 neighbours of
// one f32 block and writes one f32, so at least 8 B per slot move to or
// from device memory (one read of src, one write of dst); the 15 reads of
// neighbouring lanes and rows hit L1/L2. 30 + 210 weights per cell are
// folded once per block into shared memory. One thread per output slot on
// a grid of (ceil(N*L / 256), C): consecutive threads take consecutive
// lanes, so every load and the store are coalesced. Simple and right
// first; tiling rows through shared memory is later work.
#include <cuda_runtime.h>

#include "p1_const_stencil.cuh"

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
p1_const_apply_kernel(const float* __restrict__ src,
                      const float* __restrict__ A,
                      const float* __restrict__ E,
                      float* __restrict__ dst, int N, int pitch,
                      hyteg::ConstTables t) {
  using namespace hyteg;
  __shared__ float w_in[kConstDirs], w_sh[kConstDirs];
  __shared__ float e_in[kConstGroups * kConstDirs];
  __shared__ float e_sh[kConstGroups * kConstDirs];
  const int c = blockIdx.y;
  const_fold_weights(A + (long long)c * kConstDirs * kConstShells,
                     E + (long long)c * kConstGroups * kConstShells * kConstDirs,
                     w_in, w_sh, e_in, e_sh, threadIdx.x, blockDim.x);
  __syncthreads();
  const int L = N * pitch;
  const long long cell = (long long)N * L;
  const long long q = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (q >= cell) return;
  const int x = (int)(q / L);
  const int lane = (int)(q - (long long)x * L);
  dst[c * cell + q] = const_apply_point(src + c * cell, x, lane, N, pitch, t,
                                        w_in, w_sh, e_in, e_sh);
}

}  // namespace

// dirs: host (15, 3) int32 stencil directions; gmask: host (7,) int32 face
// group bit masks. Returns cudaGetLastError() after the launch.
extern "C" int hyteg_p1_const_apply(const float* src, const float* A,
                                    const float* E, float* dst, int C, int N,
                                    int pitch, const int* dirs,
                                    const int* gmask, void* stream) {
  hyteg::ConstTables t;
  for (int s = 0; s < hyteg::kConstDirs; ++s) {
    t.dx[s] = dirs[3 * s];
    t.dl[s] = dirs[3 * s + 1] * pitch + dirs[3 * s + 2];
  }
  for (int g = 0; g < hyteg::kConstGroups; ++g) t.gmask[g] = gmask[g];
  const long long cell = (long long)N * N * pitch;
  const dim3 grid((unsigned)((cell + kThreads - 1) / kThreads), (unsigned)C);
  p1_const_apply_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      src, A, E, dst, N, pitch, t);
  return (int)cudaGetLastError();
}
