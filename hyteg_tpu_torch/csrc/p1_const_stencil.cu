// Kernel B2: per-macro-cell constant-stencil P1 apply on flat blocks, in
// its 3D form (macro-tets) and its 2D form (macro-faces).
//
// Replaces hyteg_tpu/kernels/p1_const_stencil.py::p1_const_apply_pallas
// (the whole-cell and row-tiled Pallas kernels, both dims). Interface
// rows hold partial sums; the additive exchange follows in the caller.
//
// Bound: device-memory bandwidth. Each output slot reads 15 neighbours of
// one f32 block and writes one f32, so at least 8 B per slot move to or
// from device memory (one read of src, one write of dst); the 15 reads of
// neighbouring lanes and rows hit L1/L2. 30 + 210 weights per cell are
// folded once per block into shared memory. One thread per output slot on
// a grid of (ceil(N*L / 256), C): consecutive threads take consecutive
// lanes, so every load and the store are coalesced. Simple and right
// first; tiling rows through shared memory is later work.
//
// 2D: a face block is (N, N) with the lane axis z itself; the triangle
// x + z <= n fills half of it and the other half is written 0. 7 + 7
// weights and 2 x 21 edge corrections per face are folded into shared
// memory the same way; one thread per slot, consecutive threads on
// consecutive z. Bound: bytes again, 8 B per slot (1.07 GB at level 11
// on 32 faces, 0.32 ms at 3.35 TB/s).
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

__global__ void __launch_bounds__(kThreads)
p1_const_apply_2d_kernel(const float* __restrict__ src,
                         const float* __restrict__ A,
                         const float* __restrict__ E,
                         float* __restrict__ dst, int N,
                         hyteg::ConstTables2D t) {
  using namespace hyteg;
  __shared__ float w_in[kConst2Dirs], w_sh[kConst2Dirs];
  __shared__ float e_in[kConst2Groups * kConst2Dirs];
  __shared__ float e_sh[kConst2Groups * kConst2Dirs];
  const int c = blockIdx.y;
  const_fold_weights<kConst2Dirs, kConst2Groups>(
      A + (long long)c * kConst2Dirs * kConstShells,
      E + (long long)c * kConst2Groups * kConstShells * kConst2Dirs, w_in, w_sh,
      e_in, e_sh, threadIdx.x, blockDim.x);
  __syncthreads();
  const long long cell = (long long)N * N;
  const long long q = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (q >= cell) return;
  const int x = (int)(q / N);
  const int z = (int)(q - (long long)x * N);
  dst[c * cell + q] = const_apply_point_2d(src + c * cell, x, z, N, t, w_in,
                                           w_sh, e_in, e_sh);
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

// The 2D form. dirs: host (7, 2) int32 stencil directions; gmask: host
// (3,) int32 edge-group bit masks. Returns cudaGetLastError() after the
// launch.
extern "C" int hyteg_p1_const_apply_2d(const float* src, const float* A,
                                       const float* E, float* dst, int C,
                                       int N, const int* dirs,
                                       const int* gmask, void* stream) {
  hyteg::ConstTables2D t;
  for (int s = 0; s < hyteg::kConst2Dirs; ++s) {
    t.dx[s] = dirs[2 * s];
    t.dz[s] = dirs[2 * s + 1];
  }
  for (int g = 0; g < hyteg::kConst2Groups; ++g) t.gmask[g] = gmask[g];
  const long long cell = (long long)N * N;
  const dim3 grid((unsigned)((cell + kThreads - 1) / kThreads), (unsigned)C);
  p1_const_apply_2d_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      src, A, E, dst, N, t);
  return (int)cudaGetLastError();
}
