// Kernel B2: per-macro-cell constant-stencil P1 apply on flat blocks, in
// its 3D form (macro-tets) and its 2D form (macro-faces).
//
// Replaces hyteg_tpu/kernels/p1_const_stencil.py::p1_const_apply_pallas
// (the whole-cell and row-tiled Pallas kernels, both dims). Interface
// rows hold partial sums; the additive exchange follows in the caller.
//
// 3D bound: device-memory bandwidth. The block is written once (412 MB
// at level 7 on 48 cells, 83% of it zeros outside the tet or on padding
// lanes) and the tet read once, the 15 neighbour reads hitting L1/L2:
// 0.246 ms at 3.35 TB/s for 8 B per slot. The design this one replaced
// (one thread per slot of the padded block, a 64-bit slot split per
// thread, four bounds tests per tap and the face-group loop inside the
// tap loop) took 1.574 ms on an H100 (NVIDIA H100 80GB HBM3, 700 W): it paid for its
// mapping and its per-slot weight choice, not for bytes.
//
// The design (const_apply_plane in p1_const_stencil.cuh): one thread
// block per (cell, plane x), grid (C, N), the cells' plane 0 (all face)
// first; warps walk the rows (x, y) that meet the tet from z = 0, so a
// row of r slots takes ceil(r / 32) warp chunks whatever the pitch.
// Slots off the coordinate faces (the shell included, on its own row)
// run one unrolled 15-tap sum with no tests; face slots (plane x = 0,
// row y = 0, the z = 0 column) run const_apply_point on the 16 rows the
// block folds into shared memory (faces x shell, the group loop done
// once). Everything past the tet in a row or a plane is a store-only
// zero run with 16-byte stores. Offsets inside a cell are 32-bit. It
// takes 0.33 ms at level 7 on the same card, 1.16 times the dissection
// ladder's copy rung (which reads and writes the whole block): what
// bounds it now is the block's writes and the load latency of each
// warp's chain of row chunks (79 registers: 3 blocks, 24 warps per SM).
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

constexpr int kThreads = 256;                          // 2D
constexpr int kPlaneThreads = hyteg::kPlaneWarps * 32;  // 3D

// 3D: thread block (cell c, plane x); const_apply_plane writes the plane.
__global__ void __launch_bounds__(kPlaneThreads)
p1_const_apply_kernel(const float* __restrict__ src,
                      const float* __restrict__ A,
                      const float* __restrict__ E,
                      float* __restrict__ dst, int N, int pitch,
                      hyteg::ConstTables t) {
  using namespace hyteg;
  constexpr int nA = kConstDirs * kConstShells;
  constexpr int nE = kConstGroups * kConstShells * kConstDirs;
  __shared__ float a_s[nA], e_s[nE];
  __shared__ float rows[kConstRows * kConstDirs];
  const int c = blockIdx.x;
  // one load per thread, all in flight at once; the fold then reads
  // shared memory only
  for (int i = threadIdx.x; i < nA + nE; i += blockDim.x) {
    if (i < nA) a_s[i] = A[c * nA + i];
    else e_s[i - nA] = E[c * nE + i - nA];
  }
  __syncthreads();
  const_fold_rows(a_s, e_s, t, rows, threadIdx.x, blockDim.x);
  __syncthreads();
  const long long cell = (long long)N * N * pitch;
  const_apply_plane(src + c * cell, CellStore{dst + c * cell}, blockIdx.y, N,
                    pitch, t, rows, threadIdx.x >> 5, threadIdx.x & 31,
                    blockDim.x >> 5);
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
  const dim3 grid((unsigned)C, (unsigned)N);
  p1_const_apply_kernel<<<grid, kPlaneThreads, 0, (cudaStream_t)stream>>>(
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
