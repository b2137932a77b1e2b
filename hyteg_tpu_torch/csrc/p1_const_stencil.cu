// Kernel B2: per-macro-cell constant-stencil P1 apply on flat blocks, in
// its 3D form (macro-tets) and its 2D form (macro-faces).
//
// Replaces hyteg_tpu/kernels/p1_const_stencil.py::p1_const_apply_pallas
// (the whole-cell and row-tiled Pallas kernels, both dims). Interface
// rows hold partial sums; the additive exchange follows in the caller.
//
// 3D bound: device-memory bandwidth. The block is written once (412 MB
// at level 7 on 48 cells, 83% of it zeros outside the tet or on padding
// lanes) and the slots a stencil over the tet reads are read once (74
// MB), the 15 neighbour reads hitting L1/L2: 0.1450 ms at 3.35 TB/s
// (chip_smoke.py's bound, simplex_read_bytes). The design this one replaced
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
// x + z <= n fills half of it and the other half is written 0. Bound:
// bytes again, the block written once (537 MB at level 11 on 32 faces)
// and the slots a stencil over the triangle reads read once (269 MB):
// 0.2407 ms at 3.35 TB/s. The design this one replaced (one thread per
// slot, 524,832 blocks of 256 threads at level 11, each folding the
// face's weights from device memory, a 64-bit slot split per thread,
// four bounds tests per tap, a scalar 0 per slot past the triangle) took
// 1.2232-1.2300 ms there on the same card.
//
// The 2D design (const_apply_band_2d in p1_const_stencil.cuh): one
// thread block per (face, band of 8 rows x), grid (C, ceil(N / 8)), the
// faces' first bands (the longest rows) first; a warp per row, row 0
// (all edge) shared by the block's warps; lanes on consecutive z. Slots
// off the edges run one unrolled 7-tap sum with no tests (compile-time
// directions), two chunks of 32 slots in flight per lane, the interior
// or shell weights read from shared memory at each tap; edge slots run
// const_apply_point_2d on the 8 rows the block folds; the half past the
// triangle is a store-only zero run. Rows x +- 1 come from L1: the
// band's warps read them side by side. 31 registers (8 blocks, 64 warps
// per SM): with the 14 weights in registers it took 64 and ran slower.
// It takes 0.4016-0.4068 ms at level 11 on the same card (59-60% of the
// bound).
//
// bf16 (3D): the same kernel on bf16 storage (BF16Src, BF16CellStore in
// bf16.cuh) and bf16 weights A, E; every load widens to f32, the weight
// fold and the 15-tap sums stay f32, and each result is rounded to bf16
// once on its store (B1's bf16 rule). It replaces the Pallas kernel run on
// a bf16 source, which rounds the weights to the source's type
// (hyteg_tpu/kernels/p1_const_stencil.py:721-722).
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "bf16.cuh"
#include "p1_const_stencil.cuh"

namespace {

constexpr int kPlaneThreads = hyteg::kPlaneWarps * 32;

// 3D: thread block (cell c, plane x); const_apply_plane writes the plane.
// T: the storage type of src, A, E and dst (float or __nv_bfloat16).
template <typename T>
__global__ void __launch_bounds__(kPlaneThreads)
p1_const_apply_kernel(const T* __restrict__ src, const T* __restrict__ A,
                      const T* __restrict__ E, T* __restrict__ dst, int N,
                      int pitch, hyteg::ConstTables t) {
  using namespace hyteg;
  constexpr int nA = kConstDirs * kConstShells;
  constexpr int nE = kConstGroups * kConstShells * kConstDirs;
  __shared__ float a_s[nA], e_s[nE];
  __shared__ float rows[kConstRows * kConstDirs];
  const int c = blockIdx.x;
  // one load per thread, all in flight at once; the fold then reads
  // shared memory only
  for (int i = threadIdx.x; i < nA + nE; i += blockDim.x) {
    if (i < nA) a_s[i] = widen(A[c * nA + i]);
    else e_s[i - nA] = widen(E[c * nE + i - nA]);
  }
  __syncthreads();
  const_fold_rows(a_s, e_s, t, rows, threadIdx.x, blockDim.x);
  __syncthreads();
  const long long cell = (long long)N * N * pitch;
  const_apply_plane(Storage<T>::src(src + c * cell),
                    Storage<T>::store(dst + c * cell), blockIdx.y, N, pitch,
                    t, rows, threadIdx.x >> 5, threadIdx.x & 31,
                    blockDim.x >> 5);
}

template <typename T>
int launch_3d(const T* src, const T* A, const T* E, T* dst, int C, int N,
              int pitch, const int* dirs, const int* gmask, void* stream) {
  hyteg::ConstTables t;
  for (int s = 0; s < hyteg::kConstDirs; ++s) {
    t.dx[s] = dirs[3 * s];
    t.dl[s] = dirs[3 * s + 1] * pitch + dirs[3 * s + 2];
  }
  for (int g = 0; g < hyteg::kConstGroups; ++g) t.gmask[g] = gmask[g];
  const dim3 grid((unsigned)C, (unsigned)N);
  p1_const_apply_kernel<T><<<grid, kPlaneThreads, 0, (cudaStream_t)stream>>>(
      src, A, E, dst, N, pitch, t);
  return (int)cudaGetLastError();
}

// 2D: thread block (face c, band of kBandRows2DP1 rows x), the faces'
// first bands (the longest rows) first; the face's 8 folded rows go to
// shared memory, then const_apply_band_2d writes the band.
__global__ void __launch_bounds__(kPlaneThreads, 8)
p1_const_apply_2d_kernel(const float* __restrict__ src,
                         const float* __restrict__ A,
                         const float* __restrict__ E,
                         float* __restrict__ dst, int N,
                         hyteg::ConstTables2D t) {
  using namespace hyteg;
  constexpr int nA = kConst2Dirs * kConstShells;
  constexpr int nE = kConst2Groups * kConstShells * kConst2Dirs;
  __shared__ float a_s[nA], e_s[nE];
  __shared__ float rows[kConst2Rows * kConst2Dirs];
  const int c = blockIdx.x;
  for (int i = threadIdx.x; i < nA + nE; i += blockDim.x) {
    if (i < nA) a_s[i] = A[c * nA + i];
    else e_s[i - nA] = E[c * nE + i - nA];
  }
  __syncthreads();
  const_fold_rows(a_s, e_s, t, rows, threadIdx.x, blockDim.x);
  __syncthreads();
  const long long face = (long long)N * N;
  const_apply_band_2d(src + c * face, CellStore{dst + c * face},
                      blockIdx.y * kBandRows2DP1, N, rows,
                      threadIdx.x >> 5, threadIdx.x & 31, blockDim.x >> 5);
}

}  // namespace

// dirs: host (15, 3) int32 stencil directions; gmask: host (7,) int32 face
// group bit masks. Returns cudaGetLastError() after the launch.
extern "C" int hyteg_p1_const_apply(const float* src, const float* A,
                                    const float* E, float* dst, int C, int N,
                                    int pitch, const int* dirs,
                                    const int* gmask, void* stream) {
  return launch_3d(src, A, E, dst, C, N, pitch, dirs, gmask, stream);
}

// The bf16 form: src, A, E and dst all bf16 (same shapes).
extern "C" int hyteg_p1_const_apply_bf16(const void* src, const void* A,
                                         const void* E, void* dst, int C,
                                         int N, int pitch, const int* dirs,
                                         const int* gmask, void* stream) {
  using B = __nv_bfloat16;
  return launch_3d(static_cast<const B*>(src), static_cast<const B*>(A),
                   static_cast<const B*>(E), static_cast<B*>(dst), C, N,
                   pitch, dirs, gmask, stream);
}

// The 2D form. dirs: host (7, 2) int32 stencil directions, which must
// equal the kernel's compile-time const2_dx, const2_dz (else
// cudaErrorInvalidValue, nothing launched); gmask: host (3,) int32
// edge-group bit masks. Returns cudaGetLastError() after the launch.
extern "C" int hyteg_p1_const_apply_2d(const float* src, const float* A,
                                       const float* E, float* dst, int C,
                                       int N, const int* dirs,
                                       const int* gmask, void* stream) {
  for (int s = 0; s < hyteg::kConst2Dirs; ++s)
    if (dirs[2 * s] != hyteg::const2_dx(s) ||
        dirs[2 * s + 1] != hyteg::const2_dz(s))
      return (int)cudaErrorInvalidValue;
  hyteg::ConstTables2D t;
  for (int g = 0; g < hyteg::kConst2Groups; ++g) t.gmask[g] = gmask[g];
  const int bands = (N + hyteg::kBandRows2DP1 - 1) / hyteg::kBandRows2DP1;
  const dim3 grid((unsigned)C, (unsigned)bands);
  p1_const_apply_2d_kernel<<<grid, kPlaneThreads, 0, (cudaStream_t)stream>>>(
      src, A, E, dst, N, t);
  return (int)cudaGetLastError();
}
