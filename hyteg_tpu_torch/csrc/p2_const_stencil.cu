// Kernel B5: per-macro-cell parity-resolved P2 constant-stencil apply on
// the level-(L+1) node grid, in its 3D form (macro-tets) and its 2D form
// (macro-faces).
//
// Replaces hyteg_tpu/kernels/p2_const_stencil.py::p2_const_apply_pallas
// (both dims).
// The Pallas kernel walks 8-row tiles with the previous and next tile for
// x shifts of 2, rolls lanes, keeps per-parity and per-face-group
// accumulators and confines the face groups to sub-slices: a shape made
// for VMEM and (8, 128) tiles. Here the tables A and E are folded once per
// operator into one row of 65 weights per node class (face set, parity,
// shell key; kernels/p2_const_stencil.py::p2_folded_weights). Interface
// rows hold partial sums; the additive exchange follows in the caller.
//
// 3D bound: bytes allow 0.247 ms at level 6 (8 B per slot of the
// (48, 129, 16641) block at 3.35 TB/s). The design this one replaced
// (one thread per slot of the padded block, a row index per node, all 65
// weights of the row through the read-only cache and a 65-iteration loop
// predicated on ws != 0 and four bounds tests; 28.75 taps per node are
// structurally nonzero) took 2.489 ms on an H100 (NVIDIA H100 80GB HBM3,
// 700 W).
//
// The design (p2_const_apply_plane in p2_const_stencil.cuh): one thread
// block per (cell, plane x), grid (C, M); warps walk the rows (x, y) that
// meet the tet, a lane taking the node pair (odd z, even z) so that a
// warp needs the same two parity rows, 4 (x&1) + 2 (y&1) + {1, 0}. Each
// parity's structurally nonzero directions are compile-time lists
// (kP2TapList, from _nz_tables(3)), so a node off the coordinate faces
// runs its parity's 19 to 65 taps unrolled, with no tests and no weight
// check, on its row of the 24 (face set 0) staged in shared memory. Face
// nodes (plane x = 0, row y = 0, the z = 0 column) run the same lists
// with each read tested, on their own row of W; the z = 0 column is
// ordered odd y, then even y, so a warp mostly holds one parity.
// Everything past the tet is a store-only zero run with 16-byte stores.
// It takes 0.535 ms at level 6 on the same card. What bounds it now: L1
// wavefronts (a pair's lanes sit 2 apart, so a warp's load spans 64
// floats for 32 values) and the load latency of a warp's row chain (128
// registers: 2 blocks, 16 warps per SM).
//
// 2D bound: bytes, the (32, 2049, 2049) block written once and the slots
// a stencil over the triangle reads (0.2409 ms at P2 level 10 at 3.35
// TB/s). The design this one replaced (one thread per slot of the face
// block, a 64-bit slot split, 19 predicated taps per node on a per-node
// row, a scalar 0 for each of the half of the slots past the triangle)
// took 1.84 ms there on the same card.
//
// The 2D design (p2_const_apply_band_2d): one thread block per (band of
// 16 rows x, face), grid (ceil(M / 16), C); each warp takes one even and
// one odd row of the band; a lane takes the node pair (odd z, even z), so
// a warp runs two compile-time parity lists (kP2TapList2D, from
// _nz_tables(2)) with their shell-key-2 weights in registers. A pair off
// the faces reads each of rows x - 2 .. x + 2 as one window of 8-byte
// loads (which of the window's ends sits at an 8-byte boundary is a
// compile-time case of the row: M is odd, so it alternates) and stores
// with one 8-byte store where dst allows; the last two nodes of a row
// (shell keys 1, 0) and the face nodes (row 0, column 0) run the lists on
// their own rows, each read tested on the faces. Slots past the triangle
// are a store-only zero run. It takes 0.461-0.465 ms at level 10 (52% of
// the bound) on the same card, 64 registers, 4 blocks per SM.
//
// bf16 (both forms): the same walks, in kernels of their own, on bf16
// storage and bf16 weights W (BF16Src, BF16CellStore in bf16.cuh); every
// load widens to f32, the
// staged rows and every sum stay f32, and each result is rounded to bf16
// once on its store (B1's bf16 rule). It replaces the Pallas kernel run
// on a bf16 source, which rounds the tables to the source's type
// (hyteg_tpu/kernels/p2_const_stencil.py:409-410). Offsets are counted
// in elements, never bytes: the 3D grid's odd pitch (129) makes bf16 rows
// alternate their 4-byte alignment, which no access assumes; B5-2D's pair
// windows read pairs of elements, one 4-byte load in bf16 (an 8-byte one
// in f32), each starting where p2_pair_parity says the row allows; pair
// stores are 4 bytes and quads (the zero runs) 8, both at boundaries
// BF16CellStore::to_aligned finds. Bound: bytes, the f32 kernel's count
// with the block's bytes halved.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "bf16.cuh"
#include "p2_const_stencil.cuh"

namespace {

constexpr int kPlaneThreads = hyteg::kPlaneWarps * 32;

// 3D: thread block (cell c, plane x); p2_const_apply_plane writes the
// plane, with the cell's 24 rows off the faces staged in shared memory.
__global__ void __launch_bounds__(kPlaneThreads)
p2_const_apply_kernel(const float* __restrict__ src,
                      const float* __restrict__ W, float* __restrict__ dst,
                      int M, int pitch) {
  using namespace hyteg;
  constexpr int nR = 24 * kP2Dirs;  // rows par * 3 + k: face set 0
  __shared__ float wr[nR];
  const int c = blockIdx.x;
  const float* Wc = W + c * kP2Rows * kP2Dirs;
  for (int i = threadIdx.x; i < nR; i += blockDim.x) wr[i] = Wc[i];
  __syncthreads();
  const long long cell = (long long)M * M * pitch;
  p2_const_apply_plane(src + c * cell, Wc, wr, CellStore{dst + c * cell},
                       blockIdx.y, M, pitch, threadIdx.x >> 5,
                       threadIdx.x & 31, blockDim.x >> 5);
}

// The 3D bf16 form: the same walk on bf16 storage, the staged rows
// widened, face nodes reading their bf16 rows of W where it lies. A
// kernel of its own, not a template of the f32 one: the f32 kernel
// instantiated from a template on the storage type ran 9% slower
// (0.586-0.598 ms against 0.537-0.545 at P2 level 6 on an H100, NVIDIA
// H100 80GB HBM3, 700 W).
__global__ void __launch_bounds__(kPlaneThreads)
p2_const_apply_bf16_kernel(const __nv_bfloat16* __restrict__ src,
                           const __nv_bfloat16* __restrict__ W,
                           __nv_bfloat16* __restrict__ dst, int M,
                           int pitch) {
  using namespace hyteg;
  constexpr int nR = 24 * kP2Dirs;
  __shared__ float wr[nR];
  const int c = blockIdx.x;
  const __nv_bfloat16* Wc = W + c * kP2Rows * kP2Dirs;
  for (int i = threadIdx.x; i < nR; i += blockDim.x) wr[i] = widen(Wc[i]);
  __syncthreads();
  const long long cell = (long long)M * M * pitch;
  p2_const_apply_plane(BF16Src{src + c * cell}, BF16Src{Wc}, wr,
                       BF16CellStore{dst + c * cell}, blockIdx.y, M, pitch,
                       threadIdx.x >> 5, threadIdx.x & 31, blockDim.x >> 5);
}

// 2D: thread block (band of kBandRows2D rows x, face c); the face's 48
// folded rows are staged in shared memory, then p2_const_apply_band_2d
// writes the band.
__global__ void __launch_bounds__(kPlaneThreads)
p2_const_apply_2d_kernel(const float* __restrict__ src,
                         const float* __restrict__ W, float* __restrict__ dst,
                         int M) {
  using namespace hyteg;
  constexpr int nW = kP2Rows2D * kP2Dirs2D;
  __shared__ float w[nW];
  const int c = blockIdx.y;
  for (int i = threadIdx.x; i < nW; i += blockDim.x) w[i] = W[c * nW + i];
  __syncthreads();
  const long long face = (long long)M * M;
  p2_const_apply_band_2d(src + c * face, w, CellStore{dst + c * face},
                         blockIdx.x * kBandRows2D, M, threadIdx.x >> 5,
                         threadIdx.x & 31);
}

// The 2D bf16 form (a kernel of its own, as the 3D one): the rows staged
// widened, the band walk on bf16 storage.
__global__ void __launch_bounds__(kPlaneThreads)
p2_const_apply_2d_bf16_kernel(const __nv_bfloat16* __restrict__ src,
                              const __nv_bfloat16* __restrict__ W,
                              __nv_bfloat16* __restrict__ dst, int M) {
  using namespace hyteg;
  constexpr int nW = kP2Rows2D * kP2Dirs2D;
  __shared__ float w[nW];
  const int c = blockIdx.y;
  for (int i = threadIdx.x; i < nW; i += blockDim.x)
    w[i] = widen(W[c * nW + i]);
  __syncthreads();
  const long long face = (long long)M * M;
  p2_const_apply_band_2d(BF16Src{src + c * face}, w,
                         BF16CellStore{dst + c * face},
                         blockIdx.x * kBandRows2D, M, threadIdx.x >> 5,
                         threadIdx.x & 31);
}

bool dirs_match_3d(const int* dirs) {
  for (int s = 0; s < hyteg::kP2Dirs; ++s)
    for (int d = 0; d < 3; ++d)
      if (dirs[3 * s + d] != hyteg::kP2DirList[s][d]) return false;
  return true;
}

bool dirs_match_2d(const int* dirs) {
  for (int s = 0; s < hyteg::kP2Dirs2D; ++s)
    for (int d = 0; d < 2; ++d)
      if (dirs[2 * s + d] != hyteg::kP2DirList2D[s][d]) return false;
  return true;
}

dim3 grid_2d(int C, int M) {
  return dim3((unsigned)((M + hyteg::kBandRows2D - 1) / hyteg::kBandRows2D),
              (unsigned)C);
}

}  // namespace

// dirs: host (65, 3) int32 stencil directions, which must equal the
// kernel's compile-time kP2DirList (else cudaErrorInvalidValue, nothing
// launched). Returns cudaGetLastError() after the launch.
extern "C" int hyteg_p2_const_apply(const float* src, const float* W,
                                    float* dst, int C, int M, int pitch,
                                    const int* dirs, void* stream) {
  if (!dirs_match_3d(dirs)) return (int)cudaErrorInvalidValue;
  const dim3 grid((unsigned)C, (unsigned)M);
  p2_const_apply_kernel<<<grid, kPlaneThreads, 0, (cudaStream_t)stream>>>(
      src, W, dst, M, pitch);
  return (int)cudaGetLastError();
}

// The bf16 form: src, W and dst all bf16 (same shapes).
extern "C" int hyteg_p2_const_apply_bf16(const void* src, const void* W,
                                         void* dst, int C, int M, int pitch,
                                         const int* dirs, void* stream) {
  using B = __nv_bfloat16;
  if (!dirs_match_3d(dirs)) return (int)cudaErrorInvalidValue;
  const dim3 grid((unsigned)C, (unsigned)M);
  p2_const_apply_bf16_kernel<<<grid, kPlaneThreads, 0,
                               (cudaStream_t)stream>>>(
      static_cast<const B*>(src), static_cast<const B*>(W),
      static_cast<B*>(dst), M, pitch);
  return (int)cudaGetLastError();
}

// The 2D form. dirs: host (19, 2) int32 stencil directions, which must
// equal the kernel's compile-time kP2DirList2D (else
// cudaErrorInvalidValue, nothing launched). Returns cudaGetLastError()
// after the launch.
extern "C" int hyteg_p2_const_apply_2d(const float* src, const float* W,
                                       float* dst, int C, int M,
                                       const int* dirs, void* stream) {
  if (!dirs_match_2d(dirs)) return (int)cudaErrorInvalidValue;
  p2_const_apply_2d_kernel<<<grid_2d(C, M), kPlaneThreads, 0,
                             (cudaStream_t)stream>>>(src, W, dst, M);
  return (int)cudaGetLastError();
}

// The 2D bf16 form: src, W and dst all bf16 (same shapes).
extern "C" int hyteg_p2_const_apply_2d_bf16(const void* src, const void* W,
                                            void* dst, int C, int M,
                                            const int* dirs, void* stream) {
  using B = __nv_bfloat16;
  if (!dirs_match_2d(dirs)) return (int)cudaErrorInvalidValue;
  p2_const_apply_2d_bf16_kernel<<<grid_2d(C, M), kPlaneThreads, 0,
                                  (cudaStream_t)stream>>>(
      static_cast<const B*>(src), static_cast<const B*>(W),
      static_cast<B*>(dst), M);
  return (int)cudaGetLastError();
}
