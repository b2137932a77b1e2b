// Kernels B3 and B4 in their 2D form: the partial diagonal (or lumped row
// sum) and the general elementwise P1 apply of one macro-face, each with
// an optional nodal coefficient (arithmetic, harmonic or geometric mean
// over each micro-triangle's 3 vertices).
//
// Replace the dim == 2 branches of
// hyteg_tpu/kernels/p1_stencil.py::p1_diagonal_local_pallas_flat and
// ::p1_apply_local_pallas_flat. The Pallas kernels scatter each (class,
// vertex) row with lane rolls of a VMEM-resident (N, N) block. Here, as in
// the 3D kernels (p1_diag.cu, p1_apply.cu), each output slot gathers the
// same terms from the 6 (class, vertex) element bases around it: no
// atomics, each slot written once, the half of the block outside the
// triangle written 0.
//
// B3-2D (p1_tri.cuh): B4-2D's band walk below. Without a coefficient the
// diagonal at a slot depends only on its edge set and shell flag (the
// class rule, checked in the header): each block folds the 6 weights into
// 8 class values once, and each warp stores its row's values and the zeros
// past the triangle as one store-only run of 16-byte stores, no loads.
// With a coefficient (the mean a template argument) an interior slot
// reads its 7 neighbours' coefficients once, transforms each once and
// forms the 6 means from compile-time lists, with no tests; edge and
// shell slots run the tested diag_point_2d as one list over the block.
// Bound: writing the block (4 B per slot) and, with a coefficient,
// reading it on the triangle. The design this one replaced (one thread
// per slot of the face, a 64-bit division and 6 base tests per slot, the
// mean a run-time branch, a scalar 0 stored by each thread past the
// triangle) took 0.70-0.71 ms without a coefficient at level 11 on an
// H100 (NVIDIA H100 80GB HBM3, 700 W), 23% of its bound.
//
// B4-2D (p1_tri.cuh): one thread block per (face, band of 8 rows), grid
// (C, ceil(N / 8)), the faces' first bands first; a warp per row, lanes
// on consecutive z, row 0 shared by the block's threads, store-only zero
// runs past the triangle, as B2-2D's band walk. A slot off the edges and
// the shell runs one untested sum from compile-time lists, two chunks of
// 32 slots in flight per lane; edge and shell slots run the tested
// p1_apply_point_2d, a call of its own, as one list over the block. The
// mean is a template argument. In the harmonic and geometric means the
// staged form first transforms each coefficient value of a tile of 8
// rows x 256 slots once, in shared memory (1.27 transforms per slot at
// level 11 instead of 7.00), which on the card beat the direct form;
// the arithmetic mean, with no transform to share, runs the direct form.
// Bound: one write of the block plus the reads of src and the
// coefficient on the triangle (0.3209 ms at level 11 on 32 faces at 3.35
// TB/s). The design this one replaced (one thread per slot of the face,
// a 64-bit division and 6 base tests per slot, the mean a run-time
// branch) took 1.42-1.43 ms in the arithmetic mean at level 11 on an
// H100 (NVIDIA H100 80GB HBM3, 700 W).
//
// B3-2D in bf16 (no coefficient, plain or lumped): the same band walk on
// bf16 element matrices and a bf16 block (BF16CellStore in bf16.cuh); the
// entries widen to f32, the weight and class folds stay f32, and each
// class value is rounded to bf16 once on its store. It replaces the
// Pallas kernel run on bf16 element matrices, which writes in their type
// (hyteg_tpu/kernels/p1_stencil.py:303). Its stores are 8-byte quads of
// four bf16 slots from each row's first 8-byte boundary on
// (BF16CellStore::to_aligned; rows of the odd width N alternate their
// alignment), single stores before and after. Bound: writing the block,
// 2 B per slot.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "bf16.cuh"
#include "p1_tri.cuh"

namespace {

constexpr int kElm = hyteg::kTriClasses * hyteg::kTriVerts * hyteg::kTriVerts;

// The staged walks' team on the card: this thread, and the block's
// barrier.
struct BlockTeam {
  template <class F>
  __device__ __forceinline__ void each(F&& fn) {
    fn((int)threadIdx.x);
  }
  __device__ __forceinline__ void sync() { __syncthreads(); }
  __device__ __forceinline__ void fresh(float*, int) {}
};

// B3-2D, thread block (face c, band of rows x0 = blockIdx.y * kApplyR2).
// MODE -1: no coefficient, the 8 class values folded once and
// tri_diag_band stores them; 0-2: the mean of the coefficient,
// tri_diag_band_coeff on the 6 weights. At least 8 blocks per SM (32
// registers), the fastest of 4, 5, 6 and 8 on the card in every mode
// (uncapped, the direct arithmetic kernel took 56 registers and ran 21%
// slower).
template <int MODE>
__global__ void __launch_bounds__(hyteg::kApplyThreads, 8)
p1_diag_2d_kernel(const float* __restrict__ elmats,
                  const float* __restrict__ coeff, float* __restrict__ dst,
                  int N, int lumped) {
  using namespace hyteg;
  __shared__ float w[kTriClasses * kTriVerts];
  __shared__ float cls[kTriDiagRows];
  const int c = blockIdx.x;
  tri_diag_fold_weights(elmats + c * kElm, lumped, w, threadIdx.x,
                        blockDim.x);
  __syncthreads();
  const long long face = (long long)N * N;
  const CellStore out{dst + c * face};
  const int x0 = blockIdx.y * kApplyR2;
  if constexpr (MODE < 0) {
    tri_fold_classes(w, cls, threadIdx.x, blockDim.x);
    __syncthreads();
    tri_diag_band(out, x0, N, cls, threadIdx.x >> 5, threadIdx.x & 31);
  } else {
    __shared__ float gs[tri_apply_staged(MODE) ? kApplyG2 : 1];
    BlockTeam team;
    tri_diag_band_coeff<MODE>(team, coeff + c * face, out, x0, N, w, gs);
  }
}

// B3-2D in bf16, no coefficient: thread block (face c, band of rows x0 =
// blockIdx.y * kApplyR2); the element matrices widen into shared memory,
// then the 6 weights and the 8 class values fold in f32 and
// tri_diag_band stores them rounded once.
__global__ void __launch_bounds__(hyteg::kApplyThreads, 8)
p1_diag_2d_bf16_kernel(const __nv_bfloat16* __restrict__ elmats,
                       __nv_bfloat16* __restrict__ dst, int N, int lumped) {
  using namespace hyteg;
  __shared__ float e_s[kElm];
  __shared__ float w[kTriClasses * kTriVerts];
  __shared__ float cls[kTriDiagRows];
  const int c = blockIdx.x;
  for (int i = threadIdx.x; i < kElm; i += blockDim.x)
    e_s[i] = widen(elmats[c * kElm + i]);
  __syncthreads();
  tri_diag_fold_weights(e_s, lumped, w, threadIdx.x, blockDim.x);
  __syncthreads();
  tri_fold_classes(w, cls, threadIdx.x, blockDim.x);
  __syncthreads();
  const long long face = (long long)N * N;
  tri_diag_band(BF16CellStore{dst + c * face}, blockIdx.y * kApplyR2, N, cls,
                threadIdx.x >> 5, threadIdx.x & 31);
}

template <int MODE>
void launch_diag_2d(const float* elmats, const float* coeff, float* dst,
                    int C, int N, int lumped, cudaStream_t s) {
  const dim3 grid((unsigned)C, (unsigned)((N + hyteg::kApplyR2 - 1) /
                                          hyteg::kApplyR2));
  p1_diag_2d_kernel<MODE><<<grid, hyteg::kApplyThreads, 0, s>>>(
      elmats, coeff, dst, N, lumped);
}

// True when the passed class tables, offs (2, 3, 2) and margins (2,), are
// the compiled kTriOff and kTriMargin.
bool tri_tables_match(const int* offs, const int* margins) {
  using namespace hyteg;
  for (int t = 0; t < kTriClasses; ++t) {
    if (margins[t] != kTriMargin[t]) return false;
    for (int a = 0; a < kTriVerts; ++a)
      for (int d = 0; d < 2; ++d)
        if (offs[(t * kTriVerts + a) * 2 + d] != kTriOff[t][a][d])
          return false;
  }
  return true;
}


// Least blocks per SM each B4-2D kernel is compiled for (caps its
// registers at 65536 / (256 * blocks)), by mode (none, arithmetic:
// direct form; harmonic, geometric: staged form); the fastest of 4, 6
// and 8 on the card.
constexpr int kApplyMinBlocks2D[4] = {6, 6, 8, 8};

// B4-2D, thread block (face c, band of rows x0 = blockIdx.y * kApplyR2).
// MODE -1: no coefficient; 0-2: the mean, in the staged form
// (tri_apply_band_staged) where tri_apply_staged says so, else the direct
// one (tri_apply_band).
template <int MODE>
__global__ void __launch_bounds__(hyteg::kApplyThreads,
                                  kApplyMinBlocks2D[MODE + 1])
p1_apply_2d_kernel(const float* __restrict__ src,
                   const float* __restrict__ coeff,
                   const float* __restrict__ elmats, float* __restrict__ dst,
                   int N) {
  using namespace hyteg;
  __shared__ float elm[kElm];
  const int c = blockIdx.x;
  for (int i = threadIdx.x; i < kElm; i += blockDim.x)
    elm[i] = elmats[c * kElm + i];
  __syncthreads();
  const long long face = (long long)N * N;
  const CellStore out{dst + c * face};
  const int x0 = blockIdx.y * kApplyR2;
  if constexpr (tri_apply_staged(MODE)) {
    __shared__ float gs[kApplyG2];
    BlockTeam team;
    tri_apply_band_staged<MODE>(team, src + c * face, coeff + c * face, out,
                                x0, N, elm, gs);
  } else {
    tri_apply_band<MODE>(src + c * face,
                         MODE < 0 ? nullptr : coeff + c * face, out, x0, N,
                         elm, threadIdx.x >> 5, threadIdx.x & 31);
  }
}

template <int MODE>
void launch_apply_2d(const float* src, const float* coeff,
                     const float* elmats, float* dst, int C, int N,
                     cudaStream_t s) {
  const dim3 grid((unsigned)C, (unsigned)((N + hyteg::kApplyR2 - 1) /
                                          hyteg::kApplyR2));
  p1_apply_2d_kernel<MODE><<<grid, hyteg::kApplyThreads, 0, s>>>(
      src, coeff, elmats, dst, N);
}

}  // namespace

// offs: host (2, 3, 2) int32 class vertex offsets and margins: host (2,)
// int32, which must equal the kernel's compile-time kTriOff and
// kTriMargin (else cudaErrorInvalidValue, nothing launched); coeff may be
// null (then mode is ignored). Returns cudaGetLastError() after the
// launch.
extern "C" int hyteg_p1_diag_2d(const float* elmats, const float* coeff,
                                float* dst, int C, int N, int lumped, int mode,
                                const int* offs, const int* margins,
                                void* stream) {
  if (!tri_tables_match(offs, margins)) return (int)cudaErrorInvalidValue;
  if (coeff && (mode < 0 || mode > 2)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (!coeff)
    launch_diag_2d<-1>(elmats, coeff, dst, C, N, lumped, s);
  else if (mode == 0)
    launch_diag_2d<0>(elmats, coeff, dst, C, N, lumped, s);
  else if (mode == 1)
    launch_diag_2d<1>(elmats, coeff, dst, C, N, lumped, s);
  else
    launch_diag_2d<2>(elmats, coeff, dst, C, N, lumped, s);
  return (int)cudaGetLastError();
}

// The bf16 form of B3-2D: elmats (C, 2, 3, 3) and dst (C, N, N) bf16, no
// coefficient; offs and margins as above.
extern "C" int hyteg_p1_diag_2d_bf16(const void* elmats, void* dst, int C,
                                     int N, int lumped, const int* offs,
                                     const int* margins, void* stream) {
  if (!tri_tables_match(offs, margins)) return (int)cudaErrorInvalidValue;
  const dim3 grid((unsigned)C, (unsigned)((N + hyteg::kApplyR2 - 1) /
                                          hyteg::kApplyR2));
  p1_diag_2d_bf16_kernel<<<grid, hyteg::kApplyThreads, 0,
                           (cudaStream_t)stream>>>(
      static_cast<const __nv_bfloat16*>(elmats),
      static_cast<__nv_bfloat16*>(dst), N, lumped);
  return (int)cudaGetLastError();
}

// offs: host (2, 3, 2) int32 class vertex offsets and margins: host (2,)
// int32, which must equal the kernel's compile-time kTriOff and
// kTriMargin (else cudaErrorInvalidValue, nothing launched); coeff may be
// null (then mode is ignored). Returns cudaGetLastError() after the
// launch.
extern "C" int hyteg_p1_apply_2d(const float* src, const float* coeff,
                                 const float* elmats, float* dst, int C, int N,
                                 int mode, const int* offs,
                                 const int* margins, void* stream) {
  if (!tri_tables_match(offs, margins)) return (int)cudaErrorInvalidValue;
  if (coeff && (mode < 0 || mode > 2)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (!coeff)
    launch_apply_2d<-1>(src, coeff, elmats, dst, C, N, s);
  else if (mode == 0)
    launch_apply_2d<0>(src, coeff, elmats, dst, C, N, s);
  else if (mode == 1)
    launch_apply_2d<1>(src, coeff, elmats, dst, C, N, s);
  else
    launch_apply_2d<2>(src, coeff, elmats, dst, C, N, s);
  return (int)cudaGetLastError();
}
