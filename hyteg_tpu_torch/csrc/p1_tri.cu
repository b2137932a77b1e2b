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
//
// B3-2D and B4-2D in bf16 with a coefficient (B4-2D also without one):
// the same band walks, direct and staged, on a bf16 source, coefficient
// and block (BF16Src, BF16CellStore) and bf16 element matrices widened
// into shared memory; every load widens to f32, the staged tile holds
// the transformed coefficient values in f32, the means and sums stay f32,
// and each result is rounded to bf16 once on its store. Kernels of their
// own beside the f32 ones, which keep their code. They replace the Pallas
// kernels run on bf16 inputs, which cast the element matrices and the
// coefficient to the block's type (hyteg_tpu/kernels/p1_stencil.py:205,
// 218,299). Bound: the f32 kernels' bytes with the block's and the
// coefficient's bytes halved.
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

// B3-2D in bf16: thread block (face c, band of rows x0 = blockIdx.y *
// kApplyR2); the element matrices widen into shared memory, the 6
// weights fold in f32; MODE -1: the 8 class values fold in f32 and
// tri_diag_band stores them rounded once; 0-2: tri_diag_band_coeff on the
// bf16 coefficient, as the f32 kernel.
template <int MODE>
__global__ void __launch_bounds__(hyteg::kApplyThreads, 8)
p1_diag_2d_bf16_kernel(const __nv_bfloat16* __restrict__ elmats,
                       const __nv_bfloat16* __restrict__ coeff,
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
  const long long face = (long long)N * N;
  const BF16CellStore out{dst + c * face};
  const int x0 = blockIdx.y * kApplyR2;
  if constexpr (MODE < 0) {
    tri_fold_classes(w, cls, threadIdx.x, blockDim.x);
    __syncthreads();
    tri_diag_band(out, x0, N, cls, threadIdx.x >> 5, threadIdx.x & 31);
  } else {
    __shared__ float gs[tri_apply_staged(MODE) ? kApplyG2 : 1];
    BlockTeam team;
    tri_diag_band_coeff<MODE>(team, BF16Src{coeff + c * face}, out, x0, N, w,
                              gs);
  }
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

// The kernel of a launcher's table of four (mode -1 .. 2) that runs:
// [0] without a coefficient, else [mode + 1]; -1 (nothing launched) for
// class tables other than the compiled ones or a mode outside 0-2.
int band_kernel(const void* coeff, int mode, const int* offs,
                const int* margins) {
  if (!tri_tables_match(offs, margins)) return -1;
  if (!coeff) return 0;
  return mode < 0 || mode > 2 ? -1 : mode + 1;
}

// The grid of the 2D band walks: (faces, bands of kApplyR2 rows).
dim3 band_grid(int C, int N) {
  return dim3((unsigned)C,
              (unsigned)((N + hyteg::kApplyR2 - 1) / hyteg::kApplyR2));
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

// B4-2D in bf16: the f32 kernel's walk (staged where tri_apply_staged
// says so, else direct) on bf16 storage, the element matrices widened
// into shared memory.
template <int MODE>
__global__ void __launch_bounds__(hyteg::kApplyThreads,
                                  kApplyMinBlocks2D[MODE + 1])
p1_apply_2d_bf16_kernel(const __nv_bfloat16* __restrict__ src,
                        const __nv_bfloat16* __restrict__ coeff,
                        const __nv_bfloat16* __restrict__ elmats,
                        __nv_bfloat16* __restrict__ dst, int N) {
  using namespace hyteg;
  __shared__ float elm[kElm];
  const int c = blockIdx.x;
  for (int i = threadIdx.x; i < kElm; i += blockDim.x)
    elm[i] = widen(elmats[c * kElm + i]);
  __syncthreads();
  const long long face = (long long)N * N;
  const BF16CellStore out{dst + c * face};
  const int x0 = blockIdx.y * kApplyR2;
  if constexpr (tri_apply_staged(MODE)) {
    __shared__ float gs[kApplyG2];
    BlockTeam team;
    tri_apply_band_staged<MODE>(team, BF16Src{src + c * face},
                                BF16Src{coeff + c * face}, out, x0, N, elm,
                                gs);
  } else {
    tri_apply_band<MODE>(BF16Src{src + c * face},
                         MODE < 0 ? BF16Src{} : BF16Src{coeff + c * face},
                         out, x0, N, elm, threadIdx.x >> 5, threadIdx.x & 31);
  }
}

}  // namespace

// offs: host (2, 3, 2) int32 class vertex offsets and margins: host (2,)
// int32, which must equal the kernel's compile-time kTriOff and
// kTriMargin (else cudaErrorInvalidValue, nothing launched); coeff may be
// null (then mode is ignored). Each launcher returns cudaGetLastError()
// after the launch.
extern "C" int hyteg_p1_diag_2d(const float* elmats, const float* coeff,
                                float* dst, int C, int N, int lumped, int mode,
                                const int* offs, const int* margins,
                                void* stream) {
  const int k = band_kernel(coeff, mode, offs, margins);
  if (k < 0) return (int)cudaErrorInvalidValue;
  static void (*const kernels[4])(const float*, const float*, float*, int,
                                  int) = {
      p1_diag_2d_kernel<-1>, p1_diag_2d_kernel<0>, p1_diag_2d_kernel<1>,
      p1_diag_2d_kernel<2>};
  kernels[k]<<<band_grid(C, N), hyteg::kApplyThreads, 0,
               (cudaStream_t)stream>>>(elmats, coeff, dst, N, lumped);
  return (int)cudaGetLastError();
}

// The bf16 form of B3-2D: elmats (C, 2, 3, 3), coeff (or null) and dst
// (C, N, N) bf16; the rest as hyteg_p1_diag_2d's.
extern "C" int hyteg_p1_diag_2d_bf16(const void* elmats, const void* coeff,
                                     void* dst, int C, int N, int lumped,
                                     int mode, const int* offs,
                                     const int* margins, void* stream) {
  using B = __nv_bfloat16;
  const int k = band_kernel(coeff, mode, offs, margins);
  if (k < 0) return (int)cudaErrorInvalidValue;
  static void (*const kernels[4])(const B*, const B*, B*, int, int) = {
      p1_diag_2d_bf16_kernel<-1>, p1_diag_2d_bf16_kernel<0>,
      p1_diag_2d_bf16_kernel<1>, p1_diag_2d_bf16_kernel<2>};
  kernels[k]<<<band_grid(C, N), hyteg::kApplyThreads, 0,
               (cudaStream_t)stream>>>(
      static_cast<const B*>(elmats), static_cast<const B*>(coeff),
      static_cast<B*>(dst), N, lumped);
  return (int)cudaGetLastError();
}

// B4-2D: src, coeff (or null), elmats (C, 2, 3, 3), dst; offs and margins
// as above.
extern "C" int hyteg_p1_apply_2d(const float* src, const float* coeff,
                                 const float* elmats, float* dst, int C, int N,
                                 int mode, const int* offs,
                                 const int* margins, void* stream) {
  const int k = band_kernel(coeff, mode, offs, margins);
  if (k < 0) return (int)cudaErrorInvalidValue;
  static void (*const kernels[4])(const float*, const float*, const float*,
                                  float*, int) = {
      p1_apply_2d_kernel<-1>, p1_apply_2d_kernel<0>, p1_apply_2d_kernel<1>,
      p1_apply_2d_kernel<2>};
  kernels[k]<<<band_grid(C, N), hyteg::kApplyThreads, 0,
               (cudaStream_t)stream>>>(src, coeff, elmats, dst, N);
  return (int)cudaGetLastError();
}

// The bf16 form of B4-2D: src, coeff (or null), elmats (C, 2, 3, 3) and
// dst all bf16; the rest as hyteg_p1_apply_2d's.
extern "C" int hyteg_p1_apply_2d_bf16(const void* src, const void* coeff,
                                      const void* elmats, void* dst, int C,
                                      int N, int mode, const int* offs,
                                      const int* margins, void* stream) {
  using B = __nv_bfloat16;
  const int k = band_kernel(coeff, mode, offs, margins);
  if (k < 0) return (int)cudaErrorInvalidValue;
  static void (*const kernels[4])(const B*, const B*, const B*, B*, int) = {
      p1_apply_2d_bf16_kernel<-1>, p1_apply_2d_bf16_kernel<0>,
      p1_apply_2d_bf16_kernel<1>, p1_apply_2d_bf16_kernel<2>};
  kernels[k]<<<band_grid(C, N), hyteg::kApplyThreads, 0,
               (cudaStream_t)stream>>>(
      static_cast<const B*>(src), static_cast<const B*>(coeff),
      static_cast<const B*>(elmats), static_cast<B*>(dst), N);
  return (int)cudaGetLastError();
}
