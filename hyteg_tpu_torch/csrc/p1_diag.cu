// Kernel B3: per-cell partial diagonal (or lumped row sum) of the P1
// elementwise operator, with an optional nodal coefficient.
//
// Replaces hyteg_tpu/kernels/p1_stencil.py::p1_diagonal_local_pallas_flat.
// The Pallas kernel scatters each (class, vertex) entry with a write roll;
// here each output slot gathers the same entries from the 24 element bases
// around it, which needs no atomics and writes each slot once. No valid
// base lies outside the tet, so the two forms agree.
//
// Bound: device-memory bandwidth. Without a coefficient the kernel only
// writes the f32 block: 412 MB at level 7 on 48 cells, 0.1230 ms at 3.35
// TB/s. With one it also reads the coefficient on the tet's slots
// (0.1440 ms). The design this one replaced (one thread per slot of the
// padded block, 83% of them outside the tet or on padding lanes, two
// integer splits and 24 base tests per slot, the 96 element-matrix
// entries folded again by every block of 256 threads) took 1.3397-1.3514
// ms without a coefficient on an H100 (NVIDIA H100 80GB HBM3, 700 W).
//
// The design (p1_diag.cuh): one thread block per (cell, plane x), grid
// (C, N), the cells' plane 0 first, warps on the tet's rows from z = 0
// and store-only zero runs past the tet and on padding lanes, as B2's
// plane walk. Without a coefficient the diagonal at an in-tet slot
// depends only on its face set and shell flag (the class rule, proved in
// the header): each block folds the 24 weights into the 16 class values
// once, and each slot stores its class's value, with no loads. With a
// coefficient, a slot off the faces and the shell reads its 15-point
// neighbourhood once, transforms each value once and forms the 24
// element means from compile-time vertex lists with no tests; face and
// shell slots gather with every base tested. A minimum of 4 blocks per
// SM caps the coefficient kernels at 64 registers. At level 7 on the same
// card it takes 0.1821-0.1837 ms without a coefficient (67-68% of the
// bound: the block's writes), and 0.41 / 0.90 / 0.91-0.92 ms in the
// arithmetic / harmonic / geometric mean, none near its byte bound of
// 0.1440 ms; the harmonic and geometric means spend 0.5 ms more than the
// arithmetic one on their 15 transforms and 24 divisions or exponentials
// per slot.
//
// bf16 (no coefficient): the same walk on bf16 element matrices and a
// bf16 block (BF16CellStore in bf16.cuh); the entries widen to f32, the
// 24 weights and 16 class values are folded in f32, and each slot's value
// is rounded to bf16 once on its store. It replaces the Pallas kernel run
// on bf16 element matrices, which writes in their type
// (hyteg_tpu/kernels/p1_stencil.py:303).
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "bf16.cuh"
#include "p1_diag.cuh"

namespace {

constexpr int kPlaneThreads = hyteg::kPlaneWarps * 32;
constexpr int kElm = hyteg::kClasses * hyteg::kVerts * hyteg::kVerts;

// Thread block (cell c, plane x). MODE -1: no coefficient, the 16 class
// values folded once and diag_plane stores them; MODE 0-2: the mean of
// the coefficient, diag_plane_coeff on the 24 weights.
template <int MODE>
__global__ void __launch_bounds__(kPlaneThreads, 4)
p1_diag_kernel(const float* __restrict__ elmats,
               const float* __restrict__ coeff, float* __restrict__ dst,
               int N, int pitch, int lumped) {
  using namespace hyteg;
  __shared__ float e_s[kElm];
  __shared__ float w[kClasses * kVerts];
  __shared__ float cls[kDiagRows];
  const int c = blockIdx.x;
  for (int i = threadIdx.x; i < kElm; i += blockDim.x)
    e_s[i] = elmats[c * kElm + i];
  __syncthreads();
  diag_fold_weights(e_s, lumped, w, threadIdx.x, blockDim.x);
  __syncthreads();
  const long long cell = (long long)N * N * pitch;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if constexpr (MODE < 0) {
    diag_fold_classes(w, cls, threadIdx.x, blockDim.x);
    __syncthreads();
    diag_plane(CellStore{dst + c * cell}, blockIdx.y, N, pitch, cls, warp,
               lane, blockDim.x >> 5);
  } else {
    diag_plane_coeff<MODE>(coeff + c * cell, CellStore{dst + c * cell},
                           blockIdx.y, N, pitch, w, warp, lane,
                           blockDim.x >> 5);
  }
}

// The bf16 form, without a coefficient: thread block (cell c, plane x).
__global__ void __launch_bounds__(kPlaneThreads, 4)
p1_diag_bf16_kernel(const __nv_bfloat16* __restrict__ elmats,
                    __nv_bfloat16* __restrict__ dst, int N, int pitch,
                    int lumped) {
  using namespace hyteg;
  __shared__ float e_s[kElm];
  __shared__ float w[kClasses * kVerts];
  __shared__ float cls[kDiagRows];
  const int c = blockIdx.x;
  for (int i = threadIdx.x; i < kElm; i += blockDim.x)
    e_s[i] = widen(elmats[c * kElm + i]);
  __syncthreads();
  diag_fold_weights(e_s, lumped, w, threadIdx.x, blockDim.x);
  __syncthreads();
  diag_fold_classes(w, cls, threadIdx.x, blockDim.x);
  __syncthreads();
  const long long cell = (long long)N * N * pitch;
  diag_plane(BF16CellStore{dst + c * cell}, blockIdx.y, N, pitch, cls,
             threadIdx.x >> 5, threadIdx.x & 31, blockDim.x >> 5);
}

bool tables_ok(const int* offs, const int* margins) {
  using namespace hyteg;
  for (int t = 0; t < kClasses; ++t) {
    if (margins[t] != kDiagMargin[t]) return false;
    for (int a = 0; a < kVerts; ++a)
      for (int d = 0; d < 3; ++d)
        if (offs[(t * kVerts + a) * 3 + d] != kDiagOff[t][a][d]) return false;
  }
  return true;
}

}  // namespace

// offs: host (6, 4, 3) int32 class vertex offsets and margins: host (6,)
// int32, which must equal the kernel's compile-time kDiagOff and
// kDiagMargin (else cudaErrorInvalidValue, nothing launched); coeff may
// be null (then mode is ignored). Returns cudaGetLastError() after the
// launch.
extern "C" int hyteg_p1_diag(const float* elmats, const float* coeff,
                             float* dst, int C, int N, int pitch, int lumped,
                             int mode, const int* offs, const int* margins,
                             void* stream) {
  using namespace hyteg;
  if (!tables_ok(offs, margins)) return (int)cudaErrorInvalidValue;
  if (coeff && (mode < 0 || mode > 2)) return (int)cudaErrorInvalidValue;
  const dim3 grid((unsigned)C, (unsigned)N);
  cudaStream_t s = (cudaStream_t)stream;
  if (!coeff)
    p1_diag_kernel<-1><<<grid, kPlaneThreads, 0, s>>>(elmats, coeff, dst, N,
                                                      pitch, lumped);
  else if (mode == 0)
    p1_diag_kernel<0><<<grid, kPlaneThreads, 0, s>>>(elmats, coeff, dst, N,
                                                     pitch, lumped);
  else if (mode == 1)
    p1_diag_kernel<1><<<grid, kPlaneThreads, 0, s>>>(elmats, coeff, dst, N,
                                                     pitch, lumped);
  else
    p1_diag_kernel<2><<<grid, kPlaneThreads, 0, s>>>(elmats, coeff, dst, N,
                                                     pitch, lumped);
  return (int)cudaGetLastError();
}

// The bf16 form: elmats (C, 6, 4, 4) and dst bf16, no coefficient; the
// tables as hyteg_p1_diag's. Returns cudaGetLastError() after the launch.
extern "C" int hyteg_p1_diag_bf16(const void* elmats, void* dst, int C, int N,
                                  int pitch, int lumped, const int* offs,
                                  const int* margins, void* stream) {
  if (!tables_ok(offs, margins)) return (int)cudaErrorInvalidValue;
  const dim3 grid((unsigned)C, (unsigned)N);
  p1_diag_bf16_kernel<<<grid, kPlaneThreads, 0, (cudaStream_t)stream>>>(
      static_cast<const __nv_bfloat16*>(elmats),
      static_cast<__nv_bfloat16*>(dst), N, pitch, lumped);
  return (int)cudaGetLastError();
}
