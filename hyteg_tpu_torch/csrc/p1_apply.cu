// Kernel B4: the general elementwise P1 apply of one macro cell, with an
// optional nodal coefficient (arithmetic, harmonic or geometric mean over
// each element's vertices).
//
// Replaces hyteg_tpu/kernels/p1_stencil.py::p1_apply_local_pallas_flat.
// The Pallas kernel scatters the 6 x 4 (class, vertex) rows with 8 read
// rolls and 8 write rolls of a VMEM-resident block. Here each output slot
// gathers the same terms from the 24 element bases around it (the gather
// form of kernel B3): no atomics, each slot written once. Interface rows
// hold partial sums; the additive exchange follows in the caller.
//
// Bound: device-memory bandwidth, one write of the block plus the reads
// of src and the coefficient on the tet's slots (0.1650 ms at level 7 on
// 48 cells at 3.35 TB/s). Per in-tet slot 96 multiply-adds, 24 means of 4
// terms and, in the harmonic and geometric means, a division or a
// logarithm per transform and a division or an exponential per mean.
//
// The design (p1_apply.cuh): one thread block per (cell, plane x), grid
// (C, N), the cells' plane 0 first, warps on the tet's rows from z = 0
// and store-only zero runs past the tet and on padding lanes, as B2's and
// B3's plane walks. The mean is a template argument. A slot off the faces
// and the shell runs one untested sum from compile-time neighbour and
// vertex lists: its 15 neighbours read once, each coefficient value
// transformed once, its 24 means formed from its registers; the 96
// element-matrix entries sit in shared memory and are read as 16-byte
// rows where they are used. Face and shell slots run the tested
// p1_apply_point, a call of its own, as one list over the block's
// threads. The design this one replaced (one thread per slot of the
// padded block, 83% of them outside the tet or on padding lanes, 24 base
// tests per slot, the mean a run-time branch) took 2.42-2.44 ms in the
// arithmetic mean at level 7 on an H100 (NVIDIA H100 80GB HBM3, 700 W).
//
// A staged form that transformed each coefficient value of a tile of 8
// rows x 64 slots once, in shared memory (4.78 transforms per in-tet slot
// at level 7 instead of 14.82), ran slower than this one on the card in
// every mean and was dropped (PERF.md, PR 10).
//
// bf16 (p1_apply_bf16_kernel): the same plane walk on a bf16 source,
// coefficient and block (BF16Src, BF16CellStore in bf16.cuh) and bf16
// element matrices, which widen into the shared rows; every load widens
// to f32, the coefficient transforms, means and sums stay f32, and each
// result is rounded to bf16 once on its store. A kernel of its own beside
// the f32 one, which keeps its code. It replaces the Pallas kernel run on
// a bf16 source, which casts the element matrices and the coefficient to
// the source's type (hyteg_tpu/kernels/p1_stencil.py:205,218). Bound: the
// f32 kernel's bytes with the block's bytes halved.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "bf16.cuh"
#include "p1_apply.cuh"

namespace {

constexpr int kElm = hyteg::kClasses * hyteg::kVerts * hyteg::kVerts;

// Least blocks per SM each kernel is compiled for (caps its registers at
// 65536 / (256 * blocks)), by mode (none, arithmetic, harmonic,
// geometric); the fastest of 2, 3 and 4 on the card.
constexpr int kApplyMinBlocks[4] = {3, 3, 4, 4};

// Thread block (cell c, plane x). MODE -1: no coefficient; 0-2: the mean.
template <int MODE>
__global__ void __launch_bounds__(hyteg::kApplyThreads,
                                  kApplyMinBlocks[MODE + 1])
p1_apply_kernel(const float* __restrict__ src, const float* __restrict__ coeff,
                const float* __restrict__ elmats, float* __restrict__ dst,
                int N, int pitch) {
  using namespace hyteg;
  __shared__ __align__(16) float e_s[kElm];
  const int c = blockIdx.x;
  for (int i = threadIdx.x; i < kElm; i += blockDim.x)
    e_s[i] = elmats[c * kElm + i];
  __syncthreads();
  const long long cell = (long long)N * N * pitch;
  apply_plane<MODE>(src + c * cell, MODE < 0 ? nullptr : coeff + c * cell,
                    CellStore{dst + c * cell}, blockIdx.y, N, pitch, e_s,
                    threadIdx.x >> 5, threadIdx.x & 31, blockDim.x >> 5);
}

// The bf16 form: thread block (cell c, plane x), the element matrices
// widened into the shared rows, the walk on bf16 storage. MODE as above.
template <int MODE>
__global__ void __launch_bounds__(hyteg::kApplyThreads,
                                  kApplyMinBlocks[MODE + 1])
p1_apply_bf16_kernel(const __nv_bfloat16* __restrict__ src,
                     const __nv_bfloat16* __restrict__ coeff,
                     const __nv_bfloat16* __restrict__ elmats,
                     __nv_bfloat16* __restrict__ dst, int N, int pitch) {
  using namespace hyteg;
  __shared__ __align__(16) float e_s[kElm];
  const int c = blockIdx.x;
  for (int i = threadIdx.x; i < kElm; i += blockDim.x)
    e_s[i] = widen(elmats[c * kElm + i]);
  __syncthreads();
  const long long cell = (long long)N * N * pitch;
  apply_plane<MODE>(BF16Src{src + c * cell},
                    MODE < 0 ? BF16Src{} : BF16Src{coeff + c * cell},
                    BF16CellStore{dst + c * cell}, blockIdx.y, N, pitch, e_s,
                    threadIdx.x >> 5, threadIdx.x & 31, blockDim.x >> 5);
}

// The launch of kernels[k], k from diag_kernel, on grid (C, N).
template <typename T>
int launch_mode(void (*const (&kernels)[4])(const T*, const T*, const T*, T*,
                                              int, int),
                const T* src, const T* coeff, const T* elmats, T* dst, int C,
                int N, int pitch, int mode, const int* offs,
                const int* margins, void* stream) {
  const int k = hyteg::diag_kernel(coeff, mode, offs, margins);
  if (k < 0) return (int)cudaErrorInvalidValue;
  kernels[k]<<<dim3((unsigned)C, (unsigned)N), hyteg::kApplyThreads, 0,
               (cudaStream_t)stream>>>(src, coeff, elmats, dst, N, pitch);
  return (int)cudaGetLastError();
}

}  // namespace

// offs: host (6, 4, 3) int32 class vertex offsets and margins: host (6,)
// int32, which must equal the kernel's compile-time kDiagOff and
// kDiagMargin (else cudaErrorInvalidValue, nothing launched); coeff may
// be null (then mode is ignored). Returns cudaGetLastError() after the
// launch.
extern "C" int hyteg_p1_apply(const float* src, const float* coeff,
                              const float* elmats, float* dst, int C, int N,
                              int pitch, int mode, const int* offs,
                              const int* margins, void* stream) {
  static void (*const kernels[4])(const float*, const float*, const float*,
                                  float*, int, int) = {
      p1_apply_kernel<-1>, p1_apply_kernel<0>, p1_apply_kernel<1>,
      p1_apply_kernel<2>};
  return launch_mode(kernels, src, coeff, elmats, dst, C, N, pitch, mode,
                     offs, margins, stream);
}

// The bf16 form: src, coeff (or null), elmats (C, 6, 4, 4) and dst all
// bf16; the rest as hyteg_p1_apply's.
extern "C" int hyteg_p1_apply_bf16(const void* src, const void* coeff,
                                   const void* elmats, void* dst, int C,
                                   int N, int pitch, int mode,
                                   const int* offs, const int* margins,
                                   void* stream) {
  using B = __nv_bfloat16;
  static void (*const kernels[4])(const B*, const B*, const B*, B*, int,
                                  int) = {
      p1_apply_bf16_kernel<-1>, p1_apply_bf16_kernel<0>,
      p1_apply_bf16_kernel<1>, p1_apply_bf16_kernel<2>};
  return launch_mode(
      kernels, static_cast<const B*>(src), static_cast<const B*>(coeff),
      static_cast<const B*>(elmats), static_cast<B*>(dst), C, N, pitch, mode,
      offs, margins, stream);
}
