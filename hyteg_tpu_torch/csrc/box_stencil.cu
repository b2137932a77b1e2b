// Kernel B1: 15-point Kuhn-box stencil apply on one (X, Y*Z) block.
//
// Replaces hyteg_tpu/kernels/box_stencil.py::box_apply_pallas. f32 or
// bf16 storage: loads upcast to f32, weights and the accumulator are f32,
// the store rounds to nearest even in the block dtype.
//
// Traffic: each node reads one block value and writes one (8 B in f32,
// 4 B in bf16); its 14 neighbour reads are meant to hit L1/L2, since a
// thread walks down the rows of one lane and the threads of a warp take
// consecutive lanes. The naive one-thread-per-node mapping would also
// re-read 15 f32 weights (60 B) per node. Here each thread keeps its lane's
// 15 interior weights in registers for a tile of kRows rows, so the
// weights cost 60 B per lane per tile (~12% over the f32 floor at
// kRows = 64), and loads the row-0 / row-(X-1) weights only at those rows.
//
// Bound, as measured on an H100: not bandwidth. The kernel moves its bytes
// at ~27% of the stream-copy rate, and bf16 storage (half the bytes) is no
// faster than f32. Load latency and instruction count (15 bounds-checked
// loads and 64-bit index math per node) are the suspects. Simple and right
// first: computing the weights in the kernel from the 96 element-matrix
// entries and the lane masks, or sharing rows through shared memory, is
// later work.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "box_stencil.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kRows = 64;

struct LoadF32 {
  const float* p;
  __device__ __forceinline__ float operator()(long long i) const {
    return __ldg(p + i);
  }
};

struct LoadBF16 {
  const __nv_bfloat16* p;
  __device__ __forceinline__ float operator()(long long i) const {
    return __bfloat162float(p[i]);
  }
};

__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

template <typename T, class Load>
__global__ void __launch_bounds__(kThreads)
box_apply_kernel(const T* __restrict__ u, const float* __restrict__ w,
                 T* __restrict__ y, int X, int L, int Z) {
  using namespace hyteg;
  const int lane = blockIdx.x * blockDim.x + threadIdx.x;
  if (lane >= L) return;
  const int x0 = blockIdx.y * kRows;
  const int x1 = min(x0 + kRows, X);
  const Load load{u};
  const LoadF32 load_w{w};
  float wi[kBoxDirs];
  box_load_weights(load_w, wi, 0, lane, L);
  for (int x = x0; x < x1; ++x) {
    const int c = box_row_class(x, X);
    float acc;
    if (c != 0) {
      float wb[kBoxDirs];
      box_load_weights(load_w, wb, c, lane, L);
      acc = box_point(load, wb, x, lane, X, L, Z);
    } else {
      acc = box_point(load, wi, x, lane, X, L, Z);
    }
    store(y + (long long)x * L + lane, acc);
  }
}

}  // namespace

// u, y: (X, Y*Z) blocks of f32 (bf16 == 0) or bf16 (bf16 != 0);
// w: (3, 15, Y*Z) f32. Returns cudaGetLastError() after the launch.
extern "C" int hyteg_box_apply(const void* u, const float* w, void* y, int X,
                               int Y, int Z, int bf16, void* stream) {
  const int L = Y * Z;
  const dim3 grid((unsigned)((L + kThreads - 1) / kThreads),
                  (unsigned)((X + kRows - 1) / kRows));
  cudaStream_t st = (cudaStream_t)stream;
  if (bf16) {
    box_apply_kernel<__nv_bfloat16, LoadBF16><<<grid, kThreads, 0, st>>>(
        (const __nv_bfloat16*)u, w, (__nv_bfloat16*)y, X, L, Z);
  } else {
    box_apply_kernel<float, LoadF32><<<grid, kThreads, 0, st>>>(
        (const float*)u, w, (float*)y, X, L, Z);
  }
  return (int)cudaGetLastError();
}
