// Kernel B1: 15-point Kuhn-box stencil apply on one (X, Y*Z) block.
//
// Replaces hyteg_tpu/kernels/box_stencil.py::box_apply_pallas. f32 or
// bf16 storage: loads upcast to f32, weights and the accumulator are f32,
// the store rounds to nearest even in the block dtype.
//
// Bound: bytes. The function reads the block and the (3, 15, L) weights
// once and writes the block once: 8.80 GB at box level 9 (m = 2,
// 1,076,890,625 nodes), 2.63 ms at 3.35 TB/s. The design this one
// replaced (each thread walked 64 rows of one lane, 15 bounds-checked
// loads and 64-bit index math per node, one load in flight) took 10.6 ms
// there on an H100 (NVIDIA H100 80GB HBM3, 700 W): rows x +- 1 were
// loaded three times each, 43% of its time by the dissection ladder.
//
// The design (box_lane_walk and box_apply_thread in box_stencil.cuh): a
// thread block is a tile of 32 z x 8 y lanes and a chunk of rows x; each
// thread walks its lane down the chunk. A row is loaded once per lane, as
// the seven values at lane offsets 0, +-1, +-Z, +-(Z+1) (whether each
// offset stays in [0, L) is decided once per lane), and carried in a
// register ring as row x + 1, then x, then x - 1; the loads of row x + 2
// are issued before the sum of row x. A warp is 32 consecutive z of one
// y and a block's warps are 8 consecutive y, so the +-Z reads of a warp
// are its neighbours' own rows (L1). The 15 interior weights stay in
// registers for the chunk; rows 0 and X - 1 load their class's. On the
// same card: 5.15-5.18 ms at level 9 (51% of the bound), 0.108-0.109 ms
// at level 7 (bound 0.0441), bf16 5.19-5.20 / 0.119-0.125 ms; 64
// registers, 4 blocks of 256 threads per SM. What bounds it now: the
// loads in flight (two rows per thread at 32 warps per SM); the
// dissection ladder puts it 0.43 ms above its one-load lane-walk rung.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "box_stencil.cuh"

namespace {

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

template <typename T>
struct Store {
  T* p;
  __device__ __forceinline__ void operator()(long long i, float v) const;
};
template <>
__device__ __forceinline__ void Store<float>::operator()(long long i,
                                                         float v) const {
  p[i] = v;
}
template <>
__device__ __forceinline__ void Store<__nv_bfloat16>::operator()(
    long long i, float v) const {
  p[i] = __float2bfloat16_rn(v);
}

// ROWS, the chunk's rows, is a compile-time constant: with it a run-time
// parameter the walk took 80 registers instead of 64 (3 blocks per SM
// instead of 4) and 6.4 ms instead of 5.2 at box level 9.
template <typename T, class Load, int ROWS>
__global__ void __launch_bounds__(hyteg::kBoxTileZ * hyteg::kBoxTileY)
box_apply_kernel(const T* __restrict__ u, const float* __restrict__ w,
                 T* __restrict__ y, int X, int Y, int Z) {
  hyteg::box_apply_thread(Load{u}, LoadF32{w}, Store<T>{y}, blockIdx.x,
                          blockIdx.y, blockIdx.z, threadIdx.x, threadIdx.y,
                          ROWS, X, Y, Z);
}

template <typename T, class Load>
void launch(const T* u, const float* w, T* y, int X, int Y, int Z,
            cudaStream_t st) {
  using namespace hyteg;
  const int rows = box_chunk_rows(X);
  const dim3 block(kBoxTileZ, kBoxTileY);
  const dim3 grid((unsigned)((Z + kBoxTileZ - 1) / kBoxTileZ),
                  (unsigned)((Y + kBoxTileY - 1) / kBoxTileY),
                  (unsigned)((X + rows - 1) / rows));
  if (rows == kBoxRows)
    box_apply_kernel<T, Load, kBoxRows><<<grid, block, 0, st>>>(u, w, y, X,
                                                               Y, Z);
  else
    box_apply_kernel<T, Load, 2 * kBoxRows><<<grid, block, 0, st>>>(
        u, w, y, X, Y, Z);
}

}  // namespace

// u, y: (X, Y*Z) blocks of f32 (bf16 == 0) or bf16 (bf16 != 0);
// w: (3, 15, Y*Z) f32. Returns cudaGetLastError() after the launch.
extern "C" int hyteg_box_apply(const void* u, const float* w, void* y, int X,
                               int Y, int Z, int bf16, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (bf16)
    launch<__nv_bfloat16, LoadBF16>((const __nv_bfloat16*)u, w,
                                    (__nv_bfloat16*)y, X, Y, Z, st);
  else
    launch<float, LoadF32>((const float*)u, w, (float*)y, X, Y, Z, st);
  return (int)cudaGetLastError();
}
