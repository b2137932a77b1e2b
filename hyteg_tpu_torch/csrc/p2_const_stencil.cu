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
// shell key; kernels/p2_const_stencil.py::p2_folded_weights), so a node
// needs one row and one uniform loop over the 65 directions. Neighbouring
// z lanes alternate parity, so a per-parity direction list would diverge
// inside a warp; the uniform loop skips zero weights with a predicate.
// Interface rows hold partial sums; the additive exchange follows in the
// caller.
//
// Bound: at 8 B per slot (one read of src, one write of dst) the bytes
// allow ~0.25 ms at level 6 on an H100; the 65 reads per node (hitting
// L1/L2) and their bounds tests make it instruction- and load-latency
// bound, like B2 and B6. One thread per node on a grid of
// (ceil(M*L / 256), C): consecutive threads take consecutive lanes, so
// loads and the store are coalesced; the cell's 192 x 65 weights (50 KB)
// are read through the read-only cache, a warp touching 2-4 rows.
//
// 2D: one thread per node of the (M, M) face block, consecutive threads on
// consecutive z; the face's 48 x 19 folded rows (3.6 KB) are staged in
// shared memory once per thread block. Nodes outside the triangle (half
// the block) write 0. Bound: bytes, 8 B per node (1.07 GB at P2 level 10
// on 32 faces, 0.32 ms at 3.35 TB/s); 19 predicated taps per node.
#include <cuda_runtime.h>

#include "p2_const_stencil.cuh"

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
p2_const_apply_kernel(const float* __restrict__ src,
                      const float* __restrict__ W, float* __restrict__ dst,
                      int M, int pitch, hyteg::P2Tables t) {
  using namespace hyteg;
  const int c = blockIdx.y;
  const int L = M * pitch;
  const long long cell = (long long)M * L;
  const long long q = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (q >= cell) return;
  const int x = (int)(q / L);
  const int lane = (int)(q - (long long)x * L);
  const int y = lane / pitch;
  const int z = lane - y * pitch;
  float out = 0.f;
  if (p2_inside(x, y, z, M))
    out = p2_point(src + c * cell, x, lane, M, L, t,
                   W + ((long long)c * kP2Rows + p2_row(x, y, z, M)) * kP2Dirs);
  dst[c * cell + q] = out;
}

__global__ void __launch_bounds__(kThreads)
p2_const_apply_2d_kernel(const float* __restrict__ src,
                         const float* __restrict__ W, float* __restrict__ dst,
                         int M, hyteg::P2Tables2D t) {
  using namespace hyteg;
  __shared__ float w[kP2Rows2D * kP2Dirs2D];
  const int c = blockIdx.y;
  for (int i = threadIdx.x; i < kP2Rows2D * kP2Dirs2D; i += blockDim.x)
    w[i] = W[(long long)c * kP2Rows2D * kP2Dirs2D + i];
  __syncthreads();
  const long long cell = (long long)M * M;
  const long long q = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (q >= cell) return;
  const int x = (int)(q / M);
  const int z = (int)(q - (long long)x * M);
  dst[c * cell + q] = p2_point_2d(src + c * cell, x, z, M, t, w);
}

}  // namespace

// dirs: host (65, 3) int32 stencil directions. Returns cudaGetLastError()
// after the launch.
extern "C" int hyteg_p2_const_apply(const float* src, const float* W,
                                    float* dst, int C, int M, int pitch,
                                    const int* dirs, void* stream) {
  hyteg::P2Tables t;
  for (int s = 0; s < hyteg::kP2Dirs; ++s) {
    t.dx[s] = dirs[3 * s];
    t.dl[s] = dirs[3 * s + 1] * pitch + dirs[3 * s + 2];
  }
  const long long cell = (long long)M * M * pitch;
  const dim3 grid((unsigned)((cell + kThreads - 1) / kThreads), (unsigned)C);
  p2_const_apply_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      src, W, dst, M, pitch, t);
  return (int)cudaGetLastError();
}

// The 2D form. dirs: host (19, 2) int32 stencil directions. Returns
// cudaGetLastError() after the launch.
extern "C" int hyteg_p2_const_apply_2d(const float* src, const float* W,
                                       float* dst, int C, int M,
                                       const int* dirs, void* stream) {
  hyteg::P2Tables2D t;
  for (int s = 0; s < hyteg::kP2Dirs2D; ++s) {
    t.dx[s] = dirs[2 * s];
    t.dz[s] = dirs[2 * s + 1];
  }
  const long long cell = (long long)M * M;
  const dim3 grid((unsigned)((cell + kThreads - 1) / kThreads), (unsigned)C);
  p2_const_apply_2d_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      src, W, dst, M, t);
  return (int)cudaGetLastError();
}
