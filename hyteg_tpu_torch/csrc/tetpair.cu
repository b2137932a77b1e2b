// Kernels B6 (fused exchanged apply), B7 (install) and B8 (extract) of the
// paired-tet engine: two macro-tets share one (N, N * P) block, tet A in
// the lower corner, tet B point-reflected into the upper one.
//
// Replace hyteg_tpu/tetpair/kernel.py::pair_apply, ::pair_install and
// ::pair_extract. The Pallas kernels roll whole blocks through VMEM and
// build the per-lane weight vectors with a matmul; here a B6 block walks
// the rows of a 16 x 16 tile of lanes, B7 takes one thread per slot and B8
// one per lane, and the math and B6's walk are in tetpair.cuh.
//
// B6's bound is instructions, not bytes: with the install logic (the
// position class decides whether a value comes from the block or from a
// face array) in each of a point's 15 reads, a one-thread-per-slot B6 took
// 3.5 ms at level 7 on an H100, and 1.5 ms with plain reads. So B6
// installs each value once: a block takes a 16 x 16 tile of lanes (ly, lz)
// of one pair and walks its rows, staging each installed row of the tile
// and its one-lane rim in shared memory (1.27 staged values per output)
// and reading the 15 neighbours from there (0.77 ms; 8 x 32 tiles took
// 0.87 ms). Weights come from the pair's 120 x 7 matrix in shared memory;
// off the y/z faces a weight is one entry of it, the same for the whole
// block. Every slot is written once (0 outside both tets, so the next
// apply reads no garbage); the block is read once from device memory, the
// rim from L2.
#include <cuda_runtime.h>

#include "tetpair.cuh"

namespace {

constexpr int kThreads = 256;  // B7, B8

// pair_apply_tile's team on the card: this thread, its registers, and
// the block's barrier.
struct BlockTeam {
  hyteg::PairTileThread r;
  template <class F>
  __device__ __forceinline__ void each(F&& fn) {
    fn((int)threadIdx.x, r);
  }
  __device__ __forceinline__ void sync() { __syncthreads(); }
};

// B6: block (tile, pair), one thread per lane of the tile.
__global__ void __launch_bounds__(hyteg::kTileThreads, 4)
pair_apply_kernel(const float* __restrict__ u, const float* __restrict__ W,
                  const float* xf, const float* yf, const float* zf,
                  const float* df, float* __restrict__ dst, float* xfo,
                  float* yfo, float* zfo, float* dfo, int N, int P,
                  hyteg::PairTables t) {
  using namespace hyteg;
  __shared__ float w_s[kPairW];
  __shared__ float ring[4][kStaged];
  const int c = blockIdx.y;
  for (int i = threadIdx.x; i < kPairW; i += kTileThreads)
    w_s[i] = W[(long long)c * kPairW + i];
  const long long block = (long long)N * N * P;
  BlockTeam team;
  pair_apply_tile(team, ring, blockIdx.x, u + c * block,
                  pair_faces_of(xf, yf, zf, df, c, N, P), w_s, t,
                  dst + c * block, pair_faces_of(xfo, yfo, zfo, dfo, c, N, P),
                  N, P);
}

__global__ void __launch_bounds__(kThreads)
pair_install_kernel(const float* __restrict__ u, const float* xf,
                    const float* yf, const float* zf, const float* df,
                    float* __restrict__ out, int N, int P) {
  const int L = N * P;
  const int l = blockIdx.x * blockDim.x + threadIdx.x;
  if (l >= L) return;
  const int x = blockIdx.y, c = blockIdx.z;
  const int ly = l / P;
  const long long block = (long long)N * L;
  out[c * block + (long long)x * L + l] = hyteg::pair_installed(
      u + c * block, hyteg::pair_faces_of(xf, yf, zf, df, c, N, P), x, ly,
      l - ly * P, N, P);
}

__global__ void __launch_bounds__(kThreads)
pair_extract_kernel(const float* __restrict__ u, float* xfo, float* yfo,
                    float* zfo, float* dfo, int N, int P) {
  const int L = N * P;
  const int l = blockIdx.x * blockDim.x + threadIdx.x;
  if (l >= L) return;
  const int c = blockIdx.y;
  const int ly = l / P;
  hyteg::pair_extract_lane(u + c * (long long)N * L,
                           hyteg::pair_faces_of(xfo, yfo, zfo, dfo, c, N, P),
                           ly, l - ly * P, N, P);
}

unsigned lane_blocks(int N, int P) {
  return (unsigned)((N * P + kThreads - 1) / kThreads);
}

}  // namespace

// B6. u, dst: (Cp, N, N*P); W: (Cp, 120, 7); faces in and out as above;
// dirs: host (15, 3) int32 directions; tail_a / tail_b: bit masks of the
// directions with a shell tail. Returns cudaGetLastError() after the launch.
extern "C" int hyteg_pair_apply(const float* u, const float* W,
                                const float* xf, const float* yf,
                                const float* zf, const float* df, float* dst,
                                float* xfo, float* yfo, float* zfo, float* dfo,
                                int Cp, int N, int P, const int* dirs,
                                int tail_a, int tail_b, void* stream) {
  const hyteg::PairTables t = hyteg::pair_make_tables(dirs, tail_a, tail_b);
  const dim3 grid((unsigned)hyteg::pair_tiles(N, P), (unsigned)Cp);
  pair_apply_kernel<<<grid, hyteg::kTileThreads, 0, (cudaStream_t)stream>>>(
      u, W, xf, yf, zf, df, dst, xfo, yfo, zfo, dfo, N, P, t);
  return (int)cudaGetLastError();
}

// B7. out = u with the faces installed.
extern "C" int hyteg_pair_install(const float* u, const float* xf,
                                  const float* yf, const float* zf,
                                  const float* df, float* out, int Cp, int N,
                                  int P, void* stream) {
  const dim3 grid(lane_blocks(N, P), (unsigned)N, (unsigned)Cp);
  pair_install_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      u, xf, yf, zf, df, out, N, P);
  return (int)cudaGetLastError();
}

// B8. The face arrays of u.
extern "C" int hyteg_pair_extract(const float* u, float* xfo, float* yfo,
                                  float* zfo, float* dfo, int Cp, int N, int P,
                                  void* stream) {
  const dim3 grid(lane_blocks(N, P), (unsigned)Cp);
  pair_extract_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      u, xfo, yfo, zfo, dfo, N, P);
  return (int)cudaGetLastError();
}
