// Kernels B6 (fused exchanged apply), B7 (install) and B8 (extract) of the
// paired-tet engine: two macro-tets share one (N, N * P) block, tet A in
// the lower corner, tet B point-reflected into the upper one.
//
// Replace hyteg_tpu/tetpair/kernel.py::pair_apply, ::pair_install and
// ::pair_extract. The Pallas kernels roll whole blocks through VMEM and
// build the per-lane weight vectors with a matmul; here a B6 block walks
// one plane of a pair, B7 takes one thread per slot and B8 one per lane,
// and the math and B6's walk are in tetpair.cuh.
//
// B6's limit was instructions, not bytes: with the install logic (the
// position class decides whether a value comes from the block or from a
// face array) in each of a point's 15 reads, and the per-lane weights
// formed at every point, a one-thread-per-slot B6 took 3.5 ms at level 7
// on an H100, and the design this one replaced (16 x 16 tiles of lanes
// walking the rows they meet, each installed row staged in shared memory)
// 0.70-0.71 ms.
// The design here (pair_apply_plane in tetpair.cuh): one thread block per
// (pair, plane x), grid (Cp, N), warps on the rows of both tets, so every
// block holds between ~N^2 / 4 and ~N^2 / 2 slots of work. Every in-tet
// slot two or more steps from all installed faces but the one it is on or
// next to runs one untested sum with reads fixed at compile time by its
// kind (interior: u only; a layer slot: 4 taps on its face's array; a
// face slot: 7 taps on its array, 4 past the block read as 0), weights
// from the block's class table in shared memory; the slots on or near two
// faces (the tets' edges: 1% of the in-tet slots at level 7, 12% at level
// 5) run the tested per-point math; the middle of the block and the
// padding lanes are store-only zero runs. Every slot of dst and every
// face entry is written once (0 outside both tets, so the next apply
// reads no garbage). On an H100 (NVIDIA H100 80GB HBM3, 700 W) it takes
// 0.40 ms at cube level 7 against a bound of 0.087 ms (the reads a
// stencil over both tets needs, one write of the block and of the faces,
// W) and 1.15 ms at shell level 5 (960 pairs of N = 33) against 0.070 ms
// (python -m hyteg_tpu_torch.probes.b6_trees). Its time follows the
// number of rows and planes far more than the number of slots: each
// row's middle, zero run and four end lanes, and each plane's class table
// and list, wait on memory in turn, and the edge slots' call holds the
// kernel at 80 registers (three blocks per SM).
#include <cuda_runtime.h>

#include "tetpair.cuh"

namespace {

constexpr int kThreads = 256;  // B7, B8
constexpr int kPlaneThreads = hyteg::kPlaneWarps * 32;  // B6

// B6: block (pair c, block row y), plane pair_plane_of(y): the pair's W
// staged in shared memory (one read of global memory in flight per
// thread; folded from global memory, each thread's several table entries
// waited on global memory in turn) and folded into the class table, then
// pair_apply_plane. At least 3 blocks per SM (80 registers):
// on the card, uncapped (163 registers) it ran 70% slower, at 2 blocks
// (123) 8% slower, at 4 (64 registers, 160 bytes of spill stores) 2%
// slower.
__global__ void __launch_bounds__(kPlaneThreads, 3)
pair_apply_kernel(const float* __restrict__ u, const float* __restrict__ W,
                  const float* xf, const float* yf, const float* zf,
                  const float* df, float* __restrict__ dst, float* xfo,
                  float* yfo, float* zfo, float* dfo, int N, int P,
                  hyteg::PairTables t) {
  using namespace hyteg;
  __shared__ float w_s[kPairW];
  __shared__ float tab[kPairTab];
  const int c = blockIdx.x;
  for (int i = threadIdx.x; i < kPairW; i += kPlaneThreads)
    w_s[i] = W[(long long)c * kPairW + i];
  __syncthreads();
  const int x = pair_plane_of(blockIdx.y, N);
  pair_weight_table(w_s, t, N - 1, x, tab, threadIdx.x, kPlaneThreads);
  __syncthreads();
  const long long block = (long long)N * N * P;
  const PairOut<CellStore> out{CellStore{dst + c * block},
                               pair_stores_of(xfo, yfo, zfo, dfo, c, N, P)};
  pair_apply_plane(u + c * block, pair_faces_of(xf, yf, zf, df, c, N, P), tab,
                   out, x, N, P, threadIdx.x >> 5, threadIdx.x & 31,
                   kPlaneWarps);
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
                           hyteg::pair_stores_of(xfo, yfo, zfo, dfo, c, N, P),
                           ly, l - ly * P, N, P);
}

unsigned lane_blocks(int N, int P) {
  return (unsigned)((N * P + kThreads - 1) / kThreads);
}

}  // namespace

// B6. u, dst: (Cp, N, N*P); W: (Cp, 120, 7); faces in and out as above;
// dirs: host (15, 3) int32 directions, which must be the compiled ones
// (pair_dx, pair_dy, pair_dz; else cudaErrorInvalidValue, nothing
// launched); tail_a / tail_b: bit masks of the directions with a shell
// tail. Returns cudaGetLastError() after the launch.
extern "C" int hyteg_pair_apply(const float* u, const float* W,
                                const float* xf, const float* yf,
                                const float* zf, const float* df, float* dst,
                                float* xfo, float* yfo, float* zfo, float* dfo,
                                int Cp, int N, int P, const int* dirs,
                                int tail_a, int tail_b, void* stream) {
  if (!hyteg::pair_dirs_match(dirs)) return (int)cudaErrorInvalidValue;
  const dim3 grid((unsigned)Cp, (unsigned)N);
  pair_apply_kernel<<<grid, kPlaneThreads, 0, (cudaStream_t)stream>>>(
      u, W, xf, yf, zf, df, dst, xfo, yfo, zfo, dfo, N, P,
      hyteg::PairTables{tail_a, tail_b});
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
