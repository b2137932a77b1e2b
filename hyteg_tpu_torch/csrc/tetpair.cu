// Kernels B6 (fused exchanged apply), B7 (install) and B8 (extract) of the
// paired-tet engine: two macro-tets share one (N, N * P) block, tet A in
// the lower corner, tet B point-reflected into the upper one.
//
// Replace hyteg_tpu/tetpair/kernel.py::pair_apply, ::pair_install and
// ::pair_extract. The Pallas kernels roll whole blocks through VMEM and
// build the per-lane weight vectors with a matmul; here a B6 or B7 block
// walks one plane of a pair and a B8 block a run of the pair's face
// entries, and the math and the walks are in tetpair.cuh.
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
// (python -m hyteg_tpu_torch.probes.pair_trees). Its time follows the
// number of rows and planes far more than the number of slots: each
// row's middle, zero run and four end lanes, and each plane's class table
// and list, wait on memory in turn, and the edge slots' call holds the
// kernel at 80 registers (three blocks per SM).
//
// B7 and B8 only select and copy, so bytes bound them. Their first design
// took one thread per slot (B7: a division by P, pair_source's chain of 8
// tests and one 4-byte load through a pointer chosen at run time each, so
// ~8 KB of loads in flight per SM) and one per lane (B8: each of the ~4N
// face lanes of a pair walked all N rows, one load after another, with
// one active thread in the warps of lanes 0 and n). On an H100 (NVIDIA
// H100 80GB HBM3, 700 W) at cube level 7, block (24, 129, 16641), B7 took
// 0.28 ms against a bound of 0.123 ms (44%; the block read where it is
// kept, one face entry per installed position, the block written) and B8
// 0.077 ms against 0.0057 ms (the kept entries read, every entry written;
// its strided reads touch a 32-byte sector per value, a floor of 0.0120
// ms). Here a B7 block copies its plane with 16-byte loads and
// stores, 4 in flight per thread (planes 0 and n: the x-face's lanes from
// xf, a warp a run), and after __syncthreads rewrites the plane's lines
// (rows and lanes 0 and n, the shell lines: 4% of the slots at level 7)
// through pair_installed, whose reads it issued before the copy; its
// block size follows the plane (pair_install_threads). A B8 block takes
// 1024 face entries of a pair, a thread an entry: one load from the slot
// the gathered extract map names (none for a masked 0), one store to
// consecutive entries; no thread loops over rows. B8 walked the positions
// of the map's scatter form (pair_store_point, as B6 stores) first: each
// position's branches over every face array, at 64 registers, made it
// slower than its parent on the shell. On the same card, timed as CUDA
// graphs (python3 chip_smoke.py, b7_b8_levels, *_graph_ms), B7 takes
// 0.164 ms at cube level 7 (75% of its bound) and 0.139 ms on the shell at
// level 5 (59%), B8 0.037 ms at cube level 7 (15%; its z-lane and shell
// reads, a sector each, hold it at 33% of that floor) and 0.080 ms on the
// shell, slower than torch.take of its kept entries (0.035 and 0.063 ms),
// which writes only those entries.
#include <cuda_runtime.h>

#include "tetpair.cuh"

namespace {

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

// B7: block (pair c, block row y) of THREADS threads, plane
// pair_plane_of(y) (planes 0 and n, whose phase 1 runs a warp a run,
// start first): phase 2's first reads, phase 1, then phase 2's stores on
// the same slots.
template <int THREADS>
__global__ void __launch_bounds__(THREADS)
pair_install_kernel(const float* __restrict__ u, const float* xf,
                    const float* yf, const float* zf, const float* df,
                    float* __restrict__ out, int N, int P) {
  using namespace hyteg;
  const int c = blockIdx.x;
  const int x = pair_plane_of(blockIdx.y, N);
  const long long block = (long long)N * N * P;
  const CellStore o{out + c * block};
  const PairFaces<const float> f = pair_faces_of(xf, yf, zf, df, c, N, P);
  PatchBatch<pair_install_loads(THREADS)> first;
  pair_patch_read(u + c * block, f, x, threadIdx.x, pair_lines(x, N, P), N,
                  P, THREADS, first);
  pair_install_copy(u + c * block, f.xf, o, x, N, P, threadIdx.x, THREADS);
  __syncthreads();
  pair_install_patch(u + c * block, f, o, x, N, P, threadIdx.x, THREADS,
                     first);
}

// B8: block (pair c, block row y), face entries y * kExtractChunk on of
// the pair.
__global__ void __launch_bounds__(hyteg::kExtractThreads)
pair_extract_kernel(const float* __restrict__ u, float* xfo, float* yfo,
                    float* zfo, float* dfo, int N, int P) {
  using namespace hyteg;
  const int c = blockIdx.x;
  const int i0 = blockIdx.y * kExtractChunk;
  const int end = pair_face_entries(N, P);
  pair_extract_range(u + c * (long long)N * N * P,
                     pair_stores_of(xfo, yfo, zfo, dfo, c, N, P), i0,
                     i0 + kExtractChunk < end ? i0 + kExtractChunk : end, N,
                     P, threadIdx.x, kExtractThreads);
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
  const dim3 grid((unsigned)Cp, (unsigned)N);
  if (hyteg::pair_install_threads(N, P) == 512)
    pair_install_kernel<512><<<grid, 512, 0, (cudaStream_t)stream>>>(
        u, xf, yf, zf, df, out, N, P);
  else
    pair_install_kernel<256><<<grid, 256, 0, (cudaStream_t)stream>>>(
        u, xf, yf, zf, df, out, N, P);
  return (int)cudaGetLastError();
}

// B8. The face arrays of u.
extern "C" int hyteg_pair_extract(const float* u, float* xfo, float* yfo,
                                  float* zfo, float* dfo, int Cp, int N, int P,
                                  void* stream) {
  const int end = hyteg::pair_face_entries(N, P);
  const dim3 grid((unsigned)Cp,
                  (unsigned)((end + hyteg::kExtractChunk - 1) /
                             hyteg::kExtractChunk));
  pair_extract_kernel<<<grid, hyteg::kExtractThreads, 0,
                        (cudaStream_t)stream>>>(u, xfo, yfo, zfo, dfo, N, P);
  return (int)cudaGetLastError();
}
