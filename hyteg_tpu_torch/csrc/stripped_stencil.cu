// Kernels P2: the stripped-stencil probes, box_variant and tet_stripped.
//
// Replace the Pallas probes of the JAX package's profiling scripts:
// scripts/prof_r5.py::bench_box_variants (make, :111) by box_variant, and
// scripts/prof_r5b.py::bench_fma (:122) and
// scripts/kernel_probe.py::make_stripped (:101) by tet_stripped. The math
// and what each variant leaves out are in stripped_stencil.cuh.
//
// Each probe keeps the thread mapping of the kernel it takes apart, so
// that a gap in time is a gap in work and not in mapping:
// - box_variant maps threads as B1 does (box_stencil.cu): one thread per
//   lane walking a tile of kRows rows, its weights in registers for the
//   tile;
// - tet_stripped maps threads as B2 does (p1_const_stencil.cu): one thread
//   per slot of one cell on a grid of (ceil(N * L / 256), C), its cell's
//   weights staged in shared memory, slots outside the mask returning 0
//   before any load.
// The shift, the tap count and the mask are template parameters, so no
// variant pays for a branch or an index that it does not use.
//
// Bound: device-memory bandwidth at best, 8 B per slot (one read of u,
// one write of y) plus the weights; what the probes measure is how far
// each stripped form stays from that, against its real kernel.
#include <cuda_runtime.h>

#include "stripped_stencil.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kRows = 64;

struct ProbeLoad {
  const float* p;
  __device__ __forceinline__ float operator()(long long i) const {
    return __ldg(p + i);
  }
};

template <bool kShift, int kTaps>
__global__ void __launch_bounds__(kThreads)
box_variant_kernel(const float* __restrict__ u, const float* __restrict__ w,
                   float* __restrict__ y, int X, int L, int Z) {
  using namespace hyteg;
  const int lane = blockIdx.x * blockDim.x + threadIdx.x;
  if (lane >= L) return;
  const int x0 = blockIdx.y * kRows;
  const int x1 = min(x0 + kRows, X);
  const ProbeLoad load{u};
  float wk[kTaps];
  box_probe_weights(ProbeLoad{w}, wk, lane, L);
  for (int x = x0; x < x1; ++x) {
    const long long row = (long long)x * L;
    y[row + lane] = box_probe_point<kShift>(load, wk, row, lane, L, Z);
  }
}

template <int kMask, int kTaps>
__global__ void __launch_bounds__(kThreads)
tet_stripped_kernel(const float* __restrict__ src,
                    const float* __restrict__ w, float* __restrict__ dst,
                    int N, int pitch, hyteg::ProbeTables t) {
  using namespace hyteg;
  __shared__ float ws[kTaps];
  const int c = blockIdx.y;
  for (int s = threadIdx.x; s < kTaps; s += blockDim.x)
    ws[s] = w[c * kProbeDirs + s];
  __syncthreads();
  const int L = N * pitch;
  const long long cell = (long long)N * L;
  const long long q = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (q >= cell) return;
  const int x = (int)(q / L);
  const int lane = (int)(q - (long long)x * L);
  dst[c * cell + q] = tet_probe_point<kMask, kTaps>(src + c * cell, x, lane,
                                                    N, pitch, t, ws);
}

}  // namespace

// u, y: (X, L) f32, L = Y * Z; w: (15, L) f32. shift: 0 or 1; n_taps: 1, 6
// or 15. Returns cudaGetLastError() after the launch, or
// cudaErrorInvalidValue for a tap count with no kernel.
extern "C" int hyteg_box_variant(const float* u, const float* w, float* y,
                                 int X, int L, int Z, int shift, int n_taps,
                                 void* stream) {
  const dim3 grid((unsigned)((L + kThreads - 1) / kThreads),
                  (unsigned)((X + kRows - 1) / kRows));
  cudaStream_t st = (cudaStream_t)stream;
  const bool ok = hyteg::probe_with_taps(n_taps, [&](auto taps) {
    constexpr int kTaps = decltype(taps)::value;
    if (shift)
      box_variant_kernel<true, kTaps><<<grid, kThreads, 0, st>>>(u, w, y, X,
                                                                 L, Z);
    else
      box_variant_kernel<false, kTaps><<<grid, kThreads, 0, st>>>(u, w, y, X,
                                                                  L, Z);
  });
  if (!ok) return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}

// u, y: (C, N, N * pitch) f32; w: (C, 15) f32; dirs: host (15, 3) int32
// directions; n_taps: 1, 6 or 15; mask: a hyteg::ProbeMask. Returns
// cudaGetLastError() after the launch, or cudaErrorInvalidValue for a
// setting with no kernel.
extern "C" int hyteg_tet_stripped(const float* u, const float* w, float* y,
                                  int C, int N, int pitch, const int* dirs,
                                  int n_taps, int mask, void* stream) {
  const hyteg::ProbeTables t = hyteg::probe_tables(dirs, pitch);
  const long long cell = (long long)N * N * pitch;
  const dim3 grid((unsigned)((cell + kThreads - 1) / kThreads), (unsigned)C);
  cudaStream_t st = (cudaStream_t)stream;
  bool ok = false;
  hyteg::probe_with_mask(mask, [&](auto m) {
    ok = hyteg::probe_with_taps(n_taps, [&](auto taps) {
      constexpr int kMask = decltype(m)::value;
      constexpr int kTaps = decltype(taps)::value;
      tet_stripped_kernel<kMask, kTaps><<<grid, kThreads, 0, st>>>(
          u, w, y, N, pitch, t);
    });
  });
  if (!ok) return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}
