// Kernel P1: stream-copy bandwidth probe, dst = 2 * src over a flat f32
// array.
//
// Replaces the Pallas copy probes of the JAX package's profiling scripts
// (scripts/prof_r5.py::bench_copy, scripts/prof_r5b.py::bench_copy_cells,
// scripts/kernel_probe.py::make_copy). Bound: device-memory bandwidth by
// construction, 8 B per element. 16-byte vector loads and stores
// (float4); one block per chunk of kUnroll * 256 float4, a thread
// issuing its kUnroll loads before its stores; a grid-stride loop takes
// over only past the largest grid; the last n % 4 elements are done by
// block 0. On an H100 80GB HBM3 (700 W) one block per chunk streamed
// 3.03 TB/s at 4.3 GB per array, where one persistent wave of 8 blocks
// per SM streamed 2.86 TB/s.
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kUnroll = 4;
constexpr long long kMaxBlocks = 0x7fffffffLL;

__global__ void __launch_bounds__(kThreads)
stream_scale_kernel(const float* __restrict__ src, float* __restrict__ dst,
                    long long n) {
  const long long n4 = n / 4;
  const float4* __restrict__ s4 = reinterpret_cast<const float4*>(src);
  float4* __restrict__ d4 = reinterpret_cast<float4*>(dst);
  const long long chunk = (long long)kUnroll * kThreads;
  for (long long base = (long long)blockIdx.x * chunk; base < n4;
       base += (long long)gridDim.x * chunk) {
    float4 v[kUnroll];
#pragma unroll
    for (int k = 0; k < kUnroll; ++k) {
      const long long i = base + k * kThreads + threadIdx.x;
      if (i < n4) v[k] = s4[i];
    }
#pragma unroll
    for (int k = 0; k < kUnroll; ++k) {
      const long long i = base + k * kThreads + threadIdx.x;
      if (i < n4)
        d4[i] = make_float4(2.f * v[k].x, 2.f * v[k].y, 2.f * v[k].z,
                            2.f * v[k].w);
    }
  }
  const long long t = 4 * n4 + threadIdx.x;
  if (blockIdx.x == 0 && t < n) dst[t] = 2.f * src[t];
}

}  // namespace

// src, dst: n f32 each, 16-byte aligned. Returns cudaGetLastError() after
// the launch.
extern "C" int hyteg_stream_scale(const float* src, float* dst, long long n,
                                  void* stream) {
  const long long chunk = (long long)kUnroll * kThreads;
  long long blocks = (n / 4 + chunk - 1) / chunk;
  if (blocks > kMaxBlocks) blocks = kMaxBlocks;
  if (blocks < 1) blocks = 1;
  stream_scale_kernel<<<(unsigned)blocks, kThreads, 0, (cudaStream_t)stream>>>(
      src, dst, n);
  return (int)cudaGetLastError();
}
