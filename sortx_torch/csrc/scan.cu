// Exclusive / inclusive prefix sum of 32-bit words, mod 2^32, for Hopper.
//
// Replaces the TPU kernel sortx/ops/scan.py:_scan_tile_kernel, which
// scans tile after tile on one core and carries the running sum from
// one grid step to the next. CTAs on the card run in no order, so the
// carry becomes a reduce-then-scan over tiles of `tile` elements:
//   pass 1  scan_reduce_kernel     one CTA per tile writes the tile's sum;
//   pass 2  scan_tile_sums_kernel  one CTA scans the tile sums in place
//                                  (exclusive) and writes the grand total;
//   pass 3  scan_apply_kernel      one CTA per tile scans its tile and adds
//                                  the tile's offset.
// Arithmetic is uint32_t, so wraparound is defined; the ragged tail is
// masked, not padded.
//
// What bounds it on the card: device-memory traffic, 12 bytes per
// element (read in pass 1, read and write in pass 3); pass 2 touches
// 4 bytes per tile. Each CTA walks its tile in 1024-element chunks with
// coalesced loads, scanning each chunk with warp shuffles and one
// shared-memory step across the 32 warps. A single-pass decoupled
// look-back scan (8 bytes per element) is later work.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 1024;
constexpr int kWarps = kThreads / 32;

// Inclusive scan of one value per thread over the CTA (blockDim must be
// kThreads); `total` receives the CTA's sum. Every thread must call it.
__device__ __forceinline__ uint32_t cta_inclusive_scan(uint32_t v,
                                                       uint32_t* warp_sums,
                                                       uint32_t& total) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const uint32_t u = __shfl_up_sync(0xffffffffu, v, off);
    if (lane >= off) v += u;
  }
  if (lane == 31) warp_sums[warp] = v;
  __syncthreads();
  if (warp == 0) {
    uint32_t w = warp_sums[lane];
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const uint32_t u = __shfl_up_sync(0xffffffffu, w, off);
      if (lane >= off) w += u;
    }
    warp_sums[lane] = w;
  }
  __syncthreads();
  if (warp > 0) v += warp_sums[warp - 1];
  total = warp_sums[kWarps - 1];
  __syncthreads();  // warp_sums is rewritten by the next call
  return v;
}

__global__ void __launch_bounds__(kThreads)
    scan_reduce_kernel(const uint32_t* __restrict__ x, long long n,
                       long long tile, uint32_t* __restrict__ tile_sums) {
  __shared__ uint32_t warp_sums[kWarps];
  const long long begin = static_cast<long long>(blockIdx.x) * tile;
  const long long end = begin + tile < n ? begin + tile : n;
  uint32_t acc = 0;
  for (long long i = begin + threadIdx.x; i < end; i += kThreads) acc += x[i];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    acc += __shfl_down_sync(0xffffffffu, acc, off);
  }
  if (lane == 0) warp_sums[warp] = acc;
  __syncthreads();
  if (warp == 0) {
    uint32_t w = warp_sums[lane];
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      w += __shfl_down_sync(0xffffffffu, w, off);
    }
    if (lane == 0) tile_sums[blockIdx.x] = w;
  }
}

__global__ void __launch_bounds__(kThreads)
    scan_tile_sums_kernel(uint32_t* __restrict__ tile_sums,
                          long long num_tiles, uint32_t* __restrict__ total) {
  __shared__ uint32_t warp_sums[kWarps];
  uint32_t carry = 0;
  for (long long c = 0; c < num_tiles; c += kThreads) {
    const long long i = c + threadIdx.x;
    const uint32_t v = i < num_tiles ? tile_sums[i] : 0u;
    uint32_t chunk;
    const uint32_t incl = cta_inclusive_scan(v, warp_sums, chunk);
    if (i < num_tiles) tile_sums[i] = carry + incl - v;
    carry += chunk;
  }
  if (threadIdx.x == 0) *total = carry;
}

__global__ void __launch_bounds__(kThreads)
    scan_apply_kernel(const uint32_t* __restrict__ x,
                      uint32_t* __restrict__ out, long long n, long long tile,
                      const uint32_t* __restrict__ tile_offsets,
                      int inclusive) {
  __shared__ uint32_t warp_sums[kWarps];
  const long long begin = static_cast<long long>(blockIdx.x) * tile;
  const long long end = begin + tile < n ? begin + tile : n;
  uint32_t carry = tile_offsets[blockIdx.x];
  for (long long c = begin; c < end; c += kThreads) {
    const long long i = c + threadIdx.x;
    const uint32_t v = i < end ? x[i] : 0u;
    uint32_t chunk;
    const uint32_t incl = cta_inclusive_scan(v, warp_sums, chunk);
    if (i < end) out[i] = carry + (inclusive ? incl : incl - v);
    carry += chunk;
  }
}

}  // namespace

// x, out: n words; tile_sums: ceil(n / tile) words of scratch; total: 1
// word. tile must be a positive multiple of 1024.
extern "C" int sortx_scan(const void* x, void* out, void* tile_sums,
                          void* total, long long n, long long tile,
                          int inclusive, void* stream) {
  if (n <= 0 || tile <= 0 || tile % kThreads != 0) {
    return cudaErrorInvalidValue;
  }
  const long long tiles = (n + tile - 1) / tile;
  auto st = static_cast<cudaStream_t>(stream);
  const auto* xp = static_cast<const uint32_t*>(x);
  auto* sums = static_cast<uint32_t*>(tile_sums);
  scan_reduce_kernel<<<static_cast<unsigned>(tiles), kThreads, 0, st>>>(
      xp, n, tile, sums);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  scan_tile_sums_kernel<<<1, kThreads, 0, st>>>(
      sums, tiles, static_cast<uint32_t*>(total));
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  scan_apply_kernel<<<static_cast<unsigned>(tiles), kThreads, 0, st>>>(
      xp, static_cast<uint32_t*>(out), n, tile, sums, inclusive);
  return cudaGetLastError();
}
