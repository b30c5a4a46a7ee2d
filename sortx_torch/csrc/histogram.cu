// Per-tile digit histogram for Hopper (sm_90a).
//
// Replaces the TPU kernel sortx/ops/radix_kernels.py:_histogram_kernel,
// which counts the digit (x >> shift) & (radix - 1) of each tile with
// one one-hot compare-and-reduce per bucket and writes a 128-lane row
// per tile. Here one CTA owns one tile and writes its radix counts:
// out[tile * radix + d].
//
// What bounds it on the card: it reads each word once (4 bytes per
// element) and writes radix counts per tile, so device memory sets the
// floor; the work per element is one shared-memory atomic. The design:
// each warp keeps its own copy of the counters in shared memory (no
// contention between warps), and a warp's lanes that hold the same
// digit are merged with __match_any_sync first, so one lane adds the
// group's count. That keeps skewed inputs, where most lanes hold one
// digit (the later rounds of kth_value), at one atomic per warp and
// step instead of 32 serialised ones. The warps' copies are summed at
// the end. The ragged last tile is bounds-checked, not padded.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;

__global__ void __launch_bounds__(kThreads)
    histogram_kernel(const uint32_t* __restrict__ x, int* __restrict__ out,
                     long long n, long long tile, int shift, int radix) {
  extern __shared__ int counts[];  // kWarps copies of radix counters
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  for (int i = threadIdx.x; i < kWarps * radix; i += kThreads) counts[i] = 0;
  __syncthreads();
  int* mine = counts + warp * radix;
  const long long begin = static_cast<long long>(blockIdx.x) * tile;
  const long long end = begin + tile < n ? begin + tile : n;
  const uint32_t mask = static_cast<uint32_t>(radix - 1);
  // the step is uniform over the CTA, so every lane of a warp takes the
  // same trips and the ballot sees the whole warp
  for (long long base = begin; base < end; base += kThreads) {
    const long long i = base + threadIdx.x;
    const bool valid = i < end;
    const unsigned active = __ballot_sync(0xffffffffu, valid);
    if (valid) {
      const uint32_t d = (x[i] >> shift) & mask;
      const unsigned peers = __match_any_sync(active, d);
      if (lane == __ffs(peers) - 1) atomicAdd(mine + d, __popc(peers));
    }
  }
  __syncthreads();
  for (int d = threadIdx.x; d < radix; d += kThreads) {
    int sum = 0;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) sum += counts[w * radix + d];
    out[static_cast<long long>(blockIdx.x) * radix + d] = sum;
  }
}

}  // namespace

// out: (ceil(n / tile), radix) int32 counts of (x >> shift) & (radix-1).
extern "C" int sortx_histogram(const void* x, void* out, long long n,
                               long long tile, int shift, int radix,
                               void* stream) {
  if (n <= 0 || tile <= 0 || shift < 0 || shift > 31 || radix < 1 ||
      radix > 256 || (radix & (radix - 1)) != 0) {
    return cudaErrorInvalidValue;
  }
  const long long tiles = (n + tile - 1) / tile;
  const int smem = static_cast<int>(sizeof(int)) * kWarps * radix;
  histogram_kernel<<<static_cast<unsigned>(tiles), kThreads, smem,
                     static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(x), static_cast<int*>(out), n, tile, shift,
      radix);
  return cudaGetLastError();
}
