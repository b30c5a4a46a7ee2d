// Digit histogram, per tile or whole, for Hopper (sm_90a).
//
// Replaces the TPU kernel sortx/ops/radix_kernels.py:_histogram_kernel,
// which counts the digit (x >> shift) & (radix - 1) of each tile with
// one one-hot compare-and-reduce per bucket and writes a 128-lane row
// per tile. Here one CTA owns one tile and writes its radix counts,
// out[tile * radix + d]; or, when the caller wants only the sum of the
// rows, a card-filling grid of CTAs walks all the words and adds into one
// table of radix counts.
//
// What bounds it on the card: it reads each word once (4 bytes per
// element) and writes radix counts per tile, so device memory sets the
// floor; the work per element is a shift, a mask and one shared-memory
// atomic, and the atomics are what it must keep cheap. The design:
//   - Loads are 16 bytes a thread, kUnroll of them issued before the
//     first is used. A tile that starts off the 16-byte grid (a shifted
//     view, a tile length that is no multiple of 4) peels up to 3 words
//     at its head and tail, which take 4-byte loads.
//   - Each warp counts into its own copy of the counters in shared
//     memory with plain atomics: on well-spread digits a warp's 32 lanes
//     rarely meet at one counter. The copies are summed at the end.
//   - Skew is looked for once per 16-byte vector, not per element: the
//     digit of the first lane that counts is broadcast, and only if at
//     least kCrowd lanes hold it does the warp leave the plain path. Then,
//     if every word of all 32 vectors holds that digit, one lane adds
//     128; otherwise lanes with equal digits are merged with
//     __match_any_sync so one lane adds the group's count. That keeps an
//     all-equal input at one atomic per 128 words, and few-valued inputs
//     (and radix < 32, where lanes must meet) off 32-way serialised
//     atomics; the copies of one warp span radix words, so at radix < 32
//     the lanes that do not meet still hit distinct banks.
//   - The filter: with a prefix (one u32 in device memory, so a caller's
//     rounds need no host sync) a word counts only if its bits above the
//     digit, x >> (shift + log2 radix), equal the prefix. When no bits
//     lie above the digit the prefix is not read. kth_value's rounds
//     count the surviving words this way, in place, on the radix image.
// The ragged last tile is bounds-checked, not padded.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kUnroll = 4;    // 16-byte loads in flight per thread
constexpr int kCrowd = 4;     // lanes on one digit that count as skew
constexpr long long kWholeChunk = 16384;   // a CTA's step when not per tile
constexpr int kCtasPerSm = 4;
constexpr unsigned kFull = 0xffffffffu;

struct Digits {
  int shift;
  uint32_t mask;
  bool filter;
  int hi_shift;
  uint32_t prefix;
  __device__ __forceinline__ bool counts(uint32_t w) const {
    return !filter || (w >> hi_shift) == prefix;
  }
  __device__ __forceinline__ uint32_t digit(uint32_t w) const {
    return (w >> shift) & mask;
  }
};

// Count one 16-byte vector per lane into the warp's counters. Every lane
// of the warp calls it; ok[c] says whether word c counts.
__device__ __forceinline__ void count_vector(int* mine, const uint32_t (&d)[4],
                                             const bool (&ok)[4], int lane) {
  const unsigned first = __ballot_sync(kFull, ok[0]);
  uint32_t lead = 0;
  bool crowded = false;
  if (first) {
    lead = __shfl_sync(kFull, d[0], __ffs(first) - 1);
    crowded = __popc(__ballot_sync(kFull, ok[0] && d[0] == lead)) >= kCrowd;
  }
  if (!crowded) {
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      if (ok[c]) atomicAdd(mine + d[c], 1);
    }
    return;
  }
  const bool all_lead = ok[0] && ok[1] && ok[2] && ok[3] && d[0] == lead &&
                        d[1] == lead && d[2] == lead && d[3] == lead;
  if (__all_sync(kFull, all_lead)) {
    if (lane == 0) atomicAdd(mine + lead, 128);
    return;
  }
#pragma unroll
  for (int c = 0; c < 4; ++c) {
    const unsigned active = __ballot_sync(kFull, ok[c]);
    if (ok[c]) {
      const unsigned peers = __match_any_sync(active, d[c]);
      if (lane == __ffs(peers) - 1) atomicAdd(mine + d[c], __popc(peers));
    }
  }
}

__global__ void __launch_bounds__(kThreads)
    histogram_kernel(const uint32_t* __restrict__ x, int* __restrict__ out,
                     long long n, long long tile, long long tiles, int shift,
                     int radix, int hi_shift,
                     const uint32_t* __restrict__ prefix, int per_tile) {
  extern __shared__ int counts[];  // kWarps copies of radix counters
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  for (int i = threadIdx.x; i < kWarps * radix; i += kThreads) counts[i] = 0;
  Digits dg;
  dg.shift = shift;
  dg.mask = static_cast<uint32_t>(radix - 1);
  dg.filter = prefix != nullptr && hi_shift < 32;
  dg.hi_shift = dg.filter ? hi_shift : 0;
  dg.prefix = dg.filter ? *prefix : 0u;
  __syncthreads();
  int* mine = counts + warp * radix;

  for (long long t = blockIdx.x; t < tiles; t += gridDim.x) {
    const long long begin = t * tile;
    const long long len = (begin + tile < n ? begin + tile : n) - begin;
    const uint32_t* p = x + begin;
    // words before the 16-byte grid, whole vectors, words after them
    long long head = (4 - ((reinterpret_cast<uintptr_t>(p) >> 2) & 3)) & 3;
    if (head > len) head = len;
    const long long nvec = (len - head) >> 2;
    const long long tail = len - head - 4 * nvec;
    if (threadIdx.x < head + tail) {
      const long long i = threadIdx.x < head
                              ? threadIdx.x
                              : 4 * nvec + threadIdx.x;
      const uint32_t w = p[i];
      if (dg.counts(w)) atomicAdd(mine + dg.digit(w), 1);
    }
    const uint4* pv = reinterpret_cast<const uint4*>(p + head);
    // the trip count is uniform over the CTA: every lane of a warp takes
    // part in the votes of count_vector
    for (long long v0 = 0; v0 < nvec; v0 += kThreads * kUnroll) {
      uint4 w[kUnroll];
      bool in[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const long long v = v0 + u * kThreads + threadIdx.x;
        in[u] = v < nvec;
        w[u] = in[u] ? pv[v] : make_uint4(0u, 0u, 0u, 0u);
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const uint32_t word[4] = {w[u].x, w[u].y, w[u].z, w[u].w};
        uint32_t d[4];
        bool ok[4];
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          d[c] = dg.digit(word[c]);
          ok[c] = in[u] && dg.counts(word[c]);
        }
        count_vector(mine, d, ok, lane);
      }
    }
    if (per_tile) {   // write the tile's row and start the next from zero
      __syncthreads();
      for (int d = threadIdx.x; d < radix; d += kThreads) {
        int sum = 0;
#pragma unroll
        for (int w = 0; w < kWarps; ++w) {
          sum += counts[w * radix + d];
          counts[w * radix + d] = 0;
        }
        out[t * radix + d] = sum;
      }
      __syncthreads();
    }
  }
  if (!per_tile) {
    __syncthreads();
    for (int d = threadIdx.x; d < radix; d += kThreads) {
      int sum = 0;
#pragma unroll
      for (int w = 0; w < kWarps; ++w) sum += counts[w * radix + d];
      if (sum) atomicAdd(out + d, sum);
    }
  }
}

}  // namespace

// Counts of (x >> shift) & (radix - 1) over n words. per_tile != 0: out
// is (ceil(n / tile), radix) int32, one row per tile. per_tile == 0: out
// is (radix,) int32, the sum of those rows; this call zeroes it on its
// stream. prefix, when not null, points to one u32 on the device: a word
// counts only if x >> (shift + log2 radix) equals it (ignored when
// shift + log2 radix >= 32: no bits lie above the digit).
extern "C" int sortx_histogram(const void* x, void* out, const void* prefix,
                               long long n, long long tile, int shift,
                               int radix, int per_tile, void* stream) {
  if (n <= 0 || tile <= 0 || shift < 0 || shift > 31 || radix < 1 ||
      radix > 256 || (radix & (radix - 1)) != 0) {
    return cudaErrorInvalidValue;
  }
  auto st = static_cast<cudaStream_t>(stream);
  int hi_shift = shift;
  for (int r = radix; r > 1; r >>= 1) ++hi_shift;
  long long grid;
  if (per_tile) {
    grid = (n + tile - 1) / tile;
  } else {
    tile = kWholeChunk;
    int device = 0, sms = 0;
    cudaError_t err = cudaGetDevice(&device);
    if (err == cudaSuccess) {
      err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                   device);
    }
    if (err == cudaSuccess) {
      err = cudaMemsetAsync(out, 0, sizeof(int) * radix, st);
    }
    if (err != cudaSuccess) return err;
    grid = static_cast<long long>(sms) * kCtasPerSm;
  }
  const long long tiles = (n + tile - 1) / tile;
  if (grid > tiles) grid = tiles;
  if (grid > 0x7fffffffLL) return cudaErrorInvalidValue;
  const int smem = static_cast<int>(sizeof(int)) * kWarps * radix;
  histogram_kernel<<<static_cast<unsigned>(grid), kThreads, smem, st>>>(
      static_cast<const uint32_t*>(x), static_cast<int*>(out), n, tile, tiles,
      shift, radix, hi_shift, static_cast<const uint32_t*>(prefix), per_tile);
  return cudaGetLastError();
}
