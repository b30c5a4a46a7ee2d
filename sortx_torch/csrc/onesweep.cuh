// The device helpers both one-sweep radix engines share: the flat one
// (csrc/radix.cu, K9 and K10) and the rows' one (csrc/radix_rows.cu, K11
// and K12). A tile's digit counts, its scans, its status words and their
// decoupled look-back (Onesweep, Adinets and Merrill, arXiv:2206.01784),
// and the two tile shapes of a pass. Each source includes it once; the
// helpers are inlined into its kernels.

#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kRadix = 256;
constexpr int kThreads = 256;   // thread d owns digit d in a tile's scans
constexpr int kWarps = kThreads / 32;
constexpr long long kMaxKeys = 1LL << 30;
constexpr unsigned kFull = 0xffffffffu;

// A pass's region of the scratch: its ticket and, from kRegionHeader on,
// 256 status words a tile.
constexpr long long kRegionHeader = 32;

// status word = flag << 30 | count; a zeroed word is empty
constexpr uint32_t kAggregate = 1u << 30;
constexpr uint32_t kInclusive = 2u << 30;
constexpr uint32_t kCountMask = kAggregate - 1u;

static_assert(kThreads == kRadix, "one thread a digit");

__device__ __forceinline__ uint32_t load_status(const uint32_t* p) {
  return *reinterpret_cast<const volatile uint32_t*>(p);
}

__device__ __forceinline__ void store_status(uint32_t* p, uint32_t v) {
  *reinterpret_cast<volatile uint32_t*>(p) = v;
}

__device__ __forceinline__ uint32_t warp_inclusive_scan(uint32_t v,
                                                        int lane) {
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const uint32_t u = __shfl_up_sync(kFull, v, off);
    if (lane >= off) v += u;
  }
  return v;
}

// Exclusive scan of one value a thread over a CTA of kThreads; every
// thread calls it. warp_sums holds kWarps words of shared memory.
__device__ __forceinline__ uint32_t block_exclusive_scan(uint32_t v,
                                                         uint32_t* warp_sums) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const uint32_t incl = warp_inclusive_scan(v, lane);
  if (lane == 31) warp_sums[warp] = incl;
  __syncthreads();
  const uint32_t w =
      warp_inclusive_scan(lane < kWarps ? warp_sums[lane] : 0u, lane);
  const uint32_t before = warp ? __shfl_sync(kFull, w, warp - 1) : 0u;
  __syncthreads();   // warp_sums may be written again
  return before + incl - v;
}

// A pass's shape, keys alone and key-value pairs apart (timed on an H100
// at 2^27 uniform keys against 12 to 24 words a thread, 2 to 4 CTAs an SM,
// a look-back of 1 to 8 words at a time): a keys-only pass is bound by how
// many tiles are in flight, so it takes small tiles and 4 CTAs an SM (64
// registers); a pair pass by its extra phase, so it takes larger tiles.
template <bool kPairs>
struct Sweep {
  static constexpr int kItems = kPairs ? 24 : 16;   // words a thread
  static constexpr int kMinCtas = kPairs ? 2 : 4;   // CTAs an SM at least
  static constexpr int kLook = kPairs ? 1 : 4;      // look-back words a read
  static constexpr int kWarpWords = 32 * kItems;
  static constexpr int kTile = kThreads * kItems;
};

// Thread d of tile `tile` > 0: the count of digit d in every tile before
// it. Reads kLook predecessors' status words at a time, sums aggregates
// back to the nearest inclusive count, and spins on a word not yet
// written (a tile before the first reads as an inclusive 0).
template <int kLook>
__device__ __forceinline__ uint32_t look_back(const uint32_t* status,
                                              long long tile, int d) {
  uint32_t exclusive = 0;
  long long t = tile - 1;
  for (;;) {
    uint32_t s[kLook];
#pragma unroll
    for (int j = 0; j < kLook; ++j) {
      s[j] = t - j >= 0 ? load_status(status + (t - j) * kRadix + d)
                        : kInclusive;
    }
    int took = 0;
    bool done = false;
#pragma unroll
    for (int j = 0; j < kLook; ++j) {
      if (done || took < j || !(s[j] & (kAggregate | kInclusive))) continue;
      exclusive += s[j] & kCountMask;
      took = j + 1;
      done = s[j] & kInclusive;
    }
    if (done) return exclusive;
    t -= took;
  }
}

}  // namespace
