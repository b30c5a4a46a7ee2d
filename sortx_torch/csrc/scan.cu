// Exclusive / inclusive prefix sum of 32-bit words, mod 2^32, for Hopper.
//
// Replaces the TPU kernel sortx/ops/scan.py:_scan_tile_kernel, which
// scans tile after tile on one core and carries the running sum from
// one grid step to the next. CTAs on the card run in no order, so the
// carry becomes a chained scan with decoupled look-back, in one kernel
// and one pass over the data.
//
// What bounds it on the card: device-memory traffic, 8 bytes per
// element: every word is read once and written once, and a tile costs 8
// bytes of descriptor besides. The design:
//   - A CTA takes its tile number from an atomic ticket, not from
//     blockIdx, so every tile before it is running or done and a spin on
//     a predecessor always ends.
//   - The tile (kThreads x kVecs x 4 words) goes from device memory to
//     shared memory with asynchronous 16-byte copies, all issued at once,
//     and holds no register while in flight: shared memory, not the
//     registers, limits the CTAs on an SM, and 192 KB of loads are in
//     flight on each. That depth is needed: tiles finish in order, so a
//     tile waits for the slowest of the loads before it (measured: twice
//     as long as for its own), and only the tiles still loading keep the
//     memory busy. The tile is 8192 words on 128 threads (kVecs = 16), the
//     kernel's own choice: the output does not depend on it, tiles of 4096
//     to 16384 words timed within 4% of each other and 1024 half as slow
//     again, and at a given tile 128 threads were faster than 256 or 512
//     (and than 64 or 32), by 8% here. Each warp owns 128 x kVecs
//     contiguous words; lane l copies, and later reads, the four words at
//     (j * 32 + l) * 4 of them for j < kVecs, so a warp's copy covers 512
//     contiguous bytes and a thread reads back only what it copied itself
//     (no barrier before the first read).
//   - First pass over the staged tile: a thread sums each of its vectors,
//     the warp scans the sums with shuffles (kVecs rows of 32), and one
//     shared-memory step across the warps gives each warp its offset and
//     the CTA the tile's aggregate. Second pass: the thread reads its
//     vectors again, adds the offsets and stores 16 bytes at a time, with
//     the streaming hint (the output is not read again; 6% faster).
//     Three barriers a tile, the ticket's included.
//   - Each tile has a descriptor: a status (empty, aggregate, inclusive
//     prefix) in the high half and the 32-bit value in the low half of
//     one aligned 64-bit word, written with one store, so no fence has to
//     order a flag after a value. Warp 0 publishes the aggregate, then
//     looks back over the predecessors' descriptors 32 at a time, sums
//     aggregates down to the nearest inclusive prefix, and publishes the
//     tile's own inclusive prefix. The last tile writes the grand total.
//   - Sums mod 2^32 are associative and commutative, so the result is the
//     same bits in whatever order the tiles ran.
// A tile that is ragged (the last), or an x off the 16-byte grid (a view
// shifted by a word), is staged with 4-byte copies that fill zeros past
// n, at the same speed; an out off the grid is stored word by word.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

using u64 = unsigned long long;

// descriptor = status << 32 | value; a zeroed descriptor is empty
constexpr u64 kAggregate = 1ull << 32;
constexpr u64 kInclusive = 2ull << 32;
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ u64 load_descriptor(const u64* p) {
  return *reinterpret_cast<const volatile u64*>(p);
}

__device__ __forceinline__ void store_descriptor(u64* p, u64 v) {
  *reinterpret_cast<volatile u64*>(p) = v;
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

// Warp 0 of tile `tile` > 0: the sum of all tiles before it. Lane l
// reads the descriptor of tile - 1 - l (32 more each round), and the warp
// spins until none of the 32 is empty; the nearest inclusive prefix is
// the lowest lane that holds one, and it and the aggregates in front of
// it are the sum. Tiles before the first count as an inclusive prefix of
// 0. (Rows of 128 or 256 descriptors a round were slower: the reads of
// the waiting warps compete with the data.)
__device__ __forceinline__ uint32_t look_back(const u64* descriptors,
                                              long long tile, int lane) {
  uint32_t exclusive = 0;
  for (long long idx = tile - 1 - lane;; idx -= 32) {
    u64 d;
    do {
      d = idx >= 0 ? load_descriptor(descriptors + idx) : kInclusive;
    } while (__any_sync(kFull, (d >> 32) == 0));
    const unsigned inclusive = __ballot_sync(kFull, (d >> 32) == 2);
    const int nearest = inclusive ? __ffs(inclusive) - 1 : 31;
    uint32_t v = lane <= nearest ? static_cast<uint32_t>(d) : 0u;
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      v += __shfl_xor_sync(kFull, v, off);
    }
    exclusive += v;
    if (inclusive) return exclusive;
  }
}

// 16 bytes from device to shared memory without a register in between;
// both addresses lie on the 16-byte grid.
__device__ __forceinline__ void async_copy16(void* smem, const void* src) {
  const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(dst), "l"(src)
               : "memory");
}

// One word, or a zero where `in` is false (src must still be an address
// inside x).
__device__ __forceinline__ void async_copy4(void* smem, const void* src,
                                            bool in) {
  const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  const int bytes = in ? 4 : 0;
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;" ::"r"(dst),
               "l"(src), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void async_copies_land() {
  asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;" ::: "memory");
}

// scratch[0] is the ticket, scratch[1 + t] the descriptor of tile t; all
// zero at launch.
template <int kThreads, int kVecs>
__global__ void __launch_bounds__(kThreads)
    scan_lookback_kernel(const uint32_t* __restrict__ x,
                         uint32_t* __restrict__ out, u64* scratch,
                         uint32_t* __restrict__ total, long long n,
                         long long tiles, int inclusive, int x_wide,
                         int out_wide) {
  constexpr int kWarps = kThreads / 32;
  constexpr long long kTile = static_cast<long long>(kThreads) * kVecs * 4;
  static_assert(kWarps <= 32, "one warp scans the warps' sums");
  extern __shared__ uint4 stage[];   // the tile: vector j of thread t at
                                     // [j * kThreads + t]
  __shared__ uint32_t warp_sums[kWarps];
  __shared__ uint32_t shared_ticket;
  __shared__ uint32_t shared_prefix;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;

  if (threadIdx.x == 0) {
    shared_ticket = atomicAdd(reinterpret_cast<unsigned*>(scratch), 1u);
  }
  __syncthreads();
  const long long tile = shared_ticket;
  u64* descriptors = scratch + 1;

  // element index of this lane's vector 0
  const long long base = tile * kTile +
                         static_cast<long long>(warp) * (128 * kVecs) +
                         lane * 4;
  const bool whole = (tile + 1) * kTile <= n;
  uint4* mine = stage + threadIdx.x;
  if (whole && x_wide) {
#pragma unroll
    for (int j = 0; j < kVecs; ++j) {
      async_copy16(mine + j * kThreads, x + base + j * 128);
    }
  } else {
#pragma unroll
    for (int j = 0; j < kVecs; ++j) {
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const long long i = base + j * 128 + c;
        async_copy4(reinterpret_cast<uint32_t*>(mine + j * kThreads) + c,
                    x + (i < n ? i : n - 1), i < n);
      }
    }
  }
  async_copies_land();   // a thread reads back only what it copied itself

  // lane_excl[j]: the sum of everything in the warp's chunk before the
  // lane's vector j
  uint32_t lane_excl[kVecs];
  uint32_t run = 0;
#pragma unroll
  for (int j = 0; j < kVecs; ++j) {
    const uint4 v = mine[j * kThreads];
    const uint32_t sum = v.x + v.y + v.z + v.w;
    const uint32_t incl = warp_inclusive_scan(sum, lane);
    lane_excl[j] = run + incl - sum;
    run += __shfl_sync(kFull, incl, 31);
  }
  if (lane == 0) warp_sums[warp] = run;   // the warp's total
  __syncthreads();
  const uint32_t upto_warp = warp_inclusive_scan(
      lane < kWarps ? warp_sums[lane] : 0u, lane);
  const uint32_t warp_excl =
      warp ? __shfl_sync(kFull, upto_warp, warp - 1) : 0u;
  const uint32_t aggregate = __shfl_sync(kFull, upto_warp, kWarps - 1);
  if (warp == 0) {
    uint32_t exclusive = 0;
    if (tile == 0) {
      if (lane == 0) store_descriptor(descriptors, kInclusive | aggregate);
    } else {
      // what the tiles behind this one wait for: out before anything else
      if (lane == 0) {
        store_descriptor(descriptors + tile, kAggregate | aggregate);
      }
      exclusive = look_back(descriptors, tile, lane);
      if (lane == 0) {
        store_descriptor(descriptors + tile,
                         kInclusive | (exclusive + aggregate));
      }
    }
    if (lane == 0) {
      shared_prefix = exclusive;
      if (tile == tiles - 1) *total = exclusive + aggregate;
    }
  }
  __syncthreads();
  const uint32_t prefix = shared_prefix + warp_excl;

  const bool wide = whole && out_wide;
#pragma unroll
  for (int j = 0; j < kVecs; ++j) {
    const uint4 v = mine[j * kThreads];
    const uint32_t p = prefix + lane_excl[j];
    uint4 o;
    o.x = inclusive ? p + v.x : p;
    o.y = o.x + (inclusive ? v.y : v.x);
    o.z = o.y + (inclusive ? v.z : v.y);
    o.w = o.z + (inclusive ? v.w : v.z);
    const long long i = base + j * 128;
    if (wide) {
      __stcs(reinterpret_cast<uint4*>(out + i), o);   // written once, not read
    } else {
      if (i < n) out[i] = o.x;
      if (i + 1 < n) out[i + 1] = o.y;
      if (i + 2 < n) out[i + 2] = o.z;
      if (i + 3 < n) out[i + 3] = o.w;
    }
  }
}

template <int kThreads, int kVecs>
cudaError_t launch_scan(const uint32_t* x, uint32_t* out, u64* scratch,
                        uint32_t* total, long long n, int inclusive,
                        cudaStream_t st) {
  const long long tile = static_cast<long long>(kThreads) * kVecs * 4;
  const long long tiles = (n + tile - 1) / tile;
  if (tiles > 0x7fffffffLL) return cudaErrorInvalidValue;
  auto kernel = scan_lookback_kernel<kThreads, kVecs>;
  const int smem = static_cast<int>(tile * sizeof(uint32_t));
  // once per device for this instantiation: let the tile be above 48 KB,
  // and the SM give shared memory all it can (the tiles in flight)
  static unsigned long long done = 0;
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  const unsigned long long bit = 1ULL << (device & 63);
  if (!(done & bit)) {
    err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err == cudaSuccess) {
      err = cudaFuncSetAttribute(
          kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
          cudaSharedmemCarveoutMaxShared);
    }
    if (err != cudaSuccess) return err;
    done |= bit;
  }
  err = cudaMemsetAsync(scratch, 0, sizeof(u64) * (tiles + 1), st);
  if (err != cudaSuccess) return err;
  kernel<<<static_cast<unsigned>(tiles), kThreads, smem, st>>>(
      x, out, scratch, total, n, tiles, inclusive,
      reinterpret_cast<uintptr_t>(x) % 16 == 0,
      reinterpret_cast<uintptr_t>(out) % 16 == 0);
  return cudaGetLastError();
}

}  // namespace

// The tile the kernel is built for: 128 threads x 16 vectors x 4 words.
constexpr int kScanThreads = 128;
constexpr int kScanVecs = 16;
constexpr long long kScanTile = 4LL * kScanThreads * kScanVecs;

// x, out: n words; scratch: 1 + ceil(n / tile) 64-bit words (the ticket
// and the tiles' descriptors; this call zeroes them on its stream, so a
// call owns its scratch); total: 1 word. tile is the tile the caller
// sized scratch for: 8192, or the call is refused.
extern "C" int sortx_scan(const void* x, void* out, void* scratch,
                          void* total, long long n, long long tile,
                          int inclusive, void* stream) {
  if (n <= 0 || tile != kScanTile) return cudaErrorInvalidValue;
  return launch_scan<kScanThreads, kScanVecs>(
      static_cast<const uint32_t*>(x), static_cast<uint32_t*>(out),
      static_cast<u64*>(scratch), static_cast<uint32_t*>(total), n, inclusive,
      static_cast<cudaStream_t>(stream));
}
