// One-sweep LSD radix sort of 32-bit words, 8-bit digits, for Hopper
// (sm_90a): K9 counts every digit of every pass in one read, K10 runs one
// stable counting pass a digit.
//
// Replaces no TPU kernel: sortx sorts on the bitonic network
// (sortx/ops/bitonic.py) and the port ran that network until this engine.
// It is the algorithm of the system sortx was modelled on (OCLRadixSort,
// an LSD radix sort: a digit histogram, a scan, a stable scatter), in the
// one-sweep form of Onesweep (Adinets and Merrill, arXiv:2206.01784): the
// scan of the digit counts across tiles is folded into the scatter by
// decoupled look-back, so a pass reads and writes each word once.
//
// What bounds it on the card: device-memory traffic at best. K9 reads
// each key once (4 bytes); each K10 pass reads and writes each key (8
// bytes) and, with a value, each value (8 more). Keys-only at 32 bits that
// is 36 bytes a key in all (1.44 ms for 2^27 keys at 3.35 TB/s), 68 with a
// 32-bit value; the bitonic network needed 296 and about 1250. K10 does
// not reach that bound: between its load and its stores a tile ranks its
// words and looks back, with no traffic of its own, so the pass is bound by
// the tiles in flight (measured at 2^27 on an H100: 0.73-0.80 ms a pass
// keys-only, 1.28-1.32 ms with values, against 0.32 and 0.64). The design:
//   - K9: a card-filling grid walks the keys with 16-byte loads, four in
//     flight a thread, and counts the ceil(bits / 8) digits of each word
//     into per-warp rows of shared counters; each CTA adds its rows into
//     the global counts with atomics, and the last CTA to finish (an
//     atomic ticket after a fence) turns every pass's counts into
//     exclusive digit offsets in place. No second launch.
//   - K10: a CTA takes its tile from an atomic ticket, so every tile
//     before it is running or done and its spin on a predecessor ends;
//     ticket order is input order, which with a stable rank inside the
//     tile makes the pass stable. Warp w holds the tile's words
//     [32 kItems w, 32 kItems (w + 1)), lane l its words 32 i + l (loads of
//     128 contiguous bytes a warp). The warps first count the tile's
//     digits with shared atomics, and one thread a digit publishes the
//     tile's count (one 32-bit status word: two flag bits, aggregate or
//     inclusive, over a 30-bit count, so one store publishes both) before
//     any word is ranked, so the tiles behind it rarely wait. A scan of
//     the 256 counts gives each warp the tile rank of its first word of
//     each digit. Then a warp ranks its words in input order, slot by
//     slot: each lane sets its bit in a shared mask of its digit and reads
//     the mask back (its peers, one atomicOr where eight ballots would
//     do), the highest peer takes the group's ranks from the warp's
//     counter, and each word goes to shared memory at its rank. Meanwhile
//     thread d looks back over the predecessors' status words of digit d
//     to the nearest inclusive count. From shared memory consecutive
//     threads store consecutive ranks, so each digit's run leaves the CTA
//     in coalesced stores. A value moves with its key through the same
//     shared buffer to the same place.
//   - Keys-only tiles are 4096 words (16 a thread, 4 CTAs an SM, the
//     look-back reading 4 predecessors at a time); pair tiles 6144 (24 a
//     thread, 2 CTAs an SM): Sweep in onesweep.cuh.
//   - Every status word, ticket and count lives in one scratch buffer that
//     K9's entry zeroes with one cudaMemsetAsync on the stream: a call
//     reads nothing on the host and can be captured in a CUDA graph.
// Counts are 30 bits, so n < 2^30 (ops/sort.py:sort_engine sends larger
// sorts to the network). Digit width, tiles, threads and K9's grid are constants here:
// the output does not depend on them.

#include "onesweep.cuh"

namespace {

constexpr int kMaxPasses = 4;
constexpr int kHistBlocks = 1024;   // K9's grid at most: ~8 CTAs an SM
constexpr int kHistUnroll = 4;      // K9: 16-byte loads in flight a thread

// The scratch buffer, in 32-bit words: the counts (then offsets) of each
// pass, K9's ticket, then one region a pass (onesweep.cuh).
constexpr long long kHistTicket = kMaxPasses * kRadix;
constexpr long long kHeader = kHistTicket + 32;

// --- K9: the digit counts of every pass, as exclusive offsets ------------

struct PassDigits {
  int passes;
  uint32_t top_mask;   // the last pass's digit: bits - 8 (passes - 1) wide
  __device__ __forceinline__ void count(uint32_t* rows, uint32_t k) const {
#pragma unroll
    for (int p = 0; p < kMaxPasses; ++p) {
      if (p < passes) {
        const uint32_t m = p == passes - 1 ? top_mask : 0xffu;
        atomicAdd(rows + p * kRadix + ((k >> (8 * p)) & m), 1u);
      }
    }
  }
  __device__ __forceinline__ void count(uint32_t* rows, uint4 q) const {
    count(rows, q.x);
    count(rows, q.y);
    count(rows, q.z);
    count(rows, q.w);
  }
};

__global__ void __launch_bounds__(kThreads)
    radix_histogram_kernel(const uint32_t* __restrict__ keys, long long n,
                           int bits, int wide, uint32_t* header) {
  __shared__ uint32_t rows[kWarps][kMaxPasses * kRadix];
  __shared__ uint32_t warp_sums[kWarps];
  __shared__ bool last;
  const int passes = (bits + 7) >> 3;
  const int top_bits = bits - 8 * (passes - 1);
  const PassDigits digits{passes, (1u << top_bits) - 1u};
  for (int i = threadIdx.x; i < kWarps * kMaxPasses * kRadix; i += kThreads) {
    (&rows[0][0])[i] = 0;
  }
  __syncthreads();
  uint32_t* mine = rows[threadIdx.x >> 5];

  const long long step = static_cast<long long>(gridDim.x) * kThreads;
  const long long first = static_cast<long long>(blockIdx.x) * kThreads +
                          threadIdx.x;
  long long tail = first;   // the first word the 16-byte loop leaves
  if (wide) {
    const uint4* v = reinterpret_cast<const uint4*>(keys);
    const long long nv = n >> 2;
    long long i = first;
    for (; i + (kHistUnroll - 1) * step < nv; i += kHistUnroll * step) {
      uint4 q[kHistUnroll];
#pragma unroll
      for (int u = 0; u < kHistUnroll; ++u) q[u] = __ldg(v + i + u * step);
#pragma unroll
      for (int u = 0; u < kHistUnroll; ++u) digits.count(mine, q[u]);
    }
    for (; i < nv; i += step) digits.count(mine, __ldg(v + i));
    tail = (nv << 2) + first;
  }
  for (long long i = tail; i < n; i += step) digits.count(mine, __ldg(keys + i));
  __syncthreads();

  for (int j = threadIdx.x; j < passes * kRadix; j += kThreads) {
    uint32_t s = 0;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) s += rows[w][j];
    if (s) atomicAdd(header + j, s);
  }
  __threadfence();   // this CTA's counts are in before its ticket
  __syncthreads();
  if (threadIdx.x == 0) {
    last = atomicAdd(header + kHistTicket, 1u) == gridDim.x - 1;
  }
  __syncthreads();
  if (!last) return;
  __threadfence();
  for (int p = 0; p < passes; ++p) {
    const uint32_t c = __ldcg(header + p * kRadix + threadIdx.x);
    const uint32_t start = block_exclusive_scan(c, warp_sums);
    header[p * kRadix + threadIdx.x] = start;
  }
}

// --- K10: one stable pass of one digit -----------------------------------

template <bool kPairs>
__global__ void __launch_bounds__(kThreads, Sweep<kPairs>::kMinCtas)
    radix_onesweep_kernel(const uint32_t* __restrict__ keys_in,
                          uint32_t* __restrict__ keys_out,
                          const uint32_t* __restrict__ values_in,
                          uint32_t* __restrict__ values_out, long long n,
                          int shift, uint32_t mask,
                          const uint32_t* __restrict__ offsets,
                          uint32_t* region) {
  using S = Sweep<kPairs>;
  constexpr int kItems = S::kItems;
  // per warp: its count of each digit, then the tile rank of its next word
  // of that digit; and the lanes of a slot that hold each digit
  __shared__ uint32_t warp_counts[kWarps][kRadix];
  __shared__ uint32_t warp_peers[kWarps][kRadix];
  __shared__ uint32_t stage[S::kTile];       // the tile in digit order
  __shared__ uint32_t digit_base[kRadix];    // global place less tile rank
  __shared__ uint32_t warp_sums[kWarps];
  __shared__ uint32_t shared_tile;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  uint32_t* counts = warp_counts[warp];
  uint32_t* peers_of = warp_peers[warp];
#pragma unroll
  for (int j = 0; j < kRadix / 32; ++j) {
    counts[j * 32 + lane] = 0;
    peers_of[j * 32 + lane] = 0;
  }
  if (threadIdx.x == 0) shared_tile = atomicAdd(region, 1u);
  __syncthreads();
  const long long tile = shared_tile;
  uint32_t* status = region + kRegionHeader;
  const long long tile_base = tile * S::kTile;
  const long long base = tile_base + warp * S::kWarpWords + lane;

  uint32_t key[kItems];
#pragma unroll
  for (int i = 0; i < kItems; ++i) {
    const long long idx = base + i * 32;
    key[i] = idx < n ? __ldcs(keys_in + idx) : 0u;
  }
  // early counts: the tile's digit counts first, so that the tiles after
  // this one can read its aggregate while it ranks its words
#pragma unroll
  for (int i = 0; i < kItems; ++i) {
    if (base + i * 32 < n) atomicAdd(counts + ((key[i] >> shift) & mask), 1u);
  }
  __syncthreads();

  // thread d: publish the tile's count of digit d, find the digit's first
  // rank in the tile, and give each warp the rank of its first such word
  const int d = threadIdx.x;
  uint32_t count = 0;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) count += warp_counts[w][d];
  uint32_t* own = status + tile * kRadix + d;
  store_status(own, (tile == 0 ? kInclusive : kAggregate) | count);
  uint32_t next = block_exclusive_scan(count, warp_sums);
  const uint32_t start = next;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) {
    const uint32_t c = warp_counts[w][d];
    warp_counts[w][d] = next;
    next += c;
  }
  __syncthreads();

  // rank the warp's words slot by slot, in input order, and stage them:
  // each lane sets its bit in its digit's mask, reads the mask back (its
  // peers), and the highest peer clears it and takes the group's ranks
  const unsigned below = (1u << lane) - 1u;
  uint32_t rank[kItems];
#pragma unroll
  for (int i = 0; i < kItems; ++i) {
    const bool valid = base + i * 32 < n;
    const uint32_t dd = (key[i] >> shift) & mask;
    uint32_t* m = peers_of + dd;
    if (valid) atomicOr(m, 1u << lane);
    __syncwarp();
    const unsigned peers = valid ? *m : 0u;
    __syncwarp();   // every lane has its peers before the mask is cleared
    const int leader = valid ? 31 - __clz(peers) : lane;
    uint32_t first = 0;
    if (valid && lane == leader) {
      *m = 0;
      first = counts[dd];
      counts[dd] = first + __popc(peers);
    }
    rank[i] = __shfl_sync(kFull, first, leader) + __popc(peers & below);
    if (valid) stage[rank[i]] = key[i];
    __syncwarp();   // mask clear and counter bumped before the next slot
  }
  uint32_t value[kItems];
  if constexpr (kPairs) {
#pragma unroll
    for (int i = 0; i < kItems; ++i) {
      const long long idx = base + i * 32;
      value[i] = idx < n ? __ldcs(values_in + idx) : 0u;
    }
  }

  uint32_t exclusive = 0;
  if (tile > 0) {
    exclusive = look_back<S::kLook>(status, tile, d);
    store_status(own, kInclusive | (exclusive + count));
  }
  digit_base[d] = offsets[d] + exclusive - start;
  __syncthreads();

  const long long left = n - tile_base;
  const int valid = left < S::kTile ? static_cast<int>(left) : S::kTile;
  uint32_t pos[kItems];
#pragma unroll
  for (int k = 0; k < kItems; ++k) {
    const int j = k * kThreads + threadIdx.x;
    if (j < valid) {
      const uint32_t w = stage[j];
      pos[k] = digit_base[(w >> shift) & mask] + j;
      keys_out[pos[k]] = w;
    }
  }
  if constexpr (kPairs) {
    __syncthreads();   // every key has left the stage
#pragma unroll
    for (int i = 0; i < kItems; ++i) {
      if (base + i * 32 < n) stage[rank[i]] = value[i];
    }
    __syncthreads();
#pragma unroll
    for (int k = 0; k < kItems; ++k) {
      const int j = k * kThreads + threadIdx.x;
      if (j < valid) values_out[pos[k]] = stage[j];
    }
  }
}

}  // namespace

// keys: n words (0 < n < 2^30); bits: 1..32, the low bits the sort orders
// by; scratch: scratch_words words, at least the header. Zeroes the whole
// scratch on the stream (K10's tickets and status words included), then
// leaves in scratch[p * 256 + d] the first place of digit d in the output
// of pass p.
extern "C" int sortx_radix_histogram(const void* keys, long long n, int bits,
                                     void* scratch, long long scratch_words,
                                     void* stream) {
  if (n <= 0 || n >= kMaxKeys || bits < 1 || bits > 32 ||
      scratch_words < kHeader) {
    return cudaErrorInvalidValue;
  }
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaMemsetAsync(
      scratch, 0, static_cast<size_t>(scratch_words) * sizeof(uint32_t), st);
  if (err != cudaSuccess) return err;
  const long long want = (n + 16LL * kThreads - 1) / (16LL * kThreads);
  const unsigned blocks =
      static_cast<unsigned>(want < kHistBlocks ? want : kHistBlocks);
  radix_histogram_kernel<<<blocks, kThreads, 0, st>>>(
      static_cast<const uint32_t*>(keys), n, bits,
      reinterpret_cast<uintptr_t>(keys) % 16 == 0,
      static_cast<uint32_t*>(scratch));
  return cudaGetLastError();
}

// One pass: the words of keys_in (and values_in, or null) stably by the
// digit (k >> shift) & (2^digit_bits - 1) into keys_out (values_out).
// offsets: the pass's 256 digit offsets (K9's); region: the pass's ticket
// and status words, zeroed, region_words of them: at least 32 + 256 a
// tile of the kernel it launches (4096 words keys-only, 6144 with
// values), or the call is refused.
extern "C" int sortx_radix_onesweep(const void* keys_in, void* keys_out,
                                    const void* values_in, void* values_out,
                                    long long n, int shift, int digit_bits,
                                    const void* offsets, void* region,
                                    long long region_words, void* stream) {
  const long long tile =
      values_in ? Sweep<true>::kTile : Sweep<false>::kTile;
  const long long tiles = (n + tile - 1) / tile;
  if (n <= 0 || n >= kMaxKeys || shift < 0 || shift > 31 ||
      digit_bits < 1 || digit_bits > 8 ||
      (values_in == nullptr) != (values_out == nullptr) ||
      region_words < kRegionHeader + tiles * kRadix) {
    return cudaErrorInvalidValue;
  }
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const uint32_t mask = (1u << digit_bits) - 1u;
  const auto* kin = static_cast<const uint32_t*>(keys_in);
  auto* kout = static_cast<uint32_t*>(keys_out);
  const auto* vin = static_cast<const uint32_t*>(values_in);
  auto* vout = static_cast<uint32_t*>(values_out);
  const auto* off = static_cast<const uint32_t*>(offsets);
  auto* reg = static_cast<uint32_t*>(region);
  if (vin) {
    radix_onesweep_kernel<true><<<static_cast<unsigned>(tiles), kThreads, 0,
                                  st>>>(kin, kout, vin, vout, n, shift, mask,
                                        off, reg);
  } else {
    radix_onesweep_kernel<false><<<static_cast<unsigned>(tiles), kThreads,
                                   0, st>>>(kin, kout, vin, vout, n, shift,
                                            mask, off, reg);
  }
  return cudaGetLastError();
}
