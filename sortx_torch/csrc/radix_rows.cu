// Segmented one-sweep LSD radix sort of the rows of an [R, L] array of
// 32-bit keys, 8-bit digits, for Hopper (sm_90a): K11 counts every pass's
// digits in each row in one read, K12 runs one stable counting pass a digit
// inside every row at once.
//
// Replaces no TPU kernel: sortx sorts rows on the bitonic network in rows
// mode (sortx/ops/rows.py), which the port ran on K1-K3 until this engine.
// It is the flat radix engine's design (csrc/radix.cu, K9 and K10: Onesweep,
// Adinets and Merrill, arXiv:2206.01784) with a tile map that keeps every
// tile inside one row, so R independent sorts run in one grid a pass.
//
// What bounds it on the card: device-memory traffic at best. K11 reads each
// key once (4 bytes); the first K12 reads the key and writes the key and
// its in-row position (made in registers), 12 bytes; each later K12 reads
// and writes both, 16 bytes: 64 bytes a key for a sort with indices, where
// the row network moved two streams through 9 passes plus its staging. The
// design:
//   - Keys arrive as the caller's own words (u32, i32 or f32 bits) and the
//     order map of ops/sort.py:_to_radix_u32 (and, descending, its
//     complement) is applied in registers by K11 and the first K12; the last
//     K12 stores the words mapped back. No pad, no staging, no fill.
//   - K11: each CTA counts one chunk of one row into per-warp rows of shared
//     counters, adds them into the row's global counts with atomics, and the
//     row's last CTA to finish (a per-row atomic ticket after a fence) turns
//     the row's counts into exclusive in-row digit offsets.
//   - K12: row r owns tickets [r T, (r + 1) T) of the pass's atomic ticket
//     counter, T = ceil(L / tile); the row's L words are spread evenly over
//     its T tiles. A CTA takes a ticket, ranks its tile's words stably as
//     K10 does, and looks back over the tiles before it in the same row;
//     the row's first tile publishes its counts as inclusive at once, so a
//     look-back chain is at most T - 1 tiles long. Ticket order is input
//     order inside each row, which with the stable rank keeps every pass
//     stable. A word goes to r L + offset[r][digit] + look-back + rank.
//   - One scratch buffer holds the offsets, K11's row tickets and each
//     pass's ticket and status words; K11's entry zeroes it with one
//     cudaMemsetAsync on the stream, so a call reads nothing on the host
//     and can be captured in a CUDA graph.
// Counts are 30 bits and R L < 2^30. Tiles, threads and K11's chunk are
// constants here: the output does not depend on them.
//
// The scans, status words, look-back and tile shapes are K10's
// (onesweep.cuh); K12 looks back over its row's status words alone, whose
// tile 0 is the row's first.

#include "onesweep.cuh"

namespace {

constexpr int kPasses = 4;      // rows sort on all 32 bits
constexpr int kRowWords = kPasses * kRadix;   // a row's offsets
constexpr long long kHistChunk = 16384;       // K11: words of a row a CTA

// The order map of ops/sort.py:_to_radix_u32 on a 32-bit word w:
// w ^ ((w's sign spread over the word & neg_mask) | pos_xor), then the
// complement under descending. u32: (0, 0); i32: (0, sign); f32: (~0, sign).
struct WordMap {
  uint32_t neg_mask, pos_xor, desc_xor;
  __device__ __forceinline__ uint32_t encode(uint32_t w) const {
    const uint32_t sign = static_cast<uint32_t>(static_cast<int32_t>(w) >> 31);
    return (w ^ ((sign & neg_mask) | pos_xor)) ^ desc_xor;
  }
  __device__ __forceinline__ uint32_t decode(uint32_t u) const {
    const uint32_t v = u ^ desc_xor;
    const uint32_t was_neg =
        static_cast<uint32_t>(static_cast<int32_t>(~v) >> 31);
    return v ^ ((was_neg & neg_mask) | pos_xor);
  }
};

// --- K11: every pass's digit counts of each row, as in-row offsets -------

__device__ __forceinline__ void count_digits(uint32_t* rows, uint32_t k) {
#pragma unroll
  for (int p = 0; p < kPasses; ++p) {
    atomicAdd(rows + p * kRadix + ((k >> (8 * p)) & 0xffu), 1u);
  }
}

__global__ void __launch_bounds__(kThreads)
    radix_rows_histogram_kernel(const uint32_t* __restrict__ keys,
                                long long len, int chunks, int wide,
                                WordMap map, uint32_t* counts,
                                uint32_t* tickets) {
  __shared__ uint32_t rows[kWarps][kRowWords];
  __shared__ uint32_t warp_sums[kWarps];
  __shared__ bool last;
  for (int i = threadIdx.x; i < kWarps * kRowWords; i += kThreads) {
    (&rows[0][0])[i] = 0;
  }
  __syncthreads();
  uint32_t* mine = rows[threadIdx.x >> 5];
  const long long row = blockIdx.x / chunks;
  const long long lo = (blockIdx.x % chunks) * kHistChunk;
  const long long hi = lo + kHistChunk < len ? lo + kHistChunk : len;
  const uint32_t* in = keys + row * len;
  if (wide) {   // L % 4 == 0 and the keys on 16 bytes: so is every chunk
    const uint4* v = reinterpret_cast<const uint4*>(in);
    const long long end = hi >> 2;
    long long i = (lo >> 2) + threadIdx.x;
    for (; i + 3 * kThreads < end; i += 4 * kThreads) {
      uint4 q[4];
#pragma unroll
      for (int u = 0; u < 4; ++u) q[u] = __ldg(v + i + u * kThreads);
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        count_digits(mine, map.encode(q[u].x));
        count_digits(mine, map.encode(q[u].y));
        count_digits(mine, map.encode(q[u].z));
        count_digits(mine, map.encode(q[u].w));
      }
    }
    for (; i < end; i += kThreads) {
      const uint4 q = __ldg(v + i);
      count_digits(mine, map.encode(q.x));
      count_digits(mine, map.encode(q.y));
      count_digits(mine, map.encode(q.z));
      count_digits(mine, map.encode(q.w));
    }
  } else {
    for (long long i = lo + threadIdx.x; i < hi; i += kThreads) {
      count_digits(mine, map.encode(__ldg(in + i)));
    }
  }
  __syncthreads();

  uint32_t* row_counts = counts + row * kRowWords;
  for (int j = threadIdx.x; j < kRowWords; j += kThreads) {
    uint32_t s = 0;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) s += rows[w][j];
    if (s) atomicAdd(row_counts + j, s);
  }
  __threadfence();   // this CTA's counts are in before its ticket
  __syncthreads();
  if (threadIdx.x == 0) {
    last = atomicAdd(tickets + row, 1u) == static_cast<uint32_t>(chunks - 1);
  }
  __syncthreads();
  if (!last) return;
  __threadfence();
  for (int p = 0; p < kPasses; ++p) {
    const uint32_t c = __ldcg(row_counts + p * kRadix + threadIdx.x);
    row_counts[p * kRadix + threadIdx.x] = block_exclusive_scan(c, warp_sums);
  }
}

// --- K12: one stable pass of one digit inside every row ------------------

// values_in null with kPairs: the first pass of a sort with indices, whose
// values are the words' in-row positions, made here.
template <bool kPairs>
__global__ void __launch_bounds__(kThreads, Sweep<kPairs>::kMinCtas)
    radix_rows_onesweep_kernel(const uint32_t* __restrict__ keys_in,
                               uint32_t* __restrict__ keys_out,
                               const uint32_t* __restrict__ values_in,
                               uint32_t* __restrict__ values_out,
                               long long len, int tiles, int tile_words,
                               int shift, int first, int last, WordMap map,
                               const uint32_t* __restrict__ offsets,
                               uint32_t* region) {
  using S = Sweep<kPairs>;
  constexpr int kItems = S::kItems;
  __shared__ uint32_t warp_counts[kWarps][kRadix];
  __shared__ uint32_t warp_peers[kWarps][kRadix];
  __shared__ uint32_t stage[S::kTile];
  __shared__ uint32_t digit_base[kRadix];
  __shared__ uint32_t warp_sums[kWarps];
  __shared__ uint32_t shared_ticket;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  uint32_t* counts = warp_counts[warp];
  uint32_t* peers_of = warp_peers[warp];
#pragma unroll
  for (int j = 0; j < kRadix / 32; ++j) {
    counts[j * 32 + lane] = 0;
    peers_of[j * 32 + lane] = 0;
  }
  if (threadIdx.x == 0) shared_ticket = atomicAdd(region, 1u);
  __syncthreads();
  const long long row = shared_ticket / tiles;
  const int tile = static_cast<int>(shared_ticket % tiles);
  uint32_t* status = region + kRegionHeader + row * tiles * kRadix;
  const long long tile_lo = static_cast<long long>(tile) * tile_words;
  const long long left = len - tile_lo;
  const int valid = left < tile_words ? static_cast<int>(left) : tile_words;
  const long long row_base = row * len;
  const int base = warp * S::kWarpWords + lane;   // in the tile
  const uint32_t* in = keys_in + row_base + tile_lo;

  uint32_t key[kItems];
#pragma unroll
  for (int i = 0; i < kItems; ++i) {
    const int idx = base + i * 32;
    key[i] = idx < valid ? __ldcs(in + idx) : 0u;
    if (first) key[i] = map.encode(key[i]);
  }
#pragma unroll
  for (int i = 0; i < kItems; ++i) {
    if (base + i * 32 < valid) {
      atomicAdd(counts + ((key[i] >> shift) & 0xffu), 1u);
    }
  }
  __syncthreads();

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

  const unsigned below = (1u << lane) - 1u;
  uint32_t rank[kItems];
#pragma unroll
  for (int i = 0; i < kItems; ++i) {
    const bool ok = base + i * 32 < valid;
    const uint32_t dd = (key[i] >> shift) & 0xffu;
    uint32_t* m = peers_of + dd;
    if (ok) atomicOr(m, 1u << lane);
    __syncwarp();
    const unsigned peers = ok ? *m : 0u;
    __syncwarp();
    const int leader = ok ? 31 - __clz(peers) : lane;
    uint32_t head = 0;
    if (ok && lane == leader) {
      *m = 0;
      head = counts[dd];
      counts[dd] = head + __popc(peers);
    }
    rank[i] = __shfl_sync(kFull, head, leader) + __popc(peers & below);
    if (ok) stage[rank[i]] = key[i];
    __syncwarp();
  }
  uint32_t value[kItems];
  if constexpr (kPairs) {
    const uint32_t* vin = values_in ? values_in + row_base + tile_lo : nullptr;
#pragma unroll
    for (int i = 0; i < kItems; ++i) {
      const int idx = base + i * 32;
      value[i] = vin ? (idx < valid ? __ldcs(vin + idx) : 0u)
                     : static_cast<uint32_t>(tile_lo + idx);
    }
  }

  uint32_t exclusive = 0;
  if (tile > 0) {
    exclusive = look_back<S::kLook>(status, tile, d);
    store_status(own, kInclusive | (exclusive + count));
  }
  digit_base[d] = offsets[row * kRowWords + d] + exclusive - start;
  __syncthreads();

  uint32_t* out = keys_out + row_base;
  uint32_t pos[kItems];
#pragma unroll
  for (int k = 0; k < kItems; ++k) {
    const int j = k * kThreads + threadIdx.x;
    if (j < valid) {
      const uint32_t w = stage[j];
      pos[k] = digit_base[(w >> shift) & 0xffu] + j;
      out[pos[k]] = last ? map.decode(w) : w;
    }
  }
  if constexpr (kPairs) {
    __syncthreads();   // every key has left the stage
#pragma unroll
    for (int i = 0; i < kItems; ++i) {
      if (base + i * 32 < valid) stage[rank[i]] = value[i];
    }
    __syncthreads();
    uint32_t* vout = values_out + row_base;
#pragma unroll
    for (int k = 0; k < kItems; ++k) {
      const int j = k * kThreads + threadIdx.x;
      if (j < valid) vout[pos[k]] = stage[j];
    }
  }
}

bool make_map(int kind, int descending, WordMap* map) {
  if (kind < 0 || kind > 2) return false;
  map->neg_mask = kind == 2 ? 0xffffffffu : 0u;
  map->pos_xor = kind == 0 ? 0u : 0x80000000u;
  map->desc_xor = descending ? 0xffffffffu : 0u;
  return true;
}

long long header_words(long long rows) {
  return rows * kRowWords + (rows + 31) / 32 * 32;
}

}  // namespace

// keys: rows x len words, row-major (0 < rows len < 2^30); kind: 0 u32,
// 1 i32, 2 f32 (the order map); scratch: scratch_words words, at least the
// offsets and the row tickets. Zeroes the whole scratch on the stream (the
// passes' tickets and status words included), then leaves in
// scratch[r * 1024 + p * 256 + d] the first place of digit d in row r of
// pass p's output.
extern "C" int sortx_radix_rows_histogram(const void* keys, long long rows,
                                          long long len, int kind,
                                          int descending, void* scratch,
                                          long long scratch_words,
                                          void* stream) {
  WordMap map;
  if (rows <= 0 || len <= 0 || rows * len >= kMaxKeys ||
      !make_map(kind, descending, &map) ||
      scratch_words < header_words(rows)) {
    return cudaErrorInvalidValue;
  }
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaMemsetAsync(
      scratch, 0, static_cast<size_t>(scratch_words) * sizeof(uint32_t), st);
  if (err != cudaSuccess) return err;
  const long long chunks = (len + kHistChunk - 1) / kHistChunk;
  auto* counts = static_cast<uint32_t*>(scratch);
  radix_rows_histogram_kernel<<<static_cast<unsigned>(rows * chunks),
                                kThreads, 0, st>>>(
      static_cast<const uint32_t*>(keys), len, static_cast<int>(chunks),
      len % 4 == 0 && reinterpret_cast<uintptr_t>(keys) % 16 == 0, map,
      counts, counts + rows * kRowWords);
  return cudaGetLastError();
}

// Pass `pass` (0..3, digit 8 pass) of every row: keys_in (and values_in)
// stably into keys_out (values_out). The first pass maps the caller's words
// by `kind` and `descending`, the last maps them back. values_out null:
// keys alone; values_in null with values_out: the first pass of a sort with
// indices, whose values are the in-row positions. offsets: K11's offsets
// (scratch's first rows x 1024 words); region: the pass's ticket and status
// words, zeroed, region_words of them: at least 32 + 256 a tile of the
// kernel it launches, or the call is refused.
extern "C" int sortx_radix_rows_onesweep(
    const void* keys_in, void* keys_out, const void* values_in,
    void* values_out, long long rows, long long len, int pass, int kind,
    int descending, const void* offsets, void* region,
    long long region_words, void* stream) {
  const bool pairs = values_out != nullptr;
  const long long tile = pairs ? Sweep<true>::kTile : Sweep<false>::kTile;
  const long long tiles = (len + tile - 1) / tile;
  WordMap map;
  if (rows <= 0 || len <= 0 || rows * len >= kMaxKeys || pass < 0 ||
      pass >= kPasses || !make_map(kind, descending, &map) ||
      (values_in != nullptr && !pairs) ||
      (pairs && values_in == nullptr && pass != 0) ||
      region_words < kRegionHeader + rows * tiles * kRadix) {
    return cudaErrorInvalidValue;
  }
  const int tile_words = static_cast<int>((len + tiles - 1) / tiles);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const unsigned grid = static_cast<unsigned>(rows * tiles);
  const auto* kin = static_cast<const uint32_t*>(keys_in);
  auto* kout = static_cast<uint32_t*>(keys_out);
  const auto* vin = static_cast<const uint32_t*>(values_in);
  auto* vout = static_cast<uint32_t*>(values_out);
  const auto* off = static_cast<const uint32_t*>(offsets) + pass * kRadix;
  auto* reg = static_cast<uint32_t*>(region);
  const int first = pass == 0;
  const int last = pass == kPasses - 1;
  if (pairs) {
    radix_rows_onesweep_kernel<true><<<grid, kThreads, 0, st>>>(
        kin, kout, vin, vout, len, static_cast<int>(tiles), tile_words,
        8 * pass, first, last, map, off, reg);
  } else {
    radix_rows_onesweep_kernel<false><<<grid, kThreads, 0, st>>>(
        kin, kout, vin, vout, len, static_cast<int>(tiles), tile_words,
        8 * pass, first, last, map, off, reg);
  }
  return cudaGetLastError();
}
