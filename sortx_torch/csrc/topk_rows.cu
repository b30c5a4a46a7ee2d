// Per-row top-k of an [R, L] array of 32-bit keys whose rows have lengths of
// their own, for Hopper (sm_90a): a radix select that reads each valid key
// twice. K13 counts each row's 11-bit first digit and picks the bucket that
// holds the row's k-th key; K14 reads every valid key once more, writes the
// keys above that bucket (the row's certain winners) to the outputs and the
// bucket's keys, with their in-row indices, to the row's candidate buffer;
// K15, one CTA a row, finishes the select on that buffer alone (two more
// digits, then the gather of the bucket's winners and first ties). The row
// network orders each row's k slots after them. This is AIR top-k's
// filtering (Zhang et al., SC'23).
//
// Replaces no TPU kernel: sortx has no per-row top-k (sortx/ops/select.py's
// top_k is 1-D, a tournament on the row network). It is the select that
// DeepSeek-V3.2's sparse-attention indexer runs on every layer: the top 2048
// of each query token's causal row of scores (Indexer.forward in the model's
// inference/model.py), which a full sort of every row would do 20 times
// over.
//
// What bounds it on the card: device-memory reads. K13 and K14 each read a
// row's valid keys once (4 bytes a key): 8 bytes a key in all, against 4
// for one read; the buffer (8 bytes a bucket key, about 1.3% of a row of
// the indexer's scores), the winners and the k output slots a row are
// small. The design:
//   - Keys arrive as the caller's own words (u32, i32 or f32 bits) and are
//     mapped in registers to the unsigned image of ops/sort.py:_to_radix_u32,
//     complemented, so that the largest key is the smallest word; the top k
//     are the k smallest words, ties to the lowest index. Nothing past
//     lengths[r] is read.
//   - The digits: bits 21..31 (K13), 10..20 and 0..9 (K15). An 11-bit first
//     digit spreads a row of scores over about a hundred bins, where 8 bits
//     crowd them into a dozen, so the bucket holds about 1.3% of a row.
//   - K13: each CTA counts one chunk of one row into per-warp 16-bit
//     counters in shared memory (two to a word) and adds them into the row's
//     counts with atomics; the row's last CTA (a per-row ticket after a
//     fence) scans the 2048 counts, picks the bucket b whose run holds the
//     row's min(k, lengths[r])-th word, and keeps b, the words still to take
//     in it (need) and its size.
//   - K14: each warp reads 512 words a step; its winners (digit < b) take
//     slots in the outputs and its bucket keys slots in the buffer from one
//     64-bit atomic on the row's counters, in no set order. A row whose
//     bucket is larger than its buffer (a low-entropy row) writes no bucket
//     key: K15 reads its whole row instead. The card decides that from the
//     row's own bucket size, with nothing read on the host.
//   - K15: one CTA a row counts the next two digits over the buffer (or the
//     row's bucket keys) in shared memory, which gives the row's k-th word T
//     and the number of its ties to keep; where the row holds more ties than
//     that, a radix select of the ties' indices finds the last tie kept, so
//     the lowest indices win whatever the buffer's order. It then writes the
//     bucket's winners after K14's and the kept ties last, each with its
//     mapped word, index and own word, and fills the slots past min(k,
//     lengths[r]) so that they sort last; the row network sorts each row by
//     (mapped word, index) with the caller's words following.
//   - One scratch buffer holds the counts, tickets and the rows' counters
//     (zeroed by one cudaMemsetAsync before K13), the rows' need, bucket and
//     size, and the candidate buffers. A call can be captured in a CUDA
//     graph.
// Tiles, threads and the chunk are constants here: which keys are selected
// does not depend on them; the slots' order does, and the row sort after
// K15 makes the result unique.

#include "onesweep.cuh"

namespace {

constexpr long long kChunk = 16384;   // words of a row a CTA, K13 and K14
constexpr int kTopBits = 11;          // K13's digit, the word's top bits
constexpr int kMidBits = 11;          // then K15's two
constexpr int kLowBits = 10;
constexpr int kBins = 1 << kTopBits;  // the most bins a digit has
constexpr int kTopShift = 32 - kTopBits;
constexpr int kBinsAThread = kBins / kThreads;
constexpr int kItems = 16;            // K14: words a lane a step
constexpr int kWarpStep = 32 * kItems;
constexpr long long kMinBuffer = 1024;   // a row's buffer holds at least
static_assert(kTopBits + kMidBits + kLowBits == 32, "the digits a word");
static_assert(kMidBits <= kTopBits && kLowBits <= kTopBits, "kBins bins");
static_assert(kChunk < (1 << 16), "K13's 16-bit counters");

// The descending order map of csrc/radix_rows.cu's WordMap: the complement
// of w ^ ((w's sign spread over the word & neg_mask) | pos_xor), and its
// inverse.
struct KeyMap {
  uint32_t neg_mask, pos_xor;
  __device__ __forceinline__ uint32_t encode(uint32_t w) const {
    const uint32_t sign = static_cast<uint32_t>(static_cast<int32_t>(w) >> 31);
    return ~(w ^ ((sign & neg_mask) | pos_xor));
  }
  // the caller's word again (a float word with its top bit set was a
  // negative key's)
  __device__ __forceinline__ uint32_t decode(uint32_t u) const {
    const uint32_t was_neg =
        static_cast<uint32_t>(static_cast<int32_t>(u) >> 31);
    return ~u ^ ((was_neg & neg_mask) | pos_xor);
  }
};

// The scratch's parts (int32 words; see sortx_topk_rows_histogram).
struct Rows {
  uint32_t* counts;            // rows x kBins: K13's, zeroed
  uint32_t* tickets;           // a row's, zeroed
  unsigned long long* taken;   // a row's: K14's winners | buffered << 32
  uint32_t* need;              // a row's keys still to take at its prefix
  uint32_t* prefix;            // its chosen digits (K15: its k-th word)
  uint32_t* bucket;            // its bucket's keys (K13's digit)
  uint32_t* buf_words;         // rows x cap: the bucket's mapped words
  uint32_t* buf_index;         // rows x cap: and their in-row indices
  long long cap;
};

__device__ __forceinline__ long long row_length(const int* lengths,
                                                long long row, long long len) {
  if (lengths == nullptr) return len;
  const long long n = lengths[row];
  return n < 0 ? 0 : (n > len ? len : n);
}

__device__ __forceinline__ uint32_t kept_of(uint32_t k, long long n) {
  return static_cast<uint32_t>(k < static_cast<uint64_t>(n) ? k : n);
}

// The bin of kBins counts (kBinsAThread consecutive ones a thread, in c)
// whose run holds the need-th counted word: its digit, the words still to
// take in it and its count, to the thread that holds it (need > 0).
struct Pick {
  uint32_t digit, need, count;
};

__device__ __forceinline__ bool pick_bin(const uint32_t (&c)[kBinsAThread],
                                         uint32_t need, uint32_t* warp_sums,
                                         Pick* out) {
  uint32_t sum = 0;
#pragma unroll
  for (int j = 0; j < kBinsAThread; ++j) sum += c[j];
  uint32_t before = block_exclusive_scan(sum, warp_sums);
  bool mine = false;
#pragma unroll
  for (int j = 0; j < kBinsAThread; ++j) {
    if (need > 0 && before < need && need <= before + c[j]) {
      *out = {static_cast<uint32_t>(kBinsAThread * threadIdx.x + j),
              need - before, c[j]};
      mine = true;
    }
    before += c[j];
  }
  return mine;
}

// --- K13: each row's first digit and the bucket chosen -------------------

__global__ void __launch_bounds__(kThreads)
    topk_rows_histogram_kernel(const uint32_t* __restrict__ keys,
                               long long len, const int* lengths, int chunks,
                               int wide, KeyMap map, uint32_t k, Rows s) {
  // per-warp 16-bit counters, two to a word: a CTA counts < 2^16 words
  __shared__ uint4 warp_rows[kWarps][kBins / 8];
  __shared__ uint32_t warp_sums[kWarps];
  __shared__ bool last;
  for (int i = threadIdx.x; i < kWarps * kBins / 8; i += kThreads) {
    (&warp_rows[0][0])[i] = make_uint4(0, 0, 0, 0);
  }
  __syncthreads();
  uint32_t* mine = reinterpret_cast<uint32_t*>(warp_rows[threadIdx.x >> 5]);
  const long long row = blockIdx.x / chunks;
  const int chunk = static_cast<int>(blockIdx.x % chunks);
  const long long n = row_length(lengths, row, len);
  const long long lo = chunk * kChunk;
  const long long hi = lo + kChunk < n ? lo + kChunk : n;
  const uint32_t* in = keys + row * len;
  auto count = [&](uint32_t w) {
    const uint32_t d = map.encode(w) >> kTopShift;
    atomicAdd(mine + (d >> 1), 1u << ((d & 1u) << 4));
  };
  long long i = lo + threadIdx.x;
  if (wide && lo < hi) {   // L % 4 == 0 and the keys on 16 bytes
    const uint4* v = reinterpret_cast<const uint4*>(in);
    const long long end = hi >> 2;
    long long j = (lo >> 2) + threadIdx.x;
    for (; j + 3 * kThreads < end; j += 4 * kThreads) {
      uint4 q[4];
#pragma unroll
      for (int u = 0; u < 4; ++u) q[u] = __ldg(v + j + u * kThreads);
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        count(q[u].x);
        count(q[u].y);
        count(q[u].z);
        count(q[u].w);
      }
    }
    for (; j < end; j += kThreads) {
      const uint4 q = __ldg(v + j);
      count(q.x);
      count(q.y);
      count(q.z);
      count(q.w);
    }
    i = (end << 2) + threadIdx.x;   // the last hi % 4 words
  }
  for (; i < hi; i += kThreads) count(__ldg(in + i));
  __syncthreads();

  // thread t sums bins 8t .. 8t + 7 over the warps (the halves add apart:
  // each stays below 2^16)
  uint32_t c[kBinsAThread];
  {
    uint4 both = make_uint4(0, 0, 0, 0);
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const uint4 q = warp_rows[w][threadIdx.x];
      both.x += q.x, both.y += q.y, both.z += q.z, both.w += q.w;
    }
    const uint32_t words[4] = {both.x, both.y, both.z, both.w};
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      c[2 * j] = words[j] & 0xffffu;
      c[2 * j + 1] = words[j] >> 16;
    }
  }
  uint32_t* row_counts = s.counts + row * kBins + kBinsAThread * threadIdx.x;
#pragma unroll
  for (int j = 0; j < kBinsAThread; ++j) {
    if (c[j]) atomicAdd(row_counts + j, c[j]);
  }
  __threadfence();   // this CTA's counts are in before its ticket
  __syncthreads();
  if (threadIdx.x == 0) {
    last = atomicAdd(s.tickets + row, 1u) == static_cast<uint32_t>(chunks - 1);
  }
  __syncthreads();
  if (!last) return;
  __threadfence();
#pragma unroll
  for (int j = 0; j < kBinsAThread; ++j) c[j] = __ldcg(row_counts + j);
  const uint32_t need = kept_of(k, n);
  Pick p;
  if (pick_bin(c, need, warp_sums, &p)) {
    s.need[row] = p.need;
    s.prefix[row] = p.digit;
    s.bucket[row] = p.count;
  } else if (need == 0 && threadIdx.x == 0) {   // an empty row
    s.need[row] = 0;
    s.prefix[row] = 0;
    s.bucket[row] = 0;
  }
}

// --- K14: each row's winners above its bucket, and the bucket's keys -----

__global__ void __launch_bounds__(kThreads)
    topk_rows_gather_kernel(const uint32_t* __restrict__ keys, long long len,
                            const int* lengths, int chunks, int wide,
                            KeyMap map, Rows s,
                            uint32_t* __restrict__ keys_out,
                            uint32_t* __restrict__ index_out,
                            uint32_t* __restrict__ words_out,
                            long long out_len) {
  const long long row = blockIdx.x / chunks;
  const int chunk = static_cast<int>(blockIdx.x % chunks);
  const long long n = row_length(lengths, row, len);
  const long long lo = chunk * kChunk;
  const long long hi = lo + kChunk < n ? lo + kChunk : n;
  if (lo >= hi) return;
  const uint32_t b = s.prefix[row];
  const bool buffered = s.bucket[row] <= s.cap;
  const uint32_t* in = keys + row * len;
  uint32_t* kout = keys_out + row * out_len;
  uint32_t* iout = index_out + row * out_len;
  uint32_t* wout = words_out + row * out_len;
  uint32_t* bw = s.buf_words + row * s.cap;
  uint32_t* bi = s.buf_index + row * s.cap;
  const int lane = threadIdx.x & 31;
  const long long steps = (hi - lo + kWarpStep - 1) / kWarpStep;
  // item 4q + e of a lane sits at base + 128q + 4 lane + e: each of its
  // four loads is 512 contiguous bytes across the warp
  auto off = [&](int j) { return (j >> 2) * 128 + lane * 4 + (j & 3); };
  auto at = [&](long long base, int j) { return base + off(j); };
  auto load = [&](long long base, uint32_t (&u)[kItems]) {
    if (wide && base + kWarpStep <= hi) {
      const uint4* v = reinterpret_cast<const uint4*>(in + base) + lane;
      uint4 q[kItems / 4];
#pragma unroll
      for (int j = 0; j < kItems / 4; ++j) q[j] = __ldg(v + 32 * j);
#pragma unroll
      for (int j = 0; j < kItems / 4; ++j) {
        u[4 * j] = q[j].x, u[4 * j + 1] = q[j].y;
        u[4 * j + 2] = q[j].z, u[4 * j + 3] = q[j].w;
      }
    } else {
#pragma unroll
      for (int j = 0; j < kItems; ++j) {
        u[j] = at(base, j) < hi ? __ldg(in + at(base, j)) : 0u;
      }
    }
  };
  // the next step's words are in flight while this step's slots are
  // taken (an atomic's round trip) and written
  uint32_t u[kItems], next[kItems];
  long long st = threadIdx.x >> 5;
  if (st < steps) load(lo + st * kWarpStep, next);
  for (; st < steps; st += kWarps) {
    const long long base = lo + st * kWarpStep;
#pragma unroll
    for (int j = 0; j < kItems; ++j) u[j] = next[j];
    if (st + kWarps < steps) load(base + kWarps * kWarpStep, next);
    const long long left = hi - base;
    const int rem = left < kWarpStep ? static_cast<int>(left) : kWarpStep;
    uint32_t wins = 0, cands = 0;   // bit j: item j is one
#pragma unroll
    for (int j = 0; j < kItems; ++j) {
      u[j] = map.encode(u[j]);
      const uint32_t d = u[j] >> kTopShift;
      const bool ok = off(j) < rem;
      wins |= static_cast<uint32_t>(ok && d < b) << j;
      cands |= static_cast<uint32_t>(ok && buffered && d == b) << j;
    }
    const uint32_t packed = __popc(wins) | (__popc(cands) << 16);
    const uint32_t incl = warp_inclusive_scan(packed, lane);
    const uint32_t total = __shfl_sync(kFull, incl, 31);
    if (total == 0) continue;
    unsigned long long old = 0;
    if (lane == 31) {
      old = atomicAdd(s.taken + row,
                      static_cast<unsigned long long>(total & 0xffffu) |
                          (static_cast<unsigned long long>(total >> 16)
                           << 32));
    }
    old = __shfl_sync(kFull, old, 31);
    const uint32_t ex = incl - packed;
    uint32_t win_slot = static_cast<uint32_t>(old) + (ex & 0xffffu);
    uint32_t buf_slot = static_cast<uint32_t>(old >> 32) + (ex >> 16);
    // a lane walks its own few hits (a store a stream each), not all its
    // items: predicated stores for every item would crowd the load and
    // store units
    for (uint32_t hits = wins | cands; hits != 0; hits &= hits - 1) {
      const int j = __ffs(hits) - 1;
      uint32_t v = u[0];
#pragma unroll
      for (int q = 1; q < kItems; ++q) v = q == j ? u[q] : v;
      const uint32_t i = static_cast<uint32_t>(at(base, j));
      if ((wins >> j) & 1u) {   // below the row's kept count by K13's pick
        kout[win_slot] = v;
        iout[win_slot] = i;
        wout[win_slot] = map.decode(v);
        ++win_slot;
      } else {                  // below the bucket's size <= cap
        bw[buf_slot] = v;
        bi[buf_slot] = i;
        ++buf_slot;
      }
    }
  }
}

// --- K15: the rest of each row's select, on its buffer -------------------

constexpr int kBatch = 8;   // K15: entries a thread loads at once

// Calls f(u, index, live) on every entry of a row's source, kBatch a
// thread at a time so that their loads are in flight together; every
// thread makes the same calls (live: the entry exists and is counted).
template <class Entry, class F>
__device__ __forceinline__ void for_entries(const Entry& entry,
                                            long long size, const F& f) {
  for (long long j0 = 0; j0 < size; j0 += kThreads * kBatch) {
    uint32_t u[kBatch], at[kBatch];
    bool live[kBatch];
#pragma unroll
    for (int q = 0; q < kBatch; ++q) {
      const long long j = j0 + q * kThreads + threadIdx.x;
      u[q] = at[q] = 0;
      live[q] = j < size && entry(j, u[q], at[q]);
    }
#pragma unroll
    for (int q = 0; q < kBatch; ++q) f(u[q], at[q], live[q]);
  }
}

// Counts digit_of(u, index) (kBins for none) over the entries of the row's
// source into hist, then picks the bin that holds the need-th; every
// thread gets the pick.
template <class Entry, class Digit>
__device__ __forceinline__ Pick select_digit(const Entry& entry,
                                             long long size,
                                             const Digit& digit_of,
                                             uint32_t need, uint32_t* hist,
                                             uint32_t* warp_sums,
                                             Pick* chosen) {
  for (int i = threadIdx.x; i < kBins; i += kThreads) hist[i] = 0;
  __syncthreads();
  for_entries(entry, size, [&](uint32_t u, uint32_t at, bool live) {
    const uint32_t d = live ? digit_of(u, at) : kBins;
    if (d < kBins) atomicAdd(hist + d, 1u);
  });
  __syncthreads();
  uint32_t c[kBinsAThread];
#pragma unroll
  for (int j = 0; j < kBinsAThread; ++j) {
    c[j] = hist[kBinsAThread * threadIdx.x + j];
  }
  Pick p;
  if (pick_bin(c, need, warp_sums, &p)) *chosen = p;
  __syncthreads();
  return *chosen;
}

// six CTAs an SM: a row's CTA is a chain of short dependent phases, so
// more rows in flight hide them
__global__ void __launch_bounds__(kThreads, 6)
    topk_rows_buffer_select_kernel(const uint32_t* __restrict__ keys,
                                   long long len, const int* lengths,
                                   KeyMap map, uint32_t k, Rows s,
                                   uint32_t* __restrict__ keys_out,
                                   uint32_t* __restrict__ index_out,
                                   uint32_t* __restrict__ words_out,
                                   long long out_len, uint32_t lowest,
                                   unsigned long long* counted) {
  __shared__ uint32_t hist[kBins];
  __shared__ uint32_t warp_sums[kWarps];
  __shared__ Pick chosen;
  __shared__ uint32_t slots[2];   // the bucket's winners and ties written
  const long long row = blockIdx.x;
  const long long n = row_length(lengths, row, len);
  const uint32_t kept = kept_of(k, n);
  uint32_t* kout = keys_out + row * out_len;
  uint32_t* iout = index_out + row * out_len;
  uint32_t* wout = words_out + row * out_len;
  for (long long j = kept + threadIdx.x; j < out_len; j += kThreads) {
    kout[j] = ~0u;   // the slots past the kept keys sort last
    iout[j] = ~0u;
    wout[j] = lowest;
  }
  const uint32_t size_b = s.bucket[row];
  const bool buffered = size_b <= s.cap;
  if (counted != nullptr && threadIdx.x == 0) {
    atomicAdd(counted, buffered ? 1ull : 0ull);
    atomicAdd(counted + 1, 1ull);
  }
  if (kept == 0) return;
  const uint32_t top = s.prefix[row];
  const uint32_t* in = keys + row * len;
  const uint32_t* bw = s.buf_words + row * s.cap;
  const uint32_t* bi = s.buf_index + row * s.cap;
  // entry j of the row's source: its buffer, or where that could not hold
  // the bucket, the row (whose keys outside the bucket are skipped)
  const long long size = buffered ? size_b : n;
  auto entry = [&](long long j, uint32_t& u, uint32_t& at) {
    if (buffered) {
      u = bw[j];
      at = bi[j];
      return true;
    }
    u = map.encode(__ldg(in + j));
    at = static_cast<uint32_t>(j);
    return (u >> kTopShift) == top;
  };
  const Pick mid = select_digit(
      entry, size,
      [](uint32_t u, uint32_t) { return (u >> kLowBits) & (kBins - 1); },
      s.need[row], hist, warp_sums, &chosen);
  const uint32_t high = (top << kMidBits) | mid.digit;   // bits 10..31
  const Pick low = select_digit(
      entry, size,
      [high](uint32_t u, uint32_t) {
        return (u >> kLowBits) == high ? u & ((1u << kLowBits) - 1)
                                       : static_cast<uint32_t>(kBins);
      },
      mid.need, hist, warp_sums, &chosen);
  const uint32_t T = (high << kLowBits) | low.digit;
  const uint32_t ties = low.need;   // ties kept, of low.count in the row
  // where the row holds more ties than it keeps: the index of the last
  // kept one, a radix select over the ties' indices (n >= 2 here)
  uint32_t last_tie = ~0u;
  if (low.count > ties) {
    int hi_bit = 32 - __clz(static_cast<uint32_t>(n - 1));
    uint32_t got = 0, need = ties;
    while (hi_bit > 0) {
      const int w = hi_bit < kTopBits ? hi_bit : kTopBits;
      const int sh = hi_bit - w;
      const Pick p = select_digit(
          entry, size,
          [=](uint32_t u, uint32_t at) {
            return u == T && (at >> hi_bit) == got
                       ? (at >> sh) & ((1u << w) - 1)
                       : static_cast<uint32_t>(kBins);
          },
          need, hist, warp_sums, &chosen);
      got = (got << w) | p.digit;
      need = p.need;
      hi_bit = sh;
    }
    last_tie = got;
  }
  // the bucket's winners after K14's; the kept ties after all winners
  if (threadIdx.x == 0) slots[0] = slots[1] = 0;
  __syncthreads();
  const uint32_t first_win = static_cast<uint32_t>(s.taken[row]);
  const uint32_t first_tie = kept - ties;
  const int lane = threadIdx.x & 31;
  const uint32_t below = (1u << lane) - 1u;
  for_entries(entry, size, [&](uint32_t u, uint32_t at, bool live) {
    const bool win = live && u < T;
    const bool tie = live && u == T && at <= last_tie;
    const uint32_t wm = __ballot_sync(kFull, win);
    const uint32_t tm = __ballot_sync(kFull, tie);
    if ((wm | tm) == 0) return;
    uint32_t wb = 0, tb = 0;
    if (lane == 0) {
      if (wm) wb = atomicAdd(slots, __popc(wm));
      if (tm) tb = atomicAdd(slots + 1, __popc(tm));
    }
    wb = __shfl_sync(kFull, wb, 0);
    tb = __shfl_sync(kFull, tb, 0);
    uint32_t slot = 0;
    if (win) slot = first_win + wb + __popc(wm & below);
    if (tie) slot = first_tie + tb + __popc(tm & below);
    if (win || tie) {
      kout[slot] = u;
      iout[slot] = at;
      wout[slot] = map.decode(u);
    }
  });
  if (threadIdx.x == 0) {
    s.need[row] = ties;
    s.prefix[row] = T;
  }
}

bool make_map(int kind, KeyMap* map) {
  if (kind < 0 || kind > 2) return false;
  map->neg_mask = kind == 2 ? 0xffffffffu : 0u;
  map->pos_xor = kind == 0 ? 0u : 0x80000000u;
  return true;
}

long long pad32(long long n) { return (n + 31) / 32 * 32; }

long long chunks_of(long long len) { return (len + kChunk - 1) / kChunk; }

// a row's candidate buffer: a sixteenth of the row, at least kMinBuffer
// keys and at most the row
long long buffer_cap(long long len) {
  const long long sixteenth = (len + 15) / 16;
  const long long cap = sixteenth > kMinBuffer ? sixteenth : kMinBuffer;
  return cap < len ? cap : len;
}

// The parts of the scratch (null pointers for a null scratch); returns its
// words, the first `zeroed` of which K13's entry zeroes.
long long layout(void* scratch, long long rows, long long len, Rows* s,
                 long long* zeroed) {
  auto* w = static_cast<uint32_t*>(scratch);
  long long at = 0;
  auto take = [&](long long words) {
    uint32_t* p = w ? w + at : nullptr;
    at += pad32(words);
    return p;
  };
  s->cap = buffer_cap(len);
  s->counts = take(rows * kBins);
  s->tickets = take(rows);
  s->taken = reinterpret_cast<unsigned long long*>(take(2 * rows));
  *zeroed = at;
  s->need = take(rows);
  s->prefix = take(rows);
  s->bucket = take(rows);
  s->buf_words = take(rows * s->cap);
  s->buf_index = take(rows * s->cap);
  return at;
}

bool valid_call(long long rows, long long len, int kind, long long k,
                long long scratch_words, KeyMap* map, Rows* s,
                long long* zeroed) {
  return rows > 0 && rows < (1LL << 31) && len > 0 && len < (1LL << 31) &&
         k > 0 && k < (1LL << 31) && rows * chunks_of(len) < (1LL << 31) &&
         make_map(kind, map) &&
         layout(nullptr, rows, len, s, zeroed) <= scratch_words;
}

}  // namespace

// keys: rows x len words, row-major; lengths: rows int32 (null: every row
// len long; each clamped to [0, len]); kind: 0 u32, 1 i32, 2 f32 (the order
// map); k: the keys kept a row (> 0). scratch: scratch_words words laid out
// as `layout` says: the counts (rows x 2048), tickets and the rows' 64-bit
// counters, zeroed on the stream here; then each row's need, prefix and
// bucket size, and the candidate buffers (rows x cap words and indices).
// After K13 a row's prefix is its bucket (the top 11 bits of its k-th
// largest key's word), need the words still to take in it and bucket its
// keys.
extern "C" int sortx_topk_rows_histogram(const void* keys, long long rows,
                                         long long len, const void* lengths,
                                         int kind, long long k, void* scratch,
                                         long long scratch_words,
                                         void* stream) {
  KeyMap map;
  Rows s;
  long long zeroed = 0;
  if (!valid_call(rows, len, kind, k, scratch_words, &map, &s, &zeroed)) {
    return cudaErrorInvalidValue;
  }
  layout(scratch, rows, len, &s, &zeroed);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const cudaError_t err = cudaMemsetAsync(
      scratch, 0, static_cast<size_t>(zeroed) * sizeof(uint32_t), st);
  if (err != cudaSuccess) return err;
  const long long chunks = chunks_of(len);
  const int wide = len % 4 == 0 && reinterpret_cast<uintptr_t>(keys) % 16 == 0;
  topk_rows_histogram_kernel<<<static_cast<unsigned>(rows * chunks),
                               kThreads, 0, st>>>(
      static_cast<const uint32_t*>(keys), len,
      static_cast<const int*>(lengths), static_cast<int>(chunks), wide, map,
      static_cast<uint32_t>(k), s);
  return cudaGetLastError();
}

// After K13: each row's keys above its bucket (its certain winners) into
// the first slots of keys_out (mapped words), index_out (in-row indices)
// and words_out (the caller's words), rows of out_len >= k words, in no set
// order; and, where the bucket fits the row's buffer, the bucket's keys
// (mapped word and index) into it, in no set order. The row's 64-bit
// counter ends at winners | buffered keys << 32.
extern "C" int sortx_topk_rows_gather(const void* keys, long long rows,
                                      long long len, const void* lengths,
                                      int kind, long long k, void* scratch,
                                      long long scratch_words, void* keys_out,
                                      void* index_out, void* words_out,
                                      long long out_len, void* stream) {
  KeyMap map;
  Rows s;
  long long zeroed = 0;
  if (out_len < k ||
      !valid_call(rows, len, kind, k, scratch_words, &map, &s, &zeroed)) {
    return cudaErrorInvalidValue;
  }
  layout(scratch, rows, len, &s, &zeroed);
  const long long chunks = chunks_of(len);
  const int wide = len % 4 == 0 && reinterpret_cast<uintptr_t>(keys) % 16 == 0;
  topk_rows_gather_kernel<<<static_cast<unsigned>(rows * chunks), kThreads,
                            0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(keys), len,
      static_cast<const int*>(lengths), static_cast<int>(chunks), wide, map,
      s, static_cast<uint32_t*>(keys_out), static_cast<uint32_t*>(index_out),
      static_cast<uint32_t*>(words_out), out_len);
  return cudaGetLastError();
}

// After K14: the rest of each row's min(k, lengths[r]) largest keys into
// the outputs (the bucket's winners after K14's, then the kept ties, in no
// set order) and each row's later slots 0xFFFFFFFF, 0xFFFFFFFF and
// `lowest`. A row's prefix ends as its k-th largest key's word and need as
// the number of its ties kept. counted: null, or two 64-bit counters that
// each row adds to: 1 where its later rounds and gather read its buffer
// alone, and 1.
extern "C" int sortx_topk_rows_buffer_select(
    const void* keys, long long rows, long long len, const void* lengths,
    int kind, long long k, void* scratch, long long scratch_words,
    void* keys_out, void* index_out, void* words_out, long long out_len,
    int lowest, void* counted, void* stream) {
  KeyMap map;
  Rows s;
  long long zeroed = 0;
  if (out_len < k ||
      !valid_call(rows, len, kind, k, scratch_words, &map, &s, &zeroed)) {
    return cudaErrorInvalidValue;
  }
  layout(scratch, rows, len, &s, &zeroed);
  topk_rows_buffer_select_kernel<<<static_cast<unsigned>(rows), kThreads, 0,
                                   static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(keys), len,
      static_cast<const int*>(lengths), map, static_cast<uint32_t>(k), s,
      static_cast<uint32_t*>(keys_out), static_cast<uint32_t*>(index_out),
      static_cast<uint32_t*>(words_out), out_len,
      static_cast<uint32_t>(lowest),
      static_cast<unsigned long long*>(counted));
  return cudaGetLastError();
}
