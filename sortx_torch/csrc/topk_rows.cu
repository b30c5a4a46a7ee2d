// Per-row top-k of an [R, L] array of 32-bit keys whose rows have lengths of
// their own, for Hopper (sm_90a): a radix select. K13 counts one 8-bit digit
// a round over each row's first lengths[r] keys, under the prefix the rounds
// before it chose, and picks the digit that holds the row's k-th key; after
// four rounds each row knows its k-th key T and how many of its ties to take.
// K14 then gathers each row's winners (the keys above T, and the first ties
// in row order) with their in-row indices and own words; the row network
// orders them.
//
// Replaces no TPU kernel: sortx has no per-row top-k (sortx/ops/select.py's
// top_k is 1-D, a tournament on the row network). It is the select that
// DeepSeek-V3.2's sparse-attention indexer runs on every layer: the top 2048
// of each query token's causal row of scores (Indexer.forward in the model's
// inference/model.py), which a full sort of every row would do 20 times
// over.
//
// What bounds it on the card: device-memory reads. Each round reads a row's
// valid keys once (4 bytes a key), and K14 once more: 20 bytes a key in all,
// against 4 for one read; the outputs (k slots a row of 12 bytes) are small.
// The design:
//   - Keys arrive as the caller's own words (u32, i32 or f32 bits) and are
//     mapped in registers to the unsigned image of ops/sort.py:_to_radix_u32,
//     complemented, so that the largest key is the smallest word; the top k
//     are the k smallest words, ties to the lowest index. Nothing past
//     lengths[r] is read.
//   - K13: each CTA counts one chunk of one row into per-warp rows of shared
//     counters (K11's scheme) and adds them into the row's counts with
//     atomics; the row's last CTA (a per-row ticket after a fence) scans the
//     256 counts, picks the digit b whose run holds the row's need-th word,
//     takes the words below it off need, appends b to the row's prefix, and
//     zeroes the counts and the ticket for the next round. Round 0 sets need
//     to min(k, lengths[r]). The last round also keeps each chunk's counts,
//     and the row's last CTA turns those of the chosen digit into each
//     chunk's count of earlier ties.
//   - K14: each CTA reads one chunk in row order, 2048 words at a time; a
//     block-wide OR skips a step that holds no winner and no tie. Where one
//     does, a block scan ranks the step's winners and ties in row order:
//     winners (word < T) take slots from the row's atomic counter, ties
//     (word == T) their rank among the row's ties, kept below need, after
//     the winners; each carries its mapped word, its index and the
//     caller's word. The row's first CTA writes its slots past min(k,
//     lengths[r]) so that they sort last. The row network then sorts each
//     row by (mapped word, index) with the caller's words following, so no
//     pass decodes the words.
//   - One scratch buffer holds the counts, tickets and winner counters
//     (zeroed by one cudaMemsetAsync in round 0's entry) and the rows'
//     need, prefix, chunk tie bases and last-round chunk counts, which each
//     round writes before they are read. Nothing is read on the host, so a
//     call can be captured in a CUDA graph.
// Tiles, threads and the chunk are constants here: which keys are selected
// does not depend on them; the winners' slot order does, and the row sort
// after K14 makes the result unique.

#include "onesweep.cuh"

namespace {

constexpr long long kChunk = 16384;   // words of a row a CTA, K13 and K14
constexpr int kGatherItems = 8;       // K14: words a thread a step
constexpr int kStep = kThreads * kGatherItems;

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
  uint32_t* counts;         // rows x 256, zero between rounds
  uint32_t* tickets;        // a row's, zero between rounds
  uint32_t* taken;          // K14's winner counter a row, zero
  uint32_t* need;           // a row's keys still to take at its prefix
  uint32_t* prefix;         // a row's chosen digits so far
  uint32_t* tie_base;       // rows x chunks: ties in the chunks before
  uint32_t* chunk_counts;   // rows x chunks x 256: the last round's
};

__device__ __forceinline__ long long row_length(const int* lengths,
                                                long long row, long long len) {
  if (lengths == nullptr) return len;
  const long long n = lengths[row];
  return n < 0 ? 0 : (n > len ? len : n);
}

// --- K13: one digit a row under the row's prefix, and the digit chosen ---

template <bool kFiltered, bool kLast>
__global__ void __launch_bounds__(kThreads)
    topk_rows_histogram_kernel(const uint32_t* __restrict__ keys,
                               long long len, const int* lengths, int chunks,
                               int wide, KeyMap map, uint32_t k, int shift,
                               Rows s) {
  __shared__ uint32_t warp_rows[kWarps][kRadix];
  __shared__ uint32_t warp_sums[kWarps];
  __shared__ uint32_t chosen, total;
  __shared__ bool last;
  for (int i = threadIdx.x; i < kWarps * kRadix; i += kThreads) {
    (&warp_rows[0][0])[i] = 0;
  }
  __syncthreads();
  uint32_t* mine = warp_rows[threadIdx.x >> 5];
  const long long row = blockIdx.x / chunks;
  const int chunk = static_cast<int>(blockIdx.x % chunks);
  const long long n = row_length(lengths, row, len);
  const long long lo = chunk * kChunk;
  const long long hi = lo + kChunk < n ? lo + kChunk : n;
  const uint32_t pre = kFiltered ? s.prefix[row] : 0u;
  const uint32_t* in = keys + row * len;
  auto count = [&](uint32_t w) {
    const uint32_t u = map.encode(w);
    if (!kFiltered || (u >> (shift + 8)) == pre) {
      atomicAdd(mine + ((u >> shift) & 0xffu), 1u);
    }
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

  const int d = threadIdx.x;
  uint32_t* row_counts = s.counts + row * kRadix;
  uint32_t c = 0;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) c += warp_rows[w][d];
  if (c) atomicAdd(row_counts + d, c);
  if (kLast) s.chunk_counts[(row * chunks + chunk) * kRadix + d] = c;
  __threadfence();   // this CTA's counts are in before its ticket
  __syncthreads();
  if (threadIdx.x == 0) {
    last = atomicAdd(s.tickets + row, 1u) == static_cast<uint32_t>(chunks - 1);
  }
  __syncthreads();
  if (!last) return;
  __threadfence();
  const uint32_t all = __ldcg(row_counts + d);
  row_counts[d] = 0;
  const uint32_t before = block_exclusive_scan(all, warp_sums);
  const uint32_t need =
      kFiltered ? s.need[row]
                : static_cast<uint32_t>(k < static_cast<uint64_t>(n) ? k : n);
  if (threadIdx.x == 0) {
    s.tickets[row] = 0;
    chosen = 0;
    if (need == 0) {   // an empty row: nothing to choose
      s.need[row] = 0;
      s.prefix[row] = pre << 8;
    }
  }
  __syncthreads();
  if (need > 0 && before < need && need <= before + all) {
    s.need[row] = need - before;
    s.prefix[row] = (pre << 8) | static_cast<uint32_t>(d);
    chosen = d;
  }
  if (!kLast) return;
  __syncthreads();
  // each chunk's ties (words equal to the row's k-th) in the chunks before
  const uint32_t b = chosen;
  uint32_t carry = 0;
  for (int c0 = 0; c0 < chunks; c0 += kThreads) {
    const int ci = c0 + threadIdx.x;
    const uint32_t t =
        ci < chunks ? __ldcg(s.chunk_counts + (row * chunks + ci) * kRadix + b)
                    : 0u;
    const uint32_t ex = block_exclusive_scan(t, warp_sums);
    if (ci < chunks) s.tie_base[row * chunks + ci] = carry + ex;
    if (threadIdx.x == kThreads - 1) total = ex + t;
    __syncthreads();
    carry += total;
  }
}

// --- K14: each row's winners and first ties, with their indices ----------

__global__ void __launch_bounds__(kThreads)
    topk_rows_gather_kernel(const uint32_t* __restrict__ keys, long long len,
                            const int* lengths, int chunks, int wide,
                            KeyMap map, uint32_t k, Rows s,
                            uint32_t* __restrict__ keys_out,
                            uint32_t* __restrict__ index_out,
                            uint32_t* __restrict__ words_out,
                            long long out_len, uint32_t lowest) {
  __shared__ uint32_t warp_sums[kWarps];
  __shared__ uint32_t step_base, step_ties;
  const long long row = blockIdx.x / chunks;
  const int chunk = static_cast<int>(blockIdx.x % chunks);
  const long long n = row_length(lengths, row, len);
  const uint32_t kept = static_cast<uint32_t>(
      k < static_cast<uint64_t>(n) ? k : n);
  uint32_t* kout = keys_out + row * out_len;
  uint32_t* iout = index_out + row * out_len;
  uint32_t* wout = words_out + row * out_len;
  if (chunk == 0) {   // the row's slots past its kept keys: sorted last
    for (long long j = kept + threadIdx.x; j < out_len; j += kThreads) {
      kout[j] = ~0u;
      iout[j] = ~0u;
      wout[j] = lowest;
    }
  }
  const long long lo = chunk * kChunk;
  const long long hi = lo + kChunk < n ? lo + kChunk : n;
  if (lo >= hi) return;
  const uint32_t T = s.prefix[row];
  const uint32_t need = s.need[row];
  const uint32_t first_tie = kept - need;   // the winners' slots come first
  uint32_t ties = s.tie_base[row * chunks + chunk];
  const uint32_t* in = keys + row * len;
  for (long long base = lo; base < hi; base += kStep) {
    const long long i0 = base + threadIdx.x * kGatherItems;
    uint32_t u[kGatherItems];
    if (wide && i0 + kGatherItems <= hi) {
      const uint4* v = reinterpret_cast<const uint4*>(in + i0);
      uint4 q[kGatherItems / 4];
#pragma unroll
      for (int j = 0; j < kGatherItems / 4; ++j) q[j] = __ldg(v + j);
#pragma unroll
      for (int j = 0; j < kGatherItems / 4; ++j) {
        u[4 * j] = q[j].x, u[4 * j + 1] = q[j].y;
        u[4 * j + 2] = q[j].z, u[4 * j + 3] = q[j].w;
      }
    } else {
#pragma unroll
      for (int j = 0; j < kGatherItems; ++j) {
        u[j] = i0 + j < hi ? __ldg(in + i0 + j) : 0u;
      }
    }
    uint32_t wins = 0, tied = 0;
#pragma unroll
    for (int j = 0; j < kGatherItems; ++j) {
      u[j] = map.encode(u[j]);
      const bool ok = i0 + j < hi;
      wins += ok && u[j] < T;
      tied += ok && u[j] == T;
    }
    if (!__syncthreads_or(wins | tied)) continue;
    const uint32_t packed = wins | (tied << 16);
    const uint32_t ex = block_exclusive_scan(packed, warp_sums);
    if (threadIdx.x == kThreads - 1) {
      const uint32_t sum = ex + packed;
      step_base = (sum & 0xffffu) ? atomicAdd(s.taken + row, sum & 0xffffu)
                                  : 0u;
      step_ties = sum >> 16;
    }
    __syncthreads();
    uint32_t win_slot = step_base + (ex & 0xffffu);
    uint32_t tie_rank = ties + (ex >> 16);
#pragma unroll
    for (int j = 0; j < kGatherItems; ++j) {
      if (i0 + j >= hi) continue;
      const uint32_t at = static_cast<uint32_t>(i0 + j);
      if (u[j] < T) {
        kout[win_slot] = u[j];
        iout[win_slot] = at;
        wout[win_slot] = map.decode(u[j]);
        ++win_slot;
      } else if (u[j] == T) {
        if (tie_rank < need) {
          kout[first_tie + tie_rank] = u[j];
          iout[first_tie + tie_rank] = at;
          wout[first_tie + tie_rank] = map.decode(u[j]);
        }
        ++tie_rank;
      }
    }
    ties += step_ties;
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

// The parts of the scratch (null pointers for a null scratch); returns its
// words, the first `zeroed` of which round 0's entry zeroes.
long long layout(void* scratch, long long rows, long long len, Rows* s,
                 long long* zeroed) {
  auto* w = static_cast<uint32_t*>(scratch);
  const long long chunks = chunks_of(len);
  long long at = 0;
  auto take = [&](long long words) {
    uint32_t* p = w ? w + at : nullptr;
    at += pad32(words);
    return p;
  };
  s->counts = take(rows * kRadix);
  s->tickets = take(rows);
  s->taken = take(rows);
  *zeroed = at;
  s->need = take(rows);
  s->prefix = take(rows);
  s->tie_base = take(rows * chunks);
  s->chunk_counts = take(rows * chunks * kRadix);
  return at;
}

bool valid_call(long long rows, long long len, int kind, long long k,
                long long scratch_words, KeyMap* map, Rows* s,
                long long* zeroed) {
  return rows > 0 && len > 0 && len < (1LL << 31) && k > 0 &&
         k < (1LL << 31) && rows * chunks_of(len) < (1LL << 31) &&
         make_map(kind, map) &&
         layout(nullptr, rows, len, s, zeroed) <= scratch_words;
}

}  // namespace

// keys: rows x len words, row-major; lengths: rows int32 (null: every row
// len long; each clamped to [0, len]); kind: 0 u32, 1 i32, 2 f32 (the order
// map); k: the keys kept a row (> 0); round: 0..3, the digit at bit 24 - 8
// round. scratch: scratch_words words laid out as `layout` says: the counts
// (rows x 256), tickets and winner counters, zeroed on the stream by round
// 0's entry; then each row's need and prefix, its chunks' tie bases and the
// last round's chunk counts. After round 3 a row's prefix is its k-th
// largest key's word and need the number of its ties to keep.
extern "C" int sortx_topk_rows_histogram(const void* keys, long long rows,
                                         long long len, const void* lengths,
                                         int kind, long long k, int round,
                                         void* scratch,
                                         long long scratch_words,
                                         void* stream) {
  KeyMap map;
  Rows s;
  long long zeroed = 0;
  if (round < 0 || round > 3 ||
      !valid_call(rows, len, kind, k, scratch_words, &map, &s, &zeroed)) {
    return cudaErrorInvalidValue;
  }
  layout(scratch, rows, len, &s, &zeroed);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (round == 0) {
    const cudaError_t err = cudaMemsetAsync(
        scratch, 0, static_cast<size_t>(zeroed) * sizeof(uint32_t), st);
    if (err != cudaSuccess) return err;
  }
  const long long chunks = chunks_of(len);
  const auto* in = static_cast<const uint32_t*>(keys);
  const auto* ln = static_cast<const int*>(lengths);
  const int wide = len % 4 == 0 && reinterpret_cast<uintptr_t>(keys) % 16 == 0;
  const unsigned grid = static_cast<unsigned>(rows * chunks);
  const int shift = 24 - 8 * round;
  const auto kk = static_cast<uint32_t>(k);
  const int c = static_cast<int>(chunks);
  if (round == 0) {
    topk_rows_histogram_kernel<false, false><<<grid, kThreads, 0, st>>>(
        in, len, ln, c, wide, map, kk, shift, s);
  } else if (round < 3) {
    topk_rows_histogram_kernel<true, false><<<grid, kThreads, 0, st>>>(
        in, len, ln, c, wide, map, kk, shift, s);
  } else {
    topk_rows_histogram_kernel<true, true><<<grid, kThreads, 0, st>>>(
        in, len, ln, c, wide, map, kk, shift, s);
  }
  return cudaGetLastError();
}

// After the four rounds: each row's min(k, lengths[r]) largest keys, as
// their mapped words into keys_out, their in-row indices into index_out and
// the caller's own words into words_out (rows of out_len >= k words; the
// winners in the first slots in no set order, then the ties in row order;
// each row's later slots 0xFFFFFFFF, 0xFFFFFFFF and `lowest`).
extern "C" int sortx_topk_rows_gather(const void* keys, long long rows,
                                      long long len, const void* lengths,
                                      int kind, long long k, void* scratch,
                                      long long scratch_words, void* keys_out,
                                      void* index_out, void* words_out,
                                      long long out_len, int lowest,
                                      void* stream) {
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
      static_cast<uint32_t>(k), s, static_cast<uint32_t*>(keys_out),
      static_cast<uint32_t*>(index_out), static_cast<uint32_t*>(words_out),
      out_len, static_cast<uint32_t>(lowest));
  return cudaGetLastError();
}
