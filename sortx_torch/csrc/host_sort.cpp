// Host sort, scan and k-way merge of u32 words: the port's own copy of
// csrc/host_sort.cpp (the C++ analog of the reference's CPU golden sort,
// Tahoe/Algorithm/Sort/RadixSort.cpp:10-104). Stable 8-bit LSD radix sort
// (keys-only and key-value, partial sort_bits), exclusive scan, and the
// stable parallel k-way merge of sorted runs that assembles the
// out-of-core sort (sortx_torch.sort_large). Exposed through a C ABI and
// bound with ctypes by sortx_torch/runtime/native.py, which compiles it
// with the host C++ compiler at first use.

#include <algorithm>
#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <thread>
#include <vector>

namespace {

constexpr int kBitsPerPass = 8;                 // RadixSort.h:41
constexpr int kNumTables = 1 << kBitsPerPass;   // RadixSort.h:43
// Below this, thread spawn overhead beats the parallel speedup.
constexpr int64_t kParallelMin = int64_t{1} << 20;

int num_threads(int64_t n) {
  unsigned hw = std::thread::hardware_concurrency();
  if (hw == 0) hw = 1;
  // SORTX_NATIVE_THREADS caps the per-call pool, for callers that run
  // several merges at once and would otherwise oversubscribe the cores.
  if (const char* env = std::getenv("SORTX_NATIVE_THREADS")) {
    long cap = std::strtol(env, nullptr, 10);
    if (cap >= 1 && cap < static_cast<long>(hw)) {
      hw = static_cast<unsigned>(cap);
    }
  }
  int t = static_cast<int>(std::min<unsigned>(hw, 16));
  // Keep >= 2^18 elements per thread so phase-3 scatter stays useful.
  while (t > 1 && n / t < (int64_t{1} << 18)) --t;
  return t;
}

// One stable counting pass over `width` low bits starting at `shift`.
template <bool kHasValues>
void counting_pass(const uint32_t* keys_in, const uint32_t* vals_in,
                   uint32_t* keys_out, uint32_t* vals_out, int64_t n,
                   int shift, int width) {
  const uint32_t mask = (width >= 32) ? 0xFFFFFFFFu : ((1u << width) - 1u);
  int64_t counts[kNumTables] = {0};
  for (int64_t i = 0; i < n; ++i) {
    counts[(keys_in[i] >> shift) & mask]++;
  }
  int64_t offsets[kNumTables];
  int64_t running = 0;
  for (int t = 0; t < kNumTables; ++t) {
    offsets[t] = running;
    running += counts[t];
  }
  for (int64_t i = 0; i < n; ++i) {
    const uint32_t d = (keys_in[i] >> shift) & mask;
    const int64_t dst = offsets[d]++;
    keys_out[dst] = keys_in[i];
    if (kHasValues) vals_out[dst] = vals_in[i];
  }
}

// Parallel stable counting pass: per-chunk histograms, then global
// offsets laid out digit-major with chunks in order INSIDE each digit
// (chunk order == original order => the pass stays stable), then each
// thread scatters its own chunk against its own offset row. The
// reference's host path is strictly serial (RadixSort.cpp:58-104); this
// is the beyond-reference native speedup, same contract.
template <bool kHasValues>
void counting_pass_mt(const uint32_t* keys_in, const uint32_t* vals_in,
                      uint32_t* keys_out, uint32_t* vals_out, int64_t n,
                      int shift, int width, int nt) {
  const uint32_t mask = (width >= 32) ? 0xFFFFFFFFu : ((1u << width) - 1u);
  const int64_t chunk = (n + nt - 1) / nt;
  std::vector<int64_t> counts(static_cast<size_t>(nt) * kNumTables, 0);
  {
    std::vector<std::thread> ts;
    ts.reserve(nt);
    for (int t = 0; t < nt; ++t) {
      ts.emplace_back([&, t] {
        const int64_t lo = t * chunk;
        const int64_t hi = std::min<int64_t>(lo + chunk, n);
        int64_t* c = counts.data() + static_cast<size_t>(t) * kNumTables;
        for (int64_t i = lo; i < hi; ++i) {
          c[(keys_in[i] >> shift) & mask]++;
        }
      });
    }
    for (auto& th : ts) th.join();
  }
  // offsets[t][d] = sum over (d' < d, all t') + (d, t' < t)
  int64_t running = 0;
  for (int d = 0; d < kNumTables; ++d) {
    for (int t = 0; t < nt; ++t) {
      int64_t& slot = counts[static_cast<size_t>(t) * kNumTables + d];
      const int64_t c = slot;
      slot = running;                 // reuse the table as offsets
      running += c;
    }
  }
  {
    std::vector<std::thread> ts;
    ts.reserve(nt);
    for (int t = 0; t < nt; ++t) {
      ts.emplace_back([&, t] {
        const int64_t lo = t * chunk;
        const int64_t hi = std::min<int64_t>(lo + chunk, n);
        int64_t* off = counts.data() + static_cast<size_t>(t) * kNumTables;
        for (int64_t i = lo; i < hi; ++i) {
          const uint32_t d = (keys_in[i] >> shift) & mask;
          const int64_t dst = off[d]++;
          keys_out[dst] = keys_in[i];
          if (kHasValues) vals_out[dst] = vals_in[i];
        }
      });
    }
    for (auto& th : ts) th.join();
  }
}

template <bool kHasValues>
void radix_sort_impl(uint32_t* keys, uint32_t* vals, int64_t n,
                     int sort_bits) {
  if (n <= 1 || sort_bits <= 0) return;
  std::vector<uint32_t> tmp_keys(n);
  std::vector<uint32_t> tmp_vals(kHasValues ? n : 0);
  uint32_t* ka = keys;
  uint32_t* kb = tmp_keys.data();
  uint32_t* va = vals;
  uint32_t* vb = kHasValues ? tmp_vals.data() : nullptr;
  const int nt = (n >= kParallelMin) ? num_threads(n) : 1;
  for (int shift = 0; shift < sort_bits; shift += kBitsPerPass) {
    const int width = (sort_bits - shift < kBitsPerPass)
                          ? (sort_bits - shift) : kBitsPerPass;
    if (nt > 1) {
      counting_pass_mt<kHasValues>(ka, va, kb, vb, n, shift, width, nt);
    } else {
      counting_pass<kHasValues>(ka, va, kb, vb, n, shift, width);
    }
    std::swap(ka, kb);
    std::swap(va, vb);
  }
  if (ka != keys) {
    std::memcpy(keys, ka, sizeof(uint32_t) * n);
    if (kHasValues) std::memcpy(vals, va, sizeof(uint32_t) * n);
  }
}

// ---- parallel k-way merge of sorted runs (out-of-core sort support) ----
//
// The reference transparently backs >max-alloc buffers in host memory
// (Adl/CL/AdlCL.inl:373-378); here chunks sorted on the device come back
// as runs and are merged on the host. Output-partitioned: each thread
// co-ranks every run at its output boundary (binary search on the value
// space, ties split in run order to keep the merge stable), then merges
// its span with a linear head scan (K is small).

// pos[k] = how many elements of run k precede global output position p.
static void kway_boundaries(const uint32_t* keys, const int64_t* off,
                            int K, int64_t p, int64_t* pos) {
  const int64_t n = off[K];
  if (p >= n) {
    for (int k = 0; k < K; ++k) pos[k] = off[k + 1] - off[k];
    return;
  }
  // smallest v with count_leq(v) >= p+1  (the (p+1)-th smallest value)
  uint32_t lo = 0, hi = 0xFFFFFFFFu;
  while (lo < hi) {
    const uint32_t mid = lo + (hi - lo) / 2;
    int64_t leq = 0;
    for (int k = 0; k < K; ++k) {
      const uint32_t* b = keys + off[k];
      const uint32_t* e = keys + off[k + 1];
      leq += std::upper_bound(b, e, mid) - b;
    }
    if (leq >= p + 1) hi = mid; else lo = mid + 1;
  }
  const uint32_t v = lo;
  int64_t less = 0;
  for (int k = 0; k < K; ++k) {
    const uint32_t* b = keys + off[k];
    const uint32_t* e = keys + off[k + 1];
    pos[k] = std::lower_bound(b, e, v) - b;
    less += pos[k];
  }
  int64_t extra = p - less;  // ties of v, consumed from earlier runs first
  for (int k = 0; k < K && extra > 0; ++k) {
    const uint32_t* b = keys + off[k];
    const uint32_t* e = keys + off[k + 1];
    const int64_t ties = (std::upper_bound(b, e, v) - b) - pos[k];
    const int64_t take = std::min(extra, ties);
    pos[k] += take;
    extra -= take;
  }
}

template <bool kHasValues>
static void merge_span(const uint32_t* keys, const uint32_t* vals,
                       const int64_t* off, int K, int64_t* cur,
                       const int64_t* stop, uint32_t* ko, uint32_t* vo,
                       int64_t out_begin, int64_t out_end) {
  for (int64_t o = out_begin; o < out_end; ++o) {
    int best = -1;
    uint32_t bk = 0;
    for (int k = 0; k < K; ++k) {
      if (cur[k] < stop[k]) {
        const uint32_t kk = keys[off[k] + cur[k]];
        if (best < 0 || kk < bk) {  // strict <: ties keep run order
          best = k;
          bk = kk;
        }
      }
    }
    ko[o] = bk;
    if (kHasValues) vo[o] = vals[off[best] + cur[best]];
    cur[best]++;
  }
}

template <bool kHasValues>
static void merge_runs_impl(const uint32_t* keys, const uint32_t* vals,
                            const int64_t* off, int K, uint32_t* ko,
                            uint32_t* vo) {
  const int64_t n = off[K];
  if (n == 0 || K <= 0) return;
  const int nt = (n >= kParallelMin) ? num_threads(n) : 1;
  const int64_t chunk = (n + nt - 1) / nt;
  std::vector<std::thread> ts;
  ts.reserve(nt);
  for (int t = 0; t < nt; ++t) {
    ts.emplace_back([&, t] {
      const int64_t lo = t * chunk;
      const int64_t hi = std::min<int64_t>(lo + chunk, n);
      if (lo >= hi) return;
      std::vector<int64_t> cur(K), stop(K);
      kway_boundaries(keys, off, K, lo, cur.data());
      kway_boundaries(keys, off, K, hi, stop.data());
      merge_span<kHasValues>(keys, vals, off, K, cur.data(), stop.data(),
                             ko, vo, lo, hi);
    });
  }
  for (auto& th : ts) th.join();
}

}  // namespace

extern "C" {

// Stable parallel k-way merge: `keys` holds k_runs sorted runs laid out
// back-to-back, run r = keys[offsets[r] : offsets[r+1]] (offsets has
// k_runs+1 entries). Writes the merged order to keys_out (and mirrors
// values to values_out when both value pointers are non-null).
void sortx_host_merge_u32(const uint32_t* keys, const uint32_t* values,
                          const int64_t* offsets, int k_runs,
                          uint32_t* keys_out, uint32_t* values_out) {
  if (values != nullptr && values_out != nullptr) {
    merge_runs_impl<true>(keys, values, offsets, k_runs, keys_out,
                          values_out);
  } else {
    merge_runs_impl<false>(keys, nullptr, offsets, k_runs, keys_out,
                           nullptr);
  }
}

// In-place stable LSD radix sort of u32 keys on the low sort_bits bits.
void sortx_host_sort_u32(uint32_t* keys, int64_t n, int sort_bits) {
  radix_sort_impl<false>(keys, nullptr, n, sort_bits);
}

// In-place stable key-value sort (values follow keys).
void sortx_host_sort_kv_u32(uint32_t* keys, uint32_t* values, int64_t n,
                            int sort_bits) {
  radix_sort_impl<true>(keys, values, n, sort_bits);
}

// Exclusive prefix sum with u32 wraparound; returns the grand total.
uint32_t sortx_host_exclusive_scan_u32(const uint32_t* in, uint32_t* out,
                                       int64_t n) {
  uint32_t acc = 0;
  for (int64_t i = 0; i < n; ++i) {
    out[i] = acc;
    acc += in[i];
  }
  return acc;
}

}  // extern "C"
