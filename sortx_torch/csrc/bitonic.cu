// Bitonic sorting-network kernels for Hopper (sm_90a).
//
// Replaces the TPU kernels of sortx/ops/bitonic.py:
//   bitonic_block_kernel  <- _kernel_a  stages 1..L inside one 2^L block
//   bitonic_tail_kernel   <- _kernel_b  stage s > L, layers L-1..0
//   bitonic_global_kernel <- _kernel_d  stage s, layers j_hi..j_lo >= L
//
// The network: flat index i, stage s, layer distance 2^j (j = s-1..0),
// partner i ^ 2^j, direction bit (i >> s) & 1 (1 = descending). The
// streams are NS parallel u32 arrays of one buffer, stream t at
// x + t * stride; the comparator is unsigned and lexicographic on the
// first NK streams, and a pair swaps only when strictly out of order,
// so a tied pair never moves in either direction. The output therefore
// does not depend on how the layers are split into passes.
//
// Rows mode (the row_log / force_asc options of the TPU kernels): the
// buffer is rows of 2^R elements, each sorted ascending on its own.
// Exchanges at distance < 2^R never cross a row, so the network only
// stops at stage R and runs stage R ascending everywhere: K1 takes
// row_log (stages 1..R, R <= L), K2 and K3 take force_asc for stage R.
//
// The merge stage (bitonic_merge_streams, the TPU's merge) is one
// ascending stage s = log2 n over a bitonic sequence: K3 passes for
// layers s-1..L under force_asc, then K2 under force_asc, which there
// may also take s == L (the whole merge inside one block).
//
// Stream sets: the 7 narrow sets (1-4 streams, 1-2 keys) run every
// mode; the wide sets of the 64-bit, argsort and lexsort paths ((3,3),
// (4,3), (5,2), (4,4), (5,5), (6,6), (7,7), (8,8)) run the full
// network only: rows mode and forced K2 are refused for them. Above 4
// streams K3 keeps at most 2^3 elements per thread and stream (v[8][8] =
// 64 words), not 2^4, so it does not spill.
//
// What bounds them on the card. K2 and K3 are bound by bytes: every
// pass reads and writes each of the NS streams once (8 * NS bytes per
// element), and a pass has few comparators per byte. K1 is bound by
// operations: L (L + 1) / 2 layers of 2^(L-1) compare-exchanges per
// block over one read and one write. The network as a whole costs its
// passes over device memory, so the block kernels run every layer below
// L in one pass and K3 keeps 2^F elements per thread in registers so
// that F cross-block layers cost one pass.
//
// K1 and K2, the register design. A thread owns E = 2^e elements of
// every stream in registers for the whole kernel (e = 4 for up to 4
// streams, 5 for 1 stream in a block above 2^13, 3 above 4 streams),
// and a block of 2^L elements has 2^(L-e) threads, e + 5 <= L <= 2e + 5.
// Two assignments of the L index bits to (slot, lane, warp) serve every
// layer (ops/bitonic.py low_layout / high_layout must match them):
//
//   low    slot r = 4q + k holds index  warp << (e+5) | q << 7 | lane << 2 | k
//          slot bits: index bits 0, 1 and 7..e+4; lane bits: 2..6.
//          Layers 0..e+4. A thread's 4 consecutive words move as one
//          16-byte access, a warp's as 512 contiguous bytes, to device
//          and to shared memory alike (no bank conflict: the 8 lanes of
//          a quarter warp cover the 32 banks).
//   high   slot r holds index  r << (L-e) | thread
//          slot bits: index bits L-e..L-1; lane bits: 0..4.
//          Layers e+5..L-1. A warp's 32 lanes touch 32 consecutive
//          words: one 128-byte line of device memory, 32 banks.
//
// A layer whose bit is a slot bit runs in registers (keys-only: a min
// and a max; otherwise a predicate and selects), one whose bit is a
// lane bit by __shfl_xor_sync (both lanes reach the same verdict, so a
// tie moves on neither side), and the block changes layout through
// shared memory: write, one barrier, read. K2 loads device memory
// straight into the high layout, runs layers L-1..e+5, changes layout
// once and stores from the low layout: 1 barrier for its L layers (the
// per-layer kernel: L). K1 runs stages 1..e+5 in the low layout with no
// barrier at all and every later stage with two changes of layout: 8
// barriers at L = 13, e = 4 and 10 at L = 15, e = 5 (per layer: 91 and
// 120). Measured on an H100 at 2^27 words (PERF.md): at one stream K2
// takes 0.41 ms against 0.32 ms for its bytes at the card's memory rate,
// and K1 2.55 ms against 0.96 ms for its min and max alone on the 64
// INT32 lanes of an SM (a shuffle layer adds a shuffle and a select per
// element). The wider sets pay for their comparator: a predicate chain
// and 2 selects per stream and pair, with no branch (a branch per key
// word cost 2x). The loads are not made asynchronous (cp.async, TMA):
// with 2-3 blocks on an SM one block's loads overlap another's layers,
// and K2 has 11-22% left to its bound.
//
// The direction is out of the layers: every layer runs ascending, and
// an element whose stage runs descending carries its key words
// complemented (a strict swap on complemented keys is the descending
// strict swap, ties included). K2 complements per block, on the way in
// and out; K1 complements between stages those elements whose
// direction bit changes, by thread or, where the stage's bit is a slot
// bit, by slot. Rows mode and force_asc only change which stage counts
// as ascending, once per stage and thread, so they are runtime
// arguments and each stream set has one K1 and one K2 per e.
//
// Blocks below 2^(e+5), above 2^(2e+5) (or what shared memory holds,
// design_top), or of a buffer whose streams are not 16-byte aligned run
// the per-layer kernels (one barrier per layer over shared memory),
// which take every L >= 1.
//
// Every K1-K3 launch takes `skip`, a device pointer to one int or null:
// each CTA reads it first and returns at once where it is nonzero, so a
// pass runs or not on a flag the device computed (the reference's
// lax.cond around its network, sortx/ops/sort_pallas.py:343-350 and
// :442-445), with no read on the host, and a sort can be captured in a
// CUDA graph and replayed on ordered and unordered inputs alike.
//
// K8, reverse_kernel, is that branch's jnp.flip (sort_pallas.py:349):
// where the order flags (ops/bitonic.py reverse_ordered) say
// nonincreasing and not nondecreasing, it writes the input reversed over
// the skipped network's output; otherwise every CTA returns at once. It
// is bound by bytes: one read and one write of each word, coalesced on
// both sides (consecutive threads take consecutive outputs and the
// inputs just below one another), 4 loads in flight a thread.
//
// C entries return cudaGetLastError() (or the first error met) and
// launch on the stream given; they allocate nothing and do not sync.

#include <algorithm>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

// Is this pass skipped on the device (see the notes above)?
__device__ __forceinline__ bool skipped(const int* skip) {
  return skip != nullptr && *skip != 0;
}

// a < b on the first NK words, unsigned, lexicographic; no branch.
template <int NK>
__device__ __forceinline__ bool lex_lt(const uint32_t* a, const uint32_t* b) {
  bool lt = a[NK - 1] < b[NK - 1];
#pragma unroll
  for (int t = NK - 2; t >= 0; --t) {
    lt = (a[t] < b[t]) | ((a[t] == b[t]) & lt);
  }
  return lt;
}

// --- the register design of K1 and K2 -----------------------------------

// Ascending compare-exchange of slots lo < hi of one thread.
template <int NS, int NK, int E>
__device__ __forceinline__ void cx_slots(uint32_t (&v)[NS][E], int lo,
                                         int hi) {
  if constexpr (NS == 1) {
    const uint32_t a = v[0][lo], b = v[0][hi];
    v[0][lo] = min(a, b);
    v[0][hi] = max(a, b);
  } else {
    uint32_t a[NK], b[NK];
#pragma unroll
    for (int t = 0; t < NK; ++t) {
      a[t] = v[t][lo];
      b[t] = v[t][hi];
    }
    const bool swap = lex_lt<NK>(b, a);
#pragma unroll
    for (int t = 0; t < NS; ++t) {
      const uint32_t u = v[t][lo], w = v[t][hi];
      v[t][lo] = swap ? w : u;
      v[t][hi] = swap ? u : w;
    }
  }
}

// The layer whose bit is slot bit beta: in registers.
template <int NS, int NK, int E>
__device__ __forceinline__ void layer_slots(uint32_t (&v)[NS][E], int beta) {
#pragma unroll
  for (int r = 0; r < E; ++r) {
    if (r & (1 << beta)) continue;
    cx_slots<NS, NK, E>(v, r, r | (1 << beta));
  }
}

// The layer whose bit is lane bit `bit`: each element meets its partner
// in lane ^ 2^bit; the lower lane keeps the smaller, the upper the
// larger, and on a tie both keep their own.
template <int NS, int NK, int E>
__device__ __forceinline__ void layer_lanes(uint32_t (&v)[NS][E], int bit,
                                            int lane) {
  const int mask = 1 << bit;
  const bool up = (lane & mask) != 0;
#pragma unroll
  for (int r = 0; r < E; ++r) {
    uint32_t o[NS];
#pragma unroll
    for (int t = 0; t < NS; ++t) {
      o[t] = __shfl_xor_sync(0xffffffffu, v[t][r], mask);
    }
    if constexpr (NS == 1) {
      v[0][r] = up ? max(v[0][r], o[0]) : min(v[0][r], o[0]);
    } else {
      uint32_t m[NK];
#pragma unroll
      for (int t = 0; t < NK; ++t) m[t] = v[t][r];
      const bool swap = up ? lex_lt<NK>(m, o) : lex_lt<NK>(o, m);
#pragma unroll
      for (int t = 0; t < NS; ++t) v[t][r] = swap ? o[t] : v[t][r];
    }
  }
}

// Layers min(s, e+5)-1..0 in the low layout: slot bits 2.. (index bits
// 7..e+4), the lane bits (index bits 6..2), slot bits 1 and 0.
template <int NS, int NK, int LOG_E>
__device__ __forceinline__ void low_layers(uint32_t (&v)[NS][1 << LOG_E],
                                           int s, int lane) {
  constexpr int E = 1 << LOG_E;
#pragma unroll
  for (int beta = LOG_E - 1; beta >= 2; --beta) {
    if (beta + 5 < s) layer_slots<NS, NK, E>(v, beta);
  }
#pragma unroll 1
  for (int j = (s - 1 < 6 ? s - 1 : 6); j >= 2; --j) {
    layer_lanes<NS, NK, E>(v, j - 2, lane);
  }
#pragma unroll
  for (int beta = 1; beta >= 0; --beta) {
    if (beta < s) layer_slots<NS, NK, E>(v, beta);
  }
}

// Layers min(s, L)-1..e+5 in the high layout (slot bit beta is index bit
// L-e+beta).
template <int NS, int NK, int LOG_E>
__device__ __forceinline__ void high_layers(uint32_t (&v)[NS][1 << LOG_E],
                                            int s, int log_block) {
  constexpr int E = 1 << LOG_E;
#pragma unroll
  for (int beta = LOG_E - 1; beta >= 0; --beta) {
    const int j = log_block - LOG_E + beta;
    if (j >= LOG_E + 5 && j < s) layer_slots<NS, NK, E>(v, beta);
  }
}

// Low layout: slot 4q + k of the thread whose slot 0 is word `low0` is
// word low0 + (q << 7) + k; p is device or shared memory, stream t at
// p + t * pitch.
template <int NS, int E>
__device__ __forceinline__ void load_low(uint32_t (&v)[NS][E],
                                         const uint32_t* p, long long pitch,
                                         int low0) {
#pragma unroll
  for (int t = 0; t < NS; ++t) {
#pragma unroll
    for (int q = 0; q < E / 4; ++q) {
      const uint4 w =
          *reinterpret_cast<const uint4*>(p + t * pitch + low0 + (q << 7));
      v[t][4 * q] = w.x;
      v[t][4 * q + 1] = w.y;
      v[t][4 * q + 2] = w.z;
      v[t][4 * q + 3] = w.w;
    }
  }
}

template <int NS, int E>
__device__ __forceinline__ void store_low(const uint32_t (&v)[NS][E],
                                          uint32_t* p, long long pitch,
                                          int low0) {
#pragma unroll
  for (int t = 0; t < NS; ++t) {
#pragma unroll
    for (int q = 0; q < E / 4; ++q) {
      *reinterpret_cast<uint4*>(p + t * pitch + low0 + (q << 7)) = make_uint4(
          v[t][4 * q], v[t][4 * q + 1], v[t][4 * q + 2], v[t][4 * q + 3]);
    }
  }
}

// High layout: slot r of thread tid is word tid + (r << shift), shift =
// L - e.
template <int NS, int E>
__device__ __forceinline__ void load_high(uint32_t (&v)[NS][E],
                                          const uint32_t* p, long long pitch,
                                          int tid, int shift) {
#pragma unroll
  for (int t = 0; t < NS; ++t) {
#pragma unroll
    for (int r = 0; r < E; ++r) v[t][r] = p[t * pitch + tid + (r << shift)];
  }
}

template <int NS, int E>
__device__ __forceinline__ void store_high(const uint32_t (&v)[NS][E],
                                           uint32_t* p, long long pitch,
                                           int tid, int shift) {
#pragma unroll
  for (int t = 0; t < NS; ++t) {
#pragma unroll
    for (int r = 0; r < E; ++r) p[t * pitch + tid + (r << shift)] = v[t][r];
  }
}

// Complement the NK key words of every slot of the thread.
template <int NS, int NK, int E>
__device__ __forceinline__ void flip_keys(uint32_t (&v)[NS][E],
                                          uint32_t mask) {
#pragma unroll
  for (int t = 0; t < NK; ++t) {
#pragma unroll
    for (int r = 0; r < E; ++r) v[t][r] ^= mask;
  }
}

// The slots (bit r = slot r) of the low layout whose index has bit s
// set, for the stages whose bit is a slot bit: s = 1 (slot bit 1) and
// s = 7..e+4 (slot bit s - 5); 0 for every other stage.
template <int LOG_E>
__device__ __forceinline__ uint64_t stage_slots(int s) {
  if (s == 1) return 0xCCCCCCCCCCCCCCCCull;
  if (s == 7 && LOG_E > 2) return 0xF0F0F0F0F0F0F0F0ull;
  if (s == 8 && LOG_E > 3) return 0xFF00FF00FF00FF00ull;
  if (s == 9 && LOG_E > 4) return 0xFFFF0000FFFF0000ull;
  if (s == 10 && LOG_E > 5) return 0xFFFFFFFF00000000ull;
  return 0ull;
}

// K1 between stages, in the low layout: complement the keys of the
// elements whose direction bit differs between stage sa and stage sb
// (bit s of the index; stage 0 stands for "ascending everywhere"). g is
// the flat index of the thread's slot 0, mod 2^32.
template <int NS, int NK, int LOG_E>
__device__ __forceinline__ void toggle(uint32_t (&v)[NS][1 << LOG_E],
                                       uint32_t g, int sa, int sb) {
  constexpr int E = 1 << LOG_E;
  const uint32_t by_thread =
      0u - ((((sa ? g >> sa : 0u) ^ (sb ? g >> sb : 0u))) & 1u);
  const uint64_t by_slot = stage_slots<LOG_E>(sa) ^ stage_slots<LOG_E>(sb);
  if (by_slot == 0ull) {    // the same for every thread of the block
    flip_keys<NS, NK, E>(v, by_thread);
  } else {
    const uint64_t slots = by_thread ? ~by_slot : by_slot;
#pragma unroll
    for (int r = 0; r < E; ++r) {
      const uint32_t mask = 0u - static_cast<uint32_t>((slots >> r) & 1ull);
#pragma unroll
      for (int t = 0; t < NK; ++t) v[t][r] ^= mask;
    }
  }
}

// Shared memory one block may ask for on this card.
constexpr int SMEM_MAX = 232448;

// log2 of the elements a thread owns for one stream in a block above
// 2^13 (ops/bitonic.py E_BIG). 6, on 512 threads, was measured on an
// H100 and lost: K1 6% faster, K2 10% slower, the network 2% slower.
constexpr int E_BIG = 5;
static_assert(E_BIG == 5 || E_BIG == 6);

// The largest block (log2) the register design takes with 2^e elements
// a thread: 2e + 5, as far as NS streams of it fit in shared memory
// (ops/bitonic.py design_top).
constexpr int design_top(int ns, int log_e) {
  int top = 2 * log_e + 5;
  while (((4 * ns) << top) > SMEM_MAX) --top;
  return top;
}

// Threads and shared memory of that largest block, and the blocks of
// that size that should share an SM: the compiler keeps the registers
// within 65536 / (threads * blocks). Two blocks where the streams' 2^e
// words each leave room without a spill (measured: K1 at two streams
// fits 64 registers only by spilling, and runs 5% slower without the
// cap; K2 fits). Two caps do make K1 spill, and stay because the
// kernel without the spill measured slower: at 4 streams (128 registers
// for 512 threads; under a 256-thread bound it takes 166, spills
// nothing, leaves one block an SM and is 5% slower at 2^12) and at
// E_BIG (64 registers for 1024 threads; the other way to a 2^15 block,
// 2^6 elements on 512 threads, spills more).
constexpr int design_threads(int ns, int log_e) {
  return 1 << (design_top(ns, log_e) - log_e);
}
constexpr int design_smem(int ns, int log_e) {
  return (4 * ns) << design_top(ns, log_e);
}
constexpr int design_blocks(int ns, int log_e, bool tail) {
  if (log_e >= 5) return 1;
  if (log_e == 4) return ns == 1 || (ns == 2 && tail) ? 2 : 1;
  return ns <= 6 ? 2 : 1;
}

// K1: stages 1..L of one 2^L block, in place; with row_log > 0 stages
// 1..row_log, the last one ascending. 2^(L-e) threads.
template <int NS, int NK, int LOG_E>
__global__ void __launch_bounds__(design_threads(NS, LOG_E),
                                  design_blocks(NS, LOG_E, false))
    bitonic_block_kernel(uint32_t* __restrict__ x,
                         const int* __restrict__ skip, long long stride,
                         int log_block, int row_log) {
  if (skipped(skip)) return;
  constexpr int E = 1 << LOG_E;
  extern __shared__ uint4 smem[];
  uint32_t* sm = reinterpret_cast<uint32_t*>(smem);
  const int len = 1 << log_block;
  const int tid = threadIdx.x, lane = tid & 31;
  const int low0 = ((tid >> 5) << (LOG_E + 5)) | (lane << 2);
  const int shift = log_block - LOG_E;
  uint32_t* xb = x + (static_cast<long long>(blockIdx.x) << log_block);
  const uint32_t g = (blockIdx.x << log_block) | static_cast<uint32_t>(low0);
  uint32_t v[NS][E];
  load_low<NS, E>(v, xb, stride, low0);
  const int top = row_log > 0 ? row_log : log_block;
  int dir = 0;
  for (int s = 1; s <= top; ++s) {
    const int next = s == row_log ? 0 : s;
    toggle<NS, NK, LOG_E>(v, g, dir, next);
    dir = next;
    if (s > LOG_E + 5) {
      store_low<NS, E>(v, sm, len, low0);
      __syncthreads();
      load_high<NS, E>(v, sm, len, tid, shift);
      high_layers<NS, NK, LOG_E>(v, s, log_block);
      store_high<NS, E>(v, sm, len, tid, shift);
      __syncthreads();
      load_low<NS, E>(v, sm, len, low0);
    }
    low_layers<NS, NK, LOG_E>(v, s, lane);
  }
  toggle<NS, NK, LOG_E>(v, g, dir, 0);
  store_low<NS, E>(v, xb, stride, low0);
}

// K2: layers L-1..0 of stage s >= L for one 2^L block, in place. The
// direction is constant over the block: bit s of its base, or ascending
// under force_asc.
template <int NS, int NK, int LOG_E>
__global__ void __launch_bounds__(design_threads(NS, LOG_E),
                                  design_blocks(NS, LOG_E, true))
    bitonic_tail_kernel(uint32_t* __restrict__ x,
                        const int* __restrict__ skip, long long stride,
                        int log_block, int s, int force_asc) {
  if (skipped(skip)) return;
  constexpr int E = 1 << LOG_E;
  extern __shared__ uint4 smem[];
  uint32_t* sm = reinterpret_cast<uint32_t*>(smem);
  const int len = 1 << log_block;
  const int tid = threadIdx.x, lane = tid & 31;
  const int low0 = ((tid >> 5) << (LOG_E + 5)) | (lane << 2);
  const int shift = log_block - LOG_E;
  uint32_t* xb = x + (static_cast<long long>(blockIdx.x) << log_block);
  const int up = s - log_block;     // bit s of the base is bit `up` of the block
  const uint32_t flip =
      (!force_asc && up < 32 && ((blockIdx.x >> up) & 1u)) ? ~0u : 0u;
  uint32_t v[NS][E];
  if (log_block > LOG_E + 5) {
    load_high<NS, E>(v, xb, stride, tid, shift);
    flip_keys<NS, NK, E>(v, flip);
    high_layers<NS, NK, LOG_E>(v, log_block, log_block);
    store_high<NS, E>(v, sm, len, tid, shift);
    __syncthreads();
    load_low<NS, E>(v, sm, len, low0);
  } else {
    load_low<NS, E>(v, xb, stride, low0);
    flip_keys<NS, NK, E>(v, flip);
  }
  low_layers<NS, NK, LOG_E>(v, log_block, lane);
  flip_keys<NS, NK, E>(v, flip);
  store_low<NS, E>(v, xb, stride, low0);
}

// --- the per-layer kernels: any block 2^L, L >= 1, any alignment ---------

// One compare-exchange layer at distance 2^j over a shared-memory block
// of len elements per stream (stream t at sm + t * len); base is the
// block's first flat index, s the stage; asc runs it ascending
// everywhere.
template <int NS, int NK>
__device__ __forceinline__ void smem_layer(uint32_t* sm, int len, int j,
                                           long long base, int s, bool asc) {
  const int dmask = (1 << j) - 1;
  for (int p = threadIdx.x; p < (len >> 1); p += blockDim.x) {
    const int lo = ((p & ~dmask) << 1) | (p & dmask);
    const int hi = lo | (1 << j);
    uint32_t a[NK], b[NK];
#pragma unroll
    for (int t = 0; t < NK; ++t) {
      a[t] = sm[t * len + lo];
      b[t] = sm[t * len + hi];
    }
    const bool desc = !asc && (((base + lo) >> s) & 1);
    if (desc ? lex_lt<NK>(a, b) : lex_lt<NK>(b, a)) {
#pragma unroll
      for (int t = 0; t < NS; ++t) {
        const uint32_t u = sm[t * len + lo];
        sm[t * len + lo] = sm[t * len + hi];
        sm[t * len + hi] = u;
      }
    }
  }
  __syncthreads();
}

template <int NS>
__device__ __forceinline__ void load_block(uint32_t* sm,
                                           const uint32_t* __restrict__ x,
                                           long long stride, long long base,
                                           int len) {
#pragma unroll
  for (int t = 0; t < NS; ++t) {
    for (int i = threadIdx.x; i < len; i += blockDim.x) {
      sm[t * len + i] = x[t * stride + base + i];
    }
  }
  __syncthreads();
}

template <int NS>
__device__ __forceinline__ void store_block(const uint32_t* sm,
                                            uint32_t* __restrict__ x,
                                            long long stride, long long base,
                                            int len) {
#pragma unroll
  for (int t = 0; t < NS; ++t) {
    for (int i = threadIdx.x; i < len; i += blockDim.x) {
      x[t * stride + base + i] = sm[t * len + i];
    }
  }
}

// K1 layer by layer.
template <int NS, int NK>
__global__ void __launch_bounds__(1024)
    bitonic_block_layers_kernel(uint32_t* __restrict__ x,
                                const int* __restrict__ skip,
                                long long stride, int log_block,
                                int row_log) {
  if (skipped(skip)) return;
  extern __shared__ uint4 smem[];
  uint32_t* sm = reinterpret_cast<uint32_t*>(smem);
  const int len = 1 << log_block;
  const long long base = static_cast<long long>(blockIdx.x) << log_block;
  load_block<NS>(sm, x, stride, base, len);
  const int top = row_log > 0 ? row_log : log_block;
  for (int s = 1; s <= top; ++s) {
    for (int j = s - 1; j >= 0; --j) {
      smem_layer<NS, NK>(sm, len, j, base, s, s == row_log);
    }
  }
  store_block<NS>(sm, x, stride, base, len);
}

// K2 layer by layer.
template <int NS, int NK>
__global__ void __launch_bounds__(1024)
    bitonic_tail_layers_kernel(uint32_t* __restrict__ x,
                               const int* __restrict__ skip,
                               long long stride, int log_block, int s,
                               int force_asc) {
  if (skipped(skip)) return;
  extern __shared__ uint4 smem[];
  uint32_t* sm = reinterpret_cast<uint32_t*>(smem);
  const int len = 1 << log_block;
  const long long base = static_cast<long long>(blockIdx.x) << log_block;
  load_block<NS>(sm, x, stride, base, len);
  for (int j = log_block - 1; j >= 0; --j) {
    smem_layer<NS, NK>(sm, len, j, base, s, force_asc != 0);
  }
  store_block<NS>(sm, x, stride, base, len);
}

// K3: layers j_lo+F-1..j_lo of stage s, in place. Thread g owns the 2^F
// elements i0 + r * 2^j_lo (r < 2^F), where i0 is g with F zero bits
// inserted at bit j_lo; they stay in registers for all F layers.
template <int NS, int NK, int F>
__global__ void __launch_bounds__(256)
    bitonic_global_kernel(uint32_t* __restrict__ x,
                          const int* __restrict__ skip, long long stride,
                          long long n_groups, int s, int j_lo,
                          bool force_asc) {
  if (skipped(skip)) return;
  constexpr int R = 1 << F;
  const long long g =
      static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (g >= n_groups) return;
  const long long low = g & ((1LL << j_lo) - 1);
  const long long i0 = ((g >> j_lo) << (j_lo + F)) | low;
  const bool desc = !force_asc && ((i0 >> s) & 1);
  uint32_t v[NS][R];
#pragma unroll
  for (int t = 0; t < NS; ++t) {
#pragma unroll
    for (int r = 0; r < R; ++r) {
      v[t][r] = x[t * stride + i0 + (static_cast<long long>(r) << j_lo)];
    }
  }
#pragma unroll
  for (int ell = F - 1; ell >= 0; --ell) {
#pragma unroll
    for (int r = 0; r < R; ++r) {
      if (r & (1 << ell)) continue;
      const int q = r | (1 << ell);
      uint32_t a[NK], b[NK];
#pragma unroll
      for (int t = 0; t < NK; ++t) {
        a[t] = v[t][r];
        b[t] = v[t][q];
      }
      const bool swap = desc ? lex_lt<NK>(a, b) : lex_lt<NK>(b, a);
#pragma unroll
      for (int t = 0; t < NS; ++t) {
        const uint32_t u = v[t][r], w = v[t][q];
        v[t][r] = swap ? w : u;
        v[t][q] = swap ? u : w;
      }
    }
  }
#pragma unroll
  for (int t = 0; t < NS; ++t) {
#pragma unroll
    for (int r = 0; r < R; ++r) {
      x[t * stride + i0 + (static_cast<long long>(r) << j_lo)] = v[t][r];
    }
  }
}

// K8: out[i] = src[n - 1 - i] where the order flags are exactly
// nonincreasing (bit 1 without bit 0; all-equal words need no move).
constexpr int kRevThreads = 256;
constexpr int kRevUnroll = 4;

__global__ void __launch_bounds__(kRevThreads)
    reverse_kernel(const int* __restrict__ flags,
                   const uint32_t* __restrict__ src,
                   uint32_t* __restrict__ out, long long n) {
  if ((*flags & 3) != 2) return;
  const long long step =
      static_cast<long long>(gridDim.x) * kRevThreads * kRevUnroll;
  for (long long i0 = static_cast<long long>(blockIdx.x) * kRevThreads *
                          kRevUnroll + threadIdx.x;
       i0 < n; i0 += step) {
    uint32_t v[kRevUnroll];
#pragma unroll
    for (int u = 0; u < kRevUnroll; ++u) {
      const long long i = i0 + u * kRevThreads;
      if (i < n) v[u] = src[n - 1 - i];
    }
#pragma unroll
    for (int u = 0; u < kRevUnroll; ++u) {
      const long long i = i0 + u * kRevThreads;
      if (i < n) out[i] = v[u];
    }
  }
}

// The narrow stream sets, which also run rows mode and forced K2
// (ops/bitonic.py NARROW_SETS).
constexpr bool narrow(int ns, int nk) { return ns <= 4 && nk <= 2; }

// Most layers one K3 pass keeps in registers for NS streams
// (ops/bitonic.py f_max).
constexpr int f_max(int ns) { return ns <= 4 ? 4 : 3; }

// log2 of the elements a thread owns in the register design, for NS
// streams in a block 2^L; 0 where the per-layer kernels run instead
// (ops/bitonic.py elems_log).
constexpr int elems_log(int ns, int log_block) {
  const int e = ns > 4 ? 3 : (ns == 1 && log_block > 13 ? E_BIG : 4);
  if (log_block < e + 5 || log_block > design_top(ns, e)) return 0;
  return e;
}

// Raise a kernel's dynamic shared-memory limit, once per device for the
// instantiation that owns `done` (a sort makes 50-70 launches).
template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, int bytes, unsigned long long* done) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  const unsigned long long bit = 1ULL << (dev & 63);
  if (*done & bit) return cudaSuccess;
  err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err == cudaSuccess) *done |= bit;
  return err;
}

// Launch a block kernel over ext / 2^L blocks of `threads` threads with
// all NS streams of a block in shared memory.
template <int NS, typename Kernel, typename... Args>
cudaError_t launch_block(Kernel kernel, unsigned long long* done, int smem_max,
                         int threads, uint32_t* x, const int* skip,
                         long long ext, long long stride, int log_block,
                         cudaStream_t stream, Args... args) {
  const long long len = 1LL << log_block;
  const long long blocks = ext >> log_block;
  const long long smem = static_cast<long long>(sizeof(uint32_t)) * NS * len;
  if (blocks <= 0 || (ext & (len - 1)) != 0 || smem > smem_max) {
    return cudaErrorInvalidValue;
  }
  const cudaError_t err = allow_smem(kernel, smem_max, done);
  if (err != cudaSuccess) return err;
  kernel<<<static_cast<unsigned>(blocks), threads, static_cast<int>(smem),
           stream>>>(x, skip, stride, log_block, args...);
  return cudaGetLastError();
}

// Can the streams move as 16-byte words?
inline bool aligned16(const uint32_t* x, long long stride) {
  return reinterpret_cast<uintptr_t>(x) % 16 == 0 && stride % 4 == 0;
}

// K1 (args: row_log) or K2 (args: s, force_asc) of the register design
// with 2^LOG_E elements a thread.
template <int NS, int NK, int LOG_E, bool TAIL, typename... Args>
cudaError_t launch_design(uint32_t* x, const int* skip, long long ext,
                          long long stride, int log_block,
                          cudaStream_t stream, Args... args) {
  static unsigned long long done = 0;
  const int threads = 1 << (log_block - LOG_E);
  if constexpr (TAIL) {
    return launch_block<NS>(bitonic_tail_kernel<NS, NK, LOG_E>, &done,
                            design_smem(NS, LOG_E), threads, x, skip, ext,
                            stride, log_block, stream, args...);
  } else {
    return launch_block<NS>(bitonic_block_kernel<NS, NK, LOG_E>, &done,
                            design_smem(NS, LOG_E), threads, x, skip, ext,
                            stride, log_block, stream, args...);
  }
}

// K1 or K2 for a block 2^L: the register design where elems_log gives
// it an e and the streams are aligned, else the per-layer kernel.
template <int NS, int NK, bool TAIL, typename... Args>
cudaError_t launch_k12(uint32_t* x, const int* skip, long long ext,
                       long long stride, int log_block, cudaStream_t stream,
                       Args... args) {
  constexpr int E_SMALL = NS > 4 ? 3 : 4;   // below a 2^14 block
  const int e = aligned16(x, stride) ? elems_log(NS, log_block) : 0;
  if (e == E_SMALL) {
    return launch_design<NS, NK, E_SMALL, TAIL>(x, skip, ext, stride,
                                                log_block, stream, args...);
  }
  if constexpr (NS == 1) {
    if (e == E_BIG) {
      return launch_design<NS, NK, E_BIG, TAIL>(x, skip, ext, stride,
                                                log_block, stream, args...);
    }
  }
  static unsigned long long done = 0;
  const int threads = log_block > 10 ? 1024 : 1 << (log_block - 1);
  if constexpr (TAIL) {
    return launch_block<NS>(bitonic_tail_layers_kernel<NS, NK>, &done,
                            SMEM_MAX, threads, x, skip, ext, stride,
                            log_block, stream, args...);
  } else {
    return launch_block<NS>(bitonic_block_layers_kernel<NS, NK>, &done,
                            SMEM_MAX, threads, x, skip, ext, stride,
                            log_block, stream, args...);
  }
}

// K1, in rows mode if row_log > 0 (the narrow sets only).
template <int NS, int NK>
cudaError_t launch_k1(uint32_t* x, const int* skip, long long ext,
                      long long stride, int log_block, int row_log,
                      cudaStream_t stream) {
  if (row_log > 0 && !narrow(NS, NK)) return cudaErrorInvalidValue;
  return launch_k12<NS, NK, false>(x, skip, ext, stride, log_block, stream,
                                   row_log);
}

// K2 at stage s, ascending everywhere under force_asc (the narrow sets
// only).
template <int NS, int NK>
cudaError_t launch_k2(uint32_t* x, const int* skip, long long ext,
                      long long stride, int log_block, int s, int force_asc,
                      cudaStream_t stream) {
  if (force_asc && !narrow(NS, NK)) return cudaErrorInvalidValue;
  return launch_k12<NS, NK, true>(x, skip, ext, stride, log_block, stream, s,
                                  force_asc);
}

template <int NS, int NK, int F>
cudaError_t launch_global_f(uint32_t* x, const int* skip, long long ext,
                            long long stride, int s, int j_lo, bool force_asc,
                            cudaStream_t stream) {
  const long long n_groups = ext >> F;
  if (n_groups <= 0 || (ext & ((1LL << (j_lo + F)) - 1)) != 0) {
    return cudaErrorInvalidValue;
  }
  const int threads = 256;
  const long long blocks = (n_groups + threads - 1) / threads;
  bitonic_global_kernel<NS, NK, F>
      <<<static_cast<unsigned>(blocks), threads, 0, stream>>>(
          x, skip, stride, n_groups, s, j_lo, force_asc);
  return cudaGetLastError();
}

template <int NS, int NK>
cudaError_t launch_global(uint32_t* x, const int* skip, long long ext,
                          long long stride, int s, int j_hi, int j_lo,
                          bool asc, cudaStream_t stream) {
  switch (j_hi - j_lo + 1) {
    case 1:
      return launch_global_f<NS, NK, 1>(x, skip, ext, stride, s, j_lo, asc,
                                        stream);
    case 2:
      return launch_global_f<NS, NK, 2>(x, skip, ext, stride, s, j_lo, asc,
                                        stream);
    case 3:
      return launch_global_f<NS, NK, 3>(x, skip, ext, stride, s, j_lo, asc,
                                        stream);
    case 4:
      if constexpr (f_max(NS) >= 4) {
        return launch_global_f<NS, NK, 4>(x, skip, ext, stride, s, j_lo, asc,
                                          stream);
      }
      return cudaErrorInvalidValue;
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// Every stream set of the library: the narrow sets (NS in 1..4 streams,
// NK in 1..2 keys) and the wide sets listed at the top of the file. The
// cases must match ops/bitonic.py STREAM_SETS.
#define SORTX_CASE(ns_, nk_, ...)                              \
  case (ns_) * 16 + (nk_): {                                   \
    constexpr int NS = (ns_), NK = (nk_);                      \
    return __VA_ARGS__;                                        \
  }
#define SORTX_DISPATCH_STREAMS(ns, nk, ...)                    \
  switch ((ns) * 16 + (nk)) {                                  \
    SORTX_CASE(1, 1, __VA_ARGS__) SORTX_CASE(2, 1, __VA_ARGS__) \
    SORTX_CASE(2, 2, __VA_ARGS__) SORTX_CASE(3, 1, __VA_ARGS__) \
    SORTX_CASE(3, 2, __VA_ARGS__) SORTX_CASE(4, 1, __VA_ARGS__) \
    SORTX_CASE(4, 2, __VA_ARGS__) SORTX_CASE(3, 3, __VA_ARGS__) \
    SORTX_CASE(4, 3, __VA_ARGS__) SORTX_CASE(5, 2, __VA_ARGS__) \
    SORTX_CASE(4, 4, __VA_ARGS__) SORTX_CASE(5, 5, __VA_ARGS__) \
    SORTX_CASE(6, 6, __VA_ARGS__) SORTX_CASE(7, 7, __VA_ARGS__) \
    SORTX_CASE(8, 8, __VA_ARGS__)                              \
    default: return cudaErrorInvalidValue;                     \
  }

extern "C" int sortx_bitonic_block(void* x, const void* skip, long long ext,
                                   long long stride, int ns, int nk,
                                   int log_block, int row_log, void* stream) {
  if (log_block < 1 || log_block > 30 || row_log < 0 || row_log > log_block) {
    return cudaErrorInvalidValue;
  }
  auto* p = static_cast<uint32_t*>(x);
  const auto* sk = static_cast<const int*>(skip);
  auto st = static_cast<cudaStream_t>(stream);
  SORTX_DISPATCH_STREAMS(ns, nk,
                         launch_k1<NS, NK>(p, sk, ext, stride, log_block,
                                           row_log, st))
}

extern "C" int sortx_bitonic_tail(void* x, const void* skip, long long ext,
                                  long long stride, int ns, int nk,
                                  int log_block, int s, int force_asc,
                                  void* stream) {
  // s == L only for the merge stage, which runs ascending
  if (log_block < 1 || log_block > 30 || s < log_block ||
      (s == log_block && !force_asc)) {
    return cudaErrorInvalidValue;
  }
  auto* p = static_cast<uint32_t*>(x);
  const auto* sk = static_cast<const int*>(skip);
  auto st = static_cast<cudaStream_t>(stream);
  SORTX_DISPATCH_STREAMS(ns, nk,
                         launch_k2<NS, NK>(p, sk, ext, stride, log_block, s,
                                           force_asc != 0 ? 1 : 0, st))
}

extern "C" int sortx_bitonic_global(void* x, const void* skip, long long ext,
                                    long long stride, int ns, int nk, int s,
                                    int j_hi, int j_lo, int force_asc,
                                    void* stream) {
  if (j_hi >= s || j_lo > j_hi) return cudaErrorInvalidValue;
  auto* p = static_cast<uint32_t*>(x);
  const auto* sk = static_cast<const int*>(skip);
  auto st = static_cast<cudaStream_t>(stream);
  SORTX_DISPATCH_STREAMS(ns, nk,
                         launch_global<NS, NK>(p, sk, ext, stride, s, j_hi,
                                               j_lo, force_asc != 0, st))
}

// K8 over n words: src and out do not overlap; flags is one int on the
// card (ops/bitonic.py reverse_ordered).
extern "C" int sortx_reverse_ordered(const void* flags, const void* src,
                                     void* out, long long n, void* stream) {
  if (n <= 0 || flags == nullptr) return cudaErrorInvalidValue;
  const long long per_block = static_cast<long long>(kRevThreads) * kRevUnroll;
  // enough CTAs to fill the card, each walking the rest of the words
  const long long blocks = std::min((n + per_block - 1) / per_block, 132LL * 8);
  reverse_kernel<<<static_cast<unsigned>(blocks), kRevThreads, 0,
                   static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(flags), static_cast<const uint32_t*>(src),
      static_cast<uint32_t*>(out), n);
  return cudaGetLastError();
}

// Shared by every C entry of the library (the scan entry included).
extern "C" const char* sortx_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
