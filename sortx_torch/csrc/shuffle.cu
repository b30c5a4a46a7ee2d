// Receiver-driven run movers for Hopper (sm_90a).
//
// Replace the TPU kernels of sortx/ops/shuffle.py:
//   run_mover_kernel   <- _runs_mover_kernel  N streams, device run
//                                             table, per-stream fills
//   piece_mover_kernel <- _mover_kernel       one stream, host-built
//                                             piece plan, zero fill
//
// Both apply a run-concatenation permutation out[d + j] = src[s + j]
// (j < len) for runs (s, d, len) whose destinations are sorted and do
// not overlap; output that no run covers keeps the fill (0 for K7), and
// a read below 0 or at src_len and above gives 0. One CTA owns one
// output chunk and writes every word of it exactly once; no two CTAs
// write the same word, so there are no ordering hazards between CTAs.
//
// What bounds them on the card: device memory. K7 moves 8 bytes a word
// (one read, one write) plus 12 bytes a piece and 8 a chunk of plan;
// K6 reads the words its runs hold, writes the whole output, and reads
// 12 bytes a run. The design is output-driven, so that the time depends
// on the bytes and not on how the runs cut a chunk:
//
//  * The CTA reads its chunk's pieces (K7) or runs (K6, clipped to the
//    chunk) into shared memory, up to kCap at a time, as (begin, end,
//    source of begin). Each 16-byte output vector then finds the piece
//    that holds its first word by a branch-free binary search over the
//    begins, so every thread has work however long the pieces are.
//    A batch owns the output from the end of the one before to the
//    first begin of the one after, so chunks of any piece count run.
//  * Each thread writes kVec aligned 16-byte vectors a step (4 for one
//    stream: a CTA of 256 threads covers 4096 words a step), and issues
//    the loads of all of them before the first store: read-only loads
//    through the non-coherent path, and streaming stores (the output is
//    written once and not read back). With 48 registers a thread and no
//    spills, 5 CTAs an SM keep about 80 KB of loads in flight, where the
//    parent's loop kept one dependent 4-byte load a thread. A vector
//    whose four words lie in one piece loads one 16-byte vector where
//    source and destination agree mod 4, else four words, which still
//    coalesce across the warp. Vectors at a piece's edge or past the
//    source go word by word. The up to 3 words at each end of a chunk
//    that is not on the 16-byte grid (chunk % 4 != 0) go word by word.
//
// The TPU means do not come along: aligned DMA covers and the flat roll
// (the misaligned words are loaded where they lie), DMA slots and
// semaphores, the source padding (the bounds check gives the zeros its
// padding gave) and the splitting of large plans for SMEM (the batches).
//
// C entries return cudaGetLastError() and launch on the stream given;
// they allocate nothing and do not sync. The outputs must lie on the
// 16-byte grid (the wrappers allocate them); sources may lie anywhere.

#include <climits>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kMaxStreams = 4;
constexpr int kThreads = 256;
constexpr int kCap = 1024;  // pieces of a chunk in shared memory at a time

// 16-byte vectors a thread per step: the loads in flight fill 12 to 16
// registers whatever the stream count (twice as many spill).
template <int NS>
constexpr int kVec = NS == 1 ? 4 : NS == 2 ? 2 : 1;

struct Streams {
  const uint32_t* src[kMaxStreams];
  uint32_t* out[kMaxStreams];
  uint32_t fill[kMaxStreams];
  int src_mis[kMaxStreams];  // (address / 4) % 4 of src[t]
};

// One batch of a chunk's pieces, as offsets from the chunk's start.
struct Batch {
  int beg[kCap];
  int end[kCap];        // == beg for a piece that covers nothing
  long long src[kCap];  // source index of beg
  int max_end;          // largest end of the batches so far
};

// Last piece of the batch whose begin is at or below p, or -1; steps is
// the bit length of n.
__device__ __forceinline__ int find(const Batch& b, int n, int steps, int p) {
  int j = -1;
  for (int s = steps - 1; s >= 0; --s) {
    const int m = j + (1 << s);
    if (m < n && b.beg[m] <= p) j = m;
  }
  return j;
}

// The word at offset p of every stream, given j = find(p) or any piece
// before it.
template <int NS>
__device__ __forceinline__ void word_at(const Streams& st, long long src_len,
                                        const Batch& b, int n, int& j, int p,
                                        uint32_t (&w)[NS]) {
  while (j + 1 < n && b.beg[j + 1] <= p) ++j;
  int k = j;
  while (k >= 0 && b.end[k] <= b.beg[k]) --k;  // empty pieces cover nothing
  if (k >= 0 && p < b.end[k]) {
    const long long s = b.src[k] + (p - b.beg[k]);
    const bool in = s >= 0 && s < src_len;
#pragma unroll
    for (int t = 0; t < NS; ++t) w[t] = in ? __ldg(st.src[t] + s) : 0u;
  } else {
#pragma unroll
    for (int t = 0; t < NS; ++t) w[t] = st.fill[t];
  }
}

// The 16-byte vector at offsets p .. p + 3 of every stream; j = find(p).
template <int NS>
__device__ __forceinline__ void vector_at(const Streams& st, long long src_len,
                                          const Batch& b, int n, int j, int p,
                                          uint4 (&v)[NS]) {
  if (j >= 0 && p + 4 <= b.end[j]) {
    const long long s = b.src[j] + (p - b.beg[j]);
    if (s >= 0 && s + 4 <= src_len) {
#pragma unroll
      for (int t = 0; t < NS; ++t) {
        const uint32_t* a = st.src[t] + s;
        if (((s + st.src_mis[t]) & 3) == 0) {
          v[t] = __ldg(reinterpret_cast<const uint4*>(a));
        } else {
          v[t] = make_uint4(__ldg(a), __ldg(a + 1), __ldg(a + 2), __ldg(a + 3));
        }
      }
      return;
    }
  }
  uint32_t w[4][NS];
#pragma unroll
  for (int i = 0; i < 4; ++i) word_at<NS>(st, src_len, b, n, j, p + i, w[i]);
#pragma unroll
  for (int t = 0; t < NS; ++t) v[t] = make_uint4(w[0][t], w[1][t], w[2][t], w[3][t]);
}

// Write offsets [lo, hi) of the chunk at word c0 from the batch of n
// pieces in shared memory.
template <int NS>
__device__ __forceinline__ void copy_range(const Streams& st, long long src_len,
                                           long long c0, int lo, int hi,
                                           const Batch& b, int n) {
  constexpr int V = kVec<NS>;
  const int steps = n > 0 ? 32 - __clz(n) : 0;
  // 16-byte vectors start where c0 + p is a multiple of 4
  int vlo = lo + static_cast<int>((4 - ((c0 + lo) & 3)) & 3);
  if (vlo > hi) vlo = hi;
  const int nv = (hi - vlo) >> 2;
  const int vhi = vlo + 4 * nv;
  const int n_head = vlo - lo;
  if (threadIdx.x < n_head + (hi - vhi)) {  // at most 6 words
    const int p = threadIdx.x < n_head ? lo + threadIdx.x
                                       : vhi + threadIdx.x - n_head;
    int j = find(b, n, steps, p);
    uint32_t w[NS];
    word_at<NS>(st, src_len, b, n, j, p, w);
#pragma unroll
    for (int t = 0; t < NS; ++t) __stcs(st.out[t] + c0 + p, w[t]);
  }
  for (int base = threadIdx.x; base < nv; base += kThreads * V) {
    int p[V], j[V];
#pragma unroll
    for (int k = 0; k < V; ++k) {
      p[k] = vlo + 4 * (base + k * kThreads);
      j[k] = -1;
    }
    for (int s = steps - 1; s >= 0; --s) {
#pragma unroll
      for (int k = 0; k < V; ++k) {
        const int m = j[k] + (1 << s);
        if (m < n && b.beg[m] <= p[k]) j[k] = m;
      }
    }
    uint4 v[V][NS];
#pragma unroll
    for (int k = 0; k < V; ++k) {
      if (base + k * kThreads < nv) vector_at<NS>(st, src_len, b, n, j[k], p[k], v[k]);
    }
#pragma unroll
    for (int k = 0; k < V; ++k) {
      if (base + k * kThreads < nv) {
#pragma unroll
        for (int t = 0; t < NS; ++t) {
          __stcs(reinterpret_cast<uint4*>(st.out[t] + c0 + p[k]), v[k][t]);
        }
      }
    }
  }
}

// Piece k of a chunk of `chunk` words, given as (dst offset d from the
// chunk's start, len, src), clipped to the chunk.
__device__ __forceinline__ void clip(long long d, long long len, long long s,
                                     long long chunk, int& beg, int& end,
                                     long long& src) {
  const long long bb = d < 0 ? 0 : d > chunk ? chunk : d;
  long long ee = d + len;
  ee = ee > chunk ? chunk : ee < bb ? bb : ee;
  beg = static_cast<int>(bb);
  end = static_cast<int>(ee);
  src = s + (bb - d);
}

// The chunk [c0, c0 + chunk) of the output, given its `count` pieces in
// destination order: piece(k, d, len, s) yields the k-th as (dst offset
// from c0, length, source index).
template <int NS, typename PieceAt>
__device__ __forceinline__ void move_chunk(const Streams& st, long long src_len,
                                           long long c0, long long chunk,
                                           int count, PieceAt piece,
                                           Batch& b) {
  if (threadIdx.x == 0) b.max_end = 0;
  int lo = 0;
  for (int b0 = 0;; b0 += kCap) {
    const int n = count - b0 < kCap ? (count - b0 > 0 ? count - b0 : 0) : kCap;
    const bool last = count - b0 <= kCap;
    __syncthreads();  // the batch before is done with shared memory
    int top = 0;
    for (int k = threadIdx.x; k < n; k += kThreads) {
      long long d, len, s;
      piece(b0 + k, d, len, s);
      clip(d, len, s, chunk, b.beg[k], b.end[k], b.src[k]);
      top = max(top, b.end[k]);
    }
    top = __reduce_max_sync(0xffffffffu, top);
    if ((threadIdx.x & 31) == 0) atomicMax(&b.max_end, top);
    // a batch ends where the next one's first piece begins, or past the
    // end of its own pieces if an empty piece begins inside one
    int hi = static_cast<int>(chunk);
    if (!last) {
      long long d, len, s;
      piece(b0 + kCap, d, len, s);
      int nb, ne;
      long long ns;
      clip(d, len, s, chunk, nb, ne, ns);
      hi = nb;
    }
    __syncthreads();
    if (!last && b.max_end > hi) hi = b.max_end;
    copy_range<NS>(st, src_len, c0, lo, hi, b, n);
    if (last) break;
    lo = hi;
  }
}

// K6: chunk c holds runs chunk_first[c] .. + chunk_count[c] of the
// destination-sorted run table (runs may reach past the chunk).
template <int NS>
__global__ void __launch_bounds__(kThreads)
    run_mover_kernel(Streams st, long long src_len,
                     const int* __restrict__ run_src,
                     const int* __restrict__ run_dst,
                     const int* __restrict__ run_len,
                     const int* __restrict__ chunk_first,
                     const int* __restrict__ chunk_count, long long chunk) {
  __shared__ Batch b;
  const long long c0 = static_cast<long long>(blockIdx.x) * chunk;
  const int first = __ldg(chunk_first + blockIdx.x);
  move_chunk<NS>(st, src_len, c0, chunk, __ldg(chunk_count + blockIdx.x),
                 [&](int k, long long& d, long long& len, long long& s) {
                   d = __ldg(run_dst + first + k) - c0;
                   len = __ldg(run_len + first + k);
                   s = __ldg(run_src + first + k);
                 },
                 b);
}

// K7: chunk c holds pieces chunk_first[c] .. + chunk_count[c], each
// inside the chunk, at offset piece_dst_off from its start.
__global__ void __launch_bounds__(kThreads)
    piece_mover_kernel(Streams st, long long src_len,
                       const int* __restrict__ piece_src,
                       const int* __restrict__ piece_dst_off,
                       const int* __restrict__ piece_len,
                       const int* __restrict__ chunk_first,
                       const int* __restrict__ chunk_count, long long chunk) {
  __shared__ Batch b;
  const long long c0 = static_cast<long long>(blockIdx.x) * chunk;
  const int first = __ldg(chunk_first + blockIdx.x);
  move_chunk<1>(st, src_len, c0, chunk, __ldg(chunk_count + blockIdx.x),
                [&](int k, long long& d, long long& len, long long& s) {
                  d = __ldg(piece_dst_off + first + k);
                  len = __ldg(piece_len + first + k);
                  s = __ldg(piece_src + first + k);
                },
                b);
}

// Streams of ns sources and outputs; false if an output is off the
// 16-byte grid.
bool make_streams(int ns, const void* const* srcs, void* const* outs,
                  const unsigned* fills, Streams& st) {
  st = Streams{};
  for (int t = 0; t < ns; ++t) {
    st.src[t] = static_cast<const uint32_t*>(srcs[t]);
    st.out[t] = static_cast<uint32_t*>(outs[t]);
    st.fill[t] = fills[t];
    st.src_mis[t] = static_cast<int>((reinterpret_cast<uintptr_t>(srcs[t]) >> 2) & 3);
    if (reinterpret_cast<uintptr_t>(outs[t]) & 15) return false;
  }
  return true;
}

bool bad_shape(long long out_len, long long chunk) {
  return chunk <= 0 || chunk > INT_MAX || out_len <= 0 ||
         out_len % chunk != 0 || out_len / chunk > INT_MAX;
}

}  // namespace

// K6 over out_len / chunk chunks of ns streams; srcs, outs and fills
// are host arrays of ns entries, the tables device int32 arrays.
extern "C" int sortx_move_runs(const void* const* srcs, void* const* outs,
                               const unsigned* fills, int ns,
                               long long src_len, const void* run_src,
                               const void* run_dst, const void* run_len,
                               const void* chunk_first,
                               const void* chunk_count, long long out_len,
                               long long chunk, void* stream) {
  Streams st;
  if (ns < 1 || ns > kMaxStreams || bad_shape(out_len, chunk) ||
      !make_streams(ns, srcs, outs, fills, st)) {
    return cudaErrorInvalidValue;
  }
  const auto blocks = static_cast<unsigned>(out_len / chunk);
  auto s = static_cast<cudaStream_t>(stream);
  const auto* rs = static_cast<const int*>(run_src);
  const auto* rd = static_cast<const int*>(run_dst);
  const auto* rl = static_cast<const int*>(run_len);
  const auto* cf = static_cast<const int*>(chunk_first);
  const auto* cc = static_cast<const int*>(chunk_count);
  switch (ns) {
    case 1:
      run_mover_kernel<1><<<blocks, kThreads, 0, s>>>(st, src_len, rs, rd, rl,
                                                      cf, cc, chunk);
      break;
    case 2:
      run_mover_kernel<2><<<blocks, kThreads, 0, s>>>(st, src_len, rs, rd, rl,
                                                      cf, cc, chunk);
      break;
    case 3:
      run_mover_kernel<3><<<blocks, kThreads, 0, s>>>(st, src_len, rs, rd, rl,
                                                      cf, cc, chunk);
      break;
    default:
      run_mover_kernel<4><<<blocks, kThreads, 0, s>>>(st, src_len, rs, rd, rl,
                                                      cf, cc, chunk);
      break;
  }
  return cudaGetLastError();
}

// K7 over out_len / chunk chunks of one stream, zero fill.
extern "C" int sortx_apply_pieces(const void* src, void* out,
                                  long long src_len, const void* piece_src,
                                  const void* piece_dst_off,
                                  const void* piece_len,
                                  const void* chunk_first,
                                  const void* chunk_count, long long out_len,
                                  long long chunk, void* stream) {
  const unsigned zero = 0;
  Streams st;
  if (bad_shape(out_len, chunk) || !make_streams(1, &src, &out, &zero, st)) {
    return cudaErrorInvalidValue;
  }
  piece_mover_kernel<<<static_cast<unsigned>(out_len / chunk), kThreads, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      st, src_len, static_cast<const int*>(piece_src),
      static_cast<const int*>(piece_dst_off),
      static_cast<const int*>(piece_len),
      static_cast<const int*>(chunk_first),
      static_cast<const int*>(chunk_count), chunk);
  return cudaGetLastError();
}
