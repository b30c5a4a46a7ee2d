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
// not overlap; output that no run covers keeps the fill. One CTA owns
// one output chunk: it walks the runs (K6) or pieces (K7) that land in
// its chunk in destination order and, for each, fills the gap before
// it and copies the run's part that lies in the chunk. Every output
// word is written exactly once and no two CTAs write the same word, so
// there are no ordering hazards and no barriers.
//
// What bounds them on the card: device memory, 8 bytes per element and
// stream (one read, one write), plus the run table. Threads of a CTA
// copy neighbouring words of a run, so loads and stores coalesce up to
// the runs' misalignment. The TPU means do not come along: aligned DMA
// covers and the flat roll, DMA slots and semaphores, the source
// padding (reads past the end of a source give 0 here, as its zero
// padding gave there) and the splitting of large plans for SMEM. A CTA
// walks its runs one after another, so a chunk made of many tiny runs
// leaves most threads idle; a warp-per-run schedule is later work.
//
// C entries return cudaGetLastError() and launch on the stream given;
// they allocate nothing and do not sync.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kMaxStreams = 4;
constexpr int kThreads = 512;

struct Streams {
  const uint32_t* src[kMaxStreams];
  uint32_t* out[kMaxStreams];
  uint32_t fill[kMaxStreams];
};

template <int NS>
__device__ __forceinline__ void fill_range(const Streams& st, long long lo,
                                           long long hi) {
  for (long long i = lo + threadIdx.x; i < hi; i += blockDim.x) {
#pragma unroll
    for (int t = 0; t < NS; ++t) st.out[t][i] = st.fill[t];
  }
}

// The chunk [c0, c1) of the output, given its runs in destination order:
// run(k) yields (src, dst, len) of the k-th run, for k < count.
template <int NS, typename RunAt>
__device__ __forceinline__ void move_chunk(const Streams& st,
                                           long long src_len, long long c0,
                                           long long c1, int count,
                                           RunAt run) {
  long long cursor = c0;
  for (int k = 0; k < count; ++k) {
    long long s, d, len;
    run(k, s, d, len);
    const long long lo = d > c0 ? d : c0;
    const long long hi = d + len < c1 ? d + len : c1;
    if (hi <= lo) continue;  // empty, or not in this chunk
    fill_range<NS>(st, cursor, lo);
    const long long from = s + (lo - d);
    for (long long i = threadIdx.x; i < hi - lo; i += blockDim.x) {
      const long long at = from + i;
      const bool in = at >= 0 && at < src_len;
#pragma unroll
      for (int t = 0; t < NS; ++t) {
        st.out[t][lo + i] = in ? st.src[t][at] : 0u;
      }
    }
    cursor = hi;
  }
  fill_range<NS>(st, cursor, c1);
}

// K6: chunk c holds runs chunk_first[c] .. + chunk_count[c] of the
// destination-sorted run table.
template <int NS>
__global__ void __launch_bounds__(kThreads)
    run_mover_kernel(Streams st, long long src_len,
                     const int* __restrict__ run_src,
                     const int* __restrict__ run_dst,
                     const int* __restrict__ run_len,
                     const int* __restrict__ chunk_first,
                     const int* __restrict__ chunk_count, long long chunk) {
  const long long c0 = static_cast<long long>(blockIdx.x) * chunk;
  const int first = chunk_first[blockIdx.x];
  move_chunk<NS>(st, src_len, c0, c0 + chunk, chunk_count[blockIdx.x],
                 [&](int k, long long& s, long long& d, long long& len) {
                   s = run_src[first + k];
                   d = run_dst[first + k];
                   len = run_len[first + k];
                 });
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
  const long long c0 = static_cast<long long>(blockIdx.x) * chunk;
  const int first = chunk_first[blockIdx.x];
  move_chunk<1>(st, src_len, c0, c0 + chunk, chunk_count[blockIdx.x],
                [&](int k, long long& s, long long& d, long long& len) {
                  s = piece_src[first + k];
                  d = c0 + piece_dst_off[first + k];
                  len = piece_len[first + k];
                });
}

Streams make_streams(int ns, const void* const* srcs, void* const* outs,
                     const unsigned* fills) {
  Streams st{};
  for (int t = 0; t < ns; ++t) {
    st.src[t] = static_cast<const uint32_t*>(srcs[t]);
    st.out[t] = static_cast<uint32_t*>(outs[t]);
    st.fill[t] = fills[t];
  }
  return st;
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
  if (ns < 1 || ns > kMaxStreams || chunk <= 0 || out_len <= 0 ||
      out_len % chunk != 0) {
    return cudaErrorInvalidValue;
  }
  const Streams st = make_streams(ns, srcs, outs, fills);
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
  if (chunk <= 0 || out_len <= 0 || out_len % chunk != 0) {
    return cudaErrorInvalidValue;
  }
  const unsigned zero = 0;
  const Streams st = make_streams(1, &src, &out, &zero);
  piece_mover_kernel<<<static_cast<unsigned>(out_len / chunk), kThreads, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      st, src_len, static_cast<const int*>(piece_src),
      static_cast<const int*>(piece_dst_off),
      static_cast<const int*>(piece_len),
      static_cast<const int*>(chunk_first),
      static_cast<const int*>(chunk_count), chunk);
  return cudaGetLastError();
}
