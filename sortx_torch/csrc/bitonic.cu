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
// What bounds them on the card: every pass reads and writes each of
// the NS streams once (8 * NS bytes per element), and the network's
// cost is the number of passes over device memory. The design cuts
// passes: the block kernels hold all NS streams of a block in shared
// memory and run every layer below L there (one pass for stages 1..L,
// one pass per later stage), and the global kernel keeps 2^F elements
// per thread in registers so that F cross-block layers cost one pass.
// Loads and stores are coalesced: neighbouring threads touch
// neighbouring words. No tensor cores, TMA or warp specialisation yet.
//
// C entries return cudaGetLastError() (or the first error met) and
// launch on the stream given; they allocate nothing and do not sync.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

// a < b on the first NK words, unsigned, lexicographic.
template <int NK>
__device__ __forceinline__ bool lex_lt(const uint32_t* a, const uint32_t* b) {
#pragma unroll
  for (int t = 0; t < NK; ++t) {
    if (a[t] != b[t]) return a[t] < b[t];
  }
  return false;
}

// One compare-exchange layer at distance 2^j over a shared-memory block
// of len elements per stream (stream t at sm + t * len); base is the
// block's first flat index, s the stage.
template <int NS, int NK>
__device__ __forceinline__ void smem_layer(uint32_t* sm, int len, int j,
                                           long long base, int s) {
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
    const bool desc = ((base + lo) >> s) & 1;
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

// K1: all stages 1..L of one 2^L block, in place.
template <int NS, int NK>
__global__ void __launch_bounds__(1024)
    bitonic_block_kernel(uint32_t* __restrict__ x, long long stride,
                         int log_block) {
  extern __shared__ uint32_t sm[];
  const int len = 1 << log_block;
  const long long base = static_cast<long long>(blockIdx.x) << log_block;
  load_block<NS>(sm, x, stride, base, len);
  for (int s = 1; s <= log_block; ++s) {
    for (int j = s - 1; j >= 0; --j) smem_layer<NS, NK>(sm, len, j, base, s);
  }
  store_block<NS>(sm, x, stride, base, len);
}

// K2: layers L-1..0 of stage s > L for one 2^L block, in place. The
// direction is constant over the block.
template <int NS, int NK>
__global__ void __launch_bounds__(1024)
    bitonic_tail_kernel(uint32_t* __restrict__ x, long long stride,
                        int log_block, int s) {
  extern __shared__ uint32_t sm[];
  const int len = 1 << log_block;
  const long long base = static_cast<long long>(blockIdx.x) << log_block;
  load_block<NS>(sm, x, stride, base, len);
  for (int j = log_block - 1; j >= 0; --j) {
    smem_layer<NS, NK>(sm, len, j, base, s);
  }
  store_block<NS>(sm, x, stride, base, len);
}

// K3: layers j_lo+F-1..j_lo of stage s, in place. Thread g owns the 2^F
// elements i0 + r * 2^j_lo (r < 2^F), where i0 is g with F zero bits
// inserted at bit j_lo; they stay in registers for all F layers.
template <int NS, int NK, int F>
__global__ void __launch_bounds__(256)
    bitonic_global_kernel(uint32_t* __restrict__ x, long long stride,
                          long long n_groups, int s, int j_lo) {
  constexpr int R = 1 << F;
  const long long g =
      static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (g >= n_groups) return;
  const long long low = g & ((1LL << j_lo) - 1);
  const long long i0 = ((g >> j_lo) << (j_lo + F)) | low;
  const bool desc = (i0 >> s) & 1;
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

// Launch K1 (s == 0) or K2 (stage s) over ext / 2^L blocks.
template <int NS, int NK>
cudaError_t launch_block(uint32_t* x, long long ext, long long stride,
                         int log_block, int s, cudaStream_t stream) {
  const int len = 1 << log_block;
  const long long blocks = ext >> log_block;
  if (blocks <= 0 || (ext & (len - 1)) != 0) return cudaErrorInvalidValue;
  const int threads = len / 2 < 1024 ? len / 2 : 1024;
  const int smem = static_cast<int>(sizeof(uint32_t)) * NS * len;
  cudaError_t err;
  if (s == 0) {
    err = cudaFuncSetAttribute(bitonic_block_kernel<NS, NK>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               smem);
    if (err != cudaSuccess) return err;
    bitonic_block_kernel<NS, NK>
        <<<static_cast<unsigned>(blocks), threads, smem, stream>>>(
            x, stride, log_block);
  } else {
    err = cudaFuncSetAttribute(bitonic_tail_kernel<NS, NK>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               smem);
    if (err != cudaSuccess) return err;
    bitonic_tail_kernel<NS, NK>
        <<<static_cast<unsigned>(blocks), threads, smem, stream>>>(
            x, stride, log_block, s);
  }
  return cudaGetLastError();
}

template <int NS, int NK, int F>
cudaError_t launch_global_f(uint32_t* x, long long ext, long long stride,
                            int s, int j_lo, cudaStream_t stream) {
  const long long n_groups = ext >> F;
  if (n_groups <= 0 || (ext & ((1LL << (j_lo + F)) - 1)) != 0) {
    return cudaErrorInvalidValue;
  }
  const int threads = 256;
  const long long blocks = (n_groups + threads - 1) / threads;
  bitonic_global_kernel<NS, NK, F>
      <<<static_cast<unsigned>(blocks), threads, 0, stream>>>(
          x, stride, n_groups, s, j_lo);
  return cudaGetLastError();
}

template <int NS, int NK>
cudaError_t launch_global(uint32_t* x, long long ext, long long stride, int s,
                          int j_hi, int j_lo, cudaStream_t stream) {
  switch (j_hi - j_lo + 1) {
    case 1: return launch_global_f<NS, NK, 1>(x, ext, stride, s, j_lo, stream);
    case 2: return launch_global_f<NS, NK, 2>(x, ext, stride, s, j_lo, stream);
    case 3: return launch_global_f<NS, NK, 3>(x, ext, stride, s, j_lo, stream);
    case 4: return launch_global_f<NS, NK, 4>(x, ext, stride, s, j_lo, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// Every stream set of the sort path: NS in 1..4 streams, NK in 1..2 keys.
#define SORTX_DISPATCH_STREAMS(ns, nk, ...)                   \
  switch ((ns) * 4 + (nk)) {                                  \
    case 5: { constexpr int NS = 1, NK = 1; return __VA_ARGS__; }  \
    case 9: { constexpr int NS = 2, NK = 1; return __VA_ARGS__; }  \
    case 10: { constexpr int NS = 2, NK = 2; return __VA_ARGS__; } \
    case 13: { constexpr int NS = 3, NK = 1; return __VA_ARGS__; } \
    case 14: { constexpr int NS = 3, NK = 2; return __VA_ARGS__; } \
    case 17: { constexpr int NS = 4, NK = 1; return __VA_ARGS__; } \
    case 18: { constexpr int NS = 4, NK = 2; return __VA_ARGS__; } \
    default: return cudaErrorInvalidValue;                    \
  }

extern "C" int sortx_bitonic_block(void* x, long long ext, long long stride,
                                   int ns, int nk, int log_block,
                                   void* stream) {
  auto* p = static_cast<uint32_t*>(x);
  auto st = static_cast<cudaStream_t>(stream);
  SORTX_DISPATCH_STREAMS(ns, nk,
                         launch_block<NS, NK>(p, ext, stride, log_block, 0, st))
}

extern "C" int sortx_bitonic_tail(void* x, long long ext, long long stride,
                                  int ns, int nk, int log_block, int s,
                                  void* stream) {
  if (s <= log_block) return cudaErrorInvalidValue;
  auto* p = static_cast<uint32_t*>(x);
  auto st = static_cast<cudaStream_t>(stream);
  SORTX_DISPATCH_STREAMS(ns, nk,
                         launch_block<NS, NK>(p, ext, stride, log_block, s, st))
}

extern "C" int sortx_bitonic_global(void* x, long long ext, long long stride,
                                    int ns, int nk, int s, int j_hi, int j_lo,
                                    void* stream) {
  if (j_hi >= s || j_lo > j_hi) return cudaErrorInvalidValue;
  auto* p = static_cast<uint32_t*>(x);
  auto st = static_cast<cudaStream_t>(stream);
  SORTX_DISPATCH_STREAMS(
      ns, nk, launch_global<NS, NK>(p, ext, stride, s, j_hi, j_lo, st))
}

// Shared by every C entry of the library (the scan entry included).
extern "C" const char* sortx_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
