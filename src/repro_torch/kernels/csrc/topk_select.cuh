// Exact blockwise top-k selection in shared memory, shared by
// topk_ef_sparse.cu (compacted picks) and topk_ef.cu (dense hat).
//
// Each value of a selection block becomes a 64-bit key (|v| bits << 32) |
// (0xFFFFFFFF - local_idx). Non-negative fp32 bit patterns order like the
// floats, and the low word makes a lower index the larger key, so a
// descending bitonic sort of the keys is lax.top_k's order exactly
// (descending |v|, ties to the lowest index; a NaN's magnitude bits sort
// above every number). Sort padding up to the next power of two uses key 0,
// below every real key. k == 1 takes a max reduction over the same keys
// instead of the sort.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace topk {

constexpr int kMaxBlock = 2048;
constexpr int kThreads = 512;

__device__ __forceinline__ unsigned long long make_key(float v, int local) {
  const unsigned int mag = __float_as_uint(v) & 0x7FFFFFFFu;
  return (static_cast<unsigned long long>(mag) << 32) |
         static_cast<unsigned long long>(0xFFFFFFFFu -
                                         static_cast<unsigned int>(local));
}

__device__ __forceinline__ int key_index(unsigned long long key) {
  return static_cast<int>(0xFFFFFFFFu -
                          static_cast<unsigned int>(key & 0xFFFFFFFFull));
}

// Every thread of the CTA calls this after tot[0..block) is in shared
// memory and a barrier has passed. On return (after a barrier) keys[0..k)
// hold the k picks in selection order; tot is only read.
__device__ __forceinline__ void select_block(
    const float* tot, unsigned long long* keys,
    unsigned long long* warp_best, int block, int k, int pow2) {
  const int tid = threadIdx.x;
  if (k == 1) {
    unsigned long long best = 0ull;
    for (int i = tid; i < block; i += blockDim.x) {
      const unsigned long long key = make_key(tot[i], i);
      best = key > best ? key : best;
    }
    for (int off = 16; off > 0; off >>= 1) {
      const unsigned long long o = __shfl_down_sync(0xFFFFFFFFu, best, off);
      best = o > best ? o : best;
    }
    if ((tid & 31) == 0) warp_best[tid >> 5] = best;
    __syncthreads();
    if (tid < 32) {
      best = tid < static_cast<int>(blockDim.x >> 5) ? warp_best[tid] : 0ull;
      for (int off = 16; off > 0; off >>= 1) {
        const unsigned long long o = __shfl_down_sync(0xFFFFFFFFu, best, off);
        best = o > best ? o : best;
      }
      if (tid == 0) keys[0] = best;
    }
    __syncthreads();
    return;
  }
  for (int i = tid; i < pow2; i += blockDim.x)
    keys[i] = (i < block) ? make_key(tot[i], i) : 0ull;
  __syncthreads();
  // bitonic sort, descending
  for (int size = 2; size <= pow2; size <<= 1) {
    for (int stride = size >> 1; stride > 0; stride >>= 1) {
      for (int i = tid; i < pow2; i += blockDim.x) {
        const int j = i ^ stride;
        if (j > i) {
          const unsigned long long a = keys[i];
          const unsigned long long e = keys[j];
          const bool descending = (i & size) == 0;
          if (descending ? (a < e) : (a > e)) {
            keys[i] = e;
            keys[j] = a;
          }
        }
      }
      __syncthreads();
    }
  }
}

// smallest power of two >= block (the sort's width)
inline int sort_width(int block) {
  int pow2 = 1;
  while (pow2 < block) pow2 <<= 1;
  return pow2;
}

}  // namespace topk
