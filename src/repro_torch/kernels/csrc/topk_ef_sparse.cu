// Blockwise exact top-k with fused error feedback, for Hopper (sm_90a).
//
// Replaces the Pallas kernel src/repro/kernels/topk_ef.py::topk_ef_sparse
// (_topk_ef_sparse_kernel / _select_block): per selection block of `block`
// (<= 2048) fp32 values, tot = x + err; keep EXACTLY k entries by |tot| in
// lax.top_k order (descending, ties to the lowest index); emit the kept
// values, their global flat indices, and new_err = tot with the picks zeroed.
//
// Layout: one launch serves every client of a round. x is (c, d) deltas,
// err the resident (m, d) EF buffer, rows (c,) the client rows of err; the
// kernel updates those rows IN PLACE (each thread reads its values before
// it writes them back, and rows are distinct). vals/idx are (c, nb, k). One
// CTA of 256 threads per (block, client).
//
// Bound on this card: bytes. Per element it reads x and err and writes err
// (12 bytes), plus 8 bytes per pick. So each value is read once into a
// register, where tot, the selection and the EF residual are computed, and
// written once from there, by warp accesses of 128 contiguous bytes;
// shared memory holds only the selection's histograms and the k picks. The
// membership comes from topk_select.cuh's radix select (a few histogram
// passes, not a sort of the block). Only the k picks are then ordered: each
// takes a slot by a shared atomic and writes its 64-bit key (|v| bits <<
// 32) | (0xFFFF - local) << 16 | slot there (the low word orders ties by
// index as today's 0xFFFFFFFF - local does; the slot only finds the value
// again), and the keys are sorted by one warp's shuffles for k <= 32, or in
// shared memory over pow2(k) keys. The ragged last block's positions past
// d are zeros that compete as the JAX compressor's zero padding does
// (their indices are >= d).
#include "topk_select.cuh"

namespace {

using topk::kFull;
using topk::kPer;
using topk::kThreads;

// A pick's sort key: descending keys are lax.top_k's order (|v| bits, then
// the lower block-local index first); the low 16 bits carry its slot.
__device__ __forceinline__ unsigned long long pick_key(float v, int local,
                                                       unsigned slot) {
  return (static_cast<unsigned long long>(topk::mag_bits(v)) << 32) |
         ((0xFFFFu - static_cast<unsigned>(local)) << 16) | slot;
}
__device__ __forceinline__ unsigned key_slot(unsigned long long key) {
  return static_cast<unsigned>(key) & 0xFFFFu;
}
__device__ __forceinline__ int key_local(unsigned long long key) {
  return static_cast<int>(0xFFFFu - (static_cast<unsigned>(key) >> 16));
}

// Descending bitonic sort of one key per lane across a warp.
__device__ __forceinline__ unsigned long long warp_sort_desc(
    unsigned long long key) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int size = 2; size <= 32; size <<= 1) {
#pragma unroll
    for (int stride = size >> 1; stride > 0; stride >>= 1) {
      const unsigned long long o = __shfl_xor_sync(kFull, key, stride);
      const bool take_max = ((lane & size) == 0) == ((lane & stride) == 0);
      key = take_max ? (o > key ? o : key) : (o < key ? o : key);
    }
  }
  return key;
}

// Descending bitonic sort of keys[0..width) in shared memory (width a power
// of two) by the whole CTA; starts and ends with a barrier.
__device__ __forceinline__ void block_sort_desc(unsigned long long* keys,
                                                int width) {
  const int tid = threadIdx.x;
  __syncthreads();
  for (int size = 2; size <= width; size <<= 1) {
    for (int stride = size >> 1; stride > 0; stride >>= 1) {
      for (int i = tid; i < width; i += kThreads) {
        const int j = i ^ stride;
        if (j > i) {
          const unsigned long long a = keys[i];
          const unsigned long long e = keys[j];
          if (((i & size) == 0) ? (a < e) : (a > e)) {
            keys[i] = e;
            keys[j] = a;
          }
        }
      }
      __syncthreads();
    }
  }
}

// smallest power of two >= n
__host__ __device__ inline int pow2_at_least(int n) {
  int p = 1;
  while (p < n) p <<= 1;
  return p;
}

__global__ void __launch_bounds__(kThreads, topk::kMinBlocks)
topk_ef_sparse_kernel(const float* __restrict__ x, float* __restrict__ err,
                      const long long* __restrict__ rows,
                      float* __restrict__ vals, int* __restrict__ idx,
                      long long d, int block, int nb, int k) {
  __shared__ topk::SelectSmem s;
  __shared__ unsigned taken;   // pick slots handed out
  // picks: pow2(max(k, 32)) keys, then k values
  extern __shared__ unsigned long long keys[];

  const int b = blockIdx.x;
  const int c = blockIdx.y;
  const int tid = threadIdx.x;
  const long long start = static_cast<long long>(b) * block + tid;
  const float* xr = x + static_cast<long long>(c) * d;
  float* er = err + rows[c] * d;
  const unsigned in = topk::slots_in(block);
  unsigned live = 0;   // in the block and < d: loaded and stored
  if (tid == 0) taken = 0;   // ordered by find_threshold's first barrier
  float v[kPer];
#pragma unroll
  for (int j = 0; j < kPer; ++j) {
    const long long g = start + j * kThreads;
    if (((in >> j) & 1u) && g < d) live |= 1u << j;
    v[j] = ((live >> j) & 1u) ? __fadd_rn(xr[g], er[g]) : 0.0f;
  }

  const topk::Threshold t = topk::find_threshold(v, in, k, s);
  const unsigned keep = topk::keep_mask(v, in, t, s);

  // the k picks into any of k slots; the key orders them
  const int width = pow2_at_least(k < 32 ? 32 : k);
  float* pval = reinterpret_cast<float*>(keys + width);
#pragma unroll
  for (int j = 0; j < kPer; ++j) {
    if ((keep >> j) & 1u) {
      const unsigned slot = atomicAdd(&taken, 1u);
      keys[slot] = pick_key(v[j], j * kThreads + tid, slot);
      pval[slot] = v[j];
    }
    // EF residual from registers: the picks zeroed
    if ((live >> j) & 1u)
      er[start + j * kThreads] = ((keep >> j) & 1u) ? 0.0f : v[j];
  }

  const long long o0 = (static_cast<long long>(c) * nb + b) * k;
  if (k <= 32) {
    __syncthreads();
    if (tid < 32) {
      const unsigned long long key =
          warp_sort_desc(tid < k ? keys[tid] : 0ull);
      if (tid < k) {
        vals[o0 + tid] = pval[key_slot(key)];
        idx[o0 + tid] = b * block + key_local(key);
      }
    }
    return;
  }
  for (int i = k + tid; i < width; i += kThreads) keys[i] = 0ull;
  block_sort_desc(keys, width);
  for (int i = tid; i < k; i += kThreads) {
    vals[o0 + i] = pval[key_slot(keys[i])];
    idx[o0 + i] = b * block + key_local(keys[i]);
  }
}

}  // namespace

extern "C" int topk_ef_sparse_launch(const float* x, float* err,
                                     const long long* rows, float* vals,
                                     int* idx, long long d, int block, int nb,
                                     int k, int c, void* stream) {
  if (block <= 0 || block > topk::kMaxBlock || k <= 0 || k > block ||
      c <= 0 || nb <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const int width = pow2_at_least(k < 32 ? 32 : k);
  const size_t smem = width * sizeof(unsigned long long) + k * sizeof(float);
  const dim3 grid(static_cast<unsigned int>(nb), static_cast<unsigned int>(c));
  topk_ef_sparse_kernel<<<grid, kThreads, smem,
                          static_cast<cudaStream_t>(stream)>>>(
      x, err, rows, vals, idx, d, block, nb, k);
  return static_cast<int>(cudaGetLastError());
}
