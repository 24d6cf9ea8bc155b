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
// kernel updates those rows IN PLACE (each CTA reads its block into shared
// memory before it writes it back, and rows are distinct). vals/idx are
// (c, nb, k). One CTA per (block, client).
//
// Selection: topk_select.cuh (64-bit |v|/index keys, bitonic sort or a max
// reduction at k == 1). The ragged last block is zero-filled in shared
// memory (never in device memory): padded positions compete as zeros with
// indices >= d, exactly as the JAX compressor's zero-padded blocks do.
//
// Bound on this card: bytes. Per element it reads x and err and writes err
// (12 bytes), plus 8 bytes per pick; the sort is O(block log^2 block)
// shared-memory work per CTA, which is what keeps it off the bandwidth
// roof. Making it fast (radix select, fewer barriers) is later work.
#include "topk_select.cuh"

namespace {

using topk::key_index;
using topk::kMaxBlock;
using topk::kThreads;

__global__ void __launch_bounds__(kThreads)
topk_ef_sparse_kernel(const float* __restrict__ x, float* __restrict__ err,
                      const long long* __restrict__ rows,
                      float* __restrict__ vals, int* __restrict__ idx,
                      long long d, int block, int nb, int k, int pow2) {
  __shared__ float tot[kMaxBlock];
  __shared__ unsigned long long keys[kMaxBlock];
  __shared__ unsigned long long warp_best[kThreads / 32];

  const int b = blockIdx.x;
  const int c = blockIdx.y;
  const int tid = threadIdx.x;
  const long long start = static_cast<long long>(b) * block;
  const float* xr = x + static_cast<long long>(c) * d;
  float* er = err + rows[c] * d;

  for (int i = tid; i < block; i += blockDim.x) {
    const long long g = start + i;
    tot[i] = (g < d) ? __fadd_rn(xr[g], er[g]) : 0.0f;
  }
  __syncthreads();
  topk::select_block(tot, keys, warp_best, block, k, pow2);

  // emit in selection order (k may exceed the CTA's threads: strided);
  // every read of tot finishes before any pick is zeroed
  const long long o0 = (static_cast<long long>(c) * nb + b) * k;
  for (int t = tid; t < k; t += blockDim.x) {
    const int li = key_index(keys[t]);
    vals[o0 + t] = tot[li];
    idx[o0 + t] = li + b * block;
  }
  __syncthreads();
  for (int t = tid; t < k; t += blockDim.x) tot[key_index(keys[t])] = 0.0f;
  __syncthreads();
  for (int i = tid; i < block; i += blockDim.x) {
    const long long g = start + i;
    if (g < d) er[g] = tot[i];
  }
}

}  // namespace

extern "C" int topk_ef_sparse_launch(const float* x, float* err,
                                     const long long* rows, float* vals,
                                     int* idx, long long d, int block, int nb,
                                     int k, int c, void* stream) {
  if (block <= 0 || block > kMaxBlock || k <= 0 || k > block || c <= 0 ||
      nb <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(static_cast<unsigned int>(nb), static_cast<unsigned int>(c));
  topk_ef_sparse_kernel<<<grid, kThreads, 0,
                          static_cast<cudaStream_t>(stream)>>>(
      x, err, rows, vals, idx, d, block, nb, k, topk::sort_width(block));
  return static_cast<int>(cudaGetLastError());
}
