// Blockwise exact top-k with fused error feedback, dense form, for Hopper
// (sm_90a).
//
// Replaces the Pallas kernel src/repro/kernels/topk_ef.py::topk_ef
// (_topk_ef_kernel): per selection block of `block` (<= 2048) fp32 values,
// tot = x + err; keep EXACTLY k entries by |tot| in lax.top_k order; write
// the dense hat (tot at the picks, 0 elsewhere) and new_err = tot - hat
// (exactly 0 at the picks, tot elsewhere; NaN - NaN stays NaN as in JAX).
//
// Layout: as topk_ef_sparse.cu. x is (c, d) deltas, err the resident (m, d)
// EF buffer, rows (c,) distinct client rows of err, updated IN PLACE; hat is
// (c, d). One CTA per (block, client), so the gather and scatter of the
// (c, d) EF rows that the JAX FedSim does around the call are never
// materialized. The selection is topk_select.cuh's, the same as
// topk_ef_sparse's; a shared-memory flag marks the picks. The ragged last
// block is zero-filled in shared memory and only positions < d are written.
//
// Bound on this card: bytes. Per element it reads x and err and writes hat
// and err (16 bytes); the per-CTA sort is the same shared-memory work as
// topk_ef_sparse's and keeps it off the bandwidth roof.
#include "topk_select.cuh"

namespace {

using topk::key_index;
using topk::kMaxBlock;
using topk::kThreads;

__global__ void __launch_bounds__(kThreads)
topk_ef_kernel(const float* __restrict__ x, float* __restrict__ err,
               const long long* __restrict__ rows, float* __restrict__ hat,
               long long d, int block, int k, int pow2) {
  __shared__ float tot[kMaxBlock];
  __shared__ unsigned long long keys[kMaxBlock];
  __shared__ unsigned long long warp_best[kThreads / 32];
  __shared__ unsigned char keep[kMaxBlock];

  const int b = blockIdx.x;
  const int c = blockIdx.y;
  const int tid = threadIdx.x;
  const long long start = static_cast<long long>(b) * block;
  const float* xr = x + static_cast<long long>(c) * d;
  float* hr = hat + static_cast<long long>(c) * d;
  float* er = err + rows[c] * d;

  for (int i = tid; i < block; i += blockDim.x) {
    const long long g = start + i;
    tot[i] = (g < d) ? __fadd_rn(xr[g], er[g]) : 0.0f;
    keep[i] = 0;
  }
  __syncthreads();
  topk::select_block(tot, keys, warp_best, block, k, pow2);
  for (int t = tid; t < k; t += blockDim.x) keep[key_index(keys[t])] = 1;
  __syncthreads();
  for (int i = tid; i < block; i += blockDim.x) {
    const long long g = start + i;
    if (g < d) {
      const float t = tot[i];
      const float h = keep[i] ? t : 0.0f;
      hr[g] = h;
      er[g] = __fsub_rn(t, h);
    }
  }
}

}  // namespace

extern "C" int topk_ef_launch(const float* x, float* err,
                              const long long* rows, float* hat, long long d,
                              int block, int nb, int k, int c, void* stream) {
  if (block <= 0 || block > kMaxBlock || k <= 0 || k > block || c <= 0 ||
      nb <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(static_cast<unsigned int>(nb), static_cast<unsigned int>(c));
  topk_ef_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      x, err, rows, hat, d, block, k, topk::sort_width(block));
  return static_cast<int>(cudaGetLastError());
}
