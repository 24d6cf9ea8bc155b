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
// (c, d). One CTA of 256 threads per (block, client), so the gather and
// scatter of the (c, d) EF rows that the JAX FedSim does around the call are
// never materialized.
//
// Bound on this card: bytes. Per element it reads x and err and writes hat
// and err (16 bytes). So each value is read once into a register and hat
// and err are written from there, by warp accesses of 128 contiguous bytes;
// the selection is topk_select.cuh's radix select over the values in
// registers, and the dense form needs only the membership, so nothing is
// sorted. The ragged last block's positions past d compete as zeros and
// are never written.
#include "topk_select.cuh"

namespace {

using topk::kPer;
using topk::kThreads;

__global__ void __launch_bounds__(kThreads, topk::kMinBlocks)
topk_ef_kernel(const float* __restrict__ x, float* __restrict__ err,
               const long long* __restrict__ rows, float* __restrict__ hat,
               long long d, int block, int k) {
  __shared__ topk::SelectSmem s;

  const int b = blockIdx.x;
  const int c = blockIdx.y;
  const int tid = threadIdx.x;
  const long long start = static_cast<long long>(b) * block + tid;
  const float* xr = x + static_cast<long long>(c) * d;
  float* hr = hat + static_cast<long long>(c) * d;
  float* er = err + rows[c] * d;
  const unsigned in = topk::slots_in(block);
  unsigned live = 0;   // in the block and < d: loaded and stored
  float v[kPer];
#pragma unroll
  for (int j = 0; j < kPer; ++j) {
    const long long g = start + j * kThreads;
    if (((in >> j) & 1u) && g < d) live |= 1u << j;
    v[j] = ((live >> j) & 1u) ? __fadd_rn(xr[g], er[g]) : 0.0f;
  }

  const topk::Threshold t = topk::find_threshold(v, in, k, s);
  const unsigned keep = topk::keep_mask(v, in, t, s);

#pragma unroll
  for (int j = 0; j < kPer; ++j) {
    if ((live >> j) & 1u) {
      const long long g = start + j * kThreads;
      const float h = ((keep >> j) & 1u) ? v[j] : 0.0f;
      hr[g] = h;
      er[g] = __fsub_rn(v[j], h);
    }
  }
}

}  // namespace

extern "C" int topk_ef_launch(const float* x, float* err,
                              const long long* rows, float* hat, long long d,
                              int block, int nb, int k, int c, void* stream) {
  if (block <= 0 || block > topk::kMaxBlock || k <= 0 || k > block ||
      c <= 0 || nb <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(static_cast<unsigned int>(nb), static_cast<unsigned int>(c));
  topk_ef_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      x, err, rows, hat, d, block, k);
  return static_cast<int>(cudaGetLastError());
}
