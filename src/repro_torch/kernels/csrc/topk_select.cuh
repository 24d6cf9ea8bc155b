// Exact blockwise top-k membership by radix select in registers, shared by
// topk_ef_sparse.cu (compacted picks) and topk_ef.cu (dense hat).
//
// One CTA of kThreads threads owns one selection block of `block` (<= 2048)
// values. Value j (slot j < kPer) of thread t is the block's value
// j·kThreads + t, so every load and store of a warp covers 128 contiguous
// bytes whatever the row's alignment, and index order is slot-major, then
// thread order. The values stay in registers from load to store; shared
// memory holds only the digit histograms and the counts of a rank scan.
//
// Order: lax.top_k's on |v| — descending |v|, ties to the lowest index. |v|
// is compared as its 31-bit pattern (bits & 0x7FFFFFFF): non-negative fp32
// patterns order like the floats (+0.0 == -0.0, denormals below normals),
// +inf is 0x7F800000, and a NaN sits above +inf, NaNs ordered by their
// payload bits, as XLA's top_k orders them (on the card every NaN total is
// the canonical 0x7FFFFFFF, so they tie and go by index).
//
// Selection:
//   1. radix select of T, the k-th largest magnitude, over digits of 8, 8,
//      8 and 7 bits from the top; one shared histogram per digit, counted
//      by plain shared atomics (integer counts are exact in any order, so
//      the result is deterministic; warp-aggregating them with
//      __match_any_sync measured slower on H100, the exponent digit's
//      crowding included); warp 0 finds the bin holding the k-th value with
//      one warp scan over 8 bins a lane. The passes stop as soon as that
//      bin is taken whole (2 passes on most blocks of normal deltas);
//   2. a value is kept iff its magnitude is above T's prefix, or equal to it
//      and its rank among those ties in index order (index_ranks) is below
//      need = k - above. Exactly k values are kept.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace topk {

constexpr int kMaxBlock = 2048;
constexpr int kThreads = 256;
constexpr int kPer = kMaxBlock / kThreads;   // values per thread, at most
constexpr int kWarps = kThreads / 32;
// CTAs per SM the register budget is set for (48 registers a thread, no
// spills): while one CTA selects, the others' loads are in flight. 6 (40
// registers) spills and 4 keeps fewer loads in flight; both are slower
// (scripts/topk_floor.py times them)
constexpr int kMinBlocks = 5;
constexpr int kBins = 256;
constexpr int kPasses = 4;
constexpr unsigned kFull = 0xFFFFFFFFu;
static_assert(kPer * kWarps == 64, "index_ranks scans 2 counts a lane");

__device__ __forceinline__ unsigned mag_bits(float v) {
  return __float_as_uint(v) & 0x7FFFFFFFu;
}

// Shared memory of the selection.
struct __align__(16) SelectSmem {
  unsigned hist[kPasses][kBins];
  unsigned counts[kPer * kWarps];      // index_ranks
  unsigned found[3];                   // bin, count above it, count in it
};

// The selection's result, the same in every thread.
struct Threshold {
  unsigned prefix;   // T's top (31 - shift) bits
  int shift;         // a value's magnitude >> shift is compared to prefix
  int need;          // how many of the values equal to prefix are kept
  bool whole;        // every value equal to prefix is kept
};

// Bit j is set iff slot j of this thread lies in a block of `block` values.
__device__ __forceinline__ unsigned slots_in(int block) {
  unsigned in = 0;
#pragma unroll
  for (int j = 0; j < kPer; ++j)
    if (j * kThreads + static_cast<int>(threadIdx.x) < block) in |= 1u << j;
  return in;
}

// For each set bit j of `bits`, rank[j] = the number of set bits of the
// whole CTA at lower block indices. One barrier; once per kernel.
__device__ __forceinline__ void index_ranks(unsigned bits,
                                            unsigned (&rank)[kPer],
                                            SelectSmem& s) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const unsigned below = (1u << lane) - 1u;
#pragma unroll
  for (int j = 0; j < kPer; ++j) {
    const unsigned bal = __ballot_sync(kFull, (bits >> j) & 1u);
    rank[j] = __popc(bal & below);
    if (lane == 0) s.counts[j * kWarps + warp] = __popc(bal);
  }
  __syncthreads();
  // exclusive scan of the 64 (slot, warp) counts in index order, 2 a lane
  const unsigned a = s.counts[2 * lane];
  const unsigned pair = a + s.counts[2 * lane + 1];
  unsigned incl = pair;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const unsigned y = __shfl_up_sync(kFull, incl, off);
    if (lane >= off) incl += y;
  }
  const unsigned excl = incl - pair;
#pragma unroll
  for (int j = 0; j < kPer; ++j) {
    const int e = j * kWarps + warp;
    const unsigned base = __shfl_sync(kFull, excl, e >> 1) +
                          ((e & 1) ? __shfl_sync(kFull, a, e >> 1) : 0u);
    rank[j] += base;
  }
}

// Every thread of the CTA calls this with its values v and `in` =
// slots_in(block). Returns the threshold; `s.hist` need not be cleared.
__device__ __forceinline__ Threshold find_threshold(const float (&v)[kPer],
                                                    unsigned in, int k,
                                                    SelectSmem& s) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  for (int i = tid; i < kPasses * kBins; i += kThreads)
    (&s.hist[0][0])[i] = 0u;
  __syncthreads();

  unsigned prefix = 0;   // magnitude >> (shift + width) of the k-th value
  unsigned r = static_cast<unsigned>(k);   // its rank among those
  int shift = 31;
  bool whole = false;
#pragma unroll
  for (int p = 0; p < kPasses; ++p) {
    const int width = p < kPasses - 1 ? 8 : 7;
    const int sh = 23 - 8 * p < 0 ? 0 : 23 - 8 * p;   // 23, 15, 7, 0
    unsigned* hist = s.hist[p];
#pragma unroll
    for (int j = 0; j < kPer; ++j) {
      const unsigned m = mag_bits(v[j]);
      // shift == 31 on the first pass: every value matches prefix 0
      if (((in >> j) & 1u) && (m >> shift) == prefix)
        atomicAdd(&hist[(m >> sh) & ((1u << width) - 1u)], 1u);
    }
    __syncthreads();
    if (warp == 0) {
      // the bin b with (count above b) < r <= (count above b) + hist[b]:
      // lane l sums bins 8(31-l)..8(31-l)+7, the top bins in lane 0
      const uint4* h4 = reinterpret_cast<const uint4*>(hist) + 2 * (31 - lane);
      const uint4 lo = h4[0], hi = h4[1];
      const unsigned c8[8] = {lo.x, lo.y, lo.z, lo.w, hi.x, hi.y, hi.z, hi.w};
      unsigned sum = 0;
#pragma unroll
      for (int q = 0; q < 8; ++q) sum += c8[q];
      unsigned incl = sum;
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const unsigned y = __shfl_up_sync(kFull, incl, off);
        if (lane >= off) incl += y;
      }
      unsigned above = incl - sum;
      if (above < r && r <= incl) {
#pragma unroll
        for (int q = 7; q >= 0; --q) {
          if (above < r && r <= above + c8[q]) {
            s.found[0] = 8 * (31 - lane) + q;
            s.found[1] = above;
            s.found[2] = c8[q];
          }
          above += c8[q];
        }
      }
    }
    __syncthreads();
    prefix = (prefix << width) | s.found[0];
    r -= s.found[1];
    shift = sh;
    if (s.found[2] == r) {   // the k-th value's bin is taken whole
      whole = true;
      break;
    }
  }
  return Threshold{prefix, shift, static_cast<int>(r), whole};
}

// Bit j of the result is set iff slot j of this thread is kept. Every
// thread of the CTA calls it (it may scan, with index_ranks).
__device__ __forceinline__ unsigned keep_mask(const float (&v)[kPer],
                                              unsigned in,
                                              const Threshold& t,
                                              SelectSmem& s) {
  unsigned keep = 0, tie = 0;
#pragma unroll
  for (int j = 0; j < kPer; ++j) {
    const unsigned hi = mag_bits(v[j]) >> t.shift;
    if (hi > t.prefix) keep |= 1u << j;
    if (hi == t.prefix) tie |= 1u << j;
  }
  keep &= in;
  tie &= in;
  if (t.whole) return keep | tie;
  // ties at T: the first `need` of them in index order
  unsigned rank[kPer];
  index_ranks(tie, rank, s);
#pragma unroll
  for (int j = 0; j < kPer; ++j)
    if (((tie >> j) & 1u) && rank[j] < static_cast<unsigned>(t.need))
      keep |= 1u << j;
  return keep;
}

}  // namespace topk
