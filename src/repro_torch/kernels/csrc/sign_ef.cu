// Scaled sign with fused error feedback for Hopper (sm_90a).
//
// Replaces the Pallas kernels src/repro/kernels/sign_ef.py::sign_ef
// (_l1_partial_kernel, _sign_ef_kernel): per client, tot = x + err,
// scale = sum|tot| / d, hat = scale * (tot >= 0 ? 1 : -1) (sign(0) and
// sign(-0.0) are +1, as make_sign and the 1-bit wire define it), and
// new_err = tot - hat.
//
// Layout: as topk_ef.cu. x is (c, d) deltas, err the resident (m, d) EF
// buffer, rows (c,) distinct client rows of err, updated IN PLACE; hat is
// (c, d). The work is the flattened list of the c * nb blocks of kBlock
// values (block r is block r % nb of client r / nb, the ragged tail
// zero-filled).
//
// Bound on this card: bytes — read x and err once, write hat and err once
// (16 bytes per element). The scale is a reduction over a whole client, so
// a kernel that reads once must keep the totals on chip while it is
// formed. One cooperative launch does that:
//   1. each CTA (all resident: the grid is the occupancy × the SM count,
//      queried on the device) takes a contiguous range of blocks. A warp
//      owns one block at a time: value j·32 + lane sits in its lane's
//      register j (64 a lane), so every warp access is 128 contiguous
//      bytes at any row alignment, and 128 loads of each warp are in
//      flight at once. It forms tot (__fadd_rn), keeps it in shared
//      memory (up to `hold` blocks a CTA; 27 at the main path's shapes,
//      221 KB of the opt-in 227 KB), and sums |tot| in ref.tree_sum's
//      order with no barrier: the levels 1024 … 32 pair registers of one
//      lane, 16 … 1 are __shfl_down_sync. The partial goes to
//      partials[r]. A block past `hold` is summed and dropped, and read
//      again in step 3 (more blocks than the card holds: every size stays
//      correct);
//   2. per-client arrival, not a grid barrier: the CTA publishes its
//      partials (__threadfence, then one atomicAdd of its block count on
//      each of its clients' counts, a thread a client). The CTA whose add
//      completes a client's nb resets that count to 0 and bumps the
//      client's epoch (a release store); every CTA of the client waits,
//      with acquire loads, for the epoch to move from the value it read
//      at its start, then forms the scale from the nb partials in
//      ref.sign_scale's order (a 256-wide tree per chunk of kChunk
//      partials, the chunk sums added in order, a correctly rounded
//      division by the true d). Every CTA of a client computes the same
//      bits. The counts and epochs live in a buffer the wrapper owns per
//      (device, stream), zeroed once when it is made: no call zeroes them,
//      and nothing else is launched;
//   3. hat and err are written from the held totals (128-byte warp
//      stores), err as tot - hat (__fsub_rn).
// No float atomics: every sum has one fixed order, which the plain twin
// (kernels/ref.py::sign_scale) repeats with tensor slices, so kernel and
// twin agree bitwise. Against jnp.mean (whose order XLA does not specify)
// the scale is a few ulp off. A NaN in tot makes its client's scale NaN.
#include <cuda_runtime.h>

namespace {

constexpr int kBlock = 2048;                // values per partial
// a block each at a time; 9 warps take the main path's 26–27 blocks a CTA
// in 3 rounds, where 8 take 4 (scripts/sign_floor.py times 8)
constexpr int kWarps = 9;
constexpr int kThreads = kWarps * 32;
constexpr int kPer = kBlock / 32;           // values a lane holds per block
constexpr int kChunk = 8192;                // widest scale tree
constexpr int kTree = 256;                  // threads of the scale tree
constexpr int kChunkPer = kChunk / kTree;
static_assert(kThreads >= kTree, "the scale tree needs kTree threads");
constexpr unsigned kFull = 0xFFFFFFFFu;
constexpr unsigned long long kWaitLimitNs = 10000000000ull;   // 10 s

// tot of one block, value j·32 + lane in t[j]; past d it is +0.0
__device__ __forceinline__ void load_tot(const float* __restrict__ xr,
                                         const float* er, long long start,
                                         long long d, int lane,
                                         float (&t)[kPer]) {
  float a[kPer], b[kPer];
  if (start + kBlock <= d) {
#pragma unroll
    for (int j = 0; j < kPer; ++j) {
      a[j] = __ldcs(xr + start + j * 32 + lane);
      b[j] = __ldcs(er + start + j * 32 + lane);
    }
  } else {
#pragma unroll
    for (int j = 0; j < kPer; ++j) {
      const long long g = start + j * 32 + lane;
      a[j] = g < d ? __ldcs(xr + g) : 0.0f;
      b[j] = g < d ? __ldcs(er + g) : 0.0f;
    }
  }
#pragma unroll
  for (int j = 0; j < kPer; ++j) t[j] = __fadd_rn(a[j], b[j]);
}

// v[j] += v[j + H] for j < H, then for H/2, …, 1: the top levels of a
// halving tree over 2H values held in registers (every index a constant,
// so nothing goes to local memory)
template <int H>
__device__ __forceinline__ void halve(float* v) {
#pragma unroll
  for (int j = 0; j < H; ++j) v[j] = __fadd_rn(v[j], v[j + H]);
  if constexpr (H > 1) halve<H / 2>(v);
}

// the last five levels, across the lanes of a warp (lane 0's result)
__device__ __forceinline__ float warp_halve(float s) {
#pragma unroll
  for (int h = 16; h > 0; h >>= 1)
    s = __fadd_rn(s, __shfl_down_sync(kFull, s, h));
  return s;
}

// sum of |t| over the block (lane 0's result) by ref.tree_sum's halving
// tree: t[j] + t[j + h] is value i + 32h; the last five levels cross lanes
__device__ __forceinline__ float block_l1(float (&t)[kPer]) {
#pragma unroll
  for (int j = 0; j < kPer; ++j) t[j] = fabsf(t[j]);
  halve<kPer / 2>(t);
  return warp_halve(t[0]);
}

__device__ __forceinline__ unsigned long long globaltimer_ns() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}

__device__ __forceinline__ unsigned ld_acquire(const unsigned* p) {
  unsigned v;
  asm volatile("ld.acquire.gpu.global.u32 %0, [%1];"
               : "=r"(v) : "l"(p) : "memory");
  return v;
}

__device__ __forceinline__ void st_release(unsigned* p, unsigned v) {
  asm volatile("st.release.gpu.global.u32 [%0], %1;"
               :: "l"(p), "r"(v) : "memory");
}

// What a CTA keeps for each client its range touches, in shared memory.
struct Client {
  unsigned epoch;   // the client's epoch when the CTA started
  float scale;
};

// ‖·‖₁ of one client's nb partials (thread 0's result) in
// ref.sign_scale's order: chunks of kChunk (zero-padded, which adds +0.0
// to sums of |·| and so leaves the tree over a power of two below it
// unchanged), value j·kTree + tid of a chunk in v[j]; levels 4096 … 256 in
// registers, 128 … 32 across warps through `red`, 16 … 1 by shuffles.
// Partials come from L2 (other CTAs wrote them).
__device__ __forceinline__ float client_l1(const float* p, int nb,
                                           float* red) {
  const int tid = threadIdx.x;
  float total = 0.0f;
  for (int base = 0; base < nb; base += kChunk) {
    if (tid < kTree) {
      float v[kChunkPer];
#pragma unroll
      for (int j = 0; j < kChunkPer; ++j) {
        const int i = base + j * kTree + tid;
        v[j] = i < nb ? __ldcg(p + i) : 0.0f;
      }
      halve<kChunkPer / 2>(v);
      red[tid] = v[0];
    }
    __syncthreads();
    if (tid < 32) {
      float u[kTree / 32];
#pragma unroll
      for (int w = 0; w < kTree / 32; ++w) u[w] = red[tid + 32 * w];
      halve<kTree / 64>(u);
      const float s = warp_halve(u[0]);
      total = base == 0 ? s : __fadd_rn(total, s);
    }
    __syncthreads();   // red is read before the next chunk writes it
  }
  return total;
}

// step 2 for clients c_lo … c_hi of this CTA's range [lo, hi): publish,
// wait, and put each client's scale in cl[client - c_lo]. arrivals[2ci]
// counts the blocks of client ci whose partials are published (0 between
// calls: the last CTA to arrive resets it), arrivals[2ci + 1] is the
// client's epoch, which that CTA then bumps. A thread a client, so the
// arrivals of a CTA's clients are in flight together.
__device__ __forceinline__ void form_scales(
    const float* partials, unsigned* arrivals, long long lo, long long hi,
    int nb, long long d, int c_lo, int c_hi, float* red, Client* cl) {
  __syncthreads();   // every partial of the CTA is written
  for (int ci = c_lo + threadIdx.x; ci <= c_hi; ci += kThreads) {
    const long long a = lo > static_cast<long long>(ci) * nb
                            ? lo : static_cast<long long>(ci) * nb;
    const long long b = hi < static_cast<long long>(ci + 1) * nb
                            ? hi : static_cast<long long>(ci + 1) * nb;
    const unsigned n = static_cast<unsigned>(b - a);
    __threadfence();   // the CTA's partials before its arrival
    if (atomicAdd(arrivals + 2 * ci, n) + n == static_cast<unsigned>(nb)) {
      __threadfence();   // every CTA's partials before the epoch
      arrivals[2 * ci] = 0;
      st_release(arrivals + 2 * ci + 1, cl[ci - c_lo].epoch + 1);
    }
  }
  const unsigned long long t0 = globaltimer_ns();
  for (int ci = c_lo + threadIdx.x; ci <= c_hi; ci += kThreads)
    while (ld_acquire(arrivals + 2 * ci + 1) == cl[ci - c_lo].epoch) {
      // every CTA is resident and publishes before it waits, so a wait
      // ends within one range's reads; an epoch that never moves (a
      // fault) ends the kernel with an error instead of hanging the card
      if (globaltimer_ns() - t0 > kWaitLimitNs) __trap();
    }
  __syncthreads();
  for (int ci = c_lo; ci <= c_hi; ++ci) {
    const float s = client_l1(partials + static_cast<long long>(ci) * nb, nb,
                              red);
    if (threadIdx.x == 0)
      cl[ci - c_lo].scale = __fdiv_rn(s, static_cast<float>(d));
  }
  __syncthreads();
}

__global__ void __launch_bounds__(kThreads, 1)
sign_ef_kernel(const float* __restrict__ x, float* err,
               const long long* __restrict__ rows, float* __restrict__ hat,
               float* partials, unsigned* arrivals, long long d, int nb,
               int c, int hold) {
  extern __shared__ float smem[];
  float* held = smem;                                       // hold × kBlock
  float* red = smem + static_cast<long long>(hold) * kBlock;  // kTree
  Client* cl = reinterpret_cast<Client*>(red + kTree);
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const long long total = static_cast<long long>(c) * nb;
  const long long per = total / gridDim.x, rem = total % gridDim.x;
  const long long cta = blockIdx.x;
  const long long lo = cta * per + (cta < rem ? cta : rem);
  const long long hi = lo + per + (cta < rem ? 1 : 0);
  if (lo >= hi) return;
  const int c_lo = static_cast<int>(lo / nb);
  const int c_hi = static_cast<int>((hi - 1) / nb);
  // no epoch moves before this CTA arrives, so these are the call's
  for (int ci = c_lo + threadIdx.x; ci <= c_hi; ci += kThreads)
    cl[ci - c_lo].epoch =
        *reinterpret_cast<volatile unsigned*>(arrivals + 2 * ci + 1);

  // 1. read x and err once, hold the totals, write the partials
  for (long long r = lo + warp; r < hi; r += kWarps) {
    const int ci = static_cast<int>(r / nb);
    const long long start = (r - static_cast<long long>(ci) * nb) * kBlock;
    float t[kPer];
    load_tot(x + static_cast<long long>(ci) * d, err + rows[ci] * d, start,
             d, lane, t);
    if (r - lo < hold) {
      float* s = held + (r - lo) * kBlock;
#pragma unroll
      for (int j = 0; j < kPer; ++j) s[j * 32 + lane] = t[j];
    }
    const float part = block_l1(t);
    if (lane == 0) partials[r] = part;
  }

  // 2. the scales of this CTA's clients
  form_scales(partials, arrivals, lo, hi, nb, d, c_lo, c_hi, red, cl);

  // 3. write hat and err once
  for (long long r = lo + warp; r < hi; r += kWarps) {
    const int ci = static_cast<int>(r / nb);
    const long long start = (r - static_cast<long long>(ci) * nb) * kBlock;
    float* er = err + rows[ci] * d;
    float* hr = hat + static_cast<long long>(ci) * d;
    float t[kPer];
    if (r - lo < hold) {
      const float* s = held + (r - lo) * kBlock;
#pragma unroll
      for (int j = 0; j < kPer; ++j) t[j] = s[j * 32 + lane];
    } else {
      load_tot(x + static_cast<long long>(ci) * d, er, start, d, lane, t);
    }
    const float s = cl[ci - c_lo].scale;
#pragma unroll
    for (int j = 0; j < kPer; ++j) {
      const long long g = start + j * 32 + lane;
      if (g < d) {
        const float h = t[j] >= 0.0f ? s : -s;
        hr[g] = h;
        er[g] = __fsub_rn(t[j], h);
      }
    }
  }
}

int g_smem_set[64];   // per device: the dynamic shared memory allowed so far

}  // namespace

// arrivals: (>= 2c,) words of the wrapper's buffer for this device and
// stream, zero when it was made and left as each call found them
extern "C" int sign_ef_launch(const float* x, float* err,
                              const long long* rows, float* hat,
                              float* partials, unsigned* arrivals,
                              long long d, int nb, int c, void* stream) {
  if (d <= 0 || c <= 0 || nb != (d + kBlock - 1) / kBlock)
    return static_cast<int>(cudaErrorInvalidValue);
  int dev = 0, sms = 0, optin = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&optin,
                               cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (e != cudaSuccess) return static_cast<int>(e);
  if (dev >= 64) return static_cast<int>(cudaErrorInvalidDevice);
  // Blocks a CTA takes if one CTA sits on each SM, the clients such a range
  // can touch (a shorter range touches no more), and the blocks it holds.
  const long long total = static_cast<long long>(c) * nb;
  const long long widest = (total + sms - 1) / sms;
  long long span = (widest - 1) / nb + 2;
  if (span > c) span = c;
  const long long fixed = kTree * 4 + span * sizeof(Client);
  const long long per_block = kBlock * 4;
  long long hold = (optin - fixed) / per_block;
  if (hold < 1) return static_cast<int>(cudaErrorInvalidConfiguration);
  if (hold > widest) hold = widest;
  size_t smem = static_cast<size_t>(hold * per_block + fixed);
  if (g_smem_set[dev] < optin) {
    e = cudaFuncSetAttribute(sign_ef_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             optin);
    if (e != cudaSuccess) return static_cast<int>(e);
    g_smem_set[dev] = optin;
  }
  int occ = 0;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&occ, sign_ef_kernel,
                                                    kThreads, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  if (occ < 1) return static_cast<int>(cudaErrorInvalidConfiguration);
  long long grid = static_cast<long long>(occ) * sms;
  if (grid > total) grid = total;
  // the grid's ranges are no longer than `widest`: hold no more than that
  const long long len = (total + grid - 1) / grid;
  if (hold > len) {
    hold = len;
    smem = static_cast<size_t>(hold * per_block + fixed);
  }
  int hold_i = static_cast<int>(hold);
  void* args[] = {&x, &err, &rows, &hat, &partials, &arrivals,
                  &d, &nb,  &c,    &hold_i};
  return static_cast<int>(cudaLaunchCooperativeKernel(
      reinterpret_cast<void*>(sign_ef_kernel),
      dim3(static_cast<unsigned>(grid)), dim3(kThreads), args, smem,
      static_cast<cudaStream_t>(stream)));
}
