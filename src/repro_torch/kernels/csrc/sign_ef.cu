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
// (c, d). The scale is a global reduction per client, so three launches:
//   1. one CTA per (2048-element block, client) sums |tot| of its block by a
//      fixed shared-memory halving tree (the ragged tail zero-filled) into
//      partials (c, nb);
//   2. one CTA per client sums its nb partials by a halving tree over a
//      power-of-two width P (zero-padded) and divides by the TRUE d with a
//      correctly rounded division — no padding of the vector, and so none of
//      the rescale the JAX wrapper (kernels/ops.py) applies to a padded one.
//      Past kChunk partials (d > 2^24) the tree runs over chunks of kChunk
//      (the last zero-padded) and the chunk sums are added in chunk order;
//   3. an elementwise pass writes hat and err.
// No float atomics: every sum has one fixed order, which the plain twin
// (kernels/ref.py::sign_scale) repeats with tensor slices, so kernel and
// twin agree bitwise. Against jnp.mean (whose order XLA does not specify)
// the scale is a few ulp off. A NaN in tot makes its client's scale NaN.
//
// Bound on this card: bytes — read x and err, write hat and err (16 bytes
// per element). Passes 1 and 3 both read x and err, so 24 bytes move.
#include <cuda_runtime.h>

namespace {

constexpr int kBlock = 2048;   // elements per pass-1 partial
constexpr int kThreads = 1024;
constexpr int kChunk = 8192;   // widest pass-2 tree (32 KB shared)

__global__ void __launch_bounds__(kThreads)
l1_partials_kernel(const float* __restrict__ x, const float* __restrict__ err,
                   const long long* __restrict__ rows,
                   float* __restrict__ partials, long long d, int nb) {
  __shared__ float s[kBlock];
  const int b = blockIdx.x;
  const int c = blockIdx.y;
  const int tid = threadIdx.x;
  const long long start = static_cast<long long>(b) * kBlock;
  const float* xr = x + static_cast<long long>(c) * d;
  const float* er = err + rows[c] * d;
  for (int i = tid; i < kBlock; i += blockDim.x) {
    const long long g = start + i;
    s[i] = (g < d) ? fabsf(__fadd_rn(xr[g], er[g])) : 0.0f;
  }
  __syncthreads();
  for (int h = kBlock / 2; h > 0; h >>= 1) {
    for (int i = tid; i < h; i += blockDim.x)
      s[i] = __fadd_rn(s[i], s[i + h]);
    __syncthreads();
  }
  if (tid == 0) partials[static_cast<long long>(c) * nb + b] = s[0];
}

__global__ void __launch_bounds__(kThreads)
scale_kernel(const float* __restrict__ partials, float* __restrict__ scale,
             long long d, int nb, int width) {
  __shared__ float s[kChunk];
  const int c = blockIdx.x;
  const int tid = threadIdx.x;
  const float* p = partials + static_cast<long long>(c) * nb;
  float total = 0.0f;  // thread 0's running sum over the chunks
  for (int base = 0; base < nb; base += width) {
    for (int i = tid; i < width; i += blockDim.x)
      s[i] = (base + i < nb) ? p[base + i] : 0.0f;
    __syncthreads();
    for (int h = width / 2; h > 0; h >>= 1) {
      for (int i = tid; i < h; i += blockDim.x)
        s[i] = __fadd_rn(s[i], s[i + h]);
      __syncthreads();
    }
    if (tid == 0) total = (base == 0) ? s[0] : __fadd_rn(total, s[0]);
    __syncthreads();  // s[0] is read before the next chunk overwrites it
  }
  if (tid == 0) scale[c] = __fdiv_rn(total, static_cast<float>(d));
}

__global__ void __launch_bounds__(256)
apply_kernel(const float* __restrict__ x, float* __restrict__ err,
             const long long* __restrict__ rows,
             const float* __restrict__ scale, float* __restrict__ hat,
             long long d) {
  const int c = blockIdx.y;
  const float s = scale[c];
  const float* xr = x + static_cast<long long>(c) * d;
  float* hr = hat + static_cast<long long>(c) * d;
  float* er = err + rows[c] * d;
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long g = static_cast<long long>(blockIdx.x) * blockDim.x +
                     threadIdx.x;
       g < d; g += stride) {
    const float t = __fadd_rn(xr[g], er[g]);
    const float h = (t >= 0.0f) ? s : -s;
    hr[g] = h;
    er[g] = __fsub_rn(t, h);
  }
}

}  // namespace

extern "C" int sign_ef_launch(const float* x, float* err,
                              const long long* rows, float* hat,
                              float* partials, float* scale, long long d,
                              int nb, int width, int c, void* stream) {
  int want = 1;  // nb rounded up to a power of two, at most kChunk
  while (want < nb && want < kChunk) want <<= 1;
  if (d <= 0 || c <= 0 || nb != (d + kBlock - 1) / kBlock || width != want)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  l1_partials_kernel<<<dim3(static_cast<unsigned int>(nb),
                            static_cast<unsigned int>(c)),
                       kThreads, 0, st>>>(x, err, rows, partials, d, nb);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  scale_kernel<<<static_cast<unsigned int>(c), kThreads, 0, st>>>(
      partials, scale, d, nb, width);
  e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  long long blocks = (d + 255) / 256;
  const long long cap = (132LL * 16 + c - 1) / c;  // ~16 CTAs per SM in all
  if (blocks > cap) blocks = cap;
  apply_kernel<<<dim3(static_cast<unsigned int>(blocks),
                      static_cast<unsigned int>(c)),
                 256, 0, st>>>(x, err, rows, scale, hat, d);
  return static_cast<int>(cudaGetLastError());
}
