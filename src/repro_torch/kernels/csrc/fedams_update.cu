// Fused elementwise FedAMS server update for Hopper (sm_90a).
//
// Replaces the Pallas kernel src/repro/kernels/fedams_update.py::
// fedams_update (_fedams_kernel): one pass reading x, m, v, vhat and the
// aggregated delta, writing x, m, v, vhat.
//   option 1:  vhat = max(vhat, v, eps);  x += eta*m / sqrt(vhat)
//   option 2:  vhat = max(vhat, v);       x += eta*m / (sqrt(vhat) + eps)
// with m = b1*m + (1-b1)*d and v = b2*v + (1-b2)*(d*d), every multiply and
// add rounded separately (--fmad=false and the _rn intrinsics), a true
// division and a correctly rounded sqrt — the op order of
// repro.core.server_opt._server_update_f32. The host folds (1 - beta) in
// float64 and passes it as fp32, as JAX folds its Python constants.
//
// A grid-stride loop covers any N: no padding copies (the Pallas kernel pads
// a ragged N to a multiple of 4096).
//
// Bound on this card: bytes — 5 fp32 reads + 4 fp32 writes per element.
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

// maximum that returns a NaN operand, as jnp.maximum and torch.maximum do
// (fmaxf would drop it and keep a finite v-hat for a non-finite delta)
__device__ __forceinline__ float nan_max(float a, float b) {
  return a != a ? a : (b != b ? b : fmaxf(a, b));
}

__global__ void __launch_bounds__(kThreads)
fedams_update_kernel(const float* __restrict__ x, const float* __restrict__ m,
                     const float* __restrict__ v,
                     const float* __restrict__ vh,
                     const float* __restrict__ delta,
                     float* __restrict__ x_out, float* __restrict__ m_out,
                     float* __restrict__ v_out, float* __restrict__ vh_out,
                     long long n, float b1, float omb1, float b2, float omb2,
                     float eta, float eps, int option) {
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long i = static_cast<long long>(blockIdx.x) * blockDim.x +
                     threadIdx.x;
       i < n; i += stride) {
    const float dd = delta[i];
    const float m2 = __fadd_rn(__fmul_rn(b1, m[i]), __fmul_rn(omb1, dd));
    const float v2 =
        __fadd_rn(__fmul_rn(b2, v[i]), __fmul_rn(omb2, __fmul_rn(dd, dd)));
    float vh2, x2;
    if (option == 1) {
      vh2 = nan_max(nan_max(vh[i], v2), eps);
      x2 = __fadd_rn(x[i], __fdiv_rn(__fmul_rn(eta, m2), __fsqrt_rn(vh2)));
    } else {
      vh2 = nan_max(vh[i], v2);
      x2 = __fadd_rn(
          x[i], __fdiv_rn(__fmul_rn(eta, m2), __fadd_rn(__fsqrt_rn(vh2), eps)));
    }
    x_out[i] = x2;
    m_out[i] = m2;
    v_out[i] = v2;
    vh_out[i] = vh2;
  }
}

}  // namespace

extern "C" int fedams_update_launch(const float* x, const float* m,
                                    const float* v, const float* vh,
                                    const float* delta, float* x_out,
                                    float* m_out, float* v_out, float* vh_out,
                                    long long n, float b1, float omb1,
                                    float b2, float omb2, float eta, float eps,
                                    int option, void* stream) {
  if (n <= 0) return static_cast<int>(cudaErrorInvalidValue);
  long long blocks = (n + kThreads - 1) / kThreads;
  if (blocks > 132LL * 16) blocks = 132LL * 16;  // 16 CTAs per SM, then stride
  fedams_update_kernel<<<static_cast<unsigned int>(blocks), kThreads, 0,
                         static_cast<cudaStream_t>(stream)>>>(
      x, m, v, vh, delta, x_out, m_out, v_out, vh_out, n, b1, omb1, b2, omb2,
      eta, eps, option);
  return static_cast<int>(cudaGetLastError());
}
