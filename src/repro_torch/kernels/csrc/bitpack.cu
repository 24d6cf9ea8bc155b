// MSB-first n-bit packing and unpacking (n = 1..32 at run time) for Hopper
// (sm_90a): the sub-word streams of the wire formats (the sign codec's
// 1-bit stream, blocktopk's ceil(log2 B)-bit index stream).
//
// Replaces the Pallas kernels src/repro/kernels/bitpack.py::pack_uint
// (_pack_uint_kernel) and ::unpack_uint (_unpack_uint_kernel). Value slot s
// of the stream spans stream bits [s*n, (s+1)*n) and byte k spans
// [8k, 8k+8), most significant bit first (slot 0 lands in bit 7 of byte 0,
// as np.packbits does). With L = lcm(n, 8) the stream tiles into groups of
// gv = L/n values <-> gb = L/8 bytes (gv <= 8, gb <= 32); every overlapping
// (byte k, slot s) pair of a group contributes one bit run whose alignment
// is the constant shift 8k + 8 - (s+1)*n:
//   byte_k  = OR_s shift(value_s, 8k + 8 - (s+1)*n) & 0xFF
//   value_s = OR_k shift(byte_k, (s+1)*n - 8k - 8) & (2^n - 1)
// The pairs are computed here from (k, s) as bitpack.py's _pack_pairs /
// _unpack_pairs tabulate them. One thread per group: groups own whole
// bytes, so no two threads write one byte and no atomics are needed. A
// ragged count needs no padding of the input: slots past `count` read as 0,
// bytes past the input read as 0, and only the ceil(count*n/8) output bytes
// (or `count` values) are written. Byte-identical to pack_uint_words /
// unpack_uint_words.
//
// Inputs: pack takes uint8 or int32 values (uint32 bit patterns; only the
// low n bits are kept); unpack writes int32 (uint32 bit patterns) or, for
// n <= 8, uint8.
//
// Bound on this card: bytes — each input read once and each output written
// once; the shifts are a few integer operations per byte.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ unsigned int shl(unsigned int v, int sh) {
  return sh >= 0 ? (v << sh) : (v >> -sh);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
pack_kernel(const T* __restrict__ in, uint8_t* __restrict__ out,
            long long count, long long nbytes, int n, int gv, int gb,
            unsigned int mask, long long groups) {
  const long long g =
      static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (g >= groups) return;
  const long long v0 = g * gv;
  const long long o0 = g * gb;
  for (int k = 0; k < gb; ++k) {
    if (o0 + k >= nbytes) break;
    const int s_hi = min((8 * k + 7) / n, gv - 1);
    unsigned int acc = 0u;
    for (int s = (8 * k) / n; s <= s_hi; ++s) {
      const long long i = v0 + s;
      const unsigned int v =
          i < count ? (static_cast<unsigned int>(in[i]) & mask) : 0u;
      acc |= shl(v, 8 * k + 8 - (s + 1) * n);
    }
    out[o0 + k] = static_cast<uint8_t>(acc & 0xFFu);
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
unpack_kernel(const uint8_t* __restrict__ in, long long nbytes_in,
              T* __restrict__ out, long long count, int n, int gv, int gb,
              unsigned int mask, long long groups) {
  const long long g =
      static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (g >= groups) return;
  const long long v0 = g * gv;
  const long long o0 = g * gb;
  for (int s = 0; s < gv; ++s) {
    if (v0 + s >= count) break;
    const int k_hi = min(((s + 1) * n - 1) / 8, gb - 1);
    unsigned int acc = 0u;
    for (int k = (s * n) / 8; k <= k_hi; ++k) {
      const long long o = o0 + k;
      const unsigned int b = o < nbytes_in ? in[o] : 0u;
      acc |= shl(b, (s + 1) * n - 8 * k - 8);
    }
    out[v0 + s] = static_cast<T>(acc & mask);
  }
}

int gcd(int a, int b) { return b == 0 ? a : gcd(b, a % b); }

// group shape (gv values, gb bytes) and the launch size for `count` values
bool shape(long long count, int n, int* gv, int* gb, long long* groups,
           unsigned int* blocks) {
  if (count <= 0 || n < 1 || n > 32) return false;
  const int lcm = n / gcd(n, 8) * 8;
  *gv = lcm / n;
  *gb = lcm / 8;
  *groups = (count + *gv - 1) / *gv;
  const long long nblk = (*groups + kThreads - 1) / kThreads;
  if (nblk > 0x7FFFFFFFLL) return false;
  *blocks = static_cast<unsigned int>(nblk);
  return true;
}

}  // namespace

extern "C" int pack_uint_launch(const void* in, uint8_t* out, long long count,
                                int nbits, int in_bytes, void* stream) {
  int gv, gb;
  long long groups;
  unsigned int blocks;
  if (!shape(count, nbits, &gv, &gb, &groups, &blocks) ||
      (in_bytes != 1 && in_bytes != 4))
    return static_cast<int>(cudaErrorInvalidValue);
  const unsigned int mask =
      nbits == 32 ? 0xFFFFFFFFu : ((1u << nbits) - 1u);
  const long long nbytes = (count * nbits + 7) / 8;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (in_bytes == 1)
    pack_kernel<uint8_t><<<blocks, kThreads, 0, st>>>(
        static_cast<const uint8_t*>(in), out, count, nbytes, nbits, gv, gb,
        mask, groups);
  else
    pack_kernel<int><<<blocks, kThreads, 0, st>>>(
        static_cast<const int*>(in), out, count, nbytes, nbits, gv, gb, mask,
        groups);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int unpack_uint_launch(const uint8_t* in, long long nbytes_in,
                                  void* out, long long count, int nbits,
                                  int out_bytes, void* stream) {
  int gv, gb;
  long long groups;
  unsigned int blocks;
  if (!shape(count, nbits, &gv, &gb, &groups, &blocks) || nbytes_in < 0 ||
      (out_bytes != 1 && out_bytes != 4) || (out_bytes == 1 && nbits > 8))
    return static_cast<int>(cudaErrorInvalidValue);
  const unsigned int mask =
      nbits == 32 ? 0xFFFFFFFFu : ((1u << nbits) - 1u);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (out_bytes == 1)
    unpack_kernel<uint8_t><<<blocks, kThreads, 0, st>>>(
        in, nbytes_in, static_cast<uint8_t*>(out), count, nbits, gv, gb, mask,
        groups);
  else
    unpack_kernel<int><<<blocks, kThreads, 0, st>>>(
        in, nbytes_in, static_cast<int*>(out), count, nbits, gv, gb, mask,
        groups);
  return static_cast<int>(cudaGetLastError());
}
