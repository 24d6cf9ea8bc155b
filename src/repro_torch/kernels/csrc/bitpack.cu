// MSB-first n-bit packing and unpacking (n = 1..32 at run time) for Hopper
// (sm_90a), over a block of rows in one launch: the sub-word streams of the
// wire formats (the sign codec's 1-bit stream, blocktopk's
// ceil(log2 B)-bit index stream) for every client of a round at once.
//
// Replaces the Pallas kernels src/repro/kernels/bitpack.py::pack_uint
// (_pack_uint_kernel) and ::unpack_uint (_unpack_uint_kernel), which the
// JAX codecs run once a round under jax.vmap. Value slot s of a row's
// stream spans stream bits [s*n, (s+1)*n) and byte k spans [8k, 8k+8), most
// significant bit first (slot 0 lands in bit 7 of byte 0, as np.packbits
// does). Each row is packed on its own (the semantics of vmap(pack_uint)):
// row r's ceil(count*n/8) bytes go to out[r*out_stride + col ...] of a
// caller's (c, W) message block, beside the header and scale bytes the
// codec writes there, so no byte outside [col, col + nbytes) of a row is
// written, and no input is padded: slots past `count` read as 0 and bytes
// past `avail` read as 0. Byte-identical to pack_uint_words /
// unpack_uint_words row by row.
//
// Value kinds: pack reads uint8 or int32 values (uint32 bit patterns, only
// the low n bits kept), or, for n = 1, fp32 totals whose bit is
// `x >= 0.0f` on the float (-0.0 -> 1, NaN -> 0; not the sign bit): the
// sign codec's predicate fused into the pack. Unpack writes uint8
// (n <= 8) or int32, or, for n = 1, fp32 __fmul_rn(scale, bit ? 1 : -1)
// with the row's scale read from the message itself (4 little-endian
// bytes at scale_col, or at scale_col + 4*(i / scale_block) with per-block
// scales): the sign codec's decode fused into the unpack, bitwise
// `scale * (bits.float()*2 - 1)` for any scale, NaN, inf or 0 included.
//
// Bound on this card: bytes. The fused sign pair moves 4 bytes of fp32 a
// value against 1/8 of a byte of stream; the n = 11 index stream of a round
// is 0.6 MB, so a launch costs more than its bytes. Design:
//  * n = 1: a warp owns 32 consecutive 4-byte words of a row's output,
//    aligned in memory whatever col and the row stride are (the sign
//    stream of row r starts at byte 88,054r + 20, 6r + 4 mod 16): word j
//    covers stream bytes 4j - a .. 4j - a + 3 with a the row's misalignment,
//    so values 32j - 8a + lane of 32 iterations give 32 ballots (coalesced
//    128-byte loads, 32 in flight a lane), and lane t keeps ballot t, turned
//    into four MSB-first bytes by __brev + __byte_perm and stored as one
//    4-byte word; only a row's first and last word, where they hold bytes
//    outside the row's stream, are stored byte by byte. Unpack is the
//    mirror: each lane gathers one 4-byte word, the warp shuffles word t to
//    every lane in iteration t, and each lane writes value 32t + lane
//    (coalesced 128-byte stores).
//  * n >= 2: one thread a group of gv = lcm(n,8)/n values <-> gb = lcm/8
//    bytes (gv <= 8, gb <= 32), a 64-bit shift register emitting bytes (or
//    values) as they fill; int32 values are read by 16-byte loads where
//    the row allows it. Groups own whole bytes, so no two threads write
//    one byte and no atomics are needed.
// The grid covers the whole (rows, words or groups) block: one launch a
// call, whatever the number of rows.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kWordsPerWarp = 32;           // n = 1: 1024 values a warp
constexpr unsigned int kFull = 0xFFFFFFFFu;
constexpr int kMaxRows = 65535;             // gridDim.y

enum Kind { kU8 = 0, kI32 = 1, kF32 = 2 };

// -- n = 1 ------------------------------------------------------------------

template <int K>
__device__ __forceinline__ bool bit_of(const void* row, long long i) {
  if (K == kF32) return static_cast<const float*>(row)[i] >= 0.0f;
  if (K == kI32) return static_cast<const int*>(row)[i] & 1;
  return static_cast<const uint8_t*>(row)[i] & 1;
}

template <int K>
__device__ __forceinline__ const void* row_of(const void* in, long long r,
                                              long long stride) {
  if (K == kF32) return static_cast<const float*>(in) + r * stride;
  if (K == kI32) return static_cast<const int*>(in) + r * stride;
  return static_cast<const uint8_t*>(in) + r * stride;
}

template <int K>
__global__ void __launch_bounds__(kThreads)
pack_bits_kernel(const void* __restrict__ in, long long in_stride,
                 uint8_t* __restrict__ out, long long out_stride,
                 long long col, long long count, long long nbytes) {
  const int lane = threadIdx.x & 31;
  const long long r = blockIdx.y;
  const void* src = row_of<K>(in, r, in_stride);
  uint8_t* dst = out + r * out_stride + col;          // stream byte 0
  const int a = static_cast<int>(reinterpret_cast<uintptr_t>(dst) & 3u);
  const long long nwords = (nbytes + a + 3) / 4;
  const long long w0 =
      (static_cast<long long>(blockIdx.x) * kWarps + (threadIdx.x >> 5)) *
      kWordsPerWarp;
  if (w0 >= nwords) return;                           // warp-uniform
  // word j holds stream bytes 4j - a .. 4j - a + 3: values 32j - 8a + 0..31
  const long long v0 = 32 * w0 - 8 * a + lane;
  bool p[kWordsPerWarp];
#pragma unroll
  for (int t = 0; t < kWordsPerWarp; ++t) {
    const long long i = v0 + 32LL * t;
    p[t] = i >= 0 && i < count && bit_of<K>(src, i);
  }
  unsigned int word = 0u;
#pragma unroll
  for (int t = 0; t < kWordsPerWarp; ++t) {
    const unsigned int b = __ballot_sync(kFull, p[t]);
    if (lane == t) word = b;
  }
  const long long j = w0 + lane;
  if (j >= nwords) return;
  // ballot bit 8q + m is value 8q + m of the word: byte q, bit 7 - m
  const unsigned int bytes = __byte_perm(__brev(word), 0u, 0x0123);
  const long long s = 4 * j - a;
  if (s >= 0 && s + 4 <= nbytes) {
    *reinterpret_cast<unsigned int*>(dst + s) = bytes;   // 4-byte aligned
  } else {
#pragma unroll
    for (int q = 0; q < 4; ++q)
      if (s + q >= 0 && s + q < nbytes)
        dst[s + q] = static_cast<uint8_t>(bytes >> (8 * q));
  }
}

__device__ __forceinline__ float le_float(const uint8_t* p) {
  return __uint_as_float(static_cast<unsigned int>(p[0]) |
                         (static_cast<unsigned int>(p[1]) << 8) |
                         (static_cast<unsigned int>(p[2]) << 16) |
                         (static_cast<unsigned int>(p[3]) << 24));
}

template <int K, bool kBlockScales>
__global__ void __launch_bounds__(kThreads)
unpack_bits_kernel(const uint8_t* __restrict__ in, long long in_stride,
                   long long col, long long avail, void* __restrict__ out,
                   long long out_stride, long long count, long long scale_col,
                   long long scale_block) {
  const int lane = threadIdx.x & 31;
  const long long r = blockIdx.y;
  const long long t0 =
      (static_cast<long long>(blockIdx.x) * kWarps + (threadIdx.x >> 5)) *
      (32LL * kWordsPerWarp);
  if (t0 >= count) return;                            // warp-uniform
  const uint8_t* msg = in + r * in_stride;
  const uint8_t* src = msg + col;
  const long long b0 = t0 / 8 + 4 * lane;
  unsigned int word = 0u;
#pragma unroll
  for (int q = 0; q < 4; ++q)
    if (b0 + q < avail)
      word |= static_cast<unsigned int>(src[b0 + q]) << (8 * q);
  float scale = 0.0f;
  if (K == kF32 && !kBlockScales) scale = le_float(msg + scale_col);
  // value 32t + lane of the warp: stream byte 4t + lane/8, bit 7 - lane%8
  const int sh = 8 * (lane >> 3) + 7 - (lane & 7);
#pragma unroll 8
  for (int t = 0; t < kWordsPerWarp; ++t) {
    const unsigned int w = __shfl_sync(kFull, word, t);
    const long long i = t0 + 32LL * t + lane;
    if (i >= count) continue;
    const unsigned int b = (w >> sh) & 1u;
    if (K == kF32) {
      const float s = kBlockScales
                          ? le_float(msg + scale_col + 4 * (i / scale_block))
                          : scale;
      static_cast<float*>(out)[r * out_stride + i] =
          __fmul_rn(s, b ? 1.0f : -1.0f);
    } else if (K == kI32) {
      static_cast<int*>(out)[r * out_stride + i] = static_cast<int>(b);
    } else {
      static_cast<uint8_t*>(out)[r * out_stride + i] =
          static_cast<uint8_t>(b);
    }
  }
}

// -- n >= 2 -----------------------------------------------------------------

template <typename T>
__global__ void __launch_bounds__(kThreads)
pack_groups_kernel(const T* __restrict__ in, long long in_stride,
                   uint8_t* __restrict__ out, long long out_stride,
                   long long col, long long count, long long nbytes, int n,
                   int gv, int gb, unsigned int mask, long long groups) {
  const long long g =
      static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (g >= groups) return;
  const long long r = blockIdx.y;
  const T* src = in + r * in_stride;
  uint8_t* dst = out + r * out_stride + col + g * gb;
  const long long v0 = g * gv;
  unsigned int v[8];
  // a whole group of 4 or 8 int32 values starts on a 16-byte boundary of
  // its row when the row does
  if (sizeof(T) == 4 && gv % 4 == 0 && v0 + gv <= count &&
      (reinterpret_cast<uintptr_t>(src) & 15u) == 0) {
#pragma unroll
    for (int q = 0; q < 2; ++q) {
      if (4 * q < gv) {
        const uint4 u = *reinterpret_cast<const uint4*>(src + v0 + 4 * q);
        v[4 * q] = u.x;
        v[4 * q + 1] = u.y;
        v[4 * q + 2] = u.z;
        v[4 * q + 3] = u.w;
      }
    }
  } else {
#pragma unroll
    for (int s = 0; s < 8; ++s)
      v[s] = s < gv && v0 + s < count ? static_cast<unsigned int>(src[v0 + s])
                                      : 0u;
  }
  // bits enter at the bottom and leave from the top, 8 at a time
  unsigned long long acc = 0ull;
  int have = 0, k = 0;
#pragma unroll
  for (int s = 0; s < 8; ++s) {
    if (s < gv) {
      acc = (acc << n) | (v[s] & mask);
      have += n;
      while (have >= 8) {
        have -= 8;
        if (g * gb + k < nbytes)
          dst[k] = static_cast<uint8_t>(acc >> have);
        ++k;
      }
      acc &= (1ull << have) - 1ull;
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
unpack_groups_kernel(const uint8_t* __restrict__ in, long long in_stride,
                     long long col, long long avail, T* __restrict__ out,
                     long long out_stride, long long count, int n, int gv,
                     int gb, unsigned int mask, long long groups) {
  const long long g =
      static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (g >= groups) return;
  const long long r = blockIdx.y;
  const uint8_t* src = in + r * in_stride + col;
  T* dst = out + r * out_stride;
  const long long o0 = g * gb, v0 = g * gv;
  unsigned long long acc = 0ull;
  int have = 0, s = 0;
  for (int k = 0; k < gb; ++k) {
    const unsigned int b = o0 + k < avail ? src[o0 + k] : 0u;
    acc = (acc << 8) | b;
    have += 8;
    while (have >= n) {
      have -= n;
      if (v0 + s < count)
        dst[v0 + s] = static_cast<T>(static_cast<unsigned int>(acc >> have) &
                                     mask);
      ++s;
    }
    acc &= (1ull << have) - 1ull;
  }
}

int gcd(int a, int b) { return b == 0 ? a : gcd(b, a % b); }

unsigned int low_mask(int n) {
  return n == 32 ? 0xFFFFFFFFu : ((1u << n) - 1u);
}

bool grid_x(long long units, long long per_block, unsigned int* x) {
  const long long nblk = (units + per_block - 1) / per_block;
  if (nblk < 1 || nblk > 0x7FFFFFFFLL) return false;
  *x = static_cast<unsigned int>(nblk);
  return true;
}

}  // namespace

// in: (rows, in_stride) values of `in_kind`; out: row r's stream at
// out + r*out_stride + col. One launch.
extern "C" int pack_uint_launch(const void* in, long long in_stride,
                                int in_kind, uint8_t* out,
                                long long out_stride, long long col,
                                long long count, int nbits, int rows,
                                void* stream) {
  if (count <= 0 || nbits < 1 || nbits > 32 || rows < 1 ||
      rows > kMaxRows || col < 0 || in_kind < kU8 || in_kind > kF32 ||
      (in_kind == kF32 && nbits != 1))
    return static_cast<int>(cudaErrorInvalidValue);
  const long long nbytes = (count * nbits + 7) / 8;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  unsigned int bx;
  if (nbits == 1) {
    // at most one word more than the stream's bytes need, for misalignment
    if (!grid_x((nbytes + 6) / 4, kWarps * kWordsPerWarp, &bx))
      return static_cast<int>(cudaErrorInvalidValue);
    const dim3 grid(bx, rows);
    if (in_kind == kF32)
      pack_bits_kernel<kF32><<<grid, kThreads, 0, st>>>(
          in, in_stride, out, out_stride, col, count, nbytes);
    else if (in_kind == kI32)
      pack_bits_kernel<kI32><<<grid, kThreads, 0, st>>>(
          in, in_stride, out, out_stride, col, count, nbytes);
    else
      pack_bits_kernel<kU8><<<grid, kThreads, 0, st>>>(
          in, in_stride, out, out_stride, col, count, nbytes);
    return static_cast<int>(cudaGetLastError());
  }
  const int lcm = nbits / gcd(nbits, 8) * 8;
  const int gv = lcm / nbits, gb = lcm / 8;
  const long long groups = (count + gv - 1) / gv;
  if (!grid_x(groups, kThreads, &bx))
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(bx, rows);
  if (in_kind == kI32)
    pack_groups_kernel<int><<<grid, kThreads, 0, st>>>(
        static_cast<const int*>(in), in_stride, out, out_stride, col, count,
        nbytes, nbits, gv, gb, low_mask(nbits), groups);
  else
    pack_groups_kernel<uint8_t><<<grid, kThreads, 0, st>>>(
        static_cast<const uint8_t*>(in), in_stride, out, out_stride, col,
        count, nbytes, nbits, gv, gb, low_mask(nbits), groups);
  return static_cast<int>(cudaGetLastError());
}

// in: row r's stream at in + r*in_stride + col, `avail` bytes of it
// readable; out: (rows, out_stride) values of `out_kind`. For kF32 (n = 1)
// the row's scale is at in + r*in_stride + scale_col (+ 4*(i/scale_block)
// when scale_block > 0). One launch.
extern "C" int unpack_uint_launch(const uint8_t* in, long long in_stride,
                                  long long col, long long avail, void* out,
                                  long long out_stride, int out_kind,
                                  long long count, int nbits, int rows,
                                  long long scale_col, long long scale_block,
                                  void* stream) {
  if (count <= 0 || nbits < 1 || nbits > 32 || rows < 1 ||
      rows > kMaxRows || col < 0 || avail < 0 || out_kind < kU8 ||
      out_kind > kF32 || (out_kind == kU8 && nbits > 8) ||
      (out_kind == kF32 && (nbits != 1 || scale_col < 0 || scale_block < 0)))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  unsigned int bx;
  if (nbits == 1) {
    if (!grid_x(count, 32LL * kWarps * kWordsPerWarp, &bx))
      return static_cast<int>(cudaErrorInvalidValue);
    const dim3 grid(bx, rows);
    if (out_kind == kF32 && scale_block > 0)
      unpack_bits_kernel<kF32, true><<<grid, kThreads, 0, st>>>(
          in, in_stride, col, avail, out, out_stride, count, scale_col,
          scale_block);
    else if (out_kind == kF32)
      unpack_bits_kernel<kF32, false><<<grid, kThreads, 0, st>>>(
          in, in_stride, col, avail, out, out_stride, count, scale_col, 0);
    else if (out_kind == kI32)
      unpack_bits_kernel<kI32, false><<<grid, kThreads, 0, st>>>(
          in, in_stride, col, avail, out, out_stride, count, 0, 0);
    else
      unpack_bits_kernel<kU8, false><<<grid, kThreads, 0, st>>>(
          in, in_stride, col, avail, out, out_stride, count, 0, 0);
    return static_cast<int>(cudaGetLastError());
  }
  const int lcm = nbits / gcd(nbits, 8) * 8;
  const int gv = lcm / nbits, gb = lcm / 8;
  const long long groups = (count + gv - 1) / gv;
  if (!grid_x(groups, kThreads, &bx))
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(bx, rows);
  if (out_kind == kI32)
    unpack_groups_kernel<int><<<grid, kThreads, 0, st>>>(
        in, in_stride, col, avail, static_cast<int*>(out), out_stride, count,
        nbits, gv, gb, low_mask(nbits), groups);
  else
    unpack_groups_kernel<uint8_t><<<grid, kThreads, 0, st>>>(
        in, in_stride, col, avail, static_cast<uint8_t*>(out), out_stride,
        count, nbits, gv, gb, low_mask(nbits), groups);
  return static_cast<int>(cudaGetLastError());
}
