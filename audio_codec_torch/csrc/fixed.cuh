// BASOP primitives of the bit-exact fixed-point decoder's kernels
// (fx_sns_dec.cu, fx_spec_decode.cu, fx_dct4.cu, fx_ola_ltpf.cu), and the
// thread groups their steps are written over.
//
// Word16 and Word32 values ride int64, as in the plain versions
// (ops/fixed_dec.py) and the reference (jax_enable_x64): a product of two
// Word32 values is exact in int64. Every function saturates and rounds where
// the ITU-T basic operator does, so a kernel equals its plain version bit for
// bit by construction; no float is involved.
//
// Where trouble is likely, and what is done about it:
// - Shifts. A shift by the width or more, or by a negative count, is
//   undefined in C++ and CUDA. Every shift goes through `shl64`/`shr64`,
//   whose count is clamped to 0..63 as the plain versions clamp it
//   (torch's and numpy's int64 shifts agree at 0..63); `>>` of a negative
//   value is arithmetic on every compiler this builds with (nvcc, g++).
// - norm_s/norm_l of 0 and -1, and of the most negative value: BASOP's
//   values (0, 15/31, 0), from the bit length of x or ~x, not __clz's raw
//   count.
// - Saturation: after every 32-bit add, subtract and negation (`ladd`,
//   `lsub`, `lneg`; lneg(-2^31) = 2^31 - 1).
#pragma once

#include <cstdint>

#include "acodec.cuh"

namespace acx {
namespace fx {

using i64 = long long;
constexpr i64 MAX32 = 2147483647LL, MIN32 = -2147483648LL;
constexpr i64 MAX16 = 32767, MIN16 = -32768;

ACX_HD i64 sat32(i64 x) { return x > MAX32 ? MAX32 : (x < MIN32 ? MIN32 : x); }
ACX_HD i64 sat16(i64 x) { return x > MAX16 ? MAX16 : (x < MIN16 ? MIN16 : x); }
ACX_HD i64 clamp64(i64 v, i64 lo, i64 hi) { return v < lo ? lo : (v > hi ? hi : v); }
ACX_HD i64 min64(i64 a, i64 b) { return a < b ? a : b; }
ACX_HD i64 max64(i64 a, i64 b) { return a > b ? a : b; }

// x << n and x >> n with the count clamped to 0..63 (two's complement wrap on
// the left, arithmetic on the right)
ACX_HD i64 shl64(i64 x, i64 n) {
  return static_cast<i64>(static_cast<unsigned long long>(x) << clamp64(n, 0, 63));
}
ACX_HD i64 shr64(i64 x, i64 n) { return x >> clamp64(n, 0, 63); }

// bit length of m >= 0
ACX_HD int bitlen(i64 m) {
  if (m <= 0) return 0;
#ifdef __CUDA_ARCH__
  return 64 - __clzll(m);
#else
  return 64 - __builtin_clzll(static_cast<unsigned long long>(m));
#endif
}
ACX_HD i64 norm_s(i64 x) { return x == 0 ? 0 : 15 - bitlen(x < 0 ? ~x : x); }
ACX_HD i64 norm_l(i64 x) { return x == 0 ? 0 : 31 - bitlen(x < 0 ? ~x : x); }

// saturating shl; a negative s is an arithmetic shr (ops/fixed_dec.py:L_shl)
ACX_HD i64 L_shl(i64 x, i64 s) {
  if (s >= 0) {
    const i64 sl = min64(s, 63);
    const i64 ax = x < 0 ? -x : x;
    if (shr64(ax, max64(31 - sl, 0)) > 0) return x >= 0 ? MAX32 : MIN32;
    return sat32(shl64(x, sl));
  }
  return shr64(x, -s);
}
ACX_HD i64 mpy_32_16(i64 x, i64 y) { return sat32((x * y) >> 15); }
ACX_HD i64 mpy_32_32(i64 x, i64 y) { return sat32((x * y) >> 31); }
ACX_HD i64 round_fx(i64 L) { return sat16(sat32(L + 0x8000) >> 16); }
ACX_HD i64 mult_r(i64 a, i64 b) { return sat16((a * b + 0x4000) >> 15); }
ACX_HD i64 L_mult(i64 a, i64 b) { return sat32(shl64(a * b, 1)); }
ACX_HD i64 mac_r(i64 L, i64 a, i64 b) { return round_fx(sat32(L + L_mult(a, b))); }
ACX_HD i64 msu_r(i64 L, i64 a, i64 b) { return round_fx(sat32(L - L_mult(a, b))); }
// Word16 saturating shl, a negative s a shr, both counts clamped to 31
ACX_HD i64 shl16(i64 x, i64 s) {
  return s >= 0 ? sat16(shl64(x, min64(s, 31))) : shr64(x, min64(-s, 31));
}
ACX_HD i64 ladd(i64 a, i64 b) { return sat32(a + b); }
ACX_HD i64 lsub(i64 a, i64 b) { return sat32(a - b); }
ACX_HD i64 lneg(i64 a) { return sat32(-a); }

// set bits of a 32-lane ballot, and the index of its highest set bit (-1 if
// none)
ACX_HD int popc32(unsigned m) {
#ifdef __CUDA_ARCH__
  return __popc(m);
#else
  return __builtin_popcount(m);
#endif
}
ACX_HD int top32(unsigned m) {
  if (m == 0) return -1;
#ifdef __CUDA_ARCH__
  return 31 - __clz(m);
#else
  return 31 - __builtin_clz(m);
#endif
}
// the ballot's bits below lane j, and at or below it ((2u << 31) wraps to 0)
ACX_HD unsigned below32(int j) { return (1u << j) - 1u; }
ACX_HD unsigned upto32(int j) { return (2u << j) - 1u; }

// ---- the groups of threads a step runs over ----
// On the host one thread runs every element in turn (the rehearsal); on the
// card a warp (32 lanes) or a block takes every 32nd or blockDim-th element.
// min/max combine each thread's partial over the group.
// The warp's scans run over chunks of 32 elements, a ballot of pred each:
//   scan_count(n, pred, f) calls f(i, rank, p) with p = pred(i) and rank the
//   count of j < i with pred(j), and returns the total;
//   scan_last(n, pred, f) calls f(i, last) with last the greatest j <= i with
//   pred(j), -1 if none.
// pred of a whole chunk is read before f runs on it. The host's scans build
// each chunk's ballot bit by bit and apply the same mask arithmetic, so the
// rehearsal runs it too.
struct Host {
  template <class F>
  void each(int n, F&& f) const {
    for (int i = 0; i < n; ++i) f(i);
  }
  void sync() const {}
  bool leader() const { return true; }
  i64 min(i64 v) const { return v; }
  i64 max(i64 v) const { return v; }
  template <class P>
  static unsigned ballot(int base, int n, P& pred) {
    unsigned m = 0;
    for (int j = 0; j < 32 && base + j < n; ++j) m |= (pred(base + j) ? 1u : 0u) << j;
    return m;
  }
  template <class P, class F>
  int scan_count(int n, P&& pred, F&& f) const {
    int r = 0;
    for (int base = 0; base < n; base += 32) {
      const unsigned m = ballot(base, n, pred);
      for (int j = 0; j < 32 && base + j < n; ++j)
        f(base + j, r + popc32(m & below32(j)), ((m >> j) & 1u) != 0);
      r += popc32(m);
    }
    return r;
  }
  template <class P, class F>
  void scan_last(int n, P&& pred, F&& f) const {
    int last = -1;
    for (int base = 0; base < n; base += 32) {
      const unsigned m = ballot(base, n, pred);
      for (int j = 0; j < 32 && base + j < n; ++j) {
        const int t = top32(m & upto32(j));
        f(base + j, t >= 0 ? base + t : last);
      }
      if (m != 0) last = base + top32(m);
    }
  }
};

#ifdef __CUDACC__
struct Warp {
  int lane;
  template <class F>
  __device__ void each(int n, F&& f) const {
    for (int i = lane; i < n; i += 32) f(i);
  }
  __device__ void sync() const { __syncwarp(); }
  __device__ bool leader() const { return lane == 0; }
  __device__ i64 min(i64 v) const {
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) v = min64(v, __shfl_xor_sync(0xffffffffu, v, o));
    return v;
  }
  __device__ i64 max(i64 v) const {
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) v = max64(v, __shfl_xor_sync(0xffffffffu, v, o));
    return v;
  }
  template <class P, class F>
  __device__ int scan_count(int n, P&& pred, F&& f) const {
    int r = 0;
    for (int base = 0; base < n; base += 32) {
      const int i = base + lane;
      const bool p = i < n && pred(i);
      const unsigned m = __ballot_sync(0xffffffffu, p);
      if (i < n) f(i, r + popc32(m & below32(lane)), p);
      r += popc32(m);
    }
    return r;
  }
  template <class P, class F>
  __device__ void scan_last(int n, P&& pred, F&& f) const {
    int last = -1;
    for (int base = 0; base < n; base += 32) {
      const int i = base + lane;
      const unsigned m = __ballot_sync(0xffffffffu, i < n && pred(i));
      const int t = top32(m & upto32(lane));
      if (i < n) f(i, t >= 0 ? base + t : last);
      if (m != 0) last = base + top32(m);
    }
  }
};

// A block of blockDim.x threads (a multiple of 32, at most 1024); `red` is
// 32 words of shared memory for the reductions.
struct Block {
  i64* red;
  template <class F>
  __device__ void each(int n, F&& f) const {
    for (int i = threadIdx.x; i < n; i += blockDim.x) f(i);
  }
  __device__ void sync() const { __syncthreads(); }
  __device__ bool leader() const { return threadIdx.x == 0; }
  template <bool kMin>
  __device__ i64 reduce(i64 v) const {
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
      const i64 u = __shfl_xor_sync(0xffffffffu, v, o);
      v = kMin ? min64(v, u) : max64(v, u);
    }
    __syncthreads();
    if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = v;
    __syncthreads();
    v = red[0];
    for (int w = 1; w < static_cast<int>(blockDim.x >> 5); ++w) v = kMin ? min64(v, red[w]) : max64(v, red[w]);
    return v;
  }
  __device__ i64 min(i64 v) const { return reduce<true>(v); }
  __device__ i64 max(i64 v) const { return reduce<false>(v); }
};
#endif

}  // namespace fx
}  // namespace acx
