// The DCT-IV of the low-delay MDCT and IMDCT (mdct.c:72-126, imdct.c:14-59)
// as a product of the stream rows by the N x N matrix, with the MDCT's window
// and fold as its prologue and the IMDCT's unfold, window and overlap-add as
// its epilogue. mdct.cu and imdct.cu launch it.
//
// Three float orders, each the one its plain version in ops/transforms.py
// states, so that the kernels equal the plain versions bit for bit:
// - the encoder's MDCT on the card (_dct4_card, dct4_out): each output a sum
//   over k in blocks of kDctTK = 32 (the last block ragged), each block one
//   k-ascending chain of separately rounded products and sums from its first
//   product, the blocks' sums added in order; the window and fold products
//   rounded one by one (rmul, radd);
// - the concealment's MDCT (the TDAC, _dct4_compensated,
//   dct4_out_compensated): the CPU's compensated product on every device,
//   Dekker-split exact products summed with Neumaier compensation (for row
//   values in range the Dekker term one fused multiply-add,
//   compensated_step_fast), and the fold's first product contracted as the
//   CPU contracts it (xfma);
// - the IMDCT (numerics.xla_dot, xla_dct4_out): the CPU's 68-deep chains of
//   xfma, written as xfma_d below, on doubles that hold float values.
#pragma once

#include <cstring>

#include "acodec.cuh"

namespace acx {

constexpr int kDctTK = 32;     // k-depth of a block of the card's sum
constexpr int kDctMaxN = 480;  // the largest frame at 10 ms without HR mode

// ---- the IMDCT's chain step on doubles ----
// xfma(a, b, p) rounds the exact double product plus p to float. Kept in a
// double register, a chain needs no conversion: the product of two floats
// is exact in double, so one double fused multiply-add is xfma's double
// product and add, and the rounding to float precision is (x + M) - M with
// M = x * 2^29 cut to its high word (x's sign, exponent E + 29 and 20
// fraction bits; the low word zero), E the exponent of x. M and x share a
// sign and |M| <= (2 - 2^-20) * 2^(E + 29), so |x + M| lies in
// [2^(E + 29), 2^(E + 30)), where a double's ulp is 2^(E - 23), the float
// ulp at exponent E; M / ulp is a multiple of 2^32, even, so the double's
// round-half-even is the float's, and (x + M) - M is exact. M costs one
// integer add on x's high word. That holds where float rounding has the
// ulp of E: 2^-126 <= |x| < 2^127, and for +0, which the trick leaves at
// +0 (x is a sum of floats' products and floats, so a zero exponent field
// with a zero high word is +0). -0 (which must stay -0), the other
// subnormal results, |x| at or past 2^127 (the float maximum, infinities)
// and NaN take the conversion.
constexpr uint32_t kExpField = 0x7FF00000u;
constexpr uint32_t kFloatExpLo = 897u << 20;    // exponent field of 2^-126
constexpr uint32_t kFloatExpHi = 1149u << 20;   // exponent field of 2^126
constexpr uint32_t kRoundM = (29u << 20);      // x's high word -> M's: exponent + 29

ACX_HD uint32_t hi_word(double x) {
#ifdef __CUDA_ARCH__
  return static_cast<uint32_t>(__double2hiint(x));
#else
  uint64_t u;
  std::memcpy(&u, &x, sizeof u);
  return static_cast<uint32_t>(u >> 32);
#endif
}

ACX_HD double from_hi_word(uint32_t hi) {
#ifdef __CUDA_ARCH__
  return __hiloint2double(static_cast<int>(hi), 0);
#else
  const uint64_t u = static_cast<uint64_t>(hi) << 32;
  double x;
  std::memcpy(&x, &u, sizeof x);
  return x;
#endif
}

ACX_HD double radd_f64(double a, double b) {
#ifdef __CUDA_ARCH__
  return __dadd_rn(a, b);
#else
  return a + b;
#endif
}

ACX_HD double rfma_f64(double a, double b, double c) {
#ifdef __CUDA_ARCH__
  return __fma_rn(a, b, c);
#else
  return std::fma(a, b, c);
#endif
}

ACX_HD float to_float(double x) {
#ifdef __CUDA_ARCH__
  return __double2float_rn(x);
#else
  return static_cast<float>(x);
#endif
}

// x rounded to float precision, for a caller that knows 2^-126 <= |x| <
// 2^127 or x is +0.
ACX_HD double round_float_in_range(double x) {
  const double m = from_hi_word(hi_word(x) + kRoundM);
  return radd_f64(radd_f64(x, m), -m);
}

// x rounded to float precision where 2^-126 <= |x| < 2^127 or x is +0;
// elsewhere sets far, and the value is not x's rounding.
ACX_HD double round_float_near(double x, bool& far) {
  const uint32_t hi = hi_word(x);
  const uint32_t e = hi & kExpField;
  far = far || e > kFloatExpHi || (e < kFloatExpLo && hi != 0u);
  return round_float_in_range(x);
}

// x rounded to float, as a double: static_cast<double>(to_float(x)).
ACX_HD double round_float(double x) {
  bool far = false;
  const double r = round_float_near(x, far);
  return far ? static_cast<double>(to_float(x)) : r;
}

// xfma on floats held in doubles, equal to xfma bit for bit.
ACX_HD double xfma_d(double a, double b, double p) { return round_float(rfma_f64(a, b, p)); }

// Where a chain of xfma_d needs no range test. Let every spectrum value a
// of a chain be zero or 2^-60 <= |a| < 2^120, and every matrix value b a
// DCT-IV entry of N <= 480 (1.05e-4 <= |b| <= sqrt(2 / N), so |b| >= 2^-14
// and its last bit is at least 2^-37). Then each product a * b is a
// multiple of 2^-120, and so is every partial sum (a float rounding of a
// multiple of 2^-120 to a coarser power-of-two grid stays a multiple of
// it): each is +0 (an exact zero from +0 is +0, and no -0 can arise) or at
// least 2^-120 in magnitude, and at most N * sqrt(2 / N) * 2^120 =
// sqrt(2 N) * 2^120 < 2^125. So every step's sum is in
// round_float_in_range's domain.
constexpr uint32_t kFastALo = 67u << 23;    // float bits of 2^-60
constexpr uint32_t kFastAHi = 247u << 23;   // float bits of 2^120

ACX_HD bool imdct_fast_input(float a) {
  uint32_t u;
#ifdef __CUDA_ARCH__
  u = __float_as_uint(a);
#else
  std::memcpy(&u, &a, sizeof u);
#endif
  u &= 0x7FFFFFFFu;
  return u == 0u || u - kFastALo < kFastAHi - kFastALo;
}

// out[n] = sum_k a[k] * Mt[k * N + n] in the card's blocked order above.
ACX_HD float dct4_out(const float* a, const float* Mt, int N, int n) {
  float acc = 0.0f;
  for (int k0 = 0; k0 < N; k0 += kDctTK) {
    const int k1 = imin(k0 + kDctTK, N);
    float part = rmul(a[k0], Mt[k0 * N + n]);
    for (int k = k0 + 1; k < k1; ++k) part = radd(part, rmul(a[k], Mt[k * N + n]));
    acc = k0 == 0 ? part : radd(acc, part);
  }
  return acc;
}

// The Veltkamp split at 2^12 + 1 of a float (transforms._dct4_compensated).
ACX_HD void veltkamp(float v, float& hi, float& lo) {
  const float c = rmul(4097.0f, v);
  hi = rsub(c, rsub(c, v));
  lo = rsub(v, hi);
}

// One term a * b of the compensated product: the Dekker error of the
// product, then a Neumaier two-sum of the product (contracted into the sum
// and into its compensation, as XLA:CPU contracts it) and of the error.
ACX_HD void compensated_step(float a, float ah, float al, float b, float bh, float bl, float& s,
                             float& comp) {
  const float p = rmul(a, b);
  const float err = xfma(al, bl, xfma(al, bh, xfma(ah, bl, xfma(ah, bh, -p))));
  float t = xfma(a, b, s);
  float bv = rsub(t, s);
  comp = radd(comp, radd(rsub(s, rsub(t, bv)), xfma(a, b, -bv)));
  s = t;
  t = radd(s, err);
  bv = rsub(t, s);
  comp = radd(comp, radd(rsub(s, rsub(t, bv)), rsub(err, bv)));
  s = t;
}

// ---- compensated_step without the split, for inputs in range ----
// Let the row value a be +-0 or 2^-89 <= |a| < 2^115, and b a DCT-IV entry
// of N <= 480 (1.05e-4 <= |b| <= 1: |cos| >= sin(pi / 4N) on the matrix's
// odd multiples of pi / 4N, times sqrt(2 / N)). Then Dekker's error term of
// compensated_step is fmaf(a, b, -p) bit for bit, and neither operand needs
// its Veltkamp halves:
// - 4097 a stays finite (4097 * 2^115 < 2^127.001), so the split is exact:
//   a = ah + al, each half of at most 12 significant bits on a's grid of
//   ulp(a) (Veltkamp, Dekker 1971); b likewise.
// - Every partial product of the halves then fits 24 bits, and every value
//   of the chain ((ah bh - p) + ah bl) + al bh) + al bl is an integer
//   multiple of ulp(a) ulp(b) >= 2^(-89-23) * 2^(-14-23) = 2^-149, the
//   float grid, with at most 24 significant bits (Dekker's theorem, whose
//   bit count needs only that grid): each is a float, xfma's double holds
//   it exactly (a product of two floats and a sum that is a float are exact
//   in double), and the chain ends at a b - p, unrounded.
// - a b - p is on the same grid and |a b - p| <= ulp(p) / 2 <= 2^23 grid
//   steps, so fmaf(a, b, -p) returns it unrounded too.
// - a = +-0: ah = a, al = +0, every product a signed zero, ah bh - p = +0
//   (opposite zeros), and every later sum +0; fmaf gives +0.
// Past 2^115 the split may overflow (4097 a reaches the float maximum just
// below 2^116); below 2^-89 the grid is finer than the float's. The kernel
// tests each row's values against this range in the fold prologue
// (compensated_fast_input) and gives the terms of the other rows
// compensated_step.
// The Neumaier tail xfma(a, b, -bv), with t = xfma(a, b, s) and
// bv = fl(t - s), is fmaf(a, b, -bv) for any a and b: a b - bv is exact in
// double, so xfma's double add rounds nothing. If bv = 0 it is a b (48
// bits). Otherwise t != s, so |a b| >= ulp(s) / 4 (1 - 2^-28) (s + a b
// reached the nearer neighbour's midpoint, even through the double's
// rounding); then ulp(t) <= 8 |a b| (1 + 2^-27) where |a b| <= |s|, and
// ulp(t) <= 2^-22 |a b| (1 + 2^-23) where not; |t - s - a b| <=
// ulp(t) / 2 (1 + 2^-29), |bv - (t - s)| <= ulp(bv) / 2, |bv| <= 5 |a b|,
// and ulp(t) <= 2^25 ulp(bv) (|t - s| is at least the finer ulp of the
// two, or half of |t|). a b - bv is a multiple of g, the finer of
// ulp(a) ulp(b) (|a b| < 2^48 of those) and ulp(bv), and |a b - bv| <
// 2^51 g: at most 53 bits. Zeros, infinities and NaN take the same sign
// rules and values in both. So only t = xfma(a, b, s) keeps a double
// multiply-add, on a and b converted once a k-row and s once a term.
constexpr uint32_t kCompFastLo = 38u << 23;    // float bits of 2^-89
constexpr uint32_t kCompFastHi = 242u << 23;   // float bits of 2^115

ACX_HD bool compensated_fast_input(float a) {
  uint32_t u;
#ifdef __CUDA_ARCH__
  u = __float_as_uint(a);
#else
  std::memcpy(&u, &a, sizeof u);
#endif
  u &= 0x7FFFFFFFu;
  return u == 0u || u - kCompFastLo < kCompFastHi - kCompFastLo;
}

ACX_HD float rfmaf(float a, float b, float c) {
#ifdef __CUDA_ARCH__
  return __fmaf_rn(a, b, c);
#else
  return std::fmaf(a, b, c);
#endif
}

// compensated_step for a in compensated_fast_input's range; ad and bd are a
// and b as doubles.
ACX_HD void compensated_step_fast(float a, float b, double ad, double bd, float& s,
                                  float& comp) {
  const float p = rmul(a, b);
  const float err = rfmaf(a, b, -p);
  float t = to_float(rfma_f64(ad, bd, static_cast<double>(s)));     // xfma(a, b, s)
  float bv = rsub(t, s);
  const float tail = rfmaf(a, b, -bv);                               // xfma(a, b, -bv)
  comp = radd(comp, radd(rsub(s, rsub(t, bv)), tail));
  s = t;
  t = radd(s, err);
  bv = rsub(t, s);
  comp = radd(comp, radd(rsub(s, rsub(t, bv)), rsub(err, bv)));
  s = t;
}

// One term of the compensated product, by the step its row value takes.
ACX_HD void compensated_term(float a, float b, float& s, float& comp) {
  if (compensated_fast_input(a)) {
    compensated_step_fast(a, b, static_cast<double>(a), static_cast<double>(b), s, comp);
  } else {
    float ah, al, bh, bl;
    veltkamp(a, ah, al);
    veltkamp(b, bh, bl);
    compensated_step(a, ah, al, b, bh, bl, s, comp);
  }
}

// out[n] in the compensated order.
ACX_HD float dct4_out_compensated(const float* a, const float* Mt, int N, int n) {
  float s = 0.0f, comp = 0.0f;
  for (int k = 0; k < N; ++k) compensated_term(a[k], Mt[k * N + n], s, comp);
  return radd(s, comp);
}

// The IMDCT's product in XLA:CPU's order (numerics.xla_dot, which the
// IMDCT's plain version takes on every device): k-blocks of
// imdct_chain_len(N) terms, each one chain of xfma from zero, the blocks'
// sums added in order.
ACX_HD int imdct_chain_len(int N) { return N == 480 ? 68 : N; }

ACX_HD float xla_dct4_out(const float* a, const float* Mt, int N, int n) {
  const int blk = imdct_chain_len(N);
  float acc = 0.0f;
  double part = 0.0;
  for (int k = 0; k < N; ++k) {
    if (k > 0 && k % blk == 0) {
      acc = k == blk ? static_cast<float>(part) : radd(acc, static_cast<float>(part));
      part = 0.0;
    }
    part = xfma_d(a[k], Mt[k * N + n], part);
  }
  return N <= blk ? static_cast<float>(part) : radd(acc, static_cast<float>(part));
}

// The IMDCT's product of a single row (numerics.xla_gemv): eight interleaved
// xfma chains from zero (chain k % 8), combined pairwise.
ACX_HD float xla_dct4_out_row(const float* a, const float* Mt, int N, int n) {
  double acc[8] = {0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0};
  for (int k0 = 0; k0 < N; k0 += 8) {
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      if (k0 + j < N) acc[j] = xfma_d(a[k0 + j], Mt[(k0 + j) * N + n], acc[j]);
    }
  }
  float f[8];
#pragma unroll
  for (int j = 0; j < 8; ++j) f[j] = static_cast<float>(acc[j]);
  return radd(radd(radd(f[0], f[1]), radd(f[2], f[3])), radd(radd(f[4], f[5]), radd(f[6], f[7])));
}

// The MDCT's input buffer [mem (N - la), x (N), zeros (la)] at j.
ACX_HD float mdct_buf(const float* x, const float* mem, int N, int la, int j) {
  return j < N - la ? mem[j] : (j < 2 * N - la ? x[j - (N - la)] : 0.0f);
}

// Element k of the windowed and folded MDCT input (mdct.c:115-119): for
// k < N/2, -w[3h+k] - w[3h-1-k]; above, w[k-h] - w[2h-1-(k-h)], with
// w[j] = buf[j] * win[j] (h = N/2). In the compensated order the first
// product is contracted into the difference (xfma), as on the CPU.
ACX_HD float mdct_fold(const float* x, const float* mem, const float* win, int N, int la, int k,
                       bool compensated = false) {
  const int h = N / 2;
  int j1, j2;
  float s1;
  if (k < h) {
    j1 = 3 * h + k;
    j2 = 3 * h - 1 - k;
    s1 = -mdct_buf(x, mem, N, la, j1);
  } else {
    j1 = k - h;
    j2 = 2 * h - 1 - (k - h);
    s1 = mdct_buf(x, mem, N, la, j1);
  }
  const float w2 = -rmul(mdct_buf(x, mem, N, la, j2), win[j2]);
  return compensated ? xfma(s1, win[j1], w2) : radd(rmul(s1, win[j1]), w2);
}

// The IMDCT's output at position j of the 2N-sample unfolded frame x_ov, whose
// value is v: x_ov[la:N] * win + mem goes to out[0:N-la], x_ov[N:N+la] * win
// to out[N-la:N], x_ov[N+la:] * win to new_mem; x_ov[:la] is dropped. win is
// the reversed window. The overlap-add is one fused multiply-add in the
// CPU's contraction (xfma), as the plain version's numerics.xla_fma.
ACX_HD void imdct_place(float v, int j, int N, int la, const float* win, const float* mem,
                        float* out, float* new_mem) {
  if (j < la) return;
  if (j < N) {
    out[j - la] = xfma(v, win[j], mem[j - la]);
  } else if (j < N + la) {
    out[j - la] = rmul(v, win[j]);
  } else {
    new_mem[j - N - la] = rmul(v, win[j]);
  }
}

// The TDA unfold (imdct.c:31-46): x_ov = [t[h:], -rev(t[h:]), -rev(t[:h]),
// -t[:h]]; each DCT-IV output t[c] lands at two positions.
ACX_HD void imdct_scatter(float t, int c, int N, int la, const float* win, const float* mem,
                          float* out, float* new_mem) {
  const int h = N / 2;
  if (c >= h) {
    imdct_place(t, c - h, N, la, win, mem, out, new_mem);
    imdct_place(-t, h + (N - 1 - c), N, la, win, mem, out, new_mem);
  } else {
    imdct_place(-t, N + (h - 1 - c), N, la, win, mem, out, new_mem);
    imdct_place(-t, N + h + c, N, la, win, mem, out, new_mem);
  }
}

}  // namespace acx

#ifdef __CUDACC__
// Sets a kernel's dynamic shared memory limit once, where it passes the
// 48 KB default.
template <typename Kernel>
inline cudaError_t acx_dynamic_smem(Kernel kernel, size_t bytes, bool* done) {
  if (bytes <= 48 * 1024 || *done) return cudaSuccess;
  const cudaError_t rc = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(bytes));
  *done = rc == cudaSuccess;
  return rc;
}
#endif
