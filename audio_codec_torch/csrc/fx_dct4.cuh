// The steps of fx_dct4.cu: the fixed-point DCT-IV of one 480-point row
// (ops/fixed_dev.py:batch_dct4_plain over ops/fixed_imdct.py:dct_IV and the
// cfft of 240 points, fftN2_8 over fft30 columns), written once over the
// group of lanes that runs a row (fx_dct4.cu's RowLanes on the card, a warp
// or half a warp; fixed.cuh's Host, one thread, in the rehearsals,
// tests/test_torch_fxdct_fec_rehearsal.py and
// tests/test_torch_lane_rehearsal.py).
//
// Word size. The kernel's inputs are Word32 (K20b saturates every spectral
// value it writes), and every operation of the transform saturates or
// shifts to 32 bits, so every value is held as int32 and every operation is
// its 32-bit form: add_sat32/sub_sat32 for L_add/L_sub, mpy32_16 for
// Mpy_32_16, neg_sat32 for L_negate (-(-2^31) saturates to 2^31 - 1),
// shl_sat32 for L_shl with a count of 0..31 (the headroom's; 1 in the
// FFT5). Only the row's loads (int64 in, converted once) and the output's
// stores (int64, which K21 reads) are 64-bit. For Word32 inputs the scaling
// keeps every sum and product inside 32 bits, so no saturation fires on
// them; the 32-bit forms saturate all the same, exactly as the 64-bit ones.
//
// The stages, a group sync between them, in two int32 buffers of 480:
//  1. the row below the 400-bin cap into a, its headroom (getScaleFactor32_0)
//     from the OR of v ^ (v >> 31) over the row (clz of it, less one, is the
//     least norm_l of the nonzero values);
//  2. the pre-scale and pre-twiddle in place (node k reads and writes 2k,
//     2k + 1, 478 - 2k, 479 - 2k);
//  3. the 16 fft15 halves of the 8 fft30 columns (a half a lane) into b;
//  4. the 30 twiddled radix-8 rows, each taking its 8 inputs from the two
//     fft15 halves of a column (fft30's last stage, a sum or a difference
//     of two halved values, fused here), into a;
//  5. the post-twiddle (120 nodes; the reference's loop carries only values
//     it read before writing, so each node's outputs follow from the
//     transform's output alone), written out as int64 pairs, and the second
//     headroom.
#pragma once

#include "fixed.cuh"

namespace acx {
namespace fx {

using w32 = int32_t;

constexpr int kDctN = 480, kDctM = 240, kDctMaxBw = 400;
// the table pack (kernels.py:fx_dct4_table_pack, int32 on the card):
// SineWindow480 [240][2], SineTable480 [241][2], RotVector_480 [900]
constexpr int kDctTw = 0, kDctSin = 480, kDctRot = 962, kFxDctTableWords = 1862;
// FFT constants (fft.c:53-90, WORD322WORD16 of the Word32 values)
constexpr w32 kC31 = -28378, kC51 = 31164, kC52 = -25212, kC53 = -11904, kC54 = 18318,
              kC55 = -20480, kC81 = 23170, kC82 = -23170, kTwiddle = 23170;
constexpr w32 kW32Max = 2147483647, kW32Min = -kW32Max - 1;

// L_negate: -(-2^31) saturates to 2^31 - 1
ACX_HD w32 neg_sat32(w32 a) { return sub_sat32(0, a); }
// L_shl(x, s) for 0 <= s <= 31: where x << s leaves 32 bits, x's sign's bound
ACX_HD w32 shl_sat32(w32 x, int s) {
  const w32 r = static_cast<w32>(static_cast<uint32_t>(x) << s);
  return (r >> s) == x ? r : (x < 0 ? kW32Min : kW32Max);
}
// norm_l(v) = clz(v ^ (v >> 31)) - 1 for v != 0, so the least norm_l of a
// row's nonzero values is clz of the OR of these words, less one
ACX_HD uint32_t norm_word(w32 v) { return static_cast<uint32_t>(v ^ (v >> 31)); }
ACX_HD int clz32(uint32_t m) {
  if (m == 0) return 32;
#ifdef __CUDA_ARCH__
  return __clz(m);
#else
  return __builtin_clz(m);
#endif
}
// getScaleFactor32_0 from a row's OR of norm words and OR of values: 32 for
// an all-zero row
ACX_HD int headroom32(uint32_t norm_or, uint32_t value_or) {
  return value_or == 0 ? 32 : clz32(norm_or) - 1;
}

// 64-bit pairs of a row: 16-byte loads and stores on the card (rows start
// 16-byte aligned: the wrapper's)
struct I64Pair {
  i64 x, y;
};
ACX_HD I64Pair load_i64_pair(const i64* p) {
#ifdef __CUDA_ARCH__
  const longlong2 v = __ldg(reinterpret_cast<const longlong2*>(p));
  return {v.x, v.y};
#else
  return {p[0], p[1]};
#endif
}
ACX_HD void store_i64_pair(i64* p, w32 x, w32 y) {
#ifdef __CUDA_ARCH__
  *reinterpret_cast<longlong2*>(p) = make_longlong2(x, y);
#else
  p[0] = x;
  p[1] = y;
#endif
}

// cplxMpy32_32_16_2 (basop_mpy.h:45-50)
ACX_HD void cplx2(w32 a, w32 b, w32 c, w32 d, w32* re, w32* im) {
  *re = sub_sat32(mpy32_16(a, c) >> 1, mpy32_16(b, d) >> 1);
  *im = add_sat32(mpy32_16(a, d) >> 1, mpy32_16(b, c) >> 1);
}

// 5-point butterfly (fft.c:215-231): (y0, r1, r3, r4, r2)
ACX_HD void core5(const w32* x, w32* o) {
  w32 r1 = add_sat32(x[1], x[4]), r4 = sub_sat32(x[1], x[4]);
  w32 r3 = add_sat32(x[2], x[3]), r2 = sub_sat32(x[2], x[3]);
  w32 t = mpy32_16(sub_sat32(r1, r3), kC54);
  r1 = add_sat32(r1, r3);
  const w32 y0 = add_sat32(x[0], r1);
  const w32 m55 = mpy32_16(r1, kC55);
  r1 = add_sat32(y0, shl_sat32(m55, 1));
  r3 = sub_sat32(r1, t);
  r1 = add_sat32(r1, t);
  t = mpy32_16(add_sat32(r4, r2), kC51);
  const w32 m52 = mpy32_16(r4, kC52);
  r4 = add_sat32(t, shl_sat32(m52, 1));
  r2 = add_sat32(t, mpy32_16(r2, kC53));
  o[0] = y0;
  o[1] = r1;
  o[2] = r3;
  o[3] = r4;
  o[4] = r2;
}

// FFT5 on 5 pairs (re[], im[]) with the Word16 constants (fft.c:261-277)
ACX_HD void fft5_pairs(const w32* re, const w32* im, w32* ore, w32* oim) {
  w32 rr[5], ss[5];
  core5(re, rr);
  core5(im, ss);
  ore[0] = rr[0];
  oim[0] = ss[0];
  ore[1] = add_sat32(rr[1], ss[4]);
  oim[1] = sub_sat32(ss[1], rr[4]);
  ore[2] = sub_sat32(rr[2], ss[3]);
  oim[2] = add_sat32(ss[2], rr[3]);
  ore[3] = add_sat32(rr[2], ss[3]);
  oim[3] = sub_sat32(ss[2], rr[3]);
  ore[4] = sub_sat32(rr[1], ss[4]);
  oim[4] = add_sat32(ss[1], rr[4]);
}

// Half h of fft30 column c (fft.c:1791-2583): its 15 input pairs
// c + 8 load_h[j] of `in` (interleaved re, im) shifted right by 5, then
// fft15's 3 FFT5 and 5 FFT3 (fft.c:656-913); output k at pair
// 30 c + 15 h + k of z.
ACX_HD void fft15_half(const w32* in, w32* z, int c, int h) {
  constexpr int loadA[15] = {0, 18, 6, 24, 12, 20, 8, 26, 14, 2, 10, 28, 16, 4, 22};
  constexpr int loadB[15] = {15, 3, 21, 9, 27, 5, 23, 11, 29, 17, 25, 13, 1, 19, 7};
  constexpr int slots[5][3] = {{0, 10, 5}, {6, 1, 11}, {12, 7, 2}, {3, 13, 8}, {9, 4, 14}};
  w32 br[15], bi[15];
#pragma unroll
  for (int j = 0; j < 3; ++j) {
    w32 re[5], im[5];
#pragma unroll
    for (int q = 0; q < 5; ++q) {
      const int p = c + 8 * (h == 0 ? loadA[5 * j + q] : loadB[5 * j + q]);
      re[q] = in[2 * p] >> 5;
      im[q] = in[2 * p + 1] >> 5;
    }
    fft5_pairs(re, im, br + 5 * j, bi + 5 * j);
  }
  w32* o = z + 2 * (30 * c + 15 * h);
#pragma unroll
  for (int k = 0; k < 5; ++k) {
    const w32 ar = br[k], ai = bi[k], b_r = br[5 + k], b_i = bi[5 + k], cr = br[10 + k],
              ci = bi[10 + k];
    w32 r1 = add_sat32(b_r, cr);
    const w32 r2 = mpy32_16(sub_sat32(b_r, cr), kC31);
    const w32 o0r = add_sat32(ar, r1);
    r1 = sub_sat32(ar, r1 >> 1);
    w32 s1 = add_sat32(b_i, ci);
    const w32 s2 = mpy32_16(sub_sat32(b_i, ci), kC31);
    const w32 o0i = add_sat32(ai, s1);
    s1 = sub_sat32(ai, s1 >> 1);
    o[2 * slots[k][0]] = o0r;
    o[2 * slots[k][0] + 1] = o0i;
    o[2 * slots[k][1]] = sub_sat32(r1, s2);
    o[2 * slots[k][1] + 1] = add_sat32(s1, r2);
    o[2 * slots[k][2]] = add_sat32(r1, s2);
    o[2 * slots[k][2] + 1] = sub_sat32(s1, r2);
  }
}

// radix-8 butterfly of fftN2's second stage with the SCALEFACTORN2 - 1 = 2
// shifts (fft.c:3492-3600); x: 8 pairs interleaved, y: 8 pairs
ACX_HD void bfly8(const w32* x, w32* y) {
  auto ps = [](w32 v) { return v >> 2; };
  const w32 t00 = ps(add_sat32(x[0], x[8])), t02 = ps(sub_sat32(x[0], x[8]));
  const w32 t01 = ps(add_sat32(x[1], x[9])), t03 = ps(sub_sat32(x[1], x[9]));
  const w32 t04 = ps(add_sat32(x[2], x[10])), t06 = sub_sat32(x[2], x[10]);
  const w32 t05 = ps(add_sat32(x[3], x[11])), t07 = sub_sat32(x[3], x[11]);
  const w32 t08 = ps(add_sat32(x[4], x[12])), t10 = ps(sub_sat32(x[4], x[12]));
  const w32 t09 = ps(add_sat32(x[5], x[13])), t11 = ps(sub_sat32(x[5], x[13]));
  const w32 t12 = ps(add_sat32(x[6], x[14])), t14 = sub_sat32(x[6], x[14]);
  const w32 t13 = ps(add_sat32(x[7], x[15])), t15 = sub_sat32(x[7], x[15]);
  const w32 s00 = add_sat32(t00, t08), s04 = sub_sat32(t00, t08);
  const w32 s01 = add_sat32(t01, t09), s05 = sub_sat32(t01, t09);
  const w32 s08 = sub_sat32(t02, t11), s10 = add_sat32(t02, t11);
  const w32 s09 = add_sat32(t03, t10), s11 = sub_sat32(t03, t10);
  const w32 s02 = add_sat32(t04, t12), s07 = sub_sat32(t04, t12);
  const w32 s03 = add_sat32(t05, t13), s06 = sub_sat32(t13, t05);
  const w32 ta = ps(add_sat32(t06, t14)), tb = ps(sub_sat32(t06, t14));
  const w32 tc = ps(add_sat32(t07, t15)), td = ps(sub_sat32(t07, t15));
  const w32 s12 = mpy32_16(add_sat32(tc, tb), kC81);
  const w32 s14 = mpy32_16(sub_sat32(tc, tb), kC81);
  const w32 s13 = mpy32_16(sub_sat32(td, ta), kC81);
  const w32 s15 = mpy32_16(add_sat32(ta, td), kC82);
  y[0] = add_sat32(s00, s02);
  y[1] = add_sat32(s01, s03);
  y[2] = add_sat32(s10, s12);
  y[3] = add_sat32(s11, s13);
  y[4] = sub_sat32(s04, s06);
  y[5] = sub_sat32(s05, s07);
  y[6] = add_sat32(s08, s14);
  y[7] = add_sat32(s09, s15);
  y[8] = sub_sat32(s00, s02);
  y[9] = sub_sat32(s01, s03);
  y[10] = sub_sat32(s10, s12);
  y[11] = sub_sat32(s11, s13);
  y[12] = add_sat32(s04, s06);
  y[13] = add_sat32(s05, s07);
  y[14] = sub_sat32(s08, s14);
  y[15] = sub_sat32(s09, s15);
}

// Row i of fftN2_8(dim1 30, RotVector_480, sc 2, Woff 60). Its input k is
// output i of fft30 column k: with t = i mod 15 and kk = pair30[t] (t / 2,
// or 8 + t / 2 for odd t), fft30's last stage gives the sum of the halves'
// outputs kk, each shifted right by 1, at i = t for even t and i = 15 + t
// for odd t, their difference at the other. Then the twiddle (cplxMpy4_8_0,
// fft.c:113-119), bfly8, to pairs i + 30 k of out.
ACX_HD void n2_8_row(const w32* z, w32* out, int i, const w32* rot) {
  const int t = i < 15 ? i : i - 15;
  const int kk = (t >> 1) + ((t & 1) != 0 ? 8 : 0);
  const bool sum = (i < 15) == ((t & 1) == 0);
  w32 x[16], y[16];
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    const w32* za = z + 2 * (30 * k + kk);
    const w32* zb = za + 2 * 15;
    const w32 r1 = za[0] >> 1, r3 = za[1] >> 1, r2 = zb[0] >> 1, r4 = zb[1] >> 1;
    const w32 a = sum ? add_sat32(r1, r2) : sub_sat32(r1, r2);
    const w32 b = sum ? add_sat32(r3, r4) : sub_sat32(r3, r4);
    if (k == 0 || i == 0) {
      x[2 * k] = a >> 1;
      x[2 * k + 1] = b >> 1;
    } else {
      const int wi = 2 * i + 2 * k * 30 - 60;
      const w32 c = rot[wi], d = rot[wi + 1];
      x[2 * k] = sub_sat32(mpy32_16(a, c), mpy32_16(b, d)) >> 1;
      x[2 * k + 1] = add_sat32(mpy32_16(a, d), mpy32_16(b, c)) >> 1;
    }
  }
  bfly8(x, y);
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    out[2 * (i + 30 * k)] = y[2 * k];
    out[2 * (i + 30 * k) + 1] = y[2 * k + 1];
  }
}

// the pre-scale and pre-twiddle's node k of 120 (dct4_fx.c:38-60), in place
ACX_HD void dct4_pre(w32* a, int k, int ys, const w32* tw) {
  const int p0 = 2 * k, p1 = kDctN - 2 - 2 * k;
  const w32 x0 = shl_sat32(a[p0], ys), x1 = shl_sat32(a[p0 + 1], ys);
  const w32 x2 = shl_sat32(a[p1], ys), x3 = shl_sat32(a[p1 + 1], ys);
  w32 a1, a2, a3, a4;
  cplx2(x3, x0, tw[4 * k], tw[4 * k + 1], &a1, &a2);
  cplx2(x2, x1, tw[4 * k + 2], tw[4 * k + 3], &a3, &a4);
  a[p0] = a2;
  a[p0 + 1] = a1;
  a[p1] = a4;
  a[p1 + 1] = neg_sat32(a3);
}

// the post-twiddle's node t of 120 (dct4_fx.c:80-135): iteration t of the
// reference's loop writes 2t, 479 - 2t, and the (a3, a4) it carries to the
// next iteration lands at 2t + 1, 478 - 2t. Node t's four outputs go out as
// the pairs 2t and 478 - 2t of the row; their words join the headroom's ORs.
ACX_HD void dct4_post(const w32* F, int t, const w32* sin, i64* out, uint32_t& norm_or,
                      uint32_t& value_or) {
  auto s = [&](int idx, int c) { return sin[2 * idx + c]; };
  w32 a1, a2, a3, a4, o0, o1, o2, o3;   // the outputs 2t, 2t + 1, 478 - 2t, 479 - 2t
  if (t == 0) {
    cplx2(F[kDctN - 2], F[kDctN - 1], s(2, 0), s(2, 1), &a3, &a4);
    o0 = F[0] >> 1;
    o1 = a3;
    o2 = a4;
    o3 = neg_sat32(F[1] >> 1);
  } else if (t < kDctM / 2 - 1) {
    cplx2(F[2 * t + 1], F[2 * t], s(2 * t, 0), s(2 * t, 1), &a1, &a2);
    cplx2(F[kDctN - 2 - 2 * t], F[kDctN - 1 - 2 * t], s(2 * (t + 1), 0), s(2 * (t + 1), 1), &a3,
          &a4);
    o0 = a2;
    o1 = a3;
    o2 = a4;
    o3 = neg_sat32(a1);
  } else {   // t = 119: outputs 238 (a4), 239, 240, 241 (-a3)
    const int p0 = kDctM - 2, p1 = kDctM;
    cplx2(F[p0 + 1], F[p0], s(p0, 0), s(p0, 1), &a3, &a4);
    a1 = mpy32_16(F[p1], kTwiddle) >> 1;
    a2 = mpy32_16(F[p1 + 1], kTwiddle) >> 1;
    o0 = a4;
    o1 = sub_sat32(a1, a2);
    o2 = add_sat32(a1, a2);
    o3 = neg_sat32(a3);
  }
  store_i64_pair(out + 2 * t, o0, o1);
  store_i64_pair(out + kDctN - 2 - 2 * t, o2, o3);
  norm_or |= norm_word(o0) | norm_word(o1) | norm_word(o2) | norm_word(o3);
  value_or |= static_cast<uint32_t>(o0 | o1 | o2 | o3);
}

// One row: y [480] (Word32 values in int64) and its exponent -> ytda [480],
// y_e, y_s, zero. a, b: 480 words of scratch each; tab: the table pack.
template <class G>
ACX_HD void fx_dct4_row(const G& g, const i64* y, i64 y_e_in, const w32* tab, w32* a, w32* b,
                        i64* ytda, i64* y_e, i64* y_s, bool* zero) {
  // 1. the bandwidth cap, the row as Word32, its headroom
  uint32_t norm_or = 0, value_or = 0;
  g.each_loaded(
      kDctMaxBw / 2, [&](int p) { return load_i64_pair(y + 2 * p); },
      [&](int p, I64Pair v) {
        const w32 v0 = static_cast<w32>(v.x), v1 = static_cast<w32>(v.y);
        a[2 * p] = v0;
        a[2 * p + 1] = v1;
        norm_or |= norm_word(v0) | norm_word(v1);
        value_or |= static_cast<uint32_t>(v0 | v1);
      });
  g.each(kDctN - kDctMaxBw, [&](int i) { a[kDctMaxBw + i] = 0; });
  const int hs = headroom32(g.bor(norm_or), g.bor(value_or));
  const bool is_zero = hs >= 32;
  const int ys = is_zero ? 0 : hs;
  g.sync();
  // 2. the pre-scale and the pre-twiddle
  g.each(kDctM / 2, [&](int k) { dct4_pre(a, k, ys, tab + kDctTw); });
  g.sync();
  // 3. the fft30 columns' fft15 halves
  g.each(16, [&](int q) { fft15_half(a, b, q >> 1, q & 1); });
  g.sync();
  // 4. the radix-8 rows
  g.each(30, [&](int i) { n2_8_row(b, a, i, tab + kDctRot); });
  g.sync();
  // 5. the post-twiddle, out; cfft(240)'s scale 9 and dct_IV's 2, the
  // post-scale rules at N = 480
  norm_or = value_or = 0;
  g.each(kDctM / 2, [&](int t) { dct4_post(a, t, tab + kDctSin, ytda, norm_or, value_or); });
  const int s2 = headroom32(g.bor(norm_or), g.bor(value_or)) - 1;
  if (g.leader()) {
    *y_e = is_zero ? 0 : y_e_in - ys + 11 - (s2 + 3);
    *y_s = s2;
    *zero = is_zero;
  }
}

}  // namespace fx
}  // namespace acx
