// The steps of fx_dct4.cu: the fixed-point DCT-IV of one 480-point row
// (ops/fixed_dev.py:batch_dct4_plain over ops/fixed_imdct.py:dct_IV and the
// cfft of 240 points, fftN2_8 over fft30 columns), written once over the
// group of threads that runs it (fixed.cuh: a block on the card, one thread
// in the rehearsal, tests/test_torch_lane_rehearsal.py).
//
// Each stage reads one buffer and writes the other, so its nodes are
// independent and run in parallel, a group sync between stages: the
// pre-twiddle (120 nodes of 4 values), 8 fft30 columns, 30 twiddled radix-8
// rows, the post-twiddle (120 nodes; the reference's loop carries only
// values it read before writing, so each node's outputs follow from the
// transform's output alone).
#pragma once

#include "fixed.cuh"

namespace acx {
namespace fx {

constexpr int kDctN = 480, kDctM = 240, kDctMaxBw = 400;
// the table pack (kernels.py:fx_dct4_table_pack): SineWindow480 [240][2],
// SineTable480 [241][2], RotVector_480 [900]
constexpr int kDctTw = 0, kDctSin = 480, kDctRot = 962, kFxDctTableWords = 1862;
// FFT constants (fft.c:53-90, WORD322WORD16 of the Word32 values)
constexpr i64 kC31 = -28378, kC51 = 31164, kC52 = -25212, kC53 = -11904, kC54 = 18318,
              kC55 = -20480, kC81 = 23170, kC82 = -23170, kTwiddle = 23170;

ACX_HD void cplx2(i64 a, i64 b, i64 c, i64 d, i64* re, i64* im) {
  *re = lsub(mpy_32_16(a, c) >> 1, mpy_32_16(b, d) >> 1);
  *im = ladd(mpy_32_16(a, d) >> 1, mpy_32_16(b, c) >> 1);
}

// 5-point butterfly (fft.c:215-231): (y0, r1, r3, r4, r2)
ACX_HD void core5(const i64* x, i64* o) {
  i64 r1 = ladd(x[1], x[4]), r4 = lsub(x[1], x[4]);
  i64 r3 = ladd(x[2], x[3]), r2 = lsub(x[2], x[3]);
  i64 t = mpy_32_16(lsub(r1, r3), kC54);
  r1 = ladd(r1, r3);
  const i64 y0 = ladd(x[0], r1);
  r1 = ladd(y0, L_shl(mpy_32_16(r1, kC55), 1));
  r3 = lsub(r1, t);
  r1 = ladd(r1, t);
  t = mpy_32_16(ladd(r4, r2), kC51);
  r4 = ladd(t, L_shl(mpy_32_16(r4, kC52), 1));
  r2 = ladd(t, mpy_32_16(r2, kC53));
  o[0] = y0;
  o[1] = r1;
  o[2] = r3;
  o[3] = r4;
  o[4] = r2;
}

// FFT5 on 5 pairs (re[], im[]) with the Word16 constants (fft.c:261-277)
ACX_HD void fft5_pairs(const i64* re, const i64* im, i64* ore, i64* oim) {
  i64 rr[5], ss[5];
  core5(re, rr);
  core5(im, ss);
  ore[0] = rr[0];
  oim[0] = ss[0];
  ore[1] = ladd(rr[1], ss[4]);
  oim[1] = lsub(ss[1], rr[4]);
  ore[2] = lsub(rr[2], ss[3]);
  oim[2] = ladd(ss[2], rr[3]);
  ore[3] = ladd(rr[2], ss[3]);
  oim[3] = lsub(ss[2], rr[3]);
  ore[4] = lsub(rr[1], ss[4]);
  oim[4] = ladd(ss[1], rr[4]);
}

// 3 FFT5 + 5 FFT3 of fft15/fft30 (fft.c:656-913)
ACX_HD void fft15_core(const i64* re, const i64* im, i64* ore, i64* oim) {
  constexpr int slots[5][3] = {{0, 10, 5}, {6, 1, 11}, {12, 7, 2}, {3, 13, 8}, {9, 4, 14}};
  i64 br[15], bi[15];
  for (int j = 0; j < 3; ++j) fft5_pairs(re + 5 * j, im + 5 * j, br + 5 * j, bi + 5 * j);
  for (int k = 0; k < 5; ++k) {
    const i64 ar = br[k], ai = bi[k], b_r = br[5 + k], b_i = bi[5 + k], cr = br[10 + k],
              ci = bi[10 + k];
    i64 r1 = ladd(b_r, cr);
    const i64 r2 = mpy_32_16(lsub(b_r, cr), kC31);
    const i64 o0r = ladd(ar, r1);
    r1 = lsub(ar, r1 >> 1);
    i64 s1 = ladd(b_i, ci);
    const i64 s2 = mpy_32_16(lsub(b_i, ci), kC31);
    const i64 o0i = ladd(ai, s1);
    s1 = lsub(ai, s1 >> 1);
    ore[slots[k][0]] = o0r;
    oim[slots[k][0]] = o0i;
    ore[slots[k][1]] = lsub(r1, s2);
    oim[slots[k][1]] = ladd(s1, r2);
    ore[slots[k][2]] = ladd(r1, s2);
    oim[slots[k][2]] = lsub(s1, r2);
  }
}

// fft30 (fft.c:1791-2583) of column c: inputs the pairs c + 8j of `in`
// (interleaved re, im), j = 0..29; outputs pair i at out[2 (30 c + i)]
ACX_HD void fft30_col(const i64* in, i64* out, int c) {
  constexpr int loadA[15] = {0, 18, 6, 24, 12, 20, 8, 26, 14, 2, 10, 28, 16, 4, 22};
  constexpr int loadB[15] = {15, 3, 21, 9, 27, 5, 23, 11, 29, 17, 25, 13, 1, 19, 7};
  constexpr int pair30[15] = {0, 8, 1, 9, 2, 10, 3, 11, 4, 12, 5, 13, 6, 14, 7};
  i64 ar[15], ai[15], br[15], bi[15], zar[15], zai[15], zbr[15], zbi[15];
  for (int j = 0; j < 15; ++j) {
    const int qa = c + 8 * loadA[j], qb = c + 8 * loadB[j];
    ar[j] = in[2 * qa] >> 5;
    ai[j] = in[2 * qa + 1] >> 5;
    br[j] = in[2 * qb] >> 5;
    bi[j] = in[2 * qb + 1] >> 5;
  }
  fft15_core(ar, ai, zar, zai);
  fft15_core(br, bi, zbr, zbi);
  i64* o = out + 2 * 30 * c;
  for (int t = 0; t < 15; ++t) {
    const int k = pair30[t];
    const i64 r1 = zar[k] >> 1, r3 = zai[k] >> 1, r2 = zbr[k] >> 1, r4 = zbi[k] >> 1;
    const int ia = t % 2 == 0 ? t : 15 + t, is = t % 2 == 0 ? 15 + t : t;
    o[2 * ia] = ladd(r1, r2);
    o[2 * ia + 1] = ladd(r3, r4);
    o[2 * is] = lsub(r1, r2);
    o[2 * is + 1] = lsub(r3, r4);
  }
}

// radix-8 butterfly of fftN2's second stage with the SCALEFACTORN2 - 1 = 2
// shifts (fft.c:3492-3600); x: 8 pairs interleaved, y: 8 pairs
ACX_HD void bfly8(const i64* x, i64* y) {
  auto ps = [](i64 v) { return v >> 2; };
  const i64 t00 = ps(ladd(x[0], x[8])), t02 = ps(lsub(x[0], x[8]));
  const i64 t01 = ps(ladd(x[1], x[9])), t03 = ps(lsub(x[1], x[9]));
  const i64 t04 = ps(ladd(x[2], x[10])), t06 = lsub(x[2], x[10]);
  const i64 t05 = ps(ladd(x[3], x[11])), t07 = lsub(x[3], x[11]);
  const i64 t08 = ps(ladd(x[4], x[12])), t10 = ps(lsub(x[4], x[12]));
  const i64 t09 = ps(ladd(x[5], x[13])), t11 = ps(lsub(x[5], x[13]));
  const i64 t12 = ps(ladd(x[6], x[14])), t14 = lsub(x[6], x[14]);
  const i64 t13 = ps(ladd(x[7], x[15])), t15 = lsub(x[7], x[15]);
  const i64 s00 = ladd(t00, t08), s04 = lsub(t00, t08);
  const i64 s01 = ladd(t01, t09), s05 = lsub(t01, t09);
  const i64 s08 = lsub(t02, t11), s10 = ladd(t02, t11);
  const i64 s09 = ladd(t03, t10), s11 = lsub(t03, t10);
  const i64 s02 = ladd(t04, t12), s07 = lsub(t04, t12);
  const i64 s03 = ladd(t05, t13), s06 = lsub(t13, t05);
  const i64 ta = ps(ladd(t06, t14)), tb = ps(lsub(t06, t14));
  const i64 tc = ps(ladd(t07, t15)), td = ps(lsub(t07, t15));
  const i64 s12 = mpy_32_16(ladd(tc, tb), kC81);
  const i64 s14 = mpy_32_16(lsub(tc, tb), kC81);
  const i64 s13 = mpy_32_16(lsub(td, ta), kC81);
  const i64 s15 = mpy_32_16(ladd(ta, td), kC82);
  const i64 r[16] = {ladd(s00, s02), ladd(s01, s03), ladd(s10, s12), ladd(s11, s13),
                     lsub(s04, s06), lsub(s05, s07), ladd(s08, s14), ladd(s09, s15),
                     lsub(s00, s02), lsub(s01, s03), lsub(s10, s12), lsub(s11, s13),
                     ladd(s04, s06), ladd(s05, s07), lsub(s08, s14), lsub(s09, s15)};
  for (int k = 0; k < 16; ++k) y[k] = r[k];
}

// row i of fftN2_8(dim1 30, RotVector_480, sc 2, Woff 60): the 8 column
// outputs i of `in` (fft30_col's layout), twiddled (cplxMpy4_8_0,
// fft.c:113-119), through bfly8, to the pairs i + 30 k of out
ACX_HD void n2_8_row(const i64* in, i64* out, int i, const i64* rot) {
  i64 x[16], y[16];
  for (int k = 0; k < 8; ++k) {
    const i64 a = in[2 * (30 * k + i)], b = in[2 * (30 * k + i) + 1];
    if (k == 0 || i == 0) {
      x[2 * k] = a >> 1;
      x[2 * k + 1] = b >> 1;
    } else {
      const int wi = 2 * i + 2 * k * 30 - 60;
      const i64 c = rot[wi], d = rot[wi + 1];
      x[2 * k] = lsub(mpy_32_16(a, c), mpy_32_16(b, d)) >> 1;
      x[2 * k + 1] = ladd(mpy_32_16(a, d), mpy_32_16(b, c)) >> 1;
    }
  }
  bfly8(x, y);
  for (int k = 0; k < 8; ++k) {
    out[2 * (i + 30 * k)] = y[2 * k];
    out[2 * (i + 30 * k) + 1] = y[2 * k + 1];
  }
}

// the pre-twiddle's node k of 120 (dct4_fx.c:38-60)
ACX_HD void dct4_pre(const i64* in, i64* out, int k, const i64* tw) {
  const int p0 = 2 * k, p1 = kDctN - 2 - 2 * k;
  i64 a1, a2, a3, a4;
  cplx2(in[p1 + 1], in[p0], tw[2 * (2 * k)], tw[2 * (2 * k) + 1], &a1, &a2);
  cplx2(in[p1], in[p0 + 1], tw[2 * (2 * k + 1)], tw[2 * (2 * k + 1) + 1], &a3, &a4);
  out[p0] = a2;
  out[p0 + 1] = a1;
  out[p1] = a4;
  out[p1 + 1] = lneg(a3);
}

// the post-twiddle's node t of 120 (dct4_fx.c:80-135): iteration t of the
// reference's loop writes 2t, 479 - 2t, and the (a3, a4) it carries to the
// next iteration lands at 2t + 1, 478 - 2t
ACX_HD void dct4_post(const i64* F, i64* out, int t, const i64* sin) {
  auto s = [&](int idx, int c) { return sin[2 * idx + c]; };
  i64 a1, a2, a3, a4;
  if (t == 0) {
    out[0] = F[0] >> 1;
    out[kDctN - 1] = lneg(F[1] >> 1);
    cplx2(F[kDctN - 2], F[kDctN - 1], s(2, 0), s(2, 1), &a3, &a4);
    out[1] = a3;
    out[kDctN - 2] = a4;
  } else if (t < kDctM / 2 - 1) {
    cplx2(F[2 * t + 1], F[2 * t], s(2 * t, 0), s(2 * t, 1), &a1, &a2);
    out[kDctN - 1 - 2 * t] = lneg(a1);
    out[2 * t] = a2;
    cplx2(F[kDctN - 2 - 2 * t], F[kDctN - 1 - 2 * t], s(2 * (t + 1), 0), s(2 * (t + 1), 1), &a3,
          &a4);
    out[2 * t + 1] = a3;
    out[kDctN - 2 - 2 * t] = a4;
  } else {
    const int p0 = kDctM - 2, p1 = kDctM;
    cplx2(F[p0 + 1], F[p0], s(p0, 0), s(p0, 1), &a3, &a4);
    a1 = mpy_32_16(F[p1], kTwiddle) >> 1;
    a2 = mpy_32_16(F[p1 + 1], kTwiddle) >> 1;
    out[p1] = ladd(a1, a2);
    out[p0 + 1] = lsub(a1, a2);
    out[p1 + 1] = lneg(a3);
    out[p0] = a4;
  }
}

// getScaleFactor32_0 of a row: the least norm_l of its nonzero values, 32
// if it is all zero
template <class G>
ACX_HD i64 headroom32_0(const G& g, const i64* x, int n) {
  i64 m = 32;
  g.each(n, [&](int i) {
    if (x[i] != 0) m = min64(m, norm_l(x[i]));
  });
  return g.min(m);
}

// One row: y [480] and its exponent -> ytda [480], y_e, y_s, zero.
// a, b: 480 words of scratch each.
template <class G>
ACX_HD void fx_dct4_row(const G& g, const i64* y, i64 y_e_in, const i64* tab, i64* a, i64* b,
                        i64* ytda, i64* y_e, i64* y_s, bool* zero) {
  // the bandwidth cap, the headroom pre-scale
  g.each(kDctN, [&](int i) { a[i] = i < kDctMaxBw ? y[i] : 0; });
  g.sync();
  const i64 hs = headroom32_0(g, a, kDctN);
  const bool is_zero = hs >= 32;
  const i64 ys = is_zero ? 0 : hs;
  g.each(kDctN, [&](int i) { b[i] = L_shl(a[i], ys); });
  g.sync();
  g.each(kDctM / 2, [&](int k) { dct4_pre(b, a, k, tab + kDctTw); });
  g.sync();
  g.each(8, [&](int c) { fft30_col(a, b, c); });
  g.sync();
  g.each(30, [&](int i) { n2_8_row(b, a, i, tab + kDctRot); });
  g.sync();
  g.each(kDctM / 2, [&](int t) { dct4_post(a, b, t, tab + kDctSin); });
  g.sync();
  // cfft(240)'s scale 9 and dct_IV's 2; the post-scale rules at N = 480
  const i64 s2 = headroom32_0(g, b, kDctN) - 1;
  g.each(kDctN, [&](int i) { ytda[i] = b[i]; });
  if (g.leader()) {
    *y_e = is_zero ? 0 : y_e_in - ys + 11 - (s2 + 3);
    *y_s = s2;
    *zero = is_zero;
  }
}

}  // namespace fx
}  // namespace acx
