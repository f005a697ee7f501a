// The lane function of fx_sns_dec.cu: one frame's fixed-point SNS decode
// (ops/fixed_dev.py:sns_decode_scf, sns_interpolate). Compiles for the card
// and, with g++, for the rehearsal (tests/test_torch_lane_rehearsal.py).
#pragma once

#include "fixed.cuh"

namespace acx {
namespace fx {

// the table pack (kernels.py:fx_sns_table_pack): stage-1 codebooks, the four
// submodes' gains, the isqrt tables and InvLog2_16's two tables
constexpr int kSnsLf = 0, kSnsHf = 256, kSnsGain0 = 512, kSnsIsqQ16 = 530, kSnsIsq = 595,
              kSnsIsqDiff = 627, kSnsInvLog1 = 659, kSnsInvLog2 = 723, kFxSnsTableWords = 787;
// the submodes' gain tables (offset in the pack, length) and largest k
ACX_HD int sns_gain_off(int sm) { return sm == 0 ? 0 : (sm == 1 ? 2 : (sm == 2 ? 6 : 10)); }
ACX_HD int sns_gain_len(int sm) { return sm == 0 ? 2 : (sm == 3 ? 8 : 4); }
ACX_HD int sns_maxk(int sm) { return sm < 2 ? 10 : (sm == 2 ? 8 : 6); }
// scratch words of one lane: h (12), then the 64 interpolated bands
constexpr int kSnsScratch = 12 + 64;

ACX_HD i64 tab_at(const i64* tab, int off, int len, i64 i) {
  return tab[off + clamp64(i, 0, len - 1)];
}

// mpvq_deindex_fx of one (DIM, KVAL) shape (fixed_dev.py:_mpvq_deindex_batch
// on one lane): writes DIM pulses to y, returns ber. h: KVAL + 2 words of
// scratch, indexed at run time (shared memory on the card: a runtime-indexed
// register array read back stale on sm_90a); y is indexed only statically
// once the position loop is unrolled.
template <int DIM, int KVAL>
ACX_HD i64 mpvq_deindex(const i64* h0, i64 ls_ind, i64 index, i64* h, i64* y) {
  constexpr int K = KVAL + 2;
  for (int k = 0; k < K; ++k) h[k] = h0[k];
  const i64 size = 1 + h0[KVAL + 1] + (h0[KVAL] >> 1);
  const i64 ber = (DIM != 1 && index >= size) ? 1 : 0;
  i64 ind = ber ? 0 : index;
  i64 sign = ls_ind != 0 ? -1 : 1;
  i64 k_max = KVAL;
  bool done = false;
#pragma unroll
  for (int pos = 0; pos < DIM; ++pos) {
    i64 out = 0;
    if (!done) {
      if (ind == 0) {
        out = sign >= 0 ? k_max : -k_max;
        done = true;
      } else {
        // k_acc: the number of k <= k_max with h[k] <= ind, less one, clipped
        i64 cnt = 0;
        for (int k = 0; k < K; ++k) cnt += (k <= k_max && h[k] <= ind) ? 1 : 0;
        const i64 k_acc = clamp64(cnt - 1, 0, KVAL);
        const i64 ind2 = ind - h[k_acc];
        const i64 k_delta = k_max - k_acc;
        const bool moved = k_delta != 0;
        if (moved) {
          out = sign >= 0 ? k_delta : -k_delta;
          sign = (ind2 & 1) != 0 ? -1 : 1;
        }
        ind = moved ? (ind2 >> 1) : ind2;
        k_max = moved ? k_acc : k_max;
        // a_bwd over h[0..k_max+1]
        i64 a0 = 0;
        for (int i = 1; i < K; ++i) {
          if (i <= k_max + 1) {
            const i64 a1 = h[i] - a0 - h[i - 1];
            h[i - 1] = a0;
            a0 = a1;
          }
        }
        if (k_max + 1 < K) h[k_max + 1] = a0;
      }
    }
    y[pos] = out;
  }
  return ber;
}

// ISqrt16: (mantissa, exponent) of 1/sqrt
ACX_HD void isqrt16(const i64* tab, i64 mantissa, i64 exponent, i64* m_out, i64* e_out) {
  const i64 pre = norm_s(mantissa);
  const i64 e = exponent - pre;
  const i64 m = shl16(mantissa, pre);
  const i64 idx = mac_r(-32768 - (32LL << 16), m, 1 << 6);
  const i64 frac = m & 0x1FF;
  const i64 m2 = msu_r(tab_at(tab, kSnsIsq, 32, idx), tab_at(tab, kSnsIsqDiff, 32, idx), frac);
  *m_out = (e & 1) == 0 ? mult_r(m2, 0x5A82) : m2;
  *e_out = msu_r(1 << 15, e, 1 << 14);
}

// idct16_fx (dct2_fx.c:120-215), in place on 16 Word16 values
ACX_HD void idct16(i64* v) {
  auto m = [](i64 a, i64 c) { return mult_r(a, c); };
  auto ad = [](i64 a, i64 b) { return sat16(a + b); };
  auto sb = [](i64 a, i64 b) { return sat16(a - b); };
  const i64* i = v;
  i64 a8 = ad(m(i[1], 1136), m(i[15], -11529));
  i64 a9 = ad(m(i[9], 8956), m(i[7], -7350));
  i64 a10 = ad(m(i[5], 5461), m(i[11], -10217));
  i64 a11 = ad(m(i[13], 11086), m(i[3], -3363));
  i64 a12 = ad(m(i[3], 11086), m(i[13], 3363));
  i64 a13 = ad(m(i[11], 5461), m(i[5], 10217));
  i64 a14 = ad(m(i[7], 8956), m(i[9], 7350));
  i64 a15 = ad(m(i[15], 1136), m(i[1], 11529));
  i64 b4 = ad(m(i[2], 2260), m(i[14], -11363));
  i64 b5 = ad(m(i[10], 9633), m(i[6], -6436));
  i64 b6 = ad(m(i[6], 9633), m(i[10], 6436));
  i64 b7 = ad(m(i[14], 2260), m(i[2], 11363));
  i64 b8 = ad(a9, a8);
  i64 b9 = sb(a8, a9);
  i64 b10 = sb(a11, a10);
  i64 b11 = ad(a10, a11);
  i64 b12 = ad(a13, a12);
  i64 b13 = sb(a12, a13);
  i64 b14 = sb(a15, a14);
  i64 b15 = ad(a14, a15);
  i64 a0 = ad(m(i[0], 8192), m(i[8], 8192));
  i64 a1 = ad(m(i[8], -8192), m(i[0], 8192));
  i64 a2 = ad(m(i[4], 4433), m(i[12], -10703));
  i64 a3 = ad(m(i[12], 4433), m(i[4], 10703));
  i64 a4 = ad(b5, b4);
  i64 a5 = sb(b4, b5);
  i64 a6 = sb(b7, b6);
  i64 a7 = ad(b6, b7);
  a8 = b8;
  a9 = ad(m(b9, -30274), m(b14, 12540));
  a10 = ad(m(b10, -12540), m(b13, -30274));
  a11 = b11;
  a12 = b12;
  a13 = ad(m(b13, 12540), m(b10, -30274));
  a14 = ad(m(b14, 30274), m(b9, 12540));
  a15 = b15;
  i64 b0 = ad(a3, a0);
  i64 b1 = ad(a2, a1);
  i64 b2 = sb(a1, a2);
  i64 b3 = sb(a0, a3);
  b4 = a4;
  b5 = ad(m(a5, -23170), m(a6, 23170));
  b6 = ad(m(a6, 23170), m(a5, 23170));
  b7 = a7;
  b8 = ad(a11, a8);
  b9 = ad(a10, a9);
  b10 = sb(a9, a10);
  b11 = sb(a8, a11);
  b12 = sb(a15, a12);
  b13 = sb(a14, a13);
  b14 = ad(a13, a14);
  b15 = ad(a12, a15);
  a0 = ad(b7, b0);
  a1 = ad(b6, b1);
  a2 = ad(b5, b2);
  a3 = ad(b4, b3);
  a4 = sb(b3, b4);
  a5 = sb(b2, b5);
  a6 = sb(b1, b6);
  a7 = sb(b0, b7);
  a10 = ad(m(b10, -23170), m(b13, 23170));
  a11 = ad(m(b11, -23170), m(b12, 23170));
  a12 = ad(m(b12, 23170), m(b11, 23170));
  a13 = ad(m(b13, 23170), m(b10, 23170));
  const i64 o[16] = {ad(b15, a0), ad(b14, a1), ad(a13, a2), ad(a12, a3),
                     ad(a11, a4), ad(a10, a5), ad(b9, a6), ad(b8, a7),
                     sb(a7, b8), sb(a6, b9), sb(a5, a10), sb(a4, a11),
                     sb(a3, a12), sb(a2, a13), sb(a1, b14), sb(a0, b15)};
#pragma unroll
  for (int k = 0; k < 16; ++k) v[k] = o[k];
}

// One lane: scf_idx[7] -> scf[n_bands], scf_e[n_bands] (stride `os` between
// bands). Only the de-index of the lane's submode runs (the plain version
// runs all four and selects; the results are the same). scratch:
// kSnsScratch words.
ACX_HD void fx_sns_dec_lane(const int32_t* idx, const i64* tab, int n_bands, i64* scratch,
                            i64* scf, i64* scf_e, int os) {
  const i64 idx0 = idx[0], idx1 = idx[1], submode = idx[2], gidx = idx[3], ls = idx[4],
            mpvq = idx[5], idxB = idx[6];
  const int sm = static_cast<int>(clamp64(submode, 0, 3));
  // the MPVQ offsets h[0..k+1] mpvq_deindex_fx starts from, per (dim, k) of
  // the submodes' shapes: the exact recurrence of fixed_dec.py:_pascal_A,
  // h[k+1] halved where k is below the tabled maximum
  // (fixed_dev.py:mpvq_offsets)
  const i64 h10k10[12] = {0, 1, 19, 181, 1159, 5641, 22363, 75517, 224143, 598417, 1462563,
                          1658722};
  const i64 h6k1[3] = {0, 1, 5};
  const i64 h16k8[10] = {0, 1, 31, 481, 4991, 39041, 246047, 1303777, 5984767, 12165888};
  const i64 h16k6[8] = {0, 1, 31, 481, 4991, 39041, 246047, 651888};
  i64 y[16];
  i64* h = scratch;
  // the plain version's where-chain: submode 0, 1, 2, else 3 (unclipped)
  if (submode == 0) {
    mpvq_deindex<10, 10>(h10k10, ls, mpvq, h, y);
    mpvq_deindex<6, 1>(h6k1, idxB & 1, idxB >> 1, h, y + 10);
  } else if (submode == 1) {
    mpvq_deindex<10, 10>(h10k10, ls, mpvq, h, y);
#pragma unroll
    for (int k = 10; k < 16; ++k) y[k] = 0;
  } else if (submode == 2) {
    mpvq_deindex<16, 8>(h16k8, ls, mpvq, h, y);
  } else {
    mpvq_deindex<16, 6>(h16k6, ls, mpvq, h, y);
  }
  // pvq_dec_en1_normQ14_fx with the submode's k_val_max
  i64 L_yy = 0;
#pragma unroll
  for (int k = 0; k < 16; ++k) L_yy += y[k] * y[k];
  i64 iq;
  if (L_yy < 64) {
    iq = tab_at(tab, kSnsIsqQ16, 65, clamp64(L_yy, 0, 63));
  } else {
    i64 t2, e2;
    isqrt16(tab, L_yy & 0xFFFF, 15, &t2, &e2);
    iq = shl16(t2, e2 + 1);
  }
  const i64 shift_num = norm_s(sns_maxk(sm));
#pragma unroll
  for (int k = 0; k < 16; ++k)
    y[k] = round_fx(L_shl(L_mult(iq, shl16(y[k], shift_num)), 13 - shift_num));
  idct16(y);
  const i64 gval = tab_at(tab, kSnsGain0 + sns_gain_off(sm), sns_gain_len(sm), gidx);
  i64 q[16];
#pragma unroll
  for (int k = 0; k < 16; ++k) {
    const i64 base = k < 8 ? tab[kSnsLf + clamp64(idx0, 0, 31) * 8 + k]
                           : tab[kSnsHf + clamp64(idx1, 0, 31) * 8 + (k - 8)];
    q[k] = sat16(base + mult_r(gval, y[k]));
  }
  // processSnsInterpolateScf_fx into the 64 band words of the scratch
  i64* c = scratch + 12;
  c[0] = q[0];
  c[1] = q[0];
  i64 tmp2 = 0;
#pragma unroll
  for (int i = 1; i < 16; ++i) {
    const i64 d = sat16(q[i] - q[i - 1]);
    tmp2 = mult_r(d, 8192);
    const i64 tmp = mult_r(d, 4096);
    c[i * 4 - 2] = sat16(q[i - 1] + tmp);
    c[i * 4 - 1] = sat16(c[i * 4 - 2] + tmp2);
    c[i * 4] = sat16(c[i * 4 - 1] + tmp2);
    c[i * 4 + 1] = sat16(c[i * 4] + tmp2);
  }
  c[62] = sat16(c[61] + tmp2);
  c[63] = sat16(c[62] + tmp2);
  if (n_bands < 32) {
    // every read index (4i+3 < 4t, 4t+2i+1 < 2 n_bands) lies above every
    // written one, so the in-place update reads the original values
    const int t = 32 - n_bands;
    for (int i = 0; i < t; ++i)
      c[i] = sat16(mac_r(L_mult(c[4 * i], 8192), c[4 * i + 1], 8192) +
                   mac_r(L_mult(c[4 * i + 2], 8192), c[4 * i + 3], 8192));
    for (int i = 0; i < n_bands - t; ++i)
      c[t + i] = mac_r(L_mult(c[4 * t + 2 * i], 16384), c[4 * t + 2 * i + 1], 16384);
  } else if (n_bands < 64) {
    const int t = 64 - n_bands;
    for (int i = 0; i < t; ++i) c[i] = mac_r(L_mult(c[2 * i], 16384), c[2 * i + 1], 16384);
    for (int i = t; i < n_bands; ++i) c[i] = c[t + i];
  }
  // BASOP_Util_InvLog2_16
  for (int b = 0; b < n_bands; ++b) {
    const i64 x = c[b];
    const i64 t1 = (x & 2047) >> 5;
    const i64 t2 = (x & 31) << 4;
    scf[b * os] = mac_r(tab_at(tab, kSnsInvLog1, 64, t1), tab_at(tab, kSnsInvLog2, 64, t1), t2);
    scf_e[b * os] = (x >> 11) + 1;
  }
}

}  // namespace fx
}  // namespace acx
