// The steps of fx_sns_dec.cu: one frame's fixed-point SNS decode
// (ops/fixed_dev.py:sns_decode_scf, sns_interpolate) on a warp. A template
// over the warp (warp.cuh), so that g++ compiles it for the rehearsal
// (tests/test_torch_snsdec_pc_rehearsal.py, tests/test_torch_lane_rehearsal.py).
//
// Every value is a Word16 or a Word32, so the arithmetic is 32-bit: the
// Word16 operators below saturate where the ITU-T basic operator does, and
// their comments say which inputs can reach the saturation. The plain
// version computes in int64; the integers are the same.
#pragma once

#include "fixed.cuh"
#include "warp.cuh"

namespace acx {
namespace fx {

// the table pack (kernels.py:fx_sns_table_pack), int32 words: stage-1
// codebooks, the four submodes' gains, the isqrt tables, InvLog2_16's two
// tables, then the MPVQ offsets A(n, k) for n = 1..16 (row n - 1), k = 0..10
constexpr int kSnsLf = 0, kSnsHf = 256, kSnsGain0 = 512, kSnsIsqQ16 = 530, kSnsIsq = 595,
              kSnsIsqDiff = 627, kSnsInvLog1 = 659, kSnsInvLog2 = 723, kSnsMpvq = 787;
constexpr int kSnsMpvqCols = 11;
constexpr int kFxSnsTableWords = kSnsMpvq + 16 * kSnsMpvqCols;
// the submodes' gain tables (offset in the pack 0, 2, 6, 10; length 2, 4,
// 4, 8) and largest k (10, 10, 8, 6), sm = 0..3, as arithmetic of
// comparisons. Written as chained selects, the card's build read the wrong
// gain for submodes 1, 2 and 4 (4 clipped to 3) where the gain index was past
// its table, and g++'s build the right one (tests/torch_kernel_cases.py:
// fx_sns_edge_rows)
ACX_HD int sns_gain_off(int sm) { return 4 * sm - 2 + 2 * (sm == 0); }
ACX_HD int sns_gain_len(int sm) { return 2 + 2 * (sm != 0) + 4 * (sm == 3); }
ACX_HD int sns_maxk(int sm) { return 10 - 2 * (sm == 2) - 4 * (sm == 3); }

// ---- Word16 operators in 32 bits ----
ACX_HD int32_t sat16w(int32_t x) { return x > 32767 ? 32767 : (x < -32768 ? -32768 : x); }
// mult_r of two Word16 values: a * b + 0x4000 fits in 32 bits; only
// -32768 * -32768 leaves Word16
ACX_HD int32_t mult_rw(int32_t a, int32_t b) { return sat16w((a * b + 0x4000) >> 15); }
// L_mult of two Word16 values: only -32768 * -32768 saturates
ACX_HD int32_t L_multw(int32_t a, int32_t b) {
  const int32_t p = a * b;
  return p == 0x40000000 ? static_cast<int32_t>(MAX32) : p * 2;
}
// round_fx of a Word32: the sum saturates, the shifted value is a Word16
ACX_HD int32_t round_w(int32_t L) { return add_sat32(L, 0x8000) >> 16; }
ACX_HD int32_t mac_rw(int32_t L, int32_t a, int32_t b) { return round_w(add_sat32(L, L_multw(a, b))); }
ACX_HD int32_t msu_rw(int32_t L, int32_t a, int32_t b) { return round_w(sub_sat32(L, L_multw(a, b))); }
// shl16 of a Word16: a count above 16 saturates every nonzero value as 16
// does, a negative count is an arithmetic shift right clamped to 31
ACX_HD int32_t shl16w(int32_t x, int32_t s) {
  return s >= 0 ? sat16w(static_cast<int32_t>(static_cast<uint32_t>(x) << (s < 16 ? s : 16)))
                : x >> (-s < 31 ? -s : 31);
}
// L_shl of a Word32 by 0..31, saturating
ACX_HD int32_t L_shlw(int32_t x, int s) {
  const int32_t r = static_cast<int32_t>(static_cast<uint32_t>(x) << s);
  return (r >> s) == x ? r : (x < 0 ? static_cast<int32_t>(MIN32) : static_cast<int32_t>(MAX32));
}
ACX_HD int32_t norm_sw(int32_t x) { return static_cast<int32_t>(norm_s(x)); }
ACX_HD int32_t tab_w(const int32_t* tab, int off, int len, int32_t i) {
  return tab[off + (i < 0 ? 0 : (i > len - 1 ? len - 1 : i))];
}

// ISqrt16: (mantissa, exponent) of 1/sqrt, for 64 <= mantissa < 2^15
ACX_HD void isqrt16w(const int32_t* tab, int32_t mantissa, int32_t exponent, int32_t* m_out,
                     int32_t* e_out) {
  const int32_t pre = norm_sw(mantissa);
  const int32_t e = exponent - pre;
  const int32_t m = shl16w(mantissa, pre);
  const int32_t idx = mac_rw(-32768 - (32 << 16), m, 1 << 6);
  const int32_t frac = m & 0x1FF;
  const int32_t m2 = msu_rw(tab_w(tab, kSnsIsq, 32, idx), tab_w(tab, kSnsIsqDiff, 32, idx), frac);
  *m_out = (e & 1) == 0 ? mult_rw(m2, 0x5A82) : m2;
  *e_out = msu_rw(1 << 15, e, 1 << 14);
}

// idct16_fx (dct2_fx.c:120-215) of 16 Word16 values, the output k returned
// (every lane runs the whole butterfly, about 280 operations; k is a lane's
// index, so the outputs are picked by selects, never by a register index).
// Every coefficient c has |c| <= 30274, so |a c + 0x4000| < 2^30 and
// (a c + 0x4000) >> 15 lies in Word16: mult_r's saturation never acts.
ACX_HD int32_t idct16_pick(const int32_t* i, int k) {
  auto m = [](int32_t a, int32_t c) { return (a * c + 0x4000) >> 15; };
  auto ad = [](int32_t a, int32_t b) { return sat16w(a + b); };
  auto sb = [](int32_t a, int32_t b) { return sat16w(a - b); };
  int32_t a8 = ad(m(i[1], 1136), m(i[15], -11529));
  int32_t a9 = ad(m(i[9], 8956), m(i[7], -7350));
  int32_t a10 = ad(m(i[5], 5461), m(i[11], -10217));
  int32_t a11 = ad(m(i[13], 11086), m(i[3], -3363));
  int32_t a12 = ad(m(i[3], 11086), m(i[13], 3363));
  int32_t a13 = ad(m(i[11], 5461), m(i[5], 10217));
  int32_t a14 = ad(m(i[7], 8956), m(i[9], 7350));
  int32_t a15 = ad(m(i[15], 1136), m(i[1], 11529));
  int32_t b4 = ad(m(i[2], 2260), m(i[14], -11363));
  int32_t b5 = ad(m(i[10], 9633), m(i[6], -6436));
  int32_t b6 = ad(m(i[6], 9633), m(i[10], 6436));
  int32_t b7 = ad(m(i[14], 2260), m(i[2], 11363));
  int32_t b8 = ad(a9, a8);
  int32_t b9 = sb(a8, a9);
  int32_t b10 = sb(a11, a10);
  int32_t b11 = ad(a10, a11);
  int32_t b12 = ad(a13, a12);
  int32_t b13 = sb(a12, a13);
  int32_t b14 = sb(a15, a14);
  int32_t b15 = ad(a14, a15);
  int32_t a0 = ad(m(i[0], 8192), m(i[8], 8192));
  int32_t a1 = ad(m(i[8], -8192), m(i[0], 8192));
  int32_t a2 = ad(m(i[4], 4433), m(i[12], -10703));
  int32_t a3 = ad(m(i[12], 4433), m(i[4], 10703));
  int32_t a4 = ad(b5, b4);
  int32_t a5 = sb(b4, b5);
  int32_t a6 = sb(b7, b6);
  int32_t a7 = ad(b6, b7);
  a8 = b8;
  a9 = ad(m(b9, -30274), m(b14, 12540));
  a10 = ad(m(b10, -12540), m(b13, -30274));
  a11 = b11;
  a12 = b12;
  a13 = ad(m(b13, 12540), m(b10, -30274));
  a14 = ad(m(b14, 30274), m(b9, 12540));
  a15 = b15;
  int32_t b0 = ad(a3, a0);
  int32_t b1 = ad(a2, a1);
  int32_t b2 = sb(a1, a2);
  int32_t b3 = sb(a0, a3);
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
  const int32_t o[16] = {ad(b15, a0), ad(b14, a1), ad(a13, a2), ad(a12, a3),
                         ad(a11, a4), ad(a10, a5), ad(b9, a6), ad(b8, a7),
                         sb(a7, b8), sb(a6, b9), sb(a5, a10), sb(a4, a11),
                         sb(a3, a12), sb(a2, a13), sb(a1, b14), sb(a0, b15)};
  int32_t r = o[0];
#pragma unroll
  for (int j = 1; j < 16; ++j) r = k == j ? o[j] : r;
  return r;
}

// The MPVQ offsets lane j reads: A(n, min(j, 10)) for n = 1..16 (row n - 1).
struct SnsMpvqColumn {
  int32_t a[16];
};

// mpvq_deindex_fx of the shape (DIM, KVAL) (fixed_dev.py:_mpvq_deindex_batch)
// on a warp, its pulses on lanes OFF .. OFF + DIM - 1 of y. The plain
// version carries the offsets h and updates them after each position by the
// a_bwd recurrence; on every entry a position counts (k <= k_max), h at
// position pos holds A(DIM - pos, k), the offsets of the remaining length,
// whatever path the index took (tests/test_torch_snsdec_pc_rehearsal.py
// holds the table to the recurrence). So lane j <= KVAL holds A(DIM - pos, j)
// from the table, a ballot counts the offsets at or below the index, and the
// chosen offset comes from its lane by a shuffle: one uniform chain.
// SIZE: the shape's set size, 1 + U(KVAL + 1) + A(KVAL) / 2 (the index is
// out of range, ber, at or above it and then de-indexes as 0).
template <int DIM, int KVAL, int OFF, int SIZE, class W>
ACX_HD void sns_deindex_warp(const W& w, int32_t ls_ind, int32_t index,
                             const typename W::template Lanes<SnsMpvqColumn>& col,
                             typename W::template Lanes<int>& y) {
  using IL = typename W::template Lanes<int>;
  int32_t ind = index >= SIZE ? 0 : index;
  int32_t sign = ls_ind != 0 ? -1 : 1;
  int32_t k_max = KVAL;
  bool done = false;
#pragma unroll
  for (int pos = 0; pos < DIM; ++pos) {
    int32_t out = 0;
    if (!done) {
      if (ind == 0) {
        out = sign >= 0 ? k_max : -k_max;
        done = true;
      } else {
        IL a, ge;
        w.lanes([&](int j) {
          a[j] = col[j].a[DIM - pos - 1];
          ge[j] = j <= k_max && a[j] <= ind ? 1 : 0;
        });
        // the count of k <= k_max with h[k] <= ind, less one, clipped
        const int32_t cnt = popc32(w.ballot(ge));
        const int32_t k_acc = cnt - 1 < 0 ? 0 : (cnt - 1 > KVAL ? KVAL : cnt - 1);
        const int32_t ind2 = ind - w.shfl(a, k_acc);
        const int32_t k_delta = k_max - k_acc;
        if (k_delta != 0) {
          out = sign >= 0 ? k_delta : -k_delta;
          sign = (ind2 & 1) != 0 ? -1 : 1;
          ind = ind2 >> 1;
          k_max = k_acc;
        } else {
          ind = ind2;
        }
      }
    }
    w.lanes([&](int j) { y[j] = j == OFF + pos ? out : y[j]; });
  }
}

// One frame: scf_idx[7] -> scf[n_bands], scf_e[n_bands] (int64), on a warp.
//  1. the submode's de-index (a warp-uniform branch: a warp is one frame),
//     position i on lane i;
//  2. pvq_dec_en1_normQ14_fx: the energy a warp sum, lane k its pulse;
//  3. the idct whole on every lane, lane k (mod 16) keeping output k, and the
//     stage-1 vector and gain over it: q[k] on lane k;
//  4. the interpolation: lane i (1-15) bands 4i-2 .. 4i+1 from q[i-1] and
//     q[i], lane 0 bands 0-1, lane 15 also 62-63, into the warp's 64 band
//     words c (shared memory on the card), then the n_bands < 64 folds, each
//     lane reading its sources before any lane writes;
//  5. InvLog2 on bands l and l + 32 on lane l, each output row written by the
//     warp in one coalesced store.
template <class W>
ACX_HD void fx_sns_dec_warp(const W& w, const int32_t* idx, const int32_t* tab, int n_bands,
                            int32_t* c, i64* scf, i64* scf_e) {
  using IL = typename W::template Lanes<int>;
  typename W::template Lanes<SnsMpvqColumn> col;
  IL iv, y;
  w.lanes([&](int j) {
    iv[j] = j < 7 ? idx[j] : 0;
#pragma unroll
    for (int r = 0; r < 16; ++r)
      col[j].a[r] = tab[kSnsMpvq + r * kSnsMpvqCols + (j < kSnsMpvqCols ? j : kSnsMpvqCols - 1)];
    y[j] = 0;
  });
  const int32_t idx0 = w.shfl(iv, 0), idx1 = w.shfl(iv, 1), submode = w.shfl(iv, 2),
                gidx = w.shfl(iv, 3), ls = w.shfl(iv, 4), mpvq = w.shfl(iv, 5), idxB = w.shfl(iv, 6);
  const int sm = imin(imax(submode, 0), 3);
  // the plain version's where-chain: submode 0, 1, 2, else 3 (unclipped)
  if (submode == 0 || submode == 1) {
    sns_deindex_warp<10, 10, 0, 2390004>(w, ls, mpvq, col, y);
    if (submode == 0) sns_deindex_warp<6, 1, 10, 6>(w, idxB & 1, idxB >> 1, col, y);
  } else if (submode == 2) {
    sns_deindex_warp<16, 8, 0, 15158272>(w, ls, mpvq, col, y);
  } else {
    sns_deindex_warp<16, 6, 0, 774912>(w, ls, mpvq, col, y);
  }
  // the pulses' energy: at most 10^2 + 1^2 (a shape's pulses sum to at most
  // its KVAL), so the isqrt's mantissa is the energy itself
  typename W::template Lanes<unsigned> sq;
  w.lanes([&](int j) { sq[j] = static_cast<unsigned>(y[j] * y[j]); });
  const int32_t L_yy = static_cast<int32_t>(w.reduce_add(sq));
  int32_t iq;
  if (L_yy < 64) {
    iq = tab_w(tab, kSnsIsqQ16, 65, L_yy);
  } else {
    int32_t t2, e2;
    isqrt16w(tab, L_yy & 0xFFFF, 15, &t2, &e2);
    iq = shl16w(t2, e2 + 1);
  }
  const int32_t shift_num = norm_sw(sns_maxk(sm));
  IL en1;
  w.lanes([&](int j) {
    en1[j] = round_w(L_shlw(L_multw(iq, shl16w(y[j], shift_num)), 13 - shift_num));
  });
  int32_t v[16];
#pragma unroll
  for (int k = 0; k < 16; ++k) v[k] = w.shfl(en1, k);
  const int32_t gval = tab[kSnsGain0 + sns_gain_off(sm) + imin(imax(gidx, 0), sns_gain_len(sm) - 1)];
  const int32_t i0 = idx0 < 0 ? 0 : (idx0 > 31 ? 31 : idx0);
  const int32_t i1 = idx1 < 0 ? 0 : (idx1 > 31 ? 31 : idx1);
  IL q;
  w.lanes([&](int j) {
    const int k = j & 15;
    const int32_t base = k < 8 ? tab[kSnsLf + i0 * 8 + k] : tab[kSnsHf + i1 * 8 + (k - 8)];
    q[j] = sat16w(base + mult_rw(gval, idct16_pick(v, k)));
  });
  // processSnsInterpolateScf_fx into the band words
  const IL qp = w.shfl_up(q, 1);
  w.lanes([&](int j) {
    if (j == 0) {
      c[0] = q[j];
      c[1] = q[j];
    } else if (j < 16) {
      const int32_t d = sat16w(q[j] - qp[j]);
      const int32_t tmp2 = mult_rw(d, 8192);
      const int32_t tmp = mult_rw(d, 4096);
      const int32_t b0 = sat16w(qp[j] + tmp);
      const int32_t b1 = sat16w(b0 + tmp2);
      const int32_t b2 = sat16w(b1 + tmp2);
      const int32_t b3 = sat16w(b2 + tmp2);
      c[j * 4 - 2] = b0;
      c[j * 4 - 1] = b1;
      c[j * 4] = b2;
      c[j * 4 + 1] = b3;
      if (j == 15) {
        c[62] = sat16w(b3 + tmp2);
        c[63] = sat16w(c[62] + tmp2);
      }
    }
  });
  w.sync();
  if (n_bands < 32) {
    // band l from the originals: 4 of them for l < t, 2 above
    const int t = 32 - n_bands;
    IL nv;
    w.lanes([&](int j) {
      nv[j] = 0;
      if (j < t) {
        nv[j] = sat16w(mac_rw(L_multw(c[4 * j], 8192), c[4 * j + 1], 8192) +
                       mac_rw(L_multw(c[4 * j + 2], 8192), c[4 * j + 3], 8192));
      } else if (j < n_bands) {
        const int i = j - t;
        nv[j] = mac_rw(L_multw(c[4 * t + 2 * i], 16384), c[4 * t + 2 * i + 1], 16384);
      }
    });
    w.sync();
    w.lanes([&](int j) {
      if (j < n_bands) c[j] = nv[j];
    });
    w.sync();
  } else if (n_bands < 64) {
    // bands l and l + 32: pairs below t, the bands t above them after
    const int t = 64 - n_bands;
    IL lo, hi;
    w.lanes([&](int j) {
      const int o0 = j, o1 = j + 32;
      lo[j] = o0 < t ? mac_rw(L_multw(c[2 * o0], 16384), c[2 * o0 + 1], 16384)
                     : (o0 < n_bands ? c[t + o0] : 0);
      hi[j] = o1 < t ? mac_rw(L_multw(c[2 * o1], 16384), c[2 * o1 + 1], 16384)
                     : (o1 < n_bands ? c[t + o1] : 0);
    });
    w.sync();
    w.lanes([&](int j) {
      if (j < n_bands) c[j] = lo[j];
      if (j + 32 < n_bands) c[j + 32] = hi[j];
    });
    w.sync();
  }
  // BASOP_Util_InvLog2_16 of bands l and l + 32
  w.lanes([&](int j) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int b = j + 32 * h;
      if (b < n_bands) {
        const int32_t x = c[b];
        const int32_t t1 = (x & 2047) >> 5;
        const int32_t t2 = (x & 31) << 4;
        scf[b] = mac_rw(tab[kSnsInvLog1 + t1], tab[kSnsInvLog2 + t1], t2);
        scf_e[b] = (x >> 11) + 1;
      }
    }
  });
}

}  // namespace fx
}  // namespace acx
