// The SNS quantizer's encoder on a warp (sns_vq_enc.cu, K5), one stream a
// warp: process_snsQuantizesScf_Enc as ops/sns.py:sns_vq_enc_plain orders it.
//
// The steps and their lanes:
//  1. the two stage-1 searches: lane j the distance of codebook entry j to
//     each half of the scale factors (8 terms, left to right), then a
//     first-argmin tree of shuffles on (distance, entry), the lower entry
//     winning ties. The distances are sums of squares, never NaN on the
//     inputs the plain version takes, so < is a total order on them and the
//     tree finds the scan's first minimum;
//  2. the residual's DCT-II: lane n output n, a 16-term chain, k ascending;
//  3. the four pulse searches at once, a group of 8 lanes each (A: 10
//     pulses in 10 lanes; B: 1 in the 6-lane tail; near: 8 in 16; far: 6 in
//     16). Lane r of a group holds positions r and r + 8: it computes their
//     (xy + xa)^2 and yy + y for each pulse, and every lane of the group then
//     scans the 16 positions in order against the running best, as the
//     plain version does. The scan stays a scan: rounded cross-products are
//     not transitive, and a tree of comparisons can pick another pulse;
//  4. the near and far shapes' DCT-IIs (lane n output n of one, lane 16 + n
//     of the other), then the 18 gain candidates a lane each (lanes 0-5 the
//     split and low-band gains, 8-11 the near shape's, 16-23 the far
//     shape's), each error a 16-term chain, and a first-argmin tree in each
//     group of 8 lanes;
//  5. the split choice's shape over its gain, its DCT-II (lane n output n),
//     its error (a chain), then the near and far shapes tried in that order
//     against it, as the plain version tries them;
//  6. the quantized scale factors (lane n output n) and, on lane 0, the
//     chosen shape's MPVQ index (sns_vq.cuh:mpvq_enc).
//
// Every float op is rounded on its own (rmul, radd, rsub; rdiv and rroot
// IEEE), in the plain version's order, so the indices and scale factors
// equal its bit for bit. Register arrays take static indices only; every
// computed index is clipped. The steps are templates over the warp
// (warp.cuh), so g++ compiles them for the CPU rehearsal
// (tests/test_torch_sns_nf_rehearsal.py).
#pragma once

#include "sns_vq.cuh"
#include "warp.cuh"

namespace acx {

constexpr int kPvqGroups = 4;       // pulse searches, a group of lanes each
constexpr int kPvqGroupLanes = 8;   // lanes a group: positions r and r + 8
constexpr int kPvqMaxPulses = 10;   // the most pulses a search places

// (lanes, pulses) of the searches: A, its tail B, the near and far shapes
ACX_HD int pvq_group_dim(int g) { return g == 0 ? 10 : (g == 1 ? 6 : 16); }
ACX_HD int pvq_group_pulses(int g) { return g == 0 ? 10 : (g == 1 ? 1 : (g == 2 ? 8 : 6)); }

// The encoder's tables: the buffer of kernels.py:_sns_tables (f, A) and the
// DCT-II matrix transposed, D2t[k][n] = D2[n][k], so that lane n of a
// transform reads a column of either at neighbouring addresses.
struct SnsEncTables {
  const float* f;
  const int32_t* A;
  const float* D2t;
};

// What the lanes of one warp share (shared memory on the card).
struct alignas(16) SnsEncScratch {
  float pt[kSnsM];                   // the residual after the DCT-II
  float tp[kSnsM];                   // the residual
  float x[kPvqGroups][kSnsM];        // each search's target (B: pt's tail)
  float xy2[kPvqGroups][kSnsM];      // (xy + xa)^2 of each position
  float yyt[kPvqGroups][kSnsM];      // yy + 0.5 + y of each position
  float xa[kPvqGroups][kSnsM];
  float y[kPvqGroups][kSnsM];
  int32_t ys[kPvqGroups][kSnsM];     // the signed pulses
  float en[kPvqGroups][kSnsM];       // the pulses at unit energy
  float vec[4][kSnsM];               // cn, enA (lanes 10-15 zero), near's and far's DCT-II
  float chosen[kSnsM];
  float st2[kSnsM];
};

// out[n] = sum_k in[k] * D[k][n], k ascending from the first product
ACX_HD float sns_dct_out(const float* in, const float* D, int n) {
  float acc = rmul(in[0], D[n]);
#pragma unroll
  for (int k = 1; k < kSnsM; ++k) acc = radd(acc, rmul(in[k], D[k * kSnsM + n]));
  return acc;
}

// Squared error of t against g * s, summed left to right.
ACX_HD float sns_gain_err(const float* t, float g, const float* s) {
  float e = sq(rsub(t[0], rmul(g, s[0])));
#pragma unroll
  for (int i = 1; i < kSnsM; ++i) e = radd(e, sq(rsub(t[i], rmul(g, s[i]))));
  return e;
}

// The best position of a pulse: the first maximum over the dim positions of
// xy2 / yyt, compared by cross-multiplication with a strict >, in position
// order from (bn, bd) = (-32768, 0) (sns_quantize_scf.c:92-104).
ACX_HD int pvq_scan(const float* xy2, const float* yyt, int dim) {
  int best = 0;
  float bn = -32768.0f, bd = 0.0f;
#pragma unroll
  for (int i = 0; i < kSnsM; ++i) {
    const float n = xy2[i], d = yyt[i];
    const bool better = i < dim && rmul(n, bd) > rmul(d, bn);
    best = better ? i : best;
    bn = better ? n : bn;
    bd = better ? d : bd;
  }
  return best;
}

// The first argmin of NV (value, index) pairs in each group of `width`
// lanes (a power of two): every lane of the group ends with the group's
// least value and, among equal values, its lowest index.
template <int NV, class W>
ACX_HD void warp_first_argmin(const W& w, typename W::template Lanes<float> (&v)[NV],
                              typename W::template Lanes<int> (&i)[NV], int width) {
  for (int m = width / 2; m >= 1; m /= 2) {
#pragma unroll
    for (int q = 0; q < NV; ++q) {
      const auto ov = w.shfl_xor(v[q], m);
      const auto oi = w.shfl_xor(i[q], m);
      w.lanes([&](int ln) {
        const bool take = ov[ln] < v[q][ln] || (ov[ln] == v[q][ln] && oi[ln] < i[q][ln]);
        v[q][ln] = take ? ov[ln] : v[q][ln];
        i[q][ln] = take ? oi[ln] : i[q][ln];
      });
    }
  }
}

// pvq_subpyr_search (sns_quantize_scf.c:43-137) of the four groups at once:
// group g's target in S.x[g], its signed pulses and their unit-energy values
// out in S.ys[g], S.en[g]. Where a target is silent the C writes y[0] and
// y[dim], one past the active lanes, and so does this.
template <class W>
ACX_HD void sns_pvq_search_warp(const W& w, SnsEncScratch& S) {
  using FL = typename W::template Lanes<float>;
  using IL = typename W::template Lanes<int>;
  FL xy, yy, yy1, pulse_tot, x0, x1, xa0, xa1, y0, y1, bxa, by;
  IL silent, need, best;
  // the projection: every lane of a group runs its chains over all 16
  // positions, and keeps its own two
  w.lanes([&](int ln) {
    const int g = ln / kPvqGroupLanes, r = ln % kPvqGroupLanes;
    const int dim = pvq_group_dim(g), P = pvq_group_pulses(g);
    const float* xg = S.x[g];
    float xa[kSnsM], y[kSnsM];
#pragma unroll
    for (int i = 0; i < kSnsM; ++i) xa[i] = i < dim ? fabsf(xg[i]) : 0.0f;
    float xsum = xa[0];
#pragma unroll
    for (int i = 1; i < kSnsM; ++i) xsum = radd(xsum, xa[i]);
    const float eps = 5.9604644775390625e-08f;  // 2^-24
    const bool project = xsum > eps;            // false for a silent target and a NaN
    const float proj_fac = rmul(rdiv(1.0f, xsum), static_cast<float>(P - 1));
#pragma unroll
    for (int i = 0; i < kSnsM; ++i) y[i] = (project && i < dim) ? floorf(rmul(xa[i], proj_fac)) : 0.0f;
    float tot = y[0], sxy = rmul(xa[0], y[0]), syy = sq(y[0]);
#pragma unroll
    for (int i = 1; i < kSnsM; ++i) {
      tot = radd(tot, y[i]);
      syy = radd(syy, sq(y[i]));
      sxy = radd(sxy, rmul(xa[i], y[i]));
    }
    silent[ln] = xsum <= eps ? 1 : 0;
    xy[ln] = sxy;
    yy[ln] = rmul(syy, 0.5f);
    pulse_tot[ln] = tot;
    x0[ln] = xg[r];
    x1[ln] = xg[r + 8];
    xa0[ln] = r < dim ? fabsf(x0[ln]) : 0.0f;
    xa1[ln] = r + 8 < dim ? fabsf(x1[ln]) : 0.0f;
    y0[ln] = (project && r < dim) ? floorf(rmul(xa0[ln], proj_fac)) : 0.0f;
    y1[ln] = (project && r + 8 < dim) ? floorf(rmul(xa1[ln], proj_fac)) : 0.0f;
    S.xa[g][r] = xa0[ln];
    S.xa[g][r + 8] = xa1[ln];
    S.y[g][r] = y0[ln];
    S.y[g][r + 8] = y1[ln];
  });
  // the pulses the projection left, one a step, while any group has one
  for (int p = 0; p < kPvqMaxPulses; ++p) {
    w.lanes([&](int ln) {
      const int P = pvq_group_pulses(ln / kPvqGroupLanes);
      need[ln] = (silent[ln] == 0 && p < P && pulse_tot[ln] < static_cast<float>(P)) ? 1 : 0;
    });
    if (w.ballot(need) == 0u) break;
    w.lanes([&](int ln) {
      const int g = ln / kPvqGroupLanes, r = ln % kPvqGroupLanes;
      yy1[ln] = radd(yy[ln], 0.5f);
      S.xy2[g][r] = sq(radd(xy[ln], xa0[ln]));
      S.xy2[g][r + 8] = sq(radd(xy[ln], xa1[ln]));
      S.yyt[g][r] = radd(yy1[ln], y0[ln]);
      S.yyt[g][r + 8] = radd(yy1[ln], y1[ln]);
    });
    w.sync();
    w.lanes([&](int ln) {
      const int g = ln / kPvqGroupLanes;
      float xy2[kSnsM], yyt[kSnsM];
#pragma unroll
      for (int i = 0; i < kSnsM; ++i) {
        xy2[i] = S.xy2[g][i];
        yyt[i] = S.yyt[g][i];
      }
      const int b = iclamp(pvq_scan(xy2, yyt, pvq_group_dim(g)), 0, kSnsM - 1);
      best[ln] = b;
      bxa[ln] = S.xa[g][b];
      by[ln] = S.y[g][b];
    });
    w.sync();
    w.lanes([&](int ln) {
      if (need[ln] == 0) return;
      const int g = ln / kPvqGroupLanes, r = ln % kPvqGroupLanes;
      xy[ln] = radd(xy[ln], bxa[ln]);
      yy[ln] = radd(yy1[ln], by[ln]);
      pulse_tot[ln] = radd(pulse_tot[ln], 1.0f);
      if (best[ln] == r) {
        y0[ln] = radd(y0[ln], 1.0f);
        S.y[g][r] = y0[ln];
      }
      if (best[ln] == r + 8) {
        y1[ln] = radd(y1[ln], 1.0f);
        S.y[g][r + 8] = y1[ln];
      }
    });
  }
  // the pulses' energy, their signs and their unit-energy values
  w.lanes([&](int ln) {
    const int g = ln / kPvqGroupLanes, r = ln % kPvqGroupLanes;
    const int dim = pvq_group_dim(g), P = pvq_group_pulses(g);
    float v0 = y0[ln], v1 = y1[ln], e;
    if (silent[ln] != 0) {
      // P / 2 pulses at position 0, the rest at dl, negative
      const int dl = dim < kSnsM ? dim : kSnsM - 1;
      const float first = static_cast<float>(P / 2), last = -static_cast<float>(P - P / 2);
      e = 0.0f;
#pragma unroll
      for (int i = 0; i < kSnsM; ++i) {
        float yi = i == 0 ? first : 0.0f;
        if (dim > 1 && i == dl) yi = last;
        e = i == 0 ? sq(yi) : radd(e, sq(yi));
      }
      v0 = r == 0 ? first : 0.0f;
      if (dim > 1 && r == dl) v0 = last;
      v1 = (dim > 1 && r + 8 == dl) ? last : 0.0f;
    } else {
      e = rmul(yy[ln], 2.0f);
    }
    const float gain = rdiv(1.0f, rroot(e));
    const int s0 = static_cast<int>(rmul(v0, x0[ln] >= 0.0f ? 1.0f : -1.0f));
    const int s1 = static_cast<int>(rmul(v1, x1[ln] >= 0.0f ? 1.0f : -1.0f));
    S.ys[g][r] = s0;
    S.ys[g][r + 8] = s1;
    S.en[g][r] = rmul(static_cast<float>(s0), gain);
    S.en[g][r + 8] = rmul(static_cast<float>(s1), gain);
  });
  w.sync();
}

// process_snsQuantizesScf_Enc of one stream: scf [16] -> idx [7] (written by
// lane 0) and scf_q [16] (lane n output n).
template <class W>
ACX_HD void sns_vq_enc_warp(const W& w, const float* scf, const SnsEncTables& t,
                            SnsEncScratch& S, int32_t* idx, float* scf_q) {
  using FL = typename W::template Lanes<float>;
  using IL = typename W::template Lanes<int>;
  // 1. the stage-1 searches: lane j entry j of both codebooks
  FL d[2];
  IL j[2];
  w.lanes([&](int ln) {
    float a = sq(rsub(scf[0], t.f[kOffC1 + ln])), b = sq(rsub(scf[8], t.f[kOffC2 + ln]));
#pragma unroll
    for (int k = 1; k < 8; ++k) {
      a = radd(a, sq(rsub(scf[k], t.f[kOffC1 + k * kSnsCb + ln])));
      b = radd(b, sq(rsub(scf[8 + k], t.f[kOffC2 + k * kSnsCb + ln])));
    }
    d[0][ln] = a;
    d[1][ln] = b;
    j[0][ln] = ln;
    j[1][ln] = ln;
  });
  warp_first_argmin<2>(w, d, j, kCoderLanes);
  const int i0 = iclamp(w.shfl(j[0], 0), 0, kSnsCb - 1);
  const int i1 = iclamp(w.shfl(j[1], 0), 0, kSnsCb - 1);
  // 2. the residual and its DCT-II
  w.lanes([&](int ln) {
    const int n = ln % kSnsM;
    float tp[kSnsM];
#pragma unroll
    for (int i = 0; i < kSnsM; ++i) {
      const float st1 = i < 8 ? t.f[kOffC1 + i * kSnsCb + i0] : t.f[kOffC2 + (i - 8) * kSnsCb + i1];
      tp[i] = rsub(scf[i], st1);
    }
    const float v = sns_dct_out(tp, t.D2t, n);
    const float st1 = n < 8 ? t.f[kOffC1 + n * kSnsCb + i0] : t.f[kOffC2 + (n - 8) * kSnsCb + i1];
    if (ln < kSnsM) {
      S.pt[n] = v;
      S.tp[n] = rsub(scf[n], st1);
    }
  });
  w.sync();
  // 3. the four searches' targets, then the searches
  w.lanes([&](int ln) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int e = ln + kCoderLanes * h, g = e / kSnsM, i = e % kSnsM;
      S.x[g][i] = g == 1 ? (i < 6 ? S.pt[10 + (i < 6 ? i : 0)] : 0.0f) : S.pt[i];
    }
  });
  w.sync();
  sns_pvq_search_warp(w, S);
  // 4. cn (the split shape at unit energy) and enA on lanes n and 16 + n, the
  // near and far shapes' DCT-IIs likewise
  w.lanes([&](int ln) {
    const int n = ln % kSnsM, half = ln / kSnsM;
    float enC = 0.0f;
#pragma unroll
    for (int i = 0; i < kSnsM; ++i) {
      const int yc = i < 10 ? S.ys[0][i] : S.ys[1][i < 10 ? 0 : i - 10];
      const float e = static_cast<float>(yc * yc);
      enC = i == 0 ? e : radd(enC, e);
    }
    const float gain_fac = rdiv(1.0f, rroot(enC));
    const int yc = n < 10 ? S.ys[0][n] : S.ys[1][n < 10 ? 0 : n - 10];
    const float cn = rmul(static_cast<float>(yc), gain_fac);
    const float enA = n < 10 ? S.en[0][n] : 0.0f;
    S.vec[half][n] = half == 0 ? cn : enA;
    S.vec[2 + half][n] = sns_dct_out(S.en[2 + half], t.f + kOffD2, n);
  });
  w.sync();
  // the 18 gain candidates: lane 8 * seg + c
  FL err[1];
  IL ci[1];
  w.lanes([&](int ln) {
    const int seg = ln / 8, c = ln % 8;
    const int count = seg == 0 ? 6 : (seg == 1 ? 4 : (seg == 2 ? 8 : 0));
    const int row = seg == 0 ? (c < 2 ? 0 : 1) : (seg == 1 ? 2 : 3);
    const int gw = seg == 0 ? kOffRegG + iclamp(c, 0, 5)
                            : (seg == 1 ? kOffNearG + iclamp(c, 0, 3) : kOffFarG + c);
    const float e = sns_gain_err(seg == 0 ? S.pt : S.tp, t.f[gw], S.vec[row]);
    err[0][ln] = c < count ? e : INFINITY;
    ci[0][ln] = ln;
  });
  warp_first_argmin<1>(w, err, ci, 8);
  const int idx_g = iclamp(w.shfl(ci[0], 0), 0, 5);
  const int i_near = iclamp(w.shfl(ci[0], 8) - 8, 0, 3);
  const int i_far = iclamp(w.shfl(ci[0], 16) - 16, 0, 7);
  const float e_near = w.shfl(err[0], 8), e_far = w.shfl(err[0], 16);
  // 5. the split choice: its shape over its gain, its DCT-II, its error
  const bool split = idx_g <= 1;
  const float cand_gain = t.f[kOffRegG + idx_g], glob_gain = t.f[kOffQG + idx_g];
  w.lanes([&](int ln) {
    const int n = ln % kSnsM;
    const float v = rdiv(rmul(S.vec[split ? 0 : 1][n], cand_gain), glob_gain);
    if (ln < kSnsM) S.chosen[n] = v;
  });
  w.sync();
  w.lanes([&](int ln) {
    const int n = ln % kSnsM;
    const float v = rmul(glob_gain, sns_dct_out(S.chosen, t.f + kOffD2, n));
    if (ln < kSnsM) S.st2[n] = v;
  });
  w.sync();
  // 6. the choice among split, near and far, the scale factors, the index
  w.lanes([&](int ln) {
    float best_err = sq(rsub(S.tp[0], S.st2[0]));
#pragma unroll
    for (int i = 1; i < kSnsM; ++i) best_err = radd(best_err, sq(rsub(S.tp[i], S.st2[i])));
    int idx2 = split ? 0 : 1, idx3 = split ? idx_g : idx_g - 2;
    if (e_near < best_err) {
      idx2 = 2;
      idx3 = i_near;
      best_err = e_near;
    }
    if (e_far < best_err) {
      idx2 = 3;
      idx3 = i_far;
    }
    const int n = ln % kSnsM;
    const float st1 = n < 8 ? t.f[kOffC1 + n * kSnsCb + i0] : t.f[kOffC2 + (n - 8) * kSnsCb + i1];
    float st2 = S.st2[n];
    if (idx2 == 2) st2 = rmul(t.f[kOffNearG + i_near], S.vec[2][n]);
    if (idx2 == 3) st2 = rmul(t.f[kOffFarG + i_far], S.vec[3][n]);
    if (ln < kSnsM) scf_q[n] = radd(st1, st2);
    if (ln != 0) return;
    // the chosen shape: yC (split), yA (low band), near's or far's
    int psel[kSnsM];
#pragma unroll
    for (int i = 0; i < kSnsM; ++i) {
      const int yc = i < 10 ? S.ys[0][i] : S.ys[1][i < 10 ? 0 : i - 10];
      psel[i] = idx2 == 0 ? yc : S.ys[idx2 == 1 ? 0 : idx2][i];
    }
    int ls, mpvq, idx6;
    if (idx2 < 2) {
      mpvq_enc<10, 0>(psel, t.A, &ls, &mpvq);
      idx6 = -2;
      if (idx2 == 0) {
        int ls_tail, mpvq_tail;
        mpvq_enc<6, 10>(psel, t.A, &ls_tail, &mpvq_tail);
        idx6 = mpvq_tail * 2 + ls_tail;
      }
    } else {
      mpvq_enc<16, 0>(psel, t.A, &ls, &mpvq);
      idx6 = idx2 == 2 ? -1 : -2;
    }
    idx[0] = i0;
    idx[1] = i1;
    idx[2] = idx2;
    idx[3] = idx3;
    idx[4] = ls;
    idx[5] = mpvq;
    idx[6] = idx6;
  });
}

}  // namespace acx
