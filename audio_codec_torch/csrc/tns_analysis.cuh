// The TNS filter analysis of one stream (tns_coder.c:157-329) on a warp: per
// filter, the normalised autocorrelation over its subdivisions, the
// Levinson-Durbin recursion, the prediction gain and TNS decision, the LPC
// weighting below max_pg, the step-down to reflection coefficients, their
// 17-level quantizer, the filter order and the Huffman bit count.
// tns_filter_analysis.cu launches it a warp a stream; the steps are templates
// over the warp (warp.cuh), so g++ compiles them for the CPU rehearsal.
//
// Every float result must equal the plain version's (ops/tns.py:
// tns_filter_analysis_plain) on the card bit for bit, so every product, sum
// and quotient is rounded on its own (rmul, radd, rsub, rdiv), in the plain
// version's order: each autocorrelation lag and the energy are one chain over
// the subdivision's bins, from zero, bins ascending; a filter's r[l] sums its
// subdivisions' normalised lags from zero, subdivision 1 first. The
// recursions are unrolled at their order with compile-time indices only
// (fixed-bound loops with conditions on the unrolled counters).
//
// The warp. Each (filter, subdivision, lag) chain is independent of the
// others, so lane sub * (ORDER + 1) + l runs the lag-l chain of subdivision
// sub of filter 0 and, interleaved with it, the same chain of filter 1 (27
// chains a filter at ORDER 8 with 3 subdivisions: lanes 0-26; 10 at ORDER 4
// with 2: lanes 0-9). Each chain's lane divides it by its subdivision's
// energy; shuffles then gather the quotients onto lane 0 (filter 0) and lane
// 1 (filter 1), which sum r and run the recursions, the weighting, the
// quantizer and the bit count side by side (tns_filter_from_r).
#pragma once

#include "acodec.cuh"
#include "warp.cuh"

namespace acx {

constexpr int kTnsLags = 8;        // lanes of the coefficient outputs
constexpr int kTnsCutoffs = 6;     // bw_cutoff_bins entries
constexpr int kTnsLevels = 17;     // quantizer points

// The tables as one buffer of 32-bit words (kernels.py:_tns_tables).
constexpr int kOffTnsCut = 0;                             // [6] int32 cutoff bins
constexpr int kOffTnsLagw = kOffTnsCut + kTnsCutoffs;     // [9] lag window
constexpr int kOffTnsThr = kOffTnsLagw + 9;               // [18] quantizer thresholds
constexpr int kOffTnsPts = kOffTnsThr + 18;               // [17] quantizer points
constexpr int kOffTnsHuff = kOffTnsPts + kTnsLevels;      // [8][17] int32 Huffman bits
constexpr int kOffTnsOrderBits = kOffTnsHuff + 8 * kTnsLevels;  // [8] int32 order bits
constexpr int kTnsTableWords = kOffTnsOrderBits + 8;

// The static geometry of the configuration (ops/tns.py:_tns_geometry), and
// the float constants of the plain version's scalar operations.
struct TnsGeom {
  int N;            // row length
  int startfreq0;   // first bin of filter 0, 1-based
  int nf_max;       // 1 or 2 filters
  float max_pg;     // 1.5 or 2.0
  float inv_nsub;   // float32(1 / n_sub)
  float c_alpha;    // float32(0.85 - 1.0)
  float inv_span;   // float32(1 / (max_pg - 1.5)), used only when max_pg > 1.5
};

// Levinson-Durbin at ORDER (ops/tns.py:_levinson): r [ORDER+1] -> lpc
// [ORDER+1] with lpc[0] = 1, rc [ORDER], err.
template <int ORDER>
ACX_HD void tns_levinson(const float (&r)[ORDER + 1], float (&lpc)[ORDER + 1],
                         float (&rc)[ORDER], float& err) {
  float a[ORDER];
  float g = rdiv(r[1], r[0]);
  a[0] = g;
#pragma unroll
  for (int j = 1; j < ORDER; ++j) a[j] = 0.0f;
  float v = rmul(radd(rmul(-g, g), 1.0f), r[0]);
  rc[0] = -g;
#pragma unroll
  for (int t = 1; t < ORDER; ++t) {
    float s = rmul(a[0], r[1]);
#pragma unroll
    for (int i = 1; i < ORDER; ++i) {
      if (i < t) s = radd(rmul(a[i], r[i + 1]), s);
    }
    g = rdiv(rsub(r[t + 1], s), v);
    float na[ORDER];
    na[0] = g;
#pragma unroll
    for (int j = 1; j < ORDER; ++j) na[j] = j <= t ? radd(rmul(-g, a[t - j]), a[j - 1]) : 0.0f;
#pragma unroll
    for (int j = 0; j < ORDER; ++j) a[j] = na[j];
    v = rmul(v, radd(rmul(-g, g), 1.0f));
    rc[t] = -g;
  }
  lpc[0] = 1.0f;
#pragma unroll
  for (int i = 0; i < ORDER - 1; ++i) lpc[i + 1] = -a[ORDER - 1 - i];
  lpc[ORDER] = rc[ORDER - 1];
  err = v;
}

// poly2rc by levdown (ops/tns.py:_poly2rc): a [ORDER+1] (a[0] = 1) -> rc.
template <int ORDER>
ACX_HD void tns_poly2rc(const float (&a)[ORDER + 1], float (&rc)[ORDER]) {
  float cur[ORDER + 1];
#pragma unroll
  for (int i = 0; i <= ORDER; ++i) cur[i] = a[i];
  rc[ORDER - 1] = cur[ORDER];
#pragma unroll
  for (int k = ORDER - 2; k >= 0; --k) {
    // this step lowers the order from n = k + 2 to k + 1
    const float knxt = cur[k + 2];
    const float denom = radd(rmul(-knxt, knxt), 1.0f);
    float nxt[ORDER];
#pragma unroll
    for (int i = 0; i < ORDER; ++i) {
      nxt[i] = i < k + 1 ? rdiv(radd(rmul(-knxt, cur[k + 1 - i]), cur[i + 1]), denom) : 0.0f;
    }
#pragma unroll
    for (int i = 0; i < ORDER; ++i) {
      if (i < k + 1) cur[i + 1] = nxt[i];
    }
    rc[k] = cur[k + 1];
  }
}

struct TnsFilter {
  bool on;
  int order;
  int idx[kTnsLags];
  float rcq[kTnsLags];
  int bits;
  float gain;   // the prediction gain r[0] / err
};

// Bins [lo, hi) (0-based) of subdivision sub (1-based) of the filter over
// bins st..sp (1-based, inclusive) of a row of N bins.
ACX_HD void tns_sub_range(int st, int sp, int sub, const TnsGeom& g, int& lo, int& hi) {
  const float subdiv_len = rmul(rsub(radd(static_cast<float>(sp), 1.0f),
                                     static_cast<float>(st)), g.inv_nsub);
  const int s_lo = static_cast<int>(floorf(rmul(subdiv_len, static_cast<float>(sub - 1)))) + st - 1;
  const int s_hi = static_cast<int>(floorf(rmul(subdiv_len, static_cast<float>(sub)))) + st - 1;
  lo = imax(s_lo, 0);
  hi = imin(s_hi, g.N);
}

// The bins of a row the analysis reads: [0, tns_row_bins). Every subdivision
// ends at or below its filter's last bin sp <= bw_fcbin, as
// floor(float(float(L * float(1 / NSUB)) * NSUB)) <= L for the filter's L =
// sp + 1 - st bins (the float products lie within a few ulps of L).
ACX_HD int tns_row_bins(int bw_idx, const int32_t* tab, const TnsGeom& g) {
  return imin(tab[kOffTnsCut + iclamp(bw_idx, 0, kTnsCutoffs - 1)], g.N);
}

// A filter from the sum r [ORDER+1] of its subdivisions' normalised lags and
// the flag of a silent subdivision: the lag window, the recursions, the
// weighting, the quantizer and the bit count.
template <int ORDER>
ACX_HD TnsFilter tns_filter_from_r(const float (&r_sum)[ORDER + 1], bool dead,
                                   const int32_t* tab, const TnsGeom& g) {
  const float* tf = reinterpret_cast<const float*>(tab);
  float r[ORDER + 1];
#pragma unroll
  for (int l = 0; l <= ORDER; ++l) {
    r[l] = dead ? (l == 0 ? 1.0f : 0.0f) : r_sum[l];
    r[l] = rmul(r[l], tf[kOffTnsLagw + l]);
  }
  float lpc[ORDER + 1], rc[ORDER], err;
  tns_levinson<ORDER>(r, lpc, rc, err);
  const float pred_gain = rdiv(r[0], err);

  TnsFilter out;
  out.on = pred_gain > 1.5f;
  out.order = 0;
  out.bits = 1;
  out.gain = pred_gain;
#pragma unroll
  for (int k = 0; k < kTnsLags; ++k) {
    out.idx[k] = 0;
    out.rcq[k] = 0.0f;
  }
  if (!out.on) return out;   // every output of the filter is masked then

  if (pred_gain < g.max_pg) {
    // LPC weighting (tns_coder.c:306-317); alpha^k as a chain of products
    const float alpha = radd(rmul(rmul(rsub(g.max_pg, pred_gain), g.c_alpha), g.inv_span), 1.0f);
    float w[ORDER + 1];
    float p = 1.0f;
#pragma unroll
    for (int k = 0; k <= ORDER; ++k) {
      w[k] = rmul(lpc[k], p);
      p = k == 0 ? alpha : rmul(p, alpha);
    }
    tns_poly2rc<ORDER>(w, rc);
  }

  const float* thr = tf + kOffTnsThr;
  const float* pts = tf + kOffTnsPts;
  int last_nz = 0;
#pragma unroll
  for (int k = 0; k < kTnsLags; ++k) {
    int idx = 8;   // lanes above the order: the zero point
    if (k < ORDER) {
      int above = 0;
      for (int j = 0; j < kTnsLevels; ++j) above += rc[k] > thr[j] ? 1 : 0;
      idx = iclamp(above - 1, 0, kTnsLevels - 1);
    }
    out.idx[k] = idx;
    out.rcq[k] = pts[idx];
    if (out.rcq[k] != 0.0f) last_nz = k + 1;
  }
  out.order = last_nz > 0 ? last_nz : 1;
  int nbits = tab[kOffTnsOrderBits + iclamp(out.order - 1, 0, 7)];
#pragma unroll
  for (int k = 0; k < kTnsLags; ++k) {
    if (k < out.order) nbits += tab[kOffTnsHuff + k * kTnsLevels + out.idx[k]];
  }
  out.bits = 1 + static_cast<int>(ceilf(rmul(static_cast<float>(nbits), 1.0f / 2048.0f)));
  return out;
}

// a filter's running sum of normalised lags, and its silent-subdivision flag
template <int ORDER>
struct TnsSum {
  float r[ORDER + 1];
  bool dead;
};

// One stream on a warp: x its row (bins [0, tns_row_bins) read), its
// bandwidth index. order [2], rc_idx [2][8], rc_q [2][8], numfilters, bits;
// gains [2] the prediction gains (0 for a second filter the stream lacks;
// nullptr: not written). Lanes 0 and 1 write a filter's outputs each, lane 0
// the counts.
template <int ORDER, int NSUB, class W>
ACX_HD void tns_filter_analysis_warp(const W& w, const float* x, int bw_idx, const int32_t* tab,
                                     const TnsGeom& g, int32_t* order, int32_t* rc_idx,
                                     float* rc_q, int32_t* numfilters, int32_t* bits,
                                     float* gains) {
  constexpr int kLags = ORDER + 1;
  static_assert(NSUB * kLags <= kCoderLanes, "one chain a lane");
  const int bw_fcbin = tab[kOffTnsCut + iclamp(bw_idx, 0, kTnsCutoffs - 1)];
  const bool two = bw_idx >= 3 && g.nf_max == 2;
  const int half = bw_fcbin / 2;

  // the chains: lane sub * kLags + l runs lag l of subdivision sub + 1 of
  // filter 0 (acf0) and of filter 1 (acf1), each from zero, bins ascending
  typename W::template Lanes<float> acf0, acf1;
  w.lanes([&](int ln) {
    const int sub = ln / kLags + 1, l = ln % kLags;
    float a0 = 0.0f, a1 = 0.0f;
    if (sub <= NSUB) {
      int lo0, hi0, lo1 = 0, hi1 = 0;
      tns_sub_range(g.startfreq0, two ? half : bw_fcbin, sub, g, lo0, hi0);
      if (two) tns_sub_range(half + 1, bw_fcbin, sub, g, lo1, hi1);
      const int n0 = hi0 - l - lo0, n1 = hi1 - l - lo1;   // bins i with i + l < hi
      const int n = imax(n0, n1);
      for (int k = 0; k < n; ++k) {
        if (k < n0) a0 = radd(a0, rmul(x[lo0 + k], x[lo0 + k + l]));
        if (k < n1) a1 = radd(a1, rmul(x[lo1 + k], x[lo1 + k + l]));
      }
    }
    acf0[ln] = a0;
    acf1[ln] = a1;
  });

  // r of filter f on lane f: each chain's lane divides it by its
  // subdivision's energy (the lag-0 chain), and lanes 0 and 1 sum the
  // quotients from zero in subdivision order
  typename W::template Lanes<TnsSum<ORDER>> sum;
  w.lanes([&](int ln) {
#pragma unroll
    for (int l = 0; l < kLags; ++l) sum[ln].r[l] = 0.0f;
    sum[ln].dead = false;
  });
  float den0[NSUB], den1[NSUB];
#pragma unroll
  for (int sub = 0; sub < NSUB; ++sub) {
    const float e0 = w.shfl(acf0, sub * kLags), e1 = w.shfl(acf1, sub * kLags);
    den0[sub] = e0 < static_cast<float>(1e-30) ? static_cast<float>(1e-30) : e0;
    den1[sub] = e1 < static_cast<float>(1e-30) ? static_cast<float>(1e-30) : e1;
    w.lanes([&](int ln) {
      if (ln < 2) sum[ln].dead = sum[ln].dead || (ln == 0 ? e0 : e1) == 0.0f;
    });
  }
  w.lanes([&](int ln) {
    float d0 = 1.0f, d1 = 1.0f;
#pragma unroll
    for (int sub = 0; sub < NSUB; ++sub) {
      if (ln / kLags == sub) {
        d0 = den0[sub];
        d1 = den1[sub];
      }
    }
    acf0[ln] = rdiv(acf0[ln], d0);
    acf1[ln] = rdiv(acf1[ln], d1);
  });
#pragma unroll
  for (int s = 0; s < NSUB; ++s) {
#pragma unroll
    for (int l = 0; l < kLags; ++l) {
      const float q0 = w.shfl(acf0, s * kLags + l), q1 = w.shfl(acf1, s * kLags + l);
      w.lanes([&](int ln) {
        if (ln < 2) sum[ln].r[l] = radd(sum[ln].r[l], ln == 0 ? q0 : q1);
      });
    }
  }

  typename W::template Lanes<TnsFilter> f;
  typename W::template Lanes<int> fbits;
  w.lanes([&](int ln) {
    fbits[ln] = 0;
    if (ln < 2) {
      f[ln] = tns_filter_from_r<ORDER>(sum[ln].r, sum[ln].dead, tab, g);
      fbits[ln] = f[ln].bits;
    }
  });
  const int bits1 = w.shfl(fbits, 1);
  w.lanes([&](int ln) {
    if (ln < 2) {
      const bool has = ln == 0 || two;
      const bool on = has && f[ln].on;
      order[ln] = on ? f[ln].order : 0;
#pragma unroll
      for (int k = 0; k < kTnsLags; ++k) {
        rc_idx[kTnsLags * ln + k] = on ? f[ln].idx[k] : 0;
        rc_q[kTnsLags * ln + k] = on ? f[ln].rcq[k] : 0.0f;
      }
      if (gains != nullptr) gains[ln] = has ? f[ln].gain : 0.0f;
    }
  });
  w.leader([&]() {
    *numfilters = two ? 2 : 1;
    *bits = f[0].bits + (two ? bits1 : 0);
  });
}

}  // namespace acx
