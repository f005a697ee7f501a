// The TNS filter analysis of one stream (tns_coder.c:157-329): per filter, the
// normalised autocorrelation over its subdivisions, the Levinson-Durbin
// recursion, the prediction gain and TNS decision, the LPC weighting below
// max_pg, the step-down to reflection coefficients, their 17-level quantizer,
// the filter order and the Huffman bit count. tns_filter_analysis.cu launches
// it one thread per stream; without nvcc it compiles as plain C++.
//
// Every float result must equal the plain version's (ops/tns.py:
// tns_filter_analysis_plain) on the card bit for bit, so every product, sum
// and quotient is rounded on its own (rmul, radd, rsub, rdiv), in the plain
// version's order: each autocorrelation lag and the energy are one chain over
// the subdivision's bins, from zero, bins ascending. The recursions are
// unrolled at their order with compile-time indices only (fixed-bound loops
// with conditions on the unrolled counters).
#pragma once

#include "acodec.cuh"

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
};

// One filter over bins st..sp (1-based, inclusive) of x [N].
template <int ORDER, int NSUB>
ACX_HD TnsFilter tns_analyze_filter(const float* x, int st, int sp, const int32_t* tab,
                                    const TnsGeom& g) {
  const float* tf = reinterpret_cast<const float*>(tab);
  const float subdiv_len = rmul(rsub(radd(static_cast<float>(sp), 1.0f),
                                     static_cast<float>(st)), g.inv_nsub);
  float r[ORDER + 1];
#pragma unroll
  for (int l = 0; l <= ORDER; ++l) r[l] = 0.0f;
  bool dead = false;
#pragma unroll
  for (int sub = 1; sub <= NSUB; ++sub) {
    const int s_lo = static_cast<int>(floorf(rmul(subdiv_len, static_cast<float>(sub - 1)))) + st - 1;
    const int s_hi = static_cast<int>(floorf(rmul(subdiv_len, static_cast<float>(sub)))) + st - 1;
    const int lo = imax(s_lo, 0), hi = imin(s_hi, g.N);
    float acf[ORDER + 1];
#pragma unroll
    for (int l = 0; l <= ORDER; ++l) acf[l] = 0.0f;
    for (int i = lo; i < hi; ++i) {
      const float xi = x[i];
#pragma unroll
      for (int l = 0; l <= ORDER; ++l) {
        if (i + l < hi) acf[l] = radd(acf[l], rmul(xi, x[i + l]));
      }
    }
    const float e = acf[0];    // the energy is the lag-0 chain
    dead = dead || e == 0.0f;
    const float den = e < static_cast<float>(1e-30) ? static_cast<float>(1e-30) : e;
#pragma unroll
    for (int l = 0; l <= ORDER; ++l) r[l] = radd(r[l], rdiv(acf[l], den));
  }
#pragma unroll
  for (int l = 0; l <= ORDER; ++l) {
    if (dead) r[l] = l == 0 ? 1.0f : 0.0f;
    r[l] = rmul(r[l], tf[kOffTnsLagw + l]);
  }
  float lpc[ORDER + 1], rc[ORDER], err;
  tns_levinson<ORDER>(r, lpc, rc, err);
  const float pred_gain = rdiv(r[0], err);

  TnsFilter out;
  out.on = pred_gain > 1.5f;
  out.order = 0;
  out.bits = 1;
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

// One stream: x [N] (bins above the bandwidth unread), its bandwidth index.
// order [2], rc_idx [2][8], rc_q [2][8], numfilters, bits.
template <int ORDER, int NSUB>
ACX_HD void tns_filter_analysis_lane(const float* x, int bw_idx, const int32_t* tab,
                                     const TnsGeom& g, int* order, int* rc_idx, float* rc_q,
                                     int* numfilters, int* bits) {
  const int bw_fcbin = tab[kOffTnsCut + iclamp(bw_idx, 0, kTnsCutoffs - 1)];
  const bool two = bw_idx >= 3 && g.nf_max == 2;
  const int half = bw_fcbin / 2;
  TnsFilter f[2];
  f[0] = tns_analyze_filter<ORDER, NSUB>(x, g.startfreq0, two ? half : bw_fcbin, tab, g);
  if (two) {
    f[1] = tns_analyze_filter<ORDER, NSUB>(x, half + 1, bw_fcbin, tab, g);
  } else {
    f[1].on = false;
    f[1].bits = 0;
  }
  *numfilters = two ? 2 : 1;
  *bits = f[0].bits + (two ? f[1].bits : 0);
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    order[j] = f[j].on ? f[j].order : 0;
#pragma unroll
    for (int k = 0; k < kTnsLags; ++k) {
      rc_idx[kTnsLags * j + k] = f[j].on ? f[j].idx[k] : 0;
      rc_q[kTnsLags * j + k] = f[j].on ? f[j].rcq[k] : 0.0f;
    }
  }
}

}  // namespace acx
