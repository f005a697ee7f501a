// One stream of the advanced concealment's time-domain part (plc_tdc.cu):
// the method classifier and the LPC analysis at the first loss of a burst,
// then one frame of TD-PLC where the method is 3 (ops/plc_adv.py:
// plc_tdc_plain, which composes classify, tdc_lpc and tdc_apply as the
// reference decoder does). Written over a warp policy (plc.cuh).
//
// The LPC synthesis y[n] = e[n] - sum_k a[k] y[n - k] (k = 1..16) is the
// stream's recurrence. The plain version sums each sample's taps oldest
// first, from zero: P[n] = xfma(y[n-1], a[1], ... xfma(y[n-16], a[16], 0)),
// then y[n] = rsub(e[n], P[n]). Only the last tap reads y[n-1], so the same
// operations run in transposed order: when y[m] is known it feeds the 16
// pending sums P[m+1..m+16] at once (P[m+j] = xfma(y[m], a[j], P[m+j]),
// P[m+16] from +0), and each P[n] still receives the same operands in the
// same order. The chain of a sample is one xfma and one rsub
// (tdc_synth_warp: 16 lanes, lane m mod 16 holding P[m]).
#pragma once

#include "dct4.cuh"
#include "plc.cuh"

namespace acx {

constexpr int kTdcOrder = 16;       // the LPC state's width
constexpr int kTdcFir = 11;         // L_FIR_HP
constexpr int kTdcMaxBands = 80;

struct TdcGeom {
  int L;           // PCM history: max pitch + frame
  int MP;          // max pitch
  int fl;          // frame length
  int length;      // frame + overlap (2 fl - la_zeroes)
  int N;           // spectrum bins
  int lpc_order;   // 16, 8 at 8 kHz
  int n_bands;     // LPC analysis bands
  int rect;        // classifier correlation length
  int pitch_min2;
  int frame_dms;
  float pre_fac;   // pre-emphasis
  float atten;     // PLC34_ATTEN_FAC
  float cent_fac;  // centroid normalisation
};

// Table layout (kernels.py:_tdc_tables): floats, then int32.
struct TdcTables {
  const float* dee;    // [16] de-emphasis of the scale factors
  const float* cw;     // [2][16] centroid weights: frequency sums, widths
  const float* lpc_w;  // [n_bands] 1 / band width
  const float* pre;    // [n_bands] pre-emphasis
  const float* cosm;   // [n_bands][17] inverse ODFT
  const float* lag;    // [16] lag window
  const float* hh;     // [11] harmonic smoothing FIR
  const float* hp;     // [11] noise high-pass FIR
  const float* rsq;    // [2048] x86 rsqrt estimate
  const int32_t* off;  // [n_bands + 1] band offsets
  const int32_t* pows; // [2][length + 11] LCG advance
};

ACX_HD TdcTables tdc_tables(const float* f, const int32_t* i, int n_bands) {
  TdcTables t;
  t.dee = f;
  t.cw = f + 16;
  t.lpc_w = f + 48;
  t.pre = t.lpc_w + n_bands;
  t.cosm = t.pre + n_bands;
  t.lag = t.cosm + 17 * n_bands;
  t.hh = t.lag + 16;
  t.hp = t.hh + kTdcFir;
  t.rsq = t.hp + kTdcFir;
  t.off = i;
  t.pows = i + n_bands + 1;
  return t;
}

// A stream's inputs and outputs (row pointers and scalars).
struct TdcStream {
  const float* x;      // [L] PCM history
  const float* scf;    // [16] last good scale factors
  const float* q;      // [N] last good spectrum
  const float* a_in;   // [17]
  const float* harm_in;  // [MP]
  const float* hist_in;  // [16] synthesis memory
  int lost, nb, pitch, pitch_fr, meth_in, seed_in, fract_in, hlen_in;
  float stab, gain_c_in, alpha_in;
  float* a;            // [17]
  float* synth;        // [length]
  float* harm;         // [MP]
  float* hist;         // [16]
  int* meth;
  float* nc;
  int* seed;
  float* gain_c;
  float* alpha;
  int* fract;
  int* hlen;
};

// Per-warp work space: the sizes of the flagship point are the largest.
// Buffers whose lives do not overlap share storage (buf): at a first loss
// the classifier's PCM history (staged at buf's end) and the last good
// spectrum (staged at its start); then the pre-emphasized history `pe`
// (tdc_pe), dead once the gains are known but for its last 16 values, which
// `mem` keeps, whose end the generator's values then take (tdc_rnd); and the
// LPC residual `exc` (tdc_exc), dead once the harmonic cycle is built, whose
// storage the excitation then takes (tdc_e2). The rows that windowed sums
// read, a window of 32 a lane, are padded a word every 32 (tdc_pad: the
// history, pe, exc, the excitation), so that the lanes' reads fall in
// different banks. 13 176 bytes a warp: 16 warps an SM.
constexpr int kTdcPeWords = 1111;    // MP + fl/2 + order
constexpr int kTdcExcWords = 1095;   // MP + fl/2
constexpr int kTdcRndWords = 790;    // frame + overlap + L_FIR_HP - 1
ACX_HD constexpr int tdc_pad(int i) { return i + (i >> 5); }
ACX_HD constexpr int tdc_padded(int n) { return n > 0 ? tdc_pad(n - 1) + 1 : 0; }
constexpr int kTdcPeSpan = tdc_padded(kTdcPeWords);
constexpr int kTdcExcSpan = tdc_padded(kTdcExcWords);
constexpr int kTdcBufWords = kTdcPeSpan + kTdcExcSpan;
constexpr int kTdcSynthBlock = 16;   // samples a synthesis block
struct TdcWork {
  float buf[kTdcBufWords];
  float harm[855];          // the harmonic cycle in use
  float d2[kTdcMaxBands];
  float r[17];
  float a[17];
  float mem[kTdcOrder];     // the synthesis memory: pe's last 16 values or hist_in
  float scratch[32];
  float slot;
  float nc;                 // the classifier's results, from the leader to the warp
  int meth;
};
ACX_HD float* tdc_pe(TdcWork* ws) { return ws->buf; }
ACX_HD float* tdc_exc(TdcWork* ws) { return ws->buf + kTdcPeSpan; }
ACX_HD float* tdc_rnd(TdcWork* ws) { return ws->buf + (kTdcPeSpan - kTdcRndWords); }
ACX_HD float* tdc_e2(TdcWork* ws) { return tdc_exc(ws); }
ACX_HD float* tdc_hist_x(TdcWork* ws, int L) { return ws->buf + (kTdcBufWords - tdc_padded(L)); }
ACX_HD float* tdc_spec(TdcWork* ws) { return ws->buf; }
ACX_HD int tdc_synth_len(int length) {
  return (length + kTdcSynthBlock - 1) / kTdcSynthBlock * kTdcSynthBlock;
}
// The lane loops' chains a lane at once: n elements in groups of a lane's
// kTdcChains (i, i + 32, ...); group q starts at element (q / 32) * 32
// kTdcChains + q % 32
constexpr int kTdcChains = 2;
ACX_HD int tdc_groups(int n) { return (n + 32 * kTdcChains - 1) / (32 * kTdcChains) * 32; }
ACX_HD int tdc_group_first(int q) { return (q / 32) * 32 * kTdcChains + q % 32; }

ACX_HD int tdc_clip(int i, int n) { return iclamp(i, 0, n - 1); }

// classify (the classifier's correlation and centroid); leaves the method
// and norm_corr in ws->meth and ws->nc
template <class W>
ACX_HD void tdc_classify(const W& w, const TdcStream& s, const TdcGeom& g, const TdcTables& t,
                         TdcWork* ws) {
  const int L = g.L;
  const int p = s.pitch;
  const int corr_len = imin(imax(imin(L - p, g.rect), g.pitch_min2), g.rect);
  const int start = L - corr_len;
  // the history staged in shared memory, its loads in flight together
  float* x = tdc_hist_x(ws, L);
  w.each_loaded(L, [&](int i) { return s.x[i]; }, [&](int i, float v) { x[tdc_pad(i)] = v; });
  w.sync();
  auto cur = [&](int k) {
    return rmul(x[tdc_pad(tdc_clip(start + k, L))], k < corr_len ? 1.0f : 0.0f);
  };
  auto pred = [&](int k) {
    return rmul(x[tdc_pad(tdc_clip(start + k - p, L))], k < corr_len ? 1.0f : 0.0f);
  };
  const float num = wsum(w, g.rect, ws->scratch, &ws->slot, [&](int k) { return rmul(cur(k), pred(k)); });
  const float ec = wsum(w, g.rect, ws->scratch, &ws->slot, [&](int k) { return rmul(cur(k), cur(k)); });
  const float ep = wsum(w, g.rect, ws->scratch, &ws->slot, [&](int k) { return rmul(pred(k), pred(k)); });
  if (w.leader()) {
    const float den = radd(rroot(rmul(ec, ep)), 0x1.19799800p-40f);
    float nc = fclamp(rdiv(num, den), 0.0f, 1.0f);
    if (!(p > 0)) nc = 0.0f;
    float sn = 0.0f, sd = 0.0f;
    for (int i = 0; i < 16; ++i) {
      const float v = rmul(xla_exp2f(s.scf[i]), t.dee[i]);
      sn = xfma(v, t.cw[i], sn);
      sd = xfma(v, t.cw[16 + i], sd);
    }
    sd = radd(sd, 0x1p-31f);
    const float sc = rmul(rdiv(sn, sd), g.cent_fac);
    const float cls = rsub(xfma(0x1.dd8p-3f, nc, -sc), 0x1.3f800cp-3f);
    const int pitched = cls <= 0.0f ? (g.frame_dms == 100 ? 2 : 4) : 3;
    ws->meth = p > 0 ? pitched : 4;
    ws->nc = nc;
  }
  w.sync();
}

// tdc_lpc: LPC from the last good spectrum into ws->a
template <class W>
ACX_HD void tdc_lpc(const W& w, const TdcStream& s, const TdcGeom& g, const TdcTables& t,
                    TdcWork* ws) {
  const int ord = g.lpc_order;
  // the spectrum staged in shared memory, its loads in flight together
  float* q = tdc_spec(ws);
  w.each_loaded(g.N, [&](int k) { return s.q[k]; }, [&](int k, float v) { q[k] = v; });
  w.sync();
  w.each(g.n_bands, [&](int b) {
    float acc = 0.0f;
    for (int k = imax(t.off[b], 0); k < imin(t.off[b + 1], g.N); ++k) {
      acc = xfma(rmul(q[k], q[k]), t.lpc_w[b], acc);
    }
    ws->d2[b] = rmul(acc, t.pre[b]);
  });
  w.sync();
  // the inverse ODFT's column read 16 bands at a time, the loads before the
  // chain's steps
  w.each(ord + 1, [&](int i) {
    float acc = 0.0f;
    for (int b0 = 0; b0 < g.n_bands; b0 += 16) {
      float cv[16];
#pragma unroll
      for (int u = 0; u < 16; ++u) cv[u] = t.cosm[imin(b0 + u, g.n_bands - 1) * 17 + i];
#pragma unroll
      for (int u = 0; u < 16; ++u) {
        if (b0 + u < g.n_bands) acc = xfma(ws->d2[b0 + u], cv[u], acc);
      }
    }
    ws->r[i] = acc;
  });
  w.sync();
  if (w.leader()) {
    // the recursion's rows in registers (every index static once unrolled;
    // the steps past the order skipped whole)
    float r[kTdcOrder + 1], a[kTdcOrder + 1];
#pragma unroll
    for (int i = 0; i <= kTdcOrder; ++i) {
      r[i] = ws->r[i];
      a[i] = i == 0 ? 1.0f : 0.0f;
    }
    r[0] = fmax2(rmul(r[0], 0x1.00068ep+0f), 0x1.4484cp-100f);
#pragma unroll
    for (int i = 1; i <= kTdcOrder; ++i) {
      if (i <= ord) r[i] = rmul(r[i], t.lag[i - 1]);
    }
    float err = r[0];
#pragma unroll
    for (int m = 1; m <= kTdcOrder; ++m) {
      if (m <= ord) {
        float acc = r[m];
#pragma unroll
        for (int j = 1; j < m; ++j) acc = xfma(a[j], r[m - j], acc);
        const float k = fclamp(rdiv(-acc, fmax2(err, 0x1.4484cp-100f)), -0x1.ffffdep-1f,
                               0x1.ffffdep-1f);
        float na[kTdcOrder + 1];
#pragma unroll
        for (int i = 0; i <= kTdcOrder; ++i) na[i] = a[i];
#pragma unroll
        for (int j = 1; j <= (m + 1) / 2; ++j) {
          na[j] = xfma(k, a[m - j], a[j]);
          if (j != m - j) na[m - j] = xfma(k, a[j], a[m - j]);
        }
        na[m] = k;
#pragma unroll
        for (int i = 0; i <= kTdcOrder; ++i) a[i] = na[i];
        err = rmul(err, xfma(-k, k, 1.0f));
      }
    }
#pragma unroll
    for (int i = 0; i <= kTdcOrder; ++i) ws->a[i] = a[i];
  }
  w.sync();
}

// One block of 16 samples of the synthesis and de-emphasis over the
// coder-warp v (lanes l and l + 16 alike; q = l mod 16). Lane q holds P[n0 +
// q], the pending sum of its sample, and el its excitation e[n0 + q]. Step
// k: lane k's y = rsub(e, P) goes to every lane by a shuffle; lane q feeds
// it into its sum with the coefficient c[k] (a[(q - k) mod 16], a[16] where
// q == k, whose sum restarts from +0 as P[n0 + 16 + q]); every lane runs
// the de-emphasis m = xfma(pre, m, y); lane k keeps y and m. Each xfma is
// the double product and sum rounded once to float, as acodec.cuh's: on the
// chain of a sample a shuffle, a conversion, a double fused multiply-add, a
// conversion and a float subtraction. kGiven: the 16 values y come from
// `given` (the synthesis memory) and no output is made.
template <bool kGiven, class V>
ACX_HD void tdc_synth_block(const V& v, typename V::template Lanes<float>& P, float& m,
                            const typename V::template Lanes<double> (&c)[kTdcSynthBlock],
                            const typename V::template Lanes<float>& el, double pre,
                            const float* given, typename V::template Lanes<float>& ys,
                            typename V::template Lanes<float>& ms) {
#pragma unroll
  for (int k = 0; k < kTdcSynthBlock; ++k) {
    float y;
    if constexpr (kGiven) {
      y = given[k];
    } else {
      typename V::template Lanes<float> yc;
      v.lanes([&](int l) { yc[l] = rsub(el[l], P[l]); });
      y = v.shfl(yc, k);
    }
    const double yd = static_cast<double>(y);
    v.lanes([&](int l) {
      const float p = (l & 15) == k ? 0.0f : P[l];
      P[l] = to_float(rfma_f64(yd, c[k][l], static_cast<double>(p)));
    });
    if constexpr (!kGiven) {
      m = to_float(rfma_f64(pre, static_cast<double>(m), yd));
      v.lanes([&](int l) {
        if ((l & 15) == k) {
          ys[l] = y;
          ms[l] = m;
        }
      });
    }
  }
}

// The LPC synthesis and de-emphasis of a stream in transposed order
// (tdc_synth_block), e2 [length] in place (padded, tdc_pad): e2 the
// excitation in, the de-emphasized synthesis out; mem [16] y[-16..-1]; m0
// the de-emphasis memory (the history's last sample). The 16 values y at
// fl - 16 .. fl - 1 go to hist. e2 holds tdc_synth_len(length) values, zero
// past length.
template <class V>
ACX_HD void tdc_synth_warp(const V& v, const float* a, const float* mem, float* e2, int length,
                           int fl, float pre_fac, float m0, float* hist) {
  using LF = typename V::template Lanes<float>;
  typename V::template Lanes<double> c[kTdcSynthBlock];
  LF P, el, ys, ms;
#pragma unroll
  for (int k = 0; k < kTdcSynthBlock; ++k) {
    v.lanes([&](int l) {
      const int j = ((l & 15) - k) & 15;
      c[k][l] = static_cast<double>(a[j == 0 ? kTdcOrder : j]);
    });
  }
  // the memory fed in order: lane q then holds P[q]
  v.lanes([&](int l) { P[l] = 0.0f; });
  float m = m0;
  const double pre = static_cast<double>(pre_fac);
  tdc_synth_block<true>(v, P, m, c, el, pre, mem, ys, ms);
  const int n_all = tdc_synth_len(length);
  for (int n0 = 0; n0 < n_all; n0 += kTdcSynthBlock) {
    v.lanes([&](int l) { el[l] = e2[tdc_pad(n0 + (l & 15))]; });
    tdc_synth_block<false>(v, P, m, c, el, pre, nullptr, ys, ms);
    v.sync();     // every lane has read its e2 before any writes
    v.lanes([&](int l) {
      const int n = n0 + l;
      if (l < kTdcSynthBlock) {
        e2[tdc_pad(n)] = ms[l];
        if (n >= fl - kTdcOrder && n < fl) hist[n - (fl - kTdcOrder)] = ys[l];
      }
    });
  }
  v.sync();
}

// tdc_apply for one lane concealed by TD-PLC this frame (active), a in ws->a
template <class W>
ACX_HD void tdc_apply(const W& w, const TdcStream& s, const TdcGeom& g, const TdcTables& t,
                      TdcWork* ws, int fract) {
  const int fl = g.fl, L = g.L, MP = g.MP, length = g.length;
  const int nb = s.nb, nb_loc = nb;          // 10 ms units at 10 ms frames
  const bool first = nb == 1;
  const bool silent = nb_loc > 6;
  const int fl2 = fl / 2;
  const int span = MP + fl2 + kTdcOrder + 1;
  const int npe = span - 1, nexc = span - kTdcOrder - 1;
  float* pe = tdc_pe(ws);
  float* exc = tdc_exc(ws);
  int Tc = iclamp(s.pitch + (fract > 0 ? 1 : 0), 1, MP);
  float gain_c = s.gain_c_in, gain_p = s.alpha_in;
  int fract_out = fract;

  if (first) {
    // pre-emphasized history (its loads in flight together) and its LPC
    // residual
    struct Pair {
      float lo, hi;
    };
    w.each_loaded(npe, [&](int j) {
      // pe[0] reads the zero before the span
      return Pair{s.x[L - span + j], s.x[L - span + j + 1]};
    }, [&](int j, Pair v) { pe[tdc_pad(j)] = xfma(-g.pre_fac, v.lo, v.hi); });
    w.sync();
    float a[kTdcOrder + 1];
    double ad[kTdcOrder + 1];
    for (int j = 0; j <= kTdcOrder; ++j) {
      a[j] = ws->a[j];
      ad[j] = static_cast<double>(a[j]);
    }
    // kTdcChains outputs of a lane at once (i, i + 32, ...), their chains
    // interleaved in one block of code; each xfma a double fused
    // multiply-add rounded to float by (x + M) - M (dct4.cuh), no conversion
    // of the sum; where a rounding left that range the chains are taken again
    // with xfma
    w.each(tdc_groups(nexc), [&](int q) {
      const int t0 = tdc_group_first(q);
      int pt[kTdcChains];     // pe's index of the output's newest tap
      double acc[kTdcChains];
      bool far = false;
#pragma unroll
      for (int u = 0; u < kTdcChains; ++u) {
        pt[u] = kTdcOrder + imin(t0 + 32 * u, nexc - 1);
        acc[u] = round_float_near(
            rfma_f64(ad[0], static_cast<double>(pe[tdc_pad(pt[u])]),
                     static_cast<double>(rmul(a[1], pe[tdc_pad(pt[u] - 1)]))), far);
      }
#pragma unroll
      for (int j = 2; j <= kTdcOrder; ++j) {
#pragma unroll
        for (int u = 0; u < kTdcChains; ++u) {
          acc[u] = round_float_near(
              rfma_f64(ad[j], static_cast<double>(pe[tdc_pad(pt[u] - j)]), acc[u]), far);
        }
      }
      float v[kTdcChains];
#pragma unroll
      for (int u = 0; u < kTdcChains; ++u) v[u] = to_float(acc[u]);
      if (far) {
        for (int u = 0; u < kTdcChains; ++u) {
          v[u] = xfma(a[0], pe[tdc_pad(pt[u])], rmul(a[1], pe[tdc_pad(pt[u] - 1)]));
          for (int j = 2; j <= kTdcOrder; ++j) v[u] = xfma(a[j], pe[tdc_pad(pt[u] - j)], v[u]);
        }
      }
#pragma unroll
      for (int u = 0; u < kTdcChains; ++u) {
        if (t0 + 32 * u < nexc) exc[tdc_pad(t0 + 32 * u)] = v[u];
      }
    });
    w.sync();
    auto pe_at = [&](int from_end, int k) {
      return pe[tdc_pad(tdc_clip(npe - from_end + k, npe))];
    };
    auto gainp = [&](int lag) {
      const float xy = wsum(w, fl2, ws->scratch, &ws->slot,
                            [&](int k) { return rmul(pe_at(fl2, k), pe_at(lag + fl2, k)); });
      const float yy = wsum(w, fl2, ws->scratch, &ws->slot,
                            [&](int k) { return rmul(pe_at(lag + fl2, k), pe_at(lag + fl2, k)); });
      return rdiv(xy, fmax2(yy, 0x1.12e0bep-30f));
    };
    const bool same = s.pitch == Tc;
    const float g_same = gainp(Tc);
    const float g_a = gainp(Tc - 1);
    const bool pick = !same && g_a > g_same;
    Tc = pick ? s.pitch : Tc;
    fract_out = pick ? 0 : fract;
    const float gain_p0 = fclamp(same ? g_same : (pick ? g_a : g_same), 0.0f, 1.0f);
    auto exc_at = [&](int from_end, int k) {
      return exc[tdc_pad(tdc_clip(nexc - from_end + k, nexc))];
    };
    auto gainc = [&](int lag) {
      float gsum = wsum(w, fl2, ws->scratch, &ws->slot, [&](int k) {
        const float d = xfma(-gain_p0, exc_at(lag + fl2, k), exc_at(fl2, k));
        return rmul(d, d);
      });
      if (g.frame_dms < 100) {
        gsum = fmin2(gsum, wsum(w, fl2, ws->scratch, &ws->slot,
                                [&](int k) { return rmul(exc_at(fl2, k), exc_at(fl2, k)); }));
      }
      return rroot(rmul(gsum, 1.0f / static_cast<float>(fl2)));
    };
    const float gc_tc = gainc(Tc);
    gain_c = s.pitch == Tc ? gc_tc : fmin2(gc_tc, gainc(s.pitch));
    gain_p = gain_p0;
  }

  // damping (plc_tdc_main_fx.c:243-320)
  const float alpha_prev = first ? 1.0f : s.alpha_in;
  const float a1 = gain_p > 0x1.ebb98cp-1f ? 0x1.f5c29p-1f
                   : (gain_p < 0x1.b6147ap-1f ? 0x1.d9999ap-1f : rroot(gain_p));
  const float c1 = nb_loc == 2 ? 0x1.428f5cp-1f : 0x1.4dd2f2p-1f;
  const float c2 = nb_loc == 2 ? 0x1.666666p-2f : 0x1.4fdf3cp-2f;
  float a2 = rmul(xfma(s.stab, c2, c1), gain_p);
  if (nb_loc == 2 && a2 < 0x1.d6872cp-1f) a2 = 0x1.d6872cp-1f;
  float alpha = nb_loc == 1 ? a1 : a2;
  if (nb_loc > 3) alpha = rmul(alpha, g.atten);
  if (nb_loc > 5) gain_p = alpha;

  // the synthesis memory, kept before the generator's values take pe's
  // storage
  w.each(kTdcOrder, [&](int k) {
    ws->mem[k] = first ? pe[tdc_pad(npe - kTdcOrder + k)] : s.hist_in[k];
  });
  w.sync();
  // the harmonic cycle (first loss): the residual's last Tc samples,
  // smoothed unless the spectrum is stable
  int hlen = s.hlen_in;
  if (first) {
    const int T = Tc;
    if (s.stab >= 1.0f) {
      w.each(MP, [&](int k) {
        ws->harm[k] = exc[tdc_pad(tdc_clip(nexc - T + k % imax(T, 1), nexc))];
      });
    } else {
      float hh[kTdcFir];
      for (int m = 0; m < kTdcFir; ++m) hh[m] = t.hh[m];
      w.template each_u<kTdcChains>(MP, [&](int k) {
        auto tap = [&](int m) {
          int o = k + (m - (kTdcFir - 1) / 2);
          if (o >= T) o -= T;
          return exc[tdc_pad(tdc_clip(nexc - T + o, nexc))];
        };
        float v = rmul(tap(0), hh[0]);
#pragma unroll
        for (int m = 1; m < kTdcFir; ++m) v = radd(v, rmul(tap(m), hh[m]));
        ws->harm[k] = v;
      });
    }
    hlen = T;
  } else {
    w.each_loaded(MP, [&](int k) { return s.harm_in[k]; },
                  [&](int k, float v) { ws->harm[k] = v; });
  }
  w.sync();     // exc is dead from here: the excitation takes its storage
  // the random part: the generator's values, high-passed
  float* rnd = tdc_rnd(ws);
  float* e2 = tdc_e2(ws);
  const int nr = length + kTdcFir - 1;
  w.each_loaded(nr, [&](int k) { return lcg16_at(s.seed_in, k + 1, t.pows, nr); },
                [&](int k, int v) { rnd[k] = static_cast<float>(v); });
  w.sync();
  const float throttle = rdiv(static_cast<float>(nb_loc), static_cast<float>(nb_loc + 30));
  const float blend = rmul(rsub(1.0f, alpha), throttle);
  {
    float hp[kTdcFir];
    double hpd[kTdcFir];
    for (int m = 0; m < kTdcFir; ++m) {
      hp[m] = t.hp[m];
      hpd[m] = static_cast<double>(hp[m]);
    }
    // the residual's chains a lane at once and their rounding (above)
    w.each(tdc_groups(length), [&](int q) {
      const int i0 = tdc_group_first(q);
      const float* rr[kTdcChains];
      double hd[kTdcChains];
      bool far = false;
#pragma unroll
      for (int u = 0; u < kTdcChains; ++u) {
        rr[u] = rnd + imin(i0 + 32 * u, length - 1);
        hd[u] = round_float_near(rfma_f64(static_cast<double>(rr[u][0]), hpd[0],
                                          static_cast<double>(rmul(rr[u][1], hp[1]))), far);
      }
#pragma unroll
      for (int m = 2; m < kTdcFir; ++m) {
#pragma unroll
        for (int u = 0; u < kTdcChains; ++u) {
          hd[u] = round_float_near(rfma_f64(static_cast<double>(rr[u][m]), hpd[m], hd[u]), far);
        }
      }
      float h[kTdcChains];
#pragma unroll
      for (int u = 0; u < kTdcChains; ++u) h[u] = to_float(hd[u]);
      if (far) {
        for (int u = 0; u < kTdcChains; ++u) {
          h[u] = xfma(rr[u][0], hp[0], rmul(rr[u][1], hp[1]));
          for (int m = 2; m < kTdcFir; ++m) h[u] = xfma(rr[u][m], hp[m], h[u]);
        }
      }
#pragma unroll
      for (int u = 0; u < kTdcChains; ++u) {
        const int i = i0 + 32 * u;
        if (i < length) {
          e2[tdc_pad(i)] = first ? h[u]
                        : xfma(blend, rr[u][(kTdcFir - 1) / 2], rmul(rsub(1.0f, blend), h[u]));
        }
      }
    });
  }
  w.sync();
  const float ss = wsum(w, fl, ws->scratch, &ws->slot, [&](int i) {
    const float e = rmul(e2[tdc_pad(i)], 0.0625f);
    return rmul(e, e);
  });
  const float den = xfma(ss, 2.0f * (1.0f / static_cast<float>(fl)), 0x1.47ae14p-7f);
  const float gain_inov = rmul(xfma(-0.75f, gain_p, 0x1.19999ap+0f), xla_rsqrtf(den, t.rsq));

  // the total excitation with its gain ramps, zero past the frame up to the
  // synthesis's last block
  const float inv_fl = 1.0f / static_cast<float>(fl);
  const float step = rmul(rsub(alpha_prev, alpha), inv_fl);
  const float gc_end = rdiv(rmul(gain_c, alpha), fmax2(alpha_prev, 0x1.12e0bep-30f));
  const float step_n = rmul(rsub(gain_c, gc_end), inv_fl);
  const int hl = imax(hlen, 1);
  const int hoff = ((nb - 1) * fl) % hl;
  w.each(tdc_synth_len(length), [&](int i) {
    if (i >= length) {
      e2[tdc_pad(i)] = 0.0f;
      return;
    }
    const float fi = static_cast<float>(i);
    const float gh = fmax2(xfma(-step, fi, alpha_prev), 0.0f);
    const float gc = fmax2(xfma(-step_n, fi, gain_c), 0.0f);
    const float q = rmul(rmul(gc, gain_inov), 0.0625f);
    const float hv = ws->harm[iclamp((hoff + i) % hl, 0, MP - 1)];
    e2[tdc_pad(i)] = xfma(hv, gh, rmul(e2[tdc_pad(i)], q));
  });
  w.sync();

  // LPC synthesis and de-emphasis in transposed order, 16 lanes
  const float* mem = ws->mem;
  tdc_synth_warp(w.coder(), ws->a, mem, e2, length, fl, g.pre_fac, s.x[L - 1], s.hist);
  const bool last = nb_loc == 6;
  w.each(length, [&](int n) {
    float v = e2[tdc_pad(n)];
    if (last) v = rmul(v, fmax2(xfma(static_cast<float>(n), -inv_fl, 1.0f), 0.0f));
    s.synth[n] = silent ? 0.0f : v;
  });
  w.each(MP, [&](int k) { s.harm[k] = ws->harm[k]; });
  if (w.leader()) {
    *s.seed = lcg16_at(s.seed_in, nr, t.pows, nr);
    *s.gain_c = silent ? 0.0f : gc_end;
    *s.alpha = silent ? 0.0f : alpha;
    *s.fract = first ? fract_out : fract;
    *s.hlen = hlen;
  }
}

// The whole stream: the plain version's composition (plc_tdc_plain).
template <class W>
ACX_HD void plc_tdc_stream(const W& w, const TdcStream& s, const TdcGeom& g, const TdcTables& t,
                           TdcWork* ws) {
  const bool lost = s.lost != 0;
  const bool first = lost && s.nb == 1;
  int meth = s.meth_in;
  float nc = 0.0f;
  if (first) {
    tdc_classify(w, s, g, t, ws);
    meth = ws->meth;
    nc = ws->nc;
    tdc_lpc(w, s, g, t, ws);
  } else {
    w.each(kTdcOrder + 1, [&](int i) { ws->a[i] = s.a_in[i]; });
    w.sync();
  }
  const int fract = first ? s.pitch_fr : s.fract_in;
  w.each(kTdcOrder + 1, [&](int i) { s.a[i] = ws->a[i]; });
  if (lost && meth == 3) {
    tdc_apply(w, s, g, t, ws, fract);
  } else {
    w.each(g.length, [&](int n) { s.synth[n] = 0.0f; });
    w.each_loaded(g.MP, [&](int k) { return s.harm_in[k]; },
                  [&](int k, float v) { s.harm[k] = v; });
    w.each(kTdcOrder, [&](int k) { s.hist[k] = s.hist_in[k]; });
    if (w.leader()) {
      *s.seed = s.seed_in;
      *s.gain_c = s.gain_c_in;
      *s.alpha = s.alpha_in;
      *s.fract = fract;
      *s.hlen = s.hlen_in;
    }
  }
  if (w.leader()) {
    *s.meth = meth;
    *s.nc = nc;
  }
  w.sync();
}

}  // namespace acx
