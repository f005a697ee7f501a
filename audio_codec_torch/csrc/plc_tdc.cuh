// One stream of the advanced concealment's time-domain part (plc_tdc.cu):
// the method classifier and the LPC analysis at the first loss of a burst,
// then one frame of TD-PLC where the method is 3 (ops/plc_adv.py:
// plc_tdc_plain, which composes classify, tdc_lpc and tdc_apply as the
// reference decoder does). Written over a warp policy (plc.cuh).
#pragma once

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
struct TdcWork {
  float pe[1111];      // pre-emphasized history (MP + fl/2 + order)
  float exc[1095];     // LPC residual (MP + fl/2)
  float e2[780];       // high-passed noise, then the excitation, then the synthesis
  float rnd[790];      // the generator's values
  float harm[855];     // the harmonic cycle in use
  float d2[kTdcMaxBands];
  float r[17];
  float a[17];
  float na[kTdcOrder + 1];   // the Levinson step's new coefficients
  float scratch[32];
  float slot;
  float nc;            // the classifier's results, from the leader to the warp
  int meth;
};

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
  auto cur = [&](int k) {
    return rmul(s.x[tdc_clip(start + k, L)], k < corr_len ? 1.0f : 0.0f);
  };
  auto pred = [&](int k) {
    return rmul(s.x[tdc_clip(start + k - p, L)], k < corr_len ? 1.0f : 0.0f);
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
  w.each(g.n_bands, [&](int b) {
    float acc = 0.0f;
    for (int k = imax(t.off[b], 0); k < imin(t.off[b + 1], g.N); ++k) {
      acc = xfma(rmul(s.q[k], s.q[k]), t.lpc_w[b], acc);
    }
    ws->d2[b] = rmul(acc, t.pre[b]);
  });
  w.sync();
  w.each(ord + 1, [&](int i) {
    float acc = 0.0f;
    for (int b = 0; b < g.n_bands; ++b) acc = xfma(ws->d2[b], t.cosm[b * 17 + i], acc);
    ws->r[i] = acc;
  });
  w.sync();
  if (w.leader()) {
    float* r = ws->r;
    float* a = ws->a;
    r[0] = fmax2(rmul(r[0], 0x1.00068ep+0f), 0x1.4484cp-100f);
    for (int i = 1; i <= ord; ++i) r[i] = rmul(r[i], t.lag[i - 1]);
    for (int i = 0; i <= kTdcOrder; ++i) a[i] = i == 0 ? 1.0f : 0.0f;
    float err = r[0];
    float* na = ws->na;
    for (int m = 1; m <= ord; ++m) {
      float acc = r[m];
      for (int j = 1; j < m; ++j) acc = xfma(a[j], r[m - j], acc);
      const float k = fclamp(rdiv(-acc, fmax2(err, 0x1.4484cp-100f)), -0x1.ffffdep-1f,
                             0x1.ffffdep-1f);
      for (int i = 0; i <= kTdcOrder; ++i) na[i] = a[i];
      for (int j = 1; j <= (m + 1) / 2; ++j) {
        na[j] = xfma(k, a[m - j], a[j]);
        if (j != m - j) na[m - j] = xfma(k, a[j], a[m - j]);
      }
      na[m] = k;
      for (int i = 0; i <= kTdcOrder; ++i) a[i] = na[i];
      err = rmul(err, xfma(-k, k, 1.0f));
    }
  }
  w.sync();
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
  const float* a = ws->a;
  int Tc = iclamp(s.pitch + (fract > 0 ? 1 : 0), 1, MP);
  float gain_c = s.gain_c_in, gain_p = s.alpha_in;
  int fract_out = fract;

  if (first) {
    // pre-emphasized history and its LPC residual
    w.each(npe, [&](int j) {
      const int i = j + 1;      // pe[0] reads the zero before the span
      ws->pe[j] = xfma(-g.pre_fac, s.x[L - span + i - 1], s.x[L - span + i]);
    });
    w.sync();
    w.each(nexc, [&](int tt) {
      float acc = xfma(a[0], ws->pe[kTdcOrder + tt], rmul(a[1], ws->pe[kTdcOrder - 1 + tt]));
      for (int j = 2; j <= kTdcOrder; ++j) acc = xfma(a[j], ws->pe[kTdcOrder - j + tt], acc);
      ws->exc[tt] = acc;
    });
    w.sync();
    auto pe_at = [&](int from_end, int k) { return ws->pe[tdc_clip(npe - from_end + k, npe)]; };
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
    auto exc_at = [&](int from_end, int k) { return ws->exc[tdc_clip(nexc - from_end + k, nexc)]; };
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

  // the harmonic cycle (first loss): the residual's last Tc samples,
  // smoothed unless the spectrum is stable
  int hlen = s.hlen_in;
  if (first) {
    const int T = Tc;
    w.each(MP, [&](int k) {
      float v;
      if (s.stab >= 1.0f) {
        v = ws->exc[tdc_clip(nexc - T + k % imax(T, 1), nexc)];
      } else {
        auto tap = [&](int m) {
          int o = k + (m - (kTdcFir - 1) / 2);
          if (o >= T) o -= T;
          return ws->exc[tdc_clip(nexc - T + o, nexc)];
        };
        v = rmul(tap(0), t.hh[0]);
        for (int m = 1; m < kTdcFir; ++m) v = radd(v, rmul(tap(m), t.hh[m]));
      }
      ws->harm[k] = v;
    });
    hlen = T;
  } else {
    w.each(MP, [&](int k) { ws->harm[k] = s.harm_in[k]; });
  }
  // the random part: the generator's values, high-passed
  const int nr = length + kTdcFir - 1;
  w.each(nr, [&](int k) { ws->rnd[k] = static_cast<float>(lcg16_at(s.seed_in, k + 1, t.pows, nr)); });
  w.sync();
  const float throttle = rdiv(static_cast<float>(nb_loc), static_cast<float>(nb_loc + 30));
  const float blend = rmul(rsub(1.0f, alpha), throttle);
  w.each(length, [&](int i) {
    float hp = xfma(ws->rnd[i], t.hp[0], rmul(ws->rnd[i + 1], t.hp[1]));
    for (int m = 2; m < kTdcFir; ++m) hp = xfma(ws->rnd[i + m], t.hp[m], hp);
    ws->e2[i] = first ? hp
                      : xfma(blend, ws->rnd[i + (kTdcFir - 1) / 2], rmul(rsub(1.0f, blend), hp));
  });
  w.sync();
  const float ss = wsum(w, fl, ws->scratch, &ws->slot, [&](int i) {
    const float e = rmul(ws->e2[i], 0.0625f);
    return rmul(e, e);
  });
  const float den = xfma(ss, 2.0f * (1.0f / static_cast<float>(fl)), 0x1.47ae14p-7f);
  const float gain_inov = rmul(xfma(-0.75f, gain_p, 0x1.19999ap+0f), xla_rsqrtf(den, t.rsq));

  // the total excitation with its gain ramps
  const float inv_fl = 1.0f / static_cast<float>(fl);
  const float step = rmul(rsub(alpha_prev, alpha), inv_fl);
  const float gc_end = rdiv(rmul(gain_c, alpha), fmax2(alpha_prev, 0x1.12e0bep-30f));
  const float step_n = rmul(rsub(gain_c, gc_end), inv_fl);
  const int hl = imax(hlen, 1);
  const int hoff = ((nb - 1) * fl) % hl;
  w.each(length, [&](int i) {
    const float fi = static_cast<float>(i);
    const float gh = fmax2(xfma(-step, fi, alpha_prev), 0.0f);
    const float gc = fmax2(xfma(-step_n, fi, gain_c), 0.0f);
    const float q = rmul(rmul(gc, gain_inov), 0.0625f);
    const float hv = ws->harm[iclamp((hoff + i) % hl, 0, MP - 1)];
    ws->e2[i] = xfma(hv, gh, rmul(ws->e2[i], q));
  });
  w.sync();

  // LPC synthesis and de-emphasis: one lane, sample by sample
  if (w.leader()) {
    float mem[kTdcOrder];
    for (int k = 0; k < kTdcOrder; ++k) {
      mem[k] = first ? ws->pe[npe - kTdcOrder + k] : s.hist_in[k];
    }
    float arev[kTdcOrder];
    for (int k = 0; k < kTdcOrder; ++k) arev[k] = a[kTdcOrder - k];
    for (int n = 0; n < length; ++n) {
      float acc = 0.0f;
#pragma unroll
      for (int k = 0; k < kTdcOrder; ++k) acc = xfma(mem[k], arev[k], acc);
      const float y = rsub(ws->e2[n], acc);
#pragma unroll
      for (int k = 0; k < kTdcOrder - 1; ++k) mem[k] = mem[k + 1];
      mem[kTdcOrder - 1] = y;
      ws->e2[n] = y;
    }
    for (int k = 0; k < kTdcOrder; ++k) s.hist[k] = ws->e2[fl - kTdcOrder + k];
    float m = s.x[L - 1];
    for (int n = 0; n < length; ++n) {
      m = xfma(g.pre_fac, m, ws->e2[n]);
      ws->e2[n] = m;
    }
  }
  w.sync();
  const bool last = nb_loc == 6;
  w.each(length, [&](int n) {
    float v = ws->e2[n];
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
    w.each(g.MP, [&](int k) { s.harm[k] = s.harm_in[k]; });
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
