// One stream of the Phase ECU (phecu_spec_ana.cu, phecu_subst.cu): the
// first-loss peak analysis and group energies, and the per-frame burst
// analysis and spectrum substitution (ops/plc_phecu.py:
// phecu_spec_ana_plain, phecu_subst_plain). Written over a warp policy
// (plc.cuh).
#pragma once

#include "plc.cuh"

namespace acx {

constexpr int kPhBins = 321;    // search_bins at 48 kHz
constexpr int kPhAll = 385;     // nbins: Lprot / 2 + 1
constexpr int kPhGroups = 9;    // MAX_LGW
constexpr int kPhDelta = 5;     // DELTA_CORR

struct PhGeom {
  int ns;          // search bins
  int nsf;         // all bins
  int n_lgw;       // groups that hold bins (the rest copy the last)
  int fl;          // frame length
  int t_adv;       // phase-evolution time advance
  int lprot;       // prototype length
};

struct PhWork {
  float mag[kPhBins];
  int mask[kPhBins];
  float scratch[32];
  float slot;
  float mc[kPhGroups], alpha[kPhGroups], beta[kPhGroups];
};

ACX_HD float ph_sq(float r, float i) { return radd(rmul(r, r), rmul(i, i)); }

// On the card the sine and cosine are sinf and cosf, which torch.sin and
// torch.cos compute for a tensor there; the host build (the rehearsal) takes
// the double's, correctly rounded, and so does the plain version there.
ACX_HD float ph_cos(float x) {
#ifdef __CUDA_ARCH__
  return cosf(x);
#else
  return static_cast<float>(std::cos(static_cast<double>(x)));
#endif
}
ACX_HD float ph_sin(float x) {
#ifdef __CUDA_ARCH__
  return sinf(x);
#else
  return static_cast<float>(std::sin(static_cast<double>(x)));
#endif
}

// Group g of bin k (gwlpr_fx starts: 1, 12, 20, 36, 68, 132, 196, 260, 324).
ACX_HD int ph_group(int k) {
  const int starts[kPhGroups] = {1, 12, 20, 36, 68, 132, 196, 260, 324};
  int g = 0;
#pragma unroll
  for (int b = 0; b < kPhGroups; ++b) g = k >= starts[b] ? b : g;
  return g;
}

// phecu_spec_ana for one stream at its first loss: writes f0est [ns],
// num_plocs and the two group energies [9] (e_oold from Xo, e_old from X).
template <class W>
ACX_HD void ph_spec_ana_stream(const W& w, const PhGeom& g, const float* xr, const float* xi,
                               const float* xor_, const float* xoi, float nc, PhWork* ws,
                               float* f0, int* npl_out, float* e_oold, float* e_old) {
  const int ns = g.ns;
  w.each(ns, [&](int k) {
    ws->mag[k] = rroot(ph_sq(xr[k], xi[k]));
    ws->mask[k] = 0;
  });
  w.sync();
  if (w.leader()) {
    // sensitivity, then the hysteresis scan over the bins
    float mx = ws->mag[0], mn = ws->mag[0];
    for (int k = 1; k < ns; ++k) {
      mx = fmax2(mx, ws->mag[k]);
      mn = fmin2(mn, ws->mag[k]);
    }
    const float sens = rmul(rsub(mx, mn), 0x1.1ecp-4f);
    float ref = ws->mag[0], cand = 0.0f;
    int cand_idx = 0, mode = 0;
    for (int k = 0; k < ns; ++k) {
      const float m = ws->mag[k];
      const bool rising = mode == 0 && m > radd(ref, sens);
      const bool new_peak = mode == 1 && m < rsub(cand, sens);
      const bool better = mode == 1 && m >= cand;
      if (new_peak) ws->mask[iclamp(cand_idx, 0, ns - 1)] = 1;
      if (rising || better) {
        cand = m;
        cand_idx = k;
      }
      ref = new_peak ? m : (mode == 0 ? fmin2(ref, m) : ref);
      mode = rising ? 1 : (new_peak ? 0 : mode);
    }
    if (mode == 1) ws->mask[iclamp(cand_idx, 0, ns - 1)] = 1;
    int count = 0;
    bool lf = false;
    for (int k = 0; k < ns; ++k) {
      count += ws->mask[k];
      if (k >= 1 && k < 7 && ws->mask[k]) lf = true;
    }
    const bool drop = nc > 0.0f && nc < 0.5f && count > 14 && lf;
    *npl_out = drop ? 0 : count;
    ws->slot = drop ? 1.0f : 0.0f;
  }
  w.sync();
  const bool drop = ws->slot != 0.0f;
  w.each(ns, [&](int k) {
    float v = -1.0f;
    if (ws->mask[k] && !drop) {
      const float rm1 = k > 0 ? xr[k - 1] : 0.0f, im1 = k > 0 ? xi[k - 1] : 0.0f;
      const float rp1 = k + 1 < ns ? xr[k + 1] : 0.0f, ip1 = k + 1 < ns ? xi[k + 1] : 0.0f;
      float frac;
      if (k < 2 || k >= ns - 2) {
        const float mm1 = k > 0 ? ws->mag[k - 1] : 0.0f, mp1 = k + 1 < ns ? ws->mag[k + 1] : 0.0f;
        const float pden = radd(rsub(mm1, rmul(2.0f, ws->mag[k])), mp1);
        frac = rdiv(rmul(0.5f, rsub(mm1, mp1)), fabsf(pden) > 0x1.197998p-40f ? pden : 1.0f);
      } else {
        const float nr = rsub(rm1, rp1), ni = rsub(im1, ip1);
        const float dr = rsub(rsub(rmul(2.0f, xr[k]), rm1), rp1);
        const float di = rsub(rsub(rmul(2.0f, xi[k]), im1), ip1);
        const float re = xfma(nr, dr, rmul(ni, di));
        const float dd = xfma(dr, dr, rmul(di, di));
        frac = rdiv(rmul(0x1.249518p+0f, re), fmax2(dd, 0x1.197998p-40f));
      }
      v = radd(static_cast<float>(k), fclamp(frac, -1.0f, 1.0f));
    }
    f0[k] = v;
  });
  // group energies: lane g sums group g, ascending
  w.each(2 * kPhGroups, [&](int j) {
    const int grp = j % kPhGroups;
    const float* r = j < kPhGroups ? xr : xor_;
    const float* i = j < kPhGroups ? xi : xoi;
    float acc = 0.0f;
    const int src = grp < g.n_lgw ? grp : g.n_lgw - 1;
    for (int k = 0; k < ns; ++k) {
      if (ph_group(k) == src) acc = radd(acc, ph_sq(r[k], i[k]));
    }
    (j < kPhGroups ? e_old : e_oold)[grp] = acc;
  });
  w.sync();
}

// trans_burst_ana's attenuations for the substitution (group g), into ws
template <class W>
ACX_HD void ph_burst(const W& w, int nb, const float* e_oold, const float* e_old, const float* mc1,
                     float beta_mute, PhWork* ws) {
  const bool first = nb <= 1;
  const float bm = first ? 0.25f : (nb > 4 ? rmul(beta_mute, 0.5f) : beta_mute);
  w.each(kPhGroups, [&](int gi) {
    const float el = fmax2(e_oold[gi], 0x1.12e0bep-30f), er = fmax2(e_old[gi], 0x1.12e0bep-30f);
    const bool tr = el <= rmul(0x1.99999ap-4f, er) || rmul(0x1.99999ap-4f, el) >= er;
    const float att1 = (tr && er < el) ? rroot(rdiv(er, el)) : 1.0f;
    const float m1 = first ? att1 : mc1[gi];
    const float att = xla_exp2f(-static_cast<float>(iclamp(nb - 2, 0, 30)));
    const float mc = first ? att1 : rmul(m1, att);
    const float alpha = first ? 1.0f : mc;
    float beta = first ? 0.0f : rmul(bm, rroot(fmax2(xfma(-alpha, alpha, 1.0f), 0.0f)));
    beta = rmul(beta, gi >= 6 ? 0x1.99999ap-4f : (gi >= 4 ? 0.5f : 1.0f));
    beta = rmul(beta, (nb == 2 && m1 < 1.0f) ? 0.5f : 1.0f);
    ws->mc[gi] = mc;
    ws->alpha[gi] = alpha;
    ws->beta[gi] = beta;
  });
  w.sync();
}

// The LCG state of rand_phase_fx at bin k from seed0: tables A [ns] ++ B [ns].
ACX_HD float ph_rand(int seed0, int k, const int32_t* tab, int ns) {
  const uint32_t s0 = static_cast<uint32_t>(((seed0 % 65536) + 65536) % 65536);
  const uint32_t s = (s0 * static_cast<uint32_t>(tab[k]) + static_cast<uint32_t>(tab[ns + k])) & 0xFFFFu;
  return rmul(0x1.921fb6p-3f, static_cast<float>(s >> 11));
}

// phecu_subst for one concealed stream: out [nsf] real and imaginary parts.
template <class W>
ACX_HD void ph_subst_stream(const W& w, const PhGeom& g, const float* xr, const float* xi,
                            const float* f0, int num_plocs, int nb, int is_trans,
                            const float* xavg, const int32_t* tab, PhWork* ws, float* outr,
                            float* outi) {
  const int ns = g.ns, nsf = g.nsf, nyq = nsf - 1;
  const int time_offs = imax(nb - 1, 0) * g.fl;
  const int burst_len = time_offs / g.fl + 1;
  const int npl = is_trans ? 0 : num_plocs;
  const float adv = static_cast<float>(g.t_adv + time_offs);
  const float inv_lp = 1.0f / static_cast<float>(g.lprot);
  auto is_peak = [&](int k) { return f0[k] >= 0.0f && npl > 0; };
  auto ang = [&](int k) {
    return rmul(rmul(rmul(0x1.921fb6p+2f, is_peak(k) ? f0[k] : 0.0f), adv), inv_lp);
  };
  const bool burst = burst_len > 3;
  w.each(nsf, [&](int k) {
    float r, i;
    if (k >= ns) {
      r = xr[k];
      i = xi[k];
    } else if (k == 0 || k >= imin(ns, nyq)) {
      r = xr[k];
      i = xi[k];
    } else {
      // the nearest peak within DELTA_CORR: the bin itself, then k + d before k - d
      bool assigned = is_peak(k);
      float pa = assigned ? ang(k) : 0.0f;
#pragma unroll
      for (int d = 1; d <= kPhDelta; ++d) {
        if (!assigned && k + d < ns && is_peak(k + d)) {
          assigned = true;
          pa = ang(k + d);
        }
        if (!assigned && k - d >= 0 && is_peak(k - d)) {
          assigned = true;
          pa = ang(k - d);
        }
      }
      const float ph1 = ph_rand(time_offs, k, tab, ns), ph2 = ph_rand(time_offs + 1, k, tab, ns);
      const float theta = assigned ? pa : ph1;
      const float c = ph_cos(theta), s = ph_sin(theta);
      float rr = xfma(xr[k], c, -rmul(xi[k], s));
      float ri = xfma(xr[k], s, rmul(xi[k], c));
      if ((npl == 0 || time_offs != 0) && !assigned) {
        const float vfac = radd(1.0f, rmul(0.25f, radd(rmul(0.5f, rsub(rmul(ph2, 0x1.45f306p-2f), 1.0f)),
                                                       rmul(0.5f, ph_cos(ph1)))));
        rr = rmul(rr, vfac);
        ri = rmul(ri, vfac);
      }
      const int gi = ph_group(k);
      const bool zero = npl > 0 && npl < 3 && !assigned;
      if (zero) rr = ri = 0.0f;
      const float amp = zero ? 0.0f : rmul(ws->beta[gi], xavg[gi]);
      r = xfma(ws->mc[gi], rr, rmul(amp, ph_cos(ph2)));
      i = xfma(ws->mc[gi], ri, rmul(amp, ph_sin(ph2)));
    }
    if (k == 0) {
      r = npl == 0 ? 0.0f : xr[0];
      i = npl == 0 ? 0.0f : xi[0];
      if (burst) {
        r = rmul(r, ws->alpha[0]);
        i = rmul(i, ws->alpha[0]);
      }
    }
    if (k == nyq) {
      r = npl == 0 ? 0.0f : r;
      if (burst) r = rmul(r, ws->alpha[g.n_lgw - 1]);
      i = 0.0f;
    }
    outr[k] = r;
    outi[k] = i;
  });
}

}  // namespace acx
