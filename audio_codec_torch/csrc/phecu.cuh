// One stream of the Phase ECU (phecu_spec_ana.cu, phecu_subst.cu): the
// first-loss peak analysis and group energies, and the per-frame burst
// analysis and spectrum substitution (ops/plc_phecu.py:
// phecu_spec_ana_plain, phecu_subst_plain). The analysis is written over
// the warps of warp.cuh, the substitution over a warp policy (plc.cuh).
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

// the substitution's per-group factors (ph_burst, ph_subst_stream)
struct PhWork {
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

// Group g of bin k (gwlpr_fx starts: 1, 12, 20, 36, 68, 132, 196, 260, 324;
// bin 0 in group 0).
ACX_HD int ph_group_start(int g) {
  constexpr int kStarts[kPhGroups + 1] = {0, 12, 20, 36, 68, 132, 196, 260, 324, 1 << 20};
  return kStarts[iclamp(g, 0, kPhGroups)];
}
ACX_HD int ph_group(int k) {
  int g = 0;
#pragma unroll
  for (int b = 1; b < kPhGroups; ++b) g = k >= ph_group_start(b) ? b : g;
  return g;
}

// ---- the first-loss analysis: the stream's work over the lanes of a warp
// (phecu_spec_ana.cu) ----
//
// ph_spec_ana_warp runs ops/plc_phecu.py:phecu_spec_ana_plain's steps for
// one stream (the plain version's _peaks and _group_energy) on a warp of
// warp.cuh:
//  - the four rows are loaded once, a bin a lane, every load of a lane in
//    flight, and staged in the warp's shared scratch with |X|^2 of both
//    spectra and |X|;
//  - the maximum and minimum magnitude are warp reductions of their bits:
//    a magnitude is the root of a sum of two squares, +0 or above (never -0:
//    (-0)^2 is +0; never NaN for finite spectra; +inf at worst), and such
//    floats order as their bits do, so the extremes are the same in any
//    grouping;
//  - the 18 group energies (9 groups of each spectrum) run on lanes 0-17,
//    each over its own group's bins in ascending order from +0, as the
//    plain version's product by the 0/1 group matrix sums them; a window of
//    8 bins is loaded ahead, and bins past the group's end add +0, which
//    leaves a sum >= +0 as it is;
//  - the hysteresis scan stays one chain in bin order (its state feeds
//    every comparison after it), run by every lane alike on magnitudes read
//    four at a time. Its step is short: the thresholds radd(ref, sens) and
//    rsub(cand, sens) are kept in place of ref and cand where the tests read
//    them (rounding is monotone, so radd(min(ref, m), sens) =
//    min(radd(ref, sens), radd(m, sens))), each new value's threshold is
//    computed off the chain, and the state is selected with bit operations,
//    not branched. The step touches no memory: where the scan takes a
//    candidate and where it finds a new peak are bits in two registers,
//    stored once a chunk of 32 bins, and the peaks follow from them
//    afterwards, a bin a lane (a take whose next event is a new peak, or the
//    last event of all);
//  - the peak count and the low-frequency test are ballots;
//  - the refinement runs a bin a lane from the staged rows.

constexpr int kPhPad = (kPhBins + 3) / 4 * 4;   // a staged row, 16-byte multiple
constexpr int kPhWords = (kPhBins + 31) / 32;  // rounds of 32 bins

// a warp's shared scratch
struct alignas(16) PhAnaWork {
  float mag[kPhPad], xr[kPhPad], xi[kPhPad], sq[2][kPhPad];   // sq: |X|^2, |Xo|^2
  uint32_t take[kPhWords], peak[kPhWords];   // the scan's events, a bit a bin
};

// all ones where p holds; a where mask is all ones, else b: selects as bit
// operations, which the compiler keeps as such (a select of floats on a
// condition it may compile into a branch)
ACX_HD uint32_t all_if(bool p) { return 0u - static_cast<uint32_t>(p); }
ACX_HD float fsel_bits(uint32_t mask, float a, float b) {
  return float_of(static_cast<int>((static_cast<uint32_t>(bits_of(a)) & mask) |
                                   (static_cast<uint32_t>(bits_of(b)) & ~mask)));
}

// four consecutive staged values from a 16-byte aligned address
ACX_HD void ph_load4(const float* p, float* v) {
#ifdef __CUDA_ARCH__
  const float4 q = *reinterpret_cast<const float4*>(p);
  v[0] = q.x;
  v[1] = q.y;
  v[2] = q.z;
  v[3] = q.w;
#else
  for (int j = 0; j < 4; ++j) v[j] = p[j];
#endif
}

// phecu_spec_ana for one stream at its first loss on warp w (warp.cuh):
// writes f0est [ns], num_plocs and the two group energies [9] (e_oold from
// Xo, e_old from X).
template <class W>
ACX_HD void ph_spec_ana_warp(const W& w, const PhGeom& g, const float* xr, const float* xi,
                             const float* xor_, const float* xoi, float nc, PhAnaWork* ws,
                             float* f0, int* npl_out, float* e_oold, float* e_old) {
  using IL = typename W::template Lanes<int>;
  const int ns = g.ns;
  // stage the rows; each lane's largest and smallest magnitude bits
  IL mxL, mnL;
  w.lanes([&](int l) {
    float a[kPhWords], b[kPhWords], c[kPhWords], d[kPhWords];
#pragma unroll
    for (int u = 0; u < kPhWords; ++u) {
      const int k = imin(l + 32 * u, ns - 1);
      a[u] = xr[k];
      b[u] = xi[k];
      c[u] = xor_[k];
      d[u] = xoi[k];
    }
    int mx = 0, mn = 0x7FFFFFFF;
#pragma unroll
    for (int u = 0; u < kPhWords; ++u) {
      const int k = l + 32 * u;
      if (k < ns) {
        const float s = ph_sq(a[u], b[u]), m = rroot(s);
        ws->xr[k] = a[u];
        ws->xi[k] = b[u];
        ws->sq[0][k] = s;
        ws->sq[1][k] = ph_sq(c[u], d[u]);
        ws->mag[k] = m;
        mx = imax(mx, bits_of(m));
        mn = imin(mn, bits_of(m));
      }
    }
    mxL[l] = mx;
    mnL[l] = -mn;
  });
  w.sync();
  const float mx = float_of(w.reduce_max(mxL)), mn = float_of(-w.reduce_max(mnL));
  const float sens = rmul(rsub(mx, mn), 0x1.1ecp-4f);
  // group energies: lane j sums group j % 9 of X (j < 9) or of Xo, ascending
  w.lanes([&](int l) {
    if (l < 2 * kPhGroups) {
      const int grp = l % kPhGroups;
      const int src = grp < g.n_lgw ? grp : g.n_lgw - 1;
      const int lo = imin(ph_group_start(src), ns), hi = imin(ph_group_start(src + 1), ns);
      const float* e = ws->sq[l < kPhGroups ? 0 : 1];
      float acc = 0.0f;
      for (int k0 = lo; k0 < hi; k0 += 8) {
        float v[8];
#pragma unroll
        for (int j = 0; j < 8; ++j) v[j] = k0 + j < hi ? e[imin(k0 + j, ns - 1)] : 0.0f;
#pragma unroll
        for (int j = 0; j < 8; ++j) acc = radd(acc, v[j]);
      }
      (l < kPhGroups ? e_old : e_oold)[grp] = acc;
    }
  });
  // the hysteresis scan (every lane alike), a chunk of 32 bins a round:
  // each step's take (a rise or a better candidate) and new peak kept as
  // bits, stored once a chunk
  const int nw = (ns + 31) / 32;
  float thr = radd(ws->mag[0], sens);   // radd(ref, sens)
  float thp = rsub(0.0f, sens);         // rsub(cand, sens)
  float cand = 0.0f;
  uint32_t mode = 0;                    // mode 1: all ones
  auto step = [&](float m, int j, uint32_t& tb, uint32_t& nb) {
    const float mr = radd(m, sens), mp = rsub(m, sens);
    const uint32_t rising = all_if(m > thr) & ~mode;
    const uint32_t new_peak = all_if(m < thp) & mode;
    const uint32_t better = all_if(m >= cand) & mode;
    const uint32_t take = rising | better;
    cand = fsel_bits(take, m, cand);
    thp = fsel_bits(take, mp, thp);
    thr = fsel_bits(new_peak, mr, fsel_bits(mode, thr, fmin2(thr, mr)));
    mode = rising | (mode & ~new_peak);
    tb |= take & (1u << j);
    nb |= new_peak & (1u << j);
  };
  for (int c = 0; c < nw; ++c) {
    uint32_t tb = 0, nb = 0;
    if (32 * c + 32 <= ns) {
#pragma unroll
      for (int j0 = 0; j0 < 32; j0 += 4) {
        float v[4];
        ph_load4(ws->mag + 32 * c + j0, v);
#pragma unroll
        for (int j = 0; j < 4; ++j) step(v[j], j0 + j, tb, nb);
      }
    } else {   // the last chunk, shorter
      for (int j = 0; j < ns - 32 * c; ++j) step(ws->mag[32 * c + j], j, tb, nb);
    }
    ws->take[c] = tb;
    ws->peak[c] = nb;
  }
  w.sync();
  // the peaks: a new peak marks the candidate, the last take before it, and
  // a scan that ends in mode 1 the last take of all; so a take is a peak
  // where the next event (a take or a new peak) is a new peak, or none
  // follows. Their count and the low-frequency test (a peak in bins 1-6)
  // are ballots; bit u of a lane's word marks its bin l + 32 u.
  using UL = typename W::template Lanes<uint32_t>;
  UL mine;
  int count = 0;
  bool lf = false;
  for (int u = 0; u < nw; ++u) {
    IL pk;
    w.lanes([&](int l) {
      bool is_peak = false;
      if (l + 32 * u < ns && ((ws->take[u] >> l) & 1u) != 0) {
        uint32_t e = (ws->take[u] | ws->peak[u]) & ~((2u << l) - 1u);
        int at = u;
        while (e == 0 && ++at < nw) e = ws->take[at] | ws->peak[at];
        is_peak = e == 0 || (ws->peak[at] & e & (0u - e)) != 0;
      }
      pk[l] = is_peak;
      if (u == 0) mine[l] = 0;
      mine[l] |= static_cast<uint32_t>(is_peak) << u;
    });
    const unsigned bal = w.ballot(pk);
    count += popc32(bal);
    if (u == 0) lf = (bal & 0x7Eu) != 0;
  }
  const bool drop = nc > 0.0f && nc < 0.5f && count > 14 && lf;
  w.leader([&] { *npl_out = drop ? 0 : count; });
  // the refinement, a bin a lane
  w.lanes([&](int l) {
    for (int u = 0, k = l; k < ns; ++u, k += 32) {
      float v = -1.0f;
      if (((mine[l] >> u) & 1u) != 0 && !drop) {
        const float rm1 = k > 0 ? ws->xr[k - 1] : 0.0f, im1 = k > 0 ? ws->xi[k - 1] : 0.0f;
        const float rp1 = k + 1 < ns ? ws->xr[k + 1] : 0.0f, ip1 = k + 1 < ns ? ws->xi[k + 1] : 0.0f;
        float frac;
        if (k < 2 || k >= ns - 2) {
          const float mm1 = k > 0 ? ws->mag[k - 1] : 0.0f, mp1 = k + 1 < ns ? ws->mag[k + 1] : 0.0f;
          const float pden = radd(rsub(mm1, rmul(2.0f, ws->mag[k])), mp1);
          frac = rdiv(rmul(0.5f, rsub(mm1, mp1)), fabsf(pden) > 0x1.197998p-40f ? pden : 1.0f);
        } else {
          const float nr = rsub(rm1, rp1), ni = rsub(im1, ip1);
          const float dr = rsub(rsub(rmul(2.0f, ws->xr[k]), rm1), rp1);
          const float di = rsub(rsub(rmul(2.0f, ws->xi[k]), im1), ip1);
          const float re = xfma(nr, dr, rmul(ni, di));
          const float dd = xfma(dr, dr, rmul(di, di));
          frac = rdiv(rmul(0x1.249518p+0f, re), fmax2(dd, 0x1.197998p-40f));
        }
        v = radd(static_cast<float>(k), fclamp(frac, -1.0f, 1.0f));
      }
      f0[k] = v;
    }
  });
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
