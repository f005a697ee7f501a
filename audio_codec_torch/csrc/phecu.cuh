// One stream of the Phase ECU (phecu_spec_ana.cu, phecu_subst.cu): the
// first-loss peak analysis and group energies, and the per-frame burst
// analysis and spectrum substitution (ops/plc_phecu.py:
// phecu_spec_ana_plain, phecu_subst_plain). Both are written over the
// warps of warp.cuh.
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
ACX_HD int ph_group(int k) {   // the starts from 36 on are 4 + 64 (g - 3) + 32
  return k >= 36 ? imin(3 + ((k - 4) >> 6), kPhGroups - 1) : (k >= 20 ? 2 : (k >= 12 ? 1 : 0));
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

// ---- the burst analysis and the substitution: the stream's work over the
// lanes of a warp (phecu_subst.cu) ----
//
// ph_subst_warp runs ops/plc_phecu.py:phecu_subst_plain's steps for one
// concealed stream (the plain version's trans_burst_ana and _subst) on a
// warp of warp.cuh, bin k on lane k % 32:
//  - every load of a lane is issued first: the row (13 bins a lane), the
//    peak row and the generator's jumps tab[k], tab[ns + k] (11 bins a
//    lane), each loaded once for both of the generator's seeds, and the
//    group rows; the bins' outputs are computed into registers before any
//    is stored;
//  - the nine groups' factors run on lanes 0-8 (ph_burst_warp), the
//    product beta * xavg of a group computed there once;
//  - the peak mask (f0 >= 0 and num_plocs > 0) is a string of 11 ballot
//    words held by every lane; a bin's nearest peak within DELTA_CORR, in
//    the plain version's order (the bin itself, then k + d before k - d for
//    d = 1..5), is the lowest set bit of the string's six bits from k up
//    against the highest of its six bits up to k: no read per neighbour;
//  - a peak's angle is computed once, by the lane of its bin, and its
//    cosine and sine once, a peak a lane in the order of the peaks (the
//    angles compacted by rank, the count of set bits below the peak); a bin
//    finds its peak's values by that rank;
//  - the generator's phases take 32 values, pi / 16 times the top five bits
//    of the state: lane l makes the cosine and sine of phase l, at the very
//    argument ph1 and ph2 take, so that cos(ph1), cos(ph2), sin(ph2) and,
//    on a bin no peak claims, cos(theta) and sin(theta) are table reads (32
//    floats, one a bank: no conflict). The sine and cosine are the card's
//    accurate sinf and cosf everywhere (ph_cos, ph_sin);
//  - a bin's choices (its peak's values or the table's, the valley
//    scaling, the zero rule, the interior, DC and Nyquist) are selects of
//    bits, not branches, so that the 13 bins of a lane run interleaved.

constexpr int kPhRounds = (kPhAll + 31) / 32;   // rounds of 32 bins of a row
constexpr float kPhStep = 0x1.921fb6p-3f;       // f32(2 pi / 32), a generator phase's step

// a warp's shared scratch
struct alignas(16) PhWork {
  float mc[kPhGroups], alpha[kPhGroups], amp[kPhGroups];   // amp: beta * xavg
  float tc[32], ts[32];                   // cosine and sine of the 32 generator phases
  float pc[kPhBins], ps[kPhBins];         // a peak's angle, then its cosine; its sine (by rank)
};

// a stream's group rows, group g on lane g (the lanes past them hold group 8)
template <class W>
struct PhGroups {
  typename W::template Lanes<float> e_oold, e_old, mc1, xavg;
};

// trans_burst_ana's attenuations for the substitution, group g on lane g
template <class W>
ACX_HD void ph_burst_warp(const W& w, int nb, const PhGroups<W>& gr, float beta_mute, PhWork* ws) {
  const bool first = nb <= 1;
  const float bm = first ? 0.25f : (nb > 4 ? rmul(beta_mute, 0.5f) : beta_mute);
  w.lanes([&](int gi) {
    if (gi >= kPhGroups) return;
    const float el = fmax2(gr.e_oold[gi], 0x1.12e0bep-30f);
    const float er = fmax2(gr.e_old[gi], 0x1.12e0bep-30f);
    const bool tr = el <= rmul(0x1.99999ap-4f, er) || rmul(0x1.99999ap-4f, el) >= er;
    const float att1 = (tr && er < el) ? rroot(rdiv(er, el)) : 1.0f;
    const float m1 = first ? att1 : gr.mc1[gi];
    const float att = xla_exp2f(-static_cast<float>(iclamp(nb - 2, 0, 30)));
    const float mc = first ? att1 : rmul(m1, att);
    const float alpha = first ? 1.0f : mc;
    float beta = first ? 0.0f : rmul(bm, rroot(fmax2(xfma(-alpha, alpha, 1.0f), 0.0f)));
    beta = rmul(beta, gi >= 6 ? 0x1.99999ap-4f : (gi >= 4 ? 0.5f : 1.0f));
    beta = rmul(beta, (nb == 2 && m1 < 1.0f) ? 0.5f : 1.0f);
    ws->mc[gi] = mc;
    ws->alpha[gi] = alpha;
    ws->amp[gi] = rmul(beta, gr.xavg[gi]);
  });
}

// The generator phase index (the top five bits of rand_phase_fx's state)
// at a bin from seed0, given the bin's jumps a = tab[k], c = tab[ns + k].
ACX_HD int ph_phase(uint32_t s0, int32_t a, int32_t c) {
  const uint32_t s = (s0 * static_cast<uint32_t>(a) + static_cast<uint32_t>(c)) & 0xFFFFu;
  return static_cast<int>(s >> 11);
}
ACX_HD uint32_t ph_seed(int seed0) {
  return static_cast<uint32_t>(((seed0 % 65536) + 65536) % 65536);
}

// phecu_subst for one concealed stream on warp w: out [nsf] real and
// imaginary parts. f0: the stream's peaks [ns]; e_oold, e_old, mc1, xavg:
// its group rows [9].
template <class W>
ACX_HD void ph_subst_warp(const W& w, const PhGeom& g, const float* xr, const float* xi,
                          const float* f0, int num_plocs, int nb, int is_trans,
                          const float* e_oold, const float* e_old, const float* mc1,
                          float beta_mute, const float* xavg, const int32_t* tab, PhWork* ws,
                          float* outr, float* outi) {
  using FL = typename W::template Lanes<float>;
  using IL = typename W::template Lanes<int>;
  const int ns = g.ns, nsf = g.nsf, nyq = nsf - 1, hi = imin(ns, nyq);
  const int time_offs = imax(nb - 1, 0) * g.fl;
  const bool burst = time_offs / g.fl + 1 > 3;
  const int npl = is_trans ? 0 : num_plocs;
  const float adv = static_cast<float>(g.t_adv + time_offs);
  const float inv_lp = 1.0f / static_cast<float>(g.lprot);
  // every load of a lane first; the generator phases' cosines and sines
  // while they are in flight
  FL re[kPhRounds], im[kPhRounds], fk[kPhWords];
  IL ja[kPhWords], jc[kPhWords];
  PhGroups<W> gr;
  w.lanes([&](int l) {
    const int gl = imin(l, kPhGroups - 1);
    gr.e_oold[l] = e_oold[gl];
    gr.e_old[l] = e_old[gl];
    gr.mc1[l] = mc1[gl];
    gr.xavg[l] = xavg[gl];
#pragma unroll
    for (int u = 0; u < kPhRounds; ++u) {
      const int k = imin(l + 32 * u, nsf - 1);
      re[u][l] = xr[k];
      im[u][l] = xi[k];
    }
#pragma unroll
    for (int u = 0; u < kPhWords; ++u) {
      const int k = imin(l + 32 * u, ns - 1);
      fk[u][l] = f0[k];
      ja[u][l] = tab[k];
      jc[u][l] = tab[ns + k];
    }
    const float ph = rmul(kPhStep, static_cast<float>(l));
    ws->tc[l] = ph_cos(ph);
    ws->ts[l] = ph_sin(ph);
  });
  ph_burst_warp(w, nb, gr, beta_mute, ws);
  // the peak mask: bit l of word u marks bin l + 32 u; cum[u]: the peaks
  // before word u
  uint32_t word[kPhWords + 1];
  int cum[kPhWords + 1];
  cum[0] = 0;
#pragma unroll
  for (int u = 0; u < kPhWords; ++u) {
    IL p;
    w.lanes([&](int l) { p[l] = l + 32 * u < ns && fk[u][l] >= 0.0f && npl > 0; });
    word[u] = w.ballot(p);
    cum[u + 1] = cum[u] + popc32(word[u]);
  }
  word[kPhWords] = 0u;
  const int npk = cum[kPhWords];
  // each peak's angle at its rank, by the lane of its bin
  w.lanes([&](int l) {
#pragma unroll
    for (int u = 0; u < kPhWords; ++u) {
      if ((word[u] >> l) & 1u) {
        ws->pc[cum[u] + popc32(word[u] & ((1u << l) - 1u))] =
            rmul(rmul(rmul(0x1.921fb6p+2f, fk[u][l]), adv), inv_lp);
      }
    }
  });
  w.sync();
  // each peak's cosine and sine, a peak a lane
  w.lanes([&](int l) {
    for (int j = l; j < npk; j += 32) {
      const float a = ws->pc[j];
      ws->pc[j] = ph_cos(a);
      ws->ps[j] = ph_sin(a);
    }
  });
  w.sync();
  // the bins into registers, every bin before any store (a store between
  // them would keep each bin's loads of the scratch behind the bin before)
  const uint32_t s1 = ph_seed(time_offs), s2 = ph_seed(time_offs + 1);
  w.lanes([&](int l) {
#pragma unroll
    for (int u = 0; u < kPhRounds; ++u) {
      const int k = l + 32 * u;
      float r = re[u][l], i = im[u][l];
      if (u < kPhWords) {
        const int su = u < kPhWords ? u : 0;   // (a static index below kPhWords)
        // the nearest peak: bits k..k+5 from k up, bits k-5..k up to k
        const uint32_t lo = su > 0 ? word[su - 1] : 0u, mid = word[su], up_w = word[su + 1];
        const uint64_t w_up = (static_cast<uint64_t>(up_w) << 32) | mid;
        const uint64_t w_dn = (static_cast<uint64_t>(mid) << 32) | lo;
        const uint32_t up = static_cast<uint32_t>(w_up >> l) & 0x3Fu;
        const uint32_t dn = static_cast<uint32_t>(w_dn >> (27 + l)) & 0x3Fu;
        const int du = up ? msb32(static_cast<int>(up & (0u - up))) : kPhDelta + 1;
        const int dd = dn ? kPhDelta - msb32(static_cast<int>(dn)) : kPhDelta + 1;
        const bool assigned = imin(du, dd) <= kPhDelta;
        // the peak's rank: the peaks before its word and before it in the word
        const int kp = du <= dd ? k + du : k - dd, side = (kp >> 5) - su;   // -1, 0 or 1
        const uint32_t wv = side < 0 ? lo : (side > 0 ? up_w : mid);
        const int before = side < 0 ? cum[su > 0 ? su - 1 : 0] : (side > 0 ? cum[su + 1] : cum[su]);
        const int rank = imin(before + popc32(wv & ((1u << (kp & 31)) - 1u)), kPhBins - 1);
        const int p1 = ph_phase(s1, ja[su][l], jc[su][l]), p2 = ph_phase(s2, ja[su][l], jc[su][l]);
        const uint32_t am = all_if(assigned);
        const float c = fsel_bits(am, ws->pc[rank], ws->tc[p1]);
        const float s = fsel_bits(am, ws->ps[rank], ws->ts[p1]);
        float rr = xfma(r, c, -rmul(i, s));
        float ri = xfma(r, s, rmul(i, c));
        const float ph2 = rmul(kPhStep, static_cast<float>(p2));
        const float vfac = radd(1.0f, rmul(0.25f, radd(rmul(0.5f, rsub(rmul(ph2, 0x1.45f306p-2f), 1.0f)),
                                                       rmul(0.5f, ws->tc[p1]))));
        const uint32_t scale = all_if((npl == 0 || time_offs != 0) && !assigned);
        rr = fsel_bits(scale, rmul(rr, vfac), rr);
        ri = fsel_bits(scale, rmul(ri, vfac), ri);
        const int gi = ph_group(k);
        const uint32_t zero = all_if(npl > 0 && npl < 3 && !assigned);
        rr = fsel_bits(zero, 0.0f, rr);
        ri = fsel_bits(zero, 0.0f, ri);
        const float amp = fsel_bits(zero, 0.0f, ws->amp[gi]);
        const uint32_t interior = all_if(k >= 1 && k < hi);
        r = fsel_bits(interior, xfma(ws->mc[gi], rr, rmul(amp, ws->tc[p2])), r);
        i = fsel_bits(interior, xfma(ws->mc[gi], ri, rmul(amp, ws->ts[p2])), i);
      }
      // DC and Nyquist
      const uint32_t none = all_if(npl == 0), att = all_if(burst);
      const float dr = fsel_bits(none, 0.0f, r), di = fsel_bits(none, 0.0f, i);
      if (u == 0) {
        const uint32_t dc = all_if(k == 0);
        r = fsel_bits(dc, fsel_bits(att, rmul(dr, ws->alpha[0]), dr), r);
        i = fsel_bits(dc, fsel_bits(att, rmul(di, ws->alpha[0]), di), i);
      }
      const uint32_t ny = all_if(k == nyq);
      r = fsel_bits(ny, fsel_bits(att, rmul(dr, ws->alpha[g.n_lgw - 1]), dr), r);
      i = fsel_bits(ny, 0.0f, i);
      re[u][l] = r;
      im[u][l] = i;
    }
#pragma unroll
    for (int u = 0; u < kPhRounds; ++u) {
      const int k = l + 32 * u;
      if (k < nsf) {
        outr[k] = re[u][l];
        outi[k] = im[u][l];
      }
    }
  });
}

}  // namespace acx
