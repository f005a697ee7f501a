// The steps of fx_spec_decode.cu: one frame's fixed-point spectral chain
// (ops/fixed_dev.py:spectrum_decode_plain), written once over the group of
// threads that runs it (fixed.cuh: a warp on the card, one thread in the
// rehearsal, tests/test_torch_lane_rehearsal.py).
#pragma once

#include "fixed.cuh"

namespace acx {
namespace fx {

// the table pack (kernels.py:fx_spec_table_pack): bandwidth cutoffs, TNS
// quantizer points, InvLog2's three tables, then at kSpecLcg the LCG's
// closed form (A^r and the sums, r = 0..yLen) and the band of each bin
constexpr int kSpecBw = 0, kSpecPts = 6, kSpecE3 = 23, kSpecE2 = 55, kSpecE1 = 87, kSpecLcg = 119;

struct SpecGeom {
  int yLen, N, n_bands, frame_dms, gg_off, R;
};

// the side words of a lane (kernels.py:fx_spec_decode)
enum SpecSide { kNRes, kNfSeed, kZeroFrame, kFacNs, kBwIdx, kGgIdx, kOrder0, kOrder1, kSpecSideWords };

// BASOP_Util_InvLog2: 2^(x in Q25) in Q31
ACX_HD i64 inv_log2(const i64* tab, i64 x) {
  if (x < -1040187392) return 0;
  if (x >= 1040187392 || x == 0) return MAX32;
  const i64 frac = x & 0x3FF;
  const i64 i3 = (x >> 10) & 0x1F, i2 = (x >> 15) & 0x1F, i1 = (x >> 20) & 0x1F;
  i64 e = x >> 25;
  e = x > 0 ? 31 - e : -e;
  const i64 lookup3f = tab[kSpecE3 + i3] + (mpy_32_16(0x0016302F, frac) >> 1);
  const i64 lookup12 = mpy_32_32(tab[kSpecE1 + i1], tab[kSpecE2 + i2]);
  return L_shl(mpy_32_32(lookup12, lookup3f), -(e - 3));
}

// getScaleFactor32 over bins [lo, hi) of x: the least norm_l of the nonzero
// values, 0 if there is none
template <class W>
ACX_HD i64 headroom32(const W& w, const i64* x, int lo, int hi) {
  i64 m = 63;
  w.each(hi > lo ? hi - lo : 0, [&](int k) {
    const i64 v = x[lo + k];
    if (v != 0) m = min64(m, norm_l(v));
  });
  m = w.min(m);
  return m == 63 ? 0 : m;
}

// One lane: the range decoder's x [yLen] (int32) and residual bits [R], the
// side words, tns_idx [16], the bands' scf and scf_e [n_bands] -> the shaped
// spectrum out [N] and its exponent. xs: yLen words of scratch; run: yLen
// ints (the run of zeros ending at each bin).
template <class W>
ACX_HD void fx_spec_decode_lane(const W& w, const int32_t* x, const int32_t* res,
                                const int32_t* sd, const int32_t* tidx, const i64* scf,
                                const i64* scf_e, const i64* tab, const SpecGeom& g, i64* xs,
                                int32_t* run, i64* out, i64* x_e_out) {
  const int n = g.yLen;
  const i64* lcg_a = tab + kSpecLcg;
  const i64* lcg_c = lcg_a + n + 1;
  const i64* bmap = lcg_c + n + 1;
  // ---- processAriDecoderScaling_fx
  i64 mx = 0;
  w.each(n, [&](int i) {
    const i64 v = x[i] < 0 ? -static_cast<i64>(x[i]) : x[i];
    mx = max64(mx, v);
  });
  mx = w.max(mx);
  const i64 shift = mx == 0 ? 15 : norm_s(mx);
  // a value above Word16 would make the shift negative: 0, as the plain
  // version and XLA's shift by a negative count give
  w.each(n, [&](int i) { xs[i] = shift >= 0 ? shl64(shl64(x[i], 16), shift) : 0; });
  i64 x_e = 15 - shift;
  w.sync();
  // ---- processResidualDecoding_fx: each nonzero bin takes the residual bit
  // of its rank among the nonzero bins (the plain version's cumsum), a
  // prefix count over the group
  const i64 fac_m = L_shl(0x0C000000, -(x_e - 1)), fac_p = L_shl(0x14000000, -(x_e - 1));
  const i64 n_res = sd[kNRes];
  w.scan_count(n, [&](int i) { return xs[i] != 0; }, [&](int i, int rank, bool nz) {
    if (nz && rank < n_res && rank < g.R) {
      const i64 v = xs[i];
      const bool pos = v > 0;
      const i64 delta = res[rank] == 0 ? (pos ? -fac_m : -fac_p) : (pos ? fac_p : fac_m);
      xs[i] = sat32(v + delta);
    }
  });
  w.sync();
  // ---- processNoiseFilling_fx, not on zero frames
  const i64 bw_idx = sd[kBwIdx];
  const i64 bw_bin = tab[kSpecBw + clamp64(bw_idx, 0, 5)];
  if (sd[kZeroFrame] == 0) {
    const int sh = g.frame_dms == 25 ? 2 : (g.frame_dms == 50 ? 1 : 0);
    const int nfw = g.frame_dms == 25 ? 1 : (g.frame_dms == 50 ? 2 : 3);
    const int nfs = g.frame_dms == 25 ? 6 : (g.frame_dms == 50 ? 12 : 24);
    const i64 Nbw = bw_bin >> sh;
    // the zero run ending at each bin (the plain version's cummax: the last
    // nonzero bin at or before it), a scan over the group
    w.scan_last(n, [&](int i) { return xs[i] != 0; },
                [&](int i, int last) { run[i] = i - last; });
    w.sync();
    // the selected bins, and each one's LCG step from its 1-based rank among
    // them (the plain version's cumsum), a prefix count over the group;
    // the selection reads only the runs, so the filled bins go to xs at once
    const i64 re_last = run[clamp64(Nbw - 1, 0, n - 1)];
    const i64 v = L_shl(shl64(8 - sd[kFacNs], 11), -(x_e - 16));
    const i64 seed0 = static_cast<i64>(sd[kNfSeed]) & 0xFFFF;
    auto selected = [&](int k) {
      const i64 re_kn = k + nfw < n ? run[k + nfw] : 0;
      const bool in_main = k >= nfs && k < Nbw - nfw;
      const bool in_tail = k >= max64(Nbw - nfw, nfs) && k < Nbw;
      return (in_main && re_kn >= 2 * nfw + 1) || (in_tail && re_last >= nfw + Nbw - k);
    };
    w.scan_count(n, selected, [&](int k, int rank, bool sel) {
      if (sel) {
        const i64 su = (lcg_a[rank + 1] * seed0 + lcg_c[rank + 1]) & 0xFFFF;
        xs[k] = su < 0x8000 ? v : -v;
      }
    });
    w.sync();
  }
  // ---- processApplyGlobalGain_fx
  const i64 tmp32 = sat32(shl64((static_cast<i64>(sd[kGgIdx]) + g.gg_off) * 0x797D, 7));
  const i64 gg = round_fx(inv_log2(tab, tmp32 | -33554432LL));
  x_e += (tmp32 >> 25) + 1;
  w.each(n, [&](int i) { xs[i] = mpy_32_16(xs[i], gg); });
  w.sync();
  // ---- processTnsDecoder_fx
  const int start0 = g.frame_dms == 25 ? 3 : (g.frame_dms == 50 ? 6 : 12);
  const i64 bw_stop = bw_bin >> (g.frame_dms == 25 ? 2 : (g.frame_dms == 50 ? 1 : 0));
  const bool numf2 = bw_idx >= 3 && g.frame_dms >= 50;
  const i64 start1 = bw_stop >> 1;
  const i64 o0 = sd[kOrder0], o1 = numf2 ? sd[kOrder1] : 0;
  if (o0 > 0 || o1 > 0) {
    const i64 f = (numf2 && o0 == 0) ? start1 : start0;
    const i64 fc = clamp64(f, 0, n);
    const i64 s1 = headroom32(w, xs, 0, static_cast<int>(fc));
    const i64 s2 = headroom32(w, xs, static_cast<int>(fc), n);
    const i64 s = min64(s1, s2 - 7);
    x_e -= s;
    w.sync();
    if (w.leader()) {
      // the lattice, its state carried from bin to bin (lane 0): state and
      // coefficients in registers, every index static once unrolled
      i64 rc0[8], rc1[8], st[8];
#pragma unroll
      for (int k = 0; k < 8; ++k) {
        rc0[k] = tab[kSpecPts + clamp64(tidx[k], 0, 16)];
        rc1[k] = tab[kSpecPts + clamp64(tidx[8 + k], 0, 16)];
        st[k] = 0;
      }
      const i64 stop1 = numf2 ? start1 : bw_stop;
      for (int i = 0; i < n; ++i) {
        const bool in_f1 = i >= start0 && i < stop1 && o0 > 0;
        const bool in_f2 = numf2 && i >= start1 && i < bw_stop && o1 > 0;
        i64 xi = L_shl(xs[i], s);
        if (in_f1 || in_f2) {
          const i64 o = in_f2 ? o1 : o0;
          const i64 om1 = clamp64(o - 1, 0, 7);
          i64 rc[8], st_om1 = 0, rc_om1 = 0;
#pragma unroll
          for (int k = 0; k < 8; ++k) {
            rc[k] = in_f2 ? rc1[k] : rc0[k];
            if (k == om1) {
              st_om1 = st[k];
              rc_om1 = rc[k];
            }
          }
          xi = sat32(xi - mpy_32_16(st_om1, rc_om1));
#pragma unroll
          for (int kk = 6; kk >= 0; --kk) {
            if (kk <= o - 2) {
              xi = sat32(xi - mpy_32_16(st[kk], rc[kk]));
              st[kk + 1] = sat32(st[kk] + mpy_32_16(xi, rc[kk]));
            }
          }
          st[0] = xi;
        }
        xs[i] = xi;
      }
    }
    w.sync();
  }
  // ---- processScfScaling, processMdctShaping_fx, zeros to the frame's end
  i64 m = MIN32;
  w.each(g.n_bands, [&](int b) { m = max64(m, scf_e[b]); });
  m = w.max(m);
  w.each(g.N, [&](int i) {
    if (i < n) {
      const i64 b = bmap[i];
      out[i] = L_shl(mpy_32_16(xs[i], scf[b]), scf_e[b] - m);
    } else {
      out[i] = 0;
    }
  });
  if (w.leader()) *x_e_out = x_e + m;
}

}  // namespace fx
}  // namespace acx
