// The steps of fx_spec_decode.cu: the fixed-point spectral chain of up to
// kFxSpecFrames frames (ops/fixed_dev.py:spectrum_decode_plain), written
// once over the group of threads that runs it (fixed.cuh: a warp on the
// card, one thread in the rehearsal) and, for the TNS lattice, over the
// coder-warp (warp.cuh: lane registers and shuffles; the host's runs the 32
// lanes of a step in turn, every lane read before any is written).
//
// The lattice (processTnsDecoder_fx, the plain version's scan over the
// bins) feeds its output back (st[0] = xi), so its bins stay in order; but
// tap kk of bin i needs only tap kk + 1 of the same bin (the chain xi) and
// tap kk - 1 of bin i - 1 (its update of st[kk]). Tap kk lies on lane kk of
// an 8-lane group, a frame a group, four frames a warp, and runs bin i at
// step 2 (i - lo) + 7 - kk (fx_tns_wave): each step passes xi down one lane
// and the update up one lane. The arithmetic is integer, so the result is
// the plain version's wherever each saturation falls in the same order.
// Every value is a Word32 (each stage ends in a saturation or an L_shl), so
// the spectrum lives in shared memory as int32 and the taps run in 32-bit
// arithmetic (mpy32_16, add_sat32, sub_sat32: fixed.cuh).
#pragma once

#include "fixed.cuh"
#include "warp.cuh"

namespace acx {
namespace fx {

// the table pack (kernels.py:fx_spec_table_pack): bandwidth cutoffs, TNS
// quantizer points, InvLog2's three tables, then at kSpecLcg the LCG's
// closed form (A^r and the sums, r = 0..yLen) and the band of each bin
constexpr int kSpecBw = 0, kSpecPts = 6, kSpecE3 = 23, kSpecE2 = 55, kSpecE1 = 87, kSpecLcg = 119;

struct SpecGeom {
  int yLen, N, n_bands, frame_dms, gg_off, R;
};

constexpr int kFxSpecFrames = 4;     // frames a warp
constexpr int kTnsTaps = 8;          // lattice taps, and lanes a frame
using SpecWord = int32_t;            // a Word32 of the spectrum in shared memory

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
ACX_HD i64 headroom32(const W& w, const SpecWord* x, int lo, int hi) {
  i64 m = 63;
  w.each(hi > lo ? hi - lo : 0, [&](int k) {
    const i64 v = x[lo + k];
    if (v != 0) m = min64(m, norm_l(v));
  });
  m = w.min(m);
  return m == 63 ? 0 : m;
}


// A frame's lattice: the bins [lo, hi) it runs (none where lo >= hi), its
// filters' ranges and orders (filter 0 over start0 .. stop1, filter 1 over
// start1 .. bw_stop where numf2), and the frame's exponent, carried from the
// stages before the lattice to those after it.
struct FxTnsFrame {
  int lo, hi, start0, stop1, start1, bw_stop, o0, o1, numf2;
  i64 x_e;
};

// The stages before the lattice, one frame: the range decoder's x [yLen]
// (int32) and residual bits [R], the side words, the bands' scf -> xs
// [yLen] (the lattice's input, shifted by its headroom where TNS is on) and
// the frame's lattice tf. run: yLen int16 (the run of zeros ending at each
// bin).
template <class W>
ACX_HD void fx_spec_pre(const W& w, const int32_t* x, const int32_t* res, const int32_t* sd,
                        const i64* tab, const SpecGeom& g, SpecWord* xs, int16_t* run,
                        FxTnsFrame* tf) {
  const int n = g.yLen;
  const i64* lcg_a = tab + kSpecLcg;
  const i64* lcg_c = lcg_a + n + 1;
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
  w.each(n, [&](int i) {
    xs[i] = static_cast<SpecWord>(shift >= 0 ? shl64(shl64(x[i], 16), shift) : 0);
  });
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
      xs[i] = static_cast<SpecWord>(sat32(v + delta));
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
                [&](int i, int last) { run[i] = static_cast<int16_t>(i - last); });
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
        xs[k] = static_cast<SpecWord>(su < 0x8000 ? v : -v);
      }
    });
    w.sync();
  }
  // ---- processApplyGlobalGain_fx
  const i64 tmp32 = sat32(shl64((static_cast<i64>(sd[kGgIdx]) + g.gg_off) * 0x797D, 7));
  const i64 gg = round_fx(inv_log2(tab, tmp32 | -33554432LL));
  x_e += (tmp32 >> 25) + 1;
  w.each(n, [&](int i) {
    xs[i] = mpy32_16(static_cast<int32_t>(xs[i]), static_cast<int32_t>(gg));
  });
  w.sync();
  // ---- processTnsDecoder_fx: the headroom, the whole row shifted by it, and
  // the lattice's bins
  const int start0 = g.frame_dms == 25 ? 3 : (g.frame_dms == 50 ? 6 : 12);
  const i64 bw_stop = bw_bin >> (g.frame_dms == 25 ? 2 : (g.frame_dms == 50 ? 1 : 0));
  const bool numf2 = bw_idx >= 3 && g.frame_dms >= 50;
  const i64 start1 = bw_stop >> 1;
  const i64 o0 = sd[kOrder0], o1 = numf2 ? sd[kOrder1] : 0;
  const i64 stop1 = numf2 ? start1 : bw_stop;
  FxTnsFrame f{0, 0, start0, static_cast<int>(stop1), static_cast<int>(start1),
               static_cast<int>(bw_stop), static_cast<int>(clamp64(o0, 0, 64)),
               static_cast<int>(clamp64(o1, 0, 64)), numf2 ? 1 : 0, x_e};
  if (o0 > 0 || o1 > 0) {
    const i64 fb = (numf2 && o0 == 0) ? start1 : start0;
    const i64 fc = clamp64(fb, 0, n);
    const i64 s1 = headroom32(w, xs, 0, static_cast<int>(fc));
    const i64 s2 = headroom32(w, xs, static_cast<int>(fc), n);
    const i64 s = min64(s1, s2 - 7);
    f.x_e = x_e - s;
    w.sync();
    w.each(n, [&](int i) { xs[i] = static_cast<SpecWord>(L_shl(xs[i], s)); });
    // the hull of the active bins
    i64 lo = n, hi = 0;
    if (o0 > 0) {
      lo = min64(lo, start0);
      hi = max64(hi, stop1);
    }
    if (o1 > 0) {
      lo = min64(lo, start1);
      hi = max64(hi, bw_stop);
    }
    f.lo = static_cast<int>(clamp64(lo, 0, n));
    f.hi = static_cast<int>(clamp64(hi, 0, n));
  }
  w.sync();
  if (w.leader()) *tf = f;
  w.sync();
}

// A lattice row's word i: on the card a shared-memory access at the row's
// shared address plus 4 i (an asm statement, so that the compiler neither
// recomputes the shared window a step nor sinks the load into a branch),
// where the row holds int32 words; elsewhere through the pointer.
ACX_HD uint32_t wave_row_addr(const SpecWord* row) {
#ifdef __CUDA_ARCH__
  return static_cast<uint32_t>(__cvta_generic_to_shared(row));
#else
  (void)row;
  return 0u;
#endif
}
ACX_HD int32_t wave_load(const SpecWord* row, uint32_t addr, int i) {
#ifdef __CUDA_ARCH__
  if constexpr (sizeof(SpecWord) == 4) {
    int32_t v;
    asm volatile("ld.shared.b32 %0, [%1];" : "=r"(v) : "r"(addr + 4u * static_cast<uint32_t>(i)));
    return v;
  }
#endif
  (void)addr;
  return static_cast<int32_t>(row[i]);
}
ACX_HD void wave_store(SpecWord* row, uint32_t addr, int i, int32_t v, bool on) {
#ifdef __CUDA_ARCH__
  if constexpr (sizeof(SpecWord) == 4) {
    asm volatile("{\n .reg .pred p;\n setp.ne.b32 p, %2, 0;\n @p st.shared.b32 [%0], %1;\n}"
                 :: "r"(addr + 4u * static_cast<uint32_t>(i)), "r"(v), "r"(on ? 1 : 0));
    return;
  }
#endif
  (void)addr;
  if (on) row[i] = v;
}

// The lattices of nf <= kFxSpecFrames frames at once over the coder-warp v:
// frame f's taps on lanes 8 f .. 8 f + 7, its spectrum at xs + f * stride
// (filtered in place over [lo, hi)), its reflection indices at tidx + 16 f.
// Lane kk runs bin i at step 2 (i - lo) + 7 - kk: it takes xi from lane kk +
// 1's step before (lane 7 from xs) and subtracts its tap where kk <= o - 1
// (o the order of the bin's filter); lane 0 keeps the result as st[0] and
// writes it. The tap's state update st[kk + 1] = st[kk] + xi rc[kk], where
// kk < o - 1, goes up to lane kk + 1, which ran the same bin the step
// before, knows it is due and takes it on its idle step, before its next
// bin. The filter of each bin, its order and its coefficient are selects,
// never branches.
template <class V>
ACX_HD void fx_tns_wave(const V& v, int nf, const FxTnsFrame* tf, SpecWord* xs, int stride,
                        const int32_t* tidx, const i64* tab) {
  using LI = typename V::template Lanes<int32_t>;
  // a lane's frame and tap: its coefficients, its frame's bins and filters
  // (lo1 > any bin where filter 0 is off, lo2 where filter 1 is), and where
  // it subtracts a tap in each filter (kk <= o - 1)
  LI rc0, rc1, lo, hi, lo1, hi1, lo2, hi2, tap0, tap1, st, xin, y, upd, want;
  typename V::template Lanes<uint32_t> addr;
  int steps = 0;
  for (int f = 0; f < nf; ++f) {
    steps = imax(steps, tf[f].hi > tf[f].lo ? 2 * (tf[f].hi - tf[f].lo) + kTnsTaps - 2 : 0);
  }
  v.lanes([&](int l) {
    const int f = l / kTnsTaps, kk = l % kTnsTaps;
    const FxTnsFrame& F = tf[imin(f, nf - 1)];
    const int32_t* ti = tidx + 16 * imin(f, nf - 1);
    rc0[l] = static_cast<int32_t>(tab[kSpecPts + clamp64(ti[kk], 0, 16)]);
    rc1[l] = static_cast<int32_t>(tab[kSpecPts + clamp64(ti[kTnsTaps + kk], 0, 16)]);
    lo[l] = F.lo;
    hi[l] = f < nf ? F.hi : F.lo;
    lo1[l] = F.o0 > 0 ? F.start0 : 1 << 30;
    hi1[l] = F.stop1;
    lo2[l] = F.numf2 != 0 && F.o1 > 0 ? F.start1 : 1 << 30;
    hi2[l] = F.bw_stop;
    tap0[l] = kk <= iclamp(F.o0 - 1, 0, kTnsTaps - 1);
    tap1[l] = kk <= iclamp(F.o1 - 1, 0, kTnsTaps - 1);
    st[l] = 0;
    xin[l] = 0;
    want[l] = 0;
    addr[l] = wave_row_addr(xs + imin(f, nf - 1) * stride);
  });
  for (int t = 0; t < steps; ++t) {
    v.lanes([&](int l) {
      const int kk = l % kTnsTaps;
      const int d = t - (kTnsTaps - 1 - kk);
      const int i = lo[l] + (d >> 1);
      // selects and predicated accesses only: no branch a step
      const bool on = (d >= 0) & ((d & 1) == 0) & (i < hi[l]);
      SpecWord* row = xs + imin(l / kTnsTaps, nf - 1) * stride;
      const int32_t xr = wave_load(row, addr[l], iclamp(i, 0, stride - 1));
      const int32_t x = kk == kTnsTaps - 1 ? (on ? xr : 0) : xin[l];
      const bool in2 = (i >= lo2[l]) & (i < hi2[l]);
      const bool act = on & (in2 | ((i >= lo1[l]) & (i < hi1[l])));
      const bool tap = act & ((in2 ? tap1[l] : tap0[l]) != 0);
      const int32_t rc = in2 ? rc1[l] : rc0[l];
      const int32_t s = st[l];
      const int32_t sub = sub_sat32(x, mpy32_16(s, rc));
      const int32_t yi = tap ? sub : x;
      upd[l] = add_sat32(s, mpy32_16(yi, rc));
      st[l] = kk == 0 && act ? yi : s;
      want[l] = kk > 0 && tap ? 1 : want[l];
      wave_store(row, addr[l], iclamp(i, 0, stride - 1), yi, kk == 0 && on);
      y[l] = yi;
    });
    xin = v.shfl_down(y, 1);
    const LI u = v.shfl_up(upd, 1);
    v.lanes([&](int l) {
      const int d = t - (kTnsTaps - 1 - l % kTnsTaps);
      const bool take = ((d & 1) != 0) & (want[l] != 0);
      st[l] = take ? u[l] : st[l];
      want[l] = take ? 0 : want[l];
    });
  }
  v.sync();
}

// The stages after the lattice, one frame: processScfScaling,
// processMdctShaping_fx, zeros to the frame's end -> out [N] and the
// exponent.
template <class W>
ACX_HD void fx_spec_post(const W& w, const SpecWord* xs, const i64* scf, const i64* scf_e,
                         const i64* tab, const SpecGeom& g, i64 x_e, i64* out, i64* x_e_out) {
  const int n = g.yLen;
  const i64* bmap = tab + kSpecLcg + 2 * (n + 1);
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

// nf <= kFxSpecFrames consecutive frames: each frame's stages before the
// lattice over the group w, the lattices at once over the coder-warp v, then
// each frame's stages after it. The inputs and outputs are the first
// frame's rows (the next frame's a row further on); xs: kFxSpecFrames rows
// of yLen words; run: yLen int16; tf: kFxSpecFrames lattices.
template <class W, class V>
ACX_HD void fx_spec_decode_lane(const W& w, const V& v, int nf, const int32_t* x,
                                const int32_t* res, const int32_t* sd, const int32_t* tidx,
                                const i64* scf, const i64* scf_e, const i64* tab,
                                const SpecGeom& g, SpecWord* xs, int16_t* run, FxTnsFrame* tf,
                                i64* out, i64* x_e_out) {
  const int n = g.yLen;
  for (int f = 0; f < nf; ++f) {
    fx_spec_pre(w, x + f * n, res + f * g.R, sd + f * kSpecSideWords, tab, g, xs + f * n, run,
                tf + f);
  }
  fx_tns_wave(v, nf, tf, xs, n, tidx, tab);
  for (int f = 0; f < nf; ++f) {
    fx_spec_post(w, xs + f * n, scf + f * g.n_bands, scf_e + f * g.n_bands, tab, g, tf[f].x_e,
                 out + f * g.N, x_e_out + f);
  }
}

}  // namespace fx
}  // namespace acx
