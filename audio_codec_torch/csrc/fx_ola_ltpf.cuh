// The steps of fx_ola_ltpf.cu: one stream's frame of the fixed-point
// decoder's back end, the IMDCT's overlap-add (ops/fixed_dev.py:imdct_ola),
// the LTPF post-filter (ops/fixed_ltpf_dev.py:ltpf_decode) and the PCM
// rounding (fixed_dev.py:round_pcm16), written once over the group of
// threads that runs it (fixed.cuh: a warp on the card, one thread in the
// rehearsal, tests/test_torch_lane_rehearsal.py).
//
// Where trouble is likely, and what is done about it:
// - The filter's clamped tap reads: the output history is read `pitch_int`
//   samples back at an index clipped into [0, W-1] of the live buffer, so a
//   tap lands on the same element as in the plain version, the frame's
//   not-yet-written zeros included.
// - pat4's crossfade runs a second pass over the first pass's output: its
//   input window is a snapshot of that output (`zs`), taken before the
//   second pass overwrites it.
// - The input windows read the input buffer from `base - l`, l = 0..tlen.
// - old_sfi starts at -1: the first pass of a fading-out frame takes the
//   tilt row 0 then, as the plain version does.
#pragma once

#include "fixed.cuh"

namespace acx {
namespace fx {

struct OlaGeom {
  int N, wLen, x_len, y_len, ilen, tlen, shift, N4, pitch_scale, fade_step, sfi, gain_val;
  // offsets in the table pack (kernels.py:fx_ola_table_pack): the window, the
  // rate's four interpolation rows of 12 and four tilt rows of 11
  int off_inter, off_tilt;
};

// one stream's state (kernels.py:fx_ola_ltpf), read and updated in place
struct OlaState {
  i64 *mem, *mem_e, *old_x, *old_y, *old_e, *pitch_int, *pitch_fr, *gain, *mem_active, *old_sfi;
};

// scratch words of one stream: xbuf, ybuf, the new OLA memory, pat4's snapshot
ACX_HD int ola_scratch_words(const OlaGeom& g) {
  return (g.x_len + g.N) + (g.y_len + g.N) + (g.wLen - g.N) + (g.tlen + g.N4);
}

// Scale_sig of one value: s > 0 a saturating shl, s < 0 a rounded shr
ACX_HD i64 scale_sig(i64 x, i64 s) {
  if (s == 0) return x;
  if (s > 0) return clamp64(shl64(x, min64(s, 31)), MIN16, MAX16);
  const i64 tmp = -shl64(1, 15 + max64(s, -15));
  const i64 prod = sat32(-shl64(x * tmp, 1));
  return sat16(sat32(prod + 0x8000) >> 16);
}

// getScaleFactor16_0 over n values: the least norm_s of the nonzero ones,
// 16 if all are zero
template <class W>
ACX_HD i64 headroom16_0(const W& w, const i64* x, int n) {
  i64 m = 16;
  w.each(n, [&](int i) {
    if (x[i] != 0) m = min64(m, norm_s(x[i]));
  });
  return w.min(m);
}

// ltpf_synth_filter (ltpf_decoder_fx.c:244-316) on one lane: writes ybuf
// [ybase, ybase + len); x is read at xbase + j - l
ACX_HD void synth_filter(i64* ybuf, int W_, int ybase, const i64* x, int xbase, int len,
                         i64 pitch_int, i64 gain, const i64* ic, const i64* tc, const OlaGeom& g,
                         int fade) {
  const i64 x0 = ybase - pitch_int + g.shift;
  i64 alpha = fade < 0 ? 0x7FFF : 0;
  const i64 step = fade < 0 ? -g.fade_step : (fade > 0 ? g.fade_step : 0);
  for (int j = 0; j < len; ++j) {
    i64 s = L_mult(ybuf[clamp64(x0 + j, 0, W_ - 1)], ic[0]);
    for (int l = 1; l < g.ilen; ++l) s = sat32(s + L_mult(ybuf[clamp64(x0 + j - l, 0, W_ - 1)], ic[l]));
    for (int l = 0; l < g.tlen; ++l) s = sat32(s - L_mult(x[xbase + j - l], tc[l]));
    const i64 i16 = round_fx(sat32(s - L_mult(x[xbase + j - g.tlen], tc[g.tlen])));
    i64 k16 = mult_r(gain, i16);
    if (fade != 0) k16 = mult_r(k16, alpha);
    ybuf[ybase + j] = sat16(x[xbase + j] + k16);
    if (fade != 0) alpha = sat16(alpha + step);
  }
}

// One stream's frame: ytda [N] with y_e, y_s, zero from fx_dct4, the LTPF
// side words lp[3] -> pcm [N]; the state st updated in place. sc: scratch of
// ola_scratch_words(g) words.
template <class W>
ACX_HD void fx_ola_ltpf_lane(const W& w, const i64* ytda, i64 y_e, i64 y_s, bool zero,
                             const int32_t* lp, const i64* tab, const OlaGeom& g,
                             const OlaState& st, i64* sc, int16_t* pcm) {
  const int N = g.N, memLen = g.wLen - g.N, x_len = g.x_len, y_len = g.y_len;
  const int Wy = y_len + N;
  i64* xbuf = sc;                 // old_x ++ the frame
  i64* ybuf = xbuf + x_len + N;   // old_y ++ the filtered frame
  i64* memn = ybuf + Wy;          // the new OLA memory
  i64* zs = memn + memLen;        // pat4's snapshot
  const i64* win = tab;
  // ---- imdct_ola: exponent alignment
  const int z = 2 * N - g.wLen, m = N >> 1, o = m - z;
  i64 ye = zero ? 0 : y_e;
  i64 ys = y_s;
  i64 ms = 16;
  w.each(memLen, [&](int i) {
    if (st.mem[i] != 0) ms = min64(ms, norm_l(st.mem[i]) - 16);
  });
  ms = w.min(ms);
  const bool has_hr = ms < 16;
  if (has_hr) ms -= 1;
  const i64 mem_e = has_hr ? *st.mem_e - ms : ye;
  const i64 s = mem_e - ye;
  if (s > 0) {
    ys -= s;
    ye += s;
  } else {
    ms += s;
  }
  ms = max64(ms, -31);
  ys = max64(ys, -31);
  // ---- TDA unfold, window, overlap-add: the frame into xbuf after old_x,
  // the new memory into memn
  w.each(x_len, [&](int i) { xbuf[i] = st.old_x[i]; });
  w.each(y_len, [&](int i) { ybuf[i] = st.old_y[i]; });
  w.each(g.wLen, [&](int k) {
    i64 v;
    if (k < o) {
      v = round_fx(lsub(L_shl(shl64(st.mem[k], 16), ms),
                        mpy_32_16(L_shl(ytda[m + k + z], ys), win[4 * m - 1 - k - z])));
    } else if (k < o + m) {
      const int i = k - o;
      v = round_fx(ladd(L_shl(shl64(st.mem[o + i], 16), ms),
                        mpy_32_16(L_shl(ytda[2 * m - 1 - i], ys), win[3 * m - 1 - i])));
    } else if (k < o + 2 * m) {
      const int i = m - 1 - (k - o - m);
      v = round_fx(lneg(mpy_32_16(L_shl(ytda[i], ys), win[m + i])));
    } else {
      const int i = k - o - 2 * m;
      v = round_fx(lneg(mpy_32_16(L_shl(ytda[i], ys), win[m - 1 - i])));
    }
    if (k < N)
      xbuf[x_len + k] = v;
    else
      memn[k - N] = v;
  });
  w.sync();
  w.each(memLen, [&](int i) { st.mem[i] = memn[i]; });
  const i64* x_in = xbuf + x_len;
  const i64 x_e = ye;
  // ---- the LTPF parameters (clean frames)
  const i64 ltpf = lp[0], pidx = lp[2];
  i64 active = lp[1];
  const i64 p1 = (pidx + 64) >> 2, f1 = pidx - shl64(p1, 2) + 128;
  const i64 p2 = (pidx - 126) >> 1, f2 = shl64(pidx, 1) - shl64(p2, 2) - 252;
  i64 pint = pidx < 380 ? p1 : (pidx < 440 ? p2 : pidx - 283);
  i64 pfr = pidx < 380 ? f1 : (pidx < 440 ? f2 : 0);
  const i64 pitch = mult_r(shl16(shl64(pint, 2) + pfr, 2), g.pitch_scale);
  pint = ltpf != 0 ? pitch >> 2 : 0;
  pfr = ltpf != 0 ? pitch - shl64(pitch >> 2, 2) : 0;
  if (g.sfi < 0) active = 0;
  const i64 gain = active != 0 ? g.gain_val : 0;
  const i64 old_e = *st.old_e, old_pint = *st.pitch_int, old_pfr = *st.pitch_fr,
            old_gain = *st.gain, old_active = *st.mem_active, old_sfi = *st.old_sfi;
  const bool passthrough = active == 0 && old_active == 0;
  i64 x_e_out, new_old_e;
  const i64* yout;
  if (passthrough) {
    // ---- branch A: the history follows the frame's exponent
    const i64 sA = old_e - x_e;
    const int keep = y_len - N;
    w.each(y_len, [&](int k) {
      i64 v;
      if (sA > 0) {
        v = k < keep ? ybuf[k + N] : (sA > 15 ? 0 : shr64(x_in[k - keep], sA));
      } else if (k < keep) {
        const i64 oy = ybuf[k + N];
        v = sA < -15 ? 0 : (sA < 0 ? sat16(shr64(oy, -sA)) : clamp64(shl64(oy, sA), MIN16, MAX16));
      } else {
        v = x_in[k - keep];
      }
      st.old_y[k] = v;
    });
    w.each(x_len, [&](int k) {
      const i64 v = x_in[N - x_len + k];
      st.old_x[k] = sA > 0 ? (sA > 15 ? 0 : shr64(v, sA)) : v;
    });
    new_old_e = sA > 0 ? old_e : x_e;
    x_e_out = x_e;
    yout = x_in;
  } else {
    // ---- branch B: rescale the histories and the frame to one exponent
    const i64 s0 = min64(headroom16_0(w, xbuf, x_len), headroom16_0(w, ybuf, y_len)) - 1;
    const i64 oe = old_e - s0;
    i64 any = 0;
    w.each(N, [&](int i) { any = max64(any, x_in[i] != 0 ? 1 : 0); });
    any = w.max(any);
    const i64 h0 = headroom16_0(w, x_in, N);
    const i64 s1 = (any ? (h0 & 0xF) : 0) - 1;
    i64 x_eB = x_e - s1;
    const i64 sB = oe - x_eB;
    const i64 x_scale = sB > 0 ? s1 - sB : s1, h_scale = sB > 0 ? s0 : s0 + sB;
    if (sB > 0) x_eB = oe;
    w.sync();
    w.each(x_len + N, [&](int i) { xbuf[i] = scale_sig(xbuf[i], i < x_len ? h_scale : x_scale); });
    w.each(Wy, [&](int i) { ybuf[i] = i < y_len ? scale_sig(ybuf[i], h_scale) : 0; });
    w.sync();
    if (w.leader()) {
      // the four first-phase patterns; the filters on lane 0
      const bool same = pint == old_pint && pfr == old_pfr;
      const bool pat1 = active == 0, pat2 = active != 0 && old_active == 0;
      const bool pat4 = active != 0 && old_active != 0 && !same;
      const bool use_old = pat1 || pat4;
      const i64 pfr_A = use_old ? old_pfr : pfr, pint_A = use_old ? old_pint : pint;
      const i64 gain_A = use_old ? old_gain : gain;
      const i64 sfi_A = use_old ? (old_sfi >= 0 ? old_sfi : 0) : g.sfi;
      const int fade_A = use_old ? -1 : (pat2 ? 1 : 0);
      const i64* inter = tab + g.off_inter;
      const i64* tilt = tab + g.off_tilt;
      const i64* icA = inter + 12 * clamp64(pfr_A, 0, 3);
      const i64* tcA = tilt + 11 * clamp64(sfi_A, 0, 3);
      const i64* icB = inter + 12 * clamp64(pfr, 0, 3);
      const i64* tcB = tilt + 11 * clamp64(g.sfi, 0, 3);
      synth_filter(ybuf, Wy, y_len, xbuf, x_len, g.N4, pint_A, gain_A, icA, tcA, g, fade_A);
      if (pat4) {
        for (int i = 0; i < g.tlen + g.N4; ++i) zs[i] = ybuf[y_len - g.tlen + i];
        synth_filter(ybuf, Wy, y_len, zs, g.tlen, g.N4, pint, gain, icB, tcB, g, 1);
      }
      if (active > 0) {
        synth_filter(ybuf, Wy, y_len + g.N4, xbuf, x_len + g.N4, N - g.N4, pint, gain, icB, tcB,
                     g, 0);
      } else {
        for (int i = g.N4; i < N; ++i) ybuf[y_len + i] = xbuf[x_len + i];
      }
    }
    w.sync();
    w.each(x_len, [&](int k) { st.old_x[k] = xbuf[N + k]; });
    w.each(y_len, [&](int k) { st.old_y[k] = ybuf[N + k]; });
    new_old_e = x_eB;
    x_e_out = x_eB;
    yout = ybuf + y_len;
  }
  // ---- round_pcm16 (dec_lc3.c:289-295)
  const i64 sh = 15 - x_e_out;
  w.each(N, [&](int i) {
    i64 v = shl64(yout[i], 16);
    v = sh >= 0 ? shr64(v, sh) : sat32(shl64(v, -sh));
    pcm[i] = static_cast<int16_t>(sat16(sat32(v + 0x8000) >> 16));
  });
  w.sync();
  if (w.leader()) {
    *st.mem_e = ye;
    *st.old_e = new_old_e;
    *st.pitch_int = pint;
    *st.pitch_fr = pfr;
    *st.gain = passthrough ? 0 : gain;
    *st.mem_active = passthrough ? 0 : active;
    *st.old_sfi = g.sfi;
  }
}

}  // namespace fx
}  // namespace acx
