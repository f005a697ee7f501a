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
// - The post-filter's sample loop across the lanes (synth_filter_warp):
//   sample j reads the output d = pitch_int - shift + l samples back
//   (l = 0..ilen-1) and the input only, so the samples of a chunk no longer
//   than d read nothing the chunk writes. A pass runs in chunks of
//   min(32, d) samples, a sample a lane, every lane's reads before any
//   lane's write; where d <= 0 a sample may read the one written just before
//   it, and the pass runs on lane 0 in the reference's own order. The fade's
//   alpha after j steps of sat16(alpha + step), a step of one sign, is
//   clamp(alpha0 + j step) (synth_alpha).
// - The buffers hold Word16 values (the frame's OLA output, the histories
//   the decoder itself wrote, their rescaled copies), so they live in
//   shared memory as int32 (OlaWord), half the int64 footprint; the filter
//   runs in 32-bit arithmetic whose saturating forms (add_sat32, lmult16)
//   equal the 64-bit BASOP operators on such values. The state in global
//   memory stays int64, and must hold Word16 histories, as every frame
//   writes them.
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

// a word of the shared buffers: a Word16 value
using OlaWord = int32_t;

constexpr int kOlaChunk = 32;     // samples of the post-filter a chunk, at most
constexpr int kOlaMaxIlen = 12;   // interpolation taps, at most (48 kHz)
constexpr int kOlaMaxTlen = 10;   // tilt taps before the last, at most (48 kHz)
constexpr int kOlaPad = kOlaMaxTlen;   // scratch words before xbuf

// scratch words (OlaWord) of one stream: a pad, xbuf, ybuf, the new OLA
// memory, pat4's snapshot
ACX_HD int ola_scratch_words(const OlaGeom& g) {
  return kOlaPad + (g.x_len + g.N) + (g.y_len + g.N) + (g.wLen - g.N) + (g.tlen + g.N4);
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
template <class W, class T>
ACX_HD i64 headroom16_0(const W& w, const T* x, int n) {
  i64 m = 16;
  w.each(n, [&](int i) {
    if (x[i] != 0) m = min64(m, norm_s(x[i]));
  });
  return w.min(m);
}

// L_mult, round_fx, mult_r and sat16 of Word16 values in 32-bit arithmetic:
// a product of two Word16 values fits, and twice it saturates only at 2^30
ACX_HD int32_t lmult16(int32_t a, int32_t b) {
  const int32_t p = a * b;
  return p == 0x40000000 ? 0x7FFFFFFF : p + p;
}
ACX_HD int32_t round16(int32_t L) { return add_sat32(L, 0x8000) >> 16; }
ACX_HD int32_t sat16_32(int32_t x) { return x > 32767 ? 32767 : (x < -32768 ? -32768 : x); }
ACX_HD int32_t mult_r16(int32_t a, int32_t b) { return sat16_32((a * b + 0x4000) >> 15); }

// A pass's coefficients and gain, in registers (Word16 values; the arrays
// indexed by unrolled static indices only, the tilt's last tap apart). The
// taps past the rate's ilen and tlen are 0: their terms are 0, and a
// saturating sum of 0 leaves the sum as it is, so every pass runs the
// 48 kHz counts with no branch a tap.
struct SynthTaps {
  int32_t ic[kOlaMaxIlen], tc[kOlaMaxTlen];
  int32_t tlast, gain, alpha0, step;
  int tlen, fade;
};

ACX_HD SynthTaps synth_taps(const i64* ic, const i64* tc, i64 gain, const OlaGeom& g, int fade) {
  SynthTaps t;
#pragma unroll
  for (int l = 0; l < kOlaMaxIlen; ++l) t.ic[l] = l < g.ilen ? static_cast<int32_t>(ic[l]) : 0;
#pragma unroll
  for (int l = 0; l < kOlaMaxTlen; ++l) t.tc[l] = l < g.tlen ? static_cast<int32_t>(tc[l]) : 0;
  t.tlast = static_cast<int32_t>(tc[g.tlen]);
  t.gain = static_cast<int32_t>(gain);
  t.alpha0 = fade < 0 ? 0x7FFF : 0;
  t.step = fade < 0 ? -g.fade_step : (fade > 0 ? g.fade_step : 0);
  t.tlen = g.tlen;
  t.fade = fade;
  return t;
}

// alpha at sample j: j steps of sat16(alpha + step) from alpha0, with a step
// of one sign, in closed form
ACX_HD int32_t synth_alpha(const SynthTaps& t, int j) {
  return sat16_32(t.alpha0 + j * t.step);
}

// Sample j of ltpf_synth_filter (ltpf_decoder_fx.c:244-316): the output
// history ybuf read at xb - l (clamped into [0, W-1]; xb = ybase + j -
// pitch_int + shift, pre-clamped into [-64, W + 64], which keeps every
// clamped tap), the input at xj[-l] (l < kOlaMaxTlen: the buffers lie
// kOlaPad words into the scratch, so a zero tap's read stays inside it)
ACX_HD OlaWord synth_sample(const OlaWord* ybuf, int W_, int xb, const OlaWord* xj,
                            const SynthTaps& t, int j) {
  int32_t y[kOlaMaxIlen];
  if (xb >= kOlaMaxIlen - 1 && xb < W_) {
#pragma unroll
    for (int l = 0; l < kOlaMaxIlen; ++l) y[l] = ybuf[xb - l];
  } else {
#pragma unroll
    for (int l = 0; l < kOlaMaxIlen; ++l) y[l] = ybuf[iclamp(xb - l, 0, W_ - 1)];
  }
  int32_t s = lmult16(y[0], t.ic[0]);
#pragma unroll
  for (int l = 1; l < kOlaMaxIlen; ++l) s = add_sat32(s, lmult16(y[l], t.ic[l]));
#pragma unroll
  for (int l = 0; l < kOlaMaxTlen; ++l) s = sub_sat32(s, lmult16(xj[-l], t.tc[l]));
  const int32_t i16 = round16(sub_sat32(s, lmult16(xj[-t.tlen], t.tlast)));
  int32_t k16 = mult_r16(t.gain, i16);
  if (t.fade != 0) k16 = mult_r16(k16, synth_alpha(t, j));
  return sat16_32(xj[0] + k16);
}

// ltpf_synth_filter over the group: writes ybuf [ybase, ybase + len) of a
// buffer of W_ words; x is read at xbase + j - l. Chunks of min(32, d)
// samples, d = pitch_int - shift, a sample a lane; lane 0 alone in order
// where d <= 0.
template <class W>
ACX_HD void synth_filter_warp(const W& w, OlaWord* ybuf, int W_, int ybase, const OlaWord* x,
                              int xbase, int len, i64 pitch_int, i64 gain, const i64* ic,
                              const i64* tc, const OlaGeom& g, int fade) {
  const SynthTaps t = synth_taps(ic, tc, gain, g, fade);
  const i64 d = pitch_int - g.shift;
  const i64 x0 = ybase - d;
  auto sample = [&](int j) {
    const int xb = static_cast<int>(clamp64(x0 + j, -64, W_ + 64));
    return synth_sample(ybuf, W_, xb, x + xbase + j, t, j);
  };
  if (d <= 0) {
    if (w.leader()) {
      for (int j = 0; j < len; ++j) ybuf[ybase + j] = sample(j);
    }
    w.sync();
    return;
  }
  const int c = static_cast<int>(min64(d, kOlaChunk));
  for (int j0 = 0; j0 < len; j0 += c) {
    w.chunk(imin(c, len - j0), [&](int k) { return sample(j0 + k); },
            [&](int k, OlaWord v) { ybuf[ybase + j0 + k] = v; });
  }
}

// The inputs of the overlap-add's output k (imdct_ola: the TDA unfold of
// ytda against the window win, the old memory mem on the first o + m)
struct OlaTap {
  i64 y, mem, w;
};

ACX_HD OlaTap ola_tap(const i64* ytda, const i64* mem, const i64* win, int k, int o, int m,
                      int z) {
  if (k < o) return {ytda[m + k + z], mem[k], win[4 * m - 1 - k - z]};
  if (k < o + m) return {ytda[2 * m - 1 - (k - o)], mem[k], win[3 * m - 1 - (k - o)]};
  if (k < o + 2 * m) {
    const int i = m - 1 - (k - o - m);
    return {ytda[i], 0, win[m + i]};
  }
  const int i = k - o - 2 * m;
  return {ytda[i], 0, win[m - 1 - i]};
}

// One stream's frame: ytda [N] with y_e, y_s, zero from fx_dct4, the LTPF
// side words lp[3] -> pcm [N]; the state st updated in place. sc: scratch of
// ola_scratch_words(g) words.
template <class W>
ACX_HD void fx_ola_ltpf_lane(const W& w, const i64* ytda, i64 y_e, i64 y_s, bool zero,
                             const int32_t* lp, const i64* tab, const OlaGeom& g,
                             const OlaState& st, OlaWord* sc, int16_t* pcm) {
  const int N = g.N, memLen = g.wLen - g.N, x_len = g.x_len, y_len = g.y_len;
  const int Wy = y_len + N;
  OlaWord* xbuf = sc + kOlaPad;       // old_x ++ the frame
  OlaWord* ybuf = xbuf + x_len + N;   // old_y ++ the filtered frame
  OlaWord* memn = ybuf + Wy;          // the new OLA memory
  OlaWord* zs = memn + memLen;        // pat4's snapshot
  const i64* win = tab;
  // ---- imdct_ola: exponent alignment
  const int z = 2 * N - g.wLen, m = N >> 1, o = m - z;
  i64 ye = zero ? 0 : y_e;
  i64 ys = y_s;
  i64 ms = 16;
  w.each_loaded(memLen, [&](int i) { return st.mem[i]; }, [&](int, i64 v) {
    if (v != 0) ms = min64(ms, norm_l(v) - 16);
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
  w.each_loaded(x_len, [&](int i) { return st.old_x[i]; },
                [&](int i, i64 v) { xbuf[i] = static_cast<OlaWord>(v); });
  w.each_loaded(y_len, [&](int i) { return st.old_y[i]; },
                [&](int i, i64 v) { ybuf[i] = static_cast<OlaWord>(v); });
  w.each_loaded(g.wLen, [&](int k) { return ola_tap(ytda, st.mem, win, k, o, m, z); },
                [&](int k, const OlaTap& a) {
    i64 v;
    if (k < o) {
      v = round_fx(lsub(L_shl(shl64(a.mem, 16), ms), mpy_32_16(L_shl(a.y, ys), a.w)));
    } else if (k < o + m) {
      v = round_fx(ladd(L_shl(shl64(a.mem, 16), ms), mpy_32_16(L_shl(a.y, ys), a.w)));
    } else {
      v = round_fx(lneg(mpy_32_16(L_shl(a.y, ys), a.w)));
    }
    if (k < N)
      xbuf[x_len + k] = static_cast<OlaWord>(v);
    else
      memn[k - N] = static_cast<OlaWord>(v);
  });
  w.sync();
  w.each(memLen, [&](int i) { st.mem[i] = memn[i]; });
  const OlaWord* x_in = xbuf + x_len;
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
  const OlaWord* yout;
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
    // getScaleFactor16 of the frame: 0 where it is all zero, and then
    // headroom16_0 is 16, whose low four bits are 0
    const i64 s1 = (headroom16_0(w, x_in, N) & 0xF) - 1;
    i64 x_eB = x_e - s1;
    const i64 sB = oe - x_eB;
    const i64 x_scale = sB > 0 ? s1 - sB : s1, h_scale = sB > 0 ? s0 : s0 + sB;
    if (sB > 0) x_eB = oe;
    w.sync();
    w.each(x_len + N, [&](int i) {
      xbuf[i] = static_cast<OlaWord>(scale_sig(xbuf[i], i < x_len ? h_scale : x_scale));
    });
    w.each(Wy, [&](int i) {
      ybuf[i] = i < y_len ? static_cast<OlaWord>(scale_sig(ybuf[i], h_scale)) : 0;
    });
    w.sync();
    // the four first-phase patterns (the same on every lane); each filter
    // pass across the group
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
    synth_filter_warp(w, ybuf, Wy, y_len, xbuf, x_len, g.N4, pint_A, gain_A, icA, tcA, g, fade_A);
    if (pat4) {
      w.each(g.tlen + g.N4, [&](int i) { zs[i] = ybuf[y_len - g.tlen + i]; });
      w.sync();
      synth_filter_warp(w, ybuf, Wy, y_len, zs, g.tlen, g.N4, pint, gain, icB, tcB, g, 1);
    }
    if (active > 0) {
      synth_filter_warp(w, ybuf, Wy, y_len + g.N4, xbuf, x_len + g.N4, N - g.N4, pint, gain, icB,
                        tcB, g, 0);
    } else {
      w.each(N - g.N4, [&](int i) { ybuf[y_len + g.N4 + i] = xbuf[x_len + g.N4 + i]; });
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
