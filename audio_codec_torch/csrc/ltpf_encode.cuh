// The LTPF parameter coder of one stream (ltpf_coder.c:34-263, as
// audio_codec_tpu/ops/analysis.py:ltpf_encode computes it): the normalised
// correlation at the 17 lags of the window around the open-loop pitch, the
// integer search, the 17x36 interpolation at the fractional candidates, the
// fractional search, the pitch index, the normalised correlation of the
// 4-tap interpolated signals, and the activation rules. ltpf_encode.cu
// spreads the window's lags and the filtered samples over the lanes of a
// warp; ltpf_encode_lane runs the same steps in order, which is how the
// functions compile as plain C++ without nvcc.
//
// Every float result must equal the plain version's (ops/analysis.py:
// ltpf_encode_plain) on the card bit for bit, so every product and sum is
// rounded on its own (rmul, radd, rsub, rdiv, rroot) in the order it states:
// each lag's correlation and energy and each of the three normcorr sums is a
// chain from the first product over the samples, ascending; the
// interpolation a chain over the 17 window entries, zero taps included.
#pragma once

#include "olpa.cuh"

namespace acx {

constexpr int kLtpfMinPitch = 32;   // MIN_PITCH_12K8
constexpr int kLtpfMaxPitch = 228;  // MAX_PITCH_12K8
constexpr int kLtpfRes2 = 157;      // RES2_PITCH_12K8
constexpr int kLtpfRes4 = 127;      // RES4_PITCH_12K8
constexpr int kLtpfLag0 = kLtpfMinPitch - 4;
constexpr int kLtpfLags = kLtpfMaxPitch + 4 - kLtpfLag0 + 1;   // 205
constexpr int kLtpfWin = 17;
constexpr int kLtpfInterTaps = 32;  // inter4_1 taps the interpolation reads
constexpr int kLtpfInterOut = 36;
constexpr int kLtpfTableWords = kLtpfInterTaps + 16;   // inter4_1[:32] ++ enc_inter_filter
constexpr int kLtpfMaxRow = 368;    // memory + frame, at most 264 + 33 (2.5 ms) or 232 + 129
constexpr int kLtpfMaxAcf = 128;

// The configuration's geometry (ops/analysis.py:ltpf_encode_plain).
struct LtpfGeom {
  int xlen;       // 12.8 kHz samples of the input row
  int N;          // samples a frame advances
  int mem_len;    // input memory
  int acflen;     // correlation length
  int xbase;      // first sample of the current block in the row
  int frame_dms;  // 25, 50 or 100
  int enable;     // LTPF may switch on
};

ACX_HD int ltpf_row_len(const LtpfGeom& g) { return g.mem_len + g.xlen; }

// The chain over the block's energy.
ACX_HD float ltpf_energy(const float* buf, const LtpfGeom& g) {
  const float* x = buf + g.xbase;
  float e = rmul(x[0], x[0]);
  for (int n = 1; n < g.acflen; ++n) e = radd(e, rmul(x[n], x[n]));
  return e;
}

// The first lag index of the window (clamped lag - 28 of its first entry).
ACX_HD int ltpf_t0_min(int pitch_ol) { return imax(pitch_ol - 4, kLtpfMinPitch); }

// Normalised correlation of window entry i: the lag index t_min - 28 + i,
// clamped at the last of the 205 lags, as the plain version gathers it.
ACX_HD float ltpf_window_nc(const float* buf, const LtpfGeom& g, int pitch_ol, int i,
                            float e_cur) {
  const int li = iclamp(ltpf_t0_min(pitch_ol) - 4 - kLtpfLag0 + i, 0, kLtpfLags - 1);
  const float* x = buf + g.xbase;
  const float* lag = buf + imax(g.xbase - kLtpfLag0 - li, 0);
  float c = rmul(x[0], lag[0]);
  float en = rmul(lag[0], lag[0]);
  for (int n = 1; n < g.acflen; ++n) {
    c = radd(c, rmul(x[n], lag[n]));
    en = radd(en, rmul(lag[n], lag[n]));
  }
  const float nc = rdiv(c, radd(rroot(rmul(e_cur, en)), 1e-5f));
  return nc < 0.0f ? 0.0f : nc;
}

// Interpolated correlation at output i (0..35): sum over the window entries
// m of cor[m] * inter4_1[4m - i], a chain from m = 0 with the taps outside
// 0..31 zero.
ACX_HD float ltpf_interp(const float* cor, const float* inter, int i) {
  float acc = 0.0f;
#pragma unroll
  for (int m = 0; m < kLtpfWin; ++m) {
    const int k = 4 * m - i;
    const bool in_taps = k >= 0 && k < kLtpfInterTaps;
    const float tap = in_taps ? inter[iclamp(k, 0, kLtpfInterTaps - 1)] : 0.0f;
    const float p = rmul(cor[m], tap);
    acc = m == 0 ? p : radd(acc, p);
  }
  return acc;
}

struct LtpfPitch {
  int pitch_int, pitch_fr, index;
};

// The integer search over the window's middle 9 entries, the fractional
// search at <= 7 interpolated candidates and the pitch index.
ACX_HD LtpfPitch ltpf_pitch_search(const float* cor, int pitch_ol, const float* inter) {
  const int t0_min = ltpf_t0_min(pitch_ol);
  const int t0_max = imin(pitch_ol + 4, kLtpfMaxPitch);
  const int n_int = t0_max - t0_min + 1;
  float bv = -INFINITY;
  int bi = kNoIndex;
#pragma unroll
  for (int i = 0; i < 9; ++i) {
    const float v = i < n_int ? cor[4 + i] : -INFINITY;
    if (first_max_beats(v, i, bv, bi)) { bv = v; bi = i; }
  }
  const int t1 = iclamp(bi, 0, 8) + t0_min;
  const int step = t1 >= kLtpfRes4 ? 2 : 1;
  const int midpoint = 4 * (t1 - t0_min) + 1;
  const int delta = 4 - step;
  const int delta_down = t1 == t0_min ? 0 : delta;
  const int count = (delta + delta_down) / step + 1;
  bv = -INFINITY;
  bi = kNoIndex;
#pragma unroll
  for (int o = 0; o < 7; ++o) {
    float v = -INFINITY;
    if (o < count) {
      const int i = midpoint - delta_down - 1 + o * step;
      v = ltpf_interp(cor, inter, iclamp(i, 0, kLtpfInterOut - 1));
    }
    if (first_max_beats(v, o, bv, bi)) { bv = v; bi = o; }
  }
  const int fr0 = iclamp(bi, 0, 6) * step - delta_down;
  LtpfPitch p;
  p.pitch_int = fr0 >= 0 ? t1 : t1 - 1;
  p.pitch_fr = fr0 >= 0 ? fr0 : fr0 + 4;
  if (t1 >= kLtpfRes2) {
    p.pitch_int = t1;
    p.pitch_fr = 0;
  }
  const int pi = p.pitch_int, pf = p.pitch_fr;
  if (pi < kLtpfRes4) {
    p.index = pi * 4 + pf - kLtpfMinPitch * 4;
  } else if (pi < kLtpfRes2) {
    p.index = pi * 2 + (pf >> 1) - kLtpfRes4 * 2 + (kLtpfRes4 - kLtpfMinPitch) * 4;
  } else {
    p.index = pi - kLtpfRes2 + (kLtpfRes4 - kLtpfMinPitch) * 4 + (kLtpfRes2 - kLtpfRes4) * 2;
  }
  return p;
}

// Sample j of the block filtered by row 0 of enc_inter_filter (cf) and of the
// signal at the pitch filtered by its fractional row (pf).
ACX_HD void ltpf_filtered(const float* buf, const LtpfGeom& g, const float* ef, LtpfPitch p,
                          int j, float* cf, float* pf) {
  const int last = ltpf_row_len(g) - 1;
  const int n = g.xbase + j;
  *cf = radd(radd(rmul(buf[imin(n + 1, last)], ef[0]), rmul(buf[n], ef[1])),
             rmul(buf[n - 1], ef[2]));
  const int m = iclamp(n - p.pitch_int, 2, last - 1);
  const float* f = ef + 4 * iclamp(p.pitch_fr, 0, 3);
  *pf = radd(radd(radd(rmul(buf[m + 1], f[0]), rmul(buf[m], f[1])), rmul(buf[m - 1], f[2])),
             rmul(buf[m - 2], f[3]));
}

// The three chains of the normalised correlation over the filtered samples.
ACX_HD float ltpf_chain(const float* a, const float* b, int n) {
  float acc = rmul(a[0], b[0]);
  for (int j = 1; j < n; ++j) acc = radd(acc, rmul(a[j], b[j]));
  return acc;
}

struct LtpfOut {
  int param[3];
  int bits;
  float nc, mem_mem_nc, pitch;
  int on;
};

// The normalised correlation and the activation rules (ltpf_coder.c:227-241).
ACX_HD LtpfOut ltpf_decide(float s1, float s2, float s3, LtpfPitch p, float nc_ol, float mem_nc,
                           float mem_mem_nc, int mem_on, float mem_pitch, const LtpfGeom& g) {
  float nc = rdiv(s1, radd(rroot(rmul(s2, s3)), 1e-5f));
  nc = nc > 1.0f ? 1.0f : (nc < 0.0f ? 0.0f : nc);
  const float pitch = radd(static_cast<float>(p.pitch_int),
                           rmul(static_cast<float>(p.pitch_fr), 0.25f));
  const bool searched = nc_ol > 0.6f;
  bool fresh = mem_on == 0 && nc > 0.94f && mem_nc > 0.94f;
  if (g.frame_dms != 100) fresh = fresh && mem_mem_nc > 0.94f;
  const bool keep = mem_on == 1 && nc > 0.9f;
  const bool track = mem_on == 1 && fabsf(rsub(pitch, mem_pitch)) < 2.0f &&
                     rsub(nc, mem_nc) > -0.1f && nc > 0.84f;
  const bool active = g.enable && searched && (fresh || keep || track);
  LtpfOut o;
  o.param[0] = searched ? 1 : 0;
  o.param[1] = searched && active ? 1 : 0;
  o.param[2] = searched ? p.index : 0;
  o.bits = searched ? 11 : 1;
  o.nc = searched ? nc : nc_ol;
  o.mem_mem_nc = g.frame_dms < 100 ? mem_nc : mem_mem_nc;
  o.on = o.param[1];
  o.pitch = searched ? pitch : 0.0f;
  return o;
}

// The whole coder for one stream, in order. buf: scratch of kLtpfMaxRow
// floats; tab: inter4_1[:32] ++ enc_inter_filter [4][4]. Writes new_mem_in
// [mem_len] and returns the scalar outputs.
ACX_HD LtpfOut ltpf_encode_lane(const float* s12k8, int pitch_ol, float nc_ol,
                                const float* mem_in, float mem_nc, float mem_mem_nc, int mem_on,
                                float mem_pitch, const float* tab, const LtpfGeom& g, float* buf,
                                float* new_mem_in) {
  for (int i = 0; i < g.mem_len; ++i) buf[i] = mem_in[i];
  for (int i = 0; i < g.xlen; ++i) buf[g.mem_len + i] = s12k8[i];
  for (int i = 0; i < g.mem_len; ++i) new_mem_in[i] = buf[g.N + i];
  const float e_cur = ltpf_energy(buf, g);
  float cor[kLtpfWin];
  for (int i = 0; i < kLtpfWin; ++i) cor[i] = ltpf_window_nc(buf, g, pitch_ol, i, e_cur);
  const LtpfPitch p = ltpf_pitch_search(cor, pitch_ol, tab);
  float cf[kLtpfMaxAcf], pf[kLtpfMaxAcf];
  for (int j = 0; j < g.acflen; ++j) {
    ltpf_filtered(buf, g, tab + kLtpfInterTaps, p, j, &cf[j], &pf[j]);
  }
  return ltpf_decide(ltpf_chain(cf, pf, g.acflen), ltpf_chain(cf, cf, g.acflen),
                     ltpf_chain(pf, pf, g.acflen), p, nc_ol, mem_nc, mem_mem_nc, mem_on,
                     mem_pitch, g);
}

}  // namespace acx
