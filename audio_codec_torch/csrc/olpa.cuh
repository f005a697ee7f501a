// The open-loop pitch search of one stream (olpa.c:52-180, as
// audio_codec_tpu/ops/analysis.py:olpa computes it): the 5-tap low-pass and
// decimation to 6.4 kHz, the correlation R and energy E at the 98 lags
// 17..114, the weighted first maximum, the search within +-4 of the previous
// pitch, and the choice between the two. olpa.cu spreads the lags of a stream
// over the lanes of a warp and reduces the maxima with first_max_beats;
// olpa_lane runs the same steps in order, which is how the functions compile
// as plain C++ without nvcc.
//
// Every float result must equal the plain version's (ops/analysis.py:
// olpa_plain) on the card bit for bit, so every product and sum is rounded on
// its own (rmul, radd, rdiv, rroot) in the order it states: each low-pass
// output is a chain from zero over the taps; R, E and e0 of a lag are chains
// from the first product over the samples, ascending.
#pragma once

#include "acodec.cuh"

namespace acx {

constexpr int kOlpaMinPitch = 17;   // MIN_PITCH_6K4
constexpr int kOlpaMaxPitch = 114;  // MAX_PITCH_6K4
constexpr int kOlpaLags = 98;       // RANGE_PITCH_6K4
constexpr int kOlpaTaps = 5;
constexpr int kOlpaMaxRow = 208;    // 6.4 kHz memory + decimated frame, at most 130 + 64
constexpr int kOlpaTableWords = kOlpaTaps + kOlpaLags;   // olpa_down2 ++ olpa_acw
constexpr int kNoIndex = 1 << 30;

// The configuration's geometry (ops/analysis.py:olpa_plain).
struct OlpaGeom {
  int length;       // 12.8 kHz samples of the frame
  int len2;         // decimated samples, length / 2
  int mem_in_len;   // 6.4 kHz memory
  int acflen;       // correlation length
  int base;         // first sample of the current block in the 6.4 kHz row
};

// (v, i) comes before the best (bv, bi) so far in a first-maximum search:
// a larger value, or an equal one at a lower index (jnp.argmax's order).
ACX_HD bool first_max_beats(float v, int i, float bv, int bi) {
  return v > bv || (v == bv && i < bi);
}

// Sample n of [mem_s12k8 (3), s12k8].
ACX_HD float olpa_in(const float* mem12, const float* s, int n) {
  return n < 3 ? mem12[n] : s[n - 3];
}

// Decimated sample i: the low-pass output at 4 + 2i, a chain from zero over
// the taps, ((0 + w0 b[j]) + w1 b[j-1]) + ...
ACX_HD float olpa_decimate(const float* mem12, const float* s, const float* w, int i) {
  const int j = 4 + 2 * i;
  float acc = 0.0f;
#pragma unroll
  for (int k = 0; k < kOlpaTaps; ++k) acc = radd(acc, rmul(w[k], olpa_in(mem12, s, j - k)));
  return acc;
}

// e0: the current block's energy.
ACX_HD float olpa_energy(const float* row, const OlpaGeom& g) {
  const float* cur = row + g.base;
  float e = rmul(cur[0], cur[0]);
  for (int n = 1; n < g.acflen; ++n) e = radd(e, rmul(cur[n], cur[n]));
  return e;
}

// R and E of lag index l (the lag 17 + l).
ACX_HD void olpa_lag_sums(const float* row, const OlpaGeom& g, int l, float* r, float* e) {
  const float* cur = row + g.base;
  const float* lag = row + imax(g.base - kOlpaMinPitch - l, 0);
  float rr = rmul(cur[0], lag[0]);
  float ee = rmul(lag[0], lag[0]);
  for (int n = 1; n < g.acflen; ++n) {
    rr = radd(rr, rmul(cur[n], lag[n]));
    ee = radd(ee, rmul(lag[n], lag[n]));
  }
  *r = rr;
  *e = ee;
}

// Whether lag index l lies within +-4 of the previous pitch (clipped to the range).
ACX_HD bool olpa_in_window(int l, int mem_pitch) {
  const int lag = l + kOlpaMinPitch;
  return lag >= imax(mem_pitch - 4, kOlpaMinPitch) && lag <= imin(mem_pitch + 4, kOlpaMaxPitch);
}

ACX_HD float olpa_norm_corr(float r, float e, float e0) {
  const float nc = rdiv(r, radd(rroot(rmul(e, e0)), 1e-5f));
  return nc < 0.0f ? 0.0f : nc;
}

// The pitch T0 and its normalised correlation from the weighted maximum L
// and the windowed maximum L2: the windowed one is taken where it differs and
// its correlation exceeds 0.85 of the other's.
ACX_HD void olpa_decide(float r1, float e1, int L, float r2, float e2, int L2, float e0, int* t0,
                        float* nc) {
  const int T0 = L + kOlpaMinPitch, T02 = L2 + kOlpaMinPitch;
  const float nc1 = olpa_norm_corr(r1, e1, e0), nc2 = olpa_norm_corr(r2, e2, e0);
  const bool take2 = T02 != T0 && nc2 > rmul(nc1, 0.85f);
  *t0 = take2 ? T02 : T0;
  *nc = take2 ? nc2 : nc1;
}

// The whole search for one stream, in order. row: scratch of kOlpaMaxRow
// floats; tab: olpa_down2 (5) ++ olpa_acw (98). Writes 2*T0, nc, T0 and the
// two new memories (new_mem12 [3], new_mem64 [mem_in_len]).
ACX_HD void olpa_lane(const float* s, const float* mem12, const float* mem64, int mem_pitch,
                      const float* tab, const OlpaGeom& g, float* row, int* pitch2, float* nc,
                      int* t0, float* new_mem12, float* new_mem64) {
  for (int i = 0; i < g.mem_in_len; ++i) row[i] = mem64[i];
  for (int i = 0; i < g.len2; ++i) row[g.mem_in_len + i] = olpa_decimate(mem12, s, tab, i);
  for (int i = 0; i < 3; ++i) new_mem12[i] = olpa_in(mem12, s, g.length + i);
  for (int i = 0; i < g.mem_in_len; ++i) new_mem64[i] = row[g.len2 + i];
  const float e0 = olpa_energy(row, g);
  const float* acw = tab + kOlpaTaps;
  float r[kOlpaLags], e[kOlpaLags];
  float bv = -INFINITY, bv2 = -INFINITY;
  int bi = kNoIndex, bi2 = kNoIndex;
  for (int l = 0; l < kOlpaLags; ++l) {
    olpa_lag_sums(row, g, l, &r[l], &e[l]);
    const float v = rmul(r[l], acw[l]);
    if (first_max_beats(v, l, bv, bi)) { bv = v; bi = l; }
    const float v2 = olpa_in_window(l, mem_pitch) ? r[l] : -INFINITY;
    if (first_max_beats(v2, l, bv2, bi2)) { bv2 = v2; bi2 = l; }
  }
  const int L = iclamp(bi, 0, kOlpaLags - 1), L2 = iclamp(bi2, 0, kOlpaLags - 1);
  olpa_decide(r[L], e[L], L, r[L2], e[L2], L2, e0, t0, nc);
  *pitch2 = 2 * *t0;
}

}  // namespace acx
