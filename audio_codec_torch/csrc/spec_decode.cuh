// The decoder's spectrum reconstruction of one stream, from partial
// concealment to the global gain (dec_lc3.c's order, as
// audio_codec_tpu/models/decoder.py:103-125 composes ops/pc.py:pc_apply and
// pc_update and ops/quant.py:residual_decode, noise_filling and
// apply_global_gain). spec_decode.cu spreads the lines of a stream over the
// lanes of a warp; spec_decode_lane runs the same steps in order, which is
// how the functions compile as plain C++ without nvcc.
//
// The float results must equal the plain version's (ops/quant.py:
// spectrum_decode_plain) on the card bit for bit, so every product, sum,
// quotient and root is rounded on its own (rmul, radd, rsub, rdiv, rroot) in
// its order: the concealment's four energies are chains of squares in line
// order, computed only for a partially corrupt frame (bfi 2), whose outputs
// alone depend on them. The noise-filling generator u' = (31821 u + 13849)
// mod 2^16 steps once per filled line; a line's value after r + 1 steps is
// the closed form u0 * mult[r + 1] + add[r + 1], as the plain version computes
// it, so each line needs only its rank among the filled lines.
#pragma once

#include "acodec.cuh"

namespace acx {

constexpr int kSpecBwCutoffs = 6;    // bw_cutoff_bins entries
constexpr int kSpecMaxLines = 416;   // 13 x 32 >= the 400 lines of a 10 ms frame

// The configuration's geometry (ops/quant.py:noise_filling, residual_decode).
struct SpecGeom {
  int N;          // spectral lines
  int width;      // zero-line window half width: 3 at 10 ms, else 1
  int start;      // first line filled: 24, 12 or 6
  int res_width;  // residual bits a frame can carry
};

// Per-stream inputs of the kernel's flat [B] vectors.
struct SpecScalars {
  float gain;             // 10^((gg_idx + offset) / 28)
  int bfi, rframe, spec_inv_idx, bw_idx, fac_ns_idx;
  int residual_present, n_res, nf_seed, zero_frame;
  float prev_gg;
  int prev_bw_idx;
  float prev_fac_ns;
  int nb_lost;
};

// The concealment's new history and what the rest of the frame needs.
struct SpecHistory {
  float prev_gg;
  int prev_bw_idx;
  float prev_fac_ns;
  int nb_lost;
  int bw_bin_nf;     // the bandwidth noise filling runs at
};

// The chain from zero of a[k]^2 over [lo, hi).
ACX_HD float spec_energy(const float* a, int lo, int hi) {
  float acc = 0.0f;
  for (int k = lo; k < hi; ++k) acc = radd(acc, rmul(a[k], a[k]));
  return acc;
}

// pc_apply's factors from its four energies: fac (the energy ratio's root, or
// 1) and the factor of the synthesised lines (the gains' ratio or fac).
ACX_HD float spec_fac(float ener_prev, float ener_curr) {
  if (!(ener_prev > 0.0f)) return 1.0f;
  const float ratio = rdiv(ener_curr, ener_prev < 1e-30f ? 1e-30f : ener_prev);
  return rroot(ratio > 1.0f ? 1.0f : ratio);
}

ACX_HD float spec_fac_local(float mean_low, float mean_high, float ener_prev, float ener_curr,
                            int inv, int N, const SpecScalars& s) {
  const float n_low = static_cast<float>(imax(inv, 1));
  const float n_high = static_cast<float>(imax(N - inv, 1));
  if (inv < N - inv) {
    mean_high = rdiv(rmul(mean_high, n_low), n_high);
  } else {
    mean_low = rdiv(rmul(mean_low, n_high), n_low);
  }
  const bool use_gains = mean_low <= mean_high ||
                         rmul(ener_prev, rmul(s.prev_gg, s.prev_gg)) <=
                             rmul(ener_curr, rmul(s.gain, s.gain));
  return use_gains ? rdiv(s.prev_gg, s.gain < 1e-30f ? 1e-30f : s.gain)
                   : spec_fac(ener_prev, ener_curr);
}

// pc_update and the lost-frame count. fac: pc_apply's fac (bfi 2).
ACX_HD SpecHistory spec_history(const SpecScalars& s, float fac, int N, const int32_t* bw_bins) {
  const bool good = s.bfi != 1, act = s.bfi == 2;
  SpecHistory h;
  h.prev_gg = good ? s.gain : s.prev_gg;
  const bool plain = good && s.rframe == 0;
  h.prev_bw_idx = plain ? s.bw_idx : s.prev_bw_idx;
  h.prev_fac_ns = plain ? rdiv(rsub(8.0f, static_cast<float>(s.fac_ns_idx)), 16.0f)
                        : s.prev_fac_ns;
  const bool redo = good && s.rframe != 0 && act && s.bw_idx != s.prev_bw_idx &&
                    s.spec_inv_idx < N;
  if (redo) {
    const float d = rmul(s.prev_fac_ns, fac);
    h.prev_fac_ns = d < 0.0625f ? 0.0625f : (d > 0.5f ? 0.5f : d);
  }
  h.nb_lost = s.bfi == 0 ? 0 : s.nb_lost + (act ? 1 : 0);
  h.bw_bin_nf = bw_bins[iclamp(redo ? s.prev_bw_idx : s.bw_idx, 0, kSpecBwCutoffs - 1)];
  return h;
}

// Line k after the concealment: the previous residual line scaled by
// fac_local at and above spec_inv_idx of a bfi-2 frame, below 0.625 zeroed.
ACX_HD float spec_concealed(const float* x, const float* q_old_res, int k, const SpecScalars& s,
                            float fac_local) {
  if (s.bfi != 2 || k < s.spec_inv_idx) return x[k];
  const float syn = rmul(q_old_res[k], fac_local);
  return fabsf(syn) < 0.625f ? 0.0f : syn;
}

// A nonzero line nudged by its residual bit: bit 1 adds 5/16 to a positive
// line and 3/16 to a negative one, bit 0 takes 3/16 from a positive line and
// 5/16 from a negative one.
ACX_HD float spec_nudge(float v, int32_t bit) {
  const float d = bit != 0 ? (v > 0.0f ? 0.3125f : 0.1875f) : (v > 0.0f ? -0.1875f : -0.3125f);
  return radd(v, d);
}

// Whether line k of the spectrum after the residual (xr) is a zero line:
// start <= k < bw and no nonzero line in [k - width, min(k + width, bw - 1)].
ACX_HD bool spec_zero_line(const float* xr, int k, int bw, const SpecGeom& g) {
  if (k < g.start || k >= bw) return false;
  for (int i = imax(k - g.width, 0); i <= imin(k + g.width, bw - 1); ++i) {
    if (xr[imin(i, g.N - 1)] != 0.0f) return false;
  }
  return true;
}

// The filled value of the zero line of rank r among the filled lines: the
// generator after r + 1 steps from nf_seed + 32768 sets the sign, the level
// is the frame's below spec_inv_idx and the previous frame's above it.
// lcg: mult [N + 1] ++ add [N + 1] (ops/quant.py:lcg_tables).
ACX_HD float spec_fill(int k, int r, const SpecScalars& s, const int32_t* lcg, int N) {
  const int steps = iclamp(r + 1, 0, N);
  const unsigned u = (static_cast<unsigned>(s.nf_seed + 32768) * static_cast<unsigned>(lcg[steps]) +
                      static_cast<unsigned>(lcg[N + 1 + steps])) & 0xffffu;
  const float level = k < s.spec_inv_idx
                          ? rdiv(rsub(8.0f, static_cast<float>(s.fac_ns_idx)), 16.0f)
                          : s.prev_fac_ns;
  return u < 32768u ? -level : level;
}

// The concealment's factors, computed only for a bfi-2 frame.
ACX_HD void spec_factors(const float* x, const float* q_old_res, const float* q_old_d,
                         const SpecScalars& s, int N, float* fac, float* fac_local) {
  *fac = 1.0f;
  *fac_local = 0.0f;
  if (s.bfi != 2) return;
  const int inv = iclamp(s.spec_inv_idx, 0, N);
  const float ener_prev = spec_energy(q_old_res, 0, inv);
  const float ener_curr = spec_energy(x, 0, inv);
  *fac = spec_fac(ener_prev, ener_curr);
  *fac_local = spec_fac_local(spec_energy(q_old_d, 0, inv), spec_energy(q_old_d, inv, N),
                              ener_prev, ener_curr, s.spec_inv_idx, N, s);
}

// The whole reconstruction for one stream, in order. Writes x_out (the
// spectrum after the global gain; the decoded spectrum unchanged on a lost
// frame) and q_old_res_out (the spectrum after the concealment, or the
// previous one on a lost frame), and returns the new history.
ACX_HD SpecHistory spec_decode_lane(const float* x, const float* q_old_res, const float* q_old_d,
                                    const int32_t* res_bits, const SpecScalars& s,
                                    const int32_t* bw_bins, const int32_t* lcg,
                                    const SpecGeom& g, float* x_out, float* q_old_res_out) {
  float fac, fac_local;
  spec_factors(x, q_old_res, q_old_d, s, g.N, &fac, &fac_local);
  const SpecHistory h = spec_history(s, fac, g.N, bw_bins);
  const bool good = s.bfi != 1;
  const bool residual = good && s.residual_present == 1;
  int rank = 0;
  for (int k = 0; k < g.N; ++k) {
    float v = spec_concealed(x, q_old_res, k, s, fac_local);
    q_old_res_out[k] = good ? v : q_old_res[k];
    if (residual && v != 0.0f) {
      if (rank < s.n_res) v = spec_nudge(v, res_bits[iclamp(rank, 0, g.res_width - 1)]);
      ++rank;
    }
    x_out[k] = v;
  }
  if (!good) return h;
  // the zero lines of the spectrum after the residual, before any is filled
  bool zero[kSpecMaxLines];
  for (int k = 0; k < g.N; ++k) {
    zero[k] = s.zero_frame == 0 && spec_zero_line(x_out, k, h.bw_bin_nf, g);
  }
  int filled = 0;
  for (int k = 0; k < g.N; ++k) {
    const float v = zero[k] ? spec_fill(k, filled++, s, lcg, g.N) : x_out[k];
    x_out[k] = rmul(v, s.gain);
  }
  return h;
}

}  // namespace acx
