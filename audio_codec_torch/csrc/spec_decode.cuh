// The decoder's spectrum reconstruction of one stream on a warp, from partial
// concealment to the global gain (dec_lc3.c's order, as
// audio_codec_tpu/models/decoder.py:103-125 composes ops/pc.py:pc_apply and
// pc_update and ops/quant.py:residual_decode, noise_filling and
// apply_global_gain). spec_decode.cu runs spec_decode_warp a warp a stream;
// it is a template over the warp (warp.cuh), so g++ compiles it for the CPU
// rehearsals (tests/test_torch_dec_rehearsal.py,
// tests/test_torch_lane_rehearsal.py).
//
// Lane l holds the lines 32 c + l of the row, c < NC = ceil(N / 32): the
// decoded spectrum and, for a lost or partially corrupt frame, the previous
// residual row, in registers, loaded once with every load issued before the
// first ballot. The residual bits a rank can read (the first min(res_width,
// N)) are loaded the same way and packed by ballots into words, word j on
// lane j, so a nonzero line's bit is a shuffle and a shift at its rank (a
// ballot prefix), not a load. The nonzero lines after the residual are a
// ballot a chunk, masked to the lines below the bandwidth, and a line's
// zero-line window is a few bits of them (noise_residual_enc.cuh:
// nf_window_clear), so the test reads no memory. The ballot is taken after
// the nudges, as the plain version tests the row after the residual; on
// the decoder's rows it is the ballot before them too: a decoded line is an
// integer and a synthesised one at least 0.625 in magnitude (spec_concealed
// zeroes anything smaller), and a nudge of 3/16 or 5/16 makes neither zero.
//
// The float results must equal the plain version's (ops/quant.py:
// spectrum_decode_plain) on the card bit for bit, so every product, sum,
// quotient and root is rounded on its own (rmul, radd, rsub, rdiv, rroot) in
// its order: the concealment's four energies are chains of squares in line
// order on lanes 0-3, computed only for a partially corrupt frame (bfi 2),
// whose outputs alone depend on them. The noise-filling generator
// u' = (31821 u + 13849) mod 2^16 steps once per filled line: the line of
// rank r takes its state after r + 1 steps from nf_seed + 32768, which the
// plain version computes in closed form from tables (ops/quant.py:
// lcg_tables). Here the state is carried from chunk to chunk: lane l holds
// the map of l steps (spec_lcg_power), a filled line of rank j in its chunk
// takes the map of its rank by a shuffle and applies it and one step to the
// chunk's state (spec_lcg_next), and the chunk's last filled line hands its
// state on by a shuffle. Every step is exact integer arithmetic mod 2^16, so
// the states are the tables' states; the kernel reads no table.
#pragma once

#include "acodec.cuh"
#include "noise_residual_enc.cuh"
#include "warp.cuh"

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

// The frame's noise level (8 - fac_ns_idx) / 16.
ACX_HD float spec_level(const SpecScalars& s) {
  return rdiv(rsub(8.0f, static_cast<float>(s.fac_ns_idx)), 16.0f);
}

// pc_update and the lost-frame count. fac: pc_apply's fac (bfi 2).
ACX_HD SpecHistory spec_history(const SpecScalars& s, float fac, int N, const int32_t* bw_bins) {
  const bool good = s.bfi != 1, act = s.bfi == 2;
  SpecHistory h;
  h.prev_gg = good ? s.gain : s.prev_gg;
  const bool plain = good && s.rframe == 0;
  h.prev_bw_idx = plain ? s.bw_idx : s.prev_bw_idx;
  h.prev_fac_ns = plain ? spec_level(s) : s.prev_fac_ns;
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

// Line k after the concealment, from its decoded value xk and previous
// residual qk: qk scaled by fac_local at and above spec_inv_idx of a bfi-2
// frame, below 0.625 zeroed.
ACX_HD float spec_concealed(float xk, float qk, int k, const SpecScalars& s, float fac_local) {
  if (s.bfi != 2 || k < s.spec_inv_idx) return xk;
  const float syn = rmul(qk, fac_local);
  return fabsf(syn) < 0.625f ? 0.0f : syn;
}

// A nonzero line nudged by its residual bit: bit 1 adds 5/16 to a positive
// line and 3/16 to a negative one, bit 0 takes 3/16 from a positive line and
// 5/16 from a negative one.
ACX_HD float spec_nudge(float v, int32_t bit) {
  const float d = bit != 0 ? (v > 0.0f ? 0.3125f : 0.1875f) : (v > 0.0f ? -0.1875f : -0.3125f);
  return radd(v, d);
}

// The noise-filling generator u' = (31821 u + 13849) mod 2^16 (noise_filling.c)
// as an affine map u -> (m u + a) mod 2^16, and its power of `steps` steps
// (steps < 32), by squarings: the maps of one generator commute, so their
// product in any order is the same map.
constexpr uint32_t kLcgMul = 31821u, kLcgAdd = 13849u;

ACX_HD void spec_lcg_power(int steps, uint32_t* m, uint32_t* a) {
  uint32_t mm = 1u, aa = 0u, sm = kLcgMul, sa = kLcgAdd;
  for (int bit = 0; bit < 5; ++bit) {
    if ((steps >> bit) & 1) {
      mm = (sm * mm) & 0xffffu;
      aa = (sm * aa + sa) & 0xffffu;
    }
    sa = (sm * sa + sa) & 0xffffu;
    sm = (sm * sm) & 0xffffu;
  }
  *m = mm;
  *a = aa;
}

// The generator after j steps (the map (m, a)) and one more from u.
ACX_HD uint32_t spec_lcg_next(uint32_t m, uint32_t a, uint32_t u) {
  const uint32_t uj = (m * u + a) & 0xffffu;
  return (kLcgMul * uj + kLcgAdd) & 0xffffu;
}

// The whole reconstruction of one stream on a warp, NC = ceil(N / 32)
// chunks: x, q_old_res, q_old_d its rows [N], res_bits its residual bits
// [res_width]. Writes x_out (the spectrum after the global gain; the decoded
// spectrum unchanged on a lost frame) and q_old_res_out (the spectrum after
// the concealment, or the previous one on a lost frame), and returns the new
// history (the same on every lane).
template <int NC, class W>
ACX_HD SpecHistory spec_decode_warp(const W& w, const float* x, const float* q_old_res,
                                    const float* q_old_d, const int32_t* res_bits,
                                    const SpecScalars& s, const int32_t* bw_bins,
                                    const SpecGeom& g, float* x_out, float* q_old_res_out) {
  using IL = typename W::template Lanes<int>;
  struct Row {
    float v[NC];      // the line: decoded, then concealed, nudged
    float q[NC];      // the previous residual line (a frame with bfi 1 or 2)
    int32_t r[NC];    // the residual bit of rank 32 c + lane
  };
  typename W::template Lanes<Row> row;
  typename W::template Lanes<uint32_t> words;   // word j of the residual bits on lane j
  const int N = g.N, n_bits = imin(g.res_width, N);
  const bool history = s.bfi != 0;
  w.lanes([&](int ln) {
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      const int k = 32 * c + ln;
      row[ln].v[c] = k < N ? x[k] : 0.0f;
      row[ln].q[c] = history && k < N ? q_old_res[k] : 0.0f;
      row[ln].r[c] = k < n_bits ? res_bits[k] : 0;
    }
    words[ln] = 0u;
  });
#pragma unroll
  for (int c = 0; c < NC; ++c) {
    IL p;
    w.lanes([&](int ln) { p[ln] = row[ln].r[c] != 0 ? 1 : 0; });
    const uint32_t word = w.ballot(p);
    w.lanes([&](int ln) { words[ln] = ln == c ? word : words[ln]; });
  }

  // the concealment's four energies, one chain a lane, where bfi is 2
  float fac = 1.0f, fac_local = 0.0f;
  if (s.bfi == 2) {
    const int inv = iclamp(s.spec_inv_idx, 0, N);
    typename W::template Lanes<float> e;
    // ener_prev, ener_curr, mean_low, mean_high on lanes 0-3
    w.lanes([&](int ln) {
      const float* a = ln == 0 ? q_old_res : (ln == 1 ? x : q_old_d);
      e[ln] = ln < 4 ? spec_energy(a, ln == 3 ? inv : 0, ln == 3 ? N : inv) : 0.0f;
    });
    const float ener_prev = w.shfl(e, 0), ener_curr = w.shfl(e, 1);
    const float mean_low = w.shfl(e, 2), mean_high = w.shfl(e, 3);
    fac = spec_fac(ener_prev, ener_curr);
    fac_local = spec_fac_local(mean_low, mean_high, ener_prev, ener_curr, s.spec_inv_idx, N, s);
  }
  const SpecHistory h = spec_history(s, fac, N, bw_bins);

  // the concealed spectrum, the history row and the residual's nudges; the
  // nonzero lines after them below the bandwidth
  const bool good = s.bfi != 1;
  const bool residual = good && s.residual_present == 1;
  const int bw = iclamp(h.bw_bin_nf, 0, N);
  uint32_t nzb[NC];
  int rank0 = 0;
#pragma unroll
  for (int c = 0; c < NC; ++c) {
    IL nz, src, from;
    w.lanes([&](int ln) {
      const int k = 32 * c + ln;
      const float v = k < N ? spec_concealed(row[ln].v[c], row[ln].q[c], k, s, fac_local) : 0.0f;
      if (k < N) q_old_res_out[k] = good ? v : row[ln].q[c];
      row[ln].v[c] = v;
      nz[ln] = residual && v != 0.0f ? 1 : 0;
    });
    const uint32_t m = w.ballot(nz);
    w.lanes([&](int ln) {
      const int rank = rank0 + popc32(m & ((1u << ln) - 1u));
      nz[ln] = nz[ln] != 0 && rank < s.n_res ? 1 : 0;
      src[ln] = iclamp(rank, 0, g.res_width - 1);   // the bit the plain version gathers
      from[ln] = src[ln] >> 5;                      // the lane of its word
    });
    const auto word = w.shfl_from(words, from);
    IL after;
    w.lanes([&](int ln) {
      float v = row[ln].v[c];
      if (nz[ln] != 0) v = spec_nudge(v, static_cast<int32_t>((word[ln] >> (src[ln] & 31)) & 1u));
      row[ln].v[c] = v;
      after[ln] = v != 0.0f ? 1 : 0;
    });
    rank0 += popc32(m);
    nzb[c] = w.ballot(after) & nf_bits_below(bw - 32 * c);
  }
  if (!good) {
    w.lanes([&](int ln) {
#pragma unroll
      for (int c = 0; c < NC; ++c) {
        if (32 * c + ln < N) x_out[32 * c + ln] = row[ln].v[c];
      }
    });
    return h;
  }

  // noise filling in the zero lines of that row, and the global gain
  const bool fill = s.zero_frame == 0;
  const float level = spec_level(s);
  typename W::template Lanes<uint32_t> pm, pa, u;   // lane l: the map of l steps
  w.lanes([&](int ln) { spec_lcg_power(ln, &pm[ln], &pa[ln]); });
  uint32_t gen = static_cast<uint32_t>(s.nf_seed + 32768) & 0xffffu;   // after the filled lines
#pragma unroll
  for (int c = 0; c < NC; ++c) {
    IL z, j;
    const uint32_t prev = c > 0 ? nzb[c > 0 ? c - 1 : 0] : 0u;
    const uint32_t next = c + 1 < NC ? nzb[c + 1 < NC ? c + 1 : c] : 0u;
    w.lanes([&](int ln) {
      const int k = 32 * c + ln;
      z[ln] = fill && k >= g.start && k < bw && nf_window_clear(prev, nzb[c], next, ln, g.width)
                  ? 1 : 0;
    });
    const uint32_t zm = w.ballot(z);
    w.lanes([&](int ln) { j[ln] = popc32(zm & ((1u << ln) - 1u)); });
    const auto m = w.shfl_from(pm, j), a = w.shfl_from(pa, j);
    w.lanes([&](int ln) {
      const int k = 32 * c + ln;
      u[ln] = spec_lcg_next(m[ln], a[ln], gen);
      if (k < N) {
        const float l = k < s.spec_inv_idx ? level : s.prev_fac_ns;
        const float v = z[ln] != 0 ? (u[ln] < 32768u ? -l : l) : row[ln].v[c];
        x_out[k] = rmul(v, s.gain);
      }
    });
    if (zm != 0u) gen = w.shfl(u, msb32(static_cast<int>(zm)));
  }
  return h;
}

}  // namespace acx
