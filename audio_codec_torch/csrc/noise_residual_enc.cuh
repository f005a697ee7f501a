// The encoder's noise factor and residual coder of one stream
// (processNoiseFactor_fl and processResidualCoding_fl, as
// audio_codec_tpu/ops/quant.py:noise_factor and residual_encode compute them,
// with the encoder's n_res = 0 in lsbMode). noise_residual_enc.cu spreads the
// lines of a stream over the lanes of a warp and runs the ordered sums on one
// lane; noise_residual_enc_lane runs the same steps in order, which is how
// the functions compile as plain C++ without nvcc.
//
// The noise factor's float sums must equal the plain version's
// (ops/quant.py:noise_residual_enc_plain) on the card bit for bit: each is a
// chain of |x / gain| over the zero lines in line order, rounded op by op
// (rdiv, radd), divided by the count. A chain from zero over every line, 0
// off the zero lines, is the same chain: the values are never negative. The
// residual bits compare x with the rounded product xq * gain.
#pragma once

#include "acodec.cuh"

namespace acx {

constexpr int kNfMaxLines = 416;   // 13 x 32 >= the 400 lines of a 10 ms frame

// The configuration's geometry (ops/quant.py:noise_factor, residual_encode).
struct NfEncGeom {
  int N;            // spectral lines
  int width;        // zero-line window half width: 3 at 10 ms, else 1
  int start;        // first line tested: 24, 12 or 6
  int half_means;   // 10 ms at <= 20 bytes: the smaller of two half means
  int max_res;      // residual bits a stream
};

// Whether line k is a zero line: start <= k < bw and no nonzero quantized
// line in [k - width, min(k + width, bw - 1)].
ACX_HD bool nf_enc_zero_line(const int32_t* xq, int k, int bw, const NfEncGeom& g) {
  if (k < g.start || k >= bw) return false;
  for (int i = imax(k - g.width, 0); i <= imin(k + g.width, bw - 1); ++i) {
    if (xq[imin(i, g.N - 1)] != 0) return false;
  }
  return true;
}

// |x / gain| of a zero line, 0 elsewhere.
ACX_HD float nf_enc_value(const float* x, int k, float gain, bool zero_line) {
  return zero_line ? fabsf(rdiv(x[k], gain)) : 0.0f;
}

// The chain from zero over v[lo, hi).
ACX_HD float nf_enc_chain(const float* v, int lo, int hi) {
  float acc = 0.0f;
  for (int k = lo; k < hi; ++k) acc = radd(acc, v[k]);
  return acc;
}

// The mean over the zero lines, or at <= 20 bytes the smaller of the means
// below and above the middle line mid (lines k < mid, nlo of them), as the
// index: C round() of 8 - 16 fac, clamped to 0..7.
ACX_HD int nf_enc_index(const float* v, int N, int kcnt, int mid, int nlo,
                        const NfEncGeom& g) {
  float fac = kcnt > 0 ? rdiv(nf_enc_chain(v, 0, N), static_cast<float>(kcnt)) : 0.0f;
  if (g.half_means && kcnt > 0) {
    const float f1 = rdiv(nf_enc_chain(v, 0, mid), static_cast<float>(imax(nlo, 1)));
    const float f2 = rdiv(nf_enc_chain(v, mid, N), static_cast<float>(imax(kcnt - nlo, 1)));
    fac = f2 < f1 ? f2 : f1;
  }
  const float t = rsub(8.0f, rmul(16.0f, fac));
  const float sign = t > 0.0f ? 1.0f : (t < 0.0f ? -1.0f : 0.0f);
  const float r = rmul(sign, floorf(radd(fabsf(t), 0.5f)));
  return static_cast<int>(r < 0.0f ? 0.0f : (r > 7.0f ? 7.0f : r));
}

// The sign-refinement bit of a nonzero line.
ACX_HD int32_t nf_enc_res_bit(const float* x, const int32_t* xq, int k, float gain) {
  return x[k] >= rmul(static_cast<float>(xq[k]), gain) ? 1 : 0;
}

// The residual bits the frame sends: min(nonzero lines, bits left), 0 in lsbMode.
ACX_HD int nf_enc_n_res(int n_nz, int target, int nbits2, int lsb_mode) {
  const int n = imin(n_nz, imax(target - nbits2 + 4, 0));
  return lsb_mode == 0 ? n : 0;
}

// The whole coder for one stream, in order. v: scratch of N floats.
ACX_HD void noise_residual_enc_lane(const float* x, const int32_t* xq, float gain, int bw_bin,
                                    int target, int nbits2, int lsb_mode, const NfEncGeom& g,
                                    float* v, int32_t* fac_ns_idx, int32_t* res,
                                    int32_t* n_res) {
  const int bw = iclamp(bw_bin, 0, g.N);
  int kcnt = 0, lines = 0;
  for (int k = 0; k < g.N; ++k) {
    const bool z = nf_enc_zero_line(xq, k, bw, g);
    v[k] = nf_enc_value(x, k, gain, z);
    kcnt += z ? 1 : 0;
    lines += z ? k + 1 : 0;
  }
  const int mid = kcnt > 0 ? lines / kcnt : 0;
  int nlo = 0;
  for (int k = 0; k < mid; ++k) nlo += nf_enc_zero_line(xq, k, bw, g) ? 1 : 0;
  *fac_ns_idx = nf_enc_index(v, g.N, kcnt, mid, nlo, g);
  int rank = 0;
  for (int k = 0; k < g.N; ++k) {
    if (xq[k] == 0) continue;
    if (rank < g.max_res) res[rank] = nf_enc_res_bit(x, xq, k, gain);
    ++rank;
  }
  for (int i = imin(rank, g.max_res); i < g.max_res; ++i) res[i] = 0;
  *n_res = nf_enc_n_res(rank, target, nbits2, lsb_mode);
}

}  // namespace acx
