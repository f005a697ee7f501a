// The partial-concealment classifier of one stream (pc_classify_fx.c:19-299,
// as audio_codec_tpu/ops/pc.py:pc_classify and _peak_detector compute it):
// whether a partially corrupt frame (bfi 2) is downgraded to a full loss.
// pc_classify.cu launches it one thread per stream; without nvcc it compiles
// as plain C++.
//
// The float results decide comparisons only, but a last-place difference
// flips one, so every product and sum is rounded on its own (rmul, radd) in
// the order the plain version (ops/pc.py) states for a tensor on the card:
// the mean energy is one chain over the row, bins ascending, times
// float32(1 / N); each 3-bin block energy is (s[k] + s[k+1]) + s[k+2]; the
// two residual energies are chains from zero.
#pragma once

#include "acodec.cuh"

namespace acx {

constexpr int kPcBlock = 3;   // peakDetector BLOCK_SIZE
constexpr int kPcThr1 = 8;

ACX_HD float fmax3(float a, float b, float c) {
  const float m = a > b ? a : b;
  return m > c ? m : c;
}

// peakDetector_fx (pc_classify_fx.c:150-299): the crossover bin below which a
// dominant spectral peak sits. sig [N].
ACX_HD int pc_peak_detector(const float* sig, int N, float inv_n) {
  float sum = 0.0f;
  for (int i = 0; i < N; ++i) sum = radd(sum, rmul(sig[i], sig[i]));
  const float mean_nrg = rmul(rmul(sum, inv_n), static_cast<float>(kPcBlock * kPcThr1));
  const float a0 = fabsf(sig[0]), a1 = fabsf(sig[1]);
  // the first block (i == 0): two bins
  const float edge_cent = radd(rmul(sig[0], sig[0]), rmul(sig[1], sig[1]));
  const bool hit0 = a0 >= a1 && edge_cent > mean_nrg &&
                    (a0 > a1 ? a0 : a1) > fmax3(fabsf(sig[2]), fabsf(sig[3]), fabsf(sig[4]));
  float max_peak = hit0 ? edge_cent : 0.0f;
  int xover = hit0 ? 1 : 0;
  for (int k = 0; k <= N - 2 * kPcBlock; ++k) {
    const float ak = fabsf(sig[k]), ak1 = fabsf(sig[k + 1]), ak2 = fabsf(sig[k + 2]);
    if (!(ak1 >= ak && ak1 >= ak2)) continue;             // no local maximum at k+1
    const float cent = radd(radd(rmul(sig[k], sig[k]), rmul(sig[k + 1], sig[k + 1])),
                            rmul(sig[k + 2], sig[k + 2]));
    if (!(cent > mean_nrg)) continue;
    const float cur = fmax3(ak, ak1, ak2);
    float prv = 0.0f;   // the bins k-3..k-1; for k < 3 those above bin 0
    for (int j = k - kPcBlock; j < k; ++j) {
      if (j > 0 || k >= kPcBlock) prv = prv > fabsf(sig[j]) ? prv : fabsf(sig[j]);
    }
    const float nxt = fmax3(fabsf(sig[k + 3]), fabsf(sig[k + 4]), fabsf(sig[k + 5]));
    if (!(cur >= prv && cur > nxt)) continue;
    // hysteresis: a new maximum, or one above 0.3 of it, moves the crossover
    if (cent >= max_peak) {
      max_peak = cent;
      xover = k + kPcBlock - 1;
    } else if (cent > rmul(0.3f, max_peak)) {
      xover = k + kPcBlock - 1;
    }
  }
  return xover;
}

// processPCclassify_fx: bfi' of one stream. q_old_d, q_old_res [N].
ACX_HD int pc_classify_lane(int bfi, int spec_inv_idx, float stab_fac, int pitch_present,
                            const float* q_old_d, const float* q_old_res, int N, int frame_dms,
                            float inv_n) {
  const bool low_region = spec_inv_idx * 10 < 4 * frame_dms;
  if (!(bfi == 2 && low_region)) return bfi;
  if (stab_fac < 0.5f) return 1;                          // unstable
  bool bad;
  if (pitch_present == 1) {
    const int max_pitch_bin = frame_dms == 50 ? 4 : 8;
    const int xover = pc_peak_detector(q_old_d, N, inv_n);
    bad = spec_inv_idx < xover || spec_inv_idx < max_pitch_bin;
  } else {
    float part = 0.0f, full = 0.0f;
    for (int i = 0; i < N; ++i) {
      const float e = rmul(q_old_res[i], q_old_res[i]);
      part = radd(part, i < spec_inv_idx ? e : 0.0f);
      full = radd(full, e);
    }
    bad = part < rmul(0.3f, full);
  }
  return bad ? 1 : bfi;
}

}  // namespace acx
