// The SNS vector quantizer's tables and its decoder, one stream per call:
// MPVQ indexing and de-indexing and the decoder's 16-point DCT-II
// (sns_quantize_scf.c). sns_vq_dec.cu launches sns_vq_dec_lane one thread
// per stream; the encoder's warp (sns_vq_enc.cuh) indexes its shape with
// mpvq_enc.
//
// Every float result must equal the plain versions' (ops/sns.py) on the card
// bit for bit: a last-place difference flips an argmin or a pulse. So every
// product, sum and difference is rounded on its own (rmul, radd, rsub), sums
// run left to right from their first term, the 16-wide products run k
// ascending from their first term, and divisions and roots are IEEE (rdiv,
// rroot): the order the plain versions state for a tensor on the card.
// Arrays that live in registers are indexed by unrolled loops only, never by
// a value known at run time.
#pragma once

#include "acodec.cuh"

namespace acx {

constexpr int kSnsM = 16;      // scale factors a frame
constexpr int kSnsCb = 32;     // entries of a stage-1 codebook
constexpr int kMpvqCols = 11;  // columns of the MPVQ offset table (0..10 pulses)

// The tables as one buffer of 32-bit words (kernels.py:_sns_tables): floats,
// but for the MPVQ offsets, which are int32.
constexpr int kOffC1 = 0;                        // [8][32] first-half codebook
constexpr int kOffC2 = kOffC1 + 8 * kSnsCb;      // [8][32] second-half codebook
constexpr int kOffD2 = kOffC2 + 8 * kSnsCb;      // [16][16] DCT-II matrix D2[k][n]
constexpr int kOffA = kOffD2 + kSnsM * kSnsM;    // [16][11] MPVQ offsets, int32
constexpr int kOffRegG = kOffA + kSnsM * kMpvqCols;  // 2 split + 4 low-band gains
constexpr int kOffNearG = kOffRegG + 6;          // 4 gains of the near outlier shape
constexpr int kOffFarG = kOffNearG + 4;          // 8 gains of the far outlier shape
constexpr int kOffDecG = kOffFarG + 8;           // [4][8] decoder gains by submode
constexpr int kOffQG = kOffDecG + 32;            // 6 gains of the split/low-band choice
constexpr int kSnsTableWords = kOffQG + 6;

struct SnsTables {
  const float* f;    // the buffer as floats
  const int32_t* A;  // the MPVQ offsets
};

ACX_HD SnsTables sns_tables(const int32_t* words) {
  return {reinterpret_cast<const float*>(words), words + kOffA};
}

ACX_HD float sq(float v) { return rmul(v, v); }

// out[n] = sum_k in[k] * D2[k][n] in the decoder's order (numerics.xla_dot,
// the reference's): four fused multiply-add chains from zero, term k in chain
// k % 4, combined (c0 + c1) + (c2 + c3).
ACX_HD void sns_dct_chains4(const float (&in)[kSnsM], const float* D2, float (&out)[kSnsM]) {
#pragma unroll
  for (int n = 0; n < kSnsM; ++n) {
    float c[4] = {0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll
    for (int k = 0; k < kSnsM; ++k) c[k % 4] = xfma(in[k], D2[k * kSnsM + n], c[k % 4]);
    out[n] = radd(radd(c[0], c[1]), radd(c[2], c[3]));
  }
}

// MPVQ index of the LEN pulses p[OFF .. OFF+LEN) (pvq_enc): the leading
// sign (0 plus, 1 minus, -1 where there is no pulse) and the index.
template <int LEN, int OFF>
ACX_HD void mpvq_enc(const int (&p)[kSnsM], const int32_t* A, int* ls_out, int* mpvq_out) {
  int ls = -1, mpvq = 0, k = 0;
#pragma unroll
  for (int pos = LEN - 1; pos >= 0; --pos) {
    const int v = p[OFF + pos];
    if (ls >= 0 && v != 0) mpvq = 2 * mpvq + ls;
    ls = v > 0 ? 0 : (v < 0 ? 1 : ls);
    mpvq += A[(LEN - pos - 1) * kMpvqCols + iclamp(k, 0, kMpvqCols - 1)];
    k += iabs(v);
  }
  *ls_out = ls;
  *mpvq_out = mpvq;
}

// MPVQ de-indexing (pvq_dec, sns_quantize_scf.c:520-560): K pulses over the
// LEN lanes p[OFF .. OFF+LEN), from the leading sign and the index.
template <int K, int LEN, int OFF>
ACX_HD void mpvq_dec(int ls_ind, int mpvq, const int32_t* A, int (&p)[kSnsM]) {
  int leading_sign = 1 - 2 * ls_ind;
  int kk = K;
  bool done = false;
#pragma unroll
  for (int pos = 0; pos < LEN; ++pos) {
    const int32_t* row = A + (LEN - pos - 1) * kMpvqCols;
    int cnt = 0;
#pragma unroll
    for (int j = 0; j <= K; ++j) cnt += mpvq >= row[j] ? 1 : 0;
    const int idx = imin(imax(cnt - 1, 0), kk);
    if (mpvq == 0 && !done) {
      p[OFF + pos] = leading_sign * kk;
      done = true;
    }
    if (done) continue;
    int next = mpvq - row[iclamp(idx, 0, K)];
    const int k_delta = kk - idx;
    if (k_delta != 0) {
      p[OFF + pos] = leading_sign * k_delta;
      leading_sign = (next & 1) != 0 ? -1 : 1;
      next >>= 1;  // floor division by 2
      kk -= k_delta;
    }
    mpvq = next;
  }
}

// process_snsQuantizesScf_Dec: the seven indices -> 16 quantized scale factors.
ACX_HD void sns_vq_dec_lane(const int* idx, const SnsTables& t, float* scf_q) {
  int p[kSnsM];
#pragma unroll
  for (int i = 0; i < kSnsM; ++i) p[i] = 0;
  const int sub = idx[2];
  if (sub < 2) {
    mpvq_dec<10, 10, 0>(idx[4], idx[5], t.A, p);
    if (sub == 0) mpvq_dec<1, 6, 10>(idx[6] & 1, idx[6] >> 1, t.A, p);
  } else if (sub == 2) {
    mpvq_dec<8, 16, 0>(idx[4], idx[5], t.A, p);
  } else {
    mpvq_dec<6, 16, 0>(idx[4], idx[5], t.A, p);
  }
  float en = static_cast<float>(p[0] * p[0]);
#pragma unroll
  for (int i = 1; i < kSnsM; ++i) en = radd(en, static_cast<float>(p[i] * p[i]));
  const float norm = rroot(en);
  float v[kSnsM], w[kSnsM];
#pragma unroll
  for (int i = 0; i < kSnsM; ++i) v[i] = rdiv(static_cast<float>(p[i]), norm);
  sns_dct_chains4(v, t.f + kOffD2, w);
  const float g = t.f[kOffDecG + iclamp(sub, 0, 3) * 8 + iclamp(idx[3], 0, 7)];
  const int i0 = iclamp(idx[0], 0, kSnsCb - 1), i1 = iclamp(idx[1], 0, kSnsCb - 1);
#pragma unroll
  for (int i = 0; i < kSnsM; ++i) {
    const float st1 = i < 8 ? t.f[kOffC1 + i * kSnsCb + i0] : t.f[kOffC2 + (i - 8) * kSnsCb + i1];
    scf_q[i] = xfma(g, w[i], st1);
  }
}

}  // namespace acx
