// The SNS vector quantizer, one stream per call: the stage-1 codebooks, the
// 16-point DCT-II, the pulse search, MPVQ indexing and de-indexing
// (sns_quantize_scf.c). sns_vq_enc.cu and sns_vq_dec.cu launch these lane
// functions one thread per stream.
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

// out[n] = sum_k in[k] * D2[k][n] (TRANSPOSED: D2[n][k]), k ascending
template <bool TRANSPOSED>
ACX_HD void sns_dct(const float (&in)[kSnsM], const float* D2, float (&out)[kSnsM]) {
#pragma unroll
  for (int n = 0; n < kSnsM; ++n) {
    float acc = rmul(in[0], D2[TRANSPOSED ? n * kSnsM : n]);
#pragma unroll
    for (int k = 1; k < kSnsM; ++k) {
      acc = radd(acc, rmul(in[k], D2[TRANSPOSED ? n * kSnsM + k : k * kSnsM + n]));
    }
    out[n] = acc;
  }
}

// First index of the least squared distance between target [8] and the 32
// columns of cb [8][32].
ACX_HD int sns_vq_half(const float* target, const float* cb) {
  int best = 0;
  float best_d = 0.0f;
  for (int j = 0; j < kSnsCb; ++j) {
    float d = sq(rsub(target[0], cb[j]));
#pragma unroll
    for (int k = 1; k < 8; ++k) d = radd(d, sq(rsub(target[k], cb[k * kSnsCb + j])));
    if (j == 0 || d < best_d) {
      best = j;
      best_d = d;
    }
  }
  return best;
}

// pvq_subpyr_search (sns_quantize_scf.c:43-137): PULSES unit pulses over the
// first DIM lanes of x. ys: the signed pulses; en: ys scaled to unit energy.
// Where the target is silent the C writes y[0] and y[DIM], one past the
// active lanes, and so does this.
template <int DIM, int PULSES>
ACX_HD void pvq_search(const float (&x)[kSnsM], int (&ys)[kSnsM], float (&en)[kSnsM]) {
  float xa[kSnsM], y[kSnsM];
#pragma unroll
  for (int i = 0; i < kSnsM; ++i) xa[i] = i < DIM ? fabsf(x[i]) : 0.0f;
  float xsum = xa[0];
#pragma unroll
  for (int i = 1; i < kSnsM; ++i) xsum = radd(xsum, xa[i]);
  const float eps = 5.9604644775390625e-08f;  // 2^-24
  float yy;
  if (xsum <= eps) {
#pragma unroll
    for (int i = 0; i < kSnsM; ++i) y[i] = 0.0f;
    y[0] = static_cast<float>(PULSES / 2);
    if (DIM > 1) y[DIM < kSnsM ? DIM : kSnsM - 1] = -static_cast<float>(PULSES - PULSES / 2);
    yy = sq(y[0]);
#pragma unroll
    for (int i = 1; i < kSnsM; ++i) yy = radd(yy, sq(y[i]));
  } else {
    const bool project = xsum > eps;  // false only for a NaN
    const float proj_fac = rmul(rdiv(1.0f, xsum), static_cast<float>(PULSES - 1));
#pragma unroll
    for (int i = 0; i < kSnsM; ++i) {
      y[i] = (project && i < DIM) ? floorf(rmul(xa[i], proj_fac)) : 0.0f;
    }
    float pulse_tot = y[0], xy = rmul(xa[0], y[0]);
    yy = sq(y[0]);
#pragma unroll
    for (int i = 1; i < kSnsM; ++i) {
      pulse_tot = radd(pulse_tot, y[i]);
      yy = radd(yy, sq(y[i]));
      xy = radd(xy, rmul(xa[i], y[i]));
    }
    yy = rmul(yy, 0.5f);
    for (int p = 0; p < PULSES && pulse_tot < static_cast<float>(PULSES); ++p) {
      const float yy1 = radd(yy, 0.5f);
      // the lane that gains most: first maximum of (xy + xa)^2 / (yy1 + y),
      // compared by cross-multiplication with a strict >
      int best = 0;
      float bn = -32768.0f, bd = 0.0f, bxa = xa[0], by = y[0];
#pragma unroll
      for (int i = 0; i < DIM; ++i) {
        const float xy2 = sq(radd(xy, xa[i]));
        const float yyt = radd(yy1, y[i]);
        if (rmul(xy2, bd) > rmul(yyt, bn)) {
          best = i;
          bn = xy2;
          bd = yyt;
          bxa = xa[i];
          by = y[i];
        }
      }
      xy = radd(xy, bxa);
      yy = radd(yy1, by);
#pragma unroll
      for (int i = 0; i < DIM; ++i) {
        if (i == best) y[i] = radd(y[i], 1.0f);
      }
      pulse_tot = radd(pulse_tot, 1.0f);
    }
    yy = rmul(yy, 2.0f);
  }
  const float gain = rdiv(1.0f, rroot(yy));
#pragma unroll
  for (int i = 0; i < kSnsM; ++i) {
    ys[i] = static_cast<int>(rmul(y[i], x[i] >= 0.0f ? 1.0f : -1.0f));
    en[i] = rmul(static_cast<float>(ys[i]), gain);
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
  sns_dct<false>(v, t.f + kOffD2, w);
  const float g = t.f[kOffDecG + iclamp(sub, 0, 3) * 8 + iclamp(idx[3], 0, 7)];
  const int i0 = iclamp(idx[0], 0, kSnsCb - 1), i1 = iclamp(idx[1], 0, kSnsCb - 1);
#pragma unroll
  for (int i = 0; i < kSnsM; ++i) {
    const float st1 = i < 8 ? t.f[kOffC1 + i * kSnsCb + i0] : t.f[kOffC2 + (i - 8) * kSnsCb + i1];
    scf_q[i] = radd(rmul(g, w[i]), st1);
  }
}

// Squared error of tp against g * s, summed left to right.
ACX_HD float sns_gain_err(const float (&tp)[kSnsM], float g, const float (&s)[kSnsM]) {
  float e = sq(rsub(tp[0], rmul(g, s[0])));
#pragma unroll
  for (int i = 1; i < kSnsM; ++i) e = radd(e, sq(rsub(tp[i], rmul(g, s[i]))));
  return e;
}

// One outlier shape (PULSES over all 16 lanes, NG gains): keeps it where its
// best gain's error is below best_err.
template <int PULSES, int NG>
ACX_HD void sns_try_outlier(const float (&pt)[kSnsM], const float (&tp)[kSnsM],
                            const SnsTables& t, const float* gains, int submode,
                            float& best_err, int& idx2, int& idx3, int (&psel)[kSnsM],
                            float (&st2)[kSnsM]) {
  int y[kSnsM];
  float en[kSnsM], s[kSnsM];
  pvq_search<kSnsM, PULSES>(pt, y, en);
  sns_dct<false>(en, t.f + kOffD2, s);
  int ig = 0;
  float eg = 0.0f;
  for (int g = 0; g < NG; ++g) {
    const float e = sns_gain_err(tp, gains[g], s);
    if (g == 0 || e < eg) {
      ig = g;
      eg = e;
    }
  }
  if (eg < best_err) {
    const float gain = gains[ig];
    idx2 = submode;
    idx3 = ig;
    best_err = eg;
#pragma unroll
    for (int i = 0; i < kSnsM; ++i) {
      psel[i] = y[i];
      st2[i] = rmul(gain, s[i]);
    }
  }
}

// process_snsQuantizesScf_Enc: 16 scale factors -> the seven indices and the
// quantized scale factors.
ACX_HD void sns_vq_enc_lane(const float* scf_in, const SnsTables& t, int* idx, float* scf_q) {
  float scf[kSnsM], st1[kSnsM], tp[kSnsM], pt[kSnsM];
#pragma unroll
  for (int i = 0; i < kSnsM; ++i) scf[i] = scf_in[i];
  const int i0 = sns_vq_half(scf, t.f + kOffC1);
  const int i1 = sns_vq_half(scf + 8, t.f + kOffC2);
#pragma unroll
  for (int i = 0; i < kSnsM; ++i) {
    st1[i] = i < 8 ? t.f[kOffC1 + i * kSnsCb + i0] : t.f[kOffC2 + (i - 8) * kSnsCb + i1];
    tp[i] = rsub(scf[i], st1[i]);
  }
  sns_dct<true>(tp, t.f + kOffD2, pt);

  // the split shape (10 pulses in lanes 0-9, 1 in 10-15) and the low-band
  // shape (the first alone): 2 + 4 gain candidates
  int yA[kSnsM], yB[kSnsM], yC[kSnsM];
  float enA[kSnsM], enB[kSnsM], tail[kSnsM], cn[kSnsM];
  pvq_search<10, 10>(pt, yA, enA);
#pragma unroll
  for (int i = 0; i < kSnsM; ++i) tail[i] = i < 6 ? pt[10 + (i < 6 ? i : 0)] : 0.0f;
  pvq_search<6, 1>(tail, yB, enB);
#pragma unroll
  for (int i = 0; i < kSnsM; ++i) yC[i] = i < 10 ? yA[i] : yB[i < 10 ? 0 : i - 10];
  float enC = static_cast<float>(yC[0] * yC[0]);
#pragma unroll
  for (int i = 1; i < kSnsM; ++i) enC = radd(enC, static_cast<float>(yC[i] * yC[i]));
  const float gain_fac = rdiv(1.0f, rroot(enC));
#pragma unroll
  for (int i = 0; i < kSnsM; ++i) {
    cn[i] = rmul(static_cast<float>(yC[i]), gain_fac);
    if (i >= 10) enA[i] = 0.0f;
  }
  int idx_g = 0;
  float err_g = 0.0f;
  for (int c = 0; c < 6; ++c) {
    const float e = c < 2 ? sns_gain_err(pt, t.f[kOffRegG + c], cn)
                          : sns_gain_err(pt, t.f[kOffRegG + c], enA);
    if (c == 0 || e < err_g) {
      idx_g = c;
      err_g = e;
    }
  }
  const bool split = idx_g <= 1;
  const float cand_gain = t.f[kOffRegG + idx_g];
  const float glob_gain = t.f[kOffQG + idx_g];
  float chosen[kSnsM], st2[kSnsM];
  int psel[kSnsM];
#pragma unroll
  for (int i = 0; i < kSnsM; ++i) {
    chosen[i] = rdiv(rmul(split ? cn[i] : enA[i], cand_gain), glob_gain);
    psel[i] = split ? yC[i] : yA[i];
  }
  sns_dct<false>(chosen, t.f + kOffD2, st2);
#pragma unroll
  for (int i = 0; i < kSnsM; ++i) st2[i] = rmul(glob_gain, st2[i]);
  float best_err = sq(rsub(tp[0], st2[0]));
#pragma unroll
  for (int i = 1; i < kSnsM; ++i) best_err = radd(best_err, sq(rsub(tp[i], st2[i])));
  int idx2 = split ? 0 : 1;
  int idx3 = split ? idx_g : idx_g - 2;

  sns_try_outlier<8, 4>(pt, tp, t, t.f + kOffNearG, 2, best_err, idx2, idx3, psel, st2);
  sns_try_outlier<6, 8>(pt, tp, t, t.f + kOffFarG, 3, best_err, idx2, idx3, psel, st2);

  int ls, mpvq, idx6;
  if (idx2 < 2) {
    mpvq_enc<10, 0>(psel, t.A, &ls, &mpvq);
    idx6 = -2;
    if (idx2 == 0) {
      int ls_tail, mpvq_tail;
      mpvq_enc<6, 10>(psel, t.A, &ls_tail, &mpvq_tail);
      idx6 = mpvq_tail * 2 + ls_tail;
    }
  } else {
    mpvq_enc<16, 0>(psel, t.A, &ls, &mpvq);
    idx6 = idx2 == 2 ? -1 : -2;
  }
  idx[0] = i0;
  idx[1] = i1;
  idx[2] = idx2;
  idx[3] = idx3;
  idx[4] = ls;
  idx[5] = mpvq;
  idx[6] = idx6;
#pragma unroll
  for (int i = 0; i < kSnsM; ++i) scf_q[i] = radd(st1[i], st2[i]);
}

}  // namespace acx
