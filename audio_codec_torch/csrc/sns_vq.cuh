// The SNS vector quantizer's tables and its decoder, one stream per call:
// MPVQ indexing and de-indexing and the decoder's 16-point DCT-II
// (sns_quantize_scf.c). sns_vq_dec.cu runs sns_vq_dec_warp a warp a stream;
// it is a template over the warp (warp.cuh), so g++ compiles it for the CPU
// rehearsals (tests/test_torch_dec_rehearsal.py,
// tests/test_torch_lane_rehearsal.py). The encoder's warp (sns_vq_enc.cuh)
// indexes its shape with mpvq_enc.
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
#include "warp.cuh"

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

// The A columns lane j reads: A[r][j] for the 16 rows (lanes from 11 on read
// column 10, which no compare of theirs uses).
struct MpvqColumn {
  int32_t a[kSnsM];
};

// MPVQ de-indexing (pvq_dec, sns_quantize_scf.c:520-560) on a warp: K pulses
// over the LEN positions OFF .. OFF+LEN, from the leading sign and the index,
// into p (position i on lane i). One uniform chain: at each position lanes
// j <= K compare the index with A[LEN - pos - 1][j], a ballot and its
// popcount give the count of offsets at or below it, and the chosen offset
// comes from its lane by a shuffle; the integers are the lane function's.
template <int K, int LEN, int OFF, class W>
ACX_HD void mpvq_dec_warp(const W& w, int ls_ind, int mpvq,
                          const typename W::template Lanes<MpvqColumn>& col,
                          typename W::template Lanes<int>& p) {
  using IL = typename W::template Lanes<int>;
  int leading_sign = 1 - 2 * ls_ind;
  int kk = K;
  bool done = false;
#pragma unroll
  for (int pos = 0; pos < LEN; ++pos) {
    IL a, ge;
    w.lanes([&](int ln) {
      a[ln] = col[ln].a[LEN - pos - 1];
      ge[ln] = ln <= K && mpvq >= a[ln] ? 1 : 0;
    });
    const int cnt = popc32(w.ballot(ge));
    const int idx = imin(imax(cnt - 1, 0), kk);
    int put = 0;
    bool set = false;
    if (mpvq == 0 && !done) {
      put = leading_sign * kk;
      set = done = true;
    } else if (!done) {
      int next = mpvq - w.shfl(a, iclamp(idx, 0, K));
      const int k_delta = kk - idx;
      if (k_delta != 0) {
        put = leading_sign * k_delta;
        set = true;
        leading_sign = (next & 1) != 0 ? -1 : 1;
        next >>= 1;  // floor division by 2
        kk -= k_delta;
      }
      mpvq = next;
    }
    if (set) w.lanes([&](int ln) { p[ln] = ln == OFF + pos ? put : p[ln]; });
  }
}

// process_snsQuantizesScf_Dec on a warp, one stream: its seven indices idx ->
// its 16 quantized scale factors scf_q, lane n output n (lanes from 16 on
// compute output n - 16 again and store nothing). words: the tables
// (kernels.py:_sns_tables).
//  1. the pulses of the submode's shape (mpvq_dec_warp), position i on lane i;
//  2. their energy: the plain version's float chain of the squares, left to
//     right. The squares are integers and their sum is at most 121 (a shape
//     has at most 10 + 1 pulses), so every partial sum is exact and the
//     integer sum converted once is the same float;
//  3. lane k divides its pulse by the root of the energy (IEEE);
//  4. the DCT-II in the decoder's order (numerics.xla_dot, the reference's):
//     lane n runs output n's four fused multiply-add chains from zero, term k
//     (v[k] shuffled from lane k) in chain k % 4, combined (c0 + c1) +
//     (c2 + c3);
//  5. the submode's gain over it and the stage-1 vector, one xfma a lane.
template <class W>
ACX_HD void sns_vq_dec_warp(const W& w, const int32_t* idx_in, const int32_t* words,
                            float* scf_q) {
  using IL = typename W::template Lanes<int>;
  using FL = typename W::template Lanes<float>;
  struct Lane {
    float d2[kSnsM];   // D2[k][n], n = lane % 16
    float c[4];        // the DCT-II's chains
  };
  const SnsTables t = sns_tables(words);
  typename W::template Lanes<MpvqColumn> col;
  typename W::template Lanes<Lane> ln_;
  int idx[7];
#pragma unroll
  for (int k = 0; k < 7; ++k) idx[k] = idx_in[k];
  w.lanes([&](int ln) {
#pragma unroll
    for (int r = 0; r < kSnsM; ++r) col[ln].a[r] = t.A[r * kMpvqCols + imin(ln, kMpvqCols - 1)];
#pragma unroll
    for (int k = 0; k < kSnsM; ++k) ln_[ln].d2[k] = t.f[kOffD2 + k * kSnsM + ln % kSnsM];
  });
  IL p;
  w.lanes([&](int ln) { p[ln] = 0; });
  const int sub = idx[2];
  if (sub < 2) {
    mpvq_dec_warp<10, 10, 0>(w, idx[4], idx[5], col, p);
    if (sub == 0) mpvq_dec_warp<1, 6, 10>(w, idx[6] & 1, idx[6] >> 1, col, p);
  } else if (sub == 2) {
    mpvq_dec_warp<8, 16, 0>(w, idx[4], idx[5], col, p);
  } else {
    mpvq_dec_warp<6, 16, 0>(w, idx[4], idx[5], col, p);
  }
  typename W::template Lanes<unsigned> sq;
  w.lanes([&](int ln) { sq[ln] = static_cast<unsigned>(p[ln] * p[ln]); });
  const float norm = rroot(static_cast<float>(w.reduce_add(sq)));
  FL v;
  w.lanes([&](int ln) {
    v[ln] = rdiv(static_cast<float>(p[ln]), norm);
#pragma unroll
    for (int j = 0; j < 4; ++j) ln_[ln].c[j] = 0.0f;
  });
#pragma unroll
  for (int k = 0; k < kSnsM; ++k) {
    const float vk = w.shfl(v, k);
    w.lanes([&](int ln) { ln_[ln].c[k % 4] = xfma(vk, ln_[ln].d2[k], ln_[ln].c[k % 4]); });
  }
  const float g = t.f[kOffDecG + iclamp(sub, 0, 3) * 8 + iclamp(idx[3], 0, 7)];
  const int i0 = iclamp(idx[0], 0, kSnsCb - 1), i1 = iclamp(idx[1], 0, kSnsCb - 1);
  w.lanes([&](int ln) {
    const int n = ln % kSnsM;
    const float st1 = n < 8 ? t.f[kOffC1 + n * kSnsCb + i0] : t.f[kOffC2 + (n - 8) * kSnsCb + i1];
    const float* c = ln_[ln].c;
    const float wn = radd(radd(c[0], c[1]), radd(c[2], c[3]));
    if (ln < kSnsM) scf_q[n] = xfma(g, wn, st1);
  });
}

}  // namespace acx
