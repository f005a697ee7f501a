// The encoder's noise factor and residual coder of one stream on a warp
// (processNoiseFactor_fl and processResidualCoding_fl, as
// audio_codec_tpu/ops/quant.py:noise_factor and residual_encode compute them,
// with the encoder's n_res = 0 in lsbMode). noise_residual_enc.cu runs
// noise_residual_enc_warp a warp a stream; it is a template over the warp
// (warp.cuh), so g++ compiles it for the CPU rehearsals
// (tests/test_torch_sns_nf_rehearsal.py, tests/test_torch_lane_rehearsal.py).
//
// Lane l holds the lines 32 c + l of the row, x and xq in registers, loaded
// once. The nonzero lines are 32-bit ballots, one a chunk c of 32 lines; a
// line's zero-line window is a few bits of two 64-bit words of them
// (nf_window_clear), so the test reads no memory.
//
// The noise factor's float sums must equal the plain version's
// (ops/quant.py:noise_residual_enc_plain) on the card bit for bit: each is a
// chain from +0 of |x / gain| over the zero lines in line order, rounded op
// by op (rdiv, radd), divided by the count; the plain version's chain runs
// over every line, with +0 off the zero lines. Its sum starts at +0 and adds
// only values >= +0 (a NaN stays a NaN), so it is never -0, and adding +0 to
// it gives it back exactly: the chain over the zero lines alone, in order, is
// the same chain. So the zero lines' values are stored compacted in line
// order, and the chains run over them alone; at <= 20 bytes the three chains
// (all zero lines, those below the middle line, the rest) run on lanes 0, 1
// and 2 at once. The residual bits compare x with the rounded product
// xq * gain.
#pragma once

#include "acodec.cuh"
#include "warp.cuh"

namespace acx {

constexpr int kNfMaxLines = 416;   // 13 x 32 >= the 400 lines of a 10 ms frame
constexpr int kNfScratch = kNfMaxLines + 16;   // floats a warp: the chains read 16 ahead

// The configuration's geometry (ops/quant.py:noise_factor, residual_encode).
struct NfEncGeom {
  int N;            // spectral lines
  int width;        // zero-line window half width: 3 at 10 ms, else 1
  int start;        // first line tested: 24, 12 or 6
  int half_means;   // 10 ms at <= 20 bytes: the smaller of two half means
  int max_res;      // residual bits a stream
};

// The bits below m of a 32-bit word (m may be <= 0 or >= 32).
ACX_HD uint32_t nf_bits_below(int m) {
  return m <= 0 ? 0u : (m >= 32 ? 0xFFFFFFFFu : (1u << m) - 1u);
}

// Whether no line of [t - width, t + width] is set, t = 32 c + l, in the
// masks prev, cur, next of chunks c - 1, c, c + 1 (width <= 31).
ACX_HD bool nf_window_clear(uint32_t prev, uint32_t cur, uint32_t next, int l, int width) {
  const uint64_t below = (static_cast<uint64_t>(cur) << 32) | prev;   // lines 32 c - 32 ..
  const uint64_t above = (static_cast<uint64_t>(next) << 32) | cur;   // lines 32 c ..
  const uint64_t lines = (uint64_t{2} << width) - 1u;                 // width + 1 lines
  return (((below >> (l + 32 - width)) | (above >> l)) & lines) == 0u;
}

// The chain from +0 over v[lo, hi) in order. The reads are 16-byte loads
// from the aligned index at or below lo, issued a round of 8 ahead of the
// adds; terms of the first and last rounds outside [lo, hi) are taken as +0
// and added, which gives the sum back (see above). v must be 16-byte aligned
// and readable to hi + 16.
ACX_HD void nf_load8(const float* v, int j, float (&a)[8]) {
#pragma unroll
  for (int h = 0; h < 2; ++h) {
#ifdef __CUDA_ARCH__
    const float4 q = *reinterpret_cast<const float4*>(v + j + 4 * h);
    a[4 * h] = q.x;
    a[4 * h + 1] = q.y;
    a[4 * h + 2] = q.z;
    a[4 * h + 3] = q.w;
#else
    for (int u = 0; u < 4; ++u) a[4 * h + u] = v[j + 4 * h + u];
#endif
  }
}

ACX_HD float nf_chain(const float* v, int lo, int hi) {
  float acc = 0.0f;
  int j = lo & ~3;
  float a[8];
  if (j < hi) nf_load8(v, j, a);
  for (; j < hi; j += 8) {
    float next[8];
    nf_load8(v, j + 8, next);
    if (j < lo || j + 8 > hi) {
#pragma unroll
      for (int u = 0; u < 8; ++u) a[u] = (j + u >= lo && j + u < hi) ? a[u] : 0.0f;
    }
#pragma unroll
    for (int u = 0; u < 8; ++u) acc = radd(acc, a[u]);
#pragma unroll
    for (int u = 0; u < 8; ++u) a[u] = next[u];
  }
  return acc;
}

// The noise factor's index from the chains' sums: the mean over the kcnt
// zero lines, or at <= 20 bytes the smaller of the means below the middle
// line (nlo of them) and from it, as C round() of 8 - 16 fac, clamped to 0..7.
ACX_HD int nf_enc_index(float sum_all, float sum_lo, float sum_hi, int kcnt, int nlo,
                        const NfEncGeom& g) {
  float fac = kcnt > 0 ? rdiv(sum_all, static_cast<float>(kcnt)) : 0.0f;
  if (g.half_means && kcnt > 0) {
    const float f1 = rdiv(sum_lo, static_cast<float>(imax(nlo, 1)));
    const float f2 = rdiv(sum_hi, static_cast<float>(imax(kcnt - nlo, 1)));
    fac = f2 < f1 ? f2 : f1;
  }
  const float t = rsub(8.0f, rmul(16.0f, fac));
  const float sign = t > 0.0f ? 1.0f : (t < 0.0f ? -1.0f : 0.0f);
  const float r = rmul(sign, floorf(radd(fabsf(t), 0.5f)));
  return static_cast<int>(r < 0.0f ? 0.0f : (r > 7.0f ? 7.0f : r));
}

// The residual bits the frame sends: min(nonzero lines, bits left), 0 in lsbMode.
ACX_HD int nf_enc_n_res(int n_nz, int target, int nbits2, int lsb_mode) {
  const int n = imin(n_nz, imax(target - nbits2 + 4, 0));
  return lsb_mode == 0 ? n : 0;
}

// One stream on a warp, NC = ceil(N / 32) chunks: x, xq its rows [N], res
// its residual bits [max_res]; vz the warp's kNfScratch floats (16-byte
// aligned). fac_ns_idx and n_res are written by lane 0.
template <int NC, class W>
ACX_HD void noise_residual_enc_warp(const W& w, const float* x, const int32_t* xq, float gain,
                                    int bw_bin, int target, int nbits2, int lsb_mode,
                                    const NfEncGeom& g, float* vz, int32_t* fac_ns_idx,
                                    int32_t* res, int32_t* n_res) {
  using IL = typename W::template Lanes<int>;
  struct Row {
    float x[NC];
    int32_t q[NC];
  };
  typename W::template Lanes<Row> row;
  typename W::template Lanes<unsigned> lines;
  typename W::template Lanes<float> sums;
  const int N = g.N, bw = iclamp(bw_bin, 0, N);
  w.lanes([&](int ln) {
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      const int k = 32 * c + ln;
      row[ln].x[c] = k < N ? x[k] : 0.0f;
      row[ln].q[c] = k < N ? xq[k] : 0;
    }
    lines[ln] = 0u;
  });
  // the nonzero lines: all of them (the residual's ranks), those below the
  // bandwidth (the zero-line windows)
  uint32_t nz[NC], nzb[NC];
#pragma unroll
  for (int c = 0; c < NC; ++c) {
    IL p;
    w.lanes([&](int ln) { p[ln] = row[ln].q[c] != 0 ? 1 : 0; });
    nz[c] = w.ballot(p);
    nzb[c] = nz[c] & nf_bits_below(bw - 32 * c);
  }
  // the zero lines: no nonzero line below the bandwidth within width lines
  uint32_t zm[NC];
#pragma unroll
  for (int c = 0; c < NC; ++c) {
    IL z;
    const uint32_t prev = c > 0 ? nzb[c > 0 ? c - 1 : 0] : 0u;
    const uint32_t next = c + 1 < NC ? nzb[c + 1 < NC ? c + 1 : c] : 0u;
    w.lanes([&](int ln) {
      const int k = 32 * c + ln;
      z[ln] = (k >= g.start && k < bw && nf_window_clear(prev, nzb[c], next, ln, g.width)) ? 1 : 0;
    });
    zm[c] = w.ballot(z);
  }
  // the zero lines' values compacted in line order and the sum of their line
  // numbers (from 1); the residual bit of a nonzero line at its rank among
  // the nonzero lines. Every lane computes its values and selects its stores,
  // so that no chunk waits on a branch.
  int kcnt = 0, n_nz = 0;
#pragma unroll
  for (int c = 0; c < NC; ++c) {
    w.lanes([&](int ln) {
      const uint32_t before = (1u << ln) - 1u;
      const bool zero_line = ((zm[c] >> ln) & 1u) != 0u;
      const float v = fabsf(rdiv(row[ln].x[c], gain));
      if (zero_line) vz[kcnt + popc32(zm[c] & before)] = v;
      lines[ln] += zero_line ? static_cast<unsigned>(32 * c + ln + 1) : 0u;
      const int32_t q = row[ln].q[c];
      const int rank = n_nz + popc32(nz[c] & before);
      const int32_t bit = row[ln].x[c] >= rmul(static_cast<float>(q), gain) ? 1 : 0;
      if (q != 0 && rank < g.max_res) res[rank] = bit;
    });
    kcnt += popc32(zm[c]);
    n_nz += popc32(nz[c]);
  }
  w.lanes([&](int ln) {
    for (int i = imin(n_nz, g.max_res) + ln; i < g.max_res; i += 32) res[i] = 0;
  });
  const int total = static_cast<int>(w.reduce_add(lines));
  const int mid = kcnt > 0 ? total / kcnt : 0;
  int nlo = 0;   // zero lines below mid
#pragma unroll
  for (int c = 0; c < NC; ++c) nlo += popc32(zm[c] & nf_bits_below(mid - 32 * c));
  w.sync();   // the values in vz
  // the chains: lane 0 over every zero line; at <= 20 bytes lanes 1 and 2
  // over those below mid and from it
  const int n_all = kcnt, n_lo = nlo;
  w.lanes([&](int ln) {
    const bool half = g.half_means != 0;
    const int lo = (half && ln == 2) ? n_lo : 0;
    const int hi = ln == 0 ? n_all : (half && ln == 1 ? n_lo : (half && ln == 2 ? n_all : 0));
    sums[ln] = nf_chain(vz, lo, hi);
  });
  const float s_all = w.shfl(sums, 0), s_lo = w.shfl(sums, 1), s_hi = w.shfl(sums, 2);
  w.leader([&] {
    *fac_ns_idx = nf_enc_index(s_all, s_lo, s_hi, kcnt, nlo, g);
    *n_res = nf_enc_n_res(n_nz, target, nbits2, lsb_mode);
  });
}

}  // namespace acx
