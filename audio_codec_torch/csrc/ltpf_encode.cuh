// The LTPF parameter coder of one stream (ltpf_coder.c:34-263, as
// audio_codec_tpu/ops/analysis.py:ltpf_encode computes it): the normalised
// correlation at the 17 lags of the window around the open-loop pitch, the
// integer search, the 17x36 interpolation at the fractional candidates, the
// fractional search, the pitch index, the normalised correlation of the
// 4-tap interpolated signals, and the activation rules.
//
// ltpf_encode_warp runs them on the lanes of a warp, a template over the
// warp (warp.cuh): CoderCardWarp in ltpf_encode.cu, the host warp in the CPU
// rehearsals, where g++ compiles the same steps. Each chain runs on a lane of
// its own, unrolled over a compile-time correlation length (ACF, 128 or 64),
// so the shared loads of later steps issue before the adds of earlier ones:
//   - lanes 0-16 the correlation and energy chains of window entry 0-16,
//     lane 17 the block's energy chain (the same loop with the block as its
//     own lag), shuffled to the window lanes, so no lane computes it twice;
//   - the integer search and the fractional search as first-maximum shuffle
//     trees (the lowest index wins ties), the <= 7 candidates' interpolation
//     chains on lanes 0-6 at once, the window entries by shuffle;
//   - the filtered samples and their three products lane-parallel, then the
//     three normcorr sums on lanes 0-2.
//
// Every float result must equal the plain version's (ops/analysis.py:
// ltpf_encode_plain) on the card bit for bit, so every product and sum is
// rounded on its own (rmul, radd, rsub, rdiv, rroot) in the order it states:
// each lag's correlation and energy and each of the three normcorr sums is a
// chain from the first product over the samples, ascending; the
// interpolation a chain over the 17 window entries, zero taps included.
#pragma once

#include "olpa.cuh"
#include "warp.cuh"

namespace acx {

constexpr int kLtpfMinPitch = 32;   // MIN_PITCH_12K8
constexpr int kLtpfMaxPitch = 228;  // MAX_PITCH_12K8
constexpr int kLtpfRes2 = 157;      // RES2_PITCH_12K8
constexpr int kLtpfRes4 = 127;      // RES4_PITCH_12K8
constexpr int kLtpfLag0 = kLtpfMinPitch - 4;
constexpr int kLtpfLags = kLtpfMaxPitch + 4 - kLtpfLag0 + 1;   // 205
constexpr int kLtpfWin = 17;
constexpr int kLtpfEnergyLane = kLtpfWin;   // the lane of the block's energy chain
constexpr int kLtpfCands = 7;       // fractional candidates at most
constexpr int kLtpfInterTaps = 32;  // inter4_1 taps the interpolation reads
constexpr int kLtpfInterOut = 36;
constexpr int kLtpfTableWords = kLtpfInterTaps + 16;   // inter4_1[:32] ++ enc_inter_filter
constexpr int kLtpfMaxRow = 368;    // memory + frame, at most 264 + 33 (2.5 ms) or 232 + 129
constexpr int kLtpfMaxAcf = 128;
constexpr int kLtpfStageQuads = 3;  // ceil(264 / 4 / 32): the memory in 16-byte loads
constexpr int kLtpfStageWords = 12; // ceil(368 / 32): the rest a word each

// The configuration's geometry (ops/analysis.py:ltpf_encode_plain).
struct LtpfGeom {
  int xlen;       // 12.8 kHz samples of the input row
  int N;          // samples a frame advances
  int mem_len;    // input memory
  int acflen;     // correlation length
  int xbase;      // first sample of the current block in the row (a multiple of 4)
  int frame_dms;  // 25, 50 or 100
  int enable;     // LTPF may switch on
};

ACX_HD int ltpf_row_len(const LtpfGeom& g) { return g.mem_len + g.xlen; }

// The first lag index of the window (clamped lag - 28 of its first entry).
ACX_HD int ltpf_t0_min(int pitch_ol) { return imax(pitch_ol - 4, kLtpfMinPitch); }

// Four floats at a 16-byte aligned address: one vector load on the card.
struct LtpfQuad {
  float v[4];
};

ACX_HD LtpfQuad ltpf_quad(const float* p) {
#ifdef __CUDA_ARCH__
  const float4 q = *reinterpret_cast<const float4*>(p);
  return {{q.x, q.y, q.z, q.w}};
#else
  return {{p[0], p[1], p[2], p[3]}};
#endif
}

ACX_HD void ltpf_put_quad(float* p, const LtpfQuad& q) {
#ifdef __CUDA_ARCH__
  *reinterpret_cast<float4*>(p) = make_float4(q.v[0], q.v[1], q.v[2], q.v[3]);
#else
  for (int k = 0; k < 4; ++k) p[k] = q.v[k];
#endif
}

// The correlation chain of the block x with lag and the energy chain of lag,
// over ACF samples, each from the first product, ascending (x 16-byte
// aligned). With x as its own lag, the energy chain is the block's.
template <int ACF>
ACX_HD void ltpf_window_chains(const float* x, const float* lag, float* c_out, float* en_out) {
  float c = 0.0f, en = 0.0f;
#pragma unroll
  for (int n0 = 0; n0 < ACF; n0 += 4) {
    const LtpfQuad xq = ltpf_quad(x + n0);
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const float l = lag[n0 + k];
      const float p = rmul(xq.v[k], l);
      const float q = rmul(l, l);
      c = n0 + k == 0 ? p : radd(c, p);
      en = n0 + k == 0 ? q : radd(en, q);
    }
  }
  *c_out = c;
  *en_out = en;
}

// The chain over ACF values from the first, ascending (a 16-byte aligned).
template <int ACF>
ACX_HD float ltpf_sum_chain(const float* a) {
  float acc = 0.0f;
#pragma unroll
  for (int n0 = 0; n0 < ACF; n0 += 4) {
    const LtpfQuad q = ltpf_quad(a + n0);
#pragma unroll
    for (int k = 0; k < 4; ++k) acc = n0 + k == 0 ? q.v[k] : radd(acc, q.v[k]);
  }
  return acc;
}

// Tap k of the interpolation: inter4_1[k], zero outside 0..31.
ACX_HD float ltpf_tap(const float* inter, int k) {
  const bool in_taps = k >= 0 && k < kLtpfInterTaps;
  return in_taps ? inter[iclamp(k, 0, kLtpfInterTaps - 1)] : 0.0f;
}

// The first maximum over the lanes of (v, i): the largest v, the lowest i on
// ties (first_max_beats), on every lane. Lanes out of the search hold
// (-inf, kNoIndex).
template <class W>
ACX_HD void ltpf_first_max(const W& w, typename W::template Lanes<float>& v,
                           typename W::template Lanes<int>& i) {
  for (int m = kCoderLanes / 2; m >= 1; m >>= 1) {
    const auto pv = w.shfl_xor(v, m);
    const auto pi = w.shfl_xor(i, m);
    w.lanes([&](int l) {
      if (first_max_beats(pv[l], pi[l], v[l], i[l])) {
        v[l] = pv[l];
        i[l] = pi[l];
      }
    });
  }
}

struct LtpfPitch {
  int pitch_int, pitch_fr, index;
};

// The pitch and its index from the integer pick t1 (a lag) and the
// fractional pick best (a candidate) of a search with the given step.
ACX_HD LtpfPitch ltpf_pitch(int t1, int best, int step, int delta_down) {
  const int fr0 = iclamp(best, 0, kLtpfCands - 1) * step - delta_down;
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

// One stream's inputs.
struct LtpfStream {
  const float* s12k8;   // [xlen]
  const float* mem_in;  // [mem_len]
  int pitch_ol;
  float nc_ol, mem_nc, mem_mem_nc;
  int mem_on;
  float mem_pitch;
};

// A warp's shared memory: the row (memory ++ frame) and the normcorr's
// three products (cf pf, cf cf, pf pf) a filtered sample.
struct LtpfScratch {
  alignas(16) float row[kLtpfMaxRow];
  alignas(16) float prod[3][kLtpfMaxAcf];
};

// The memory and the frame into S.row: the memory in 16-byte loads where it
// is aligned, the rest a word each, every load of a lane issued before its
// stores.
template <class W>
ACX_HD void ltpf_stage_row(const W& w, const LtpfStream& s, const LtpfGeom& g, float* row) {
  const bool aligned = g.mem_len % 4 == 0 && (reinterpret_cast<uintptr_t>(s.mem_in) & 15u) == 0;
  const int quads = aligned ? g.mem_len / 4 : 0;
  const int first = 4 * quads, len = ltpf_row_len(g);
  w.lanes([&](int l) {
    LtpfQuad q[kLtpfStageQuads];
    float v[kLtpfStageWords];
#pragma unroll
    for (int u = 0; u < kLtpfStageQuads; ++u) {
      const int k = l + kCoderLanes * u;
      if (k < quads) q[u] = ltpf_quad(s.mem_in + 4 * k);
    }
#pragma unroll
    for (int u = 0; u < kLtpfStageWords; ++u) {
      const int i = first + l + kCoderLanes * u;
      if (i < len) v[u] = i < g.mem_len ? s.mem_in[i] : s.s12k8[i - g.mem_len];
    }
#pragma unroll
    for (int u = 0; u < kLtpfStageQuads; ++u) {
      const int k = l + kCoderLanes * u;
      if (k < quads) ltpf_put_quad(row + 4 * k, q[u]);
    }
#pragma unroll
    for (int u = 0; u < kLtpfStageWords; ++u) {
      const int i = first + l + kCoderLanes * u;
      if (i < len) row[i] = v[u];
    }
  });
}

// The whole coder for one stream on a warp, ACF = g.acflen. tab:
// inter4_1[:32] ++ enc_inter_filter [4][4]. Writes new_mem_in [mem_len] and
// returns the scalar outputs (the same on every lane).
template <int ACF, class W>
ACX_HD LtpfOut ltpf_encode_warp(const W& w, const LtpfStream& s, const float* tab,
                                const LtpfGeom& g, LtpfScratch& S, float* new_mem_in) {
  using FL = typename W::template Lanes<float>;
  using IL = typename W::template Lanes<int>;
  float* row = S.row;
  const float* x = row + g.xbase;
  ltpf_stage_row(w, s, g, row);
  w.sync();
  w.lanes([&](int l) {
    for (int i = l; i < g.mem_len; i += kCoderLanes) new_mem_in[i] = row[g.N + i];
  });

  // the window's chains on lanes 0-16, the block's energy on lane 17
  const int t0_min = ltpf_t0_min(s.pitch_ol);
  FL c, en, cor;
  w.lanes([&](int l) {
    const int li = iclamp(t0_min - 4 - kLtpfLag0 + l, 0, kLtpfLags - 1);
    const float* lag = l < kLtpfWin ? row + imax(g.xbase - kLtpfLag0 - li, 0) : x;
    ltpf_window_chains<ACF>(x, lag, &c[l], &en[l]);
  });
  const float e_cur = w.shfl(en, kLtpfEnergyLane);
  w.lanes([&](int l) {
    const float nc = rdiv(c[l], radd(rroot(rmul(e_cur, en[l])), 1e-5f));
    cor[l] = nc < 0.0f ? 0.0f : nc;
  });

  // the integer search over window entries 4-12
  const int t0_max = imin(s.pitch_ol + 4, kLtpfMaxPitch);
  const int n_int = t0_max - t0_min + 1;
  FL v;
  IL idx;
  w.lanes([&](int l) {
    const int i = l - 4;
    const bool in = i >= 0 && i < 9;
    v[l] = in && i < n_int ? cor[l] : -INFINITY;
    idx[l] = in ? i : kNoIndex;
  });
  ltpf_first_max(w, v, idx);
  const int t1 = iclamp(w.shfl(idx, 0), 0, 8) + t0_min;

  // the fractional candidates on lanes 0-6, each its interpolation chain
  const int step = t1 >= kLtpfRes4 ? 2 : 1;
  const int midpoint = 4 * (t1 - t0_min) + 1;
  const int delta = 4 - step;
  const int delta_down = t1 == t0_min ? 0 : delta;
  const int count = (delta + delta_down) / step + 1;
  IL at;
  FL acc;
  w.lanes([&](int l) {
    at[l] = iclamp(midpoint - delta_down - 1 + l * step, 0, kLtpfInterOut - 1);
  });
  for (int m = 0; m < kLtpfWin; ++m) {
    const float cm = w.shfl(cor, m);
    w.lanes([&](int l) {
      const float p = rmul(cm, ltpf_tap(tab, 4 * m - at[l]));
      acc[l] = m == 0 ? p : radd(acc[l], p);
    });
  }
  w.lanes([&](int l) {
    v[l] = l < kLtpfCands && l < count ? acc[l] : -INFINITY;
    idx[l] = l < kLtpfCands ? l : kNoIndex;
  });
  ltpf_first_max(w, v, idx);
  const LtpfPitch p = ltpf_pitch(t1, w.shfl(idx, 0), step, delta_down);

  // the normcorr: the filtered samples' products lane-parallel, the three
  // sums on lanes 0-2
  const float* ef = tab + kLtpfInterTaps;
  w.lanes([&](int l) {
    for (int j = l; j < ACF; j += kCoderLanes) {
      float cf, pf;
      ltpf_filtered(row, g, ef, p, j, &cf, &pf);
      S.prod[0][j] = rmul(cf, pf);
      S.prod[1][j] = rmul(cf, cf);
      S.prod[2][j] = rmul(pf, pf);
    }
  });
  w.sync();
  FL sum;
  w.lanes([&](int l) { sum[l] = l < 3 ? ltpf_sum_chain<ACF>(S.prod[imin(l, 2)]) : 0.0f; });
  return ltpf_decide(w.shfl(sum, 0), w.shfl(sum, 1), w.shfl(sum, 2), p, s.nc_ol, s.mem_nc,
                     s.mem_mem_nc, s.mem_on, s.mem_pitch, g);
}

}  // namespace acx
