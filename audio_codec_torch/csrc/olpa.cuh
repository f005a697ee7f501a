// The open-loop pitch search of one stream (olpa.c:52-180, as
// audio_codec_tpu/ops/analysis.py:olpa computes it): the 5-tap low-pass and
// decimation to 6.4 kHz, the correlation R and energy E at the 98 lags
// 17..114, the weighted first maximum, the search within +-4 of the previous
// pitch, and the choice between the two.
//
// olpa_warp runs them on the lanes of a warp, a template over the warp
// (warp.cuh): CoderCardWarp in olpa.cu, the host warp in the CPU rehearsal
// (tests/test_torch_olpa_ola_rehearsal.py), where g++ compiles the same
// steps. Lane l holds the lags l, l + 32 and l + 64, and l + 96 on lanes 0-1;
// the other lanes take the block's energy e0 in that fourth slot. All eight
// chains of a lane run in one loop over the samples, unrolled at a
// compile-time correlation length (ACF, 64 at 10 ms, 32 at 5 and 2.5 ms),
// with the block in registers: the first three lags read one window of the
// row, and each value of it is squared once.
//
// Every float result must equal the plain version's (ops/analysis.py:
// olpa_plain) on the card bit for bit, so every product and sum is rounded on
// its own (rmul, radd, rdiv, rroot) in the order it states: each low-pass
// output is a chain from zero over the taps; R, E and e0 of a lag are chains
// from the first product over the samples, ascending. rmul(x, x) gives the
// same bits wherever it runs, so a square made once serves every E.
#pragma once

#include "acodec.cuh"
#include "warp.cuh"

namespace acx {

constexpr int kOlpaMinPitch = 17;   // MIN_PITCH_6K4
constexpr int kOlpaMaxPitch = 114;  // MAX_PITCH_6K4
constexpr int kOlpaLags = 98;       // RANGE_PITCH_6K4
constexpr int kOlpaTaps = 5;
constexpr int kOlpaMaxRow = 208;    // 6.4 kHz memory + decimated frame, at most 130 + 64
constexpr int kNoIndex = 1 << 30;
constexpr int kOlpaMaxFrame = 3 + 128;  // mem_s12k8 ++ the 12.8 kHz frame, at most
constexpr int kOlpaSlots = 4;           // lags a lane: l, l + 32, l + 64, l + 96 (or e0)
constexpr int kOlpaStageMem = 5;        // ceil(130 / 32): 6.4 kHz memory words a lane
constexpr int kOlpaStageFrame = 5;      // ceil(131 / 32): frame words a lane

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

// One stream's inputs.
struct OlpaStream {
  const float* s12k8;   // [>= length]
  const float* mem12;   // [3]
  const float* mem64;   // [mem_in_len]
  int mem_pitch;
};

// A warp's shared memory: the 6.4 kHz row, placed so that its block (row +
// base) is 16-byte aligned, and the staged 12.8 kHz frame.
struct OlpaScratch {
  alignas(16) float row[kOlpaMaxRow + 4];
  float frame[kOlpaMaxFrame + 1];
};

ACX_HD float* olpa_row(OlpaScratch& S, const OlpaGeom& g) { return S.row + ((-g.base) & 3); }

// Four floats at a 16-byte aligned address: one vector load on the card.
ACX_HD void olpa_quad(const float* p, float* out) {
#ifdef __CUDA_ARCH__
  const float4 q = *reinterpret_cast<const float4*>(p);
  out[0] = q.x;
  out[1] = q.y;
  out[2] = q.z;
  out[3] = q.w;
#else
  for (int k = 0; k < 4; ++k) out[k] = p[k];
#endif
}

// The memory and the frame into shared memory, every load of a lane issued
// before its stores; the decimation from the staged frame; the two new
// memories.
template <class W>
ACX_HD void olpa_stage(const W& w, const OlpaStream& s, const float* tab, const OlpaGeom& g,
                       OlpaScratch& S, float* new_mem12, float* new_mem64) {
  float* row = olpa_row(S, g);
  float* frame = S.frame;
  const int nf = g.length + 3;
  w.lanes([&](int l) {
    float m[kOlpaStageMem], f[kOlpaStageFrame];
#pragma unroll
    for (int u = 0; u < kOlpaStageMem; ++u) {
      const int i = l + kCoderLanes * u;
      if (i < g.mem_in_len) m[u] = s.mem64[i];
    }
#pragma unroll
    for (int u = 0; u < kOlpaStageFrame; ++u) {
      const int i = l + kCoderLanes * u;
      if (i < nf) f[u] = olpa_in(s.mem12, s.s12k8, i);
    }
#pragma unroll
    for (int u = 0; u < kOlpaStageMem; ++u) {
      const int i = l + kCoderLanes * u;
      if (i < g.mem_in_len) row[i] = m[u];
    }
#pragma unroll
    for (int u = 0; u < kOlpaStageFrame; ++u) {
      const int i = l + kCoderLanes * u;
      if (i < nf) frame[i] = f[u];
    }
  });
  w.sync();
  w.lanes([&](int l) {
    for (int i = l; i < g.len2; i += kCoderLanes) {
      row[g.mem_in_len + i] = olpa_decimate(frame, frame + 3, tab, i);
    }
    if (l < 3) new_mem12[l] = frame[g.length + l];
  });
  w.sync();
  w.lanes([&](int l) {
    for (int i = l; i < g.mem_in_len; i += kCoderLanes) new_mem64[i] = row[g.len2 + i];
  });
}

// R and E of the lane's four slots, every chain from the first product over
// the ACF samples, ascending: slot k is the lag l + 32k; slot 3 is the block
// itself on lanes 2-31, so its E there is e0.
template <int ACF, class W>
ACX_HD void olpa_chains(const W& w, const float* row, const OlpaGeom& g,
                        typename W::template Lanes<float> (&r)[kOlpaSlots],
                        typename W::template Lanes<float> (&e)[kOlpaSlots]) {
  const float* cur = row + g.base;
  float c[ACF];
#pragma unroll
  for (int n = 0; n < ACF; n += 4) olpa_quad(cur + n, c + n);
  w.lanes([&](int l) {
    // slots 0-2 read one window, from the first sample of lag l + 64: slot k
    // takes its sample n at i = n + 32 (2 - k)
    const float* win = cur - kOlpaMinPitch - (l + 64);
    const float* s3 = l + 96 < kOlpaLags ? win - 32 : cur;
    float rr[kOlpaSlots], ee[kOlpaSlots];
#pragma unroll
    for (int i = 0; i < ACF + 64; ++i) {
      const float x = win[i];
      const float q = rmul(x, x);
#pragma unroll
      for (int k = 0; k < 3; ++k) {
        const int n = i - 32 * (2 - k);
        if (n >= 0 && n < ACF) {
          const float p = rmul(c[n], x);
          rr[k] = n == 0 ? p : radd(rr[k], p);
          ee[k] = n == 0 ? q : radd(ee[k], q);
        }
      }
      if (i < ACF) {
        const float y = s3[i];
        const float p = rmul(c[i], y), q3 = rmul(y, y);
        rr[3] = i == 0 ? p : radd(rr[3], p);
        ee[3] = i == 0 ? q3 : radd(ee[3], q3);
      }
    }
#pragma unroll
    for (int k = 0; k < kOlpaSlots; ++k) {
      r[k][l] = rr[k];
      e[k][l] = ee[k];
    }
  });
}

// The first maximum over the lanes of (v, i): the largest v, the lowest i on
// ties (first_max_beats), on every lane.
template <class W>
ACX_HD void olpa_first_max(const W& w, typename W::template Lanes<float>& v,
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

// Slot k of a lane's four, k uniform (static indices only: a register array
// indexed at run time is not read back reliably on the card).
ACX_HD float olpa_slot(float s0, float s1, float s2, float s3, int k) {
  return k == 0 ? s0 : (k == 1 ? s1 : (k == 2 ? s2 : s3));
}

// The value of lag index L from the lanes' slots: lane L % 32, slot L / 32.
template <class W>
ACX_HD float olpa_at(const W& w, const typename W::template Lanes<float> (&v)[kOlpaSlots],
                     int L) {
  typename W::template Lanes<float> s;
  w.lanes([&](int l) { s[l] = olpa_slot(v[0][l], v[1][l], v[2][l], v[3][l], L >> 5); });
  return w.shfl(s, L & (kCoderLanes - 1));
}

struct OlpaOut {
  int t0;
  float nc;
};

// The whole search for one stream on a warp, ACF = g.acflen. tab:
// olpa_down2 (5) ++ olpa_acw (98). Writes the two new memories (new_mem12
// [3], new_mem64 [mem_in_len]) and returns T0 and its normalised
// correlation (the same on every lane).
template <int ACF, class W>
ACX_HD OlpaOut olpa_warp(const W& w, const OlpaStream& s, const float* tab, const OlpaGeom& g,
                         OlpaScratch& S, float* new_mem12, float* new_mem64) {
  using FL = typename W::template Lanes<float>;
  using IL = typename W::template Lanes<int>;
  olpa_stage(w, s, tab, g, S, new_mem12, new_mem64);
  FL r[kOlpaSlots], e[kOlpaSlots];
  olpa_chains<ACF>(w, olpa_row(S, g), g, r, e);
  const float* acw = tab + kOlpaTaps;
  FL bv, bv2;
  IL bi, bi2;
  w.lanes([&](int l) {
    bv[l] = bv2[l] = -INFINITY;
    bi[l] = bi2[l] = kNoIndex;
#pragma unroll
    for (int k = 0; k < kOlpaSlots; ++k) {
      const int lag = l + kCoderLanes * k;
      if (lag < kOlpaLags) {
        const float v = rmul(r[k][l], acw[lag]);
        if (first_max_beats(v, lag, bv[l], bi[l])) {
          bv[l] = v;
          bi[l] = lag;
        }
        const float v2 = olpa_in_window(lag, s.mem_pitch) ? r[k][l] : -INFINITY;
        if (first_max_beats(v2, lag, bv2[l], bi2[l])) {
          bv2[l] = v2;
          bi2[l] = lag;
        }
      }
    }
  });
  olpa_first_max(w, bv, bi);
  olpa_first_max(w, bv2, bi2);
  const int L = iclamp(w.shfl(bi, 0), 0, kOlpaLags - 1);
  const int L2 = iclamp(w.shfl(bi2, 0), 0, kOlpaLags - 1);
  const float e0 = w.shfl(e[3], 2);
  OlpaOut o;
  olpa_decide(olpa_at(w, r, L), olpa_at(w, e, L), L, olpa_at(w, r, L2), olpa_at(w, e, L2), L2,
              e0, &o.t0, &o.nc);
  return o;
}

}  // namespace acx
