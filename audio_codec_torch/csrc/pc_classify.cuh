// The partial-concealment classifier with the stability factor, 32 streams
// a warp (pc_classify_fx.c:19-299 and processPLCcomputeStabFac_main, as
// audio_codec_tpu/ops/pc.py:compute_stab_fac, pc_classify and
// _peak_detector compute them): whether a partially corrupt frame (bfi 2) is
// downgraded to a full loss, and the scale factors' stability in [0, 1].
// pc_classify.cu runs pc_classify_warp on the card's warp; it is a template
// over the warp (warp.cuh), so that g++ compiles it for the rehearsal
// (tests/test_torch_snsdec_pc_rehearsal.py, tests/test_torch_lane_rehearsal.py).
//
// The float results decide comparisons, and the stability factor is an
// output, so every product, sum and division is rounded on its own (rmul,
// radd, rsub, rdiv) in the order the plain version (ops/pc.py) states for a
// tensor on the card: the squared scale-factor differences one chain of 16
// from the first, divided by 25 (IEEE); the detector's mean energy one chain
// over the row times float32(1 / N); each 3-bin block energy (s[k] + s[k+1])
// + s[k+2]; the two residual energies chains from zero.
#pragma once

#include <cstring>

#include "acodec.cuh"
#include "plc.cuh"
#include "warp.cuh"

namespace acx {

constexpr int kPcBlock = 3;    // peakDetector BLOCK_SIZE
constexpr int kPcThr1 = 8;
constexpr int kPcMaxN = 400;   // the longest row (yLen at 48 kHz, 10 ms)
constexpr int kPcBins = 13;    // detector bins a lane: 32 x 13 >= kPcMaxN - 5
constexpr int kPcGroup = 16;   // rows a warp stages at once
constexpr int kPcStride = 404; // floats a staged row: 101 16-byte words, odd, so
                               // 8 lanes reading their rows' word c hit 8 banks
constexpr int kPcChunk = 16;   // row values a lane loads before its chain steps
constexpr int kPcScf = 16;     // scale factors a frame

// the index of a nonzero mask's lowest set bit
ACX_HD int low_bit(unsigned m) { return msb32(static_cast<int>(m & (0u - m))); }

ACX_HD float fmax3(float a, float b, float c) {
  const float m = a > b ? a : b;
  return m > c ? m : c;
}

// The arguments (kernels.py:pc_classify): the per-stream vectors as the
// decoder hands them over (plc.cuh:StreamVec), the rows, the outputs.
enum : int { kPcBfi = 0, kPcInv, kPcPitch, kPcPrev, kPcPrevPrev, kPcVecs };
struct PcArgs {
  StreamVec vec[kPcVecs];
  const float* q_old_d;            // [B, N]
  const float* q_old_res;          // [B, N]
  const float* scf_q;              // [B, 16]
  const float* old_scf;            // [B, 16]
  const float* old_old_scf;        // [B, 16]
  int B, N, frame_dms;
  float inv_n;                     // float32(1 / N)
  int32_t* bfi_out;                // [B]
  float* stab_out;                 // [B]
};

// processPLCcomputeStabFac's term: 1 - the squared distance of two scale
// factor vectors over 25, clamped to [0, 1]; 0.8 after a lost frame
ACX_HD float pc_stab(const float* a, const float* b, int pbfi) {
  if (pbfi == 1) return 0.8f;
  float d = 0.0f;
  for (int i = 0; i < kPcScf; ++i) {
    const float t = rsub(a[i], b[i]);
    d = radd(d, rmul(t, t));
  }
  return fclamp(rsub(1.25f, rdiv(d, 25.0f)), 0.0f, 1.0f);
}

// Copies a row of n4 16-byte words into shared memory (cp.async on the card;
// pc_stage_wait waits for every copy of the lane).
ACX_HD void pc_copy16(float* dst, const float* src) {
#ifdef __CUDA_ARCH__
  acx_cp_async16(dst, src, true);
#else
  std::memcpy(dst, src, 16);
#endif
}
template <class W>
ACX_HD void pc_stage_wait(const W& w) {
#ifdef __CUDA_ARCH__
  acx_cp_async_commit();
  acx_cp_async_wait_all();
#endif
  w.sync();
}

// peakDetector_fx's crossover for the row s [N] in shared memory, on the
// whole warp (every lane returns it): lane l tests bins 13l .. 13l + 12 from
// a window of the row in registers, its candidates a bit mask and their
// block energies in registers. The hysteresis keeps a running maximum: a
// candidate moves the crossover where its energy is at least the maximum of
// the energies before it (and the first block's) or above 0.3 of it, then
// raises that maximum. A maximum is exact in any order, so the maximum
// before each lane's bins is a scan of the lanes' maxima, each lane then
// tests its own candidates in order, and the crossover is the last that
// moved: the in-order walk's result.
template <class W>
ACX_HD int pc_detect_warp(const W& w, const float* s, int N, float mean_nrg) {
  using IL = typename W::template Lanes<int>;
  using FL = typename W::template Lanes<float>;
  struct Bins {
    float cent[kPcBins];
  };
  const int last = N - 2 * kPcBlock;   // the last bin tested
  // the first block (i == 0): two bins
  const float s0 = s[0], s1 = s[1];
  const float a0 = fabsf(s0), a1 = fabsf(s1);
  const float edge_cent = radd(rmul(s0, s0), rmul(s1, s1));
  const bool hit0 = a0 >= a1 && edge_cent > mean_nrg &&
                    (a0 > a1 ? a0 : a1) > fmax3(fabsf(s[2]), fabsf(s[3]), fabsf(s[4]));
  const float max0 = hit0 ? edge_cent : 0.0f;
  IL mask, moved;
  FL top;
  typename W::template Lanes<Bins> bins;
  w.lanes([&](int l) {
    const int k0 = kPcBins * l;
    float win[kPcBins + 8];            // s[k0 - 3 .. k0 + kPcBins + 4]
#pragma unroll
    for (int j = 0; j < kPcBins + 8; ++j) {
      const int i = k0 - 3 + j;
      win[j] = i >= 0 && i < N ? s[i] : 0.0f;
    }
    float a[kPcBins + 8], m3[kPcBins + 6];
#pragma unroll
    for (int j = 0; j < kPcBins + 8; ++j) a[j] = fabsf(win[j]);
#pragma unroll
    for (int j = 0; j < kPcBins + 6; ++j) m3[j] = fmax3(a[j], a[j + 1], a[j + 2]);
    unsigned m = 0u;
    float t = 0.0f;                    // a candidate's energy exceeds mean_nrg >= 0
#pragma unroll
    for (int i = 0; i < kPcBins; ++i) {
      const int k = k0 + i;
      // bins k .. k+2 are a[i + 3 .. i + 5]
      const float b0 = a[i + 3], b1 = a[i + 4], b2 = a[i + 5];
      const float cent = radd(radd(rmul(win[i + 3], win[i + 3]), rmul(win[i + 4], win[i + 4])),
                              rmul(win[i + 5], win[i + 5]));
      // the bins k-3..k-1; for k < 3 those above bin 0 (from 0)
      float prv = m3[i];
      if (k < kPcBlock) prv = k == 2 ? (0.0f > a[i + 2] ? 0.0f : a[i + 2]) : 0.0f;
      const float cur = m3[i + 3], nxt = m3[i + 6];
      const bool cand = k <= last && b1 >= b0 && b1 >= b2 && cent > mean_nrg && cur >= prv &&
                        cur > nxt;
      m |= (cand ? 1u : 0u) << i;
      bins[l].cent[i] = cent;
      t = cand && cent > t ? cent : t;
    }
    mask[l] = static_cast<int>(m);
    top[l] = t;
  });
  // the maximum of the lanes' candidates up to each lane, then before it
  FL incl = top;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const FL up = w.shfl_up(incl, d);
    w.lanes([&](int l) {
      if (l >= d && up[l] > incl[l]) incl[l] = up[l];
    });
  }
  const FL before = w.shfl_up(incl, 1);
  w.lanes([&](int l) {
    float pm = l > 0 && before[l] > max0 ? before[l] : max0;
    int lm = -1;
#pragma unroll
    for (int i = 0; i < kPcBins; ++i) {
      if ((mask[l] >> i) & 1) {
        const float c = bins[l].cent[i];
        if (c >= pm || c > rmul(0.3f, pm)) lm = i;
        pm = c >= pm ? c : pm;
      }
    }
    moved[l] = lm;
  });
  IL any;
  w.lanes([&](int l) { any[l] = moved[l] >= 0 ? 1 : 0; });
  const unsigned lanes = w.ballot(any);
  if (lanes == 0u) return hit0 ? 1 : 0;
  const int src = msb32(static_cast<int>(lanes));
  return kPcBins * src + w.shfl(moved, src) + kPcBlock - 1;
}

// pc_classify with the stability factor for the 32 streams b0 .. b0 + 31 of a
// warp, a stream a lane. stage: kPcGroup * kPcStride floats of the warp's
// shared memory.
//  1. Each lane its stream's stability factor (the scale-factor rows read
//     only where bfi 1 follows a good frame or bfi is 2) and whether its
//     frame is past the early return: bfi 2 in the low region, stable. Clean
//     frames end here.
//  2. The streams past it, found by a ballot, kPcGroup at a time: their rows
//     (q_old_d on the pitch path, q_old_res on the energy path) staged with
//     16-byte copies; lane r runs the group's r-th stream's energy chains
//     (the mean energy, or the low-region and whole energies) at once with
//     the others;
//  3. each stream of the group on the pitch path, in turn, through the
//     warp's peak detector.
template <class W>
ACX_HD void pc_classify_warp(const W& w, const PcArgs& p, int b0, float* stage) {
  using IL = typename W::template Lanes<int>;
  using FL = typename W::template Lanes<float>;
  IL bfi, inv, pitch, need, out, lim;
  FL stab, full, part;
  const int max_pitch_bin = p.frame_dms == 50 ? 4 : 8;
  w.lanes([&](int l) {
    const int b = b0 + l;
    bfi[l] = inv[l] = pitch[l] = need[l] = out[l] = lim[l] = 0;
    stab[l] = 1.0f;
    if (b >= p.B) return;
    const int f = vec_int(p.vec[kPcBfi], b), prev = vec_int(p.vec[kPcPrev], b);
    const size_t r = static_cast<size_t>(b) * kPcScf;
    float st = 1.0f;
    if (f == 1 && prev != 1)
      st = pc_stab(p.old_scf + r, p.old_old_scf + r, vec_int(p.vec[kPcPrevPrev], b));
    if (f == 2) st = pc_stab(p.scf_q + r, p.old_scf + r, prev);
    bfi[l] = f;
    stab[l] = st;
    inv[l] = vec_int(p.vec[kPcInv], b);
    pitch[l] = vec_int(p.vec[kPcPitch], b);
    const bool low_region = inv[l] * 10 < 4 * p.frame_dms;
    // past the early return: unstable (st < 0.5, false for a NaN) is a loss
    // at once, a stable frame goes on to the detector or the energies
    need[l] = f == 2 && low_region && !(st < 0.5f) ? 1 : 0;
    out[l] = f == 2 && low_region && st < 0.5f ? 1 : f;
  });
  const int n4 = p.N / 4;
  unsigned todo = w.ballot(need);
  while (todo != 0u) {
    // the group: the next kPcGroup of those streams (lanes), in lane order
    unsigned grp = 0u;
    int g = 0;
    while (todo != 0u && g < kPcGroup) {
      grp |= todo & (0u - todo);
      todo &= todo - 1u;
      ++g;
    }
    // the r-th stream's row into stage row r; lane r its chains' limit
    unsigned m = grp;
#pragma unroll 1
    for (int r = 0; m != 0u; ++r, m &= m - 1u) {
      const int src = low_bit(m);
      const bool on_pitch = w.shfl(pitch, src) == 1;
      const int li = on_pitch ? 0 : w.shfl(inv, src);
      const float* row = (on_pitch ? p.q_old_d : p.q_old_res) + static_cast<size_t>(b0 + src) * p.N;
      float* dst = stage + r * kPcStride;
      w.lanes([&](int l) {
        for (int c = l; c < n4; c += 32) pc_copy16(dst + 4 * c, row + 4 * c);
        if (l == r) lim[l] = li;
      });
    }
    pc_stage_wait(w);
    // lane r: the r-th stream's energy chains, all the group's at once
    // (kPcChunk values loaded at once, so that the loads' latency does not
    // fall on the chain; a row's reads stay inside its stride, past N unused)
    w.lanes([&](int l) {
      float f = 0.0f, pt = 0.0f;
      if (l < g) {
        const float* row = stage + l * kPcStride;
        for (int i0 = 0; i0 < p.N; i0 += kPcChunk) {
          float v[kPcChunk];
#pragma unroll
          for (int u = 0; u < kPcChunk; ++u) v[u] = row[i0 + u];
#pragma unroll
          for (int u = 0; u < kPcChunk; ++u) {
            const int i = i0 + u;
            if (i < p.N) {
              const float e = rmul(v[u], v[u]);
              pt = radd(pt, i < lim[l] ? e : 0.0f);
              f = radd(f, e);
            }
          }
        }
      }
      full[l] = f;
      part[l] = pt;
    });
    // each stream's verdict, onto its own lane
    m = grp;
#pragma unroll 1
    for (int r = 0; m != 0u; ++r, m &= m - 1u) {
      const int src = low_bit(m);
      const int sinv = w.shfl(inv, src);
      bool bad;
      if (w.shfl(pitch, src) == 1) {
        const float mean_nrg =
            rmul(rmul(w.shfl(full, r), p.inv_n), static_cast<float>(kPcBlock * kPcThr1));
        const int xover = pc_detect_warp(w, stage + r * kPcStride, p.N, mean_nrg);
        bad = sinv < xover || sinv < max_pitch_bin;
      } else {
        bad = w.shfl(part, r) < rmul(0.3f, w.shfl(full, r));
      }
      w.lanes([&](int l) {
        if (l == src && bad) out[l] = 1;
      });
    }
    w.sync();
  }
  w.lanes([&](int l) {
    const int b = b0 + l;
    if (b < p.B) {
      p.bfi_out[b] = out[l];
      p.stab_out[b] = stab[l];
    }
  });
}

}  // namespace acx
