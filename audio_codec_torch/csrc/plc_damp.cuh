// One stream of the advanced concealment's spectral part
// (plc_damp_scramble.cu): noise substitution on the lanes it conceals, then
// the damping and sign scrambling of the lost lanes (bfi 1) and of the
// partially concealed ones (bfi 2), in the reference decoder's order
// (ops/plc_adv.py: damp_scramble_plain, damping_scrambling). Written over
// the warps of warp.cuh:
//  - the bins' generator jumps (mult[k + 1], add[k + 1]) are loaded with
//    the stream's flags, once for both passes; then the one row the flags
//    choose (the spectrum, or the last good one where the stream is
//    noise-substituted) in 16-byte words where the rows allow, bins
//    4 (l + 32 j) .. + 3 on lane l. The row stays in registers and goes out
//    in the same words, so a stream whose spectrum passes through (neither
//    noise-substituted nor partially concealed) is a copy;
//  - the mean energy keeps XLA's windows of 32 (numerics.xla_sum: the row
//    zero-padded to a multiple of 32, half the pad in front), each window
//    summed from +0 in order on one lane and the window sums from +0 in
//    order. The terms are staged at a padded stride, term m of the padded
//    row at m + m / 32, so that lane j reading term i of window j (at 33 j +
//    i) hits bank (j + i) % 32: no conflict. The window sums meet by
//    shuffles;
//  - a bin's choices (its sign, the damping's two branches, spec_inv_idx,
//    the row's end) are selects of bits, not branches, so that the 16 bins
//    of a lane run interleaved.
#pragma once

#include "plc.cuh"

namespace acx {

constexpr int kDampMaxN = 400;
constexpr int kDampRounds = (kDampMaxN + 31) / 32;   // the most windows of 32
constexpr int kDampWords = (kDampMaxN + 127) / 128;   // 16-byte words of a row a lane
constexpr int kDampStride = 33;                        // a window's stride in the staged terms
constexpr int kDampVecs = 14;                          // the per-stream vectors (damp_in)

struct DampState {
  float cf, cs, cfa;   // cumulative rapid-fade, slow and fast factors
};

constexpr int kDampSpare = kDampRounds * kDampStride;  // where the bins past the row's end go

// a warp's shared scratch: the energy terms of the padded row, and a spare slot
struct DampWork {
  float term[kDampSpare + 1];
};

// the stream's scalars and what it returns
struct DampIn {
  bool ns, lost, is_pc;
  int nb_cur, pc_nb_lost, pitch_int, pc_pitch, ns_seed, pc_seed, inv;
  float stab;
  DampState st;
};
struct DampOut {
  DampState st;
  int ns_seed, pc_seed;
};

// stream b's scalars from the vectors ns_lane, lost, is_pc, nb_cur,
// pc_nb_lost, pitch_int, pc_pitch, ns_seed, pc_seed, spec_inv_idx,
// stab_fac, cum_fflc, cum_slow, cum_fast
ACX_HD DampIn damp_in(const StreamVec* v, int b) {
  DampIn in;
  in.ns = vec_int(v[0], b) != 0;
  in.lost = vec_int(v[1], b) != 0;
  in.is_pc = vec_int(v[2], b) != 0;
  in.nb_cur = vec_int(v[3], b);
  in.pc_nb_lost = vec_int(v[4], b);
  in.pitch_int = vec_int(v[5], b);
  in.pc_pitch = vec_int(v[6], b);
  in.ns_seed = vec_int(v[7], b);
  in.pc_seed = vec_int(v[8], b);
  in.inv = vec_int(v[9], b);
  in.stab = vec_float(v[10], b);
  in.st = {vec_float(v[11], b), vec_float(v[12], b), vec_float(v[13], b)};
  return in;
}

// a row in registers, in 16-byte words: element c of word j of lane l is
// bin 4 (l + 32 j) + c; and the bins' generator jumps mult[k + 1], add[k + 1]
template <class W>
struct DampRow {
  typename W::template Lanes<float> v[kDampWords][4];
  typename W::template Lanes<int> mult[kDampWords][4], add[kDampWords][4];
};
ACX_HD int damp_bin(int l, int j, int c) { return 4 * (l + 32 * j) + c; }

// lane l's words of row p [N] into r (16-byte loads where vec), and back
template <class L>
ACX_HD void damp_load(const float* p, int N, bool vec, int l, L (&r)[kDampWords][4]) {
#pragma unroll
  for (int j = 0; j < kDampWords; ++j) {
    const int k = damp_bin(l, j, 0);
#ifdef __CUDA_ARCH__
    if (vec) {
      if (k < N) {
        const float4 t = *reinterpret_cast<const float4*>(p + k);
        r[j][0][l] = t.x;
        r[j][1][l] = t.y;
        r[j][2][l] = t.z;
        r[j][3][l] = t.w;
      }
      continue;
    }
#endif
#pragma unroll
    for (int c = 0; c < 4; ++c) r[j][c][l] = p[imin(k + c, N - 1)];
  }
}
template <class L>
ACX_HD void damp_store(float* p, int N, bool vec, int l, const L (&r)[kDampWords][4]) {
#pragma unroll
  for (int j = 0; j < kDampWords; ++j) {
    const int k = damp_bin(l, j, 0);
#ifdef __CUDA_ARCH__
    if (vec) {
      if (k < N) {
        *reinterpret_cast<float4*>(p + k) = make_float4(r[j][0][l], r[j][1][l], r[j][2][l], r[j][3][l]);
      }
      continue;
    }
#endif
#pragma unroll
    for (int c = 0; c < 4; ++c)
      if (k + c < N) p[k + c] = r[j][c][l];
  }
}

// damping_scrambling at 10 ms frames for one stream: the factors and the
// seed, and where `scramble` holds the signs and the damping of the row.
// Returns the new seed; updates st.
template <class W>
ACX_HD int damp_pass(const W& w, DampRow<W>& row, int N, int nb, float stab, bool scramble,
                     DampState& st, int pitch_present, int seed, int inv, bool active,
                     const int32_t* pows, DampWork* ws) {
  if (active && nb == 1) st = {1.0f, 1.0f, 1.0f};
  const float slow = xfma(0x1.99999ap-3f, stab, 0x1.99999ap-1f);
  const float fast = xfma(0x1.99999ap-3f, stab, 0x1.333334p-2f);
  if (active) {
    st.cs = rmul(st.cs, slow);
    st.cfa = rmul(st.cfa, fast);
  }
  const bool ffl = inv == 0;
  const float att = nb > 6 ? 0.0f : (nb > 2 ? 0.5f : 1.0f);
  if (active && scramble && ffl && att < 1.0f) st.cf = rmul(st.cf, att);
  const float slow_loc = ffl ? rmul(st.cs, st.cf) : st.cs;
  const float fast_loc = ffl ? rmul(st.cfa, st.cf) : st.cfa;
  const int start = pitch_present == 0 ? 1 : 2;          // PLC4_TRANSIT_START / 10 ms
  float lin = fclamp(rdiv(static_cast<float>(6 - nb), static_cast<float>(imax(6 - start, 1))),
                     0.0f, 1.0f);
  if (nb <= start) lin = 1.0f;
  const int steps = scramble ? iclamp(N - inv, 0, N) : 0;
  const int seed_out = lcg16_at(seed, steps, pows, N);
  if (!scramble) return seed_out;
  const float thr = rmul(-32768.0f, lin);
  const uint32_t su = static_cast<uint32_t>(seed) & 0xFFFFu;
  const int nwin = (N + 31) / 32, left = N <= 32 ? 0 : (nwin * 32 - N) / 2;
  // the signs; the energy terms (and the pad's +0) into the padded row, a
  // bin past the row's end into the spare slot
  w.lanes([&](int l) {
#pragma unroll
    for (int j = 0; j < kDampWords; ++j) {
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int k = damp_bin(l, j, c);
        const uint32_t s = (su * static_cast<uint32_t>(row.mult[j][c][l]) +
                            static_cast<uint32_t>(row.add[j][c][l])) & 0xFFFFu;
        const float r = static_cast<float>(static_cast<int>(s) - (s >= 32768u ? 65536 : 0));
        const uint32_t scrambled = all_if(k >= inv);
        const uint32_t flip = scrambled & all_if(r < 0.0f && (pitch_present == 0 || r < thr));
        const float v = fsel_bits(flip, -row.v[j][c][l], row.v[j][c][l]);
        row.v[j][c][l] = v;
        const int m = k + left;
        const float t = rmul(fsel_bits(scrambled, 1.0f, 0.0f), rmul(v, v));
        ws->term[k < N ? m + (m >> 5) : kDampSpare] = t;
      }
    }
    const int m = left + N + l;
    if (l < left) ws->term[l] = 0.0f;
    if (m < 32 * nwin) ws->term[m + (m >> 5)] = 0.0f;
  });
  w.sync();
  // window j from +0 on lane j, then the window sums from +0 on every lane
  // (the lanes past the windows add +0, which leaves a sum >= +0 as it is)
  typename W::template Lanes<float> part;
  w.lanes([&](int l) {
    float acc = 0.0f;
    if (l < nwin) {
      const float* t = ws->term + kDampStride * l;
#pragma unroll
      for (int i = 0; i < 32; ++i) acc = radd(acc, t[i]);
    }
    part[l] = acc;
  });
  float e = 0.0f;
#pragma unroll
  for (int j = 0; j < kDampRounds; ++j) e = radd(e, w.shfl(part, j));
  w.sync();
  const float ad_fac = xfma(0x1.19999ap+3f, lin, 0x1.333334p+0f);
  const float nbin = fmax2(static_cast<float>(iclamp(N - inv, 0, N)), 1.0f);
  const float thr_e = rroot(rmul(ad_fac, rdiv(e, nbin)));
  const float fac = rmul(rsub(slow_loc, fast_loc), thr_e);
  w.lanes([&](int l) {
#pragma unroll
    for (int j = 0; j < kDampWords; ++j) {
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int k = damp_bin(l, j, c);
        const float v = row.v[j][c][l];
        const float sg = fsel_bits(all_if(v > 0.0f), 1.0f,
                                   fsel_bits(all_if(v < 0.0f), -1.0f, 0.0f));
        const float d = fsel_bits(all_if(fabsf(v) < thr_e), rmul(v, slow_loc),
                                  xfma(v, fast_loc, rmul(sg, fac)));
        row.v[j][c][l] = fsel_bits(all_if(k >= inv), d, v);
      }
    }
  });
  return seed_out;
}

// plc_damp_scramble for one stream on warp w: writes spec_out [N] and o.
template <class W>
ACX_HD void damp_warp(const W& w, const DampIn& in, const float* x, const float* q,
                      const int32_t* pows, int N, DampWork* ws, float* spec_out, DampOut& o) {
  bool vec = (N & 3) == 0;
#ifdef __CUDA_ARCH__
  vec = vec && ((reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(q) |
                 reinterpret_cast<uintptr_t>(spec_out)) & 15u) == 0;
#endif
  // the generator jumps, then the row the stream's flags choose (the last
  // good one, tapered, where it is noise-substituted)
  DampRow<W> row;
  w.lanes([&](int l) {
#pragma unroll
    for (int j = 0; j < kDampWords; ++j) {
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int k = imin(damp_bin(l, j, c), N - 1);
        row.mult[j][c][l] = pows[k + 1];
        row.add[j][c][l] = pows[N + 2 + k];
      }
    }
    damp_load(in.ns ? q : x, N, vec, l, row.v);
    const uint32_t dc = all_if(in.ns && l == 0);   // bins 0 and 1: lane 0's first word
    row.v[0][0][l] = fsel_bits(dc, rmul(row.v[0][0][l], 0x1.99999ap-3f), row.v[0][0][l]);
    row.v[0][1][l] = fsel_bits(dc, rmul(row.v[0][1][l], 0.5f), row.v[0][1][l]);
  });
  DampState st = in.st;
  int ns_seed = in.ns_seed, pc_seed = in.pc_seed;
  if (in.lost || in.ns) {
    ns_seed = damp_pass(w, row, N, in.nb_cur, in.stab, in.ns, st, in.pitch_int > 0 ? 1 : 0,
                        in.ns_seed, 0, in.lost, pows, ws);
  }
  if (in.is_pc) {
    pc_seed = damp_pass(w, row, N, in.pc_nb_lost, in.stab, true, st, in.pc_pitch, in.pc_seed,
                        in.inv, true, pows, ws);
  }
  w.lanes([&](int l) { damp_store(spec_out, N, vec, l, row.v); });
  o.st = st;
  o.ns_seed = ns_seed;
  o.pc_seed = pc_seed;
}

}  // namespace acx
