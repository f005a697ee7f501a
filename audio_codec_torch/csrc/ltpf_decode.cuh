// The LTPF decoder of one stream (process_ltpf_decoder_fl,
// ltpf_decoder.c:13-316, as audio_codec_tpu/ops/ltpf_dec.py:ltpf_decode
// computes it): the parameter decode (concealMethod 0 for a lost frame, the
// pitch at the output rate, the gain, the case word and the four filter rows)
// and the pitch-lagged IIR comb filter with its crossfade over the first
// 2.5 ms, in five cases (off/off, on->off fade-out, off->on fade-in, on->on
// same pitch, on->on pitch change through a scratch signal z).
//
// Every value equals the plain version's (ops/ltpf_dec.py:ltpf_decode_plain,
// which reuses ltpf_postfilter_plain for the sample loop) bit for bit: the
// filter rows are separately rounded products, (0.85 * gain) * tilt[j] left
// to right; each tap chain is the first product rounded, then one xfma a tap
// (numerics.xla_fma: the exact double product and one double add, rounded
// once), and the crossfade weight k / N4 is k times the float reciprocal of
// N4, as the CPU computes them.
//
// The sample loop runs in chunks, one sample a lane. z_n of sample n reads
// x, and the z ring p1 - (inter_len - 1) samples back and further; y_n reads
// the y ring p2 - (inter_len - 1) back and further, and in case E the z of
// the previous tilt_len samples. A chunk of C samples no longer than the
// nearest of those read distances (the chains the stream's case uses) reads
// only samples of earlier chunks from the rings, so within a chunk every lane
// can take its sample at once: first z of every sample (the z phase), then y
// (the y phase, whose case-E tilt taps read the z just written), then the
// rings. At 48 kHz the smallest pitch is 32 * 48000 / 12800 = 120 and
// inter_len 6, so every decoded pitch gives C >= 115 and a chunk is the 32
// lanes; 19 at 8 kHz. A pitch of 0 (possible where param[0] is 0 but the
// filter flag set, or in the parameter memory) reads samples not yet
// produced, as zeros (ltpf_postfilter_plain's buffers hold zeros there):
// such a stream takes chunks of one sample, the sequential loop.
//
// The steps are templates over the lanes that run them (LtpfLanes: on the
// card a warp, ltpf_decode.cu; on the host a loop over the lanes of a chunk
// that, like the warp, lets every lane of a phase read before any lane
// writes), which is how they compile as plain C++ for the rehearsal
// (tests/test_torch_lane_rehearsal.py).
#pragma once

#include "acodec.cuh"

namespace acx {

constexpr int kLtpfRing = 1024;   // samples of a y or z ring
constexpr int kLtpfChunk = 32;    // samples of a chunk at most: a warp's lanes
constexpr int kLtpfMaxX = 512;    // [mem_x, x] samples at most
enum { CASE_B = 1, CASE_C = 2, CASE_D = 4, CASE_E = 8, NEW_ON = 16 };
constexpr int kMinPitch12k8 = 32, kRes4Pitch12k8 = 127, kRes2Pitch12k8 = 157;

// The configuration's lengths and constants (ops/ltpf_dec.py).
struct LtpfGeom {
  int N;          // samples of a frame
  int Lx, Ly;     // mem_x, mem_y samples
  int inter_len;  // max(fs, 16000) / 8000
  int N4;         // samples of the crossfade, fs * 0.0025
  int fs;
  int beta_idx;   // cfg.ltpf_conf_beta_idx
  float beta;     // cfg.ltpf_conf_beta
};

// What the parameter decode gives a stream.
struct LtpfParams {
  int param[3];          // the new parameter memory
  int pitch_int, pitch_fr;
  float gain;
  int cases;             // CASE_* bits
  int p1, p2;            // old and new integer pitch
};

ACX_HD int floor_div(int a, int b) { return a >= 0 ? a / b : -((-a + b - 1) / b); }

// decode_pitch (ltpf_dec.py:36-58) of one index: pitch_int, pitch_fr at fs.
// The division by 12800 is IEEE's; the CPU's reciprocal product gives the
// same pitch for every index 0..511 at every rate
// (tests/test_torch_ltpf_dec.py).
ACX_HD void ltpf_decode_pitch(int fs, int p2, int& pitch_int, int& pitch_fr) {
  const int lo_end = (kRes4Pitch12k8 - kMinPitch12k8) * 4;
  const int mid_end = lo_end + (kRes2Pitch12k8 - kRes4Pitch12k8) * 2;
  int pi, pf;
  if (p2 < lo_end) {
    pi = kMinPitch12k8 + floor_div(p2, 4);
    pf = p2 - (pi - kMinPitch12k8) * 4;
  } else if (p2 < mid_end) {
    const int p2m = p2 - lo_end;
    pi = kRes4Pitch12k8 + floor_div(p2m, 2);
    pf = (p2m - (pi - kRes4Pitch12k8) * 2) * 2;
  } else {
    pi = p2 + (kRes2Pitch12k8 - lo_end - (kRes2Pitch12k8 - kRes4Pitch12k8) * 2);
    pf = 0;
  }
  float pitch = rmul(radd(static_cast<float>(pi), rmul(static_cast<float>(pf), 0.25f)),
                     static_cast<float>(fs));
  pitch = rdiv(pitch, 12800.0f);
  pitch = rmul(floorf(radd(rmul(pitch, 4.0f), 0.5f)), 0.25f);
  pitch_int = static_cast<int>(floorf(pitch));
  pitch_fr = static_cast<int>(rmul(rsub(pitch, static_cast<float>(pitch_int)), 4.0f));
}

// The parameter decode of ltpf_decode (ltpf_dec.py:ltpf_decode before the
// sample loop) for one stream.
ACX_HD LtpfParams ltpf_params(const LtpfGeom& g, int bfi, const int32_t* param,
                              const int32_t* mem_param, int mem_pitch_int, int mem_pitch_fr) {
  LtpfParams r;
  const bool bad = bfi == 1;   // concealMethod 0: zero parameters
  for (int i = 0; i < 3; ++i) r.param[i] = bad ? 0 : param[i];
  int pi = 0, pf = 0;
  if (r.param[0] == 1) ltpf_decode_pitch(g.fs, r.param[2], pi, pf);
  r.pitch_int = pi;
  r.pitch_fr = pf;
  if (g.beta_idx < 0) r.param[1] = 0;
  r.gain = (!bad && r.param[1] == 1) ? g.beta : 0.0f;
  const bool old_on = mem_param[1] == 1, new_on = r.param[1] == 1;
  const bool same = mem_pitch_int == pi && mem_pitch_fr == pf;
  r.cases = (old_on && !new_on ? CASE_B : 0) | (!old_on && new_on ? CASE_C : 0) |
            (old_on && new_on && same ? CASE_D : 0) | (old_on && new_on && !same ? CASE_E : 0) |
            (new_on ? NEW_ON : 0);
  r.p1 = mem_pitch_int;
  r.p2 = pi;
  return r;
}

// The filter rows of a stream as doubles (each a float product), and their
// first taps as floats, in registers: an xfma then converts only its two
// varying operands.
template <int NI, int NT>
struct LtpfFilters {
  double a1[NI], a2[NI], b1[NT], b2[NT];
  float a1_0, a2_0, b1_0, b2_0;
};

// a1 = mem_gain * inter[fr1], b1 = (0.85 * mem_gain) * tilt[beta1], and the
// same of the new parameters (ltpf_dec.py: the rows before the loop).
template <int NI, int NT>
ACX_HD void ltpf_filters(const LtpfGeom& g, const LtpfParams& p, float mem_gain, int mem_pitch_fr,
                         int mem_beta_idx, const float* inter, const float* tilt,
                         LtpfFilters<NI, NT>& f) {
  const float alpha = 0.85f;
  const float* i1 = inter + NI * iclamp(mem_pitch_fr, 0, 3);
  const float* i2 = inter + NI * iclamp(p.pitch_fr, 0, 3);
  const float* t1 = tilt + NT * iclamp(mem_beta_idx, 0, 3);
  const float* t2 = tilt + NT * imax(g.beta_idx, 0);
  const float ag1 = rmul(alpha, mem_gain), ag2 = rmul(alpha, p.gain);
#pragma unroll
  for (int j = 0; j < NI; ++j) {
    f.a1[j] = static_cast<double>(rmul(mem_gain, i1[j]));
    f.a2[j] = static_cast<double>(rmul(p.gain, i2[j]));
  }
#pragma unroll
  for (int j = 0; j < NT; ++j) {
    f.b1[j] = static_cast<double>(rmul(ag1, t1[j]));
    f.b2[j] = static_cast<double>(rmul(ag2, t2[j]));
  }
  f.a1_0 = static_cast<float>(f.a1[0]);
  f.a2_0 = static_cast<float>(f.a2[0]);
  f.b1_0 = static_cast<float>(f.b1[0]);
  f.b2_0 = static_cast<float>(f.b2[0]);
}

// xfma(w, v, acc) with the weight already a double.
ACX_HD float xfma_w(double w, float v, float acc) {
#ifdef __CUDA_ARCH__
  return __double2float_rn(__fma_rn(w, static_cast<double>(v), static_cast<double>(acc)));
#else
  return static_cast<float>(std::fma(w, static_cast<double>(v), static_cast<double>(acc)));
#endif
}

// sum_j w[j] v(j): the first product rounded, then an xfma a tap.
template <int NT, class V>
ACX_HD float tap_chain(const double (&w)[NT], float w0, V v) {
  float acc = rmul(w0, v(0));
#pragma unroll
  for (int j = 1; j < NT; ++j) acc = xfma_w(w[j], v(j), acc);
  return acc;
}

// A stream's samples in a chunk: at most the nearest read distance of the
// chains its case uses (from the lag of their first tap), at least one.
ACX_HD int ltpf_chunk(const LtpfGeom& g, const LtpfParams& p) {
  const bool need_z = p.cases & (CASE_B | CASE_E), need_y = p.cases & NEW_ON;
  int dist = kLtpfChunk;
  if (need_z) dist = imin(dist, p.p1 - (g.inter_len - 1));
  if (need_y) dist = imin(dist, p.p2 - (g.inter_len - 1));
  return iclamp(dist, 1, kLtpfChunk);
}

// The shared state of a stream: the y and z rings (position i of [mem_y, y]
// at i % kLtpfRing), [mem_x, x], and z of the chunk's samples.
struct LtpfRows {
  float* yr;
  float* zr;
  float* xs;
  float* zc;
};

// Ring value at position pos as the sequential loop sees it at position cur:
// the clamped position, and zero where it is not produced yet.
ACX_HD float ltpf_ring(const float* r, int pos, int cur, int lim) {
  pos = iclamp(pos, 0, lim);
  return pos < cur ? r[pos & (kLtpfRing - 1)] : 0.0f;
}

// new mem_x = [mem_x, x][N:N+Lx], new mem_y = [mem_y, y][N:N+Ly], from the
// staged row and the ring (which holds the last kLtpfRing
// positions, and Ly <= kLtpfRing).
template <class W>
ACX_HD void ltpf_write_mems(const W& w, const LtpfGeom& g, const LtpfRows& s, float* new_mx,
                            float* new_my) {
  w.each(g.Lx, [&](int i) { new_mx[i] = s.xs[g.N + i]; });
  w.each(g.Ly, [&](int i) { new_my[i] = s.yr[(g.N + i) & (kLtpfRing - 1)]; });
}

// x at position Lx + n - j of [mem_x, x], clamped.
ACX_HD float ltpf_xtap(const LtpfGeom& g, const LtpfRows& s, int n, int j) {
  return s.xs[iclamp(g.Lx + n - j, 0, g.Lx + g.N - 1)];
}

// The z phase of the chunk of `lanes` samples from n0: z_n of each (lane l
// takes n0 + l) into the chunk's z, and in case E into the z ring. Case B
// reads z only in the crossfade, and case C or D not at all.
template <int NI, int NT, class W>
ACX_HD void ltpf_z_phase(const W& w, const LtpfGeom& g, const LtpfParams& p,
                         const LtpfFilters<NI, NT>& f, const LtpfRows& s, int n0, int lanes) {
  const bool case_e = p.cases & CASE_E;
  if (!(case_e || ((p.cases & CASE_B) && n0 < g.N4))) return;
  const int lim = g.Ly + g.N - 1;
  const float inv_n4 = static_cast<float>(1.0 / static_cast<double>(g.N4));
  w.phase(
      lanes,
      [&](int l) {
        const int n = n0 + l, cur = g.Ly + n;
        const float s1_old = tap_chain(f.b1, f.b1_0, [&](int j) { return ltpf_xtap(g, s, n, j); });
        const int base1 = cur - p.p1 + g.inter_len - 1;
        const float s2_old = tap_chain(f.a1, f.a1_0, [&](int j) {
          return ltpf_ring(s.zr, base1 - j, cur, lim);
        });
        const float c_out = rmul(static_cast<float>(g.N4 - n), inv_n4);
        return xfma(c_out, s2_old, xfma(-c_out, s1_old, s.xs[g.Lx + n]));
      },
      [&](int l, float z_n) {
        s.zc[l] = z_n;
        if (case_e) s.zr[(g.Ly + n0 + l) & (kLtpfRing - 1)] = z_n;
      });
}

// The y phase of the chunk: y_n of each sample (the case's selection; in
// case E the tilt taps of the crossfade read the z of the z phase), then y,
// the y ring, and the z ring where z is y (every case but E).
template <int NI, int NT, class W>
ACX_HD void ltpf_y_phase(const W& w, const LtpfGeom& g, const LtpfParams& p,
                         const LtpfFilters<NI, NT>& f, const LtpfRows& s, int n0, int lanes,
                         float* y) {
  const bool case_b = p.cases & CASE_B, case_c = p.cases & CASE_C;
  const bool case_e = p.cases & CASE_E, new_on = p.cases & NEW_ON;
  const int lim = g.Ly + g.N - 1;
  const float inv_n4 = static_cast<float>(1.0 / static_cast<double>(g.N4));
  w.phase(
      lanes,
      [&](int l) {
        const int n = n0 + l, cur = g.Ly + n;
        const float xn = s.xs[g.Lx + n];
        const bool in_fade = n < g.N4;
        const float z_n = case_e || (case_b && in_fade) ? s.zc[l] : 0.0f;
        if (!new_on) return case_b && in_fade ? z_n : xn;
        const bool src_z = case_e && in_fade;
        const float s1_new = src_z ? tap_chain(f.b2, f.b2_0, [&](int j) {
          return j == 0 ? z_n : ltpf_ring(s.zr, cur - j, cur, lim);
        }) : tap_chain(f.b2, f.b2_0, [&](int j) { return ltpf_xtap(g, s, n, j); });
        const int base2 = cur - p.p2 + g.inter_len - 1;
        const float s2_new = tap_chain(f.a2, f.a2_0, [&](int j) {
          return ltpf_ring(s.yr, base2 - j, cur, lim);
        });
        const float c_in = (in_fade && (case_c || case_e))
            ? rmul(static_cast<float>(n), inv_n4) : 1.0f;
        // with the new filter on (cases C, D, E) y is the new filter's output
        return xfma(c_in, s2_new, xfma(-c_in, s1_new, src_z ? z_n : xn));
      },
      [&](int l, float y_n) {
        const int n = n0 + l, pos = (g.Ly + n) & (kLtpfRing - 1);
        s.yr[pos] = y_n;
        if (!case_e) s.zr[pos] = y_n;
        y[n] = y_n;
      });
}

// One stream's frame: stages the rings, runs the chunks, writes y and the
// new memories. x [N], mem_x [Lx], mem_y [Ly]; y [N], new_mx [Lx], new_my [Ly].
template <int NI, int NT, class W>
ACX_HD void ltpf_frame(const W& w, const LtpfGeom& g, const LtpfParams& p,
                       const LtpfFilters<NI, NT>& f, const float* x, const float* mem_x,
                       const float* mem_y, const LtpfRows& s, float* y, float* new_mx,
                       float* new_my) {
  w.each(g.Ly, [&](int i) {
    s.yr[i & (kLtpfRing - 1)] = mem_y[i];
    s.zr[i & (kLtpfRing - 1)] = mem_y[i];
  });
  w.each(g.Lx + g.N, [&](int i) { s.xs[i] = i < g.Lx ? mem_x[i] : x[i - g.Lx]; });
  w.sync();
  const int C = ltpf_chunk(g, p);
  for (int n0 = 0; n0 < g.N; n0 += C) {
    const int lanes = imin(C, g.N - n0);
    ltpf_z_phase(w, g, p, f, s, n0, lanes);
    ltpf_y_phase(w, g, p, f, s, n0, lanes, y);
  }
  w.sync();
  ltpf_write_mems(w, g, s, new_mx, new_my);
}

// The lanes of a chunk run one after another on the host; a phase computes
// every lane's value before it writes any (a warp's lanes read before the
// __syncwarp that precedes the writes).
struct LtpfHostLanes {
  template <class F>
  void each(int n, F&& fn) const {
    for (int i = 0; i < n; ++i) fn(i);
  }
  void sync() const {}
  template <class Compute, class Commit>
  void phase(int n, Compute&& compute, Commit&& commit) const {
    float v[kLtpfRing];
    for (int i = 0; i < n; ++i) v[i] = compute(i);
    for (int i = 0; i < n; ++i) commit(i, v[i]);
  }
};

}  // namespace acx
