// The two TNS lattices of a stream, as the lanes of a warp run them: the
// encoder's analysis lattice (tns_analysis_lattice.cu, K6) and the decoder's
// synthesis lattice (tns_synthesis_lattice.cu, K12).
//
// Both keep their plain versions' float order bit for bit
// (ops/tns.py:tns_analysis_lattice_plain, tns_synthesis_lattice_plain),
// which is XLA:CPU's contraction on every device: each contracted product
// a numerics.xla_fma, written here as dct4.cuh:xfma_d on doubles that hold
// float values (the exact double product and one double add, rounded to
// float precision by (x + M) - M; tns_fma, with the range test of tns_round
// that keeps it exact for every value); the products XLA:CPU leaves
// uncontracted (K6's last tap and K12's first, for B > 1) a float product
// and sum, tns_mul and tns_add below. The sum of two floats held in doubles
// rounds once in double (exactly where the two exponents lie within 29 of
// each other) and once to float: as the 53-bit double has at least
// 2 * 24 + 2 bits, the double rounding is innocuous (Figueroa 1995) and
// equals the float operation.
//
// Which filter a bin belongs to and its order come from the two ranges
// (tns_bin): filter f covers bins lo[f]..hi[f] where order[f] > 0, filter 1
// wins, orders above 8 act as 8 (the plain versions clamp their last tap).
// Every bin index is clipped to the row; the state and coefficient arrays
// are indexed only by unrolled static indices (a state lane picked by a
// runtime index read back stale on sm_90a).
//
// K6, the analysis lattice, is an FIR filter: its states take only inputs
// (tmp_save, audio_codec_tpu/ops/tns.py:200-207), never outputs. State lane
// j is written at a bin from lanes 0..j-1 of the bin before, lane 0 from
// the bin's input, and is read only where it is written (j <= order - 1).
// So where a stream's active bins run through two phases at most (one
// filter, then the other), every state a bin reads is a function of the
// inputs at most 8 bins back, or is still the frame's zero: lanes a
// phase's order does not reach are never written in that phase. A lane
// that starts 8 bins ahead of its chunk from a zero state
// (kTnsWarmup) therefore reaches the chunk with the states the
// sequential loop has there, and each of the 32 lanes of a warp takes a
// chunk of one stream (tns_analysis_span). A stream whose filters leave a
// gap between their ranges, or whose filter 1 lies inside filter 0's range
// (filter 0, 1, then 0 again), reads states from further back: lane 0 runs
// its whole row (the general path; the codec's ranges never take it).
//
// K12, the synthesis lattice, feeds its output back (st[0] = s), so its
// bins stay in order; but tap el of bin n needs only tap el+1 of bin n (the
// chains s and s_f) and tap el-1 of bin n-1 (its update of st[el]). Tap el
// lies on lane el of an 8-lane group, a stream a group, and runs bin n at
// step 2n + (7 - el) (tns_wave_bin): each step passes s and s_f down one
// lane and the update up one lane, and every lane reads what its
// neighbours computed the step before (on the card __shfl_down_sync and
// __shfl_up_sync; in the rehearsal a loop that reads every lane before it
// writes any). The taps alternate: lane el is idle on the steps where
// el +- 1 work. Lanes above the bin's order pass x down; the per-bin
// choices are selects, so the four streams of a warp never serialize.
#pragma once

#include "dct4.cuh"

namespace acx {

constexpr int kTnsLags = 8;     // lattice taps, and K12's lanes a stream
constexpr int kTnsWarmup = 8;   // bins a K6 lane runs ahead of its chunk
constexpr int kTnsLanes = 32;   // K6's lanes (chunks) a stream

// x rounded to float precision where 2^-126 <= |x| < 2^127 or x is +-0:
// round_float_in_range with x's sign, which a rounding in that range keeps
// and which gives -0 its own. (x is a sum of floats' products and floats,
// at least 2^-298 where it is not zero, so an exponent field of zero is a
// zero.) The lattices' zero states make -0 often, as a negative
// coefficient times +0.
ACX_HD double round_float_signed(double x) {
#ifdef __CUDA_ARCH__
  return copysign(round_float_in_range(x), x);
#else
  return std::copysign(round_float_in_range(x), x);
#endif
}

// Rounding to float precision, in one of two ways. Exact (kExact): the
// tested step round_float, whose conversion takes the values outside the
// normal float range. Fast: round_float_signed, with no branch, noting in
// `far` a value outside its domain (a subnormal, a value at or past 2^127,
// a NaN). A lattice step (a K6 bin, a K12 tap) is taken fast, and taken
// again exactly where far was set, so its results are the exact step's and
// the usual step has no branch between its roundings, which overlap.
template <bool kExact>
ACX_HD double tns_round(double x, bool& far) {
  if constexpr (kExact) {
    return round_float(x);
  } else {
    const uint32_t hi = hi_word(x);
    const uint32_t e = hi & kExpField;
    far = far || e > kFloatExpHi || (e < kFloatExpLo && (hi & 0x7FFFFFFFu) != 0u);
    return round_float_signed(x);
  }
}
ACX_HD double rmul_f64(double a, double b) {
#ifdef __CUDA_ARCH__
  return __dmul_rn(a, b);
#else
  return a * b;
#endif
}
// xfma (numerics.xla_fma) on floats held in doubles
template <bool kExact>
ACX_HD double tns_fma(double a, double b, double p, bool& far) {
  return tns_round<kExact>(rfma_f64(a, b, p), far);
}
// a float product and a float sum, on floats held in doubles (see above)
template <bool kExact>
ACX_HD double tns_mul(double a, double b, bool& far) {
  return tns_round<kExact>(rmul_f64(a, b), far);
}
template <bool kExact>
ACX_HD double tns_add(double a, double b, bool& far) {
  return tns_round<kExact>(radd_f64(a, b), far);
}

// A stream's filters: orders as given, ranges clipped to the row, and the
// hull [a, b] of the bins either filter covers (a > b where neither is on).
struct TnsStream {
  int order[2], lo[2], hi[2];
  int a, b;
  int omax;   // the larger order of the filters that are on, at most 8
};

ACX_HD TnsStream tns_stream(const int32_t* order, const int32_t* lo, const int32_t* hi, int N) {
  TnsStream s;
  s.a = N;
  s.b = -1;
  s.omax = 0;
  for (int f = 0; f < 2; ++f) {
    s.order[f] = order[f];
    s.lo[f] = imax(lo[f], 0);
    s.hi[f] = imin(hi[f], N - 1);
    if (order[f] > 0 && s.lo[f] <= s.hi[f]) {
      s.a = imin(s.a, s.lo[f]);
      s.b = imax(s.b, s.hi[f]);
      s.omax = imax(s.omax, imin(order[f], kTnsLags));
    }
  }
  if (s.a > s.b) s.a = 0;
  return s;
}

// What bin n is: in a filter (act), in filter 1, and the order that applies.
struct TnsBin {
  bool act, in1;
  int o;
};

ACX_HD TnsBin tns_bin(const TnsStream& s, int n) {
  const bool in1 = s.order[1] > 0 && n >= s.lo[1] && n <= s.hi[1];
  const bool in0 = s.order[0] > 0 && n >= s.lo[0] && n <= s.hi[0];
  return {in0 || in1, in1, imin(in1 ? s.order[1] : s.order[0], kTnsLags)};
}

// ---- K6: the analysis lattice, a chunk a lane ----

// Whether the stream's active bins run through two phases at most, one
// filter and then the other, with no gap: then the chunks are exact.
ACX_HD bool tns_chunked(const TnsStream& s) {
  const bool on0 = s.order[0] > 0 && s.lo[0] <= s.hi[0];
  const bool on1 = s.order[1] > 0 && s.lo[1] <= s.hi[1];
  if (!on0 || !on1) return true;
  const bool joined = imax(s.lo[0], s.lo[1]) <= imin(s.hi[0], s.hi[1]) + 1;
  const bool inside = s.lo[1] > s.lo[0] && s.hi[1] < s.hi[0];
  return joined && !inside;
}

// The bins lane `lane` runs: from w, from a zero state, writing y for bins
// [c, e) (none where c >= e). Chunked: the hull [a, b] in 32 chunks of
// ceil((b - a + 1) / 32) bins, each run from kTnsWarmup bins ahead (or from
// a); else lane 0 runs the whole row.
ACX_HD void tns_analysis_span(const TnsStream& s, int N, int lane, int& w, int& c, int& e) {
  if (tns_chunked(s)) {
    const int len = s.b - s.a + 1;
    const int chunk = (len + kTnsLanes - 1) / kTnsLanes;
    c = iclamp(s.a + lane * chunk, 0, N);
    e = iclamp(imin(c + chunk, s.b + 1), 0, N);
    w = imax(s.a, c - kTnsWarmup);
    if (e <= c) w = c = e;   // a lane past the hull runs nothing
  } else {
    w = c = 0;
    e = lane == 0 ? N : 0;
  }
}

// Whether some lane writes y at bin n: the hull when chunked, else the row.
ACX_HD bool tns_analysis_wrote(const TnsStream& s, int N, int n) {
  return tns_chunked(s) ? (n >= s.a && n <= s.b) : (n >= 0 && n < N);
}

// One bin of the encoder's lattice: the state st (updated where the bin is
// active) and the output. Taps 0..o-2 contract both products; the last tap
// o-1 adds its product rounded on its own, or contracted where fused_last
// (B = 1). Taken fast, it returns false and leaves st alone where a
// rounding was out of the fast range.
template <bool kExact>
ACX_HD bool tns_analysis_bin(double* st, const TnsStream& s, const TnsBin& bn, double xv,
                             const double* r, bool fused_last, double& out) {
  bool far = false;
  double nst[kTnsLags];
  double sv = xv, save = xv;
  double s_l = 0.0, r_l = 0.0, st_l = 0.0;   // the last tap's operands
#pragma unroll
  for (int j = 0; j < kTnsLags; ++j) {
    nst[j] = st[j];
    if (j < s.omax) {   // the same for every lane of a stream
      const double rj = bn.in1 ? r[kTnsLags + j] : r[j];
      const bool live = j < bn.o - 1, last = j == bn.o - 1;
      s_l = last ? sv : s_l;
      r_l = last ? rj : r_l;
      st_l = last ? st[j] : st_l;
      if (j < kTnsLags - 1) {
        const double tmp = tns_fma<kExact>(rj, sv, st[j], far);
        const double sn = tns_fma<kExact>(rj, st[j], sv, far);
        nst[j] = (bn.act && (live || last)) ? save : st[j];
        save = live ? tmp : save;
        sv = live ? sn : sv;
      } else {
        nst[j] = (bn.act && last) ? save : st[j];
      }
    }
  }
  const double o = fused_last ? tns_fma<kExact>(r_l, st_l, s_l, far)
                              : tns_add<kExact>(s_l, tns_mul<kExact>(r_l, st_l, far), far);
  if (!kExact && far) return false;
#pragma unroll
  for (int j = 0; j < kTnsLags; ++j) st[j] = nst[j];
  out = o;
  return true;
}

// The encoder's lattice over bins [w, e) of x from a zero state, y written
// for [c, e); r [2][8] the filters' coefficients. Inactive bins keep the
// state and give y = x.
ACX_HD void tns_analysis_run(const float* x, float* y, int w, int c, int e, const TnsStream& s,
                             const double* r, bool fused_last) {
  double st[kTnsLags] = {0, 0, 0, 0, 0, 0, 0, 0};
  for (int n = w; n < e; ++n) {
    const TnsBin bn = tns_bin(s, n);
    const double xv = static_cast<double>(x[n]);
    double out = 0.0;
    if (!tns_analysis_bin<false>(st, s, bn, xv, r, fused_last, out))
      tns_analysis_bin<true>(st, s, bn, xv, r, fused_last, out);
    if (n >= c) y[n] = bn.act ? to_float(out) : x[n];
  }
}

// ---- K12: the synthesis lattice, a tap a lane ----

// The bin (from the hull's first) that tap el runs at step t, or -1.
ACX_HD int tns_wave_bin(int t, int el) {
  const int k = t - (kTnsLags - 1 - el);
  return (k >= 0 && (k & 1) == 0) ? k >> 1 : -1;
}

// Steps a stream of `len` hull bins takes: lane 0 runs its last at 2 len + 5.
ACX_HD int tns_wave_steps(int len) { return len > 0 ? 2 * len + kTnsLags - 2 : 0; }

// What a lane keeps from step to step: its state lane st[el], the chains it
// passes down (s, s_f), the update it passes up (st[el + 1] of its last
// bin), and whether its own state takes the update of the lane below.
struct TnsWaveLane {
  double st, s, sf, upd;
  bool pending;
};

// Lane el's tap of bin bn. s_in, sf_in: the chains from lane el + 1 (x at
// el = 7); u_in: lane el - 1's update at the bin before. r0, r1: tap el's
// coefficients of the two filters. Tap o-1 starts both chains: s_f with
// its product contracted, s rounded on its own unless fused_first (B = 1);
// taps below contract every product, and lanes 4-7 update their state from
// s_f. Taken fast, it returns false and leaves L alone where a rounding was
// out of the fast range.
template <bool kExact>
ACX_HD bool tns_synthesis_tap(TnsWaveLane& L, int el, double r0, double r1, const TnsBin& bn,
                              double s_in, double sf_in, double u_in, bool fused_first) {
  bool far = false;
  const double st = L.pending ? u_in : L.st;
  const double r = bn.in1 ? r1 : r0;
  const bool live = bn.act && el < bn.o - 1, first = bn.act && el == bn.o - 1;
  const double a = tns_fma<kExact>(-r, st, s_in, far);
  const double f2 = tns_fma<kExact>(-r, st, sf_in, far);
  const double sep = fused_first ? a : tns_add<kExact>(s_in, -tns_mul<kExact>(r, st, far), far);
  const double s = live ? a : (first ? sep : s_in);
  const double sf = live ? f2 : (first ? a : sf_in);
  const double upd = tns_fma<kExact>(r, el >= 4 ? sf : s, st, far);
  if (!kExact && far) return false;
  L.s = s;
  L.sf = sf;
  L.upd = upd;
  // st[el] takes lane el - 1's update where that tap is live (el <= o - 1)
  L.pending = bn.act && el >= 1 && el <= bn.o - 1;
  L.st = (el == 0 && bn.act) ? s : st;
  return true;
}

// One step of one lane: lane el = lane % 8 of the group of stream `row`
// (x in place, the hull [s.a, s.a + len)); the lanes' reads of their
// neighbours (s_in, sf_in, u_in) are the caller's.
ACX_HD void tns_synthesis_step(TnsWaveLane& L, int t, int el, float* row, const TnsStream& s,
                               int len, double r0, double r1, double s_in, double sf_in,
                               double u_in, bool fused_first) {
  const int k = tns_wave_bin(t, el);
  if (k < 0 || k >= len) return;
  const int n = iclamp(s.a + k, 0, s.b);
  const TnsBin bn = tns_bin(s, n);
  if (el == kTnsLags - 1) s_in = sf_in = static_cast<double>(row[n]);
  if (!tns_synthesis_tap<false>(L, el, r0, r1, bn, s_in, sf_in, u_in, fused_first))
    tns_synthesis_tap<true>(L, el, r0, r1, bn, s_in, sf_in, u_in, fused_first);
  if (el == 0 && bn.act) row[n] = to_float(L.s);
}

}  // namespace acx
