// The bisection of the encoder's global-gain estimate (gain_bisection.cu, K7)
// on a warp, with speculative halvings.
//
// The plain version is ops/quant.py:gain_bisection_plain
// (estimate_global_gain.c:102-125): eight halvings of the offset, fac = 128,
// 64, .., 1; halving k lowers the offset by fac, walks the block energies
// en[M-1..0] backward accumulating ener in float32 with the reference's gap
// filling for quiet blocks (iszero), and gives fac back where ener passes the
// target with a block above the low threshold.
//
// The premise: the test of halving k depends on the offset it tests alone,
// and the decisions of the halvings before it fix which of 2^(k-1) offsets
// that is. So the halvings form a binary tree: heap node h = 1 the first
// halving, children 2h (its test failed) and 2h + 1 (it passed). Every node a
// level may reach can be tested at once, and the decisions walked down the
// tree afterwards. The tests on the walked path are the plain version's tests
// exactly, each the same chain (gain_tests), so the offset equals the plain
// version's bit for bit.
//
// The warp (gain_bisection_warp): round A tests the 31 nodes of halvings 1-5,
// node h on lane h - 1; a ballot gives their decisions and a walk of five
// levels the offset after halving 5. Round B tests the 7 nodes of halvings
// 6-8 below it on lanes 0-6, and three more levels give the offset: two
// chains of M dependent steps a lane instead of eight.
//
// The steps are templates over the warp (warp.cuh), so g++ compiles them for
// the CPU rehearsal (tests/test_torch_rate_rehearsal.py).
#pragma once

#include "acodec.cuh"
#include "warp.cuh"

namespace acx {

// The reference's float32 thresholds: tmp < 7*(28/20), the gap 2.7*(28/20),
// tmp > 50*(28/20) (quant.py:99-101).
constexpr float kGainLow = 9.8f;
constexpr float kGainGap = 3.78f;
constexpr float kGainHigh = 70.0f;
constexpr int kGainMaxM = 1024;   // blocks a row: the rows staged in shared memory

// NC tests over the same row en [M], interleaved (one step of each a block):
// pass[c] where the chain at offset offs[c] passes the target. Every value
// of a step is computed, then selected: lanes testing other offsets take
// other sides of its conditions, and the conditional form, which nvcc
// compiled to branches, diverged at every step (0.0183 against 0.0085 ms at
// 2048 streams on an H100, tools/torch_coder_times.py --gain-variants). The
// selected values are the same, so is the order of the sum.
template <int NC>
ACX_HD void gain_tests(const float* en, int M, float target, const int (&offs)[NC],
                       bool (&pass)[NC]) {
  float offs_f[NC], ener[NC];
  unsigned iszero[NC];
#pragma unroll
  for (int c = 0; c < NC; ++c) {
    offs_f[c] = static_cast<float>(offs[c]);
    ener[c] = 0.0f;
    iszero[c] = 1u;
  }
#pragma unroll 4
  for (int j = M - 1; j >= 0; --j) {
    const float e = en[j];
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      const float t = rsub(e, offs_f[c]);
      const float high = rsub(rmul(2.0f, t), kGainHigh);
      const unsigned low = t < kGainLow ? 1u : 0u;
      const float above = t >= kGainHigh ? high : t;
      const float gap = iszero[c] != 0u ? 0.0f : kGainGap;
      ener[c] = radd(ener[c], low != 0u ? gap : above);
      iszero[c] &= low;
    }
  }
#pragma unroll
  for (int c = 0; c < NC; ++c) pass[c] = ener[c] > target && iszero[c] == 0u;
}

// The offset a walk of a tree of L halvings from offset o holds on reaching
// heap node h: k = msb(h) decisions taken, halving j (fac 2^(L-j)) lowering
// the offset by its fac and, where it passed, giving it back.
ACX_HD int gain_node_offset(int o, int L, int h) {
  const int k = msb32(h);
  return o - ((1 << L) - (1 << (L - k))) + ((h - (1 << k)) << (L - k));
}

// the offset node h tests: its offset lowered by its halving's fac
ACX_HD int gain_node_test(int o, int L, int h) {
  return gain_node_offset(o, L, h) - (1 << (L - 1 - msb32(h)));
}

// `levels` steps down the tree from node h by the decisions in the ballot
// mask (bit h - 1 the decision of node h)
ACX_HD int gain_walk(unsigned mask, int h, int levels) {
  for (int k = 0; k < levels; ++k) h = 2 * h + static_cast<int>((mask >> (h - 1)) & 1u);
  return h;
}

// One stream on a warp: en [M] its block energies, target its bit target
// (x 1.96), offset0 the starting offset. Returns the final offset on every
// lane.
template <class W>
ACX_HD int gain_bisection_warp(const W& w, const float* en, int M, float target, int offset0) {
  typename W::template Lanes<int> pass;
  // round A: halvings 1-5 of the tree of eight, node ln + 1 on lane ln
  w.lanes([&](int ln) {
    bool p[1] = {false};
    if (ln < 31) {
      const int offs[1] = {gain_node_test(offset0, 8, ln + 1)};
      gain_tests<1>(en, M, target, offs, p);
    }
    pass[ln] = p[0] ? 1 : 0;
  });
  const int o5 = gain_node_offset(offset0, 8, gain_walk(w.ballot(pass), 1, 5));
  // round B: halvings 6-8, a tree of three from o5
  w.lanes([&](int ln) {
    bool p[1] = {false};
    if (ln < 7) {
      const int offs[1] = {gain_node_test(o5, 3, ln + 1)};
      gain_tests<1>(en, M, target, offs, p);
    }
    pass[ln] = p[0] ? 1 : 0;
  });
  return gain_node_offset(o5, 3, gain_walk(w.ballot(pass), 1, 3));
}

}  // namespace acx
