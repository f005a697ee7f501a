// One stream of the standard concealment (plc_main.cu): processPlcMain_fl
// with processNoiseSubstitution0_fl and, fused after them, the counter rule of
// processPlcUpdate_fl (ops/plc.py: plc_main_plain). The scalars of a stream
// and each bin are functions of their own, so that the kernel can spread the
// bins over a warp and the rehearsal can run them in order on the host.
#pragma once

#include "acodec.cuh"

namespace acx {

constexpr int kPlcMainMaxN = 400;

struct PlcMainScalars {
  int lost;       // bfi == 1: the frame is concealed
  int nb_lost;    // the loss counter after the update
  float cum;      // the cumulative damping after the update (the lost frame's factor)
  unsigned u0;    // the generator's state, seed + 32768
  int seed;       // the seed after the frame
};

// The stream's scalars. lcg: mult [N + 1] ++ add [N + 1], the generator's
// closed form (ops/plc.py:_lcg_tables): u_k = (u0 * mult[k] + add[k]) mod 2^16
// after k steps.
ACX_HD PlcMainScalars plc_main_scalars(int bfi, int nb_lost, float cum_alpha, int seed,
                                       const int32_t* lcg, int N) {
  PlcMainScalars s;
  s.lost = bfi == 1;
  s.u0 = static_cast<unsigned>(seed + 32768);
  if (!s.lost) {   // plc_update: a frame that is not lost resets the counters
    s.nb_lost = 0;
    s.cum = 1.0f;
    s.seed = seed;
    return s;
  }
  s.nb_lost = nb_lost + 1;
  const float alpha = s.nb_lost < 4 ? 1.0f : (s.nb_lost < 8 ? 0.9f : 0.85f);
  s.cum = rmul(cum_alpha, alpha);
  const unsigned u = (s.u0 * static_cast<unsigned>(lcg[N]) + static_cast<unsigned>(lcg[2 * N + 1]))
                     & 0xffffu;
  s.seed = static_cast<int>(u) - 32768;
  return s;
}

// Bin k: the concealed value (the history's bin with the sign of the seed
// after k + 1 steps, damped) or the frame's own; the history keeps its row
// through a loss and takes the frame's bin otherwise.
ACX_HD void plc_main_bin(const PlcMainScalars& s, int k, float spec, float q_prev,
                         const int32_t* lcg, int N, float* spec_out, float* q_out) {
  if (!s.lost) {
    *spec_out = spec;
    *q_out = spec;
    return;
  }
  const unsigned u = (s.u0 * static_cast<unsigned>(lcg[k + 1]) +
                      static_cast<unsigned>(lcg[N + 2 + k])) & 0xffffu;
  const float v = rmul(q_prev, s.cum);
  *spec_out = u < 32768u ? -v : v;
  *q_out = q_prev;
}

}  // namespace acx
