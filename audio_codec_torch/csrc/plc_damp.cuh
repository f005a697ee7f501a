// One stream of the advanced concealment's spectral part
// (plc_damp_scramble.cu): noise substitution on the lanes it conceals, then
// the damping and sign scrambling of the lost lanes (bfi 1) and of the
// partially concealed ones (bfi 2), in the reference decoder's order
// (ops/plc_adv.py: damp_scramble_plain, damping_scrambling). Written over a
// warp policy (plc.cuh).
#pragma once

#include "plc.cuh"

namespace acx {

constexpr int kDampMaxN = 400;

struct DampState {
  float cf, cs, cfa;   // cumulative rapid-fade, slow and fast factors
};

struct DampWork {
  float spec[kDampMaxN];
  float scratch[32];
  float slot;
};

// damping_scrambling at 10 ms frames for one stream; spec in ws->spec.
// Returns the new seed; updates st.
template <class W>
ACX_HD int damp_pass(const W& w, DampWork* ws, int N, int nb, float stab, bool scramble,
                     DampState& st, int pitch_present, int seed, int inv, bool active,
                     const int32_t* pows) {
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
  w.each(N, [&](int k) {
    const float r = static_cast<float>(lcg16_at(seed, k + 1, pows, N));
    const bool neg = r < 0.0f && (pitch_present == 0 || r < thr);
    if (k >= inv && neg) ws->spec[k] = -ws->spec[k];
  });
  w.sync();
  const float ad_fac = xfma(0x1.19999ap+3f, lin, 0x1.333334p+0f);
  const float nbin = fmax2(static_cast<float>(iclamp(N - inv, 0, N)), 1.0f);
  const float e = wsum(w, N, ws->scratch, &ws->slot, [&](int k) {
    return rmul(k >= inv ? 1.0f : 0.0f, rmul(ws->spec[k], ws->spec[k]));
  });
  const float thr_e = rroot(rmul(ad_fac, rdiv(e, nbin)));
  const float fac = rmul(rsub(slow_loc, fast_loc), thr_e);
  w.each(N, [&](int k) {
    if (k < inv) return;
    const float v = ws->spec[k];
    const float sg = v > 0.0f ? 1.0f : (v < 0.0f ? -1.0f : 0.0f);
    ws->spec[k] = fabsf(v) < thr_e ? rmul(v, slow_loc) : xfma(v, fast_loc, rmul(sg, fac));
  });
  w.sync();
  return seed_out;
}

// ints: ns_lane, lost, is_pc, nb_cur, pc_nb_lost, pitch_int, pc_pitch,
// ns_seed, pc_seed, spec_inv_idx; floats: stab_fac, cum_fflc, cum_slow,
// cum_fast. Writes spec_out and (cum_fflc, cum_slow, cum_fast), (ns_seed,
// pc_seed).
template <class W>
ACX_HD void damp_stream(const W& w, const float* x, const float* q, const int (&iv)[10],
                        const float (&fv)[4], const int32_t* pows, int N, DampWork* ws,
                        float* spec_out, float (&fo)[3], int (&io)[2]) {
  const bool ns = iv[0] != 0, lost = iv[1] != 0, is_pc = iv[2] != 0;
  w.each(N, [&](int k) {
    ws->spec[k] = ns ? (k == 0 ? rmul(q[0], 0x1.99999ap-3f) : (k == 1 ? rmul(q[1], 0.5f) : q[k]))
                     : x[k];
  });
  w.sync();
  DampState st = {fv[1], fv[2], fv[3]};
  int ns_seed = iv[7], pc_seed = iv[8];
  if (lost || ns) {
    ns_seed = damp_pass(w, ws, N, iv[3], fv[0], ns, st, iv[5] > 0 ? 1 : 0, iv[7], 0, lost, pows);
  }
  if (is_pc) {
    pc_seed = damp_pass(w, ws, N, iv[4], fv[0], true, st, iv[6], iv[8], iv[9], true, pows);
  }
  w.each(N, [&](int k) { spec_out[k] = ws->spec[k]; });
  fo[0] = st.cf;
  fo[1] = st.cs;
  fo[2] = st.cfa;
  io[0] = ns_seed;
  io[1] = pc_seed;
}

}  // namespace acx
