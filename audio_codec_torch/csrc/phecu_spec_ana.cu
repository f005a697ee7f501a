// phecu_spec_ana: the Phase ECU's first-loss analysis for one frame of B
// streams.
//
// Replaces audio_codec_tpu/ops/plc_phecu.py: spec_ana (:135) after its
// rFFT (the hysteresis peak scan :153-170, the Jacobsen and parabola
// refinement, the peak-dense drop rule) and band_energies (:200) after its
// two rFFTs (the group sums). The FFTs stay library calls (torch.fft), as the
// reference leaves them to jnp.fft. The reference analyses every stream
// whenever any stream starts a Phase ECU burst; here only the streams at the
// first loss of such a burst do the work, the others write -1 and zeros.
//
// Bound on an H100: the bytes, two [321] complex rows in and a [321] row and
// 18 energies out per stream (6.5 KB, 13 MB at B = 2048, 4 us at 3.35 TB/s,
// if every stream were at such a first loss). The hysteresis scan is a
// recurrence over the 321 bins: one stream's chain of 321 short steps is the
// floor of a launch.
// Design: a warp a stream, blocks of four warps (phecu.cuh:ph_spec_ana_warp):
// the four rows read once, coalesced, and staged in the warp's shared
// scratch; the extremes warp reductions; the group energies on 18 lanes,
// each over its own group's bins; the scan one short select chain run by
// every lane alike; the count and the low-frequency test ballots; the
// refinement a bin a lane. The float order is the plain version's, so the
// two agree bit for bit.
#include "phecu.cuh"

using namespace acx;

#ifdef __CUDACC__
constexpr int kPhWarps = 4;

__global__ void __launch_bounds__(32 * kPhWarps)
    phecu_spec_ana_kernel(const float* __restrict__ xr, const float* __restrict__ xi,
                          const float* __restrict__ xor_, const float* __restrict__ xoi,
                          const float* __restrict__ nc, const int32_t* __restrict__ active,
                          float* __restrict__ f0, int32_t* __restrict__ npl,
                          float* __restrict__ e, int B, PhGeom g) {
  __shared__ PhAnaWork work[kPhWarps];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int b = blockIdx.x * kPhWarps + warp;
  if (b >= B) return;   // the whole warp leaves together
  const size_t row = static_cast<size_t>(b) * g.ns;
  float* eo = e + static_cast<size_t>(b) * kPhGroups;              // e_oold [B, 9]
  float* el = e + (static_cast<size_t>(B) + b) * kPhGroups;        // e_old [B, 9]
  if (!active[b]) {
    for (int k = lane; k < g.ns; k += 32) f0[row + k] = -1.0f;
    if (lane < kPhGroups) eo[lane] = el[lane] = 0.0f;
    if (lane == 0) npl[b] = 0;
    return;
  }
  ph_spec_ana_warp(CoderCardWarp{lane}, g, xr + row, xi + row, xor_ + row, xoi + row, nc[b],
                   &work[warp], f0 + row, npl + b, eo, el);
}

extern "C" int acx_phecu_spec_ana(const void* xr, const void* xi, const void* xor_,
                                  const void* xoi, const void* nc, const void* active, void* f0,
                                  void* npl, void* e, int B, int ns, int n_lgw, void* stream) {
  if (ns > kPhBins || ns < 8 || n_lgw < 1 || n_lgw > kPhGroups) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (B == 0) return static_cast<int>(cudaSuccess);
  const PhGeom g = {ns, 0, n_lgw, 0, 0, 0};
  const int blocks = (B + kPhWarps - 1) / kPhWarps;
  phecu_spec_ana_kernel<<<blocks, 32 * kPhWarps, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(xr), static_cast<const float*>(xi),
      static_cast<const float*>(xor_), static_cast<const float*>(xoi),
      static_cast<const float*>(nc), static_cast<const int32_t*>(active),
      static_cast<float*>(f0), static_cast<int32_t*>(npl), static_cast<float*>(e), B, g);
  return static_cast<int>(cudaGetLastError());
}
#endif
