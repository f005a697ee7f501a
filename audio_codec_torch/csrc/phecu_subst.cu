// phecu_subst: the Phase ECU's burst analysis and spectrum substitution for
// one frame of B streams.
//
// Replaces audio_codec_tpu/ops/plc_phecu.py: trans_burst_ana (:231) as the
// concealment step calls it, and subst_spec (:273: the spreading of the peak
// phases over +-5 bins, the two generator draws of _rand_phases :122, the
// valley magnitude scrambling, the fade to the group average, the DC and
// Nyquist rules). The reference substitutes every stream whenever any stream
// is concealed by the Phase ECU; here only those streams do the work, the
// others write zeros.
//
// Bound on an H100: the bytes, a [385] complex row in and out and a [321] row
// of peaks per stream (7.4 KB, 15 MB at B = 2048, 4.5 us at 3.35 TB/s, if
// every stream were concealed so); per bin at most 11 peak tests, three
// sines or cosines and a dozen products.
// Design: a warp a stream, one block of four warps; the bins spread over the
// lanes, each finding its nearest peak from the peak row; the nine groups'
// attenuations computed once a stream. The float order is the plain
// version's (phecu.cuh), so the two agree bit for bit, the sines and cosines
// being the card's sinf and cosf as torch.sin and torch.cos compute them.
#include "phecu.cuh"

using namespace acx;

#ifdef __CUDACC__
constexpr int kPhSubstWarps = 4;

__global__ void phecu_subst_kernel(const float* __restrict__ xr, const float* __restrict__ xi,
                                   const float* __restrict__ f0, const int32_t* __restrict__ ints,
                                   const float* __restrict__ groups,
                                   const float* __restrict__ beta_mute,
                                   const int32_t* __restrict__ tab, float* __restrict__ outr,
                                   float* __restrict__ outi, int B, PhGeom g) {
  __shared__ PhWork work[kPhSubstWarps];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int b = blockIdx.x * kPhSubstWarps + warp;
  if (b >= B) return;   // the whole warp leaves together
  const size_t row = static_cast<size_t>(b) * g.nsf;
  if (!ints[3 * B + b]) {
    for (int k = lane; k < g.nsf; k += 32) outr[row + k] = outi[row + k] = 0.0f;
    return;
  }
  const CardWarp w{lane};
  const int nb = ints[B + b];
  // groups: e_oold, e_old, mag_chg_1st, xavg, each [B, 9]
  const size_t gb = static_cast<size_t>(b) * kPhGroups, gB = static_cast<size_t>(B) * kPhGroups;
  ph_burst(w, nb, groups + gb, groups + gB + gb, groups + 2 * gB + gb, beta_mute[b], &work[warp]);
  ph_subst_stream(w, g, xr + row, xi + row, f0 + static_cast<size_t>(b) * g.ns, ints[b], nb,
                  ints[2 * B + b], groups + 3 * gB + gb, tab, &work[warp], outr + row, outi + row);
}

extern "C" int acx_phecu_subst(const void* xr, const void* xi, const void* f0, const void* ints,
                               const void* groups, const void* beta_mute, const void* tab,
                               void* outr, void* outi, int B, int ns, int nsf, int n_lgw, int fl,
                               int t_adv, int lprot, void* stream) {
  if (ns > kPhBins || nsf > kPhAll || ns > nsf || n_lgw < 1 || n_lgw > kPhGroups || fl < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (B == 0) return static_cast<int>(cudaSuccess);
  const PhGeom g = {ns, nsf, n_lgw, fl, t_adv, lprot};
  const int blocks = (B + kPhSubstWarps - 1) / kPhSubstWarps;
  phecu_subst_kernel<<<blocks, 32 * kPhSubstWarps, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(xr), static_cast<const float*>(xi),
      static_cast<const float*>(f0), static_cast<const int32_t*>(ints),
      static_cast<const float*>(groups), static_cast<const float*>(beta_mute),
      static_cast<const int32_t*>(tab), static_cast<float*>(outr), static_cast<float*>(outi), B, g);
  return static_cast<int>(cudaGetLastError());
}
#endif
