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
// every stream were concealed so); per bin a dozen products, and a sine and
// a cosine per peak.
// Design: a warp a stream (phecu.cuh:ph_subst_warp), blocks of four warps;
// the peak mask a string of ballot words, each bin's nearest peak from its
// bits; a peak's cosine and sine once per peak, the generator phases' from a
// 32-entry table made by the warp; the streams the Phase ECU does not
// conceal write zeros. The per-stream vectors are read as the wrapper hands
// them over (plc.cuh:StreamVec). The float order is the plain version's, so
// the two agree bit for bit, the sines and cosines being the card's sinf and
// cosf as torch.sin and torch.cos compute them.
#include "phecu.cuh"

using namespace acx;

#ifdef __CUDACC__
constexpr int kPhSubstWarps = 4;
constexpr int kPhSubstVecs = 5;   // num_plocs, nb_cur, is_trans, active, beta_mute

struct PhSubstVecs {
  StreamVec v[kPhSubstVecs];
};

__global__ void phecu_subst_kernel(const float* __restrict__ xr, const float* __restrict__ xi,
                                   const float* __restrict__ f0, const float* __restrict__ e_oold,
                                   const float* __restrict__ e_old, const float* __restrict__ mc1,
                                   const float* __restrict__ xavg, PhSubstVecs v,
                                   const int32_t* __restrict__ tab, float* __restrict__ outr,
                                   float* __restrict__ outi, int B, PhGeom g) {
  __shared__ PhWork work[kPhSubstWarps];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int b = blockIdx.x * kPhSubstWarps + warp;
  if (b >= B) return;   // the whole warp leaves together
  const size_t row = static_cast<size_t>(b) * g.nsf;
  if (!vec_int(v.v[3], b)) {
    for (int k = lane; k < g.nsf; k += 32) outr[row + k] = outi[row + k] = 0.0f;
    return;
  }
  const size_t gb = static_cast<size_t>(b) * kPhGroups;
  ph_subst_warp(CoderCardWarp{lane}, g, xr + row, xi + row, f0 + static_cast<size_t>(b) * g.ns,
                vec_int(v.v[0], b), vec_int(v.v[1], b), vec_int(v.v[2], b), e_oold + gb,
                e_old + gb, mc1 + gb, vec_float(v.v[4], b), xavg + gb, tab, &work[warp],
                outr + row, outi + row);
}

// vecs, meta: the five per-stream vectors (kPhSubstVecs) and their (stride,
// type) pairs, in host memory
extern "C" int acx_phecu_subst(const void* xr, const void* xi, const void* f0, const void* e_oold,
                               const void* e_old, const void* mc1, const void* xavg,
                               const void* const* vecs, const int* meta, const void* tab,
                               void* outr, void* outi, int B, int ns, int nsf, int n_lgw, int fl,
                               int t_adv, int lprot, void* stream) {
  if (ns > kPhBins || nsf > kPhAll || ns > nsf || n_lgw < 1 || n_lgw > kPhGroups || fl < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (B == 0) return static_cast<int>(cudaSuccess);
  const PhGeom g = {ns, nsf, n_lgw, fl, t_adv, lprot};
  PhSubstVecs v;
  for (int i = 0; i < kPhSubstVecs; ++i) v.v[i] = {vecs[i], meta[2 * i], meta[2 * i + 1]};
  const int blocks = (B + kPhSubstWarps - 1) / kPhSubstWarps;
  phecu_subst_kernel<<<blocks, 32 * kPhSubstWarps, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(xr), static_cast<const float*>(xi),
      static_cast<const float*>(f0), static_cast<const float*>(e_oold),
      static_cast<const float*>(e_old), static_cast<const float*>(mc1),
      static_cast<const float*>(xavg), v, static_cast<const int32_t*>(tab),
      static_cast<float*>(outr), static_cast<float*>(outi), B, g);
  return static_cast<int>(cudaGetLastError());
}
#endif
