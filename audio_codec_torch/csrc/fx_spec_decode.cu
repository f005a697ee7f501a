// fx_spec_decode: the fixed-point decoder's spectral chain (K20b).
//
// Replaces audio_codec_tpu/ops/fixed_dev.py:ari_scaling (:48),
// residual_decode (:56), noise_filling (:93, with _lcg_tables :81 and the
// cummax :109), apply_global_gain (:166, inv_log2 :145), tns_decode (:185,
// the scan :220-252, _masked_headroom32 :176), scf_scaling (:310) and
// mdct_shaping (:315): dec_lc3.c:196-235 on clean frames. [L, yLen] decoded
// spectrum, residual bits and side words + the bands' scale factors ->
// the shaped Word32 spectrum [L, N] and its exponent, L = T x B frames.
//
// Bound on an H100: the TNS lattice, up to 400 bins x 8 taps a frame, each
// tap a dependent multiply and saturation; the bytes are about 9.6 KB a
// lane (L = 16384: 157 MB, 0.05 ms at 3.35 TB/s).
// Design: a warp a frame (kFxSpecWarps a block). The elementwise lines run
// on 32 lanes, the headroom and maximum over the warp with shuffles; the
// residual's and the noise filler's ranks and the zero runs are warp scans
// over 13 chunks of 32 bins (a ballot, then popc or the highest set bit,
// fixed.cuh); only the lattice runs on lane 0 (its state and coefficients in
// registers, indexed statically). The spectrum and the zero runs sit in
// shared memory.
#include "fx_spec_decode.cuh"

using namespace acx::fx;

constexpr int kFxSpecWarps = 4;

// a warp's shared words: the spectrum (yLen) and the zero runs (yLen int32)
__host__ __device__ inline int spec_smem_words(int yLen) { return yLen + (yLen + 1) / 2; }

__global__ void fx_spec_decode_kernel(const int32_t* __restrict__ x,
                                      const int32_t* __restrict__ res,
                                      const int32_t* __restrict__ side,
                                      const int32_t* __restrict__ tidx,
                                      const i64* __restrict__ scf, const i64* __restrict__ scf_e,
                                      const i64* __restrict__ tab, i64* __restrict__ out,
                                      i64* __restrict__ x_e, int L, SpecGeom g) {
  extern __shared__ i64 smem[];
  const int wi = threadIdx.x >> 5;
  const int l = blockIdx.x * kFxSpecWarps + wi;
  if (l >= L) return;            // whole warps leave together
  i64* xs = smem + wi * spec_smem_words(g.yLen);
  int32_t* run = reinterpret_cast<int32_t*>(xs + g.yLen);
  const Warp w{static_cast<int>(threadIdx.x & 31)};
  const size_t ls = static_cast<size_t>(l);
  fx_spec_decode_lane(w, x + ls * g.yLen, res + ls * g.R, side + ls * kSpecSideWords,
                      tidx + ls * 16, scf + ls * g.n_bands, scf_e + ls * g.n_bands, tab, g, xs,
                      run, out + ls * g.N, x_e + ls);
}

extern "C" int acx_fx_spec_decode(const void* x, const void* res, const void* side,
                                  const void* tidx, const void* scf, const void* scf_e,
                                  const void* tab, void* out, void* x_e, int L, int yLen, int N,
                                  int n_bands, int frame_dms, int gg_off, int R, void* stream) {
  const SpecGeom g{yLen, N, n_bands, frame_dms, gg_off, R};
  const size_t smem = static_cast<size_t>(kFxSpecWarps) * spec_smem_words(yLen) * sizeof(i64);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        fx_spec_decode_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const int blocks = (L + kFxSpecWarps - 1) / kFxSpecWarps;
  fx_spec_decode_kernel<<<blocks, 32 * kFxSpecWarps, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(x), static_cast<const int32_t*>(res),
      static_cast<const int32_t*>(side), static_cast<const int32_t*>(tidx),
      static_cast<const i64*>(scf), static_cast<const i64*>(scf_e), static_cast<const i64*>(tab),
      static_cast<i64*>(out), static_cast<i64*>(x_e), L, g);
  return static_cast<int>(cudaGetLastError());
}
