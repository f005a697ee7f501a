// fx_sns_dec: the fixed-point decoder's SNS decode (K20a).
//
// Replaces audio_codec_tpu/ops/fixed_dev.py:sns_decode_scf (:525, with
// _mpvq_deindex_batch :456 in four configurations, isqrt16 :345, shl16v :331,
// idct16 :373) and sns_interpolate (:269, inv_log2_16 :256):
// processSnsQuantizeScfDecoder_fx and processSnsInterpolateScf_fx
// (sns_quantize_scf_fx.c:552-574, sns_interpolate_scf_fx.c). [L, 7] side
// indices -> the bands' scale factors [L, n_bands] Word16 and exponents, L =
// T x B frames of a block.
//
// Bound on an H100: 28 bytes in and 1 KB out a frame (L = 16384: 17 MB,
// 5 us at 3.35 TB/s); about 1 000 warp instructions a frame.
// Design: a warp a frame (fx_sns_dec.cuh:fx_sns_dec_warp), blocks of
// kFxSnsWarps warps, every value 32-bit: the de-index one chain of a ballot
// and a shuffle a position over the MPVQ offsets table, the idct on every
// lane, the 64 bands in the warp's shared words, each output row one
// coalesced store. The tables are read through L1.
#include "fx_sns_dec.cuh"

using namespace acx;
using namespace acx::fx;

constexpr int kFxSnsWarps = 4;

__global__ void __launch_bounds__(32 * kFxSnsWarps)
    fx_sns_dec_kernel(const int32_t* __restrict__ idx, const int32_t* __restrict__ tab,
                      i64* __restrict__ scf, i64* __restrict__ scf_e, int L, int n_bands) {
  __shared__ int32_t bands[kFxSnsWarps][64];
  const int wid = threadIdx.x >> 5;
  const int l = blockIdx.x * kFxSnsWarps + wid;
  if (l >= L) return;
  const size_t row = static_cast<size_t>(l) * n_bands;
  fx_sns_dec_warp(CoderCardWarp{static_cast<int>(threadIdx.x & 31)},
                  idx + 7 * static_cast<size_t>(l), tab, n_bands, bands[wid], scf + row,
                  scf_e + row);
}

extern "C" int acx_fx_sns_dec(const void* idx, const void* tab, void* scf, void* scf_e, int L,
                              int n_bands, void* stream) {
  const int blocks = (L + kFxSnsWarps - 1) / kFxSnsWarps;
  fx_sns_dec_kernel<<<blocks, 32 * kFxSnsWarps, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(idx), static_cast<const int32_t*>(tab), static_cast<i64*>(scf),
      static_cast<i64*>(scf_e), L, n_bands);
  return static_cast<int>(cudaGetLastError());
}
