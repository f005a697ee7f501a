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
// Bound on an H100: about 20 de-index steps of up to 12 offsets each, the
// 16-point idct and 64 interpolated bands a lane, all integer; the bytes are
// 28 in and 1 KB out a lane (L = 16384: 17 MB, 5 us at 3.35 TB/s). The
// per-lane chain is the bound.
// Design: one thread a lane (kFxSnsThreads a block). Only the lane's
// submode's de-index runs. The offsets h and the 64 interpolated bands,
// indexed at run time, live in shared memory (kSnsScratch words a thread);
// the pulses and the idct's values in registers, indexed statically.
#include "fx_sns_dec.cuh"

using namespace acx::fx;

constexpr int kFxSnsThreads = 64;

__global__ void fx_sns_dec_kernel(const int32_t* __restrict__ idx, const i64* __restrict__ tab,
                                  i64* __restrict__ scf, i64* __restrict__ scf_e, int L,
                                  int n_bands) {
  __shared__ i64 scratch[kFxSnsThreads * kSnsScratch];
  const int l = blockIdx.x * blockDim.x + threadIdx.x;
  if (l >= L) return;
  fx_sns_dec_lane(idx + 7 * static_cast<size_t>(l), tab, n_bands,
                  scratch + threadIdx.x * kSnsScratch, scf + static_cast<size_t>(l) * n_bands,
                  scf_e + static_cast<size_t>(l) * n_bands, 1);
}

extern "C" int acx_fx_sns_dec(const void* idx, const void* tab, void* scf, void* scf_e, int L,
                              int n_bands, void* stream) {
  const int blocks = (L + kFxSnsThreads - 1) / kFxSnsThreads;
  fx_sns_dec_kernel<<<blocks, kFxSnsThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(idx), static_cast<const i64*>(tab), static_cast<i64*>(scf),
      static_cast<i64*>(scf_e), L, n_bands);
  return static_cast<int>(cudaGetLastError());
}
