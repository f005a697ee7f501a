// sns_vq_dec: the decoder of the SNS vector quantizer.
//
// Replaces audio_codec_tpu/ops/sns.py:quantize_scf_dec (sns.py:311, with the
// MPVQ de-indexing pvq_dec at :181; process_snsQuantizesScf_Dec), which
// de-indexes all four pulse shapes for every stream and selects, because a
// tensor program cannot branch per stream. A warp de-indexes the one shape
// its submode names, normalises it to unit energy, applies the 16-point
// inverse DCT-II and the submode's gain, and adds the stage-1 codebook
// vectors.
//
// Bound on an H100: per stream a chain of 10 to 16 de-indexing steps (each
// up to 11 table compares) and 256 multiply-adds; the bytes are 7 int32 in
// and 16 floats out per stream, 188 KB at B = 2048, under 0.1 us at
// 3.35 TB/s. The operations bound it, far below the launch; what a stream
// waits for is its de-indexing chain.
// Design: a warp a stream (sns_vq.cuh:sns_vq_dec_warp), blocks of
// kSnsDecWarps streams, so that 2048 streams fill the card with 512 blocks:
// the de-indexing one uniform chain whose table compares run on lanes (a
// ballot and a popcount a position), then lane n output n of the DCT-II, its
// four chains and its gain. The tables (4 KB, a lane reading about 34 words
// of them) are read through L1, no staging. The float order is the plain
// version's (sns_vq.cuh), so the two agree bit for bit; for the DCT-II and
// the gain that is the reference's (XLA:CPU's) order, four fused chains and
// a fused multiply-add, so that the card's scale factors equal the CPU
// port's.
#include "sns_vq.cuh"

using namespace acx;

#ifdef __CUDACC__
constexpr int kSnsDecWarps = 4;   // streams a block

__global__ void __launch_bounds__(kSnsDecWarps * 32)
    sns_vq_dec_kernel(const int32_t* __restrict__ scf_idx, const int32_t* __restrict__ tables,
                      float* __restrict__ scf_q, int B) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int b = blockIdx.x * kSnsDecWarps + warp;
  if (b >= B) return;   // the whole warp leaves together
  sns_vq_dec_warp(CoderCardWarp{lane}, scf_idx + 7 * static_cast<size_t>(b), tables,
                  scf_q + kSnsM * static_cast<size_t>(b));
}

extern "C" int acx_sns_vq_dec(const void* scf_idx, const void* tables, void* scf_q, int B,
                              void* stream) {
  const int blocks = (B + kSnsDecWarps - 1) / kSnsDecWarps;
  sns_vq_dec_kernel<<<blocks, 32 * kSnsDecWarps, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(scf_idx), static_cast<const int32_t*>(tables),
      static_cast<float*>(scf_q), B);
  return static_cast<int>(cudaGetLastError());
}
#endif
