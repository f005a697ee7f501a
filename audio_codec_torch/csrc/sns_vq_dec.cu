// sns_vq_dec: the decoder of the SNS vector quantizer.
//
// Replaces audio_codec_tpu/ops/sns.py:quantize_scf_dec (sns.py:311, with the
// MPVQ de-indexing pvq_dec at :181; process_snsQuantizesScf_Dec), which
// de-indexes all four pulse shapes for every stream and selects, because a
// tensor program cannot branch per stream. A thread de-indexes the one shape
// its submode names, normalises it to unit energy, applies the 16-point
// inverse DCT-II and the submode's gain, and adds the stage-1 codebook
// vectors.
//
// Bound on an H100: per stream a chain of 10 to 16 de-indexing steps (each
// up to 11 table compares) and 256 multiply-adds; the bytes are 7 int32 in
// and 16 floats out per stream, 188 KB at B = 2048, under 0.1 us at
// 3.35 TB/s. The operations bound it, far below the launch.
// Design: one thread per stream, the tables (4 KB) in shared memory, pulses
// and vectors in registers. The float order is the plain version's
// (sns_vq.cuh), so the two agree bit for bit; for the DCT-II and the gain
// that is the reference's (XLA:CPU's) order, four fused chains and a fused
// multiply-add, so that the card's scale factors equal the CPU port's.
#include "sns_vq.cuh"

using namespace acx;

#ifdef __CUDACC__
constexpr int kSnsDecThreads = 64;

__global__ void sns_vq_dec_kernel(const int32_t* __restrict__ scf_idx,
                                  const int32_t* __restrict__ tables,
                                  float* __restrict__ scf_q, int B) {
  __shared__ int32_t tab[kSnsTableWords];
  acx_load_shared(tab, tables, kSnsTableWords);
  __syncthreads();
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= B) return;
  int idx[7];
#pragma unroll
  for (int k = 0; k < 7; ++k) idx[k] = scf_idx[7 * b + k];
  float q[kSnsM];
  sns_vq_dec_lane(idx, sns_tables(tab), q);
#pragma unroll
  for (int i = 0; i < kSnsM; ++i) scf_q[kSnsM * b + i] = q[i];
}

extern "C" int acx_sns_vq_dec(const void* scf_idx, const void* tables, void* scf_q, int B,
                              void* stream) {
  const int blocks = (B + kSnsDecThreads - 1) / kSnsDecThreads;
  sns_vq_dec_kernel<<<blocks, kSnsDecThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(scf_idx), static_cast<const int32_t*>(tables),
      static_cast<float*>(scf_q), B);
  return static_cast<int>(cudaGetLastError());
}
#endif
