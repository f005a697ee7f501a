// sns_vq_enc: the encoder's search of the SNS vector quantizer.
//
// Replaces audio_codec_tpu/ops/sns.py:quantize_scf_enc (sns.py:214, with the
// pulse search pvq_subpyr_search at :94, its scan at :143, and the MPVQ
// indexing pvq_enc at :163; process_snsQuantizesScf_Enc): two 8-dim searches
// of 32-entry codebooks, a 16-point DCT-II of the residual, four pulse
// searches (10 pulses in 10 lanes, 1 in 6, 8 in 16, 6 in 16), 6 + 4 + 8 gain
// candidates, the choice of the shape with the least error, and its MPVQ
// index. As tensor code each pulse is a masked scan over the lanes of every
// stream; a thread runs the searches as plain loops on its own 16 floats and
// indexes only the shape it chose.
//
// Bound on an H100: about 7 000 dependent float operations per stream, most
// in the codebook searches (1 500), the four transforms (2 000) and the pulse
// loops (pulses left after the projection x lanes x 7); the bytes are 16
// floats in and 7 int32 + 16 floats out per stream, 319 KB at B = 2048, 0.1
// us at 3.35 TB/s. The operations bound it.
// Design: one thread per stream, the tables (4 KB) in shared memory, every
// vector in registers with static indices. The float order is the plain
// version's (sns_vq.cuh), so indices and scale factors agree bit for bit.
#include "sns_vq.cuh"

using namespace acx;

#ifdef __CUDACC__
constexpr int kSnsEncThreads = 32;

__global__ void sns_vq_enc_kernel(const float* __restrict__ scf,
                                  const int32_t* __restrict__ tables,
                                  int32_t* __restrict__ scf_idx, float* __restrict__ scf_q,
                                  int B) {
  __shared__ int32_t tab[kSnsTableWords];
  acx_load_shared(tab, tables, kSnsTableWords);
  __syncthreads();
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= B) return;
  float in[kSnsM], q[kSnsM];
  int idx[7];
#pragma unroll
  for (int i = 0; i < kSnsM; ++i) in[i] = scf[kSnsM * b + i];
  sns_vq_enc_lane(in, sns_tables(tab), idx, q);
#pragma unroll
  for (int k = 0; k < 7; ++k) scf_idx[7 * b + k] = idx[k];
#pragma unroll
  for (int i = 0; i < kSnsM; ++i) scf_q[kSnsM * b + i] = q[i];
}

extern "C" int acx_sns_vq_enc(const void* scf, const void* tables, void* scf_idx, void* scf_q,
                              int B, void* stream) {
  const int blocks = (B + kSnsEncThreads - 1) / kSnsEncThreads;
  sns_vq_enc_kernel<<<blocks, kSnsEncThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(scf), static_cast<const int32_t*>(tables),
      static_cast<int32_t*>(scf_idx), static_cast<float*>(scf_q), B);
  return static_cast<int>(cudaGetLastError());
}
#endif
