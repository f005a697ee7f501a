// sns_vq_enc: the encoder's search of the SNS vector quantizer.
//
// Replaces audio_codec_tpu/ops/sns.py:quantize_scf_enc (sns.py:214, with the
// pulse search pvq_subpyr_search at :94, its scan at :143, and the MPVQ
// indexing pvq_enc at :163; process_snsQuantizesScf_Enc): two 8-dim searches
// of 32-entry codebooks, a 16-point DCT-II of the residual, four pulse
// searches (10 pulses in 10 lanes, 1 in 6, 8 in 16, 6 in 16), 6 + 4 + 8 gain
// candidates, the choice of the shape with the least error, and its MPVQ
// index. As tensor code each pulse is a masked scan over the lanes of every
// stream.
//
// Bound on an H100: about 7 000 float operations per stream, most in the
// codebook searches (1 500), the four transforms (2 000) and the pulse
// loops (pulses left after the projection x lanes x 7); the bytes are 16
// floats in and 7 int32 + 16 floats out per stream, 319 KB at B = 2048, 0.1
// us at 3.35 TB/s. The operations bound it; what a stream waits for is its
// chains: a pulse's 16-position scan, a 16-term product or error.
// Design: a warp a stream (sns_vq_enc.cuh:sns_vq_enc_warp): the codebook
// entries, the transforms' outputs and the gain candidates a lane each with
// first-argmin trees of shuffles, the four pulse searches at once on four
// groups of 8 lanes, each group's scan in position order. Blocks of
// kSnsEncWarps streams stage the tables (4 KB, and the DCT-II matrix
// transposed) in shared memory, every thread's loads issued before its
// stores (acodec.cuh:acx_load_shared). The float order is the plain
// version's, so indices and scale factors agree bit for bit.
#include "sns_vq_enc.cuh"

using namespace acx;

#ifdef __CUDACC__
constexpr int kSnsEncWarps = 4;   // streams a block
constexpr int kSnsEncThreads = 32 * kSnsEncWarps;

__global__ void __launch_bounds__(kSnsEncThreads)
    sns_vq_enc_kernel(const float* __restrict__ scf, const int32_t* __restrict__ tables,
                      int32_t* __restrict__ scf_idx, float* __restrict__ scf_q, int B) {
  __shared__ alignas(16) int32_t tab[kSnsTableWords];
  __shared__ float d2t[kSnsM * kSnsM];
  __shared__ SnsEncScratch scratch[kSnsEncWarps];
  constexpr int kD2Round = (kSnsM * kSnsM + kSnsEncThreads - 1) / kSnsEncThreads;
  float d2[kD2Round];
#pragma unroll
  for (int u = 0; u < kD2Round; ++u) {
    const int i = threadIdx.x + u * kSnsEncThreads;   // d2t[k][n] = D2[n][k], i = 16 k + n
    d2[u] = i < kSnsM * kSnsM
                ? __int_as_float(__ldg(tables + kOffD2 + (i % kSnsM) * kSnsM + i / kSnsM))
                : 0.0f;
  }
  acx_load_shared(tab, tables, kSnsTableWords);
#pragma unroll
  for (int u = 0; u < kD2Round; ++u) {
    const int i = threadIdx.x + u * kSnsEncThreads;
    if (i < kSnsM * kSnsM) d2t[i] = d2[u];
  }
  __syncthreads();
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int b = blockIdx.x * kSnsEncWarps + warp;
  if (b >= B) return;   // the whole warp leaves together
  const SnsTables st = sns_tables(tab);
  const SnsEncTables t = {st.f, st.A, d2t};
  sns_vq_enc_warp(CoderCardWarp{lane}, scf + static_cast<size_t>(kSnsM) * b, t, scratch[warp],
                  scf_idx + static_cast<size_t>(7) * b, scf_q + static_cast<size_t>(kSnsM) * b);
}

extern "C" int acx_sns_vq_enc(const void* scf, const void* tables, void* scf_idx, void* scf_q,
                              int B, void* stream) {
  const int blocks = (B + kSnsEncWarps - 1) / kSnsEncWarps;
  sns_vq_enc_kernel<<<blocks, kSnsEncThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(scf), static_cast<const int32_t*>(tables),
      static_cast<int32_t*>(scf_idx), static_cast<float*>(scf_q), B);
  return static_cast<int>(cudaGetLastError());
}
#endif
