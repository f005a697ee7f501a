// plc_damp_scramble: noise substitution, damping and sign scrambling of the
// advanced concealment for one frame of B streams.
//
// Replaces audio_codec_tpu/ops/plc_adv.py: noise_substitution (:453) and
// damping_scrambling (:461, the per-bin generator _lcg16 :217 and its
// closed-form advance _lcg_pows :542), run twice by the reference decoder
// (models/decoder.py:263-279): on the lost lanes (bfi 1), then on the
// partially concealed ones (bfi 2). The reference computes both passes over
// every stream of every frame; here a clean stream copies its spectrum and
// its factors through and a lost or partially concealed one runs its pass.
//
// Bound on an H100: the bytes, the spectrum in and out and the last good one
// read (4.8 KB a stream, 9.8 MB at B = 2048, 2.9 us at 3.35 TB/s); a stream's
// work is 400 generator values, a 400-term sum and 400 multiply-adds.
// Design: a warp a stream, one block of four warps; the bins spread over the
// lanes, the generator in closed form (one table lookup a bin), the mean
// energy in the reference's windows of 32 (one lane a window). The float
// order is the plain version's (plc_damp.cuh), so the two agree bit for bit.
#include "plc_damp.cuh"

using namespace acx;

#ifdef __CUDACC__
constexpr int kDampWarps = 4;

__global__ void plc_damp_kernel(const float* __restrict__ x, const float* __restrict__ q,
                                const int32_t* __restrict__ ints, const float* __restrict__ floats,
                                const int32_t* __restrict__ pows, float* __restrict__ spec,
                                float* __restrict__ fout, int32_t* __restrict__ iout, int B, int N) {
  __shared__ DampWork work[kDampWarps];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int b = blockIdx.x * kDampWarps + warp;
  if (b >= B) return;   // the whole warp leaves together
  const CardWarp w{lane};
  int iv[10];
  float fv[4];
#pragma unroll
  for (int k = 0; k < 10; ++k) iv[k] = ints[k * B + b];
#pragma unroll
  for (int k = 0; k < 4; ++k) fv[k] = floats[k * B + b];
  float fo[3];
  int io[2];
  const size_t row = static_cast<size_t>(b) * N;
  damp_stream(w, x + row, q + row, iv, fv, pows, N, &work[warp], spec + row, fo, io);
  if (lane == 0) {
#pragma unroll
    for (int k = 0; k < 3; ++k) fout[k * B + b] = fo[k];
    iout[b] = io[0];
    iout[B + b] = io[1];
  }
}

extern "C" int acx_plc_damp_scramble(const void* x, const void* q, const void* ints,
                                     const void* floats, const void* pows, void* spec, void* fout,
                                     void* iout, int B, int N, int frame_dms, void* stream) {
  if (N > kDampMaxN || N < 2 || frame_dms != 100) return static_cast<int>(cudaErrorInvalidValue);
  if (B == 0) return static_cast<int>(cudaSuccess);
  const int blocks = (B + kDampWarps - 1) / kDampWarps;
  plc_damp_kernel<<<blocks, 32 * kDampWarps, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<const float*>(q),
      static_cast<const int32_t*>(ints), static_cast<const float*>(floats),
      static_cast<const int32_t*>(pows), static_cast<float*>(spec), static_cast<float*>(fout),
      static_cast<int32_t*>(iout), B, N);
  return static_cast<int>(cudaGetLastError());
}
#endif
