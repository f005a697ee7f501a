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
// Design: a warp a stream (plc_damp.cuh:damp_warp), blocks of four warps; a
// stream whose spectrum passes through copies it with 16-byte loads and
// stores; the others hold the row and its generator jumps in registers,
// stage the energy terms at a padded stride for the windows of 32 (no bank
// conflict) and add the window sums by shuffles. The per-stream vectors are
// read as the wrapper hands them over (plc.cuh:StreamVec). The float order
// is the plain version's, so the two agree bit for bit.
#include "plc_damp.cuh"

using namespace acx;

#ifdef __CUDACC__
constexpr int kDampWarps = 4;

struct DampVecs {
  StreamVec v[kDampVecs];
};

__global__ void plc_damp_kernel(const float* __restrict__ x, const float* __restrict__ q,
                                DampVecs v, const int32_t* __restrict__ pows,
                                float* __restrict__ spec, float* __restrict__ fout,
                                int32_t* __restrict__ iout, int B, int N) {
  __shared__ DampWork work[kDampWarps];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int b = blockIdx.x * kDampWarps + warp;
  if (b >= B) return;   // the whole warp leaves together
  const size_t row = static_cast<size_t>(b) * N;
  DampOut o;
  damp_warp(CoderCardWarp{lane}, damp_in(v.v, b), x + row, q + row, pows, N, &work[warp],
            spec + row, o);
  if (lane == 0) {
    fout[b] = o.st.cf;
    fout[B + b] = o.st.cs;
    fout[2 * B + b] = o.st.cfa;
    iout[b] = o.ns_seed;
    iout[B + b] = o.pc_seed;
  }
}

// vecs, meta: the per-stream vectors of damp_in and their (stride, type)
// pairs, in host memory
extern "C" int acx_plc_damp_scramble(const void* x, const void* q, const void* const* vecs,
                                     const int* meta, const void* pows, void* spec, void* fout,
                                     void* iout, int B, int N, int frame_dms, void* stream) {
  if (N > kDampMaxN || N < 2 || frame_dms != 100) return static_cast<int>(cudaErrorInvalidValue);
  if (B == 0) return static_cast<int>(cudaSuccess);
  DampVecs v;
  for (int i = 0; i < kDampVecs; ++i) v.v[i] = {vecs[i], meta[2 * i], meta[2 * i + 1]};
  const int blocks = (B + kDampWarps - 1) / kDampWarps;
  plc_damp_kernel<<<blocks, 32 * kDampWarps, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<const float*>(q), v,
      static_cast<const int32_t*>(pows), static_cast<float*>(spec), static_cast<float*>(fout),
      static_cast<int32_t*>(iout), B, N);
  return static_cast<int>(cudaGetLastError());
}
#endif
