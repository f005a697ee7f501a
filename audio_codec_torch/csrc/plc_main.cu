// plc_main: the standard concealment (plc_mode 0) of one frame of B streams,
// with the concealment's counter update fused after it.
//
// Replaces audio_codec_tpu/ops/plc.py: plc_main (:64) with
// noise_substitution (:41) and plc_update (:80), which the reference decoder
// runs on every frame (models/decoder.py:137, :157): a [B, 400] int64
// generator for every stream, clean ones included, and about twenty
// [B, 400]-wide operations (processPlcMain_fl, plc_main.c:13-53;
// processNoiseSubstitution0_fl, plc_noise_substitution0.c:14-46;
// processPlcUpdate_fl, plc_update.c:13-30). The update reads only bfi and
// plc_main's outputs, and nothing between the two calls reads the counters
// at plc_mode 0.
//
// Bound on an H100: the bytes. A stream reads one row (its spectrum, or on a
// lost frame the history) and writes two (the spectrum and the history) and
// five scalars: 4.8 KB a stream, 9.8 MB at B = 2048, 0.0029 ms at 3.35 TB/s.
// Design: a warp a stream, four warps a block, lane l on the bins l, l + 32,
// ... (13 a lane at N = 400). Lane 0 computes the stream's scalars (the
// counter, the damping and the seed after the frame, plc_main.cuh) and
// broadcasts them with __shfl_sync; the generator's closed form is staged in
// shared memory once a block from a table cached on the device. The float
// operation is one product a bin, rounded as the plain version rounds it, so
// the two agree bit for bit.
#include "plc_main.cuh"

using namespace acx;

#ifdef __CUDACC__
constexpr int kPlcMainWarps = 4;
constexpr unsigned kFullMask = 0xffffffffu;

__global__ void plc_main_kernel(const float* __restrict__ spec, const float* __restrict__ q_prev,
                                const int32_t* __restrict__ bfi,
                                const int32_t* __restrict__ nb_lost,
                                const float* __restrict__ cum_alpha,
                                const int32_t* __restrict__ seed,
                                const int32_t* __restrict__ lcg, float* __restrict__ spec_out,
                                float* __restrict__ q_out, int32_t* __restrict__ nb_out,
                                float* __restrict__ cum_out, int32_t* __restrict__ seed_out,
                                int B, int N) {
  __shared__ int32_t lcg_s[2 * (kPlcMainMaxN + 1)];
  for (int i = threadIdx.x; i < 2 * (N + 1); i += blockDim.x) lcg_s[i] = lcg[i];
  __syncthreads();
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int b = blockIdx.x * kPlcMainWarps + warp;
  if (b >= B) return;   // the whole warp leaves together
  PlcMainScalars s{};
  if (lane == 0) {
    s = plc_main_scalars(bfi[b], nb_lost[b], cum_alpha[b], seed[b], lcg_s, N);
    nb_out[b] = s.nb_lost;
    cum_out[b] = s.cum;
    seed_out[b] = s.seed;
  }
  s.lost = __shfl_sync(kFullMask, s.lost, 0);
  s.cum = __shfl_sync(kFullMask, s.cum, 0);
  s.u0 = __shfl_sync(kFullMask, s.u0, 0);
  const size_t row = static_cast<size_t>(b) * N;
  for (int k = lane; k < N; k += 32) {
    // a lost frame reads only the history, a kept one only its spectrum
    const float v = s.lost ? 0.0f : spec[row + k];
    const float q = s.lost ? q_prev[row + k] : 0.0f;
    plc_main_bin(s, k, v, q, lcg_s, N, spec_out + row + k, q_out + row + k);
  }
}

extern "C" int acx_plc_main(const void* spec, const void* q_prev, const void* bfi,
                            const void* nb_lost, const void* cum_alpha, const void* seed,
                            const void* lcg, void* spec_out, void* q_out, void* nb_out,
                            void* cum_out, void* seed_out, int B, int N, void* stream) {
  if (N > kPlcMainMaxN || N < 1) return static_cast<int>(cudaErrorInvalidValue);
  if (B == 0) return static_cast<int>(cudaSuccess);
  const int blocks = (B + kPlcMainWarps - 1) / kPlcMainWarps;
  plc_main_kernel<<<blocks, 32 * kPlcMainWarps, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(spec), static_cast<const float*>(q_prev),
      static_cast<const int32_t*>(bfi), static_cast<const int32_t*>(nb_lost),
      static_cast<const float*>(cum_alpha), static_cast<const int32_t*>(seed),
      static_cast<const int32_t*>(lcg), static_cast<float*>(spec_out),
      static_cast<float*>(q_out), static_cast<int32_t*>(nb_out), static_cast<float*>(cum_out),
      static_cast<int32_t*>(seed_out), B, N);
  return static_cast<int>(cudaGetLastError());
}
#endif
