// hp50_biquad: the 50 Hz high-pass biquad of the 12.8 kHz resampler.
//
// Replaces the lax.scan of audio_codec_tpu/ops/analysis.py:resample_12k8
// (hp_step at analysis.py:50-55, scanned at :57; resamp12k8.c:13-84): a
// transposed direct-form-II biquad over the frame's 128 resampled samples,
// its two memories carried from frame to frame. The dense resampling product
// before it stays torch.matmul (ops/analysis.py).
//
// Bound on an H100: each output feeds the next step's memories, a chain of
// 128 dependent steps per stream (5 products, 4 sums each); the bytes are
// the input and output rows (B x 128 x 4 each) and the memories, about 2 MB
// at B = 2048, 0.6 us at 3.35 TB/s. The chain is the bound.
// Design: one thread per stream, the memories in registers; a block stages
// its rows in shared memory with coalesced copies and filters them in place.
// Every product and sum is rounded on its own, in the plain version's order,
// so the two agree bit for bit.
#include "acodec.cuh"

using namespace acx;

// One stream, in place on x [N] (stride 1). mem [2] in, new memories out.
ACX_HD void hp50_lane(float* x, int N, float* mem, float b0, float b1, float b2, float a1,
                      float a2) {
  float u1 = mem[0], u2 = mem[1];
  for (int n = 0; n < N; ++n) {
    const float xt = x[n];
    const float y = radd(rmul(b0, xt), u1);
    const float u1n = radd(rmul(-a1, y), radd(rmul(b1, xt), u2));
    const float u2n = radd(rmul(b2, xt), -rmul(a2, y));
    u1 = u1n;
    u2 = u2n;
    x[n] = y;
  }
  mem[0] = u1;
  mem[1] = u2;
}

#ifdef __CUDACC__
constexpr int kHpThreads = 32;

__global__ void hp50_biquad_kernel(const float* __restrict__ x, const float* __restrict__ mem,
                                   float* __restrict__ y, float* __restrict__ mem_out, int B,
                                   int N, float b0, float b1, float b2, float a1, float a2) {
  extern __shared__ float tile[];
  const int row0 = blockIdx.x * blockDim.x;
  const int rows = imin(static_cast<int>(blockDim.x), B - row0);
  acx_load_rows(tile, x, row0, rows, N);
  __syncthreads();
  const int t = threadIdx.x;
  if (t < rows) {
    const int s = row0 + t;
    float m[2] = {mem[2 * s], mem[2 * s + 1]};
    hp50_lane(tile + t * ACX_ROW_STRIDE(N), N, m, b0, b1, b2, a1, a2);
    mem_out[2 * s] = m[0];
    mem_out[2 * s + 1] = m[1];
  }
  __syncthreads();
  acx_store_rows(y, tile, row0, rows, N);
}

extern "C" int acx_hp50_biquad(const void* x, const void* mem, void* y, void* mem_out, int B,
                               int N, float b0, float b1, float b2, float a1, float a2,
                               void* stream) {
  size_t smem = 0;
  cudaError_t err = acx_row_tiles_smem(hp50_biquad_kernel, kHpThreads, N, &smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int blocks = (B + kHpThreads - 1) / kHpThreads;
  hp50_biquad_kernel<<<blocks, kHpThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<const float*>(mem), static_cast<float*>(y),
      static_cast<float*>(mem_out), B, N, b0, b1, b2, a1, a2);
  return static_cast<int>(cudaGetLastError());
}
#endif
