// hp50_biquad: the 50 Hz high-pass biquad of the 12.8 kHz resampler.
//
// Replaces the lax.scan of audio_codec_tpu/ops/analysis.py:resample_12k8
// (hp_step at analysis.py:50-55, scanned at :57; resamp12k8.c:13-84): a
// transposed direct-form-II biquad over the frame's resampled samples, its
// two memories carried from frame to frame. The dense resampling product
// before it stays torch.matmul (ops/analysis.py). Plain version:
// ops/analysis.py:hp50_biquad_plain.
//
// Bound on an H100: the bytes are the input and output rows (B x N x 4
// each) and the memories, 2.1 MB at B = 2048 and N = 128, 0.64 us at
// 3.35 TB/s. Each output feeds the next step's memories: a chain of N
// steps a stream whose dependent path is an add, a product and an add
// (about 12 cycles), so 128 steps take about 1 us. A stream's chain cannot
// be split across lanes without changing the rounding, so the kernel's time
// is one memory round trip in, the chain, and one out.
// Design: one thread a stream. With N a template parameter (the frame
// lengths 2.5, 5, 7.5 and 10 ms give N = 32, 64, 96, 128) the thread loads
// its whole row into registers with 16-byte loads, all in flight at once,
// runs the chain on registers and stores the row with 16-byte stores: no
// shared memory, no index arithmetic in the loop. Blocks of kHpThreads = 16
// threads, so B = 2048 streams make 128 blocks, one on nearly every SM. Any
// other N, or rows not 16-byte aligned, take the general loop (one thread a
// stream, 4-byte loads). Every product and sum is rounded on its own, in the
// plain version's order, so the two agree bit for bit.
#include "acodec.cuh"

using namespace acx;

namespace acx {

struct Hp50Coefs {
  float b0, b1, b2, a1, a2;
};

// One step of the biquad: x in, y out, the memories (u1, u2) updated.
ACX_HD float hp50_step(float& u1, float& u2, float xt, const Hp50Coefs& c) {
  const float y = radd(rmul(c.b0, xt), u1);
  const float u1n = radd(rmul(-c.a1, y), radd(rmul(c.b1, xt), u2));
  const float u2n = radd(rmul(c.b2, xt), -rmul(c.a2, y));
  u1 = u1n;
  u2 = u2n;
  return y;
}

// One stream, in place on x [N] (stride 1). mem [2] in, new memories out.
ACX_HD void hp50_lane(float* x, int N, float* mem, const Hp50Coefs& c) {
  float u1 = mem[0], u2 = mem[1];
  for (int n = 0; n < N; ++n) x[n] = hp50_step(u1, u2, x[n], c);
  mem[0] = u1;
  mem[1] = u2;
}

}  // namespace acx

#ifdef __CUDACC__
constexpr int kHpThreads = 16;

// N > 0: the row in registers, 16-byte loads and stores; N == 0: the general
// loop over n rows.
template <int N>
__global__ void __launch_bounds__(64) hp50_biquad_kernel(const float* __restrict__ x,
                                                         const float* __restrict__ mem,
                                                         float* __restrict__ y,
                                                         float* __restrict__ mem_out, int B,
                                                         int n, Hp50Coefs c) {
  const int s = blockIdx.x * blockDim.x + threadIdx.x;
  if (s >= B) return;
  float u1 = mem[2 * s], u2 = mem[2 * s + 1];
  if constexpr (N > 0) {
    const float4* xs = reinterpret_cast<const float4*>(x + static_cast<size_t>(s) * N);
    float4* ys = reinterpret_cast<float4*>(y + static_cast<size_t>(s) * N);
    float v[N];
#pragma unroll
    for (int q = 0; q < N / 4; ++q) {
      const float4 t = __ldg(xs + q);
      v[4 * q] = t.x;
      v[4 * q + 1] = t.y;
      v[4 * q + 2] = t.z;
      v[4 * q + 3] = t.w;
    }
#pragma unroll
    for (int k = 0; k < N; ++k) v[k] = hp50_step(u1, u2, v[k], c);
#pragma unroll
    for (int q = 0; q < N / 4; ++q)
      ys[q] = make_float4(v[4 * q], v[4 * q + 1], v[4 * q + 2], v[4 * q + 3]);
  } else {
    const float* xs = x + static_cast<size_t>(s) * n;
    float* ys = y + static_cast<size_t>(s) * n;
    for (int k = 0; k < n; ++k) ys[k] = hp50_step(u1, u2, __ldg(xs + k), c);
  }
  mem_out[2 * s] = u1;
  mem_out[2 * s + 1] = u2;
}

template <int N>
static void hp50_launch(const float* x, const float* mem, float* y, float* mem_out, int B, int n,
                        Hp50Coefs c, cudaStream_t st) {
  hp50_biquad_kernel<N><<<(B + kHpThreads - 1) / kHpThreads, kHpThreads, 0, st>>>(
      x, mem, y, mem_out, B, n, c);
}

// The launch for N (the register path where N is one of the template
// lengths and both rows are 16-byte aligned, else the general loop).
static void hp50_dispatch(const float* x, const float* mem, float* y, float* mem_out, int B,
                          int N, Hp50Coefs c, cudaStream_t st) {
  const uintptr_t ends = reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(y);
  const bool aligned = (ends & 15) == 0;
  if (aligned && N == 128) return hp50_launch<128>(x, mem, y, mem_out, B, N, c, st);
  if (aligned && N == 96) return hp50_launch<96>(x, mem, y, mem_out, B, N, c, st);
  if (aligned && N == 64) return hp50_launch<64>(x, mem, y, mem_out, B, N, c, st);
  if (aligned && N == 32) return hp50_launch<32>(x, mem, y, mem_out, B, N, c, st);
  hp50_launch<0>(x, mem, y, mem_out, B, N, c, st);
}

extern "C" int acx_hp50_biquad(const void* x, const void* mem, void* y, void* mem_out, int B,
                               int N, float b0, float b1, float b2, float a1, float a2,
                               void* stream) {
  if (B == 0) return static_cast<int>(cudaSuccess);
  hp50_dispatch(static_cast<const float*>(x), static_cast<const float*>(mem),
                static_cast<float*>(y), static_cast<float*>(mem_out), B, N,
                Hp50Coefs{b0, b1, b2, a1, a2}, static_cast<cudaStream_t>(stream));
  return static_cast<int>(cudaGetLastError());
}
#endif
