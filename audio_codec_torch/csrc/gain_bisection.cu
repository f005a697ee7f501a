// gain_bisection: the bisection of the encoder's global-gain estimate.
//
// Replaces the 8 x (lg/4)-step loop of audio_codec_tpu/ops/quant.py:
// estimate_global_gain (quant.py:93-110, the lax.scan at :108;
// estimate_global_gain.c:102-125). Eight halvings of the offset; each walks
// the block energies en[j] backward, accumulating ener in float32 with the
// reference's gap filling for quiet blocks (iszero), and keeps the halving
// where the energy passes the target.
//
// Bound on an H100: each halving is a chain of lg/4 = 100 dependent float
// adds per stream, 800 in all; the bytes are en read once (B x 100 x 4) and
// one int32 out, about 0.8 MB at B = 2048, a quarter of a microsecond at
// 3.35 TB/s. The chain is the bound.
// Design: one thread per stream; a block stages its streams' en rows in
// shared memory with coalesced loads (the eight passes re-read them there),
// and keeps ener, iszero and the offset in registers. Every sum is rounded
// on its own (radd/rsub/rmul), as the plain version's PyTorch ops round them,
// so the two agree bit for bit.
#include "acodec.cuh"

using namespace acx;

// The reference's float32 thresholds: tmp < 7*(28/20), the gap 2.7*(28/20),
// tmp > 50*(28/20) (quant.py:99-101).
constexpr float kLow = 9.8f;
constexpr float kGap = 3.78f;
constexpr float kHigh = 70.0f;

// One stream: en [M] (stride 1), returns the final offset.
ACX_HD int gain_bisection_lane(const float* en, int M, float target, int offset) {
  int fac = 256;
  for (int it = 0; it < 8; ++it) {
    fac >>= 1;
    offset -= fac;
    const float offs_f = static_cast<float>(offset);
    float ener = 0.0f;
    bool iszero = true;
    for (int j = M - 1; j >= 0; --j) {
      const float t = rsub(en[j], offs_f);
      const bool low = t < kLow;
      const float add = low ? ((!iszero) ? kGap : 0.0f)
                            : (t >= kHigh ? rsub(rmul(2.0f, t), kHigh) : t);
      ener = radd(ener, add);
      iszero = iszero && low;
    }
    if (ener > target && !iszero) offset += fac;
  }
  return offset;
}

#ifdef __CUDACC__
constexpr int kGainThreads = 32;

__global__ void gain_bisection_kernel(const float* __restrict__ en,
                                      const float* __restrict__ target,
                                      int32_t* __restrict__ out, int B, int M, int offset0) {
  extern __shared__ float tile[];
  const int row0 = blockIdx.x * blockDim.x;
  const int rows = imin(static_cast<int>(blockDim.x), B - row0);
  acx_load_rows(tile, en, row0, rows, M);
  __syncthreads();
  if (static_cast<int>(threadIdx.x) >= rows) return;
  const int s = row0 + threadIdx.x;
  out[s] = gain_bisection_lane(tile + threadIdx.x * ACX_ROW_STRIDE(M), M, target[s], offset0);
}

extern "C" int acx_gain_bisection(const void* en, const void* target, void* out, int B, int M,
                                  int offset0, void* stream) {
  size_t smem = 0;
  cudaError_t err = acx_row_tiles_smem(gain_bisection_kernel, kGainThreads, M, &smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int blocks = (B + kGainThreads - 1) / kGainThreads;
  gain_bisection_kernel<<<blocks, kGainThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(en), static_cast<const float*>(target),
      static_cast<int32_t*>(out), B, M, offset0);
  return static_cast<int>(cudaGetLastError());
}
#endif
