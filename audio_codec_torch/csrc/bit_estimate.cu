// bit_estimate: the context-model bit count of a quantized spectrum.
//
// Replaces audio_codec_tpu/ops/quant.py:bit_estimate (quant.py:135, the
// lax.scan over 2-tuples at :219), processQuantizeSpec_fl in
// quantize_spec.c:78-168. Outputs nbits, nbits2, lastnz, lastnz2, lsbMode.
//
// Bound on an H100: the bytes are one read of xq (B x N x 4) and five int32
// outputs, about 3.3 MB at B = 2048 and N = 400, or 1 us at 3.35 TB/s.
// Design (bit_estimate.cuh): the tuple context is a window of two tuples,
// not a chain, so a warp takes a stream and each lane a run of ceil(N/64)
// tuples; a warp scan of the lanes' int32 sums gives every running count,
// warp maxima lastnz and lastnz2. Eight streams a block (2048 streams: 256
// blocks, every SM busy in one wave). The row is staged in shared memory
// with coalesced loads. The 4096-entry lookup and the [64,17] bit table are
// read from global memory through L1: staging them in shared memory once a
// block measured slower (tools/torch_coder_times.py --tables).
#include "bit_estimate.cuh"

using namespace acx;

#ifdef __CUDACC__
constexpr int kBitEstWarps = 8;   // streams a block

__global__ void __launch_bounds__(kBitEstWarps * 32)
    bit_estimate_kernel(const int32_t* __restrict__ xq, const int32_t* __restrict__ target,
                        int32_t* __restrict__ out, const int32_t* __restrict__ lookup,
                        const int32_t* __restrict__ bits_tab, int B, int N, int mode,
                        int rate_flag, int max_lev) {
  extern __shared__ int32_t rows[];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int s = blockIdx.x * kBitEstWarps + warp;
  if (s >= B) return;   // the whole warp leaves together
  int32_t* row = rows + static_cast<size_t>(warp) * N;
  const int32_t* g = xq + static_cast<size_t>(s) * N;
  for (int i = lane; i < N; i += 32) row[i] = g[i];
  __syncwarp();
  const CoderCardWarp w{lane};
  bit_estimate_warp(w, row, N, target[s], mode, rate_flag, max_lev, lookup, bits_tab, out + s, B);
}

extern "C" int acx_bit_estimate(const void* xq, const void* target, void* out,
                                const void* lookup, const void* bits_tab, int B, int N,
                                int mode, int rate_flag, int max_lev, void* stream) {
  if (B == 0) return static_cast<int>(cudaSuccess);
  if (N > 2 * kCoderLanes * kBitEstMaxRun) return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = static_cast<size_t>(kBitEstWarps) * N * sizeof(int32_t);
  const int blocks = (B + kBitEstWarps - 1) / kBitEstWarps;
  bit_estimate_kernel<<<blocks, kBitEstWarps * 32, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(xq), static_cast<const int32_t*>(target),
      static_cast<int32_t*>(out), static_cast<const int32_t*>(lookup),
      static_cast<const int32_t*>(bits_tab), B, N, mode, rate_flag, max_lev);
  return static_cast<int>(cudaGetLastError());
}
#endif
