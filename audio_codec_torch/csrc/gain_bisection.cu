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
// Design: a warp a stream with speculative halvings
// (gain_bisection.cuh:gain_bisection_warp): the 31 offsets halvings 1-5 may
// test on 31 lanes, a ballot and a walk of the decision tree, then the 7 of
// halvings 6-8 below the walked node, two chains a lane in all. A step's
// values are all computed, then selected, so that lanes testing other
// offsets never diverge (gain_bisection.cuh:gain_tests). Every lane reads
// en[j] at the same j, a broadcast from the row staged in shared memory with
// coalesced loads. Eight streams a block (256 blocks at 2048 streams, all
// resident in one wave). Every sum is rounded on its own (radd/rsub/rmul),
// as the plain version's PyTorch ops round them, so the two agree bit for
// bit.
#include "gain_bisection.cuh"

using namespace acx;

#ifdef __CUDACC__
constexpr int kGainWarps = 8;   // streams a block

__global__ void __launch_bounds__(kGainWarps * 32)
    gain_bisection_kernel(const float* __restrict__ en, const float* __restrict__ target,
                          int32_t* __restrict__ out, int B, int M, int offset0) {
  extern __shared__ float rows[];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int s = blockIdx.x * kGainWarps + warp;
  if (s >= B) return;   // the whole warp leaves together
  float* row = rows + static_cast<size_t>(warp) * M;
  const float* g = en + static_cast<size_t>(s) * M;
  for (int i = lane; i < M; i += 32) row[i] = g[i];
  __syncwarp();
  const int offset = gain_bisection_warp(CoderCardWarp{lane}, row, M, target[s], offset0);
  if (lane == 0) out[s] = offset;
}

extern "C" int acx_gain_bisection(const void* en, const void* target, void* out, int B, int M,
                                  int offset0, void* stream) {
  if (M < 1 || M > kGainMaxM) return static_cast<int>(cudaErrorInvalidValue);
  if (B == 0) return static_cast<int>(cudaSuccess);
  const size_t smem = static_cast<size_t>(kGainWarps) * M * sizeof(float);
  const int blocks = (B + kGainWarps - 1) / kGainWarps;
  gain_bisection_kernel<<<blocks, kGainWarps * 32, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(en), static_cast<const float*>(target),
      static_cast<int32_t*>(out), B, M, offset0);
  return static_cast<int>(cudaGetLastError());
}
#endif
