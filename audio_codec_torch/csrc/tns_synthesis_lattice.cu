// tns_synthesis_lattice: the decoder's inverse TNS lattice over the bins.
//
// Replaces the lax.scan of audio_codec_tpu/ops/tns.py:tns_decode (the step
// at tns.py:256-273, scanned at :276; processTnsDecoder_fl,
// tns_decoder.c:13-51): the all-pole lattice of order 1..8 that undoes the
// encoder's filter, its 8-lane state carried from bin to bin and across the
// two filters' ranges. The coefficient lookup and the ranges stay tensor
// code (ops/tns.py).
//
// Bound on an H100: every bin depends on the state the previous bin left;
// the bytes are x and y (B x 400 x 4 each) plus the filters (B x 88 bytes),
// about 6.7 MB at B = 2048, 2 us at 3.35 TB/s. The recursion is the bound:
// along the wavefront below, tap el of bin n waits for tap el-1 of bin
// n-1, which waits for tap el of bin n-1, so a bin costs two dependent
// steps of a shuffle and two xfma_d.
// Design (tns_lattice.cuh): a tap a lane, 8 lanes a stream, 4 streams a
// warp (512 warps at B = 2048, one on each scheduler of 128 SMs); lane el
// runs bin n at step 2n + (7 - el), over the hull of the stream's filter
// ranges only (y = x outside it), and passes the chains down and its state
// update up one lane a step by __shfl_down_sync / __shfl_up_sync. The
// state, the chains and the coefficients are doubles that hold float
// values, rounded by xfma_d (no conversion in the chain). The warp stages
// its 4 rows in shared memory, filters them in place (lane 7 reads x at
// step 2n, lane 0 writes y at step 2n + 7) and stores them coalesced. A
// lane whose step it is not skips it; a tap whose rounding leaves the fast
// range (tns_lattice.cuh) is taken again with the tested rounding.
// The taps keep the plain version's contraction, XLA:CPU's on every device
// (ops/tns.py:tns_synthesis_lattice_plain): state lanes 5-7 on a second
// chain whose first product is contracted, the main chain's first product
// rounded on its own unless B = 1. So the card's TNS decode equals the CPU
// port's, and the kernel its plain version, bit for bit.
#include "tns_lattice.cuh"

using namespace acx;

#ifdef __CUDACC__
constexpr int kSynWarps = 4;                       // warps a block
constexpr int kSynRows = 32 / kTnsLags;            // streams a warp
constexpr unsigned kFull = 0xFFFFFFFFu;

__global__ void __launch_bounds__(kSynWarps * 32)
    tns_synthesis_lattice_kernel(const float* __restrict__ x, const float* __restrict__ rc,
                                 const int32_t* __restrict__ order, const int32_t* __restrict__ lo,
                                 const int32_t* __restrict__ hi, float* __restrict__ y, int B,
                                 int N) {
  extern __shared__ float tile[];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int row0 = (blockIdx.x * kSynWarps + warp) * kSynRows;
  if (row0 >= B) return;   // the whole warp leaves together
  const int rows = imin(kSynRows, B - row0);
  float* t = tile + static_cast<size_t>(warp) * kSynRows * N;
  const float* xg = x + static_cast<size_t>(row0) * N;
  for (int i = lane; i < rows * N; i += 32) t[i] = xg[i];
  __syncwarp();

  const int g = lane / kTnsLags, el = lane % kTnsLags;
  const int b = row0 + imin(g, rows - 1);   // a group past the last row repeats it, writes nothing
  const TnsStream s = tns_stream(order + 2 * static_cast<size_t>(b), lo + 2 * static_cast<size_t>(b),
                                 hi + 2 * static_cast<size_t>(b), N);
  const int len = g < rows ? s.b - s.a + 1 : 0;
  const double r0 = rc[static_cast<size_t>(b) * 2 * kTnsLags + el];
  const double r1 = rc[static_cast<size_t>(b) * 2 * kTnsLags + kTnsLags + el];
  const int steps = __reduce_max_sync(kFull, tns_wave_steps(len));
  float* row = t + g * N;
  TnsWaveLane L = {0.0, 0.0, 0.0, 0.0, false};
  const bool fused_first = B == 1;
  for (int step = 0; step < steps; ++step) {
    const double s_in = __shfl_down_sync(kFull, L.s, 1);
    const double sf_in = __shfl_down_sync(kFull, L.sf, 1);
    const double u_in = __shfl_up_sync(kFull, L.upd, 1);
    tns_synthesis_step(L, step, el, row, s, len, r0, r1, s_in, sf_in, u_in, fused_first);
  }
  __syncwarp();
  float* yg = y + static_cast<size_t>(row0) * N;
  for (int i = lane; i < rows * N; i += 32) yg[i] = t[i];
}

extern "C" int acx_tns_synthesis_lattice(const void* x, const void* rc, const void* order,
                                         const void* lo, const void* hi, void* y, int B, int N,
                                         void* stream) {
  if (B == 0 || N == 0) return static_cast<int>(cudaSuccess);
  const size_t smem = static_cast<size_t>(kSynWarps) * kSynRows * N * sizeof(float);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        tns_synthesis_lattice_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const int per_block = kSynWarps * kSynRows;
  const int blocks = (B + per_block - 1) / per_block;
  tns_synthesis_lattice_kernel<<<blocks, kSynWarps * 32, smem,
                                 static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<const float*>(rc),
      static_cast<const int32_t*>(order), static_cast<const int32_t*>(lo),
      static_cast<const int32_t*>(hi), static_cast<float*>(y), B, N);
  return static_cast<int>(cudaGetLastError());
}
#endif
