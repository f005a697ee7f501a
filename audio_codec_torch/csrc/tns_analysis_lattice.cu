// tns_analysis_lattice: the encoder's TNS lattice filter over the bins.
//
// Replaces the lax.scan of audio_codec_tpu/ops/tns.py:tns_encode (the
// lattice_step at tns.py:196-216, scanned at :219; tns_coder.c:330-360): an
// order-1..8 lattice whose 8-lane state carries from bin to bin and across
// the two filters' ranges. The filter analysis around it stays tensor code
// (ops/tns.py).
//
// Bound on an H100: the bytes are x and y (B x 480 x 4 each) plus the
// filters (B x 88 bytes), about 8 MB at B = 2048, 2.5 us at 3.35 TB/s; the
// work is at most 7 taps of two contracted products a bin.
// Design (tns_lattice.cuh): the lattice is an FIR filter, so a warp takes a
// stream and each of its 32 lanes a chunk of the hull of the filter ranges
// (15 bins at most at N = 480), run from 8 bins ahead from a zero state,
// which reaches the chunk with the sequential loop's states (2048 warps,
// about 16 an SM). A stream whose ranges leave a gap or nest filter 1
// inside filter 0 runs on lane 0 whole. The row is staged in shared memory,
// the outputs go to a second row there, and both are stored coalesced (y = x
// outside the hull). The state and coefficients are doubles that hold float
// values; the taps keep the plain version's contraction, XLA:CPU's on every
// device (ops/tns.py:tns_analysis_lattice_plain): every product contracted
// (xfma_d) but, for B > 1, the last tap's product into the output, rounded
// on its own. So the card's TNS encode equals the CPU port's, and the kernel
// its plain version, bit for bit.
#include "tns_lattice.cuh"

using namespace acx;

#ifdef __CUDACC__
constexpr int kAnaWarps = 4;   // warps (streams) a block

__global__ void __launch_bounds__(kAnaWarps * 32)
    tns_analysis_lattice_kernel(const float* __restrict__ x, const float* __restrict__ rc,
                                const int32_t* __restrict__ order, const int32_t* __restrict__ lo,
                                const int32_t* __restrict__ hi, float* __restrict__ y, int B,
                                int N) {
  extern __shared__ float rows[];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int b = blockIdx.x * kAnaWarps + warp;
  if (b >= B) return;   // the whole warp leaves together
  float* xs = rows + static_cast<size_t>(warp) * 2 * N;
  float* ys = xs + N;
  const float* xg = x + static_cast<size_t>(b) * N;
  for (int i = lane; i < N; i += 32) xs[i] = xg[i];
  const TnsStream s = tns_stream(order + 2 * static_cast<size_t>(b), lo + 2 * static_cast<size_t>(b),
                                 hi + 2 * static_cast<size_t>(b), N);
  double r[2 * kTnsLags];
#pragma unroll
  for (int k = 0; k < 2 * kTnsLags; ++k) r[k] = rc[static_cast<size_t>(b) * 2 * kTnsLags + k];
  __syncwarp();
  int w, c, e;
  tns_analysis_span(s, N, lane, w, c, e);
  tns_analysis_run(xs, ys, w, c, e, s, r, B == 1);
  __syncwarp();
  float* yg = y + static_cast<size_t>(b) * N;
  for (int i = lane; i < N; i += 32) yg[i] = tns_analysis_wrote(s, N, i) ? ys[i] : xs[i];
}

extern "C" int acx_tns_analysis_lattice(const void* x, const void* rc, const void* order,
                                        const void* lo, const void* hi, void* y, int B, int N,
                                        void* stream) {
  if (B == 0 || N == 0) return static_cast<int>(cudaSuccess);
  const size_t smem = static_cast<size_t>(kAnaWarps) * 2 * N * sizeof(float);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        tns_analysis_lattice_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const int blocks = (B + kAnaWarps - 1) / kAnaWarps;
  tns_analysis_lattice_kernel<<<blocks, kAnaWarps * 32, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<const float*>(rc),
      static_cast<const int32_t*>(order), static_cast<const int32_t*>(lo),
      static_cast<const int32_t*>(hi), static_cast<float*>(y), B, N);
  return static_cast<int>(cudaGetLastError());
}
#endif
