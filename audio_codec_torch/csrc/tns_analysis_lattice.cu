// tns_analysis_lattice: the encoder's TNS lattice filter over the bins.
//
// Replaces the lax.scan of audio_codec_tpu/ops/tns.py:tns_encode (the
// lattice_step at tns.py:196-216, scanned at :219; tns_coder.c:330-360): an
// order-1..8 lattice whose 8-lane state carries from bin to bin and across
// the two filters' ranges. The filter analysis around it stays tensor code
// (ops/tns.py).
//
// Bound on an H100: every bin depends on the state the previous bin left, a
// chain of N = 480 steps per stream of up to 7 lattice taps (4 dependent
// float ops each); the bytes are x and y (B x 480 x 4 each) plus the filters
// (B x 88 bytes), about 8 MB at B = 2048, 2.5 us at 3.35 TB/s. The chain is
// the bound.
// Design: one thread per stream; a block stages its streams' rows in shared
// memory with coalesced loads, filters them in place with the state, the
// coefficients and the orders in registers (the taps are unrolled, so the
// state never leaves registers), and stores them coalesced. Which filter a
// bin belongs to is computed from the ranges, not read from [B, N] masks.
// Every product and sum is rounded on its own, as the plain version's
// PyTorch ops on the card round them, so the two agree bit for bit. The last
// tap is step o-1 of the unrolled tap loop rather than a state lane picked
// by a runtime index: code for sm_90a that read and wrote st[last] through
// such an index was seen to read a stale lane where the order changes from
// one bin to the next (at the switch between the two filters).
#include "acodec.cuh"

using namespace acx;

constexpr int kLags = 8;

// One stream, in place on x [N] (stride 1). rc [2][8]; order, lo, hi [2]:
// filter f covers bins lo[f]..hi[f] where order[f] > 0; filter 1 wins.
ACX_HD void tns_analysis_lane(float* x, int N, const float* rc, const int* order,
                              const int* lo, const int* hi) {
  float st[kLags] = {0, 0, 0, 0, 0, 0, 0, 0};
  for (int n = 0; n < N; ++n) {
    const bool in1 = order[1] > 0 && n >= lo[1] && n <= hi[1];
    const bool in0 = order[0] > 0 && n >= lo[0] && n <= hi[0];
    if (!in0 && !in1) continue;                 // y = x, state kept
    // orders above 8 act as 8, as the plain version's clamped last tap does
    const int o = imin(in1 ? order[1] : order[0], kLags);
    const float* r = rc + (in1 ? kLags : 0);
    float s = x[n];
    float tmp_save = s;
    // taps 0..o-2, then the last tap o-1; every state lane is read before
    // it is written and every index is static once the loop is unrolled
#pragma unroll
    for (int j = 0; j < kLags; ++j) {
      if (j < o - 1) {
        const float tmp = radd(rmul(r[j], s), st[j]);
        s = radd(rmul(r[j], st[j]), s);
        st[j] = tmp_save;
        tmp_save = tmp;
      } else if (j == o - 1) {
        s = radd(s, rmul(r[j], st[j]));
        st[j] = tmp_save;
      }
    }
    x[n] = s;
  }
}

#ifdef __CUDACC__
constexpr int kTnsThreads = 32;

__global__ void tns_analysis_lattice_kernel(const float* __restrict__ x,
                                            const float* __restrict__ rc,
                                            const int32_t* __restrict__ order,
                                            const int32_t* __restrict__ lo,
                                            const int32_t* __restrict__ hi,
                                            float* __restrict__ y, int B, int N) {
  extern __shared__ float tile[];
  const int row0 = blockIdx.x * blockDim.x;
  const int rows = imin(static_cast<int>(blockDim.x), B - row0);
  acx_load_rows(tile, x, row0, rows, N);
  __syncthreads();
  const int t = threadIdx.x;
  if (t < rows) {
    const int s = row0 + t;
    float r[2 * kLags];
#pragma unroll
    for (int k = 0; k < 2 * kLags; ++k) r[k] = rc[s * 2 * kLags + k];
    const int o[2] = {order[2 * s], order[2 * s + 1]};
    const int l[2] = {lo[2 * s], lo[2 * s + 1]};
    const int h[2] = {hi[2 * s], hi[2 * s + 1]};
    tns_analysis_lane(tile + t * ACX_ROW_STRIDE(N), N, r, o, l, h);
  }
  __syncthreads();
  acx_store_rows(y, tile, row0, rows, N);
}

extern "C" int acx_tns_analysis_lattice(const void* x, const void* rc, const void* order,
                                        const void* lo, const void* hi, void* y, int B, int N,
                                        void* stream) {
  size_t smem = 0;
  cudaError_t err = acx_row_tiles_smem(tns_analysis_lattice_kernel, kTnsThreads, N, &smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int blocks = (B + kTnsThreads - 1) / kTnsThreads;
  tns_analysis_lattice_kernel<<<blocks, kTnsThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<const float*>(rc),
      static_cast<const int32_t*>(order), static_cast<const int32_t*>(lo),
      static_cast<const int32_t*>(hi), static_cast<float*>(y), B, N);
  return static_cast<int>(cudaGetLastError());
}
#endif
