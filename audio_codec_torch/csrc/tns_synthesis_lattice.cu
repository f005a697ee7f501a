// tns_synthesis_lattice: the decoder's inverse TNS lattice over the bins.
//
// Replaces the lax.scan of audio_codec_tpu/ops/tns.py:tns_decode (the step
// at tns.py:256-273, scanned at :276; processTnsDecoder_fl,
// tns_decoder.c:13-51): the all-pole lattice of order 1..8 that undoes the
// encoder's filter, its 8-lane state carried from bin to bin and across the
// two filters' ranges. The coefficient lookup and the ranges stay tensor
// code (ops/tns.py).
//
// Bound on an H100: every bin depends on the state the previous bin left, a
// chain of N = 400 steps per stream of up to 8 lattice taps (4 dependent
// float ops each); the bytes are x and y (B x 400 x 4 each) plus the filters
// (B x 88 bytes), about 6.7 MB at B = 2048, 2 us at 3.35 TB/s. The chain is
// the bound.
// Design: as tns_analysis_lattice.cu: one thread per stream, rows staged
// through shared memory with coalesced copies, filtered in place with the
// state, coefficients and orders in registers; bin membership from the
// ranges, and every state index static (see tns_analysis_lattice.cu). The
// taps follow the plain version's contraction, which is XLA:CPU's on every
// device (ops/tns.py:tns_synthesis_lattice_plain): each contracted product
// a fused multiply-add in double (`xfma`, as numerics.xla_fma), state lanes
// 5-7 on a second chain whose first product is contracted, the main chain's
// first product rounded on its own unless B = 1. So the card's TNS decode
// equals the CPU port's, and the kernel its plain version, bit for bit.
#include "acodec.cuh"

using namespace acx;

constexpr int kLags = 8;

// One stream, in place on x [N] (stride 1); arguments as tns_analysis_lane,
// and fused_first: B = 1, where the main chain's first product is contracted.
ACX_HD void tns_synthesis_lane(float* x, int N, const float* rc, const int* order,
                               const int* lo, const int* hi, bool fused_first) {
  float st[kLags] = {0, 0, 0, 0, 0, 0, 0, 0};
  for (int n = 0; n < N; ++n) {
    const bool in1 = order[1] > 0 && n >= lo[1] && n <= hi[1];
    const bool in0 = order[0] > 0 && n >= lo[0] && n <= hi[0];
    if (!in0 && !in1) continue;                 // y = x, state kept
    // orders above 8 act as 8, as the plain version's clamped last tap does
    const int o = imin(in1 ? order[1] : order[0], kLags);
    const float* r = rc + (in1 ? kLags : 0);
    float s = x[n], s_f = x[n];
    // the last tap o-1 first, then taps o-2..0; every state lane is read
    // before it is written and every index is static once unrolled
#pragma unroll
    for (int el = kLags - 1; el >= 0; --el) {
      if (el == o - 1) {
        s_f = xfma(-r[el], st[el], x[n]);
        s = fused_first ? s_f : rsub(x[n], rmul(r[el], st[el]));
      } else if (el < o - 1) {
        const float s_new = xfma(-r[el], st[el], s);
        float upd;
        if (el >= 4) {
          s_f = xfma(-r[el], st[el], s_f);
          upd = xfma(r[el], s_f, st[el]);
        } else {
          upd = xfma(r[el], s_new, st[el]);
        }
        st[el + 1] = upd;
        s = s_new;
      }
    }
    st[0] = s;
    x[n] = s;
  }
}

#ifdef __CUDACC__
constexpr int kTnsThreads = 32;

__global__ void tns_synthesis_lattice_kernel(const float* __restrict__ x,
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
    tns_synthesis_lane(tile + t * ACX_ROW_STRIDE(N), N, r, o, l, h, B == 1);
  }
  __syncthreads();
  acx_store_rows(y, tile, row0, rows, N);
}

extern "C" int acx_tns_synthesis_lattice(const void* x, const void* rc, const void* order,
                                         const void* lo, const void* hi, void* y, int B, int N,
                                         void* stream) {
  size_t smem = 0;
  cudaError_t err = acx_row_tiles_smem(tns_synthesis_lattice_kernel, kTnsThreads, N, &smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int blocks = (B + kTnsThreads - 1) / kTnsThreads;
  tns_synthesis_lattice_kernel<<<blocks, kTnsThreads, smem,
                                 static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<const float*>(rc),
      static_cast<const int32_t*>(order), static_cast<const int32_t*>(lo),
      static_cast<const int32_t*>(hi), static_cast<float*>(y), B, N);
  return static_cast<int>(cudaGetLastError());
}
#endif
