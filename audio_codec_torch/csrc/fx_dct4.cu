// fx_dct4: the fixed-point decoder's integer DCT-IV (K20c).
//
// Replaces audio_codec_tpu/ops/fixed_dev.py:batch_dct4 (:574) over
// ops/fixed_imdct.py:dct_IV (:488) and cfft(240) = fftN2_8(..,
// "RotVector_480", 30, 2, 60) (:469, :383, fft30 :243): ProcessingIMDCT's
// front half (imdct_fx.c:60-115, dct4_fx.c:16-140, fft.c:3668) on clean
// frames. [L, 480] Word32 rows and exponents -> ytda [L, 480], y_e, y_s and
// the all-zero flag, L = T x B frames of a block. N = 480 only (48 kHz,
// 10 ms); the other sizes raise in the wrapper (ROADMAP Queue 1 item 9).
//
// Bound on an H100: about 60 saturating integer operations a value over six
// dependent stages (two headroom reductions, the pre-twiddle, the fft30
// columns, the radix-8 rows, the post-twiddle); the bytes are the rows in
// and out, 7.7 KB a row (L = 16384: 126 MB, 0.04 ms at 3.35 TB/s).
// Design: a block a row, the row in shared memory twice (each stage reads
// one copy and writes the other, its nodes in parallel over the block's
// threads: 120 pre-twiddle nodes, 8 fft30 columns, 30 radix-8 rows, 120
// post-twiddle nodes), the headrooms by warp shuffles and shared memory.
#include "fx_dct4.cuh"

using namespace acx::fx;

constexpr int kFxDctThreads = 128;

__global__ void fx_dct4_kernel(const i64* __restrict__ y, const i64* __restrict__ y_e_in,
                               const i64* __restrict__ tab, i64* __restrict__ ytda,
                               i64* __restrict__ y_e, i64* __restrict__ y_s,
                               bool* __restrict__ zero) {
  __shared__ i64 a[kDctN], b[kDctN], red[32];
  const size_t r = blockIdx.x;
  const Block g{red};
  fx_dct4_row(g, y + r * kDctN, y_e_in[r], tab, a, b, ytda + r * kDctN, y_e + r, y_s + r, zero + r);
}

extern "C" int acx_fx_dct4(const void* y, const void* y_e_in, const void* tab, void* ytda,
                           void* y_e, void* y_s, void* zero, int L, void* stream) {
  fx_dct4_kernel<<<L, kFxDctThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const i64*>(y), static_cast<const i64*>(y_e_in), static_cast<const i64*>(tab),
      static_cast<i64*>(ytda), static_cast<i64*>(y_e), static_cast<i64*>(y_s),
      static_cast<bool*>(zero));
  return static_cast<int>(cudaGetLastError());
}
