// fx_dct4: the fixed-point decoder's integer DCT-IV (K20c).
//
// Replaces audio_codec_tpu/ops/fixed_dev.py:batch_dct4 (:574) over
// ops/fixed_imdct.py:dct_IV (:488) and cfft(240) = fftN2_8(..,
// "RotVector_480", 30, 2, 60) (:469, :383, fft30 :243): ProcessingIMDCT's
// front half (imdct_fx.c:60-115, dct4_fx.c:16-140, fft.c:3668) on clean
// frames. [L, 480] Word32 rows and exponents -> ytda [L, 480], y_e, y_s and
// the all-zero flag, L = T x B frames of a block. N = 480 only (48 kHz,
// 10 ms); the other sizes raise in the wrapper (ROADMAP Queue 1 item 3).
//
// Bound on an H100: the bytes, the 400 bins below the cap in and the rows
// out, about 7 KB a row (L = 16384: 116 MB, 0.035 ms at 3.35 TB/s); the
// work is about 12 000 32-bit operations a row over five dependent stages
// (fx_dct4.cuh), some 1 500 warp instructions a row once spread over the
// lanes.
// Design: a row a group of kFxDctRowLanes lanes (half a warp: two rows a
// warp, in step), kFxDctWarps warps a block; the row in two int32 buffers in
// shared memory (3 840 B a row), every stage's nodes spread over the
// group's lanes (fx_dct4.cuh: the 16 fft15 halves one a lane), group syncs
// by __syncwarp, the two headroom minima OR reductions within the group;
// 16-byte loads of the row, all in flight, and 16-byte stores of the output
// straight from the last stage; the int32 tables staged in shared memory
// once a block. A warp a row, or the tables read through L1, took 0.081-0.089
// graph ms against this design's 0.072 on an H100 (B = 2048, T = 8:
// tools/torch_fxdct_fec_times.py --variants).
#include "fx_dct4.cuh"

using namespace acx::fx;

#ifdef __CUDACC__
constexpr int kFxDctRowLanes = 16;   // lanes a row: two rows a warp
constexpr int kFxDctWarps = 4;       // warps a block
constexpr int kFxDctRows = kFxDctWarps * (32 / kFxDctRowLanes);   // rows a block

// kLanes (32 or 16) lanes of a warp that run one row; the warp's other
// lanes, if any, run another row in step with them
template <int kLanes>
struct RowLanes {
  int lane;   // 0 .. kLanes - 1
  template <class F>
  __device__ void each(int n, F&& f) const {
    for (int i = lane; i < n; i += kLanes) f(i);
  }
  // every load of a lane in flight before f runs; n <= 256 (a row's 200
  // pairs)
  template <class L, class F>
  __device__ void each_loaded(int n, L&& load, F&& f) const {
    constexpr int kRounds = 256 / kLanes;
    decltype(load(0)) v[kRounds];
#pragma unroll
    for (int u = 0; u < kRounds; ++u) {
      if (lane + kLanes * u < n) v[u] = load(lane + kLanes * u);
    }
#pragma unroll
    for (int u = 0; u < kRounds; ++u) {
      if (lane + kLanes * u < n) f(lane + kLanes * u, v[u]);
    }
  }
  __device__ void sync() const { __syncwarp(); }
  __device__ bool leader() const { return lane == 0; }
  // the OR over the group's lanes (xor shuffles stay within the group)
  __device__ uint32_t bor(uint32_t v) const {
#pragma unroll
    for (int o = kLanes / 2; o > 0; o >>= 1) v |= __shfl_xor_sync(0xffffffffu, v, o);
    return v;
  }
};

__global__ void __launch_bounds__(32 * kFxDctWarps)
    fx_dct4_kernel(const i64* __restrict__ y, const i64* __restrict__ y_e_in,
                   const w32* __restrict__ tab, i64* __restrict__ ytda, i64* __restrict__ y_e,
                   i64* __restrict__ y_s, bool* __restrict__ zero, int L) {
  __shared__ w32 buf[kFxDctRows][2][kDctN];
  __shared__ w32 tabs[kFxDctTableWords];
  acx_load_shared(tabs, tab, kFxDctTableWords);
  __syncthreads();
  const int slot = threadIdx.x / kFxDctRowLanes;
  const int first = blockIdx.x * kFxDctRows + (threadIdx.x / 32) * (32 / kFxDctRowLanes);
  if (first >= L) return;   // the whole warp leaves together
  // half a warp past the last row runs the last row again, in step with the
  // other half, and writes the same values
  const int row = static_cast<int>(blockIdx.x) * kFxDctRows + slot;
  const size_t r = row < L ? row : L - 1;
  const RowLanes<kFxDctRowLanes> g{static_cast<int>(threadIdx.x % kFxDctRowLanes)};
  fx_dct4_row(g, y + r * kDctN, y_e_in[r], tabs, buf[slot][0], buf[slot][1], ytda + r * kDctN,
              y_e + r, y_s + r, zero + r);
}

extern "C" int acx_fx_dct4(const void* y, const void* y_e_in, const void* tab, void* ytda,
                           void* y_e, void* y_s, void* zero, int L, void* stream) {
  const int blocks = (L + kFxDctRows - 1) / kFxDctRows;
  fx_dct4_kernel<<<blocks, 32 * kFxDctWarps, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const i64*>(y), static_cast<const i64*>(y_e_in), static_cast<const w32*>(tab),
      static_cast<i64*>(ytda), static_cast<i64*>(y_e), static_cast<i64*>(y_s),
      static_cast<bool*>(zero), L);
  return static_cast<int>(cudaGetLastError());
}
#endif
