// olpa: the encoder's open-loop pitch search at 6.4 kHz.
//
// Replaces audio_codec_tpu/ops/analysis.py:olpa (analysis.py:77, with
// _window_gather at :71): a 5-tap filter as five [B, 131] ops, a [B, 98, 64]
// gather of the lagged rows, two products over it, two first-argmax searches
// and the take-over rule, about 40 launches a frame in the port's tensor code.
//
// Bound on an H100: reads the 12.8 kHz frame (128 samples), the two memories
// and the previous pitch, writes 3 scalars and the memories again: about
// 2 KB a stream, 4.2 MB at B = 2048, 0.0013 ms at 3.35 TB/s. The work is
// 98 lags x 64 samples x 2 multiply-adds a stream, 25.7 M operations at
// B = 2048, 0.0004 ms at 67 TFLOP/s.
// Design: one warp per stream. The lanes decimate the frame into the 6.4 kHz
// row in shared memory; lane l then sums the lags l, l+32, l+64 and l+96
// (< 98), each R and E one chain over the 64 samples, ascending, as the plain
// version orders them (olpa.cuh), and keeps its first maximum of the weighted
// R and of R within the window; a shuffle reduction with first_max_beats
// keeps the lowest index on ties. Lane 0 then takes the decision.
#include "olpa.cuh"

using namespace acx;

#ifdef __CUDACC__
constexpr int kOlpaWarps = 4;
constexpr unsigned kFullMask = 0xffffffffu;

__device__ __forceinline__ void warp_first_max(float* v, int* i) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const float ov = __shfl_xor_sync(kFullMask, *v, off);
    const int oi = __shfl_xor_sync(kFullMask, *i, off);
    if (first_max_beats(ov, oi, *v, *i)) {
      *v = ov;
      *i = oi;
    }
  }
}

__global__ void olpa_kernel(const float* __restrict__ s12k8, int s_stride,
                            const float* __restrict__ mem12, const float* __restrict__ mem64,
                            int mem64_stride, const int32_t* __restrict__ mem_pitch,
                            const float* __restrict__ tables, int32_t* __restrict__ pitch2,
                            float* __restrict__ nc, int32_t* __restrict__ t0,
                            float* __restrict__ new_mem12, float* __restrict__ new_mem64, int B,
                            OlpaGeom g) {
  __shared__ float tab[kOlpaTableWords];
  __shared__ float rows[kOlpaWarps][kOlpaMaxRow];
  __shared__ float rs[kOlpaWarps][kOlpaLags];
  __shared__ float es[kOlpaWarps][kOlpaLags];
  for (int i = threadIdx.x; i < kOlpaTableWords; i += blockDim.x) tab[i] = tables[i];
  __syncthreads();
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int b = blockIdx.x * kOlpaWarps + warp;
  if (b >= B) return;   // the whole warp leaves together
  float* row = rows[warp];
  const float* s = s12k8 + static_cast<size_t>(b) * s_stride;
  const float* m12 = mem12 + 3 * static_cast<size_t>(b);
  const float* m64 = mem64 + static_cast<size_t>(b) * mem64_stride;
  for (int i = lane; i < g.mem_in_len; i += 32) row[i] = m64[i];
  for (int i = lane; i < g.len2; i += 32) row[g.mem_in_len + i] = olpa_decimate(m12, s, tab, i);
  if (lane < 3) new_mem12[3 * static_cast<size_t>(b) + lane] = olpa_in(m12, s, g.length + lane);
  __syncwarp();
  for (int i = lane; i < g.mem_in_len; i += 32) {
    new_mem64[static_cast<size_t>(b) * g.mem_in_len + i] = row[g.len2 + i];
  }
  const int mp = mem_pitch[b];
  const float* acw = tab + kOlpaTaps;
  float bv = -INFINITY, bv2 = -INFINITY;
  int bi = kNoIndex, bi2 = kNoIndex;
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const int l = lane + 32 * k;
    if (l < kOlpaLags) {
      float r, e;
      olpa_lag_sums(row, g, l, &r, &e);
      rs[warp][l] = r;
      es[warp][l] = e;
      const float v = rmul(r, acw[l]);
      if (first_max_beats(v, l, bv, bi)) { bv = v; bi = l; }
      const float v2 = olpa_in_window(l, mp) ? r : -INFINITY;
      if (first_max_beats(v2, l, bv2, bi2)) { bv2 = v2; bi2 = l; }
    }
  }
  warp_first_max(&bv, &bi);
  warp_first_max(&bv2, &bi2);
  __syncwarp();
  if (lane == 0) {
    const float e0 = olpa_energy(row, g);
    const int L = iclamp(bi, 0, kOlpaLags - 1), L2 = iclamp(bi2, 0, kOlpaLags - 1);
    int t;
    float c;
    olpa_decide(rs[warp][L], es[warp][L], L, rs[warp][L2], es[warp][L2], L2, e0, &t, &c);
    t0[b] = t;
    pitch2[b] = 2 * t;
    nc[b] = c;
  }
}

extern "C" int acx_olpa(const void* s12k8, const void* mem12, const void* mem64,
                        const void* mem_pitch, const void* tables, void* pitch2, void* nc,
                        void* t0, void* new_mem12, void* new_mem64, int B, int s_stride,
                        int mem64_stride, int length, int len2, int mem_in_len, int acflen,
                        int base, void* stream) {
  if (mem_in_len + len2 > kOlpaMaxRow || base + acflen > mem_in_len + len2 ||
      base - kOlpaMinPitch - (kOlpaLags - 1) < 0 || acflen < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const OlpaGeom g = {length, len2, mem_in_len, acflen, base};
  const int blocks = (B + kOlpaWarps - 1) / kOlpaWarps;
  olpa_kernel<<<blocks, 32 * kOlpaWarps, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(s12k8), s_stride, static_cast<const float*>(mem12),
      static_cast<const float*>(mem64), mem64_stride, static_cast<const int32_t*>(mem_pitch),
      static_cast<const float*>(tables), static_cast<int32_t*>(pitch2), static_cast<float*>(nc),
      static_cast<int32_t*>(t0), static_cast<float*>(new_mem12), static_cast<float*>(new_mem64),
      B, g);
  return static_cast<int>(cudaGetLastError());
}
#endif
