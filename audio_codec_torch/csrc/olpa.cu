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
// Design: a warp a stream (olpa.cuh:olpa_warp), blocks of 4 warps, the
// tables read through the read-only cache (no block-wide staging). Every
// load of the memory and the frame a lane issues at once into shared
// memory, the decimation reads the staged frame; then every lane runs its
// eight chains in one unrolled loop at a compile-time correlation length
// (64 or 32), the block in registers and each row value squared once, e0
// beside the lags on the lanes without a fourth lag; the two searches are
// first-maximum shuffle trees, and R and E of their winners come back by
// shuffle.
#include "olpa.cuh"

using namespace acx;

#ifdef __CUDACC__
constexpr int kOlpaWarps = 4;   // streams a block

template <int ACF>
__global__ void olpa_kernel(const float* __restrict__ s12k8, int s_stride,
                            const float* __restrict__ mem12, const float* __restrict__ mem64,
                            int mem64_stride, const int32_t* __restrict__ mem_pitch,
                            const float* __restrict__ tables, int32_t* __restrict__ pitch2,
                            float* __restrict__ nc, int32_t* __restrict__ t0,
                            float* __restrict__ new_mem12, float* __restrict__ new_mem64, int B,
                            OlpaGeom g) {
  __shared__ OlpaScratch scratch[kOlpaWarps];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int b = blockIdx.x * kOlpaWarps + warp;
  if (b >= B) return;   // the whole warp leaves together
  const size_t bs = static_cast<size_t>(b);
  const OlpaStream s = {s12k8 + bs * s_stride, mem12 + 3 * bs, mem64 + bs * mem64_stride,
                        mem_pitch[b]};
  const OlpaOut o = olpa_warp<ACF>(CoderCardWarp{lane}, s, tables, g, scratch[warp],
                                   new_mem12 + 3 * bs, new_mem64 + bs * g.mem_in_len);
  if (lane == 0) {
    t0[b] = o.t0;
    pitch2[b] = 2 * o.t0;
    nc[b] = o.nc;
  }
}

extern "C" int acx_olpa(const void* s12k8, const void* mem12, const void* mem64,
                        const void* mem_pitch, const void* tables, void* pitch2, void* nc,
                        void* t0, void* new_mem12, void* new_mem64, int B, int s_stride,
                        int mem64_stride, int length, int len2, int mem_in_len, int acflen,
                        int base, void* stream) {
  if (mem_in_len + len2 > kOlpaMaxRow || base + acflen > mem_in_len + len2 ||
      base - kOlpaMinPitch - (kOlpaLags - 1) < 0 || (acflen != 64 && acflen != 32) ||
      length + 3 > kOlpaMaxFrame || 2 * len2 > length ||
      mem_in_len > kCoderLanes * kOlpaStageMem) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const OlpaGeom g = {length, len2, mem_in_len, acflen, base};
  const int blocks = (B + kOlpaWarps - 1) / kOlpaWarps;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  auto f = [](const void* v) { return static_cast<const float*>(v); };
  if (acflen == 64) {
    olpa_kernel<64><<<blocks, 32 * kOlpaWarps, 0, st>>>(
        f(s12k8), s_stride, f(mem12), f(mem64), mem64_stride,
        static_cast<const int32_t*>(mem_pitch), f(tables), static_cast<int32_t*>(pitch2),
        static_cast<float*>(nc), static_cast<int32_t*>(t0), static_cast<float*>(new_mem12),
        static_cast<float*>(new_mem64), B, g);
  } else {
    olpa_kernel<32><<<blocks, 32 * kOlpaWarps, 0, st>>>(
        f(s12k8), s_stride, f(mem12), f(mem64), mem64_stride,
        static_cast<const int32_t*>(mem_pitch), f(tables), static_cast<int32_t*>(pitch2),
        static_cast<float*>(nc), static_cast<int32_t*>(t0), static_cast<float*>(new_mem12),
        static_cast<float*>(new_mem64), B, g);
  }
  return static_cast<int>(cudaGetLastError());
}
#endif
