// Shared helpers of the codec's CUDA kernels.
//
// The per-lane state machines are written as functions that compile for the
// device and, without nvcc, as plain C++ for the host: the host build is only
// a way to read the arithmetic; the kernels themselves run on the card.
#pragma once

#include <cmath>
#include <cstdint>

#ifdef __CUDACC__
#include <cuda_runtime.h>
#define ACX_HD __host__ __device__ __forceinline__
#else
#define ACX_HD static inline
#endif

namespace acx {

constexpr int MASK24 = (1 << 24) - 1;

ACX_HD int imin(int a, int b) { return a < b ? a : b; }
ACX_HD int imax(int a, int b) { return a > b ? a : b; }
ACX_HD int iclamp(int v, int lo, int hi) { return v < lo ? lo : (v > hi ? hi : v); }
ACX_HD int iabs(int v) { return v < 0 ? -v : v; }

// floor(log2(v)) for v >= 1 (31 - clz)
ACX_HD int msb32(int v) {
#ifdef __CUDA_ARCH__
  return 31 - __clz(v);
#else
  return 31 - __builtin_clz(static_cast<unsigned>(v));
#endif
}

// (v << 8) & MASK24 in two's complement, for any int v
ACX_HD int shl8_24(int v) {
  return static_cast<int>((static_cast<unsigned>(v) << 8) & MASK24);
}

}  // namespace acx

#ifdef __CUDACC__
// Copies n int32 words from global to shared memory with the whole block.
__device__ __forceinline__ void acx_load_shared(int32_t* dst, const int32_t* src, int n) {
  for (int i = threadIdx.x; i < n; i += blockDim.x) dst[i] = src[i];
}
#endif
