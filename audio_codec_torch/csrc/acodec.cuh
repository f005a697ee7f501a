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

// Float products and sums rounded one by one, never contracted into a fused
// multiply-add: the plain versions on the card round each PyTorch op, and the
// kernels that must equal them bit for bit use these. (A host build of a lane
// function is compiled with -ffp-contract=off to the same end.)
ACX_HD float rmul(float a, float b) {
#ifdef __CUDA_ARCH__
  return __fmul_rn(a, b);
#else
  return a * b;
#endif
}
ACX_HD float radd(float a, float b) {
#ifdef __CUDA_ARCH__
  return __fadd_rn(a, b);
#else
  return a + b;
#endif
}
ACX_HD float rsub(float a, float b) {
#ifdef __CUDA_ARCH__
  return __fsub_rn(a, b);
#else
  return a - b;
#endif
}
// IEEE division and square root, rounded to nearest, as PyTorch's div,
// reciprocal and sqrt compute them on the card.
ACX_HD float rdiv(float a, float b) {
#ifdef __CUDA_ARCH__
  return __fdiv_rn(a, b);
#else
  return a / b;
#endif
}
ACX_HD float rroot(float a) {
#ifdef __CUDA_ARCH__
  return __fsqrt_rn(a);
#else
  return std::sqrt(a);
#endif
}

// a * b + c as the plain versions' numerics.xla_fma computes it on every
// device: the product exact in double, one double add, rounded once to float.
// (It equals the fused float multiply-add but where the double sum falls on a
// float tie; the plain version, and so the kernel, takes the double's way.)
ACX_HD float xfma(float a, float b, float c) {
#ifdef __CUDA_ARCH__
  return __double2float_rn(__dadd_rn(__dmul_rn(static_cast<double>(a), static_cast<double>(b)),
                                     static_cast<double>(c)));
#else
  return static_cast<float>(static_cast<double>(a) * static_cast<double>(b) +
                            static_cast<double>(c));
#endif
}

}  // namespace acx

#ifdef __CUDACC__
// Copies n int32 words from global to shared memory with the whole block.
__device__ __forceinline__ void acx_load_shared(int32_t* dst, const int32_t* src, int n) {
  for (int i = threadIdx.x; i < n; i += blockDim.x) dst[i] = src[i];
}

// Row tiles of a [B, N] array of 32-bit words in shared memory, one row per thread of
// the block, rows ACX_ROW_STRIDE(N) floats apart (an odd stride, so that the
// threads walking their rows in step hit different banks). The copies are
// coalesced: neighbouring threads move neighbouring elements.
#define ACX_ROW_STRIDE(N) ((N) | 1)

template <typename T>
__device__ __forceinline__ void acx_load_rows(T* tile, const T* g, int row0, int rows, int N) {
  const int stride = ACX_ROW_STRIDE(N);
  for (int i = threadIdx.x; i < rows * N; i += blockDim.x) {
    tile[(i / N) * stride + i % N] = g[static_cast<size_t>(row0) * N + i];
  }
}

template <typename T>
__device__ __forceinline__ void acx_store_rows(T* g, const T* tile, int row0, int rows, int N) {
  const int stride = ACX_ROW_STRIDE(N);
  for (int i = threadIdx.x; i < rows * N; i += blockDim.x) {
    g[static_cast<size_t>(row0) * N + i] = tile[(i / N) * stride + i % N];
  }
}

// Dynamic shared memory for a block of `threads` row tiles of N words; sets
// the kernel's limit where the tiles pass the 48 KB default.
template <typename Kernel>
inline cudaError_t acx_row_tiles_smem(Kernel kernel, int threads, int N, size_t* bytes) {
  *bytes = static_cast<size_t>(threads) * ACX_ROW_STRIDE(N) * sizeof(float);
  if (*bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(*bytes));
}
#endif
