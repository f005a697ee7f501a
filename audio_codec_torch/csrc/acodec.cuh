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

// set bits of a 32-lane ballot
ACX_HD int popc32(unsigned m) {
#ifdef __CUDA_ARCH__
  return __popc(m);
#else
  return __builtin_popcount(m);
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
// Asynchronous 16-byte copies from device to shared memory (cp.async.cg):
// a copy whose source is not valid writes zeros.
__device__ __forceinline__ void acx_cp_async16(void* smem, const void* gmem, bool valid) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(gmem),
               "r"(valid ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void acx_cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
__device__ __forceinline__ void acx_cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// Copies n int32 words from global to shared memory with the whole block.
// Each thread issues the loads of a round (kAcxLoadRound words, blockDim.x
// apart) before it stores any of them: a copy that stores each load before
// issuing the next keeps one load in flight a thread (hp50_biquad's first
// design lost 0.03 ms to it, tools/torch_biquad_times.py --phases).
constexpr int kAcxLoadRound = 8;

__device__ __forceinline__ void acx_load_shared(int32_t* __restrict__ dst,
                                                const int32_t* __restrict__ src, int n) {
  for (int i0 = threadIdx.x; i0 < n; i0 += kAcxLoadRound * blockDim.x) {
    int32_t v[kAcxLoadRound];
#pragma unroll
    for (int u = 0; u < kAcxLoadRound; ++u) {
      const int i = i0 + u * static_cast<int>(blockDim.x);
      v[u] = i < n ? __ldg(src + i) : 0;
    }
#pragma unroll
    for (int u = 0; u < kAcxLoadRound; ++u) {
      const int i = i0 + u * static_cast<int>(blockDim.x);
      if (i < n) dst[i] = v[u];
    }
  }
}
#endif
