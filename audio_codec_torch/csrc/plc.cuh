// Shared pieces of the advanced-concealment kernels (plc_tdc.cu,
// plc_damp_scramble.cu, phecu_spec_ana.cu, phecu_subst.cu).
//
// Each kernel runs a warp a stream. A stream's steps are written once, as
// templates over the warp that runs them. plc_tdc's run over the policies
// here: on the card `CardWarp` (32 lanes, each taking every 32nd element of
// a loop, lane 0 alone for the sequential parts), on the host `HostWarp`
// (one thread running every element in turn), which is how the steps
// compile as plain C++ for the rehearsals (tests/test_torch_lane_rehearsal.py).
// The other three kernels' run over the warps of warp.cuh.
//
// The float order is the plain versions' (ops/plc_adv.py, ops/plc_phecu.py),
// which is the reference's (XLA:CPU's) on every device: sums of more than 32
// terms in XLA's windows of 32 (numerics.xla_sum, `wsum` here, one lane a
// window), fused multiply-adds where XLA contracts (numerics.xla_fma, `xfma`),
// the x86 reciprocal square root estimate and its two Newton steps
// (numerics.xla_rsqrt), Cephes exp2 (numerics.xla_exp2); every other product
// and sum rounded on its own (rmul, radd, rsub, rdiv, rroot).
#pragma once

#include <cstring>

#include "acodec.cuh"
#include "warp.cuh"

namespace acx {

// each_u<U>(n, f): f(i) for every i < n, as each; on the card a lane runs U
// of its elements (i, i + 32, ...) in one unrolled iteration, so that their
// independent chains overlap. each_loaded(n, load, f): f(i, load(i)) for
// every i < n; on the card a lane issues the loads of kPlcLoadRound of its
// elements before it runs f on any of them, so that its global loads are in
// flight together. coder(): the same lanes as a warp of warp.cuh, for steps
// written over lane registers and shuffles.
constexpr int kPlcLoadRound = 8;

struct HostWarp {
  template <class F>
  void each(int n, F&& f) const {
    for (int i = 0; i < n; ++i) f(i);
  }
  template <int U, class F>
  void each_u(int n, F&& f) const {
    for (int i = 0; i < n; ++i) f(i);
  }
  template <class L, class F>
  void each_loaded(int n, L&& load, F&& f) const {
    for (int i = 0; i < n; ++i) f(i, load(i));
  }
  void sync() const {}
  bool leader() const { return true; }
  CoderHostWarp coder() const { return CoderHostWarp{}; }
};

#ifdef __CUDACC__
struct CardWarp {
  int lane;
  template <class F>
  __host__ __device__ void each(int n, F&& f) const {
    for (int i = lane; i < n; i += 32) f(i);
  }
  template <int U, class F>
  __host__ __device__ void each_u(int n, F&& f) const {
    int i = lane;
    for (; i + 32 * (U - 1) < n; i += 32 * U) {
#pragma unroll
      for (int u = 0; u < U; ++u) f(i + 32 * u);
    }
    for (; i < n; i += 32) f(i);
  }
  template <class L, class F>
  __host__ __device__ void each_loaded(int n, L&& load, F&& f) const {
    for (int i0 = lane; i0 < n; i0 += 32 * kPlcLoadRound) {
      decltype(load(0)) v[kPlcLoadRound];
#pragma unroll
      for (int u = 0; u < kPlcLoadRound; ++u) {
        if (i0 + 32 * u < n) v[u] = load(i0 + 32 * u);
      }
#pragma unroll
      for (int u = 0; u < kPlcLoadRound; ++u) {
        if (i0 + 32 * u < n) f(i0 + 32 * u, v[u]);
      }
    }
  }
  __host__ __device__ void sync() const {
#ifdef __CUDA_ARCH__
    __syncwarp();
#endif
  }
  __host__ __device__ bool leader() const { return lane == 0; }
  __host__ __device__ CoderCardWarp coder() const { return CoderCardWarp{lane}; }
};
#endif

ACX_HD float fmin2(float a, float b) { return b < a ? b : a; }
ACX_HD float fmax2(float a, float b) { return b > a ? b : a; }
ACX_HD float fclamp(float v, float lo, float hi) { return fmin2(fmax2(v, lo), hi); }
ACX_HD int bits_of(float v) {
#ifdef __CUDA_ARCH__
  return __float_as_int(v);
#else
  int b;
  std::memcpy(&b, &v, 4);
  return b;
#endif
}
ACX_HD float float_of(int b) {
#ifdef __CUDA_ARCH__
  return __int_as_float(b);
#else
  float v;
  std::memcpy(&v, &b, 4);
  return v;
#endif
}

// all ones where p holds; a where mask is all ones, else b: selects as bit
// operations, which the compiler keeps as such (a select of floats on a
// condition it may compile into a branch)
ACX_HD uint32_t all_if(bool p) { return 0u - static_cast<uint32_t>(p); }
ACX_HD float fsel_bits(uint32_t mask, float a, float b) {
  return float_of(static_cast<int>((static_cast<uint32_t>(bits_of(a)) & mask) |
                                   (static_cast<uint32_t>(bits_of(b)) & ~mask)));
}

// numerics.xla_sum of get(0..n-1), n <= 1024: windows of 32 after half the
// zero pad, each summed from zero by one lane, then the window sums from zero
// by the leader. scratch: 32 floats; slot: where the leader leaves the sum
// for every lane.
template <class W, class G>
ACX_HD float wsum(const W& w, int n, float* scratch, float* slot, G get) {
  if (n <= 32) {
    if (w.leader()) {
      float acc = 0.0f;
      for (int i = 0; i < n; ++i) acc = radd(acc, get(i));
      *slot = acc;
    }
  } else {
    const int tot = (n + 31) / 32 * 32, left = (tot - n) / 2;
    w.each(tot / 32, [&](int j) {
      // the window's 32 terms first (their loads at once), then its sum; a
      // term of the pad is +0 by a mask of its bits, not a branch around
      // the term's loads
      float v[32];
#pragma unroll
      for (int k = 0; k < 32; ++k) {
        const int i = j * 32 + k - left;
        const float g = get(iclamp(i, 0, n - 1));
        v[k] = float_of(bits_of(g) & ((i >= 0 && i < n) ? -1 : 0));
      }
      float acc = 0.0f;
#pragma unroll
      for (int k = 0; k < 32; ++k) acc = radd(acc, v[k]);
      scratch[j] = acc;
    });
    w.sync();
    if (w.leader()) {
      float acc = 0.0f;
      for (int j = 0; j < tot / 32; ++j) acc = radd(acc, scratch[j]);
      *slot = acc;
    }
  }
  w.sync();
  const float s = *slot;
  w.sync();
  return s;
}

// numerics.xla_exp2: Cephes exp of x ln 2 with its multiply-adds fused.
ACX_HD float xla_exp2f(float x) {
  x = rmul(x, 0x1.62e43p-1f);            // f32(ln 2)
  x = fclamp(x, -0x1.5f3334p+6f, 0x1.633334p+6f);
  const float fx = floorf(xfma(x, 0x1.715476p+0f, 0.5f));
  x = xfma(fx, -0.693359375f, x);
  x = xfma(fx, 2.12194440e-4f, x);
  const float z = rmul(x, x);
  float y = xfma(x, 1.9875691500e-4f, 1.3981999507e-3f);
  y = xfma(y, x, 8.3334519073e-3f);
  y = xfma(y, x, 4.1665795894e-2f);
  y = xfma(y, x, 1.6666665459e-1f);
  y = xfma(y, x, 5.0000001201e-1f);
  y = xfma(y, z, x);
  y = radd(1.0f, y);
  const int n = static_cast<int>(fx) + 127;
  return rmul(y, float_of(imax(n, 0) << 23));
}

// numerics.xla_rsqrt: the x86 estimate (table: 2 x 1024 values, the
// exponent's parity and the top 10 mantissa bits) and two Newton steps.
ACX_HD float xla_rsqrtf(float x, const float* table) {
  const int b = bits_of(x);
  if (!(x > 0.0f) || b >= 0x7F800000 || b < 0x00800000) return rdiv(1.0f, rroot(x));
  const int e = ((b >> 23) & 0xFF) - 127;
  const int par = e & 1;
  const int k = (e - par) / 2;
  float y = rmul(table[par * 1024 + ((b >> 13) & 1023)], float_of((127 - k) << 23));
#pragma unroll
  for (int s = 0; s < 2; ++s) y = xfma(rmul(y, -0.5f), xfma(rmul(x, y), y, -1.0f), y);
  return y;
}

// A per-stream vector as the wrapper hands it over, read where the kernel
// needs it (phecu_subst.cu, plc_damp_scramble.cu): its address, its stride
// in elements and its element type, so that the tensors the decoder passes
// (bool masks, int32 counters, columns of wider rows) need no cast or copy.
// vec_int reads bool or int32 as an int; vec_float reads float32.
enum : int { kVecBool = 0, kVecInt32 = 1, kVecFloat32 = 2 };
struct StreamVec {
  const void* p;
  int stride;
  int type;
};
ACX_HD int vec_int(const StreamVec& v, int b) {
  const size_t i = static_cast<size_t>(b) * v.stride;
  if (v.type == kVecBool) return static_cast<const uint8_t*>(v.p)[i] != 0;
  return static_cast<const int32_t*>(v.p)[i];
}
ACX_HD float vec_float(const StreamVec& v, int b) {
  return static_cast<const float*>(v.p)[static_cast<size_t>(b) * v.stride];
}

// The 16-bit generator seed' = 16831 + 12821 seed (mod 2^16) k steps from
// seed, in closed form: pows = mult [n + 1] ++ add [n + 1]; the signed value.
ACX_HD int lcg16_at(int seed, int k, const int32_t* pows, int n) {
  const uint32_t su = static_cast<uint32_t>(seed) & 0xFFFFu;
  const uint32_t s = (su * static_cast<uint32_t>(pows[k]) + static_cast<uint32_t>(pows[n + 1 + k])) &
                     0xFFFFu;
  return s >= 32768u ? static_cast<int>(s) - 65536 : static_cast<int>(s);
}

}  // namespace acx
