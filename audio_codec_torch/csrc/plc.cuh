// Shared pieces of the advanced-concealment kernels (plc_tdc.cu,
// plc_damp_scramble.cu, phecu_spec_ana.cu, phecu_subst.cu).
//
// Each kernel runs a warp a stream. A stream's steps are written once, as
// templates over the warp that runs them: on the card `CardWarp` (32 lanes,
// each taking every 32nd element of a loop, lane 0 alone for the sequential
// parts), on the host `HostWarp` (one thread running every element in turn),
// which is how the steps compile as plain C++ for the rehearsal
// (tests/test_torch_lane_rehearsal.py).
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

namespace acx {

struct HostWarp {
  template <class F>
  void each(int n, F&& f) const {
    for (int i = 0; i < n; ++i) f(i);
  }
  void sync() const {}
  bool leader() const { return true; }
};

#ifdef __CUDACC__
struct CardWarp {
  int lane;
  template <class F>
  __host__ __device__ void each(int n, F&& f) const {
    for (int i = lane; i < n; i += 32) f(i);
  }
  __host__ __device__ void sync() const {
#ifdef __CUDA_ARCH__
    __syncwarp();
#endif
  }
  __host__ __device__ bool leader() const { return lane == 0; }
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
      float acc = 0.0f;
      for (int k = 0; k < 32; ++k) {
        const int i = j * 32 + k - left;
        acc = radd(acc, (i >= 0 && i < n) ? get(i) : 0.0f);
      }
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

// The 16-bit generator seed' = 16831 + 12821 seed (mod 2^16) k steps from
// seed, in closed form: pows = mult [n + 1] ++ add [n + 1]; the signed value.
ACX_HD int lcg16_at(int seed, int k, const int32_t* pows, int n) {
  const uint32_t su = static_cast<uint32_t>(seed) & 0xFFFFu;
  const uint32_t s = (su * static_cast<uint32_t>(pows[k]) + static_cast<uint32_t>(pows[n + 1 + k])) &
                     0xFFFFu;
  return s >= 32768u ? static_cast<int>(s) - 65536 : static_cast<int>(s);
}

}  // namespace acx
