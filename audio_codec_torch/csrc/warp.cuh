// The two warps that run the steps of the warp-a-stream kernels written as
// templates over the warp (bit_estimate.cuh, ari_encode.cuh,
// tns_analysis.cuh, gain_bisection.cuh, ari_decode.cuh, sns_vq_enc.cuh,
// noise_residual_enc.cuh, spec_decode.cuh, sns_vq.cuh's decoder, fec.cuh's
// encoder and decoder, phecu.cuh's first-loss analysis).
//
// On the card CoderCardWarp: a thread a lane, a Lanes<T> a register, the
// collectives __shfl_up_sync, __shfl_down_sync, __shfl_sync,
// __shfl_xor_sync, __ballot_sync and the warp reductions. On the host CoderHostWarp: one thread running the 32 lanes of
// each step in turn, a Lanes<T> an array of 32, every collective reading all
// lanes before it writes any; with it g++ compiles the steps for the CPU
// rehearsals (tests/test_torch_coder_rehearsal.py,
// tests/test_torch_rate_rehearsal.py, tests/test_torch_lane_rehearsal.py,
// tests/test_torch_decode_rehearsal.py, tests/test_torch_sns_nf_rehearsal.py,
// tests/test_torch_dec_rehearsal.py, tests/test_torch_fxdct_fec_rehearsal.py,
// tests/test_torch_fecenc_phecu_rehearsal.py).
#pragma once

#include "acodec.cuh"

namespace acx {

constexpr int kCoderLanes = 32;

struct CoderHostWarp {
  template <class T>
  struct Lanes {
    T v[kCoderLanes];
    T& operator[](int l) { return v[l]; }
    const T& operator[](int l) const { return v[l]; }
  };
  template <class F>
  void lanes(F&& f) const {
    for (int l = 0; l < kCoderLanes; ++l) f(l);
  }
  template <class F>
  void leader(F&& f) const {
    f();
  }
  void sync() const {}
  // lane l gets x[l - d], lanes below d their own
  template <class T>
  Lanes<T> shfl_up(const Lanes<T>& x, int d) const {
    Lanes<T> y;
    for (int l = 0; l < kCoderLanes; ++l) y[l] = x[l >= d ? l - d : l];
    return y;
  }
  // lane l gets x[l + d], lanes from 32 - d their own
  template <class T>
  Lanes<T> shfl_down(const Lanes<T>& x, int d) const {
    Lanes<T> y;
    for (int l = 0; l < kCoderLanes; ++l) y[l] = x[l + d < kCoderLanes ? l + d : l];
    return y;
  }
  template <class T>
  T shfl(const Lanes<T>& x, int src) const {
    return x[src];
  }
  // lane l gets x[src[l]]
  template <class T>
  Lanes<T> shfl_from(const Lanes<T>& x, const Lanes<int>& src) const {
    Lanes<T> y;
    for (int l = 0; l < kCoderLanes; ++l) y[l] = x[src[l] & (kCoderLanes - 1)];
    return y;
  }
  // lane l gets x[l ^ m]
  template <class T>
  Lanes<T> shfl_xor(const Lanes<T>& x, int m) const {
    Lanes<T> y;
    for (int l = 0; l < kCoderLanes; ++l) y[l] = x[l ^ m];
    return y;
  }
  template <class T>
  T uniform(const T& v) const {   // a value lane 0 holds, for every lane
    return v;
  }
  unsigned ballot(const Lanes<int>& p) const {
    unsigned m = 0;
    for (int l = 0; l < kCoderLanes; ++l) m |= (p[l] != 0 ? 1u : 0u) << l;
    return m;
  }
  int reduce_max(const Lanes<int>& x) const {
    int m = x[0];
    for (int l = 1; l < kCoderLanes; ++l) m = imax(m, x[l]);
    return m;
  }
  unsigned reduce_add(const Lanes<unsigned>& x) const {
    unsigned s = 0u;
    for (int l = 0; l < kCoderLanes; ++l) s += x[l];
    return s;
  }
  unsigned reduce_xor(const Lanes<unsigned>& x) const {
    unsigned s = 0u;
    for (int l = 0; l < kCoderLanes; ++l) s ^= x[l];
    return s;
  }
  // bit `bit` of the 32-bit word at w set to v (shared memory on the card,
  // where lanes write other bits of the same word at once)
  void put_bit(uint32_t* w, int bit, int v) const {
    if (v) *w |= 1u << bit;
    else *w &= ~(1u << bit);
  }
};

#ifdef __CUDACC__
struct CoderCardWarp {
  int lane;
  template <class T>
  struct Lanes {
    T v;
    __host__ __device__ T& operator[](int) { return v; }
    __host__ __device__ const T& operator[](int) const { return v; }
  };
  template <class F>
  __host__ __device__ void lanes(F&& f) const {
    f(lane);
  }
  template <class F>
  __host__ __device__ void leader(F&& f) const {
    if (lane == 0) f();
  }
  __host__ __device__ void sync() const {
#ifdef __CUDA_ARCH__
    __syncwarp();
#endif
  }
  template <class T>
  __host__ __device__ Lanes<T> shfl_up(const Lanes<T>& x, int d) const {
#ifdef __CUDA_ARCH__
    return {__shfl_up_sync(0xFFFFFFFFu, x.v, d)};
#else
    return x;
#endif
  }
  template <class T>
  __host__ __device__ Lanes<T> shfl_down(const Lanes<T>& x, int d) const {
#ifdef __CUDA_ARCH__
    return {__shfl_down_sync(0xFFFFFFFFu, x.v, d)};
#else
    return x;
#endif
  }
  template <class T>
  __host__ __device__ T shfl(const Lanes<T>& x, int src) const {
#ifdef __CUDA_ARCH__
    return __shfl_sync(0xFFFFFFFFu, x.v, src);
#else
    return x.v;
#endif
  }
  template <class T>
  __host__ __device__ Lanes<T> shfl_from(const Lanes<T>& x, const Lanes<int>& src) const {
#ifdef __CUDA_ARCH__
    return {__shfl_sync(0xFFFFFFFFu, x.v, src.v)};
#else
    return x;
#endif
  }
  template <class T>
  __host__ __device__ Lanes<T> shfl_xor(const Lanes<T>& x, int m) const {
#ifdef __CUDA_ARCH__
    return {__shfl_xor_sync(0xFFFFFFFFu, x.v, m)};
#else
    return x;
#endif
  }
  template <class T>
  __host__ __device__ T uniform(const T& v) const {
#ifdef __CUDA_ARCH__
    return __shfl_sync(0xFFFFFFFFu, v, 0);
#else
    return v;
#endif
  }
  __host__ __device__ unsigned ballot(const Lanes<int>& p) const {
#ifdef __CUDA_ARCH__
    return __ballot_sync(0xFFFFFFFFu, p.v != 0);
#else
    return 0u;
#endif
  }
  __host__ __device__ int reduce_max(const Lanes<int>& x) const {
#ifdef __CUDA_ARCH__
    return __reduce_max_sync(0xFFFFFFFFu, x.v);
#else
    return x.v;
#endif
  }
  __host__ __device__ unsigned reduce_add(const Lanes<unsigned>& x) const {
#ifdef __CUDA_ARCH__
    return __reduce_add_sync(0xFFFFFFFFu, x.v);
#else
    return x.v;
#endif
  }
  __host__ __device__ unsigned reduce_xor(const Lanes<unsigned>& x) const {
#ifdef __CUDA_ARCH__
    return __reduce_xor_sync(0xFFFFFFFFu, x.v);
#else
    return x.v;
#endif
  }
  __host__ __device__ void put_bit(uint32_t* w, int bit, int v) const {
#ifdef __CUDA_ARCH__
    if (v) atomicOr(w, 1u << bit);
    else atomicAnd(w, ~(1u << bit));
#endif
  }
};
#endif

}  // namespace acx
