// ltpf_postfilter: the sample loop of the LTPF decoder post-filter.
//
// Replaces the lax.scan of audio_codec_tpu/ops/ltpf_dec.py:ltpf_decode
// (ltpf_dec.py:122-161; process_ltpf_decoder_fl, ltpf_decoder.c:13-316): a
// pitch-lagged IIR comb filter whose parameters cross-fade from the previous
// frame's to the current one's over the first 2.5 ms, in five cases (off/off,
// on->off fade-out, off->on fade-in, on->on same pitch, on->on pitch change
// through a scratch signal z). The parameter decode around it stays tensor
// code (ops/ltpf_dec.py).
//
// Bound on an H100: each output sample feeds back into later ones (a chain
// of N = 480 dependent steps per stream, each two dot products of 11 and 12
// taps); the bytes are x and y (B x 480 x 4 each) plus the history (B x 861
// x 4), about 15 MB at B = 2048, or 4.5 us at 3.35 TB/s. The chain is the
// bound.
// Design: one thread per stream; the stream's y and z histories sit in
// shared memory as two 1024-sample rings (8 KB a stream), the filters and
// pitches in registers. Taps are summed in the plain version's order, the
// CPU's (numerics.xla_fma on every device): the first product rounded, then a
// chain of xfma (a double product and add, rounded once), and the crossfade
// weight k / N4 as k times the float reciprocal of N4; so the two agree bit for
// bit.
#include "acodec.cuh"

using namespace acx;

constexpr int kRing = 1024;
constexpr int kMaxTaps = 12;
enum { CASE_B = 1, CASE_C = 2, CASE_D = 4, CASE_E = 8, NEW_ON = 16 };

ACX_HD float tap_dot(const float* w, const float* v, int n) {
  float acc = rmul(w[0], v[0]);
  for (int j = 1; j < n; ++j) acc = xfma(w[j], v[j], acc);
  return acc;
}

// One stream. x [N], mem_x [Lx], mem_y [Ly]; a1/a2 [n_inter], b1/b2
// [n_tilt]; yr/zr: rings of kRing samples. Writes y [N].
ACX_HD void ltpf_lane(const float* x, const float* mem_x, const float* mem_y, int N, int Lx,
                      int Ly, const float* a1, const float* b1, const float* a2,
                      const float* b2, int n_inter, int n_tilt, int p1, int p2, int cases,
                      int inter_len, int N4, float* yr, float* zr, float* y) {
  const bool case_b = cases & CASE_B, case_c = cases & CASE_C, case_d = cases & CASE_D;
  const bool case_e = cases & CASE_E, new_on = cases & NEW_ON;
  for (int i = 0; i < Ly; ++i) {
    yr[i & (kRing - 1)] = mem_y[i];
    zr[i & (kRing - 1)] = mem_y[i];
  }
  const int lim = Ly + N - 1;
  const float inv_n4 = static_cast<float>(1.0 / static_cast<double>(N4));
  float xt[kMaxTaps], zt[kMaxTaps], yt[kMaxTaps], zx[kMaxTaps];
  for (int n = 0; n < N; ++n) {
    const int cur = Ly + n;  // position being produced
    // a read of a position not yet produced sees the zeros of the plain
    // version's buffers
    auto ring = [&](const float* r, int pos) {
      pos = iclamp(pos, 0, lim);
      return pos < cur ? r[pos & (kRing - 1)] : 0.0f;
    };
    for (int j = 0; j < n_tilt; ++j) {
      const int p = iclamp(Lx + n - j, 0, Lx + N - 1);
      xt[j] = p < Lx ? mem_x[p] : x[p - Lx];
    }
    const float s1_old = tap_dot(b1, xt, n_tilt);
    const int base1 = cur - p1 + inter_len - 1;
    for (int j = 0; j < n_inter; ++j) zt[j] = ring(zr, base1 - j);
    const float s2_old = tap_dot(a1, zt, n_inter);
    const bool in_fade = n < N4;
    const float c_out = rmul(static_cast<float>(N4 - n), inv_n4);
    const float z_n = xfma(c_out, s2_old, xfma(-c_out, s1_old, x[n]));

    const bool src_z = case_e && in_fade;
    const float* s1_src = xt;
    if (src_z) {
      zx[0] = z_n;
      for (int j = 1; j < n_tilt; ++j) zx[j] = ring(zr, cur - j);
      s1_src = zx;
    }
    const float s1_new = tap_dot(b2, s1_src, n_tilt);
    const int base2 = cur - p2 + inter_len - 1;
    for (int j = 0; j < n_inter; ++j) yt[j] = ring(yr, base2 - j);
    const float s2_new = tap_dot(a2, yt, n_inter);
    const float c_in = (in_fade && (case_c || case_e))
        ? rmul(static_cast<float>(n), inv_n4) : 1.0f;
    const float x_eff = src_z ? z_n : x[n];
    const float cand_new = xfma(c_in, s2_new, xfma(-c_in, s1_new, x_eff));

    float y_n = x[n];
    if (case_b && in_fade) y_n = z_n;
    if ((case_c || case_e) && in_fade) y_n = cand_new;
    if (case_d) y_n = cand_new;
    if (new_on && !in_fade) y_n = cand_new;
    yr[cur & (kRing - 1)] = y_n;
    zr[cur & (kRing - 1)] = case_e ? z_n : y_n;
    y[n] = y_n;
  }
}

#ifdef __CUDACC__
constexpr int kLtpfThreads = 16;

__global__ void ltpf_postfilter_kernel(const float* __restrict__ x,
                                       const float* __restrict__ mem_x,
                                       const float* __restrict__ mem_y,
                                       const float* __restrict__ a1, const float* __restrict__ b1,
                                       const float* __restrict__ a2, const float* __restrict__ b2,
                                       const int32_t* __restrict__ p1,
                                       const int32_t* __restrict__ p2,
                                       const int32_t* __restrict__ cases, float* __restrict__ y,
                                       int B, int N, int Lx, int Ly, int n_inter, int n_tilt,
                                       int inter_len, int N4) {
  extern __shared__ float rings[];
  const int s = blockIdx.x * blockDim.x + threadIdx.x;
  if (s >= B) return;
  float* yr = rings + threadIdx.x * 2 * kRing;
  float* zr = yr + kRing;
  float fa1[kMaxTaps], fb1[kMaxTaps], fa2[kMaxTaps], fb2[kMaxTaps];
  for (int j = 0; j < n_inter; ++j) {
    fa1[j] = a1[s * n_inter + j];
    fa2[j] = a2[s * n_inter + j];
  }
  for (int j = 0; j < n_tilt; ++j) {
    fb1[j] = b1[s * n_tilt + j];
    fb2[j] = b2[s * n_tilt + j];
  }
  ltpf_lane(x + static_cast<size_t>(s) * N, mem_x + static_cast<size_t>(s) * Lx,
            mem_y + static_cast<size_t>(s) * Ly, N, Lx, Ly, fa1, fb1, fa2, fb2, n_inter,
            n_tilt, p1[s], p2[s], cases[s], inter_len, N4, yr, zr,
            y + static_cast<size_t>(s) * N);
}

extern "C" int acx_ltpf_postfilter(const void* x, const void* mem_x, const void* mem_y,
                                   const void* a1, const void* b1, const void* a2,
                                   const void* b2, const void* p1, const void* p2,
                                   const void* cases, void* y, int B, int N, int Lx, int Ly,
                                   int n_inter, int n_tilt, int inter_len, int N4,
                                   void* stream) {
  if (Ly + 16 > kRing || n_inter > kMaxTaps || n_tilt > kMaxTaps) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const size_t smem = static_cast<size_t>(kLtpfThreads) * 2 * kRing * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(ltpf_postfilter_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const int blocks = (B + kLtpfThreads - 1) / kLtpfThreads;
  ltpf_postfilter_kernel<<<blocks, kLtpfThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<const float*>(mem_x),
      static_cast<const float*>(mem_y), static_cast<const float*>(a1),
      static_cast<const float*>(b1), static_cast<const float*>(a2),
      static_cast<const float*>(b2), static_cast<const int32_t*>(p1),
      static_cast<const int32_t*>(p2), static_cast<const int32_t*>(cases),
      static_cast<float*>(y), B, N, Lx, Ly, n_inter, n_tilt, inter_len, N4);
  return static_cast<int>(cudaGetLastError());
}
#endif
