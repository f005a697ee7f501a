// bit_estimate: the context-model bit count of a quantized spectrum.
//
// Replaces audio_codec_tpu/ops/quant.py:bit_estimate (quant.py:135, the
// lax.scan over 2-tuples at :219), processQuantizeSpec_fl in
// quantize_spec.c:78-168. Outputs nbits, nbits2, lastnz, lastnz2, lsbMode.
//
// Bound on an H100: the work is a chain of dependent steps per stream (the
// context c of each tuple depends on the previous one: up to N/2 = 200 steps
// at 48 kHz, each a few table lookups), and the bytes are one read of xq
// (B x N x 4) and five int32 outputs. At B = 2048 the bytes take about a
// microsecond at 3.35 TB/s; the chain is the bound.
// Design: one thread per stream keeps the context and the counts in
// registers; the 4096-entry lookup and the [64,17] bit table sit in shared
// memory, loaded once per block, so the per-step lookups hit shared memory.
#include "acodec.cuh"

using namespace acx;

// One stream. xq: its N coefficients; out[j * stride] the j-th output.
ACX_HD void bit_estimate_lane(const int32_t* xq, int N, int target, int mode,
                              int rate_flag, int max_lev, const int32_t* lookup,
                              const int32_t* bits_tab, int32_t* out, int stride) {
  int last_tup = 0;
  for (int k = N / 2 - 1; k >= 1; --k) {
    if (xq[2 * k] != 0 || xq[2 * k + 1] != 0) { last_tup = k; break; }
  }
  const int lastnz = 2 * last_tup + 1;
  const int n_act = (lastnz + 1) / 2;
  int c = 0, nbits = 0, nbits2 = 0, lastnz2 = 2, nbits_lsb = 0;
  for (int k = 0; k < n_act; ++k) {
    const int a = iabs(xq[2 * k]);
    const int b = iabs(xq[2 * k + 1]);
    const int t = c + rate_flag + (k > N / 4 ? 256 : 0);
    const int m = imax(a, b);
    const int nlev = m >= 4 ? imax(msb32(m) - 1, 0) : 0;
    const int nl = imin(nlev, max_lev);
    int nb = mode <= 0 ? (imin(a, 1) + imin(b, 1)) * 2048 : 0;
    int lsb = 0;
    for (int lev = 0; lev < nl; ++lev) {
      const int pki = lookup[iclamp(t + imin(lev, 3) * 1024, 0, 4095)];
      nb += bits_tab[pki * 17 + 16];
      if (lev == 0) {
        if (mode > 0) lsb += 2; else nb += 2 * 2048;
      } else {
        nb += 2 * 2048;
      }
    }
    const int aa = a >> nl, bb = b >> nl;
    const int pki = lookup[iclamp(t + imin(nlev, 3) * 1024, 0, 4095)];
    nb += bits_tab[pki * 17 + iclamp(aa + 4 * bb, 0, 16)];
    const int a1 = nlev > 0 ? a >> 1 : a;
    const int b1 = nlev > 0 ? b >> 1 : b;
    if (nlev > 0 && a1 == 0 && a != 0) lsb += 1;
    if (nlev > 0 && b1 == 0 && b != 0) lsb += 1;
    if (mode > 0) nb += (imin(a1, 1) + imin(b1, 1)) * 2048;
    nbits += nb;
    nbits_lsb += lsb;
    if (mode >= 0 && (a != 0 || b != 0) && nbits <= target * 2048) {
      lastnz2 = 2 * k + 2;
      nbits2 = nbits;
    }
    const int levm1 = imin(nlev, 3) - 1;
    const int t_next = levm1 <= 0 ? 1 + (aa + bb) * (levm1 + 2) : 13 + levm1;
    c = (c & 15) * 16 + t_next;
  }
  int nbits_f = (nbits + 2047) / 2048;
  int nbits2_f;
  if (mode >= 0) {
    nbits2_f = (nbits2 + 2047) / 2048;
  } else {
    nbits2_f = nbits_f;
    lastnz2 = lastnz + 1;
  }
  if (mode > 0) {
    nbits_f += nbits_lsb;
    nbits2_f += nbits_lsb;
  }
  out[0] = nbits_f;
  out[stride] = nbits2_f;
  out[2 * stride] = lastnz;
  out[3 * stride] = lastnz2;
  out[4 * stride] = (mode > 0 && nbits_f > target) ? 1 : 0;
}

#ifdef __CUDACC__
constexpr int kBitEstThreads = 32;

__global__ void bit_estimate_kernel(const int32_t* __restrict__ xq,
                                    const int32_t* __restrict__ target,
                                    int32_t* __restrict__ out,
                                    const int32_t* __restrict__ lookup_g,
                                    const int32_t* __restrict__ bits_g, int B, int N,
                                    int mode, int rate_flag, int max_lev) {
  __shared__ int32_t lookup[4096];
  __shared__ int32_t bits_tab[64 * 17];
  acx_load_shared(lookup, lookup_g, 4096);
  acx_load_shared(bits_tab, bits_g, 64 * 17);
  __syncthreads();
  const int s = blockIdx.x * blockDim.x + threadIdx.x;
  if (s >= B) return;
  bit_estimate_lane(xq + static_cast<size_t>(s) * N, N, target[s], mode, rate_flag,
                    max_lev, lookup, bits_tab, out + s, B);
}

extern "C" int acx_bit_estimate(const void* xq, const void* target, void* out,
                                const void* lookup, const void* bits_tab, int B, int N,
                                int mode, int rate_flag, int max_lev, void* stream) {
  const int blocks = (B + kBitEstThreads - 1) / kBitEstThreads;
  bit_estimate_kernel<<<blocks, kBitEstThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(xq), static_cast<const int32_t*>(target),
      static_cast<int32_t*>(out), static_cast<const int32_t*>(lookup),
      static_cast<const int32_t*>(bits_tab), B, N, mode, rate_flag, max_lev);
  return static_cast<int>(cudaGetLastError());
}
#endif
