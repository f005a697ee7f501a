// noise_residual_enc: the encoder's noise factor and residual coder, with the
// lsbMode mask of the residual bit count.
//
// Replaces audio_codec_tpu/ops/quant.py:noise_factor (quant.py:279) and
// residual_encode (quant.py:326), and the port's mask
// n_res = where(lsb_mode == 0, n_res, 0) (models/encoder.py): seven rolls for
// the zero-line mask, masked sums, a rounding, a cumulative-sum rank and a
// scatter, about 50 [B, 400]-wide launches a frame in the port's tensor code.
//
// Bound on an H100: reads the spectrum (400 floats), the quantized spectrum
// (400 ints) and five scalars, writes 400 residual bits (int32) and two
// scalars: about 4.8 KB a stream, 9.9 MB at B = 2048, 0.0029 ms at
// 3.35 TB/s.
// Design: one warp per stream, lane l on the lines l, l + 32, ...: the
// zero-line tests and |x / gain| in parallel into shared memory, the counts by
// ballots; lane 0 then runs the chains over the 400 values in line order, as
// the plain version orders them (noise_residual_enc.cuh); a nonzero line's
// residual rank is its ballot prefix, so the bits are written in parallel.
#include "noise_residual_enc.cuh"

using namespace acx;

#ifdef __CUDACC__
constexpr int kNfWarps = 4;
constexpr int kNfChunks = kNfMaxLines / 32;
constexpr unsigned kFullMask = 0xffffffffu;

__global__ void noise_residual_enc_kernel(const float* __restrict__ x,
                                          const int32_t* __restrict__ xq,
                                          const float* __restrict__ gain,
                                          const int32_t* __restrict__ bw_bin,
                                          const int32_t* __restrict__ target,
                                          const int32_t* __restrict__ nbits2,
                                          const int32_t* __restrict__ lsb_mode,
                                          int32_t* __restrict__ fac_ns_idx,
                                          int32_t* __restrict__ res, int32_t* __restrict__ n_res,
                                          int B, NfEncGeom g) {
  __shared__ float vals[kNfWarps][kNfMaxLines];
  __shared__ unsigned zero_mask[kNfWarps][kNfChunks];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int b = blockIdx.x * kNfWarps + warp;
  if (b >= B) return;   // the whole warp leaves together
  const size_t row = static_cast<size_t>(b) * g.N;
  const float* xr = x + row;
  const int32_t* qr = xq + row;
  const float gn = gain[b];
  const int bw = iclamp(bw_bin[b], 0, g.N);
  float* v = vals[warp];
  int kcnt = 0, lines = 0, n_nz = 0;
  for (int c = 0; c * 32 < g.N; ++c) {
    const int k = c * 32 + lane;
    const bool z = k < g.N && nf_enc_zero_line(qr, k, bw, g);
    if (k < g.N) v[k] = nf_enc_value(xr, k, gn, z);
    const unsigned zm = __ballot_sync(kFullMask, z);
    if (lane == 0) zero_mask[warp][c] = zm;
    kcnt += __popc(zm);
    lines += z ? k + 1 : 0;
    // the residual bit of a nonzero line at its rank among the nonzero lines
    const bool nz = k < g.N && qr[k] != 0;
    const unsigned nm = __ballot_sync(kFullMask, nz);
    const int rank = n_nz + __popc(nm & ((1u << lane) - 1u));
    if (nz && rank < g.max_res) {
      res[static_cast<size_t>(b) * g.max_res + rank] = nf_enc_res_bit(xr, qr, k, gn);
    }
    n_nz += __popc(nm);
  }
  for (int i = imin(n_nz, g.max_res) + lane; i < g.max_res; i += 32) {
    res[static_cast<size_t>(b) * g.max_res + i] = 0;
  }
  lines = __reduce_add_sync(kFullMask, lines);
  __syncwarp();
  if (lane == 0) {
    const int mid = kcnt > 0 ? lines / kcnt : 0;
    int nlo = 0;
    for (int c = 0; c * 32 < mid; ++c) {
      const int below = mid - c * 32;
      nlo += __popc(below >= 32 ? zero_mask[warp][c] : zero_mask[warp][c] & ((1u << below) - 1u));
    }
    fac_ns_idx[b] = nf_enc_index(v, g.N, kcnt, mid, nlo, g);
    n_res[b] = nf_enc_n_res(n_nz, target[b], nbits2[b], lsb_mode[b]);
  }
}

extern "C" int acx_noise_residual_enc(const void* x, const void* xq, const void* gain,
                                      const void* bw_bin, const void* target, const void* nbits2,
                                      const void* lsb_mode, void* fac_ns_idx, void* res,
                                      void* n_res, int B, int N, int width, int start,
                                      int half_means, int max_res, void* stream) {
  if (N < 1 || N > kNfMaxLines || width < 1 || max_res < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const NfEncGeom g = {N, width, start, half_means, max_res};
  const int blocks = (B + kNfWarps - 1) / kNfWarps;
  noise_residual_enc_kernel<<<blocks, 32 * kNfWarps, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<const int32_t*>(xq),
      static_cast<const float*>(gain), static_cast<const int32_t*>(bw_bin),
      static_cast<const int32_t*>(target), static_cast<const int32_t*>(nbits2),
      static_cast<const int32_t*>(lsb_mode), static_cast<int32_t*>(fac_ns_idx),
      static_cast<int32_t*>(res), static_cast<int32_t*>(n_res), B, g);
  return static_cast<int>(cudaGetLastError());
}
#endif
