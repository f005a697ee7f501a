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
// 3.35 TB/s. What a stream waits for is the noise factor's chain: one
// dependent add a zero line.
// Design: a warp a stream (noise_residual_enc.cuh:noise_residual_enc_warp),
// lane l on the lines l, l + 32, ..., the row loaded once into registers
// with coalesced loads; the nonzero lines as ballots, so that a zero-line
// test is bit operations on two 64-bit words of them; the zero lines'
// values |x / gain| stored compacted in line order in shared memory, and
// the chains over them alone (adding the +0 of a line that is not a zero
// line gives the sum back), 16-byte loads issued a round ahead of the adds,
// the half means' chains on lanes 1 and 2 beside lane 0's; a nonzero line's
// residual rank is its ballot prefix, so the bits are written in parallel.
// NC = ceil(N / 32) is a template parameter, so the row stays in registers.
#include "noise_residual_enc.cuh"

using namespace acx;

#ifdef __CUDACC__
constexpr int kNfWarps = 4;   // streams a block

template <int NC>
__global__ void __launch_bounds__(kNfWarps * 32)
    noise_residual_enc_kernel(const float* __restrict__ x, const int32_t* __restrict__ xq,
                              const float* __restrict__ gain, const int32_t* __restrict__ bw_bin,
                              const int32_t* __restrict__ target,
                              const int32_t* __restrict__ nbits2,
                              const int32_t* __restrict__ lsb_mode,
                              int32_t* __restrict__ fac_ns_idx, int32_t* __restrict__ res,
                              int32_t* __restrict__ n_res, int B, NfEncGeom g) {
  __shared__ alignas(16) float vals[kNfWarps][kNfScratch];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int b = blockIdx.x * kNfWarps + warp;
  if (b >= B) return;   // the whole warp leaves together
  const size_t row = static_cast<size_t>(b) * g.N;
  noise_residual_enc_warp<NC>(CoderCardWarp{lane}, x + row, xq + row, gain[b], bw_bin[b],
                              target[b], nbits2[b], lsb_mode[b], g, vals[warp], fac_ns_idx + b,
                              res + static_cast<size_t>(b) * g.max_res, n_res + b);
}

template <int NC>
static void launch(const void* const* a, void* const* o, int B, const NfEncGeom& g,
                   cudaStream_t stream) {
  const int blocks = (B + kNfWarps - 1) / kNfWarps;
  noise_residual_enc_kernel<NC><<<blocks, 32 * kNfWarps, 0, stream>>>(
      static_cast<const float*>(a[0]), static_cast<const int32_t*>(a[1]),
      static_cast<const float*>(a[2]), static_cast<const int32_t*>(a[3]),
      static_cast<const int32_t*>(a[4]), static_cast<const int32_t*>(a[5]),
      static_cast<const int32_t*>(a[6]), static_cast<int32_t*>(o[0]),
      static_cast<int32_t*>(o[1]), static_cast<int32_t*>(o[2]), B, g);
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
  const void* a[7] = {x, xq, gain, bw_bin, target, nbits2, lsb_mode};
  void* o[3] = {fac_ns_idx, res, n_res};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch ((N + 31) / 32) {
    case 1: launch<1>(a, o, B, g, s); break;
    case 2: launch<2>(a, o, B, g, s); break;
    case 3: launch<3>(a, o, B, g, s); break;
    case 4: launch<4>(a, o, B, g, s); break;
    case 5: launch<5>(a, o, B, g, s); break;
    case 6: launch<6>(a, o, B, g, s); break;
    case 7: launch<7>(a, o, B, g, s); break;
    case 8: launch<8>(a, o, B, g, s); break;
    case 9: launch<9>(a, o, B, g, s); break;
    case 10: launch<10>(a, o, B, g, s); break;
    case 11: launch<11>(a, o, B, g, s); break;
    case 12: launch<12>(a, o, B, g, s); break;
    default: launch<13>(a, o, B, g, s); break;
  }
  return static_cast<int>(cudaGetLastError());
}
#endif
