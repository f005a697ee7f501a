// ltpf_encode: the encoder's LTPF pitch refinement and activation decision.
//
// Replaces audio_codec_tpu/ops/analysis.py:ltpf_encode (analysis.py:163,
// with _ltpf_interp_matrix at :146): a [B, 205, 128] gather and two products
// over all 205 lags, of which only the 17 around the open-loop pitch are
// read, then about 80 [B]-wide ops for the searches, the interpolated
// normalised correlation and the activation rules.
//
// Bound on an H100: reads the frame (129 samples), the 232-sample memory and
// six scalars, writes the memory again and ten scalars: about 2.9 KB a
// stream, 6.0 MB at B = 2048, 0.0018 ms at 3.35 TB/s. The work is 17 lags x
// 128 samples x 2 multiply-adds, the energy, <= 7 x 17 interpolation taps and
// 128 x 3 normcorr products a stream, about 11 M operations at B = 2048. What
// bounds it is the chains the plain version's order keeps sequential: a lag's
// correlation and energy over 128 samples, the interpolation over 17 entries,
// the normcorr's three sums over 128 products.
// Design: a warp a stream (ltpf_encode.cuh:ltpf_encode_warp), blocks of 4
// warps sharing the tables; the row staged in shared memory with 16-byte
// loads of the memory, every load of a lane in flight at once; each chain on
// a lane of its own, unrolled at a compile-time correlation length (ACF, 128
// at 10 ms, 64 at 5 and 2.5 ms), the block's energy on lane 17 beside the 17
// window lanes, the <= 7 fractional candidates on lanes 0-6 at once, the
// searches as first-maximum shuffle trees.
#include "ltpf_encode.cuh"

using namespace acx;

#ifdef __CUDACC__
constexpr int kLtpfWarps = 4;   // streams a block

template <int ACF>
__global__ void ltpf_encode_kernel(const float* __restrict__ s12k8,
                                   const int32_t* __restrict__ pitch_ol,
                                   const float* __restrict__ nc_ol,
                                   const float* __restrict__ mem_in,
                                   const float* __restrict__ mem_nc,
                                   const float* __restrict__ mem_mem_nc,
                                   const int32_t* __restrict__ mem_on,
                                   const float* __restrict__ mem_pitch,
                                   const float* __restrict__ tables, int32_t* __restrict__ param,
                                   int32_t* __restrict__ bits, float* __restrict__ new_mem_in,
                                   float* __restrict__ nc_out, float* __restrict__ mem_mem_out,
                                   int32_t* __restrict__ on_out, float* __restrict__ pitch_out,
                                   int B, LtpfGeom g) {
  __shared__ float tab[kLtpfTableWords];
  __shared__ LtpfScratch scratch[kLtpfWarps];
  for (int i = threadIdx.x; i < kLtpfTableWords; i += blockDim.x) tab[i] = tables[i];
  __syncthreads();
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int b = blockIdx.x * kLtpfWarps + warp;
  if (b >= B) return;   // the whole warp leaves together
  const LtpfStream s = {s12k8 + static_cast<size_t>(b) * g.xlen,
                        mem_in + static_cast<size_t>(b) * g.mem_len,
                        pitch_ol[b], nc_ol[b], mem_nc[b], mem_mem_nc[b], mem_on[b], mem_pitch[b]};
  const LtpfOut o = ltpf_encode_warp<ACF>(CoderCardWarp{lane}, s, tab, g, scratch[warp],
                                          new_mem_in + static_cast<size_t>(b) * g.mem_len);
  if (lane == 0) {
    param[3 * static_cast<size_t>(b)] = o.param[0];
    param[3 * static_cast<size_t>(b) + 1] = o.param[1];
    param[3 * static_cast<size_t>(b) + 2] = o.param[2];
    bits[b] = o.bits;
    nc_out[b] = o.nc;
    mem_mem_out[b] = o.mem_mem_nc;
    on_out[b] = o.on;
    pitch_out[b] = o.pitch;
  }
}

template <int ACF>
static void ltpf_encode_launch(const void* const* a, void* const* o, int B, const LtpfGeom& g,
                               cudaStream_t stream) {
  const int blocks = (B + kLtpfWarps - 1) / kLtpfWarps;
  auto f = [](const void* v) { return static_cast<const float*>(v); };
  auto i = [](const void* v) { return static_cast<const int32_t*>(v); };
  ltpf_encode_kernel<ACF><<<blocks, 32 * kLtpfWarps, 0, stream>>>(
      f(a[0]), i(a[1]), f(a[2]), f(a[3]), f(a[4]), f(a[5]), i(a[6]), f(a[7]), f(a[8]),
      static_cast<int32_t*>(o[0]), static_cast<int32_t*>(o[1]), static_cast<float*>(o[2]),
      static_cast<float*>(o[3]), static_cast<float*>(o[4]), static_cast<int32_t*>(o[5]),
      static_cast<float*>(o[6]), B, g);
}

extern "C" int acx_ltpf_encode(const void* s12k8, const void* pitch_ol, const void* nc_ol,
                               const void* mem_in, const void* mem_nc, const void* mem_mem_nc,
                               const void* mem_on, const void* mem_pitch, const void* tables,
                               void* param, void* bits, void* new_mem_in, void* nc_out,
                               void* mem_mem_out, void* on_out, void* pitch_out, int B, int xlen,
                               int N, int mem_len, int acflen, int xbase, int frame_dms,
                               int enable, void* stream) {
  const LtpfGeom g = {xlen, N, mem_len, acflen, xbase, frame_dms, enable};
  if (ltpf_row_len(g) > kLtpfMaxRow || (acflen != 128 && acflen != 64) || xbase % 4 != 0 ||
      xbase - kLtpfLag0 - (kLtpfLags - 1) < 0 || xbase + acflen >= ltpf_row_len(g) ||
      N + mem_len > ltpf_row_len(g)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const void* a[9] = {s12k8, pitch_ol, nc_ol, mem_in, mem_nc, mem_mem_nc, mem_on, mem_pitch,
                      tables};
  void* const o[7] = {param, bits, new_mem_in, nc_out, mem_mem_out, on_out, pitch_out};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (acflen == 128) {
    ltpf_encode_launch<128>(a, o, B, g, st);
  } else {
    ltpf_encode_launch<64>(a, o, B, g, st);
  }
  return static_cast<int>(cudaGetLastError());
}
#endif
