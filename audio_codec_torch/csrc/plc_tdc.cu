// plc_tdc: the advanced concealment's method classifier, LPC analysis and
// time-domain concealment (TD-PLC) for one frame of B streams.
//
// Replaces audio_codec_tpu/ops/plc_adv.py: classify (:129, with _xcorr :59
// and _spectral_centroid :80), tdc_lpc (:165) and tdc_apply (:236, its LPC
// synthesis and de-emphasis scans :398 and :408, the generator _lcg16 :217),
// as the reference decoder composes them (models/decoder.py:233-252). The
// reference runs all of it for every stream of every frame and selects; here
// a stream that is not lost only copies its state through, the classifier and
// the LPC analysis run at the first loss of a burst, and TD-PLC only where the
// burst's method is 3.
//
// Bound on an H100: per TD-PLC stream at a first loss about 19 000 fused
// multiply-adds for the residual, 11 000 for the filters, 12 500 dependent
// ones for the order-16 synthesis over 780 samples and 780 for the
// de-emphasis; the bytes are the rows in and out, 16 KB a stream (33 MB at
// B = 2048 if every stream were concealed). The synthesis is a recurrence:
// one lane runs it, 780 x 16 steps of three double operations in a chain,
// which bounds a concealed stream far above its bytes or its operations.
// Design: a warp a stream, one block a warp; the residual, the filters, the
// generator (in closed form), the ramps and the windowed sums spread over the
// lanes; the Levinson recursion, the synthesis and the de-emphasis on lane 0.
// The work rows (19 KB) live in shared memory. The float order is the plain
// version's (plc_tdc.cuh, plc.cuh), so the two agree bit for bit.
#include "plc_tdc.cuh"

using namespace acx;

#ifdef __CUDACC__
__global__ void plc_tdc_kernel(const float* __restrict__ x, const float* __restrict__ scf,
                               const float* __restrict__ q, const float* __restrict__ a_in,
                               const float* __restrict__ harm_in,
                               const float* __restrict__ hist_in, const int32_t* __restrict__ ints,
                               const float* __restrict__ floats, const float* __restrict__ ftab,
                               const int32_t* __restrict__ itab, float* __restrict__ a_out,
                               float* __restrict__ synth, float* __restrict__ harm,
                               float* __restrict__ hist, int32_t* __restrict__ iout,
                               float* __restrict__ fout, int B, TdcGeom g) {
  extern __shared__ float smem[];
  TdcWork* ws = reinterpret_cast<TdcWork*>(smem);
  const int b = blockIdx.x;
  if (b >= B) return;
  const CardWarp w{static_cast<int>(threadIdx.x)};
  const size_t bb = static_cast<size_t>(b);
  TdcStream s;
  s.x = x + bb * g.L;
  s.scf = scf + bb * 16;
  s.q = q + bb * g.N;
  s.a_in = a_in + bb * 17;
  s.harm_in = harm_in + bb * g.MP;
  s.hist_in = hist_in + bb * kTdcOrder;
  s.lost = ints[b];
  s.nb = ints[B + b];
  s.pitch = ints[2 * B + b];
  s.pitch_fr = ints[3 * B + b];
  s.meth_in = ints[4 * B + b];
  s.seed_in = ints[5 * B + b];
  s.fract_in = ints[6 * B + b];
  s.hlen_in = ints[7 * B + b];
  s.stab = floats[b];
  s.gain_c_in = floats[B + b];
  s.alpha_in = floats[2 * B + b];
  s.a = a_out + bb * 17;
  s.synth = synth + bb * g.length;
  s.harm = harm + bb * g.MP;
  s.hist = hist + bb * kTdcOrder;
  s.meth = iout + b;
  s.seed = iout + B + b;
  s.fract = iout + 2 * B + b;
  s.hlen = iout + 3 * B + b;
  s.nc = fout + b;
  s.gain_c = fout + B + b;
  s.alpha = fout + 2 * B + b;
  plc_tdc_stream(w, s, g, tdc_tables(ftab, itab, g.n_bands), ws);
}

extern "C" int acx_plc_tdc(const void* x, const void* scf, const void* q, const void* a_in,
                           const void* harm_in, const void* hist_in, const void* ints,
                           const void* floats, const void* ftab, const void* itab, void* a_out,
                           void* synth, void* harm, void* hist, void* iout, void* fout, int B,
                           int L, int MP, int fl, int length, int N, int lpc_order, int n_bands,
                           int rect, int pitch_min2, int frame_dms, float pre_fac, float atten,
                           float cent_fac, void* stream) {
  const int fl2 = fl / 2;
  if (MP + fl2 + kTdcOrder > static_cast<int>(sizeof(TdcWork::pe) / 4) ||
      MP + fl2 > static_cast<int>(sizeof(TdcWork::exc) / 4) ||
      length > static_cast<int>(sizeof(TdcWork::e2) / 4) ||
      length + kTdcFir - 1 > static_cast<int>(sizeof(TdcWork::rnd) / 4) ||
      MP > static_cast<int>(sizeof(TdcWork::harm) / 4) || n_bands > kTdcMaxBands ||
      lpc_order > kTdcOrder || rect > 1024 || fl2 > 1024 || frame_dms != 100) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (B == 0) return static_cast<int>(cudaSuccess);
  const TdcGeom g = {L, MP, fl, length, N, lpc_order, n_bands, rect, pitch_min2, frame_dms,
                     pre_fac, atten, cent_fac};
  plc_tdc_kernel<<<B, 32, sizeof(TdcWork), static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<const float*>(scf), static_cast<const float*>(q),
      static_cast<const float*>(a_in), static_cast<const float*>(harm_in),
      static_cast<const float*>(hist_in), static_cast<const int32_t*>(ints),
      static_cast<const float*>(floats), static_cast<const float*>(ftab),
      static_cast<const int32_t*>(itab), static_cast<float*>(a_out), static_cast<float*>(synth),
      static_cast<float*>(harm), static_cast<float*>(hist), static_cast<int32_t*>(iout),
      static_cast<float*>(fout), B, g);
  return static_cast<int>(cudaGetLastError());
}
#endif
