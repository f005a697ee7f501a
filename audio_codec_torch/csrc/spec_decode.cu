// spec_decode: the decoder's spectrum reconstruction, from partial
// concealment to the global gain.
//
// Replaces the tensor code the reference composes at
// audio_codec_tpu/models/decoder.py:103-125: ops/pc.py:pc_apply (pc.py:142)
// and pc_update (:184), the lost-frame count's reset, ops/quant.py:
// residual_decode (:358), noise_filling (:417) with its closed-form
// generator, and apply_global_gain (:391), each masked per stream; about 90
// [B, 400]-wide launches a frame in the port's tensor code, on every clean
// frame too.
//
// Bound on an H100, on clean frames: reads the decoded spectrum (400 floats),
// the residual bits of the lines that carry one (int32), fourteen scalars and
// the gain, writes the spectrum, the concealment's history row and four
// scalars: about 5-8 KB a stream, 12-16 MB at B = 2048, 0.004-0.005 ms at
// 3.35 TB/s. A partially corrupt frame (bfi 2) also reads the two history
// rows of the concealment.
// Design: a warp a stream (spec_decode.cuh:spec_decode_warp), lane l on the
// lines l, l + 32, ...; NC = ceil(N / 32) is a template parameter, so the
// row stays in registers. Every load of a stream (its row, its residual bits,
// the previous row of a lossy frame) is issued before the first ballot; the
// residual bits become ballot words, so a line's bit is a shuffle at its rank
// (a ballot prefix), not a dependent load; the zero-line test is a few bits
// of the nonzero lines' ballots; the noise filler's generator is carried
// from chunk to chunk by shuffles (lane l the map of l steps), so no table is
// read. Where bfi is 2, lanes 0-3 each run one of the concealment's four
// energy chains.
#include "spec_decode.cuh"

using namespace acx;

#ifdef __CUDACC__
constexpr int kSpecWarps = 4;   // streams a block

// The [B] inputs, in the order of the kernel's int32 and float vectors.
enum { kSpecBfi, kSpecRframe, kSpecInv, kSpecBw, kSpecFacNs, kSpecResPresent, kSpecNRes,
       kSpecSeed, kSpecZero, kSpecPrevBw, kSpecNbLost, kSpecInts };
enum { kSpecGain, kSpecPrevGg, kSpecPrevFacNs, kSpecFloats };

template <int NC>
__global__ void __launch_bounds__(kSpecWarps * 32)
    spec_decode_kernel(const float* __restrict__ x, const int32_t* __restrict__ ints,
                       const float* __restrict__ floats, const int32_t* __restrict__ res_bits,
                       const float* __restrict__ q_old_res, const float* __restrict__ q_old_d,
                       const int32_t* __restrict__ bw_bins, float* __restrict__ x_out,
                       float* __restrict__ q_old_res_out,
                       float* __restrict__ prev_gg_out, int32_t* __restrict__ prev_bw_out,
                       float* __restrict__ prev_fac_ns_out, int32_t* __restrict__ nb_lost_out,
                       int B, SpecGeom g) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int b = blockIdx.x * kSpecWarps + warp;
  if (b >= B) return;   // the whole warp leaves together
  auto in = [&](int k) { return ints[static_cast<size_t>(k) * B + b]; };
  auto fl = [&](int k) { return floats[static_cast<size_t>(k) * B + b]; };
  SpecScalars s;
  s.gain = fl(kSpecGain);
  s.bfi = in(kSpecBfi);
  s.rframe = in(kSpecRframe);
  s.spec_inv_idx = in(kSpecInv);
  s.bw_idx = in(kSpecBw);
  s.fac_ns_idx = in(kSpecFacNs);
  s.residual_present = in(kSpecResPresent);
  s.n_res = in(kSpecNRes);
  s.nf_seed = in(kSpecSeed);
  s.zero_frame = in(kSpecZero);
  s.prev_gg = fl(kSpecPrevGg);
  s.prev_bw_idx = in(kSpecPrevBw);
  s.prev_fac_ns = fl(kSpecPrevFacNs);
  s.nb_lost = in(kSpecNbLost);
  const size_t row = static_cast<size_t>(b) * g.N;
  const SpecHistory h = spec_decode_warp<NC>(
      CoderCardWarp{lane}, x + row, q_old_res + row, q_old_d + row,
      res_bits + static_cast<size_t>(b) * g.res_width, s, bw_bins, g, x_out + row,
      q_old_res_out + row);
  if (lane == 0) {
    prev_gg_out[b] = h.prev_gg;
    prev_bw_out[b] = h.prev_bw_idx;
    prev_fac_ns_out[b] = h.prev_fac_ns;
    nb_lost_out[b] = h.nb_lost;
  }
}

template <int NC>
static void launch(const void* const* a, void* const* o, int B, const SpecGeom& g,
                   cudaStream_t stream) {
  const int blocks = (B + kSpecWarps - 1) / kSpecWarps;
  spec_decode_kernel<NC><<<blocks, 32 * kSpecWarps, 0, stream>>>(
      static_cast<const float*>(a[0]), static_cast<const int32_t*>(a[1]),
      static_cast<const float*>(a[2]), static_cast<const int32_t*>(a[3]),
      static_cast<const float*>(a[4]), static_cast<const float*>(a[5]),
      static_cast<const int32_t*>(a[6]), static_cast<float*>(o[0]), static_cast<float*>(o[1]),
      static_cast<float*>(o[2]), static_cast<int32_t*>(o[3]), static_cast<float*>(o[4]),
      static_cast<int32_t*>(o[5]), B, g);
}

// lcg: the generator's closed-form tables of the first design, which the
// warp no longer reads (it carries the generator by shuffles); the entry point
// keeps its arguments.
extern "C" int acx_spec_decode(const void* x, const void* ints, const void* floats,
                               const void* res_bits, const void* q_old_res, const void* q_old_d,
                               const void* bw_bins, const void* lcg, void* x_out,
                               void* q_old_res_out, void* prev_gg_out, void* prev_bw_out,
                               void* prev_fac_ns_out, void* nb_lost_out, int B, int N, int width,
                               int start, int res_width, void* stream) {
  if (N < 1 || N > kSpecMaxLines || width < 1 || res_width < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const SpecGeom g = {N, width, start, res_width};
  const void* a[7] = {x, ints, floats, res_bits, q_old_res, q_old_d, bw_bins};
  void* o[6] = {x_out, q_old_res_out, prev_gg_out, prev_bw_out, prev_fac_ns_out, nb_lost_out};
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
