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
// Design: one warp per stream, lane l on the lines l, l + 32, ...
// (spec_decode.cuh). Where bfi is 2, lanes 0-3 each run one of the
// concealment's four energy chains. One pass conceals, writes the history
// row and nudges each nonzero line by the residual bit of its rank (a ballot
// prefix) into a shared row; after it, one pass tests the zero lines on that
// row, fills each with the generator's closed form at its rank among the
// filled lines (a ballot prefix; the tables in shared memory) and applies the
// gain.
#include "spec_decode.cuh"

using namespace acx;

#ifdef __CUDACC__
constexpr int kSpecWarps = 4;
constexpr unsigned kFullMask = 0xffffffffu;

// The [B] inputs, in the order of the kernel's int32 and float vectors.
enum { kSpecBfi, kSpecRframe, kSpecInv, kSpecBw, kSpecFacNs, kSpecResPresent, kSpecNRes,
       kSpecSeed, kSpecZero, kSpecPrevBw, kSpecNbLost, kSpecInts };
enum { kSpecGain, kSpecPrevGg, kSpecPrevFacNs, kSpecFloats };

__global__ void spec_decode_kernel(const float* __restrict__ x,
                                   const int32_t* __restrict__ ints,
                                   const float* __restrict__ floats,
                                   const int32_t* __restrict__ res_bits,
                                   const float* __restrict__ q_old_res,
                                   const float* __restrict__ q_old_d,
                                   const int32_t* __restrict__ bw_bins,
                                   const int32_t* __restrict__ lcg,
                                   float* __restrict__ x_out, float* __restrict__ q_old_res_out,
                                   float* __restrict__ prev_gg_out,
                                   int32_t* __restrict__ prev_bw_out,
                                   float* __restrict__ prev_fac_ns_out,
                                   int32_t* __restrict__ nb_lost_out, int B, SpecGeom g) {
  __shared__ int32_t bins[kSpecBwCutoffs];
  __shared__ int32_t lcg_s[2 * (kSpecMaxLines + 1)];
  __shared__ float rows[kSpecWarps][kSpecMaxLines];
  const int N = g.N;
  if (threadIdx.x < kSpecBwCutoffs) bins[threadIdx.x] = bw_bins[threadIdx.x];
  for (int i = threadIdx.x; i < 2 * (N + 1); i += blockDim.x) lcg_s[i] = lcg[i];
  __syncthreads();
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
  const size_t row = static_cast<size_t>(b) * N;
  const float* xr = x + row;
  const float* qr = q_old_res + row;

  // the concealment's four energies, one chain a lane, where bfi is 2
  float fac = 1.0f, fac_local = 0.0f;
  if (s.bfi == 2) {
    const int inv = iclamp(s.spec_inv_idx, 0, N);
    const float* qd = q_old_d + row;
    // ener_prev, ener_curr, mean_low, mean_high on lanes 0-3, one code path
    const float* a = lane == 0 ? qr : (lane == 1 ? xr : qd);
    const float e = lane < 4 ? spec_energy(a, lane == 3 ? inv : 0, lane == 3 ? N : inv) : 0.0f;
    const float ener_prev = __shfl_sync(kFullMask, e, 0);
    const float ener_curr = __shfl_sync(kFullMask, e, 1);
    const float mean_low = __shfl_sync(kFullMask, e, 2);
    const float mean_high = __shfl_sync(kFullMask, e, 3);
    fac = spec_fac(ener_prev, ener_curr);
    fac_local = spec_fac_local(mean_low, mean_high, ener_prev, ener_curr, s.spec_inv_idx, N, s);
  }
  const SpecHistory h = spec_history(s, fac, N, bins);
  if (lane == 0) {
    prev_gg_out[b] = h.prev_gg;
    prev_bw_out[b] = h.prev_bw_idx;
    prev_fac_ns_out[b] = h.prev_fac_ns;
    nb_lost_out[b] = h.nb_lost;
  }

  // the concealed spectrum, the history row and the residual's nudges
  const bool good = s.bfi != 1;
  const bool residual = good && s.residual_present == 1;
  const unsigned below = (1u << lane) - 1u;
  float* v_row = rows[warp];
  int rank0 = 0;
  for (int c = 0; c * 32 < N; ++c) {
    const int k = c * 32 + lane;
    float v = 0.0f;
    if (k < N) {
      v = spec_concealed(xr, qr, k, s, fac_local);
      q_old_res_out[row + k] = good ? v : qr[k];
    }
    const bool nz = k < N && residual && v != 0.0f;
    const unsigned m = __ballot_sync(kFullMask, nz);
    const int rank = rank0 + __popc(m & below);
    if (nz && rank < s.n_res) {
      v = spec_nudge(v, res_bits[static_cast<size_t>(b) * g.res_width +
                                 iclamp(rank, 0, g.res_width - 1)]);
    }
    rank0 += __popc(m);
    if (k < N) {
      if (good) {
        v_row[k] = v;
      } else {
        x_out[row + k] = v;
      }
    }
  }
  if (!good) return;
  __syncwarp();

  // noise filling in the zero lines of that row, and the global gain
  const bool fill = s.zero_frame == 0;
  int filled0 = 0;
  for (int c = 0; c * 32 < N; ++c) {
    const int k = c * 32 + lane;
    const bool z = k < N && fill && spec_zero_line(v_row, k, h.bw_bin_nf, g);
    const unsigned m = __ballot_sync(kFullMask, z);
    if (k < N) {
      const float v = z ? spec_fill(k, filled0 + __popc(m & below), s, lcg_s, N) : v_row[k];
      x_out[row + k] = rmul(v, s.gain);
    }
    filled0 += __popc(m);
  }
}

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
  const int blocks = (B + kSpecWarps - 1) / kSpecWarps;
  spec_decode_kernel<<<blocks, 32 * kSpecWarps, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<const int32_t*>(ints),
      static_cast<const float*>(floats), static_cast<const int32_t*>(res_bits),
      static_cast<const float*>(q_old_res), static_cast<const float*>(q_old_d),
      static_cast<const int32_t*>(bw_bins), static_cast<const int32_t*>(lcg),
      static_cast<float*>(x_out), static_cast<float*>(q_old_res_out),
      static_cast<float*>(prev_gg_out), static_cast<int32_t*>(prev_bw_out),
      static_cast<float*>(prev_fac_ns_out), static_cast<int32_t*>(nb_lost_out), B, g);
  return static_cast<int>(cudaGetLastError());
}
#endif
