// ltpf_decode: the LTPF decoder whole, its parameter decode and its
// post-filter, one launch a frame.
//
// Replaces audio_codec_tpu/ops/ltpf_dec.py:ltpf_decode (ltpf_dec.py:59-166:
// the parameter decode, the case word and the filter rows as tensor code,
// then the lax.scan over samples at :122-161; process_ltpf_decoder_fl,
// ltpf_decoder.c:13-316). In the port's earlier design the parameter code was
// about 30 torch ops around a kernel that ran the sample loop one thread a
// stream.
//
// Bound on an H100 at B = 2048, 48 kHz: the bytes are x and y (480 floats
// each), mem_x and mem_y read and written (10 and 861 floats each), and the
// parameters, about 10.7 KB a stream, 22 MB at B = 2048, 0.0065 ms at
// 3.35 TB/s. The work a sample of a filtered stream is at most 4 tap chains
// of 11 and 12 terms and the crossfade; every term is a double multiply-add
// with three float/double conversions, and the conversions, at 16 a clock an
// SM, bound the issue rate (ltpf_decode.cuh says the order).
// Design: one warp a stream, four warps a block. Every lane decodes the
// stream's parameters (the same values; lane 0 writes them) and holds the
// four filter rows as doubles in registers, the rows' lengths a template
// argument of the rate, so they are indexed statically. The y and z rings
// (1024 samples each), [mem_x, x] and the chunk's z sit in shared memory,
// 10.1 KB a warp. The sample loop runs in chunks of up to 32 samples, a
// sample a lane: the z phase, __syncwarp, the ring writes, the y phase, the
// ring writes (ltpf_decode.cuh). Streams in neither filter state copy x.
#include "ltpf_decode.cuh"

using namespace acx;

#ifdef __CUDACC__
constexpr int kLtpfWarps = 4;

// The lanes of a warp: a loop spread over them, and a phase whose lane l
// computes sample l of the chunk, every lane's reads before any lane's writes.
struct LtpfWarp {
  int lane;
  template <class F>
  __host__ __device__ void each(int n, F&& fn) const {
    for (int i = lane; i < n; i += 32) fn(i);
  }
  __host__ __device__ void sync() const {
#ifdef __CUDA_ARCH__
    __syncwarp();
#endif
  }
  template <class Compute, class Commit>
  __host__ __device__ void phase(int n, Compute&& compute, Commit&& commit) const {
    float v = 0.0f;
    if (lane < n) v = compute(lane);
    sync();
    if (lane < n) commit(lane, v);
    sync();
  }
};

template <int NI, int NT>
__global__ void __launch_bounds__(kLtpfWarps * 32)
    ltpf_decode_kernel(const float* __restrict__ x, const int32_t* __restrict__ bfi,
                       const int32_t* __restrict__ param, const int32_t* __restrict__ mem_param,
                       const float* __restrict__ mem_x, const float* __restrict__ mem_y,
                       const int32_t* __restrict__ mem_pitch_int,
                       const int32_t* __restrict__ mem_pitch_fr,
                       const float* __restrict__ mem_gain, const int32_t* __restrict__ mem_beta_idx,
                       const float* __restrict__ inter, const float* __restrict__ tilt,
                       float* __restrict__ y, float* __restrict__ new_mx, float* __restrict__ new_my,
                       int32_t* __restrict__ out_param, int32_t* __restrict__ out_pitch_int,
                       int32_t* __restrict__ out_pitch_fr, float* __restrict__ out_gain,
                       int32_t* __restrict__ out_beta_idx, int B, LtpfGeom g) {
  __shared__ float yr[kLtpfWarps][kLtpfRing];
  __shared__ float zr[kLtpfWarps][kLtpfRing];
  __shared__ float xs[kLtpfWarps][kLtpfMaxX];
  __shared__ float zc[kLtpfWarps][kLtpfChunk];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int b = blockIdx.x * kLtpfWarps + warp;
  if (b >= B) return;   // the whole warp leaves together
  const LtpfParams p = ltpf_params(g, bfi[b], param + 3 * static_cast<size_t>(b),
                                   mem_param + 3 * static_cast<size_t>(b), mem_pitch_int[b],
                                   mem_pitch_fr[b]);
  if (lane == 0) {
    for (int i = 0; i < 3; ++i) out_param[3 * static_cast<size_t>(b) + i] = p.param[i];
    out_pitch_int[b] = p.pitch_int;
    out_pitch_fr[b] = p.pitch_fr;
    out_gain[b] = p.gain;
    out_beta_idx[b] = g.beta_idx;
  }
  LtpfFilters<NI, NT> f;
  ltpf_filters(g, p, mem_gain[b], mem_pitch_fr[b], mem_beta_idx[b], inter, tilt, f);
  const LtpfRows rows = {yr[warp], zr[warp], xs[warp], zc[warp]};
  const size_t s = static_cast<size_t>(b);
  ltpf_frame(LtpfWarp{lane}, g, p, f, x + s * g.N, mem_x + s * g.Lx, mem_y + s * g.Ly, rows,
             y + s * g.N, new_mx + s * g.Lx, new_my + s * g.Ly);
}

// inter [4][n_inter], tilt [4][n_tilt]: the configuration's filter tables.
extern "C" int acx_ltpf_decode(const void* x, const void* bfi, const void* param,
                               const void* mem_param, const void* mem_x, const void* mem_y,
                               const void* mem_pitch_int, const void* mem_pitch_fr,
                               const void* mem_gain, const void* mem_beta_idx, const void* inter,
                               const void* tilt, void* y, void* new_mx, void* new_my,
                               void* out_param, void* out_pitch_int, void* out_pitch_fr,
                               void* out_gain, void* out_beta_idx, int B, int N, int Lx, int Ly,
                               int n_inter, int n_tilt, int inter_len, int N4, int fs,
                               int beta_idx, float beta, void* stream) {
  if (Ly + kLtpfChunk > kLtpfRing || Lx + N > kLtpfMaxX || N4 < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (B == 0) return static_cast<int>(cudaSuccess);
  const LtpfGeom g = {N, Lx, Ly, inter_len, N4, fs, beta_idx, beta};
  const int blocks = (B + kLtpfWarps - 1) / kLtpfWarps;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
#define ACX_LTPF_ARGS                                                                        \
  static_cast<const float*>(x), static_cast<const int32_t*>(bfi),                            \
      static_cast<const int32_t*>(param), static_cast<const int32_t*>(mem_param),            \
      static_cast<const float*>(mem_x), static_cast<const float*>(mem_y),                    \
      static_cast<const int32_t*>(mem_pitch_int), static_cast<const int32_t*>(mem_pitch_fr), \
      static_cast<const float*>(mem_gain), static_cast<const int32_t*>(mem_beta_idx),        \
      static_cast<const float*>(inter), static_cast<const float*>(tilt),                     \
      static_cast<float*>(y), static_cast<float*>(new_mx), static_cast<float*>(new_my),      \
      static_cast<int32_t*>(out_param), static_cast<int32_t*>(out_pitch_int),               \
      static_cast<int32_t*>(out_pitch_fr), static_cast<float*>(out_gain),                    \
      static_cast<int32_t*>(out_beta_idx), B, g
  if (n_inter == 12 && n_tilt == 11) {
    ltpf_decode_kernel<12, 11><<<blocks, kLtpfWarps * 32, 0, st>>>(ACX_LTPF_ARGS);
  } else if (n_inter == 8 && n_tilt == 7) {
    ltpf_decode_kernel<8, 7><<<blocks, kLtpfWarps * 32, 0, st>>>(ACX_LTPF_ARGS);
  } else if (n_inter == 6 && n_tilt == 5) {
    ltpf_decode_kernel<6, 5><<<blocks, kLtpfWarps * 32, 0, st>>>(ACX_LTPF_ARGS);
  } else if (n_inter == 4 && n_tilt == 3) {
    ltpf_decode_kernel<4, 3><<<blocks, kLtpfWarps * 32, 0, st>>>(ACX_LTPF_ARGS);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
#undef ACX_LTPF_ARGS
  return static_cast<int>(cudaGetLastError());
}
#endif
