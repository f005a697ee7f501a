// fx_spec_decode: the fixed-point decoder's spectral chain (K20b).
//
// Replaces audio_codec_tpu/ops/fixed_dev.py:ari_scaling (:48),
// residual_decode (:56), noise_filling (:93, with _lcg_tables :81 and the
// cummax :109), apply_global_gain (:166, inv_log2 :145), tns_decode (:185,
// the scan :220-252, _masked_headroom32 :176), scf_scaling (:310) and
// mdct_shaping (:315): dec_lc3.c:196-235 on clean frames. [L, yLen] decoded
// spectrum, residual bits and side words + the bands' scale factors ->
// the shaped Word32 spectrum [L, N] and its exponent, L = T x B frames.
//
// Bound on an H100: the TNS lattice, up to 400 bins x 8 taps a frame, each
// tap a dependent multiply and saturation; the bytes are about 9.6 KB a
// lane (L = 16384: 157 MB, 0.05 ms at 3.35 TB/s).
// Design: a block of four warps takes four frames (kFxSpecFrames). The
// stages before and after the lattice run a frame a warp: the elementwise
// lines, the headroom and maximum over the warp with shuffles, the
// residual's and the noise filler's ranks and the zero runs as warp scans
// over 13 chunks of 32 bins (a ballot, then popc or the highest set bit,
// fixed.cuh). Between them warp 0 runs the four frames' lattices at once,
// a wavefront of a tap a lane (fx_spec_decode.cuh:fx_tns_wave). The spectra
// (int32) and each warp's zero runs (int16) sit in shared memory.
#include "fx_spec_decode.cuh"

using namespace acx;
using namespace acx::fx;

constexpr int kFxSpecWarps = 4;   // a frame a warp
static_assert(kFxSpecWarps == kFxSpecFrames, "a block's warps are its frames");

// a block's shared bytes: the four lattices and the four spectra (yLen words
// each), then each warp's zero runs (yLen int16), each part a multiple of 16
__host__ __device__ inline int spec_frames_bytes(int yLen) {
  const int b = kFxSpecFrames * static_cast<int>(sizeof(FxTnsFrame)) +
                kFxSpecFrames * yLen * static_cast<int>(sizeof(SpecWord));
  return (b + 15) / 16 * 16;
}
__host__ __device__ inline int spec_run_bytes(int yLen) { return (yLen * 2 + 15) / 16 * 16; }
__host__ __device__ inline int spec_block_bytes(int yLen) {
  return spec_frames_bytes(yLen) + kFxSpecWarps * spec_run_bytes(yLen);
}

__global__ void fx_spec_decode_kernel(const int32_t* __restrict__ x,
                                      const int32_t* __restrict__ res,
                                      const int32_t* __restrict__ side,
                                      const int32_t* __restrict__ tidx,
                                      const i64* __restrict__ scf, const i64* __restrict__ scf_e,
                                      const i64* __restrict__ tab, i64* __restrict__ out,
                                      i64* __restrict__ x_e, int L, SpecGeom g) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int wi = threadIdx.x >> 5;
  const int lane = static_cast<int>(threadIdx.x & 31);
  const int l0 = blockIdx.x * kFxSpecFrames;
  const int nf = imin(kFxSpecFrames, L - l0);
  FxTnsFrame* tf = reinterpret_cast<FxTnsFrame*>(smem);
  SpecWord* xs = reinterpret_cast<SpecWord*>(tf + kFxSpecFrames);
  int16_t* run = reinterpret_cast<int16_t*>(smem + spec_frames_bytes(g.yLen) +
                                            wi * spec_run_bytes(g.yLen));
  const size_t l = static_cast<size_t>(l0) + wi;
  if (wi < nf) {
    fx_spec_pre(Warp{lane}, x + l * g.yLen, res + l * g.R, side + l * kSpecSideWords, tab, g,
                xs + wi * g.yLen, run, tf + wi);
  }
  __syncthreads();
  if (wi == 0) {
    fx_tns_wave(CoderCardWarp{lane}, nf, tf, xs, g.yLen, tidx + static_cast<size_t>(l0) * 16, tab);
  }
  __syncthreads();
  if (wi < nf) {
    fx_spec_post(Warp{lane}, xs + wi * g.yLen, scf + l * g.n_bands, scf_e + l * g.n_bands, tab, g,
                 tf[wi].x_e, out + l * g.N, x_e + l);
  }
}

extern "C" int acx_fx_spec_decode(const void* x, const void* res, const void* side,
                                  const void* tidx, const void* scf, const void* scf_e,
                                  const void* tab, void* out, void* x_e, int L, int yLen, int N,
                                  int n_bands, int frame_dms, int gg_off, int R, void* stream) {
  const SpecGeom g{yLen, N, n_bands, frame_dms, gg_off, R};
  if (yLen > 32767) return static_cast<int>(cudaErrorInvalidValue);   // int16 zero runs
  const size_t smem = static_cast<size_t>(spec_block_bytes(yLen));
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        fx_spec_decode_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  if (L == 0) return static_cast<int>(cudaSuccess);
  const int blocks = (L + kFxSpecFrames - 1) / kFxSpecFrames;
  fx_spec_decode_kernel<<<blocks, 32 * kFxSpecWarps, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(x), static_cast<const int32_t*>(res),
      static_cast<const int32_t*>(side), static_cast<const int32_t*>(tidx),
      static_cast<const i64*>(scf), static_cast<const i64*>(scf_e), static_cast<const i64*>(tab),
      static_cast<i64*>(out), static_cast<i64*>(x_e), L, g);
  return static_cast<int>(cudaGetLastError());
}
