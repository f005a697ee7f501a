// fx_ola_ltpf: the fixed-point decoder's back end for one frame (K21).
//
// Replaces audio_codec_tpu/ops/fixed_dev.py:imdct_ola (:605; window
// window_table(480), state mem [B, wLen - N] and mem_e),
// ops/fixed_ltpf_dev.py:ltpf_decode (:169: the parameter decode :186-208,
// the passthrough branch A :209-234, branch B :235-288 with the four
// patterns :257-270 and the three _synth_filter passes :274-288, the scan
// :132-157) and fixed_dev.round_pcm16 (:654): imdct_fx.c:115-175,
// ltpf_decoder_fx.c:16-316, dec_lc3.c:289-295. Per frame: ytda [B, 480]
// with y_e, y_s, zero and the LTPF side words -> int16 PCM [B, 480], the
// state (mem, mem_e, old_x, old_y, old_e, pitch_int, pitch_fr, gain,
// mem_active, old_sfi) updated in place. One launch a frame.
//
// Bound on an H100: the post-filter's sample loop, 120 + 360 samples (and
// 120 more on a crossfade) of up to 12 + 11 dependent multiply-adds with
// saturation each, the output read back `pitch_int` samples; the bytes are
// the frame, the two histories and the memory in and out, about 19 KB a
// stream (B = 2048: 39 MB, 0.012 ms at 3.35 TB/s). The sample loop is the
// bound.
// Design: a warp a stream (kFxOlaWarps a block). Lanes 0-31 do the
// overlap-add's headroom (a warp minimum), window, unfold and overlap-add,
// the histories' headrooms and rescaling, and the PCM rounding; the filter's
// sample loop runs on lane 0 (splitting it by the pitch lag is later work,
// ROADMAP Queue 2 item 1). The buffers live in shared memory.
#include "fx_ola_ltpf.cuh"

using namespace acx::fx;

constexpr int kFxOlaWarps = 2;

__global__ void fx_ola_ltpf_kernel(const i64* __restrict__ ytda, const i64* __restrict__ y_e,
                                   const i64* __restrict__ y_s, const bool* __restrict__ zero,
                                   const int32_t* __restrict__ lp, const i64* __restrict__ tab,
                                   OlaState st, int16_t* __restrict__ pcm, int B, OlaGeom g) {
  extern __shared__ i64 smem[];
  const int wi = threadIdx.x >> 5;
  const int b = blockIdx.x * kFxOlaWarps + wi;
  if (b >= B) return;            // whole warps leave together
  const size_t bs = static_cast<size_t>(b);
  const int memLen = g.wLen - g.N;
  const OlaState s{st.mem + bs * memLen, st.mem_e + bs, st.old_x + bs * g.x_len,
                   st.old_y + bs * g.y_len, st.old_e + bs, st.pitch_int + bs, st.pitch_fr + bs,
                   st.gain + bs, st.mem_active + bs, st.old_sfi + bs};
  const Warp w{static_cast<int>(threadIdx.x & 31)};
  fx_ola_ltpf_lane(w, ytda + bs * g.N, y_e[b], y_s[b], zero[b], lp + 3 * bs, tab, g, s,
                   smem + wi * ola_scratch_words(g), pcm + bs * g.N);
}

extern "C" int acx_fx_ola_ltpf(const void* ytda, const void* y_e, const void* y_s,
                               const void* zero, const void* lp, const void* tab, void* mem,
                               void* mem_e, void* old_x, void* old_y, void* old_e,
                               void* pitch_int, void* pitch_fr, void* gain, void* mem_active,
                               void* old_sfi, void* pcm, int B, const int* geom, void* stream) {
  const OlaGeom g{geom[0], geom[1], geom[2], geom[3], geom[4], geom[5], geom[6], geom[7],
                  geom[8], geom[9], geom[10], geom[11], geom[12], geom[13]};
  const OlaState st{static_cast<i64*>(mem), static_cast<i64*>(mem_e),
                    static_cast<i64*>(old_x), static_cast<i64*>(old_y),
                    static_cast<i64*>(old_e), static_cast<i64*>(pitch_int),
                    static_cast<i64*>(pitch_fr), static_cast<i64*>(gain),
                    static_cast<i64*>(mem_active), static_cast<i64*>(old_sfi)};
  const size_t smem = static_cast<size_t>(kFxOlaWarps) * ola_scratch_words(g) * sizeof(i64);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        fx_ola_ltpf_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const int blocks = (B + kFxOlaWarps - 1) / kFxOlaWarps;
  fx_ola_ltpf_kernel<<<blocks, 32 * kFxOlaWarps, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const i64*>(ytda), static_cast<const i64*>(y_e), static_cast<const i64*>(y_s),
      static_cast<const bool*>(zero), static_cast<const int32_t*>(lp),
      static_cast<const i64*>(tab), st, static_cast<int16_t*>(pcm), B, g);
  return static_cast<int>(cudaGetLastError());
}
