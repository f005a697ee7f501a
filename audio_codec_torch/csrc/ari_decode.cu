// ari_decode: the range decoder of one frame per lane.
//
// Replaces audio_codec_tpu/ops/ari.py:decode (ari.py:491) with dec_init
// (:419), ac_decode (:455) and the partial-concealment hooks (_pc_check
// :379): processAriDecoder_fl in ari_codec.c. The lane function is
// ari_decode_lane (ari_decode.cuh), a template on the partial-concealment
// mode: no PC block (the main path's frames), a relocated PC block (EP3/EP4
// frames of 80 bytes or more, with the channel decoder's bfi 2 and corrupt
// bit range), and the encoder's simulation that finds b_left. The mode is
// one per launch, so the lanes of a launch never diverge on it.
// decode_block runs the kernel once over the T*B frames of a block
// (models/decoder.py); the stream engine once per frame.
//
// Bound on an H100: a chain of dependent steps per lane (each symbol's
// table row depends on the previous tuple's context, and each step does a
// 17-entry search of the cumulative frequencies); the bytes are the frames
// (T*B x 80 x 4) in and x (T*B x 400 x 4) plus residual bits out, about
// 7 MB at T*B = 4096, or 2 us at 3.35 TB/s. The chain is the bound. The
// per-symbol table gathers are what docs/PERF.md:126-134 names as the decode
// bottleneck of the reference package.
// Design: one thread per lane keeps low, range, both pointers, the PC
// pointer state and the context in registers; the frame bytes of the lane
// and the 4096-entry lookup and [64,18] cumulative frequency tables sit in
// shared memory. Every buffer index is clipped: the PC pointers jump
// (bp -> 0, bp_side -> pc_bytes - 1).
#include "ari_decode.cuh"

using namespace acx;

#ifdef __CUDACC__
constexpr int kAriDecThreads = 32;
constexpr int kDecTabWords = 4096 + 64 * 18 + 2 * 9 + 8 * 18;

__global__ void ari_decode_kernel(const int32_t* __restrict__ frames,
                                  const int32_t* __restrict__ side,  // [9, L]
                                  const int32_t* __restrict__ pc_in,  // [3, L] or null
                                  const int32_t* __restrict__ tabs,
                                  int32_t* __restrict__ x, int32_t* __restrict__ tns_order,
                                  int32_t* __restrict__ tns_idx, int32_t* __restrict__ res,
                                  uint8_t* __restrict__ levs, int32_t* __restrict__ out,
                                  int L, int nbytes, DecGeom g, int pc_mode) {
  extern __shared__ int32_t smem[];
  acx_load_shared(smem, tabs, kDecTabWords);
  __syncthreads();
  const int s = blockIdx.x * blockDim.x + threadIdx.x;
  if (s >= L) return;
  DecTables tb;
  tb.lookup = smem;
  tb.cumf = smem + 4096;
  tb.order_cf = tb.cumf + 64 * 18;
  tb.coef_cf = tb.order_cf + 2 * 9;
  uint8_t* buf = reinterpret_cast<uint8_t*>(smem + kDecTabWords) + threadIdx.x * nbytes;
  const int32_t* in = frames + static_cast<size_t>(s) * nbytes;
  for (int i = 0; i < nbytes; ++i) buf[i] = static_cast<uint8_t>(in[i]);
  int32_t sd[9];
  for (int j = 0; j < 9; ++j) sd[j] = side[j * L + s];
  const int bfi_in = pc_in == nullptr ? 0 : pc_in[s];
  const int be_l = pc_in == nullptr ? -1 : pc_in[L + s];
  const int be_r = pc_in == nullptr ? -1 : pc_in[2 * L + s];
  int32_t* xs = x + static_cast<size_t>(s) * g.N;
  int32_t* rs = res + static_cast<size_t>(s) * g.max_res;
  uint8_t* ls = levs + static_cast<size_t>(s) * (g.N / 2);
  if (pc_mode == kPcDecode) {
    ari_decode_lane<kPcDecode>(buf, nbytes, sd, tb, g, bfi_in, be_l, be_r, xs, tns_order + 2 * s,
                               tns_idx + 16 * s, rs, ls, out + s, L);
  } else if (pc_mode == kPcEncSim) {
    ari_decode_lane<kPcEncSim>(buf, nbytes, sd, tb, g, bfi_in, be_l, be_r, xs, tns_order + 2 * s,
                               tns_idx + 16 * s, rs, ls, out + s, L);
  } else {
    ari_decode_lane<kPcNone>(buf, nbytes, sd, tb, g, bfi_in, be_l, be_r, xs, tns_order + 2 * s,
                             tns_idx + 16 * s, rs, ls, out + s, L);
  }
}

extern "C" int acx_ari_decode(const void* frames, const void* side, const void* pc_in,
                              const void* tabs, void* x, void* tns_order, void* tns_idx, void* res,
                              void* levs, void* out, int L, int nbytes, int N, int max_lev,
                              int hrmode, int tns_max, int lpcw, int rate_flag, int total_bits,
                              int max_res, int res_iters, int pc_mode, int pc_bytes,
                              int numbytes, void* stream) {
  const size_t smem = kDecTabWords * sizeof(int32_t) + static_cast<size_t>(kAriDecThreads) * nbytes;
  cudaError_t err = cudaFuncSetAttribute(ari_decode_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const DecGeom g = {N, max_lev, hrmode, tns_max, lpcw, rate_flag, total_bits, max_res,
                     res_iters, pc_bytes, numbytes};
  const int blocks = (L + kAriDecThreads - 1) / kAriDecThreads;
  ari_decode_kernel<<<blocks, kAriDecThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(frames), static_cast<const int32_t*>(side),
      static_cast<const int32_t*>(pc_in), static_cast<const int32_t*>(tabs),
      static_cast<int32_t*>(x), static_cast<int32_t*>(tns_order), static_cast<int32_t*>(tns_idx),
      static_cast<int32_t*>(res), static_cast<uint8_t*>(levs), static_cast<int32_t*>(out), L,
      nbytes, g, pc_mode);
  return static_cast<int>(cudaGetLastError());
}
#endif
