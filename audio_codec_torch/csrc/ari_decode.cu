// ari_decode: the range decoder, a thread a frame, 128 frames a block (4
// warps; fewer where their rows do not fit in shared memory), with the side
// information's parse fused in front of it.
//
// Replaces audio_codec_tpu/ops/ari.py:decode (ari.py:491) with dec_init
// (:419), ac_decode (:455) and the partial-concealment hooks (_pc_check
// :379): processAriDecoder_fl in ari_codec.c; in its parsed mode also
// audio_codec_tpu/ops/bits.py:parse_side_info (:123, on read_bit :45 and
// read_uint :54; processDecoderEntropy_fl, dec_entropy.c:121-270), the
// frame's side information read backward from its end. Plain versions:
// ops/ari.py:decode_plain, after ops/bits.py:parse_side_info_plain in the
// parsed mode. The steps are in ari_decode.cuh, a template on the
// partial-concealment mode: no PC block (the main path's frames), a
// relocated PC block (EP3/EP4 frames of 80 bytes or more, with the channel
// decoder's bfi 2 and corrupt bit range), and the encoder's simulation that
// finds b_left; and on the side information: read from side rows a caller
// made, or parsed by each lane from its frame's staged bytes
// (side_info.cuh:side_info_parse_bits), the side dict written out beside the
// decoder's rows. Both are one per launch, so the lanes of a launch never
// diverge on them. decode_block runs the kernel once over the T*B frames of
// a block (models/decoder.py), the stream engine once per frame, both
// parsed.
//
// Bound on an H100: the bytes are the frames in (T*B x 80 x 4: the payload
// arrives a byte a word), and x (T*B x 400 x 4), the residual bits (T*B x
// 400 x 4 at 48 kHz), the TNS entries, 7 scalars and the side dict's 21
// words out: about 62 MB at T*B = 16 384, 0.019 ms at 3.35 TB/s. The chain is
// longer: each symbol needs the coder state after the one before and its
// table row the context of the tuples before, about 200 tuples and 300
// symbols a frame at 64 kbps; one warp's 32 frames take about 0.1 ms
// (tools/torch_coder_times.py --decode-variants at 4 frames), and 16 384
// frames are 512 warps, four an SM: the kernel is one warp's chain long.
// Design: the chain stays one frame's and everything else comes off it
// (ari_decode.cuh): a block of four warps stages the tables (lookup,
// cumulative frequencies, TNS, and the inverse of the spectral rows: 85 KB)
// in shared memory with 16-byte loads, and each warp decodes 32 frames, a
// thread a frame; a spectral symbol is one byte of the inverse table at
// floor(low / tmp) instead of 17 products and compares; without a PC block
// the next bytes wait in registers and the side bits are read without
// branches. The warp stages its frames' bytes with coalesced loads, keeps
// each frame's rows in shared memory (x as int16 but in the high-resolution
// mode), sums the nonzero count and the seed as it goes, and writes every
// row out coalesced, the zeros included. In the parsed mode a lane gathers
// its row's last 12 staged bytes into three registers and takes each side
// field as one extract (a few hundred instructions against the frame's
// chain of about 200 tuples); the side scalars go out field-major, coalesced,
// and the row-major side words through the frame buffer once the decode is
// done. The timing tool builds the designs
// it was compared with (the count, a binary search, groups of 4 and 8 lanes
// a frame, tables through L1, smaller blocks) from this text by
// substitutions (--decode-variants), and the first design with each of its
// phases removed (--decode-phases).
#include "ari_decode.cuh"

using namespace acx;

#ifdef __CUDACC__
// the words of kernels._decoder_tables: lookup, cumf, the TNS tables; the
// inverse of the spectral rows from word kDecInvWord (16-byte aligned)
constexpr int kDecInvWord = 5412;
constexpr int kDecInvWords = 64 * kDecInvQ / 4;
// what a block stages in shared memory: every table, the inverse included
constexpr int kDecStageWords = kDecInvWord + kDecInvWords;
// frames a warp (a thread a frame) and warps a block
constexpr int kDecFrames = 32;
constexpr int kDecWarps = 4;

// Words of shared memory of a warp: the rows of its frames (stride
// kDecFrames + 1) and their bytes (in the parsed mode, after the decode, its
// side rows' words).
__host__ __device__ inline size_t dec_warp_words(int xbytes, int N, int max_res,
                                                 int nbytes) {
  constexpr int S = kDecFrames + 1;
  return (static_cast<size_t>(N) * S * xbytes + 3) / 4 +
         static_cast<size_t>(dec_lev_words(N) + dec_res_words(max_res) + 18 + 2) * S +
         (static_cast<size_t>(dec_fbuf_bytes(nbytes)) + 3) / 4;
}

// the block's threads copy n words (n a multiple of 4, both ends 16-byte
// aligned) with 16-byte loads, eight in flight a thread before any store
// (a load stored before the next is issued keeps one in flight)
__device__ inline void dec_stage(int32_t* dst, const int32_t* src, int n) {
  const int4* s4 = reinterpret_cast<const int4*>(src);
  int4* d4 = reinterpret_cast<int4*>(dst);
  const int n4 = n / 4, step = blockDim.x;
  for (int i0 = threadIdx.x; i0 < n4; i0 += 8 * step) {
    int4 v[8];
#pragma unroll
    for (int u = 0; u < 8; ++u)
      if (i0 + u * step < n4) v[u] = __ldg(s4 + i0 + u * step);
#pragma unroll
    for (int u = 0; u < 8; ++u)
      if (i0 + u * step < n4) d4[i0 + u * step] = v[u];
  }
}

// A block of blockDim.x / 32 warps: the block stages every table, then each
// warp decodes its own kDecFrames frames into its own rows.
template <int kPc, bool kParse, typename XT>
__global__ void __launch_bounds__(128) ari_decode_kernel(DecIo io,
                                                         const int32_t* __restrict__ tabs,
                                                         DecGeom g) {
  extern __shared__ int4 smem4[];
  constexpr int S = kDecFrames + 1;
  const int N = g.N;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  int32_t* p = reinterpret_cast<int32_t*>(smem4);
  dec_stage(p, tabs, kDecStageWords);
  __syncthreads();
  const int32_t* t = p;
  DecTables tb;
  tb.lookup = t;
  tb.cumf = t + 4096;
  tb.order_cf = tb.cumf + 64 * 18;
  tb.coef_cf = tb.order_cf + 2 * 9;
  tb.inv = reinterpret_cast<const uint8_t*>(t + kDecInvWord);
  p += kDecStageWords;
  const int s0 = (blockIdx.x * (blockDim.x / 32) + warp) * kDecFrames;
  if (s0 >= io.L) return;   // the whole warp leaves together
  const int nf = imin(kDecFrames, io.L - s0);
  p += warp * dec_warp_words(sizeof(XT), N, g.max_res, io.nbytes);
  DecRows<XT> rows;
  rows.stride = S;
  rows.x = reinterpret_cast<XT*>(p);
  p += (static_cast<size_t>(N) * S * sizeof(XT) + 3) / 4;
  rows.lev = reinterpret_cast<uint32_t*>(p);
  p += dec_lev_words(N) * S;
  rows.res = reinterpret_cast<uint32_t*>(p);
  p += dec_res_words(g.max_res) * S;
  rows.tns = p;
  p += 18 * S;
  rows.len = p;
  p += 2 * S;
  ari_decode_warp<kPc, kParse>(CoderCardWarp{lane}, io, s0, nf, tb, g,
                               reinterpret_cast<uint8_t*>(p), rows);
}

// Blocks of kDecWarps warps, fewer where their shared memory would pass the
// 227 KB a block may have (one in the high-resolution mode, whose x is int32).
template <int kPc, bool kParse, typename XT>
inline cudaError_t ari_decode_launch(const DecIo& io, const int32_t* tabs, const DecGeom& g,
                                     cudaStream_t st) {
  const auto kernel = ari_decode_kernel<kPc, kParse, XT>;
  const size_t per_warp = dec_warp_words(sizeof(XT), g.N, g.max_res, io.nbytes) * 4;
  const size_t stage = static_cast<size_t>(kDecStageWords) * 4;
  int warps = kDecWarps;
  while (warps > 1 && stage + warps * per_warp > 232448) warps /= 2;
  const size_t smem = stage + warps * per_warp;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  const int F = kDecFrames * warps;
  kernel<<<(io.L + F - 1) / F, 32 * warps, smem, st>>>(io, tabs, g);
  return cudaGetLastError();
}

// x as int16 but in the high-resolution mode
template <int kPc, bool kParse>
inline cudaError_t ari_decode_mode(const DecIo& io, const int32_t* tabs, const DecGeom& g,
                                   cudaStream_t st) {
  if (g.hrmode) return ari_decode_launch<kPc, kParse, int32_t>(io, tabs, g, st);
  return ari_decode_launch<kPc, kParse, int16_t>(io, tabs, g, st);
}

template <bool kParse>
inline int ari_decode_pc(const DecIo& io, const int32_t* tabs, const DecGeom& g, int pc_mode,
                         cudaStream_t st) {
  if (io.L == 0) return static_cast<int>(cudaSuccess);
  // x stays int16 only where no value can pass 2^15 - 1 (13 escape levels)
  if (!g.hrmode && g.max_lev > 14) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err;
  if (pc_mode == kPcDecode) err = ari_decode_mode<kPcDecode, kParse>(io, tabs, g, st);
  else if (pc_mode == kPcEncSim) err = ari_decode_mode<kPcEncSim, kParse>(io, tabs, g, st);
  else err = ari_decode_mode<kPcNone, kParse>(io, tabs, g, st);
  return static_cast<int>(err);
}

static const int32_t* I(const void* p) { return static_cast<const int32_t*>(p); }
static int32_t* O(void* p) { return static_cast<int32_t*>(p); }

// The side information read from side [9, L] (DecSide's fields in order).
extern "C" int acx_ari_decode(const void* frames, const void* side, const void* pc_in,
                              const void* tabs, void* x, void* tns_order, void* tns_idx, void* res,
                              void* out, int L, int nbytes, int N, int max_lev, int hrmode,
                              int tns_max, int lpcw, int rate_flag, int total_bits, int max_res,
                              int res_iters, int pc_mode, int pc_bytes, int numbytes,
                              void* stream) {
  const DecGeom g = {N, max_lev, hrmode, tns_max, lpcw, rate_flag, total_bits, max_res,
                     res_iters, pc_bytes, numbytes};
  const DecIo io = {I(frames), I(side), I(pc_in), O(x), O(tns_order), O(tns_idx), O(res), O(out),
                    L, nbytes};
  return ari_decode_pc<false>(io, I(tabs), g, pc_mode, static_cast<cudaStream_t>(stream));
}

// The side information parsed from each frame's bytes; side_out [21 * L]
// (DecIo), flags / meta: the three PC inputs' addresses (null: the default)
// and their (stride, element type) pairs (kernels.py:ari_decode_frames).
extern "C" int acx_ari_decode_frames(const void* frames, void* side_out,
                                     const void* const* flags, const int* meta, const void* tabs,
                                     void* x, void* tns_order, void* tns_idx, void* res,
                                     void* out, int L, int nbytes, int N, int max_lev,
                                     int hrmode, int tns_max, int lpcw, int rate_flag,
                                     int total_bits, int max_res, int res_iters, int pc_mode,
                                     int pc_bytes, int numbytes, int start, int bw_bits,
                                     int lastnz_bits, int fs_idx, int one_tns, void* stream) {
  const DecGeom g = {N, max_lev, hrmode, tns_max, lpcw, rate_flag, total_bits, max_res,
                     res_iters, pc_bytes, numbytes};
  DecIo io = {I(frames), nullptr, nullptr, O(x), O(tns_order), O(tns_idx), O(res), O(out),
              L, nbytes, O(side_out)};
  for (int k = 0; k < 3; ++k) io.flags[k] = {flags[k], meta[2 * k], meta[2 * k + 1]};
  io.lay = {nbytes, start, bw_bits, lastnz_bits, fs_idx, N, one_tns};
  return ari_decode_pc<true>(io, I(tabs), g, pc_mode, static_cast<cudaStream_t>(stream));
}
#endif
