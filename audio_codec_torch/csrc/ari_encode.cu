// ari_encode: the range encoder of one frame per stream.
//
// Replaces audio_codec_tpu/ops/ari.py:encode (ari.py:218) with its helpers
// _tuple_context (:187), ac_encode (:104), _ac_shift (:81), ac_finalize
// (:119) and the residual fill scan (:350): processAriEncoder_fl,
// ari_codec.c:726-866. The side information is already packed backward into
// the frame (ops/bits.py:pack_side_info); this kernel codes the TNS symbols,
// the spectral 2-tuples with their escape levels, the sign and LSB bits,
// the residual bits, and the final bytes.
//
// Bound on an H100: the bytes are xq (B x N x 4), the residual bits and the
// 80-byte frame, about 5 MB at B = 2048, or 1.5 us at 3.35 TB/s; the range
// coder's state is one chain a stream (about 250 symbols at 64 kbps).
// Design (ari_encode.cuh): a warp a stream, eight streams a block (2048
// streams: 256 blocks, every SM busy in one wave). The lanes choose the
// symbols, place the side bits and build the LSB list 32 tuples at a time;
// lane 0 runs the chain over the chunk's symbol list. The row, the frame, a
// symbol list and an LSB list a warp sit in shared memory; the tables
// (lookup [4096], cumulative frequencies [64, 18], the TNS tables) are read
// from global memory through L1 (tools/torch_coder_times.py --tables times
// them staged in shared memory too). A stream whose forward bytes reach the
// side bits (the order test) is coded again on lane 0 by the sequential
// lane; the kernel adds one a stream to *lane0_streams.
#include "ari_encode.cuh"

using namespace acx;

#ifdef __CUDACC__
constexpr int kAriEncWarps = 8;   // streams a block

// a warp's words of shared memory: the row, the frame, the symbol list, the
// LSB list
__host__ __device__ inline int ari_warp_words(int N, int nbytes) {
  return N + (nbytes + 3) / 4 + kAriSymCap + kAriLsbWords;
}

__global__ void __launch_bounds__(kAriEncWarps * 32)
    ari_encode_kernel(const int32_t* __restrict__ buf_in, int32_t* __restrict__ buf_out,
                      const int32_t* __restrict__ xq, const int32_t* __restrict__ bp_side,
                      const int32_t* __restrict__ mask_side, const int32_t* __restrict__ num_tns,
                      const int32_t* __restrict__ lastnz, const int32_t* __restrict__ lsb_mode,
                      const int32_t* __restrict__ n_res, const int32_t* __restrict__ tns_order,
                      const int32_t* __restrict__ tns_idx, const int32_t* __restrict__ res,
                      const int32_t* __restrict__ tabs, int32_t* __restrict__ lane0_streams,
                      int B, int N, int nbytes, int res_width, int max_lev, int rate_flag,
                      int lpcw, int total_bits) {
  extern __shared__ int32_t smem[];
  const int32_t* tab = tabs;
  int32_t* warps = smem;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int s = blockIdx.x * kAriEncWarps + warp;
  if (s >= B) return;   // the whole warp leaves together
  AriTables tb;
  tb.lookup = tab;
  tb.cumf = tab + 4096;
  tb.tns_freq_cf = tb.cumf + 64 * 18;
  tb.tns_cf = tb.tns_freq_cf + 2 * 9;
  int32_t* row = warps + static_cast<size_t>(warp) * ari_warp_words(N, nbytes);
  uint32_t* frame = reinterpret_cast<uint32_t*>(row + N);
  uint32_t* syms = frame + (nbytes + 3) / 4;
  uint32_t* lsb_words = syms + kAriSymCap;
  uint8_t* buf = reinterpret_cast<uint8_t*>(frame);
  const int32_t* in = buf_in + static_cast<size_t>(s) * nbytes;
  const int32_t* g = xq + static_cast<size_t>(s) * N;
  for (int i = lane; i < N; i += 32) row[i] = g[i];
  for (int i = lane; i < nbytes; i += 32) buf[i] = static_cast<uint8_t>(in[i]);
  const int32_t sd[6] = {bp_side[s], mask_side[s], num_tns[s], lastnz[s], lsb_mode[s], n_res[s]};
  __syncwarp();
  const CoderCardWarp w{lane};
  const int path = ari_encode_warp(w, frame, in, nbytes, row, N, sd,
                                   tns_order + 2 * static_cast<size_t>(s),
                                   tns_idx + 16 * static_cast<size_t>(s),
                                   res + static_cast<size_t>(s) * res_width, res_width, tb,
                                   max_lev, rate_flag, lpcw, total_bits, syms, lsb_words);
  if (path != 0 && lane == 0) atomicAdd(lane0_streams, 1);
  int32_t* out = buf_out + static_cast<size_t>(s) * nbytes;
  for (int i = lane; i < nbytes; i += 32) out[i] = buf[i];
}

extern "C" int acx_ari_encode(const void* buf_in, void* buf_out, const void* xq,
                              const void* bp_side, const void* mask_side, const void* num_tns,
                              const void* lastnz, const void* lsb_mode, const void* n_res,
                              const void* tns_order, const void* tns_idx, const void* res,
                              const void* tabs, void* lane0_streams, int B, int N, int nbytes,
                              int res_width, int max_lev, int rate_flag, int lpcw,
                              int total_bits, void* stream) {
  if (B == 0) return static_cast<int>(cudaSuccess);
  if (N > 32 * kAriLsbWords || max_lev > 21) return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = static_cast<size_t>(kAriEncWarps) * ari_warp_words(N, nbytes) *
                      sizeof(int32_t);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        ari_encode_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const int blocks = (B + kAriEncWarps - 1) / kAriEncWarps;
  const auto I = [](const void* p) { return static_cast<const int32_t*>(p); };
  ari_encode_kernel<<<blocks, kAriEncWarps * 32, smem, static_cast<cudaStream_t>(stream)>>>(
      I(buf_in), static_cast<int32_t*>(buf_out), I(xq), I(bp_side), I(mask_side), I(num_tns),
      I(lastnz), I(lsb_mode), I(n_res), I(tns_order), I(tns_idx), I(res), I(tabs),
      static_cast<int32_t*>(lane0_streams), B, N, nbytes, res_width, max_lev, rate_flag, lpcw,
      total_bits);
  return static_cast<int>(cudaGetLastError());
}
#endif
