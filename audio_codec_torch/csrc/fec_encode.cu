// fec_encode: the channel coder's encoder, one slot per lane.
//
// Replaces audio_codec_tpu/ops/fec.py:fec_encode (fec.py:628, with
// _crc_eval :391 and _rs_parity :419): CRC1 with the EPMR embedding, CRC2
// over the partial-concealment block, the bit swap, the RS parity of each
// codeword, the mode's signalling polynomial and the interleave. The lane
// function is fec_encode_lane (fec.cuh).
//
// Bound on an H100: the bytes are the payloads in and the slots out, about
// 2 x B x slot x 4 bytes (1.3 MB at B = 2048, 80 bytes; 0.4 us at 3.35 TB/s);
// the lane's chain (one CRC step a nibble, 13 products a parity nibble) is
// a few thousand dependent integer steps, so a launch is bound by its
// latency. Design: one thread a slot, the tables in shared memory, the
// data and code words in the thread's local scratch.
#include "fec.cuh"

using namespace acx;

#ifdef __CUDACC__
constexpr int kFecEncThreads = 64;

__global__ void fec_encode_kernel(const int32_t* __restrict__ data,
                                  const int32_t* __restrict__ epmr,
                                  const int32_t* __restrict__ tabs, int32_t* __restrict__ out,
                                  int B, int data_bytes, int slot, int mode, int ccc) {
  __shared__ int32_t smem[kFecTableWords];
  acx_load_shared(smem, tabs, kFecTableWords);
  __syncthreads();
  const int s = blockIdx.x * blockDim.x + threadIdx.x;
  if (s >= B) return;
  FecTables tb;
  tb.w = smem;
  uint8_t dw[kFecMaxNib], cw[kFecMaxNib];
  fec_encode_lane(data + static_cast<size_t>(s) * data_bytes, epmr[s], tb, slot, mode, ccc, dw,
                  cw, out + static_cast<size_t>(s) * slot);
}

extern "C" int acx_fec_encode(const void* data, const void* epmr, const void* tabs, void* out,
                              int B, int data_bytes, int slot, int mode, int ccc, void* stream) {
  const int blocks = (B + kFecEncThreads - 1) / kFecEncThreads;
  fec_encode_kernel<<<blocks, kFecEncThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(data), static_cast<const int32_t*>(epmr),
      static_cast<const int32_t*>(tabs), static_cast<int32_t*>(out), B, data_bytes, slot, mode,
      ccc);
  return static_cast<int>(cudaGetLastError());
}
#endif
