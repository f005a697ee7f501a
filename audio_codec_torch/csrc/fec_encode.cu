// fec_encode: the channel coder's encoder, a warp a slot.
//
// Replaces audio_codec_tpu/ops/fec.py:fec_encode (fec.py:628, with
// _crc_eval :391, _crc1_rem :398, _bitswap :410 and _rs_parity :419): CRC1
// with the EPMR embedding, CRC2 over the partial-concealment block, the bit
// swap, the RS parity of each codeword, the mode's signalling polynomial and
// the interleave. The warp function is fec_encode_warp (fec.cuh).
//
// Bound on an H100: the bytes are the payloads in and the slots out, about
// 2 x B x slot x 4 bytes (1.3 MB at B = 2048, 80 bytes; 0.4 us at 3.35 TB/s);
// a slot's work is a few hundred table lookups and XORs, so a launch is
// bound by one slot's critical path. Design: a warp a slot, kFecEncWarps
// slots a block (no block barrier): the payload loaded coalesced into the
// warp's shared scratch as nibbles, the CRCs' terms spread over the lanes
// and XOR-reduced, a codeword a lane (two past 32) with its parity from at
// most 13 packed lookups, and each output byte assembled by a lane from
// the codewords in shared memory and written once, coalesced. The tables
// (the CRC powers and the packed parity terms) are read through L1.
#include "fec.cuh"

using namespace acx;

#ifdef __CUDACC__
constexpr int kFecEncWarps = 4;   // slots a block

__global__ void __launch_bounds__(32 * kFecEncWarps)
    fec_encode_kernel(const int32_t* __restrict__ data, const int32_t* __restrict__ epmr,
                      const int32_t* __restrict__ tabs, int32_t* __restrict__ out, int B,
                      int data_bytes, int slot, int mode, int ccc) {
  __shared__ FecEncScratch ws[kFecEncWarps];
  const int warp = threadIdx.x / 32;
  const int s = blockIdx.x * kFecEncWarps + warp;
  if (s >= B) return;   // the whole warp leaves together
  fec_encode_warp(CoderCardWarp{static_cast<int>(threadIdx.x % 32)},
                  data + static_cast<size_t>(s) * data_bytes, epmr[s], tabs, slot, mode, ccc,
                  &ws[warp], out + static_cast<size_t>(s) * slot);
}

extern "C" int acx_fec_encode(const void* data, const void* epmr, const void* tabs, void* out,
                              int B, int data_bytes, int slot, int mode, int ccc, void* stream) {
  const int blocks = (B + kFecEncWarps - 1) / kFecEncWarps;
  fec_encode_kernel<<<blocks, 32 * kFecEncWarps, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(data), static_cast<const int32_t*>(epmr),
      static_cast<const int32_t*>(tabs), static_cast<int32_t*>(out), B, data_bytes, slot, mode,
      ccc);
  return static_cast<int>(cudaGetLastError());
}
#endif
