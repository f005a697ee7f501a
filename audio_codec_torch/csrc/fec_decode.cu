// fec_decode: the channel coder's decoder, a warp a slot.
//
// Replaces audio_codec_tpu/ops/fec.py:fec_decode (fec.py:696, with
// _syndromes6 :443, _peterson_elp :452, _chien :532, _forney :557 and the
// simple_float risk compares :605-619): deinterleave, syndromes, EP1 check,
// detection under the three upper modes on codewords 0..5, the risk pick,
// correction of the detected mode's codewords, CRC1/CRC2, the EPMR (or its
// estimate on a failed frame), the low-rate cap, the partial-concealment
// span and the final merge. The warp function is fec_decode_warp (fec.cuh).
//
// Bound on an H100: the slots in and the payload and nine scalars out,
// about 2 x B x slot x 4 bytes (1.3 MB at B = 2048, 80 bytes; 0.4 us at
// 3.35 TB/s). A slot's work is a chain of table lookups: a launch is bound
// by one slot's critical path, not by bytes or instruction rate.
// Design: a warp a slot, kFecDecWarps slots a block (fec.cuh): the slot's
// bytes staged in shared memory, a codeword a lane (two where a slot has
// more than 32), its six syndromes from 15 packed lookups, the 18
// detections on 18 lanes at once, the correction a codeword a lane, the
// flags ballots, the data word gathered in shared memory, the CRCs' terms
// spread over the lanes and XOR-reduced. The GF(16), risk and syndrome
// tables are staged in shared memory once a block, the CRC powers read
// through L1.
#include "fec.cuh"

using namespace acx;

#ifdef __CUDACC__
constexpr int kFecDecWarps = 4;   // slots a block

__global__ void __launch_bounds__(32 * kFecDecWarps)
    fec_decode_kernel(const int32_t* __restrict__ frames, const int32_t* __restrict__ bfi_in,
                      const int32_t* __restrict__ tabs, int32_t* __restrict__ data,
                      int32_t* __restrict__ out, int B, int slot, int ccc) {
  __shared__ int32_t tw[kFecCrcPow];
  __shared__ FecWarpScratch ws[kFecDecWarps];
  acx_load_shared(tw, tabs, kFecCrcPow);
  __syncthreads();
  const int warp = threadIdx.x / 32;
  const int s = blockIdx.x * kFecDecWarps + warp;
  if (s >= B) return;   // the whole warp leaves together
  fec_decode_warp(CoderCardWarp{static_cast<int>(threadIdx.x % 32)},
                  frames + static_cast<size_t>(s) * slot, bfi_in == nullptr ? 0 : bfi_in[s], tw,
                  tabs + kFecCrcPow, slot, ccc, &ws[warp], data + static_cast<size_t>(s) * slot,
                  out + s, B);
}

extern "C" int acx_fec_decode(const void* frames, const void* bfi_in, const void* tabs,
                              void* data, void* out, int B, int slot, int ccc, void* stream) {
  const int blocks = (B + kFecDecWarps - 1) / kFecDecWarps;
  fec_decode_kernel<<<blocks, 32 * kFecDecWarps, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(frames), static_cast<const int32_t*>(bfi_in),
      static_cast<const int32_t*>(tabs), static_cast<int32_t*>(data), static_cast<int32_t*>(out),
      B, slot, ccc);
  return static_cast<int>(cudaGetLastError());
}
#endif
