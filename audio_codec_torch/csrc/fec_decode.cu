// fec_decode: the channel coder's decoder, one slot per lane.
//
// Replaces audio_codec_tpu/ops/fec.py:fec_decode (fec.py:696, with
// _syndromes6 :443, _peterson_elp :452, _chien :532, _forney :557 and the
// simple_float risk compares :605-619): deinterleave, syndromes, EP1 check,
// detection under the three upper modes on codewords 0..5, the risk pick,
// correction of the detected mode's codewords, CRC1/CRC2, the EPMR (or its
// estimate on a failed frame), the low-rate cap, the partial-concealment
// span and the final merge. The lane function is fec_decode_lane
// (fec.cuh).
//
// Bound on an H100: the slots in and the payload and nine scalars out,
// about 2 x B x slot x 4 bytes (1.3 MB at B = 2048, 80 bytes; 0.4 us at
// 3.35 TB/s); a lane runs some 10^4 dependent table lookups (six syndromes
// of 15 products a codeword, three Peterson and Chien searches on six
// codewords), so a launch is bound by its latency. Design: one thread a
// slot, the GF(16) and risk tables in shared memory, the codewords and
// syndromes in the thread's local scratch (1.5 KB).
#include "fec.cuh"

using namespace acx;

#ifdef __CUDACC__
constexpr int kFecDecThreads = 64;

__global__ void fec_decode_kernel(const int32_t* __restrict__ frames,
                                  const int32_t* __restrict__ bfi_in,
                                  const int32_t* __restrict__ tabs, int32_t* __restrict__ data,
                                  int32_t* __restrict__ out, int B, int slot, int ccc) {
  __shared__ int32_t smem[kFecTableWords];
  acx_load_shared(smem, tabs, kFecTableWords);
  __syncthreads();
  const int s = blockIdx.x * blockDim.x + threadIdx.x;
  if (s >= B) return;
  FecTables tb;
  tb.w = smem;
  FecDecScratch sc;
  fec_decode_lane(frames + static_cast<size_t>(s) * slot, bfi_in == nullptr ? 0 : bfi_in[s], tb,
                  slot, ccc, sc, data + static_cast<size_t>(s) * slot, out + s, B);
}

extern "C" int acx_fec_decode(const void* frames, const void* bfi_in, const void* tabs,
                              void* data, void* out, int B, int slot, int ccc, void* stream) {
  const int blocks = (B + kFecDecThreads - 1) / kFecDecThreads;
  fec_decode_kernel<<<blocks, kFecDecThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(frames), static_cast<const int32_t*>(bfi_in),
      static_cast<const int32_t*>(tabs), static_cast<int32_t*>(data), static_cast<int32_t*>(out),
      B, slot, ccc);
  return static_cast<int>(cudaGetLastError());
}
#endif
