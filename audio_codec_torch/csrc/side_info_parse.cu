// side_info_parse: the decoder's side information, read backward from the
// end of each frame.
//
// Replaces audio_codec_tpu/ops/bits.py:parse_side_info (bits.py:123, on
// read_bit :45 and read_uint :54; dec_entropy.c:121-270), a chain of about
// 75 gathers of one byte per frame with three selects each. A thread reads a
// field of n bits in n steps, splits the joint SNS index of its own submode,
// and raises the bad-frame flag where a field is out of range.
//
// Bound on an H100: about 75 dependent bit reads per frame, all from the
// last ten bytes of its row; the bytes are those ten (one int32 word each)
// in and 21 int32 words out per frame, 2.0 MB at L = 16 384, 0.6 us at
// 3.35 TB/s. The chain is the bound.
// Design: one thread per frame reads its row's tail straight from device
// memory (a few 32-byte sectors, which stay in L1 for the next bit) and
// keeps the cursor and the fields in registers; the scalar fields are stored
// field-major, so a warp's stores are coalesced, and tns_on, scf_idx and
// ltpf_param in the [L, k] layouts their consumers take.
#include "side_info.cuh"

using namespace acx;

constexpr int kParseScalars = 9;  // bfi bw_idx lastnz lsb_mode gg_idx num_tns fac_ns bp mask

#ifdef __CUDACC__
constexpr int kParseThreads = 128;

__global__ void side_info_parse_kernel(const int32_t* __restrict__ buf,
                                       int32_t* __restrict__ scalars,
                                       int32_t* __restrict__ tns_on,
                                       int32_t* __restrict__ scf_idx,
                                       int32_t* __restrict__ ltpf, int n, SideLayout L) {
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= n) return;
  SideFields s;
  int bfi;
  const SideCursor c =
      side_info_parse_lane(buf + static_cast<size_t>(b) * L.nbytes, L, s, &bfi);
  const int v[kParseScalars] = {bfi,       s.bw_idx,     s.lastnz, s.lsb_mode, s.gg_idx,
                                s.num_tns, s.fac_ns_idx, c.bp,     c.mask};
#pragma unroll
  for (int k = 0; k < kParseScalars; ++k) scalars[static_cast<size_t>(k) * n + b] = v[k];
  tns_on[2 * b] = s.tns_on[0];
  tns_on[2 * b + 1] = s.tns_on[1];
#pragma unroll
  for (int k = 0; k < 7; ++k) scf_idx[7 * b + k] = s.scf_idx[k];
#pragma unroll
  for (int k = 0; k < 3; ++k) ltpf[3 * b + k] = s.ltpf[k];
}

extern "C" int acx_side_info_parse(const void* buf, void* scalars, void* tns_on, void* scf_idx,
                                   void* ltpf, int n, int nbytes, int start, int bw_bits,
                                   int lastnz_bits, int fs_idx, int ylen, int one_tns,
                                   void* stream) {
  const SideLayout L = {nbytes, start, bw_bits, lastnz_bits, fs_idx, ylen, one_tns};
  const int blocks = (n + kParseThreads - 1) / kParseThreads;
  side_info_parse_kernel<<<blocks, kParseThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(buf), static_cast<int32_t*>(scalars),
      static_cast<int32_t*>(tns_on), static_cast<int32_t*>(scf_idx),
      static_cast<int32_t*>(ltpf), n, L);
  return static_cast<int>(cudaGetLastError());
}
#endif
