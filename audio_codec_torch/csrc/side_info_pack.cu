// side_info_pack: the encoder's side information, written backward from the
// end of each stream's frame.
//
// Replaces audio_codec_tpu/ops/bits.py:pack_side_info (bits.py:66, on
// write_bit_backward :19 and write_uint_backward :36; enc_entropy.c:13-115),
// a chain of about 75 masked one-bit updates of the whole [B, nbytes] buffer.
//
// Bound on an H100: 18 int32 fields in, the row and two cursor words out
// (B x (72 + 4 nbytes + 8) bytes, 0.8 MB at B = 2048 and nbytes = 80, a
// quarter of a microsecond at 3.35 TB/s); the work is about 20 shifts and
// ors a field. The row's store is most of the bytes.
// Design: a warp a stream, blocks of 4 warps (side_info.cuh:
// side_info_pack_warp). Every lane loads the stream's fields (one broadcast
// request each, all in flight at once) and builds its side bits as a bit
// string in three registers, by shifts at offsets known once the fields are
// (side_info_pack_bits); lane l then writes bytes l, l + 32, ... of the row,
// each once and coalesced, zeros included: no read-modify-write, no chain
// through memory, no shared tile, no zeroed buffer. Lane 0 writes the cursor.
#include "side_info.cuh"

using namespace acx;

#ifdef __CUDACC__
constexpr int kPackWarps = 4;   // streams a block

__global__ void side_info_pack_kernel(
    const int32_t* __restrict__ bw_idx, const int32_t* __restrict__ lastnz,
    const int32_t* __restrict__ lsb_mode, const int32_t* __restrict__ gg_idx,
    const int32_t* __restrict__ num_tns, const int32_t* __restrict__ tns_order,
    const int32_t* __restrict__ ltpf, const int32_t* __restrict__ scf_idx,
    const int32_t* __restrict__ fac_ns_idx, int32_t* __restrict__ buf,
    int32_t* __restrict__ cursor, int B, SideLayout L) {
  const int lane = threadIdx.x % 32;
  const int b = blockIdx.x * kPackWarps + threadIdx.x / 32;
  if (b >= B) return;   // the whole warp leaves together
  SideFields s;
  s.bw_idx = bw_idx[b];
  s.lastnz = lastnz[b];
  s.lsb_mode = lsb_mode[b];
  s.gg_idx = gg_idx[b];
  s.num_tns = num_tns[b];
  s.tns_on[0] = tns_order[2 * b];
  s.tns_on[1] = tns_order[2 * b + 1];
#pragma unroll
  for (int k = 0; k < 3; ++k) s.ltpf[k] = ltpf[3 * b + k];
#pragma unroll
  for (int k = 0; k < 7; ++k) s.scf_idx[k] = scf_idx[7 * b + k];
  s.fac_ns_idx = fac_ns_idx[b];
  const SideCursor c = side_info_pack_warp(CoderCardWarp{lane}, L, s,
                                           buf + static_cast<size_t>(b) * L.nbytes);
  if (lane == 0) {
    cursor[b] = c.bp;
    cursor[B + b] = c.mask;
  }
}

extern "C" int acx_side_info_pack(const void* bw_idx, const void* lastnz, const void* lsb_mode,
                                  const void* gg_idx, const void* num_tns,
                                  const void* tns_order, const void* ltpf, const void* scf_idx,
                                  const void* fac_ns_idx, void* buf, void* cursor, int B,
                                  int nbytes, int start, int bw_bits, int lastnz_bits,
                                  void* stream) {
  // the string holds 64 + bw_bits + lastnz_bits bits at most
  if (nbytes < 1 || bw_bits < 0 || lastnz_bits < 0 || bw_bits + lastnz_bits > 32) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const SideLayout L = {nbytes, start, bw_bits, lastnz_bits, 0, 0, 0};
  const int blocks = (B + kPackWarps - 1) / kPackWarps;
  auto p = [](const void* v) { return static_cast<const int32_t*>(v); };
  side_info_pack_kernel<<<blocks, 32 * kPackWarps, 0, static_cast<cudaStream_t>(stream)>>>(
      p(bw_idx), p(lastnz), p(lsb_mode), p(gg_idx), p(num_tns), p(tns_order), p(ltpf),
      p(scf_idx), p(fac_ns_idx), static_cast<int32_t*>(buf), static_cast<int32_t*>(cursor), B, L);
  return static_cast<int>(cudaGetLastError());
}
#endif
