// side_info_pack: the encoder's side information, written backward from the
// end of each stream's frame.
//
// Replaces audio_codec_tpu/ops/bits.py:pack_side_info (bits.py:66, on
// write_bit_backward :19 and write_uint_backward :36; enc_entropy.c:13-115),
// a chain of about 75 masked one-bit updates of the whole [B, nbytes] buffer.
// A thread writes a field of n bits in n steps and branches on its own
// stream's submode and LTPF flag.
//
// Bound on an H100: each stream does about 75 dependent read-modify-writes
// of a byte; the bytes are 18 int32 fields in and the zeroed row plus two
// cursor words out (B x (72 + 4 nbytes + 8) bytes, 0.8 MB at B = 2048 and
// nbytes = 80, a quarter of a microsecond at 3.35 TB/s). The row's store is
// most of the bytes; the chain is the bound.
// Design: one thread per stream; a block zeroes its streams' rows in shared
// memory, each thread writes its bits there (side_info.cuh), and the block
// stores the rows coalesced, so the caller passes no zeroed buffer.
#include "side_info.cuh"

using namespace acx;

#ifdef __CUDACC__
constexpr int kPackThreads = 32;

__global__ void side_info_pack_kernel(
    const int32_t* __restrict__ bw_idx, const int32_t* __restrict__ lastnz,
    const int32_t* __restrict__ lsb_mode, const int32_t* __restrict__ gg_idx,
    const int32_t* __restrict__ num_tns, const int32_t* __restrict__ tns_order,
    const int32_t* __restrict__ ltpf, const int32_t* __restrict__ scf_idx,
    const int32_t* __restrict__ fac_ns_idx, int32_t* __restrict__ buf,
    int32_t* __restrict__ cursor, int B, SideLayout L) {
  extern __shared__ int32_t tile[];
  const int row0 = blockIdx.x * blockDim.x;
  const int rows = imin(static_cast<int>(blockDim.x), B - row0);
  const int stride = ACX_ROW_STRIDE(L.nbytes);
  for (int i = threadIdx.x; i < rows * stride; i += blockDim.x) tile[i] = 0;
  __syncthreads();
  const int t = threadIdx.x;
  if (t < rows) {
    const int b = row0 + t;
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
    const SideCursor c = side_info_pack_lane(tile + t * stride, L, s);
    cursor[b] = c.bp;
    cursor[B + b] = c.mask;
  }
  __syncthreads();
  acx_store_rows(buf, tile, row0, rows, L.nbytes);
}

extern "C" int acx_side_info_pack(const void* bw_idx, const void* lastnz, const void* lsb_mode,
                                  const void* gg_idx, const void* num_tns,
                                  const void* tns_order, const void* ltpf, const void* scf_idx,
                                  const void* fac_ns_idx, void* buf, void* cursor, int B,
                                  int nbytes, int start, int bw_bits, int lastnz_bits,
                                  void* stream) {
  size_t smem = 0;
  cudaError_t err = acx_row_tiles_smem(side_info_pack_kernel, kPackThreads, nbytes, &smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const SideLayout L = {nbytes, start, bw_bits, lastnz_bits, 0, 0, 0};
  const int blocks = (B + kPackThreads - 1) / kPackThreads;
  auto p = [](const void* v) { return static_cast<const int32_t*>(v); };
  side_info_pack_kernel<<<blocks, kPackThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      p(bw_idx), p(lastnz), p(lsb_mode), p(gg_idx), p(num_tns), p(tns_order), p(ltpf),
      p(scf_idx), p(fac_ns_idx), static_cast<int32_t*>(buf), static_cast<int32_t*>(cursor), B, L);
  return static_cast<int>(cudaGetLastError());
}
#endif
