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
// Bound on an H100: a chain of dependent steps per stream (200 tuples, each
// up to max_lev escape symbols with one or two renormalisations, plus up to
// a few hundred side-bit writes); the bytes are xq (B x N x 4), the residual
// bits and the 80-byte frame, about 5 MB at B = 2048, or 1.5 us at
// 3.35 TB/s. The chain is the bound.
// Design: one thread per stream holds low, range, cache, carry, carry_count
// and both byte pointers in registers; the stream's frame sits in shared
// memory as bytes; the 4096-entry lookup and the [64,18] cumulative
// frequency table sit in shared memory. Carry runs are written directly, as
// ac_shift_fl does.
#include "acodec.cuh"

using namespace acx;

struct AriTables {
  const int32_t* lookup;       // [4096]
  const int32_t* cumf;         // [64, 18]
  const int32_t* tns_freq_cf;  // [2, 9]
  const int32_t* tns_cf;       // [8, 18]
};

struct Enc {
  uint8_t* buf;
  int nbytes, bp, low, range, cache, carry, cc, bp_side, mask_side;
};

ACX_HD int enc_clip(const Enc& e, int p) { return iclamp(p, 0, e.nbytes - 1); }

// ac_shift_fl (ari_codec.c:585-611)
ACX_HD void enc_shift(Enc& e) {
  if (e.low < 0xFF0000 || e.carry == 1) {
    if (e.cache >= 0) {
      e.buf[enc_clip(e, e.bp)] = static_cast<uint8_t>((e.cache + e.carry) & 255);
      e.bp += 1;
    }
    if (e.cc > 0) {
      const uint8_t v = static_cast<uint8_t>((e.carry + 255) & 255);
      const int end = imin(e.bp + e.cc, e.nbytes);
      for (int p = enc_clip(e, e.bp); p < end; ++p) e.buf[p] = v;
    }
    e.bp += e.cc;
    e.cache = e.low >> 16;
    e.carry = 0;
    e.cc = 0;
  } else {
    e.cc += 1;
  }
  e.low = shl8_24(e.low);
}

// ac_encode_fl (ari_codec.c:565-583)
ACX_HD void enc_symbol(Enc& e, int sym_freq, int cum_freq) {
  const int r = e.range >> 10;
  const int low = e.low + r * cum_freq;
  if ((low >> 24) == 1) e.carry = 1;
  e.low = low & MASK24;
  e.range = r * sym_freq;
  for (int i = 0; i < 2; ++i) {
    if (e.range < (1 << 16)) {
      e.range <<= 8;
      enc_shift(e);
    }
  }
}

// write_bit_backward_fl
ACX_HD void enc_side_bit(Enc& e, int bit) {
  const int at = enc_clip(e, e.bp_side);
  const int cur = e.buf[at];
  e.buf[at] = static_cast<uint8_t>(bit == 0 ? (cur & (255 - e.mask_side)) : (cur | e.mask_side));
  if (e.mask_side == 128) {
    e.bp_side -= 1;
    e.mask_side = 1;
  } else {
    e.mask_side *= 2;
  }
}

// ac_finalize_fl (ari_codec.c:641-697)
ACX_HD void enc_finalize(Enc& e) {
  int bits = 24 - msb32(imax(e.range, 1));
  const int mask = MASK24 >> bits;
  int val = e.low + mask;
  const int over1 = val >> 24;
  val &= MASK24;
  int high = e.low + e.range;
  const int over2 = high >> 24;
  high &= MASK24;
  val &= (MASK24 - mask);
  const bool same = over1 == over2;
  if (same && val + mask >= high) {
    bits += 1;
    const int mask2 = mask >> 1;
    val = ((e.low + mask2) & MASK24) & (MASK24 - mask2);
  }
  if (same && val < e.low) e.carry = 1;
  e.low = val;

  const int n_shift = bits > 8 ? (bits + 7) / 8 : 1;
  for (int i = 0; i < 3; ++i) {
    if (i < n_shift) enc_shift(e);
  }
  int b = bits > 8 ? bits - 8 * n_shift : bits;
  if (b < 0) b += 8;

  const bool has_cc = e.cc > 0;
  if (has_cc) {
    e.buf[enc_clip(e, e.bp)] = static_cast<uint8_t>(e.cache & 255);
    e.bp += 1;
    const int run = imax(e.cc - 1, 0);
    const int end = imin(e.bp + run, e.nbytes);
    for (int p = enc_clip(e, e.bp); p < end; ++p) e.buf[p] = 255;
    e.bp += run;
  }
  const int wval = has_cc ? (b >= 8 ? 255 << (imax(b, 8) - 8) : 0) : e.cache;
  const int at = enc_clip(e, e.bp);
  int out = e.buf[at];
  int m = 128;
  for (int k = 0; k < 8; ++k) {
    if (k < b) out = (wval & m) == 0 ? (out & (255 - m)) : (out | m);
    m >>= 1;
  }
  e.buf[at] = static_cast<uint8_t>(out);
}

// One stream. buf: its frame bytes (side info packed), coded in place.
// side: bp_side, mask_side, num_tns, lastnz, lsb_mode, n_res;
// tns_order [2], tns_idx [2, 8]; res: its res_width residual bits.
// lsb_words: scratch for up to 32 * 32 LSB bits.
ACX_HD void ari_encode_lane(uint8_t* buf, int nbytes, const int32_t* xq, int N,
                            const int32_t* side, const int32_t* tns_order,
                            const int32_t* tns_idx, const int32_t* res, int res_width,
                            const AriTables& tb, int max_lev, int rate_flag, int lpcw,
                            int total_bits, uint32_t* lsb_words) {
  Enc e;
  e.buf = buf;
  e.nbytes = nbytes;
  e.bp = 0;
  e.low = 0;
  e.range = MASK24;
  e.cache = -1;
  e.carry = 0;
  e.cc = 0;
  e.bp_side = side[0];
  e.mask_side = side[1];
  const int num_tns = side[2], lastnz = side[3], lsb_mode = side[4], n_res = side[5];

  // TNS orders and coefficients
  for (int f = 0; f < 2; ++f) {
    const int order = tns_order[f];
    if (!(f < num_tns && order > 0)) continue;
    const int o = iclamp(order, 1, 8);
    const int cf = tb.tns_freq_cf[lpcw * 9 + o - 1];
    enc_symbol(e, tb.tns_freq_cf[lpcw * 9 + o] - cf, cf);
    for (int j = 0; j < 8 && j < order; ++j) {
      const int idx = tns_idx[f * 8 + j];
      const int c0 = tb.tns_cf[j * 18 + iclamp(idx, 0, 17)];
      enc_symbol(e, tb.tns_cf[j * 18 + iclamp(idx + 1, 0, 17)] - c0, c0);
    }
  }

  // spectral 2-tuples
  const bool save = lsb_mode == 1;
  int lsb_count = 0;
  for (int w = 0; w < 32; ++w) lsb_words[w] = 0u;
  auto push = [&](int v) {
    const int at = iclamp(lsb_count, 0, N - 1);
    if (v) lsb_words[at >> 5] |= (1u << (at & 31));
    else lsb_words[at >> 5] &= ~(1u << (at & 31));
    lsb_count += 1;
  };
  int c = 0;
  for (int k = 0; k < N / 2 && 2 * k < lastnz; ++k) {
    const int xa = xq[2 * k], xb = xq[2 * k + 1];
    const int a = iabs(xa), b = iabs(xb);
    const int t = c + rate_flag + (k > N / 4 ? 256 : 0);
    const int m = imax(a, b);
    const int nlev = m >= 4 ? imax(msb32(m) - 1, 0) : 0;
    const int aa = a >> nlev, bb = b >> nlev;
    int lsb1 = 0, lsb2 = 0;
    for (int lev = 0; lev < nlev && lev < max_lev; ++lev) {
      const int* row = tb.cumf + tb.lookup[iclamp(t + imin(lev, 3) * 1024, 0, 4095)] * 18;
      enc_symbol(e, row[17] - row[16], row[16]);
      const int bit1 = (a >> lev) & 1, bit2 = (b >> lev) & 1;
      if (lev == 0) {
        lsb1 = bit1;
        lsb2 = bit2;
        if (save) continue;
      }
      enc_side_bit(e, bit1);
      enc_side_bit(e, bit2);
    }
    const int* row = tb.cumf + tb.lookup[iclamp(t + imin(nlev, 3) * 1024, 0, 4095)] * 18;
    const int s = iclamp(aa + 4 * bb, 0, 16);
    enc_symbol(e, row[s + 1] - row[s], row[s]);

    const int a1 = a >> 1, b1 = b >> 1;
    const bool shifted = save && nlev > 0;
    if (shifted) {
      push(lsb1);
      if (a1 == 0 && a != 0) push(xa < 0);
      push(lsb2);
      if (b1 == 0 && b != 0) push(xb < 0);
    }
    if ((shifted ? a1 : a) != 0) enc_side_bit(e, xa < 0);
    if ((shifted ? b1 : b) != 0) enc_side_bit(e, xb < 0);

    const int levm1 = imin(nlev, 3) - 1;
    c = (c & 15) * 16 + (levm1 <= 0 ? 1 + (aa + bb) * (levm1 + 2) : 13 + levm1);
  }

  // residual or LSB bits (ari_codec.c:826-860)
  const int nbits_side = total_bits - (8 * (e.bp_side + 1) + 8 - msb32(imax(e.mask_side, 1)));
  const int nbits_ari = (e.bp + 1) * 8 + 25 - msb32(imax(e.range, 1))
      + (e.cache >= 0 ? 8 : 0) + e.cc * 8;
  const int nbits_res = imax(total_bits - (nbits_side + nbits_ari), 0);
  const int n_fill = imin(nbits_res, lsb_mode == 0 ? n_res : lsb_count);
  const int max_fill = imin(imax(res_width, N), total_bits);
  for (int k = 0; k < n_fill && k < max_fill; ++k) {
    int bit;
    if (lsb_mode == 0) bit = k < res_width ? res[k] : 0;
    else bit = k < N ? static_cast<int>((lsb_words[k >> 5] >> (k & 31)) & 1u) : 0;
    enc_side_bit(e, bit);
  }
  enc_finalize(e);
}

#ifdef __CUDACC__
constexpr int kAriEncThreads = 32;
constexpr int kTabWords = 4096 + 64 * 18 + 2 * 9 + 8 * 18;

__global__ void ari_encode_kernel(const int32_t* __restrict__ buf_in,
                                  int32_t* __restrict__ buf_out,
                                  const int32_t* __restrict__ xq,
                                  const int32_t* __restrict__ side,  // [6, B]
                                  const int32_t* __restrict__ tns_order,
                                  const int32_t* __restrict__ tns_idx,
                                  const int32_t* __restrict__ res, const int32_t* __restrict__ tabs,
                                  int B, int N, int nbytes, int res_width, int max_lev,
                                  int rate_flag, int lpcw, int total_bits) {
  extern __shared__ int32_t smem[];
  acx_load_shared(smem, tabs, kTabWords);
  __syncthreads();
  const int s = blockIdx.x * blockDim.x + threadIdx.x;
  if (s >= B) return;
  AriTables tb;
  tb.lookup = smem;
  tb.cumf = smem + 4096;
  tb.tns_freq_cf = tb.cumf + 64 * 18;
  tb.tns_cf = tb.tns_freq_cf + 2 * 9;
  uint8_t* buf = reinterpret_cast<uint8_t*>(smem + kTabWords) + threadIdx.x * nbytes;
  const int32_t* in = buf_in + static_cast<size_t>(s) * nbytes;
  for (int i = 0; i < nbytes; ++i) buf[i] = static_cast<uint8_t>(in[i]);
  int32_t sd[6];
  for (int j = 0; j < 6; ++j) sd[j] = side[j * B + s];
  uint32_t lsb_words[32];
  ari_encode_lane(buf, nbytes, xq + static_cast<size_t>(s) * N, N, sd, tns_order + 2 * s,
                  tns_idx + 16 * s, res + static_cast<size_t>(s) * res_width, res_width, tb,
                  max_lev, rate_flag, lpcw, total_bits, lsb_words);
  int32_t* out = buf_out + static_cast<size_t>(s) * nbytes;
  for (int i = 0; i < nbytes; ++i) out[i] = buf[i];
}

extern "C" int acx_ari_encode(const void* buf_in, void* buf_out, const void* xq,
                              const void* side, const void* tns_order, const void* tns_idx,
                              const void* res, const void* tabs, int B, int N, int nbytes,
                              int res_width, int max_lev, int rate_flag, int lpcw,
                              int total_bits, void* stream) {
  const size_t smem = kTabWords * sizeof(int32_t) + static_cast<size_t>(kAriEncThreads) * nbytes;
  cudaError_t err = cudaFuncSetAttribute(ari_encode_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const int blocks = (B + kAriEncThreads - 1) / kAriEncThreads;
  ari_encode_kernel<<<blocks, kAriEncThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(buf_in), static_cast<int32_t*>(buf_out),
      static_cast<const int32_t*>(xq), static_cast<const int32_t*>(side),
      static_cast<const int32_t*>(tns_order), static_cast<const int32_t*>(tns_idx),
      static_cast<const int32_t*>(res), static_cast<const int32_t*>(tabs), B, N, nbytes,
      res_width, max_lev, rate_flag, lpcw, total_bits);
  return static_cast<int>(cudaGetLastError());
}
#endif
