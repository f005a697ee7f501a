// ari_decode: the range decoder of one frame per lane.
//
// Replaces audio_codec_tpu/ops/ari.py:decode (ari.py:491) for frames without
// a partial-concealment block (n_pc == 0), with dec_init (:419) and
// ac_decode (:455): processAriDecoder_fl in ari_codec.c. It decodes the TNS
// orders and coefficients, the spectral 2-tuples with escapes and the
// bit-error checks (ari.py:579-651), the residual bits (:657-692), the LSB
// refinement (:694-728), nf_seed and zero_frame (:743-751). decode_block
// runs it once over the T*B frames of a block (models/decoder.py).
//
// Bound on an H100: a chain of dependent steps per lane (each symbol's
// table row depends on the previous tuple's context, and each step does a
// 17-entry search of the cumulative frequencies); the bytes are the frames
// (T*B x 80 x 4) in and x (T*B x 400 x 4) plus residual bits out, about
// 7 MB at T*B = 4096, or 2 us at 3.35 TB/s. The chain is the bound. The
// per-symbol table gathers are what docs/PERF.md:126-134 names as the decode
// bottleneck of the reference package.
// Design: one thread per lane keeps low, range, both pointers and the
// context in registers; the frame bytes of the lane and the 4096-entry
// lookup and [64,18] cumulative frequency tables sit in shared memory.
#include "acodec.cuh"

using namespace acx;

struct DecTables {
  const int32_t* lookup;     // [4096]
  const int32_t* cumf;       // [64, 18]
  const int32_t* order_cf;   // [2, 9]
  const int32_t* coef_cf;    // [8, 18]
};

struct Dec {
  const uint8_t* buf;
  int nbytes, bp, low, range, ber, bp_side, mask_side;
};

ACX_HD int dec_byte(const Dec& d, int p) { return d.buf[iclamp(p, 0, d.nbytes - 1)]; }

// ac_decode_fl (ari_codec.c:115-146) over a row of num_sym + 1 cumulative
// frequencies
ACX_HD int dec_symbol(Dec& d, const int32_t* row, int num_sym) {
  const int tmp = d.range >> 10;
  if (d.low >= (tmp << 10)) d.ber = 1;
  int cnt = 0;
  for (int j = 0; j < num_sym; ++j) cnt += (tmp * row[j] <= d.low) ? 1 : 0;
  const int val = iclamp(cnt - 1, 0, num_sym - 1);
  const int cf = row[val];
  d.low -= tmp * cf;
  d.range = tmp * (row[val + 1] - cf);
  for (int i = 0; i < 2; ++i) {
    if (d.range < (1 << 16)) {
      d.low = shl8_24(d.low) + dec_byte(d, d.bp);
      d.bp += 1;
      d.range <<= 8;
    }
  }
  return val;
}

ACX_HD int dec_side_bit(Dec& d) {
  const int bit = (dec_byte(d, d.bp_side) & d.mask_side) != 0 ? 1 : 0;
  if (d.mask_side == 128) {
    d.bp_side -= 1;
    d.mask_side = 1;
  } else {
    d.mask_side *= 2;
  }
  return bit;
}

// Scalar outputs of one lane, in this order.
enum DecOut { OUT_NF_SEED, OUT_ZERO_FRAME, OUT_N_RES, OUT_RES_PRESENT, OUT_BFI,
              OUT_SPEC_INV, OUT_B_LEFT, N_DEC_OUT };

// One lane. side: lastnz, lsb_mode, num_tns, tns_on0, tns_on1, bp_side,
// mask_side, gg_idx, fac_ns_idx. Writes x [N], tns_order [2], tns_idx [16],
// res [max_res], levs [N/2] (scratch) and out[j * stride].
ACX_HD void ari_decode_lane(const uint8_t* buf, int nbytes, const int32_t* side,
                            const DecTables& tb, int N, int max_lev, bool hrmode,
                            int tns_max, int lpcw, int rate_flag, int total_bits,
                            int max_res, int res_iters, int32_t* x, int32_t* tns_order,
                            int32_t* tns_idx, int32_t* res, uint8_t* levs, int32_t* out,
                            int stride) {
  const int lastnz = side[0], lsb_mode = side[1], num_tns = side[2];
  Dec d;
  d.buf = buf;
  d.nbytes = nbytes;
  d.low = (dec_byte(d, 0) << 16) + (dec_byte(d, 1) << 8) + dec_byte(d, 2);
  d.bp = 3;
  d.range = MASK24;
  d.ber = 0;
  d.bp_side = side[5];
  d.mask_side = side[6];
  int bfi = 0;
  for (int i = 0; i < N; ++i) x[i] = 0;
  for (int i = 0; i < N / 2; ++i) levs[i] = 0;
  for (int i = 0; i < 2; ++i) tns_order[i] = 0;
  for (int i = 0; i < 16; ++i) tns_idx[i] = 0;
  for (int i = 0; i < max_res; ++i) res[i] = 0;

  // TNS
  for (int f = 0; f < 2; ++f) {
    if (!(f < num_tns && side[3 + f] > 0 && bfi == 0)) continue;
    const int order = dec_symbol(d, tb.order_cf + lpcw * 9, 8) + 1;
    if (order > tns_max) bfi = 1;
    tns_order[f] = order;
    for (int k = 0; k < 8; ++k) {
      if (!(k < order && bfi == 0)) continue;
      if (d.bp_side < d.bp) bfi = 1;
      tns_idx[f * 8 + k] = dec_symbol(d, tb.coef_cf + k * 18, 17);
    }
  }
  bfi |= d.ber;

  // spectral 2-tuples
  int c = 0;
  for (int k = 0; k < N / 2; ++k) {
    if (!(2 * k < lastnz && bfi == 0)) break;
    const int t = c + rate_flag + (k > N / 4 ? 256 : 0);
    int ak = 0, bk = 0, lev_fin = 0, sym_fin = 0;
    bool done = false;
    for (int lev = 0; lev < max_lev && !done; ++lev) {
      const int pki = tb.lookup[iclamp(t + imin(lev, 3) * 1024, 0, 4095)];
      const int sym = dec_symbol(d, tb.cumf + pki * 18, 17);
      if (sym >= 16) {
        if (lsb_mode == 0 || lev > 0) {
          ak += dec_side_bit(d) << lev;
          bk += dec_side_bit(d) << lev;
        }
        lev_fin = lev + 1;
      } else {
        lev_fin = lev;
        sym_fin = sym;
        done = true;
      }
    }
    int lev_eff = lev_fin;
    if (!hrmode) {
      if (!done && lev_fin - 1 == 13) bfi = 1;
      lev_eff = imin(lev_fin, 13);
    }
    const int a_fin = sym_fin & 3, b_fin = sym_fin >> 2;
    ak += a_fin << lev_eff;
    bk += b_fin << lev_eff;
    if (ak > 0 && bfi == 0 && dec_side_bit(d) == 1) ak = -ak;
    if (bk > 0 && bfi == 0 && dec_side_bit(d) == 1) bk = -bk;
    x[2 * k] = ak;
    x[2 * k + 1] = bk;
    levs[k] = static_cast<uint8_t>(lev_eff);
    const int lev1 = imin(lev_eff, 3);
    c = (c & 15) * 16 + (lev1 <= 1 ? 1 + (a_fin + b_fin) * (lev1 + 1) : 12 + lev1);
    if (d.bp - d.bp_side > 3) bfi = 1;
    bfi |= d.ber;
  }

  // residual bits (ari_codec.c:965-1000)
  const int nbits_side = total_bits - (8 * (d.bp_side + 1) + 8 - msb32(imax(d.mask_side, 1)));
  const int nbits_ari = (d.bp + 1 - 3) * 8 + 25 - msb32(imax(d.range, 1));
  int nbits_residual = total_bits - (nbits_side + nbits_ari);
  if (bfi == 0 && nbits_residual < 0) bfi = 1;
  nbits_residual = imax(nbits_residual, 0);
  int nz = 0;
  for (int i = 0; i < N; ++i) nz += x[i] != 0 ? 1 : 0;
  const int n_res0 = imin(nbits_residual, nz * res_iters);
  if (lsb_mode == 0 && bfi == 0) {
    for (int k = 0; k < n_res0 && k < max_res; ++k) res[k] = dec_side_bit(d);
  }

  // LSB refinement (ari_codec.c:476-556)
  if (lsb_mode == 1 && bfi == 0) {
    int budget = nbits_residual;
    for (int k = 0; k < N / 2; ++k) {
      if (!(levs[k] > 0 && 2 * k < lastnz)) continue;
      for (int j = 2 * k; j < 2 * k + 2; ++j) {
        if (budget <= 0) continue;
        const int xv = x[j];
        const int bit = dec_side_bit(d);
        budget -= 1;
        if (bit == 1 && xv != 0) {
          x[j] = xv > 0 ? xv + 1 : xv - 1;
        } else if (bit == 1 && xv == 0 && budget > 0) {
          const int bit2 = dec_side_bit(d);
          budget -= 1;
          x[j] = bit2 == 0 ? 1 : -1;
        }
      }
    }
  }

  unsigned seed = 0;
  for (int i = 0; i < N; ++i) seed += static_cast<unsigned>(iabs(x[i])) * static_cast<unsigned>(i);
  int nf_seed = static_cast<int>(seed & 65535u);
  if (nf_seed >= 32768) nf_seed -= 65536;
  const int zero_frame = (lastnz == 2 && x[0] == 0 && x[1] == 0 && side[7] == 0
                          && side[8] == 7) ? 1 : 0;
  if (bfi == 0 && d.ber > 0) bfi = 1;
  out[OUT_NF_SEED * stride] = nf_seed;
  out[OUT_ZERO_FRAME * stride] = zero_frame;
  out[OUT_N_RES * stride] = lsb_mode == 0 ? n_res0 : 0;
  out[OUT_RES_PRESENT * stride] = lsb_mode == 0 ? 1 : 0;
  out[OUT_BFI * stride] = bfi;
  out[OUT_SPEC_INV * stride] = N;
  out[OUT_B_LEFT * stride] = 0;
}

#ifdef __CUDACC__
constexpr int kAriDecThreads = 32;
constexpr int kDecTabWords = 4096 + 64 * 18 + 2 * 9 + 8 * 18;

__global__ void ari_decode_kernel(const int32_t* __restrict__ frames,
                                  const int32_t* __restrict__ side,  // [9, L]
                                  const int32_t* __restrict__ tabs,
                                  int32_t* __restrict__ x, int32_t* __restrict__ tns_order,
                                  int32_t* __restrict__ tns_idx, int32_t* __restrict__ res,
                                  uint8_t* __restrict__ levs, int32_t* __restrict__ out,
                                  int L, int nbytes, int N, int max_lev, int hrmode,
                                  int tns_max, int lpcw, int rate_flag, int total_bits,
                                  int max_res, int res_iters) {
  extern __shared__ int32_t smem[];
  acx_load_shared(smem, tabs, kDecTabWords);
  __syncthreads();
  const int s = blockIdx.x * blockDim.x + threadIdx.x;
  if (s >= L) return;
  DecTables tb;
  tb.lookup = smem;
  tb.cumf = smem + 4096;
  tb.order_cf = tb.cumf + 64 * 18;
  tb.coef_cf = tb.order_cf + 2 * 9;
  uint8_t* buf = reinterpret_cast<uint8_t*>(smem + kDecTabWords) + threadIdx.x * nbytes;
  const int32_t* in = frames + static_cast<size_t>(s) * nbytes;
  for (int i = 0; i < nbytes; ++i) buf[i] = static_cast<uint8_t>(in[i]);
  int32_t sd[9];
  for (int j = 0; j < 9; ++j) sd[j] = side[j * L + s];
  ari_decode_lane(buf, nbytes, sd, tb, N, max_lev, hrmode != 0, tns_max, lpcw, rate_flag,
                  total_bits, max_res, res_iters, x + static_cast<size_t>(s) * N,
                  tns_order + 2 * s, tns_idx + 16 * s, res + static_cast<size_t>(s) * max_res,
                  levs + static_cast<size_t>(s) * (N / 2), out + s, L);
}

extern "C" int acx_ari_decode(const void* frames, const void* side, const void* tabs, void* x,
                              void* tns_order, void* tns_idx, void* res, void* levs, void* out,
                              int L, int nbytes, int N, int max_lev, int hrmode, int tns_max,
                              int lpcw, int rate_flag, int total_bits, int max_res,
                              int res_iters, void* stream) {
  const size_t smem = kDecTabWords * sizeof(int32_t) + static_cast<size_t>(kAriDecThreads) * nbytes;
  cudaError_t err = cudaFuncSetAttribute(ari_decode_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const int blocks = (L + kAriDecThreads - 1) / kAriDecThreads;
  ari_decode_kernel<<<blocks, kAriDecThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(frames), static_cast<const int32_t*>(side),
      static_cast<const int32_t*>(tabs), static_cast<int32_t*>(x),
      static_cast<int32_t*>(tns_order), static_cast<int32_t*>(tns_idx),
      static_cast<int32_t*>(res), static_cast<uint8_t*>(levs), static_cast<int32_t*>(out), L,
      nbytes, N, max_lev, hrmode, tns_max, lpcw, rate_flag, total_bits, max_res, res_iters);
  return static_cast<int>(cudaGetLastError());
}
#endif
