// The range decoder of one frame per lane: the lane function of
// csrc/ari_decode.cu.
//
// processAriDecoder_fl (ari_codec.c) as audio_codec_tpu/ops/ari.py:decode
// (ari.py:491) computes it, with dec_init (:419) and ac_decode (:455): the
// TNS orders and coefficients, the spectral 2-tuples with escapes and the
// bit-error checks (ari.py:579-651), the residual bits (:657-692), the LSB
// refinement (:694-728), nf_seed and zero_frame (:743-751).
//
// The lane is a template on the partial-concealment mode, chosen once per
// launch: kPcNone (no PC block, n_pc == 0), kPcDecode (the frame carries a
// relocated PC block: _pc_check :379 before every forward byte and every
// fresh backward byte, the PC branch of dec_init :419, the consumed-bits
// rule :661-668, the bfi 2 conversion with spec_inv_idx :732-752) and
// kPcEncSim (the encoder's simulation on the logical stream, which stops at
// the pointers' convergence and returns b_left, :759-765). The kPcNone
// instantiation is the decoder of slices 1-5: every hook is `if constexpr`.
#pragma once

#include "acodec.cuh"

namespace acx {

enum PcMode { kPcNone = 0, kPcDecode = 1, kPcEncSim = 2 };

struct DecTables {
  const int32_t* lookup;     // [4096]
  const int32_t* cumf;       // [64, 18]
  const int32_t* order_cf;   // [2, 9]
  const int32_t* coef_cf;    // [8, 18]
};

struct Dec {
  const uint8_t* buf;
  int nbytes, bp, low, range, ber, bp_side, mask_side;
  // partial-concealment pointer state (Pc_State_fx, ari_codec.c:18-33)
  int pcb, b_left, b_right, inv_bin, be_l, be_r;
  bool c_bp, c_bp_side, bfi2;
};

ACX_HD int dec_byte(const Dec& d, int p) { return d.buf[iclamp(p, 0, d.nbytes - 1)]; }

// check_pc_bytes (ari_codec.c:1824-1921) before a forward byte read
// (from_left) or a backward bit read; true where the read must not happen
template <int kPc>
ACX_HD bool pc_check(Dec& d, int cur_bin, bool act, bool from_left) {
  if (!from_left) act = act && d.mask_side == 1;
  const int bp_local = from_left ? d.bp : d.bp - 1;
  const int bp_side_local = from_left ? d.bp_side + (d.mask_side == 1 ? 1 : 0) : d.bp_side;
  const int offset = kPc == kPcEncSim ? -1 : d.pcb - 1;
  const bool conv = act && d.b_right < 0 && bp_side_local + offset - bp_local == d.pcb;
  if (conv) {
    d.b_left = bp_local + 1;
    d.b_right = bp_side_local - 1;
  }
  if (kPc == kPcEncSim) return conv;
  const bool have = act && d.b_right >= 0;
  if (from_left) {
    if (have && d.bp == d.b_left) {
      d.bp = 0;
      d.c_bp = true;
    }
  } else if (have && bp_side_local == d.b_right) {
    d.bp_side = d.pcb - 1;
    d.c_bp_side = true;
  }
  const bool in2 = act && d.bfi2;
  const bool trig = in2 && ((d.c_bp && d.bp >= d.be_l) || (d.c_bp_side && d.bp_side <= d.be_r));
  const bool soft = in2 && !trig && (d.c_bp || (d.c_bp_side && d.bp_side <= d.pcb - 1));
  if (trig) {
    d.inv_bin = cur_bin;
  } else if (soft) {
    d.inv_bin = imin(d.inv_bin, cur_bin);
  }
  return trig;
}

// ac_decode_fl (ari_codec.c:115-146) over a row of num_sym + 1 cumulative
// frequencies; *stop is set where the PC hook suppressed a byte read
template <int kPc>
ACX_HD int dec_symbol(Dec& d, const int32_t* row, int num_sym, int cur_bin, bool* stop) {
  const int tmp = d.range >> 10;
  if (d.low >= (tmp << 10)) d.ber = 1;
  int cnt = 0;
  for (int j = 0; j < num_sym; ++j) cnt += (tmp * row[j] <= d.low) ? 1 : 0;
  const int val = iclamp(cnt - 1, 0, num_sym - 1);
  const int cf = row[val];
  d.low -= tmp * cf;
  d.range = tmp * (row[val + 1] - cf);
  *stop = false;
  for (int i = 0; i < 2; ++i) {
    if (d.range < (1 << 16)) {
      if constexpr (kPc != kPcNone) {
        if (pc_check<kPc>(d, cur_bin, true, true)) {
          *stop = true;
          break;
        }
      }
      d.low = shl8_24(d.low) + dec_byte(d, d.bp);
      d.bp += 1;
      d.range <<= 8;
    }
  }
  return val;
}

// one backward bit; *trig is set (and nothing read) where the PC hook stops
template <int kPc>
ACX_HD int dec_side_bit(Dec& d, int cur_bin, bool* trig) {
  *trig = false;
  if constexpr (kPc != kPcNone) {
    if (pc_check<kPc>(d, cur_bin, true, false)) {
      *trig = true;
      return 0;
    }
  }
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

// The configuration of a launch.
struct DecGeom {
  int N, max_lev, hrmode, tns_max, lpcw, rate_flag, total_bits, max_res, res_iters;
  int pc_bytes, numbytes;   // of the PC block (kPcDecode, kPcEncSim)
};

// One lane. side: lastnz, lsb_mode, num_tns, tns_on0, tns_on1, bp_side,
// mask_side, gg_idx, fac_ns_idx; bfi_in, be_l, be_r: the channel's bfi and
// corrupt bit range (kPcDecode). Writes x [N], tns_order [2], tns_idx [16],
// res [max_res], levs [N/2] (scratch) and out[j * stride].
template <int kPc>
ACX_HD void ari_decode_lane(const uint8_t* buf, int nbytes, const int32_t* side,
                            const DecTables& tb, const DecGeom& g, int bfi_in, int be_l,
                            int be_r, int32_t* x, int32_t* tns_order, int32_t* tns_idx,
                            int32_t* res, uint8_t* levs, int32_t* out, int stride) {
  const int N = g.N;
  const int lastnz = side[0], lsb_mode = side[1], num_tns = side[2];
  Dec d;
  d.buf = buf;
  d.nbytes = nbytes;
  d.range = MASK24;
  d.ber = 0;
  d.bp_side = side[5];
  d.mask_side = side[6];
  d.pcb = g.pc_bytes;
  d.b_left = 0;
  d.b_right = -1;
  d.inv_bin = N + 1;
  d.be_l = -1;
  d.be_r = -1;
  d.c_bp = d.c_bp_side = d.bfi2 = false;
  int bfi = 0;
  bool stop;
  if constexpr (kPc == kPcNone) {
    d.low = (dec_byte(d, 0) << 16) + (dec_byte(d, 1) << 8) + dec_byte(d, 2);
    d.bp = 3;
  } else {
    // the forward pointer starts past the relocated block, the encoder's
    // simulation at 0 (ari_codec.c:490-495)
    d.bp = kPc == kPcEncSim ? 0 : g.pc_bytes;
    d.low = 0;
    d.b_left = g.numbytes + 1;
    d.be_l = be_l >> 3;
    d.be_r = be_r >> 3;
    d.bfi2 = bfi_in == 2;
    for (int i = 0; i < 3 && bfi == 0; ++i) {
      if (pc_check<kPc>(d, 0, true, true)) {
        bfi = 1;
      } else {
        d.low = (d.low << 8) + dec_byte(d, d.bp);
        d.bp += 1;
      }
    }
  }
  for (int i = 0; i < N; ++i) x[i] = 0;
  for (int i = 0; i < N / 2; ++i) levs[i] = 0;
  for (int i = 0; i < 2; ++i) tns_order[i] = 0;
  for (int i = 0; i < 16; ++i) tns_idx[i] = 0;
  for (int i = 0; i < g.max_res; ++i) res[i] = 0;

  // TNS
  for (int f = 0; f < 2; ++f) {
    if (!(f < num_tns && side[3 + f] > 0 && bfi == 0)) continue;
    const int order = dec_symbol<kPc>(d, tb.order_cf + g.lpcw * 9, 8, 0, &stop) + 1;
    if (stop) bfi = 1;
    if (order > g.tns_max) bfi = 1;
    tns_order[f] = order;
    for (int k = 0; k < 8; ++k) {
      if (!(k < order && bfi == 0)) continue;
      if (d.bp_side < d.bp) bfi = 1;
      tns_idx[f * 8 + k] = dec_symbol<kPc>(d, tb.coef_cf + k * 18, 17, 0, &stop);
      if (stop) bfi = 1;
    }
  }
  bfi |= d.ber;

  // spectral 2-tuples
  int c = 0;
  bool trig;
  for (int k = 0; k < N / 2; ++k) {
    if (!(2 * k < lastnz && bfi == 0)) break;
    const int t = c + g.rate_flag + (k > N / 4 ? 256 : 0);
    int ak = 0, bk = 0, lev_fin = 0, sym_fin = 0;
    bool done = false;
    for (int lev = 0; lev < g.max_lev && !done && bfi == 0; ++lev) {
      const int pki = tb.lookup[iclamp(t + imin(lev, 3) * 1024, 0, 4095)];
      const int sym = dec_symbol<kPc>(d, tb.cumf + pki * 18, 17, 2 * k, &stop);
      if (stop) {
        bfi = 1;
        break;
      }
      if (sym >= 16) {
        if (lsb_mode == 0 || lev > 0) {
          const int bit1 = dec_side_bit<kPc>(d, 2 * k, &trig);
          if (trig) {
            bfi = 1;
          } else {
            ak += bit1 << lev;
            const int bit2 = dec_side_bit<kPc>(d, 2 * k, &trig);
            if (trig) {
              bfi = 1;
            } else {
              bk += bit2 << lev;
            }
          }
        }
        lev_fin = lev + 1;
      } else {
        lev_fin = lev;
        sym_fin = sym;
        done = true;
      }
    }
    int lev_eff = lev_fin;
    if (!g.hrmode) {
      if (!done && lev_fin - 1 == 13) bfi = 1;
      lev_eff = imin(lev_fin, 13);
    }
    const int a_fin = sym_fin & 3, b_fin = sym_fin >> 2;
    ak += a_fin << lev_eff;
    bk += b_fin << lev_eff;
    if (ak > 0 && bfi == 0) {
      const int bit = dec_side_bit<kPc>(d, 2 * k, &trig);
      if (trig) bfi = 1;
      else if (bit == 1) ak = -ak;
    }
    if (bk > 0 && bfi == 0) {
      const int bit = dec_side_bit<kPc>(d, 2 * k + 1, &trig);
      if (trig) bfi = 1;
      else if (bit == 1) bk = -bk;
    }
    x[2 * k] = ak;
    x[2 * k + 1] = bk;
    levs[k] = static_cast<uint8_t>(lev_eff);
    const int lev1 = imin(lev_eff, 3);
    c = (c & 15) * 16 + (lev1 <= 1 ? 1 + (a_fin + b_fin) * (lev1 + 1) : 12 + lev1);
    // with a PC block the pointers are compared only while both are on the
    // same side of it (ari_codec.c:750)
    if (d.bp - d.bp_side > 3 && (kPc == kPcNone || d.c_bp == d.c_bp_side)) bfi = 1;
    bfi |= d.ber;
  }

  // residual bits (ari_codec.c:965-1000; with a PC block, :965-981)
  const int log2_mask = msb32(imax(d.mask_side, 1)), msb_r = msb32(imax(d.range, 1));
  int nbits_side, nbits_ari;
  if constexpr (kPc == kPcDecode) {
    const int consumed = d.c_bp ? d.bp + d.b_left - d.pcb : d.bp - d.pcb;
    nbits_ari = (consumed + 1 - 3) * 8 + 25 - msb_r;
    nbits_side = g.total_bits - 16 + log2_mask
                 - 8 * (d.c_bp_side ? d.b_left - d.pcb + d.bp_side : d.bp_side);
  } else {
    nbits_side = g.total_bits - (8 * (d.bp_side + 1) + 8 - log2_mask);
    nbits_ari = (d.bp + 1 - 3) * 8 + 25 - msb_r;
  }
  int nbits_residual = g.total_bits - (nbits_side + nbits_ari);
  if (bfi == 0 && nbits_residual < 0) bfi = 1;
  nbits_residual = imax(nbits_residual, 0);
  int nz = 0;
  for (int i = 0; i < N; ++i) nz += x[i] != 0 ? 1 : 0;
  const int n_res0 = imin(nbits_residual, nz * g.res_iters);
  // a residual-phase read that enters the corrupt bytes ends the residual
  bool res_dead = false;
  if (lsb_mode == 0 && bfi == 0) {
    for (int k = 0; k < n_res0 && k < g.max_res; ++k) {
      const int bit = dec_side_bit<kPc>(d, d.inv_bin, &trig);
      if (trig) {
        res_dead = true;
        break;
      }
      res[k] = bit;
    }
  }

  // LSB refinement (ari_codec.c:476-556)
  if (lsb_mode == 1 && bfi == 0) {
    int budget = nbits_residual;
    for (int k = 0; k < N / 2; ++k) {
      if (!(levs[k] > 0 && 2 * k < lastnz)) continue;
      for (int j = 2 * k; j < 2 * k + 2; ++j) {
        if (budget <= 0 || res_dead) continue;
        const int xv = x[j];
        const int bit = dec_side_bit<kPc>(d, d.inv_bin, &trig);
        if (trig) {
          res_dead = true;
          continue;
        }
        budget -= 1;
        if (bit == 1 && xv != 0) {
          x[j] = xv > 0 ? xv + 1 : xv - 1;
        } else if (bit == 1 && xv == 0 && budget > 0) {
          const int bit2 = dec_side_bit<kPc>(d, d.inv_bin, &trig);
          if (trig) {
            res_dead = true;
          } else {
            budget -= 1;
            x[j] = bit2 == 0 ? 1 : -1;
          }
        }
      }
    }
  }

  int n_res = lsb_mode == 0 ? n_res0 : 0;
  int spec_inv = N;
  if constexpr (kPc == kPcDecode) {
    // ber_detect: an abort with a valid inv_bin is a partial loss
    // (ari_codec.c:1164-1187)
    if (bfi == 1 && d.inv_bin > 0 && d.inv_bin <= N) {
      spec_inv = d.inv_bin;
      bfi = 2;
    }
  }
  unsigned seed = 0;
  for (int i = 0; i < spec_inv; ++i)
    seed += static_cast<unsigned>(iabs(x[i])) * static_cast<unsigned>(i);
  int nf_seed = static_cast<int>(seed & 65535u);
  if (nf_seed >= 32768) nf_seed -= 65536;
  int zero_frame = (lastnz == 2 && x[0] == 0 && x[1] == 0 && side[7] == 0 && side[8] == 7)
                       ? 1 : 0;
  if (bfi == 0 && d.ber > 0) bfi = 1;
  if constexpr (kPc == kPcDecode) {
    if (bfi == 2 || res_dead) {
      zero_frame = 0;
      n_res = 0;
    }
  }
  int b_left = d.b_left;
  // the never-converged fallback (ari_codec.c:1135-1143)
  if constexpr (kPc == kPcEncSim) b_left = d.b_left > g.numbytes ? d.bp_side - d.pcb : d.b_left;
  out[OUT_NF_SEED * stride] = nf_seed;
  out[OUT_ZERO_FRAME * stride] = zero_frame;
  out[OUT_N_RES * stride] = n_res;
  out[OUT_RES_PRESENT * stride] = lsb_mode == 0 ? 1 : 0;
  out[OUT_BFI * stride] = bfi;
  out[OUT_SPEC_INV * stride] = spec_inv;
  out[OUT_B_LEFT * stride] = b_left;
}

}  // namespace acx
