// The range decoder: the steps of csrc/ari_decode.cu.
//
// processAriDecoder_fl (ari_codec.c) as audio_codec_tpu/ops/ari.py:decode
// (ari.py:491) computes it, with dec_init (:419) and ac_decode (:455): the
// TNS orders and coefficients, the spectral 2-tuples with escapes and the
// bit-error checks (ari.py:579-651), the residual bits (:657-692), the LSB
// refinement (:694-728), nf_seed and zero_frame (:743-751).
//
// The side information comes one of two ways, a template parameter of the
// warp, one per launch: read (side [9, L], fields a caller made) or parsed
// (processDecoderEntropy_fl, audio_codec_tpu/ops/bits.py:parse_side_info
// :123, first: each lane runs side_info_parse_bits on its frame's row that
// the warp staged, and writes the side dict's 21 words a frame beside the
// decoder's rows).
//
// A frame is decoded by one thread, a template on the partial-concealment
// mode, chosen once per launch: kPcNone
// (no PC block, n_pc == 0), kPcDecode (the frame carries a relocated PC
// block: _pc_check :379 before every forward byte and every fresh backward
// byte, the PC branch of dec_init :419, the consumed-bits rule :661-668, the
// bfi 2 conversion with spec_inv_idx :732-752) and kPcEncSim (the encoder's
// simulation on the logical stream, which stops at the pointers' convergence
// and returns b_left, :759-765). Every hook is `if constexpr`.
//
// The coder state is a chain: each symbol needs low and range after the one
// before, and its table row the context of the two tuples before. So a
// frame's chain stays on its lanes, and the rest comes off it:
// - the frame's decoded rows (x, the escape flags that the LSB pass reads,
//   the residual bits, the TNS orders and indices) stay in the warp's shared
//   memory (DecRows) until the warp writes them out whole, coalesced, with
//   the zeros past each frame's last decoded tuple and residual bit
//   (ari_decode_warp): nothing of a row is zero-filled or read back from
//   device memory;
// - the nonzero count and the noise-filling seed (integer sums, the seed
//   modulo 2^32, so their order is free) are summed as the tuples are
//   decoded, the seed corrected by the LSB pass's changes; only a bfi 2
//   frame of kPcDecode, whose seed stops at spec_inv_idx, sums its row again;
// - without a PC block the next forward byte and the next two side bytes
//   wait in registers, loaded ahead of their use;
// - the symbol is the number of j < n with tmp * row[j] <= low (less one),
//   that is with row[j] <= floor(low / tmp): for the spectral rows the
//   kernel reads it, one byte of an inverse table at that quotient, and
//   counts the TNS rows' 8 or 17 entries (dec_count).
// tools/torch_coder_times.py --decode-variants builds the other designs it
// was compared with from this text (the count on every row, a binary search,
// groups of lanes a frame, other blocks and table placements).
// Every buffer index is clipped: the PC pointers jump (bp -> 0, bp_side ->
// pc_bytes - 1).
#pragma once

#include "acodec.cuh"
#include "plc.cuh"
#include "side_info.cuh"
#include "warp.cuh"

namespace acx {

enum PcMode { kPcNone = 0, kPcDecode = 1, kPcEncSim = 2 };

struct DecTables {
  const int32_t* lookup;     // [4096]
  const int32_t* cumf;       // [64, 18]
  const int32_t* order_cf;   // [2, 9]
  const int32_t* coef_cf;    // [8, 18]
  const uint8_t* inv;        // [64, kDecInvQ], the inverse of the cumf rows
};

// The inverse of the spectral rows: inv[r][q] is the number of j < 17 with
// cumf[r][j] <= q, for q < kDecInvQ; every cumf[r][j], j < 17, is below
// kDecInvQ, so the count at any larger q is the one at kDecInvQ - 1
// (kernels.py:_decoder_tables builds it, tests/test_torch_decode_rehearsal.py
// holds the premise).
constexpr int kDecInvQ = 1024;

struct Dec {
  const uint8_t* buf;
  int nbytes, bp, low, range, ber, bp_side, mask_side;
  // without a PC block: the bytes at bp (loaded a symbol ahead), at bp_side
  // and at bp_side - 1 (loaded eight side bits ahead)
  int nb, sb, sb2;
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

// The number of j < kSym with tmp * row[j] <= low (a sum: its order is free).
template <int kSym>
ACX_HD int dec_count(const int32_t* row, int tmp, int low) {
  int cnt = 0;
  for (int j = 0; j < kSym; ++j) cnt += tmp * row[j] <= low ? 1 : 0;
  return cnt;
}

// min(floor(low / tmp), kDecInvQ - 1) for 0 <= low < 2^24 and 1 <= tmp <
// 2^14: the float quotient (a reciprocal within an ulp, a rounded product) is
// within a relative 2.5e-7 of low / tmp, so below kDecInvQ + 1 its
// truncation is the floor or one off it, and one exact integer test each way
// corrects it; above, both stay at the clip.
ACX_HD int dec_quotient(int low, int tmp) {
#ifdef __CUDA_ARCH__
  float r;   // the reciprocal within an ulp (PTX rcp.approx), enough for the bound
  asm("rcp.approx.ftz.f32 %0, %1;" : "=f"(r) : "f"(__int2float_rn(tmp)));
  int q = imin(__float2int_rz(__fmul_rn(__int2float_rn(low), r)), kDecInvQ - 1);
#else
  const float qf = static_cast<float>(low) * (1.0f / static_cast<float>(tmp));
  int q = imin(static_cast<int>(qf), kDecInvQ - 1);
#endif
  if (tmp * q > low) q -= 1;
  else if (q < kDecInvQ - 1 && tmp * (q + 1) <= low) q += 1;
  return q;
}

// ac_decode_fl (ari_codec.c:115-146) over a row of kSym + 1 cumulative
// frequencies; *stop is set where the PC hook suppressed a byte read. The
// symbol is val = clamp(cnt - 1, 0, kSym - 1), cnt the number of j < kSym
// with tmp * row[j] <= low, that is with row[j] <= floor(low / tmp): with
// kInv (the spectral rows) one byte of the inverse table inv at that
// quotient instead of kSym products and compares, else dec_count. Where
// there is no PC block the renormalisation takes the byte loaded a symbol
// ahead (d.nb).
template <int kPc, int kSym, bool kInv>
ACX_HD int dec_symbol(Dec& d, const int32_t* row, const uint8_t* inv, int cur_bin, bool* stop) {
  const int tmp = d.range >> 10;
  if (d.low >= (tmp << 10)) d.ber = 1;
  const int low = d.low;
  int cnt;
  if constexpr (kInv) {
    // tmp is 0 or low negative only on a corrupt frame: every entry, or none
    const int q = dec_quotient(imax(low, 0), imax(tmp, 1));
    cnt = low < 0 ? 0 : tmp == 0 ? kSym : static_cast<int>(inv[q]);
  } else {
    cnt = dec_count<kSym>(row, tmp, low);
  }
  const int val = iclamp(cnt - 1, 0, kSym - 1);
  const int cf = row[val];
  d.low -= tmp * cf;
  d.range = tmp * (row[val + 1] - cf);
  *stop = false;
  if constexpr (kPc == kPcNone) {
    // the first renormalisation selected, not branched; a second is rare
    const bool shift = d.range < (1 << 16);
    d.low = shift ? shl8_24(d.low) + d.nb : d.low;
    d.bp += shift ? 1 : 0;
    d.range = shift ? d.range << 8 : d.range;
    if (d.range < (1 << 16)) {
      d.low = shl8_24(d.low) + dec_byte(d, d.bp);
      d.bp += 1;
      d.range <<= 8;
    }
    d.nb = dec_byte(d, d.bp);
  } else {
    for (int i = 0; i < 2; ++i) {
      if (d.range < (1 << 16)) {
        if (pc_check<kPc>(d, cur_bin, true, true)) {
          *stop = true;
          break;
        }
        d.low = shl8_24(d.low) + dec_byte(d, d.bp);
        d.bp += 1;
        d.range <<= 8;
      }
    }
  }
  return val;
}

// one backward bit; *trig is set (and nothing read) where the PC hook stops
template <int kPc>
ACX_HD int dec_side_bit(Dec& d, int cur_bin, bool* trig) {
  *trig = false;
  if constexpr (kPc == kPcNone) {
    // the bytes come from registers; the one after next is loaded on a move
    const int bit = (d.sb & d.mask_side) != 0 ? 1 : 0;
    if (d.mask_side == 128) {
      d.bp_side -= 1;
      d.mask_side = 1;
      d.sb = d.sb2;
      d.sb2 = dec_byte(d, d.bp_side - 1);
    } else {
      d.mask_side *= 2;
    }
    return bit;
  }
  if (pc_check<kPc>(d, cur_bin, true, false)) {
    *trig = true;
    return 0;
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

// Without a PC block: one backward bit where rd, else none (and 0), every
// step selected, not branched (the byte after next is loaded either way,
// its index clipped).
ACX_HD int dec_side_bit_where(Dec& d, bool rd) {
  const int bit = rd && (d.sb & d.mask_side) != 0 ? 1 : 0;
  const bool move = rd && d.mask_side == 128;
  const int after = dec_byte(d, d.bp_side - 2);
  d.bp_side -= move ? 1 : 0;
  d.mask_side = move ? 1 : rd ? d.mask_side * 2 : d.mask_side;
  d.sb = move ? d.sb2 : d.sb;
  d.sb2 = move ? after : d.sb2;
  return bit;
}

// Scalar outputs of a frame, in this order.
enum DecOut { OUT_NF_SEED, OUT_ZERO_FRAME, OUT_N_RES, OUT_RES_PRESENT, OUT_BFI,
              OUT_SPEC_INV, OUT_B_LEFT, N_DEC_OUT };

// The configuration of a launch.
struct DecGeom {
  int N, max_lev, hrmode, tns_max, lpcw, rate_flag, total_bits, max_res, res_iters;
  int pc_bytes, numbytes;   // of the PC block (kPcDecode, kPcEncSim)
};

// Where a frame's decoded rows stay until the warp writes them out: entry i
// at [i * stride] of each array (on the card shared memory, the frames of a
// warp side by side, stride the frames a warp plus one).
template <typename XT>
struct DecRows {
  XT* x;          // x [N], valid below len[0]; XT is int16_t where no value can
                  // pass 2^15 - 1 (every mode but the high-resolution one:
                  // at most 13 escape levels, |x| <= 4 * 2^13 - 1 with the
                  // LSB), else int32_t
  uint32_t* lev;  // bit k % 32 of word k / 32: tuple k had an escape (levs > 0)
  uint32_t* res;  // residual bit k in word k / 32, valid below len[stride]
  int32_t* tns;   // tns_order [2], then tns_idx [2][8]
  int32_t* len;   // the decoded length of x, then of the residual bits
  int stride;
};

// frame q's rows
template <typename XT>
ACX_HD DecRows<XT> dec_rows_at(const DecRows<XT>& r, int q) {
  return {r.x + q, r.lev + q, r.res + q, r.tns + q, r.len + q, r.stride};
}

// Words of a frame's shared rows for N coefficients and max_res residual
// bits, x as XT; tns and the two lengths 20 words.
ACX_HD int dec_lev_words(int N) { return (N / 2 + 31) / 32; }
ACX_HD int dec_res_words(int max_res) { return (max_res + 31) / 32; }

// The side fields a frame's decode reads, and the cursor of its side bits.
struct DecSide {
  int lastnz, lsb_mode, num_tns, tns_on[2], bp_side, mask_side, gg_idx, fac_ns_idx;
};

// One frame. bfi_in, be_l, be_r: the channel's bfi and corrupt bit range
// (kPcDecode). Writes the frame's rows r and out[j * out_stride].
template <int kPc, typename XT>
ACX_HD void ari_decode_frame(const uint8_t* buf, int nbytes, const DecSide& side,
                             const DecTables& tb, const DecGeom& g, int bfi_in, int be_l,
                             int be_r, const DecRows<XT>& r, int32_t* out, int out_stride) {
  const int N = g.N, S = r.stride;
  const int lastnz = side.lastnz, lsb_mode = side.lsb_mode, num_tns = side.num_tns;
  Dec d;
  d.buf = buf;
  d.nbytes = nbytes;
  d.range = MASK24;
  d.ber = 0;
  d.bp_side = side.bp_side;
  d.mask_side = side.mask_side;
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
    d.nb = dec_byte(d, 3);
    d.sb = dec_byte(d, d.bp_side);
    d.sb2 = dec_byte(d, d.bp_side - 1);
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
  for (int i = 0; i < 18; ++i) r.tns[i * S] = 0;

  // TNS (its rows have no inverse table)
  for (int f = 0; f < 2; ++f) {
    if (!(f < num_tns && side.tns_on[f] > 0 && bfi == 0)) continue;
    const int order = dec_symbol<kPc, 8, false>(d, tb.order_cf + g.lpcw * 9, nullptr, 0,
                                                 &stop) + 1;
    if (stop) bfi = 1;
    if (order > g.tns_max) bfi = 1;
    r.tns[f * S] = order;
    for (int k = 0; k < 8; ++k) {
      if (!(k < order && bfi == 0)) continue;
      if (d.bp_side < d.bp) bfi = 1;
      r.tns[(2 + f * 8 + k) * S] = dec_symbol<kPc, 17, false>(d, tb.coef_cf + k * 18, nullptr,
                                                              0, &stop);
      if (stop) bfi = 1;
    }
  }
  bfi |= d.ber;

  // spectral 2-tuples; the nonzero count and the seed as they come
  int c = 0, k_end = 0, nz = 0;
  unsigned seed = 0u;
  uint32_t lw = 0u;
  bool trig;
  for (int k = 0; k < N / 2; ++k) {
    if (!(2 * k < lastnz && bfi == 0)) break;
    const int t = c + g.rate_flag + (k > N / 4 ? 256 : 0);
    int ak = 0, bk = 0, lev_fin = 0, sym_fin = 0;
    bool done = false;
    for (int lev = 0; lev < g.max_lev && !done && bfi == 0; ++lev) {
      const int pki = tb.lookup[iclamp(t + imin(lev, 3) * 1024, 0, 4095)];
      const int sym = dec_symbol<kPc, 17, true>(d, tb.cumf + pki * 18, tb.inv + pki * kDecInvQ,
                                                2 * k, &stop);
      if (stop) {
        bfi = 1;
        break;
      }
      if constexpr (kPc == kPcNone) {
        // no hook can stop a read: the escape's two bits without a branch
        const bool esc = sym >= 16;
        const bool rd = esc && (lsb_mode == 0 || lev > 0);
        ak += dec_side_bit_where(d, rd) << lev;
        bk += dec_side_bit_where(d, rd) << lev;
        lev_fin = esc ? lev + 1 : lev;
        sym_fin = esc ? sym_fin : sym;
        done = !esc;
      } else if (sym >= 16) {
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
    if constexpr (kPc == kPcNone) {
      if (dec_side_bit_where(d, ak > 0 && bfi == 0)) ak = -ak;
      if (dec_side_bit_where(d, bk > 0 && bfi == 0)) bk = -bk;
    } else {
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
    }
    r.x[2 * k * S] = static_cast<XT>(ak);
    r.x[(2 * k + 1) * S] = static_cast<XT>(bk);
    nz += (ak != 0 ? 1 : 0) + (bk != 0 ? 1 : 0);
    seed += static_cast<unsigned>(iabs(ak)) * static_cast<unsigned>(2 * k) +
            static_cast<unsigned>(iabs(bk)) * static_cast<unsigned>(2 * k + 1);
    lw |= (lev_eff > 0 ? 1u : 0u) << (k & 31);
    if ((k & 31) == 31) {
      r.lev[(k >> 5) * S] = lw;
      lw = 0u;
    }
    k_end = k + 1;
    const int lev1 = imin(lev_eff, 3);
    c = (c & 15) * 16 + (lev1 <= 1 ? 1 + (a_fin + b_fin) * (lev1 + 1) : 12 + lev1);
    // with a PC block the pointers are compared only while both are on the
    // same side of it (ari_codec.c:750)
    if (d.bp - d.bp_side > 3 && (kPc == kPcNone || d.c_bp == d.c_bp_side)) bfi = 1;
    bfi |= d.ber;
  }
  if ((k_end & 31) != 0) r.lev[(k_end >> 5) * S] = lw;
  const int x_len = 2 * k_end;

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
  const int n_res0 = imin(nbits_residual, nz * g.res_iters);
  // a residual-phase read that enters the corrupt bytes ends the residual
  bool res_dead = false;
  int res_len = 0;
  if (lsb_mode == 0 && bfi == 0) {
    uint32_t rw = 0u;
    for (int k = 0; k < n_res0 && k < g.max_res; ++k) {
      const int bit = dec_side_bit<kPc>(d, d.inv_bin, &trig);
      if (trig) {
        res_dead = true;
        break;
      }
      rw |= static_cast<uint32_t>(bit) << (k & 31);
      if ((k & 31) == 31) {
        r.res[(k >> 5) * S] = rw;
        rw = 0u;
      }
      res_len = k + 1;
    }
    if ((res_len & 31) != 0) r.res[(res_len >> 5) * S] = rw;
  }

  // LSB refinement (ari_codec.c:476-556); the seed follows each change
  if (lsb_mode == 1 && bfi == 0) {
    int budget = nbits_residual;
    for (int k = 0; k < N / 2; ++k) {
      if (!(2 * k < lastnz && ((r.lev[(k >> 5) * S] >> (k & 31)) & 1u) != 0u)) continue;
      for (int j = 2 * k; j < 2 * k + 2; ++j) {
        if (budget <= 0 || res_dead) continue;
        const int xv = r.x[j * S];
        const int bit = dec_side_bit<kPc>(d, d.inv_bin, &trig);
        if (trig) {
          res_dead = true;
          continue;
        }
        budget -= 1;
        int xn = xv;
        if (bit == 1 && xv != 0) {
          xn = xv > 0 ? xv + 1 : xv - 1;
        } else if (bit == 1 && xv == 0 && budget > 0) {
          const int bit2 = dec_side_bit<kPc>(d, d.inv_bin, &trig);
          if (trig) {
            res_dead = true;
          } else {
            budget -= 1;
            xn = bit2 == 0 ? 1 : -1;
          }
        }
        if (xn != xv) {
          r.x[j * S] = static_cast<XT>(xn);
          seed += (static_cast<unsigned>(iabs(xn)) - static_cast<unsigned>(iabs(xv))) *
                  static_cast<unsigned>(j);
        }
      }
    }
  }

  int n_res = lsb_mode == 0 ? n_res0 : 0;
  int spec_inv = N;
  if constexpr (kPc == kPcDecode) {
    // ber_detect: an abort with a valid inv_bin is a partial loss
    // (ari_codec.c:1164-1187); its seed stops there
    if (bfi == 1 && d.inv_bin > 0 && d.inv_bin <= N) {
      spec_inv = d.inv_bin;
      bfi = 2;
      seed = 0u;
      for (int i = 0; i < imin(spec_inv, x_len); ++i)
        seed += static_cast<unsigned>(iabs(static_cast<int>(r.x[i * S]))) *
                static_cast<unsigned>(i);
    }
  }
  int nf_seed = static_cast<int>(seed & 65535u);
  if (nf_seed >= 32768) nf_seed -= 65536;
  const int x0 = x_len > 0 ? static_cast<int>(r.x[0]) : 0;
  const int x1 = x_len > 0 ? static_cast<int>(r.x[S]) : 0;
  int zero_frame =
      (lastnz == 2 && x0 == 0 && x1 == 0 && side.gg_idx == 0 && side.fac_ns_idx == 7) ? 1 : 0;
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
  r.len[0] = x_len;
  r.len[S] = res_len;
  out[OUT_NF_SEED * out_stride] = nf_seed;
  out[OUT_ZERO_FRAME * out_stride] = zero_frame;
  out[OUT_N_RES * out_stride] = n_res;
  out[OUT_RES_PRESENT * out_stride] = lsb_mode == 0 ? 1 : 0;
  out[OUT_BFI * out_stride] = bfi;
  out[OUT_SPEC_INV * out_stride] = spec_inv;
  out[OUT_B_LEFT * out_stride] = b_left;
}

// The device arrays of a launch over L frames: frames [L, nbytes] (a byte a
// word) in; x [L, N], tns_order [L, 2], tns_idx [L, 16], res [L, max_res],
// out [7, L] out. Read mode: side [9, L] (DecSide's fields in order) and
// pc_in [3, L] (bfi_in, be_l, be_r; null without a PC block) in. Parsed
// mode: side_out, the side dict's 21 words a frame (kSideScalars [9, L]
// field-major, then tns_on [L, 2], scf_idx [L, 7], ltpf_param [L, 3]) out;
// the PC inputs as the caller holds them (flags: bfi_in, be_l, be_r, each a
// vector of L values at its stride, or null for its default 0, -1, -1); lay,
// the configuration's side layout.
struct DecIo {
  const int32_t* frames;
  const int32_t* side;
  const int32_t* pc_in;
  int32_t* x;
  int32_t* tns_order;
  int32_t* tns_idx;
  int32_t* res;
  int32_t* out;
  int L, nbytes;
  int32_t* side_out;
  StreamVec flags[3];
  SideLayout lay;
};

// The parsed side dict's scalars, field-major: bfi, bw_idx, lastnz,
// lsb_mode, gg_idx, num_tns, fac_ns_idx, bp_side, mask_side
// (kernels.SIDE_SCALARS).
constexpr int kSideScalars = 9;
// its row-major words a frame: tns_on [2], scf_idx [7], ltpf_param [3]
constexpr int kSideRowWords = 12;
struct SideRow {
  int32_t v[kSideRowWords];
};

// Bytes of a warp's frame buffer: the frames' rows, and in parsed mode the
// side rows' words after the decode.
ACX_HD int dec_fbuf_bytes(int nbytes) {
  return imax(kCoderLanes * nbytes, kCoderLanes * kSideRowWords * 4);
}

// a per-frame PC input: the vector's value, or dflt where there is none
ACX_HD int dec_flag(const StreamVec& v, int s, int dflt) {
  return v.p == nullptr ? dflt : vec_int(v, s);
}

// Parsed mode, frame s on its lane: the side information of its row (the
// warp's staged bytes), the scalars out (coalesced across the warp), the
// row-major words kept for after the decode. Returns the fields the decode
// reads.
template <typename RowT>
ACX_HD DecSide dec_parse_side(const RowT* row, const DecIo& io, int s, SideRow& kept) {
  SideFields f;
  int bfi;
  const SideCursor c = side_info_parse_bits(row, io.lay, f, &bfi);
  const int v[kSideScalars] = {bfi,       f.bw_idx,     f.lastnz, f.lsb_mode, f.gg_idx,
                               f.num_tns, f.fac_ns_idx, c.bp,     c.mask};
#pragma unroll
  for (int k = 0; k < kSideScalars; ++k) io.side_out[static_cast<size_t>(k) * io.L + s] = v[k];
  kept.v[0] = f.tns_on[0];
  kept.v[1] = f.tns_on[1];
#pragma unroll
  for (int k = 0; k < 7; ++k) kept.v[2 + k] = f.scf_idx[k];
#pragma unroll
  for (int k = 0; k < 3; ++k) kept.v[9 + k] = f.ltpf[k];
  return {f.lastnz, f.lsb_mode, f.num_tns, {f.tns_on[0], f.tns_on[1]}, c.bp, c.mask, f.gg_idx,
          f.fac_ns_idx};
}

// Parsed mode, after the decode: the warp's kept side rows through its frame
// buffer (sh: tns_on [32, 2], scf_idx [32, 7], ltpf_param [32, 3], each in
// its output's order) and out, coalesced.
template <class W>
ACX_HD void dec_side_rows_out(const W& w, const DecIo& io, int s0, int nf,
                              const typename W::template Lanes<SideRow>& kept, int32_t* sh) {
  constexpr int kScf = 2 * kCoderLanes, kLtpf = 9 * kCoderLanes;
  w.lanes([&](int l) {
    if (l >= nf) return;
#pragma unroll
    for (int k = 0; k < 2; ++k) sh[l * 2 + k] = kept[l].v[k];
#pragma unroll
    for (int k = 0; k < 7; ++k) sh[kScf + l * 7 + k] = kept[l].v[2 + k];
#pragma unroll
    for (int k = 0; k < 3; ++k) sh[kLtpf + l * 3 + k] = kept[l].v[9 + k];
  });
  w.sync();
  const size_t L = io.L, s = s0;
  int32_t* tns_on = io.side_out + kSideScalars * L;
  int32_t* scf_idx = tns_on + 2 * L;
  int32_t* ltpf = scf_idx + 7 * L;
  w.lanes([&](int l) {
    for (int i = l; i < 2 * nf; i += kCoderLanes) tns_on[s * 2 + i] = sh[i];
    for (int i = l; i < 7 * nf; i += kCoderLanes) scf_idx[s * 7 + i] = sh[kScf + i];
    for (int i = l; i < 3 * nf; i += kCoderLanes) ltpf[s * 3 + i] = sh[kLtpf + i];
  });
}

// One warp's frames s0 .. s0 + nf - 1 (nf <= 32): their bytes staged in
// fbuf [dec_fbuf_bytes(nbytes)] with coalesced loads, frame q's side
// information read (kParse false) or parsed from its staged row (kParse) and
// the frame decoded by lane q into the rows (frame q at dec_rows_at(rows,
// q)), then every row written out by the whole warp, coalesced, zeros past
// each frame's decoded length, and in parsed mode the side rows.
template <int kPc, bool kParse = false, typename XT, class W>
ACX_HD void ari_decode_warp(const W& w, const DecIo& io, int s0, int nf, const DecTables& tb,
                            const DecGeom& g, uint8_t* fbuf, const DecRows<XT>& rows) {
  const int nbytes = io.nbytes, L = io.L, N = g.N, S = rows.stride;
  const int32_t* in = io.frames + static_cast<size_t>(s0) * nbytes;
  w.lanes([&](int l) {
    for (int i = l; i < nf * nbytes; i += kCoderLanes) fbuf[i] = static_cast<uint8_t>(in[i]);
  });
  w.sync();
  typename W::template Lanes<SideRow> kept;
  w.lanes([&](int q) {
    if (q >= nf) return;
    const int s = s0 + q;
    DecSide sd;
    if constexpr (kParse) {
      sd = dec_parse_side(fbuf + q * nbytes, io, s, kept[q]);
    } else {
      const int32_t* v = io.side + s;
      sd = {v[0], v[L], v[2 * L], {v[3 * L], v[4 * L]}, v[5 * L], v[6 * L], v[7 * L], v[8 * L]};
    }
    int bfi_in = 0, be_l = -1, be_r = -1;
    if constexpr (kPc != kPcNone) {
      if constexpr (kParse) {
        bfi_in = dec_flag(io.flags[0], s, 0);
        be_l = dec_flag(io.flags[1], s, -1);
        be_r = dec_flag(io.flags[2], s, -1);
      } else if (io.pc_in != nullptr) {
        bfi_in = io.pc_in[s];
        be_l = io.pc_in[L + s];
        be_r = io.pc_in[2 * L + s];
      }
    }
    ari_decode_frame<kPc>(fbuf + q * nbytes, nbytes, sd, tb, g, bfi_in, be_l, be_r,
                          dec_rows_at(rows, q), io.out + s, L);
  });
  w.sync();
  if constexpr (kParse) dec_side_rows_out(w, io, s0, nf, kept, reinterpret_cast<int32_t*>(fbuf));
  // the rows out: x and res a frame at a time, the TNS entries of all the
  // warp's frames at once
  for (int q = 0; q < nf; ++q) {
    const size_t s = static_cast<size_t>(s0 + q);
    const int x_len = rows.len[q], res_len = rows.len[S + q];
    w.lanes([&](int l) {
      for (int i = l; i < N; i += kCoderLanes)
        io.x[s * N + i] = i < x_len ? static_cast<int32_t>(rows.x[i * S + q]) : 0;
      for (int i = l; i < g.max_res; i += kCoderLanes)
        io.res[s * g.max_res + i] =
            i < res_len ? static_cast<int32_t>((rows.res[(i >> 5) * S + q] >> (i & 31)) & 1u) : 0;
    });
  }
  w.lanes([&](int l) {
    for (int i = l; i < 2 * nf; i += kCoderLanes)
      io.tns_order[static_cast<size_t>(s0) * 2 + i] = rows.tns[(i & 1) * S + (i >> 1)];
    for (int i = l; i < 16 * nf; i += kCoderLanes)
      io.tns_idx[static_cast<size_t>(s0) * 16 + i] = rows.tns[(2 + (i & 15)) * S + (i >> 4)];
  });
}

}  // namespace acx
