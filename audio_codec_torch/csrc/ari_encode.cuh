// The range encoder of one frame (ari_encode.cu, K10): the sequential lane
// (ari_encode_lane, processAriEncoder_fl as one thread runs it) and the warp
// design (ari_encode_warp) that runs a stream on 32 lanes.
//
// The plain version is ops/ari.py:encode_plain. The range coder's state
// (low, range, cache, carry, carry_count and the forward byte pointer) is a
// chain over the symbol list; everything else is not. The tuple context is a
// window of two tuples (bit_estimate.cuh: c[k] = 16 (tn[k-2] & 15) +
// tn[k-1]), so each tuple's symbols follow from the tuple and its two
// predecessors; how many side bits and LSB-list entries a tuple writes
// depends on the tuple alone, so exclusive warp scans of those counts place
// every tuple's side bits (counted back from the frame's bp_side/mask_side)
// and LSB entries.
//
// ari_encode_warp, a stream a warp:
//   TNS phase   lanes 0..17 each take one of the (cum, freq) pairs of the
//               TNS orders and coefficients; a ballot compacts them into the
//               warp's symbol list; lane 0 codes them.
//   tuples      chunks of 32 tuples, a tuple a lane. Each lane computes its
//               context (from tn of the two tuples before it: shuffles, and
//               the chunk before's last two), its escape symbols and final
//               symbol, its side-bit count (2 a level, level 0's only
//               without lsb_mode, then the signs) and LSB count; one
//               inclusive scan of the three counts packed into a word gives
//               each lane's offsets; the lanes write their symbols into the
//               list, lane 0 codes the list (enc_symbol, the sequential
//               arithmetic), then the lanes write their side bits and LSB
//               entries.
//   check       the order test below; where it fails, the stream is coded
//               again from buf_in by ari_encode_lane on lane 0 (the lane-0
//               path; the kernel counts such streams).
//   residual    nbits_side, nbits_ari and n_fill from the state after the
//               tuples (ari_codec.c:826-860); the lanes write the residual or
//               LSB bits at their positions; lane 0 runs enc_finalize, whose
//               read-modify-write of the last byte comes after every side bit.
//
// The order test. The sequential lane interleaves the forward bytes of
// enc_shift (whole-byte stores at increasing positions, clipped to the
// frame) with the side bits of enc_side_bit (read-modify-writes of one bit
// each, at decreasing bit positions Q = 8 byte - bit, clipped to the frame);
// the warp writes a chunk's forward bytes, then its side bits. Let F be the
// bytes written forward up to the end of the tuples and S the bytes the
// tuples' side bits touch. Every forward write lies below the forward
// pointer bp_end at the end of the tuples (each write at p moves the pointer
// past p), and the side bits of the tuples touch the bytes from the byte of
// the last one, low = (Q_last + 7) >> 3, up to bp_side. If the side bits
// start inside the frame (0 <= bp_side < nbytes, mask_side a power of two up
// to 128), Q_last >= -7 (no side bit clipped to byte 0) and bp_end <= low,
// then F and S are disjoint and no write is clipped: a forward store and a
// side bit then touch different bytes and commute, the forward stores keep
// their order (lane 0), and the side bits write distinct bits (distinct Q),
// so any interleaving of the two sequences leaves the bytes the sequential
// one leaves, and the coder's state (which no side bit reads) is the same.
// The TNS phase comes before every side bit and the residual phase after
// every tuple in both orders. The residual bits never reach below byte bp
// (n_fill <= nbits_res = Q_T + 16 - nbits_ari and nbits_ari >= 8 bp + 10,
// Q_T the position after the tuples), so they are never clipped and touch
// only bytes that enc_finalize writes after them in both orders. Where the
// test fails (a spectrum over its bit budget, which the rate loop does not
// make), the forward bytes may have overtaken the side bits and the
// sequential lane decides. The LSB list holds N entries; the sequential
// lane writes entries past N - 1 to N - 1, where the last one stays: the
// warp writes there only a chunk's last entry, chunk after chunk.
#pragma once

#include "bit_estimate.cuh"

namespace acx {

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

constexpr int kAriTnsSyms = 18;                 // 2 filters x (order + 8 coefficients)
constexpr int kAriSymCap = kCoderLanes * 22;    // a chunk: 32 tuples x (21 escapes + 1)
constexpr int kAriLsbWords = 32;                // the LSB list, N <= 1024

// a symbol of the warp's list: cum in the low half, freq in the high
ACX_HD uint32_t ari_sym(int cum, int freq) {
  return static_cast<uint32_t>(cum & 0xFFFF) | (static_cast<uint32_t>(freq & 0xFFFF) << 16);
}

// lane 0 codes n symbols of the list
ACX_HD void ari_code_list(Enc& e, const uint32_t* syms, int n) {
  for (int i = 0; i < n; ++i) {
    enc_symbol(e, static_cast<int>(syms[i] >> 16), static_cast<int>(syms[i] & 0xFFFFu));
  }
}

// the side bit at position Q (byte (Q + 7) >> 3, bit 8 byte - Q), set to
// bit != 0; frame: the frame's bytes as words. The byte is clipped to the
// frame as enc_side_bit clips it (which happens only on a stream that then
// takes the lane-0 path).
template <class W>
ACX_HD void ari_put_side(const W& w, uint32_t* frame, int nbytes, int Q, int bit) {
  const int byte = (Q + 7) >> 3;
  const int pos = 8 * byte - Q;
  const int at = iclamp(byte, 0, nbytes - 1);
  w.put_bit(frame + (at >> 2), 8 * (at & 3) + pos, bit != 0);
}

// One stream on a warp. frame: its nbytes bytes (side info packed, as buf_in
// holds them), as words, coded in place; buf_in: the same bytes as int32,
// read again on the lane-0 path. side, tns_order, tns_idx, res as for
// ari_encode_lane. syms: kAriSymCap words; lsb_words: kAriLsbWords words.
// Returns 0 where the warp coded the stream, 1 where lane 0 did.
template <class W>
ACX_HD int ari_encode_warp(const W& w, uint32_t* frame, const int32_t* buf_in, int nbytes,
                           const int32_t* xq, int N, const int32_t* side,
                           const int32_t* tns_order, const int32_t* tns_idx, const int32_t* res,
                           int res_width, const AriTables& tb, int max_lev, int rate_flag,
                           int lpcw, int total_bits, uint32_t* syms, uint32_t* lsb_words) {
  using IL = typename W::template Lanes<int>;
  using UL = typename W::template Lanes<unsigned>;
  uint8_t* buf = reinterpret_cast<uint8_t*>(frame);
  const int bp0 = side[0], mask0 = side[1], num_tns = side[2], lastnz = side[3];
  const int lsb_mode = side[4], n_res = side[5];
  const bool save = lsb_mode == 1;
  const int NT = N / 2;
  bool ok = mask0 >= 1 && mask0 <= 128 && (mask0 & (mask0 - 1)) == 0 && bp0 >= 0 && bp0 < nbytes;
  if (ok) {
    const int Q0 = 8 * bp0 - msb32(mask0);
    Enc e;
    e.buf = buf;
    e.nbytes = nbytes;
    e.bp = 0;
    e.low = 0;
    e.range = MASK24;
    e.cache = -1;
    e.carry = 0;
    e.cc = 0;
    e.bp_side = bp0;
    e.mask_side = mask0;

    // TNS orders and coefficients: symbol i = 9 f + j, j = 0 the order
    IL t_on;
    UL t_sym;
    w.lanes([&](int l) {
      const int f = l / 9, j = l % 9;
      const int order = l < kAriTnsSyms ? tns_order[f] : 0;
      t_on[l] = l < kAriTnsSyms && f < num_tns && order > 0 && (j == 0 || j - 1 < order);
      t_sym[l] = 0u;
      if (t_on[l] && j == 0) {
        const int o = iclamp(order, 1, 8);
        const int cf = tb.tns_freq_cf[lpcw * 9 + o - 1];
        t_sym[l] = ari_sym(cf, tb.tns_freq_cf[lpcw * 9 + o] - cf);
      } else if (t_on[l]) {
        const int idx = tns_idx[f * 8 + j - 1];
        const int c0 = tb.tns_cf[(j - 1) * 18 + iclamp(idx, 0, 17)];
        t_sym[l] = ari_sym(c0, tb.tns_cf[(j - 1) * 18 + iclamp(idx + 1, 0, 17)] - c0);
      }
    });
    const unsigned t_mask = w.ballot(t_on);
    w.lanes([&](int l) {
      if (t_on[l]) syms[popc32(t_mask & ((1u << l) - 1u))] = t_sym[l];
    });
    w.sync();
    w.leader([&]() { ari_code_list(e, syms, popc32(t_mask)); });
    w.sync();

    // spectral 2-tuples, 32 a chunk
    const int n_tup = iclamp((lastnz + 1) / 2, 0, NT);
    int n_side = 0, n_lsb = 0;    // side bits and LSB entries so far
    int tn_b1 = 0, tn_b2 = 0;     // tn of the two tuples before the chunk
    w.lanes([&](int l) { lsb_words[l] = 0u; });   // kAriLsbWords == kCoderLanes
    w.sync();
    for (int base = 0; base < n_tup; base += kCoderLanes) {
      IL tn;
      w.lanes([&](int l) {
        const int k = base + l;
        tn[l] = 0;
        if (k < n_tup) {
          const int a = iabs(xq[2 * k]), b = iabs(xq[2 * k + 1]);
          const int nlev = escape_count(a, b);
          tn[l] = tuple_tn(nlev, a >> nlev, b >> nlev);
        }
      });
      const IL p1 = w.shfl_up(tn, 1), p2 = w.shfl_up(tn, 2);
      IL ctx;
      UL cnt;
      w.lanes([&](int l) {
        const int k = base + l;
        cnt[l] = 0u;
        ctx[l] = 0;
        if (k < n_tup) {
          const int a = iabs(xq[2 * k]), b = iabs(xq[2 * k + 1]);
          const int nlev = escape_count(a, b), nl = imin(nlev, max_lev);
          const int prev1 = l >= 1 ? p1[l] : tn_b1;
          const int prev2 = l >= 2 ? p2[l] : (l == 1 ? tn_b1 : tn_b2);
          ctx[l] = tuple_context(prev2, prev1) + rate_flag + (k > N / 4 ? 256 : 0);
          const bool shifted = save && nlev > 0;
          const int a1 = a >> 1, b1 = b >> 1;
          const int n_sides = 2 * nl - (save && nl > 0 ? 2 : 0) +
                              ((shifted ? a1 : a) != 0) + ((shifted ? b1 : b) != 0);
          const int n_lsbs = shifted ? 2 + (a1 == 0 && a != 0) + (b1 == 0 && b != 0) : 0;
          cnt[l] = static_cast<unsigned>(nl + 1) | (static_cast<unsigned>(n_sides) << 10) |
                   (static_cast<unsigned>(n_lsbs) << 21);
        }
      });
      const UL upto = warp_scan_incl(w, cnt);
      const unsigned total = w.shfl(upto, kCoderLanes - 1);
      const int c_syms = static_cast<int>(total & 1023u);
      const int c_side = static_cast<int>((total >> 10) & 2047u);
      const int c_lsb = static_cast<int>(total >> 21);
      w.lanes([&](int l) {
        const int k = base + l;
        if (k >= n_tup) return;
        const unsigned before = upto[l] - cnt[l];
        uint32_t* out = syms + (before & 1023u);
        const int a = iabs(xq[2 * k]), b = iabs(xq[2 * k + 1]);
        const int nlev = escape_count(a, b), nl = imin(nlev, max_lev);
        const int t = ctx[l];
        for (int lev = 0; lev < nl; ++lev) {
          const int* row = tb.cumf + tb.lookup[iclamp(t + imin(lev, 3) * 1024, 0, 4095)] * 18;
          out[lev] = ari_sym(row[16], row[17] - row[16]);
        }
        const int* row = tb.cumf + tb.lookup[iclamp(t + imin(nlev, 3) * 1024, 0, 4095)] * 18;
        const int s = iclamp((a >> nlev) + 4 * (b >> nlev), 0, 16);
        out[nl] = ari_sym(row[s], row[s + 1] - row[s]);
      });
      w.sync();
      w.leader([&]() { ari_code_list(e, syms, c_syms); });
      w.sync();
      w.lanes([&](int l) {
        const int k = base + l;
        if (k >= n_tup) return;
        const unsigned before = upto[l] - cnt[l];
        const int xa = xq[2 * k], xb = xq[2 * k + 1];
        const int a = iabs(xa), b = iabs(xb);
        const int nlev = escape_count(a, b), nl = imin(nlev, max_lev);
        int Q = Q0 - n_side - static_cast<int>((before >> 10) & 2047u);
        for (int lev = save ? 1 : 0; lev < nl; ++lev) {
          ari_put_side(w, frame, nbytes, Q--, (a >> lev) & 1);
          ari_put_side(w, frame, nbytes, Q--, (b >> lev) & 1);
        }
        const bool shifted = save && nlev > 0;
        const int a1 = a >> 1, b1 = b >> 1;
        if ((shifted ? a1 : a) != 0) ari_put_side(w, frame, nbytes, Q--, xa < 0);
        if ((shifted ? b1 : b) != 0) ari_put_side(w, frame, nbytes, Q--, xb < 0);
        if (shifted) {
          const int end = n_lsb + c_lsb;   // entries after this chunk
          int P = n_lsb + static_cast<int>(before >> 21);
          const int v[4] = {a & 1, xa < 0, b & 1, xb < 0};
          const bool on[4] = {true, a1 == 0 && a != 0, true, b1 == 0 && b != 0};
          for (int i = 0; i < 4; ++i) {
            if (!on[i]) continue;
            const int at = P < N - 1 ? P : (P == end - 1 ? N - 1 : -1);
            if (at >= 0) w.put_bit(lsb_words + (at >> 5), at & 31, v[i]);
            ++P;
          }
        }
      });
      n_side += c_side;
      n_lsb += c_lsb;
      tn_b1 = w.shfl(tn, kCoderLanes - 1);
      tn_b2 = w.shfl(tn, kCoderLanes - 2);
      w.sync();
    }

    // the order test (see the head of this file)
    const int bp_end = w.uniform(e.bp);
    if (n_side > 0) {
      const int q_last = Q0 - (n_side - 1);
      ok = q_last >= -7 && bp_end <= ((q_last + 7) >> 3);
    }
    if (ok) {
      // residual or LSB bits (ari_codec.c:826-860)
      const int QT = Q0 - n_side;
      const int bp_side = (QT + 7) >> 3, mask_side = 1 << (8 * bp_side - QT);
      const int nbits_side = total_bits - (8 * (bp_side + 1) + 8 - msb32(mask_side));
      const int nbits_ari = w.uniform((e.bp + 1) * 8 + 25 - msb32(imax(e.range, 1)) +
                                      (e.cache >= 0 ? 8 : 0) + e.cc * 8);
      const int nbits_res = imax(total_bits - (nbits_side + nbits_ari), 0);
      const int n_fill = imin(nbits_res, lsb_mode == 0 ? n_res : n_lsb);
      const int n_put = imax(imin(n_fill, imin(imax(res_width, N), total_bits)), 0);
      w.lanes([&](int l) {
        for (int k = l; k < n_put; k += kCoderLanes) {
          int bit;
          if (lsb_mode == 0) bit = k < res_width ? res[k] : 0;
          else bit = k < N ? static_cast<int>((lsb_words[k >> 5] >> (k & 31)) & 1u) : 0;
          ari_put_side(w, frame, nbytes, QT - k, bit);
        }
      });
      w.sync();
      w.leader([&]() {
        const int QE = QT - n_put;
        e.bp_side = (QE + 7) >> 3;
        e.mask_side = 1 << (8 * e.bp_side - QE);
        enc_finalize(e);
      });
      w.sync();
      return 0;
    }
  }

  // the lane-0 path: the sequential lane from the frame as it came
  w.sync();
  w.lanes([&](int l) {
    for (int i = l; i < nbytes; i += kCoderLanes) buf[i] = static_cast<uint8_t>(buf_in[i]);
  });
  w.sync();
  w.leader([&]() {
    ari_encode_lane(buf, nbytes, xq, N, side, tns_order, tns_idx, res, res_width, tb, max_lev,
                    rate_flag, lpcw, total_bits, lsb_words);
  });
  w.sync();
  return 1;
}

}  // namespace acx
