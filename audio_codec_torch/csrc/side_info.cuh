// The side information of an LC3plus frame, written and read backward from
// the frame's end, one stream per call (processEncoderEntropy_fl,
// enc_entropy.c:13-115; processDecoderEntropy_fl, dec_entropy.c:121-270).
//
// A row is `nbytes` int32 words, one byte in each; every byte index is
// clipped into the row, as the plain versions (ops/bits.py) clip it.
// side_info_pack.cu runs side_info_pack_warp, a warp a stream: the stream's
// side bits assembled in registers as a bit string (side_info_pack_bits, a
// lane function the range encoder can call on the fields it holds), then
// each byte of the row written once. side_info_pack_lane, the backward
// writer one read-modify-write a bit, stays as the order the CPU rehearsals
// hold the string to. The range decoder (ari_decode.cuh, its parsed mode)
// reads a stream's side information with side_info_parse_bits: the row's
// tail gathered once into the same string, each field one extract at its
// offset. side_info_parse_lane, the backward reader one bit a step, stays as
// the order the CPU rehearsals hold it to.
#pragma once

#include "acodec.cuh"
#include "warp.cuh"

namespace acx {

// Field widths that depend on the configuration and not on the stream.
struct SideLayout {
  int nbytes;       // words in a row
  int start;        // byte of the first side bit (targetBytes - 1)
  int bw_bits;      // BW_cutoff_bits, 0 where the bandwidth is not sent
  int lastnz_bits;  // width of the lastnz field
  int fs_idx;       // sampling-rate index: the bandwidth where none is sent
  int ylen;         // coded bins: a larger lastnz is a bad frame
  int one_tns;      // 1 for 2.5 ms frames: always one TNS filter
};

// What the encoder sends (pack) and the decoder reads back (parse).
struct SideFields {
  int bw_idx, lastnz, lsb_mode, gg_idx, num_tns;
  int tns_on[2];   // pack: the filters' orders (sent as order > 0)
  int ltpf[3];     // active, pitch present, pitch index
  int scf_idx[7];  // stage-1 indices, submode, gain, leading sign, MPVQ indices
  int fac_ns_idx;
};

// Sizes of the MPVQ index sets (without the leading sign)
constexpr int kMpvqSplit = 2390004;   // 10 pulses in 10 dims
constexpr int kMpvqNear = 15158272;   // 8 pulses in 16 dims
constexpr int kMpvqFar = 774912;      // 6 pulses in 16 dims

// Cursor of the backward bit stream: byte index and bit mask.
struct SideCursor {
  int bp, mask;
};

ACX_HD void side_step(SideCursor& c) {
  if (c.mask == 128) {
    c.bp -= 1;
    c.mask = 1;
  } else {
    c.mask <<= 1;
  }
}

ACX_HD void side_write_bit(int32_t* row, int nbytes, SideCursor& c, int bit) {
  const int at = iclamp(c.bp, 0, nbytes - 1);
  row[at] = bit == 0 ? (row[at] & (255 - c.mask)) : (row[at] | c.mask);
  side_step(c);
}

// nbits bits of val, least significant first
ACX_HD void side_write_uint(int32_t* row, int nbytes, SideCursor& c, int val, int nbits) {
  for (int k = 0; k < nbits; ++k) side_write_bit(row, nbytes, c, (val >> k) & 1);
}

ACX_HD int side_read_bit(const int32_t* row, int nbytes, SideCursor& c) {
  const int bit = (row[iclamp(c.bp, 0, nbytes - 1)] & c.mask) != 0 ? 1 : 0;
  side_step(c);
  return bit;
}

ACX_HD int side_read_uint(const int32_t* row, int nbytes, SideCursor& c, int nbits) {
  int val = 0;
  for (int k = 0; k < nbits; ++k) val += side_read_bit(row, nbytes, c) << k;
  return val;
}

// a * b + c in wrapping 32-bit arithmetic, as int32 tensors compute it
ACX_HD int side_mad(int a, int b, int c) {
  return static_cast<int>(static_cast<unsigned>(a) * static_cast<unsigned>(b) +
                          static_cast<unsigned>(c));
}

// Writes one stream's side information into its zeroed row; returns the
// cursor behind the last bit (bp_side, mask_side of the range encoder).
ACX_HD SideCursor side_info_pack_lane(int32_t* row, const SideLayout& L, const SideFields& s) {
  SideCursor c = {L.start, 1};
  const int n = L.nbytes;
  if (L.bw_bits > 0) side_write_uint(row, n, c, s.bw_idx, L.bw_bits);
  side_write_uint(row, n, c, (s.lastnz >> 1) - 1, L.lastnz_bits);
  side_write_bit(row, n, c, s.lsb_mode);
  side_write_uint(row, n, c, s.gg_idx, 8);
  if (s.num_tns > 0) side_write_bit(row, n, c, imin(s.tns_on[0], 1));
  if (s.num_tns > 1) side_write_bit(row, n, c, imin(s.tns_on[1], 1));
  side_write_bit(row, n, c, s.ltpf[0]);
  side_write_uint(row, n, c, s.scf_idx[0], 5);
  side_write_uint(row, n, c, s.scf_idx[1], 5);

  // SNS-VQ second stage (enc_entropy.c:60-92): the submode's high bit, the
  // gain's high bits, the leading sign, then one joint index of 25 or 24 bits
  const int submode = iclamp(s.scf_idx[2], 0, 3);
  const int submode_msb = s.scf_idx[2] >> 1;
  const int submode_lsb = s.scf_idx[2] & 1;
  const int gain_msb_bits = submode < 2 ? 1 : 2;
  const int gain_lsb_bits = submode & 1;
  const int gain_lsb = s.scf_idx[3] & 1;
  side_write_bit(row, n, c, submode_msb);
  side_write_uint(row, n, c, s.scf_idx[3] >> gain_lsb_bits, gain_msb_bits);
  side_write_bit(row, n, c, s.scf_idx[4]);
  if (submode_msb == 0) {
    const int hi = submode_lsb == 0 ? s.scf_idx[6] + 2 : gain_lsb;
    side_write_uint(row, n, c, side_mad(hi, kMpvqSplit, s.scf_idx[5]), 25);
  } else {
    const int v = submode_lsb != 0 ? side_mad(2, s.scf_idx[5], gain_lsb + kMpvqNear)
                                   : s.scf_idx[5];
    side_write_uint(row, n, c, v, 24);
  }

  if (s.ltpf[0] == 1) {
    side_write_uint(row, n, c, s.ltpf[1], 1);
    side_write_uint(row, n, c, s.ltpf[2], 9);
  }
  side_write_uint(row, n, c, s.fac_ns_idx, 3);
  return c;
}

// The side bits of a stream as a string: bit k is the k-th bit the backward
// writer writes, in word k / 32 at bit k % 32. At most 64 + bw_bits +
// lastnz_bits bits, 76 at every configuration (the entry point takes at most
// 96).
constexpr int kSideWords = 3;

struct SideBits {
  uint32_t w[kSideWords];
  int n;   // bits in the string
};

// The nbits (0..25) low bits of v appended at bit s.n, by shifts at known
// offsets: (v >> k) & 1 for k < nbits is bit s.n + k.
ACX_HD void side_put(SideBits& s, int v, int nbits) {
  const uint32_t field = static_cast<uint32_t>(v) & ((1u << nbits) - 1u);
  const int word = s.n >> 5;
  const uint64_t wide = static_cast<uint64_t>(field) << (s.n & 31);
  const uint32_t lo = static_cast<uint32_t>(wide), hi = static_cast<uint32_t>(wide >> 32);
#pragma unroll
  for (int k = 0; k < kSideWords; ++k) s.w[k] |= (k == word ? lo : 0u) | (k == word + 1 ? hi : 0u);
  s.n += nbits;
}

// One bit: set where the value is not zero (side_write_bit).
ACX_HD void side_put_bit(SideBits& s, int bit) { side_put(s, bit != 0 ? 1 : 0, 1); }

// One stream's side bits in side_info_pack_lane's order: the same fields,
// widths and branches.
ACX_HD SideBits side_info_pack_bits(const SideLayout& L, const SideFields& s) {
  SideBits b = {{0u, 0u, 0u}, 0};
  if (L.bw_bits > 0) side_put(b, s.bw_idx, L.bw_bits);
  side_put(b, (s.lastnz >> 1) - 1, L.lastnz_bits);
  side_put_bit(b, s.lsb_mode);
  side_put(b, s.gg_idx, 8);
  if (s.num_tns > 0) side_put_bit(b, imin(s.tns_on[0], 1));
  if (s.num_tns > 1) side_put_bit(b, imin(s.tns_on[1], 1));
  side_put_bit(b, s.ltpf[0]);
  side_put(b, s.scf_idx[0], 5);
  side_put(b, s.scf_idx[1], 5);

  const int submode = iclamp(s.scf_idx[2], 0, 3);
  const int submode_msb = s.scf_idx[2] >> 1;
  const int submode_lsb = s.scf_idx[2] & 1;
  const int gain_lsb_bits = submode & 1;
  const int gain_lsb = s.scf_idx[3] & 1;
  side_put_bit(b, submode_msb);
  side_put(b, s.scf_idx[3] >> gain_lsb_bits, submode < 2 ? 1 : 2);
  side_put_bit(b, s.scf_idx[4]);
  if (submode_msb == 0) {
    const int hi = submode_lsb == 0 ? s.scf_idx[6] + 2 : gain_lsb;
    side_put(b, side_mad(hi, kMpvqSplit, s.scf_idx[5]), 25);
  } else {
    side_put(b, submode_lsb != 0 ? side_mad(2, s.scf_idx[5], gain_lsb + kMpvqNear)
                                 : s.scf_idx[5], 24);
  }
  if (s.ltpf[0] == 1) {
    side_put(b, s.ltpf[1], 1);
    side_put(b, s.ltpf[2], 9);
  }
  side_put(b, s.fac_ns_idx, 3);
  return b;
}

// Byte j of the string (its bits 8j..8j+7), zero outside it.
ACX_HD uint32_t side_string_byte(const SideBits& b, int j) {
  uint32_t v = 0u;
#pragma unroll
  for (int k = 0; k < kSideWords; ++k) v |= (j >> 2) == k ? b.w[k] : 0u;
  return j >= 0 && j < 4 * kSideWords ? (v >> (8 * (j & 3))) & 255u : 0u;
}

// Byte t of the row: the string's byte start - t. Where the clipped indices
// put several string bytes on the row's first or last byte, the last write of
// each bit wins: the last of them, over the one before it where the last is
// partial. A byte no bit reaches is zero.
ACX_HD int side_row_byte(const SideBits& b, const SideLayout& L, int t) {
  const int jmax = (b.n - 1) >> 3;   // the string's last byte
  const int jhi = imin(t == 0 ? jmax : L.start - t, jmax);
  const int jlo = imax(t == L.nbytes - 1 ? 0 : L.start - t, 0);
  if (jhi < jlo) return 0;
  const int fresh = imin(b.n - 8 * jhi, 8);   // bits of byte jhi in the string
  const uint32_t under = jhi > jlo ? side_string_byte(b, jhi - 1) & (0xFFu << fresh) & 255u : 0u;
  return static_cast<int>(side_string_byte(b, jhi) | under);
}

// The cursor behind the string's last bit.
ACX_HD SideCursor side_string_cursor(const SideBits& b, const SideLayout& L) {
  return {L.start - (b.n >> 3), 1 << (b.n & 7)};
}

// One stream's side information on a warp: every lane builds the string,
// lane l writes bytes l, l + 32, ... of the row, each once, zeros included.
// Returns the cursor (the same on every lane).
template <class W>
ACX_HD SideCursor side_info_pack_warp(const W& w, const SideLayout& L, const SideFields& s,
                                      int32_t* row) {
  const SideBits b = side_info_pack_bits(L, s);
  w.lanes([&](int l) {
    for (int t = l; t < L.nbytes; t += kCoderLanes) row[t] = side_row_byte(b, L, t);
  });
  return side_string_cursor(b, L);
}

// Reads one stream's side information; *bfi is 1 where a field is out of
// range (dec_entropy.c:152-270). Returns the cursor behind the last bit.
ACX_HD SideCursor side_info_parse_lane(const int32_t* row, const SideLayout& L, SideFields& s,
                                       int* bfi) {
  SideCursor c = {L.start, 1};
  const int n = L.nbytes;
  *bfi = 0;
  if (L.bw_bits > 0) {
    s.bw_idx = side_read_uint(row, n, c, L.bw_bits);
    if (L.fs_idx < s.bw_idx) *bfi = 1;
  } else {
    s.bw_idx = L.fs_idx;
  }
  s.num_tns = (L.one_tns || s.bw_idx < 3) ? 1 : 2;
  s.lastnz = (side_read_uint(row, n, c, L.lastnz_bits) + 1) * 2;
  if (s.lastnz > L.ylen) *bfi = 1;
  s.lsb_mode = side_read_bit(row, n, c);
  s.gg_idx = side_read_uint(row, n, c, 8);
  s.tns_on[0] = side_read_bit(row, n, c);
  s.tns_on[1] = s.num_tns > 1 ? side_read_bit(row, n, c) : 0;
  s.ltpf[0] = side_read_bit(row, n, c);
  s.scf_idx[0] = side_read_uint(row, n, c, 5);
  s.scf_idx[1] = side_read_uint(row, n, c, 5);

  const int submode_msb = side_read_bit(row, n, c);
  int gain = side_read_uint(row, n, c, submode_msb == 0 ? 1 : 2);
  s.scf_idx[4] = side_read_bit(row, n, c);
  const int tmp = side_read_uint(row, n, c, submode_msb == 0 ? 25 : 24);
  int submode_lsb;
  if (submode_msb == 0) {
    // 14 sets of kMpvqSplit: the gain's low bit (2) or the tail's index (12)
    const int ind = tmp / kMpvqSplit;
    if (tmp >= 14 * kMpvqSplit) *bfi = 1;
    submode_lsb = ind < 2 ? 1 : 0;
    if (submode_lsb) gain = gain * 2 + ind;
    s.scf_idx[5] = tmp - ind * kMpvqSplit;
    s.scf_idx[6] = submode_lsb ? -2 : ind - 2;
  } else {
    if (tmp >= kMpvqNear + 2 * kMpvqFar) *bfi = 1;
    submode_lsb = tmp >= kMpvqNear ? 1 : 0;
    if (submode_lsb) gain = gain * 2 + ((tmp - kMpvqNear) & 1);
    s.scf_idx[5] = submode_lsb ? (tmp - kMpvqNear) >> 1 : tmp;
    s.scf_idx[6] = submode_lsb ? -2 : -1;
  }
  s.scf_idx[2] = submode_msb * 2 + submode_lsb;
  s.scf_idx[3] = gain;

  const bool ltpf_on = s.ltpf[0] == 1;
  s.ltpf[1] = ltpf_on ? side_read_uint(row, n, c, 1) : 0;
  s.ltpf[2] = ltpf_on ? side_read_uint(row, n, c, 9) : 0;
  s.fac_ns_idx = side_read_uint(row, n, c, 3);
  return c;
}

// The string a row holds from its byte start backward: byte j of the string
// is the row's byte clamp(start - j, 0, nbytes - 1), the low 8 bits of the
// element (all that side_read_bit's masks see), for j < 4 * kSideWords; the
// side information's at most 76 bits are its first. RowT is int32_t for rows
// in device memory (a byte a word), uint8_t for rows staged in shared memory.
template <typename RowT>
ACX_HD SideBits side_string_of_row(const RowT* row, const SideLayout& L) {
  SideBits b = {{0u, 0u, 0u}, 0};
#pragma unroll
  for (int j = 0; j < 4 * kSideWords; ++j) {
    const uint32_t byte = static_cast<uint32_t>(row[iclamp(L.start - j, 0, L.nbytes - 1)]) & 255u;
#pragma unroll
    for (int k = 0; k < kSideWords; ++k) b.w[k] |= (j >> 2) == k ? byte << (8 * (j & 3)) : 0u;
  }
  return b;
}

// Bits p .. p + nbits - 1 (nbits 1..25) of the string, bit p the lowest: the
// value side_read_uint reads after p bits. The two words are picked by
// selects over static indices (a register array indexed at run time would
// go to local memory).
ACX_HD int side_field(const SideBits& b, int p, int nbits) {
  const int word = p >> 5;
  uint32_t lo = 0u, hi = 0u;
#pragma unroll
  for (int k = 0; k < kSideWords; ++k) {
    lo |= k == word ? b.w[k] : 0u;
    hi |= k == word + 1 ? b.w[k] : 0u;
  }
  const uint64_t wide = (static_cast<uint64_t>(hi) << 32 | lo) >> (p & 31);
  return static_cast<int>(static_cast<uint32_t>(wide) & ((1u << nbits) - 1u));
}

// Reads one stream's side information in side_info_parse_lane's order, with
// its checks, from the string of its row: each field one extract at its
// offset; only the offsets after the TNS count (from bw_idx), the submode's
// high bit and the LTPF flag depend on the stream, and the fields those
// choose are selected, not branched. Returns the cursor behind the last bit
// (side_string_cursor, the bit reader's: its byte index is not clipped).
template <typename RowT>
ACX_HD SideCursor side_info_parse_bits(const RowT* row, const SideLayout& L, SideFields& s,
                                       int* bfi) {
  SideBits b = side_string_of_row(row, L);
  int p = 0;
  const auto take = [&](int nbits) {
    const int v = side_field(b, p, nbits);
    p += nbits;
    return v;
  };
  *bfi = 0;
  s.bw_idx = L.fs_idx;
  if (L.bw_bits > 0) {
    s.bw_idx = take(L.bw_bits);
    if (L.fs_idx < s.bw_idx) *bfi = 1;
  }
  s.num_tns = (L.one_tns || s.bw_idx < 3) ? 1 : 2;
  s.lastnz = (take(L.lastnz_bits) + 1) * 2;
  if (s.lastnz > L.ylen) *bfi = 1;
  s.lsb_mode = take(1);
  s.gg_idx = take(8);
  s.tns_on[0] = take(1);
  const int tns1 = side_field(b, p, 1);
  s.tns_on[1] = s.num_tns > 1 ? tns1 : 0;
  p += s.num_tns - 1;
  s.ltpf[0] = take(1);
  s.scf_idx[0] = take(5);
  s.scf_idx[1] = take(5);

  // the SNS second stage: 14 sets of kMpvqSplit where the submode's high bit
  // is 0 (the gain's low bit, 2, or the tail's index, 12), else the near set
  // and the far set's two halves
  const int submode_msb = take(1);
  const int gain = take(submode_msb + 1);
  s.scf_idx[4] = take(1);
  const int tmp = take(25 - submode_msb);
  const int ind = tmp / kMpvqSplit, far = tmp - kMpvqNear;
  const int lsb = submode_msb == 0 ? (ind < 2 ? 1 : 0) : (far >= 0 ? 1 : 0);
  if (tmp >= (submode_msb == 0 ? 14 * kMpvqSplit : kMpvqNear + 2 * kMpvqFar)) *bfi = 1;
  s.scf_idx[2] = submode_msb * 2 + lsb;
  s.scf_idx[3] = lsb ? gain * 2 + (submode_msb == 0 ? ind : far & 1) : gain;
  s.scf_idx[5] = submode_msb == 0 ? tmp - ind * kMpvqSplit : lsb ? far >> 1 : tmp;
  s.scf_idx[6] = lsb ? -2 : submode_msb == 0 ? ind - 2 : -1;

  // the pitch fields (1 + 9 bits) where the LTPF flag is set
  const int pitch = side_field(b, p, 10);
  s.ltpf[1] = s.ltpf[0] == 1 ? pitch & 1 : 0;
  s.ltpf[2] = s.ltpf[0] == 1 ? pitch >> 1 : 0;
  p += s.ltpf[0] == 1 ? 10 : 0;
  s.fac_ns_idx = take(3);
  b.n = p;
  return side_string_cursor(b, L);
}

}  // namespace acx
