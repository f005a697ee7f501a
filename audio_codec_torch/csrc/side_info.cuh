// The side information of an LC3plus frame, written and read backward from
// the frame's end, one stream per call (processEncoderEntropy_fl,
// enc_entropy.c:13-115; processDecoderEntropy_fl, dec_entropy.c:121-270).
//
// The functions are lane functions: side_info_pack.cu and side_info_parse.cu
// launch them one thread per stream, and the range-coder kernels can call
// them on the row they already hold. A row is `nbytes` int32 words, one byte
// in each; every byte index is clipped into the row, as the plain versions
// (ops/bits.py) clip it.
#pragma once

#include "acodec.cuh"

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

}  // namespace acx
