// The LC3plus channel coder: GF(16) Reed-Solomon with mode detection, the
// CRCs and the partial-concealment span.
//
// The steps of csrc/fec_encode.cu (fec_encode_warp) and csrc/fec_decode.cu
// (fec_decode_warp), a warp a slot each, which replace
// audio_codec_tpu/ops/fec.py:fec_encode (fec.py:628) and :fec_decode
// (fec.py:696). They follow the plain versions in
// audio_codec_torch/ops/fec.py step for step; every value is an integer, so
// each must equal its plain version bit for bit.
//
// The slot's geometry (codeword count and lengths, the redundancy of each
// codeword, the payload split) is computed here from the slot size and the
// mode, as fec.py's _slot_plan/_mode_plan compute it. The CRCs are split
// over the lanes: the remainder is linear, sum_i v_i x^(4(i + 2h)) mod P,
// the same as the plain version's position tables. The GF(16) tables, the
// syndrome points, the signalling polynomials and their syndromes, the risk
// table and the RS parity bases come in one int32 table (fec_tables in
// kernels.py) in the layout of FecTables; the decoder's (fec_dec_tables)
// adds its packed syndrome terms and the CRC powers of its lanes, the
// encoder's (fec_enc_tables) the packed parity terms after those.
//
// The decoder commits early where the plain version's lane-wise merge makes
// the rest irrelevant: a slot that passes the EP1 check returns the EP1
// payload, and only the detected mode's codewords are corrected (the plain
// version corrects all three and selects one); the EPMR estimate of a
// failed frame uses the detections of codeword 0 under the two upper modes.
#pragma once

#include "acodec.cuh"
#include "warp.cuh"

// member functions (ACX_HD is `static` on the host)
#ifdef __CUDACC__
#define ACX_HDM __host__ __device__ __forceinline__
#else
#define ACX_HDM inline
#endif

namespace acx {

constexpr int kFecMaxCw = 40;       // codewords of a 300-byte slot
constexpr int kFecMaxNib = 600;     // nibbles of a 300-byte slot
constexpr int kFecMinSlot = 40;
constexpr int kFecMaxSlot = 300;

// table layout (words)
constexpr int kFecMul = 0;                       // [16][16]
constexpr int kFecInv = kFecMul + 256;           // [16]
constexpr int kFecGPow = kFecInv + 16;           // [15]
constexpr int kFecSyndPow = kFecGPow + 15;       // [6][15]
constexpr int kFecSigPolys = kFecSyndPow + 90;   // [4][15]
constexpr int kFecSigSyndr = kFecSigPolys + 60;  // [4][6]
constexpr int kFecRiskM = kFecSigSyndr + 24;     // [4][4]
constexpr int kFecRiskE = kFecRiskM + 16;        // [4][4]
constexpr int kFecBitcnt = kFecRiskE + 16;       // [16]
constexpr int kFecBasis = kFecBitcnt + 16;       // [3][13][6]: hd 3, 5, 7
constexpr int kFecTableWords = kFecBasis + 3 * 13 * 6;

constexpr int kBecMask = 0x0FFF >> 1;
constexpr int kAllOk = 0x0800 | 0x1000 | 0x2000 | 0x4000;

// the decoder's scalar outputs, in this order ([9][B])
enum FecOut { FEC_DATA_BYTES, FEC_BFI, FEC_EPMR, FEC_ERROR_REPORT, FEC_MODE, FEC_N_PCCW,
              FEC_N_PC, FEC_BE_LEFT, FEC_BE_RIGHT, N_FEC_OUT };

struct FecTables {
  const int32_t* w;
  ACX_HDM int mul(int a, int b) const { return w[kFecMul + a * 16 + b]; }
  ACX_HDM int inv(int a) const { return w[kFecInv + a]; }
};

ACX_HD int fec_ncw(int slot) { return (2 * slot + 14) / 15; }
ACX_HD int fec_cw_len(int slot, int i) { return (2 * slot - i - 1) / fec_ncw(slot) + 1; }
ACX_HD int fec_hd0(int mode) { return mode == 1 ? 3 : (mode == 2 ? 3 : (mode == 3 ? 5 : 7)); }
ACX_HD int fec_hd1(int mode) { return mode == 1 ? 1 : (mode == 2 ? 3 : (mode == 3 ? 5 : 7)); }
ACX_HD int fec_crc1_bytes(int mode, int slot) { return (slot == 40 && mode > 1) ? 2 : 3; }

ACX_HD int fec_n_pccw(int slot, int mode, int ccc) {
  int n = 0;
  if (mode == 3) n = (2 * 2636 * slot - 117377 + 0x8000) >> 16;
  if (mode == 4) n = (2 * 2178 * slot - 129115 + 0x8000) >> 16;
  return (ccc == 1 || slot < 80) ? 0 : n;
}

ACX_HD int fec_n_pc(int mode, int n_pccw, int slot) {
  if (mode == 1 || slot < 80) return 0;
  const int ncw = fec_ncw(slot);
  int s = -2 * n_pccw * (mode - 1);
  for (int i = 0; i < n_pccw; ++i) s += (2 * slot + i) / ncw;
  return s;
}

ACX_HD int fec_data_size(int mode, int ccc, int slot) {
  int p = slot - (mode == 1 ? 1 : fec_ncw(slot) * (mode - 1)) - fec_crc1_bytes(mode, slot);
  if (ccc == 0 && mode > 2 && slot >= 80) p -= 2;
  return p;
}

// The static layout of one (slot, mode) (fec.py:_mode_plan).
struct FecPlan {
  int slot, ncw, n_nib, mode, red0, red1, data_bytes, n_crc1, n_crc2, n_pccw, pc_split,
      dw_len, ind0, ind1, crc1_n;
  ACX_HDM int red(int i) const { return i == 0 ? red0 : red1; }
};

ACX_HD FecPlan fec_plan(int slot, int mode, int ccc) {
  FecPlan p;
  p.slot = slot;
  p.ncw = fec_ncw(slot);
  p.n_nib = 2 * slot;
  p.mode = mode;
  p.red0 = fec_hd0(mode) - 1;
  p.red1 = fec_hd1(mode) - 1;
  p.data_bytes = fec_data_size(mode, ccc, slot);
  p.n_crc1 = fec_crc1_bytes(mode, slot);
  p.n_pccw = fec_n_pccw(slot, mode, ccc);
  p.pc_split = fec_n_pc(mode, p.n_pccw, slot);
  p.n_crc2 = (p.pc_split > 0 && mode > 1) ? 2 : 0;
  p.dw_len = 2 * (p.data_bytes + p.n_crc1 + p.n_crc2);
  p.ind0 = 2 * p.n_crc1 - 1;
  p.ind1 = fec_cw_len(slot, 0) - 1 - p.red0;
  p.crc1_n = 2 * p.data_bytes - p.pc_split;
  return p;
}

// (r * x^4) mod P for r of degree < deg
ACX_HD int crc_mulx4(int r, int poly, int deg) {
  r <<= 4;
  for (int b = deg + 3; b >= deg; --b)
    if ((r >> b) & 1) r ^= poly << (b - deg);
  return r;
}

ACX_HD int crc1_poly(int n_crc1) { return n_crc1 == 2 ? 0x4645 : 0x490F29; }
ACX_HD int crc1_deg(int n_crc1) { return n_crc1 == 2 ? 14 : 22; }

// dw0_bitswap (al_fec.c:358-385); an involution
ACX_HD void fec_bitswap(uint8_t* dw, int ind0, int ind1) {
  const int a = dw[ind0], b = dw[ind1];
  dw[ind0] = static_cast<uint8_t>((a & 3) | ((b & 3) << 2));
  dw[ind1] = static_cast<uint8_t>((b & 12) | ((a >> 2) & 3));
}

// ---- decoder ----

struct Elp {
  int e1, e2, e3, deg;
};

// Peterson's algorithm without branches (fec.py:_peterson_elp); deg = t+1
// flags a failure
ACX_HD Elp peterson(const FecTables& tb, const int* s, int t) {
  const int s0 = s[0], s1 = s[1];
  bool all_zero = (s0 | s1) == 0;
  if (t >= 2) all_zero = all_zero && (s[2] | s[3]) == 0;
  if (t >= 3) all_zero = all_zero && (s[4] | s[5]) == 0;
  Elp r = {0, 0, 0, t + 1};
  const int e1_1 = tb.mul(s1, tb.inv(s0));
  int lsf1 = 0;
  for (int k = 1; k < 2 * t - 1; ++k) lsf1 |= tb.mul(e1_1, s[k]) ^ s[k + 1];
  if (s0 != 0) {
    const bool ok1 = lsf1 == 0 && e1_1 != 0;
    r.deg = ok1 ? 1 : t + 1;
    r.e1 = ok1 ? e1_1 : 0;
  }
  if (t >= 2) {
    const int det2 = tb.mul(s0, s[2]) ^ tb.mul(s1, s1);
    const int di2 = tb.inv(det2);
    const int e1_2 = tb.mul(tb.mul(s1, s[2]) ^ tb.mul(s0, s[3]), di2);
    const int e2_2 = tb.mul(tb.mul(s[2], s[2]) ^ tb.mul(s1, s[3]), di2);
    int lsf2 = 0;
    for (int k = 2; k < 2 * t - 2; ++k)
      lsf2 |= tb.mul(e2_2, s[k]) ^ tb.mul(e1_2, s[k + 1]) ^ s[k + 2];
    if (det2 != 0) {
      const bool ok2 = lsf2 == 0 && e2_2 != 0;
      r.deg = ok2 ? 2 : t + 1;
      r.e1 = ok2 ? e1_2 : 0;
      r.e2 = ok2 ? e2_2 : 0;
    }
  }
  if (t >= 3) {
    const int s2 = s[2], s3 = s[3], s4 = s[4], s5 = s[5];
    const int s22 = tb.mul(s1, s1), s33 = tb.mul(s2, s2), s44 = tb.mul(s3, s3),
              s13 = tb.mul(s0, s2);
    const int det3 = tb.mul(s13, s4) ^ tb.mul(s44, s0) ^ tb.mul(s22, s4) ^ tb.mul(s33, s2);
    const int di3 = tb.inv(det3);
    const int s14 = tb.mul(s0, s3), s15 = tb.mul(s0, s4);
    const int s23 = tb.mul(s1, s2), s24 = tb.mul(s1, s3), s25 = tb.mul(s1, s4);
    const int s34 = tb.mul(s2, s3), s35 = tb.mul(s2, s4);
    const int a = s35 ^ s44, b = s15 ^ s33, c = s13 ^ s22;
    const int d = s34 ^ s25, e = s23 ^ s14, f = s24 ^ s33;
    const int e3_3 = tb.mul(tb.mul(a, s3) ^ tb.mul(d, s4) ^ tb.mul(f, s5), di3);
    const int e2_3 = tb.mul(tb.mul(d, s3) ^ tb.mul(b, s4) ^ tb.mul(e, s5), di3);
    const int e1_3 = tb.mul(tb.mul(f, s3) ^ tb.mul(e, s4) ^ tb.mul(c, s5), di3);
    if (det3 != 0) {
      const bool ok3 = e3_3 != 0;
      r.deg = ok3 ? 3 : t + 1;
      r.e1 = ok3 ? e1_3 : 0;
      r.e2 = ok3 ? e2_3 : 0;
      r.e3 = ok3 ? e3_3 : 0;
    }
  }
  if (all_zero) r = {0, 0, 0, 0};
  return r;
}

// Chien search over the 15 field points (fec.py:_chien): returns the
// failure flag and the first three root positions (15 = none)
ACX_HD bool chien(const FecTables& tb, const Elp& elp, int max_pos, int* pos) {
  int n_roots = 0;
  pos[0] = pos[1] = pos[2] = 15;
  for (int p = 0; p < 15; ++p) {
    const int X = tb.w[kFecGPow + p];
    const int X2 = tb.mul(X, X), X3 = tb.mul(X2, X);
    const int val = X3 ^ tb.mul(elp.e1, X2) ^ tb.mul(elp.e2, X) ^ elp.e3;
    if (val == 0 && elp.deg > 0) {
      if (n_roots < 3) pos[n_roots] = p;
      ++n_roots;
    }
  }
  bool in_range = true;
  for (int jj = 0; jj < 3; ++jj)
    if (jj < elp.deg && pos[jj] > max_pos) in_range = false;
  return (n_roots != elp.deg || !in_range) && elp.deg > 0;
}

// error magnitudes by Cramer's rule (fec.py:_forney)
ACX_HD void forney(const FecTables& tb, const int* pos, int deg, const int* s, int* err) {
  const int X0 = tb.w[kFecGPow + pos[0] % 15], X1 = tb.w[kFecGPow + pos[1] % 15],
            X2 = tb.w[kFecGPow + pos[2] % 15];
  const int s0 = s[0], s1 = s[1], s2 = s[2];
  const int e0_1 = tb.mul(tb.inv(X0), s0);
  const int x0q = tb.mul(X0, X0), x1q = tb.mul(X1, X1), x2q = tb.mul(X2, X2);
  const int di2 = tb.inv(tb.mul(x0q, X1) ^ tb.mul(x1q, X0));
  const int e0_2 = tb.mul(tb.mul(x1q, s0) ^ tb.mul(X1, s1), di2);
  const int e1_2 = tb.mul(tb.mul(x0q, s0) ^ tb.mul(X0, s1), di2);
  const int di3 = tb.inv(tb.mul(tb.mul(X1 ^ X0, X2 ^ X0), X2 ^ X1));
  int e3[3];
  const int xs[3] = {X0, X1, X2}, xq[3] = {x0q, x1q, x2q};
  for (int o = 0; o < 3; ++o) {
    const int a = o == 0 ? 1 : 0, b = o == 2 ? 1 : 2;   // the two other roots, in order
    const int num = tb.mul(tb.mul(xs[a], xq[b]) ^ tb.mul(xs[b], xq[a]), s0)
                    ^ tb.mul(xq[b] ^ xq[a], s1) ^ tb.mul(xs[b] ^ xs[a], s2);
    e3[o] = tb.mul(tb.mul(num, di3), tb.inv(xs[o]));
  }
  const int e0 = deg == 1 ? e0_1 : (deg == 2 ? e0_2 : e3[0]);
  const int e1 = deg == 2 ? e1_2 : e3[1];
  err[0] = deg >= 1 ? e0 : 0;
  err[1] = deg >= 2 ? e1 : 0;
  err[2] = deg >= 3 ? e3[2] : 0;
}

// simple_float arithmetic (al_fec.c:2310-2377)
ACX_HD void sf_mul(int& m1, int& e1, int m2, int e2) {
  const int aux = (m1 * m2) >> 14;
  const bool hi = (aux & 32768) != 0;
  m1 = hi ? aux >> 1 : aux;
  e1 = hi ? e1 + e2 + 1 : e1 + e2;
}
ACX_HD bool sf_le(int m1, int e1, int m2, int e2) { return e1 < e2 || (e1 == e2 && m1 <= m2); }
ACX_HD bool sf_lt(int m1, int e1, int m2, int e2) { return e1 < e2 || (e1 == e2 && m1 < m2); }

// ---- the decoder: a warp a slot (fec_decode.cu) ----
//
// fec_decode_warp runs the lane decoder's steps (fec_decoder, al_fec.c:711-882;
// fec.py:fec_decode_plain) across the lanes of a warp:
//  - lane l holds codewords l and l + 32 (slots of 241 bytes and more have
//    up to 40), each packed in a 64-bit word (nibble j at bits 4j), and their
//    six syndromes packed in a 32-bit word (syndrome k at bits 4k): the
//    syndromes are linear in the codeword, so one table word a (position,
//    nibble) gives all six terms (kFecSyn6), 15 independent lookups a
//    codeword;
//  - the 18 detections of codewords 0..5 under the three internal modes run
//    on lanes 6m + i at once, each packed into one word (fec_detect_word); the
//    EPMR estimate of a failed frame reuses those of (m = 1, 2; i = 0);
//  - the clean, blacklist and Chien-failure flags are ballots; the risk
//    products stay a chain of six sf_mul in codeword order 0..5, lane m mode
//    m's (sf_mul truncates, so the order sets the products' last bits,
//    though no decision they reach changes with it:
//    tests/test_torch_fxdct_fec_rehearsal.py);
//  - the correction runs a codeword a lane; the corrected bits are a warp
//    sum, the broken, failure and trust flags ballots;
//  - the data word is gathered into shared memory by its codewords' lanes
//    at offsets known in closed form;
//  - each CRC is split over the lanes: the remainder is linear over GF(2),
//    sum_i v_i x^(4(i + 2h)) mod P, so lane l sums the terms of nibbles l,
//    l + 32, ..., each from x^(4(i + 2h)) mod P (a table, kFecCrcPow, read
//    through L1) and three steps of x, and the lanes' sums are XOR-reduced:
//    no chain longer than a lane's 19 independent terms; the EPMR embedding
//    of CRC1 is added once.
// Everything else is uniform: every lane runs the scalar decisions.

// the decoder's table: fec_tables' words, then (kernels.py:fec_dec_tables)
// the packed syndrome terms, both staged in shared memory, then the CRC
// powers, read through L1
constexpr int kFecSyn6 = kFecTableWords;             // [15][16] the six syndrome terms, packed
constexpr int kFecCrcPow = kFecSyn6 + 15 * 16;       // [3][kFecCrcPowers]: x^(4k) mod P of
constexpr int kFecCrcPowers = kFecMaxNib + 8;        //   CRC1 (2 bytes, 3 bytes) and CRC2
constexpr int kFecDecTableWords = kFecCrcPow + 3 * kFecCrcPowers;
static_assert(kFecMaxCw <= 64, "a lane holds two codewords");

// a warp's shared scratch: the slot's bytes and a data word of nibbles
struct FecWarpScratch {
  uint8_t frame[kFecMaxSlot];
  uint8_t dw[kFecMaxNib];
};

ACX_HD int nib64(uint64_t w, int j) { return static_cast<int>((w >> (4 * j)) & 15); }
ACX_HD int nib32(uint32_t w, int k) { return static_cast<int>((w >> (4 * k)) & 15); }

// codeword i of the slot's bytes (its len nibbles; fec_deinterleave_unpack)
ACX_HD uint64_t fec_codeword(const uint8_t* frame, int slot, int ncw, int i, int len) {
  uint64_t cw = 0;
  for (int j = 0; j < 15; ++j) {
    if (j < len) {
      const int o = 2 * slot - 1 - (j * ncw + i);
      cw |= static_cast<uint64_t>((frame[o >> 1] >> (4 * (o & 1))) & 15) << (4 * j);
    }
  }
  return cw;
}

// the six syndromes of a codeword, packed (fec.py:_syndromes6)
ACX_HD uint32_t fec_syndromes(const int32_t* tw, uint64_t cw) {
  uint32_t s = 0;
  for (int j = 0; j < 15; ++j) s ^= static_cast<uint32_t>(tw[kFecSyn6 + 16 * j + nib64(cw, j)]);
  return s;
}

// (r * x) mod P for r of degree < deg
ACX_HD int crc_mulx(int r, int poly, int deg) {
  r <<= 1;
  return ((r >> deg) & 1) != 0 ? r ^ poly : r;
}

// sum_i v[i] x^(4(i + 2h)) mod P over n nibbles (the CRC remainder of
// fec.py:_crc_eval's position tables), pw[k] = x^(4k) mod P: nibble i on lane i mod 32, v[i] x^(4(i + 2h)) as
// the XOR of x^(4(i + 2h) + b) over v[i]'s bits b
template <class W>
ACX_HD int fec_crc_warp(const W& w, const uint8_t* v, int n, int h, const int32_t* pw, int poly,
                        int deg) {
  typename W::template Lanes<unsigned> r;
  w.lanes([&](int l) {
    int acc = 0;
    for (int i = l; i < n; i += 32) {
      const int vi = v[i];
      int p = pw[i + 2 * h];
      for (int b = 0; b < 4; ++b) {
        if (((vi >> b) & 1) != 0) acc ^= p;
        p = crc_mulx(p, poly, deg);
      }
    }
    r[l] = static_cast<unsigned>(acc);
  });
  return static_cast<int>(w.reduce_xor(r));
}

// the CRC1 remainder with the EPMR embedding (crc1_rem); cp: the CRC powers
template <class W>
ACX_HD int fec_crc1_warp(const W& w, const int32_t* cp, const uint8_t* v, int n, int n_crc1,
                         int epmr) {
  const int poly = crc1_poly(n_crc1), deg = crc1_deg(n_crc1);
  int e = epmr << 2;
  for (int k = 0; k < 2 * n_crc1 - 1; ++k) e = crc_mulx4(e, poly, deg);
  const int32_t* pw = cp + (n_crc1 == 2 ? 0 : kFecCrcPowers);
  return fec_crc_warp(w, v, n, n_crc1, pw, poly, deg) ^ e ^ (epmr << deg);
}

ACX_HD bool fec_crc_ok(const uint8_t* dw, int rem, int nibbles) {
  bool ok = true;
  for (int q = 0; q < nibbles; ++q)
    if (dw[q] != ((rem >> (4 * q)) & 15)) ok = false;
  return ok;
}

// The data-word offset of codeword i's first data nibble (its nibble
// red(i)): the sum over i' < i of len(i') - red(i') = i q + min(i, r) - red0
// - (i - 1) red1 (n_nib = q ncw + r: the first r codewords are q + 1 long,
// the others q).
ACX_HD int fec_dw_start(const FecPlan& p, int i) {
  const int q = p.n_nib / p.ncw, r = p.n_nib % p.ncw;
  return i * q + imin(i, r) - (i > 0 ? p.red0 + (i - 1) * p.red1 : 0);
}

// The data word of plan p from the codewords (fec.py:fec_decode's flat/dw_pos
// gather and bit swap): lane l writes the data nibbles of its codewords at
// their offsets.
template <class W, class L64>
ACX_HD void fec_data_word(const W& w, const L64& cwA, const L64& cwB, const FecPlan& p,
                          uint8_t* dw) {
  w.lanes([&](int l) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int i = l + 32 * h;
      if (i < p.ncw) {
        const uint64_t cw = h == 0 ? cwA[l] : cwB[l];
        const int len = fec_cw_len(p.slot, i), red = p.red(i);
        const int k = fec_dw_start(p, i) - red;
        for (int j = red; j < len; ++j) dw[k + j] = static_cast<uint8_t>(nib64(cw, j));
      }
    }
  });
  w.sync();
  w.leader([&] { fec_bitswap(dw, p.ind0, p.ind1); });
  w.sync();
}

// A detection (Peterson, Chien, the masked Forney magnitudes; fec.py:
// _peterson_elp, _chien, _forney and msk6) packed in a word: the three root
// positions (bits 0-11), the three error magnitudes (12-23), the degree
// (24-27) and the Chien failure (28).
ACX_HD int fec_detect_word(const FecTables& tb, const int* s, int t, int max_pos) {
  const Elp elp = peterson(tb, s, t);
  int pos[3], err[3];
  const bool fail = chien(tb, elp, max_pos, pos);
  forney(tb, pos, elp.deg, s, err);
  int word = elp.deg << 24 | (fail ? 1 << 28 : 0);
  for (int jj = 0; jj < 3; ++jj) {
    if (!(jj < elp.deg && !fail && elp.deg <= t)) err[jj] = 0;
    word |= pos[jj] << (4 * jj) | err[jj] << (12 + 4 * jj);
  }
  return word;
}
ACX_HD int det_pos(int d, int jj) { return (d >> (4 * jj)) & 15; }
ACX_HD int det_err(int d, int jj) { return (d >> (12 + 4 * jj)) & 15; }
ACX_HD int det_deg(int d) { return (d >> 24) & 15; }
ACX_HD bool det_fail(int d) { return ((d >> 28) & 1) != 0; }

// codeword cw with a detection's errors applied (the dump position 15 lies
// past the 15 nibbles)
ACX_HD uint64_t det_apply(uint64_t cw, int d) {
  for (int jj = 0; jj < 3; ++jj) cw ^= static_cast<uint64_t>(det_err(d, jj)) << (4 * det_pos(d, jj));
  return cw;
}

// mode m's signalling polynomial, packed as a codeword
ACX_HD uint64_t fec_sig_word(const int32_t* tw, int m) {
  uint64_t v = 0;
  for (int j = 0; j < 15; ++j) v |= static_cast<uint64_t>(tw[kFecSigPolys + m * 15 + j]) << (4 * j);
  return v;
}

// fec_decoder (al_fec.c:711-882) of one slot on a warp: frame [slot] bytes
// -> data [slot] bytes and out[k * stride] for the FecOut fields. tw: the
// decoder's table up to kFecCrcPow; cp: its CRC powers; ws: the warp's
// scratch.
template <class W>
ACX_HD void fec_decode_warp(const W& w, const int32_t* frame, int bfi_in, const int32_t* tw,
                            const int32_t* cp, int slot, int ccc, FecWarpScratch* ws,
                            int32_t* data, int32_t* out, int stride) {
  using IL = typename W::template Lanes<int>;
  using UL = typename W::template Lanes<uint32_t>;
  using L64 = typename W::template Lanes<unsigned long long>;
  FecTables tb;
  tb.w = tw;
  const int ncw = fec_ncw(slot), len0 = fec_cw_len(slot, 0);
  // the slot's bytes, every load of a lane in flight
  w.lanes([&](int l) {
    constexpr int kRounds = (kFecMaxSlot + 31) / 32;
    int32_t v[kRounds];
#pragma unroll
    for (int u = 0; u < kRounds; ++u) v[u] = l + 32 * u < slot ? frame[l + 32 * u] : 0;
#pragma unroll
    for (int u = 0; u < kRounds; ++u)
      if (l + 32 * u < slot) ws->frame[l + 32 * u] = static_cast<uint8_t>(v[u]);
  });
  w.sync();
  // the codewords and their syndromes, codeword l (A) and l + 32 (B) a lane
  L64 cwA, cwB;
  UL synA, synB;
  w.lanes([&](int l) {
    cwA[l] = cwB[l] = 0;
    synA[l] = synB[l] = 0;
    if (l < ncw) {
      cwA[l] = fec_codeword(ws->frame, slot, ncw, l, fec_cw_len(slot, l));
      synA[l] = fec_syndromes(tw, cwA[l]);
    }
    if (l + 32 < ncw) {
      cwB[l] = fec_codeword(ws->frame, slot, ncw, l + 32, fec_cw_len(slot, l + 32));
      synB[l] = fec_syndromes(tw, cwB[l]);
    }
  });
  const uint32_t syn0 = w.shfl(synA, 0);
  const int epmr_raw = nib64(w.shfl(cwA, 0), len0 - 1) & 3;

  int bfi = 1, mode = -1, er = kBecMask, epmr = 0, data_bytes = 0, n_pc = 0, n_pccw = 0;
  int be_l = -1, be_r = -1;
  bool data_set = false;
  FecPlan pd = fec_plan(slot, 1, ccc);   // the plan of the data word in ws->dw

  // stage 1: EP1 by codeword 0's syndromes and CRC1
  const bool ep1_syn_ok = (syn0 & 0xFF) == 0;
  bool ep1_ok = false;
  if (ep1_syn_ok) {
    fec_data_word(w, cwA, cwB, pd, ws->dw);
    const int rem = fec_crc1_warp(w, cp, ws->dw + 2 * pd.n_crc1, pd.crc1_n, pd.n_crc1, epmr_raw);
    ep1_ok = fec_crc_ok(ws->dw, rem, 2 * pd.n_crc1);
    if (ep1_ok) {
      data_set = true;
      bfi = 0;
      mode = 1;
      er = kAllOk;
      epmr = epmr_raw;
      data_bytes = pd.data_bytes;
    }
  }

  if (!ep1_ok) {
    // stage 2: the 18 detections, codeword i < 6 under internal mode m on
    // lane 6m + i (lanes 18-31 idle)
    IL src;
    w.lanes([&](int l) { src[l] = l < 18 ? l % 6 : 0; });
    const UL sdet = w.shfl_from(synA, src);
    const uint64_t cw0 = w.shfl(cwA, 0);
    IL det, cleanL, blackL, failL, dcL, epL;
    w.lanes([&](int l) {
      const int m = imin(l / 6, 2), i = l % 6, t = m + 1;
      int s[6];
      bool clean = true;
      for (int k = 0; k < 6; ++k) {
        s[k] = nib32(sdet[l], k) ^ tw[kFecSigSyndr + (m + 1) * 6 + k];
        if (k < 2 * t && s[k] != 0) clean = false;
      }
      const int d = l < 18 ? fec_detect_word(tb, s, t, fec_cw_len(slot, i) - 1) : 0;
      det[l] = d;
      cleanL[l] = l < 18 && clean;
      blackL[l] = l < 18 && det_deg(d) > t;
      failL[l] = l < 18 && det_fail(d);
      dcL[l] = imin(det_deg(d), 3);
      // codeword 0's EPMR bits once corrected under m (epmr_det)
      int v = nib64(cw0, len0 - 1);
      for (int jj = 0; jj < 3; ++jj)
        if (det_pos(d, jj) == len0 - 1) v ^= det_err(d, jj);
      epL[l] = (v ^ tw[kFecSigPolys + (m + 1) * 15 + len0 - 1]) & 3;
    });
    const unsigned cleanB = w.ballot(cleanL), blackB = w.ballot(blackL), failB = w.ballot(failL);
    // the risk products: lane m multiplies mode m's six risks in codeword order
    IL pmL, peL;
    w.lanes([&](int l) {
      pmL[l] = 16384;
      peL[l] = 0;
    });
    for (int i = 0; i < 6; ++i) {
      IL from;
      w.lanes([&](int l) { from[l] = imin(6 * l + i, 31); });
      const IL dc = w.shfl_from(dcL, from);
      w.lanes([&](int l) {
        const int m = imin(l, 2);
        sf_mul(pmL[l], peL[l], tw[kFecRiskM + (m + 1) * 4 + dc[l]],
               tw[kFecRiskE + (m + 1) * 4 + dc[l]]);
      });
    }
    int clean_m = -1;
    for (int m = 2; m >= 0; --m)
      if (((cleanB >> (6 * m)) & 63) == 63) clean_m = m;
    // candidate pick (al_fec.c:1190-1290)
    const int thr_m = slot <= 40 ? 21990 : 25166, thr_e = slot <= 40 ? -23 : -10;
    int sel_m = -1, sel_mant = 0, sel_e = 0;
    for (int m = 0; m < 3; ++m) {
      const int pm = w.shfl(pmL, m), pe = w.shfl(peL, m);
      const bool viable = ((blackB >> (6 * m)) & 63) == 0 && sf_le(pm, pe, thr_m, thr_e)
                          && ((failB >> (6 * m)) & 63) == 0;
      if (viable && (sel_m < 0 || sf_lt(pm, pe, sel_mant, sel_e))) {
        sel_m = m;
        sel_mant = pm;
        sel_e = pe;
      }
    }
    const int det_m = clean_m >= 0 ? clean_m : sel_m;

    if (det_m < 0) {
      // total failure (fec_estimate_epmr_from_cw0, al_fec.c:908-1010):
      // codeword 0 under the two upper modes, lanes 6 and 12
      const int d2 = w.shfl(det, 6), d3 = w.shfl(det, 12);
      const int epmr_det2 = w.shfl(epL, 6), epmr_det3 = w.shfl(epL, 12);
      const int ep2_s01 = (nib32(syn0, 0) ^ tw[kFecSigSyndr + 6])
                          | (nib32(syn0, 1) ^ tw[kFecSigSyndr + 7]);
      int est_exp = (ep1_syn_ok || ep2_s01 == 0) ? -8 : 0;
      const int dc2 = imin(det_deg(d2), 3), dc3 = imin(det_deg(d3), 3);
      const int re2 = tw[kFecRiskE + 2 * 4 + dc2], rm2 = tw[kFecRiskM + 2 * 4 + dc2];
      const int re3 = tw[kFecRiskE + 3 * 4 + dc3], rm3 = tw[kFecRiskM + 3 * 4 + dc3];
      const bool cand2 = det_deg(d2) <= 2 && re2 <= -8;
      const bool cand3 = det_deg(d3) <= 3 && re3 <= -8;
      const bool first_is_2 = (cand2 && cand3) ? sf_lt(rm2, re2, rm3, re3) : cand2;
      const bool pick2 = cand2 && !det_fail(d2), pick3 = cand3 && !det_fail(d3);
      const bool use2 = pick2 && (first_is_2 || !pick3);
      const bool use3 = pick3 && !use2;
      est_exp = use2 ? re2 : (use3 ? re3 : est_exp);
      const int base = use2 ? epmr_det2 : (use3 ? epmr_det3 : epmr_raw);
      epmr = base + 4 * (est_exp > -16 ? 1 : 0) + 4 * (est_exp > -8 ? 1 : 0);
    } else {
      // the detected mode: correct every codeword, a codeword a lane;
      // codewords 0..5 take their detection under m (lane 6m + i)
      const int m = det_m, t = m + 1;
      pd = fec_plan(slot, m + 2, ccc);
      const FecPlan& p = pd;
      IL from;
      w.lanes([&](int l) { from[l] = l < 6 ? 6 * m + l : l; });
      const IL mine = w.shfl_from(det, from);
      const uint64_t sig = fec_sig_word(tw, m + 1);
      const int risk_e = kFecRiskE + (m + 1) * 4;
      IL bitsL, degL, brokenL, bfi1L, bfi2L, hardL, untrustA, untrustB;
      w.lanes([&](int l) {
        int bits = 0, broken = 0, bfi1 = 0, bfi2 = 0, hard = 0, deg_a = 0;
        untrustA[l] = untrustB[l] = 0;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int i = l + 32 * h;
          if (i < ncw) {
            int d;
            if (i < 6) {
              d = mine[l];
            } else {
              const uint32_t sy = h == 0 ? synA[l] : synB[l];
              int s[6];
              for (int k = 0; k < 6; ++k) s[k] = nib32(sy, k);
              d = fec_detect_word(tb, s, t, fec_cw_len(slot, i) - 1);
              const bool hardfail = det_deg(d) > t || det_fail(d);
              const bool is_pc = i >= ncw - p.n_pccw;
              if (hardfail && !is_pc) bfi1 = 1;
              if (hardfail && is_pc) bfi2 = 1;
              if (hardfail) hard = 1;
              const bool trust = !hardfail && !(tw[risk_e + imin(det_deg(d), 3)] + 16 > 0);
              (h == 0 ? untrustA : untrustB)[l] = trust ? 0 : 1;
            }
            const int deg = det_deg(d);
            if (h == 0) deg_a = deg;
            for (int b = 0; b < 4; ++b)
              if (b < m + 1 && deg > b) broken |= 1 << b;
            for (int jj = 0; jj < 3; ++jj) bits += tw[kFecBitcnt + det_err(d, jj)];
            uint64_t cw = det_apply(h == 0 ? cwA[l] : cwB[l], d);
            if (i < 6) cw ^= sig;
            (h == 0 ? cwA : cwB)[l] = cw;
          }
        }
        bitsL[l] = bits;
        degL[l] = deg_a;
        brokenL[l] = broken;
        bfi1L[l] = bfi1;
        bfi2L[l] = bfi2;
        hardL[l] = hard;
      });
      typename W::template Lanes<unsigned> bitsU;
      w.lanes([&](int l) { bitsU[l] = static_cast<unsigned>(bitsL[l]); });
      const int bits = static_cast<int>(w.reduce_add(bitsU));
      const bool bfi1 = w.ballot(bfi1L) != 0, bfi2 = w.ballot(bfi2L) != 0;
      const bool any_hardfail = w.ballot(hardL) != 0;
      const unsigned untrust0 = w.ballot(untrustA), untrust1 = w.ballot(untrustB);
      bool broken[4];
      for (int b = 0; b < 4; ++b) {
        IL bb;
        w.lanes([&](int l) { bb[l] = (brokenL[l] >> b) & 1; });
        broken[b] = w.ballot(bb) != 0;
      }
      const int deg0 = imin(w.shfl(degL, 0), 3);
      if (ncw > 6 && any_hardfail)
        for (int b = 0; b < 4; ++b) broken[b] = true;
      const int epmr_det = nib64(w.shfl(cwA, 0), len0 - 1) & 3;
      fec_data_word(w, cwA, cwB, p, ws->dw);
      const int tmp_epmr = ws->dw[2 * p.n_crc1 - 1] >> 2;
      const int c12 = 2 * (p.n_crc1 + p.n_crc2);
      const int remc = fec_crc1_warp(w, cp, ws->dw + c12, p.crc1_n, p.n_crc1, tmp_epmr);
      const bool crc1_ok = fec_crc_ok(ws->dw, remc, 2 * p.n_crc1);
      bool crc2_ok = true;
      if (p.n_crc2) {
        const int rem2 = fec_crc_warp(w, ws->dw + p.dw_len - p.pc_split, p.pc_split, 2,
                                      cp + 2 * kFecCrcPowers, 0x1A2EB, 16);
        crc2_ok = fec_crc_ok(ws->dw + 2 * p.n_crc1, rem2, 2 * p.n_crc2);
      }
      // EPMR of the corrected path (al_fec.c:1177,1359-1370)
      const int exp0 = tw[kFecRiskE + (m + 1) * 4 + deg0];
      epmr = clean_m >= 0 ? epmr_raw
                          : epmr_det + 8 - 4 * (exp0 <= -8 ? 1 : 0) - 4 * (exp0 <= -16 ? 1 : 0);
      int broken_bits = 0;
      for (int b = 0; b < 4; ++b)
        if (!broken[b]) broken_bits |= (0x1000 << b) >> 1;
      er = bfi1 ? kBecMask : ((bits & kBecMask) | broken_bits);
      bfi = bfi1 ? 1 : (bfi2 ? 2 : 0);
      mode = m + 2;
      // low-rate error cap (al_fec.c:760-783)
      bool cap_fail = false;
      if (slot == 40) {
        const int lims[5] = {0, 0, 3, 9, 18};
        const int bits_only = er & kBecMask;
        cap_fail = bits_only > lims[mode];
        if (!cap_fail && bits_only > lims[2]) er &= ~0x1000;
        if (!cap_fail && bits_only > lims[3]) er &= ~0x2000;
        if (cap_fail) {
          er = bits_only;
          bfi = 1;
        }
      }
      // CRC outcomes
      if (!bfi1 && !cap_fail) {
        if (crc1_ok) {
          epmr = tmp_epmr;
          if (bfi != 2 && !crc2_ok) bfi = 2;
        } else {
          bfi = 1;
        }
      }
      // partial-concealment span from the trust of the PC codewords
      if (m >= 1 && p.n_pccw > 0 && bfi == 2) {
        int first_bad = p.n_pccw, last_bad = -1;
        for (int q = 0; q < p.n_pccw; ++q) {
          const int i = ncw - 1 - q;
          const bool untrusted = (((i < 32 ? untrust0 : untrust1) >> (i & 31)) & 1u) != 0;
          if (untrusted) {
            if (first_bad == p.n_pccw) first_bad = q;
            last_bad = q;
          }
        }
        if (last_bad < 0) last_bad = p.n_pccw - 1;
        be_l = first_bad == p.n_pccw ? 0 : 4 * fec_n_pc(p.mode, first_bad, slot);
        be_r = 4 * fec_n_pc(p.mode, last_bad + 1, slot) - 1;
      }
      if (bfi == 1 && cap_fail) mode = -1;
      if (bfi != 1) {
        data_set = true;
        data_bytes = p.data_bytes;
      }
      n_pc = p.pc_split;
      n_pccw = p.n_pccw;
      if (mode < 0) n_pc = n_pccw = 0;
      if (bfi != 2) be_l = be_r = -1;
    }
  }
  // the payload bytes of the data word (fec.py:_dw_to_bytes), zero padded
  const int top = pd.dw_len - 2 * pd.data_bytes, nd = data_set ? pd.data_bytes : 0;
  w.lanes([&](int l) {
    for (int j = l; j < slot; j += 32) {
      const int q = pd.data_bytes - 1 - j;
      data[j] = j < nd ? ws->dw[top + 2 * q] * 16 | ws->dw[top + 2 * q + 1] : 0;
    }
  });
  if (bfi_in == 1) {
    bfi = 1;
    er = -1;
    data_bytes = 0;
    mode = -1;
  }
  w.leader([&] {
    out[FEC_DATA_BYTES * stride] = data_bytes;
    out[FEC_BFI * stride] = bfi;
    out[FEC_EPMR * stride] = epmr;
    out[FEC_ERROR_REPORT * stride] = er;
    out[FEC_MODE * stride] = mode;
    out[FEC_N_PCCW * stride] = n_pccw;
    out[FEC_N_PC * stride] = n_pc;
    out[FEC_BE_LEFT * stride] = be_l;
    out[FEC_BE_RIGHT * stride] = be_r;
  });
}

// ---- the encoder: a warp a slot (fec_encode.cu) ----
//
// fec_encode_warp runs the steps of fec_encoder (al_fec.c:481-557;
// fec.py:fec_encode_plain) across the lanes of a warp:
//  - the payload row is loaded coalesced, a byte a lane, every load of a
//    lane in flight, and stored into the warp's shared scratch as the data
//    word's nibbles (reversed byte order, after the CRC nibbles);
//  - CRC1 (with the EPMR embedding) and CRC2 are split over the lanes as the
//    decoder's are (fec_crc1_warp, fec_crc_warp): 19 independent terms a
//    lane at most, XOR-reduced; lanes 0 to c12 - 1 then store the CRC
//    nibbles at the data word's head;
//  - lane l builds codewords l and l + 32 as 64-bit words (nibble j at bits
//    4j), the data nibbles from their closed-form offset (fec_dw_start);
//  - the bit swap touches codeword 0's data alone: ind0 = 2 n_crc1 - 1 <= 5
//    and ind1 = nd0 - 1, where nd0 = len0 - red0 >= 14 - 6 = 8 (a slot of
//    40..300 bytes has 6..40 codewords and codeword 0 is 14 or 15 nibbles
//    long), so ind0 < ind1 < nd0 at every slot and mode
//    (tests/test_torch_fecenc_phecu_rehearsal.py checks each); lane 0 swaps
//    the bits in its register before the parity;
//  - the parity is linear in the data nibbles: a table word a (hd, data
//    position c, nibble value) packs all `red` parity nibbles
//    (kFecParity), so a codeword's parity is at most 13 independent lookups
//    XORed; the mode's signalling polynomial is one packed word, XORed into
//    codewords 0..5 where they carry parity;
//  - the codewords go to shared memory, then lane l assembles output bytes
//    b = l, l + 32, ...: nibble o = 2b (low half) and 2b + 1 (high half) of
//    the slot is nibble (n_nib - 1 - o) div ncw of codeword
//    (n_nib - 1 - o) mod ncw. Each byte is written once, coalesced.

// the encoder's table: fec_dec_tables' words (the CRC powers read at
// kFecCrcPow), then [3][13][16] the parity terms of hd 3, 5 and 7:
// nibble q of word (h, c, v) is mul(v, basis_h[c][q])
constexpr int kFecParity = kFecDecTableWords;
constexpr int kFecEncTableWords = kFecParity + 3 * 13 * 16;

// a warp's shared scratch: the codewords and the data word of nibbles
struct FecEncScratch {
  unsigned long long cw[kFecMaxCw];
  uint8_t dw[kFecMaxNib];
};

// the bit swap of fec_bitswap on a codeword's data nibbles (nibble c at bits 4c)
ACX_HD uint64_t fec_bitswap64(uint64_t d, int ind0, int ind1) {
  const uint64_t a = (d >> (4 * ind0)) & 15, b = (d >> (4 * ind1)) & 15;
  d &= ~((15ull << (4 * ind0)) | (15ull << (4 * ind1)));
  return d | ((a & 3) | ((b & 3) << 2)) << (4 * ind0) | ((b & 12) | ((a >> 2) & 3)) << (4 * ind1);
}

// the red parity nibbles (nibble q at bits 4q) of a codeword of nd data
// nibbles d (nibble c at bits 4c), red > 0 (fec.py:_rs_parity)
ACX_HD uint32_t fec_parity(const int32_t* tw, int red, uint64_t d, int nd) {
  const int32_t* par = tw + kFecParity + (red / 2 - 1) * 13 * 16;
  uint32_t r = 0;
#pragma unroll
  for (int c = 0; c < 13; ++c)
    if (c < nd) r ^= static_cast<uint32_t>(par[16 * c + nib64(d, c)]);
  return r;
}

// fec_encoder (al_fec.c:481-557) of one slot on a warp: data [data_bytes]
// bytes -> out [slot] bytes. tw: the encoder's table (fec_enc_tables); ws:
// the warp's scratch.
template <class W>
ACX_HD void fec_encode_warp(const W& w, const int32_t* data, int epmr, const int32_t* tw,
                            int slot, int mode, int ccc, FecEncScratch* ws, int32_t* out) {
  const FecPlan p = fec_plan(slot, mode, ccc);
  const int D = p.data_bytes, c12 = 2 * (p.n_crc1 + p.n_crc2);
  epmr = iclamp(epmr, 0, 3);
  // payload byte j -> data-word nibbles c12 + 2 (D - 1 - j) (high) and + 1 (low)
  w.lanes([&](int l) {
    constexpr int kRounds = (kFecMaxSlot + 31) / 32;
    int32_t v[kRounds];
#pragma unroll
    for (int u = 0; u < kRounds; ++u) v[u] = l + 32 * u < D ? data[l + 32 * u] : 0;
#pragma unroll
    for (int u = 0; u < kRounds; ++u) {
      const int j = l + 32 * u;
      if (j < D) {
        const int at = c12 + 2 * (D - 1 - j);
        ws->dw[at] = static_cast<uint8_t>((v[u] & 255) >> 4);
        ws->dw[at + 1] = static_cast<uint8_t>(v[u] & 15);
      }
    }
  });
  w.sync();
  // the CRCs over the lanes, then their nibbles at the data word's head
  const int32_t* cp = tw + kFecCrcPow;
  const int rem1 = fec_crc1_warp(w, cp, ws->dw + c12, p.crc1_n, p.n_crc1, epmr);
  const int rem2 = p.n_crc2 ? fec_crc_warp(w, ws->dw + c12 + p.crc1_n, p.pc_split, 2,
                                           cp + 2 * kFecCrcPowers, 0x1A2EB, 16)
                            : 0;
  w.lanes([&](int l) {
    const int n1 = 2 * p.n_crc1;
    if (l < c12)
      ws->dw[l] = static_cast<uint8_t>(l < n1 ? (rem1 >> (4 * l)) & 15 : (rem2 >> (4 * (l - n1))) & 15);
  });
  w.sync();
  // codewords l and l + 32: data, bit swap (codeword 0), parity, signalling
  const uint64_t sig = fec_sig_word(tw, mode - 1) & ((1ull << 52) - 1);   // nibbles 0..12
  w.lanes([&](int l) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int i = l + 32 * h;
      if (i < p.ncw) {
        const int red = p.red(i), nd = fec_cw_len(slot, i) - red;
        const uint8_t* src = ws->dw + fec_dw_start(p, i);
        uint64_t d = 0;
#pragma unroll
        for (int c = 0; c < 15; ++c)
          if (c < nd) d |= static_cast<uint64_t>(src[c]) << (4 * c);
        if (i == 0) d = fec_bitswap64(d, p.ind0, p.ind1);
        uint64_t cw = d << (4 * red);
        if (red > 0) {
          cw |= fec_parity(tw, red, d, nd);
          if (i < 6) cw ^= sig;
        }
        ws->cw[i] = cw;
      }
    }
  });
  w.sync();
  // the interleave: codeword i nibble j is slot nibble n_nib - 1 - (j ncw + i)
  w.lanes([&](int l) {
    for (int b = l; b < slot; b += 32) {
      const int t = p.n_nib - 1 - 2 * b;   // the low half's; the high half's is t - 1
      const int i = t % p.ncw, j = t / p.ncw;
      const int i1 = i > 0 ? i - 1 : p.ncw - 1, j1 = i > 0 ? j : j - 1;
      out[b] = nib64(ws->cw[i], j) | nib64(ws->cw[i1], j1) << 4;
    }
  });
}

}  // namespace acx
