// The LC3plus channel coder of one slot per lane: GF(16) Reed-Solomon with
// mode detection, the CRCs and the partial-concealment span.
//
// Lane functions of csrc/fec_encode.cu and csrc/fec_decode.cu, which replace
// audio_codec_tpu/ops/fec.py:fec_encode (fec.py:628) and :fec_decode
// (fec.py:696). They follow the plain versions in
// audio_codec_torch/ops/fec.py step for step; every value is an integer, so
// a lane must equal its plain version bit for bit.
//
// The slot's geometry (codeword count and lengths, the redundancy of each
// codeword, the payload split) is computed here from the slot size and the
// mode, as fec.py's _slot_plan/_mode_plan compute it. The CRCs run as a
// Horner scheme over the nibbles with the generator polynomial, which gives
// the same remainder as the plain version's position tables (the CRC is
// linear: both are sum_i v_i x^(4(i + 2h)) mod P). The GF(16) tables, the
// syndrome points, the signalling polynomials and their syndromes, the risk
// table and the RS parity bases come in one int32 table (fec_tables in
// kernels.py) in the layout of FecTables.
//
// The decoder commits early where the plain version's lane-wise merge makes
// the rest irrelevant: a slot that passes the EP1 check returns the EP1
// payload, and only the detected mode's codewords are corrected (the plain
// version corrects all three and selects one; the EPMR estimate needs
// codeword 0 of the two upper modes, which is corrected on its own).
#pragma once

#include "acodec.cuh"

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

// sum_i v[i] x^(4(i + 2h)) mod P: the remainder of fec.py:_crc_eval
ACX_HD int crc_rem(const uint8_t* v, int n, int h, int poly, int deg) {
  int r = 0;
  for (int i = n - 1; i >= 0; --i) r = crc_mulx4(r, poly, deg) ^ v[i];
  for (int k = 0; k < 2 * h; ++k) r = crc_mulx4(r, poly, deg);
  return r;
}

ACX_HD int crc1_poly(int n_crc1) { return n_crc1 == 2 ? 0x4645 : 0x490F29; }
ACX_HD int crc1_deg(int n_crc1) { return n_crc1 == 2 ? 14 : 22; }

// the CRC1 remainder with the EPMR embedding (fec.py:_crc1_rem)
ACX_HD int crc1_rem(const uint8_t* v, int n, int n_crc1, int epmr) {
  const int poly = crc1_poly(n_crc1), deg = crc1_deg(n_crc1);
  int e = epmr << 2;
  for (int k = 0; k < 2 * n_crc1 - 1; ++k) e = crc_mulx4(e, poly, deg);
  return crc_rem(v, n, n_crc1, poly, deg) ^ e ^ (epmr << deg);
}

ACX_HD int crc2_rem(const uint8_t* v, int n) { return crc_rem(v, n, 2, 0x1A2EB, 16); }

// dw0_bitswap (al_fec.c:358-385); an involution
ACX_HD void fec_bitswap(uint8_t* dw, int ind0, int ind1) {
  const int a = dw[ind0], b = dw[ind1];
  dw[ind0] = static_cast<uint8_t>((a & 3) | ((b & 3) << 2));
  dw[ind1] = static_cast<uint8_t>((b & 12) | ((a >> 2) & 3));
}

ACX_HD const int32_t* fec_basis(const FecTables& tb, int hd) {
  return tb.w + kFecBasis + (hd == 3 ? 0 : (hd == 5 ? 1 : 2)) * 78;
}

// fec_encoder (al_fec.c:481-557) of one slot: data [data_bytes] bytes ->
// out [slot] bytes. dw and cw are scratch of kFecMaxNib nibbles.
ACX_HD void fec_encode_lane(const int32_t* data, int epmr, const FecTables& tb, int slot,
                            int mode, int ccc, uint8_t* dw, uint8_t* cw, int32_t* out) {
  const FecPlan p = fec_plan(slot, mode, ccc);
  const int D = p.data_bytes, c12 = 2 * (p.n_crc1 + p.n_crc2);
  epmr = iclamp(epmr, 0, 3);
  for (int j = 0; j < D; ++j) {
    const int byte = data[D - 1 - j] & 255;
    dw[c12 + 2 * j] = static_cast<uint8_t>(byte >> 4);
    dw[c12 + 2 * j + 1] = static_cast<uint8_t>(byte & 15);
  }
  const int rem1 = crc1_rem(dw + c12, p.crc1_n, p.n_crc1, epmr);
  for (int q = 0; q < 2 * p.n_crc1; ++q) dw[q] = static_cast<uint8_t>((rem1 >> (4 * q)) & 15);
  if (p.n_crc2) {
    const int rem2 = crc2_rem(dw + c12 + p.crc1_n, p.pc_split);
    for (int q = 0; q < 2 * p.n_crc2; ++q)
      dw[2 * p.n_crc1 + q] = static_cast<uint8_t>((rem2 >> (4 * q)) & 15);
  }
  fec_bitswap(dw, p.ind0, p.ind1);
  int k = 0, off = 0;
  for (int i = 0; i < p.ncw; ++i) {
    const int len = fec_cw_len(slot, i), red = p.red(i), nd = len - red;
    for (int j = 0; j < nd; ++j) cw[off + red + j] = dw[k + j];
    if (red > 0) {
      const int32_t* basis = fec_basis(tb, red + 1);
      for (int q = 0; q < red; ++q) {
        int par = 0;
        for (int c = 0; c < imin(nd, 13); ++c) par ^= tb.mul(dw[k + c], basis[c * 6 + q]);
        cw[off + q] = static_cast<uint8_t>(par);
      }
      if (i < 6)
        for (int q = 0; q < 13; ++q) cw[off + q] ^= tb.w[kFecSigPolys + (mode - 1) * 15 + q];
    }
    k += nd;
    off += len;
  }
  // interleave: codeword i position j -> nibble n_nib-1-(j*ncw+i)
  for (int b = 0; b < slot; ++b) out[b] = 0;
  off = 0;
  for (int i = 0; i < p.ncw; ++i) {
    const int len = fec_cw_len(slot, i);
    for (int j = 0; j < len; ++j) {
      const int o = p.n_nib - 1 - (j * p.ncw + i);
      out[o >> 1] |= cw[off + j] << (4 * (o & 1));
    }
    off += len;
  }
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

// The scratch of one decoding lane.
struct FecDecScratch {
  uint8_t cw[kFecMaxCw][16];   // codewords, column 15 a dump slot
  uint8_t dw[kFecMaxNib];      // data word of a mode
  uint8_t synd[kFecMaxCw][6];  // the six syndromes of each codeword
};

// the data word of plan p from the codewords (fec.py:fec_decode's flat/dw_pos
// gather and bit swap)
ACX_HD void fec_extract_dw(const FecDecScratch& sc, const FecPlan& p, uint8_t* dw) {
  int k = 0;
  for (int i = 0; i < p.ncw; ++i) {
    const int len = fec_cw_len(p.slot, i);
    for (int j = p.red(i); j < len; ++j) dw[k++] = sc.cw[i][j];
  }
  fec_bitswap(dw, p.ind0, p.ind1);
}

// the payload bytes of a data word (fec.py:_dw_to_bytes), zero padded
ACX_HD void fec_dw_bytes(const uint8_t* dw, const FecPlan& p, int32_t* data) {
  const int top = p.dw_len - 2 * p.data_bytes;
  for (int j = 0; j < p.data_bytes; ++j) {
    const int q = p.data_bytes - 1 - j;
    data[j] = dw[top + 2 * q] * 16 | dw[top + 2 * q + 1];
  }
  for (int j = p.data_bytes; j < p.slot; ++j) data[j] = 0;
}

// detection of codeword i < 6 under internal mode m (t = m + 1)
struct Det {
  Elp elp;
  int pos[3];
  bool fail;
};

ACX_HD Det fec_detect(const FecTables& tb, const FecDecScratch& sc, int slot, int m, int i) {
  int s[6];
  for (int k = 0; k < 6; ++k) s[k] = sc.synd[i][k] ^ tb.w[kFecSigSyndr + (m + 1) * 6 + k];
  Det d;
  d.elp = peterson(tb, s, m + 1);
  d.fail = chien(tb, d.elp, fec_cw_len(slot, i) - 1, d.pos);
  return d;
}

// the masked error magnitudes of a detection (fec.py: msk6)
ACX_HD void fec_det_errors(const FecTables& tb, const FecDecScratch& sc, const Det& d, int m,
                           int i, int* err) {
  int s[6];
  for (int k = 0; k < 6; ++k) s[k] = sc.synd[i][k] ^ tb.w[kFecSigSyndr + (m + 1) * 6 + k];
  forney(tb, d.pos, d.elp.deg, s, err);
  for (int jj = 0; jj < 3; ++jj)
    if (!(jj < d.elp.deg && !d.fail && d.elp.deg <= m + 1)) err[jj] = 0;
}

// codeword 0's EPMR bits once corrected under internal mode m (epmr_det)
ACX_HD int fec_epmr_det(const FecTables& tb, const FecDecScratch& sc, const Det& d0, int m,
                        int len0) {
  int err[3];
  fec_det_errors(tb, sc, d0, m, 0, err);
  int v = sc.cw[0][len0 - 1];
  for (int jj = 0; jj < 3; ++jj)
    if (d0.pos[jj] == len0 - 1) v ^= err[jj];
  return (v ^ tb.w[kFecSigPolys + (m + 1) * 15 + len0 - 1]) & 3;
}

// fec_decoder (al_fec.c:711-882) of one slot: frame [slot] bytes -> data
// [slot] bytes and out[k * stride] for the FecOut fields.
ACX_HD void fec_decode_lane(const int32_t* frame, int bfi_in, const FecTables& tb, int slot,
                            int ccc, FecDecScratch& sc, int32_t* data, int32_t* out,
                            int stride) {
  const int ncw = fec_ncw(slot), n_nib = 2 * slot, len0 = fec_cw_len(slot, 0);
  // unpack and deinterleave, then the syndromes
  for (int i = 0; i < ncw; ++i) {
    const int len = fec_cw_len(slot, i);
    for (int j = 0; j < 16; ++j) {
      int v = 0;
      if (j < len) {
        const int o = n_nib - 1 - (j * ncw + i);
        v = (frame[o >> 1] >> (4 * (o & 1))) & 15;
      }
      sc.cw[i][j] = static_cast<uint8_t>(v);
    }
    for (int k = 0; k < 6; ++k) {
      int acc = 0;
      for (int j = 0; j < 15; ++j) acc ^= tb.mul(sc.cw[i][j], tb.w[kFecSyndPow + k * 15 + j]);
      sc.synd[i][k] = static_cast<uint8_t>(acc);
    }
  }
  const int epmr_raw = sc.cw[0][len0 - 1] & 3;

  int bfi = 1, mode = -1, er = kBecMask, epmr = 0, data_bytes = 0, n_pc = 0, n_pccw = 0;
  int be_l = -1, be_r = -1;
  bool data_set = false;

  // stage 1: EP1 by codeword 0's syndromes and CRC1
  const bool ep1_syn_ok = (sc.synd[0][0] | sc.synd[0][1]) == 0;
  bool ep1_ok = false;
  if (ep1_syn_ok) {
    const FecPlan p1 = fec_plan(slot, 1, ccc);
    fec_extract_dw(sc, p1, sc.dw);
    const int rem = crc1_rem(sc.dw + 2 * p1.n_crc1, p1.crc1_n, p1.n_crc1, epmr_raw);
    ep1_ok = true;
    for (int q = 0; q < 2 * p1.n_crc1; ++q)
      if (sc.dw[q] != ((rem >> (4 * q)) & 15)) ep1_ok = false;
    if (ep1_ok) {
      fec_dw_bytes(sc.dw, p1, data);
      data_set = true;
      bfi = 0;
      mode = 1;
      er = kAllOk;
      epmr = epmr_raw;
      data_bytes = p1.data_bytes;
    }
  }

  if (!ep1_ok) {
    // stage 2: detection on codewords 0..5 under each internal mode
    bool clean[3], blacklist[3], chfail_any[3];
    int pm[3], pe[3];
    for (int m = 0; m < 3; ++m) {
      const int t = m + 1;
      clean[m] = true;
      blacklist[m] = false;
      chfail_any[m] = false;
      pm[m] = 16384;
      pe[m] = 0;
      for (int i = 0; i < 6; ++i) {
        for (int k = 0; k < 2 * t; ++k)
          if ((sc.synd[i][k] ^ tb.w[kFecSigSyndr + (m + 1) * 6 + k]) != 0) clean[m] = false;
        const Det d = fec_detect(tb, sc, slot, m, i);
        if (d.elp.deg > t) blacklist[m] = true;
        if (d.fail) chfail_any[m] = true;
        const int dc = iclamp(d.elp.deg, 0, 3);
        sf_mul(pm[m], pe[m], tb.w[kFecRiskM + (m + 1) * 4 + dc],
               tb.w[kFecRiskE + (m + 1) * 4 + dc]);
      }
    }
    int clean_m = -1;
    for (int m = 2; m >= 0; --m)
      if (clean[m]) clean_m = m;
    // candidate pick (al_fec.c:1190-1290)
    const int thr_m = slot <= 40 ? 21990 : 25166, thr_e = slot <= 40 ? -23 : -10;
    int sel_m = -1, sel_mant = 0, sel_e = 0;
    for (int m = 0; m < 3; ++m) {
      const bool viable = !blacklist[m] && sf_le(pm[m], pe[m], thr_m, thr_e) && !chfail_any[m];
      if (viable && (sel_m < 0 || sf_lt(pm[m], pe[m], sel_mant, sel_e))) {
        sel_m = m;
        sel_mant = pm[m];
        sel_e = pe[m];
      }
    }
    const int det_m = clean_m >= 0 ? clean_m : sel_m;

    // codeword 0 under the two upper modes: the EPMR estimate of a failure
    const Det d0_2 = fec_detect(tb, sc, slot, 1, 0), d0_3 = fec_detect(tb, sc, slot, 2, 0);
    const int epmr_det2 = fec_epmr_det(tb, sc, d0_2, 1, len0);
    const int epmr_det3 = fec_epmr_det(tb, sc, d0_3, 2, len0);

    if (det_m < 0) {
      // total failure (fec_estimate_epmr_from_cw0, al_fec.c:908-1010)
      const int ep2_s01 = (sc.synd[0][0] ^ tb.w[kFecSigSyndr + 6])
                          | (sc.synd[0][1] ^ tb.w[kFecSigSyndr + 7]);
      int est_exp = (ep1_syn_ok || ep2_s01 == 0) ? -8 : 0;
      const int dc2 = iclamp(d0_2.elp.deg, 0, 3), dc3 = iclamp(d0_3.elp.deg, 0, 3);
      const int re2 = tb.w[kFecRiskE + 2 * 4 + dc2], rm2 = tb.w[kFecRiskM + 2 * 4 + dc2];
      const int re3 = tb.w[kFecRiskE + 3 * 4 + dc3], rm3 = tb.w[kFecRiskM + 3 * 4 + dc3];
      const bool cand2 = d0_2.elp.deg <= 2 && re2 <= -8;
      const bool cand3 = d0_3.elp.deg <= 3 && re3 <= -8;
      const bool first_is_2 = (cand2 && cand3) ? sf_lt(rm2, re2, rm3, re3) : cand2;
      const bool pick2 = cand2 && !d0_2.fail, pick3 = cand3 && !d0_3.fail;
      const bool use2 = pick2 && (first_is_2 || !pick3);
      const bool use3 = pick3 && !use2;
      est_exp = use2 ? re2 : (use3 ? re3 : est_exp);
      const int base = use2 ? epmr_det2 : (use3 ? epmr_det3 : epmr_raw);
      epmr = base + 4 * (est_exp > -16 ? 1 : 0) + 4 * (est_exp > -8 ? 1 : 0);
    } else {
      // the detected mode: correct every codeword
      const int m = det_m, t = m + 1;
      const FecPlan p = fec_plan(slot, m + 2, ccc);
      int bits = 0, deg0 = 0;
      bool bfi1 = false, bfi2 = false, any_hardfail = false;
      bool broken[4] = {false, false, false, false};
      bool trust[kFecMaxCw];
      for (int i = 0; i < ncw; ++i) {
        int err[3], pos[3], deg;
        if (i < 6) {
          const Det d = fec_detect(tb, sc, slot, m, i);
          fec_det_errors(tb, sc, d, m, i, err);
          for (int jj = 0; jj < 3; ++jj) pos[jj] = d.pos[jj];
          deg = d.elp.deg;
          if (i == 0) deg0 = iclamp(deg, 0, 3);
          for (int b = 0; b < 4; ++b)
            if (b < m + 1 && deg > b) broken[b] = true;
        } else {
          int s[6];
          for (int k = 0; k < 6; ++k) s[k] = sc.synd[i][k];
          const Elp elp = peterson(tb, s, t);
          const bool chien_fail = chien(tb, elp, fec_cw_len(slot, i) - 1, pos);
          const bool hardfail = elp.deg > t || chien_fail;
          forney(tb, pos, elp.deg, s, err);
          for (int jj = 0; jj < 3; ++jj)
            if (!(jj < elp.deg && !hardfail)) err[jj] = 0;
          deg = elp.deg;
          const bool is_pc = i >= ncw - p.n_pccw;
          if (hardfail && !is_pc) bfi1 = true;
          if (hardfail && is_pc) bfi2 = true;
          if (hardfail) any_hardfail = true;
          trust[i] = !hardfail && !(tb.w[kFecRiskE + (m + 1) * 4 + iclamp(deg, 0, 3)] + 16 > 0);
          for (int b = 0; b < 4; ++b)
            if (b < m + 1 && deg > b) broken[b] = true;
        }
        for (int jj = 0; jj < 3; ++jj) {
          bits += tb.w[kFecBitcnt + err[jj]];
          sc.cw[i][imin(pos[jj], 15)] ^= static_cast<uint8_t>(err[jj]);
        }
        if (i < 6)
          for (int j = 0; j < 15; ++j)
            sc.cw[i][j] ^= static_cast<uint8_t>(tb.w[kFecSigPolys + (m + 1) * 15 + j]);
      }
      if (ncw > 6 && any_hardfail)
        for (int b = 0; b < 4; ++b) broken[b] = true;
      const int epmr_det = sc.cw[0][len0 - 1] & 3;
      fec_extract_dw(sc, p, sc.dw);
      const int tmp_epmr = sc.dw[2 * p.n_crc1 - 1] >> 2;
      const int c12 = 2 * (p.n_crc1 + p.n_crc2);
      const int remc = crc1_rem(sc.dw + c12, p.crc1_n, p.n_crc1, tmp_epmr);
      bool crc1_ok = true, crc2_ok = true;
      for (int q = 0; q < 2 * p.n_crc1; ++q)
        if (sc.dw[q] != ((remc >> (4 * q)) & 15)) crc1_ok = false;
      if (p.n_crc2) {
        const int rem2 = crc2_rem(sc.dw + p.dw_len - p.pc_split, p.pc_split);
        for (int q = 0; q < 2 * p.n_crc2; ++q)
          if (sc.dw[2 * p.n_crc1 + q] != ((rem2 >> (4 * q)) & 15)) crc2_ok = false;
      }
      // EPMR of the corrected path (al_fec.c:1177,1359-1370)
      const int exp0 = tb.w[kFecRiskE + (m + 1) * 4 + deg0];
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
          if (!trust[ncw - 1 - q]) {
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
        fec_dw_bytes(sc.dw, p, data);
        data_set = true;
        data_bytes = p.data_bytes;
      }
      n_pc = p.pc_split;
      n_pccw = p.n_pccw;
      if (mode < 0) n_pc = n_pccw = 0;
      if (bfi != 2) be_l = be_r = -1;
    }
  }
  if (!data_set)
    for (int j = 0; j < slot; ++j) data[j] = 0;
  if (bfi_in == 1) {
    bfi = 1;
    er = -1;
    data_bytes = 0;
    mode = -1;
  }
  out[FEC_DATA_BYTES * stride] = data_bytes;
  out[FEC_BFI * stride] = bfi;
  out[FEC_EPMR * stride] = epmr;
  out[FEC_ERROR_REPORT * stride] = er;
  out[FEC_MODE * stride] = mode;
  out[FEC_N_PCCW * stride] = n_pccw;
  out[FEC_N_PC * stride] = n_pc;
  out[FEC_BE_LEFT * stride] = be_l;
  out[FEC_BE_RIGHT * stride] = be_r;
}

}  // namespace acx
