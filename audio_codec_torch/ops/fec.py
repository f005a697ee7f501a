"""LC3plus channel coder (error protection): batched GF(16) Reed-Solomon.

The counterpart of `audio_codec_tpu/ops/fec.py` (fec_encoder, al_fec.c:481;
fec_decoder, al_fec.c:711). `fec_encode` and `fec_decode` launch the CUDA
kernels `fec_encode` and `fec_decode` (csrc/fec_encode.cu, csrc/fec_decode.cu)
for tensors on the card and run the plain versions below for tensors on the
CPU.

The first half of this module is host code, numpy only: the GF(16) tables,
the RS generator bases, the CRC position tables and the static slot and mode
plans (get_n_codewords, get_codeword_length, fec_get_data_size,
fec_get_n_pc, fec_get_n_pccw, al_fec.c:200-357). It is a copy of the
reference module's host half, which cannot be shared because importing that
module imports JAX; `config.py` takes the slot geometry from here.

The plain versions follow the reference's batched formulation step for step
(every lane runs every candidate mode and a lexicographic pick replaces the
reference's sort-and-try loop), in int64 on [B, ...] tensors; XOR
reductions are written as per-bit parities.
"""
from __future__ import annotations

import functools

import numpy as np
import torch

from .. import kernels
from . import numerics as nm

I32 = torch.int32
I64 = torch.int64

RS16_CW_LEN_MAX = 15
FEC_SLOT_BYTES_MIN = 40
FEC_SLOT_BYTES_MAX = 300

# error report flags (al_fec.c:42-48)
BEC_MASK = 0x0FFF >> 1
EP_OK = tuple((0x1000 << i) >> 1 for i in range(4))
ALL_OK = EP_OK[0] | EP_OK[1] | EP_OK[2] | EP_OK[3]

# ---------------------------------------------------------------------------
# host half: GF(16) tables (poly x^4+x+1, generator g = 2; al_fec.c:71-86)
# ---------------------------------------------------------------------------


def _gf_mul_scalar(a: int, b: int) -> int:
    r = 0
    for _ in range(4):
        if b & 1:
            r ^= a
        b >>= 1
        a <<= 1
        if a & 16:
            a ^= 0b10011
    return r


_MUL = np.array([[_gf_mul_scalar(a, b) for b in range(16)] for a in range(16)], np.int32)
G_POW = np.ones(15, np.int32)
for _i in range(1, 15):
    G_POW[_i] = _gf_mul_scalar(int(G_POW[_i - 1]), 2)
G_LOG = np.zeros(16, np.int32)
for _i in range(15):
    G_LOG[G_POW[_i]] = _i
_INV = np.zeros(16, np.int32)
for _a in range(1, 16):
    _INV[_a] = G_POW[(15 - G_LOG[_a]) % 15]


def _gf_poly_mul(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    out = np.zeros(len(a) + len(b) - 1, np.int32)
    for i, ai in enumerate(a):
        for j, bj in enumerate(b):
            out[i + j] ^= _gf_mul_scalar(int(ai), int(bj))
    return out


def _gp_for_hd(hd: int) -> np.ndarray:
    """RS16 generator polynomial with roots g^1..g^(hd-1), low-to-high
    coefficients (rs16_gp_d3/d5/d7, al_fec.c:89-91)."""
    gp = np.array([1], np.int32)
    for j in range(1, hd):
        gp = _gf_poly_mul(gp, np.array([G_POW[j % 15], 1], np.int32))
    return gp


@functools.cache
def _rs_basis(hd: int, max_data: int) -> np.ndarray:
    """basis[i, k]: coefficient k of (x^(d+i) mod gp), d = hd-1: the parity
    of a data word is XOR_i gf_mul(data_i, basis[i]) (systematic rs16_enc)."""
    d = hd - 1
    gp = _gp_for_hd(hd)
    basis = np.zeros((max_data, max(d, 1)), np.int32)
    rem = np.zeros(d + 1, np.int32)
    rem[d] = 1
    for i in range(max_data):
        lead = rem[d]
        r = rem.copy()
        r[d] = 0
        for k in range(d):
            r[k] ^= _gf_mul_scalar(int(lead), int(gp[k]))
        basis[i] = r[:d] if d else np.zeros(0, np.int32)
        rem = np.concatenate([[0], r[:d]])
        rem = np.append(rem, 0)[: d + 1]
    return basis


# syndrome evaluation points: S_k = cw(g^(k+1)), k = 0..5
_SYND_POW = np.array([[G_POW[((k + 1) * i) % 15] for i in range(15)] for k in range(6)],
                     np.int32)

# mode signalling polynomials, coefficients 0..12 (al_fec.c:97-100); row
# m-1 is XORed onto the first 13 nibbles of the first six codewords in EP
# mode m (mode 1's polynomial is zero)
_SIG_POLYS = np.zeros((4, 15), np.int32)
_SIG_POLYS[1, :13] = [7, 15, 5, 6, 14, 9, 1, 3, 12, 10, 13, 3, 2]
_SIG_POLYS[2, :13] = [7, 11, 14, 1, 2, 3, 12, 11, 6, 15, 7, 6, 12]
_SIG_POLYS[3, :13] = [6, 15, 12, 2, 9, 15, 2, 8, 12, 3, 10, 5, 4]

# syndromes of the signalling polynomials (sig_poly_syndr, al_fec.c:102-105)
_SIG_SYNDR = np.zeros((4, 6), np.int32)
for _m in range(4):
    for _k in range(6):
        _acc = 0
        for _i in range(15):
            _acc ^= _gf_mul_scalar(int(_SIG_POLYS[_m, _i]), int(_SYND_POW[_k, _i]))
        _SIG_SYNDR[_m, _k] = _acc

# fec configuration (al_fec.c:115-134)
_HD_MODE0 = (1, 3, 3, 5, 7)   # first codeword, by external mode
_HD_MODE1 = (1, 1, 3, 5, 7)   # the other codewords
_CRC1_BYTES_40 = (0, 3, 2, 2, 2)
_CRC1_BYTES = (0, 3, 3, 3, 3)
_CRC2_BYTES = (0, 0, 2, 2, 2)
_LOW_BR_MAX_BIT_ERRORS = (0, 0, 3, 9, 18)

# risk table: simple_float (mantissa, exponent) pairs; rows = internal mode
# (EP m+1), columns = corrected symbols (al_fec.c:129-133)
_RISK_M = np.array([[16384, 16384, 16384, 16384],
                    [16384, 26880, 16384, 16384],
                    [16384, 26880, 20475, 16384],
                    [16384, 26880, 20475, 19195]], np.int32)
_RISK_E = np.array([[0, 0, 0, 0],
                    [-8, -1, 0, 0],
                    [-16, -9, -2, 0],
                    [-24, -17, -10, -4]], np.int32)

# mode-detection risk thresholds (al_fec.c:54-57)
_EP_RISK_THRESH_NS = (21990, -23)
_EP_RISK_THRESH_OS = (25166, -10)

# CRC generator polynomials (degree 14/22 with the EPMR embedding, degree 16)
_CRC1_POLY = {2: (0x4645, 14), 3: (0x490F29, 22)}
_CRC2_POLY = {2: (0x1A2EB, 16)}
_BITCNT = np.array([0, 1, 1, 2, 1, 2, 2, 3, 1, 2, 2, 3, 2, 3, 3, 4], np.int32)


def _clmod(a: int, p: int) -> int:
    deg_p = p.bit_length() - 1
    while a.bit_length() - 1 >= deg_p:
        a ^= p << (a.bit_length() - 1 - deg_p)
    return a


def _crc_pos_table(n_nibbles: int, hash_bytes: int, poly: int) -> np.ndarray:
    """tab[i, v]: contribution of data nibble v at index i to the CRC
    remainder, v * x^(4*(i + 2*hash_bytes)) mod P (al_fec.c:2222-2246)."""
    tab = np.zeros((max(n_nibbles, 1), 16), np.int64)
    for i in range(n_nibbles):
        sh = 4 * (i + 2 * hash_bytes)
        for v in range(16):
            tab[i, v] = _clmod(v << sh, poly)
    return tab.astype(np.int32)


def _crc1_epmr_table(hash_bytes: int, poly: int, shift: int) -> np.ndarray:
    """The EPMR injection's contribution plus the raw EPMR bits placed above
    the CRC (al_fec.c:2230-2246)."""
    tab = np.zeros(4, np.int64)
    for e in range(4):
        tab[e] = _clmod((e << 2) << (4 * (2 * hash_bytes - 1)), poly) ^ (e << shift)
    return tab.astype(np.int32)


# ---------------------------------------------------------------------------
# host half: static slot geometry (al_fec.c:200-357)
# ---------------------------------------------------------------------------


def n_codewords(slot_bytes: int) -> int:
    return (2 * slot_bytes + RS16_CW_LEN_MAX - 1) // RS16_CW_LEN_MAX


def codeword_length(slot_bytes: int, i: int) -> int:
    return (2 * slot_bytes - i - 1) // n_codewords(slot_bytes) + 1


def crc1_bytes(mode: int, slot_bytes: int) -> int:
    return (_CRC1_BYTES_40 if slot_bytes == 40 else _CRC1_BYTES)[mode]


def fec_get_n_pccw(slot_bytes: int, mode: int, ccc_flag: int) -> int:
    if mode == 3:
        n = (2 * 2636 * slot_bytes - 117377 + 0x8000) >> 16
    elif mode == 4:
        n = (2 * 2178 * slot_bytes - 129115 + 0x8000) >> 16
    else:
        n = 0
    if ccc_flag == 1 or slot_bytes < 80:
        n = 0
    return n


def fec_get_n_pc(mode: int, n_pccw: int, slot_bytes: int) -> int:
    ncw = n_codewords(slot_bytes)
    if mode == 1 or slot_bytes < 80:
        return 0
    return -2 * n_pccw * (mode - 1) + sum((2 * slot_bytes + i) // ncw for i in range(n_pccw))


def fec_get_data_size(mode: int, ccc_flag: int, slot_bytes: int) -> int:
    payload = slot_bytes
    if mode > 0:
        payload -= 1 if mode == 1 else n_codewords(slot_bytes) * (mode - 1)
        payload -= crc1_bytes(mode, slot_bytes)
        if ccc_flag == 0 and mode > 2 and slot_bytes >= 80:
            payload -= _CRC2_BYTES[mode]
    return payload


@functools.cache
def _slot_plan(slot_bytes: int) -> dict:
    """Index maps shared by all modes of one slot size."""
    if not FEC_SLOT_BYTES_MIN <= slot_bytes <= FEC_SLOT_BYTES_MAX:
        raise ValueError(f"slot of {slot_bytes} bytes outside [{FEC_SLOT_BYTES_MIN}, "
                         f"{FEC_SLOT_BYTES_MAX}]")
    ncw = n_codewords(slot_bytes)
    n_nib = 2 * slot_bytes
    lens = np.array([codeword_length(slot_bytes, i) for i in range(ncw)], np.int32)
    offs = np.concatenate([[0], np.cumsum(lens)[:-1]]).astype(np.int32)
    # interleave: codeword i position j <-> output nibble n_nib-1-(j*ncw+i)
    il_src = np.zeros(n_nib, np.int32)
    for i in range(ncw):
        for j in range(lens[i]):
            il_src[n_nib - 1 - (j * ncw + i)] = offs[i] + j
    il_dst = np.argsort(il_src).astype(np.int32)
    cw_gather = np.full((ncw, RS16_CW_LEN_MAX), n_nib, np.int32)
    for i in range(ncw):
        cw_gather[i, :lens[i]] = offs[i] + np.arange(lens[i])
    flat_i = np.zeros(n_nib, np.int32)
    flat_j = np.zeros(n_nib, np.int32)
    for i in range(ncw):
        flat_i[offs[i]: offs[i] + lens[i]] = i
        flat_j[offs[i]: offs[i] + lens[i]] = np.arange(lens[i])
    return dict(ncw=ncw, n_nib=n_nib, lens=lens, offs=offs, il_src=il_src, il_dst=il_dst,
                cw_gather=cw_gather, flat_i=flat_i, flat_j=flat_j)


@functools.cache
def _mode_plan(slot_bytes: int, mode: int, ccc_flag: int) -> dict:
    """Per (slot, external mode) layout: redundancy nibbles per codeword,
    data-word maps, CRC tables, bit-swap indices."""
    sp = _slot_plan(slot_bytes)
    ncw, n_nib = sp["ncw"], sp["n_nib"]
    hd0, hd1 = _HD_MODE0[mode], _HD_MODE1[mode]
    red = np.array([hd0 - 1] + [hd1 - 1] * (ncw - 1), np.int32)
    data_bytes = fec_get_data_size(mode, ccc_flag, slot_bytes)
    n_crc1 = crc1_bytes(mode, slot_bytes)
    n_pccw = fec_get_n_pccw(slot_bytes, mode, ccc_flag)
    pc_split = fec_get_n_pc(mode, n_pccw, slot_bytes)
    n_crc2 = _CRC2_BYTES[mode] if (pc_split > 0 and mode > 1) else 0
    dw_len = n_nib - int(red.sum())
    assert dw_len == 2 * (data_bytes + n_crc1 + n_crc2)
    dw_pos = np.zeros(dw_len, np.int32)
    k = 0
    for i in range(ncw):
        for j in range(red[i], sp["lens"][i]):
            dw_pos[k] = sp["offs"][i] + j
            k += 1
    data_gather = np.full((ncw, RS16_CW_LEN_MAX), dw_len, np.int32)
    k = 0
    for i in range(ncw):
        nd = sp["lens"][i] - red[i]
        data_gather[i, :nd] = k + np.arange(nd)
        k += nd
    par_pos = np.full((ncw, 6), n_nib, np.int32)
    for i in range(ncw):
        par_pos[i, :red[i]] = sp["offs"][i] + np.arange(red[i])
    cw0_len = int(sp["lens"][0])
    c1_poly, c1_shift = _CRC1_POLY[n_crc1] if n_crc1 else (0, 0)
    crc1_n = 2 * data_bytes - pc_split
    sig = np.zeros(n_nib, np.int32)
    for i in range(min(6, ncw)):
        if red[i] > 0:
            sig[sp["offs"][i]: sp["offs"][i] + 13] = _SIG_POLYS[mode - 1, :13]
    return dict(
        sp=sp, mode=mode, red=red, data_bytes=data_bytes, n_crc1=n_crc1, n_crc2=n_crc2,
        n_pccw=n_pccw, pc_split=pc_split, dw_len=dw_len, dw_pos=dw_pos,
        data_gather=data_gather, par_pos=par_pos, ind0=2 * n_crc1 - 1,
        ind1=cw0_len - 1 - (hd0 - 1),
        basis0=_rs_basis(hd0, 13) if hd0 > 1 else None,
        basis1=_rs_basis(hd1, 13) if hd1 > 1 else None,
        crc1_n=crc1_n,
        crc1_tab=_crc_pos_table(crc1_n, n_crc1, c1_poly) if n_crc1 else None,
        crc1_epmr=_crc1_epmr_table(n_crc1, c1_poly, c1_shift) if n_crc1 else None,
        crc2_tab=_crc_pos_table(pc_split, n_crc2, _CRC2_POLY[2][0]) if n_crc2 else None,
        pc_nib=np.array([fec_get_n_pc(mode, k, slot_bytes) for k in range(n_pccw + 2)],
                        np.int32),
        sig=sig)


# ---------------------------------------------------------------------------
# device copies of the tables and plans, made once per device
# ---------------------------------------------------------------------------

_CONSTS = dict(mul=_MUL.reshape(-1), inv=_INV, g_pow=G_POW, synd_pow=_SYND_POW,
               sig_polys=_SIG_POLYS, sig_syndr=_SIG_SYNDR, risk_m=_RISK_M, risk_e=_RISK_E,
               bitcnt=_BITCNT, low_br=np.array(_LOW_BR_MAX_BIT_ERRORS, np.int32))


def _const_np(name: str) -> np.ndarray:
    return _CONSTS[name]


def _slot_np(slot_bytes: int, key: str) -> np.ndarray:
    return _slot_plan(slot_bytes)[key]


def _mode_np(slot_bytes: int, mode: int, ccc_flag: int, key: str) -> np.ndarray:
    return _mode_plan(slot_bytes, mode, ccc_flag)[key]


def _c(name: str, dev) -> torch.Tensor:
    return nm.table(_const_np, name, device=dev, dtype=I64)


def _sp(slot_bytes: int, key: str, dev) -> torch.Tensor:
    return nm.table(_slot_np, slot_bytes, key, device=dev, dtype=I64)


def _mp(mp: dict, ccc_flag: int, key: str, dev) -> torch.Tensor:
    return nm.table(_mode_np, mp["sp"]["n_nib"] // 2, mp["mode"], ccc_flag, key, device=dev,
                    dtype=I64)


# ---------------------------------------------------------------------------
# plain versions: batched primitives
# ---------------------------------------------------------------------------


def _xor_reduce(v: torch.Tensor, dim: int, bits: int) -> torch.Tensor:
    """XOR of v along dim, as the parity of each of the low `bits` bits."""
    out = torch.zeros_like(v.select(dim, 0))
    for b in range(bits):
        out = out | ((((v >> b) & 1).sum(dim) & 1) << b)
    return out


def _gf_mul(a, b, dev):
    return torch.take(_c("mul", dev), a * 16 + b)


def _gf_inv(a, dev):
    return torch.take(_c("inv", dev), a)


def _bytes_to_dw(data):
    """[B, D] bytes -> [B, 2D] reversed nibble stream (fec_data_preproc)."""
    rev = data.flip(1)
    return torch.stack([rev >> 4, rev & 15], dim=-1).reshape(data.shape[0], -1)


def _dw_to_bytes(dw, data_bytes: int):
    """Inverse of _bytes_to_dw over the top 2*data_bytes nibbles."""
    top = dw[:, dw.shape[1] - 2 * data_bytes:]
    pairs = top.reshape(dw.shape[0], data_bytes, 2).flip(1)
    return (pairs[:, :, 0] * 16) | pairs[:, :, 1]


def _crc_eval(tab, nibbles):
    """XOR-reduce of per-position contributions. tab [n, 16], nibbles [B, n]."""
    idx = torch.arange(tab.shape[0], device=nibbles.device)[None, :] * 16 + nibbles
    return _xor_reduce(torch.take(tab.reshape(-1), idx), 1, 24)


def _crc1_rem(mp, ccc_flag, nibbles, epmr):
    """CRC1 remainder with the EPMR embedding (al_fec.c:2185-2251)."""
    dev = nibbles.device
    rem = _crc_eval(_mp(mp, ccc_flag, "crc1_tab", dev), nibbles)
    return rem ^ torch.take(_mp(mp, ccc_flag, "crc1_epmr", dev), epmr)


def _rem_to_hash(rem, hash_bytes: int):
    """[B] remainder -> [B, 2*hash_bytes] nibbles, least significant first."""
    sh = 4 * torch.arange(2 * hash_bytes, device=rem.device)
    return (rem[:, None] >> sh[None, :]) & 15


def _bitswap(dw, ind0: int, ind1: int):
    """Swap bits 2,3 of dw[ind0] with bits 0,1 of dw[ind1] (dw0_bitswap,
    al_fec.c:358-385); an involution."""
    a, b = dw[:, ind0], dw[:, ind1]
    dw = dw.clone()
    dw[:, ind0] = (a & 3) | ((b & 3) << 2)
    dw[:, ind1] = (b & 12) | ((a >> 2) & 3)
    return dw


def _rs_parity(mp, ccc_flag, dw):
    """Per-codeword RS parity nibbles through the linear basis: [B, ncw, 6]."""
    B, dev = dw.shape[0], dw.device
    ncw = mp["sp"]["ncw"]
    dwp = torch.cat([dw, torch.zeros((B, 1), dtype=I64, device=dev)], dim=1)
    cw_data = dwp[:, _mp(mp, ccc_flag, "data_gather", dev)]           # [B, ncw, 15]
    out = torch.zeros((B, ncw, 6), dtype=I64, device=dev)
    for key, rows in (("basis0", slice(0, 1)), ("basis1", slice(1, ncw))):
        if mp[key] is None:
            continue
        bas = _mp(mp, ccc_flag, key, dev)                              # [13, d]
        prod = _gf_mul(cw_data[:, rows, :13, None], bas[None, None], dev)
        out[:, rows, : bas.shape[1]] = _xor_reduce(prod, 2, 4)
    return out


def _syndromes6(cw_mat):
    """All six syndromes of every codeword: [B, ncw, 15] -> [B, ncw, 6]."""
    dev = cw_mat.device
    prod = _gf_mul(cw_mat[:, :, None, :], _c("synd_pow", dev)[None, None], dev)
    return _xor_reduce(prod, 3, 4)


def _peterson_elp(s, t: int):
    """Error-locator polynomial by Peterson's algorithm without branches
    (rs16_calculate_elp, al_fec.c:1794-1976). s [..., 6] -> (elp [..., 4]
    with elp0 = 1, deg [...]); deg = t+1 flags a failure."""
    dev = s.device
    mul = lambda a, b: _gf_mul(a, b, dev)
    inv = lambda a: _gf_inv(a, dev)
    z = torch.zeros_like(s[..., 0])
    s0, s1 = s[..., 0], s[..., 1]
    all_zero = (s0 | s1) == 0
    if t >= 2:
        all_zero &= (s[..., 2] | s[..., 3]) == 0
    if t >= 3:
        all_zero &= (s[..., 4] | s[..., 5]) == 0

    e1_1 = mul(s1, inv(s0))
    lsf1 = z
    for k in range(1, 2 * t - 1):
        lsf1 = lsf1 | (mul(e1_1, s[..., k]) ^ s[..., k + 1])
    commit1 = s0 != 0
    ok1 = commit1 & (lsf1 == 0) & (e1_1 != 0)
    deg = torch.where(commit1, torch.where(ok1, 1, t + 1), t + 1)
    elp1 = torch.where(ok1, e1_1, z)
    elp2, elp3 = z, z

    if t >= 2:
        det2 = mul(s0, s[..., 2]) ^ mul(s1, s1)
        di2 = inv(det2)
        e1_2 = mul(mul(s1, s[..., 2]) ^ mul(s0, s[..., 3]), di2)
        e2_2 = mul(mul(s[..., 2], s[..., 2]) ^ mul(s1, s[..., 3]), di2)
        lsf2 = z
        for k in range(2, 2 * t - 2):
            lsf2 = lsf2 | (mul(e2_2, s[..., k]) ^ mul(e1_2, s[..., k + 1]) ^ s[..., k + 2])
        commit2 = det2 != 0
        ok2 = commit2 & (lsf2 == 0) & (e2_2 != 0)
        deg = torch.where(commit2, torch.where(ok2, 2, t + 1), deg)
        elp1 = torch.where(commit2, torch.where(ok2, e1_2, 0), elp1)
        elp2 = torch.where(commit2, torch.where(ok2, e2_2, 0), elp2)

    if t >= 3:
        s2, s3, s4, s5 = s[..., 2], s[..., 3], s[..., 4], s[..., 5]
        s22, s33, s44, s13 = mul(s1, s1), mul(s2, s2), mul(s3, s3), mul(s0, s2)
        det3 = mul(s13, s4) ^ mul(s44, s0) ^ mul(s22, s4) ^ mul(s33, s2)
        di3 = inv(det3)
        s14, s15 = mul(s0, s3), mul(s0, s4)
        s23, s24, s25 = mul(s1, s2), mul(s1, s3), mul(s1, s4)
        s34, s35 = mul(s2, s3), mul(s2, s4)
        a, b, c = s35 ^ s44, s15 ^ s33, s13 ^ s22
        d, e, f = s34 ^ s25, s23 ^ s14, s24 ^ s33
        e3_3 = mul(mul(a, s3) ^ mul(d, s4) ^ mul(f, s5), di3)
        e2_3 = mul(mul(d, s3) ^ mul(b, s4) ^ mul(e, s5), di3)
        e1_3 = mul(mul(f, s3) ^ mul(e, s4) ^ mul(c, s5), di3)
        commit3 = det3 != 0
        ok3 = commit3 & (e3_3 != 0)
        deg = torch.where(commit3, torch.where(ok3, 3, t + 1), deg)
        elp1 = torch.where(commit3, torch.where(ok3, e1_3, 0), elp1)
        elp2 = torch.where(commit3, torch.where(ok3, e2_3, 0), elp2)
        elp3 = torch.where(commit3, torch.where(ok3, e3_3, 0), elp3)

    deg = torch.where(all_zero, 0, deg)
    elp = [torch.where(all_zero, 0, e) for e in (elp1, elp2, elp3)]
    return torch.stack([torch.ones_like(z)] + elp, dim=-1), deg


def _chien(elp, deg, max_pos):
    """Chien search over the 15 field points (rs16_factorize_elp,
    al_fec.c:1981). Returns (fail [...], err_pos [..., 3], 15 = none)."""
    dev = elp.device
    mul = lambda a, b: _gf_mul(a, b, dev)
    X = _c("g_pow", dev)
    X2 = mul(X, X)
    X3 = mul(X2, X)
    val = X3 ^ mul(elp[..., 1:2], X2) ^ mul(elp[..., 2:3], X) ^ elp[..., 3:4]
    is_root = (val == 0) & (deg[..., None] > 0)
    n_roots = is_root.to(I64).sum(-1)
    pos = torch.arange(15, device=dev)
    err_pos = torch.sort(torch.where(is_root, pos, 15), dim=-1).values[..., :3]
    in_range = torch.where(torch.arange(3, device=dev) < deg[..., None],
                           err_pos <= max_pos[..., None], True)
    fail = ((n_roots != deg) | ~in_range.all(-1)) & (deg > 0)
    return fail, err_pos


def _forney(err_pos, deg, s):
    """Error magnitudes by Cramer's rule on sum_i e_i X_i^(k+1) = S_k
    (rs16_calculate_errors, al_fec.c:2079-2172): [..., 3]."""
    dev = s.device
    mul = lambda a, b: _gf_mul(a, b, dev)
    inv = lambda a: _gf_inv(a, dev)
    Xp = torch.take(_c("g_pow", dev), err_pos % 15)
    X0, X1, X2 = Xp[..., 0], Xp[..., 1], Xp[..., 2]
    s0, s1, s2 = s[..., 0], s[..., 1], s[..., 2]
    e0_1 = mul(inv(X0), s0)
    x0q, x1q, x2q = mul(X0, X0), mul(X1, X1), mul(X2, X2)
    di2 = inv(mul(x0q, X1) ^ mul(x1q, X0))
    e0_2 = mul(mul(x1q, s0) ^ mul(X1, s1), di2)
    e1_2 = mul(mul(x0q, s0) ^ mul(X0, s1), di2)
    di3 = inv(mul(mul(X1 ^ X0, X2 ^ X0), X2 ^ X1))

    def _e(xa, xb, xaq, xbq, xo):
        num = mul(mul(xa, xbq) ^ mul(xb, xaq), s0) ^ mul(xbq ^ xaq, s1) ^ mul(xb ^ xa, s2)
        return mul(mul(num, di3), inv(xo))

    e0_3 = _e(X1, X2, x1q, x2q, X0)
    e1_3 = _e(X0, X2, x0q, x2q, X1)
    e2_3 = _e(X0, X1, x0q, x1q, X2)
    e0 = torch.where(deg == 1, e0_1, torch.where(deg == 2, e0_2, e0_3))
    e1 = torch.where(deg == 2, e1_2, e1_3)
    z = torch.zeros_like(e0)
    return torch.stack([torch.where(deg >= 1, e0, z), torch.where(deg >= 2, e1, z),
                        torch.where(deg >= 3, e2_3, z)], dim=-1)


def _sf_mul(m1, e1, m2, e2):
    """simple_float product (al_fec.c:2310-2377)."""
    aux = (m1 * m2) >> 14
    hi = (aux & 32768) != 0
    return torch.where(hi, aux >> 1, aux), torch.where(hi, e1 + e2 + 1, e1 + e2)


def _sf_le(m1, e1, m2, e2):
    return (e1 < e2) | ((e1 == e2) & (m1 <= m2))


def _sf_lt(m1, e1, m2, e2):
    return (e1 < e2) | ((e1 == e2) & (m1 < m2))


# ---------------------------------------------------------------------------
# encoder (fec_encoder, al_fec.c:481-557)
# ---------------------------------------------------------------------------


def fec_encode_plain(data, epmr, slot_bytes: int, mode: int, ccc_flag: int = 0):
    """Plain version of the `fec_encode` kernel. data: [B, data_bytes]
    payload bytes (data_bytes = fec_get_data_size(mode, ccc_flag,
    slot_bytes)); epmr: [B] in 0..3. Returns [B, slot_bytes] int32."""
    mp = _mode_plan(slot_bytes, mode, ccc_flag)
    sp = mp["sp"]
    if data.shape[1] != mp["data_bytes"]:
        raise ValueError(f"fec_encode: {data.shape[1]} payload bytes, the slot of "
                         f"{slot_bytes} bytes at EP{mode} takes {mp['data_bytes']}")
    B, dev = data.shape[0], data.device
    data = data.to(I64)
    epmr = epmr.to(I64).clamp(0, 3)
    dwd = _bytes_to_dw(data)
    n_pc = mp["pc_split"]
    parts = []
    if mp["n_crc1"]:
        rem1 = _crc1_rem(mp, ccc_flag, dwd[:, : dwd.shape[1] - n_pc], epmr)
        parts.append(_rem_to_hash(rem1, mp["n_crc1"]))
    if mp["n_crc2"]:
        rem2 = _crc_eval(_mp(mp, ccc_flag, "crc2_tab", dev), dwd[:, dwd.shape[1] - n_pc:])
        parts.append(_rem_to_hash(rem2, mp["n_crc2"]))
    dw = _bitswap(torch.cat(parts + [dwd], dim=1), mp["ind0"], mp["ind1"])
    parity = _rs_parity(mp, ccc_flag, dw)
    cw = torch.zeros((B, sp["n_nib"] + 1), dtype=I64, device=dev)
    cw[:, _mp(mp, ccc_flag, "dw_pos", dev)] = dw
    par_pos = _mp(mp, ccc_flag, "par_pos", dev).reshape(-1)
    cw[:, par_pos] = parity.reshape(B, -1)       # padded columns land in the last slot
    cw = cw[:, : sp["n_nib"]] ^ _mp(mp, ccc_flag, "sig", dev)
    nib = cw[:, _sp(slot_bytes, "il_src", dev)].reshape(B, slot_bytes, 2)
    return (nib[:, :, 0] | (nib[:, :, 1] << 4)).to(I32)


# ---------------------------------------------------------------------------
# decoder (fec_decoder, al_fec.c:711-882; rs16_detect_and_correct,
# al_fec.c:1014-1463)
# ---------------------------------------------------------------------------

DECODE_FIELDS = ("data", "data_bytes", "bfi", "epmr", "error_report", "mode", "n_pccw",
                 "n_pc", "be_bp_left", "be_bp_right")


def _scatter_xor(cw_p, epos, errs):
    """XOR errs into cw_p [B, C, 16] at epos [B, C, 3] (column 15 takes the
    masked positions)."""
    for jj in range(3):
        pos = epos[:, :, jj].clamp(max=15)[..., None]
        cur = torch.gather(cw_p, 2, pos)
        cw_p = cw_p.scatter(2, pos, cur ^ errs[:, :, jj: jj + 1])
    return cw_p


def fec_decode_plain(frames, slot_bytes: int, ccc_flag: int = 0, bfi_in=None):
    """Plain version of the `fec_decode` kernel: mode detection, RS
    correction and the CRC checks. frames: [B, slot_bytes] bytes. Returns
    the dict of `audio_codec_tpu.ops.fec.fec_decode` (DECODE_FIELDS), int32:
    data [B, slot_bytes] (payload left-aligned, zero padded), data_bytes,
    bfi (0/1/2), epmr (0..11), error_report, mode (1..4 or -1), n_pccw,
    n_pc, be_bp_left, be_bp_right."""
    sp = _slot_plan(slot_bytes)
    mps = {m: _mode_plan(slot_bytes, m, ccc_flag) for m in (1, 2, 3, 4)}
    ncw, n_nib = sp["ncw"], sp["n_nib"]
    cw0_len = int(sp["lens"][0])
    B, dev = frames.shape[0], frames.device
    frames = frames.to(I64)
    tt = (1, 2, 3)
    risk_m, risk_e = _c("risk_m", dev), _c("risk_e", dev)
    mp_ = lambda m, key: _mp(mps[m], ccc_flag, key, dev)
    ar = lambda n: torch.arange(n, device=dev)
    full = lambda v: torch.full((B,), v, dtype=I64, device=dev)

    # unpack and deinterleave (fec_deinterleave_unpack, al_fec.c:884)
    nib = torch.stack([frames & 15, frames >> 4], dim=-1).reshape(B, n_nib)
    cws = nib[:, _sp(slot_bytes, "il_dst", dev)]
    cw_pad = torch.cat([cws, torch.zeros((B, 1), dtype=I64, device=dev)], dim=1)
    cw_mat = cw_pad[:, _sp(slot_bytes, "cw_gather", dev)]            # [B, ncw, 15]
    synd6 = _syndromes6(cw_mat)                                       # [B, ncw, 6]
    epmr_raw = cw_mat[:, 0, cw0_len - 1] & 3

    # stage 1: EP1 by codeword 0's syndromes and CRC1 (al_fec.c:1102)
    mp1 = mps[1]
    ep1_syn_ok = (synd6[:, 0, 0] | synd6[:, 0, 1]) == 0
    dw1u = _bitswap(cws[:, mp_(1, "dw_pos")], mp1["ind0"], mp1["ind1"])
    hash1 = _rem_to_hash(_crc1_rem(mp1, ccc_flag, dw1u[:, 2 * mp1["n_crc1"]:], epmr_raw),
                         mp1["n_crc1"])
    ep1_ok = ep1_syn_ok & (dw1u[:, : 2 * mp1["n_crc1"]] == hash1).all(1)

    # stage 2: per-mode syndromes of codewords 0..5 (al_fec.c:1130)
    synd_m = synd6[:, None, :6, :] ^ _c("sig_syndr", dev)[1:4][None, :, None, :]
    max_pos6 = _sp(slot_bytes, "lens", dev)[:6] - 1
    clean_l, deg_l, epos_l, chfail_l = [], [], [], []
    for m in range(3):
        t = tt[m]
        clean_l.append((synd_m[:, m, :, : 2 * t] == 0).all(2).all(1))
        elp, deg = _peterson_elp(synd_m[:, m], t)
        fail, epos = _chien(elp, deg, max_pos6[None, :].expand(B, 6))
        deg_l.append(deg)
        epos_l.append(epos)
        chfail_l.append(fail)
    clean = torch.stack(clean_l, 1)                                   # [B, 3]
    deg_det = torch.stack(deg_l, 1)                                   # [B, 3, 6]
    epos_det = torch.stack(epos_l, 1)                                 # [B, 3, 6, 3]
    chfail_det = torch.stack(chfail_l, 1)                             # [B, 3, 6]
    clean_any = clean.any(1)
    clean_m = torch.argmax(clean.to(I64), 1)

    # risk analysis and candidate pick (al_fec.c:1190-1290)
    thr_m, thr_e = _EP_RISK_THRESH_NS if slot_bytes <= 40 else _EP_RISK_THRESH_OS
    sel_m, sel_e, sel_mant = full(-1), full(0), full(0)
    for m in range(3):
        t = tt[m]
        blacklist = (deg_det[:, m] > t).any(1)
        dc = deg_det[:, m].clamp(0, 3)
        rm, re = risk_m[m + 1][dc], risk_e[m + 1][dc]                 # [B, 6]
        pm, pe = full(16384), full(0)
        for cw in range(6):
            pm, pe = _sf_mul(pm, pe, rm[:, cw], re[:, cw])
        cand = ~blacklist & _sf_le(pm, pe, thr_m, thr_e)
        viable = cand & ~chfail_det[:, m].any(1)
        better = viable & ((sel_m < 0) | _sf_lt(pm, pe, sel_mant, sel_e))
        sel_m = torch.where(better, m, sel_m)
        sel_mant = torch.where(better, pm, sel_mant)
        sel_e = torch.where(better, pe, sel_e)
    det_m = torch.where(clean_any, clean_m, sel_m)                    # internal, -1 = fail
    det_ok = clean_any | (sel_m >= 0)

    # per-mode correction of every codeword, then the data words
    flat_i, flat_j = _sp(slot_bytes, "flat_i", dev), _sp(slot_bytes, "flat_j", dev)
    lens_r = _sp(slot_bytes, "lens", dev)[6:] - 1
    n_rem = ncw - 6
    bitcnt = _c("bitcnt", dev)
    per_mode = []
    for m in range(3):
        t = tt[m]
        mp = mps[m + 2]
        deg6 = deg_det[:, m]
        msk6 = (ar(3)[None, None, :] < deg6[:, :, None]) & ~chfail_det[:, m, :, None] \
            & (deg6 <= t)[:, :, None]
        errs6 = torch.where(msk6, _forney(epos_det[:, m], deg6, synd_m[:, m]), 0)
        bits6 = bitcnt[errs6].sum((1, 2))
        syndr = synd6[:, 6:, :]
        elpr, degr = _peterson_elp(syndr, t)
        failr, eposr = _chien(elpr, degr, lens_r[None, :].expand(B, n_rem))
        hardfail = (degr > t) | failr
        mskr = (ar(3)[None, None, :] < degr[:, :, None]) & ~hardfail[:, :, None]
        errsr = torch.where(mskr, _forney(eposr, degr, syndr), 0)
        bitsr = bitcnt[errsr].sum((1, 2))
        is_pc = (ar(n_rem) + 6 >= ncw - mp["n_pccw"])[None, :]
        bfi1 = (hardfail & ~is_pc).any(1)
        bfi2 = (hardfail & is_pc).any(1)
        # trust of each codeword (al_fec.c:1407-1443)
        trust = ~hardfail & ~(risk_e[m + 1][degr.clamp(0, 3)] + 16 > 0)
        broken = []
        for i in range(4):
            b = torch.zeros((B,), dtype=torch.bool, device=dev)
            if i < m + 1:
                b = b | (deg6 > i).any(1)
                if n_rem:
                    b = b | (degr > i).any(1)
            if n_rem:
                b = b | hardfail.any(1)
            broken.append(b)
        broken = torch.stack(broken, 1)                               # [B, 4]
        cw_p = torch.cat([cw_mat, torch.zeros((B, ncw, 1), dtype=I64, device=dev)], -1)
        cw_p = torch.cat([_scatter_xor(cw_p[:, :6], epos_det[:, m], errs6),
                          _scatter_xor(cw_p[:, 6:], eposr, errsr)], dim=1)
        sig = _c("sig_polys", dev)[m + 1]
        cw_p = torch.cat([torch.cat([cw_p[:, :6, :15] ^ sig, cw_p[:, :6, 15:]], -1),
                          cw_p[:, 6:]], dim=1)
        epmr_det = cw_p[:, 0, cw0_len - 1] & 3
        dw = _bitswap(cw_p[:, flat_i, flat_j][:, mp_(m + 2, "dw_pos")], mp["ind0"], mp["ind1"])
        tmp_epmr = dw[:, 2 * mp["n_crc1"] - 1] >> 2
        c12 = 2 * (mp["n_crc1"] + mp["n_crc2"])
        remc = _crc1_rem(mp, ccc_flag, dw[:, c12: c12 + mp["crc1_tab"].shape[0]], tmp_epmr)
        crc1_ok = (dw[:, : 2 * mp["n_crc1"]] == _rem_to_hash(remc, mp["n_crc1"])).all(1)
        if mp["n_crc2"]:
            rem2 = _crc_eval(mp_(m + 2, "crc2_tab"), dw[:, dw.shape[1] - mp["pc_split"]:])
            crc2_ok = (dw[:, 2 * mp["n_crc1"]: c12] == _rem_to_hash(rem2, mp["n_crc2"])).all(1)
        else:
            crc2_ok = torch.ones((B,), dtype=torch.bool, device=dev)
        data = torch.nn.functional.pad(_dw_to_bytes(dw, mp["data_bytes"]),
                                       (0, slot_bytes - mp["data_bytes"]))
        per_mode.append(dict(bits=bits6 + bitsr, bfi1=bfi1, bfi2=bfi2, trust=trust,
                             broken=broken, epmr_det=epmr_det, tmp_epmr=tmp_epmr,
                             crc1_ok=crc1_ok, crc2_ok=crc2_ok, data=data,
                             deg0=deg_det[:, m, 0].clamp(0, 3)))

    data1 = torch.nn.functional.pad(_dw_to_bytes(dw1u, mp1["data_bytes"]),
                                    (0, slot_bytes - mp1["data_bytes"]))

    # lane-wise selection over the detected mode
    idx = det_m.clamp(0, 2)

    def sel3(key):
        stacked = torch.stack([pm_[key] for pm_ in per_mode], 1)
        at = idx.reshape((B, 1) + (1,) * (stacked.dim() - 2)).expand(B, 1, *stacked.shape[2:])
        return torch.gather(stacked, 1, at)[:, 0]

    bits_sel, bfi1_sel, bfi2_sel = sel3("bits"), sel3("bfi1"), sel3("bfi2")
    broken_sel, crc1_ok_sel, crc2_ok_sel = sel3("broken"), sel3("crc1_ok"), sel3("crc2_ok")
    tmp_epmr_sel, epmr_det_sel = sel3("tmp_epmr"), sel3("epmr_det")
    data_sel, deg0_sel = sel3("data"), sel3("deg0")

    # EPMR by path (al_fec.c:1177,1359-1370,1109)
    exp0 = risk_e.reshape(-1)[(idx + 1) * 4 + deg0_sel]
    incr = 8 - 4 * (exp0 <= -8).to(I64) - 4 * (exp0 <= -16).to(I64)
    epmr = torch.where(clean_any, epmr_raw, epmr_det_sel + incr)

    # total-failure EPMR estimate (fec_estimate_epmr_from_cw0, al_fec.c:908-1010)
    est_exp = torch.where(ep1_syn_ok | ((synd_m[:, 0, 0, 0] | synd_m[:, 0, 0, 1]) == 0),
                          -8, 0)
    cand_es, risk_es, fact_es, epmr_es = [], [], [], []
    for m in (1, 2):
        d0 = deg_det[:, m, 0].clamp(0, 3)
        re0, rm0 = risk_e[m + 1][d0], risk_m[m + 1][d0]
        cand_es.append((deg_det[:, m, 0] <= tt[m]) & (re0 <= -8))
        risk_es.append((rm0, re0))
        fact_es.append(~chfail_det[:, m, 0])
        epmr_es.append(per_mode[m]["epmr_det"])
    r2_lt_r3 = _sf_lt(risk_es[0][0], risk_es[0][1], risk_es[1][0], risk_es[1][1])
    first_is_2 = torch.where(cand_es[0] & cand_es[1], r2_lt_r3, cand_es[0])
    pick2 = cand_es[0] & fact_es[0]
    pick3 = cand_es[1] & fact_es[1]
    use2 = pick2 & (first_is_2 | ~pick3)
    use3 = pick3 & ~use2
    est_exp = torch.where(use2, risk_es[0][1], torch.where(use3, risk_es[1][1], est_exp))
    epmr_base = torch.where(use2, epmr_es[0], torch.where(use3, epmr_es[1], epmr_raw))
    epmr_fail = epmr_base + 4 * (est_exp > -16).to(I64) + 4 * (est_exp > -8).to(I64)

    # outputs, by priority: EP1 > detected > failure
    broken_bits = full(0)
    for i in range(4):
        broken_bits = broken_bits | torch.where(broken_sel[:, i], 0, EP_OK[i])
    er = torch.where(bfi1_sel, BEC_MASK, (bits_sel & BEC_MASK) | broken_bits)
    bfi = torch.where(bfi1_sel, 1, torch.where(bfi2_sel, 2, 0))
    mode_ext = det_m + 2

    # low-rate error cap (al_fec.c:760-783)
    if slot_bytes == 40:
        lims = _c("low_br", dev)
        bits_only = er & BEC_MASK
        over = bits_only > lims[mode_ext.clamp(0, 4)]
        er = torch.where((bits_only > _LOW_BR_MAX_BIT_ERRORS[2]) & ~over, er & ~EP_OK[1], er)
        er = torch.where((bits_only > _LOW_BR_MAX_BIT_ERRORS[3]) & ~over, er & ~EP_OK[2], er)
        er = torch.where(over, bits_only, er)
        bfi = torch.where(over, 1, bfi)
        cap_fail = over
    else:
        cap_fail = torch.zeros((B,), dtype=torch.bool, device=dev)

    # CRC outcomes (skipped for lanes already dead)
    alive = det_ok & ~bfi1_sel & ~cap_fail
    epmr = torch.where(alive & crc1_ok_sel, tmp_epmr_sel, epmr)
    bfi = torch.where(alive & ~crc1_ok_sel, 1, bfi)
    bfi = torch.where(alive & crc1_ok_sel & (bfi != 2) & ~crc2_ok_sel, 2, bfi)

    # partial-concealment byte error positions (al_fec.c:840-870)
    be_left, be_right = full(-1), full(-1)
    for m in (1, 2):
        n_pccw0 = mps[m + 2]["n_pccw"]
        if n_pccw0 == 0:
            continue
        # trust index j is codeword ncw-1-j; all-trusted lanes take the
        # first_bad == n_pccw -> be_bp_left = 0 case
        bad = ~per_mode[m]["trust"].flip(1)[:, :n_pccw0]
        any_bad = bad.any(1)
        first_bad = torch.where(any_bad, torch.argmax(bad.to(I64), 1), n_pccw0)
        last_bad = torch.where(any_bad, n_pccw0 - 1 - torch.argmax(bad.flip(1).to(I64), 1),
                               n_pccw0 - 1)
        pc_nib = mp_(m + 2, "pc_nib")
        left = torch.where(first_bad == n_pccw0, 0,
                           4 * pc_nib[first_bad.clamp(max=n_pccw0 + 1)])
        right = 4 * pc_nib[last_bad + 1] - 1
        lane = (det_m == m) & (bfi == 2)
        be_left = torch.where(lane, left, be_left)
        be_right = torch.where(lane, right, be_right)

    # final lane-priority merge
    per_ext = lambda key: [0] + [mps[m][key] for m in (1, 2, 3, 4)]
    pick = lambda key, at: sum(torch.where(at == k, v, 0) for k, v in enumerate(per_ext(key)))
    data_out = torch.where(ep1_ok[:, None], data1, data_sel)
    mode_f = torch.where(ep1_ok, 1, torch.where(det_ok, mode_ext, -1))
    bfi_f = torch.where(ep1_ok, 0, torch.where(det_ok, bfi, 1))
    er_f = torch.where(ep1_ok, ALL_OK, torch.where(det_ok, er, BEC_MASK))
    epmr_f = torch.where(ep1_ok, epmr_raw, torch.where(det_ok, epmr, epmr_fail))
    dead = (bfi_f == 1) | (mode_f < 0)
    mode_f = torch.where((bfi_f == 1) & ~ep1_ok & cap_fail, -1, mode_f)
    mclip = mode_f.clamp(0, 4)
    data_bytes = torch.where(dead, 0, pick("data_bytes", mclip))
    n_pc = pick("pc_split", mclip)
    n_pccw = pick("n_pccw", mclip)
    data_out = torch.where(dead[:, None], 0, data_out)
    be_left = torch.where(bfi_f == 2, be_left, -1)
    be_right = torch.where(bfi_f == 2, be_right, -1)
    if bfi_in is not None:
        was_bad = bfi_in.to(dev) == 1
        bfi_f = torch.where(was_bad, 1, bfi_f)
        er_f = torch.where(was_bad, -1, er_f)
        data_bytes = torch.where(was_bad, 0, data_bytes)
        mode_f = torch.where(was_bad, -1, mode_f)
    out = dict(data=data_out, data_bytes=data_bytes, bfi=bfi_f, epmr=epmr_f,
               error_report=er_f, mode=mode_f, n_pccw=n_pccw, n_pc=n_pc,
               be_bp_left=be_left, be_bp_right=be_right)
    return {k: v.to(I32) for k, v in out.items()}


# ---------------------------------------------------------------------------
# entry points
# ---------------------------------------------------------------------------


def fec_encode(data, epmr, *, slot_bytes: int, mode: int, ccc_flag: int = 0):
    """Channel-coder encode: [B, data_bytes] payload bytes and [B] EPMR ->
    [B, slot_bytes] int32 protected frames."""
    if data.device.type == "cpu":
        return fec_encode_plain(data, epmr, slot_bytes, mode, ccc_flag)
    return kernels.fec_encode(data, epmr, slot_bytes, mode, ccc_flag)


def fec_decode(frames, *, slot_bytes: int, ccc_flag: int = 0, bfi_in=None):
    """Channel-coder decode of [B, slot_bytes] frames; returns the dict of
    fec_decode_plain."""
    if frames.device.type == "cpu":
        return fec_decode_plain(frames, slot_bytes, ccc_flag, bfi_in)
    return kernels.fec_decode(frames, slot_bytes, ccc_flag, bfi_in)
