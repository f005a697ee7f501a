"""The bit-exact fixed-point decode chain over a batch of frames
(`audio_codec_tpu/ops/fixed_dev.py`, dec_lc3.c:156-235 and the IMDCT's
front half).

Every stage is the reference's BASOP arithmetic on int64 tensors over a
[L] batch of frames (L = T x B lanes in `fixed_decoder_dev`): per-frame
control flow becomes masks, data-dependent loops fixed-trip loops, and
per-frame scalars (exponents, gains) [L] vectors. The stages group into
three of the four CUDA kernels of the chain, each with its plain version
here:

  sns_decode      (K20a, `fx_sns_dec`)     sns_decode_scf + sns_interpolate
  spectrum_decode (K20b, `fx_spec_decode`) ari_scaling .. tns_decode,
                                           scf_scaling, mdct_shaping
  batch_dct4      (K20c, `fx_dct4`)        the headroom and dct_IV

The fourth, `fx_ola_ltpf` (K21), is `fixed_ltpf_dev.ola_ltpf`. Each
dispatcher runs the plain version for a tensor on the CPU and the kernel
for a tensor on the card. The arithmetic is integer, so kernel, plain
version and reference agree exactly.
"""
from __future__ import annotations

import numpy as np
import torch

from .. import kernels
from .. import tables as T
from . import fixed_dec as fd
from . import fixed_imdct as fi
from . import numerics as nm
from .quant import lcg_tables

I64 = torch.int64
MAX32 = (1 << 31) - 1


def _t(name: str, device) -> torch.Tensor:
    return nm.table(T.t, name, device=device, dtype=I64)


def _gat(tab: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """tab[idx] per lane, the index clipped into the table (1-D table)."""
    return tab[torch.clamp(idx.to(I64), 0, tab.shape[0] - 1)]


def _i64(x) -> torch.Tensor:
    return x.to(I64)


# ------------------------------------------------------------- stages

def ari_scaling(sq):
    """processAriDecoderScaling_fx: sq [L, N] -> (x32 [L, N], x_e [L])."""
    sq = _i64(sq)
    mx = torch.amax(torch.abs(sq), dim=1)
    shift = torch.where(mx == 0, 15, fd.norm_s(mx))
    # a value above Word16 would make the shift negative: XLA's shift by a
    # negative count gives 0, and so does this
    v = (sq << 16) << torch.clamp(shift, 0, 63)[:, None]
    return torch.where((shift >= 0)[:, None], v, 0), 15 - shift


def residual_decode(x32, x_e, prm, res_bits):
    """processResidualDecoding_fx. prm [L, R] 0/1 bits; res_bits [L]."""
    x = _i64(x32)
    L, _ = x.shape
    R = prm.shape[1]
    s = _i64(x_e) - 1
    fac_m = fd.L_shl(torch.full((L,), 0x0C000000, dtype=I64, device=x.device), -s)[:, None]
    fac_p = fd.L_shl(torch.full((L,), 0x14000000, dtype=I64, device=x.device), -s)[:, None]
    nz = x != 0
    rank = torch.cumsum(nz.to(I64), dim=1) - nz.to(I64)   # exclusive rank among nonzeros
    active = nz & (rank < _i64(res_bits)[:, None]) & (rank < R)
    bit = torch.gather(_i64(prm), 1, torch.clamp(rank, 0, R - 1))
    pos = x > 0
    delta = torch.where(bit == 0, torch.where(pos, -fac_m, -fac_p), torch.where(pos, fac_p, fac_m))
    return torch.where(active, fd.sat32(x + delta), x)


def _nf_geometry(frame_dms: int):
    """(bandwidth shift, nfw, nfs) of the noise filler."""
    return {25: (2, 1, 6), 50: (1, 2, 12), 100: (0, 3, 24)}[frame_dms]


def noise_filling(xq, nfseed, xq_e, fac_ns_idx, bw_idx, frame_dms: int):
    """processNoiseFilling_fx (valid while Nbw - nfw > nfs, which holds at
    every supported operating point). Returns (x, final seed)."""
    xq = _i64(xq)
    L, N = xq.shape
    dev = xq.device
    sh_bw, nfw, nfs = _nf_geometry(frame_dms)
    Nbw = _gat(_t("BW_cutoff_bin_all", dev), bw_idx) >> sh_bw
    idx = torch.arange(N, dtype=I64, device=dev)[None, :]
    m_nz = xq != 0
    last_nz = torch.cummax(torch.where(m_nz, idx, -1), dim=1).values
    run_end = idx - last_nz              # the run of zeros ending at p
    # main window: all of [k-nfw, k+nfw] zero  <=>  run_end[k+nfw] >= 2nfw+1
    re_kn = torch.cat([run_end[:, nfw:], torch.zeros((L, nfw), dtype=I64, device=dev)], dim=1)
    re_last = torch.gather(run_end, 1, (Nbw - 1)[:, None])
    cond_main = re_kn >= 2 * nfw + 1
    cond_tail = re_last >= (nfw + Nbw[:, None] - idx)
    in_main = (idx >= nfs) & (idx < Nbw[:, None] - nfw)
    in_tail = (idx >= torch.clamp(Nbw[:, None] - nfw, min=nfs)) & (idx < Nbw[:, None])
    sel = (in_main & cond_main) | (in_tail & cond_tail)

    fac_ns = (8 - _i64(fac_ns_idx)) << 11
    sh = _i64(xq_e) - 16
    v = fd.L_shl(fac_ns, -sh)[:, None]
    ap, cs = (torch.as_tensor(a, device=dev) for a in lcg_tables(N + 1))
    rank = torch.cumsum(sel.to(I64), dim=1)       # 1-based at selected positions
    seed0 = _i64(nfseed) & 0xFFFF
    seed_u = (ap[rank] * seed0[:, None] + cs[rank]) & 0xFFFF
    out = torch.where(sel, torch.where(seed_u < 0x8000, v, -v), xq)
    n_sel = rank[:, -1]
    seed_fin_u = (ap[n_sel] * seed0 + cs[n_sel]) & 0xFFFF
    seed_fin = torch.where(seed_fin_u >= 0x8000, seed_fin_u - 0x10000, seed_fin_u)
    return out, seed_fin


def inv_log2(x):
    """BASOP_Util_InvLog2 over [L]: 2^(x in Q25) in Q31."""
    x = _i64(x)
    dev = x.device
    frac = x & 0x3FF
    i3 = (x >> 10) & 0x1F
    i2 = (x >> 15) & 0x1F
    i1 = (x >> 20) & 0x1F
    exp = x >> 25
    exp = torch.where(x > 0, 31 - exp, -exp)
    e3, e2, e1 = (_t(n, dev) for n in ("fx_exp2x_tab_long", "fx_exp2w_tab_long",
                                       "fx_exp2_tab_long"))
    lookup3f = _gat(e3, i3) + (fd.mpy_32_16(0x0016302F, frac) >> 1)
    lookup12 = fd.mpy_32_32(_gat(e1, i1), _gat(e2, i2))
    lookup = fd.mpy_32_32(lookup12, lookup3f)
    res = fd.L_shl(lookup, -(exp - 3))
    res = torch.where(x < -1040187392, 0, res)
    return torch.where((x >= 1040187392) | (x == 0), MAX32, res)


def apply_global_gain(x32, x_e, gg_idx, gg_off: int):
    """processApplyGlobalGain_fx."""
    gg_idx = _i64(gg_idx)
    tmp32 = fd.sat32(((gg_idx + gg_off) * 0x797D) << 7)
    gg_e = (tmp32 >> 25) + 1
    gg = fd.round_fx(inv_log2(tmp32 | -33554432))
    return fd.mpy_32_16(_i64(x32), gg[:, None]), _i64(x_e) + gg_e


def _masked_headroom32(x, mask):
    """getScaleFactor32 over the masked region per lane: the least norm_l
    of its nonzero entries, 0 if there is none."""
    nz = mask & (x != 0)
    n = torch.where(nz, fd.norm_l(torch.where(nz, x, 1)), 63)
    return torch.where(nz.any(dim=1), torch.amin(n, dim=1), 0)


def _tns_geometry(frame_dms: int):
    """(filter 0's first bin, bandwidth shift)."""
    return {25: (3, 2), 50: (6, 1), 100: (12, 0)}[frame_dms]


def tns_decode(rc_idx, x32, x_e, order, bw_idx, frame_dms: int):
    """processTnsDecoder_fx. rc_idx [L, 16], order [L, 2]."""
    x = _i64(x32)
    L, N = x.shape
    dev = x.device
    pts = _t("fx_tnsQuantPts", dev)
    bw_idx = _i64(bw_idx)
    start0, sh_bw = _tns_geometry(frame_dms)
    bw_stop = _gat(_t("BW_cutoff_bin_all", dev), bw_idx) >> sh_bw
    numf2 = (bw_idx >= 3) & (frame_dms >= 50)
    start1 = bw_stop >> 1
    order = _i64(order)
    o0 = order[:, 0]
    o1 = torch.where(numf2, order[:, 1], 0)
    lane_act = (o0 > 0) | (o1 > 0)

    f = torch.where(numf2 & (o0 == 0), start1, start0)
    idx = torch.arange(N, dtype=I64, device=dev)[None, :]
    s1 = _masked_headroom32(x, idx < f[:, None])
    s2 = _masked_headroom32(x, idx >= f[:, None])
    s = torch.minimum(s1, s2 - 7)
    x_e = torch.where(lane_act, _i64(x_e) - s, _i64(x_e))

    rc_idx = _i64(rc_idx)
    rc0 = _gat(pts, rc_idx[:, 0:8])
    rc1 = _gat(pts, rc_idx[:, 8:16])
    stop1 = torch.where(numf2, start1, bw_stop)   # filter 0's stop
    state = torch.zeros((L, 8), dtype=I64, device=dev)
    cols, acts = [], []
    for i in range(N):
        x_i = x[:, i]
        in_f1 = (i >= start0) & (i < stop1) & (o0 > 0)
        in_f2 = numf2 & (i >= start1) & (i < bw_stop) & (o1 > 0)
        act = (in_f1 | in_f2) & lane_act
        rc = torch.where(in_f2[:, None], rc1, rc0)
        o = torch.where(in_f2, o1, o0)
        xi = fd.L_shl(x_i, s)
        om1 = torch.clamp(o - 1, 0, 7)[:, None]
        st_om1 = torch.gather(state, 1, om1)[:, 0]
        rc_om1 = torch.gather(rc, 1, om1)[:, 0]
        xi = torch.where(act, fd.sat32(xi - fd.mpy_32_16(st_om1, rc_om1)), xi)
        new_state = state.clone()
        for kk in range(6, -1, -1):
            a_k = act & (kk <= o - 2)
            xi2 = fd.sat32(xi - fd.mpy_32_16(new_state[:, kk], rc[:, kk]))
            xi = torch.where(a_k, xi2, xi)
            upd = fd.sat32(new_state[:, kk] + fd.mpy_32_16(xi, rc[:, kk]))
            new_state[:, kk + 1] = torch.where(a_k, upd, new_state[:, kk + 1])
        new_state[:, 0] = torch.where(act, xi, new_state[:, 0])
        state = torch.where(act[:, None], new_state, state)
        cols.append(xi)
        acts.append(act)
    x_filt = torch.stack(cols, dim=1)
    act_map = torch.stack(acts, dim=1)
    x_shifted = fd.L_shl(x, s[:, None])
    x_out = torch.where(lane_act[:, None], torch.where(act_map, x_filt, x_shifted), x)
    return x_out, x_e


def inv_log2_16(x):
    """BASOP_Util_InvLog2_16, elementwise: (mantissa Q15, exponent)."""
    x = _i64(x)
    t1, t2 = _t("fx_InvLog2_16_table1", x.device), _t("fx_InvLog2_16_table2", x.device)
    tmp1 = (x & 2047) >> 5
    tmp2 = (x & 31) << 4
    y = fd.mac_r(_gat(t1, tmp1), _gat(t2, tmp1), tmp2)
    return y, (x >> 11) + 1


def sns_interpolate(scf_q, n_bands: int):
    """processSnsInterpolateScf_fx. scf_q [L, 16] -> (scf, scf_e) [L, n_bands]."""
    scf_q = _i64(scf_q)
    L = scf_q.shape[0]
    cols = [None] * 64
    cols[0] = scf_q[:, 0]
    cols[1] = scf_q[:, 0]
    tmp2 = torch.zeros((L,), dtype=I64, device=scf_q.device)
    for i in range(1, 16):
        d = fd.sat16(scf_q[:, i] - scf_q[:, i - 1])
        tmp2 = fd.mult_r(d, 8192)
        tmp = fd.mult_r(d, 4096)
        cols[i * 4 - 2] = fd.sat16(scf_q[:, i - 1] + tmp)
        cols[i * 4 - 1] = fd.sat16(cols[i * 4 - 2] + tmp2)
        cols[i * 4] = fd.sat16(cols[i * 4 - 1] + tmp2)
        cols[i * 4 + 1] = fd.sat16(cols[i * 4] + tmp2)
    cols[62] = fd.sat16(cols[61] + tmp2)
    cols[63] = fd.sat16(cols[62] + tmp2)
    if n_bands < 32:
        t = 32 - n_bands
        orig = list(cols)
        for i in range(t):
            cols[i] = fd.sat16(
                fd.mac_r(fd.L_mult(orig[4 * i], 8192), orig[4 * i + 1], 8192)
                + fd.mac_r(fd.L_mult(orig[4 * i + 2], 8192), orig[4 * i + 3], 8192))
        for i in range(n_bands - t):
            cols[t + i] = fd.mac_r(fd.L_mult(orig[4 * t + 2 * i], 16384),
                                   orig[4 * t + 2 * i + 1], 16384)
    elif n_bands < 64:
        t = 64 - n_bands
        for i in range(t):
            cols[i] = fd.mac_r(fd.L_mult(cols[2 * i], 16384), cols[2 * i + 1], 16384)
        for i in range(t, n_bands):
            cols[i] = cols[t + i]
    return inv_log2_16(torch.stack(cols[:n_bands], dim=1))


def scf_scaling(scf_exp, x_e):
    m = torch.amax(scf_exp, dim=1)
    return scf_exp - m[:, None], _i64(x_e) + m


def band_of_bin(bands_offset, n_bins: int) -> np.ndarray:
    bo = np.asarray(bands_offset, np.int64)
    out = np.zeros(n_bins, np.int64)
    for i in range(len(bo) - 1):
        out[bo[i]: bo[i + 1]] = i
    return out


def mdct_shaping(x32, scf, scf_exp, bands_offset, n_bins: int):
    """processMdctShaping_fx: each bin times its band's scale factor."""
    bmap = torch.as_tensor(band_of_bin(bands_offset, n_bins), device=scf.device)
    x = _i64(x32)[:, :n_bins]
    return fd.L_shl(fd.mpy_32_16(x, scf[:, bmap]), scf_exp[:, bmap])


# ------------------------------------------------------ fixed SNS decoder

def isqrt16(mantissa, exponent):
    """ISqrt16 over [L]: (mantissa, exponent) of 1/sqrt."""
    dev = mantissa.device
    pre = fd.norm_s(mantissa)
    e = exponent - pre
    m = fd.shl16(mantissa, pre)
    idx = fd.mac_r(torch.full_like(m, -32768 - (32 << 16)), m, 1 << 6)
    frac = m & 0x1FF
    m2 = fd.msu_r(_gat(_t("fx_ISqrtTable", dev), idx), _gat(_t("fx_ISqrtDiffTable", dev), idx),
                  frac)
    m3 = torch.where((e & 1) == 0, fd.mult_r(m2, 0x5A82), m2)
    return m3, fd.msu_r(torch.full_like(e, 1 << 15), e, 1 << 14)


def idct16(cols):
    """idct16_fx on [L, 16] (the reference's dataflow)."""
    def m(a, c):
        return fd.mult_r(a, c)

    def ad(a, b):
        return fd.sat16(a + b)

    def sb(a, b):
        return fd.sat16(a - b)

    i = [cols[:, k] for k in range(16)]
    a8 = ad(m(i[1], 1136), m(i[15], -11529))
    a9 = ad(m(i[9], 8956), m(i[7], -7350))
    a10 = ad(m(i[5], 5461), m(i[11], -10217))
    a11 = ad(m(i[13], 11086), m(i[3], -3363))
    a12 = ad(m(i[3], 11086), m(i[13], 3363))
    a13 = ad(m(i[11], 5461), m(i[5], 10217))
    a14 = ad(m(i[7], 8956), m(i[9], 7350))
    a15 = ad(m(i[15], 1136), m(i[1], 11529))
    b4 = ad(m(i[2], 2260), m(i[14], -11363))
    b5 = ad(m(i[10], 9633), m(i[6], -6436))
    b6 = ad(m(i[6], 9633), m(i[10], 6436))
    b7 = ad(m(i[14], 2260), m(i[2], 11363))
    b8 = ad(a9, a8)
    b9 = sb(a8, a9)
    b10 = sb(a11, a10)
    b11 = ad(a10, a11)
    b12 = ad(a13, a12)
    b13 = sb(a12, a13)
    b14 = sb(a15, a14)
    b15 = ad(a14, a15)
    a0 = ad(m(i[0], 8192), m(i[8], 8192))
    a1 = ad(m(i[8], -8192), m(i[0], 8192))
    a2 = ad(m(i[4], 4433), m(i[12], -10703))
    a3 = ad(m(i[12], 4433), m(i[4], 10703))
    a4 = ad(b5, b4)
    a5 = sb(b4, b5)
    a6 = sb(b7, b6)
    a7 = ad(b6, b7)
    a8 = b8
    a9 = ad(m(b9, -30274), m(b14, 12540))
    a10 = ad(m(b10, -12540), m(b13, -30274))
    a11 = b11
    a12 = b12
    a13 = ad(m(b13, 12540), m(b10, -30274))
    a14 = ad(m(b14, 30274), m(b9, 12540))
    a15 = b15
    b0 = ad(a3, a0)
    b1 = ad(a2, a1)
    b2 = sb(a1, a2)
    b3 = sb(a0, a3)
    b4 = a4
    b5 = ad(m(a5, -23170), m(a6, 23170))
    b6 = ad(m(a6, 23170), m(a5, 23170))
    b7 = a7
    b8 = ad(a11, a8)
    b9 = ad(a10, a9)
    b10 = sb(a9, a10)
    b11 = sb(a8, a11)
    b12 = sb(a15, a12)
    b13 = sb(a14, a13)
    b14 = ad(a13, a14)
    b15 = ad(a12, a15)
    a0 = ad(b7, b0)
    a1 = ad(b6, b1)
    a2 = ad(b5, b2)
    a3 = ad(b4, b3)
    a4 = sb(b3, b4)
    a5 = sb(b2, b5)
    a6 = sb(b1, b6)
    a7 = sb(b0, b7)
    a10 = ad(m(b10, -23170), m(b13, 23170))
    a11 = ad(m(b11, -23170), m(b12, 23170))
    a12 = ad(m(b12, 23170), m(b11, 23170))
    a13 = ad(m(b13, 23170), m(b10, 23170))
    return torch.stack(
        [ad(b15, a0), ad(b14, a1), ad(a13, a2), ad(a12, a3),
         ad(a11, a4), ad(a10, a5), ad(b9, a6), ad(b8, a7),
         sb(a7, b8), sb(a6, b9), sb(a5, a10), sb(a4, a11),
         sb(a3, a12), sb(a2, a13), sb(a1, b14), sb(a0, b15)], dim=1)


def mpvq_offsets(dim: int, k_val: int) -> list[int]:
    """The MPVQ offsets h[0..k_val+1] that mpvq_deindex_fx starts from."""
    h = list(fd._MPVQ_OFFS[dim][: k_val + 2])
    if k_val != fd._TABLED_KMAX[dim]:
        h[k_val + 1] >>= 1              # A(K+1) -> U(K+1)
    return h


def _mpvq_deindex_batch(dim: int, k_val: int, ls_ind, index):
    """mpvq_deindex_fx for a fixed (dim, k_val) over [L] lanes.
    Returns (pulses [L, dim], ber [L])."""
    h0 = mpvq_offsets(dim, k_val)
    size = 1 + h0[k_val + 1] + (h0[k_val] >> 1)
    index = _i64(index)
    L, dev = index.shape[0], index.device
    ber = (index >= size).to(I64) if dim != 1 else torch.zeros_like(index)
    index = torch.where(ber == 1, 0, index)
    K = k_val + 2
    h = torch.as_tensor(h0, dtype=I64, device=dev)[None, :].repeat(L, 1)
    leading_sign = torch.where(_i64(ls_ind) != 0, -1, 1)
    k_max = torch.full((L,), k_val, dtype=I64, device=dev)
    ind = index
    done = torch.zeros((L,), dtype=torch.bool, device=dev)
    karr = torch.arange(K, dtype=I64, device=dev)[None, :]
    outs = []
    for _ in range(dim):
        active = ~done
        emit0 = active & (ind == 0)
        val0 = torch.where(leading_sign >= 0, k_max, -k_max)
        # k_acc = the largest k <= k_max with h[k] <= ind (h nondecreasing)
        le = (karr <= k_max[:, None]) & (h <= ind[:, None])
        k_acc = torch.clamp(le.sum(dim=1) - 1, 0, k_val)
        ind2 = ind - torch.gather(h, 1, k_acc[:, None])[:, 0]
        k_delta = k_max - k_acc
        moved = active & ~emit0 & (k_delta != 0)
        val = torch.where(moved, torch.where(leading_sign >= 0, k_delta, -k_delta), 0)
        leading_sign = torch.where(moved, torch.where((ind2 & 1) != 0, -1, 1), leading_sign)
        ind3 = torch.where(moved, ind2 >> 1, ind2)
        k_max2 = torch.where(moved, k_acc, k_max)
        # a_bwd update of h over i = 1..k_max2+1 (still-active lanes only)
        upd_lane = active & ~emit0
        a0 = torch.zeros((L,), dtype=I64, device=dev)
        hn = h.clone()
        for i in range(1, K):
            do = upd_lane & (i <= k_max2 + 1)
            a1 = hn[:, i] - a0 - hn[:, i - 1]
            hn[:, i - 1] = torch.where(do, a0, hn[:, i - 1])
            a0 = torch.where(do, a1, a0)
        onehot = (karr == (k_max2 + 1)[:, None]) & upd_lane[:, None]
        h = torch.where(onehot, a0[:, None], hn)
        outs.append(torch.where(emit0, val0, torch.where(moved, val, 0)))
        done = done | emit0
        ind = torch.where(active, ind3, ind)
        k_max = torch.where(active, k_max2, k_max)
    return torch.stack(outs, dim=1), ber


# (dim, k) of each submode's shapes, its gain table and its largest k
_SNS_GAINS = ("fx_sns_vq_reg_adj_gains", "fx_sns_vq_reg_lf_adj_gains",
              "fx_sns_vq_near_adj_gains", "fx_sns_vq_far_adj_gains")
SNS_MAXK = (10, 10, 8, 6)


def sns_decode_scf(scf_idx):
    """processSnsQuantizeScfDecoder_fx. scf_idx [L, 7] -> (scf_q [L, 16]
    Word16, ber [L])."""
    scf_idx = _i64(scf_idx)
    dev = scf_idx.device
    idx0, idx1, submode, gidx, ls, mpvq, idxB = (scf_idx[:, k] for k in range(7))
    lf = _t("fx_st1SCF0_7_base5_32x8_Q14", dev).reshape(32, 8)
    hf = _t("fx_st1SCF8_15_base5_32x8_Q14", dev).reshape(32, 8)
    scf = torch.cat([lf[idx0.clamp(0, 31)], hf[idx1.clamp(0, 31)]], dim=1)
    gvals = torch.stack([_gat(_t(n, dev), gidx) for n in _SNS_GAINS], dim=1)
    sm = submode.clamp(0, 3)
    gval = torch.gather(gvals, 1, sm[:, None])[:, 0]
    # every submode's de-index on every lane, then the lane's own (the
    # kernel runs only the lane's)
    p0a, b0a = _mpvq_deindex_batch(10, 10, ls, mpvq)
    p0b, b0b = _mpvq_deindex_batch(6, 1, idxB & 1, idxB >> 1)
    p2, b2 = _mpvq_deindex_batch(16, 8, ls, mpvq)
    p3, b3 = _mpvq_deindex_batch(16, 6, ls, mpvq)
    z6 = torch.zeros((scf.shape[0], 6), dtype=I64, device=dev)
    smc = submode[:, None]
    pulses = torch.where(smc == 0, torch.cat([p0a, p0b], dim=1),
                         torch.where(smc == 1, torch.cat([p0a, z6], dim=1),
                                     torch.where(smc == 2, p2, p3)))
    ber = torch.where(submode == 0, b0a | b0b,
                      torch.where(submode == 1, b0a, torch.where(submode == 2, b2, b3)))
    maxk = torch.as_tensor(SNS_MAXK, dtype=I64, device=dev)[sm]
    # pvq_dec_en1_normQ14_fx with the lane's k_val_max
    L_yy = (pulses * pulses).sum(dim=1)
    tab = _gat(_t("fx_isqrt_Q16tab", dev), torch.clamp(L_yy, 0, 63))
    t2v, e2v = isqrt16(L_yy & 0xFFFF, torch.full_like(L_yy, 15))
    isqrt_q16 = torch.where(L_yy < 64, tab, fd.shl16(t2v, e2v + 1))
    shift_num = fd.norm_s(maxk)
    Lp = fd.L_mult(isqrt_q16[:, None], fd.shl16(pulses, shift_num[:, None]))
    en1 = fd.round_fx(fd.L_shl(Lp, (13 - shift_num)[:, None]))
    out = fd.sat16(scf + fd.mult_r(gval[:, None], idct16(en1)))
    return out, ber


def sns_decode_plain(scf_idx, n_bands: int):
    """sns_decode_scf then sns_interpolate: scf_idx [L, 7] -> (scf, scf_e)
    [L, n_bands] int64; the plain version of the `fx_sns_dec` kernel."""
    scf_q, _ = sns_decode_scf(scf_idx)
    return sns_interpolate(scf_q, n_bands)


def sns_decode(scf_idx, n_bands: int):
    """The SNS decode of the fixed chain: the `fx_sns_dec` kernel for a
    tensor on the card, its plain version on the CPU."""
    if nm.on_cpu(scf_idx):
        return sns_decode_plain(scf_idx, n_bands)
    return kernels.fx_sns_dec(scf_idx.to(torch.int32).contiguous(), n_bands)


# ------------------------------------------------------ spectrum

def spectrum_decode_plain(cfg, x, res_bits, n_res, nf_seed, zero_frame, fac_ns_idx, bw_idx,
                          gg_idx, tns_idx, tns_order, scf, scf_e):
    """The spectral chain of one clean frame a lane (dec_lc3.c:196-235):
    ari scaling, residual, noise filling (not on zero frames), global
    gain, TNS, SNS scaling and shaping, zero-padded to the frame. x [L, yLen]
    and res_bits [L, R] from the range decoder, tns_idx [L, 2, 8] or
    [L, 16], tns_order [L, 2], the side fields [L], scf/scf_e [L, n_bands]
    from sns_decode. Returns (shaped [L, frame_length], x_e [L]) int64;
    the plain version of the `fx_spec_decode` kernel."""
    L = x.shape[0]
    N, yLen = cfg.frame_length, cfg.yLen
    xs, x_e = ari_scaling(x)
    xs = residual_decode(xs, x_e, res_bits, n_res)
    nf, _ = noise_filling(xs, nf_seed, x_e, fac_ns_idx, bw_idx, cfg.frame_dms)
    xs = torch.where((_i64(zero_frame) == 0)[:, None], nf, xs)
    xs, x_e = apply_global_gain(xs, x_e, gg_idx, cfg.quantizedGainOff)
    xs, x_e = tns_decode(_i64(tns_idx).reshape(L, 16), xs, x_e, tns_order, bw_idx,
                         cfg.frame_dms)
    scf_e, x_e = scf_scaling(_i64(scf_e), x_e)
    bo = T.bands_offset(cfg.fs_idx, cfg.frame_dms, cfg.hrmode)
    shaped = mdct_shaping(xs, _i64(scf), scf_e, bo, yLen)
    if N > yLen:
        shaped = torch.cat([shaped, torch.zeros((L, N - yLen), dtype=I64, device=x.device)],
                           dim=1)
    return shaped, x_e


def spectrum_decode(cfg, x, res_bits, n_res, nf_seed, zero_frame, fac_ns_idx, bw_idx, gg_idx,
                    tns_idx, tns_order, scf, scf_e):
    """The spectral chain: the `fx_spec_decode` kernel for a tensor on the
    card, its plain version on the CPU."""
    args = (cfg, x, res_bits, n_res, nf_seed, zero_frame, fac_ns_idx, bw_idx, gg_idx, tns_idx,
            tns_order, scf, scf_e)
    if nm.on_cpu(x):
        return spectrum_decode_plain(*args)
    return kernels.fx_spec_decode(*(a.contiguous() if isinstance(a, torch.Tensor) else a
                                    for a in args))


# ----------------------------------------------------------- transform

def _headroom32(y):
    """getScaleFactor32_0 per row: the least norm_l of the nonzero
    entries, 32 if the row is zero."""
    nz = y != 0
    return torch.amin(torch.where(nz, fd.norm_l(torch.where(nz, y, 1)), 32), dim=1)


def batch_dct4_plain(y, y_e, N: int, frame_dms: int = 100):
    """ProcessingIMDCT's front half (imdct_fx.c:60-115) over [L] rows: the
    bandwidth cap, the headroom pre-scale, dct_IV and the exponent rules.
    y [L, N], y_e [L]. Returns (ytda [L, N], y_e, y_s, zero) int64 (zero
    bool); the plain version of the `fx_dct4` kernel."""
    y = _i64(y)
    y_e = _i64(y_e)
    max_bw = fi.MAX_BW >> {25: 2, 50: 1, 100: 0}[frame_dms]
    if N > max_bw:
        y = y.clone()
        y[:, max_bw:] = 0
    y_s = _headroom32(y)
    zero = y_s >= 32
    ys_eff = torch.where(zero, 0, y_s)
    pd = [fd.L_shl(y[:, j], ys_eff) for j in range(N)]
    y_e = y_e - ys_eff
    pd, sc_add = fi.dct_IV(pd, N)
    y_e = y_e + sc_add
    out = torch.stack(pd, dim=1)
    y_s2 = _headroom32(out) - 1
    y_e = y_e - (y_s2 + 3)
    if N <= 20:
        y_e = y_e + 2
    elif N <= 120:
        y_e = y_e + 1
    y_e = torch.where(zero, 0, y_e)
    return out, y_e, y_s2, zero


def batch_dct4(y, y_e, N: int, frame_dms: int = 100):
    """The fixed DCT-IV: the `fx_dct4` kernel for a tensor on the card
    (N = 480 only), its plain version on the CPU."""
    if nm.on_cpu(y):
        return batch_dct4_plain(y, y_e, N, frame_dms)
    return kernels.fx_dct4(y.contiguous(), y_e.contiguous(), N, frame_dms)


# ----------------------------------------------------- overlap-add, PCM

def imdct_ola(ytda, y_e, y_s, zero, w, N: int, wLen: int, mem, mem_e):
    """ProcessingIMDCT's back half (imdct_fx.c:115-175) over [B] streams:
    the exponent alignment, TDA unfold, window and overlap-add in Word16.
    Returns (x [B, N], y_e', new_mem, new_mem_e)."""
    z = 2 * N - wLen
    m = N >> 1
    o = m - z
    memLen = wLen - N
    # the reference broadcasts a memory of no columns; no 10 ms size has one
    assert memLen > 0, "imdct_ola: the window leaves no overlap memory"
    dev = ytda.device
    y = _i64(ytda)
    y_e = torch.where(zero, 0, _i64(y_e))
    y_s = _i64(y_s)
    mem, mem_e = _i64(mem), _i64(mem_e)
    nz = mem != 0
    mem_s = torch.amin(torch.where(nz, fd.norm_l(torch.where(nz, mem, 1)) - 16, 16), dim=1)
    has_hr = mem_s < 16
    mem_s = torch.where(has_hr, mem_s - 1, mem_s)
    mem_e = torch.where(has_hr, mem_e - mem_s, y_e)
    s = mem_e - y_e
    pos = s > 0
    y_s = torch.where(pos, y_s - s, y_s)
    y_e = torch.where(pos, y_e + s, y_e)
    mem_s = torch.where(pos, mem_s, mem_s + s)
    mem_s = torch.clamp(mem_s, min=-31)
    y_s = torch.clamp(y_s, min=-31)

    w = torch.as_tensor(np.asarray(w, np.int64), device=dev)
    ms = mem_s[:, None]
    ys = y_s[:, None]
    i_o = torch.arange(o, device=dev)
    x0 = fd.round_fx(fi.lsub(fd.L_shl(mem[:, :o] << 16, ms),
                             fd.mpy_32_16(fd.L_shl(y[:, m + i_o + z], ys),
                                          w[4 * m - 1 - i_o - z][None, :])))
    i_m = torch.arange(m, device=dev)
    x1 = fd.round_fx(fi.ladd(fd.L_shl(mem[:, o: o + m] << 16, ms),
                             fd.mpy_32_16(fd.L_shl(y[:, 2 * m - 1 - i_m], ys),
                                          w[3 * m - 1 - i_m][None, :])))
    xa = fd.round_fx(fi.lneg(fd.mpy_32_16(fd.L_shl(y[:, i_m], ys), w[m - 1 - i_m][None, :])))
    xb = fd.round_fx(fi.lneg(fd.mpy_32_16(fd.L_shl(y[:, i_m], ys), w[m + i_m][None, :])))
    # x[3m-z : 4m-z] = xa; x[3m-z-1-i] = xb (i ascending)
    x = torch.cat([x0, x1, torch.flip(xb, dims=[1]), xa], dim=1)   # [B, wLen]
    return x[:, :N], y_e, x[:, N: N + memLen], y_e


def round_pcm16(x, x_e):
    """dec_lc3.c:289-295: round_fx_sat(L_shr_sat(L_deposit_h(x), 15 - e))."""
    s = 15 - _i64(x_e)
    v = _i64(x) << 16
    vr = v >> torch.clamp(s, 0, 63)[:, None]
    vl = fd.sat32(v << torch.clamp(-s, 0, 63)[:, None])
    v = torch.where((s >= 0)[:, None], vr, vl)
    v = fd.sat32(v + 0x8000) >> 16
    return fd.sat16(v).to(torch.int16)
