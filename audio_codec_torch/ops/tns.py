"""Temporal Noise Shaping: analysis, quantization, lattice filters.

processTnsCoder_fl (tns_coder.c:157-362) and processTnsDecoder_fl
(tns_decoder.c:13-51), as in `audio_codec_tpu/ops/tns.py`: masked
reductions over the per-stream subdivisions, Levinson-Durbin unrolled at
order 8, and the lattice filters as a loop over bins with [B, 8] state.
"""
from __future__ import annotations

import math

import torch

from .. import tables as T
from ..config import Config
from . import numerics as nm

F32 = torch.float32
I32 = torch.int32
MAXLAG = 8


def _tns_geometry(cfg: Config):
    """Static pieces of the filter geometry (tns_coder.c:199-263)."""
    N = cfg.frame_length
    fs = cfg.fs
    if N > 4 * cfg.frame_dms:
        N = 4 * cfg.frame_dms
        fs = 40000
    numfilters_max = 2 if (cfg.fs >= 32000 and cfg.frame_dms >= 50) else 1
    startfreq0 = math.floor(600 * N * 2 / fs) + 1
    max_order = 8 if cfg.frame_dms == 100 else 4
    n_sub = 3 if cfg.frame_dms == 100 else 2
    nbits = cfg.total_bits
    limited = (cfg.frame_dms >= 50 and nbits >= 48 * cfg.frame_dms // 10) \
        or cfg.frame_dms == 25
    max_pg = 1.5 if limited else 2.0
    order_bits = T.t("order1_tns") if limited else T.t("order2_tns")
    return N, startfreq0, numfilters_max, max_order, n_sub, max_pg, order_bits


def _levinson(r, order: int):
    """Batched Levinson-Durbin: r [B, order+1] -> (lpc [B, order+1], rc, err)."""
    g = r[:, 1] / r[:, 0]
    a = [g]
    v = nm.fma(-g, g, 1.0) * r[:, 0]
    rc = [-g]
    for t in range(1, order):
        s = a[0] * r[:, 1]
        for i in range(1, t):
            s = nm.fma(a[i], r[:, i + 1], s)
        g = (r[:, t + 1] - s) / v
        a = [g] + [nm.fma(-g, a[t - j], a[j - 1]) for j in range(1, t + 1)]
        v = v * nm.fma(-g, g, 1.0)
        rc.append(-g)
    lpc = torch.stack([torch.ones_like(v)] + [-a[order - 1 - i] for i in range(order - 1)]
                      + [rc[order - 1]], dim=-1)
    return lpc, torch.stack(rc, dim=-1), v


def _poly2rc(a, order: int):
    """Batched poly2rc via levdown: a [B, order+1] (a[0]==1) -> rc [B, order]."""
    out = [None] * order
    cur = a
    n = order
    out[order - 1] = cur[:, order]
    for k in range(order - 2, -1, -1):
        knxt = cur[:, n]
        denom = nm.fma(-knxt, knxt, 1.0)
        nxt = [nm.fma(-knxt, cur[:, n - 1 - i], cur[:, i + 1]) / denom
               for i in range(n - 1)]
        cur = torch.stack([torch.ones_like(knxt)] + nxt, dim=-1)
        n -= 1
        out[k] = cur[:, n]
    return torch.stack(out, dim=-1)


def tns_encode(cfg: Config, x, bw_idx):
    """TNS analysis + filtering. x: [B, N] shaped spectrum; bw_idx: [B] i32.
    Returns (x_filt [B, N], order [B, 2] i32, rc_idx [B, 2, 8] i32,
             numfilters [B] i32, bits [B] i32)."""
    B, Nfull = x.shape
    dev = x.device
    _, startfreq0, nf_max, max_order, n_sub, max_pg, order_bits_tab = _tns_geometry(cfg)
    cutoffs = nm.const(T.bw_cutoff_bins(cfg.frame_dms), dev, I32)
    bw_fcbin = cutoffs[bw_idx.long()]

    two_filters = (bw_idx >= 3) & (nf_max == 2)
    numfilters = torch.where(two_filters, 2, 1).to(I32)
    start0 = torch.full((B,), startfreq0, dtype=I32, device=dev)
    half = torch.div(bw_fcbin, 2, rounding_mode="floor")
    stop0 = torch.where(two_filters, half, bw_fcbin)
    start1 = half + 1
    stop1 = bw_fcbin
    starts = torch.stack([start0, start1], dim=1)
    stops = torch.stack([stop0, stop1], dim=1)

    lagw = nm.const(T.t("lagw_tns")[: max_order + 1], dev)
    thr = nm.const(T.t("quants_thr_tns"), dev)
    quants_pts = nm.const(T.t("quants_pts_tns"), dev)
    huff_bits = nm.const(T.t("huff_bits_tns"), dev, I32)      # [8, 17]
    order_bits_tab = nm.const(order_bits_tab, dev, I32)
    bins = torch.arange(Nfull, device=dev)[None, :]
    lanes = torch.arange(MAXLAG, device=dev)[None, :]
    zero = torch.zeros((), dtype=F32, device=dev)

    def analyze_filter(f):
        st, sp = starts[:, f], stops[:, f]
        subdiv_len = nm.div(sp.to(F32) + 1.0 - st.to(F32), n_sub)
        r = torch.zeros((B, max_order + 1), dtype=F32, device=dev)
        dead = torch.zeros((B,), dtype=torch.bool, device=dev)
        for sub in range(1, n_sub + 1):
            s_lo = torch.floor(subdiv_len * (sub - 1)).to(I32) + st - 1
            s_hi = torch.floor(subdiv_len * sub).to(I32) + st - 1
            m = (bins >= s_lo[:, None]) & (bins < s_hi[:, None])
            xm = torch.where(m, x, zero)
            e = torch.sum(xm * xm, dim=-1)
            dead = dead | (e == 0)
            acfs = []
            for lag in range(max_order + 1):
                prod = torch.where(m[:, : Nfull - lag] & m[:, lag:],
                                   x[:, : Nfull - lag] * x[:, lag:], zero)
                acfs.append(torch.sum(prod, dim=-1))
            acf = torch.stack(acfs, dim=-1)
            r = r + acf / torch.clamp(e, min=1e-30)[:, None]
        unit = torch.cat([torch.ones((B, 1), dtype=F32, device=dev),
                          torch.zeros((B, max_order), dtype=F32, device=dev)], -1)
        r = torch.where(dead[:, None], unit, r)
        r = r * lagw[None, :]
        lpc, rc_unq, err = _levinson(r, max_order)
        pred_gain = r[:, 0] / err
        tns_on = pred_gain > 1.5

        alpha = (max_pg - pred_gain) * (0.85 - 1.0) / (max_pg - 1.5) + 1.0
        weight = pred_gain < max_pg
        powers = nm.pow(torch.where(weight, alpha, 1.0)[:, None],
                        torch.arange(max_order + 1, dtype=F32, device=dev)[None, :])
        rc_w = _poly2rc(lpc * powers, max_order)
        rc_used = torch.where(weight[:, None], rc_w, rc_unq)

        v = rc_used[:, :, None]
        rc_idx = torch.clamp(torch.sum((v > thr[None, None, :-1]).to(I32), -1) - 1, 0, 16)
        if max_order < MAXLAG:
            rc_idx = torch.cat([rc_idx, torch.full((B, MAXLAG - max_order), 8,
                                                   dtype=rc_idx.dtype, device=dev)], -1)
        rc_idx = rc_idx.to(I32)
        rc_q = quants_pts[rc_idx.long()]
        nz = rc_q != 0
        last_nz = torch.where(nz, lanes + 1, 0).max(dim=-1).values
        order = torch.where(nz.any(-1), last_nz, 1).to(I32)

        ob = order_bits_tab[torch.clamp(order - 1, 0, 7).long()]
        hb = torch.where(lanes < order[:, None],
                         huff_bits[lanes.expand(B, -1), rc_idx.long()], 0).sum(-1)
        coef_bits = torch.ceil((ob + hb).to(F32) / 2048.0).to(I32)
        bits_f = 1 + torch.where(tns_on, coef_bits, 0)
        return tns_on, order, rc_idx, rc_q, bits_f.to(I32)

    act0, ord0, idx0, rcq0, bits0 = analyze_filter(0)
    if nf_max == 2:
        act1, ord1, idx1, rcq1, bits1 = analyze_filter(1)
    else:
        act1 = torch.zeros((B,), dtype=torch.bool, device=dev)
        ord1 = torch.zeros((B,), dtype=I32, device=dev)
        idx1 = torch.zeros((B, MAXLAG), dtype=I32, device=dev)
        rcq1 = torch.zeros((B, MAXLAG), dtype=F32, device=dev)
        bits1 = torch.zeros((B,), dtype=I32, device=dev)
    act1 = act1 & two_filters
    bits = bits0 + torch.where(two_filters, bits1, 0)

    rc0 = torch.where(act0[:, None], rcq0, zero)
    rc1 = torch.where(act1[:, None], rcq1, zero)
    in_f0 = act0[:, None] & (bins >= start0[:, None] - 1) & (bins <= stop0[:, None] - 1)
    in_f1 = act1[:, None] & (bins >= start1[:, None] - 1) & (bins <= stop1[:, None] - 1)
    ordsel = torch.where(in_f1, ord1[:, None], ord0[:, None])
    active_bin = in_f0 | in_f1

    st_c = torch.zeros((B, MAXLAG), dtype=F32, device=dev)
    ys = []
    for n in range(Nfull):
        xb, use_f1, act, order = x[:, n], in_f1[:, n], active_bin[:, n], ordsel[:, n]
        rc = torch.where(use_f1[:, None], rc1, rc0)
        s = xb
        tmp_save = s
        new_st = st_c.clone()
        for j in range(MAXLAG - 1):
            live = j < (order - 1)
            tmp_fl = nm.fma(rc[:, j], s, st_c[:, j])
            s_new = nm.fma(rc[:, j], st_c[:, j], s)
            new_st[:, j] = torch.where(act & live, tmp_save, new_st[:, j])
            tmp_save = torch.where(live, tmp_fl, tmp_save)
            s = torch.where(live, s_new, s)
        last = torch.clamp(order - 1, 0, MAXLAG - 1).long()[:, None]
        st_last = torch.gather(st_c, 1, last)[:, 0]
        rc_last = torch.gather(rc, 1, last)[:, 0]
        s = nm.fma(rc_last, st_last, s)
        new_st = torch.where(act[:, None] & (lanes == last), tmp_save[:, None], new_st)
        ys.append(torch.where(act, s, xb))
        st_c = torch.where(act[:, None], new_st, st_c)
    x_out = torch.stack(ys, dim=-1)

    order_out = torch.stack([torch.where(act0, ord0, 0), torch.where(act1, ord1, 0)], 1)
    rc_idx_out = torch.stack([torch.where(act0[:, None], idx0, 0),
                              torch.where(act1[:, None], idx1, 0)], 1)
    return x_out, order_out.to(I32), rc_idx_out.to(I32), numfilters, bits


def tns_decode(cfg: Config, x, rc_idx, order, numfilters, bw_idx):
    """Inverse lattice filter (processTnsDecoder_fl, tns_decoder.c:13-51).
    x: [B, N]; rc_idx: [B, 2, 8]; order: [B, 2]; bw_idx [B]."""
    B, Nfull = x.shape
    dev = x.device
    cutoffs = nm.const(T.bw_cutoff_bins(cfg.frame_dms), dev, I32)
    bw_fcbin = cutoffs[bw_idx.clamp(0, cutoffs.shape[0] - 1).long()]
    startfreq0 = math.floor(600 * cfg.N_red_tns * 2 / cfg.fs_red_tns) + 1
    two = numfilters == 2
    half = torch.div(bw_fcbin, 2, rounding_mode="floor")
    start0 = torch.full((B,), startfreq0, dtype=I32, device=dev)
    stop0 = torch.where(two, half, bw_fcbin)
    start1 = half + 1
    stop1 = bw_fcbin
    quants_pts = nm.const(T.t("quants_pts_tns"), dev)
    rc = quants_pts[rc_idx.clamp(0, quants_pts.shape[0] - 1).long()]   # [B, 2, 8]
    act = order > 0

    bins = torch.arange(Nfull, device=dev)[None, :]
    in_f0 = act[:, 0:1] & (bins >= start0[:, None] - 1) & (bins <= stop0[:, None] - 1)
    in_f1 = act[:, 1:2] & two[:, None] & (bins >= start1[:, None] - 1) & \
        (bins <= stop1[:, None] - 1)
    active_bin = in_f0 | in_f1
    ordsel = torch.where(in_f1, order[:, 1:2], order[:, 0:1])

    st_c = torch.zeros((B, MAXLAG), dtype=F32, device=dev)
    ys = []
    for n in range(Nfull):
        xb, use_f1, actb, ordb = x[:, n], in_f1[:, n], active_bin[:, n], ordsel[:, n]
        rcf = torch.where(use_f1[:, None], rc[:, 1], rc[:, 0])
        last = torch.clamp(ordb - 1, 0, MAXLAG - 1).long()[:, None]
        rc_last = torch.gather(rcf, 1, last)[:, 0]
        st_last = torch.gather(st_c, 1, last)[:, 0]
        s = xb - rc_last * st_last   # not contracted by XLA:CPU, the others are
        new_st = st_c.clone()
        for el in range(MAXLAG - 2, -1, -1):
            live = el <= (ordb - 2)
            s_new = nm.fma(-rcf[:, el], st_c[:, el], s)
            upd = nm.fma(rcf[:, el], s_new, st_c[:, el])
            new_st[:, el + 1] = torch.where(actb & live, upd, new_st[:, el + 1])
            s = torch.where(live, s_new, s)
        new_st[:, 0] = torch.where(actb, s, new_st[:, 0])
        ys.append(torch.where(actb, s, xb))
        st_c = torch.where(actb[:, None], new_st, st_c)
    return torch.stack(ys, dim=-1)
