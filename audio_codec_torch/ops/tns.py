"""Temporal Noise Shaping: analysis, quantization, lattice filters.

processTnsCoder_fl (tns_coder.c:157-362) and processTnsDecoder_fl
(tns_decoder.c:13-51), as in `audio_codec_tpu/ops/tns.py`: masked
reductions over the per-stream subdivisions, Levinson-Durbin unrolled at
order 8, and the lattice filters as a loop over bins with [B, 8] state.
"""
from __future__ import annotations

import math

import torch

from .. import kernels
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


def _lag_sums(x, m, max_order: int, card: bool):
    """The energy and the autocorrelation at lags 0..max_order of x over the
    bins where m is set, per stream: [B], [B, max_order + 1]. On the CPU
    masked `torch.sum`s; for a tensor on the card one chain per lag from
    zero, bins ascending (the kernel's order; the energy is the lag-0
    chain), over the bins below the highest bandwidth cutoff."""
    B, N = x.shape
    zero = torch.zeros((), dtype=F32, device=x.device)
    prods = []
    for lag in range(max_order + 1):
        p = torch.where(m[:, : N - lag] & m[:, lag:], x[:, : N - lag] * x[:, lag:], zero)
        prods.append(torch.nn.functional.pad(p, (0, lag)) if card else p)
    if not card:
        xm = torch.where(m, x, zero)
        return torch.sum(xm * xm, dim=-1), torch.stack([torch.sum(p, -1) for p in prods], -1)
    prods = torch.stack(prods, dim=1)                     # [B, lags, N]
    acf = torch.zeros((B, max_order + 1), dtype=F32, device=x.device)
    for i in range(min(N, int(T.bw_cutoff_bins(100).max()))):
        acf = acf + prods[:, :, i]
    return acf[:, 0], acf


def _analyze(cfg: Config, x, bw_idx):
    """The TNS filter analysis (tns_coder.c:157-329) of both filters, with
    the prediction gains [B, 2] (0 where a stream has one filter) beside
    the outputs of tns_filter_analysis_plain."""
    B, Nfull = x.shape
    dev = x.device
    card = not nm.on_cpu(x)
    _, _, nf_max, max_order, n_sub, max_pg, order_bits_tab = _tns_geometry(cfg)
    two_filters = (bw_idx >= 3) & (nf_max == 2)
    numfilters = torch.where(two_filters, 2, 1).to(I32)
    lo, hi = _filter_ranges(cfg, bw_idx, numfilters, B, dev)
    starts, stops = lo + 1, hi + 1

    lagw = nm.table(T.t, "lagw_tns", device=dev)[: max_order + 1]
    thr = nm.table(T.t, "quants_thr_tns", device=dev)
    quants_pts = nm.table(T.t, "quants_pts_tns", device=dev)
    huff_bits = nm.table(T.t, "huff_bits_tns", device=dev, dtype=I32)   # [8, 17]
    order_bits_tab = nm.table(T.t, "order1_tns" if max_pg == 1.5 else "order2_tns",
                              device=dev, dtype=I32)
    bins = torch.arange(Nfull, device=dev)[None, :]
    lanes = torch.arange(MAXLAG, device=dev)[None, :]
    zero = torch.zeros((), dtype=F32, device=dev)

    def analyze_filter(f):
        st, sp = starts[:, f], stops[:, f]
        # a product by the float32 reciprocal, as numerics.div on the CPU,
        # written out so that the card computes it so too
        subdiv_len = (sp.to(F32) + 1.0 - st.to(F32)) * nm.f32(1.0 / n_sub)
        r = torch.zeros((B, max_order + 1), dtype=F32, device=dev)
        dead = torch.zeros((B,), dtype=torch.bool, device=dev)
        for sub in range(1, n_sub + 1):
            s_lo = torch.floor(subdiv_len * (sub - 1)).to(I32) + st - 1
            s_hi = torch.floor(subdiv_len * sub).to(I32) + st - 1
            m = (bins >= s_lo[:, None]) & (bins < s_hi[:, None])
            e, acf = _lag_sums(x, m, max_order, card)
            dead = dead | (e == 0)
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
        base = torch.where(weight, alpha, 1.0)[:, None]
        if card:
            # alpha^k as a chain of products, as the kernel computes it
            powers = [torch.ones_like(base), base]
            while len(powers) < max_order + 1:
                powers.append(powers[-1] * base)
            powers = torch.cat(powers, dim=-1)
        else:
            powers = nm.pow(base, torch.arange(max_order + 1, dtype=F32, device=dev)[None, :])
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
        return tns_on, order, rc_idx, rc_q, bits_f.to(I32), pred_gain

    act0, ord0, idx0, rcq0, bits0, pg0 = analyze_filter(0)
    if nf_max == 2:
        act1, ord1, idx1, rcq1, bits1, pg1 = analyze_filter(1)
    else:
        act1 = torch.zeros((B,), dtype=torch.bool, device=dev)
        ord1 = torch.zeros((B,), dtype=I32, device=dev)
        idx1 = torch.zeros((B, MAXLAG), dtype=I32, device=dev)
        rcq1 = torch.zeros((B, MAXLAG), dtype=F32, device=dev)
        bits1 = torch.zeros((B,), dtype=I32, device=dev)
        pg1 = torch.zeros((B,), dtype=F32, device=dev)
    act1 = act1 & two_filters
    bits = bits0 + torch.where(two_filters, bits1, 0)

    rc = torch.stack([torch.where(act0[:, None], rcq0, zero),
                      torch.where(act1[:, None], rcq1, zero)], 1)
    order_out = torch.stack([torch.where(act0, ord0, 0),
                             torch.where(act1, ord1, 0)], 1).to(I32)
    rc_idx_out = torch.stack([torch.where(act0[:, None], idx0, 0),
                              torch.where(act1[:, None], idx1, 0)], 1).to(I32)
    gains = torch.stack([pg0, torch.where(two_filters, pg1, 0.0)], 1)
    return (order_out, rc_idx_out, rc, numfilters, bits.to(I32)), gains


def tns_filter_analysis_plain(cfg: Config, x, bw_idx):
    """The TNS filter analysis of both filters (tns_coder.c:157-329); the
    plain version of the `tns_filter_analysis` kernel. x: [B, N] shaped
    spectrum; bw_idx: [B] i32. Returns (order [B, 2] i32, rc_idx [B, 2, 8]
    i32, rc_q [B, 2, 8] f32, numfilters [B] i32, bits [B] i32), every
    output of a filter that is off masked to 0 (bits to 1).

    For a tensor on the card it states the kernel's float order: the lag
    sums are chains (`_lag_sums`) and the weighting's powers a chain of
    products. At max_pg 1.5 the weighting's alpha divides by zero; it is
    only taken where TNS is off, whose outputs are masked."""
    return _analyze(cfg, x, bw_idx)[0]


def tns_filter_analysis(cfg: Config, x, bw_idx):
    """The filter analysis: the CUDA kernel for a tensor on the card, its
    plain version for a tensor on the CPU."""
    if nm.on_cpu(x):
        return tns_filter_analysis_plain(cfg, x, bw_idx)
    return kernels.tns_filter_analysis(cfg, x.contiguous(), bw_idx.contiguous())


def tns_encode(cfg: Config, x, bw_idx):
    """TNS analysis + filtering. x: [B, N] shaped spectrum; bw_idx: [B] i32.
    Returns (x_filt [B, N], order [B, 2] i32, rc_idx [B, 2, 8] i32,
             numfilters [B] i32, bits [B] i32)."""
    B = x.shape[0]
    order, rc_idx, rc, numfilters, bits = tns_filter_analysis(cfg, x, bw_idx)
    lo, hi = _filter_ranges(cfg, bw_idx, numfilters, B, x.device)
    x_out = tns_analysis_lattice(x, rc, order, lo, hi)
    return x_out, order, rc_idx, numfilters, bits


def _filter_ranges(cfg: Config, bw_idx, numfilters, B: int, dev):
    """First and last bin (0-based, inclusive) of each filter [B, 2]
    (tns_coder.c:244-263)."""
    cutoffs = nm.table(T.bw_cutoff_bins, cfg.frame_dms, device=dev, dtype=I32)
    bw_fcbin = cutoffs[bw_idx.clamp(0, cutoffs.shape[0] - 1).long()]
    startfreq0 = _tns_geometry(cfg)[1]
    two = numfilters == 2
    half = torch.div(bw_fcbin, 2, rounding_mode="floor")
    start0 = torch.full((B,), startfreq0, dtype=I32, device=dev)
    stop0 = torch.where(two, half, bw_fcbin)
    lo = torch.stack([start0, half + 1], 1) - 1
    hi = torch.stack([stop0, bw_fcbin], 1) - 1
    return lo.to(I32), hi.to(I32)


def tns_decode(cfg: Config, x, rc_idx, order, numfilters, bw_idx):
    """Inverse lattice filter (processTnsDecoder_fl, tns_decoder.c:13-51).
    x: [B, N]; rc_idx: [B, 2, 8]; order: [B, 2]; bw_idx [B]."""
    B = x.shape[0]
    quants_pts = nm.table(T.t, "quants_pts_tns", device=x.device)
    rc = quants_pts[rc_idx.clamp(0, quants_pts.shape[0] - 1).long()]   # [B, 2, 8]
    orders = torch.stack([order[:, 0], torch.where(numfilters == 2, order[:, 1], 0)], 1).to(I32)
    lo, hi = _filter_ranges(cfg, bw_idx, numfilters, B, x.device)
    return tns_synthesis_lattice(x, rc, orders, lo, hi)


def _filter_bins(order, lo, hi, N: int):
    """Per bin of the two filters' ranges: (in filter 1, in either filter,
    the order that applies) as [B, N] tensors. Filter f covers bins
    lo[:, f]..hi[:, f] inclusive where order[:, f] > 0; filter 1 wins."""
    bins = torch.arange(N, device=order.device)[None, :]
    inside = [(order[:, f: f + 1] > 0) & (bins >= lo[:, f: f + 1]) & (bins <= hi[:, f: f + 1])
              for f in (0, 1)]
    return inside[1], inside[0] | inside[1], torch.where(inside[1], order[:, 1:2],
                                                         order[:, 0:1])


def tns_analysis_lattice_plain(x, rc, order, lo, hi):
    """The encoder's lattice (tns_coder.c:330-360) over the bins, with [B, 8]
    state carried across both filters; the plain version of the
    `tns_analysis_lattice` kernel. x [B, N] f32; rc [B, 2, 8] f32; order,
    lo, hi [B, 2] i32 (see _filter_bins). Returns the filtered x.

    Each product is contracted where XLA:CPU contracts it in the reference's
    scan body (read from its object code): every product but, for B > 1, the
    last tap's product into the output. The contracted products are
    `numerics.xla_fma` on every device, card included, so the card takes the
    CPU's contraction (the kernel writes them as `xfma_d`)."""
    B, N = x.shape
    in_f1, active, ordsel = _filter_bins(order, lo, hi, N)
    lanes = torch.arange(MAXLAG, device=x.device)[None, :]
    st_c = torch.zeros((B, MAXLAG), dtype=F32, device=x.device)
    ys = []
    for n in range(N):
        xb, use_f1, act, o = x[:, n], in_f1[:, n], active[:, n], ordsel[:, n]
        rcn = torch.where(use_f1[:, None], rc[:, 1], rc[:, 0])
        s = xb
        tmp_save = s
        new_st = st_c.clone()
        for j in range(MAXLAG - 1):
            live = j < (o - 1)
            tmp_fl = nm.xla_fma(rcn[:, j], s, st_c[:, j])
            s_new = nm.xla_fma(rcn[:, j], st_c[:, j], s)
            new_st[:, j] = torch.where(act & live, tmp_save, new_st[:, j])
            tmp_save = torch.where(live, tmp_fl, tmp_save)
            s = torch.where(live, s_new, s)
        last = torch.clamp(o - 1, 0, MAXLAG - 1).long()[:, None]
        st_last = torch.gather(st_c, 1, last)[:, 0]
        rc_last = torch.gather(rcn, 1, last)[:, 0]
        s = nm.xla_fma(rc_last, st_last, s) if B == 1 else s + rc_last * st_last
        new_st = torch.where(act[:, None] & (lanes == last), tmp_save[:, None], new_st)
        ys.append(torch.where(act, s, xb))
        st_c = torch.where(act[:, None], new_st, st_c)
    return torch.stack(ys, dim=-1)


def tns_synthesis_lattice_plain(x, rc, order, lo, hi):
    """The decoder's inverse lattice (tns_decoder.c:13-51) over the bins;
    the plain version of the `tns_synthesis_lattice` kernel. Arguments as
    tns_analysis_lattice_plain.

    On the CPU: XLA:CPU computes each state lane in its own fusion, each
    recomputing the chain of s. For B > 1 the first product
    (x - rc[last] * st[last]) is contracted only in the fusions of state
    lanes 5-7, so those lanes follow a second chain; every later product is
    contracted everywhere, and at B = 1 the first one too. The contracted
    products are `numerics.xla_fma` on every device, card included, so the
    card takes the CPU's contraction (the kernel writes them as `xfma_d`)."""
    B, N = x.shape
    in_f1, active, ordsel = _filter_bins(order, lo, hi, N)
    st_c = torch.zeros((B, MAXLAG), dtype=F32, device=x.device)
    ys = []
    for n in range(N):
        xb, use_f1, actb, o = x[:, n], in_f1[:, n], active[:, n], ordsel[:, n]
        rcf = torch.where(use_f1[:, None], rc[:, 1], rc[:, 0])
        last = torch.clamp(o - 1, 0, MAXLAG - 1).long()[:, None]
        rc_last = torch.gather(rcf, 1, last)[:, 0]
        st_last = torch.gather(st_c, 1, last)[:, 0]
        s_f = nm.xla_fma(-rc_last, st_last, xb)      # the chain of state lanes 5-7
        s = s_f if B == 1 else xb - rc_last * st_last
        new_st = st_c.clone()
        for el in range(MAXLAG - 2, -1, -1):
            live = el <= (o - 2)
            s_new = nm.xla_fma(-rcf[:, el], st_c[:, el], s)
            if el >= 4:
                s_f = torch.where(live, nm.xla_fma(-rcf[:, el], st_c[:, el], s_f), s_f)
                upd = nm.xla_fma(rcf[:, el], s_f, st_c[:, el])
            else:
                upd = nm.xla_fma(rcf[:, el], s_new, st_c[:, el])
            new_st[:, el + 1] = torch.where(actb & live, upd, new_st[:, el + 1])
            s = torch.where(live, s_new, s)
        new_st[:, 0] = torch.where(actb, s, new_st[:, 0])
        ys.append(torch.where(actb, s, xb))
        st_c = torch.where(actb[:, None], new_st, st_c)
    return torch.stack(ys, dim=-1)


def tns_analysis_lattice(x, rc, order, lo, hi):
    """The encoder's lattice: the CUDA kernel for a tensor on the card, its
    plain version for a tensor on the CPU."""
    if nm.on_cpu(x):
        return tns_analysis_lattice_plain(x, rc, order, lo, hi)
    return kernels.tns_analysis_lattice(*(t.contiguous() for t in (x, rc, order, lo, hi)))


def tns_synthesis_lattice(x, rc, order, lo, hi):
    """The decoder's lattice: the CUDA kernel for a tensor on the card, its
    plain version for a tensor on the CPU."""
    if nm.on_cpu(x):
        return tns_synthesis_lattice_plain(x, rc, order, lo, hi)
    return kernels.tns_synthesis_lattice(*(t.contiguous() for t in (x, rc, order, lo, hi)))
