"""Partial concealment: conceal only the corrupted spectral region.

Counterpart of `audio_codec_tpu/ops/pc.py` (processPCmain_fx,
processPCclassify_fx / peakDetector_fx, processPCapply_fx,
processPCupdate_fx and the PLC stability factor). These run on every
decoded frame; on clean frames they only carry the history forward.
"""
from __future__ import annotations

import torch

from ..config import Config
from .quant import global_gain

I32 = torch.int32
F32 = torch.float32

_BLOCK = 3   # peakDetector BLOCK_SIZE
_THR1 = 8


def compute_stab_fac(scf_q, old_scf, old_old_scf, bfi, prev_bfi, prev_prev_bfi):
    """Scale-factor stability in [0,1] (processPLCcomputeStabFac_main)."""
    def stab(a, b, pbfi):
        d = torch.sum((a - b) ** 2, dim=-1)
        s = torch.clamp(1.25 - d / 25.0, 0.0, 1.0)
        return torch.where(pbfi == 1, 0.8, s)

    s1 = stab(old_scf, old_old_scf, prev_prev_bfi)
    s2 = stab(scf_q, old_scf, prev_bfi)
    out = torch.ones(scf_q.shape[0], dtype=F32, device=scf_q.device)
    out = torch.where((bfi == 1) & (prev_bfi != 1), s1, out)
    return torch.where(bfi == 2, s2, out)


def _peak_detector(sig):
    """peakDetector_fx (pc_classify_fx.c:150-299): crossover bin below which
    a dominant spectral peak sits. sig: [B, N] -> xover [B] i32."""
    B, N = sig.shape
    dev = sig.device
    a = torch.abs(sig)
    mean_nrg = _BLOCK * _THR1 * torch.mean(sig ** 2, dim=1)
    sq = sig ** 2
    blk = sq[:, :-2] + sq[:, 1:-1] + sq[:, 2:]

    edge_cent = sq[:, 0] + sq[:, 1]
    cond0 = (a[:, 0] >= a[:, 1]) & (edge_cent > mean_nrg)
    cur0 = torch.maximum(a[:, 0], a[:, 1])
    nxt0 = torch.max(a[:, _BLOCK - 1:_BLOCK + 2], dim=1).values
    hit0 = cond0 & (cur0 > nxt0)
    max_peak = torch.where(hit0, edge_cent, torch.zeros_like(edge_cent))
    xover = torch.where(hit0, 1, 0).to(I32)

    idx = torch.arange(0, N - 2 * _BLOCK + 1, device=dev)

    def win_max(lo_off):
        cols = [a[:, idx + o] for o in range(lo_off, lo_off + 3)]
        return torch.maximum(torch.maximum(cols[0], cols[1]), cols[2])

    locmax = (a[:, idx + 1] >= a[:, idx]) & (a[:, idx + 1] >= a[:, idx + 2])
    cent = blk[:, idx]
    cur = win_max(0)
    prv = win_max(-_BLOCK)
    small = idx[None, :] < _BLOCK
    prv_small = torch.zeros_like(prv)
    for j in range(-_BLOCK, 0):
        valid = (idx + j > 0)[None, :]
        prv_small = torch.where(valid, torch.maximum(prv_small,
                                                     a[:, (idx + j).clamp(0, N - 1)]),
                                prv_small)
    prv = torch.where(small, prv_small, prv)
    nxt = win_max(_BLOCK)
    cand = locmax & (cent > mean_nrg[:, None]) & (cur >= prv) & (cur > nxt)

    # sequential hysteresis over the candidates (only columns with one)
    for k in torch.nonzero(cand.any(dim=0)).flatten().tolist():
        c = cand[:, k]
        ce = cent[:, k]
        take_full = c & (ce >= max_peak)
        take_hyst = c & ~take_full & (ce > 0.3 * max_peak)
        max_peak = torch.where(take_full, ce, max_peak)
        xover = torch.where(take_full | take_hyst, k + _BLOCK - 1, xover)
    return xover.to(I32)


def pc_classify(cfg: Config, bfi, spec_inv_idx, stab_fac, pitch_present,
                q_old_d, q_old_res):
    """processPCclassify_fx: downgrade bfi 2 -> 1 when the corrupt region is
    too low-frequency to conceal partially."""
    N = cfg.yLen
    low_region = spec_inv_idx * 10 < 4 * cfg.frame_dms
    unstable = stab_fac < 0.5
    max_pitch_bin = 4 if cfg.frame_dms == 50 else 8
    xover = _peak_detector(q_old_d)
    pitch_bad = (spec_inv_idx < xover) | (spec_inv_idx < max_pitch_bin)
    low_mask = torch.arange(N, device=bfi.device)[None, :] < spec_inv_idx[:, None]
    zero = torch.zeros((), dtype=F32, device=bfi.device)
    part = torch.sum(torch.where(low_mask, q_old_res ** 2, zero), dim=1)
    full = torch.sum(q_old_res ** 2, dim=1)
    nrg_bad = part < 0.3 * full
    bad = unstable | torch.where(pitch_present == 1, pitch_bad, nrg_bad)
    return torch.where((bfi == 2) & low_region & bad, 1, bfi).to(I32)


def pc_apply(cfg: Config, bfi, x, q_old_res, q_old_d, spec_inv_idx, gg_idx,
             prev_gg, nb_lost):
    """processPCapply_fx: synthesize bins >= spec_inv_idx from the previous
    residual spectrum. Returns (x', fac, nb_lost')."""
    B, N = x.shape
    act = bfi == 2
    nb_lost = (nb_lost + act.to(I32)).to(I32)
    gg = global_gain(cfg, gg_idx)
    kidx = torch.arange(N, device=x.device)[None, :]
    low_mask = (kidx < spec_inv_idx[:, None]).to(F32)
    n_low = torch.clamp(spec_inv_idx.to(F32), min=1.0)
    n_high = torch.clamp((N - spec_inv_idx).to(F32), min=1.0)
    mean_low = torch.sum(low_mask * q_old_d ** 2, dim=1)
    mean_high = torch.sum((1 - low_mask) * q_old_d ** 2, dim=1)
    fewer_low = spec_inv_idx < N - spec_inv_idx
    mean_high = torch.where(fewer_low, mean_high * n_low / n_high, mean_high)
    mean_low = torch.where(fewer_low, mean_low, mean_low * n_high / n_low)

    ener_prev = torch.sum(low_mask * q_old_res ** 2, dim=1)
    ener_curr = torch.sum(low_mask * x ** 2, dim=1)
    fac = torch.where(ener_prev > 0,
                      torch.sqrt(torch.clamp(ener_curr / torch.clamp(ener_prev, min=1e-30),
                                             max=1.0)), 1.0)
    fac_local = torch.where((mean_low <= mean_high)
                            | (ener_prev * prev_gg ** 2 <= ener_curr * gg ** 2),
                            prev_gg / torch.clamp(gg, min=1e-30), fac)
    synth = q_old_res * fac_local[:, None]
    synth = torch.where(torch.abs(synth) < 0.625, 0.0, synth)
    x_out = torch.where(act[:, None] & (kidx >= spec_inv_idx[:, None]), synth, x)
    return x_out, torch.where(act, fac, 1.0), nb_lost


def pc_update(cfg: Config, bfi, rframe, x, spec_inv_idx, gg_idx, fac,
              bw_idx_nf, st_q_old_res, st_prev_gg, st_prev_bw,
              st_prev_fac_ns, fac_ns_idx):
    """processPCupdate_fx: refresh the PC history after a non-lost frame.
    Returns (q_old_res', prev_gg', bw_idx_nf', prev_bw', prev_fac_ns')."""
    act = bfi != 1
    gg = global_gain(cfg, gg_idx)
    prev_gg = torch.where(act, gg, st_prev_gg)
    q_old_res = torch.where(act[:, None], x, st_q_old_res)
    plain = act & (rframe == 0)
    prev_bw = torch.where(plain, bw_idx_nf, st_prev_bw).to(I32)
    prev_fac_ns = torch.where(plain, (8.0 - fac_ns_idx.to(F32)) / 16.0, st_prev_fac_ns)
    redo = act & (rframe != 0) & (bfi == 2) & (bw_idx_nf != st_prev_bw) \
        & (spec_inv_idx < cfg.yLen)
    bw_out = torch.where(redo, st_prev_bw, bw_idx_nf).to(I32)
    damped = torch.clamp(st_prev_fac_ns * fac, 0.0625, 0.5)
    prev_fac_ns = torch.where(redo, damped, prev_fac_ns)
    return q_old_res, prev_gg, bw_out, prev_bw, prev_fac_ns
