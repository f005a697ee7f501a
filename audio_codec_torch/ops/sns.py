"""Spectral Noise Shaping: scale factors, PVQ quantizer, shaping.

- processSnsComputeScf_fl   (sns_compute_scf.c:13-176)
- process_snsQuantizesScf_Enc / _Dec + MPVQ indexing (sns_quantize_scf.c)
- processSnsInterpolateScf_fl (sns_interpolate_scf.c:13-100)
- processMdctShaping_fl      (mdct_shaping.c:13-22)

Counterparts of `audio_codec_tpu/ops/sns.py`; the searches are masked
argmin/argmax over the fixed codebooks and fixed-trip pulse loops.

The vector quantizer's encoder and decoder run as the CUDA kernels
`sns_vq_enc` and `sns_vq_dec` (csrc/sns_vq_enc.cu, csrc/sns_vq_dec.cu) for
tensors on a card, and as `sns_vq_enc_plain` and `sns_vq_dec_plain` on the
CPU. The kernels must give the plain versions' indices and scale factors bit
for bit, so on a card the plain versions state their float order: sums and
the 16-wide products are chains in index order of separately rounded
operations (`numerics.chain_sum`, `numerics.chain_dot`), and `reciprocal`,
`sqrt` and `/` are IEEE operations there. On the CPU they keep the order that
reproduces the reference.
"""
from __future__ import annotations

import functools

import numpy as np
import torch

from .. import kernels
from .. import tables as T
from ..config import Config
from . import numerics as nm

F32 = torch.float32
I32 = torch.int32
M = T.SNS_M


def _sq(v: torch.Tensor) -> torch.Tensor:
    return v * v


def _first_argmin(v: torch.Tensor) -> torch.Tensor:
    m = v.min(dim=-1, keepdim=True).values
    idx = torch.arange(v.shape[-1], device=v.device)
    return torch.where(v == m, idx, v.shape[-1]).min(dim=-1).values


@functools.cache
def _downsample_matrix() -> np.ndarray:
    W = np.array([1, 2, 3, 3, 2, 1], dtype=np.float64) / 12.0
    D = np.zeros((64, 16))
    for n in range(16):
        if n == 0:
            idx = [0, 0, 1, 2, 3, 4]
        elif n == 15:
            idx = [59, 60, 61, 62, 63, 63]
        else:
            idx = list(range(4 * n - 1, 4 * n + 5))
        for w, j in zip(W, idx):
            D[j, n] += w
    return D


@functools.cache
def _attack_smoothing_matrix() -> np.ndarray:
    Sm = np.zeros((16, 16))
    Sm[0, :3] = 1 / 3
    Sm[1, :4] = 1 / 4
    for k in range(2, 14):
        Sm[k, k - 2: k + 3] = 1 / 5
    Sm[14, 12:16] = 1 / 4
    Sm[15, 13:16] = 1 / 3
    return Sm


def compute_scf(cfg: Config, ener, attack_detected):
    """[B, bands] energies -> [B, 16] scale factors (processSnsComputeScf_fl)."""
    B, nb = ener.shape
    dev = ener.device
    x = ener
    if nb < 64:
        d = 64 - nb
        if d < nb:
            x = torch.cat([torch.repeat_interleave(x[:, :d], 2, dim=1), x[:, d:]], -1)
        else:
            n4 = round(abs(1.0 - 32.0 / nb) * nb)
            n2 = nb - n4
            mapping = np.concatenate([np.repeat(np.arange(n4), 4),
                                      np.repeat(np.arange(n4, n4 + n2), 2)])
            x = x[:, torch.as_tensor(mapping, device=dev)]
    xl = torch.cat([x[:, :1], x[:, :-1]], -1)
    xr = torch.cat([x[:, 1:], x[:, -1:]], -1)
    x = nm.fma(0.25, xr, nm.fma(0.25, xl, 0.5 * x))
    i = torch.arange(64, dtype=F32, device=dev)
    x = x * nm.pow(10.0, nm.div(nm.div(i * cfg.tilt, 63.0), 10.0))
    mean = torch.mean(x, dim=-1, keepdim=True)
    nf = torch.clamp(mean * nm.f32(1e-4), min=nm.f32(2.0 ** -32))
    x = torch.maximum(x, nf)
    xlog = nm.log2(x) / 2.0
    xl4 = nm.dot(xlog, nm.const(_downsample_matrix(), dev))
    scf = cfg.sns_damping * (xl4 - torch.mean(xl4, dim=-1, keepdim=True))

    if cfg.attack_handling:
        sm = nm.dot(scf, nm.const(_attack_smoothing_matrix().T, dev))
        sm = 0.5 * (sm - torch.mean(sm, dim=-1, keepdim=True))
        scf = torch.where((attack_detected == 1)[:, None], sm, scf)
    return scf


def _pvq_subpyr_search(x, dim: int, pulses: int):
    """pvq_subpyr_search (sns_quantize_scf.c:43-137). x: [B, 16] target (first
    `dim` used). Returns (y [B,16] i32, y_en1_norm [B,16] f32)."""
    B = x.shape[0]
    dev = x.device
    lane = torch.arange(M, device=dev) < dim
    zero = torch.zeros((), dtype=F32, device=dev)
    xa = torch.where(lane, torch.abs(x), zero)
    xsign = torch.where(x >= 0, 1, -1).to(I32)
    xsum = nm.chain_sum(xa)
    eps = nm.f32(2.0 ** -24)

    proj_fac = torch.reciprocal(xsum[:, None]) * (pulses - 1)
    y = torch.where(lane, torch.floor(xa * proj_fac), zero)
    y = torch.where((xsum > eps)[:, None], y, zero)
    pulse_tot = nm.chain_sum(y)
    yy = nm.chain_sum(y * y) * 0.5
    xy = nm.chain_sum(xa * y)

    for _ in range(pulses):
        need = pulse_tot < pulses
        yy1 = yy + 0.5
        xy2 = _sq(xy[:, None] + xa)
        yyt = yy1[:, None] + y
        best = torch.zeros((B,), dtype=torch.long, device=dev)
        bn = torch.full((B,), -(2.0 ** 15), dtype=F32, device=dev)
        bd = torch.zeros((B,), dtype=F32, device=dev)
        for i in range(min(dim, M)):
            better = xy2[:, i] * bd > yyt[:, i] * bn
            best = torch.where(better, i, best)
            bn = torch.where(better, xy2[:, i], bn)
            bd = torch.where(better, yyt[:, i], bd)
        xy_n = xy + torch.gather(xa, 1, best[:, None])[:, 0]
        yy_n = yy1 + torch.gather(y, 1, best[:, None])[:, 0]
        y_n = y + torch.nn.functional.one_hot(best, M).to(F32)
        y = torch.where(need[:, None], y_n, y)
        pulse_tot = torch.where(need, pulse_tot + 1, pulse_tot)
        yy = torch.where(need, yy_n, yy)
        xy = torch.where(need, xy_n, xy)
    yy = yy * 2.0

    y_deg = torch.zeros((B, M), dtype=F32, device=dev)
    y_deg[:, 0] = pulses // 2
    if dim > 1:
        # the C writes y[dim] (one past the active range, sns_quantize_scf.c:121)
        y_deg[:, min(dim, M - 1)] = -(pulses - pulses // 2)
    yy_deg = nm.chain_sum(y_deg * y_deg)
    use_deg = xsum <= eps
    y = torch.where(use_deg[:, None], y_deg, y)
    yy = torch.where(use_deg, yy_deg, yy)

    gain = torch.reciprocal(torch.sqrt(yy))
    y_signed = (y * xsign).to(I32)
    return y_signed, y_signed.to(F32) * gain[:, None]


def _pvq_enc(pulses, length: int):
    """MPVQ index (pvq_enc): [B,16] i32 -> (LS_ind [B], MPVQ_ind [B])."""
    A = nm.const(T.t("pvq_enc_A"), pulses.device, I32)       # [16, 11]
    B_ = pulses.shape[0]
    ls = torch.full((B_,), -1, dtype=I32, device=pulses.device)
    mpvq = torch.zeros((B_,), dtype=I32, device=pulses.device)
    k = torch.zeros((B_,), dtype=I32, device=pulses.device)
    for pos in range(length - 1, -1, -1):
        p = pulses[:, pos]
        nz = p != 0
        mpvq = torch.where((ls >= 0) & nz, 2 * mpvq + ls, mpvq)
        ls = torch.where(p > 0, 0, torch.where(p < 0, 1, ls)).to(I32)
        mpvq = mpvq + A[length - pos - 1, k.clamp(0, 10).long()]
        k = k + torch.abs(p)
    return ls, mpvq


def _pvq_dec(k: int, m: int, ls_ind, mpvq_ind):
    """MPVQ de-index (pvq_dec, sns_quantize_scf.c:520-560) -> pulses [B,16]."""
    dev = ls_ind.device
    A = T.t("pvq_enc_A").astype(np.int64)
    B_ = ls_ind.shape[0]
    cols = torch.arange(M, device=dev)
    leading_sign = 1 - 2 * ls_ind
    pulses = torch.zeros((B_, M), dtype=I32, device=dev)
    mpvq = mpvq_ind
    kk = torch.full((B_,), k, dtype=I32, device=dev)
    done = torch.zeros((B_,), dtype=torch.bool, device=dev)
    for pos in range(m):
        row = nm.const(A[m - pos - 1, : k + 1], dev, I32)
        cnt = torch.sum((mpvq[:, None] >= row[None, :]).to(I32), dim=1)
        idx = torch.minimum(torch.clamp(cnt - 1, min=0), kk)
        terminal = (mpvq == 0) & ~done
        at = (cols == pos)[None, :]
        pulses = torch.where(terminal[:, None] & at,
                             (leading_sign * kk)[:, None], pulses)
        done = done | terminal
        live = ~done
        mpvq_n = mpvq - row[idx.clamp(0, k).long()]
        k_delta = kk - idx
        has_delta = (k_delta != 0) & live
        pulses = torch.where(has_delta[:, None] & at,
                             (leading_sign * k_delta)[:, None], pulses)
        new_ls = torch.where(torch.remainder(mpvq_n, 2) != 0, -1, 1)
        leading_sign = torch.where(has_delta, new_ls, leading_sign)
        mpvq_n2 = torch.where(has_delta,
                              torch.div(mpvq_n, 2, rounding_mode="floor"), mpvq_n)
        kk = torch.where(has_delta, kk - k_delta, kk)
        mpvq = torch.where(live, mpvq_n2, mpvq)
    return pulses.to(I32)


def sns_vq_enc_plain(scf):
    """SNS-VQ encoder (process_snsQuantizesScf_Enc), the plain version of the
    `sns_vq_enc` kernel. scf: [B, 16]. Returns (scf_idx [B, 7] i32, scf_q
    [B, 16])."""
    B = scf.shape[0]
    dev = scf.device
    C1 = nm.const(T.t("sns_C1"), dev)                          # [8, 32]
    C2 = nm.const(T.t("sns_C2"), dev)

    def vq_half(target, cb):
        d = nm.chain_sum(_sq(target[:, :, None] - cb[None, :, :]), dim=1)
        return _first_argmin(d).to(I32)

    i0 = vq_half(scf[:, :8], C1)
    i1 = vq_half(scf[:, 8:], C2)
    st1 = torch.cat([C1[:, i0.long()].T, C2[:, i1.long()].T], dim=-1)

    target_pre = scf - st1
    D2 = nm.const(T.dct2_matrix(M), dev)
    D2t = nm.const(T.dct2_matrix(M).T, dev)
    pvq_target = nm.chain_dot(target_pre, D2t)

    yA, enA = _pvq_subpyr_search(pvq_target, 10, 10)
    tail = torch.cat([pvq_target[:, 10:], torch.zeros((B, 10), dtype=F32, device=dev)], -1)
    yB, _ = _pvq_subpyr_search(tail, 6, 1)
    yC = torch.cat([yA[:, :10], yB[:, :6]], dim=-1)
    gain_fac = torch.reciprocal(torch.sqrt(nm.chain_sum((yC * yC).to(F32))))
    yC_n = yC.to(F32) * gain_fac[:, None]

    reg_g = np.concatenate([T.t("sns_vq_reg_adj_gains_fl"),
                            T.t("sns_vq_reg_lf_adj_gains_fl")])
    q_g = T.t("q_g_sns")
    enA10 = torch.cat([enA[:, :10], torch.zeros((B, 6), dtype=F32, device=dev)], -1)
    cand = torch.stack([yC_n * nm.f32(reg_g[0]), yC_n * nm.f32(reg_g[1])]
                       + [enA10 * nm.f32(reg_g[2 + i]) for i in range(4)], dim=1)
    errs = nm.chain_sum(_sq(pvq_target[:, None, :] - cand))
    idx_g = _first_argmin(errs).to(I32)
    glob_gain = nm.const(q_g, dev)[idx_g.long()]
    chosen = torch.gather(cand, 1, idx_g.long()[:, None, None].expand(B, 1, M))[:, 0] \
        / glob_gain[:, None]
    st2_split = nm.chain_dot(chosen, D2)
    err_split = nm.chain_sum(_sq(target_pre - glob_gain[:, None] * st2_split))

    idx2 = torch.where(idx_g <= 1, 0, 1).to(I32)
    idx3 = torch.where(idx_g <= 1, idx_g, idx_g - 2).to(I32)
    pulses_sel = torch.where((idx_g <= 1)[:, None], yC, yA)
    st2 = glob_gain[:, None] * st2_split
    best_err = err_split

    for dim_k, pulses_k, gains_name, sub in ((16, 8, "sns_vq_near_adj_gains_fl", 2),
                                             (16, 6, "sns_vq_far_adj_gains_fl", 3)):
        yO, enO = _pvq_subpyr_search(pvq_target, dim_k, pulses_k)
        st2O = nm.chain_dot(enO, D2)
        gains = T.t(gains_name)
        errsO = torch.stack([nm.chain_sum(_sq(target_pre - nm.f32(g) * st2O))
                             for g in gains], dim=1)
        iO = _first_argmin(errsO).to(I32)
        eO = torch.gather(errsO, 1, iO.long()[:, None])[:, 0]
        gO = nm.const(gains, dev)[iO.long()]
        use = eO < best_err
        idx2 = torch.where(use, sub, idx2).to(I32)
        idx3 = torch.where(use, iO, idx3)
        pulses_sel = torch.where(use[:, None], yO, pulses_sel)
        st2 = torch.where(use[:, None], gO[:, None] * st2O, st2)
        best_err = torch.minimum(best_err, eO)

    ls10, mp10 = _pvq_enc(pulses_sel, 10)
    ls16, mp16 = _pvq_enc(pulses_sel, 16)
    idx4 = torch.where(idx2 < 2, ls10, ls16)
    idx5 = torch.where(idx2 < 2, mp10, mp16)
    tail_pulses = torch.cat([pulses_sel[:, 10:],
                             torch.zeros((B, 10), dtype=I32, device=dev)], -1)
    lsT, mpT = _pvq_enc(tail_pulses, 6)
    idx6 = torch.where(idx2 == 0, mpT * 2 + lsT,
                       torch.where(idx2 == 2, -1, -2)).to(I32)

    scf_idx = torch.stack([i0, i1, idx2, idx3, idx4, idx5, idx6], dim=-1).to(I32)
    return scf_idx, st1 + st2


def quantize_scf_enc(cfg: Config, scf):
    """SNS-VQ encoder: scf [B, 16] -> (scf_idx [B, 7] i32, scf_q [B, 16]).
    The `sns_vq_enc` kernel for a tensor on a card, `sns_vq_enc_plain` on
    the CPU."""
    if nm.on_cpu(scf):
        return sns_vq_enc_plain(scf)
    return kernels.sns_vq_enc(scf.contiguous())


def sns_vq_dec_plain(scf_idx):
    """SNS-VQ decoder (process_snsQuantizesScf_Dec), the plain version of
    the `sns_vq_dec` kernel: [B,7] i32 -> [B,16]."""
    dev = scf_idx.device
    C1 = nm.const(T.t("sns_C1"), dev)
    C2 = nm.const(T.t("sns_C2"), dev)
    i0, i1, sub, gidx, ls, mpvq, idx6 = [scf_idx[:, k] for k in range(7)]
    st1 = torch.cat([C1[:, i0.long()].T, C2[:, i1.long()].T], dim=-1)

    p_s0 = _pvq_dec(10, 10, ls, mpvq)
    p2 = _pvq_dec(1, 6, torch.remainder(idx6, 2), torch.div(idx6, 2, rounding_mode="floor"))
    p_s0_full = p_s0.clone()
    p_s0_full[:, 10:] = torch.where((sub == 0)[:, None], p2[:, :6], 0)
    p_s2 = _pvq_dec(8, 16, ls, mpvq)
    p_s3 = _pvq_dec(6, 16, ls, mpvq)
    pulses = torch.where((sub < 2)[:, None], p_s0_full,
                         torch.where((sub == 2)[:, None], p_s2, p_s3))
    norm = torch.sqrt(nm.chain_sum((pulses * pulses).to(F32)))
    v = pulses.to(F32) / norm[:, None]
    v = nm.chain_dot(v, nm.const(T.dct2_matrix(M), dev))
    gains = nm.const(T.t("sns_dec_gains"), dev)                # [4, 8]
    g = gains[sub.clamp(0, 3).long(), gidx.clamp(0, 7).long()]
    return nm.fma(g[:, None], v, st1)


def quantize_scf_dec(scf_idx):
    """SNS-VQ decoder: scf_idx [B, 7] i32 -> scf_q [B, 16]. The `sns_vq_dec`
    kernel for a tensor on a card, `sns_vq_dec_plain` on the CPU."""
    if nm.on_cpu(scf_idx):
        return sns_vq_dec_plain(scf_idx)
    return kernels.sns_vq_dec(scf_idx.contiguous())


@functools.cache
def _interp_matrix(nb: int) -> np.ndarray:
    """[16 -> nb] linear interpolation operator (processSnsInterpolateScf_fl)."""
    Mi = np.zeros((64, 16))
    Mi[0, 0] = Mi[1, 0] = 1.0
    for n in range(15):
        for k, w in enumerate([1, 3, 5, 7]):
            Mi[n * 4 + 2 + k, n] = 1 - w / 8.0
            Mi[n * 4 + 2 + k, n + 1] = w / 8.0
    Mi[62, 15], Mi[62, 14] = 1 + 1 / 8.0, -1 / 8.0
    Mi[63, 15], Mi[63, 14] = 1 + 3 / 8.0, -3 / 8.0
    if nb < 64:
        d = 64 - nb
        out = np.zeros((nb, 16))
        if d < 32:
            for i in range(d):
                out[i] = (Mi[2 * i] + Mi[2 * i + 1]) / 2.0
            out[d:] = Mi[2 * d:]
        else:
            n4 = round(abs(1.0 - 32.0 / nb) * nb)
            for i in range(n4):
                out[i] = Mi[4 * i: 4 * i + 4].mean(0)
            for i in range(nb - n4):
                out[n4 + i] = Mi[4 * n4 + 2 * i: 4 * n4 + 2 * i + 2].mean(0)
        return out
    return Mi


def interpolate_scf(cfg: Config, scf_q, encoder_side: bool):
    """[B,16] quantized scf -> [B, bands_number] linear-domain gains."""
    g = nm.dot(scf_q, nm.const(_interp_matrix(cfg.bands_number).T, scf_q.device))
    if encoder_side:
        g = -g
    return nm.exp2(g)


def mdct_shaping(cfg: Config, d, gains):
    """Multiply each bin by its band gain (processMdctShaping_fl); bins at or
    above the last band boundary pass through unchanged."""
    n = d.shape[1]
    idx = torch.as_tensor(T.band_expand_indices(cfg.fs_idx, cfg.frame_dms,
                                                cfg.hrmode, cfg.frame_length)[:n],
                          dtype=torch.long, device=d.device)
    last = int(T.bands_offset(cfg.fs_idx, cfg.frame_dms, cfg.hrmode)[-1])
    shaped = d * gains[:, idx]
    if n > last:
        k = torch.arange(n, device=d.device)[None, :]
        shaped = torch.where(k < last, shaped, d)
    return shaped
