"""Encoder front-end analysis, batched over streams.

- 12.8 kHz resampler  (resamp12k8.c:13-84): dense product + the biquad
  (the CUDA kernel `hp50_biquad` on the card, csrc/hp50_biquad.cu)
- open-loop pitch     (olpa.c:52-180): autocorrelation over all lags (the
  CUDA kernel `olpa` on the card, csrc/olpa.cu)
- LTPF parameter coder (ltpf_coder.c:34-263): correlation and masked argmax
  searches (the CUDA kernel `ltpf_encode` on the card, csrc/ltpf_encode.cu)
- attack detector     (attack_detector.c:13-104)
- per-band energy     (per_band_energy.c:13-30): one product
- bandwidth detector  (detect_cutoff_warped.c:13-83)

Counterparts of `audio_codec_tpu/ops/analysis.py`, function for function.
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


def resample_12k8(cfg: Config, x, mem_in, mem_50, mem_out):
    """Returns (y [B, len_12k8+1], new_mem_in, new_mem_50, new_mem_out).

    On the CPU the product over [mem_in, x] is the sum of one product over
    the memory and one over the frame, as XLA:CPU splits the reference's
    product of a concatenation; the frame's product runs in 256-deep blocks
    (read at 480 and 320 taps, tests/test_torch_analysis.py)."""
    n12k8 = cfg.frame_length * 12800 // cfg.fs
    R = nm.const(T.resampler_matrix(cfg.fs_idx, cfg.frame_length).T, x.device)
    buf = torch.cat([mem_in, x], dim=-1)
    new_mem_in = buf[:, cfg.frame_length:]
    if nm.on_cpu(x):
        n_mem = mem_in.shape[1]
        down = nm.dot(mem_in, R[:n_mem]) + nm.dot(x, R[n_mem:], block=256)
    else:
        down = nm.dot(buf, R)                               # [B, n12k8]

    filt, new_mem_50 = hp50_biquad(down, mem_50)

    buf_out = torch.cat([mem_out, filt], dim=-1)            # [B, 24 + n12k8]
    y = buf_out[:, : cfg.len_12k8 + 1]
    new_mem_out = buf_out[:, n12k8: n12k8 + 24]
    return y, new_mem_in, new_mem_50, new_mem_out


def hp50_biquad_plain(x, mem_50):
    """The 50 Hz high-pass biquad of the resampler over x [B, n] with
    memories mem_50 [B, 2]; the plain version of the `hp50_biquad` kernel.
    Returns (filtered x, new memories).

    On the CPU the products are contracted as in the reference's scan body
    (read from XLA:CPU's object code): b0*x feeds both y and, as b2*x (the
    same constant), u2, so it is rounded on its own and y = b0*x + u1 is not
    contracted; u2 = b2*x - a2*y and u1 = (b1*x + u2) - a1*y are."""
    b = [nm.f32(v) for v in T.t("highpass50_filt_b")]
    a = [nm.f32(v) for v in T.t("highpass50_filt_a")]
    u1, u2 = mem_50[:, 0], mem_50[:, 1]
    ys = []
    for n in range(x.shape[1]):
        xt = x[:, n]
        y = b[0] * xt + u1
        u1n = nm.fma(-a[1], y, nm.fma(b[1], xt, u2))
        u2n = nm.fma(-a[2], y, b[2] * xt)
        u1, u2 = u1n, u2n
        ys.append(y)
    return torch.stack(ys, dim=-1), torch.stack([u1, u2], dim=-1)


def hp50_biquad(x, mem_50):
    """The 50 Hz high-pass: the CUDA kernel for a tensor on the card, its
    plain version for a tensor on the CPU."""
    if nm.on_cpu(x):
        return hp50_biquad_plain(x, mem_50)
    return kernels.hp50_biquad(x.contiguous(), mem_50.contiguous())


def _window_gather(buf, base: int, n_lags: int, n: int):
    """buf[:, base + j - l] for l in [0,n_lags), j in [0,n) -> [B, n_lags, n]."""
    idx = base + np.arange(n)[None, :] - np.arange(n_lags)[:, None]
    return buf[:, torch.as_tensor(idx, device=buf.device)]


def _first_argmax(v: torch.Tensor) -> torch.Tensor:
    """Index of the first maximum along the last axis (jnp.argmax)."""
    m = v.max(dim=-1, keepdim=True).values
    hit = v == m
    idx = torch.arange(v.shape[-1], device=v.device)
    return torch.where(hit, idx, v.shape[-1]).min(dim=-1).values


def _clamp0(v):
    """max(v, 0). On the card a comparison, which the kernels follow (the
    sign of a zero is then the plain version's, not the library's)."""
    if nm.on_cpu(v):
        return torch.clamp(v, min=0.0)
    return torch.where(v < 0.0, 0.0, v)


def olpa_plain(cfg: Config, s12k8, mem_s12k8, mem_s6k4, mem_pitch):
    """Open-loop pitch search at 6.4 kHz (processOlpa_fl, olpa.c:52-180);
    the plain version of the `olpa` kernel. Returns (2*T0 [B] i32, normcorr
    [B], T0 [B] i32, new mem_s12k8, new mem_s6k4).

    For a tensor on the card it states the kernel's float order: R, E and
    e0 of each lag are chains (`numerics.chain_sum`) over the samples,
    ascending, and the normalised correlations clamp at 0 by a comparison."""
    length = cfg.len_12k8
    len2 = length // 2
    mem_in_len = T.MAX_PITCH_6K4 + (16 if cfg.frame_dms == 25 else 0)
    acflen = len2 + (16 if cfg.frame_dms == 25 else 0)
    dev = s12k8.device

    buf = torch.cat([mem_s12k8, s12k8[:, :length]], dim=-1)  # [B, len+3]
    new_mem_s12k8 = buf[:, length: length + 3]
    w = [nm.f32(v) for v in T.t("olpa_down2")]
    padded = torch.nn.functional.pad(buf, (4, 0))
    filt = torch.zeros_like(buf)
    for k in range(5):
        filt = filt + w[k] * padded[:, 4 - k: 4 - k + length + 3]
    d_wsp = filt[:, 4::2][:, :len2]

    buf2 = torch.cat([mem_s6k4[:, :mem_in_len], d_wsp], dim=-1)
    new_mem_s6k4 = buf2[:, len2: len2 + mem_in_len]
    base = mem_in_len - 16 if cfg.frame_dms == 25 else mem_in_len
    cur = buf2[:, base: base + acflen]

    lagged = _window_gather(buf2, base - T.MIN_PITCH_6K4, T.RANGE_PITCH_6K4, acflen)
    if nm.on_cpu(s12k8):
        R = torch.einsum("bn,bln->bl", cur, lagged)
        E = torch.einsum("bln,bln->bl", lagged, lagged)
        e0 = torch.sum(cur * cur, dim=-1)
    else:
        R = nm.chain_sum(cur[:, None, :] * lagged)
        E = nm.chain_sum(lagged * lagged)
        e0 = nm.chain_sum(cur * cur)

    acw = nm.const(T.t("olpa_acw"), dev)
    L = _first_argmax(R * acw)
    T0 = L.to(I32) + T.MIN_PITCH_6K4

    def norm_corr_at(lag_idx):
        s0 = torch.gather(R, 1, lag_idx[:, None])[:, 0]
        s1 = torch.gather(E, 1, lag_idx[:, None])[:, 0]
        nc = s0 / (nm.sqrt(s1 * e0) + nm.f32(1e-5))
        return _clamp0(nc)

    nc1 = norm_corr_at(L)
    min_p = torch.clamp(mem_pitch - 4, min=T.MIN_PITCH_6K4)
    max_p = torch.clamp(mem_pitch + 4, max=T.MAX_PITCH_6K4)
    lags = torch.arange(T.RANGE_PITCH_6K4, device=dev)[None, :] + T.MIN_PITCH_6K4
    in_win = (lags >= min_p[:, None]) & (lags <= max_p[:, None])
    L2 = _first_argmax(torch.where(in_win, R, -torch.inf))
    T02 = L2.to(I32) + T.MIN_PITCH_6K4
    nc2 = norm_corr_at(L2)

    take2 = (T02 != T0) & (nc2 > nc1 * nm.f32(0.85))
    T0f = torch.where(take2, T02, T0)
    ncf = torch.where(take2, nc2, nc1)
    return 2 * T0f, ncf, T0f, new_mem_s12k8, new_mem_s6k4


def olpa(cfg: Config, s12k8, mem_s12k8, mem_s6k4, mem_pitch):
    """The open-loop pitch search: the CUDA kernel for a tensor on the card,
    its plain version for a tensor on the CPU."""
    if nm.on_cpu(s12k8):
        return olpa_plain(cfg, s12k8, mem_s12k8, mem_s6k4, mem_pitch)
    return kernels.olpa(cfg, s12k8.contiguous(), mem_s12k8.contiguous(),
                        mem_s6k4.contiguous(), mem_pitch.to(I32).contiguous())


@functools.cache
def _ltpf_interp_matrix() -> np.ndarray:
    """[n_out, 17]: cor_int[i] = sum_m cor[m] * inter4_1[4m - i]
    (ltpf_coder.c:125-141 with the sparse upsampling folded in)."""
    inter = T.t("inter4_1")
    n_out = 4 * 9
    M = np.zeros((n_out, 17))
    for i in range(n_out):
        for m in range(17):
            k = 4 * m - i
            if 0 <= k < 32:
                M[i, m] = inter[k]
    return M


def ltpf_encode_plain(cfg: Config, s12k8, pitch_ol, nc_ol, mem_in,
                      mem_normcorr, mem_mem_normcorr, mem_on, mem_pitch):
    """LTPF pitch refinement + activation (process_ltpf_coder_fl); the plain
    version of the `ltpf_encode` kernel. Returns (param [B,3] i32, bits [B]
    i32, new mem_in, normcorr, mem_mem_normcorr, ltpf_on, pitch).

    For a tensor on the card it computes only the 17 lags the search window
    reads and states the kernel's float order: each lag's correlation and
    energy and each of the normcorr's three sums is a chain
    (`numerics.chain_sum`) over the samples, ascending; the interpolation a
    k-ascending chain (`numerics.chain_dot`) with its zero taps; the clamps
    comparisons."""
    dev = s12k8.device
    xlen = cfg.len_12k8 + 1
    N = xlen - 1
    mem_len = cfg.ltpf_mem_in_len
    buf = torch.cat([mem_in, s12k8], dim=-1)
    new_mem_in = buf[:, N: N + mem_len]
    if cfg.frame_dms == 25:
        acflen, xbase = 2 * N, mem_len - N
    else:
        acflen, xbase = N, mem_len
    x = buf[:, xbase: xbase + acflen]

    n_lags = T.MAX_PITCH_12K8 + 4 - (T.MIN_PITCH_12K8 - 4) + 1
    lag0 = T.MIN_PITCH_12K8 - 4
    t0_min = torch.clamp(pitch_ol - 4, min=T.MIN_PITCH_12K8)
    t0_max = torch.clamp(pitch_ol + 4, max=T.MAX_PITCH_12K8)
    t_min = t0_min - 4
    ar = lambda n: torch.arange(n, device=dev)
    # near the top lag the window runs past the 205 lags; those entries only
    # feed the fractional search, which is skipped up there (RES2 and above)
    win_idx = ((t_min - lag0)[:, None] + ar(17)[None, :]).clamp(max=n_lags - 1)
    if nm.on_cpu(s12k8):
        lagged = _window_gather(buf, xbase - lag0, n_lags, acflen)
        cor_all = torch.einsum("bn,bln->bl", x, lagged)
        en_all = torch.einsum("bln,bln->bl", lagged, lagged)
        e_cur = torch.sum(x * x, dim=-1)
        denom = nm.sqrt(e_cur[:, None] * en_all) + nm.f32(1e-5)
        nc_all = torch.clamp(cor_all / denom, min=0.0)
        cor = torch.gather(nc_all, 1, win_idx.long())
    else:
        idx = xbase - lag0 - win_idx[:, :, None] + ar(acflen)[None, None, :]
        lagged = torch.gather(buf[:, None, :].expand(-1, 17, -1), 2,
                              idx.clamp(0, buf.shape[1] - 1).long())    # [B, 17, acflen]
        e_cur = nm.chain_sum(x * x)
        denom = nm.sqrt(e_cur[:, None] * nm.chain_sum(lagged * lagged)) + nm.f32(1e-5)
        cor = _clamp0(nm.chain_sum(x[:, None, :] * lagged) / denom)

    n_int = t0_max - t0_min + 1
    mask = ar(9)[None, :] < n_int[:, None]
    t1 = _first_argmax(torch.where(mask, cor[:, 4:13], -torch.inf)).to(I32) + t0_min

    Mi = nm.const(_ltpf_interp_matrix().T, dev)
    cor_int = nm.chain_dot(cor, Mi)                           # [B, 36]
    step = torch.where(t1 >= T.RES4_PITCH_12K8, 2, 1).to(I32)
    midpoint = 4 * (t1 - t0_min) + 1
    delta = 4 - step
    delta_down = torch.where(t1 == t0_min, 0, delta).to(I32)
    count = torch.div(delta + delta_down, step, rounding_mode="floor") + 1
    offs = ar(7)[None, :]
    cand_idx = midpoint[:, None] - delta_down[:, None] - 1 + offs * step[:, None]
    cmask = offs < count[:, None]
    cvals = torch.gather(cor_int, 1, cand_idx.clamp(0, cor_int.shape[1] - 1).long())
    best = _first_argmax(torch.where(cmask, cvals, -torch.inf)).to(I32)
    pitch_fr0 = best * step - delta_down
    pitch_int = torch.where(pitch_fr0 >= 0, t1, t1 - 1)
    pitch_fr = torch.where(pitch_fr0 >= 0, pitch_fr0, pitch_fr0 + 4)
    no_fr = t1 >= T.RES2_PITCH_12K8
    pitch_int = torch.where(no_fr, t1, pitch_int).to(I32)
    pitch_fr = torch.where(no_fr, 0, pitch_fr).to(I32)

    pi, pf = pitch_int, pitch_fr
    idx_lo = pi * 4 + pf - T.MIN_PITCH_12K8 * 4
    idx_mid = (pi * 2 + torch.div(pf, 2, rounding_mode="floor")
               - T.RES4_PITCH_12K8 * 2 + (T.RES4_PITCH_12K8 - T.MIN_PITCH_12K8) * 4)
    idx_hi = (pi - T.RES2_PITCH_12K8 + (T.RES4_PITCH_12K8 - T.MIN_PITCH_12K8) * 4
              + (T.RES2_PITCH_12K8 - T.RES4_PITCH_12K8) * 2)
    pitch_index = torch.where(pi < T.RES4_PITCH_12K8, idx_lo,
                              torch.where(pi < T.RES2_PITCH_12K8, idx_mid, idx_hi))
    pitch = pi.to(F32) + pf.to(F32) / 4.0

    ef = nm.const(T.t("enc_inter_filter"), dev)               # [4, 4]
    j = ar(acflen)[None, :]

    def shifted(k):
        return buf[:, xbase + k: xbase + k + acflen]

    cur_f = shifted(1) * ef[0, 0] + shifted(0) * ef[0, 1] + shifted(-1) * ef[0, 2]
    fsel = ef[pitch_fr.long()]                               # [B, 4]
    base_idx = (xbase + j - pitch_int[:, None]).long()
    g = lambda off: torch.gather(buf, 1, (base_idx + off).clamp(0, buf.shape[1] - 1))
    pred_f = (g(1) * fsel[:, 0:1] + g(0) * fsel[:, 1:2]
              + g(-1) * fsel[:, 2:3] + g(-2) * fsel[:, 3:4])
    s1 = nm.chain_sum(cur_f * pred_f)
    s2 = nm.chain_sum(cur_f * cur_f)
    s3 = nm.chain_sum(pred_f * pred_f)
    nc = s1 / (nm.sqrt(s2 * s3) + nm.f32(1e-5))
    if nm.on_cpu(nc):
        nc = torch.clamp(torch.clamp(nc, -1.0, 1.0), min=0.0)
    else:
        nc = torch.where(nc > 1.0, 1.0, _clamp0(nc))

    # activation decision (ltpf_coder.c:227-241)
    searched = nc_ol > nm.f32(0.6)
    cond_fresh = (mem_on == 0) & (nc > nm.f32(0.94)) & (mem_normcorr > nm.f32(0.94))
    if cfg.frame_dms != 100:
        cond_fresh = cond_fresh & (mem_mem_normcorr > nm.f32(0.94))
    cond_keep = (mem_on == 1) & (nc > nm.f32(0.9))
    cond_track = ((mem_on == 1) & (torch.abs(pitch - mem_pitch) < 2)
                  & ((nc - mem_normcorr) > nm.f32(-0.1)) & (nc > nm.f32(0.84)))
    active = searched & (cond_fresh | cond_keep | cond_track)
    if not cfg.ltpf_enable:
        active = torch.zeros_like(active)

    zero = torch.zeros_like(pitch_index)
    nc_out = torch.where(searched, nc, nc_ol)
    pitch_out = torch.where(searched, pitch, torch.zeros_like(pitch))
    param = torch.stack([searched.to(I32),
                         torch.where(searched, active.to(I32), zero),
                         torch.where(searched, pitch_index, zero)], dim=-1).to(I32)
    bits = torch.where(searched, 11, 1).to(I32)
    new_mem_mem_normcorr = mem_normcorr if cfg.frame_dms < 100 else mem_mem_normcorr
    return (param, bits, new_mem_in, nc_out, new_mem_mem_normcorr,
            param[:, 1].clone(), pitch_out)


def ltpf_encode(cfg: Config, s12k8, pitch_ol, nc_ol, mem_in,
                mem_normcorr, mem_mem_normcorr, mem_on, mem_pitch):
    """The LTPF parameter coder: the CUDA kernel for a tensor on the card,
    its plain version for a tensor on the CPU."""
    args = (s12k8, pitch_ol, nc_ol, mem_in, mem_normcorr, mem_mem_normcorr, mem_on, mem_pitch)
    if nm.on_cpu(s12k8):
        return ltpf_encode_plain(cfg, *args)
    dtypes = (F32, I32, F32, F32, F32, F32, I32, F32)
    return kernels.ltpf_encode(cfg, *(a.to(dt).contiguous() for a, dt in zip(args, dtypes)))


def attack_detector(cfg: Config, x, position, acc_energy, filter_mem):
    """attack_detector_fl (attack_detector.c:13-104). Returns
    (attack_flag [B] i32, new_position, new_acc_energy, new_filter_mem)."""
    B = x.shape[0]
    if not cfg.attack_handling:
        return torch.zeros((B,), dtype=I32, device=x.device), position, \
            acc_energy, filter_mem
    nblocks = 4
    fs = cfg.fs
    frame_16k = nblocks * 40
    mval = nm.f32(1e-5) if fs == 96000 else 0.0
    if fs in (96000, 48000, 32000):
        d = x.reshape(B, -1, {96000: 6, 48000: 3, 32000: 2}[fs]).sum(-1)
    elif fs == 24000:
        xr = x.reshape(B, -1, 3)
        d = xr[:, :, 0] + (xr[:, :, 1] + xr[:, :, 2]) / 2.0
    else:
        d = x
    ptr = torch.cat([filter_mem, d], dim=-1)
    new_filter_mem = ptr[:, frame_16k: frame_16k + 2]
    f_sig = ptr[:, 2:] * 0.375 + ptr[:, 1:-1] * -0.5 + ptr[:, :-2] * 0.125
    blk = (f_sig * f_sig).reshape(B, nblocks, 40).sum(-1)

    flag = torch.zeros((B,), dtype=torch.bool, device=x.device)
    attack_pos = torch.full((B,), -1, dtype=I32, device=x.device)
    acc = acc_energy
    for i in range(nblocks):
        tmp = nm.div(blk[:, i], 8.5)
        hit = tmp > torch.clamp(acc, min=mval)
        flag = flag | hit
        attack_pos = torch.where(hit, i + 1, attack_pos).to(I32)
        acc = torch.maximum(blk[:, i], 0.25 * acc)
    flag = flag | (position > 2)
    return flag.to(I32), attack_pos, acc, new_filter_mem


def per_band_energy(cfg: Config, d):
    """[B, N] spectrum -> [B, bands_number] mean energies (one product)."""
    M = nm.const(T.band_energy_matrix(cfg.fs_idx, cfg.frame_dms, cfg.hrmode,
                                    cfg.frame_length), d.device)
    return nm.dot(d * d, M)


def detect_cutoff_warped(cfg: Config, ener):
    """Bandwidth index detection (processDetectCutoffWarped_fl). [B] i32."""
    B = ener.shape[0]
    dev = ener.device
    if cfg.fs_idx == 0 or cfg.hrmode:
        return torch.full((B,), cfg.fs_idx, dtype=I32, device=dev)
    fs_names = {1: "16k", 2: "24k", 3: "32k", 4: "48k"}
    suffix = {100: "", 50: "_5ms", 25: "_2_5ms"}[cfg.frame_dms]
    starts = T.t(f"BW_warp_idx_start_{fs_names[cfg.fs_idx]}{suffix}")
    stops = T.t(f"BW_warp_idx_stop_{fs_names[cfg.fs_idx]}{suffix}")
    thr_quiet = T.t("threshold_quiet")
    thr_brick = T.t("threshold_brickwall")
    bw_dist = T.t("brickwall_dist")

    counter = torch.full((B,), cfg.fs_idx, dtype=I32, device=dev)
    stopped = torch.zeros((B,), dtype=torch.bool, device=dev)
    for c in range(cfg.fs_idx, 0, -1):
        lo, hi = int(starts[c - 1]), int(stops[c - 1])
        mean = ener[:, lo: hi + 1].mean(dim=-1)
        quiet = mean < nm.f32(thr_quiet[c - 1])
        at_c = (counter == c) & ~stopped
        counter = torch.where(at_c & quiet, c - 1, counter).to(I32)
        stopped = stopped | (at_c & ~quiet)
    bw_idx = counter

    eps = nm.f32(np.finfo(np.float32).eps)
    log_e = 10.0 * nm.log10(ener + eps)
    brick = torch.zeros((B,), dtype=torch.bool, device=dev)
    for c in range(cfg.fs_idx):
        sel = bw_idx == c
        stop = int(starts[c])
        dist = int(bw_dist[c])
        thr = nm.f32(thr_brick[c])
        hit = torch.zeros((B,), dtype=torch.bool, device=dev)
        for i in range(stop, stop - dist - 1, -1):
            hit = hit | ((log_e[:, i - dist + 1] - log_e[:, i + 1]) > thr)
        brick = torch.where(sel, hit, brick)
    return torch.where((bw_idx < cfg.fs_idx) & ~brick, cfg.fs_idx, bw_idx).to(I32)


def cutoff_bandwidth(cfg: Config, d):
    """Bandwidth controller (cutoff_bandwidth.c:13-26): taper the four bins
    straddling the forced cutoff and zero everything above, up to yLen."""
    bw_bin = cfg.bw_ctrl_cutoff_bin
    D = d.shape[-1]
    if cfg.yLen <= bw_bin:
        return d
    mask = np.ones((D,), np.float32)
    for i in range(-1, 3):
        if 0 <= bw_bin + i < cfg.yLen:
            mask[bw_bin + i] = 2.0 ** -(i + 2)
    mask[bw_bin + 3: cfg.yLen] = 0.0
    return d * nm.const(mask, d.device)
