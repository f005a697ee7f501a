"""LTPF decoder post-filter (process_ltpf_decoder_fl, ltpf_decoder.c:13-316).

The pitch-lagged IIR comb filter with a parameter crossfade. The parameter
decode and the per-stream filter coefficients are tensor code; the sample
loop (`audio_codec_tpu/ops/ltpf_dec.py:122-161`) is the CUDA kernel
`ltpf_postfilter` (csrc/ltpf_postfilter.cu) on the card and the plain loop
`ltpf_postfilter_plain` on the CPU. The reference's five control cases
(off/off, on->off fade-out, off->on fade-in, on->on same pitch, on->on
pitch change through a scratch buffer) are per-stream flags.
"""
from __future__ import annotations

import numpy as np
import torch

from .. import kernels
from .. import tables as T
from ..config import Config
from ..models.state import ltpf_dec_lens
from . import numerics as nm

F32 = torch.float32
I32 = torch.int32

# bits of the per-stream case word handed to the sample loop
CASE_B, CASE_C, CASE_D, CASE_E, NEW_ON = 1, 2, 4, 8, 16


def _filter(fs: int, which: int) -> np.ndarray:
    """The post-filter's interpolation (which 0) or tilt (1) table at fs."""
    key = {8000: "16", 16000: "16", 24000: "24", 32000: "32",
           44100: "48", 48000: "48", 96000: "48"}[fs]
    return np.asarray(T.t(f"conf_{('inter', 'tilt')[which]}_filter_{key}"))


def decode_pitch(cfg: Config, param):
    """Pitch index -> (pitch_int [B], pitch_fr [B]) at the output rate
    (ltpf_decoder.c:44-66)."""
    p2 = param[:, 2]
    lo = p2 < (T.RES4_PITCH_12K8 - T.MIN_PITCH_12K8) * 4
    mid = p2 < (T.RES4_PITCH_12K8 - T.MIN_PITCH_12K8) * 4 \
        + (T.RES2_PITCH_12K8 - T.RES4_PITCH_12K8) * 2
    fdiv = lambda a, b: torch.div(a, b, rounding_mode="floor")
    pi_lo = T.MIN_PITCH_12K8 + fdiv(p2, 4)
    pf_lo = p2 - (pi_lo - T.MIN_PITCH_12K8) * 4
    p2m = p2 - (T.RES4_PITCH_12K8 - T.MIN_PITCH_12K8) * 4
    pi_mid = T.RES4_PITCH_12K8 + fdiv(p2m, 2)
    pf_mid = (p2m - (pi_mid - T.RES4_PITCH_12K8) * 2) * 2
    pi_hi = p2 + (T.RES2_PITCH_12K8 - (T.RES4_PITCH_12K8 - T.MIN_PITCH_12K8) * 4
                  - (T.RES2_PITCH_12K8 - T.RES4_PITCH_12K8) * 2)
    pi = torch.where(lo, pi_lo, torch.where(mid, pi_mid, pi_hi))
    pf = torch.where(lo, pf_lo, torch.where(mid, pf_mid, 0))
    pitch = nm.div((pi.to(F32) + pf.to(F32) / 4.0) * cfg.fs, 12800.0)
    pitch = torch.floor(pitch * 4.0 + 0.5) / 4.0   # C round(), pitch > 0
    pitch_int = torch.floor(pitch).to(I32)
    pitch_fr = ((pitch - pitch_int) * 4.0).to(I32)
    on = param[:, 0] == 1
    return torch.where(on, pitch_int, 0).to(I32), torch.where(on, pitch_fr, 0).to(I32)


def _tap_sum(w, v):
    """sum_j w[:, j] * v[:, j] as a sequential fused multiply-add chain in
    the CPU's contraction (numerics.xla_fma) on every device."""
    acc = w[:, 0] * v[:, 0]
    for j in range(1, w.shape[1]):
        acc = nm.xla_fma(w[:, j], v[:, j], acc)
    return acc


def ltpf_postfilter_plain(cfg: Config, x, mem_x, mem_y, a1, b1, a2, b2, p1, p2, cases):
    """Plain version of the `ltpf_postfilter` kernel: the sample loop of
    ltpf_decode. x [B, N]; mem_x [B, Lx]; mem_y [B, Ly]; a1/a2 [B, inter
    taps] and b1/b2 [B, tilt taps] the old/new filters; p1/p2 [B] the
    old/new integer pitch; cases [B] the CASE_* bits. Returns y [B, N].
    Every device computes the CPU's order (the taps' and the crossfade's
    multiply-adds contracted as numerics.xla_fma), which the kernel follows
    bit for bit."""
    B, N = x.shape
    Lx, Ly = mem_x.shape[1], mem_y.shape[1]
    inter_len = max(cfg.fs, 16000) // 8000
    N4 = int(cfg.fs * 0.0025)
    dev = x.device
    case_b, case_c, case_d, case_e, new_on = (
        (cases & bit) != 0 for bit in (CASE_B, CASE_C, CASE_D, CASE_E, NEW_ON))
    xbuf = torch.cat([mem_x, x], dim=-1)
    ybuf = torch.cat([mem_y, torch.zeros((B, N), dtype=F32, device=dev)], dim=-1)
    zbuf = ybuf.clone()
    toff = torch.arange(b1.shape[1], device=dev)
    ioff = torch.arange(a1.shape[1], device=dev)
    lim = Ly + N - 1
    # the crossfade weight k / N4 as the CPU computes it (numerics.xla_div)
    fade = lambda k: float(np.float32(k) * np.float32(1.0 / N4))
    ys = []
    for n in range(N):
        xt = xbuf[:, (Lx + n - toff).clamp(0, Lx + N - 1)]
        s1_old = _tap_sum(b1, xt)
        base1 = Ly + n - p1 + inter_len - 1
        zt = torch.gather(zbuf, 1, (base1[:, None] - ioff[None, :]).clamp(0, lim).long())
        s2_old = _tap_sum(a1, zt)
        in_fade = n < N4
        c_out = fade(N4 - n)
        z_n = nm.xla_fma(c_out, s2_old, nm.xla_fma(-c_out, s1_old, x[:, n]))

        src_z = case_e & in_fade
        zx = zbuf[:, (Ly + n - toff).clamp(0, lim)]
        zx[:, 0] = z_n
        s1_new = _tap_sum(b2, torch.where(src_z[:, None], zx, xt))
        base2 = Ly + n - p2 + inter_len - 1
        yt = torch.gather(ybuf, 1, (base2[:, None] - ioff[None, :]).clamp(0, lim).long())
        s2_new = _tap_sum(a2, yt)
        c_in = torch.where(in_fade & (case_c | case_e), fade(n), 1.0).to(F32)
        x_eff = torch.where(src_z, z_n, x[:, n])
        cand_new = nm.xla_fma(c_in, s2_new, nm.xla_fma(-c_in, s1_new, x_eff))

        y_n = x[:, n]
        if in_fade:
            y_n = torch.where(case_b, z_n, y_n)
            y_n = torch.where(case_c | case_e, cand_new, y_n)
        y_n = torch.where(case_d, cand_new, y_n)
        if not in_fade:
            y_n = torch.where(new_on, cand_new, y_n)
        ybuf[:, Ly + n] = y_n
        zbuf[:, Ly + n] = torch.where(case_e, z_n, y_n)
        ys.append(y_n)
    return torch.stack(ys, dim=-1)


def ltpf_postfilter(cfg: Config, x, mem_x, mem_y, a1, b1, a2, b2, p1, p2, cases):
    """The post-filter's sample loop: the CUDA kernel for tensors on the
    card, its plain version for tensors on the CPU."""
    args = (cfg, x, mem_x, mem_y, a1, b1, a2, b2, p1, p2, cases)
    if x.device.type == "cpu":
        return ltpf_postfilter_plain(*args)
    return kernels.ltpf_postfilter(*args)


def ltpf_decode(cfg: Config, x, bfi, param, mem_param, mem_x, mem_y,
                mem_pitch_int, mem_pitch_fr, mem_gain, mem_beta_idx):
    """Returns (y [B, N], new mem_x, new mem_y, new parameter mems).
    x: [B, N] synthesized PCM; param: [B, 3] parsed LTPF parameters."""
    B, N = x.shape
    dev = x.device
    old_x_len, old_y_len, _, _ = ltpf_dec_lens(cfg)

    bad = bfi == 1   # concealMethod 0: zero parameters (ltpf_decoder.c:33-40)
    param = torch.where(bad[:, None], torch.zeros_like(param), param)
    pitch_int, pitch_fr = decode_pitch(cfg, param)
    pitch_int = torch.where(bad, 0, pitch_int).to(I32)
    pitch_fr = torch.where(bad, 0, pitch_fr).to(I32)
    if cfg.ltpf_conf_beta_idx < 0:
        param = param.clone()
        param[:, 1] = 0
    zero = torch.zeros((), dtype=F32, device=dev)
    gain = torch.where(bad, zero, torch.where(param[:, 1] == 1,
                                              torch.full((), cfg.ltpf_conf_beta, dtype=F32,
                                                         device=dev), zero))
    new_mem = dict(param=param.to(I32), pitch_int=pitch_int, pitch_fr=pitch_fr,
                   gain=gain.to(F32),
                   beta_idx=torch.full((B,), cfg.ltpf_conf_beta_idx, dtype=I32, device=dev))
    if cfg.ltpf_conf_beta <= 0:
        return x, mem_x, mem_y, new_mem

    inter_t, tilt_t = (nm.table(_filter, cfg.fs, k, device=dev) for k in (0, 1))
    old_on = mem_param[:, 1] == 1
    new_on = param[:, 1] == 1
    same_pitch = (mem_pitch_int == pitch_int) & (mem_pitch_fr == pitch_fr)
    cases = (torch.where(old_on & ~new_on, CASE_B, 0)
             | torch.where(~old_on & new_on, CASE_C, 0)
             | torch.where(old_on & new_on & same_pitch, CASE_D, 0)
             | torch.where(old_on & new_on & ~same_pitch, CASE_E, 0)
             | torch.where(new_on, NEW_ON, 0)).to(I32)
    conf_alpha = float(np.float32(0.85))
    beta_new = max(cfg.ltpf_conf_beta_idx, 0)
    a1 = mem_gain[:, None] * inter_t[mem_pitch_fr.clamp(0, 3).long()]
    b1 = conf_alpha * mem_gain[:, None] * tilt_t[mem_beta_idx.clamp(0, 3).long()]
    a2 = gain[:, None] * inter_t[pitch_fr.clamp(0, 3).long()]
    b2 = conf_alpha * gain[:, None] * tilt_t[beta_new][None, :]
    y = ltpf_postfilter(cfg, x.contiguous(), mem_x.contiguous(), mem_y.contiguous(),
                        a1.contiguous(), b1.contiguous(), a2.contiguous(),
                        b2.contiguous(), mem_pitch_int.to(I32).contiguous(),
                        pitch_int.contiguous(), cases)
    new_mem_x = torch.cat([mem_x, x], dim=-1)[:, N: N + old_x_len]
    new_mem_y = torch.cat([mem_y, y], dim=-1)[:, N: N + old_y_len]
    return y, new_mem_x, new_mem_y, new_mem
