"""The integer-exact LTPF decoder post-filter over a batch of streams
(`audio_codec_tpu/ops/fixed_ltpf_dev.py`, ltpf_decoder_fx.c:16-316), and
the last kernel of the fixed chain, `fx_ola_ltpf` (K21): the IMDCT's
overlap-add, this post-filter and the PCM rounding of one frame.

Lanes carry independent streams. The reference's per-frame branches (the
parameter decode, the passthrough, the four first-phase patterns and the
history rescaling) become masks, and the filter's serial tap recursion
runs sample by sample with the output history as carry: each step reads
the output `pitch_int` samples back (a tap index clipped into the buffer,
so the not-yet-written zeros of the frame's region are read as the
reference reads them) and writes one sample.
"""
from __future__ import annotations

import numpy as np
import torch

from .. import kernels
from .. import tables as T
from . import fixed_dec as fd
from . import fixed_dev as fv
from . import numerics as nm
from .fixed_ltpf import _FADE_STEP, mem_lens

I64 = torch.int64
STATE_KEYS = ("old_x", "old_y", "old_e", "pitch_int", "pitch_fr", "gain", "mem_active", "old_sfi")


def _scale_sig(x, s):
    """Scale_sig over [B, n] by s [B]: 0 is the identity, s > 0 a
    saturating shl, s < 0 a rounded shr (msu_r against -2^(15+s))."""
    s = s[:, None]
    up = torch.clamp(x << torch.clamp(s, 0, 31), -32768, 32767)
    sneg = torch.clamp(s, min=-15)
    tmp = -(torch.ones_like(x) << (15 + sneg).clamp(0, 63))
    prod = fd.sat32(-((x * tmp) << 1))
    down = fd.sat16(fd.sat32(prod + 0x8000) >> 16)
    return torch.where(s == 0, x, torch.where(s > 0, up, down))


def _headroom16_0(x):
    """getScaleFactor16_0 per row: the least norm_s, 16 if all zero."""
    nz = x != 0
    mn = torch.amin(torch.where(nz, fd.norm_s(torch.where(nz, x, 1)), 16), dim=1)
    return torch.where(nz.any(dim=1), mn, 16)


def _headroom16(x):
    """getScaleFactor16: as _headroom16_0, but 0 if all zero."""
    return torch.where((x != 0).any(dim=1), _headroom16_0(x) & 0xF, 0)


def state_init(fs: int, B: int, device) -> dict[str, torch.Tensor]:
    """The post-filter's per-stream history (LtpfDevState of the reference)."""
    x_len, y_len = mem_lens(fs)
    z = lambda *s: torch.zeros((B, *s), dtype=I64, device=device)
    return dict(old_x=z(x_len), old_y=z(y_len), old_e=z(), pitch_int=z(), pitch_fr=z(),
                gain=z(), mem_active=z(), old_sfi=torch.full((B,), -1, dtype=I64, device=device))


def filter_geometry(fs_idx: int) -> dict[str, int]:
    """The interpolation and tilt filters' lengths, the tap shift, the
    overlap length and the pitch scale at a rate."""
    return dict(ilen=int(T.t("fx_inter_filter_len")[fs_idx]),
                shift=int(T.t("fx_inter_filter_shift")[fs_idx]),
                tlen=int(T.t("fx_tilt_filter_len")[fs_idx]),
                N4=int(T.t("fx_ltpf_overlap_len")[fs_idx]),
                pitch_scale=int(T.t("fx_pitch_scale")[fs_idx]))


def _filter_coefs(fs_idx: int, pitch_fr, sfi, device):
    """(inter row [B, ilen], tilt row [B, tlen+1])."""
    g = filter_geometry(fs_idx)
    inter = torch.as_tensor(np.asarray(T.t("fx_inter_filter")[fs_idx], np.int64), device=device)
    tilt = torch.as_tensor(np.asarray(T.t("fx_tilt_filter")[fs_idx], np.int64), device=device)
    ic = inter[torch.clamp(pitch_fr, 0, inter.shape[0] - 1), : g["ilen"]]
    tc = tilt[torch.clamp(sfi, 0, tilt.shape[0] - 1), : g["tlen"] + 1]
    return ic, tc


def _synth_filter(ybuf, ybase: int, xwin, length: int, pitch_int, gain, ic, tc, ilen: int,
                  tlen: int, shift: int, fade_mode, step_len: int, active):
    """ltpf_synth_filter over [B] lanes. ybuf [B, W], written in place at
    ybase..ybase+length where `active`; xwin [B, length, tlen+1] input taps
    (xwin[:, j, l] = x[xbase + j - l]); fade_mode [B] in {-1, 0, +1}."""
    B, W = ybuf.shape
    x0 = ybase - pitch_int + shift
    step = torch.where(fade_mode < 0, -_FADE_STEP[step_len],
                       torch.where(fade_mode > 0, _FADE_STEP[step_len], 0))
    alpha = torch.where(fade_mode < 0, 0x7FFF, 0)
    l_off = torch.arange(ilen, dtype=I64, device=ybuf.device)[None, :]
    for j in range(length):
        xw = xwin[:, j]
        yidx = torch.clamp(x0[:, None] + j - l_off, 0, W - 1)
        ytap = torch.gather(ybuf, 1, yidx)
        s = fd.L_mult(ytap[:, 0], ic[:, 0])
        for el in range(1, ilen):
            s = fd.sat32(s + fd.L_mult(ytap[:, el], ic[:, el]))
        for el in range(tlen):
            s = fd.sat32(s - fd.L_mult(xw[:, el], tc[:, el]))
        k16 = fd.mult_r(gain, fd.msu_r(s, xw[:, tlen], tc[:, tlen]))
        k16 = torch.where(fade_mode != 0, fd.mult_r(k16, alpha), k16)
        val = fd.sat16(xw[:, 0] + k16)
        col = ybase + j
        ybuf[:, col] = torch.where(active, val, ybuf[:, col])
        alpha = torch.where(active & (fade_mode != 0), fd.sat16(alpha + step), alpha)
    return ybuf


def _windows(xarr, base: int, length: int, tlen: int):
    """xwin[:, j, l] = xarr[:, base + j - l] for l in 0..tlen."""
    return torch.stack([xarr[:, base - el: base - el + length] for el in range(tlen + 1)], dim=2)


def decode_pitch(ltpf, pitch_index, pitch_scale: int):
    """The LTPF pitch of the side words, at the output rate: (pitch_int,
    pitch_fr), 0 where the LTPF field is off."""
    p1 = (pitch_index + 64) >> 2
    f1 = pitch_index - (p1 << 2) + 128
    p2 = (pitch_index - 126) >> 1
    f2 = (pitch_index << 1) - (p2 << 2) - 252
    pitch_int = torch.where(pitch_index < 380, p1,
                            torch.where(pitch_index < 440, p2, pitch_index - 283))
    pitch_fr = torch.where(pitch_index < 380, f1, torch.where(pitch_index < 440, f2, 0))
    pitch = fd.mult_r(fd.shl16((pitch_int << 2) + pitch_fr, 2), pitch_scale)
    return (torch.where(ltpf != 0, pitch >> 2, 0),
            torch.where(ltpf != 0, pitch - ((pitch >> 2) << 2), 0))


def ltpf_decode(st: dict, x_in, x_e, fs_idx: int, L: int, ltpf, ltpf_active, pitch_index,
                scale_fac_idx: int):
    """process_ltpf_decoder_fx over [B] lanes of clean frames.

    st: the state of state_init; x_in [B, L] Word16; x_e [B];
    ltpf/ltpf_active/pitch_index [B]; scale_fac_idx the configuration's.
    Returns (y_out [B, L], x_e', new state dict)."""
    B = x_in.shape[0]
    dev = x_in.device
    g = filter_geometry(fs_idx)
    ilen, tlen, shift, N4 = g["ilen"], g["tlen"], g["shift"], g["N4"]
    x_len, y_len = st["old_x"].shape[1], st["old_y"].shape[1]
    z = lambda: torch.zeros((B,), dtype=I64, device=dev)
    ltpf, ltpf_active, pitch_index = (v.to(I64) for v in (ltpf, ltpf_active, pitch_index))
    x_e = x_e.to(I64)
    sfi = torch.full((B,), scale_fac_idx, dtype=I64, device=dev)
    pitch_int, pitch_fr = decode_pitch(ltpf, pitch_index, g["pitch_scale"])
    if scale_fac_idx < 0:
        ltpf_active = z()
    gain_val = int(T.t("fx_gain_scale_fac")[scale_fac_idx]) if scale_fac_idx >= 0 else 0
    gain = torch.where(ltpf_active != 0, gain_val, 0)

    x_in = x_in.to(I64)
    passthrough = (ltpf_active == 0) & (st["mem_active"] == 0)

    # ---- branch A: the passthrough's history update
    sA = st["old_e"] - x_e
    oy = st["old_y"]
    # s > 0: old_y keeps its scale, the new frame shifted down by s
    xin_dn = torch.where((sA > 15)[:, None], 0, x_in >> torch.clamp(sA, 0, 63)[:, None])
    oyA_pos = torch.cat([oy[:, L:], xin_dn], dim=1)
    oxA_pos = xin_dn[:, L - x_len:]
    # s <= 0: the history rescaled to the new exponent
    oy_shift = torch.where(
        (sA < -15)[:, None], 0,
        torch.where((sA < 0)[:, None], fd.sat16(oy[:, L:] >> torch.clamp(-sA, 0, 63)[:, None]),
                    torch.clamp(oy[:, L:] << torch.clamp(sA, 0, 63)[:, None], -32768, 32767)))
    oyA_neg = torch.cat([oy_shift, x_in], dim=1)
    oxA_neg = x_in[:, L - x_len:]
    posA = (sA > 0)[:, None]
    oyA = torch.where(posA, oyA_pos, oyA_neg)
    oxA = torch.where(posA, oxA_pos, oxA_neg)
    oeA = torch.where(sA > 0, st["old_e"], x_e)

    # ---- branch B: the filter
    N34 = L - N4
    xbuf = torch.cat([st["old_x"], x_in], dim=1)
    ybuf = torch.cat([st["old_y"], torch.zeros((B, L), dtype=I64, device=dev)], dim=1)
    xbase, ybase = x_len, y_len
    s0 = torch.minimum(_headroom16_0(st["old_x"]), _headroom16_0(st["old_y"])) - 1
    old_e = st["old_e"] - s0
    s1 = _headroom16(xbuf[:, xbase:]) - 1
    x_eB = x_e - s1
    sB = old_e - x_eB
    posB = sB > 0
    x_scale = torch.where(posB, s1 - sB, s1)
    h_scale = torch.where(posB, s0, s0 + sB)
    x_eB = torch.where(posB, old_e, x_eB)
    xbuf = torch.cat([_scale_sig(xbuf[:, :xbase], h_scale),
                      _scale_sig(xbuf[:, xbase:], x_scale)], dim=1)
    ybuf = torch.cat([_scale_sig(ybuf[:, :ybase], h_scale), ybuf[:, ybase:]], dim=1)

    # the four first-phase patterns
    same = (pitch_int == st["pitch_int"]) & (pitch_fr == st["pitch_fr"])
    pat1 = (ltpf_active == 0) & ~passthrough
    pat2 = (ltpf_active != 0) & (st["mem_active"] == 0)
    pat4 = (ltpf_active != 0) & (st["mem_active"] != 0) & ~same
    use_old = pat1 | pat4
    old_sfi_eff = torch.where(st["old_sfi"] >= 0, st["old_sfi"], 0)
    pfr_A = torch.where(use_old, st["pitch_fr"], pitch_fr)
    pint_A = torch.where(use_old, st["pitch_int"], pitch_int)
    gain_A = torch.where(use_old, st["gain"], gain)
    sfi_A = torch.where(use_old, old_sfi_eff, sfi)
    fade_A = torch.where(pat1 | pat4, -1, torch.where(pat2, 1, 0))
    icA, tcA = _filter_coefs(fs_idx, pfr_A, sfi_A, dev)
    xwin = _windows(xbuf, xbase, N4, tlen)
    ybuf = _synth_filter(ybuf, ybase, xwin, N4, pint_A, gain_A, icA, tcA, ilen, tlen, shift,
                         fade_A, N4, ~passthrough)
    # pat4's crossfade: a second pass over the first pass's output
    icB, tcB = _filter_coefs(fs_idx, pitch_fr, sfi, dev)
    zwin = _windows(ybuf, ybase, N4, tlen)
    ybuf = _synth_filter(ybuf, ybase, zwin, N4, pitch_int, gain, icB, tcB, ilen, tlen, shift,
                         torch.ones((B,), dtype=I64, device=dev), N4, pat4)
    # phase 2 over N34
    xwin2 = _windows(xbuf, xbase + N4, N34, tlen)
    act2 = (ltpf_active > 0) & ~passthrough
    ybuf = _synth_filter(ybuf, ybase + N4, xwin2, N34, pitch_int, gain, icB, tcB, ilen, tlen,
                         shift, z(), N4, act2)
    # inactive lanes copy the input into the second region
    tail = torch.where(act2[:, None], ybuf[:, ybase + N4:], xbuf[:, xbase + N4:])
    ybuf = torch.cat([ybuf[:, :ybase + N4], tail], dim=1)

    # ---- merge the branches
    pt = passthrough[:, None]
    y_out = torch.where(pt, x_in, ybuf[:, ybase:])
    new = dict(old_x=torch.where(pt, oxA, xbuf[:, L:]), old_y=torch.where(pt, oyA, ybuf[:, L:]),
               old_e=torch.where(passthrough, oeA, x_eB), pitch_int=pitch_int, pitch_fr=pitch_fr,
               gain=torch.where(passthrough, 0, gain),
               mem_active=torch.where(passthrough, 0, ltpf_active), old_sfi=sfi)
    return y_out, torch.where(passthrough, x_e, x_eB), new


def ltpf_patterns(st: dict, ltpf_param, fs_idx: int) -> torch.Tensor:
    """Which branch each stream's frame takes: 0 passthrough, 1-4 the
    first-phase patterns pat1..pat4 (for histograms; at a configuration
    whose post-filter is on, scale_fac_idx_for >= 0)."""
    lp = ltpf_param.to(I64)
    active = lp[:, 1]
    pint, pfr = decode_pitch(lp[:, 0], lp[:, 2], filter_geometry(fs_idx)["pitch_scale"])
    mem = st["mem_active"] != 0
    same = (pint == st["pitch_int"]) & (pfr == st["pitch_fr"])
    on = active != 0
    return torch.where(~on & ~mem, 0, torch.where(~on, 1, torch.where(
        ~mem, 2, torch.where(same, 3, 4))))


def ola_ltpf_plain(cfg, st: dict, ytda, y_e, y_s, zero, ltpf_param, sfi: int):
    """One frame of B streams: imdct_ola, ltpf_decode and round_pcm16.
    st: dict(mem [B, wLen-N], mem_e [B], and the post-filter state of
    state_init), updated in place. ytda [B, N], y_e/y_s [B] int64, zero
    [B] bool from batch_dct4; ltpf_param [B, 3]. Returns PCM [B, N]
    int16; the plain version of the `fx_ola_ltpf` kernel."""
    N = cfg.frame_length
    from .fixed_imdct import window_table
    w = window_table(N)
    x, xe, mem, mem_e = fv.imdct_ola(ytda, y_e, y_s, zero, w, N, len(w), st["mem"], st["mem_e"])
    lp = ltpf_param.to(I64)
    y, ye, new = ltpf_decode({k: st[k] for k in STATE_KEYS}, x, xe, cfg.fs_idx, N, lp[:, 0],
                             lp[:, 1], lp[:, 2], sfi)
    st["mem"].copy_(mem)
    st["mem_e"].copy_(mem_e)
    for k in STATE_KEYS:
        st[k].copy_(new[k])
    return fv.round_pcm16(y, ye)


def ola_ltpf(cfg, st: dict, ytda, y_e, y_s, zero, ltpf_param, sfi: int):
    """OLA, post-filter and PCM of one frame: the `fx_ola_ltpf` kernel for
    tensors on the card, its plain version on the CPU. Updates st in place."""
    if nm.on_cpu(ytda):
        return ola_ltpf_plain(cfg, st, ytda, y_e, y_s, zero, ltpf_param, sfi)
    return kernels.fx_ola_ltpf(cfg, st, *(t.contiguous() for t in (ytda, y_e, y_s, zero)),
                               ltpf_param.to(torch.int32).contiguous(), sfi)
