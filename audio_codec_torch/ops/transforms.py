"""Low-delay MDCT / IMDCT: window and fold, then the DCT-IV as one matrix
product over the stream batch (mdct.c:72-126, imdct.c:14-59).

On a CUDA device the DCT-IV is `torch.matmul` in full float32. On the CPU
the forward transform runs the compensated product of the reference's CPU
branch (`audio_codec_tpu/ops/transforms.py:_dct4_apply`) step for step, so
the spectra, and with them the quantizer's dead-zone ties, agree exactly.
"""
from __future__ import annotations

import functools

import numpy as np
import torch

from .. import tables as T
from ..config import Config
from . import numerics as nm

F32 = torch.float32


@functools.cache
def _win_np(cfg: Config) -> np.ndarray:
    return T.mdct_window(cfg.frame_length, cfg.frame_dms, cfg.hrmode)


def _dct4_apply(folded: torch.Tensor, Mt: torch.Tensor) -> torch.Tensor:
    """folded [B, N] @ Mt [N, N]: Dekker-split exact products summed with
    Neumaier compensation on the CPU, a plain product on the card."""
    if not nm.on_cpu(folded):
        return torch.matmul(folded, Mt)
    B = folded.shape[0]

    def split(v):  # Veltkamp split at 2^12+1 for f32
        c = 4097.0 * v
        hi = c - (c - v)
        return hi, v - hi

    s = torch.zeros((B, Mt.shape[1]), dtype=F32)
    comp = torch.zeros_like(s)
    for k in range(folded.shape[1]):
        a = folded[:, k: k + 1].expand(B, Mt.shape[1])
        b = Mt[k][None, :].expand(B, Mt.shape[1])
        ah, al = split(a)
        bh, bl = split(b)
        p = a * b
        # the products are exact, so XLA:CPU's contractions here are too
        err = nm.fma(al, bl, nm.fma(al, bh, nm.fma(ah, bl, nm.fma(ah, bh, -p))))
        # Neumaier two-sum of p then err; XLA:CPU contracts the product p
        # into the first sum and into its compensation term
        t = nm.fma(a, b, s)
        bv = t - s
        comp = comp + ((s - (t - bv)) + nm.fma(a, b, -bv))
        s = t
        t = s + err
        bv = t - s
        comp = comp + ((s - (t - bv)) + (err - bv))
        s = t
    return s + comp


def mdct(cfg: Config, x: torch.Tensor, mem: torch.Tensor):
    """Forward low-delay MDCT of one frame per stream.

    x: [B, N] PCM frame; mem: [B, N - la_zeroes] previous raw input tail.
    Returns (d [B, N] spectrum, new_mem)."""
    N = cfg.frame_length
    la = cfg.la_zeroes
    h = N // 2
    win = nm.const(_win_np(cfg), x.device)
    buf = torch.cat([mem, x], dim=-1)
    if la:
        buf = torch.nn.functional.pad(buf, (0, la))
    rev = lambda v: v[:, 2 * h: 3 * h].flip(-1)
    # the products XLA:CPU contracts: the second of -w - w, the first of w - w
    out_lo = nm.fma(-buf[:, 3 * h:], win[3 * h:], -(rev(buf) * rev(win[None, :])))
    out_hi = nm.fma(buf[:, :h], win[:h], -(buf[:, h: 2 * h].flip(-1) * win[h: 2 * h].flip(-1)))
    folded = torch.cat([out_lo, out_hi], dim=-1)
    Mt = nm.const(T.dct4_matrix(N).T, x.device)
    return _dct4_apply(folded, Mt), x[:, la:]


def imdct(cfg: Config, y: torch.Tensor, mem: torch.Tensor):
    """Inverse MDCT with overlap-add (ProcessingIMDCT_fl).

    y: [B, N] spectrum; mem: [B, N - la_zeroes]. Returns (x [B, N], new_mem)."""
    N = cfg.frame_length
    la = cfg.la_zeroes
    h = N // 2
    Mt = nm.const(T.dct4_matrix(N).T, y.device)
    x_tda = nm.dot(y, Mt)
    a = x_tda[:, h:]
    b = x_tda[:, :h]
    x_ov = torch.cat([a, -a.flip(-1), -b.flip(-1), -b], dim=-1)
    win = nm.const(_win_np(cfg)[::-1], y.device)
    ola = nm.fma(x_ov[:, la:N], win[la:N], mem[:, : N - la])
    x = torch.cat([ola, x_ov[:, N: N + la] * win[N: N + la]], dim=-1)
    return x, x_ov[:, N + la:] * win[N + la:]
