"""Low-delay MDCT / IMDCT: window and fold, then the DCT-IV as one matrix
product over the stream batch (mdct.c:72-126, imdct.c:14-59).

On the card both transforms are CUDA kernels (csrc/mdct.cu, csrc/imdct.cu)
that fuse the window, fold, unfold and overlap-add around the product;
`mdct_plain` and `imdct_plain` are their plain versions. For a tensor on
the card the plain versions state the kernels' float order: the DCT-IV sums
each output in k-blocks of DCT4_BLOCK, each block one k-ascending chain, the
blocks added in order (`_dct4_card`). On the CPU the forward transform runs
the compensated product of the reference's CPU branch
(`audio_codec_tpu/ops/transforms.py:_dct4_apply`) step for step, so the
spectra, and with them the quantizer's dead-zone ties, agree exactly, and
the inverse transform's product follows XLA:CPU's order (`numerics.dot`).
"""
from __future__ import annotations

import functools

import torch

from .. import kernels
from .. import tables as T
from ..config import Config
from . import numerics as nm

F32 = torch.float32
DCT4_BLOCK = 32     # k-depth of the card's DCT-IV blocks (csrc/dct4.cuh:kDctTK)


@functools.cache
def window(cfg: Config, device: str, reverse: bool = False) -> torch.Tensor:
    """The MDCT window [2N] (reversed for the IMDCT) as float32 on `device`,
    uploaded once."""
    w = T.mdct_window(cfg.frame_length, cfg.frame_dms, cfg.hrmode)
    return nm.const(w[::-1] if reverse else w, device)


@functools.cache
def dct4_mt(N: int, device: str) -> torch.Tensor:
    """The transposed DCT-IV matrix [N, N] as float32 on `device`, uploaded
    once."""
    return nm.const(T.dct4_matrix(N).T, device)


def _dct4_card(a: torch.Tensor, Mt: torch.Tensor) -> torch.Tensor:
    """a [B, K] @ Mt [K, N] in the kernels' order: k-blocks of DCT4_BLOCK
    (the last one ragged), each a k-ascending chain of separately rounded
    products and sums from its first product, the blocks' sums added in
    order."""
    out = None
    for lo in range(0, Mt.shape[0], DCT4_BLOCK):
        part = a[:, lo: lo + 1] * Mt[lo]
        for k in range(lo + 1, min(lo + DCT4_BLOCK, Mt.shape[0])):
            part = part + a[:, k: k + 1] * Mt[k]
        out = part if out is None else out + part
    return out


def _dct4_apply(folded: torch.Tensor, Mt: torch.Tensor) -> torch.Tensor:
    """folded [B, N] @ Mt [N, N]: Dekker-split exact products summed with
    Neumaier compensation on the CPU, the kernels' blocked order on the
    card."""
    if not nm.on_cpu(folded):
        return _dct4_card(folded, Mt)
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


def mdct_plain(cfg: Config, x: torch.Tensor, mem: torch.Tensor):
    """Forward low-delay MDCT of one frame per stream; the plain version of
    the `mdct` kernel.

    x: [B, N] PCM frame; mem: [B, N - la_zeroes] previous raw input tail.
    Returns (d [B, N] spectrum, new_mem)."""
    N = cfg.frame_length
    la = cfg.la_zeroes
    h = N // 2
    win = window(cfg, str(x.device))
    buf = torch.cat([mem, x], dim=-1)
    if la:
        buf = torch.nn.functional.pad(buf, (0, la))
    rev = lambda v: v[:, 2 * h: 3 * h].flip(-1)
    # the products XLA:CPU contracts: the second of -w - w, the first of w - w
    out_lo = nm.fma(-buf[:, 3 * h:], win[3 * h:], -(rev(buf) * rev(win[None, :])))
    out_hi = nm.fma(buf[:, :h], win[:h], -(buf[:, h: 2 * h].flip(-1) * win[h: 2 * h].flip(-1)))
    folded = torch.cat([out_lo, out_hi], dim=-1)
    return _dct4_apply(folded, dct4_mt(N, str(x.device))), x[:, la:]


def imdct_plain(cfg: Config, y: torch.Tensor, mem: torch.Tensor):
    """Inverse MDCT with overlap-add (ProcessingIMDCT_fl); the plain version
    of the `imdct` kernel.

    y: [B, N] spectrum; mem: [B, N - la_zeroes]. Returns (x [B, N], new_mem)."""
    N = cfg.frame_length
    la = cfg.la_zeroes
    h = N // 2
    Mt = dct4_mt(N, str(y.device))
    x_tda = nm.dot(y, Mt) if nm.on_cpu(y) else _dct4_card(y, Mt)
    a = x_tda[:, h:]
    b = x_tda[:, :h]
    x_ov = torch.cat([a, -a.flip(-1), -b.flip(-1), -b], dim=-1)
    win = window(cfg, str(y.device), reverse=True)
    ola = nm.fma(x_ov[:, la:N], win[la:N], mem[:, : N - la])
    x = torch.cat([ola, x_ov[:, N: N + la] * win[N: N + la]], dim=-1)
    return x, x_ov[:, N + la:] * win[N + la:]


def mdct(cfg: Config, x: torch.Tensor, mem: torch.Tensor):
    """The forward MDCT: the CUDA kernel for a tensor on the card, its plain
    version for a tensor on the CPU."""
    if nm.on_cpu(x):
        return mdct_plain(cfg, x, mem)
    return kernels.mdct(cfg, x.contiguous(), mem.contiguous())


def imdct(cfg: Config, y: torch.Tensor, mem: torch.Tensor):
    """The inverse MDCT: the CUDA kernel for a tensor on the card, its plain
    version for a tensor on the CPU."""
    if nm.on_cpu(y):
        return imdct_plain(cfg, y, mem)
    return kernels.imdct(cfg, y.contiguous(), mem.contiguous())
