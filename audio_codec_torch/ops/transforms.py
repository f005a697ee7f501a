"""Low-delay MDCT / IMDCT: window and fold, then the DCT-IV as one matrix
product over the stream batch (mdct.c:72-126, imdct.c:14-59).

On the card both transforms are CUDA kernels (csrc/mdct.cu, csrc/imdct.cu)
that fuse the window, fold, unfold and overlap-add around the product;
`mdct_plain` and `imdct_plain` are their plain versions. For a tensor on
the card the encoder's forward transform states its kernel's float order:
the DCT-IV sums each output in k-blocks of DCT4_BLOCK, each block one
k-ascending chain, the blocks added in order (`_dct4_card`); on the CPU it
runs the compensated product of the reference's CPU branch
(`audio_codec_tpu/ops/transforms.py:_dct4_apply`) step for step
(`_dct4_compensated`), so the spectra, and with them the quantizer's
dead-zone ties, agree exactly. The concealment's TDAC asks for the
compensated order on every device (`compensated=True`, the
`mdct_compensated` kernel on the card), so that its memory on the card
equals the CPU's. The inverse transform follows XLA:CPU's order on every
device
(`numerics.xla_dot`: 68-deep fused multiply-add chains at N = 480, one
chain below; `numerics.xla_gemv` for a single stream), and so does its
kernel.
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


@functools.cache
def dct4_mt64(N: int, device: str) -> torch.Tensor:
    """dct4_mt's float32 values as float64 on `device` (the IMDCT kernel's
    copy), made once."""
    return dct4_mt(N, device).to(torch.float64)


def _veltkamp(v: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """The Veltkamp split of float32 values at 2^12 + 1: (hi, lo)."""
    c = 4097.0 * v
    hi = c - (c - v)
    return hi, v - hi


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


def _dct4_compensated(folded: torch.Tensor, Mt: torch.Tensor) -> torch.Tensor:
    """folded [B, N] @ Mt [N, N] in the CPU's compensated order on every
    device: Dekker-split exact products summed with Neumaier compensation,
    each fused multiply-add as XLA:CPU contracts it (`numerics.xla_fma`)."""
    B = folded.shape[0]
    s = torch.zeros((B, Mt.shape[1]), dtype=F32, device=folded.device)
    comp = torch.zeros_like(s)
    for k in range(folded.shape[1]):
        a = folded[:, k: k + 1].expand(B, Mt.shape[1])
        b = Mt[k][None, :].expand(B, Mt.shape[1])
        ah, al = _veltkamp(a)
        bh, bl = _veltkamp(b)
        p = a * b
        # the products are exact, so XLA:CPU's contractions here are too
        err = nm.xla_fma(al, bl, nm.xla_fma(al, bh, nm.xla_fma(ah, bl, nm.xla_fma(ah, bh, -p))))
        # Neumaier two-sum of p then err; XLA:CPU contracts the product p
        # into the first sum and into its compensation term
        t = nm.xla_fma(a, b, s)
        bv = t - s
        comp = comp + ((s - (t - bv)) + nm.xla_fma(a, b, -bv))
        s = t
        t = s + err
        bv = t - s
        comp = comp + ((s - (t - bv)) + (err - bv))
        s = t
    return s + comp


def _fold(cfg: Config, x: torch.Tensor, mem: torch.Tensor, cpu_order: bool) -> torch.Tensor:
    """The windowed and folded MDCT input [B, N] (mdct.c:115-119)."""
    h = cfg.frame_length // 2
    win = window(cfg, str(x.device))
    buf = torch.cat([mem, x], dim=-1)
    if cfg.la_zeroes:
        buf = torch.nn.functional.pad(buf, (0, cfg.la_zeroes))
    rev = lambda v: v[:, 2 * h: 3 * h].flip(-1)
    # the products XLA:CPU contracts: the second of -w - w, the first of w - w
    fma = nm.xla_fma if cpu_order else nm.fma
    out_lo = fma(-buf[:, 3 * h:], win[3 * h:], -(rev(buf) * rev(win[None, :])))
    out_hi = fma(buf[:, :h], win[:h], -(buf[:, h: 2 * h].flip(-1) * win[h: 2 * h].flip(-1)))
    return torch.cat([out_lo, out_hi], dim=-1)


def mdct_plain(cfg: Config, x: torch.Tensor, mem: torch.Tensor, compensated: bool = False):
    """Forward low-delay MDCT of one frame per stream; the plain version of
    the `mdct` kernel, and with `compensated` of `mdct_compensated`: the
    CPU's order (the fold's contraction and the compensated product) on
    every device. On the CPU both are the CPU's order.

    x: [B, N] PCM frame; mem: [B, N - la_zeroes] previous raw input tail.
    Returns (d [B, N] spectrum, new_mem)."""
    cpu_order = compensated or nm.on_cpu(x)
    folded = _fold(cfg, x, mem, cpu_order)
    Mt = dct4_mt(cfg.frame_length, str(x.device))
    return (_dct4_compensated if cpu_order else _dct4_card)(folded, Mt), x[:, cfg.la_zeroes:]


def compensated_fast_rows(cfg: Config, x: torch.Tensor, mem: torch.Tensor) -> torch.Tensor:
    """[B] bool: the rows whose folded values are all 0 or of 2^-89 <= |v| <
    2^115, where the `mdct_compensated` kernel's terms take the step without
    the Veltkamp split (csrc/dct4.cuh:compensated_fast_input); the other rows
    take the split step."""
    bits = _fold(cfg, x, mem, True).view(torch.int32) & 0x7FFFFFFF
    return ((bits == 0) | ((bits >= 38 << 23) & (bits < 242 << 23))).all(dim=-1)


def imdct_plain(cfg: Config, y: torch.Tensor, mem: torch.Tensor):
    """Inverse MDCT with overlap-add (ProcessingIMDCT_fl); the plain version
    of the `imdct` kernel. On every device the product and the overlap-add
    take the CPU's order (`numerics.xla_dot`, `xla_fma`), so that the card's
    PCM equals the CPU's.

    y: [B, N] spectrum; mem: [B, N - la_zeroes]. Returns (x [B, N], new_mem)."""
    N = cfg.frame_length
    la = cfg.la_zeroes
    h = N // 2
    Mt = dct4_mt(N, str(y.device))
    x_tda = nm.xla_gemv(y, Mt) if y.shape[0] == 1 else nm.xla_dot(y, Mt)
    a = x_tda[:, h:]
    b = x_tda[:, :h]
    x_ov = torch.cat([a, -a.flip(-1), -b.flip(-1), -b], dim=-1)
    win = window(cfg, str(y.device), reverse=True)
    ola = nm.xla_fma(x_ov[:, la:N], win[la:N], mem[:, : N - la])
    x = torch.cat([ola, x_ov[:, N: N + la] * win[N: N + la]], dim=-1)
    return x, x_ov[:, N + la:] * win[N + la:]


def mdct(cfg: Config, x: torch.Tensor, mem: torch.Tensor, compensated: bool = False):
    """The forward MDCT: the CUDA kernel for a tensor on the card (with
    `compensated`, the one in the CPU's order), its plain version for a
    tensor on the CPU."""
    if nm.on_cpu(x):
        return mdct_plain(cfg, x, mem, compensated)
    launch = kernels.mdct_compensated if compensated else kernels.mdct
    return launch(cfg, x.contiguous(), mem.contiguous())


def imdct(cfg: Config, y: torch.Tensor, mem: torch.Tensor):
    """The inverse MDCT: the CUDA kernel for a tensor on the card, its plain
    version for a tensor on the CPU."""
    if nm.on_cpu(y):
        return imdct_plain(cfg, y, mem)
    return kernels.imdct(cfg, y.contiguous(), mem.contiguous())
