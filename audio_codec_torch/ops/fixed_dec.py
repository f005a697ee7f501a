"""ITU-T BASOP primitives on int64 tensors, for the bit-exact fixed-point
decoder (`audio_codec_tpu/ops/fixed_dec.py:64-145, 378-404`).

Word16 and Word32 values ride int64 tensors, as the reference carries them
in int64 (jax_enable_x64): a product of two Word32 values is exact in
int64 (|xy| <= 2^62). Every shift count is clamped to 0..63 before it
reaches `<<` or `>>`, where torch's int64 shifts agree with numpy's
(`tests/test_torch_fixed_dev.py` checks counts 0-63); `>>` of a negative
value is arithmetic. The per-frame host functions of the reference module
stay there; their batched counterparts are `fixed_dev.py`.

Each function takes tensors or Python ints and returns an int64 tensor
(a Python int in gives a 0-dim tensor).
"""
from __future__ import annotations

import torch

I64 = torch.int64
MIN32, MAX32 = -(1 << 31), (1 << 31) - 1
MIN16, MAX16 = -(1 << 15), (1 << 15) - 1


def _t(x, like=None) -> torch.Tensor:
    if isinstance(x, torch.Tensor):
        return x.to(I64)
    dev = like.device if isinstance(like, torch.Tensor) else None
    return torch.as_tensor(int(x), dtype=I64, device=dev)


def _like(*xs):
    return next((x for x in xs if isinstance(x, torch.Tensor)), None)


def sat32(x) -> torch.Tensor:
    return torch.clamp(_t(x), MIN32, MAX32)


def sat16(x) -> torch.Tensor:
    return torch.clamp(_t(x), MIN16, MAX16)


def bitlen(x) -> torch.Tensor:
    """Bit length of non-negative int64 values (exact below 2^53)."""
    x = _t(x)
    e = torch.frexp(x.to(torch.float64))[1].to(I64)
    return torch.where(x > 0, e, 0)


def norm_s(x) -> torch.Tensor:
    """Leading-sign-bit count minus 1 of a Word16 (basop32 norm_s);
    norm_s(0) = 0, norm_s(-1) = 15."""
    x = _t(x)
    mag = torch.where(x < 0, ~x, x)          # ~x = -x-1 for negatives
    return torch.where(x == 0, 0, 15 - bitlen(mag))


def norm_l(x) -> torch.Tensor:
    """norm_s of a Word32: norm_l(0) = 0, norm_l(-1) = 31."""
    x = _t(x)
    mag = torch.where(x < 0, ~x, x)
    return torch.where(x == 0, 0, 31 - bitlen(mag))


def L_shl(x, s) -> torch.Tensor:
    """Saturating left shift; a negative s is an arithmetic right shift."""
    like = _like(x, s)
    x, s = _t(x, like), _t(s, like)
    sl = torch.clamp(s, 0, 63)
    over = (torch.abs(x) >> torch.clamp(31 - sl, min=0)) > 0
    left = sat32(torch.where(over, torch.where(x >= 0, MAX32, MIN32), x << sl))
    right = x >> torch.clamp(-s, 0, 63)
    return torch.where(s >= 0, left, right)


def mpy_32_16(x, y) -> torch.Tensor:
    """Mpy_32_16: sat32((x*y) >> 15), floor (enh40.c:126-148)."""
    like = _like(x, y)
    return sat32((_t(x, like) * _t(y, like)) >> 15)


def mpy_32_32(x, y) -> torch.Tensor:
    """Mpy_32_32: sat32((x*y) >> 31), floor (enh40.c:204-232)."""
    like = _like(x, y)
    return sat32((_t(x, like) * _t(y, like)) >> 31)


def round_fx(L) -> torch.Tensor:
    return sat16(sat32(_t(L) + 0x8000) >> 16)


def mult_r(a, b) -> torch.Tensor:
    like = _like(a, b)
    return sat16((_t(a, like) * _t(b, like) + 0x4000) >> 15)


def L_mult(a, b) -> torch.Tensor:
    like = _like(a, b)
    return sat32((_t(a, like) * _t(b, like)) << 1)


def mac_r(L, a, b) -> torch.Tensor:
    like = _like(L, a, b)
    return round_fx(sat32(_t(L, like) + L_mult(_t(a, like), _t(b, like))))


def msu_r(L, a, b) -> torch.Tensor:
    like = _like(L, a, b)
    return round_fx(sat32(_t(L, like) - L_mult(_t(a, like), _t(b, like))))


def shl16(x, s) -> torch.Tensor:
    """Word16 saturating left shift; a negative s shifts right (both counts
    clamped to 31, as the reference's shl16v)."""
    like = _like(x, s)
    x, s = _t(x, like), _t(s, like)
    left = sat16(x << torch.clamp(s, 0, 31))
    right = x >> torch.clamp(-s, 0, 31)
    return torch.where(s >= 0, left, right)


def _pascal_A(dim: int, kmax: int) -> list[int]:
    """MPVQ offset column A(dim, 0..kmax) + top U(dim, kmax+1), exact
    integers (the tabled h_memN{16,10,6}K* vectors, constants.c:2560-2632)."""
    A = [0, 1] + [1] * kmax          # A(1, k)
    for _ in range(2, dim + 1):
        row = [0] * (kmax + 2)
        for k in range(1, kmax + 2):
            row[k] = A[k] + A[k - 1] + row[k - 1]
        A = row
    return A[: kmax + 1] + [A[kmax + 1] >> 1]


_TABLED_KMAX = {6: 2, 10: 22, 16: 12}
_MPVQ_OFFS = {d: _pascal_A(d, k) for d, k in _TABLED_KMAX.items()}
