"""CPU-reference numerics: float32 arithmetic that reproduces the JAX
reference's results on the CPU, and is plain PyTorch on the card.

Every helper here has two branches. For a CUDA tensor it is the plain
PyTorch operation: the port runs on the card on its own numerics, and
`torch.matmul` keeps full float32 (TF32 off, see `models/state.py`). For a
CPU tensor it follows what XLA:CPU (jax 0.9) was seen to compute for the
reference's operations, because PyTorch's CPU kernels round differently in
the last place, and one ulp in a gain or a spectrum moves an output sample
across a rounding boundary. The CPU branch exists only so that the tests
can hold the port to the reference bit for bit; it is retired once the
card's path is held to the reference by other means (ROADMAP Queue 3).

What each CPU branch reproduces, and where the reference relies on it:

- `fma`: a product feeding an add inside one fused computation is
  contracted to a fused multiply-add (computed here in float64 and rounded
  once); used wherever the reference writes a*b + c in one fusion.
- `dot`: a matrix product with a constant operand accumulates the
  contraction in fused multiply-add chains whose order depends on the
  shapes (`sns.py:72,84,234,255,328,369`, `analysis.py:43,208,333`,
  `transforms.py:107`; the last one as a process pinned to one core
  computes it).
- `exp2`, `log2`, `log10`: `exp` and `log` are Cephes polynomials with
  fused range reduction; `exp2(x)` is `exp(x * ln 2)` and `log2`/`log10`
  multiply `log` by 1/ln 2 and 1/ln 10 (`quant.py:64,70,81`, `sns.py:59,372`,
  `analysis.py:363`).
- `pow`: correctly rounded (`quant.py:120,270,392`, `sns.py:53`,
  `tns.py:144`).
- `div`: a division by a constant is a multiplication by the float32
  reciprocal.
- `sqrt`: correctly rounded, as XLA:CPU's root is (`analysis.py:120,190,255`,
  `pc.py:170`); PyTorch's vectorised CPU root is not always.

`chain_sum` and `chain_dot` are the other way round: the CPU keeps
`torch.sum` and `dot`, and for a tensor on the card they fix the order of the
additions, which `torch.sum` and `torch.matmul` leave to the library, so that
the kernels can equal their plain versions bit for bit.

File:line references are to `audio_codec_tpu/ops/`.
"""
from __future__ import annotations

import math

import numpy as np
import torch

F32 = torch.float32
F64 = torch.float64


def on_cpu(x: torch.Tensor) -> bool:
    return x.device.type == "cpu"


def fma(a, b, c):
    """a * b + c with one rounding (XLA:CPU's contraction) on the CPU."""
    t = next(v for v in (a, b, c) if isinstance(v, torch.Tensor))
    if not on_cpu(t):
        return a * b + c
    d = lambda v: v.to(F64) if isinstance(v, torch.Tensor) else float(v)
    return (d(a) * d(b) + d(c)).to(F32)


def _fma_chains(a64, m64, lo: int, hi: int, n_acc: int) -> torch.Tensor:
    """sum_k a[..., k] m[k] over [lo, hi) in n_acc interleaved FMA chains,
    combined pairwise."""
    accs = [torch.zeros((*a64.shape[:-1], m64.shape[-1]), dtype=F32)
            for _ in range(n_acc)]
    for i, k in enumerate(range(lo, hi)):
        j = i % n_acc
        accs[j] = (a64[..., k: k + 1] * m64[k] + accs[j].to(F64)).to(F32)
    while len(accs) > 1:
        accs = [accs[i] + accs[i + 1] for i in range(0, len(accs), 2)]
    return accs[0]


def dot(a: torch.Tensor, m: torch.Tensor, block: int | None = None) -> torch.Tensor:
    """a [..., K] @ m [K, N] in float32.

    On the CPU this is the accumulation order XLA:CPU was seen to use for
    the codec's constant operands: four interleaved chains for the 16-wide
    SNS transforms, 68-deep blocks for the 480x480 DCT-IV of the IMDCT,
    256-deep blocks for more than 512 terms, one chain otherwise; each
    block is one fused multiply-add chain from zero, and the blocks' sums
    are added in order. A caller whose product was read to take another
    depth states it in `block` (the resampler's frame taps). XLA:CPU hands
    the IMDCT's product to YNNPACK, whose blocks depend on the cores the
    process may use: the 68-deep blocks are those of a process pinned to one
    core with XLA_FLAGS unset, read by probing with cancelling operands
    (tests/test_torch_transforms.py holds them to such a process), for more
    than one row of `a`."""
    if not on_cpu(a):
        return torch.matmul(a, m)
    K, N = m.shape
    a64 = a.to(F64)
    m64 = m.to(F64)
    if N == 16 and K <= 64:
        return _fma_chains(a64, m64, 0, K, 4)
    if block is None:
        block = 68 if (K, N) == (480, 480) else 256 if K > 512 else K
    out = None
    for lo in range(0, K, block):
        part = _fma_chains(a64, m64, lo, min(K, lo + block), 1)
        out = part if out is None else out + part
    return out


def chain_sum(v: torch.Tensor, dim: int = -1) -> torch.Tensor:
    """Sum over `dim`. On the card one left-to-right chain of separately
    rounded adds from the first term: the order is written down, so that a
    kernel can follow it bit for bit. `torch.sum` on the CPU."""
    if on_cpu(v):
        return torch.sum(v, dim=dim)
    terms = v.unbind(dim)
    acc = terms[0]
    for term in terms[1:]:
        acc = acc + term
    return acc


def sqrt(x: torch.Tensor) -> torch.Tensor:
    """The correctly rounded float32 square root, on every device: the root
    in float64 rounded once to float32 (53 >= 2 * 24 + 2 bits, so the
    double rounding is exact). XLA:CPU's root and the card's `sqrt` (and the
    kernels' `rroot`) are correctly rounded; PyTorch's vectorised CPU
    `torch.sqrt` is not always (0.506 ulp seen at 0.1267 and at 5.53e18), so
    it could neither match the reference nor rehearse the card's order."""
    return torch.sqrt(x.to(F64)).to(F32)


def chain_dot(a: torch.Tensor, m: torch.Tensor) -> torch.Tensor:
    """a [..., K] @ m [K, N]. On the card a k-ascending chain of separately
    rounded products and adds from the first product (see chain_sum); `dot`
    on the CPU."""
    if on_cpu(a):
        return dot(a, m)
    acc = a[..., 0:1] * m[0]
    for k in range(1, m.shape[0]):
        acc = acc + a[..., k: k + 1] * m[k]
    return acc


_LOG2EF = 1.44269504088896341
_EXP_C1 = 0.693359375
_EXP_C2 = -2.12194440e-4
_EXP_P = (1.9875691500e-4, 1.3981999507e-3, 8.3334519073e-3,
          4.1665795894e-2, 1.6666665459e-1, 5.0000001201e-1)
_LOG_P = (7.0376836292e-2, -1.1514610310e-1, 1.1676998740e-1,
          -1.2420140846e-1, 1.4249322787e-1, -1.6668057665e-1,
          2.0000714765e-1, -2.4999993993e-1, 3.3333331174e-1)
_LOG_Q1 = -2.12194440e-4
_LOG_Q2 = 0.693359375


def f32(v: float) -> float:
    """v rounded to float32."""
    return float(torch.tensor(v, dtype=F32))


def const(arr, device, dtype=F32) -> torch.Tensor:
    """A table (numpy array) as a tensor on `device`."""
    return torch.as_tensor(np.ascontiguousarray(arr), dtype=dtype, device=device)


def _exp_cpu(x: torch.Tensor) -> torch.Tensor:
    x = x.to(F32).clamp(f32(-87.8), f32(88.8))
    fx = torch.floor(fma(x, f32(_LOG2EF), 0.5))
    x = fma(fx, -f32(_EXP_C1), x)
    x = fma(fx, -f32(_EXP_C2), x)
    z = x * x
    y = fma(x, f32(_EXP_P[0]), f32(_EXP_P[1]))
    for p in _EXP_P[2:]:
        y = fma(y, x, f32(p))
    y = fma(y, z, x)
    y = 1.0 + y
    n = fx.to(torch.int32) + 127
    pow2n = (n.clamp(min=0) << 23).view(F32)
    return y * pow2n


def _log_cpu(x: torch.Tensor) -> torch.Tensor:
    x = torch.maximum(x.to(F32), torch.tensor(1.17549435e-38, dtype=F32))
    bits = x.view(torch.int32)
    e = ((bits >> 23) & 0xFF).to(F32) - 126.0
    mant = ((bits & ~0x7F800000) | 0x3F000000).view(F32)
    mask = mant < f32(0.707106781186547524)
    tmp = torch.where(mask, mant, torch.zeros_like(mant))
    xx = mant - 1.0
    e = e - mask.to(F32)
    xx = xx + tmp
    x2 = xx * xx
    x3 = x2 * xx
    p = [f32(v) for v in _LOG_P]
    y = fma(p[0], xx, p[1])
    y1 = fma(p[3], xx, p[4])
    y2 = fma(p[6], xx, p[7])
    y = fma(y, xx, p[2])
    y1 = fma(y1, xx, p[5])
    y2 = fma(y2, xx, p[8])
    y = fma(y, x3, y1)
    y = fma(y, x3, y2)
    y = y * x3
    y = y + e * f32(_LOG_Q1)
    xx = xx - 0.5 * x2
    xx = xx + y
    return xx + e * f32(_LOG_Q2)


def exp2(x: torch.Tensor) -> torch.Tensor:
    return _exp_cpu(x * f32(math.log(2.0))) if on_cpu(x) else torch.exp2(x)


def log2(x: torch.Tensor) -> torch.Tensor:
    return div(_log_cpu(x), f32(math.log(2.0))) if on_cpu(x) else torch.log2(x)


def log10(x: torch.Tensor) -> torch.Tensor:
    return div(_log_cpu(x), f32(math.log(10.0))) if on_cpu(x) else torch.log10(x)


def pow(base, y: torch.Tensor) -> torch.Tensor:
    """base ** y for a float32 exponent tensor, correctly rounded."""
    if not on_cpu(y):
        return torch.pow(base, y)
    b = base.to(F64) if isinstance(base, torch.Tensor) else float(base)
    return torch.pow(b, y.to(F64)).to(F32)


def div(x: torch.Tensor, c: float) -> torch.Tensor:
    """x / c for a constant c; XLA:CPU multiplies by the float32 reciprocal."""
    if not on_cpu(x):
        return x / c
    return x * f32(1.0 / c)
