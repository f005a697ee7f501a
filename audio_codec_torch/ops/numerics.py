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

The `xla_*` functions (`xla_fma`, `xla_dot`, `xla_gemv`, `xla_exp2`,
`xla_pow`, `xla_div`, `xla_sum`, `xla_dot_row`, `xla_rsqrt`) compute the CPU
branch's order on every device. The decoder's SNS stages, the IMDCT, the
LTPF post-filter and the advanced concealment use them, so that the card
computes what the CPU and the reference compute there, and their kernels
write the same operations (`csrc/acodec.cuh:xfma`, `csrc/plc.cuh`).

`chain_sum` and `chain_dot` are the other way round: the CPU keeps
`torch.sum` and `dot`, and for a tensor on the card they fix the order of the
additions, which `torch.sum` and `torch.matmul` leave to the library, so that
the kernels can equal their plain versions bit for bit.

File:line references are to `audio_codec_tpu/ops/`.
"""
from __future__ import annotations

import functools
import math
from pathlib import Path

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
    return xla_fma(a, b, c)


def xla_fma(a, b, c):
    """a * b + c as the CPU branch of `fma` computes it, on every device: the
    product exact in float64, one float64 add, rounded to float32 (a kernel
    writes the same three double operations, `acodec.cuh:xfma`)."""
    # one operand in float64 is enough: the others promote inside the op
    # (fewer launches on the card, the same values)
    if isinstance(a, torch.Tensor):
        prod = a.to(F64) * b
    elif isinstance(b, torch.Tensor):
        prod = a * b.to(F64)
    else:
        prod = float(a) * float(b)      # two floats' product is exact in double
    if not isinstance(prod, torch.Tensor):
        return (c.to(F64) + prod).to(F32)
    return (prod + c).to(F32)


def _fma_chains(a64, m64, lo: int, hi: int, n_acc: int) -> torch.Tensor:
    """sum_k a[..., k] m[k] over [lo, hi) in n_acc interleaved FMA chains,
    combined pairwise."""
    prods = a64[..., lo:hi, None] * m64[lo:hi]     # exact in float64
    accs = [torch.zeros((*a64.shape[:-1], m64.shape[-1]), dtype=F32, device=a64.device)
            for _ in range(n_acc)]
    for i in range(hi - lo):
        j = i % n_acc
        accs[j] = (prods[..., i, :] + accs[j]).to(F32)   # the add in float64
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
    return xla_dot(a, m, block)


def xla_dot(a: torch.Tensor, m: torch.Tensor, block: int | None = None) -> torch.Tensor:
    """The CPU branch of `dot` on every device: the decoder's SNS products
    take it on the card too, so that the card's scale factors equal the
    CPU's."""
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


def xla_gemv(a: torch.Tensor, m: torch.Tensor) -> torch.Tensor:
    """a [1, K] @ m [K, N] as XLA:CPU computes a product of one row by a
    matrix (a matrix-vector product), on every device: eight interleaved
    fused multiply-add chains over k (chain k % 8) from zero, combined
    pairwise. Read on the IMDCT's product at N = 120-480, the same on one core
    and on many (xla_dot's blocks are those of more than one row)."""
    return _fma_chains(a.to(F64), m.to(F64), 0, m.shape[0], 8)


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


def xla_sum(v: torch.Tensor) -> torch.Tensor:
    """Sum over the last dimension in XLA:CPU's order, on every device.

    XLA rewrites a reduction of more than 32 terms into a tree: the row is
    zero-padded to a multiple of 32 (half the pad in front, the odd zero at
    the end), each window of 32 is summed left to right from zero, and the
    window sums are reduced the same way; 32 terms or fewer are summed left
    to right from zero. A kernel follows it with one lane a window."""
    n = v.shape[-1]
    if n <= 32:
        acc = torch.zeros_like(v[..., 0])
        for k in range(n):
            acc = acc + v[..., k]
        return acc
    tot = -(-n // 32) * 32
    left = (tot - n) // 2
    w = torch.nn.functional.pad(v, (left, tot - n - left)).reshape(*v.shape[:-1], tot // 32, 32)
    acc = torch.zeros_like(w[..., 0])
    for k in range(32):
        acc = acc + w[..., k]
    return xla_sum(acc)


def xla_dot_row(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """sum_k a[..., k] b[..., k] of at most 32 terms as XLA:CPU fuses it
    into its reduction: one fused multiply-add chain from zero (xla_fma)."""
    acc = torch.zeros(torch.broadcast_shapes(a.shape, b.shape)[:-1], dtype=F32,
                      device=a.device)
    for k in range(a.shape[-1]):
        acc = xla_fma(a[..., k], b[..., k], acc)
    return acc


def _x86_rsqrt() -> np.ndarray:
    return np.load(Path(__file__).resolve().parent.parent / "data" / "x86_rsqrt.npy")


def xla_rsqrt(x: torch.Tensor) -> torch.Tensor:
    """1 / sqrt(x) as XLA:CPU computes it (and `a / sqrt(b)`, which it
    rewrites to `a * rsqrt(b)`), on every device: the x86 estimate
    `vrsqrtps` (12 bits, from the exponent's parity and the top 10 bits of
    the mantissa: data/x86_rsqrt.npy, tools/torch_x86_rsqrt_table.py), then
    two Newton steps y += (-y / 2) (x y y - 1) with fused multiply-adds. The
    Newton steps run for a positive normal x; elsewhere the estimate stands,
    as in XLA. A kernel follows it with the same table and `xfma`."""
    tab = table(_x86_rsqrt, device=x.device)
    bits = x.view(torch.int32)
    e = ((bits >> 23) & 0xFF) - 127
    par = e & 1
    scale = ((127 - torch.div(e - par, 2, rounding_mode="floor")).clamp(1, 254) << 23).view(F32)
    y = tab[(par * 1024 + ((bits >> 13) & 1023)).long()] * scale
    for _ in range(2):
        y = xla_fma(y * -0.5, xla_fma(x * y, y, -1.0), y)
    normal = (x > 0) & (bits < 0x7F800000) & (bits >= 0x00800000)
    return torch.where(normal, y, torch.rsqrt(x))


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
    """A table (numpy array) as a tensor on `device`: one copy from the host.
    Tables that a frame step reads go through `table`."""
    return torch.as_tensor(np.ascontiguousarray(arr), dtype=dtype, device=device)


@functools.cache
def _table(make, args: tuple, device: str, dtype, transpose: bool) -> torch.Tensor:
    a = make(*args)
    return const(a.T if transpose else a, device, dtype)


def vec_i32(v, n: int, device) -> torch.Tensor:
    """v, a tensor or a Python number, as [n] int32 on `device` (a number is
    filled on the device, not copied from the host)."""
    if isinstance(v, torch.Tensor):
        return v.to(device=device, dtype=torch.int32).expand(n)
    return torch.full((n,), int(v), dtype=torch.int32, device=device)


def table(make, *args, device, dtype=F32, transpose: bool = False) -> torch.Tensor:
    """make(*args), a numpy table of hashable arguments (transposed if asked),
    as a tensor on `device`, made once per (make, args, device, dtype). A
    copy from the host blocks the host until the card has run everything
    queued before it, so a frame step makes none. Callers never write to
    the tensor."""
    return _table(make, args, str(torch.device(device)), dtype, transpose)


def _exp_cpu(x: torch.Tensor) -> torch.Tensor:
    x = x.to(F32).clamp(f32(-87.8), f32(88.8))
    fx = torch.floor(xla_fma(x, f32(_LOG2EF), 0.5))
    x = xla_fma(fx, -f32(_EXP_C1), x)
    x = xla_fma(fx, -f32(_EXP_C2), x)
    z = x * x
    y = xla_fma(x, f32(_EXP_P[0]), f32(_EXP_P[1]))
    for p in _EXP_P[2:]:
        y = xla_fma(y, x, f32(p))
    y = xla_fma(y, z, x)
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
    return xla_exp2(x) if on_cpu(x) else torch.exp2(x)


def xla_exp2(x: torch.Tensor) -> torch.Tensor:
    """The CPU branch of `exp2` (Cephes, its multiply-adds fused) on every
    device."""
    return _exp_cpu(x * f32(math.log(2.0)))


def log2(x: torch.Tensor) -> torch.Tensor:
    return div(_log_cpu(x), f32(math.log(2.0))) if on_cpu(x) else torch.log2(x)


def log10(x: torch.Tensor) -> torch.Tensor:
    return div(_log_cpu(x), f32(math.log(10.0))) if on_cpu(x) else torch.log10(x)


def pow(base, y: torch.Tensor) -> torch.Tensor:
    """base ** y for a float32 exponent tensor, correctly rounded."""
    if not on_cpu(y):
        return torch.pow(base, y)
    return xla_pow(base, y)


def xla_pow(base, y: torch.Tensor) -> torch.Tensor:
    """The CPU branch of `pow` on every device: through float64, rounded once."""
    b = base.to(F64) if isinstance(base, torch.Tensor) else float(base)
    return torch.pow(b, y.to(F64)).to(F32)


def div(x: torch.Tensor, c: float) -> torch.Tensor:
    """x / c for a constant c; XLA:CPU multiplies by the float32 reciprocal."""
    if not on_cpu(x):
        return x / c
    return xla_div(x, c)


def xla_div(x: torch.Tensor, c: float) -> torch.Tensor:
    """The CPU branch of `div` on every device."""
    return x * f32(1.0 / c)
