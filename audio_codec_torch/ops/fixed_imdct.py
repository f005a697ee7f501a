"""Integer-exact DCT-IV of the fixed-point decoder (BASOP semantics), the
plain version's core (`audio_codec_tpu/ops/fixed_imdct.py:31-488, 545-660`).

dct_IV (dct4_fx.c:16-140) over BASOP_cfft (fft.c:3668) for the 10 ms
sizes: the cfft of 40 (fft40), 80, 120, 160 and 240 points (fftN2_8 over
fft10, fft15, fft20 and fft30 columns). As in the reference, every FFT
"node" is a vector over the batch: here an int64 tensor of [B] rows, so
one pass transforms every row; the arithmetic is saturating 32-bit with
the BASOP primitives' rounding (`fixed_dec.py`). The card runs the same
transform as the `fx_dct4` kernel (csrc/fx_dct4.cu); this module is its
plain version's core (`fixed_dev.batch_dct4_plain`).

The 2.5 and 5 ms sizes (cfft 60 and the fftN2_4/fftN2_12 cores) and HR
mode are not ported (ROADMAP Queue 1 item 9): `cfft` raises for them.
"""
from __future__ import annotations

import numpy as np
import torch

from .. import tables as T
from .fixed_dec import L_shl, mpy_32_16, mpy_32_32, sat32


# ------------------------------------------------------------ primitives


def _w16(v32: int) -> int:
    """WORD322WORD16 (basop_util.h:40-44)."""
    if v32 >= 1 << 31:
        v32 -= 1 << 32
    r = (v32 >> 15) + 1
    if r > 0xFFFF and v32 > 0:
        return 32767
    r = (r >> 1) & 0xFFFF
    return r - 0x10000 if r >= 0x8000 else r


def _s32(v: int) -> int:
    return v - (1 << 32) if v >= 1 << 31 else v


def ladd(a, b):
    return sat32(a + b)


def lsub(a, b):
    return sat32(a - b)


def lneg(a):
    return sat32(-a)       # lneg(-2^31) = 2^31 - 1


def shr(a, n: int):
    return a >> n


def lshl1(a):
    return L_shl(a, 1)


m16 = mpy_32_16
m32 = mpy_32_32

# FFT constants (fft.c:53-90)
C31 = _w16(0x91261468)
C51, C52, C53, C54, C55 = (_w16(v) for v in
                           (0x79BC3854, 0x9D839DB0, 0xD18053CE, 0x478DDE64, 0xB0000001))
C81, C82 = _w16(0x5A82799A), _w16(0xA57D8666)
C51_32, C52_32, C53_32, C54_32, C55_32 = (
    _s32(v) for v in (0x79BC3854, 0x9D839DB0, 0xD18053CE, 0x478DDE64, 0xB0000001))
C81_32, C82_32 = _s32(0x5A82799A), _s32(0xA57D8666)
TWIDDLE = _w16(0x5A82799A)

SC5, SC10, SC15, SC20 = 4, 5, 5, 5
SC30_1, SC30_2, SCN2 = 5, 1, 3
SCALE = {10: 5, 15: 5, 20: 5, 30: 6, 40: 7, 80: 8, 120: 8, 160: 8, 240: 9}

# ------------------------------------------------------------ radix cores


def _core5(x0, x1, x2, x3, x4, mul, c51, c52, c53, c54, c55):
    """Shared 5-point butterfly (fft.c:215-231). Returns (y0, r1, r3, r4, r2)."""
    r1, r4 = ladd(x1, x4), lsub(x1, x4)
    r3, r2 = ladd(x2, x3), lsub(x2, x3)
    t = mul(lsub(r1, r3), c54)
    r1 = ladd(r1, r3)
    y0 = ladd(x0, r1)
    r1 = ladd(y0, lshl1(mul(r1, c55)))
    r3, r1 = lsub(r1, t), ladd(r1, t)
    t = mul(ladd(r4, r2), c51)
    r4 = ladd(t, lshl1(mul(r4, c52)))
    r2 = ladd(t, mul(r2, c53))
    return y0, r1, r3, r4, r2


def _comb5(rr, ss):
    """FFT5 real/imag combination (fft.c:261-277)."""
    y0, r1, r3, r4, r2 = rr
    z0, s1, s3, s4, s2 = ss
    return [(y0, z0),
            (ladd(r1, s2), lsub(s1, r2)),
            (lsub(r3, s4), ladd(s3, r4)),
            (ladd(r3, s4), lsub(s3, r4)),
            (lsub(r1, s2), ladd(s1, r2))]


def _fft5_pairs(p, mul, consts):
    rr = _core5(*(x[0] for x in p), mul, *consts)
    ss = _core5(*(x[1] for x in p), mul, *consts)
    return _comb5(rr, ss)


_C16 = (C51, C52, C53, C54, C55)
_C32 = (C51_32, C52_32, C53_32, C54_32, C55_32)


def fft5(p):
    """fft5 (fft.c:204-281): 32-bit twiddle constants."""
    p = [(shr(r, SC5), shr(i, SC5)) for r, i in p]
    return _fft5_pairs(p, m32, _C32)


def _bfly8(x, mul, c81, c82, pre_shift: int):
    """Radix-8 butterfly of the second stage of fft40/fftN2
    (fft.c:3272-3355, 3492-3600), with the SCALEFACTORN2-1 shifts."""
    (x00, x01, x02, x03, x04, x05, x06, x07,
     x08, x09, x10, x11, x12, x13, x14, x15) = x
    ps = (lambda v: shr(v, pre_shift)) if pre_shift else (lambda v: v)
    t00, t02 = ps(ladd(x00, x08)), ps(lsub(x00, x08))
    t01, t03 = ps(ladd(x01, x09)), ps(lsub(x01, x09))
    t04, t06 = ps(ladd(x02, x10)), lsub(x02, x10)
    t05, t07 = ps(ladd(x03, x11)), lsub(x03, x11)
    t08, t10 = ps(ladd(x04, x12)), ps(lsub(x04, x12))
    t09, t11 = ps(ladd(x05, x13)), ps(lsub(x05, x13))
    t12, t14 = ps(ladd(x06, x14)), lsub(x06, x14)
    t13, t15 = ps(ladd(x07, x15)), lsub(x07, x15)
    s00, s04 = ladd(t00, t08), lsub(t00, t08)
    s01, s05 = ladd(t01, t09), lsub(t01, t09)
    s08, s10 = lsub(t02, t11), ladd(t02, t11)
    s09, s11 = ladd(t03, t10), lsub(t03, t10)
    s02, s07 = ladd(t04, t12), lsub(t04, t12)
    s03, s06 = ladd(t05, t13), lsub(t13, t05)
    ta = ps(ladd(t06, t14))
    tb = ps(lsub(t06, t14))
    tc = ps(ladd(t07, t15))
    td = ps(lsub(t07, t15))
    s12 = mul(ladd(tc, tb), c81)
    s14 = mul(lsub(tc, tb), c81)
    s13 = mul(lsub(td, ta), c81)
    s15 = mul(ladd(ta, td), c82)
    return [(ladd(s00, s02), ladd(s01, s03)),
            (ladd(s10, s12), ladd(s11, s13)),
            (lsub(s04, s06), lsub(s05, s07)),
            (ladd(s08, s14), ladd(s09, s15)),
            (lsub(s00, s02), lsub(s01, s03)),
            (lsub(s10, s12), lsub(s11, s13)),
            (ladd(s04, s06), ladd(s05, s07)),
            (lsub(s08, s14), lsub(s09, s15))]


def fft10(p):
    """fft10 (fft.c:433-595): 2 FFT5 stages + 5 radix-2 stages."""
    l = [(shr(r, SC10), shr(i, SC10)) for r, i in p]
    a = _fft5_pairs([l[0], l[6], l[2], l[8], l[4]], m16, _C16)
    b = _fft5_pairs([l[5], l[1], l[7], l[3], l[9]], m16, _C16)
    out = [None] * 10
    for k, (oa, ob) in enumerate([(0, 5), (2, 7), (4, 9), (6, 1), (8, 3)]):
        (ar, ai), (br, bi) = a[k], b[k]
        out[oa] = (ladd(ar, br), ladd(ai, bi))
        out[ob] = (lsub(ar, br), lsub(ai, bi))
    return out


_FFT15_SLOTS = [(0, 10, 5), (6, 1, 11), (12, 7, 2), (3, 13, 8), (9, 4, 14)]


def _fft15_core(l):
    """3 FFT5 + 5 FFT3 stages shared by fft15 and fft30
    (fft.c:656-913, 1817-2320)."""
    blocks = [_fft5_pairs(l[5 * j: 5 * j + 5], m16, _C16) for j in range(3)]
    out = [None] * 15
    for k, (i0, isub, iadd) in enumerate(_FFT15_SLOTS):
        (ar, ai) = blocks[0][k]
        (br, bi) = blocks[1][k]
        (cr, ci) = blocks[2][k]
        r1 = ladd(br, cr)
        r2 = m16(lsub(br, cr), C31)
        o0r = ladd(ar, r1)
        r1 = lsub(ar, shr(r1, 1))
        s1 = ladd(bi, ci)
        s2 = m16(lsub(bi, ci), C31)
        o0i = ladd(ai, s1)
        s1 = lsub(ai, shr(s1, 1))
        out[i0] = (o0r, o0i)
        out[isub] = (lsub(r1, s2), ladd(s1, r2))
        out[iadd] = (ladd(r1, s2), lsub(s1, r2))
    return out


_LOAD15 = [0, 3, 6, 9, 12, 5, 8, 11, 14, 2, 10, 13, 1, 4, 7]


def fft15(p):
    l = [(shr(p[j][0], SC15), shr(p[j][1], SC15)) for j in _LOAD15]
    return _fft15_core(l)


_LOAD30_A = [0, 18, 6, 24, 12, 20, 8, 26, 14, 2, 10, 28, 16, 4, 22]
_LOAD30_B = [15, 3, 21, 9, 27, 5, 23, 11, 29, 17, 25, 13, 1, 19, 7]
_PAIR30 = [0, 8, 1, 9, 2, 10, 3, 11, 4, 12, 5, 13, 6, 14, 7]


def fft30(p):
    """fft30 (fft.c:1791-2583): 2 FFT15 blocks + 15 FFT2 stages."""
    za = _fft15_core([(shr(p[j][0], SC30_1), shr(p[j][1], SC30_1)) for j in _LOAD30_A])
    zb = _fft15_core([(shr(p[j][0], SC30_1), shr(p[j][1], SC30_1)) for j in _LOAD30_B])
    out = [None] * 30
    for t in range(15):
        k = _PAIR30[t]
        r1, r3 = shr(za[k][0], SC30_2), shr(za[k][1], SC30_2)
        r2, r4 = shr(zb[k][0], SC30_2), shr(zb[k][1], SC30_2)
        add_ = (ladd(r1, r2), ladd(r3, r4))
        sub_ = (lsub(r1, r2), lsub(r3, r4))
        if t % 2 == 0:
            out[t], out[15 + t] = add_, sub_
        else:
            out[15 + t], out[t] = add_, sub_
    return out


_LOAD20 = [[0, 16, 12, 8, 4], [5, 1, 17, 13, 9], [10, 6, 2, 18, 14], [15, 11, 7, 3, 19]]


def fft20(p):
    """fft20 (fft.c:1395-1786): 4 FFT5 stages + 5 FFT4 stages."""
    blocks = [_fft5_pairs([(shr(p[j][0], SC20), shr(p[j][1], SC20)) for j in idx], m16, _C16)
              for idx in _LOAD20]
    out = [None] * 20
    for g in range(5):
        (ar, ai), (br, bi), (cr, ci), (dr, di) = (blocks[b][g] for b in range(4))
        t0, t2 = ladd(ar, cr), lsub(ar, cr)
        t1, t3 = ladd(ai, ci), lsub(ai, ci)
        t4, t7 = ladd(br, dr), lsub(br, dr)
        t5, t6 = ladd(di, bi), lsub(di, bi)
        s = [(ladd(t0, t4), ladd(t1, t5)), (lsub(t2, t6), lsub(t3, t7)),
             (lsub(t0, t4), lsub(t1, t5)), (ladd(t2, t6), ladd(t3, t7))]
        for j in range(4):
            out[(4 * g + 5 * j) % 20] = s[j]
    return out


def _rep(vals, seg: int, like: torch.Tensor) -> torch.Tensor:
    """Per-segment constant vector: vals[i] repeated seg times."""
    return torch.as_tensor(np.repeat(np.asarray(vals, np.int64), seg), device=like.device)


def _chunked_fft2(p, dim1: int, dim2: int, stage1, twiddle, bfly):
    """The two-stage FFT of fftN2 and fft40 (fft.c:3364-3660): all `dim2`
    first-stage transforms and all `dim1` second-stage butterfly columns run
    as one pass each, the chunk or column index folded into the lane axis."""
    B = p[0][0].shape[0]
    big_in = [(torch.cat([p[i + dim2 * j][0] for i in range(dim2)]),
               torch.cat([p[i + dim2 * j][1] for i in range(dim2)])) for j in range(dim1)]
    big_out = stage1(big_in)
    cols = []
    for k in range(dim2):
        re = torch.cat([big_out[i][0][k * B:(k + 1) * B] for i in range(dim1)])
        im = torch.cat([big_out[i][1][k * B:(k + 1) * B] for i in range(dim1)])
        cols.append((re, im))
    res = bfly(twiddle(cols, B))
    out = [None] * (dim1 * dim2)
    for k in range(dim2):
        for i in range(dim1):
            out[i + dim1 * k] = (res[k][0][i * B:(i + 1) * B], res[k][1][i * B:(i + 1) * B])
    return out


def fft40(p):
    """fft40 (fft.c:3208-3352): 8 x fft5 then twiddled radix-8 columns
    with the 32-bit RotVector_40_32."""
    W = np.asarray(T.t("fx_RotVector_40_32")).astype(np.int64)

    def twiddle(cols, B):
        x = []
        i0 = _rep([1] + [0] * 4, B, cols[0][0]).bool()
        for k in range(8):
            a, b = cols[k]
            if k == 0:
                x += [shr(a, 1), shr(b, 1)]
            else:
                c = _rep([0] + [int(W[2 * (i - 1) + (k - 1) * 8]) for i in range(1, 5)], B, a)
                d = _rep([0] + [int(W[2 * (i - 1) + (k - 1) * 8 + 1]) for i in range(1, 5)], B, a)
                # cplxMpy4_8_2 (fft.c:132-139): conjugate multiply
                tr = shr(ladd(m32(a, c), m32(b, d)), 1)
                ti = shr(lsub(m32(b, c), m32(a, d)), 1)
                x += [torch.where(i0, shr(a, 1), tr), torch.where(i0, shr(b, 1), ti)]
        return x

    def bfly(x):
        return _bfly8(x, m32, C81_32, C82_32, pre_shift=SCN2 - 1)

    return _chunked_fft2(p, 5, 8, fft5, twiddle, bfly)


_STAGE1 = {10: fft10, 15: fft15, 20: fft20, 30: fft30}


def fftN2_8(p, Wname: str, dim1: int, sc: int, Woff: int):
    """fftN2, dim2 == 8 (fft.c:3364-3434, 3493-3602): dim1-point first
    stage then Word16-twiddled radix-8 columns."""
    W = np.asarray(T.t("fx_" + Wname)).astype(np.int64)

    def twiddle(cols, B):
        x = []
        i0 = _rep([1] + [0] * (dim1 - 1), B, cols[0][0]).bool()
        for k in range(8):
            a, b = cols[k]
            if k == 0:
                x += [shr(a, 1), shr(b, 1)]
            else:
                c = _rep([0] + [int(W[sc * i + sc * k * dim1 - Woff]) for i in range(1, dim1)],
                         B, a)
                d = _rep([0] + [int(W[sc * i + sc * k * dim1 + 1 - Woff])
                                for i in range(1, dim1)], B, a)
                # cplxMpy4_8_0 (fft.c:113-119)
                tr = shr(lsub(m16(a, c), m16(b, d)), 1)
                ti = shr(ladd(m16(a, d), m16(b, c)), 1)
                x += [torch.where(i0, shr(a, 1), tr), torch.where(i0, shr(b, 1), ti)]
        return x

    def bfly(x):
        return _bfly8(x, m16, C81, C82, pre_shift=SCN2 - 1)

    return _chunked_fft2(p, dim1, 8, _STAGE1[dim1], twiddle, bfly)


# the twiddle table, first-stage size, stride and offset of each cfft size
CFFT_N2_8 = {80: ("RotVector_320", 10, 4, 40), 120: ("RotVector_480", 15, 4, 60),
             160: ("RotVector_320", 20, 2, 40), 240: ("RotVector_480", 30, 2, 60)}


def cfft(p, length: int):
    """BASOP_cfft (fft.c:3668-3800) for the 10 ms IMDCT sizes; returns
    (pairs, scale_add)."""
    if length == 40:
        return fft40(p), SCALE[40]
    if length in CFFT_N2_8:
        return fftN2_8(p, *CFFT_N2_8[length]), SCALE[length]
    raise NotImplementedError(f"cfft of {length} points (only the 10 ms sizes 40-240 are "
                              f"ported)")


# ------------------------------------------------------------ DCT-IV

_SIN_TABLES = {80: ("fx_SineTable320", 8), 160: ("fx_SineTable320", 4),
               240: ("fx_SineTable480", 4), 320: ("fx_SineTable320", 2),
               480: ("fx_SineTable480", 2)}


def _cplx_2(a, b, c, d):
    """cplxMpy32_32_16_2 (basop_mpy.h:45-50)."""
    return (lsub(shr(m16(a, c), 1), shr(m16(b, d), 1)),
            ladd(shr(m16(a, d), 1), shr(m16(b, c), 1)))


def dct_IV(pd: list, L: int):
    """dct_IV (dct4_fx.c:16-140) on a list of L batch vectors; returns
    (pd, scale_add)."""
    tw = T.t(f"fx_SineWindow{L}")
    sin_name, sin_step = _SIN_TABLES[L]
    sin = T.t(sin_name)
    M = L >> 1
    M2 = M - 1

    p0, p1 = 0, L - 2
    for i in range(0, M2, 2):
        a1, a2 = _cplx_2(pd[p1 + 1], pd[p0], int(tw[i][0]), int(tw[i][1]))
        a3, a4 = _cplx_2(pd[p1], pd[p0 + 1], int(tw[i + 1][0]), int(tw[i + 1][1]))
        pd[p0], pd[p0 + 1] = a2, a1
        pd[p1], pd[p1 + 1] = a4, lneg(a3)
        p0 += 2
        p1 -= 2

    pairs = [(pd[2 * j], pd[2 * j + 1]) for j in range(M)]
    pairs, sc_add = cfft(pairs, M)
    for j in range(M):
        pd[2 * j], pd[2 * j + 1] = pairs[j]

    p0, p1 = 0, L - 2
    idx = sin_step
    M2 = ((M + 1) >> 1) - 1
    a3, a4 = _cplx_2(pd[p1], pd[p1 + 1], int(sin[idx][0]), int(sin[idx][1]))
    pd[p1 + 1] = lneg(shr(pd[p0 + 1], 1))
    pd[p0] = shr(pd[p0], 1)
    for _ in range(1, M2):
        pd[p0 + 1], pd[p1] = a3, a4
        p0 += 2
        p1 -= 2
        a1, a2 = _cplx_2(pd[p0 + 1], pd[p0], int(sin[idx][0]), int(sin[idx][1]))
        idx += sin_step
        a3, a4 = _cplx_2(pd[p1], pd[p1 + 1], int(sin[idx][0]), int(sin[idx][1]))
        pd[p1 + 1] = lneg(a1)
        pd[p0] = a2
    pd[p0 + 1], pd[p1] = a3, a4
    p0 += 2
    p1 -= 2
    a3, a4 = _cplx_2(pd[p0 + 1], pd[p0], int(sin[idx][0]), int(sin[idx][1]))
    a1 = shr(m16(pd[p1], TWIDDLE), 1)
    a2 = shr(m16(pd[p1 + 1], TWIDDLE), 1)
    pd[p1] = ladd(a1, a2)
    pd[p0 + 1] = lsub(a1, a2)
    pd[p1 + 1] = lneg(a3)
    pd[p0] = a4
    return pd, sc_add + 2


# ------------------------------------------------------------ IMDCT window

_WIN = {80: "fx_LowDelayShapes_n960_N80", 160: "fx_LowDelayShapes_n960_N160",
        240: "fx_LowDelayShapes_n960_N240", 320: "fx_LowDelayShapes_n960_N320",
        480: "fx_LowDelayShapes_n960_N480"}
MAX_BW = 400


def window_table(N: int) -> np.ndarray:
    return T.t(_WIN[N])
