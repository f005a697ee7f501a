"""Spectral quantization: global gain loop, quantizer and context bit
estimate, noise factor, residual coding, and the decoder-side inverses.

Counterparts of `audio_codec_tpu/ops/quant.py`:
- processEstimateGlobalGain_fl (estimate_global_gain.c:30-137), in the
  reference's exact float32 add order; its bisection is the CUDA kernel
  `gain_bisection` on the card (csrc/gain_bisection.cu);
- processQuantizeSpec_fl (quantize_spec.c:26-197); the context bit
  estimate is the CUDA kernel `bit_estimate` on the card (csrc/bit_estimate.cu);
- processAdjustGlobalGain_fl, processNoiseFactor_fl, residual coding and
  decoding, processApplyGlobalGain_fl, processNoiseFilling_fl. On the card
  the encoder's noise factor and residual coder are the CUDA kernel
  `noise_residual_enc` (csrc/noise_residual_enc.cu), and the decoder's
  spectrum reconstruction from partial concealment to the global gain is
  the CUDA kernel `spec_decode` (csrc/spec_decode.cu).
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


def round_c(x):
    """C round(): half away from zero (torch.round is half-even)."""
    return torch.sign(x) * torch.floor(torch.abs(x) + 0.5)


def msb(v: torch.Tensor) -> torch.Tensor:
    """floor(log2(v)) of a positive integer tensor (31 - clz(v))."""
    return (torch.frexp(v.to(torch.float64)).exponent - 1).to(I32)


def estimate_global_gain(cfg: Config, x, nbitsSQ, targetBitsOff, old_targetBits,
                         old_specBits):
    """Returns (gain [B], gg_ind [B], gg_min [B], new_targetBitsOff,
    new_old_targetBits) (processEstimateGlobalGain_fl). nbitsSQ: [B] i32."""
    B, lg = x.shape
    dev = x.device
    nbitsSQ = nm.vec_i32(nbitsSQ, B, dev)

    valid = old_targetBits >= 0
    tmp = torch.clamp(targetBitsOff + old_targetBits.to(F32) - old_specBits.to(F32),
                      -40.0, 40.0)
    targetBitsOff = torch.where(valid, nm.fma(0.8, targetBitsOff, 0.2 * tmp),
                                torch.zeros_like(targetBitsOff))
    new_old_targetBits = nbitsSQ.clone()
    nbits_adj = nbitsSQ + round_c(targetBitsOff).to(I32)

    x_max = torch.max(torch.abs(x), dim=-1).values
    reg_val = torch.zeros((B,), dtype=F32, device=dev)
    if cfg.hrmode and cfg.regBits > 0:
        i = torch.arange(lg, dtype=F32, device=dev)[None, :]
        M0 = 1e-5 + torch.sum(torch.abs(x), dim=-1)
        M1 = 1e-5 + torch.sum(i * torch.abs(x), dim=-1)
        thresh = 2 * cfg.frame_ms
        rB_offset = 8.0 * (1.0 - torch.clamp(M1 / M0, max=thresh) / thresh)
        reg_val = x_max * nm.exp2(-cfg.regBits - rB_offset)

    if cfg.hrmode:
        g_min = x_max / (32768.0 * 256.0 - 2.0)
    else:
        g_min = x_max / (32768.0 - 0.375)
    ind_min = torch.ceil(28.0 * nm.log10(torch.clamp(g_min, min=nm.f32(1e-38)))).to(I32)

    # sequential f32 sums x[4j]^2 + .. + x[4j+3]^2 and the log in the
    # reference's order (estimate_global_gain.c:84-91)
    xx = (x * x).reshape(B, lg // 4, 4)
    e4 = ((xx[..., 0] + xx[..., 1]) + xx[..., 2]) + xx[..., 3]
    larg = (e4 + reg_val[:, None]) + nm.f32(2.0 ** -31)
    en = nm.f32(28.0 / 20.0) * nm.fma(10.0, nm.log10(larg), 7.0)

    target = nm.f32(1.9599999999999997) * nbits_adj.to(F32)
    offset = gain_bisection(en, target, 255 + cfg.quantizedGainOff)
    zero = torch.zeros((), dtype=F32, device=dev)

    offset_f = offset.to(F32)
    below = offset_f < ind_min.to(F32)
    zero_in = x_max == 0
    new_old_targetBits = torch.where(below | zero_in, -1, new_old_targetBits).to(I32)
    ind = torch.where(zero_in, zero,
                      torch.maximum(ind_min.to(F32), offset_f) - cfg.quantizedGainOff)
    ind_min = torch.where(zero_in, cfg.quantizedGainOff, ind_min).to(I32)
    gain = nm.pow(10.0, nm.div(ind + cfg.quantizedGainOff, 28.0))
    return gain, ind.to(I32), ind_min, targetBitsOff, new_old_targetBits


def gain_bisection_plain(en, target, offset0: int):
    """The eight halvings of the global-gain offset (estimate_global_gain.c:
    102-125); the plain version of the `gain_bisection` kernel. en [B, M]
    f32 block energies, target [B] f32, offset0 the starting offset.
    Returns the offset [B] i32. Each halving accumulates ener backward over
    the blocks in float32 with the reference's gap filling (iszero)."""
    B, M = en.shape
    dev = en.device
    offset = torch.full((B,), offset0, dtype=I32, device=dev)
    fac = 256
    c_low, c_gap, c_hi = nm.f32(9.8), nm.f32(3.78), 70.0
    zero = torch.zeros((), dtype=F32, device=dev)
    for _ in range(8):
        fac //= 2
        offset = offset - fac
        offs_f = offset.to(F32)
        ener = torch.zeros((B,), dtype=F32, device=dev)
        iszero = torch.ones((B,), dtype=torch.bool, device=dev)
        for j in range(M - 1, -1, -1):
            t = en[:, j] - offs_f
            low = t < c_low
            gap_add = torch.where(low & ~iszero, c_gap, zero)
            hi_add = torch.where(t >= c_hi, 2.0 * t - c_hi, t)
            ener = torch.where(low, ener + gap_add, ener + hi_add)
            iszero = iszero & low
        offset = offset + torch.where((ener > target) & ~iszero, fac, 0).to(I32)
    return offset


def gain_bisection(en, target, offset0: int):
    """The gain bisection: the CUDA kernel for a tensor on the card, its
    plain version for a tensor on the CPU."""
    if nm.on_cpu(en):
        return gain_bisection_plain(en, target, offset0)
    return kernels.gain_bisection(en.contiguous(), target.contiguous(), offset0)


def quantize_spectrum(cfg: Config, x, gain):
    """Quantize x by gain with the dead-zone offset -> xq [B, N] i32."""
    offset = 0.5 if cfg.hrmode else 0.375
    q = x / gain[:, None]
    return torch.trunc(q + offset * torch.sign(q)).to(I32)


def _max_lev(cfg: Config) -> int:
    return 21 if cfg.hrmode else 14


def bit_estimate_plain(cfg: Config, xq, target, mode: int):
    """Context bit estimator (quantize_spec.c:78-168), the plain version of
    the `bit_estimate` kernel: a loop over 2-tuples carrying the context.

    xq: [B, N] i32; target: [B] i32 (targetBitsQuant); mode: -1, 0 or 1.
    Returns dict of [B] i32: nbits, nbits2, lastnz, lastnz2, lsbMode."""
    B, N = xq.shape
    dev = xq.device
    lookup = nm.table(T.t, "ari_spec_lookup_fl", device=dev, dtype=torch.int64)
    bits_tab = nm.table(T.t, "ari_spec_bits_fl", device=dev, dtype=I32)   # [64, 17]
    rate_flag = cfg.rateFlag
    max_lev = _max_lev(cfg)
    target = nm.vec_i32(target, B, dev)

    a_all = torch.abs(xq[:, 0::2])
    b_all = torch.abs(xq[:, 1::2])
    nz = (a_all != 0) | (b_all != 0)
    tup = torch.arange(1, N // 2, device=dev)[None, :]
    last_tup = torch.where(nz[:, 1:], tup, 0).max(dim=-1).values
    lastnz = (2 * last_tup + 1).to(I32)
    n_act = torch.div(lastnz + 1, 2, rounding_mode="floor")

    # per-tuple quantities that do not depend on the context
    m = torch.maximum(a_all, b_all)
    nlev = torch.where(m >= 4, torch.clamp(msb(torch.clamp(m, min=1)) - 1, min=0), 0)
    nlev_it = torch.clamp(nlev, max=max_lev)                # levels the loop runs
    aa_all = a_all >> nlev_it
    bb_all = b_all >> nlev_it
    sym_all = torch.clamp(aa_all + 4 * bb_all, 0, 16).long()
    lev1f_all = torch.clamp(nlev, max=3)
    has_lev = nlev_it > 0
    # fixed per-level costs: 2 bits a level, lev 0's only without lsbMode
    fixed = 4096 * torch.clamp(nlev_it - 1, min=0) + torch.where(
        has_lev & (mode <= 0), 4096, 0)
    if mode <= 0:
        fixed = fixed + (torch.clamp(a_all, max=1) + torch.clamp(b_all, max=1)) * 2048
    a1 = torch.where(nlev > 0, a_all >> 1, a_all)
    b1 = torch.where(nlev > 0, b_all >> 1, b_all)
    lsb_all = torch.zeros_like(a_all)
    if mode > 0:
        lsb_all = (torch.where(has_lev, 2, 0)
                   + ((nlev > 0) & (a1 == 0) & (a_all != 0)).to(I32)
                   + ((nlev > 0) & (b1 == 0) & (b_all != 0)).to(I32))
        fixed = fixed + (torch.clamp(a1, max=1) + torch.clamp(b1, max=1)) * 2048
    levm1 = lev1f_all - 1
    t_next_all = torch.where(levm1 <= 0, 1 + (aa_all + bb_all) * (levm1 + 2), 13 + levm1)

    c = torch.zeros((B,), dtype=I32, device=dev)
    nbits = torch.zeros((B,), dtype=I32, device=dev)
    nbits2 = torch.zeros((B,), dtype=I32, device=dev)
    lastnz2 = torch.full((B,), 2, dtype=I32, device=dev)
    nbits_lsb = torch.zeros((B,), dtype=I32, device=dev)
    n_lev_max = min(3, int(nlev_it.max())) if nlev_it.numel() else 0
    for k in range(int(n_act.max())):
        t = c + rate_flag + (256 if k > N // 4 else 0)
        nl = nlev_it[:, k]
        nb = fixed[:, k].clone()
        for lev in range(n_lev_max + 1):
            pki = lookup[torch.clamp(t + lev * 1024, 0, 4095).long()]
            esc = bits_tab[pki, 16]
            if lev < 3:
                nb = nb + torch.where(nl > lev, esc, 0)
            else:
                nb = nb + esc * torch.clamp(nl - 3, min=0)
        pki = lookup[torch.clamp(t + lev1f_all[:, k] * 1024, 0, 4095).long()]
        nb = nb + bits_tab[pki, sym_all[:, k]]
        in_range = k < n_act
        nbits = nbits + torch.where(in_range, nb, 0)
        nbits_lsb = nbits_lsb + torch.where(in_range, lsb_all[:, k], 0)
        if mode >= 0:
            hit = in_range & nz[:, k] & (nbits <= target * 2048)
            lastnz2 = torch.where(hit, 2 * k + 2, lastnz2)
            nbits2 = torch.where(hit, nbits, nbits2)
        c = torch.where(in_range, (c & 15) * 16 + t_next_all[:, k], c)

    nbits_f = torch.div(nbits + 2047, 2048, rounding_mode="floor")
    if mode >= 0:
        nbits2_f = torch.div(nbits2 + 2047, 2048, rounding_mode="floor")
    else:
        nbits2_f = nbits_f
        lastnz2 = lastnz + 1
    if mode > 0:
        nbits_f = nbits_f + nbits_lsb
        nbits2_f = nbits2_f + nbits_lsb
    lsb_mode = ((mode > 0) & (nbits_f > target)).to(I32)
    return dict(nbits=nbits_f.to(I32), nbits2=nbits2_f.to(I32), lastnz=lastnz,
                lastnz2=lastnz2.to(I32), lsbMode=lsb_mode)


def bit_estimate(cfg: Config, xq, target, mode: int):
    """Context bit estimate: the CUDA kernel for a tensor on the card, its
    plain version for a tensor on the CPU."""
    if xq.device.type == "cpu":
        return bit_estimate_plain(cfg, xq, target, mode)
    return kernels.bit_estimate(cfg, xq, target, mode)


def truncate_spectrum(xq, lastnz, lastnz2):
    """Zero xq[lastnz2 .. lastnz] inclusive (quantize_spec.c:170-173)."""
    idx = torch.arange(xq.shape[1], device=xq.device)[None, :]
    kill = (idx >= lastnz2[:, None]) & (idx <= lastnz[:, None])
    return torch.where(kill, 0, xq).to(I32)


def adjust_global_gain(cfg: Config, gg_idx, gg_min, gain, target, nbits):
    """processAdjustGlobalGain_fl -> (gg_idx, gain, gainChange) [B]."""
    fs_idx = cfg.fs_idx
    p1 = float(T.t("gg_p1")[fs_idx])
    p2 = float(T.t("gg_p2")[fs_idx])
    p3 = float(T.t("gg_p3")[fs_idx])
    c = float(T.t("gg_c")[fs_idx])
    d = float(T.t("gg_d")[fs_idx])
    nb = nbits.to(F32)
    delta = torch.where(nb < p1, (nb + 48.0) / 16.0,
                        torch.where(nb < p2, (nb + d) * c,
                                    torch.where(nb < p3, nm.div(nb, 48.0),
                                                torch.full_like(nb, p3 / 48.0))))
    delta = round_c(delta)
    delta2 = delta + 2

    over = nbits > target
    under = nbits < target - delta2
    change_sat = (gg_idx == 255) & over
    do_adj = ((gg_idx < 255) & over) | ((gg_idx > 0) & under)
    inc1 = (gg_idx == 254) | (nbits.to(F32) < target + delta)
    new_idx = torch.where(under, gg_idx - 1, torch.where(inc1, gg_idx + 1, gg_idx + 2))
    new_idx = torch.maximum(new_idx, gg_min - cfg.quantizedGainOff)
    gg_out = torch.where(do_adj, new_idx, gg_idx).to(I32)
    gain_out = torch.where(
        do_adj, nm.pow(10.0, nm.div((gg_out + cfg.quantizedGainOff).to(F32), 28.0)), gain)
    return gg_out, gain_out, (do_adj | change_sat).to(I32)


def noise_factor(cfg: Config, x, xq, gain, bw_bin):
    """processNoiseFactor_fl -> fac_ns_idx [B] i32. bw_bin: [B] cutoff bin.
    For a tensor on the card the float sums over the zero lines are chains
    in bin order (`numerics.chain_sum`)."""
    B, N = x.shape
    dev = x.device
    if cfg.frame_dms == 100:
        width, start_off = 3, 24
    else:
        width, start_off = 1, {50: 12, 25: 6}[cfg.frame_dms]
    k = torch.arange(N, device=dev)[None, :]
    nz = xq != 0
    any_nz = torch.zeros((B, N), dtype=torch.bool, device=dev)
    for off in range(-width, width + 1):
        sh = torch.roll(nz, -off, dims=1)
        valid = (k + off >= 0) & (k + off <= bw_bin[:, None] - 1)
        any_nz = any_nz | (sh & valid)
    zline = (k >= start_off) & (k < bw_bin[:, None]) & ~any_nz
    kcnt = torch.sum(zline, dim=-1)
    vals = torch.abs(x / gain[:, None])
    zero = torch.zeros((), dtype=F32, device=dev)
    mean_all = nm.chain_sum(torch.where(zline, vals, zero), dim=-1) / torch.clamp(kcnt, min=1)
    fac = torch.where(kcnt > 0, mean_all, zero)

    if cfg.frame_dms == 100 and cfg.targetBytes <= 20:
        lines = torch.where(zline, k + 1, 0)
        mid = torch.div(torch.sum(lines, dim=-1), torch.clamp(kcnt, min=1),
                        rounding_mode="floor")
        lo = zline & ((k + 1) <= mid[:, None])
        hi = zline & ((k + 1) > mid[:, None])
        nlo = torch.clamp(torch.sum(lo, -1), min=1)
        nhi = torch.clamp(torch.sum(hi, -1), min=1)
        nsf1 = nm.chain_sum(torch.where(lo, vals, zero), -1) / nlo
        nsf2 = nm.chain_sum(torch.where(hi, vals, zero), -1) / nhi
        fac = torch.where(kcnt > 0, torch.minimum(nsf1, nsf2), fac)

    idx = round_c(8.0 - 16.0 * fac)
    return torch.clamp(idx, 0, 7).to(I32)


def residual_max_bits(cfg: Config) -> int:
    """Size of the residual bit buffer (one bit/coef, or 20 rounds in HR)."""
    return min(cfg.yLen * (20 if cfg.hrmode else 1), T.MAX_RESBITS)


def residual_encode(cfg: Config, x, xq, gain, target, nbits2):
    """processResidualCoding_fl -> (res_bits [B, max_res] i32, n_res [B])."""
    B, N = x.shape
    dev = x.device
    m = target - nbits2 + 4 + (10 if cfg.hrmode else 0)
    nz = xq != 0
    rank = torch.cumsum(nz.to(I32), dim=-1) - 1
    n_nz = torch.sum(nz.to(I32), dim=-1)
    xqg = xq.to(F32) * gain[:, None]
    max_res = residual_max_bits(cfg)
    iters = 20 if cfg.hrmode else 1
    offset = nm.f32(0.25)
    res = torch.zeros((B, max_res + 1), dtype=I32, device=dev)
    for r in range(iters):
        bit = (x >= xqg).to(I32)
        step = gain[:, None] * offset
        x = torch.where(nz, torch.where(bit == 1, x - step, x + step), x)
        pos = r * n_nz[:, None] + rank
        ok = nz & (pos < max_res)
        scat = torch.where(ok, pos, max_res).long()
        res.scatter_reduce_(1, scat, torch.where(ok, bit, 0), reduce="amax")
        offset = offset * 0.5
    n_res = torch.minimum(n_nz * iters, torch.clamp(m, min=0))
    return res[:, :max_res].contiguous(), n_res.to(I32)


def noise_residual_enc_plain(cfg: Config, dy, xq, gain, bw_bin, target, nbits2, lsb_mode):
    """The encoder's noise factor and residual coder with its lsbMode mask
    (models/encoder.py); the plain version of the `noise_residual_enc`
    kernel. Returns (fac_ns_idx [B] i32, res_bits [B, max_res] i32, n_res
    [B] i32)."""
    fac_ns_idx = noise_factor(cfg, dy, xq, gain, bw_bin)
    res_bits, n_res = residual_encode(cfg, dy, xq, gain, target, nbits2)
    return fac_ns_idx, res_bits, torch.where(lsb_mode == 0, n_res, 0).to(I32)


def noise_residual_enc(cfg: Config, dy, xq, gain, bw_bin, target, nbits2, lsb_mode):
    """Noise factor and residual coding: the CUDA kernel for a tensor on the
    card, its plain version for a tensor on the CPU."""
    args = (dy, xq, gain, bw_bin, target, nbits2, lsb_mode)
    if nm.on_cpu(dy):
        return noise_residual_enc_plain(cfg, *args)
    dtypes = (F32, I32, F32, I32, I32, I32, I32)
    return kernels.noise_residual_enc(cfg, *(a.to(dt).contiguous() for a, dt in zip(args, dtypes)))


def residual_decode(cfg: Config, x, res_bits, n_res):
    """processResidualDecoding_fl: +-3/16, +-5/16 nudges (HR: iterative
    +-offset rounds with halving)."""
    nz = x != 0.0
    rank = torch.cumsum(nz.to(I32), dim=-1) - 1
    n_nz = torch.sum(nz.to(I32), dim=-1)
    width = res_bits.shape[1]
    if cfg.hrmode:
        offset = nm.f32(0.25)
        out = x
        for r in range(20):
            pos = r * n_nz[:, None] + rank
            active = nz & (pos < n_res[:, None])
            bit = torch.gather(res_bits, 1, pos.clamp(0, width - 1).long())
            out = torch.where(active, torch.where(bit == 0, out - offset, out + offset), out)
            offset = offset * 0.5
        return out
    active = nz & (rank < n_res[:, None])
    bit = torch.gather(res_bits, 1, rank.clamp(0, width - 1).long())
    off1, off2 = nm.f32(0.1875), nm.f32(0.3125)
    pos = x > 0
    delta = torch.where(bit == 0, torch.where(pos, -off1, -off2),
                        torch.where(pos, off2, off1))
    return torch.where(active, x + delta, x)


def global_gain(cfg: Config, gg_idx):
    """10^((gg_idx + gg_off)/28) (processApplyGlobalGain_fl), in the
    reference's order on every device (a product by the reciprocal, the power
    through float64): only the decoder calls it, and the card's gain then
    equals the CPU's."""
    return nm.xla_pow(10.0, nm.xla_div((gg_idx + cfg.quantizedGainOff).to(F32), 28.0))


def apply_global_gain(cfg: Config, x, gg_idx):
    return x * global_gain(cfg, gg_idx)[:, None]


@functools.cache
def lcg_tables(n: int):
    """Closed-form advance of the noise-filling LCG (noise_filling.c:58-60):
    in u = seed + 32768, u' = (u * 31821 + 13849) mod 2^16, so
    seed_k = seed0 * mult[k] + add[k] (mod 2^16)."""
    a, c = 31821, 13849
    mult = np.zeros(n, np.int64)
    add = np.zeros(n, np.int64)
    m, ad = 1, 0
    for k in range(n):
        mult[k], add[k] = m, ad
        m = (m * a) % 65536
        ad = (ad * a + c) % 65536
    return mult, add


def _lcg_part(n: int, which: int) -> np.ndarray:
    return lcg_tables(n)[which]


def noise_filling(cfg: Config, x, nf_seed, fac_ns_idx, bw_bin,
                  spec_inv_idx=None, fac_ns_pc=None):
    """processNoiseFilling_fl with the LCG advanced in closed form.
    Bins at or above spec_inv_idx fill at fac_ns_pc (partial concealment)."""
    B, N = x.shape
    dev = x.device
    width = 3 if cfg.frame_dms == 100 else 1
    start_off = {100: 24, 50: 12, 25: 6}[cfg.frame_dms]
    fac = (8.0 - fac_ns_idx.to(F32)) / 16.0

    k = torch.arange(N, device=dev)[None, :]
    nzm = x != 0.0
    any_nz = torch.zeros((B, N), dtype=torch.bool, device=dev)
    for off in range(-width, width + 1):
        sh = torch.roll(nzm, -off, dims=1)
        valid = (k + off >= 0) & (k + off <= bw_bin[:, None] - 1)
        any_nz = any_nz | (sh & valid)
    zline = (k >= start_off) & (k < bw_bin[:, None]) & ~any_nz
    rank = torch.cumsum(zline.to(I32), dim=-1) - 1

    mult = nm.table(_lcg_part, N + 1, 0, device=dev, dtype=torch.int64)
    add = nm.table(_lcg_part, N + 1, 1, device=dev, dtype=torch.int64)
    seed_u = (nf_seed.to(torch.int64) + 32768)
    r = rank.clamp(0, N - 1).long()
    su = (seed_u[:, None] * mult[r + 1] + add[r + 1]) & 65535
    sign_neg = su < 32768
    level = fac[:, None].expand(B, N)
    if spec_inv_idx is not None:
        level = torch.where(k < spec_inv_idx[:, None], level, fac_ns_pc[:, None])
    fill = torch.where(sign_neg, -level, level)
    return torch.where(zline, fill, x)


def spectrum_decode_plain(cfg: Config, x, gain, bfi, rframe, spec_inv_idx, bw_idx, fac_ns_idx,
                          residual_present, res_bits, n_res, nf_seed, zero_frame, q_old_res,
                          q_old_d, prev_gg, prev_bw_idx, prev_fac_ns, nb_lost):
    """The decoder's spectrum reconstruction of one frame, in the order of
    models/decoder.py: partial concealment (pc_apply, pc_update and the
    lost-frame count's reset), the residual where it is present, noise
    filling where the frame is not zero, at the bandwidth pc_update returns,
    and the global gain `gain` (global_gain(cfg, gg_idx)), each on the
    streams whose frame is not lost (bfi != 1); the plain version of the
    `spec_decode` kernel. x: [B, N] f32 decoded spectrum. Returns (x [B, N],
    q_old_res, prev_gg, prev_bw_idx, prev_fac_ns, nb_lost), the last five the
    partial concealment's new history. For a tensor on the card the
    concealment's energies are chains (ops/pc.py)."""
    from . import pc
    good = (bfi != 1)[:, None]
    x, fac, nb_lost = pc.pc_apply_gain(cfg, bfi, x, q_old_res, q_old_d, spec_inv_idx, gain,
                                       prev_gg, nb_lost)
    q_old_res, prev_gg, bw_idx_nf, prev_bw_idx, new_fac_ns = pc.pc_update_gain(
        cfg, bfi, rframe, x, spec_inv_idx, gain, fac, bw_idx, q_old_res, prev_gg,
        prev_bw_idx, prev_fac_ns, fac_ns_idx)
    nb_lost = torch.where(bfi == 0, 0, nb_lost).to(I32)
    x = torch.where((residual_present == 1)[:, None] & good,
                    residual_decode(cfg, x, res_bits, n_res), x)
    bw_tab = nm.table(T.bw_cutoff_bins, cfg.frame_dms, device=x.device, dtype=I32)
    bw_bin_nf = bw_tab[bw_idx_nf.clamp(0, bw_tab.shape[0] - 1).long()]
    nf = noise_filling(cfg, x, nf_seed, fac_ns_idx, bw_bin_nf, spec_inv_idx, prev_fac_ns)
    x = torch.where((zero_frame == 0)[:, None] & good, nf, x)
    x = torch.where(good, x * gain[:, None], x)
    return x, q_old_res, prev_gg, prev_bw_idx, new_fac_ns, nb_lost


def spectrum_decode(cfg: Config, x, gain, bfi, rframe, spec_inv_idx, bw_idx, fac_ns_idx,
                    residual_present, res_bits, n_res, nf_seed, zero_frame, q_old_res,
                    q_old_d, prev_gg, prev_bw_idx, prev_fac_ns, nb_lost):
    """The decoder's spectrum reconstruction: the CUDA kernel for a tensor
    on the card, its plain version for a tensor on the CPU."""
    args = (x, gain, bfi, rframe, spec_inv_idx, bw_idx, fac_ns_idx, residual_present, res_bits,
            n_res, nf_seed, zero_frame, q_old_res, q_old_d, prev_gg, prev_bw_idx, prev_fac_ns,
            nb_lost)
    if nm.on_cpu(x):
        return spectrum_decode_plain(cfg, *args)
    dtypes = (F32, F32, I32, I32, I32, I32, I32, I32, I32, I32, I32, I32, F32, F32, F32, I32,
              F32, I32)
    return kernels.spec_decode(cfg, *(a.to(dt).contiguous() for a, dt in zip(args, dtypes)))
