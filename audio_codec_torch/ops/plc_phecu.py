"""Phase ECU: FFT phase-evolution concealment (advanced PLC method 2).

Counterpart of `audio_codec_tpu/ops/plc_phecu.py` (the float design of
hq_phase_ecu_fx, plc_phecu_fec_hq_fx.c:1718), 10 ms frames only:
  * `spec_ana`: the last 16 ms of PCM, Hamming-rect windowed and rFFT'd at
    the first loss; spectral peaks located with hysteresis and refined to
    fractional bins (Jacobsen, a parabola at the edges); a peak-dense,
    weakly correlated spectrum drops to noise-only concealment;
  * `band_energies`: the per-group energies of the two windows before the
    loss;
  * `trans_burst_ana`: per-band transient attenuation, the burst ramp and
    the fade to the band average;
  * `subst_spec`: peak neighbourhoods evolve in phase, valleys take random
    phases and, in bursts, scrambled magnitudes;
  * `rec_frame`: the inverse rFFT, the inverse window and the splice onto
    the last good PCM.

The FFTs are `torch.fft.rfft`/`irfft`, as the reference computes them with
`jnp.fft` outside any kernel. The rest writes its float order down (complex
products as real arithmetic, `numerics.xla_fma` where XLA contracts, sums
left to right) on every device, so that the kernels (csrc/phecu_spec_ana.cu,
csrc/phecu_subst.cu) follow it bit for bit: `phecu_spec_ana` and
`phecu_subst` are their entry points, `phecu_spec_ana_plain` and
`phecu_subst_plain` their plain versions. The lanes off the Phase ECU get
zeros from both.
"""
from __future__ import annotations

import functools
import math

import numpy as np
import torch

from .. import kernels
from ..config import Config
from . import numerics as nm
from . import plc_adv

F32 = torch.float32
I32 = torch.int32

# frequency-group start bins, 62.5 Hz spacing (gwlpr_fx, constants.c:469)
GWLPR = (1, 12, 20, 36, 68, 132, 196, 260, 324, 388)
MAX_LGW = 9
DELTA_CORR = 5
BURST_ATT_THRESH = 2    # BURST_ATT_THRESH(1) + 1 at PLC2_FADEOUT_IN_MS = 30
BETA_MUTE_THR = 4
OFF_FRAMES_LIMIT = 30
BETA_MUTE_INI = 0.25
C_JACOB = 1.1429
PLOC_SENS = 2294.0 / 32768.0
PEAK_LIMIT = 14         # spec_ana_fx:1020-1045
# the substitution's sine and cosine (the kernel's sinf and cosf on the card)
_cos, _sin = torch.cos, torch.sin


def lprot(cfg: Config) -> int:
    """16 ms prototype length (LprotSzPtr, defines.h:273)."""
    return 512 * cfg.fs // 32000


def nbins(cfg: Config) -> int:
    return lprot(cfg) // 2 + 1


def search_bins(cfg: Config) -> int:
    """Peak search range: the spectrum above 20 kHz is zeroed at 48 kHz."""
    return min(nbins(cfg), 321)


def n_lgw(cfg: Config) -> int:
    return min(cfg.fs_idx + 4, 8)


def t_adv(cfg: Config) -> int:
    """Phase-evolution time advance (setup_dec_lc3.c:175-177)."""
    return (cfg.frame_length + lprot(cfg) + cfg.frame_length // 4) // 2


@functools.cache
def whr_window(cfg: Config) -> np.ndarray:
    """Hamming-rect analysis window: 3 ms rise, 10 ms flat, 3 ms fall."""
    lp, h2 = lprot(cfg), 3 * cfg.fs // 1000
    ham = 0.54 - 0.46 * np.cos(2.0 * np.pi * np.arange(2 * h2) / (2 * h2 - 1))
    return np.concatenate([ham[:h2], np.ones(lp - 2 * h2), ham[h2:]]).astype(np.float32)


@functools.cache
def band_of_bin(cfg: Config) -> np.ndarray:
    """Bin -> frequency group over the search range."""
    k = np.zeros(search_bins(cfg), np.int64)
    for b in range(MAX_LGW):
        k[np.arange(k.size) >= GWLPR[b]] = b
    return k


@functools.cache
def band_len_inv(cfg: Config) -> np.ndarray:
    """1 / the width of each frequency group in bins, in float32."""
    edges = np.clip(np.asarray(GWLPR), 0, search_bins(cfg))
    ln = np.maximum(edges[1:] - edges[:-1], 1)[:MAX_LGW].astype(np.float32)
    return np.float32(1.0) / ln


@functools.cache
def lcg_tables(n: int) -> np.ndarray:
    """[2, n] affine jumps of seed' = (13849 + 31821 seed) mod 2^16
    (rand_phase_fx): seed_i = A[i] seed0 + B[i]."""
    out = np.empty((2, n), np.int64)
    a, b = 1, 0
    for i in range(n):
        a = (a * 31821) % 65536
        b = (b * 31821 + 13849) % 65536
        out[:, i] = a, b
    return out


def rand_phases(seed0, n: int):
    """[B, n] random phases: a 32-level table of the LCG's 5 top bits
    (rand_phase_fx, 11.25-degree steps)."""
    tab = nm.table(lcg_tables, n, device=seed0.device, dtype=torch.int64)
    s = (torch.remainder(seed0.to(torch.int64), 65536)[:, None] * tab[0] + tab[1]) & 0xFFFF
    return nm.f32(2.0 * math.pi / 32.0) * (s >> 11).to(F32)


def _window(cfg: Config, device) -> torch.Tensor:
    return nm.table(whr_window, cfg, device=device)


def spectrum(cfg: Config, seg):
    """The windowed rFFT of a [B, Lprot] segment (a library call)."""
    return torch.fft.rfft(seg * _window(cfg, seg.device), n=lprot(cfg))


# ---------------------------------------------------------------------------
# first-loss analysis: peaks and band energies
# ---------------------------------------------------------------------------

def _peaks(Xr, Xi, norm_corr):
    """The peak analysis of `spec_ana` on a spectrum given as its real and
    imaginary parts [B, search_bins]: the hysteresis scan (one bin after the
    other), the fractional refinement and the peak-dense drop rule. Returns
    (f0est [B, bins] with -1 at non-peak bins, num_plocs [B] i32)."""
    B, ns = Xr.shape
    dev = Xr.device
    mag = nm.sqrt(Xr * Xr + Xi * Xi)
    sens = (torch.amax(mag, 1) - torch.amin(mag, 1)) * nm.f32(PLOC_SENS)

    # hysteresis extrema scan (plc_phEcu_peak_locator_fx model)
    ref, cand = mag[:, 0], torch.zeros((B,), dtype=F32, device=dev)
    cand_idx = torch.zeros((B,), dtype=I32, device=dev)
    mode = torch.zeros((B,), dtype=I32, device=dev)
    mask = torch.zeros((B, ns), dtype=torch.bool, device=dev)
    for k in range(ns):
        m = mag[:, k]
        rising = (mode == 0) & (m > ref + sens)
        new_peak = (mode == 1) & (m < cand - sens)
        better = (mode == 1) & (m >= cand)
        mask.scatter_(1, cand_idx[:, None].long(), new_peak[:, None] | torch.gather(
            mask, 1, cand_idx[:, None].long()))
        take = rising | better
        cand = torch.where(take, m, cand)
        cand_idx = torch.where(take, k, cand_idx)
        ref = torch.where(new_peak, m, torch.where(mode == 0, torch.minimum(ref, m), ref))
        mode = torch.where(rising, 1, torch.where(new_peak, 0, mode)).to(I32)
    mask.scatter_(1, cand_idx[:, None].long(), (mode == 1)[:, None] | torch.gather(
        mask, 1, cand_idx[:, None].long()))

    # fractional refinement: Jacobsen on the complex bins, a parabola on
    # the magnitudes at the edges
    pad = lambda v: torch.nn.functional.pad(v, (1, 1))
    Pr, Pi, Pm = pad(Xr), pad(Xi), pad(mag)
    nr, ni = Pr[:, :-2] - Pr[:, 2:], Pi[:, :-2] - Pi[:, 2:]
    dr = 2.0 * Pr[:, 1:-1] - Pr[:, :-2] - Pr[:, 2:]
    di = 2.0 * Pi[:, 1:-1] - Pi[:, :-2] - Pi[:, 2:]
    re = nm.xla_fma(nr, dr, ni * di)
    dd = nm.xla_fma(dr, dr, di * di)
    frac = nm.f32(C_JACOB) * re / torch.clamp(dd, min=nm.f32(1e-12))
    pden = Pm[:, :-2] - 2.0 * Pm[:, 1:-1] + Pm[:, 2:]
    pfrac = 0.5 * (Pm[:, :-2] - Pm[:, 2:]) / torch.where(torch.abs(pden) > nm.f32(1e-12), pden, 1.0)
    kk = torch.arange(ns, device=dev)
    edge = (kk < 2) | (kk >= ns - 2)
    frac = torch.clamp(torch.where(edge[None, :], pfrac, frac), -1.0, 1.0)
    f0est = torch.where(mask, kk[None, :].to(F32) + frac, -1.0)
    num_plocs = mask.sum(1).to(I32)
    drop = (norm_corr > 0.0) & (norm_corr < 0.5) & (num_plocs > PEAK_LIMIT) & mask[:, 1:7].any(1)
    return torch.where(drop[:, None], -1.0, f0est), torch.where(drop, 0, num_plocs).to(I32)


def _group_energy(cfg: Config, Xr, Xi):
    """Energies of the 9 frequency groups of a spectrum [B, search_bins]:
    |X|^2 summed over each group's bins from zero, ascending (the product
    with the group matrix, numerics.xla_dot: one chain over the bins)."""
    e = nm.xla_dot(Xr * Xr + Xi * Xi, nm.table(_group_matrix, cfg, device=Xr.device))
    lgw = n_lgw(cfg)
    if lgw < MAX_LGW:   # the top groups copy the last one (fec_hq:655-668)
        e = torch.cat([e[:, :lgw], e[:, lgw - 1: lgw].expand(-1, MAX_LGW - lgw)], 1)
    return e


def phecu_spec_ana_plain(cfg: Config, Xr, Xi, Xor, Xoi, norm_corr, active):
    """The plain version of the `phecu_spec_ana` kernel, for the lanes at
    the first loss of a Phase ECU burst (`active`): the peak analysis of the
    spectrum at the loss (Xr, Xi [B, search_bins]) and the group energies of
    it ('old') and of the window one frame earlier (Xor, Xoi, 'oold').
    Returns (f0est, num_plocs, e_oold, e_old); -1, 0, 0, 0 off the active
    lanes."""
    f0est, num_plocs = _peaks(Xr, Xi, norm_corr)
    e_old, e_oold = _group_energy(cfg, Xr, Xi), _group_energy(cfg, Xor, Xoi)
    act = active[:, None]
    return (torch.where(act, f0est, -1.0), torch.where(active, num_plocs, 0).to(I32),
            torch.where(act, e_oold, 0.0), torch.where(act, e_old, 0.0))


def phecu_spec_ana(cfg: Config, Xr, Xi, Xor, Xoi, norm_corr, active):
    """The first-loss analysis: the `phecu_spec_ana` kernel for tensors on a
    card, `phecu_spec_ana_plain` on the CPU."""
    if nm.on_cpu(Xr):
        return phecu_spec_ana_plain(cfg, Xr, Xi, Xor, Xoi, norm_corr, active)
    return kernels.phecu_spec_ana(cfg, Xr, Xi, Xor, Xoi, norm_corr, active)


def spec_ana(cfg: Config, xfp, norm_corr):
    """First-loss spectral analysis (spec_ana_fx:796). xfp: [B, Lprot] the
    last 16 ms of good PCM. Returns (X [B, nbins] complex64, f0est, num_plocs)."""
    ns = search_bins(cfg)
    X = spectrum(cfg, xfp)
    if nbins(cfg) > ns:
        X = torch.cat([X[:, :ns], torch.zeros_like(X[:, ns:])], 1)
    f0est, num_plocs = _peaks(X.real[:, :ns], X.imag[:, :ns], norm_corr)
    return X, f0est, num_plocs


@functools.cache
def _group_matrix(cfg: Config) -> np.ndarray:
    kmap = band_of_bin(cfg)
    return (kmap[:, None] == np.arange(MAX_LGW)[None, :]).astype(np.float32)


def band_energies(cfg: Config, x_old_tot):
    """Per-group energies of the two 16 ms windows before the loss ('oold'
    ends one frame earlier than 'old'). Returns (e_oold, e_old) [B, 9]."""
    lp, fl = lprot(cfg), cfg.frame_length
    ns = search_bins(cfg)
    Xo = spectrum(cfg, x_old_tot[:, -(lp + fl):-fl])[:, :ns]
    X = spectrum(cfg, x_old_tot[:, -lp:])[:, :ns]
    return _group_energy(cfg, Xo.real, Xo.imag), _group_energy(cfg, X.real, X.imag)


# ---------------------------------------------------------------------------
# every concealed frame: transient/burst analysis and substitution
# ---------------------------------------------------------------------------

def trans_burst_ana(cfg: Config, e_oold, e_old, burst_len, mag_chg_1st, beta_mute):
    """Per-band transient and burst attenuation (trans_burst_ana_fx:190-680).
    burst_len: the loss count (1 = first loss). Returns (mag_chg, alpha,
    beta, Xavg, beta_mute, is_trans)."""
    dev = e_old.device
    first = (burst_len <= 1)[:, None]
    beta_mute = torch.where(burst_len <= 1, nm.f32(BETA_MUTE_INI),
                            torch.where(burst_len > BETA_MUTE_THR, beta_mute * 0.5, beta_mute))
    el = torch.clamp(e_oold, min=nm.f32(1e-9))
    er = torch.clamp(e_old, min=nm.f32(1e-9))
    tr = (el <= nm.f32(0.1) * er) | (nm.f32(0.1) * el >= er)
    att1 = torch.where(tr & (er < el), nm.sqrt(er / el), 1.0)
    mag_chg_1st = torch.where(first, att1, mag_chg_1st)
    # XLA divides by a constant array as a product by its reciprocals
    xavg = nm.sqrt(nm.f32(0.5) * (el + er) * nm.table(band_len_inv, cfg, device=dev))
    attdeg = torch.clamp(burst_len - BURST_ATT_THRESH, 0, OFF_FRAMES_LIMIT)
    att = nm.xla_exp2(-attdeg.to(F32))[:, None]
    mag_chg = torch.where(first, att1, mag_chg_1st * att)
    alpha = torch.where(first, 1.0, mag_chg)
    beta = torch.where(first, 0.0, beta_mute[:, None] * nm.sqrt(
        torch.clamp(nm.xla_fma(-alpha, alpha, 1.0), min=0.0)))
    beta = beta * nm.table(_lp_shape, device=dev)
    fadein = torch.where((burst_len == 2)[:, None] & (mag_chg_1st < 1.0), nm.f32(0.5), 1.0)
    beta = beta * fadein
    # full-frame transient flags are pinned inactive in LC3plus
    # (PhECU_short_flag_prev = 0, plc_update_aft_imdct_fx.c:154)
    is_trans = torch.zeros(tr.shape[:1], dtype=torch.bool, device=dev)
    return mag_chg, alpha, beta, xavg, beta_mute, is_trans


def _lp_shape() -> np.ndarray:
    k = np.arange(MAX_LGW)
    return np.where(k >= 6, 0.1, np.where(k >= 4, 0.5, 1.0)).astype(np.float32)


def _subst(cfg: Config, Xr, Xi, f0est, num_plocs, time_offs, mag_chg, alpha, beta, xavg,
           is_trans):
    """Spectrum evolution and substitution (subst_spec_fx:1065) on a
    spectrum given as real and imaginary parts [B, nbins]. Returns the
    evolved spectrum's (real, imag) [B, nbins]."""
    B = Xr.shape[0]
    dev = Xr.device
    ns, nsf = search_bins(cfg), nbins(cfg)
    nyq = nsf - 1
    burst_len = torch.div(time_offs, cfg.frame_length, rounding_mode="floor") + 1
    npl = torch.where(is_trans, 0, num_plocs)
    mask = (f0est >= 0.0) & (npl > 0)[:, None]
    adv = (t_adv(cfg) + time_offs).to(F32)[:, None]
    ang = nm.f32(2.0 * math.pi) * torch.where(mask, f0est, 0.0) * adv * nm.f32(1.0 / lprot(cfg))

    # each peak's phase spread over +-DELTA_CORR bins, the nearest peak
    # first, the lower side before the upper at equal distance
    assigned = mask
    peak_ang = torch.where(mask, ang, 0.0)
    for d in range(1, DELTA_CORR + 1):
        for s in (-1, 1):
            sh_m = torch.roll(mask, s * d, dims=1)
            sh_a = torch.roll(ang, s * d, dims=1)
            if s > 0:
                sh_m[:, :d] = False
            else:
                sh_m[:, -d:] = False
            take = sh_m & ~assigned
            peak_ang = torch.where(take, sh_a, peak_ang)
            assigned = assigned | take

    seeds0 = time_offs.to(I32)
    ph1 = rand_phases(seeds0, ns)
    ph2 = rand_phases(seeds0 + 1, ns)
    bins = torch.arange(ns, device=dev)[None, :]
    interior = (bins >= 1) & (bins < min(ns, nyq))
    use_peak = assigned & interior
    theta = torch.where(use_peak, peak_ang, ph1)
    c, s_ = _cos(theta), _sin(theta)
    xr, xi = Xr[:, :ns], Xi[:, :ns]
    rr = nm.xla_fma(xr, c, -(xi * s_))
    ri = nm.xla_fma(xr, s_, xi * c)

    # valley magnitude scrambling in burst or peak-free frames
    noise_adj = ((npl == 0) | (time_offs != 0))[:, None] & ~use_peak
    vfac = 1.0 + nm.f32(0.25) * (nm.f32(0.5) * (ph2 * nm.f32(1.0 / math.pi) - 1.0)
                                 + nm.f32(0.5) * _cos(ph1))
    rr = torch.where(noise_adj, rr * vfac, rr)
    ri = torch.where(noise_adj, ri * vfac, ri)

    kmap = nm.table(band_of_bin, cfg, device=dev, dtype=torch.long)
    mc, bt, xa = mag_chg[:, kmap], beta[:, kmap], xavg[:, kmap]
    one_peak_zero = ((npl > 0) & (npl < 3))[:, None] & ~use_peak
    rr = torch.where(one_peak_zero, 0.0, rr)
    ri = torch.where(one_peak_zero, 0.0, ri)
    amp = torch.where(one_peak_zero, 0.0, bt * xa)
    outr = nm.xla_fma(mc, rr, amp * _cos(ph2))
    outi = nm.xla_fma(mc, ri, amp * _sin(ph2))
    outr = torch.where(interior, outr, xr)
    outi = torch.where(interior, outi, xi)

    # DC and Nyquist
    burst = burst_len > BURST_ATT_THRESH + 1
    dcr = torch.where(npl == 0, 0.0, Xr[:, 0])
    dci = torch.where(npl == 0, 0.0, Xi[:, 0])
    dcr = torch.where(burst, dcr * alpha[:, 0], dcr)
    dci = torch.where(burst, dci * alpha[:, 0], dci)
    fr = torch.cat([dcr[:, None], outr[:, 1:], Xr[:, ns:]], 1)
    fi = torch.cat([dci[:, None], outi[:, 1:], Xi[:, ns:]], 1)
    ny = torch.where(npl == 0, 0.0, fr[:, nyq])
    ny = torch.where(burst, ny * alpha[:, n_lgw(cfg) - 1], ny)
    fr = torch.cat([fr[:, :nyq], ny[:, None], fr[:, nyq + 1:]], 1)
    fi = torch.cat([fi[:, :nyq], torch.zeros((B, 1), dtype=F32, device=dev), fi[:, nyq + 1:]], 1)
    return fr, fi


def phecu_subst_plain(cfg: Config, Xr, Xi, f0est, num_plocs, nb_cur, e_oold, e_old, mag_chg_1st,
                      beta_mute, xavg, is_trans, active):
    """The plain version of the `phecu_subst` kernel, for the lanes
    concealed by the Phase ECU this frame (`active`): the burst analysis
    (trans_burst_ana) and the substitution (subst_spec) of the saved
    spectrum Xr, Xi [B, nbins]. Returns the evolved spectrum's (real, imag);
    zero off the active lanes."""
    mc, alpha, beta, _, _, _ = trans_burst_ana(cfg, e_oold, e_old, nb_cur, mag_chg_1st, beta_mute)
    time_offs = torch.clamp(nb_cur - 1, min=0) * cfg.frame_length
    fr, fi = _subst(cfg, Xr, Xi, f0est, num_plocs, time_offs, mc, alpha, beta, xavg, is_trans != 0)
    act = active[:, None]
    return torch.where(act, fr, 0.0), torch.where(act, fi, 0.0)


def phecu_subst(cfg: Config, Xr, Xi, f0est, num_plocs, nb_cur, e_oold, e_old, mag_chg_1st,
                beta_mute, xavg, is_trans, active):
    """Burst analysis and substitution: the `phecu_subst` kernel for tensors
    on a card, `phecu_subst_plain` on the CPU."""
    args = (Xr, Xi, f0est, num_plocs, nb_cur, e_oold, e_old, mag_chg_1st, beta_mute, xavg,
            is_trans, active)
    if nm.on_cpu(Xr):
        return phecu_subst_plain(cfg, *args)
    return kernels.phecu_subst(cfg, *args)


def subst_spec(cfg: Config, X, f0est, num_plocs, time_offs, mag_chg, alpha, beta, xavg, is_trans):
    """subst_spec on a complex spectrum [B, nbins]; returns complex64."""
    fr, fi = _subst(cfg, X.real, X.imag, f0est, num_plocs, time_offs.to(I32), mag_chg, alpha, beta,
                    xavg, is_trans)
    return torch.complex(fr, fi)


@functools.cache
def _splice_ramp(cfg: Config) -> np.ndarray:
    ola_len = 7 * cfg.frame_length // 40
    n = (np.arange(ola_len, dtype=np.float32) + np.float32(0.5)) / np.float32(ola_len)
    return (np.sin(np.float32(0.5 * np.pi) * n) ** 2).astype(np.float32)


def rec_frame(cfg: Config, Xev, x_old_tot):
    """iFFT, inverse window and the 3.75 ms splice (rec_wtda_fx:1529):
    2 ms of the last good PCM copied, 1.75 ms cross-faded into the inverse
    transform, which starts 2 ms into the window (fl - Lprot / 2 == fl / 5).
    Returns synth [B, 2 frame] from the lost frame's -la_zeroes."""
    lp, fl = lprot(cfg), cfg.frame_length
    dev = x_old_tot.device
    copy_len, ola_len = fl // 5, 7 * fl // 40
    assert fl - lp // 2 == copy_len
    x16 = torch.fft.irfft(Xev, n=lp)
    x16 = x16 / torch.clamp(_window(cfg, dev), min=nm.f32(0.05))[None, :]
    tail = x_old_tot[:, -(copy_len + ola_len):]
    w_new = nm.table(_splice_ramp, cfg, device=dev)[None, :]
    mid = nm.xla_fma(1.0 - w_new, tail[:, copy_len:], w_new * x16[:, :ola_len])
    zeros = torch.zeros((x16.shape[0], 2 * fl - copy_len - lp), dtype=F32, device=dev)
    return torch.cat([tail[:, :copy_len], mid, x16[:, ola_len:], zeros], 1)


def apply(cfg: Config, st_f0est, st_X_sav, st_num_plocs, st_mag_chg_1st, st_xavg, st_beta_mute,
          st_is_trans, x_old_tot, nb_cur, first, active, norm_corr):
    """One Phase ECU frame for the `active` lanes (hq_phase_ecu_fx:1718).
    first: [B] bool, the first loss of a burst. Returns a dict with pcm [B,
    frame], the OLA memory [B, frame - la_zeroes] and the state fields.

    The reference branches on "any lane at its first loss" and "any lane
    active"; here the kernels run for every frame and do the work on the
    lanes that need it, so the frame step makes no read-back to the host.
    The two windows' spectra are library FFTs; the window at the loss is the
    'old' window of the band energies, so its spectrum serves both."""
    fl, la, lp = cfg.frame_length, cfg.la_zeroes, lprot(cfg)
    ns = search_bins(cfg)
    sel1 = first & active
    sel = sel1[:, None]
    X = spectrum(cfg, x_old_tot[:, -lp:])
    if nbins(cfg) > ns:
        X = torch.cat([X[:, :ns], torch.zeros_like(X[:, ns:])], 1)
    Xo = spectrum(cfg, x_old_tot[:, -(lp + fl):-fl])
    f0n, npln, e_oold, e_old = phecu_spec_ana(
        cfg, X.real[:, :ns].contiguous(), X.imag[:, :ns].contiguous(),
        Xo.real[:, :ns].contiguous(), Xo.imag[:, :ns].contiguous(), norm_corr, sel1)
    X_sav = torch.where(sel, X, st_X_sav)
    f0est = torch.where(sel, f0n, st_f0est)
    num_plocs = torch.where(sel1, npln, st_num_plocs)
    mag_chg, _, _, xavg, beta_mute, tr_new = trans_burst_ana(
        cfg, e_oold, e_old, nb_cur, st_mag_chg_1st, st_beta_mute)
    is_trans = torch.where(sel1, tr_new.to(I32), st_is_trans)
    xavg = torch.where(sel, xavg, st_xavg)
    mag_chg_1st = torch.where(sel, mag_chg, st_mag_chg_1st)
    beta_mute = torch.where(active, beta_mute, st_beta_mute)

    fr, fi = phecu_subst(cfg, X_sav.real.contiguous(), X_sav.imag.contiguous(), f0est, num_plocs,
                         nb_cur, e_oold, e_old, mag_chg_1st, st_beta_mute, xavg, is_trans, active)
    synth = rec_frame(cfg, torch.complex(fr, fi), x_old_tot)
    pcm = synth[:, la: la + fl]
    ola = plc_adv.tdac(cfg, synth[:, la:])
    return dict(pcm=pcm, ola=ola, phecu_X_sav=X_sav, phecu_f0est=f0est,
                phecu_num_plocs=num_plocs, phecu_mag_chg_1st=mag_chg_1st, phecu_Xavg=xavg,
                phecu_beta_mute=beta_mute, phecu_is_trans=is_trans)
