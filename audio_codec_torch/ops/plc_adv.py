"""Advanced packet-loss concealment (plc_mode 1): the method classifier,
time-domain concealment (TD-PLC), the TDAC blend, noise substitution and
per-bin damping with sign scrambling.

Counterpart of `audio_codec_tpu/ops/plc_adv.py` (processPLCclassify_fx,
plc_classify_fx.c:18-80; processTimeDomainConcealment_Apply_fx,
plc_tdc_main_fx.c:78-510 with the LPC analysis of plc_apply_fx.c:173-227;
processTdac_fx; plc_noise_substitution_fx.c; processPLCDampingScrambling_fx).
Every function is batched over [B] streams, with per-lane selects.

The float order is the reference's (XLA:CPU's) on every device: sums of more
than 32 terms in XLA's windows of 32 (`numerics.xla_sum`), shorter ones and
the products XLA contracts as fused multiply-adds (`numerics.xla_fma`), a
division by a constant as a product by its reciprocal. So on the concealment
lanes the card computes what the CPU and the reference compute, and the
kernels (csrc/plc_tdc.cu, csrc/plc_damp_scramble.cu) write the same
operations. `plc_tdc` and `damp_scramble` are the kernels' entry points, with
their plain versions `plc_tdc_plain` and `damp_scramble_plain`.
"""
from __future__ import annotations

import functools
import math

import numpy as np
import torch

from .. import kernels
from .. import tables as T
from ..config import Config
from . import numerics as nm

F32 = torch.float32
I32 = torch.int32
I64 = torch.int64

PLC_FADEOUT_IN_MS = 60
PLC4_TRANSIT_START_IN_MS = 20
PLC4_TRANSIT_END_IN_MS = PLC_FADEOUT_IN_MS
ATTEN = {100: 0.5, 50: 0.70709228515625, 25: 0.84085083}  # PLC34_ATTEN_FAC
HPBLEND_THROTTLE = 30  # PLC3_HPBLENDTHROTTLE
L_FIR_HP = 11
LPC_ORDER = 16         # the state's width; order 8 at 8 kHz is zero-padded


def max_pitch(cfg: Config) -> int:
    """MAX_PITCH_FS (defines.h:39)."""
    return math.ceil(228 * cfg.fs / 12800)


def pcm_hist_len(cfg: Config) -> int:
    """x_old_tot: the classifier needs MAX_PITCH + a frame (defines.h:44-47)."""
    return max_pitch(cfg) + cfg.frame_length


def update_pcm_hist(x_old_tot, pcm):
    """Shift in one frame of synthesized PCM (processPLCupdate)."""
    return torch.cat([x_old_tot[:, pcm.shape[1]:], pcm], dim=1)


def _gather(x, idx):
    return torch.gather(x, 1, idx.clamp(0, x.shape[1] - 1).long())


# ---------------------------------------------------------------------------
# classifier
# ---------------------------------------------------------------------------

def _xcorr(cfg: Config, x_old_tot, pitch_int):
    """plc_xcorr_lc_fx: normalized correlation at the LTPF pitch lag over the
    last up-to-10 ms of history; 0 where there is no pitch."""
    L = x_old_tot.shape[1]
    dev = x_old_tot.device
    rect = int(T.t("plc_rect_len")[cfg.fs_idx])
    pitch_min2 = 2 * 20 * (cfg.fs_idx + 1)
    corr_len = torch.clamp(torch.clamp(L - pitch_int, max=rect), pitch_min2, rect)
    k = torch.arange(rect, device=dev)[None, :]
    start = L - corr_len[:, None]
    valid = (k < corr_len[:, None]).to(F32)
    cur = _gather(x_old_tot, start + k) * valid
    pred = _gather(x_old_tot, start + k - pitch_int[:, None]) * valid
    num = nm.xla_sum(cur * pred)
    den = nm.sqrt(nm.xla_sum(cur * cur) * nm.xla_sum(pred * pred)) + nm.f32(1e-12)
    nc = torch.clamp(num / den, 0.0, 1.0)
    return torch.where(pitch_int > 0, nc, 0.0)


@functools.cache
def _centroid_weights(cfg: Config) -> np.ndarray:
    """[2, 16]: the per-band frequency sums over the frame length, and the
    band widths (plc_classify_fx.c:86-205)."""
    off = _band_offsets_64(cfg).astype(np.float64)
    start = off[np.arange(16) * 4] + 1
    stop = off[np.arange(16) * 4 + 4]
    freq_sum = stop * (stop + 1) / 2 - (start - 1) * start / 2
    width = stop - start + 1
    return np.stack([freq_sum * (1.0 / cfg.frame_length), width]).astype(np.float32)


def _dee_emphasis(fs_idx: int) -> np.ndarray:
    return T.t("plc_warp_dee_emphasis")[fs_idx]


def _spectral_centroid(cfg: Config, old_scf):
    """spectral_centroid_fx_lc: de-emphasized linear-domain scf centroid,
    normalized to [0, fs_norm]."""
    fs_idx = min(cfg.fs_idx, 4)
    dev = old_scf.device
    dee = nm.table(_dee_emphasis, fs_idx, device=dev)
    wts = nm.table(_centroid_weights, cfg, device=dev)
    s = nm.xla_exp2(old_scf) * dee
    num = nm.xla_dot_row(s, wts[0])
    den = nm.xla_dot_row(s, wts[1]) + nm.f32(2.0 ** -31)
    fac = [1.0 / 6, 2.0 / 6, 3.0 / 6, 4.0 / 6, 1.0][fs_idx]
    return num / den * nm.f32(fac)


def _band_offsets_64(cfg: Config) -> np.ndarray:
    """Stretch the coding band offsets to 64 bands (plc_classify_fx.c
    115-148); identity when bands_number == 64."""
    bo = np.asarray(T.bands_offset(cfg.fs_idx, cfg.frame_dms, cfg.hrmode), np.int64)
    n = cfg.bands_number
    out = np.zeros(65, np.int64)
    if n == 64:
        out[:] = bo[:65]
    elif n < 32:
        s = 32 - n
        for i in range(n - 1, s - 1, -1):
            out[(i + s) * 2 + 2] = bo[i + 1]
            out[(i + s) * 2 + 1] = bo[i + 1]
        for i in range(s - 1, -1, -1):
            out[i * 4 + 1: i * 4 + 5] = bo[i + 1]
    else:
        s = 64 - n
        for i in range(n - 1, s - 1, -1):
            out[i + s + 1] = bo[i + 1]
        for i in range(s - 1, -1, -1):
            out[i * 2 + 2] = bo[i + 1]
            out[i * 2 + 1] = bo[i + 1]
    return out


CLASS_NC = 7640.0 / 32768.0
CLASS_OFF = 335020208.0 / 2 ** 31


def classify(cfg: Config, x_old_tot, old_scf, pitch_int):
    """First-loss method select (plc_classify_fx.c:36-80): 3 = TD-PLC when
    pitched and low-centroid, 2 = Phase ECU (10 ms), else 4 = noise
    substitution. Returns (method [B] i32, norm_corr [B])."""
    nc = _xcorr(cfg, x_old_tot, pitch_int)
    sc = _spectral_centroid(cfg, old_scf)
    cls = nm.xla_fma(nm.f32(CLASS_NC), nc, -sc) - nm.f32(CLASS_OFF)
    pitched = torch.where(cls <= 0, 2 if cfg.frame_dms == 100 else 4, 3)
    return torch.where(pitch_int > 0, pitched, 4).to(I32), nc


# ---------------------------------------------------------------------------
# TD-PLC LPC analysis (plc_apply_fx.c:173-227)
# ---------------------------------------------------------------------------

def _plc_n_bands(cfg: Config) -> int:
    n = min(cfg.frame_length, 80)
    if cfg.frame_dms == 25 and cfg.fs_idx == 4:
        n = 60
    if cfg.frame_dms == 50 and cfg.fs_idx == 2:
        n = 40
    return n


def lpc_order(cfg: Config) -> int:
    return 8 if cfg.fs_idx == 0 else 16


@functools.cache
def lpc_tables(cfg: Config) -> dict[str, np.ndarray]:
    """The LPC analysis' operators (float32): seg [N, n_bands] (the band
    means), pre [n_bands] (the pre-emphasis), cos [n_bands, order + 1] (the
    inverse ODFT) and lag [order] (the lag window)."""
    lin_map = {100: ["8000", "16000", "24000", "32000", "48000"],
               50: ["8000", "8000", "24000", "16000", "24000"],
               25: ["8000", "8000", "8000", "8000", "16000"]}
    tag = lin_map[cfg.frame_dms][min(cfg.fs_idx, 4)]
    n_bands = _plc_n_bands(cfg)
    off = np.asarray(T.t(f"bands_offset_{tag}_lpc_lin"), np.int64)[: n_bands + 1]
    order = lpc_order(cfg)
    width = (off[1:] - off[:-1]).astype(np.float64)
    seg = np.zeros((n_bands, cfg.yLen), np.float32)
    for b in range(n_bands):
        seg[b, off[b]: off[b + 1]] = 1.0 / width[b]
    i_ = np.arange(order + 1)[:, None]
    b_ = np.arange(n_bands)[None, :] + 0.5
    cosm = np.cos(np.pi * i_ * b_ / n_bands)
    fs4 = min(cfg.fs_idx, 4)
    return dict(seg=seg.T.copy(), off=off.astype(np.int32), width_inv=(1.0 / width).astype(np.float32),
                pre=np.asarray(T.t(f"plc_lin_pre_emph_{cfg.frame_dms}_{fs4}"), np.float32),
                cos=cosm.T.astype(np.float32),
                lag=np.asarray(T.t("plc_lag_win")[fs4][:order], np.float32))


def _lpc_table(cfg: Config, name: str) -> np.ndarray:
    return lpc_tables(cfg)[name]


def tdc_lpc(cfg: Config, q_old_d):
    """LPC from the last good shaped spectrum: per-band mean energy ->
    pre-emphasis -> inverse ODFT autocorrelation -> lag window -> Levinson.
    Returns a [B, 17] with a[:, 0] = 1."""
    B = q_old_d.shape[0]
    dev = q_old_d.device
    tab = {k: nm.table(_lpc_table, cfg, k, device=dev) for k in ("seg", "pre", "cos", "lag")}
    order = lpc_order(cfg)
    d2 = nm.xla_dot(q_old_d * q_old_d, tab["seg"]) * tab["pre"]
    r = nm.xla_dot(d2, tab["cos"])
    r0 = torch.clamp(r[:, 0] * nm.f32(1.0001), min=nm.f32(1e-30))
    r = [r0] + [r[:, i] * tab["lag"][i - 1] for i in range(1, order + 1)]
    a = [torch.ones((B,), dtype=F32, device=dev)] + [torch.zeros((B,), dtype=F32, device=dev)
                                                     for _ in range(order)]
    err = r[0]
    for m in range(1, order + 1):
        acc = r[m]
        for j in range(1, m):
            acc = nm.xla_fma(a[j], r[m - j], acc)
        k = torch.clamp(-acc / torch.clamp(err, min=nm.f32(1e-30)), -0.999999, 0.999999)
        new_a = list(a)
        for j in range(1, (m + 1) // 2 + 1):
            new_a[j] = nm.xla_fma(k, a[m - j], a[j])
            if j != m - j:
                new_a[m - j] = nm.xla_fma(k, a[j], a[m - j])
        new_a[m] = k
        a = new_a
        err = err * nm.xla_fma(-k, k, 1.0)
    a += [torch.zeros((B,), dtype=F32, device=dev)] * (LPC_ORDER - order)
    return torch.stack(a, dim=1)


# ---------------------------------------------------------------------------
# TD-PLC (plc_tdc_main_fx.c:78-510)
# ---------------------------------------------------------------------------

@functools.cache
def lcg_pows(n: int) -> np.ndarray:
    """[2, n + 1] int64: the k-step advance of seed' = (16831 + 12821 seed)
    mod 2^16 in closed form, seed_k = (mult[k] seed + add[k]) mod 2^16."""
    out = np.zeros((2, n + 1), np.int64)
    m, c = 1, 0
    for k in range(n + 1):
        out[:, k] = m, c
        m = (m * 12821) & 0xFFFF
        c = (c * 12821 + 16831) & 0xFFFF
    return out


def lcg16(seed, n: int):
    """The 16-bit LCG of the TD-PLC noise and the sign scrambling, n steps
    from `seed` (signed): ([B, n] the signed values as floats, final seed)."""
    pows = nm.table(lcg_pows, n, device=seed.device, dtype=I64)
    su = seed.to(I64) & 0xFFFF
    s = (su[:, None] * pows[0, 1:] + pows[1, 1:]) & 0xFFFF
    v = torch.where(s >= 32768, s - 65536, s)
    return v.to(F32), v[:, -1].to(I32)


def sum_products(terms):
    """sum_k u_k v_k over a list of (u, v) pairs as XLA:CPU contracts a sum
    of products written term by term: the first product fused onto the
    second, fma(u0, v0, u1 v1), then one fused multiply-add per term."""
    (u0, v0), (u1, v1) = terms[:2]
    acc = nm.xla_fma(u0, v0, u1 * v1)
    for u, v in terms[2:]:
        acc = nm.xla_fma(u, v, acc)
    return acc


def _fir(x, h, out_len: int):
    """y[i] = sum_k x[:, i + k] h[k] for i in [0, out_len)."""
    return sum_products([(x[:, k: k + out_len], h[k]) for k in range(len(h))])


def _table_f32(name: str) -> np.ndarray:
    return np.asarray(T.t(name), np.float32)


def loss_counters(cfg: Config, nb_lost):
    """(nb_loc, next_inc, before_next): the loss counter in 10 ms units, and
    whether it steps up with this frame or with the next one."""
    if cfg.frame_dms == 25:
        return (nb_lost + 3) >> 2, (nb_lost & 3) == 1, (nb_lost & 3) == 0
    if cfg.frame_dms == 50:
        return (nb_lost + 1) >> 1, (nb_lost & 1) == 1, (nb_lost & 1) == 0
    return nb_lost, torch.ones_like(nb_lost, dtype=torch.bool), \
        torch.ones_like(nb_lost, dtype=torch.bool)


def tdc_apply(cfg: Config, pitch_int, fract, a, x_old_tot, nb_lost, stab_fac, seed,
              gain_c_in, alpha_in, harmonic_buf, synth_hist, harmonic_len, active):
    """One frame of time-domain concealment over [B] lanes; `active` masks
    the lanes concealed by TD-PLC this frame (other lanes keep their state).
    Returns dict(synth [B, frame + overlap], and the updated seed, gain_c,
    alpha, fract, harmonic_buf, harmonic_len, synth_hist)."""
    B = pitch_int.shape[0]
    dev = x_old_tot.device
    order = a.shape[1] - 1
    fl = cfg.frame_length
    length = 2 * fl - cfg.la_zeroes
    fs4 = min(cfg.fs_idx, 4)
    pre_fac = nm.f32(float(T.t("plc_preemph_fac")[fs4]))
    L = x_old_tot.shape[1]
    MP = max_pitch(cfg)
    nb_loc, next_inc, before_next = loss_counters(cfg, nb_lost)
    first = nb_lost == 1
    silent = nb_loc > PLC_FADEOUT_IN_MS // 10

    Tc = torch.clamp(pitch_int + (fract > 0).to(I32), 1, MP)

    # first-loss analysis: pre-emphasized history and the LPC residual
    fl2 = fl // 2
    span = MP + fl2 + order + 1
    tail = x_old_tot[:, L - span:]
    prev = torch.cat([torch.zeros((B, 1), dtype=F32, device=dev), tail[:, :-1]], 1)
    pe_sig = nm.xla_fma(-pre_fac, prev, tail)[:, 1:]
    conv_len = span - order - 1
    exc = sum_products([(a[:, j:j + 1], pe_sig[:, order - j: order - j + conv_len])
                        for j in range(order + 1)])
    synth_mem_first = pe_sig[:, -order:]

    def seg(buf, start_from_end, ln: int):
        k = torch.arange(ln, device=dev)[None, :]
        return _gather(buf, buf.shape[1] - start_from_end[:, None] + k)

    fl2v = torch.full((B,), fl2, dtype=I32, device=dev)
    x_cur = seg(pe_sig, fl2v, fl2)
    x_tc = seg(pe_sig, Tc + fl2, fl2)
    x_tc1 = seg(pe_sig, Tc + fl2 - 1, fl2)

    def gainp(xx, yy):
        return nm.xla_sum(xx * yy) / torch.clamp(nm.xla_sum(yy * yy), min=nm.f32(1e-9))
    same = pitch_int == Tc
    g_same = gainp(x_cur, x_tc)
    g_a = gainp(x_cur, x_tc1)
    pick_pi = (~same) & (g_a > g_same)
    Tc = torch.where(pick_pi, pitch_int, Tc)
    fract_out = torch.where(pick_pi, 0, fract)
    gain_p0 = torch.clamp(torch.where(same, g_same, torch.where(pick_pi, g_a, g_same)), 0.0, 1.0)

    e_cur = seg(exc, fl2v, fl2)

    def gainc(lag):
        d = nm.xla_fma(-gain_p0[:, None], seg(exc, lag + fl2, fl2), e_cur)
        g = nm.xla_sum(d * d)
        if cfg.frame_dms < 100:
            g = torch.minimum(g, nm.xla_sum(e_cur * e_cur))
        return nm.sqrt(nm.xla_div(g, fl2))
    gc_tc = gainc(Tc)
    gc0 = torch.where(pitch_int == Tc, gc_tc, torch.minimum(gc_tc, gainc(pitch_int)))
    gain_c = torch.where(first, gc0, gain_c_in)
    gain_p = torch.where(first, gain_p0, alpha_in)

    # damping factor (plc_tdc_main_fx.c:243-320)
    alpha_prev = torch.where(first, 1.0, alpha_in)
    a1 = torch.where(gain_p > nm.f32(0.98 ** 2), nm.f32(0.98),
                     torch.where(gain_p < nm.f32(0.925 ** 2), nm.f32(0.925), nm.sqrt(gain_p)))
    c1 = torch.where(nb_loc == 2, nm.f32(0.630), nm.f32(0.652))
    c2 = torch.where(nb_loc == 2, nm.f32(0.350), nm.f32(0.328))
    a2 = nm.xla_fma(stab_fac, c2, c1) * gain_p
    a2 = torch.where((nb_loc == 2) & (a2 < nm.f32(0.919)), nm.f32(0.919), a2)
    alpha = torch.where(next_inc, torch.where(nb_loc == 1, a1, a2), alpha_in)
    alpha = torch.where(nb_loc > 3, alpha * nm.f32(ATTEN[cfg.frame_dms]), alpha)
    gain_p = torch.where(nb_loc > 5, alpha, gain_p)

    # harmonic part: the last pitch cycle, smoothed by an 11-tap FIR unless
    # the spectrum is stable; positions past the cycle's end wrap to its start
    kmp = torch.arange(MP, device=dev)[None, :]
    Tcc = Tc[:, None]
    cycle = _gather(exc, exc.shape[1] - Tcc + kmp % torch.clamp(Tcc, min=1))
    hh = _table_f32("TDC_high_16_harm" if cfg.fs_idx <= 1 else "TDC_high_32_harm")
    half = (L_FIR_HP - 1) // 2

    def tap(k):
        off = kmp + (k - half)
        off = torch.where(off >= Tcc, off - Tcc, off)
        return _gather(exc, exc.shape[1] - Tcc + off)
    filt = tap(0) * float(hh[0])          # products rounded: XLA fuses none
    for k in range(1, L_FIR_HP):
        filt = filt + tap(k) * float(hh[k])
    new_cycle = torch.where((stab_fac >= 1.0)[:, None], cycle, filt)
    upd_h = active & first
    harmonic_buf = torch.where(upd_h[:, None], new_cycle, harmonic_buf)
    harmonic_len = torch.where(upd_h, Tc, harmonic_len)

    # random part
    rnd, seed_out = lcg16(seed, length + L_FIR_HP - 1)
    hp = _table_f32("TDC_high_16" if cfg.fs_idx <= 1 else "TDC_high_32")
    hp_f = _fir(rnd, [float(v) for v in hp], length)
    throttle = nb_loc.to(F32) / (nb_loc + HPBLEND_THROTTLE).to(F32)
    blend = (1.0 - alpha) * throttle
    mix = nm.xla_fma(blend[:, None], rnd[:, half: half + length], (1.0 - blend)[:, None] * hp_f)
    exc2 = torch.where(first[:, None], hp_f, mix)

    e16 = exc2[:, :fl] * nm.f32(1.0 / 16.0)
    # 2 * mean + 0.01: XLA folds the 2 into the mean's reciprocal and fuses
    # the add; it rewrites a / sqrt(b) into a * rsqrt(b)
    den = nm.xla_fma(nm.xla_sum(e16 * e16), 2.0 * nm.f32(1.0 / fl), nm.f32(0.01))
    gain_inov = nm.xla_fma(nm.f32(-0.75), gain_p, nm.f32(1.1)) * nm.xla_rsqrt(den)

    # total excitation with per-sample gain ramps
    step = nm.xla_div(alpha_prev - alpha, fl)
    gc_end = gain_c * alpha / torch.clamp(alpha_prev, min=nm.f32(1e-9))
    step_n = nm.xla_div(gain_c - gc_end, fl)
    tpos = torch.arange(length, device=dev, dtype=F32)[None, :]
    gain_h_t = torch.clamp(nm.xla_fma(-step[:, None], tpos, alpha_prev[:, None]), min=0.0)
    gain_c_t = torch.clamp(nm.xla_fma(-step_n[:, None], tpos, gain_c[:, None]), min=0.0)
    hl = torch.clamp(harmonic_len, min=1)[:, None]
    hoff = ((nb_lost - 1) * fl)[:, None] % hl
    harm = _gather(harmonic_buf, (hoff + torch.arange(length, device=dev)[None, :]) % hl)
    exc_tot = nm.xla_fma(harm, gain_h_t, exc2 * (gain_c_t * gain_inov[:, None] * nm.f32(1.0 / 16)))
    gain_c_out = torch.where(active, gc_end, gain_c_in)

    # LPC synthesis and de-emphasis: recurrences over the samples
    mem = torch.where(first[:, None], synth_mem_first, synth_hist)
    arev = a[:, 1:].flip(1)
    mem = list(mem.unbind(1))
    arev = list(arev.unbind(1))
    synth_pe = []
    for n in range(length):
        acc = torch.zeros((B,), dtype=F32, device=dev)
        for k in range(order):
            acc = nm.xla_fma(mem[k], arev[k], acc)
        y = exc_tot[:, n] - acc
        mem = mem[1:] + [y]
        synth_pe.append(y)
    synth_pe = torch.stack(synth_pe, 1)
    synth_hist_out = torch.where(active[:, None], synth_pe[:, fl - order: fl], synth_hist)
    m = x_old_tot[:, -1]
    synth = []
    for n in range(length):
        m = nm.xla_fma(pre_fac, m, synth_pe[:, n])
        synth.append(m)
    synth = torch.stack(synth, 1)

    # fade-out ramp on the final concealed frame before silence
    last = before_next & (nb_loc == PLC_FADEOUT_IN_MS // 10)
    ramp = torch.clamp(nm.xla_fma(torch.arange(length, device=dev, dtype=F32), -nm.f32(1.0 / fl), 1.0), min=0.0)
    synth = torch.where(last[:, None], synth * ramp[None, :], synth)
    synth = torch.where(silent[:, None], 0.0, synth)
    alpha = torch.where(silent, 0.0, alpha)
    gain_c_out = torch.where(silent & active, 0.0, gain_c_out)
    return dict(synth=synth, seed=torch.where(active, seed_out, seed), gain_c=gain_c_out,
                alpha=torch.where(active, alpha, alpha_in),
                fract=torch.where(upd_h, fract_out, fract).to(I32),
                harmonic_buf=harmonic_buf, harmonic_len=harmonic_len.to(I32),
                synth_hist=synth_hist_out)


def tdac(cfg: Config, synth):
    """processTdac_fx: overlap-add memory for the frame after a concealed
    one, as the MDCT of the synthesized extension followed by the IMDCT (the
    port's `transforms.mdct`/`imdct`, kernels on the card). synth: [B, frame
    + (frame - la_zeroes)]. Returns ola_mem [B, frame - la_zeroes]."""
    from . import transforms
    B = synth.shape[0]
    fl, la = cfg.frame_length, cfg.la_zeroes
    mem_t = synth[:, la:fl].contiguous()
    x_next = torch.cat([synth[:, fl: 2 * fl - la],
                        torch.zeros((B, la), dtype=F32, device=synth.device)], 1)
    y, _ = transforms.mdct(cfg, x_next, mem_t)
    _, ola_mem = transforms.imdct(cfg, y, torch.zeros((B, fl - la), dtype=F32,
                                                       device=synth.device))
    return ola_mem


# ---------------------------------------------------------------------------
# noise substitution and damping/scrambling
# ---------------------------------------------------------------------------

def noise_substitution(spec_prev):
    """processPLCNoiseSubstitution_fx: repeat with a DC-blocking taper."""
    out = spec_prev.clone()
    out[:, 0] = out[:, 0] * nm.f32(0.2)
    out[:, 1] = out[:, 1] * nm.f32(0.5)
    return out


def damping_scrambling(cfg: Config, spec, nb_lost, stab_fac, scramble, cum_fflc, cum_slow,
                       cum_fast, pitch_present, seed, spec_inv_idx, active):
    """processPLCDampingScrambling_fx: cumulative slow/fast fades, sign
    scrambling above spec_inv_idx and adaptive per-bin damping. `scramble`
    masks the lanes whose spectrum changes (noise substitution, bfi 2);
    `active` the lanes whose cumulative factors step.
    Returns (spec, cum_fflc, cum_slow, cum_fast, seed)."""
    B, N = spec.shape
    dev = spec.device
    if cfg.frame_dms == 25:
        nb10, root = (nb_lost + 3) >> 2, 0.25
    elif cfg.frame_dms == 50:
        nb10, root = (nb_lost + 1) >> 1, 0.5
    else:
        nb10, root = nb_lost, 1.0
    first = nb_lost == 1
    reset = active & first
    cum_fflc = torch.where(reset, 1.0, cum_fflc)
    cum_slow = torch.where(reset, 1.0, cum_slow)
    cum_fast = torch.where(reset, 1.0, cum_fast)
    slow = nm.xla_fma(nm.f32(0.2), stab_fac, nm.f32(0.8))
    fast = nm.xla_fma(nm.f32(0.2), stab_fac, nm.f32(0.3))
    if root != 1.0:
        slow, fast = nm.xla_pow(slow, torch.full_like(slow, root)), \
            nm.xla_pow(fast, torch.full_like(fast, root))
    cum_slow = torch.where(active, cum_slow * slow, cum_slow)
    cum_fast = torch.where(active, cum_fast * fast, cum_fast)

    # rapid fading for full-frame-loss concealment (spec_inv_idx == 0 lanes)
    ffl = spec_inv_idx == 0
    fflc_att = torch.where(nb10 > PLC_FADEOUT_IN_MS // 10, 0.0,
                           torch.where(nb10 > 2, nm.f32(ATTEN[100] ** root), 1.0))
    cum_fflc = torch.where(active & scramble & ffl & (fflc_att < 1.0), cum_fflc * fflc_att,
                           cum_fflc)
    slow_loc = torch.where(ffl, cum_slow * cum_fflc, cum_slow)
    fast_loc = torch.where(ffl, cum_fast * cum_fflc, cum_fast)

    # fade-out window position
    per_frame = cfg.frame_dms / 100.0
    start_f = max(int(PLC4_TRANSIT_START_IN_MS / (10 * per_frame)), 1)
    end_f = int(PLC4_TRANSIT_END_IN_MS / (10 * per_frame))
    start = torch.where(pitch_present == 0, 1, start_f)
    lin = torch.clamp((end_f - nb_lost).to(F32) / torch.clamp(end_f - start, min=1).to(F32),
                      0.0, 1.0)
    lin = torch.where(nb_lost <= start, 1.0, lin)

    # sign scrambling with the 16-bit LCG; the seed advances only over the
    # scrambled span
    rnd, _ = lcg16(seed, N)
    thr = nm.f32(-32768.0) * lin
    kidx = torch.arange(N, device=dev)[None, :]
    in_rng = kidx >= spec_inv_idx[:, None]
    neg = (rnd < 0) & ((pitch_present == 0)[:, None] | (rnd < thr[:, None]))
    do = scramble[:, None] & in_rng
    spec = torch.where(do & neg, -spec, spec)
    steps = torch.where(scramble, N - spec_inv_idx, 0).clamp(0, N).long()
    pows = nm.table(lcg_pows, N, device=dev, dtype=I64)
    su = seed.to(I64) & 0xFFFF
    su = (su * pows[0][steps] + pows[1][steps]) & 0xFFFF
    seed_out = torch.where(su >= 32768, su - 65536, su).to(I32)

    # adaptive damping: bins under the mean-energy threshold fade slow,
    # outliers fade fast with a level offset
    ad_fac = nm.xla_fma(nm.f32(10.0 - 1.2), lin, nm.f32(1.2))
    msk = in_rng.to(F32)
    nbin = torch.clamp(nm.xla_sum(msk), min=1.0)
    mean_e = nm.xla_sum(msk * (spec * spec)) / nbin
    thr_e = nm.sqrt(ad_fac * mean_e)
    fac = (slow_loc - fast_loc) * thr_e
    below = torch.abs(spec) < thr_e[:, None]
    damped = torch.where(below, spec * slow_loc[:, None],
                         nm.xla_fma(spec, fast_loc[:, None], torch.sign(spec) * fac[:, None]))
    spec = torch.where(do, damped, spec)
    return spec, cum_fflc, cum_slow, cum_fast, seed_out


# ---------------------------------------------------------------------------
# the kernels' entry points
# ---------------------------------------------------------------------------

def plc_tdc_plain(cfg: Config, lost, nb_cur, x_old_tot, scf_q, q_d_prev, pitch_int, pitch_fr,
                  stab_fac, meth, a, seed, gain_c, alpha, fract, harmonic, harmonic_len,
                  synth_hist):
    """The plain version of the `plc_tdc` kernel: on the first loss of a
    burst the method classifier and the LPC analysis, then one frame of
    TD-PLC on the lanes concealed by it. Lanes that are not lost keep their
    state. Returns dict(meth, nc (0 but at a first loss), a, synth (0 but on
    TD-PLC lanes) and the TD-PLC state)."""
    first = lost & (nb_cur == 1)
    meth_new, nc = classify(cfg, x_old_tot, scf_q, pitch_int)
    if cfg.frame_dms != 100:   # Phase ECU runs at 10 ms frames only
        meth_new = torch.where(meth_new == 2, 4, meth_new)
    meth = torch.where(first, meth_new, meth).to(I32)
    tdc_lane = lost & (meth == 3)
    a = torch.where(first[:, None], tdc_lpc(cfg, q_d_prev), a)
    fract = torch.where(first, pitch_fr, fract)
    out = tdc_apply(cfg, pitch_int, fract, a, x_old_tot, nb_cur, stab_fac, seed, gain_c, alpha,
                    harmonic, synth_hist, harmonic_len, tdc_lane)
    out["synth"] = torch.where(tdc_lane[:, None], out["synth"], 0.0)
    out.update(meth=meth, nc=torch.where(first, nc, 0.0), a=a)
    return out


def plc_tdc(cfg: Config, lost, nb_cur, x_old_tot, scf_q, q_d_prev, pitch_int, pitch_fr, stab_fac,
            meth, a, seed, gain_c, alpha, fract, harmonic, harmonic_len, synth_hist):
    """Classifier, LPC analysis and TD-PLC: the `plc_tdc` kernel for tensors
    on a card, `plc_tdc_plain` on the CPU."""
    args = (lost, nb_cur, x_old_tot, scf_q, q_d_prev, pitch_int, pitch_fr, stab_fac, meth, a,
            seed, gain_c, alpha, fract, harmonic, harmonic_len, synth_hist)
    if nm.on_cpu(x_old_tot):
        return plc_tdc_plain(cfg, *args)
    return kernels.plc_tdc(cfg, *args)


def damp_scramble_plain(cfg: Config, x, q_d_prev, ns_lane, lost, is_pc, nb_cur, pc_nb_lost,
                        stab_fac, pitch_int, pc_pitch, cum_fflc, cum_slow, cum_fast, ns_seed,
                        pc_seed, spec_inv_idx):
    """The plain version of the `plc_damp_scramble` kernel: noise
    substitution on the noise-substitution lanes, then damping and sign
    scrambling of the lost lanes (bfi 1) and of the partially concealed
    ones (bfi 2), in the reference decoder's order. Returns (x, cum_fflc,
    cum_slow, cum_fast, ns_seed, pc_seed)."""
    x = torch.where(ns_lane[:, None], noise_substitution(q_d_prev), x)
    x, cum_fflc, cum_slow, cum_fast, ns_seed = damping_scrambling(
        cfg, x, nb_cur, stab_fac, ns_lane, cum_fflc, cum_slow, cum_fast,
        (pitch_int > 0).to(I32), ns_seed, torch.zeros_like(spec_inv_idx), lost)
    x, cum_fflc, cum_slow, cum_fast, pc_seed = damping_scrambling(
        cfg, x, pc_nb_lost, stab_fac, is_pc, cum_fflc, cum_slow, cum_fast, pc_pitch, pc_seed,
        spec_inv_idx, is_pc)
    return x, cum_fflc, cum_slow, cum_fast, ns_seed, pc_seed


def damp_scramble(cfg: Config, x, q_d_prev, ns_lane, lost, is_pc, nb_cur, pc_nb_lost, stab_fac,
                  pitch_int, pc_pitch, cum_fflc, cum_slow, cum_fast, ns_seed, pc_seed,
                  spec_inv_idx):
    """Noise substitution, damping and scrambling: the `plc_damp_scramble`
    kernel for tensors on a card, `damp_scramble_plain` on the CPU."""
    args = (x, q_d_prev, ns_lane, lost, is_pc, nb_cur, pc_nb_lost, stab_fac, pitch_int, pc_pitch,
            cum_fflc, cum_slow, cum_fast, ns_seed, pc_seed, spec_inv_idx)
    if nm.on_cpu(x):
        return damp_scramble_plain(cfg, *args)
    return kernels.plc_damp_scramble(cfg, *args)
