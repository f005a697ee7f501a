"""Synthetic inputs of the kernels that force what seeded material may not
reach: every SNS submode, the pulse search's silent-target branch,
per-stream field widths, each of the parser's bad-frame triggers, TNS
filters of order 8 and prediction gains where the LPC weighting decides,
every branch of the partial-concealment classifier, and full-scale, silent
and alternating rows for the MDCT and IMDCT. Made with numpy from a seed; shared by
the CPU parity tests, the CPU rehearsal of the kernels' lane functions and
the tests that run on a card, and chip_smoke.py. Imports nothing of JAX."""
from __future__ import annotations

import contextlib
import functools

import numpy as np

from audio_codec_torch import tables as T

# with and without the bandwidth field, and a 2.5 ms frame (always one TNS filter)
CONFIGS = {"48k": dict(fs_in=48000, bitrate=64000), "8k": dict(fs_in=8000, bitrate=32000),
           "48k_2.5ms": dict(fs_in=48000, bitrate=64000, frame_dms=25)}
# the keys of side_fields(), in the argument order of pack_side_info
FIELD_ORDER = ("bw_idx", "lastnz", "lsb_mode", "gg_idx", "num_tns_filters", "tns_order",
               "ltpf_param", "scf_idx", "fac_ns_idx")
BFI_TRIGGERS = ("lastnz", "split_payload", "outlier_payload", "bandwidth")
# (configuration, rows) of the parser's cases; the 8 kHz configuration sends
# no bandwidth field, so it has no such trigger
PARSE_CASES = [(name, rows) for rows in ("packed", "random", *BFI_TRIGGERS)
               for name in CONFIGS if (name, rows) != ("8k", "bandwidth")]
MPVQ_SPLIT, MPVQ_NEAR, MPVQ_FAR = 2390004, 15158272, 774912
# per submode: gain indices, size of the main MPVQ set, values of scf_idx[6]
SUBMODES = {0: (2, MPVQ_SPLIT, range(0, 12)), 1: (4, MPVQ_SPLIT, (-2,)),
            2: (4, MPVQ_NEAR, (-1,)), 3: (8, MPVQ_FAR, (-2,))}


def scf_idx_grid(submode: int, n: int = 24, seed: int = 0) -> np.ndarray:
    """[n, 7] valid SNS indices of one submode: seeded, with the first and
    last MPVQ index of the submode's set among them."""
    rng = np.random.default_rng(seed + submode)
    gains, size, tails = SUBMODES[submode]
    idx = np.zeros((n, 7), np.int32)
    idx[:, 0] = rng.integers(0, 32, n)
    idx[:, 1] = rng.integers(0, 32, n)
    idx[:, 2] = submode
    idx[:, 3] = rng.integers(0, gains, n)
    idx[:, 4] = rng.integers(0, 2, n)
    idx[:, 5] = rng.integers(0, size, n)
    idx[0, 5], idx[1, 5] = 0, size - 1
    idx[:, 6] = np.asarray(tails)[np.arange(n) % len(tails)]
    return idx


def scf_rows(seed: int = 0, n: int = 40) -> np.ndarray:
    """[n + 22, 16] float32 scale factors: seeded rows at three spreads, an
    all-zero row, two rows equal to stage-1 codebook vectors (the residual
    is zero, so every pulse search takes its silent-target branch), a row a
    hair off one (a silent tail only), two rows of large values, and four
    rows that the decoder gives for each submode 0-3 (the search finds that
    submode again, so all four occur)."""
    import torch

    from audio_codec_torch.ops import sns
    rng = np.random.default_rng(seed)
    C1, C2 = T.t("sns_C1").astype(np.float32), T.t("sns_C2").astype(np.float32)
    rows = [rng.standard_normal((n // 2, 16)) * 2.5, rng.standard_normal((n // 4, 16)) * 0.3,
            rng.standard_normal((n - n // 2 - n // 4, 16)) * 8.0, np.zeros((1, 16))]
    cb = np.stack([np.concatenate([C1[:, 3], C2[:, 17]]), np.concatenate([C1[:, 31], C2[:, 0]])])
    near = cb[:1].copy()
    near[0, :4] += np.float32(0.37)
    rows += [cb, near, rng.standard_normal((2, 16)) * 40.0]
    rows += [sns.sns_vq_dec_plain(torch.from_numpy(scf_idx_grid(s, 4, seed + 20))).numpy()
             for s in range(4)]
    return np.concatenate(rows).astype(np.float32)


def side_fields(cfg, n: int = 48, seed: int = 0) -> dict[str, np.ndarray]:
    """Valid side information of n streams: every submode with its own field
    widths, LTPF on and off, one and two TNS filters."""
    rng = np.random.default_rng(seed)
    scf_idx = np.concatenate([scf_idx_grid(s, n // 4, seed) for s in range(4)])
    rng.shuffle(scf_idx)
    n = scf_idx.shape[0]
    ltpf = np.zeros((n, 3), np.int32)
    on = rng.integers(0, 2, n) == 1
    ltpf[on, 0] = 1
    ltpf[on, 1] = rng.integers(0, 2, int(on.sum()))
    ltpf[on, 2] = rng.integers(0, 512, int(on.sum()))
    n_bw = 1 << cfg.BW_cutoff_bits
    bw_idx = (rng.integers(0, min(n_bw, cfg.fs_idx + 1), n) if cfg.BW_cutoff_bits
              else np.full(n, cfg.fs_idx)).astype(np.int32)
    num_tns = np.where((bw_idx < 3) | (cfg.frame_dms == 25), 1, 2).astype(np.int32)
    return dict(
        bw_idx=bw_idx,
        lastnz=(2 * rng.integers(1, cfg.yLen // 2 + 1, n)).astype(np.int32),
        lsb_mode=rng.integers(0, 2, n).astype(np.int32),
        gg_idx=rng.integers(0, 256, n).astype(np.int32),
        num_tns_filters=num_tns,
        tns_order=rng.integers(0, 9, (n, 2)).astype(np.int32),
        ltpf_param=ltpf, scf_idx=scf_idx,
        fac_ns_idx=rng.integers(0, 8, n).astype(np.int32))


def corrupt_fields(cfg, trigger: str, n: int = 8, seed: int = 0) -> dict[str, np.ndarray]:
    """Side information that packs into frames the parser must flag: a
    lastnz beyond the coded bins, a joint SNS index beyond its set in a split
    (submode_msb 0) or an outlier (submode_msb 1) frame, a bandwidth above
    the sampling rate's."""
    f = side_fields(cfg, 4 * n, seed)
    f = {k: v[:n].copy() for k, v in f.items()}
    if trigger == "lastnz":
        f["lastnz"][:] = cfg.yLen + 2 * (1 + np.arange(n))
    elif trigger == "split_payload":
        f["scf_idx"][:] = scf_idx_grid(0, n, seed)
        f["scf_idx"][:, 5] = np.arange(n)
        f["scf_idx"][:, 6] = 12          # (12 + 2) * MPVQ_SPLIT: past the 14 sets
    elif trigger == "outlier_payload":
        f["scf_idx"][:] = scf_idx_grid(3, n, seed)
        f["scf_idx"][:, 5] = MPVQ_FAR + np.arange(n)
    elif trigger == "bandwidth":
        above = (1 << cfg.BW_cutoff_bits) - cfg.fs_idx - 1     # values the field can hold
        f["bw_idx"][:] = cfg.fs_idx + 1 + np.arange(n) % above
    else:
        raise ValueError(trigger)
    return f


def count_differing(got, ref) -> int:
    """How many values of got differ from ref bit for bit. Each is an array
    or a tensor, or a tuple, list or dict of them (a dict is read key for key
    of ref). Two NaNs count as equal; an output of another shape or type
    counts as differing throughout."""
    if isinstance(ref, dict):
        got, ref = [got[k] for k in ref], list(ref.values())
    if not isinstance(ref, (tuple, list)):
        got, ref = [got], [ref]
    bad = 0
    for g, r in zip(got, ref, strict=True):
        g, r = (np.asarray(a.detach().cpu() if hasattr(a, "detach") else a) for a in (g, r))
        if g.shape != r.shape or g.dtype != r.dtype:
            bad += max(r.size, 1)
        elif g.dtype == np.float32:
            bad += int(((g.view(np.int32) != r.view(np.int32)) & ~(np.isnan(g) & np.isnan(r))).sum())
        else:
            bad += int((g != r).sum())
    return bad


# a configuration whose TNS analysis weights the LPC (max_pg 2.0: below
# 48 kbps at 10 ms), beside the flagship
TNS_CONFIGS = {"48k": dict(fs_in=48000, bitrate=64000), "48k_32kbps": dict(fs_in=48000, bitrate=32000)}


def tns_rows(seed: int = 0, n_ar: int = 48) -> tuple[np.ndarray, np.ndarray]:
    """[n, 480] float32 spectra and [n] bandwidth indices: an all-zero row,
    rows silent in their lower or upper half (dead subdivisions), strongly
    correlated rows with a rising envelope (filters of order 8 in both
    ranges), and AR(1) rows whose correlation sweeps 0.35-0.85 (prediction
    gains about 1.1-3.5, across max_pg 1.5 and 2.0); the bandwidths 0-4 in
    turn, so one and two filters occur."""
    rng = np.random.default_rng(seed)
    N = 480
    rows = [np.zeros(N)]
    half = rng.standard_normal((2, N)) * 300.0
    half[0, : N // 2] = 0.0
    half[1, N // 4:] = 0.0
    rows += list(half)
    hi = rng.standard_normal((8, N)) * np.linspace(1, 50, N)[None]
    hi *= 10 ** rng.uniform(-1, 3, (8, 1))
    for i in range(1, N):
        hi[:, i] += 0.9 * hi[:, i - 1]
    rows += list(hi)
    rho = np.linspace(0.35, 0.85, n_ar)
    ar = rng.standard_normal((n_ar, N)) * 100.0
    for i in range(1, N):
        ar[:, i] += rho * ar[:, i - 1]
    rows += list(ar)
    x = np.stack(rows).astype(np.float32)
    bw = (np.arange(x.shape[0]) % 5).astype(np.int32)
    bw[3: 3 + 8] = 4          # the correlated rows: two filters
    return x, bw


def pc_base_rows(n: int = 8, seed: int = 0) -> tuple[np.ndarray, np.ndarray]:
    """Seeded q_old_d [n, 400] (loud low band) and q_old_res [n, 400]
    (integer-valued, as a decoded residual is) for pc_rows."""
    rng = np.random.default_rng(seed)
    d = rng.standard_normal((n, 400)) * 300.0
    d[:, 100:] *= 0.01
    res = np.round(rng.standard_normal((n, 400)) * 4.0)
    return d.astype(np.float32), res.astype(np.float32)


def _peak(row: np.ndarray, k: int, energy: float):
    """A peak of this 3-bin energy centred on bin k (0.25, 0.5, 0.25 of it)."""
    amp = np.sqrt(energy)
    row[k - 1: k + 2] = amp * np.sqrt([0.25, 0.5, 0.25])


def pc_rows(q_old_d: np.ndarray, q_old_res: np.ndarray, seed: int = 0) -> dict[str, np.ndarray]:
    """Inputs of pc_classify that take every branch, built from decoded (or
    seeded) rows q_old_d, q_old_res [n, N]: besides those rows, rows with one
    dominant peak, a peak in the first block (the i == 0 edge of the peak
    detector), a flat-topped peak (a local maximum by equality), and a
    second peak at 0.5 and at 0.28 of the first (the hysteresis takes the
    one above 0.3 of the maximum). Each row runs with bfi 2 and
    spec_inv_idx swept across the low region and above it, pitch_present
    0 and 1, stab_fac on both sides of 0.5; and a few with bfi 0 and 1.
    Returns the arguments of pc_classify after cfg, as numpy arrays."""
    rng = np.random.default_rng(seed)
    n, N = q_old_d.shape
    quiet = (rng.standard_normal((6, N)) * 2.0).astype(np.float32)
    dominant, first, flat, hyst_in, hyst_out, late = (r.copy() for r in quiet)
    _peak(dominant, 25, 4e6)
    first[:5] = [3000.0, 1000.0, 10.0, 8.0, 6.0]
    flat[14:18] = [200.0, 2500.0, 2500.0, 200.0]
    for row, second in ((hyst_in, 0.5), (hyst_out, 0.28)):
        _peak(row, 20, 1e6)
        _peak(row, 70, second * 1e6)
    _peak(late, 60, 1e6)
    _peak(late, 12, 3e5)
    d = np.concatenate([q_old_d, dominant[None], first[None], flat[None], hyst_in[None],
                        hyst_out[None], late[None]])
    res = np.concatenate([q_old_res, np.round(rng.standard_normal((6, N)) * 4.0)])
    inv = np.array([0, 3, 7, 9, 16, 26, 39, 40, 200], np.int32)
    combos = [(2, i, p, s) for i in inv for p in (0, 1) for s in (0.3, 0.8)]
    combos += [(0, 5, 1, 0.8), (1, 5, 1, 0.8), (1, 300, 0, 0.3)]
    rows = np.repeat(np.arange(d.shape[0]), len(combos))
    c = np.array(combos * d.shape[0], np.float64)
    return dict(bfi=c[:, 0].astype(np.int32), spec_inv_idx=c[:, 1].astype(np.int32),
                stab_fac=c[:, 3].astype(np.float32), pitch_present=c[:, 2].astype(np.int32),
                q_old_d=np.ascontiguousarray(d[rows], np.float32),
                q_old_res=np.ascontiguousarray(res[rows], np.float32))


PC_ORDER = ("bfi", "spec_inv_idx", "stab_fac", "pitch_present", "q_old_d", "q_old_res")


def pc_branches(args: dict, out: np.ndarray, frame_dms: int = 100) -> dict[str, int]:
    """Streams of pc_classify's inputs args (numpy) with output out in each
    branch: the early return, unstable, the pitch path, the energy path,
    and among the streams past the early return the downgraded and kept."""
    bfi, inv = args["bfi"], args["spec_inv_idx"]
    active = (bfi == 2) & (inv * 10 < 4 * frame_dms)
    unstable = active & (args["stab_fac"] < 0.5)
    stable = active & ~unstable
    return {"early return": int((~active).sum()), "unstable": int(unstable.sum()),
            "pitch path": int((stable & (args["pitch_present"] == 1)).sum()),
            "energy path": int((stable & (args["pitch_present"] != 1)).sum()),
            "downgraded": int((active & (out == 1)).sum()),
            "kept": int((active & (out == 2)).sum())}


def transform_rows(N: int, la: int, seed: int = 0) -> tuple[np.ndarray, np.ndarray]:
    """[n, N] frames and [n, N - la] memories for the MDCT and IMDCT:
    full-scale noise, silent rows, alternating-sign rows at full scale and
    small, and seeded rows at several levels."""
    rng = np.random.default_rng(seed)
    full = lambda k, m: rng.uniform(-32768.0, 32767.0, (k, m))
    alt = lambda m, a: a * np.where(np.arange(m) % 2 == 0, 1.0, -1.0)[None]
    x = np.concatenate([full(4, N), np.zeros((2, N)), alt(N, 32767.0), alt(N, 0.5),
                        rng.standard_normal((8, N)) * 10.0 ** rng.uniform(-2, 4, (8, 1))])
    m = N - la
    mem = np.concatenate([full(4, m), np.zeros((2, m)), alt(m, -32768.0), np.zeros((1, m)),
                          rng.standard_normal((8, m)) * 1000.0])
    return x.astype(np.float32), mem.astype(np.float32)


# ---- the pitch analysis, the noise factor and residual coder, the decoder's
# spectrum reconstruction ----

OLPA_ORDER = ("s12k8", "mem_s12k8", "mem_s6k4", "mem_pitch")


def _periodic(kind: str, period: int, n: int, phase: int, rng) -> np.ndarray:
    """n samples of a pulse train or a tone of this period (in samples)."""
    t = np.arange(n) + phase
    if kind == "pulse":
        return np.where(t % period == 0, 8000.0, 0.0)
    if kind == "tone":
        return 6000.0 * np.sin(2 * np.pi * t / period + rng.uniform(0, 0.3))
    raise ValueError(kind)


def olpa_rows(seed: int = 0) -> dict[str, np.ndarray]:
    """Inputs of olpa (s12k8 [n, 129], mem_s12k8 [n, 3], mem_s6k4 [n, 114],
    mem_pitch [n]) from one 12.8 kHz signal a row, the memories its earlier
    samples decimated as the frame is: pulse trains and tones whose period
    at 6.4 kHz is each lag limit (17, 114) and lags between, each with the
    previous pitch at the period, at twice it (the windowed search takes
    over), at 1.5 times it (it does not), at both limits and out of range
    (an empty window); tones with the previous pitch 4-14 lags above the
    period (the windowed correlation near 0.85 of the other); silent rows
    (every lag ties, the first wins); seeded noise."""
    rng = np.random.default_rng(seed)
    w = T.t("olpa_down2")
    n12 = 228 + 3 + 129
    sigs, pitches = [], []
    for P in (17, 18, 29, 50, 57, 113, 114):
        for kind, phases in (("pulse", (0, P // 3, (2 * P) // 3)), ("tone", (0,))):
            for ph in phases:
                for mp in (P, 2 * P, (3 * P) // 2, 17, 114, 0, 300):
                    sigs.append(_periodic(kind, 2 * P, n12, 2 * ph, rng))
                    pitches.append(mp)
    # tones with the previous pitch 4-14 lags above the period: the windowed
    # search's correlation sweeps through 0.85 of the weighted one's
    for P in (40, 50, 57, 80, 100):
        for d in range(4, 15):
            sigs.append(_periodic("tone", 2 * P, n12, 0, rng))
            pitches.append(P + d)
    for mp in (17, 60, 0):
        sigs.append(np.zeros(n12))
        pitches.append(mp)
    for k in range(8):
        sigs.append(rng.standard_normal(n12) * 10.0 ** rng.uniform(0, 4))
        pitches.append(int(rng.integers(17, 115)))
    u = np.stack(sigs)
    filt = np.stack([np.convolve(r, w)[: n12] for r in u])
    return dict(s12k8=np.ascontiguousarray(u[:, 231:], np.float32),
                mem_s12k8=np.ascontiguousarray(u[:, 228:231], np.float32),
                mem_s6k4=np.ascontiguousarray(filt[:, 4:232:2], np.float32),
                mem_pitch=np.asarray(pitches, np.int32))


def olpa_weighted_lag(args: dict) -> np.ndarray:
    """T0 of olpa's weighted search alone (float64, from the inputs), to tell
    the rows where the windowed search took over."""
    w = T.t("olpa_down2")
    buf = np.concatenate([args["mem_s12k8"], args["s12k8"][:, :128]], axis=1).astype(np.float64)
    filt = np.stack([np.convolve(r, w)[: buf.shape[1]] for r in buf])
    row = np.concatenate([args["mem_s6k4"].astype(np.float64), filt[:, 4::2][:, :64]], axis=1)
    cur = row[:, 114:178]
    R = np.stack([(cur * row[:, 114 - lag: 178 - lag]).sum(-1) for lag in range(17, 115)], -1)
    return np.argmax(R * T.t("olpa_acw")[None], axis=-1).astype(np.int32) + 17


def olpa_branches(args: dict, out) -> dict[str, int]:
    """Rows of an olpa launch by outcome: T0 at each lag limit, and the
    windowed search taken over or not where its window held a lag."""
    t0 = np.asarray(out[2])
    weighted = olpa_weighted_lag(args)
    mp = args["mem_pitch"]
    window = (np.minimum(mp + 4, 114) >= np.maximum(mp - 4, 17))
    return {"T0 17": int((t0 == 17).sum()), "T0 114": int((t0 == 114).sum()),
            "window taken": int((window & (t0 != weighted)).sum()),
            "window not taken": int((window & (t0 == weighted)).sum())}


LTPF_ORDER = ("s12k8", "pitch_ol", "nc_ol", "mem_in", "mem_normcorr", "mem_mem_normcorr",
              "mem_on", "mem_pitch")


def ltpf_rows(seed: int = 0) -> dict[str, np.ndarray]:
    """Inputs of ltpf_encode at 10 ms (s12k8 [n, 129], pitch_ol, nc_ol,
    mem_in [n, 232], mem_normcorr, mem_mem_normcorr, mem_on, mem_pitch):
    pulse trains and tones at 12.8 kHz periods from the lag limits 32 and
    228 across the resolution steps 127 and 157, with noise at four levels
    (normalised correlations from about 1 down past 0.84); the open-loop
    pitch at the period or 4 above it (the search's lowest lag); the
    previous frame set up for each activation rule (fresh, keep, track,
    none); nc_ol on both sides of 0.6."""
    rng = np.random.default_rng(seed)
    n12 = 232 + 129
    cols = {k: [] for k in LTPF_ORDER}
    for Q in (32, 33, 60, 126, 127, 128, 156, 157, 158, 200, 227, 228):
        for kind in ("pulse", "tone"):
            for noise in (0.0, 0.15, 0.3, 0.5):
                for off in (0, 4):
                    for rule in ("fresh", "keep", "track", "none"):
                        u = _periodic(kind, Q, n12, int(rng.integers(0, Q)), rng)
                        u = u + rng.standard_normal(n12) * noise * 3000.0
                        cols["mem_in"].append(u[:232])
                        cols["s12k8"].append(u[232:])
                        cols["pitch_ol"].append(min(Q + off, 228))
                        cols["nc_ol"].append(rng.choice([0.59, 0.61, 0.95, 0.95, 0.95]))
                        on, mem_nc, mem_pitch = {
                            "fresh": (0, 0.97, 0.0), "keep": (1, 0.5, Q + 10.0),
                            "track": (1, 0.8, float(Q)), "none": (0, 0.5, 0.0)}[rule]
                        cols["mem_on"].append(on)
                        cols["mem_normcorr"].append(mem_nc)
                        cols["mem_mem_normcorr"].append(rng.uniform(0.9, 1.0))
                        cols["mem_pitch"].append(mem_pitch + rng.choice([0.0, 0.25, 0.5]))
    dt = dict(pitch_ol=np.int32, mem_on=np.int32)
    return {k: np.ascontiguousarray(np.stack(v) if k in ("s12k8", "mem_in") else np.asarray(v),
                                    dt.get(k, np.float32)) for k, v in cols.items()}


def ltpf_branches(args: dict, out, frame_dms: int = 100) -> dict[str, int]:
    """Rows of an ltpf_encode launch in each branch, from its inputs and its
    outputs (param, bits, mem_in, nc, mem_mem_nc, on, pitch): searched or
    not, each activation rule firing alone, the pitch at the window's lowest
    lag (the integer search's first entry and no fraction), in the
    quarter-sample range (step 1), the half-sample range (step 2) and the
    integer range (no fraction), and at each lag limit."""
    f = np.float32
    nc, pitch = np.asarray(out[3]), np.asarray(out[6])
    searched = args["nc_ol"] > f(0.6)
    on, mnc, mmnc = args["mem_on"], args["mem_normcorr"], args["mem_mem_normcorr"]
    fresh = (on == 0) & (nc > f(0.94)) & (mnc > f(0.94))
    if frame_dms != 100:
        fresh &= mmnc > f(0.94)
    keep = (on == 1) & (nc > f(0.9))
    track = ((on == 1) & (np.abs(pitch - args["mem_pitch"]) < 2) & ((nc - mnc) > f(-0.1))
             & (nc > f(0.84)))
    s = searched
    pint = np.floor(pitch).astype(np.int32)
    t0_min = np.maximum(args["pitch_ol"] - 4, 32)
    return {"searched": int(s.sum()), "not searched": int((~s).sum()),
            "fresh alone": int((s & fresh & ~keep & ~track).sum()),
            "keep alone": int((s & keep & ~fresh & ~track).sum()),
            "track alone": int((s & track & ~fresh & ~keep).sum()),
            "lowest lag": int((s & (pitch == t0_min)).sum()),
            "step 1": int((s & (pint < 126)).sum()), "step 2": int((s & (pint >= 128) & (pint < 156)).sum()),
            "no fraction": int((s & (pint >= 158)).sum()),
            "lag 32": int((s & (pint == 32)).sum()), "lag 228": int((s & (pint == 228)).sum())}


NRE_ORDER = ("dy", "xq", "gain", "bw_bin", "target", "nbits2", "lsb_mode")


def nre_rows(cfg, seed: int = 0, n: int = 64) -> dict[str, np.ndarray]:
    """Inputs of noise_residual_enc at this configuration: seeded spectra
    under a falling envelope quantized at gains that leave from most to few
    lines zero, rows with no zero line (kcnt 0), silent rows, one nonzero
    line; the configuration's bandwidths; targets that cut n_res below the
    count of nonzero lines and that leave it there; lsbMode on and off."""
    rng = np.random.default_rng(seed)
    N = cfg.yLen
    env = np.linspace(1.0, 0.05, N)[None]
    dy = rng.standard_normal((n, N)) * env * 10.0 ** rng.uniform(1, 3.5, (n, 1))
    dy[0] = rng.choice([-1.0, 1.0], N) * rng.uniform(5.0, 9.0, N)     # no zero line
    dy[1] = 0.0
    dy[2] = 0.0
    dy[2, N // 3] = 40.0
    # gains from a tenth to ten times the row's level: most to few lines zero
    level = np.abs(dy).mean(-1) + 1.0
    gain = (level * 10.0 ** rng.uniform(-1.0, 1.0, n)).astype(np.float32)
    gain[0] = 1.0
    dy = dy.astype(np.float32)
    q = dy / gain[:, None]
    xq = np.trunc(q + np.float32(0.375) * np.sign(q)).astype(np.int32)
    cut = T.bw_cutoff_bins(cfg.frame_dms)
    bw_bin = cut[rng.integers(0, min(cfg.fs_idx + 1, len(cut)), n)].astype(np.int32)
    bw_bin[:3] = cut[min(cfg.fs_idx, len(cut) - 1)]
    # target - nbits2 + 4 (the bits left for the residual) at or above the
    # count of nonzero lines, below it, and negative, in turn
    n_nz = (xq != 0).sum(-1)
    target = rng.integers(50, 400, n).astype(np.int32)
    left = np.stack([n_nz + rng.integers(0, 20, n), rng.integers(0, n_nz + 1),
                     -rng.integers(1, 30, n)])[np.arange(n) % 3, np.arange(n)]
    nbits2 = target + 4 - left
    return dict(dy=dy, xq=xq, gain=gain, bw_bin=bw_bin, target=target,
                nbits2=nbits2.astype(np.int32), lsb_mode=(rng.random(n) < 0.25).astype(np.int32))


def nre_branches(args: dict, out, cfg) -> dict[str, int]:
    """Rows of a noise_residual_enc launch by branch: no zero line (kcnt 0,
    from the inputs), n_res below and at the count of nonzero lines, and
    lsbMode (n_res 0)."""
    width, start = (3, 24) if cfg.frame_dms == 100 else (1, {50: 12, 25: 6}[cfg.frame_dms])
    xq, bw = np.asarray(args["xq"]), np.asarray(args["bw_bin"])
    B, N = xq.shape
    nz = xq != 0
    inside = np.arange(N)[None] < bw[:, None]
    # nonzero lines below the bandwidth in each window [k - width, k + width]
    cs = np.concatenate([np.zeros((B, 1), int), np.cumsum(
        np.pad(nz & inside, ((0, 0), (width, width))), axis=1)], axis=1)
    win = cs[:, 2 * width + 1: 2 * width + 1 + N] - cs[:, :N]
    kcnt = ((np.arange(N)[None] >= start) & inside & (win == 0)).sum(-1)
    n_res, n_nz = np.asarray(out[2]), nz.sum(-1)
    lsb = args["lsb_mode"] == 1
    return {"kcnt 0": int((kcnt == 0).sum()), "zero lines": int((kcnt > 0).sum()),
            "n_res below nonzero lines": int((~lsb & (n_res < n_nz)).sum()),
            "n_res at nonzero lines": int((~lsb & (n_res == n_nz) & (n_nz > 0)).sum()),
            "lsbMode": int(lsb.sum())}


SPEC_ORDER = ("x", "gain", "bfi", "rframe", "spec_inv_idx", "bw_idx", "fac_ns_idx",
              "residual_present", "res_bits", "n_res", "nf_seed", "zero_frame", "q_old_res",
              "q_old_d", "prev_gg", "prev_bw_idx", "prev_fac_ns", "nb_lost")


def spec_rows(cfg, seed: int = 0, n: int = 96, res_width: int | None = None) -> dict[str, np.ndarray]:
    """Inputs of spec_decode after cfg: decoded integer spectra with runs
    of zero lines; bfi 0, 1 and 2 (spec_inv_idx below and above half the
    lines, so fewer_low both ways); redundancy frames (rframe 1) whose
    bandwidth differs from the previous one (the bandwidth redo) and equals
    it; zero frames; residual present or not with n_res below the count of
    nonzero lines; a previous residual silent below spec_inv_idx (ener_prev
    0), previous spectra louder and quieter than the current (the
    synthesis factor from the gains and from the energies), and previous
    residuals small enough that synthesised lines fall below 0.625."""
    rng = np.random.default_rng(seed)
    N = cfg.yLen
    res_width = res_width or N
    x = np.round(rng.standard_normal((n, N)) * rng.uniform(0.3, 6.0, (n, 1)))
    x *= rng.random((n, N)) < rng.uniform(0.2, 0.9, (n, 1))
    q_old_res = np.round(rng.standard_normal((n, N)) * rng.uniform(0.5, 8.0, (n, 1)))
    q_old_res[::7] *= 0.05                                     # synthesised lines below 0.625
    inv = rng.integers(1, N, n).astype(np.int32)
    q_old_res[3::11, :] = 0.0                                  # ener_prev 0
    q_old_d = rng.standard_normal((n, N)) * rng.uniform(10, 3000, (n, 1))
    q_old_d[::2, : N // 4] *= 20.0                             # a loud low band
    bfi = np.array([0, 1, 2, 2, 2])[np.arange(n) % 5].astype(np.int32)
    rframe = (rng.random(n) < 0.3).astype(np.int32)
    bw_idx = rng.integers(0, cfg.fs_idx + 1, n).astype(np.int32)
    prev_bw = np.where(rng.random(n) < 0.5, bw_idx, rng.integers(0, cfg.fs_idx + 1, n)).astype(np.int32)
    gg = rng.integers(60, 200, n)
    gain = (10.0 ** ((gg + cfg.quantizedGainOff) / 28.0)).astype(np.float32)
    prev_gg = (gain * rng.uniform(0.3, 3.0, n)).astype(np.float32)
    n_nz = (x != 0).sum(-1)
    return dict(
        x=x.astype(np.float32), gain=gain, bfi=bfi, rframe=rframe, spec_inv_idx=inv,
        bw_idx=bw_idx, fac_ns_idx=rng.integers(0, 8, n).astype(np.int32),
        residual_present=(rng.random(n) < 0.7).astype(np.int32),
        res_bits=rng.integers(0, 2, (n, res_width)).astype(np.int32),
        n_res=(n_nz * rng.uniform(0.3, 1.2, n)).astype(np.int32),
        nf_seed=rng.integers(-32768, 32768, n).astype(np.int32),
        zero_frame=(rng.random(n) < 0.15).astype(np.int32),
        q_old_res=q_old_res.astype(np.float32), q_old_d=q_old_d.astype(np.float32),
        prev_gg=prev_gg, prev_bw_idx=prev_bw,
        prev_fac_ns=rng.uniform(0.05, 0.5, n).astype(np.float32),
        nb_lost=rng.integers(0, 4, n).astype(np.int32))


def spec_branches(args: dict, cfg) -> dict[str, int]:
    """Rows of a spec_decode launch in each branch of the concealment and
    reconstruction (float64 from the inputs; the counts only show that a
    branch was reached)."""
    N = cfg.yLen
    a = {k: np.asarray(v) for k, v in args.items()}
    bfi, inv, good = a["bfi"], a["spec_inv_idx"], a["bfi"] != 1
    act = bfi == 2
    low = np.arange(N)[None] < inv[:, None]
    d2, r2, x2 = (a[k].astype(np.float64) ** 2 for k in ("q_old_d", "q_old_res", "x"))
    ml, mh = (d2 * low).sum(-1), (d2 * ~low).sum(-1)
    n_low, n_high = np.maximum(inv, 1), np.maximum(N - inv, 1)
    fewer = inv < N - inv
    mh = np.where(fewer, mh * n_low / n_high, mh)
    ml = np.where(fewer, ml, ml * n_high / n_low)
    ep, ec = (r2 * low).sum(-1), (x2 * low).sum(-1)
    fac = np.where(ep > 0, np.sqrt(np.minimum(ec / np.maximum(ep, 1e-30), 1.0)), 1.0)
    gains = (ml <= mh) | (ep * a["prev_gg"].astype(np.float64) ** 2 <= ec * a["gain"].astype(np.float64) ** 2)
    fl = np.where(gains, a["prev_gg"] / a["gain"], fac)
    syn = np.abs(a["q_old_res"] * fl[:, None])
    small = ((syn < 0.625) & (a["q_old_res"] != 0) & ~low).any(-1)
    redo = good & (a["rframe"] != 0) & act & (a["bw_idx"] != a["prev_bw_idx"]) & (inv < N)
    return {"bfi 0": int((bfi == 0).sum()), "bfi 1": int((bfi == 1).sum()),
            "bfi 2": int(act.sum()), "fewer low": int((act & fewer).sum()),
            "more low": int((act & ~fewer).sum()), "ener_prev 0": int((act & (ep == 0)).sum()),
            "factor from the gains": int((act & gains).sum()),
            "factor from the energies": int((act & ~gains).sum()),
            "synthesised below 0.625": int((act & small).sum()),
            "bandwidth redo": int(redo.sum()),
            "zero frame": int((good & (a["zero_frame"] == 1)).sum()),
            "residual": int((good & (a["residual_present"] == 1)).sum())}


# ---- the channel coder (slice 6) ----

# the channel's error classes, in the order of channel_errors' kinds
CHANNEL_KINDS = ("clean", "correctable", "pc_codeword", "heavy", "lost", "redundancy")
FEC_SLOTS = (40, 80, 150, 300)


def _codeword_nibbles(frames: np.ndarray, slot: int) -> np.ndarray:
    """[B, slot] bytes -> [B, 2*slot] nibbles in codeword-stream order."""
    from audio_codec_torch.ops import fec
    nib = np.stack([frames & 15, frames >> 4], -1).reshape(frames.shape[0], -1)
    return nib[:, fec._slot_plan(slot)["il_dst"]]


def _frames_of(cws: np.ndarray, slot: int) -> np.ndarray:
    from audio_codec_torch.ops import fec
    nib = cws[:, np.argsort(fec._slot_plan(slot)["il_dst"])]
    return (nib[:, 0::2] | (nib[:, 1::2] << 4)).astype(np.int32)


def channel_errors(frames: np.ndarray, slot: int, mode: int, kinds: np.ndarray,
                   rng) -> np.ndarray:
    """The frames after the channel: each row by its kind (an index into
    CHANNEL_KINDS). "correctable" changes at most t = mode - 1 nibbles (one
    for EP1) in each of one to four codewords; "pc_codeword" destroys the last
    codeword beyond correction (a partial-concealment codeword at EP3/EP4 in
    a slot of 80 bytes or more, tests/test_fec.py:137-170); "heavy" XORs
    random bytes over the whole slot; "lost" and "redundancy" leave the
    bytes as they are (the caller flags them with bfi 1 and 3)."""
    from audio_codec_torch.ops import fec
    sp = fec._slot_plan(slot)
    cws = _codeword_nibbles(np.asarray(frames, np.int64), slot)
    out = np.asarray(frames, np.int32).copy()
    t = max(mode - 1, 1)
    for b, kind in enumerate(np.asarray(kinds)):
        name = CHANNEL_KINDS[kind]
        if name == "correctable":
            row = cws[b].copy()
            for i in rng.choice(sp["ncw"], size=int(rng.integers(1, 5)), replace=False):
                pos = rng.choice(sp["lens"][i], size=t, replace=False)
                row[sp["offs"][i] + pos] ^= rng.integers(1, 16, size=t)
            out[b] = _frames_of(row[None], slot)[0]
        elif name == "pc_codeword":
            row = cws[b].copy()
            i = sp["ncw"] - 1
            row[sp["offs"][i]: sp["offs"][i] + sp["lens"][i]] ^= rng.integers(
                1, 16, size=sp["lens"][i])
            out[b] = _frames_of(row[None], slot)[0]
        elif name == "heavy":
            out[b] ^= rng.integers(1, 256, size=slot).astype(np.int32)
    return out


def fec_rows(slot: int, mode: int, ccc: int, seed: int = 0, n: int = 48):
    """Payloads, EPMR (0..3, each present) and channel kinds (clean,
    correctable, pc_codeword, heavy in turn) of one (slot, mode, ccc), with
    bfi_in 1 on every sixth row. Returns (data, epmr, kinds, bfi_in)."""
    from audio_codec_torch.ops import fec
    rng = np.random.default_rng(seed + 1000 * slot + 10 * mode + ccc)
    D = fec.fec_get_data_size(mode, ccc, slot)
    data = rng.integers(0, 256, (n, D)).astype(np.int32)
    epmr = (np.arange(n) % 4).astype(np.int32)
    kinds = (np.arange(n) // 4 % 4).astype(np.int32)
    bfi_in = np.where(np.arange(n) % 6 == 5, 1, 0).astype(np.int32)
    return data, epmr, kinds, bfi_in


def wrong_mode_rows(slot: int = 80, n: int = 4, seed: int = 0) -> np.ndarray:
    """EP2 frames with three changed nibbles in codeword 0 that the decoder
    reads as another mode, whose CRC then fails (bfi 1, mode 3 or 4): found
    by a seeded search with the plain decoder."""
    import torch
    from audio_codec_torch.ops import fec
    rng = np.random.default_rng(seed)
    sp = fec._slot_plan(slot)
    D = fec.fec_get_data_size(2, 0, slot)
    found = []
    while len(found) < n:
        data = rng.integers(0, 256, (256, D)).astype(np.int32)
        enc = fec.fec_encode_plain(torch.from_numpy(data), torch.zeros(256, dtype=torch.int32),
                                   slot, 2).numpy()
        cws = _codeword_nibbles(enc.astype(np.int64), slot)
        for b in range(256):
            pos = rng.choice(sp["lens"][0], size=3, replace=False)
            cws[b, pos] ^= rng.integers(1, 16, size=3)
        frames = _frames_of(cws, slot)
        out = fec.fec_decode_plain(torch.from_numpy(frames), slot)
        hit = (out["mode"].numpy() > 2) & (out["bfi"].numpy() == 1)
        found.extend(frames[hit][: n - len(found)])
    return np.stack(found).astype(np.int32)


def epmr_risk_rows(slot: int = 80, n: int = 8, seed: int = 0) -> np.ndarray:
    """EP2 frames with one corrected nibble in codeword 1 and two changed
    nibbles in codeword 6 (beyond correction, not a partial-concealment
    codeword): the frame is lost (bfi 1) and its EPMR is the corrected
    path's, raised by the risk of codeword 0 (al_fec.c:1359-1370)."""
    import torch
    from audio_codec_torch.ops import fec
    rng = np.random.default_rng(seed)
    sp = fec._slot_plan(slot)
    D = fec.fec_get_data_size(2, 0, slot)
    data = rng.integers(0, 256, (n, D)).astype(np.int32)
    epmr = (np.arange(n) % 4).astype(np.int32)
    enc = fec.fec_encode_plain(torch.from_numpy(data), torch.from_numpy(epmr), slot, 2).numpy()
    cws = _codeword_nibbles(enc.astype(np.int64), slot)
    for b in range(n):
        cws[b, sp["offs"][1] + rng.integers(0, sp["lens"][1])] ^= rng.integers(1, 16)
        pos = rng.choice(sp["lens"][6], size=2, replace=False)
        cws[b, sp["offs"][6] + pos] ^= rng.integers(1, 16, size=2)
    return _frames_of(cws, slot)


PC_EP_MODES = (3, 4)


@functools.cache
def core_frames(epmode: int, frames: int = 2, streams: int = 6, seed: int = 0) -> np.ndarray:
    """Core payloads of seeded tones and noise through the port's encoder on
    the CPU at 48 kHz, 64 kbps and EP mode epmode (an 80-byte slot), in the
    encoder's (logical) byte order. Returns [frames*streams, targetBytes]."""
    import torch
    import audio_codec_torch as P
    cfg = P.Config(fs_in=48000, bitrate=64000, epmode=epmode)
    rng = np.random.default_rng(seed + epmode)
    n = cfg.frame_length
    k = np.arange(frames * n)
    pcm = np.stack([np.sin(2 * np.pi * (200 + 300 * s) * k / 48000) * 8000 * (1 + s % 3)
                    + rng.standard_normal(k.size) * 300 * (s + 1) for s in range(streams)])
    pcm = pcm.reshape(streams, frames, n).transpose(1, 0, 2).astype(np.float32)
    st = P.enc_state_init(cfg, streams, device="cpu")
    out = []
    for f in range(frames):
        st, pay, _ = P.encode_frame(cfg, st, torch.from_numpy(pcm[f]))
        out.append(pay.to(torch.int32).numpy())
    return np.concatenate(out).astype(np.int32)


def pc_frames(epmode: int, seed: int = 0) -> np.ndarray:
    """core_frames with a partial-concealment block as the channel coder
    carries them, each moved by the encoder's PC simulation
    (engine.reorder_payload); every third row is random bytes."""
    import torch
    import audio_codec_torch as P
    from audio_codec_torch import engine
    cfg = P.Config(fs_in=48000, bitrate=64000, epmode=epmode)
    buf = torch.from_numpy(core_frames(epmode, seed=seed))
    buf = engine.reorder_payload(buf, engine.b_left_step(cfg, buf), cfg.n_pc).numpy()
    buf[2::3] = np.random.default_rng(seed).integers(0, 256, buf[2::3].shape)
    return buf.astype(np.int32)


def pc_decode_rows(epmode: int, seed: int = 0) -> dict[str, np.ndarray]:
    """pc_frames with the channel's flags: bfi_in 0 or 2 in turn, and for
    the bfi 2 rows corrupt bit ranges from the first byte of the PC block,
    from its middle, a single byte and the whole block."""
    import audio_codec_torch as P
    cfg = P.Config(fs_in=48000, bitrate=64000, epmode=epmode)
    frames = pc_frames(epmode, seed=seed)
    L = frames.shape[0]
    pcb = (cfg.n_pc + 1) >> 1
    spans = [(0, 8 * pcb - 1), (4 * pcb, 8 * pcb - 1), (8, 15), (0, 7)]
    bfi_in = np.where(np.arange(L) % 2 == 1, 2, 0).astype(np.int32)
    be_l = np.array([spans[i // 2 % 4][0] for i in range(L)], np.int32)
    be_r = np.array([spans[i // 2 % 4][1] for i in range(L)], np.int32)
    return dict(frames=frames, bfi_in=bfi_in, be_l=np.where(bfi_in == 2, be_l, -1),
                be_r=np.where(bfi_in == 2, be_r, -1))


def stream_plan(T: int, B: int) -> tuple[np.ndarray, np.ndarray]:
    """The channel of a stream-engine run: per frame and stream a kind
    (clean, correctable, pc_codeword, heavy in turn) and per frame a bfi for
    the whole frame (frame 3 lost, frame 4 a redundancy frame)."""
    kinds = (np.arange(T)[:, None] + np.arange(B)[None, :]) % 4
    frame_bfi = np.array([{3: 1, 4: 3}.get(f, 0) for f in range(T)], np.int32)
    return kinds.astype(np.int32), frame_bfi


def encode_stream(enc, pcm: np.ndarray, epmode_at: dict | None = None,
                  trigger_at: tuple = ()) -> list[list[bytes]]:
    """Frames of a StreamEncoder (either package's) over pcm [T, B, n]:
    epmode_at {frame: mode} switches the EP mode before a frame, and the
    frames in trigger_at are -ept PLC trigger frames."""
    out = []
    for f in range(pcm.shape[0]):
        if epmode_at and f in epmode_at:
            enc.set_ep_mode(epmode_at[f])
        out.append(enc.encode_plc_trigger() if f in trigger_at else enc.encode(pcm[f]))
    return out


def channel(frames: list[list[bytes]], slot_of, kinds: np.ndarray, seed: int = 0) -> list[bytes]:
    """Each frame's payload after the channel (stream_plan's kinds; no error
    where slot_of(frame) is 0, the core payloads of EP mode 0)."""
    rng = np.random.default_rng(seed)
    out = []
    for f, pay in enumerate(frames):
        rows = np.stack([np.frombuffer(p, np.uint8) for p in pay]).astype(np.int32)
        slot, mode = slot_of(f)
        if mode:
            rows = channel_errors(rows, slot, mode, kinds[f, : rows.shape[0]], rng)
        out.append(rows.astype(np.uint8).tobytes())
    return out


def decode_stream(dec, payloads: list[bytes], frame_bfi: np.ndarray) -> np.ndarray:
    """A StreamDecoder (either package's) over the payloads; returns int32
    [T, B, n + 2 + B]: the PCM, then last_bfi, then the EPMR and the error
    report per lane."""
    out = []
    for f, p in enumerate(payloads):
        pcm = np.asarray(dec.decode(p, int(frame_bfi[f]))).astype(np.int32)
        extra = np.stack([np.asarray(dec.last_bfi), np.full(pcm.shape[0], dec.epmr),
                          np.resize(np.asarray(dec.error_report), pcm.shape[0])], 1)
        out.append(np.concatenate([pcm, extra.astype(np.int32)], 1))
    return np.stack(out)


# ---------------------------------------------------------------------------
# advanced concealment (plc_mode 1) at the flagship point: 48 kHz, 10 ms
# ---------------------------------------------------------------------------

PLC_HIST = 1335      # plc_adv.pcm_hist_len: max pitch 855 + a frame
PLC_MAX_PITCH = 855
# per group, four lanes of TD-PLC: (nb_lost, fract, stab_fac, active)
TDC_LANES = {
    0: ((1, 0, 0.3, True), (1, 2, 0.6, True), (2, 0, 0.5, True), (1, 1, 0.2, False)),
    1: ((3, 0, 0.4, True), (4, 3, 0.7, True), (1, 0, 1.0, True), (6, 0, 0.9, True)),
    2: ((7, 0, 0.5, True), (8, 1, 0.1, True), (1, 3, 1.0, True), (5, 0, 0.8, False)),
}


def _history(rng, kind: str, n: int, period: int = 300) -> np.ndarray:
    t = np.arange(n)
    if kind == "voiced":      # a pulse train of the given period through a resonance
        phase = (t % period) / period
        x = np.exp(-phase * 8.0) * 8000.0 * np.sin(2 * np.pi * 300 * (t % period) / 48000.0)
    elif kind == "tones":     # high harmonics
        f0 = rng.uniform(300, 500)
        x = sum(2000.0 / k * np.sin(2 * np.pi * f0 * k * t / 48000.0 + rng.uniform(0, 6))
                for k in range(1, 12))
    else:
        x = rng.standard_normal(n) * 2000.0
    return (x + rng.standard_normal(n) * 20.0).astype(np.float32)


def plc_adv_rows(group: int = 0) -> dict[str, np.ndarray]:
    """Four lanes of the classifier and of TD-PLC (TDC_LANES[group]): PCM
    histories (voiced, high tones, noise), scale factors of low and high
    spectral centroid, lags with and without a pitch, and the TD-PLC state."""
    rng = np.random.default_rng(100 + group)
    B = 4
    kinds = ("voiced", "tones", "voiced", "noise")
    pitch = rng.integers(120, 600, B).astype(np.int32)
    pitch[3] = 0
    x = np.stack([_history(rng, k, PLC_HIST, max(int(p), 1)) for k, p in zip(kinds, pitch)])
    tilt = np.linspace(1.0, -1.0, 16)
    scf = np.stack([8 * tilt, -4 * tilt, 3 * tilt, rng.standard_normal(16)]).astype(np.float32)
    scf += rng.standard_normal((B, 16)).astype(np.float32) * 0.2
    lanes = TDC_LANES[group]
    q = (rng.standard_normal((B, 400)) * 300).astype(np.float32)
    q[:, 160:] *= 0.02
    return dict(
        x_old_tot=x, scf=scf, pitch=pitch,
        pitch_t=rng.integers(120, PLC_MAX_PITCH, B).astype(np.int32),   # TD-PLC lanes: all pitched
        q_d=q,
        nb=np.array([v[0] for v in lanes], np.int32),
        fract=np.array([v[1] for v in lanes], np.int32),
        stab=np.array([v[2] for v in lanes], np.float32),
        active=np.array([v[3] for v in lanes], bool),
        seed=rng.integers(-32768, 32768, B).astype(np.int32),
        gain_c=(rng.random(B) * 300).astype(np.float32),
        alpha=(rng.random(B) * 0.5 + 0.5).astype(np.float32),
        harm=(rng.standard_normal((B, PLC_MAX_PITCH)) * 200).astype(np.float32),
        synth_hist=(rng.standard_normal((B, 16)) * 200).astype(np.float32),
        harm_len=rng.integers(120, PLC_MAX_PITCH, B).astype(np.int32))


# per group, four lanes of damping: (nb_lost, scramble, active, pitch, spec_inv_idx)
DAMP_LANES = {
    0: ((1, True, True, 1, 0), (2, True, True, 0, 0), (4, True, True, 1, 0), (3, False, True, 1, 0)),
    1: ((1, True, True, 1, 120), (7, True, True, 0, 0), (2, True, True, 1, 399), (1, False, False, 0, 50)),
}


def damping_rows(group: int = 0) -> dict[str, np.ndarray]:
    """Four lanes of noise substitution and damping (DAMP_LANES[group]): a
    decaying spectrum with one outlier, lanes lost (spec_inv_idx 0) and
    partially concealed (above 0), with and without pitch."""
    rng = np.random.default_rng(200 + group)
    B = 4
    lanes = DAMP_LANES[group]
    spec = (rng.standard_normal((B, 400)) * 300).astype(np.float32)
    spec[:, 150:] *= 0.05
    spec[1, 20] = 9000.0
    return dict(
        spec=spec, nb=np.array([v[0] for v in lanes], np.int32),
        stab=(rng.random(B)).astype(np.float32),
        scramble=np.array([v[1] for v in lanes], bool),
        active=np.array([v[2] for v in lanes], bool),
        pitch_present=np.array([v[3] for v in lanes], np.int32),
        inv=np.array([v[4] for v in lanes], np.int32),
        cum_fflc=(rng.random(B)).astype(np.float32), cum_slow=(rng.random(B)).astype(np.float32),
        cum_fast=(rng.random(B)).astype(np.float32),
        seed=rng.integers(-32768, 32768, B).astype(np.int32))


PHECU_LPROT = 768    # plc_phecu.lprot at 48 kHz
PHECU_BINS = 321     # plc_phecu.search_bins


def phecu_history(seed: int = 0, B: int = 4) -> np.ndarray:
    """[B, PLC_HIST] PCM histories for the Phase ECU: two tones, a chord of
    high harmonics, seeded noise and a single tone (few peaks)."""
    rng = np.random.default_rng(300 + seed)
    t = np.arange(PLC_HIST)
    rows = [3000 * np.sin(2 * np.pi * 1000.3 * t / 48000) + 2000 * np.sin(2 * np.pi * 3100 * t / 48000),
            _history(rng, "tones", PLC_HIST),
            rng.standard_normal(PLC_HIST) * 1500.0,
            6000 * np.sin(2 * np.pi * 2500.7 * t / 48000 + rng.uniform(0, 6))]
    return np.stack([rows[b % 4] + rng.standard_normal(PLC_HIST) * 5.0 for b in range(B)]).astype(np.float32)


def phecu_peak_rows(seed: int = 0, B: int = 8) -> dict[str, np.ndarray]:
    """Spectra [B, PHECU_BINS] (real, imag) for the peak analysis: the
    windowed spectra of phecu_history's rows and synthetic ones that reach
    the peak-dense drop rule (many peaks, weak correlation), one peak, and
    two, one of them a flat top of two bins."""
    rng = np.random.default_rng(400 + seed)
    hist = phecu_history(seed, 4)
    lp = PHECU_LPROT
    h2 = 144
    ham = 0.54 - 0.46 * np.cos(2.0 * np.pi * np.arange(2 * h2) / (2 * h2 - 1))
    win = np.concatenate([ham[:h2], np.ones(lp - 2 * h2), ham[h2:]])
    X = np.fft.rfft(hist[:, -lp:] * win, n=lp)[:, :PHECU_BINS]
    dense = np.zeros((2, PHECU_BINS), np.complex128)
    for r in range(2):
        for k in range(3, PHECU_BINS - 3, 9):          # a comb: ~35 peaks
            dense[r, k] = 4e4 * np.exp(1j * rng.uniform(0, 6))
        dense[r] += (rng.standard_normal(PHECU_BINS) + 1j * rng.standard_normal(PHECU_BINS)) * 50
    few = np.zeros((2, PHECU_BINS), np.complex128)
    few[0, 40] = 1e5
    few[1, 40], few[1, 90] = 1e5, 6e4
    few += (rng.standard_normal((2, PHECU_BINS)) + 1j * rng.standard_normal((2, PHECU_BINS))) * 10
    few[1, 90] = few[1, 91] = 6e4      # a flat top: the later bin of equal magnitude is the peak
    allX = np.concatenate([X, dense, few])[:B]
    nc = np.array([0.9, 0.8, 0.2, 0.95, 0.3, 0.0, 0.6, 0.7], np.float32)[:B]
    return dict(Xr=allX.real.astype(np.float32), Xi=allX.imag.astype(np.float32), nc=nc)


# per lane of plc_damp_scramble: (ns_lane, lost, is_pc, nb_cur, pc_nb_lost,
# pitch_int, pc_pitch, spec_inv_idx)
DAMP_STREAM_LANES = (
    (1, 1, 0, 1, 0, 300, 0, 400),    # noise substitution, first loss, pitched
    (1, 1, 0, 3, 0, 0, 0, 400),      # noise substitution, third loss, no pitch
    (1, 1, 0, 8, 0, 200, 1, 400),    # past the fade-out
    (0, 1, 0, 2, 0, 300, 0, 400),    # TD-PLC or Phase ECU lane: factors only
    (0, 0, 1, 0, 1, 250, 1, 120),    # partially concealed, pitched
    (0, 0, 1, 0, 3, 0, 0, 0),        # partially concealed from bin 0
    (0, 0, 1, 0, 2, 100, 1, 399),    # partially concealed, last bin only
    (0, 0, 0, 0, 0, 150, 1, 400),    # clean
)
DAMP_STREAM_INTS = ("ns_lane", "lost", "is_pc", "nb_cur", "pc_nb_lost", "pitch_int", "pc_pitch",
                    "spec_inv_idx")


def damp_stream_rows(seed: int = 0) -> dict[str, np.ndarray]:
    """Eight lanes of plc_damp_scramble (DAMP_STREAM_LANES): spectra, the
    last good one, the factors and both seeds."""
    rng = np.random.default_rng(600 + seed)
    B, N = len(DAMP_STREAM_LANES), 400
    cols = np.array(DAMP_STREAM_LANES, np.int32).T
    out = {k: cols[i].copy() for i, k in enumerate(DAMP_STREAM_INTS)}
    x = (rng.standard_normal((B, N)) * 300).astype(np.float32)
    x[:, 150:] *= 0.05
    q = (rng.standard_normal((B, N)) * 300).astype(np.float32)
    q[:, 150:] *= 0.05
    q[0, 30] = 8000.0
    out.update(x=x, q_d_prev=q, stab_fac=rng.random(B).astype(np.float32),
               cum_fflc=rng.random(B).astype(np.float32), cum_slow=rng.random(B).astype(np.float32),
               cum_fast=rng.random(B).astype(np.float32),
               ns_seed=rng.integers(-32768, 32768, B).astype(np.int32),
               pc_seed=rng.integers(-32768, 32768, B).astype(np.int32))
    out["stab_fac"][1] = 1.0
    return out


def phecu_subst_rows(seed: int = 0) -> dict[str, np.ndarray]:
    """Inputs of phecu_subst over the eight spectra of phecu_peak_rows
    (padded to 385 bins): the peak rows from `peaks` (f0est, num_plocs), a
    burst of 1, 2, 3, 4, 6, 1, 2, 9 frames, transient and inactive lanes,
    and peak counts of 0, 1 and 2."""
    rng = np.random.default_rng(700 + seed)
    r = phecu_peak_rows(seed)
    B = r["Xr"].shape[0]
    pad = lambda a: np.concatenate([a, np.zeros((B, 385 - a.shape[1]), np.float32)], 1)
    Xr, Xi = pad(r["Xr"]), pad(r["Xi"])
    Xr[:, 384] = rng.standard_normal(B).astype(np.float32) * 100
    e = (np.abs(rng.standard_normal((2, B, 9))) * 1e8).astype(np.float32)
    e[0, 2] *= 20.0                      # a falling transient
    return dict(Xr=Xr, Xi=Xi, nb_cur=np.array([1, 2, 3, 4, 6, 1, 2, 9], np.int32)[:B],
                e_oold=e[0], e_old=e[1],
                mag_chg_1st=(rng.random((B, 9)) * 1.2).astype(np.float32),
                beta_mute=rng.random(B).astype(np.float32),
                xavg=(rng.random((B, 9)) * 300).astype(np.float32),
                is_trans=np.array([0, 0, 0, 0, 1, 0, 0, 0], np.int32)[:B],
                active=np.array([1, 1, 1, 1, 1, 1, 0, 1], np.int32)[:B])


def tdc_stream_rows(group: int) -> dict[str, np.ndarray]:
    """plc_adv_rows with the state of plc_tdc: lanes lost and not, first
    losses and later ones, a method kept from the burst (a_st, fract_st:
    the LPC and pitch fraction kept from it)."""
    d = dict(plc_adv_rows(group))
    rng = np.random.default_rng(group)
    d["lost"] = (d["nb"] > 0) & np.array([True, True, True, group != 1])
    d["meth"] = np.array([3, 3, 4, 3], np.int32)
    d["a_st"] = rng.standard_normal((4, 17)).astype(np.float32)
    d["fract_st"] = np.array([1, 0, 2, 3], np.int32)
    return d


# ---- the bit-exact fixed-point decoder (fx_sns_dec, fx_spec_decode,
# fx_dct4, fx_ola_ltpf) ----

MPVQ_6K1 = 6        # the 6-dim set of submode 0 (1 + 5 + 0 indices)


def fx_sns_rows(n_per: int = 24, seed: int = 0) -> np.ndarray:
    """[4 n_per + 10, 7] int32 SNS indices: scf_idx_grid of every submode,
    both leading signs in each, then rows whose MPVQ index is out of its
    set (the `ber` lanes, which de-index 0): two of each submode past its
    main set, two of submode 0 past its 6-dim set."""
    rows = []
    for s in range(4):
        g = scf_idx_grid(s, n_per, seed)
        g[:, 4] = np.arange(n_per) % 2
        rows.append(g)
    for s in range(4):
        g = scf_idx_grid(s, 2, seed + 7)
        g[:, 5] = SUBMODES[s][1] + np.array([0, 123457])
        rows.append(g)
    g = scf_idx_grid(0, 2, seed + 8)
    g[:, 6] = 2 * MPVQ_6K1 + np.array([0, 1])
    rows.append(g)
    return np.concatenate(rows).astype(np.int32)


def fx_spec_rows(cfg, seed: int = 0, n: int = 48) -> dict[str, np.ndarray]:
    """Inputs of fx_spec_decode: sparse spectra of several levels, silent rows
    (noise filled, and zero frames), full-scale rows (+-32767), rows with TNS
    filters of order 8 in both ranges (bandwidth index 4), every bandwidth
    index, residual bits, and the SNS indices of fx_sns_rows (decode them for
    scf, scf_e)."""
    rng = np.random.default_rng(800 + seed)
    N = cfg.yLen
    R = min(N, cfg.targetBytes * 8)
    mag = np.floor(rng.laplace(0, 1, (n, N)) * 10 ** rng.uniform(0, 3, (n, 1)))
    keep = rng.random((n, N)) < rng.uniform(0.05, 0.9, (n, 1))
    x = np.clip(mag * keep, -32767, 32767)
    x[:, 200:] *= rng.random((n, 1)) < 0.5          # some rows silent above bin 200
    x[0:4] = 0                                       # silent rows
    x[4:8] = 32767 * np.where(rng.random((4, N)) < 0.5, -1, 1)
    zero_frame = np.zeros(n, np.int32)
    zero_frame[0:2] = 1
    order = rng.integers(0, 9, (n, 2))
    order[8:16] = 8
    bw = rng.integers(0, 5, n)
    bw[8:16] = 4
    sns = fx_sns_rows(12, seed)
    return dict(x=x.astype(np.int32), res_bits=rng.integers(0, 2, (n, R)).astype(np.int32),
                n_res=rng.integers(0, R + 1, n).astype(np.int32),
                nf_seed=rng.integers(0, 65536, n).astype(np.int32), zero_frame=zero_frame,
                fac_ns_idx=rng.integers(0, 8, n).astype(np.int32), bw_idx=bw.astype(np.int32),
                gg_idx=rng.integers(0, 256, n).astype(np.int32),
                tns_idx=rng.integers(0, 17, (n, 2, 8)).astype(np.int32),
                tns_order=order.astype(np.int32), scf_idx=sns[rng.integers(0, len(sns), n)])


FX_SPEC_ORDER = ("x", "res_bits", "n_res", "nf_seed", "zero_frame", "fac_ns_idx", "bw_idx",
                 "gg_idx", "tns_idx", "tns_order")


def fx_dct4_rows(seed: int = 0, n: int = 16) -> tuple[np.ndarray, np.ndarray]:
    """(y [n + 6, 480] int64, y_e [n + 6]): an all-zero row, rows of
    2^31 - 1 and of -(2^31 - 1), two alternating full-scale rows, a row
    nonzero only above the 400-bin cap, and seeded rows of several levels."""
    rng = np.random.default_rng(900 + seed)
    M = (1 << 31) - 1
    alt = np.where(np.arange(480) % 2 == 0, M, -M)
    special = np.stack([np.zeros(480), np.full(480, M), np.full(480, -M), alt, -alt,
                        np.where(np.arange(480) >= 400, 12345, 0)])
    mag = rng.laplace(0, 1, (n, 480)) * 2.0 ** rng.integers(4, 31, (n, 1))
    y = np.concatenate([special, np.clip(np.floor(mag), -M - 1, M)]).astype(np.int64)
    y_e = rng.integers(-12, 30, len(y)).astype(np.int64)
    return y, y_e


LTPF_PLAN = ("passthrough", "pat2", "pat3", "pat4", "pat1")


def _norm_l(v: np.ndarray) -> np.ndarray:
    m = np.where(v < 0, ~v, v)
    bl = np.array([int(a).bit_length() for a in m.ravel()]).reshape(v.shape)
    return np.where(v == 0, 0, 31 - bl)


def fx_ola_plan(B: int = 8, seed: int = 0) -> dict[str, np.ndarray]:
    """Five frames of fx_ola_ltpf inputs that walk every stream through the
    passthrough, pat2 (LTPF switched on), pat3 (same pitch), pat4 (a new
    pitch: the crossfade) and pat1 (switched off). Pitch indices from all
    three of the decoder's ranges; seeded frames at several levels and
    exponents (the passthrough's history shifts both ways), an all-zero
    frame in some streams. Keys: ytda [5, B, 480], y_e, y_s [5, B] int64,
    zero [5, B] bool, lp [5, B, 3] int32 (the LTPF side words: on, active,
    pitch index)."""
    rng = np.random.default_rng(1000 + seed)
    T, N = len(LTPF_PLAN), 480
    mag = rng.laplace(0, 1, (T, B, N)) * 2.0 ** rng.integers(10, 29, (T, B, 1))
    ytda = np.clip(np.floor(mag), -(1 << 31), (1 << 31) - 1).astype(np.int64)
    zero = np.zeros((T, B), bool)
    zero[2, ::3] = True
    ytda[zero] = 0
    nz = np.where(ytda != 0, _norm_l(ytda), 32).min(axis=2)
    y_s = np.where(zero, 31, nz - 1).astype(np.int64)
    y_e = rng.integers(-20, 21, (T, B)).astype(np.int64)
    y_e[0, :2] = (-20, 20)        # the passthrough's history shifts by more than 15 both ways
    ranges = [(0, 380), (380, 440), (440, 512)]
    pa = np.array([rng.integers(*ranges[b % 3]) for b in range(B)])
    pb = np.array([rng.integers(*ranges[(b + 1) % 3]) for b in range(B)])
    lp = np.zeros((T, B, 3), np.int32)
    lp[1:4, :, 0] = 1
    lp[1:4, :, 1] = 1
    lp[1, :, 2] = lp[2, :, 2] = pa
    lp[3, :, 2] = pb
    lp[4, :, 0] = np.arange(B) % 2           # switched off: with and without a pitch
    lp[4, :, 2] = np.where(np.arange(B) % 2 == 1, pb, 0)
    return dict(ytda=ytda, y_e=y_e, y_s=y_s, zero=zero, lp=lp)


# ---- the standard concealment (plc_mode 0, plc_main) ----

PLC_MAIN_ORDER = ("spec", "q_d_prev", "bfi", "nb_lost", "cum_alpha", "seed")
# the lost-frame counts before the frame that put each lane in a damping branch
PLC_MAIN_NB = (0, 2, 3, 6, 7, 11)
PLC_MAIN_SEEDS = (-32768, 32767, 32768, -1, 0, 24607)


def plc_main_rows(seed: int = 0, N: int = 400) -> dict[str, np.ndarray]:
    """Rows of the standard concealment: lost lanes (bfi 1) at every damping
    branch (the counter crossing 4 and 8) and at the generator's edge seeds
    (-32768, 32767 and 32768, which the generator takes as -32768),
    partially concealed (bfi 2) and clean lanes, spectra with zeros and
    signed zeros, a silent history."""
    rng = np.random.default_rng(seed)
    rows = [(bfi, nb, sd) for bfi in (1, 0, 2) for nb in PLC_MAIN_NB for sd in PLC_MAIN_SEEDS[:3]]
    rows += [(1, int(rng.integers(0, 20)), int(rng.integers(-32768, 32768))) for _ in range(12)]
    B = len(rows)
    spec = (rng.standard_normal((B, N)) * 3000).astype(np.float32)
    q = (rng.standard_normal((B, N)) * 3000).astype(np.float32)
    spec[:, ::17] = 0.0
    q[:, 5::19] = -0.0
    q[3] = 0.0
    return dict(spec=spec, q_d_prev=q,
                bfi=np.array([r[0] for r in rows], np.int32),
                nb_lost=np.array([r[1] for r in rows], np.int32),
                cum_alpha=rng.uniform(0.2, 1.0, B).astype(np.float32),
                seed=np.array([r[2] for r in rows], np.int32))


def plc_main_branches(bfi, nb_lost) -> dict[str, int]:
    """Stream-frames of plc_main's branches: the clean copy (bfi 0), the
    partially concealed copy (bfi 2) and the lost lanes at each damping
    factor (from the counter after the frame)."""
    bfi, nb = np.asarray(bfi), np.asarray(nb_lost) + 1
    lost = bfi == 1
    return {"clean": int((bfi == 0).sum()), "bfi 2": int((bfi == 2).sum()),
            "alpha 1": int((lost & (nb < 4)).sum()),
            "alpha 0.9": int((lost & (nb >= 4) & (nb < 8)).sum()),
            "alpha 0.85": int((lost & (nb >= 8)).sum())}


# ---- launches against their plain versions (chip_smoke.py, the GPU tests) ----

@contextlib.contextmanager
def recording(store: dict, names=None, copy: bool = False):
    """Keep the arguments of every kernel launch (of the named kernels; all
    by default), in order, as (args, kwargs) in store[kernel name]; with
    copy, copies of the tensors (a kernel that updates its state in place,
    fx_ola_ltpf)."""
    import torch
    from audio_codec_torch import kernels as K
    saved = {n: getattr(K, n) for n in (names or K.KERNELS)}

    def cp(v):
        if isinstance(v, torch.Tensor):
            return v.clone()
        return {k: cp(u) for k, u in v.items()} if isinstance(v, dict) else v

    def wrap(name, fn):
        def rec(*args, **kw):
            store.setdefault(name, []).append(([cp(a) for a in args] if copy else args, kw))
            return fn(*args, **kw)
        return rec
    for n, fn in saved.items():
        setattr(K, n, wrap(n, fn))
    try:
        yield
    finally:
        for n, fn in saved.items():
            setattr(K, n, fn)


def fixed_plain(name: str):
    """The plain version of a fixed-point kernel."""
    from audio_codec_torch.ops import fixed_dev, fixed_ltpf_dev
    return {"fx_sns_dec": fixed_dev.sns_decode_plain,
            "fx_spec_decode": fixed_dev.spectrum_decode_plain,
            "fx_dct4": fixed_dev.batch_dct4_plain, "fx_ola_ltpf": fixed_ltpf_dev.ola_ltpf_plain}[name]


def fixed_pair(K, name: str, args) -> tuple[list, list]:
    """One launch of a fixed-point kernel and one call of its plain version
    on the same arguments: (the kernel's outputs, the plain outputs), each a
    list of tensors. fx_ola_ltpf updates its state in place: each runs on
    its own copy, and the stepped state follows the PCM."""
    def listed(res):
        return list(res) if isinstance(res, tuple) else [res]
    if name == "fx_ola_ltpf":
        cfg, st, *rest = args
        s_k, s_p = ({k: v.clone() for k, v in st.items()} for _ in range(2))
        return ([K.fx_ola_ltpf(cfg, s_k, *rest), *s_k.values()],
                [fixed_plain(name)(cfg, s_p, *rest), *s_p.values()])
    return listed(getattr(K, name)(*args)), listed(fixed_plain(name)(*args))
