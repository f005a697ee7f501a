"""Synthetic inputs of the kernels that force what seeded material may not
reach: every SNS submode, the pulse search's silent-target branch,
per-stream field widths, each of the parser's bad-frame triggers, TNS
filters of order 8 and prediction gains where the LPC weighting decides,
every branch of the partial-concealment classifier, and full-scale, silent
and alternating rows for the MDCT and IMDCT. Made with numpy from a seed; shared by
the CPU parity tests, the CPU rehearsal of the kernels' lane functions and
the tests that run on a card, and chip_smoke.py. Imports nothing of JAX."""
from __future__ import annotations

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
