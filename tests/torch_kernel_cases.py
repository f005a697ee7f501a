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
