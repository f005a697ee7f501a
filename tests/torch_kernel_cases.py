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

from tests import torch_threads  # noqa: F401  (one torch thread a test process)

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


def codebook_distances(t: np.ndarray, cb: np.ndarray) -> np.ndarray:
    """The SNS quantizer's stage-1 distances of rows t [n, 8] to the
    entries of cb [8, 32] in float32, summed left to right as
    ops/sns.py:sns_vq_enc_plain sums them on the card: [n, 32]."""
    d = np.square(t[:, :1] - cb[0][None, :])
    for k in range(1, 8):
        d = d + np.square(t[:, k: k + 1] - cb[k][None, :])
    return d


def tied_halves(cb: np.ndarray) -> np.ndarray:
    """Midpoints of pairs of codebook entries whose two distances tie at the
    minimum in float32 (the plain version takes the lower entry)."""
    a, b = np.triu_indices(cb.shape[1], 1)
    mid = ((cb[:, a] + cb[:, b]) * np.float32(0.5)).T.astype(np.float32)
    d = codebook_distances(mid, cb)
    m = d.min(-1, keepdims=True)
    return mid[(d == m).sum(-1) >= 2]


@functools.cache
def sns_tie_rows() -> np.ndarray:
    """[n, 16] scale factors: halves tied between two codebook entries,
    rows of values near 1e20 (every distance and gain error overflows to
    infinity, so every argmin is a tie), and scf_rows (silent targets, an
    all-zero row, every submode)."""
    C1, C2 = T.t("sns_C1").astype(np.float32), T.t("sns_C2").astype(np.float32)
    h1, h2 = tied_halves(C1), tied_halves(C2)
    assert len(h1) >= 4 and len(h2) >= 4, (len(h1), len(h2))
    rng = np.random.default_rng(3)
    n = 24
    lo = h1[rng.integers(0, len(h1), n)]
    hi = h2[rng.integers(0, len(h2), n)]
    mixed = np.concatenate([np.concatenate([lo, hi], 1),
                            np.concatenate([lo, rng.standard_normal((n, 8)) * 2.0], 1),
                            np.concatenate([rng.standard_normal((n, 8)) * 2.0, hi], 1)])
    huge = np.stack([np.full(16, 1e20), np.tile([3e19, -3e19], 8),
                     np.linspace(4e19, 2e20, 16) * (-1.0) ** np.arange(16), -np.full(16, 5e19)])
    return np.concatenate([mixed, huge, scf_rows(5, 40)]).astype(np.float32)


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
    or a tensor, or a tuple, list or dict of them, nested (a dict is read key
    for key of ref). Two NaNs count as equal; an output of another shape or type
    counts as differing throughout."""
    if isinstance(ref, dict):
        got, ref = [got[k] for k in ref], list(ref.values())
    if not isinstance(ref, (tuple, list)):
        got, ref = [got], [ref]
    bad = 0
    for g, r in zip(got, ref, strict=True):
        if isinstance(r, (tuple, list, dict)):
            bad += count_differing(g, r)
            continue
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


# ---- the gain bisection (K7) ----

# the rows' block counts M = lg / 4 (25: 2.5 ms frames, 50: 5 ms, 100: 10 ms,
# 120: 10 ms in the high-resolution mode), and the starting offsets 255 +
# quantizedGainOff of the configurations with M blocks (8-96 kHz, 2.5-10 ms
# frames, 16-500 kbps, both modes)
GAIN_OFFSETS = {
    25: (98, 101, 109, 111, 117, 119, 120, 121, 122, 123, 124, 125),
    50: (71, 76, 93, 96, 108, 109, 112, 113, 115, 116, 119, 120, 121, 122, 123, 124),
    100: (17, 25, 60, 65, 91, 93, 98, 100, 105, 106, 112, 113, 115, 116, 119, 120, 121, 122),
    120: (17, 25, 60, 65, 79, 91, 93, 96, 98, 100, 105, 106, 107, 110, 112, 113, 115, 116, 118,
          119, 120, 121, 122)}
GAIN_LOW, GAIN_GAP, GAIN_HIGH = np.float32(9.8), np.float32(3.78), np.float32(70.0)


def gain_node_test(offset0: int, h: int) -> int:
    """The offset heap node h (1..255) of the eight halvings tests: the
    decisions above it are the bits of h below its leading one, a passed
    halving giving its fac back (csrc/gain_bisection.cuh)."""
    k = h.bit_length() - 1
    return offset0 - (256 - (256 >> k)) + ((h - (1 << k)) << (8 - k)) - (128 >> k)


def gain_chain(en: np.ndarray, offs: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """One halving's test of each row of en [n, M] at its offset offs [n]
    (ops/quant.py:gain_bisection_plain's inner loop, in float32): ener [n],
    iszero [n]."""
    o = offs.astype(np.float32)
    ener = np.zeros(en.shape[0], np.float32)
    iszero = np.ones(en.shape[0], bool)
    for j in range(en.shape[1] - 1, -1, -1):
        t = en[:, j] - o
        low = t < GAIN_LOW
        hi = np.where(t >= GAIN_HIGH, np.float32(2.0) * t - GAIN_HIGH, t)
        ener = ener + np.where(low, np.where(iszero, np.float32(0.0), GAIN_GAP), hi)
        iszero &= low
    return ener, iszero


def gain_path(en: np.ndarray, target: np.ndarray, offset0: int):
    """The eight halvings of each row as the plain version walks them: the
    offsets tested [n, 8], their ener [n, 8], and the final offset [n]."""
    n = en.shape[0]
    offset = np.full(n, offset0, np.int64)
    tested, eners = np.zeros((n, 8), np.int64), np.zeros((n, 8), np.float32)
    fac = 256
    for k in range(8):
        fac //= 2
        offset -= fac
        ener, iszero = gain_chain(en, offset)
        tested[:, k], eners[:, k] = offset, ener
        offset += np.where((ener > target) & ~iszero, fac, 0)
    return tested, eners, offset


def gain_rows(M: int, offset0: int, seed: int = 0, n: int = 24) -> tuple[np.ndarray, np.ndarray]:
    """[n, M] float32 block energies and [n] float32 targets of the gain
    bisection at the starting offset offset0: a row below the low threshold
    at every offset the halvings may test (iszero throughout); rows whose
    blocks sit on 9.8 and 70 above the offsets of a path down the tree (the
    first halving's always among them), within two ulps either side; rows with quiet blocks at the top and in the middle (the gap
    filling); falling envelopes; and targets that are a halving's ener on the
    walked path, or one ulp either side of it, beside targets at random
    offsets."""
    rng = np.random.default_rng([seed, M, offset0])
    f32 = np.float32
    lowest = offset0 - 255
    en = np.zeros((n, M), np.float32)
    en[0] = lowest - 300.0
    for r in range(1, n):
        kind = r % 4
        env = rng.uniform(20.0, 180.0) - np.linspace(0.0, rng.uniform(10.0, 120.0), M)
        row = (env + rng.normal(0.0, 8.0, M)).astype(np.float32)
        if kind == 1:           # blocks on both thresholds above the offsets of a path
            path = [1]
            while len(path) < 8:
                path.append(2 * path[-1] + int(rng.integers(0, 2)))
            c = np.float32([gain_node_test(offset0, h) for h in path])[rng.integers(0, 8, M)]
            edge = np.where(rng.random(M) < 0.5, c + GAIN_LOW, c + GAIN_HIGH).astype(np.float32)
            steps = rng.integers(-2, 3, M)
            for s in (-2, -1, 1, 2):
                sel = steps == s
                edge[sel] = np.nextafter(edge[sel], np.float32(np.inf if s > 0 else -np.inf))
                if abs(s) == 2:
                    edge[sel] = np.nextafter(edge[sel], np.float32(np.inf if s > 0 else -np.inf))
            pick = rng.random(M) < 0.6
            row[pick] = edge[pick]
        elif kind == 2:         # quiet blocks at the top and in the middle
            row[M - M // 3:] = lowest - rng.uniform(0.0, 50.0, M // 3)
            mid = int(rng.integers(0, M // 2))
            row[mid: mid + M // 5] = lowest - 10.0
        elif kind == 3:         # a row near one node's offset throughout
            c = gain_node_test(offset0, int(rng.integers(1, 256)))
            row = (c + rng.uniform(-20.0, 90.0, M)).astype(np.float32)
        en[r] = row
    # targets: the ener at a random offset, then on odd rows a halving's ener
    # on the walked path itself, or one ulp either side
    offs = rng.integers(lowest, offset0 + 1, n)
    target = gain_chain(en, offs)[0] * rng.uniform(0.9, 1.1, n).astype(np.float32)
    target = target.astype(np.float32)
    tie = np.arange(n) % 2 == 1
    _, eners, _ = gain_path(en, target, offset0)
    level = rng.integers(0, 8, n)
    e = eners[np.arange(n), level]
    nudge = rng.integers(-1, 2, n)
    e = np.where(nudge > 0, np.nextafter(e, np.float32(np.inf)),
                 np.where(nudge < 0, np.nextafter(e, np.float32(-np.inf)), e)).astype(np.float32)
    target[tie] = e[tie]
    return en, target


TNS_LATTICE_ORDER = ("x", "rc", "order", "lo", "hi")
TNS_LATTICE_N = 480
TNS_CHUNK = 15     # csrc/tns_lattice.cuh: the hull [12, 479] in 32 chunks of 15 bins


def tns_lattice_rows(seed: int = 0) -> dict[str, np.ndarray]:
    """Inputs of both TNS lattices, [n, 480] spectra with their filters
    (rc [n, 2, 8] from the quantizer's points, order, lo, hi [n, 2]), that
    take what the encoder's filters may not: the switch between the filters
    at every offset 0..14 in a 15-bin chunk of the analysis lattice (and so
    at every offset to the synthesis lattice's wavefront), with the order
    rising 3 -> 8 and falling 8 -> 1 there; filter 0 off with filter 1 on;
    a single filter; orders 9 and 12 (which act as 8); both filters off;
    ranges with a gap, filter 1 inside filter 0 and overlapping ranges (the
    analysis lattice's general path); rows of zeros and of negative zeros
    (one with positive coefficients, which carry -0 to the output),
    subnormal rows, rows near +-3e38 (the sums overflow, and the rounding
    takes its tested path); and rows of random orders 0-9 and switch bins."""
    rng = np.random.default_rng(seed)
    N = TNS_LATTICE_N
    pts = T.t("quants_pts_tns").astype(np.float32)
    rows = []

    def add(x, order, lo, hi, rc=None):
        rc = pts[rng.integers(0, 17, (2, 8))] if rc is None else rc
        rows.append((x, rc, np.array(order), np.array(lo), np.array(hi)))

    def spectrum(scale=1.0):
        v = rng.standard_normal(N) * np.linspace(1, 30, N) * 10.0 ** rng.uniform(-1, 3)
        for i in range(1, N):
            v[i] += 0.7 * v[i - 1]
        return v * scale

    for off in range(TNS_CHUNK):
        switch = 12 + TNS_CHUNK * (1 + off % 24) + off
        add(spectrum(), (3, 8), (12, switch), (switch - 1, N - 1))
        add(spectrum(), (8, 1), (12, switch), (switch - 1, N - 1))
    add(spectrum(), (0, 5), (12, 200), (199, N - 1))
    add(spectrum(), (0, 8), (12, 240), (239, 399))
    add(spectrum(), (8, 0), (12, 200), (N - 1, N - 1))
    add(spectrum(), (6, 0), (12, 0), (399, -1))
    add(spectrum(), (9, 12), (12, 200), (199, N - 1))
    add(spectrum(), (12, 2), (12, 150), (149, 399))
    add(spectrum(), (0, 0), (12, 200), (199, N - 1))
    add(spectrum(), (8, 7), (12, 300), (199, N - 1))      # a gap of 100 bins
    add(spectrum(), (8, 5), (12, 150), (N - 1, 250))      # filter 1 inside filter 0
    add(spectrum(), (5, 8), (12, 150), (250, N - 1))      # overlapping ranges
    add(np.zeros(N), (8, 8), (12, 200), (199, N - 1))
    add(np.full(N, -0.0), (8, 4), (12, 200), (199, N - 1))
    # positive coefficients keep -0 through the synthesis chain to its output
    add(np.full(N, -0.0), (8, 8), (12, 200), (199, N - 1), pts[rng.integers(9, 17, (2, 8))])
    add(rng.standard_normal(N) * 1e-39, (8, 8), (12, 200), (199, N - 1))
    add(rng.standard_normal(N) * 1e-42, (5, 8), (12, 100), (99, N - 1))
    big = rng.choice([-3e38, 3e38], N) * rng.uniform(0.5, 1.0, N)
    add(big, (8, 8), (12, 200), (199, N - 1))
    near = spectrum()
    add(near / np.abs(near).max() * 1e37, (8, 6), (12, 200), (199, N - 1))
    for _ in range(16):
        o = rng.integers(0, 10, 2)
        switch = int(rng.integers(13, N - 1))
        add(spectrum(), tuple(o), (int(rng.integers(0, 40)), switch), (switch - 1, N - 1))
    x, rc, order, lo, hi = (np.stack([r[k] for r in rows]) for k in range(5))
    return {"x": x.astype(np.float32), "rc": rc.astype(np.float32),
            "order": order.astype(np.int32), "lo": lo.astype(np.int32),
            "hi": hi.astype(np.int32)}


# the range coders' rows: the configurations of the CPU rehearsal and the
# card's checks (lsb_mode 1 at 160 kbps; N = 480 and 21 escape levels in
# the high-resolution mode)
CODER_CONFIGS = {"48k_64k": dict(fs_in=48000, bitrate=64000),
                 "48k_160k": dict(fs_in=48000, bitrate=160000),
                 "48k_hr": dict(fs_in=48000, bitrate=256000, hrmode=True)}
# the keys of coder_rows(), in the argument order of ari.encode after cfg
CODER_ARI_ORDER = ("buf", "bp_side", "mask_side", "xq", "tns_order", "tns_idx", "num_tns",
                   "lastnz", "lsb_mode", "res_bits", "n_res")


def coder_rows(cfg, seed: int = 0) -> dict[str, np.ndarray]:
    """Inputs of both range-coder kernels (bit_estimate: xq, target;
    ari_encode: CODER_ARI_ORDER) at cfg's N and frame size, rows that take
    what the encoder's spectra may not: an all-zero row, only tuple 0
    nonzero, only the last tuple nonzero (small and with escapes), dense rows
    at four scales, |x| up to 2^15 and powers of two up to 2^23 (escape
    levels beyond 3 and beyond max_lev), a dense row with the targets that
    put bit_estimate's lastnz2 on both sides of every boundary between two
    lanes' runs of tuples (found with the plain version), LSB-mode rows of
    many escaped tuples (LSB lists of hundreds of entries, past N), TNS
    orders 0-8 (and 9, 12) in both filters with indices from -1 to 17, a
    family of dense rows coded whole (lastnz = N) over 48 scales, whose
    forward bytes reach the side bits from some scale on (ari_encode's
    lane-0 path), and one row near its budget coded whole behind side
    information of 16, 18, .. 124 bits, whose forward bytes end below, on
    and past the byte of the tuples' last side bit. lastnz, lsb_mode
    and target follow from the plain bit_estimate where the row does not set
    them; the side information is otherwise 30-90 bits from the frame's end."""
    import torch
    from audio_codec_torch.ops import quant
    rng = np.random.default_rng(seed)
    N, nbytes = cfg.yLen, cfg.targetBytes
    NT = N // 2
    run = -(-NT // 32)
    xs, fixed_lastnz, fixed_target, lsb_one = [], [], [], []

    def add(x, lastnz=None, target=None, lsb=False):
        xs.append(np.asarray(np.round(x), np.int64).clip(-2 ** 23, 2 ** 23))
        fixed_lastnz.append(lastnz)
        fixed_target.append(target)
        lsb_one.append(lsb)

    z = np.zeros(N)
    add(z)
    r = z.copy(); r[0], r[1] = 3, -1
    add(r)
    r = z.copy(); r[0] = -40
    add(r)
    r = z.copy(); r[N - 2], r[N - 1] = -2, 1
    add(r)
    r = z.copy(); r[N - 1] = 300
    add(r, lastnz=N)
    for scale in (0.6, 2.0, 6.0, 20.0):
        add(rng.laplace(0.0, scale, N) * np.linspace(2.0, 0.3, N))
    add(rng.integers(-2 ** 15, 2 ** 15 + 1, N), lastnz=N)
    r = z.copy()
    r[: 2 * 24: 2] = 2.0 ** np.arange(24) * rng.choice([-1, 1], 24)
    r[N // 2: N // 2 + 24] = 2.0 ** rng.integers(10, 24, 24)
    add(r, lastnz=N)
    # lastnz2 on both sides of every lane boundary: a dense row whose every
    # tuple costs more than a bit, at the targets that end it there
    dense = np.where(rng.random(N) < 0.5, -1, 1) * rng.integers(4, 30, N)
    cand = np.arange(0, 8 * N, dtype=np.int32)
    d = torch.from_numpy(np.tile(dense.astype(np.int32), (len(cand), 1)))
    l2 = quant.bit_estimate_plain(cfg, d, torch.from_numpy(cand), 0)["lastnz2"].numpy()
    for kb in range(run, NT, run):
        for k in (kb - 1, kb):
            hit = np.flatnonzero(l2 == 2 * k + 2)
            if hit.size:
                add(dense, target=int(cand[hit[0]]))
    # LSB-mode rows: many escaped tuples, magnitudes 1 beside them
    for _ in range(4):
        r = rng.integers(4, 64, N) * np.where(rng.random(N) < 0.5, -1, 1)
        r[rng.random(N) < 0.3] = rng.choice([-1, 1])
        add(r, lsb=True)
    r = rng.integers(4, 9, N) * np.where(rng.random(N) < 0.5, -1, 1)
    r[1::4] = 1
    add(r, lastnz=N, lsb=True)
    # coded whole over 48 scales: within the budget, near it, over it
    shape = rng.laplace(0.0, 1.0, N) * np.linspace(1.5, 0.5, N)
    for scale in np.geomspace(1.0, 60.0, 48):
        add(shape * scale, lastnz=N, lsb=bool(rng.random() < 0.25))
    # the scale whose estimate leaves 70 bits of the frame, coded whole
    # behind side information of 16-124 bits: the forward bytes end from
    # about 7 bytes below the tuples' last side bit to 7 bytes past it
    scales = np.geomspace(0.05, 60.0, 400)
    cand = torch.from_numpy(np.round(shape[None] * scales[:, None]).astype(np.int32))
    nb = quant.bit_estimate_plain(cfg, cand, torch.zeros(len(scales), dtype=torch.int32),
                                  -1)["nbits"].numpy()
    edge = cand[int(np.argmin(np.abs(nb - (8 * nbytes - 70))))].numpy()
    n_fixed = len(xs)
    for _ in range(0, 109, 2):
        add(edge, lastnz=N)
    xq = np.stack(xs).astype(np.int32)
    B = xq.shape[0]

    xt = torch.from_numpy(xq)
    need = quant.bit_estimate_plain(cfg, xt, torch.full((B,), 10 ** 6, dtype=torch.int32), -1)
    target = (need["nbits"].numpy() * rng.uniform(0.3, 1.2, B)).astype(np.int32)
    target = np.array([t if f is None else f for t, f in zip(target, fixed_target)], np.int32)
    est = quant.bit_estimate_plain(cfg, xt, torch.from_numpy(target), cfg.modeFlag)
    lastnz = np.array([int(e) if f is None else f for e, f in
                       zip(est["lastnz2"].numpy(), fixed_lastnz)], np.int32)
    lsb_mode = np.where(lsb_one, 1, est["lsbMode"].numpy()).astype(np.int32)
    tns_order = rng.integers(0, 9, (B, 2))
    tns_order[:3] = [[9, 12], [8, 8], [0, 8]]
    num_tns = rng.integers(1, 3, B)
    tns_idx = rng.integers(0, 17, (B, 2, 8))
    tns_idx[:4, :, ::3] = rng.choice([-1, 17], (4, 2, 3))
    n_side = rng.integers(30, 91, B)
    n_side[n_fixed:] = 16 + 2 * np.arange(B - n_fixed)
    lsb_mode[n_fixed:] = 0
    tns_order[n_fixed:] = 0
    q = 8 * (nbytes - 1) - n_side
    bp_side = (q + 7) >> 3
    width = quant.residual_max_bits(cfg)
    i32 = lambda a: np.ascontiguousarray(a, dtype=np.int32)
    return {"xq": xq, "target": target, "buf": i32(rng.integers(0, 256, (B, nbytes))),
            "bp_side": i32(bp_side), "mask_side": i32(1 << (8 * bp_side - q)),
            "tns_order": i32(tns_order), "tns_idx": i32(tns_idx), "num_tns": i32(num_tns),
            "lastnz": lastnz, "lsb_mode": lsb_mode,
            "res_bits": i32(rng.integers(0, 2, (B, width))),
            "n_res": i32(rng.integers(0, width + 1, B))}


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


# the arguments of the fused pc_classify after cfg (kernels.pc_classify,
# ops/pc.py:pc_classify_plain)
PC_FUSED_ORDER = ("bfi", "spec_inv_idx", "pitch_present", "q_old_d", "q_old_res", "scf_q",
                  "old_scf", "old_old_scf", "prev_bfi", "prev_prev_bfi")


def _scf_pair(rng, n: int, d: np.ndarray, col: int) -> tuple[np.ndarray, np.ndarray]:
    """[n, 16] scale-factor rows a and b = a less sqrt(d) in column col, so
    that their squared distance is about d."""
    a = (rng.standard_normal((n, 16)) * 2.0).astype(np.float32)
    b = a.copy()
    b[:, col] -= np.sqrt(d).astype(np.float32)
    return a, b


def pc_fused_rows(q_old_d: np.ndarray, q_old_res: np.ndarray, seed: int = 0) -> dict[str, np.ndarray]:
    """Inputs of the fused pc_classify (the stability factor and the
    classifier) that take every branch of both: pc_rows's streams with each
    stab_fac made by scale-factor rows at the distance that gives about it
    (a bfi 2 frame's against the last good one, 1 - d / 25 clamped); streams
    for the stability factor's own branches: bfi 1 after a good frame with
    prev-prev 1 (0.8) and otherwise, bfi 1 after a lost frame (1), bfi 2
    after bfi 1 (0.8, stable), and distances that clamp it to 0 and to 1;
    detector rows with no candidate and with a first-block hit that a later
    peak does not move, and energy rows at the 0.3 edge.
    Returns the arguments after cfg, PC_FUSED_ORDER's keys."""
    a = pc_rows(q_old_d, q_old_res, seed)
    rng = np.random.default_rng(seed + 100)
    target = a.pop("stab_fac").astype(np.float64)
    n = len(target)
    extra = [  # (bfi, prev, prev-prev, squared distance), 8 streams each
        (1, 0, 1, 3.0), (1, 0, 0, 3.0), (1, 0, 0, 11.0), (1, 0, 0, 40.0), (1, 1, 0, 40.0),
        (1, 2, 1, 3.0), (2, 1, 0, 40.0), (2, 2, 1, 0.0), (2, 0, 0, 0.0), (2, 0, 0, 2.0),
        (2, 0, 0, 31.25), (2, 0, 0, 50.0), (2, 0, 1, 50.0), (0, 1, 1, 50.0), (0, 0, 0, 50.0)]
    reps = 8
    d = np.concatenate([25.0 * (1.25 - target), np.repeat([e[3] for e in extra], reps)])
    bfi = np.concatenate([a["bfi"], np.repeat([e[0] for e in extra], reps)]).astype(np.int32)
    prev = np.concatenate([np.zeros(n), np.repeat([e[1] for e in extra], reps)]).astype(np.int32)
    prev2 = np.concatenate([np.zeros(n), np.repeat([e[2] for e in extra], reps)]).astype(np.int32)
    m = len(extra) * reps
    rows = np.concatenate([np.arange(n), rng.integers(0, n, m)])
    inv = np.concatenate([a["spec_inv_idx"], rng.choice([5, 16, 30, 200], m)]).astype(np.int32)
    pitch = np.concatenate([a["pitch_present"], np.arange(m) % 2]).astype(np.int32)
    # streams on the detector's path whose rows hold no candidate: flat
    # (every block energy an eighth of the threshold) and silent;
    q_d, q_res = a["q_old_d"][rows], a["q_old_res"][rows]
    flat = np.concatenate([np.full((4, q_d.shape[1]), 100.0), np.zeros((4, q_d.shape[1]))])
    # streams on the energy path whose low region holds just under 0.3 of
    # the energy (bins 0..19 at 1, bin 20 at 2, 45 bins above at 1); and
    # detector rows with a first-block hit and a later peak above the mean
    # threshold but below 0.3 of the first block's energy (the crossover
    # stays at 1)
    edge = np.zeros((8, q_d.shape[1]))
    edge[:, :20], edge[:, 20], edge[:, 21:66] = 1.0, 2.0, 1.0
    late = np.zeros((8, q_d.shape[1]))
    late[:, :5] = [3000.0, 1000.0, 10.0, 8.0, 6.0]
    _peak(late[0], 60, 2e6)
    late[1:] = late[0]
    q_d = np.concatenate([q_d, flat, flat, late]).astype(np.float32)
    q_res = np.concatenate([q_res, q_res[:8], edge, q_res[:8]]).astype(np.float32)
    d, bfi = np.concatenate([d, np.zeros(24)]), np.concatenate([bfi, np.full(24, 2, np.int32)])
    prev = np.concatenate([prev, np.zeros(24, np.int32)])
    prev2 = np.concatenate([prev2, np.zeros(24, np.int32)])
    inv = np.concatenate([inv, np.full(16, 20), np.tile([9, 16, 26, 39], 2)]).astype(np.int32)
    pitch = np.concatenate([pitch, np.ones(8, np.int32), np.zeros(8, np.int32),
                            np.ones(8, np.int32)])
    N = len(d)
    old, old_old = _scf_pair(rng, N, d, 3)
    scf = old - (old_old - old)      # the frame as far from the last good one
    return dict(bfi=bfi, spec_inv_idx=inv, pitch_present=pitch,
                q_old_d=np.ascontiguousarray(q_d), q_old_res=np.ascontiguousarray(q_res),
                scf_q=np.ascontiguousarray(scf, np.float32), old_scf=old, old_old_scf=old_old,
                prev_bfi=prev, prev_prev_bfi=prev2)


def pc_detector_events(sig: np.ndarray) -> dict[str, np.ndarray]:
    """Per row of sig [n, N] (float32), which of the peak detector's
    outcomes it reaches, in the plain version's card order: the first block
    hit, a candidate that moves the crossover by the hysteresis (above 0.3 of
    the maximum, below it), and no candidate at all (nor a first-block hit)."""
    sig = np.asarray(sig, np.float32)
    n, N = sig.shape
    if n == 0:
        return {k: np.zeros(0, bool) for k in ("first-block hit", "hysteresis move", "no candidate")}
    a, sq = np.abs(sig), sig * sig
    acc = np.zeros(n, np.float32)
    for k in range(N):
        acc = (acc + sq[:, k]).astype(np.float32)
    mean = (acc * np.float32(1.0 / N) * np.float32(24.0)).astype(np.float32)
    edge = sq[:, 0] + sq[:, 1]
    hit0 = (a[:, 0] >= a[:, 1]) & (edge > mean) & (np.maximum(a[:, 0], a[:, 1]) > a[:, 2:5].max(1))
    peak = np.where(hit0, edge, np.float32(0.0)).astype(np.float32)
    hyst = np.zeros(n, bool)
    anyc = np.zeros(n, bool)
    for k in range(N - 5):
        cent = (sq[:, k] + sq[:, k + 1]) + sq[:, k + 2]
        cur = a[:, k: k + 3].max(1)
        # the bins k-3..k-1; for k < 3 those above bin 0 (from 0)
        prv = a[:, k - 3: k].max(1) if k >= 3 else (a[:, 1] if k == 2 else np.zeros(n, np.float32))
        nxt = a[:, k + 3: k + 6].max(1)
        c = (a[:, k + 1] >= a[:, k]) & (a[:, k + 1] >= a[:, k + 2]) & (cent > mean) & \
            (cur >= prv) & (cur > nxt)
        full = c & (cent >= peak)
        hyst |= c & ~full & (cent > np.float32(0.3) * peak)
        anyc |= c
        peak = np.where(full, cent, peak)
    return {"first-block hit": hit0, "hysteresis move": hyst, "no candidate": ~anyc & ~hit0}


def pc_fused_branches(args: dict, bfi_out: np.ndarray, stab: np.ndarray,
                      frame_dms: int = 100) -> dict[str, int]:
    """Streams of the fused pc_classify's inputs args (numpy, PC_FUSED_ORDER's
    keys) with outputs bfi_out and stab in each branch of the stability
    factor and of the classifier (pc_branches's), and of the peak detector
    where a stream reaches it."""
    bfi, prev, prev2 = args["bfi"], args["prev_bfi"], args["prev_prev_bfi"]
    counts = pc_branches({**args, "stab_fac": stab}, bfi_out, frame_dms)
    after_good = (bfi == 1) & (prev != 1)
    counts.update({
        "clean": int((bfi == 0).sum()),
        "bfi 1 after a good frame, prev-prev 1": int((after_good & (prev2 == 1)).sum()),
        "bfi 1 after a good frame, otherwise": int((after_good & (prev2 != 1)).sum()),
        "bfi 1 after a lost frame": int(((bfi == 1) & (prev == 1)).sum()),
        "bfi 2 after bfi 1": int(((bfi == 2) & (prev == 1)).sum()),
        "stability 0": int(((bfi != 0) & (stab == 0.0)).sum()),
        "stability between": int(((stab > 0.0) & (stab < 1.0)).sum()),
        "stability 1": int(((bfi == 2) & (stab == 1.0)).sum())})
    active = (bfi == 2) & (args["spec_inv_idx"] * 10 < 4 * frame_dms) & ~(stab < 0.5) & \
        (args["pitch_present"] == 1)
    ev = pc_detector_events(args["q_old_d"][active])
    counts.update({f"detector {k}": int(v.sum()) for k, v in ev.items()})
    return counts


def transform_rows(N: int, la: int, seed: int = 0,
                   extreme: bool = False) -> tuple[np.ndarray, np.ndarray]:
    """[n, N] frames and [n, N - la] memories for the MDCT and IMDCT:
    full-scale noise, silent rows, alternating-sign rows at full scale and
    small, and seeded rows at several levels. With `extreme`, after these:
    a row of seeded values with one of about 1e-30 every 97 samples (the
    IMDCT kernel leaves its untested step there, csrc/dct4.cuh:
    imdct_fast_input), rows of negative zeros, subnormal-scale rows (about
    1e-39, where a float sum loses the ulp of its exponent) and rows near
    1e37 (the compensated order's split overflows there, as it does on the
    CPU). XLA:CPU flushes
    subnormal inputs to zero, so a comparison with the JAX reference takes
    the rows without `extreme`, or the extreme rows without the subnormal
    ones (transform_rows_jax_safe)."""
    rng = np.random.default_rng(seed)
    full = lambda k, m: rng.uniform(-32768.0, 32767.0, (k, m))
    alt = lambda m, a: a * np.where(np.arange(m) % 2 == 0, 1.0, -1.0)[None]
    x = np.concatenate([full(4, N), np.zeros((2, N)), alt(N, 32767.0), alt(N, 0.5),
                        rng.standard_normal((8, N)) * 10.0 ** rng.uniform(-2, 4, (8, 1))])
    m = N - la
    mem = np.concatenate([full(4, m), np.zeros((2, m)), alt(m, -32768.0), np.zeros((1, m)),
                          rng.standard_normal((8, m)) * 1000.0])
    if extreme:
        mixed = rng.standard_normal((1, N)) * 1000.0
        mixed[:, 40::97] = 1e-30
        x = np.concatenate([x, mixed, np.full((2, N), -0.0),
                            rng.standard_normal((2, N)) * 1e-39,
                            rng.standard_normal((2, N)) * 1e37])
        mem = np.concatenate([mem, rng.standard_normal((1, m)) * 1000.0,
                              np.full((1, m), -0.0), np.zeros((1, m)),
                              rng.standard_normal((2, m)) * 1e-39,
                              rng.standard_normal((2, m)) * 1e37])
    return x.astype(np.float32), mem.astype(np.float32)


EXTREME_SUBNORMAL_ROWS = slice(-4, -2)   # the subnormal-scale rows of transform_rows(extreme=True)


def transform_rows_jax_safe(N: int, la: int, seed: int = 0) -> tuple[np.ndarray, np.ndarray]:
    """transform_rows(extreme=True) without the subnormal-scale rows, which
    XLA:CPU flushes to zero."""
    x, mem = transform_rows(N, la, seed, extreme=True)
    keep = np.ones(x.shape[0], bool)
    keep[EXTREME_SUBNORMAL_ROWS] = False
    return x[keep], mem[keep]


# ---- the LTPF decoder (ltpf_decode) ----

LTPF_DEC_ORDER = ("x", "bfi", "param", "mem_param", "mem_x", "mem_y", "mem_pitch_int",
                  "mem_pitch_fr", "mem_gain", "mem_beta_idx")
# (old parameters [present, active, index], new parameters, bfi) of each lane
LTPF_DEC_LANES = {
    "off->off": ([0, 0, 0], [0, 0, 0], 0),
    "on->off": ([1, 1, 300], [1, 0, 300], 0),
    "off->on": ([1, 0, 0], [1, 1, 120], 0),
    "on->on same pitch": ([1, 1, 250], [1, 1, 250], 0),
    "on->on new pitch": ([1, 1, 250], [1, 1, 410], 0),
    "smallest pitch": ([1, 1, 0], [1, 1, 0], 0),
    "to the smallest pitch": ([1, 1, 5], [1, 1, 0], 0),
    "largest pitch": ([1, 1, 511], [1, 1, 511], 0),
    "pitch present, filter off": ([1, 0, 200], [1, 0, 340], 0),
    "pitch 0, flags set": ([0, 1, 0], [0, 1, 0], 0),
    "to pitch 0, flags set": ([1, 1, 300], [0, 1, 0], 0),
    "from pitch 0, flags set": ([0, 1, 0], [0, 0, 0], 0),
    "from pitch 0 to on": ([0, 1, 0], [1, 1, 60], 0),
    "lost frame": ([1, 1, 200], [1, 1, 200], 1),
}


def ltpf_decode_rows(cfg, seed: int = 0, midpoint: bool = False) -> dict[str, np.ndarray]:
    """Inputs of ltpf_decode (LTPF_DEC_ORDER) whose lanes take every case
    (LTPF_DEC_LANES): the five cross-fade cases, the smallest pitch (index 0:
    120 at 48 kHz, the nearest read 115 samples back) and the largest, a
    pitch present with the filter off, a pitch of 0 with the filter flag set
    in the old or new parameters or both (reads of samples not produced yet),
    a lost frame; at 48 kHz the crossfade of 120 samples ends inside a chunk
    of 32. PCM seeded at 16-bit scale. With `midpoint` (48 kHz), a further
    fade-out lane whose first sample's tilt chain has a step whose double sum
    falls on a float midpoint that the exact sum is not on, so that a fused
    float multiply-add in its place rounds the other way (ltpf_midpoint)."""
    import torch
    from audio_codec_torch.models.state import ltpf_dec_lens
    from audio_codec_torch.ops import ltpf_dec
    rng = np.random.default_rng(seed)
    Lx, Ly, _, _ = ltpf_dec_lens(cfg)
    N = cfg.frame_length
    lanes = list(LTPF_DEC_LANES.values())
    B = len(lanes) + int(midpoint)
    mem_param = np.array([c[0] for c in lanes] + [[1, 1, 300]] * midpoint, np.int32)
    param = np.array([c[1] for c in lanes] + [[1, 0, 300]] * midpoint, np.int32)
    bfi = np.array([c[2] for c in lanes] + [0] * midpoint, np.int32)
    pi, pf = (v.numpy() for v in ltpf_dec.decode_pitch(cfg, torch.from_numpy(mem_param)))
    rows = dict(x=rng.standard_normal((B, N)) * 3000.0, bfi=bfi, param=param,
                mem_param=mem_param, mem_x=rng.standard_normal((B, Lx)) * 3000.0,
                mem_y=rng.standard_normal((B, Ly)) * 3000.0, mem_pitch_int=pi.astype(np.int32),
                mem_pitch_fr=pf.astype(np.int32),
                mem_gain=np.where(mem_param[:, 1] == 1, np.float32(cfg.ltpf_conf_beta), 0),
                mem_beta_idx=np.full(B, cfg.ltpf_conf_beta_idx, np.int32))
    rows = {k: np.ascontiguousarray(v, np.float32 if k in ("x", "mem_x", "mem_y", "mem_gain")
                                    else np.int32) for k, v in rows.items()}
    if midpoint:
        ltpf_midpoint(cfg, rows, B - 1, int(pi[-1]))
    return rows


def ltpf_midpoint(cfg, rows: dict, b: int, p1: int):
    """Makes lane b (fade-out, old pitch p1) reach a float midpoint at its
    first sample: x[0] = 0, mem_x[-1] = M, mem_x[-2] = v, the rest of the
    tilt taps and the old pitch taps 0, so that s1_old's chain is
    fl(b1 M) = A, then A + b1' v where b1' v lies above half an ulp of A by
    less than half a double ulp of A: the double sum is the midpoint, which
    rounds to the even A, the exact sum to the next float. The sample is
    z_0 = -s1_old (the crossfade weight is 1)."""
    from fractions import Fraction
    f32, f64 = np.float32, np.float64
    Lx, Ly = rows["mem_x"].shape[1], rows["mem_y"].shape[1]
    tilt = np.asarray(T.t("conf_tilt_filter_48"), f32)[rows["mem_beta_idx"][b]]
    g = f32(f32(0.85) * rows["mem_gain"][b])
    w1, w2 = f32(g * tilt[1]), f32(g * tilt[2])
    rows["x"][b, 0] = 0.0
    rows["mem_x"][b, :] = 0.0
    base = Ly - p1 + (max(cfg.fs, 16000) // 8000) - 1
    rows["mem_y"][b, max(base - 12, 0): base + 1] = 0.0
    for k in range(20000):
        M = f32(1000.0 + 0.37 * k)
        A = f32(w1 * M)
        if A.view(np.int32) & 1:
            continue
        h = f64(np.spacing(A)) / 2
        v0 = f32(h / f64(w2))
        for v in (v0, np.nextafter(v0, f32(np.inf)), np.nextafter(v0, f32(-np.inf))):
            d = f64(w2) * f64(v) - h
            if not 0 < d < 2.0 ** (np.floor(np.log2(f64(A))) - 53):
                continue
            exact = Fraction(float(A)) + Fraction(float(w2)) * Fraction(float(v))
            up = np.nextafter(A, f32(np.inf))
            assert f32(f64(A) + f64(w2) * f64(v)) == A            # the double's way
            assert exact - Fraction(float(A)) > Fraction(float(up)) - exact   # the exact way
            rows["mem_x"][b, Lx - 1] = M
            rows["mem_x"][b, Lx - 2] = v
            return
    raise AssertionError("no midpoint found")


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


def olpa_rows(seed: int = 0, frame_dms: int = 100) -> dict[str, np.ndarray]:
    """Inputs of olpa (s12k8 [n, 129], mem_s12k8 [n, 3], mem_s6k4 [n, 114]
    at 10 ms; [n, 65] and [n, 114] at 5 ms, [n, 33] and [n, 130] at 2.5 ms;
    mem_pitch [n]) from one 12.8 kHz signal a row, the memories its earlier
    samples decimated as the frame is: pulse trains and tones whose period
    at 6.4 kHz is each lag limit (17, 114) and lags between, each with the
    previous pitch at the period, at twice it (the windowed search takes
    over), at 1.5 times it (it does not), at both limits and out of range
    (an empty window); tones with the previous pitch 4-14 lags above the
    period (the windowed correlation near 0.85 of the other); silent rows
    (every lag ties, the first wins); seeded noise; constant rows (every lag
    ties at a nonzero correlation: the window's first lag takes over)."""
    rng = np.random.default_rng(seed)
    w = T.t("olpa_down2")
    length = T.LEN_12K8 * frame_dms // 100
    mem = T.MAX_PITCH_6K4 + (16 if frame_dms == 25 else 0)
    n12 = 2 * mem + 3 + length + 1
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
    # constant rows: every lag ties at one nonzero correlation, so the
    # windowed search's first lag takes over wherever it is not the
    # weighted one
    for mp in (21, 50, 60, 61, 62, 63, 100, 110):
        sigs.append(np.full(n12, 1000.0 + mp))
        pitches.append(mp)
    u = np.stack(sigs)
    filt = np.stack([np.convolve(r, w)[: n12] for r in u])
    return dict(s12k8=np.ascontiguousarray(u[:, 2 * mem + 3:], np.float32),
                mem_s12k8=np.ascontiguousarray(u[:, 2 * mem: 2 * mem + 3], np.float32),
                mem_s6k4=np.ascontiguousarray(filt[:, 4: 2 * mem + 4: 2], np.float32),
                mem_pitch=np.asarray(pitches, np.int32))


def olpa_weighted_lag(args: dict) -> np.ndarray:
    """T0 of olpa's weighted search alone (float64, from the inputs), to tell
    the rows where the windowed search took over."""
    w = T.t("olpa_down2")
    length = args["s12k8"].shape[1] - 1
    mem = args["mem_s6k4"].shape[1]
    acf = length // 2 + mem - T.MAX_PITCH_6K4     # 64 at 10 ms, 32 at 5 and 2.5 ms
    buf = np.concatenate([args["mem_s12k8"], args["s12k8"][:, :length]],
                         axis=1).astype(np.float64)
    filt = np.stack([np.convolve(r, w)[: buf.shape[1]] for r in buf])
    row = np.concatenate([args["mem_s6k4"].astype(np.float64), filt[:, 4::2][:, :length // 2]],
                         axis=1)
    cur = row[:, 114:114 + acf]
    R = np.stack([(cur * row[:, 114 - lag: 114 + acf - lag]).sum(-1) for lag in range(17, 115)],
                 -1)
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


# open-loop pitches at the lag limits and on both sides of the resolution
# steps: MIN_PITCH_12K8, RES4_PITCH_12K8 - 1 and RES4, RES2 - 1 and RES2,
# MAX_PITCH_12K8 (the window clamped at the last lag)
LTPF_EDGE_PITCHES = (32, 126, 127, 156, 157, 228)


def ltpf_edge_rows(cfg, seed: int = 0) -> dict[str, np.ndarray]:
    """Inputs of ltpf_encode at cfg's frame size (10, 5 or 2.5 ms) that
    force its edges: the open-loop pitch at each of LTPF_EDGE_PITCHES with
    pulse trains and tones of that period; silent, constant and
    alternating rows, whose window values are all tied (every lag sees the
    same samples) and whose candidates tie too (silence); pulse trains whose
    sign flips every period, so the correlation at the pitch is negative;
    and noise. The previous frame is set up for each activation rule, nc_ol
    on both sides of 0.6."""
    rng = np.random.default_rng(seed)
    xlen, mem_len = cfg.len_12k8 + 1, cfg.ltpf_mem_in_len
    n = mem_len + xlen
    t_ = np.arange(n)
    rows = []
    for Q in LTPF_EDGE_PITCHES:
        for kind in ("pulse", "tone"):
            for noise in (0.0, 0.2):
                u = _periodic(kind, Q, n, int(rng.integers(0, Q)), rng)
                rows.append((u + rng.standard_normal(n) * noise * 3000.0, Q))
        flip = np.where(t_ % Q == 0, 8000.0, 0.0) * (-1.0) ** (t_ // Q)
        rows.append((flip, Q))
        rows.append((np.zeros(n), Q))
        rows.append((np.full(n, 1234.5), Q))
        rows.append((np.where(t_ % 2 == 0, 700.0, -700.0), Q))
        rows.append((rng.standard_normal(n) * 2000.0, Q))
    cols = {k: [] for k in LTPF_ORDER}
    rules = ("fresh", "keep", "track", "none")
    for i, (u, Q) in enumerate(rows):
        cols["mem_in"].append(u[:mem_len])
        cols["s12k8"].append(u[mem_len:])
        cols["pitch_ol"].append(Q)
        cols["nc_ol"].append(0.59 if i % 7 == 3 else 0.95)
        on, mem_nc, mem_pitch = {"fresh": (0, 0.97, 0.0), "keep": (1, 0.5, Q + 10.0),
                                 "track": (1, 0.8, float(Q)), "none": (0, 0.5, 0.0)}[rules[i % 4]]
        cols["mem_on"].append(on)
        cols["mem_normcorr"].append(mem_nc)
        cols["mem_mem_normcorr"].append(rng.uniform(0.9, 1.0))
        cols["mem_pitch"].append(mem_pitch)
    dt = dict(pitch_ol=np.int32, mem_on=np.int32)
    return {k: np.ascontiguousarray(np.stack(v) if k in ("s12k8", "mem_in") else np.asarray(v),
                                    dt.get(k, np.float32)) for k, v in cols.items()}


def side_layout_rows(seed: int = 0, n: int = 96) -> tuple[np.ndarray, np.ndarray]:
    """Side layouts and fields for the bit string of the side information
    against the backward writer, outside what a configuration gives: rows of
    1-12 bytes, fewer than the side bits (the clip at the row's first byte),
    the first side bit at, below and above the last byte (the clip at the
    last), every bandwidth and lastnz width; fields at random over all of
    int32 and at their extremes, lastnz 0 and negative (a negative
    lastnz / 2 - 1). Returns (layouts [n, 7] as side_info.cuh:SideLayout,
    fields [n, 18] in FIELD_ORDER's columns)."""
    rng = np.random.default_rng(seed)
    L = np.zeros((n, 7), np.int32)
    L[:, 0] = rng.integers(1, 13, n)
    L[:, 1] = L[:, 0] - 1 + rng.choice([0, 0, -1, 2, 9], n)
    L[:, 2] = rng.integers(0, 4, n)
    L[:, 3] = rng.integers(1, 17, n)
    ext = np.array([0, 1, -1, 2**31 - 1, -2**31, 255, 2**25 - 1, 2**24], np.int64)
    F = rng.integers(-2**31, 2**31, (n, 18), dtype=np.int64)
    pick = rng.random((n, 18)) < 0.3
    F[pick] = rng.choice(ext, int(pick.sum()))
    F[:, 4] = rng.integers(-1, 4, n)                 # num_tns
    F[:, 7] = rng.choice([0, 1, 1, 2, -1], n)        # ltpf active (1: the pitch follows)
    F[:, 12] = rng.integers(-1, 5, n)                # submode, also out of 0..3
    F[::5, 1] = 0
    F[1::5, 1] = -rng.integers(1, 1000, len(F[1::5]))
    return L, F.astype(np.int32)


NRE_ORDER = ("dy", "xq", "gain", "bw_bin", "target", "nbits2", "lsb_mode")
# the residual coder's rows at 48 and 16 kHz, at 20 bytes with the half means
NRE_CONFIGS = {"48k_64k": dict(fs_in=48000, bitrate=64000),
               "48k_16k": dict(fs_in=48000, bitrate=16000),
               "16k_32k": dict(fs_in=16000, bitrate=32000),
               "16k_16k": dict(fs_in=16000, bitrate=16000)}


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


def spec_edge_rows(cfg, seed: int = 0, n: int = 64, res_width: int | None = None
                   ) -> dict[str, np.ndarray]:
    """spec_rows with lines where a warp's ballots and ranks meet their edges:
    every other row silent but for nonzero lines drawn from the edges of the
    zero-line windows (a line width and width + 1 lines from another), of
    the bandwidth (bw_bin_nf - 1 and bw_bin_nf, with bw_idx equal to the
    previous one so that no redo moves it), of the first filled line and of
    the 32-line chunks; n_res 0, the count of nonzero lines and above it in
    turn; decoded lines of +-0.1875, which a nudge makes zero (the zero-line
    test must see the row after the residual); and on partially corrupt
    frames, whose synthesis factor is then 1 (the gains' ratio, the low band
    of q_old_d silent), previous residual lines of +-0.625, a float below it
    and above it (spec_concealed's threshold)."""
    a = spec_rows(cfg, seed, n, res_width)
    rng = np.random.default_rng(seed + 100)
    N = cfg.yLen
    width, start = (3, 24) if cfg.frame_dms == 100 else (1, {50: 12, 25: 6}[cfg.frame_dms])
    bins = T.bw_cutoff_bins(cfg.frame_dms)
    x, q_old_res, q_old_d = a["x"], a["q_old_res"], a["q_old_d"]
    below = np.nextafter(np.float32(0.625), np.float32(0))
    above = np.nextafter(np.float32(0.625), np.float32(1))
    for i in range(0, n, 2):
        a["prev_bw_idx"][i] = a["bw_idx"][i]
        bw = min(int(bins[a["bw_idx"][i]]), N)
        p = int(rng.integers(start, max(start + 1, bw - 3 * width - 3)))
        edges = [bw - 1, bw, bw + 1, bw - 2 - width, start - width - 1, start - width, start,
                 p, p + width + 1, p + 2 * width + 2, p + 2 * width + 3]
        edges += list(range(31, N, 32)) + list(range(32, N, 32))
        edges = np.array([e for e in edges if 0 <= e < N])
        keep = edges[rng.random(edges.size) < 0.6]
        x[i] = 0.0
        x[i, keep] = rng.choice([-3.0, -1.0, 1.0, 2.0], keep.size)
        if i % 8 == 0:
            x[i, edges[: edges.size // 2]] = rng.choice([-0.1875, 0.1875], edges.size // 2)
        if a["bfi"][i] == 2:
            inv = int(a["spec_inv_idx"][i])
            a["prev_gg"][i] = a["gain"][i]
            q_old_d[i, :inv] = 0.0
            q_old_d[i, inv:] = 1.0
            q_old_res[i, inv:] = rng.choice([0.625, -0.625, below, -below, above, -above, 0.0],
                                            N - inv)
    n_nz = (x != 0).sum(-1)
    a["n_res"] = np.stack([np.zeros(n), n_nz, n_nz + 5])[np.arange(n) % 3, np.arange(n)]
    a["n_res"] = a["n_res"].astype(np.int32)
    a["residual_present"][::2] = 1
    return a


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


def fec_failure_rows(slot: int = 80, n: int = 8, seed: int = 0) -> np.ndarray:
    """Random bytes that the decoder reads as no mode at all (mode -1, the
    error report 0x7FF): the EPMR estimate of a total failure, found by a
    seeded search with the plain decoder."""
    import torch
    from audio_codec_torch.ops import fec
    rng = np.random.default_rng(seed + slot)
    found = []
    while len(found) < n:
        frames = rng.integers(0, 256, (64, slot)).astype(np.int32)
        out = fec.fec_decode_plain(torch.from_numpy(frames), slot)
        hit = (out["mode"].numpy() == -1) & (out["error_report"].numpy() == 0x7FF)
        found.extend(frames[hit][: n - len(found)])
    return np.stack(found).astype(np.int32)


def fec_cap_rows(mode: int, n: int = 24, seed: int = 0) -> np.ndarray:
    """EP2-4 frames in the 40-byte slot (six codewords, all under mode
    detection) with 1-6 of them changed in 1..t nibbles: the low-rate cap
    rejects some (bfi 1, mode -1) and clears the error report's flags of
    others (al_fec.c:760-783)."""
    import torch
    from audio_codec_torch.ops import fec
    slot, t = 40, mode - 1
    rng = np.random.default_rng(seed + 10 * mode)
    sp = fec._slot_plan(slot)
    D = fec.fec_get_data_size(mode, 0, slot)
    data = rng.integers(0, 256, (n, D)).astype(np.int32)
    epmr = (np.arange(n) % 4).astype(np.int32)
    enc = fec.fec_encode_plain(torch.from_numpy(data), torch.from_numpy(epmr), slot, mode).numpy()
    cws = _codeword_nibbles(enc.astype(np.int64), slot)
    for b in range(n):
        for i in rng.choice(6, size=1 + b % 6, replace=False):
            k = int(rng.integers(1, t + 1))
            pos = rng.choice(sp["lens"][i], size=k, replace=False)
            cws[b, sp["offs"][i] + pos] ^= rng.integers(1, 16, size=k)
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


# the side fields ari_decode reads, in the order of decode_rows' keys
DECODE_SIDE_KEYS = ("lastnz", "lsb_mode", "num_tns", "tns_on", "bp_side", "mask_side",
                    "gg_idx", "fac_ns_idx")
# the configurations of decode_rows: no PC block (at 64 and 160 kbps and in
# the high-resolution mode) and the EP modes whose frames carry one
DECODE_CONFIGS = {"48k_64k": dict(fs_in=48000, bitrate=64000),
                  "48k_160k": dict(fs_in=48000, bitrate=160000),
                  "48k_hr": dict(fs_in=48000, bitrate=256000, hrmode=True),
                  "ep3": dict(fs_in=48000, bitrate=64000, epmode=3),
                  "ep4": dict(fs_in=48000, bitrate=64000, epmode=4)}


@functools.cache
def decode_rows(name: str, seed: int = 3) -> dict[str, np.ndarray]:
    """Frames for the range decoder at DECODE_CONFIGS[name]: coder_rows
    coded by the plain range encoder (escapes to the last level and past it,
    LSB-mode rows, TNS orders 0-12, rows over their budget), with the side
    information the encoder set (DECODE_SIDE_KEYS; the TNS filters on where
    their order is nonzero, a gain index of 0 and a noise factor of 7 on
    every third row, so that zero frames occur); every seventh row has 1-24
    bytes replaced. At EP3/EP4 the channel's flags of pc_decode_rows follow
    (bfi_in 0 and 2 in turn, four corrupt ranges), and pc_decode_rows' own
    frames (the encoder's payloads with the PC block moved) are appended."""
    import torch
    import audio_codec_torch as P
    from audio_codec_torch.ops import ari, bits
    cfg = P.Config(**DECODE_CONFIGS[name])
    d = coder_rows(cfg, seed=seed)
    args = tuple(torch.from_numpy(np.ascontiguousarray(d[k], dtype=np.int32))
                 for k in CODER_ARI_ORDER)
    frames = ari.encode_plain(cfg, *args).numpy().astype(np.int32)
    rng = np.random.default_rng(seed)
    for i in range(0, len(frames), 7):
        at = rng.integers(0, frames.shape[1], rng.integers(1, 25))
        frames[i, at] = rng.integers(0, 256, at.size)
    third = np.arange(len(frames)) % 3 == 0
    out = {"frames": frames, "lastnz": d["lastnz"], "lsb_mode": d["lsb_mode"],
           "num_tns": d["num_tns"], "tns_on": (d["tns_order"] > 0).astype(np.int32),
           "bp_side": d["bp_side"], "mask_side": d["mask_side"],
           "gg_idx": np.where(third, 0, 17).astype(np.int32),
           "fac_ns_idx": np.where(third, 7, 3).astype(np.int32)}
    if cfg.n_pc == 0:
        return out
    pc = pc_decode_rows(cfg.epmode, seed=seed)
    side = bits.parse_side_info_plain(cfg, torch.from_numpy(pc["frames"]))
    out = {k: np.concatenate([v, pc["frames"] if k == "frames" else
                              side[k].numpy().astype(np.int32)]) for k, v in out.items()}
    L = len(out["frames"])
    pcb = (cfg.n_pc + 1) >> 1
    spans = [(0, 8 * pcb - 1), (4 * pcb, 8 * pcb - 1), (8, 15), (0, 7)]
    bfi_in = np.where(np.arange(L) % 2 == 1, 2, 0).astype(np.int32)
    out["bfi_in"] = bfi_in
    out["be_l"] = np.where(bfi_in == 2, [spans[i // 2 % 4][0] for i in range(L)], -1)
    out["be_r"] = np.where(bfi_in == 2, [spans[i // 2 % 4][1] for i in range(L)], -1)
    out["be_l"], out["be_r"] = (out[k].astype(np.int32) for k in ("be_l", "be_r"))
    return out


def biquad_rows(B: int, frames: int = 3, seed: int = 0) -> np.ndarray:
    """[frames, B, 128] float32 input rows of the resampler's biquad:
    seeded noise at levels from 1 to 3e4, a silent stream, a full-scale
    square wave, and a stream of tiny values (1e-30)."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((frames, B, 128)) * 10.0 ** rng.uniform(0, 4.5, (1, B, 1))
    x[:, 0] = 0.0
    if B > 1:
        x[:, 1] = np.where(np.arange(128) % 16 < 8, 32767.0, -32768.0)
    if B > 2:
        x[:, 2] *= 1e-34
    return np.ascontiguousarray(x, dtype=np.float32)


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


# the rows of phecu_edge_rows, in order
PHECU_EDGE_ROWS = ("tie", "edges", "mode 1 at the end", "bin 0", "all zero", "noise",
                   "dense, dropped", "dense, kept")


def phecu_edge_rows(seed: int = 0) -> dict[str, np.ndarray]:
    """Spectra [8, PHECU_BINS] (real, imag, and the window a frame earlier)
    and norm_corr for the peak analysis's edges (PHECU_EDGE_ROWS): a plateau
    of three equal magnitudes (the later bin wins, `>=`); peaks at bins 1
    and 319 (the parabola's edge bins); a rise at bin 320 that ends the scan
    in mode 1; a maximum at bin 0 (a rising test there compares the bin with
    itself, so bin 0 is never a peak) with a peak at bin 2; an all-zero
    spectrum; seeded complex noise (many peaks); a comb of more than 14
    peaks with one in bins 1-6 at norm_corr 0.3 (dropped) and the same at
    0.5 (kept)."""
    rng = np.random.default_rng(800 + seed)
    n = PHECU_BINS
    noise = lambda s: (rng.standard_normal(n) + 1j * rng.standard_normal(n)) * s
    rows = np.zeros((len(PHECU_EDGE_ROWS), n), np.complex128)
    rows[0] = noise(10.0)
    rows[0, 100:103] = 5e4                    # equal magnitudes, imaginary parts 0
    rows[1] = noise(10.0)
    rows[1, 1], rows[1, 319] = 6e4, 7e4 * np.exp(0.7j)
    rows[2] = noise(10.0)
    rows[2, 320] = 8e4
    rows[3] = noise(10.0)
    rows[3, 0], rows[3, 2] = 9e4, 5e4
    rows[5] = noise(1000.0)
    comb = np.zeros(n, np.complex128)
    for k in range(3, n - 3, 9):
        comb[k] = 4e4 * np.exp(1j * rng.uniform(0, 6))
    rows[6] = rows[7] = comb + noise(50.0)
    old = np.stack([noise(3000.0) for _ in range(len(PHECU_EDGE_ROWS))])
    old[4] = 0.0
    nc = np.array([0.9, 0.8, 0.7, 0.6, 0.2, 0.6, 0.3, 0.5], np.float32)
    f = lambda a: a.astype(np.float32)
    return dict(Xr=f(rows.real), Xi=f(rows.imag), Xor=f(old.real), Xoi=f(old.imag), nc=nc)


def phecu_edges_reached(f0, npl) -> dict[str, bool]:
    """Which of phecu_edge_rows' branches the analysis's outputs (f0est [8,
    bins], num_plocs [8]) show: the tie taken by the later bin, the edge
    peaks, the scan's end in mode 1, no peak at bin 0, the silent row, and
    the drop rule on the comb at norm_corr 0.3 and not at 0.5."""
    f0, npl = np.asarray(f0), np.asarray(npl)
    return {"tie to the later bin": bool(f0[0, 102] >= 0 and (f0[0, 100:102] < 0).all()),
            "peaks at bins 1 and 319": bool(f0[1, 1] >= 0 and f0[1, 319] >= 0),
            "a peak at bin 320 (mode 1 at the end)": bool(f0[2, 320] >= 0),
            "no peak at bin 0": bool(f0[3, 0] < 0 and f0[3, 2] >= 0),
            "all-zero row": bool(npl[4] == 0),
            "many peaks": bool(npl[5] > 14),
            "drop": bool(npl[6] == 0 and npl[7] > 14 and (f0[7, 1:7] >= 0).any())}


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


# the arguments of phecu_subst and plc_damp_scramble after cfg, in order, and
# the latter's masks
PHECU_SUBST_ARGS = ("Xr", "Xi", "f0est", "num_plocs", "nb_cur", "e_oold", "e_old", "mag_chg_1st",
                    "beta_mute", "xavg", "is_trans", "active")
DAMP_ARGS = ("x", "q_d_prev", "ns_lane", "lost", "is_pc", "nb_cur", "pc_nb_lost", "stab_fac",
             "pitch_int", "pc_pitch", "cum_fflc", "cum_slow", "cum_fast", "ns_seed", "pc_seed",
             "spec_inv_idx")
DAMP_MASKS = ("ns_lane", "lost", "is_pc")

# the rows of phecu_subst_edge_rows, in order
PHECU_SUBST_EDGE_ROWS = ("edge peaks", "equidistant", "adjacent", "one peak", "two peaks",
                         "transient", "long burst", "no peak")
PHECU_NBINS = 385    # plc_phecu.nbins at 48 kHz
PHECU_FL, PHECU_T_ADV = 480, 684   # the frame and plc_phecu.t_adv at 48 kHz


def phecu_subst_edge_rows(seed: int = 0) -> dict[str, np.ndarray]:
    """Inputs of phecu_subst (every stream active) for the substitution's
    edges (PHECU_SUBST_EDGE_ROWS): peaks at bins 0-5 and 315-320; bins
    equidistant from two peaks (at 2 and at 5, the upper peak wins); three
    adjacent peaks; num_plocs 1 and 2 (the zero rule); a transient stream; a
    burst of 100 frames with peaks at bins 305 and 310, whose angles (above
    105 615) take the card's sinf and cosf down their slow path; a stream
    with no peak. Seeded noise spectra [385] with the peaks raised."""
    rng = np.random.default_rng(900 + seed)
    B, ns, nsf = len(PHECU_SUBST_EDGE_ROWS), PHECU_BINS, PHECU_NBINS
    peaks = {0: [0, 1, 2, 3, 4, 5, 315, 316, 317, 318, 319, 320], 1: [100, 104, 200, 210, 260],
             2: [150, 151, 152], 3: [60], 4: [90, 240], 5: [40, 80, 120], 6: [20, 305, 310], 7: []}
    f0 = np.full((B, ns), -1.0, np.float32)
    X = (rng.standard_normal((B, nsf)) + 1j * rng.standard_normal((B, nsf))) * 300.0
    npl = np.zeros(B, np.int32)
    for b, ks in peaks.items():
        for k in ks:
            frac = rng.uniform(-0.45, 0.45) if k > 0 else rng.uniform(0.0, 0.45)
            f0[b, k] = np.float32(k + frac)
            X[b, k] *= 40.0
        npl[b] = len(ks)
    e = (np.abs(rng.standard_normal((2, B, 9))) * 1e8).astype(np.float32)
    e[0, 5] *= 20.0                      # a falling transient in the groups
    return dict(Xr=X.real.astype(np.float32), Xi=X.imag.astype(np.float32), f0est=f0, num_plocs=npl,
                nb_cur=np.array([1, 2, 4, 1, 3, 2, 100, 5], np.int32),
                e_oold=e[0], e_old=e[1], mag_chg_1st=(rng.random((B, 9)) * 1.2).astype(np.float32),
                beta_mute=rng.random(B).astype(np.float32),
                xavg=(rng.random((B, 9)) * 300).astype(np.float32),
                is_trans=(np.arange(B) == PHECU_SUBST_EDGE_ROWS.index("transient")).astype(
                    np.int32),
                active=np.ones(B, bool))


def phecu_subst_edges_reached(r: dict) -> dict[str, bool]:
    """Which of phecu_subst_edge_rows' edges the rows r (the arguments, as
    numpy arrays) hold: peaks at the edge bins, a bin equidistant from two
    peaks with none nearer, adjacent peaks, 1 and 2 peaks with no
    transient, a transient with peaks, all 32 generator phases on the
    interior bins of each seed, and a peak angle past 105 615."""
    from audio_codec_torch.ops import plc_phecu as H
    pk = (r["f0est"] >= 0) & (r["num_plocs"] > 0)[:, None] & (r["is_trans"] == 0)[:, None] \
        & r["active"][:, None]
    ns = pk.shape[1]

    def equidistant(row):
        for k in range(1, ns):
            for d in range(1, 6):
                if not pk[row, max(k - d + 1, 0):k + d].any() and k - d >= 0 and k + d < ns \
                        and pk[row, k - d] and pk[row, k + d]:
                    return True
        return False
    tab = H.lcg_tables(ns)
    phases = set()
    for nb in r["nb_cur"][r["active"]]:
        t = max(int(nb) - 1, 0) * PHECU_FL
        for s0 in (t, t + 1):
            phases |= set((((s0 % 65536) * tab[0, 1:] + tab[1, 1:]) & 0xFFFF) >> 11)
    t_off = np.maximum(r["nb_cur"].astype(np.float64) - 1, 0) * PHECU_FL
    ang = 2 * np.pi * np.where(pk, r["f0est"], 0.0) * (PHECU_T_ADV + t_off)[:, None] / PHECU_LPROT
    npl = np.where(r["is_trans"] != 0, 0, r["num_plocs"])
    edges = pk[:, :6].all(1).any() and pk[:, ns - 6:].all(1).any()
    return {"peaks at bins 0-5 and 315-320": bool(edges),
            "a bin equidistant from two peaks": any(equidistant(b) for b in range(len(pk))),
            "adjacent peaks": bool((pk[:, 1:] & pk[:, :-1]).any()),
            "one and two peaks (the zero rule)": bool((npl == 1).any() and (npl == 2).any()),
            "a transient with peaks": bool(((r["is_trans"] != 0) & (r["num_plocs"] > 0)).any()),
            "all 32 generator phases": len(phases) == 32,
            "a peak angle past 105 615": bool((ang > 105615.0).any())}


# the rows of damp_edge_rows, in order, and their (ns_lane, lost, is_pc,
# nb_cur, pc_nb_lost, pitch_int, pc_pitch, spec_inv_idx)
DAMP_EDGE_ROWS = ("bfi 2 from bin 0", "bfi 2 from bin 1", "bfi 2 from bin 398",
                  "bfi 2 from bin 399", "bfi 2 from bin 400", "all zero", "60 dB",
                  "threshold, noise substitution", "threshold, bfi 2")
DAMP_EDGE_LANES = (
    (0, 0, 1, 0, 3, 200, 1, 0),
    (0, 0, 1, 0, 4, 200, 1, 1),
    (0, 0, 1, 0, 2, 0, 0, 398),
    (0, 0, 1, 0, 5, 100, 1, 399),
    (0, 0, 1, 0, 3, 100, 1, 400),
    (1, 1, 0, 2, 0, 0, 0, 400),
    (1, 1, 0, 3, 0, 250, 0, 400),
    (1, 1, 0, 4, 0, 300, 0, 400),   # lin 0.5: the threshold -16384
    (0, 0, 1, 0, 3, 0, 1, 0),       # lin 0.75: the threshold -24576
)
DAMP_THRESHOLD_BIN = 37   # the bin whose generator value sits on the threshold


def _damp_values(seed: int, N: int) -> np.ndarray:
    """The sign scrambling's generator values at bins 0..N-1 from seed."""
    from audio_codec_torch.ops.plc_adv import lcg_pows
    pows = lcg_pows(N)
    s = ((seed & 0xFFFF) * pows[0, 1:] + pows[1, 1:]) & 0xFFFF
    return np.where(s >= 32768, s - 65536, s)


def _damp_seed_at(value: int, k: int, N: int) -> int:
    """The seed whose generator value at bin k is `value` (the step's
    multiplier is odd, so invertible mod 2^16)."""
    from audio_codec_torch.ops.plc_adv import lcg_pows
    pows = lcg_pows(N)
    m, a = int(pows[0, k + 1]), int(pows[1, k + 1])
    s = ((value & 0xFFFF) - a) * pow(m, -1, 65536) % 65536
    return s - 65536 if s >= 32768 else s


def damp_edge_rows(seed: int = 0) -> dict[str, np.ndarray]:
    """Inputs of plc_damp_scramble for its edges (DAMP_EDGE_ROWS): partial
    concealment from bins 0, 1, 398, 399 and 400 (nothing left to
    scramble), an all-zero substituted spectrum (energy 0), a substituted
    row spanning 60 dB, and a generator value on the sign threshold
    (-32768 lin) in a noise-substitution and a partial-concealment pass;
    the seeds -32768 and 32767 on the first two rows."""
    rng = np.random.default_rng(950 + seed)
    B, N = len(DAMP_EDGE_ROWS), 400
    cols = np.array(DAMP_EDGE_LANES, np.int32).T
    out = {k: cols[i].copy() for i, k in enumerate(DAMP_STREAM_INTS)}
    x = (rng.standard_normal((B, N)) * 300).astype(np.float32)
    q = (rng.standard_normal((B, N)) * 300).astype(np.float32)
    q[DAMP_EDGE_ROWS.index("all zero")] = 0.0
    span = 10.0 ** rng.uniform(0.0, 3.0, N) * rng.choice([-1.0, 1.0], N)
    span[[7, 230]] = 1.0, -1000.0
    q[DAMP_EDGE_ROWS.index("60 dB")] = span.astype(np.float32)
    ns_seed = rng.integers(-32768, 32768, B).astype(np.int32)
    pc_seed = rng.integers(-32768, 32768, B).astype(np.int32)
    pc_seed[0], pc_seed[1] = -32768, 32767
    ns_seed[DAMP_EDGE_ROWS.index("threshold, noise substitution")] = \
        _damp_seed_at(-16384, DAMP_THRESHOLD_BIN, N)
    pc_seed[DAMP_EDGE_ROWS.index("threshold, bfi 2")] = _damp_seed_at(-24576, DAMP_THRESHOLD_BIN, N)
    out.update(x=x, q_d_prev=q, stab_fac=rng.random(B).astype(np.float32),
               cum_fflc=rng.random(B).astype(np.float32), cum_slow=rng.random(B).astype(np.float32),
               cum_fast=rng.random(B).astype(np.float32), ns_seed=ns_seed, pc_seed=pc_seed)
    return out


def damp_edges_reached(d: dict) -> dict[str, bool]:
    """Which of damp_edge_rows' edges the rows d hold: partial concealment
    from bins 0, 1, 398, 399 and 400, an all-zero and a 60 dB substituted
    row, and a generator value equal to the pass's sign threshold (a pitched
    pass: -32768 lin) at a scrambled bin of a noise-substitution and of a
    partial-concealment pass."""
    N = d["x"].shape[1]
    ns, pc = d["ns_lane"] != 0, d["is_pc"] != 0
    sub = np.abs(d["q_d_prev"][ns])

    def lin(nb):
        return min(max((6 - nb) / 4.0, 0.0), 1.0) if nb > 2 else 1.0

    def on_threshold(seed, nb, inv):
        return bool((_damp_values(int(seed), N)[inv:] == -32768.0 * lin(int(nb))).any())
    span = sub.max(1) / np.maximum(sub.min(1), 1e-30)
    return {"spec_inv_idx 0, 1, 398, 399, 400":
                {0, 1, 398, 399, 400} <= set(d["spec_inv_idx"][pc].tolist()),
            "an all-zero spectrum": bool((sub.max(1) == 0).any()),
            "a row spanning 60 dB": bool((span >= 999.0).any()),
            "the threshold in a noise-substitution pass": any(
                on_threshold(d["ns_seed"][b], d["nb_cur"][b], 0)
                for b in np.nonzero(ns & (d["pitch_int"] > 0))[0]),
            "the threshold in a bfi 2 pass": any(
                on_threshold(d["pc_seed"][b], d["pc_nb_lost"][b], d["spec_inv_idx"][b])
                for b in np.nonzero(pc & (d["pc_pitch"] != 0))[0])}


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


TDC_EDGE_KEYS = ("lost", "nb", "pitch", "fract", "meth", "seed", "fract_st", "harm_len", "stab",
                 "gain_c", "alpha", "x_old_tot", "scf", "q_d", "a_st", "harm", "synth_hist")


def _tdc_lane(d: dict, b: int) -> dict:
    return {k: np.asarray(d[k])[b] for k in TDC_EDGE_KEYS}


def tdc_edge_rows() -> dict[str, np.ndarray]:
    """33 streams: the three TDC_LANES groups, the same lanes with halved
    histories and other seeds, and the edge rows: a first loss with a
    full-scale history (TD-PLC), a first loss with a subnormal history, a
    later loss whose memory, harmonic cycle and excitation are subnormal, a
    later loss from a synthesis memory of +0 and -0 over a silent
    excitation, and losses past the fade-out (the last concealed frame and
    a silent one)."""
    lanes = []
    for group in TDC_LANES:
        d = tdc_stream_rows(group)
        lanes += [_tdc_lane(d, b) for b in range(4)]
    for group in TDC_LANES:
        d = tdc_stream_rows(group)
        for b in range(4):
            e = _tdc_lane(d, b)
            e["x_old_tot"] = (e["x_old_tot"] * 0.5).astype(np.float32)
            e["seed"] = np.int32((int(e["seed"]) + 977) % 32768)
            lanes.append(e)
    voiced = _tdc_lane(tdc_stream_rows(0), 0)           # a first loss TD-PLC takes
    full = dict(voiced)
    full["x_old_tot"] = np.clip(voiced["x_old_tot"] * 64.0, -32767, 32767).astype(np.float32)
    tiny = dict(voiced)
    tiny["x_old_tot"] = (voiced["x_old_tot"] * np.float32(2.0 ** -140)).astype(np.float32)
    later = dict(voiced, lost=np.bool_(True), nb=np.int32(2), meth=np.int32(3),
                 gain_c=np.float32(0.0))
    stable = np.zeros(17, np.float32)                 # a stable order-2 filter
    stable[:3] = (1.0, -0.9, 0.2)
    sub = dict(later, a_st=stable)
    sub["x_old_tot"] = (voiced["x_old_tot"] * np.float32(2.0 ** -140)).astype(np.float32)
    sub["synth_hist"] = (voiced["synth_hist"] * np.float32(2.0 ** -140)).astype(np.float32)
    sub["harm"] = (voiced["harm"] * np.float32(2.0 ** -136)).astype(np.float32)
    zero = dict(later, a_st=stable)
    zero["x_old_tot"] = np.zeros_like(voiced["x_old_tot"])
    zero["synth_hist"] = np.where(np.arange(16) % 2 == 0, np.float32(0.0), np.float32(-0.0))
    zero["harm"] = np.zeros_like(voiced["harm"])
    fade = dict(later, nb=np.int32(6), gain_c=np.float32(120.0))
    silent = dict(later, nb=np.int32(7), gain_c=np.float32(120.0))
    lanes += [full, tiny, sub, zero, fade, silent]
    lanes += lanes[:33 - len(lanes)]
    return {k: np.stack([np.asarray(e[k]) for e in lanes]) for k in TDC_EDGE_KEYS}


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


# the bands of every configuration's SNS interpolation (Config.bands_number
# over the rates and frame sizes)
FX_SNS_BANDS = (20, 35, 39, 40, 43, 44, 50, 52, 54, 55, 64)
# (DIM, KVAL, size) of the de-index shapes: submodes 0-1's 10-pulse set,
# submode 0's 6-position set (1 pulse), submode 2's and submode 3's
FX_SNS_SHAPES = ((10, 10, MPVQ_SPLIT), (6, 1, MPVQ_6K1), (16, 8, MPVQ_NEAR), (16, 6, MPVQ_FAR))


def fx_sns_sample_rows(n_per: int = 200, seed: int = 0) -> np.ndarray:
    """[4 n_per + 12, 7] int32 SNS indices: of each submode a seeded sample of
    its main set's MPVQ indices over the whole range with the first and last
    among them, both leading signs; and submode 0's 6-position set whole
    (each of its 12 values of scf_idx[6])."""
    rng = np.random.default_rng(seed)
    rows = []
    for s in range(4):
        g = scf_idx_grid(s, n_per, seed + 11)
        size = SUBMODES[s][1]
        g[:, 5] = rng.integers(0, size, n_per)
        g[:4, 5] = [0, size - 1, 1, size - 2]
        g[:, 4] = rng.integers(0, 2, n_per)
        rows.append(g)
    g = scf_idx_grid(0, 2 * MPVQ_6K1, seed + 12)
    g[:, 6] = np.arange(2 * MPVQ_6K1)
    rows.append(g)
    return np.concatenate(rows).astype(np.int32)


def fx_sns_edge_rows(seed: int = 0) -> np.ndarray:
    """SNS indices past their ranges: MPVQ indices at and past each set's
    size and negative (the `ber` lanes and the de-index of a negative
    index), submode 0's 6-position index at and past its set, leading signs
    other than 0 and 1; and the clamps: codebook indices below 0 and above
    31, gain indices below 0 and past each submode's table, submodes -1 and
    4 (the plain version de-indexes them as submode 3's shape with submode 0's
    or 3's gains and largest k)."""
    rng = np.random.default_rng(seed)
    rows = []
    for s in range(4):
        size = SUBMODES[s][1]
        g = scf_idx_grid(s, 6, seed + 21)
        g[:, 5] = [size, size + 1, size + 123457, -1, -2, -(1 << 30)]
        g[:, 4] = [0, 1, 2, -1, 0, 1]
        rows.append(g)
    g = scf_idx_grid(0, 4, seed + 22)
    g[:, 6] = [2 * MPVQ_6K1, 2 * MPVQ_6K1 + 1, 4 * MPVQ_6K1 + 3, -3]
    rows.append(g)
    for s in (-1, 0, 1, 2, 3, 4):
        g = scf_idx_grid(min(max(s, 0), 3), 6, seed + 23)
        g[:, 2] = s
        g[:, 0] = [-5, 40, 0, 31, 7, -1]
        g[:, 1] = [33, -2, 31, 0, 100, 5]
        g[:, 3] = [-1, 9, 2, 3, 7, 100]
        g[:, 5] = rng.integers(0, MPVQ_FAR, 6)
        rows.append(g)
    return np.concatenate(rows).astype(np.int32)


def fx_sns_deindex_offsets(dim: int, kval: int, ls: int, index: int) -> list[list[int]]:
    """The offsets h[0..k_max] of mpvq_deindex_fx's recurrence at each
    position it counts at, for one index (the plain version's a_bwd update,
    ops/fixed_dev.py:_mpvq_deindex_batch, on one lane in Python integers)."""
    from audio_codec_torch.ops.fixed_dev import mpvq_offsets
    h = list(mpvq_offsets(dim, kval))
    size = 1 + h[kval + 1] + (h[kval] >> 1)
    ind = 0 if (dim != 1 and index >= size) else index
    k_max, seen = kval, []
    for _ in range(dim):
        if ind == 0:
            break
        seen.append(h[: k_max + 1])
        cnt = sum(1 for k in range(kval + 2) if k <= k_max and h[k] <= ind)
        k_acc = min(max(cnt - 1, 0), kval)
        ind2 = ind - h[k_acc]
        if k_max - k_acc != 0:
            ind, k_max = ind2 >> 1, k_acc
        else:
            ind = ind2
        a0 = 0
        for i in range(1, kval + 2):
            if i <= k_max + 1:
                a1 = h[i] - a0 - h[i - 1]
                h[i - 1] = a0
                a0 = a1
        if k_max + 1 < kval + 2:
            h[k_max + 1] = a0
    return seen


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



def fx_spec_tns_rows() -> dict[str, np.ndarray]:
    """fx_spec_rows (48 frames: silent, zero, full-scale, order-8 frames,
    every bandwidth) then, at bandwidth 4 (both filters possible) and 1 (one
    filter), every order 1-8: filter 0 alone, both filters, filter 1 alone,
    filter 0 alone at bandwidth 1; TNS off; and full-scale spectra with the
    extreme reflection indices, whose taps saturate (48 kHz, 64 kbps)."""
    from audio_codec_torch.config import Config
    cfg = Config(fs_in=48000, bitrate=64000)
    base = fx_spec_rows(cfg)
    extra = fx_spec_rows(cfg, seed=5, n=40)
    n = 40
    o = np.zeros((n, 2), np.int32)
    bw = np.full(n, 4, np.int32)
    for k in range(8):
        o[k] = (k + 1, 0)                 # filter 0 alone
        o[8 + k] = (k + 1, 8 - k)         # both filters
        o[16 + k] = (0, k + 1)            # filter 1 alone
        o[24 + k] = (k + 1, k + 1)
        bw[24 + k] = 1                    # one filter: bandwidth below 3
    o[32:36] = 0                          # TNS off
    o[36:40] = (8, 8)
    extra["tns_order"] = o
    extra["bw_idx"] = bw
    extra["zero_frame"][:] = 0
    extra["zero_frame"][34] = 1
    rng = np.random.default_rng(17)
    full = np.where(rng.random((8, cfg.yLen)) < 0.5, -32767, 32767).astype(np.int32)
    extra["x"][32:40] = full
    extra["x"][12:16] = full[:4]
    extra["tns_idx"][36:40] = np.where(rng.random((4, 2, 8)) < 0.5, 0, 16)
    extra["tns_idx"][12:16] = np.where(rng.random((4, 2, 8)) < 0.5, 0, 16)
    return {k: np.concatenate([base[k], extra[k]]) for k in base}


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


def fx_dct4_edge_rows(seed: int = 0) -> tuple[np.ndarray, np.ndarray]:
    """(y [14, 480] int64, y_e [14]) at the edges of the kernel's 32-bit
    words: a row holding -2^31 (headroom 0), a row of -2^31 and one
    alternating -2^31 and 2^31 - 1, rows of headroom 31 (every nonzero
    value -1) and 30 (values -2..1), rows the pre-scale takes to full scale
    (largest values 2^k - 1 and -2^k, shifted by 31 - k, k = 20 and 7),
    all-zero rows among nonzero ones, a row nonzero at bin 399 alone (the
    cap's last bin) and seeded rows of headroom 0 to 3."""
    rng = np.random.default_rng(950 + seed)
    M = 1 << 31
    n = 480
    lap = lambda s: np.floor(rng.laplace(0, 1, n) * s)
    one_min = np.clip(lap(2.0 ** 24), -M, M - 1)
    one_min[int(rng.integers(0, 400))] = -M
    alt = np.where(np.arange(n) % 2 == 0, -M, M - 1)
    h31 = np.where(rng.random(n) < 0.4, -1, 0)
    h30 = rng.integers(-2, 2, n)
    full = []
    for k in (20, 7):
        r = np.clip(lap(2.0 ** (k - 3)), -(1 << k) + 1, (1 << k) - 2)
        r[int(rng.integers(0, 200))] = (1 << k) - 1
        r[int(rng.integers(200, 400))] = -(1 << k)
        full.append(r)
    bin399 = np.zeros(n)
    bin399[399] = -12345
    seeded = [np.clip(lap(2.0 ** (27 + h)), -M, M - 1) for h in range(4)]
    y = np.stack([one_min, np.full(n, -M), alt, h31, np.zeros(n), h30, *full, np.zeros(n),
                  bin399, *seeded]).astype(np.int64)
    y_e = rng.integers(-12, 30, len(y)).astype(np.int64)
    return y, y_e


LTPF_PLAN = ("passthrough", "pat2", "pat3", "pat4", "pat1")


def _norm_l(v: np.ndarray) -> np.ndarray:
    m = np.where(v < 0, ~v, v)
    bl = np.array([int(a).bit_length() for a in m.ravel()]).reshape(v.shape)
    return np.where(v == 0, 0, 31 - bl)


def fx_ola_plan(B: int = 8, seed: int = 0, N: int = 480) -> dict[str, np.ndarray]:
    """Five frames of fx_ola_ltpf inputs that walk every stream through the
    passthrough, pat2 (LTPF switched on), pat3 (same pitch), pat4 (a new
    pitch: the crossfade) and pat1 (switched off). Pitch indices from all
    three of the decoder's ranges; seeded frames at several levels and
    exponents (the passthrough's history shifts both ways), an all-zero
    frame in some streams. Keys: ytda [5, B, N] (N the frame length, 480
    at 48 kHz, 80 at 8 kHz), y_e, y_s [5, B] int64, zero [5, B] bool, lp
    [5, B, 3] int32 (the LTPF side words: on, active, pitch index)."""
    rng = np.random.default_rng(1000 + seed)
    T = len(LTPF_PLAN)
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


def _full_scale(N: int, sign: int, period: int) -> np.ndarray:
    """A frame at the int32 limits, its sign flipping every `period` samples."""
    s = np.where((np.arange(N) // period) % 2 == 0, sign, -sign)
    return np.where(s > 0, (1 << 31) - 1, -(1 << 31)).astype(np.int64)


def fx_ola_edge_plan(B: int = 16, seed: int = 0, N: int = 480) -> dict[str, np.ndarray]:
    """fx_ola_plan with its first 10 streams set to edges
    of the post-filter: the pitch indices at the ends of the decoder's three
    ranges (0, 379, 380, 439, 440, 511); the LTPF field off with the filter
    active (pitch_int 0, so pitch_int <= shift: the pass in the reference's
    own order) switched on after and before a real pitch, so that pat2,
    pat3, pat4 (either pass) and pat1 run a pass at pitch 0 with each fade
    sign; a silent stream; full-scale frames (every sample at the int32
    limits) at exponents 60, 45 and 30, so that the PCM's shift up saturates
    and wraps past 64 bits where it is not clamped."""
    assert B >= 10
    p = fx_ola_plan(B, seed, N)
    lp, ytda, y_e, y_s, zero = p["lp"], p["ytda"], p["y_e"], p["y_s"], p["zero"]
    on = lambda s, frames, pidx, ltpf=1: (lp.__setitem__((frames, s, 0), ltpf),
                                          lp.__setitem__((frames, s, 1), 1),
                                          lp.__setitem__((frames, s, 2), pidx))
    for s, (a, b) in enumerate(((0, 511), (379, 380), (439, 440))):
        on(s, slice(1, 3), a)
        on(s, 3, b)
        lp[4, s] = (1, 0, b)
    # pitch 0 from the start: pat2 and pat3 at pitch 0, pat4's first pass at
    # the old pitch 0, pat1 at a real pitch
    on(3, slice(1, 3), 77, ltpf=0)
    on(4, 3, 200)
    lp[4, 3] = (0, 0, 0)
    on(3, 3, 200)
    # a real pitch, then pitch 0: pat4's second pass and phase 2 at pitch 0,
    # pat1's fade-out at the old pitch 0
    on(4, slice(1, 3), 100)
    on(4, 3, 5, ltpf=0)
    lp[4, 4] = (0, 0, 0)
    # silent
    zero[:, 5] = True
    ytda[:, 5] = 0
    # full scale
    for s, (e, sign, period) in zip((6, 7, 8), ((60, 1, 7), (45, -1, 1), (30, 1, N))):
        ytda[:, s] = _full_scale(N, sign, period)
        zero[:, s] = False
        y_e[:, s] = e
    on(9, slice(1, 4), 300)
    ytda[:, 9] = _full_scale(N, -1, 3)
    zero[:, 9] = False
    y_e[:, 9] = 52
    nz = np.where(ytda != 0, _norm_l(ytda), 32).min(axis=2)
    p["y_s"] = np.where(zero, 31, nz - 1).astype(np.int64)
    return p


def fx_ola_pass_lags(st: dict, lp, fs_idx: int, sfi: int) -> dict[str, int]:
    """The post-filter passes one fx_ola_ltpf frame runs, by d = pitch_int -
    shift of the pass: "d <= 0" (lane 0 in the reference's order), "d < 32"
    (chunks shorter than a warp) and "d >= 32". st: the state before the
    frame (tensors); lp [B, 3]."""
    import torch
    from audio_codec_torch.ops import fixed_ltpf_dev as fld
    geo = fld.filter_geometry(fs_idx)
    lp = torch.as_tensor(np.asarray(lp)).to(torch.int64)
    st = {k: torch.as_tensor(st[k]).cpu() for k in ("mem_active", "pitch_int", "pitch_fr")}
    pint, pfr = fld.decode_pitch(lp[:, 0], lp[:, 2], geo["pitch_scale"])
    active = lp[:, 1] if sfi >= 0 else torch.zeros_like(lp[:, 1])
    mem = st["mem_active"] != 0
    passthrough = (active == 0) & ~mem
    same = (pint == st["pitch_int"]) & (pfr == st["pitch_fr"])
    pat1 = (active == 0) & ~passthrough
    pat4 = (active != 0) & mem & ~same
    use_old = pat1 | pat4
    passes = [(torch.where(use_old, st["pitch_int"], pint), ~passthrough), (pint, pat4),
              (pint, (active > 0) & ~passthrough)]
    d = torch.cat([(pi - geo["shift"])[m] for pi, m in passes])
    return {"d <= 0": int((d <= 0).sum()), "d < 32": int(((d > 0) & (d < 32)).sum()),
            "d >= 32": int((d >= 32).sum())}


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
    """Keep the arguments of every kernel launch (of the named wrappers; by
    default every kernel's and ari_decode_frames, the parsed mode of
    ari_decode), in order, as (args, kwargs) in store[wrapper name]; with
    copy, copies of the tensors (a kernel that updates its state in place,
    fx_ola_ltpf)."""
    import torch
    from audio_codec_torch import kernels as K
    saved = {n: getattr(K, n) for n in (names or K.KERNELS + ("ari_decode_frames",))}

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
