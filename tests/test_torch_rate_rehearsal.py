"""The warp designs of the TNS filter analysis (K6 analysis) and the gain
bisection (K7), compiled for the CPU, against their plain versions.

csrc/tns_analysis.cuh (`tns_filter_analysis_warp`) and csrc/gain_bisection.cuh
(`gain_bisection_warp`) are templates over the warp that runs them. Here g++
builds them with the host warp (csrc/warp.cuh: `CoderHostWarp`, one thread
running the 32 lanes of each step in turn, every shuffle and ballot reading
all lanes before it writes any) into a shared library, called through
ctypes, and every output must equal the plain version's
(ops/tns.py:tns_filter_analysis_plain with its prediction gains, run in the
card's order; ops/quant.py:gain_bisection_plain) bit for bit: on the inputs
the port's encoder gives both kernels at 48 kHz and 64 and 32 kbps, on
tests/torch_kernel_cases.py:tns_rows one stream and 33 streams at a time,
and on gain_rows at M = 25, 50, 100 and 120 blocks from every configuration's
starting offset. A test in torch alone holds the premise of the gain
bisection's design: the 255 offsets of the decision tree tested at once and
walked afterwards give the plain version's offset. Copies of the headers
with one line changed must fail. It skips where there is no g++."""
from __future__ import annotations

import functools

import numpy as np
import pytest
import torch

import audio_codec_torch as P
from audio_codec_torch import kernels as K
from audio_codec_torch.ops import numerics, quant, tns

from tests import torch_kernel_cases as C
from tests.test_torch_lane_rehearsal import TNS_REHEARSE, build_wrapper, lane_tns, ptr

WRAPPER = r"""
#include "tns_analysis.cuh"
#include "gain_bisection.cuh"
using namespace acx;

extern "C" {
""" + TNS_REHEARSE + r"""
void rehearse_gain(const float* en, const float* target, int* out, int B, int M, int offset0) {
  for (int b = 0; b < B; ++b)
    out[b] = gain_bisection_warp(CoderHostWarp{}, en + static_cast<size_t>(M) * b, M, target[b],
                                 offset0);
}
int gain_max_m() { return kGainMaxM; }
}
"""

# mutations the rehearsal must catch: the decision of the walk's node read
# one heap index late, the subdivisions summed last first, and every lag
# chain of a subdivision started a bin late
MUTATIONS = {
    "heap_index_off_by_one": ("gain_bisection.cuh",
                              "static_cast<int>((mask >> (h - 1)) & 1u)",
                              "static_cast<int>((mask >> h) & 1u)"),
    "subdivisions_out_of_order": ("tns_analysis.cuh",
                                  "for (int s = 0; s < NSUB; ++s) {",
                                  "for (int s = NSUB - 1; s >= 0; --s) {"),
    "lag_chain_late_start": ("tns_analysis.cuh", "lo = imax(s_lo, 0);", "lo = imax(s_lo + 1, 0);"),
}

ENCODER_CONFIGS = {"48k_64k": dict(fs_in=48000, bitrate=64000),
                   "48k_32k": dict(fs_in=48000, bitrate=32000)}
GAIN_CASES = [(M, o) for M, offs in C.GAIN_OFFSETS.items() for o in offs]


@pytest.fixture(scope="module")
def lib(tmp_path_factory):
    return build_wrapper(tmp_path_factory.mktemp("rate"), WRAPPER, "rate", MUTATIONS)


@pytest.fixture
def card_order(monkeypatch):
    """The plain versions compute as they do for a tensor on a card."""
    monkeypatch.setattr(numerics, "on_cpu", lambda x: False)


@pytest.fixture(scope="module")
def encoder_inputs():
    """{config: {"tns": [(x, bw_idx)], "gain": [(en, target, offset0)]}}: the
    arguments of every filter analysis and gain bisection of the port's
    encoder on the CPU (before card_order patches the numerics), 8 streams
    of seeded noise at four decades of level, every other one in bursts that
    turn TNS on, over 2 frames."""
    store = {}
    saved = tns.tns_filter_analysis_plain, quant.gain_bisection_plain
    for name, kw in ENCODER_CONFIGS.items():
        cfg = P.Config(**kw)
        rng = np.random.default_rng(7)
        B, T, n = 8, 2, cfg.frame_length
        pcm = rng.standard_normal((T, B, n)) * 10.0 ** rng.uniform(1, 4, (1, B, 1))
        # odd streams: a burst a frame, a sharp onset and a fast decay (TNS on)
        i, on = np.arange(n), rng.integers(0, n, (T, B // 2, 1))
        pcm[:, 1::2] *= np.where(i >= on, np.exp(-(i - on) / rng.uniform(5, 60, on.shape)), 0.02)
        calls = {"tns": [], "gain": []}

        def rec_tns(c, x, bw, calls=calls):
            calls["tns"].append((x.numpy().copy(), bw.numpy().astype(np.int32)))
            return saved[0](c, x, bw)

        def rec_gain(en, target, offset0, calls=calls):
            calls["gain"].append((en.numpy().copy(), target.numpy().copy(), int(offset0)))
            return saved[1](en, target, offset0)
        tns.tns_filter_analysis_plain, quant.gain_bisection_plain = rec_tns, rec_gain
        try:
            P.encode_block(cfg, P.enc_state_init(cfg, B, device="cpu"),
                           torch.from_numpy(pcm.astype(np.float32)))
        finally:
            tns.tns_filter_analysis_plain, quant.gain_bisection_plain = saved
        store[name] = calls
    return store


def lane_gain(lib, en: np.ndarray, target: np.ndarray, offset0: int) -> np.ndarray:
    B, M = en.shape
    out = np.zeros(B, np.int32)
    lib.rehearse_gain(ptr(np.ascontiguousarray(en, np.float32)),
                      ptr(np.ascontiguousarray(target, np.float32)), ptr(out), B, M, offset0)
    return out


@functools.cache
def gain_case(M: int, offset0: int) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """gain_rows at (M, offset0) and the plain version's offsets."""
    en, target = C.gain_rows(M, offset0)
    ref = quant.gain_bisection_plain(torch.from_numpy(en), torch.from_numpy(target), offset0)
    return en, target, ref.numpy()


def plain_tns(cfg, x: np.ndarray, bw: np.ndarray):
    """The plain version's outputs and prediction gains, in the card's order
    (under card_order)."""
    outs, gains = tns._analyze(cfg, torch.from_numpy(x), torch.from_numpy(bw))
    return [o.numpy() for o in outs], gains.numpy()


def tns_differing(lib, cfg, x: np.ndarray, bw: np.ndarray) -> int:
    got, got_gains = lane_tns(lib, cfg, x, bw)
    ref, gains = plain_tns(cfg, x, bw)
    return C.count_differing(list(got) + [got_gains], ref + [gains])


def test_gain_max_m_matches_header(lib):
    assert lib.gain_max_m() == K.GAIN_MAX_M


@pytest.mark.parametrize("M", list(C.GAIN_OFFSETS))
def test_gain_bisection_warp_matches_plain_on_gain_rows(lib, M):
    """Every starting offset of the configurations with M blocks."""
    for offset0 in C.GAIN_OFFSETS[M]:
        en, target, ref = gain_case(M, offset0)
        got = lane_gain(lib, en, target, offset0)
        assert np.array_equal(got, ref), (offset0, np.nonzero(got != ref)[0].tolist())


def test_gain_rows_reach_what_they_are_for():
    """The rows hold iszero throughout (the lowest offset), blocks within two
    ulps of both thresholds at offsets the walks test, and targets within an
    ulp of a tested ener; the final offsets spread over the range."""
    near_tie = on_edge = 0
    finals = set()
    for M, offset0 in GAIN_CASES:
        en, target, ref = gain_case(M, offset0)
        assert ref[0] == offset0 - 255
        tested, eners, final = C.gain_path(en, target, offset0)
        assert np.array_equal(final, ref)
        ulps = np.abs(eners.astype(np.float64) - target[:, None].astype(np.float64)) / \
            np.spacing(np.abs(target[:, None]))
        near_tie += int((ulps <= 1).any(1).sum())
        t = en[:, None, :] - tested[:, :, None].astype(np.float32)
        near = 2 * np.spacing(np.abs(en))[:, None, :]
        on_edge += int(((np.abs(t - C.GAIN_LOW) <= near) |
                        (np.abs(t - C.GAIN_HIGH) <= near)).any((1, 2)).sum())
        finals |= set((ref - offset0).tolist())
    assert near_tie >= len(GAIN_CASES) * 6, near_tie
    assert on_edge >= len(GAIN_CASES) * 3, on_edge
    assert len(finals) >= 100, len(finals)


@pytest.mark.parametrize("M", list(C.GAIN_OFFSETS))
def test_gain_bisection_premise_tree_walk(M):
    """The 255 offsets of the decision tree, every one tested on every row
    at once (the plain version's inner loop, vectorised over the
    candidates), and the decisions walked down the tree afterwards, give
    gain_bisection_plain's offset."""
    for offset0 in C.GAIN_OFFSETS[M]:
        en, target, ref = gain_case(M, offset0)
        en_t, tgt = torch.from_numpy(en), torch.from_numpy(target)
        offs = torch.tensor([C.gain_node_test(offset0, h) for h in range(1, 256)],
                            dtype=torch.float32)[None, :]
        ener = torch.zeros((en.shape[0], 255), dtype=torch.float32)
        iszero = torch.ones((en.shape[0], 255), dtype=torch.bool)
        zero = torch.zeros((), dtype=torch.float32)
        for j in range(M - 1, -1, -1):
            t = en_t[:, j, None] - offs
            low = t < numerics.f32(9.8)
            gap = torch.where(low & ~iszero, numerics.f32(3.78), zero)
            hi = torch.where(t >= 70.0, 2.0 * t - 70.0, t)
            ener = torch.where(low, ener + gap, ener + hi)
            iszero = iszero & low
        passed = ((ener > tgt[:, None]) & ~iszero).numpy()
        h = np.ones(en.shape[0], np.int64)
        for _ in range(8):
            h = 2 * h + passed[np.arange(en.shape[0]), h - 1]
        assert np.array_equal(offset0 - 255 + (h - 256), ref), offset0


@pytest.mark.parametrize("name", list(ENCODER_CONFIGS))
def test_gain_bisection_warp_matches_plain_on_encoder_inputs(lib, encoder_inputs, name):
    calls = encoder_inputs[name]["gain"]
    assert len(calls) == 2
    for en, target, offset0 in calls:
        ref = quant.gain_bisection_plain(torch.from_numpy(en), torch.from_numpy(target), offset0)
        assert np.array_equal(lane_gain(lib, en, target, offset0), ref.numpy())


@pytest.mark.parametrize("name", list(ENCODER_CONFIGS))
def test_tns_filter_analysis_warp_matches_plain_on_encoder_spectra(lib, encoder_inputs,
                                                                   card_order, name):
    """The encoder's shaped spectra; both filters on and off occur."""
    cfg = P.Config(**ENCODER_CONFIGS[name])
    calls = encoder_inputs[name]["tns"]
    assert len(calls) == 2
    on = np.zeros(2, np.int64)
    for x, bw in calls:
        assert tns_differing(lib, cfg, x, bw) == 0
        on += (plain_tns(cfg, x, bw)[0][0] > 0).sum(0)
    assert on[0] > 0 and on[1] > 0, on


@pytest.mark.parametrize("B", [1, 33])
@pytest.mark.parametrize("name", list(C.TNS_CONFIGS))
def test_tns_filter_analysis_warp_single_and_odd_batches(lib, card_order, name, B):
    """tns_rows (silent subdivisions, order 8 in both filters, the weighting
    deciding) in launches of B streams: each row alone, or 33 rows of the
    rows tiled."""
    cfg = P.Config(**C.TNS_CONFIGS[name])
    x, bw = C.tns_rows(seed=2)
    n = x.shape[0]
    picks = [[i] for i in range(n)] if B == 1 else [np.arange(s, s + B) % n for s in (0, 26)]
    for pick in picks:
        assert tns_differing(lib, cfg, x[pick], bw[pick]) == 0, pick[:3]


@pytest.mark.parametrize("mutation", list(MUTATIONS))
def test_rehearsal_catches_mutated_rate_kernels(tmp_path, card_order, mutation):
    lib = build_wrapper(tmp_path, WRAPPER, "rate", MUTATIONS, mutation)
    bad = 0
    if MUTATIONS[mutation][0] == "gain_bisection.cuh":
        for M, offset0 in GAIN_CASES[::7]:
            en, target, ref = gain_case(M, offset0)
            bad += int((lane_gain(lib, en, target, offset0) != ref).sum())
    else:
        x, bw = C.tns_rows(seed=1)
        for name in C.TNS_CONFIGS:
            bad += tns_differing(lib, P.Config(**C.TNS_CONFIGS[name]), x, bw)
    assert bad > 0, f"the rehearsal did not see the mutation {mutation}"
