"""The decoder's spectrum reconstruction and SNS quantizer decoder, their
warp designs compiled for the CPU, against their plain versions.

csrc/spec_decode.cuh (K16b, `spec_decode_warp`) and csrc/sns_vq.cuh (K16a,
`sns_vq_dec_warp`) are templates over the warp that runs them. Here g++
builds them with the host warp (`CoderHostWarp`: one thread runs the 32
lanes of each step in turn) into a shared library called through ctypes.
Neither warp keeps anything in shared memory; their outputs are filled with
a byte pattern no path writes before each launch. Every output must equal
the plain version's (ops/quant.py:spectrum_decode_plain, ops/sns.py:
sns_vq_dec_plain), run in the card's order, bit for bit, at 1 and 33
streams: K16b on tests/torch_kernel_cases.py:spec_rows at 48 kHz and at
16 kHz (N = 160), on the port's own decoder rows at 64 and 32 kbps (a frame
lost in every third stream), and on spec_edge_rows (nonzero lines at the
bandwidth and the windows' and chunks' edges, n_res 0, the full count and
above, lines a nudge makes zero, synthesised lines at the 0.625 threshold;
also with 42 residual bits a frame); K16a on scf_idx_grid of every submode
and on damaged indices. Copies of the headers with one line changed must
fail. It skips where there is no g++."""
from __future__ import annotations

import functools

import numpy as np
import pytest
import torch

import audio_codec_torch as P
from audio_codec_torch.ops import numerics, quant, sns

from tests import torch_kernel_cases as C
from tests.test_torch_lane_rehearsal import (SNS_DEC_REHEARSE, SPEC_DEC_REHEARSE, build_wrapper,
                                             lane_spec, plain_spec, ptr, tables)

ON_CPU = numerics.on_cpu   # the port's own test, for the decoder's CPU path

WRAPPER = r"""
#include "spec_decode.cuh"
#include "sns_vq.cuh"
#include <cstring>
using namespace acx;
""" + SPEC_DEC_REHEARSE + SNS_DEC_REHEARSE

_NUDGE = """      float v = row[ln].v[c];
      if (nz[ln] != 0) v = spec_nudge(v, static_cast<int32_t>((word[ln] >> (src[ln] & 31)) & 1u));
      row[ln].v[c] = v;
      after[ln] = v != 0.0f ? 1 : 0;
"""
# mutations the rehearsal must catch: a skipped generator step, a zero-line
# window one line short, the bandwidth's mask one line short, the zero-line
# test on the row before the residual, a strict compare in the de-index, the
# DCT's chains combined in another order
MUTATIONS = {
    "lcg_skipped_step": ("spec_decode.cuh", "  return (kLcgMul * uj + kLcgAdd) & 0xffffu;",
                         "  return uj;"),
    "window_one_line_short": ("spec_decode.cuh",
                              "nf_window_clear(prev, nzb[c], next, ln, g.width)",
                              "nf_window_clear(prev, nzb[c], next, ln, g.width - 1)"),
    "bandwidth_one_line_short": ("spec_decode.cuh", "nf_bits_below(bw - 32 * c)",
                                 "nf_bits_below(bw - 1 - 32 * c)"),
    "zero_test_before_nudge": ("spec_decode.cuh", _NUDGE,
                               _NUDGE.replace("      after[ln] = v != 0.0f ? 1 : 0;\n", "")
                               .replace("      float v = row[ln].v[c];\n",
                                        "      float v = row[ln].v[c];\n"
                                        "      after[ln] = v != 0.0f ? 1 : 0;\n")),
    "deindex_strict_compare": ("sns_vq.cuh", "ge[ln] = ln <= K && mpvq >= a[ln] ? 1 : 0;",
                               "ge[ln] = ln <= K && mpvq > a[ln] ? 1 : 0;"),
    "dct_chains_other_order": ("sns_vq.cuh", "radd(radd(c[0], c[1]), radd(c[2], c[3]))",
                               "radd(radd(c[0], c[2]), radd(c[1], c[3]))"),
}

RATES = {"48k": dict(fs_in=48000, bitrate=64000), "16k": dict(fs_in=16000, bitrate=32000)}


@pytest.fixture(scope="module")
def lib(tmp_path_factory):
    return build_wrapper(tmp_path_factory.mktemp("dec"), WRAPPER, "dec", MUTATIONS)


@pytest.fixture
def card_order(monkeypatch):
    """The plain versions compute as they do for a tensor on a card."""
    monkeypatch.setattr(numerics, "on_cpu", lambda x: False)


# ---- the inputs ----

@functools.cache
def decoder_rows(bitrate: int) -> tuple:
    """The arguments of the port's spectrum_decode at each frame of 8 streams
    of seeded tones and noise over 3 frames at 48 kHz, the second frame of
    every third stream lost (the CPU path): (cfg, rows)."""
    cfg = P.Config(fs_in=48000, bitrate=bitrate)
    rng = np.random.default_rng(bitrate + 3)
    B, T_, n = 8, 3, cfg.frame_length
    k = np.arange(T_ * n)
    pcm = np.stack([np.sin(2 * np.pi * (150 + 470 * s) * k / 48000) * 3000 * (1 + s % 3)
                    + rng.standard_normal(k.size) * 10.0 ** (s % 4) for s in range(B)])
    pcm = torch.from_numpy(pcm.reshape(B, T_, n).transpose(1, 0, 2).astype(np.float32))
    bfi = torch.zeros((T_, B), dtype=torch.int32)
    bfi[1, ::3] = 1
    calls = []
    dec = quant.spectrum_decode

    def rec(c, *a):
        calls.append([t.clone() for t in a])
        return dec(c, *a)
    patched = numerics.on_cpu
    quant.spectrum_decode, numerics.on_cpu = rec, ON_CPU
    try:
        _, frames = P.encode_block(cfg, P.enc_state_init(cfg, B, device="cpu"), pcm)
        P.decode_block(cfg, P.dec_state_init(cfg, B, device="cpu"), frames, bfi)
    finally:
        quant.spectrum_decode, numerics.on_cpu = dec, patched
    rows = {k_: np.ascontiguousarray(np.concatenate([c[i].numpy() for c in calls]))
            for i, k_ in enumerate(C.SPEC_ORDER)}
    return cfg, rows


def first(a: dict, n: int) -> dict:
    return {k: v[:n] for k, v in a.items()}


def spec_differing(lib, cfg, a: dict) -> int:
    return C.count_differing(list(lane_spec(lib, cfg, a)), plain_spec(cfg, a))


def lane_sns_dec(lib, idx: np.ndarray) -> np.ndarray:
    idx = np.ascontiguousarray(idx, np.int32)
    q = np.zeros((idx.shape[0], 16), np.float32)
    lib.rehearse_sns_dec(ptr(idx), ptr(tables()), ptr(q), idx.shape[0])
    return q


def sns_differing(lib, idx: np.ndarray) -> int:
    ref = sns.sns_vq_dec_plain(torch.from_numpy(np.ascontiguousarray(idx, np.int32)))
    return C.count_differing(lane_sns_dec(lib, idx), ref.numpy())


def damaged_indices() -> np.ndarray:
    """Indices a damaged frame can parse to: any MPVQ index, any tail."""
    rng = np.random.default_rng(8)
    idx = np.concatenate([C.scf_idx_grid(s, 16, seed=9) for s in range(4)])
    idx[:, 5] = rng.integers(0, 1 << 25, idx.shape[0])
    idx[:, 6] = rng.integers(-2, 12, idx.shape[0])
    return idx


def residual_changes_nonzero_lines(cfg, a: dict) -> int:
    """Lines of good frames that a nudge of the residual makes zero, on the
    plain version's path (the concealment, then residual_decode)."""
    from audio_codec_torch.ops import pc
    t = {k: torch.from_numpy(np.asarray(v)) for k, v in a.items()}
    x, _, _ = pc.pc_apply_gain(cfg, t["bfi"], t["x"], t["q_old_res"], t["q_old_d"],
                               t["spec_inv_idx"], t["gain"], t["prev_gg"], t["nb_lost"])
    y = quant.residual_decode(cfg, x, t["res_bits"], t["n_res"])
    live = ((t["bfi"] != 1) & (t["residual_present"] == 1))[:, None]
    return int(((x != 0) & (y == 0) & live).sum())


# ---- the tests ----

@pytest.mark.parametrize("streams", [1, 33])
@pytest.mark.parametrize("rate", list(RATES))
def test_spec_warp_matches_plain_on_spec_rows(lib, card_order, rate, streams):
    cfg = P.Config(**RATES[rate])
    assert spec_differing(lib, cfg, first(C.spec_rows(cfg, seed=3), streams)) == 0


@pytest.mark.parametrize("streams", [1, 33])
@pytest.mark.parametrize("bitrate", [64000, 32000])
def test_spec_warp_matches_plain_on_decoder_rows(lib, card_order, bitrate, streams):
    cfg, rows = decoder_rows(bitrate)
    assert spec_differing(lib, cfg, first(rows, streams)) == 0
    assert spec_differing(lib, cfg, {k: v[-streams:] for k, v in rows.items()}) == 0


@pytest.mark.parametrize("res_width", [None, 42])
@pytest.mark.parametrize("streams", [1, 33])
@pytest.mark.parametrize("rate", list(RATES))
def test_spec_warp_matches_plain_on_edge_rows(lib, card_order, rate, streams, res_width):
    cfg = P.Config(**RATES[rate])
    a = C.spec_edge_rows(cfg, seed=6, res_width=res_width)
    assert spec_differing(lib, cfg, first(a, streams)) == 0
    assert spec_differing(lib, cfg, a) == 0


@pytest.mark.parametrize("bitrate", [64000, 32000])
def test_residual_keeps_the_nonzero_lines_of_decoder_rows(bitrate):
    """The premise the header states: on the decoder's rows no nudge makes a
    line zero; the edge rows' lines of +-0.1875 do, so the rehearsal sees a
    zero-line test taken on the row before the residual."""
    cfg, rows = decoder_rows(bitrate)
    assert residual_changes_nonzero_lines(cfg, rows) == 0
    assert residual_changes_nonzero_lines(cfg, C.spec_rows(cfg, seed=3)) == 0
    assert residual_changes_nonzero_lines(cfg, C.spec_edge_rows(cfg, seed=6)) > 0


@pytest.mark.parametrize("streams", [1, 33])
@pytest.mark.parametrize("submode", [0, 1, 2, 3])
def test_sns_dec_warp_matches_plain(lib, card_order, submode, streams):
    idx = C.scf_idx_grid(submode, 40, seed=7)
    assert sns_differing(lib, idx[:streams]) == 0
    assert sns_differing(lib, idx[-streams:]) == 0


@pytest.mark.parametrize("streams", [1, 33])
def test_sns_dec_warp_matches_plain_on_damaged_indices(lib, card_order, streams):
    idx = damaged_indices()
    assert sns_differing(lib, idx[:streams]) == 0
    assert sns_differing(lib, idx) == 0


@pytest.mark.parametrize("mutation", list(MUTATIONS))
def test_rehearsal_catches_mutated_dec_warps(tmp_path, card_order, mutation):
    lib_m = build_wrapper(tmp_path, WRAPPER, "dec", MUTATIONS, mutation)
    if MUTATIONS[mutation][0] == "sns_vq.cuh":
        bad = sum(sns_differing(lib_m, C.scf_idx_grid(s, 40, seed=7)) for s in range(4))
    else:
        bad = 0
        for rate in RATES:
            cfg = P.Config(**RATES[rate])
            bad += spec_differing(lib_m, cfg, C.spec_rows(cfg, seed=3))
            bad += spec_differing(lib_m, cfg, C.spec_edge_rows(cfg, seed=6))
    assert bad > 0, f"the rehearsal did not see the mutation {mutation}"
