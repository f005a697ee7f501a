"""The warp designs of the two range-coder kernels, compiled for the CPU,
against their plain versions.

csrc/bit_estimate.cuh (K8, `bit_estimate_warp`) and csrc/ari_encode.cuh (K10,
`ari_encode_warp`) are templates over the warp that runs them. Here g++
builds them with the host warp (`CoderHostWarp`: one thread runs the 32
lanes of each step in turn, and every shuffle, scan, ballot and maximum reads
all lanes before it writes any) into a shared library, called through
ctypes, and every output must equal the plain version's
(ops/quant.py:bit_estimate_plain in modes -1, 0 and 1, ops/ari.py:encode_plain)
bit for bit: on the inputs the port's encoder gives both kernels at 48 kHz
and 64 kbps, 160 kbps (LSB mode) and in the high-resolution mode (N = 480,
21 escape levels), and on tests/torch_kernel_cases.py:coder_rows. K10 takes
its warp path on every encoder stream and its lane-0 path on rows over their
bit budget. Copies of the headers with one line changed must fail. It skips
where there is no g++."""
from __future__ import annotations

import ctypes
import functools

import numpy as np
import pytest
import torch

import audio_codec_torch as P
from audio_codec_torch import kernels as K
from audio_codec_torch.ops import ari, quant

from tests import torch_kernel_cases as C
from tests.test_torch_lane_rehearsal import build_wrapper, ptr

WRAPPER = r"""
#include "ari_encode.cuh"
using namespace acx;

extern "C" {
// out [5][B]: nbits nbits2 lastnz lastnz2 lsbMode
void rehearse_bit_estimate(const int* xq, const int* target, int* out, const int* lookup,
                           const int* bits_tab, int B, int N, int mode, int rate_flag,
                           int max_lev) {
  for (int s = 0; s < B; ++s)
    bit_estimate_warp(CoderHostWarp{}, xq + static_cast<size_t>(s) * N, N, target[s], mode,
                      rate_flag, max_lev, lookup, bits_tab, out + s, B);
}
// side [6][B]: bp_side mask_side num_tns lastnz lsb_mode n_res; tabs as
// kernels._coder_tables; buf [B][nbytes] in, coded in place; path [B]
void rehearse_ari_encode(int* buf, const int* side, const int* xq, const int* tns_order,
                         const int* tns_idx, const int* res, const int* tabs, int* path, int B,
                         int N, int nbytes, int res_width, int max_lev, int rate_flag, int lpcw,
                         int total_bits) {
  AriTables tb;
  tb.lookup = tabs;
  tb.cumf = tabs + 4096;
  tb.tns_freq_cf = tb.cumf + 64 * 18;
  tb.tns_cf = tb.tns_freq_cf + 2 * 9;
  uint32_t frame[1024], syms[kAriSymCap], lsb_words[kAriLsbWords];
  for (int s = 0; s < B; ++s) {
    int* row = buf + static_cast<size_t>(s) * nbytes;
    uint8_t* bytes = reinterpret_cast<uint8_t*>(frame);
    for (int i = 0; i < nbytes; ++i) bytes[i] = static_cast<uint8_t>(row[i]);
    const int sd[6] = {side[s], side[B + s], side[2 * B + s], side[3 * B + s], side[4 * B + s],
                       side[5 * B + s]};
    path[s] = ari_encode_warp(CoderHostWarp{}, frame, row, nbytes,
                              xq + static_cast<size_t>(s) * N, N, sd, tns_order + 2 * s,
                              tns_idx + 16 * s, res + static_cast<size_t>(s) * res_width,
                              res_width, tb, max_lev, rate_flag, lpcw, total_bits, syms,
                              lsb_words);
    for (int i = 0; i < nbytes; ++i) row[i] = bytes[i];
  }
}
}
"""

# mutations the rehearsal must catch: the context from one tuple back only,
# the warp scan exclusive where it must be inclusive, lastnz2 as a lane's
# first hit instead of the last, the order test one byte wider, and the
# tuples' side bits one position late
MUTATIONS = {
    "context_one_back": ("bit_estimate.cuh",
                         "return (tn_prev2 & 15) * 16 + tn_prev1; }", "return tn_prev1; }"),
    "scan_exclusive": ("bit_estimate.cuh",
                       "      if (l >= d) x[l] += y[l];\n    });\n  }\n  return x;",
                       "      if (l >= d) x[l] += y[l];\n    });\n  }\n"
                       "  const auto e = w.shfl_up(x, 1);\n"
                       "  w.lanes([&](int l) { x[l] = l >= 1 ? e[l] : 0u; });\n  return x;"),
    "lastnz2_first_hit": ("bit_estimate.cuh",
                          "if (((nz_mask[l] >> i) & 1) != 0 && static_cast<int>(run) <= limit) {",
                          "if (last < 0 && ((nz_mask[l] >> i) & 1) != 0 && "
                          "static_cast<int>(run) <= limit) {"),
    "order_test_one_byte": ("ari_encode.cuh", "ok = q_last >= -7 && bp_end <= ((q_last + 7) >> 3);",
                            "ok = q_last >= -7 && bp_end <= ((q_last + 7) >> 3) + 1;"),
    "side_bit_late": ("ari_encode.cuh",
                      "int Q = Q0 - n_side - static_cast<int>((before >> 10) & 2047u);",
                      "int Q = Q0 - n_side - 1 - static_cast<int>((before >> 10) & 2047u);"),
}

CONFIG_NAMES = list(C.CODER_CONFIGS)


def cfg_of(name: str):
    return P.Config(**C.CODER_CONFIGS[name])


@pytest.fixture(scope="module")
def lib(tmp_path_factory):
    return build_wrapper(tmp_path_factory.mktemp("coder"), WRAPPER, "coder", MUTATIONS)


def np32(a) -> np.ndarray:
    a = a.numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
    return np.ascontiguousarray(a, dtype=np.int32)


def lane_bit_estimate(lib, cfg, xq: np.ndarray, target: np.ndarray, mode: int) -> dict:
    B, N = xq.shape
    lookup = np32(P.tables.t("ari_spec_lookup_fl"))
    bits_tab = np32(P.tables.t("ari_spec_bits_fl"))
    out = np.zeros((5, B), np.int32)
    lib.rehearse_bit_estimate(ptr(np32(xq)), ptr(np32(np.broadcast_to(target, (B,)))), ptr(out),
                              ptr(lookup), ptr(bits_tab), B, N, mode, cfg.rateFlag,
                              21 if cfg.hrmode else 14)
    return dict(zip(("nbits", "nbits2", "lastnz", "lastnz2", "lsbMode"), out))


def plain_bit_estimate(cfg, xq: np.ndarray, target: np.ndarray, mode: int) -> dict:
    tgt = np32(np.broadcast_to(target, xq.shape[:1])).copy()
    ref = quant.bit_estimate_plain(cfg, torch.from_numpy(np32(xq)), torch.from_numpy(tgt), mode)
    return {k: v.numpy() for k, v in ref.items()}


def lane_ari_encode(lib, cfg, args: tuple) -> tuple[np.ndarray, np.ndarray]:
    """K10's warp over the rows of ari.encode's arguments (after cfg): the
    coded bytes [B, nbytes] and the path of each stream (0 warp, 1 lane 0)."""
    (buf, bp_side, mask_side, xq, tns_order, tns_idx, num_tns, lastnz, lsb_mode, res,
     n_res) = (np32(a) for a in args)
    B, N = xq.shape
    out = buf.copy()
    side = np.ascontiguousarray(np.stack([np.broadcast_to(v, (B,)) for v in (
        bp_side, mask_side, num_tns, lastnz, lsb_mode, n_res)]), dtype=np.int32)
    tabs = np32(K._coder_tables("cpu"))
    path = np.full(B, -1, np.int32)
    lib.rehearse_ari_encode(ptr(out), ptr(side), ptr(xq), ptr(tns_order), ptr(tns_idx), ptr(res),
                            ptr(tabs), ptr(path), B, N, buf.shape[1], res.shape[1],
                            21 if cfg.hrmode else 14, cfg.rateFlag,
                            1 if cfg.enable_lpc_weighting else 0, cfg.targetBitsAri)
    return out, path


def plain_ari_encode(cfg, args: tuple) -> np.ndarray:
    return ari.encode_plain(cfg, *(torch.from_numpy(np32(a)) if isinstance(a, np.ndarray) else a
                                   for a in args)).numpy()


@functools.cache
def encoder_inputs(name: str) -> dict:
    """The arguments of every bit_estimate and ari.encode call of the port's
    encoder on the CPU, 8 streams of seeded noise at four decades of level
    over 2 frames."""
    cfg = cfg_of(name)
    rng = np.random.default_rng(5)
    B, T = 8, 2
    pcm = torch.from_numpy((rng.standard_normal((T, B, cfg.frame_length)) *
                            10.0 ** rng.uniform(1, 4, (1, B, 1))).astype(np.float32))
    store = {"bit_estimate": [], "ari_encode": []}
    saved = quant.bit_estimate_plain, ari.encode_plain

    def rec(key, fn):
        def f(*a):
            store[key].append(tuple(np32(v) if isinstance(v, torch.Tensor) else v for v in a[1:]))
            return fn(*a)
        return f
    quant.bit_estimate_plain = rec("bit_estimate", saved[0])
    ari.encode_plain = rec("ari_encode", saved[1])
    try:
        P.encode_block(cfg, P.enc_state_init(cfg, B, device="cpu"), pcm)
    finally:
        quant.bit_estimate_plain, ari.encode_plain = saved
    return store


@functools.cache
def rows(name: str) -> dict:
    return C.coder_rows(cfg_of(name), seed=1)


def rows_args(d: dict) -> tuple:
    return tuple(d[k] for k in C.CODER_ARI_ORDER)


@functools.cache
def plain_rows(name: str) -> tuple[dict, np.ndarray]:
    """The plain versions on coder_rows: bit_estimate in each mode, and the
    coded bytes."""
    cfg, d = cfg_of(name), rows(name)
    return ({m: plain_bit_estimate(cfg, d["xq"], d["target"], m) for m in (-1, 0, 1)},
            plain_ari_encode(cfg, rows_args(d)))


def differing(got: dict, ref: dict) -> dict:
    return {k: int((got[k] != ref[k]).sum()) for k in ref if int((got[k] != ref[k]).sum())}


@pytest.mark.parametrize("name", CONFIG_NAMES)
def test_bit_estimate_warp_matches_plain_on_encoder_inputs(lib, name):
    cfg = cfg_of(name)
    calls = encoder_inputs(name)["bit_estimate"]
    assert sorted({c[2] for c in calls}) == sorted({-1, cfg.modeFlag})
    for xq, target, mode in calls:
        for m in {mode, -1, 0, 1}:
            bad = differing(lane_bit_estimate(lib, cfg, xq, target, m),
                            plain_bit_estimate(cfg, xq, target, m))
            assert not bad, (m, bad)


@pytest.mark.parametrize("mode", [-1, 0, 1])
@pytest.mark.parametrize("name", CONFIG_NAMES)
def test_bit_estimate_warp_matches_plain_on_coder_rows(lib, name, mode):
    d = rows(name)
    bad = differing(lane_bit_estimate(lib, cfg_of(name), d["xq"], d["target"], mode),
                    plain_rows(name)[0][mode])
    assert not bad, bad


@pytest.mark.parametrize("name", CONFIG_NAMES)
def test_ari_encode_warp_matches_plain_on_encoder_inputs(lib, name):
    """Every stream of the encoder takes the warp path and equals the plain
    version's bytes."""
    cfg = cfg_of(name)
    calls = encoder_inputs(name)["ari_encode"]
    assert len(calls) == 2
    for args in calls:
        got, path = lane_ari_encode(lib, cfg, args)
        assert np.array_equal(got, plain_ari_encode(cfg, args))
        assert (path == 0).all(), path


@pytest.mark.parametrize("name", CONFIG_NAMES)
def test_ari_encode_warp_matches_plain_on_coder_rows(lib, name):
    got, path = lane_ari_encode(lib, cfg_of(name), rows_args(rows(name)))
    ref = plain_rows(name)[1]
    assert np.array_equal(got, ref), f"{int((got != ref).any(-1).sum())} rows differ"


@pytest.mark.parametrize("name", CONFIG_NAMES)
def test_coder_rows_reach_both_ari_paths_and_what_the_encoder_may_not(lib, name):
    """K10's warp path and its lane-0 path both run (the lane-0 path on rows
    coded whole over their budget); bit_estimate's lastnz2 falls on both
    sides of every lane boundary; LSB lists pass 32 entries and N; escape
    levels pass max_lev; TNS orders 0-8 occur in both filters."""
    cfg, d = cfg_of(name), rows(name)
    _, path = lane_ari_encode(lib, cfg, rows_args(d))
    assert 0 < int((path == 1).sum()) < len(path) - 8, np.bincount(path)
    assert (path[d["lastnz"] == cfg.yLen] == 1).any()
    NT = cfg.yLen // 2
    run = -(-NT // 32)
    l2 = plain_rows(name)[0][0]["lastnz2"]
    ends = set(((l2 - 2) // 2).tolist())
    assert all(kb - 1 in ends and kb in ends for kb in range(run, NT, run))
    a, b = np.abs(d["xq"][:, 0::2]), np.abs(d["xq"][:, 1::2])
    m = np.maximum(a, b)
    nlev = np.where(m >= 4, np.floor(np.log2(np.maximum(m, 1))).astype(int) - 1, 0)
    shifted = (nlev > 0) & (d["lsb_mode"][:, None] == 1) & \
        (2 * np.arange(NT)[None, :] < d["lastnz"][:, None])
    pushes = (shifted * (2 + ((a == 1) & shifted) + ((b == 1) & shifted))).sum(-1)
    assert pushes.max() > cfg.yLen and int((pushes > 32).sum()) >= 4
    assert nlev.max() > (21 if cfg.hrmode else 14)
    for f in range(2):
        on = d["tns_order"][:, f][d["num_tns"] > f]
        assert set(range(9)) <= set(on.tolist())


@pytest.mark.parametrize("mutation", list(MUTATIONS))
def test_rehearsal_catches_mutated_coder(tmp_path, mutation):
    lib = build_wrapper(tmp_path, WRAPPER, "coder", MUTATIONS, mutation)
    bad = 0
    for name in CONFIG_NAMES[:2]:
        cfg, d = cfg_of(name), rows(name)
        if MUTATIONS[mutation][0] == "bit_estimate.cuh":
            for mode in (-1, 0, 1):
                bad += sum(differing(lane_bit_estimate(lib, cfg, d["xq"], d["target"], mode),
                                     plain_rows(name)[0][mode]).values())
        got, _ = lane_ari_encode(lib, cfg, rows_args(d))
        bad += int((got != plain_rows(name)[1]).sum())
        if bad:
            break
    assert bad > 0, f"the rehearsal did not see the mutation {mutation}"
