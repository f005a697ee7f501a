"""The encoder's LTPF parameter coder and side-information packer, their warp
designs compiled for the CPU, against their plain versions.

csrc/ltpf_encode.cuh (K4, `ltpf_encode_warp`) and csrc/side_info.cuh (K10
side, `side_info_pack_warp` over the bit string of `side_info_pack_bits`)
are templates over the warp that runs them. Here g++ builds them with the
host warp (`CoderHostWarp`: one thread runs the 32 lanes of each step in
turn) into a shared library called through ctypes. The warp's shared memory
and every output are filled with a byte pattern before each stream. Every
output must equal the plain version's (ops/analysis.py:ltpf_encode_plain,
ops/bits.py:pack_side_info_plain), run in the card's order, bit for bit, at
1 and 33 streams: K4 on tests/torch_kernel_cases.py:ltpf_rows, on the port's
own encoder rows at 10, 5 and 2.5 ms (correlation lengths 128 and 64) and on
ltpf_edge_rows at each frame size (the open-loop pitch at each lag limit and
resolution step, tied window values and candidates, negative correlations),
with the memory rows aligned for 16-byte loads and not; K10 side on
side_fields of every configuration, and the bit string against the backward
writer `side_info_pack_lane` on side_layout_rows (rows shorter than the side
bits, the first side bit above the row's end, fields over all of int32, a
negative lastnz / 2 - 1). Copies of the headers with one line changed must
fail. It skips where there is no g++."""
from __future__ import annotations

import functools
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import audio_codec_torch as P
from audio_codec_torch import kernels as K
from audio_codec_torch.ops import analysis, numerics

from tests import torch_kernel_cases as C
from tests.test_torch_lane_rehearsal import LTPF_REHEARSE, build_wrapper, plain_pack, ptr

ON_CPU = numerics.on_cpu   # the port's own test, for the encoder's CPU path

WRAPPER = r"""
#include "ltpf_encode.cuh"
#include "side_info.cuh"
#include <cstring>
using namespace acx;
""" + LTPF_REHEARSE + r"""
static SideLayout layout(const int* L) { return {L[0], L[1], L[2], L[3], L[4], L[5], L[6]}; }

static SideFields fields(const int* f) {
  return {f[0], f[1], f[2], f[3], f[4], {f[5], f[6]}, {f[7], f[8], f[9]},
          {f[10], f[11], f[12], f[13], f[14], f[15], f[16]}, f[17]};
}

extern "C" {
// fields [B][18] in FIELD_ORDER's columns; layouts [B][7] (l_stride 7) or one
// (l_stride 0); rows of `words` int32, filled with a pattern, then the warp
// writes the first nbytes of each
void rehearse_pack_warp(const int* f, const int* L, int l_stride, int* buf, int words,
                        int* cursor, int B) {
  for (int b = 0; b < B; ++b) {
    int* row = buf + words * b;
    std::memset(row, 0x5A, sizeof(int) * words);
    const SideCursor c = side_info_pack_warp(CoderHostWarp{}, layout(L + l_stride * b),
                                             fields(f + 18 * b), row);
    cursor[b] = c.bp;
    cursor[B + b] = c.mask;
  }
}
// the backward writer on the same rows, zeroed up to nbytes as the plain
// version's buffer is
void rehearse_pack_lane(const int* f, const int* L, int l_stride, int* buf, int words,
                        int* cursor, int B) {
  for (int b = 0; b < B; ++b) {
    int* row = buf + words * b;
    std::memset(row, 0x5A, sizeof(int) * words);
    const SideLayout lb = layout(L + l_stride * b);
    std::memset(row, 0, sizeof(int) * lb.nbytes);
    const SideCursor c = side_info_pack_lane(row, lb, fields(f + 18 * b));
    cursor[b] = c.bp;
    cursor[B + b] = c.mask;
  }
}
}
"""

# mutations the rehearsal must catch: the energy chains started from zero
# (their first product dropped), a window entry one lag off, the
# interpolation's zero taps dropped (the clamped table entries read there),
# the first-maximum trees' tie rule strict (a tie keeps a lane's own
# entry), a field one bit short, the cursor's mask stepped past 128 where it
# wraps to the next byte
MUTATIONS = {
    "energy_chain_from_zero": ("ltpf_encode.cuh", "en = n0 + k == 0 ? q : radd(en, q);",
                               "en = n0 + k == 0 ? 0.0f : radd(en, q);"),
    "window_one_lag_off": ("ltpf_encode.cuh",
                           "const int li = iclamp(t0_min - 4 - kLtpfLag0 + l, 0, kLtpfLags - 1);",
                           "const int li = iclamp(t0_min - 3 - kLtpfLag0 + l, 0, kLtpfLags - 1);"),
    "zero_taps_dropped": ("ltpf_encode.cuh",
                          "return in_taps ? inter[iclamp(k, 0, kLtpfInterTaps - 1)] : 0.0f;",
                          "return inter[iclamp(k, 0, kLtpfInterTaps - 1)];"),
    "tie_rule_strict": ("ltpf_encode.cuh", "if (first_max_beats(pv[l], pi[l], v[l], i[l])) {",
                        "if (pv[l] > v[l]) {"),
    "field_one_bit_short": ("side_info.cuh", "  side_put(b, s.gg_idx, 8);",
                            "  side_put(b, s.gg_idx, 7);"),
    "mask_past_128": ("side_info.cuh", "return {L.start - (b.n >> 3), 1 << (b.n & 7)};",
                      "return {L.start - ((b.n - 1) >> 3), 2 << ((b.n - 1) & 7)};"),
}

FRAMES = {"10ms": 100, "5ms": 50, "2.5ms": 25}
# ltpf_rows are 10 ms rows; the encoder's and the edge rows at every frame size
LTPF_CASES = [("ltpf_rows", "10ms")] + [(name, frames) for name in ("encoder_rows", "edge_rows")
                                        for frames in FRAMES]


def config(frame_dms: int = 100):
    return P.Config(fs_in=48000, bitrate=64000, frame_dms=frame_dms)


@pytest.fixture(scope="module")
def lib(tmp_path_factory):
    return build_wrapper(tmp_path_factory.mktemp("pitch_side"), WRAPPER, "pitch_side", MUTATIONS)


@pytest.fixture
def card_order(monkeypatch):
    """The plain versions compute as they do for a tensor on a card."""
    monkeypatch.setattr(numerics, "on_cpu", lambda x: False)


# ---- K4: the inputs ----

@functools.cache
def encoder_rows(frame_dms: int) -> dict:
    """The arguments of the port's ltpf_encode at each frame of 8 streams of
    seeded tones, pulses and noise over 6 frames at 48 kHz and this frame
    size (the CPU path)."""
    cfg = config(frame_dms)
    rng = np.random.default_rng(frame_dms + 7)
    B, T_, n = 8, 6, cfg.frame_length
    k = np.arange(T_ * n)
    pcm = np.stack([np.sin(2 * np.pi * (95 + 61 * s) * k / 48000) * 5000 * (1 + s % 3)
                    + (np.where(k % (120 + 40 * s) == 0, 9000.0, 0.0) if s % 2 else 0.0)
                    + rng.standard_normal(k.size) * 10.0 ** (s % 4) for s in range(B)])
    pcm = torch.from_numpy(pcm.reshape(B, T_, n).transpose(1, 0, 2).astype(np.float32))
    calls = []
    enc = analysis.ltpf_encode

    def rec(c, *a):
        calls.append([t.clone() for t in a])
        return enc(c, *a)
    patched = numerics.on_cpu
    analysis.ltpf_encode, numerics.on_cpu = rec, ON_CPU
    try:
        P.encode_block(cfg, P.enc_state_init(cfg, B, device="cpu"), pcm)
    finally:
        analysis.ltpf_encode, numerics.on_cpu = enc, patched
    dt = dict(pitch_ol=np.int32, mem_on=np.int32)
    return {k_: np.ascontiguousarray(np.concatenate([c[i].numpy() for c in calls]),
                                     dt.get(k_, np.float32))
            for i, k_ in enumerate(C.LTPF_ORDER)}


def ltpf_cases(name: str, frame_dms: int) -> dict:
    if name == "ltpf_rows":
        return C.ltpf_rows(seed=1)
    if name == "encoder_rows":
        return encoder_rows(frame_dms)
    return C.ltpf_edge_rows(config(frame_dms), seed=2)


def warp_ltpf(lib, cfg, a: dict, aligned: bool = True):
    """The warp on the rows of a; with aligned False the memory rows lie one
    float apart more than their length, so their alignment runs through all
    four offsets and the memory is staged a word at a time where it is not
    aligned."""
    args = [np.ascontiguousarray(a[k], np.int32 if k in ("pitch_ol", "mem_on") else np.float32)
            for k in C.LTPF_ORDER]
    B = args[0].shape[0]
    xlen = cfg.len_12k8 + 1
    N, mem_len = xlen - 1, cfg.ltpf_mem_in_len
    acflen, xbase = (2 * N, mem_len - N) if cfg.frame_dms == 25 else (N, mem_len)
    stride = mem_len if aligned else mem_len + 1
    mem = np.zeros((B, stride), np.float32)
    mem[:, :mem_len] = args[3]
    args[3] = np.ascontiguousarray(mem)
    param, bits, on = (np.zeros(sh, np.int32) for sh in ((B, 3), B, B))
    new_mem = np.zeros((B, mem_len), np.float32)
    nc, mm, pitch = (np.zeros(B, np.float32) for _ in range(3))
    lib.rehearse_ltpf(*(ptr(v) for v in args), ptr(K._ltpf_tables("cpu").numpy()), B, xlen, N,
                      mem_len, acflen, xbase, cfg.frame_dms, int(bool(cfg.ltpf_enable)),
                      ptr(param), ptr(bits), ptr(new_mem), ptr(nc), ptr(mm), ptr(on), ptr(pitch),
                      stride)
    return param, bits, new_mem, nc, mm, on, pitch


def plain_ltpf(cfg, a: dict):
    return [np.ascontiguousarray(v.numpy()) for v in analysis.ltpf_encode_plain(
        cfg, *(torch.from_numpy(np.asarray(a[k])) for k in C.LTPF_ORDER))]


def ltpf_differing(lib, cfg, a: dict, aligned: bool = True) -> int:
    return C.count_differing(list(warp_ltpf(lib, cfg, a, aligned)), plain_ltpf(cfg, a))


def rows_of(a: dict, sl: slice) -> dict:
    return {k: v[sl] for k, v in a.items()}


# ---- K10 side: the inputs ----

def field_matrix(f: dict) -> np.ndarray:
    B = f["scf_idx"].shape[0]
    cols = [np.asarray(f[k], np.int32).reshape(B, -1) for k in C.FIELD_ORDER]
    return np.ascontiguousarray(np.concatenate(cols, axis=1))


def pack(lib, fn: str, F: np.ndarray, L: np.ndarray, words: int):
    """rehearse_pack_warp or rehearse_pack_lane on fields F [B, 18] with one
    layout L [7] or one a row L [B, 7]: (rows [B, words], bp, mask)."""
    B = F.shape[0]
    F, L = np.ascontiguousarray(F, np.int32), np.ascontiguousarray(L, np.int32)
    buf = np.zeros((B, words), np.int32)
    cursor = np.zeros((2, B), np.int32)
    getattr(lib, fn)(ptr(F), ptr(L), 7 if L.ndim == 2 else 0, ptr(buf), words, ptr(cursor), B)
    return buf, cursor[0], cursor[1]


def config_layout(cfg) -> np.ndarray:
    return np.array([cfg.targetBytes, cfg.targetBytes - 1, cfg.BW_cutoff_bits, cfg.lastnz_bits,
                     cfg.fs_idx, cfg.yLen, int(cfg.frame_dms == 25)], np.int32)


def string_bits(L: np.ndarray, bp: np.ndarray, mask: np.ndarray) -> np.ndarray:
    """The side bits a row's cursor stands behind."""
    return 8 * (L[:, 1] - bp) + np.log2(mask).astype(np.int32)


# ---- the tests ----

@pytest.mark.parametrize("streams", [1, 33])
@pytest.mark.parametrize("name,frames", LTPF_CASES)
def test_ltpf_warp_matches_plain(lib, card_order, name, frames, streams):
    cfg = config(FRAMES[frames])
    a = ltpf_cases(name, cfg.frame_dms)
    assert ltpf_differing(lib, cfg, rows_of(a, slice(0, streams))) == 0
    assert ltpf_differing(lib, cfg, rows_of(a, slice(-streams, None))) == 0


@pytest.mark.parametrize("name,frames", LTPF_CASES)
def test_ltpf_warp_matches_plain_on_every_row_and_branch(lib, card_order, name, frames):
    """Every row of the case at once, the memory aligned and not; the
    branches of chip_smoke's histogram each occur."""
    cfg = config(FRAMES[frames])
    a = ltpf_cases(name, cfg.frame_dms)
    got = warp_ltpf(lib, cfg, a)
    assert C.count_differing(list(got), plain_ltpf(cfg, a)) == 0
    assert ltpf_differing(lib, cfg, a, aligned=False) == 0
    if name != "encoder_rows":
        hist = C.ltpf_branches(a, got, cfg.frame_dms)
        for branch in ("searched", "not searched", "fresh alone"):
            assert hist[branch] > 0, hist


def test_ltpf_edge_rows_reach_the_edges(lib, card_order):
    """The edge rows put the pitch at both lag limits, in each resolution
    range, and on the window's lowest lag."""
    cfg = config()
    a = C.ltpf_edge_rows(cfg, seed=2)
    hist = C.ltpf_branches(a, warp_ltpf(lib, cfg, a), cfg.frame_dms)
    for branch in ("lowest lag", "step 1", "step 2", "no fraction", "lag 32", "lag 228"):
        assert hist[branch] > 0, hist


@pytest.mark.parametrize("streams", [1, 33])
@pytest.mark.parametrize("name", list(C.CONFIGS))
def test_pack_warp_matches_plain(lib, name, streams):
    cfg = P.Config(**C.CONFIGS[name])
    f = {k: v[:streams] for k, v in C.side_fields(cfg, 48, seed=3).items()}
    got = pack(lib, "rehearse_pack_warp", field_matrix(f), config_layout(cfg), cfg.targetBytes)
    assert C.count_differing(list(got), list(plain_pack(cfg, f))) == 0


@pytest.mark.parametrize("nbytes", [1, 5, 9])
@pytest.mark.parametrize("name", list(C.CONFIGS))
def test_pack_warp_matches_plain_on_short_rows(lib, name, nbytes):
    """Rows shorter than the side bits: the plain version clips every byte
    index into the row, so the string's later bytes fall on byte 0."""
    cfg = P.Config(**C.CONFIGS[name])
    short = SimpleNamespace(targetBytes=nbytes, BW_cutoff_bits=cfg.BW_cutoff_bits,
                            lastnz_bits=cfg.lastnz_bits)
    f = C.side_fields(cfg, 48, seed=6)
    L = config_layout(cfg)
    L[:2] = nbytes, nbytes - 1
    got = pack(lib, "rehearse_pack_warp", field_matrix(f), L, nbytes)
    assert C.count_differing(list(got), list(plain_pack(short, f))) == 0


@pytest.mark.parametrize("streams", [1, 33, 96])
def test_pack_bits_match_lane_on_clipped_layouts(lib, streams):
    L, F = C.side_layout_rows(seed=4)
    L, F = L[:streams], F[:streams]
    words = 16
    got = pack(lib, "rehearse_pack_warp", F, L, words)
    ref = pack(lib, "rehearse_pack_lane", F, L, words)
    assert C.count_differing(list(got), list(ref)) == 0
    if streams == 96:
        n = string_bits(L, ref[1], ref[2])
        assert (n > 8 * (L[:, 1] + 1)).any(), "no string runs below the row's first byte"
        assert (L[:, 1] > L[:, 0] - 1).any(), "no first side bit above the row's last byte"
        assert (n % 8 == 0).any(), "no string ends on a byte boundary"


@pytest.mark.parametrize("mutation", list(MUTATIONS))
def test_rehearsal_catches_mutated_pitch_side_warps(tmp_path, card_order, mutation):
    lib_m = build_wrapper(tmp_path, WRAPPER, "pitch_side", MUTATIONS, mutation)
    bad = 0
    if MUTATIONS[mutation][0] == "ltpf_encode.cuh":
        for frame_dms in FRAMES.values():
            cfg = config(frame_dms)
            bad += ltpf_differing(lib_m, cfg, C.ltpf_edge_rows(cfg, seed=2))
        bad += ltpf_differing(lib_m, config(), C.ltpf_rows(seed=1))
    else:
        for name in C.CONFIGS:
            cfg = P.Config(**C.CONFIGS[name])
            f = C.side_fields(cfg, 48, seed=3)
            got = pack(lib_m, "rehearse_pack_warp", field_matrix(f), config_layout(cfg),
                       cfg.targetBytes)
            bad += C.count_differing(list(got), list(plain_pack(cfg, f)))
        L, F = C.side_layout_rows(seed=4)
        bad += C.count_differing(list(pack(lib_m, "rehearse_pack_warp", F, L, 16)),
                                 list(pack(lib_m, "rehearse_pack_lane", F, L, 16)))
    assert bad > 0, f"the rehearsal did not see the mutation {mutation}"
