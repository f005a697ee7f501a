"""The fixed-point SNS decode and the partial-concealment classifier with
the stability factor, their warp designs compiled for the CPU, against their
plain versions.

csrc/fx_sns_dec.cuh (K20a, `fx_sns_dec_warp`: a warp a frame, every value
32-bit, the MPVQ de-index over a table of offsets) and csrc/pc_classify.cuh
(K15, `pc_classify_warp`: a stream a lane, the streams that need a row taken
a group at a time, the peak detector on the whole warp) run over the host
warp of csrc/warp.cuh, which runs the 32 lanes of a step in turn, every
shuffle, ballot and reduction reading all lanes before any is written. g++
builds them into a shared library called through ctypes. Outputs and the
warp's scratch are filled with a byte pattern first, so a value read before
it is written shows. Every output must equal the plain version's bit for bit:
K20a's (ops/fixed_dev.py:sns_decode_plain) on every submode, out-of-range
MPVQ indices, the clamps of every index, every band count of the
configurations and a seeded sample of each shape's indices with the first
and last; K15's (ops/pc.py:pc_classify_plain, in the card's order) on rows
that take every branch of the stability factor, the classifier and the
detector. The table of offsets the de-index reads must hold the integers the
plain version's recurrence makes. Copies of the headers with one line changed
must fail. It skips where there is no g++.
"""
from __future__ import annotations

import functools

import numpy as np
import pytest
import torch

from audio_codec_torch import kernels as K
from audio_codec_torch.ops import fixed_dev, numerics, pc

from tests import torch_kernel_cases as C
from tests.test_torch_lane_rehearsal import build_wrapper, f32p, ptr
from tests.torch_port_data import PCFG

WRAPPER = r"""
#include "fx_sns_dec.cuh"
#include "pc_classify.cuh"
#include <cstring>
using namespace acx;

extern "C" {
void rehearse_sns(const int32_t* idx, const int32_t* tab, int n_bands, int L, fx::i64* scf,
                  fx::i64* scf_e) {
  int32_t bands[64];
  for (int l = 0; l < L; ++l) {
    std::memset(bands, 0x5A, sizeof bands);
    std::memset(scf + l * n_bands, 0x5A, n_bands * sizeof(fx::i64));
    std::memset(scf_e + l * n_bands, 0x5A, n_bands * sizeof(fx::i64));
    fx::fx_sns_dec_warp(CoderHostWarp{}, idx + 7 * l, tab, n_bands, bands, scf + l * n_bands,
                        scf_e + l * n_bands);
  }
}
void rehearse_pc(const int* bfi, const int* inv, const int* pitch, const float* qd,
                 const float* qres, const float* scf, const float* old, const float* old_old,
                 const int* prev, const int* prev2, int B, int N, int frame_dms, float inv_n,
                 int* out, float* stab) {
  static float stage[kPcGroup * kPcStride];
  PcArgs p{};
  const int* v[kPcVecs] = {bfi, inv, pitch, prev, prev2};
  for (int k = 0; k < kPcVecs; ++k) p.vec[k] = {v[k], 1, kVecInt32};
  p.q_old_d = qd;
  p.q_old_res = qres;
  p.scf_q = scf;
  p.old_scf = old;
  p.old_old_scf = old_old;
  p.B = B;
  p.N = N;
  p.frame_dms = frame_dms;
  p.inv_n = inv_n;
  p.bfi_out = out;
  p.stab_out = stab;
  std::memset(out, 0x5A, B * sizeof(int));
  std::memset(stab, 0x5A, B * sizeof(float));
  for (int b0 = 0; b0 < B; b0 += 32) {
    std::memset(stage, 0x5A, sizeof stage);
    pc_classify_warp(CoderHostWarp{}, p, b0, stage);
  }
}
int sns_table_words() { return fx::kFxSnsTableWords; }
}
"""

# mutations the rehearsal must catch. K20a: a position's count inclusive of
# the index's own offset row (the remaining length one short), the idct's
# output picked one lane off, the n_bands < 64 fold reading a band in place
# of its pair, InvLog2's table index one bit short. K15: the stability
# factor's division as a product by the reciprocal, the energy path's low
# region one bin wider, the hysteresis's running maximum without the first
# block's energy, the staged row one 16-byte word short.
MUTATIONS = {
    "deindex_row": ("fx_sns_dec.cuh", "          a[j] = col[j].a[DIM - pos - 1];",
                    "          a[j] = col[j].a[DIM - pos - 1 > 0 ? DIM - pos - 2 : 0];"),
    "idct_pick": ("fx_sns_dec.cuh", "  for (int j = 1; j < 16; ++j) r = k == j ? o[j] : r;",
                  "  for (int j = 1; j < 16; ++j) r = k == j ? o[j - 1] : r;"),
    "fold_pair": ("fx_sns_dec.cuh",
                  "      lo[j] = o0 < t ? mac_rw(L_multw(c[2 * o0], 16384), c[2 * o0 + 1], 16384)",
                  "      lo[j] = o0 < t ? mac_rw(L_multw(c[2 * o0], 16384), c[2 * o0], 16384)"),
    "invlog_index": ("fx_sns_dec.cuh", "        const int32_t t1 = (x & 2047) >> 5;",
                     "        const int32_t t1 = (x & 1023) >> 5;"),
    "stab_reciprocal": ("pc_classify.cuh", "rdiv(d, 25.0f)", "rmul(d, 0.04f)"),
    "energy_region": ("pc_classify.cuh", "pt = radd(pt, i < lim[l] ? e : 0.0f);",
                      "pt = radd(pt, i <= lim[l] ? e : 0.0f);"),
    "first_block_dropped": ("pc_classify.cuh",
                            "    float pm = l > 0 && before[l] > max0 ? before[l] : max0;",
                            "    float pm = l > 0 ? before[l] : 0.0f;"),
    "stage_short": ("pc_classify.cuh", "for (int c = l; c < n4; c += 32) pc_copy16",
                    "for (int c = l; c < n4 - 1; c += 32) pc_copy16"),
}

STREAMS = [1, 33]


@pytest.fixture(scope="module")
def lib(tmp_path_factory):
    return build_wrapper(tmp_path_factory.mktemp("snsdec_pc"), WRAPPER, "snsdec_pc", MUTATIONS)


# ---- K20a ----

def _c(a, dtype):
    return np.ascontiguousarray(a, dtype)


SNS_ROWS = {"grid": lambda: C.fx_sns_rows(), "sample": lambda: C.fx_sns_sample_rows(),
            "edge": lambda: C.fx_sns_edge_rows()}


def lane_sns(lib, idx: np.ndarray, n_bands: int):
    idx = _c(idx, np.int32)
    L = idx.shape[0]
    scf, scf_e = np.zeros((L, n_bands), np.int64), np.zeros((L, n_bands), np.int64)
    lib.rehearse_sns(ptr(idx), ptr(_c(K.fx_sns_table_pack(), np.int32)), n_bands, L, ptr(scf),
                     ptr(scf_e))
    return scf, scf_e


@functools.cache
def plain_sns(key: str, n_bands: int):
    return [t.numpy() for t in fixed_dev.sns_decode_plain(torch.from_numpy(SNS_ROWS[key]()),
                                                          n_bands)]


def sns_differing(lib, key: str, n_bands: int, n: int | None = None) -> int:
    idx = SNS_ROWS[key]()
    n = len(idx) if n is None else n
    return C.count_differing(list(lane_sns(lib, idx[:n], n_bands)),
                             [v[:n] for v in plain_sns(key, n_bands)])


def test_sns_table_layout_matches_header(lib):
    assert lib.sns_table_words() == K.FX_SNS_TABLE_WORDS == len(K.fx_sns_table_pack())


@pytest.mark.parametrize("rows", STREAMS)
@pytest.mark.parametrize("key", list(SNS_ROWS))
def test_sns_warp_matches_plain(lib, key, rows):
    assert sns_differing(lib, key, 64, rows) == 0


@pytest.mark.parametrize("key", list(SNS_ROWS))
def test_sns_warp_matches_plain_at_every_band_count(lib, key):
    bad = {nb: sns_differing(lib, key, nb) for nb in C.FX_SNS_BANDS}
    assert not any(bad.values()), bad


def test_sns_rows_reach_every_submode_and_range():
    """Every submode on the grid and the sample, the first and last index of
    each shape, the ber lanes of every submode and of submode 0's 6-position
    set, and the clamps of every index."""
    grid, sample, edge = (SNS_ROWS[k]() for k in ("grid", "sample", "edge"))
    for rows in (grid, sample):
        assert set(rows[:, 2].tolist()) == {0, 1, 2, 3}
    for s in range(4):
        size = C.SUBMODES[s][1]
        got = set(sample[sample[:, 2] == s, 5].tolist())
        assert {0, size - 1} <= got
    assert set(sample[sample[:, 2] == 0, 6].tolist()) == set(range(2 * C.MPVQ_6K1))
    _, ber = fixed_dev.sns_decode_scf(torch.from_numpy(edge))
    ber_sub = set(edge[ber.numpy() == 1, 2].tolist())
    assert {0, 1, 2, 3} <= ber_sub
    assert (edge[:, 6] >= 2 * C.MPVQ_6K1).any() and (edge[:, 5] < 0).any()
    assert (edge[:, 0] < 0).any() and (edge[:, 0] > 31).any() and (edge[:, 1] > 31).any()
    assert (edge[:, 3] < 0).any() and (edge[:, 3] > 7).any()
    assert {-1, 4} <= set(edge[:, 2].tolist())


@pytest.mark.parametrize("shape", C.FX_SNS_SHAPES, ids=lambda s: f"{s[0]}x{s[1]}")
def test_mpvq_offsets_table_equals_the_recurrence(shape):
    """At every position the de-index counts at, on a seeded sample of each
    shape's indices with the first and last, the recurrence's offsets h[k]
    (k <= k_max) equal the table's A(remaining positions, k)."""
    dim, kval, size = shape
    tab = K.fx_sns_mpvq_offsets()
    rng = np.random.default_rng(dim * 100 + kval)
    indices = [0, 1, size - 1, size - 2, *rng.integers(0, size, 400).tolist()]
    checked = 0
    for index in indices:
        for ls in (0, 1):
            for pos, h in enumerate(C.fx_sns_deindex_offsets(dim, kval, ls, int(index))):
                assert h == tab[dim - pos - 1, : len(h)].tolist(), (index, pos)
                checked += 1
    assert checked > len(indices) * 2


# ---- K15 ----

@functools.cache
def pc_case_rows(seed: int = 5) -> dict:
    d, r = C.pc_base_rows(8, seed=seed)
    return C.pc_fused_rows(d, r, seed=seed)


def lane_pc(lib, cfg, a: dict):
    B, N = a["q_old_d"].shape
    out, stab = np.zeros(B, np.int32), np.zeros(B, np.float32)
    lib.rehearse_pc(*(ptr(_c(a[k], np.int32 if a[k].dtype.kind in "iu" else np.float32))
                      for k in C.PC_FUSED_ORDER), B, N, cfg.frame_dms, f32p(1.0 / N), ptr(out),
                    ptr(stab))
    return out, stab


def plain_pc(cfg, a: dict):
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(numerics, "on_cpu", lambda x: False)
        got = pc.pc_classify_plain(cfg, *(torch.from_numpy(a[k]) for k in C.PC_FUSED_ORDER))
    return [t.numpy() for t in got]


def pc_differing(lib, a: dict, n: int | None = None) -> int:
    n = len(a["bfi"]) if n is None else n
    part = {k: _c(v[:n], v.dtype) for k, v in a.items()}
    return C.count_differing(list(lane_pc(lib, PCFG, part)), plain_pc(PCFG, part))


@pytest.mark.parametrize("rows", STREAMS)
def test_pc_classify_warp_matches_plain(lib, rows):
    assert pc_differing(lib, pc_case_rows(), rows) == 0


@pytest.mark.parametrize("seed", [5, 6])
def test_pc_classify_warp_takes_every_branch(lib, seed):
    """Clean frames; bfi 1 after a good frame (prev-prev 1 and otherwise) and
    after a lost one; bfi 2 after bfi 1; stability 0, between and 1;
    unstable; the detector's first-block hit, hysteresis move and no
    candidate; the energy path; downgraded and kept."""
    a = pc_case_rows(seed)
    assert pc_differing(lib, a) == 0
    bfi, stab = plain_pc(PCFG, a)
    branches = C.pc_fused_branches(a, bfi, stab)
    assert all(v > 0 for v in branches.values()), branches


def test_pc_classify_warp_on_a_full_warp_of_detector_and_energy_streams(lib):
    """32 streams all on the detector's path, then all on the energy path:
    four groups of staged rows a warp."""
    a = pc_case_rows()
    sel = np.nonzero((a["bfi"] == 2) & (a["spec_inv_idx"] < 40) & (a["pitch_present"] == 1))[0]
    for pitch in (1, 0):
        rows = {k: _c(np.resize(v[sel], (32,) + v.shape[1:]), v.dtype) for k, v in a.items()}
        rows["pitch_present"][:] = pitch
        rows["prev_bfi"][:] = 1            # stability 0.8: every stream stable
        assert pc_differing(lib, rows) == 0


@pytest.mark.parametrize("mutation", list(MUTATIONS))
def test_rehearsal_catches_mutated_sns_and_pc(tmp_path, mutation):
    lib_m = build_wrapper(tmp_path, WRAPPER, "snsdec_pc", MUTATIONS, mutation)
    if MUTATIONS[mutation][0] == "fx_sns_dec.cuh":
        bad = sum(sns_differing(lib_m, key, nb) for key in SNS_ROWS for nb in (20, 44, 64))
    else:
        bad = pc_differing(lib_m, pc_case_rows()) + pc_differing(lib_m, pc_case_rows(6))
    assert bad > 0, f"the rehearsal did not see the mutation {mutation}"
