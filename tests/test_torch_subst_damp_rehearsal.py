"""The Phase ECU's substitution and the concealment's damping and
scrambling, their designs compiled for the CPU, against their plain
versions.

csrc/phecu.cuh (K18b, `ph_subst_warp`: the peak mask a string of ballot
words and each bin's nearest peak from its bits, a peak's cosine and sine
once, by rank, the generator phases' from a 32-entry table) and
csrc/plc_damp.cuh (K17b, `damp_warp`: the pass-through copy, the rows and
generator jumps in registers, the energy terms at a padded stride for XLA's
windows of 32, the window sums by shuffles) run over the host warp of
csrc/warp.cuh, which runs the 32 lanes of a step in turn, every shuffle and
ballot reading all lanes before any is written. g++ builds them into a
shared library called through ctypes, with the kernels' entry points' way
of handing over the per-stream vectors (csrc/plc.cuh:StreamVec): here bool
masks as bytes, int32 counters and a column of a wider row, as the
decoder passes them. The scratch and every output are filled with a
byte pattern before each stream, so a value read before it is written
shows. Every output must equal the plain version's
(ops/plc_phecu.py:phecu_subst_plain, ops/plc_adv.py:damp_scramble_plain,
both unchanged) bit for bit at 1 and 33 streams: K18b on phecu_subst_rows
and phecu_subst_edge_rows (peaks at the edge bins, equidistant and adjacent
peaks, the zero rule, a transient, a burst of 100 frames), with the sine and
cosine as the host build computes them (`exact_trig`); K17b on
damp_stream_rows and damp_edge_rows (partial concealment from bins 0, 1,
398, 399, 400, an all-zero and a 60 dB row, generator values on the sign
threshold). Copies of the headers with one line changed must fail. It skips
where there is no g++."""
from __future__ import annotations

import ctypes
import math

import numpy as np
import pytest
import torch

import audio_codec_torch as P
from audio_codec_torch.ops import plc_adv, plc_phecu as H

from tests import torch_kernel_cases as C
from tests.test_torch_lane_rehearsal import build_wrapper, exact_trig, ptr  # noqa: F401

WRAPPER = r"""
#include "phecu.cuh"
#include "plc_damp.cuh"
#include <cstring>
using namespace acx;

extern "C" {
// the kernel's work a stream: zeros off the active streams, the warp on the
// others; vecs, meta as the entry point takes them
void rehearse_subst(const float* xr, const float* xi, const float* f0, const float* e_oold,
                    const float* e_old, const float* mc1, const float* xavg,
                    const void* const* vecs, const int* meta, const int32_t* tab, float* outr,
                    float* outi, int B, const int* gi) {
  PhWork ws;
  const PhGeom g = {gi[0], gi[1], gi[2], gi[3], gi[4], gi[5]};
  StreamVec v[5];
  for (int i = 0; i < 5; ++i) v[i] = {vecs[i], meta[2 * i], meta[2 * i + 1]};
  for (int b = 0; b < B; ++b) {
    const size_t row = static_cast<size_t>(b) * g.nsf, gb = static_cast<size_t>(b) * kPhGroups;
    std::memset(&ws, 0x5A, sizeof ws);
    std::memset(outr + row, 0x5A, g.nsf * sizeof(float));
    std::memset(outi + row, 0x5A, g.nsf * sizeof(float));
    if (!vec_int(v[3], b)) {
      for (int k = 0; k < g.nsf; ++k) outr[row + k] = outi[row + k] = 0.0f;
      continue;
    }
    ph_subst_warp(CoderHostWarp{}, g, xr + row, xi + row, f0 + static_cast<size_t>(b) * g.ns,
                  vec_int(v[0], b), vec_int(v[1], b), vec_int(v[2], b), e_oold + gb, e_old + gb,
                  mc1 + gb, vec_float(v[4], b), xavg + gb, tab, &ws, outr + row, outi + row);
  }
}
void rehearse_damp(const float* x, const float* q, const void* const* vecs, const int* meta,
                   const int32_t* pows, float* spec, float* fout, int32_t* iout, int B, int N) {
  DampWork ws;
  StreamVec v[kDampVecs];
  for (int i = 0; i < kDampVecs; ++i) v[i] = {vecs[i], meta[2 * i], meta[2 * i + 1]};
  for (int b = 0; b < B; ++b) {
    const size_t row = static_cast<size_t>(b) * N;
    std::memset(&ws, 0x5A, sizeof ws);
    std::memset(spec + row, 0x5A, N * sizeof(float));
    DampOut o;
    std::memset(&o, 0x5A, sizeof o);
    damp_warp(CoderHostWarp{}, damp_in(v, b), x + row, q + row, pows, N, &ws, spec + row, o);
    fout[b] = o.st.cf;
    fout[B + b] = o.st.cs;
    fout[2 * B + b] = o.st.cfa;
    iout[b] = o.ns_seed;
    iout[B + b] = o.pc_seed;
  }
}
}
"""

# mutations the rehearsal must catch. K18b: the lower neighbour's peak before
# the upper one's at equal distance, the phase table one entry on, a peak's
# rank counted from the bin's own word of the mask. K17b: a window's pad of 7 bins
# instead of 8, the partial concealment's pass drawing from the noise
# substitution's seed.
MUTATIONS = {
    "subst_lower_first": ("phecu.cuh", "const int kp = du <= dd ? k + du : k - dd",
                          "const int kp = du < dd ? k + du : k - dd"),
    "phase_table_off_by_one": ("phecu.cuh", "const float ph = rmul(kPhStep, static_cast<float>(l));",
                               "const float ph = rmul(kPhStep, static_cast<float>(l + 1));"),
    "peak_rank_own_word": ("phecu.cuh", "(side > 0 ? cum[su + 1] : cum[su]);", "cum[su];"),
    "window_pad_7": ("plc_damp.cuh", "left = N <= 32 ? 0 : (nwin * 32 - N) / 2;",
                     "left = N <= 32 ? 0 : (nwin * 32 - N) / 2 - 1;"),
    "second_pass_first_seed": ("plc_damp.cuh", "in.pc_pitch, in.pc_seed,", "in.pc_pitch, in.ns_seed,"),
}

STREAMS = [1, 33]
PCFG = P.Config(fs_in=48000, bitrate=64000, plc_mode=1)
_TYPES = {np.dtype(np.bool_): 0, np.dtype(np.int32): 1, np.dtype(np.float32): 2}


@pytest.fixture(scope="module")
def lib(tmp_path_factory):
    return build_wrapper(tmp_path_factory.mktemp("subst_damp"), WRAPPER, "subst_damp", MUTATIONS)


def stream_vecs(arrays: list[np.ndarray]):
    """The entry points' (addresses, (stride, type) pairs) of numpy vectors,
    which the caller holds until the call has returned."""
    meta = []
    for a in arrays:
        meta += (a.strides[0] // a.itemsize, _TYPES[a.dtype])
    return ((ctypes.c_void_p * len(arrays))(*(a.ctypes.data for a in arrays)),
            (ctypes.c_int * len(meta))(*meta))


def column(v: np.ndarray, dtype) -> np.ndarray:
    """v as column 1 of a [B, 3] array: a strided vector, as the decoder's
    LTPF pitch flag is."""
    wide = np.zeros((len(v), 3), dtype)
    wide[:, 1] = v
    return wide[:, 1]


def tiled(rows: dict, n: int) -> dict:
    B = len(next(iter(rows.values())))
    idx = np.arange(n) % B
    return {k: np.ascontiguousarray(v[idx]) for k, v in rows.items()}


# ---- K18b ----

def subst_rows() -> dict[str, np.ndarray]:
    """phecu_subst_rows of both seeds (their peaks from the plain analysis,
    one stream's count set to 1) and the edge rows."""
    parts = []
    for seed in (0, 1):
        r, d = C.phecu_peak_rows(seed), C.phecu_subst_rows(seed)
        t_ = lambda v: torch.from_numpy(np.asarray(v))
        f0, npl = H._peaks(t_(r["Xr"]), t_(r["Xi"]), t_(r["nc"]))
        npl = npl.numpy().astype(np.int32)
        npl[5] = 1
        parts.append(dict(d, f0est=f0.numpy(), num_plocs=npl, active=d["active"] != 0))
    parts.append(C.phecu_subst_edge_rows())
    return {k: np.concatenate([p[k] for p in parts]).astype(parts[-1][k].dtype)
            for k in C.PHECU_SUBST_ARGS}


def lane_subst(lib, r: dict):
    B = r["Xr"].shape[0]
    f = lambda k: np.ascontiguousarray(r[k], np.float32)
    held = [r["num_plocs"].astype(np.int32), r["nb_cur"].astype(np.int32),
            column(r["is_trans"], np.int32), r["active"].astype(bool),
            r["beta_mute"].astype(np.float32)]
    vecs, meta = stream_vecs(held)
    tab = np.ascontiguousarray(H.lcg_tables(H.search_bins(PCFG)), np.int32)
    outr, outi = (np.zeros((B, H.nbins(PCFG)), np.float32) for _ in range(2))
    gi = np.array([H.search_bins(PCFG), H.nbins(PCFG), H.n_lgw(PCFG), PCFG.frame_length,
                   H.t_adv(PCFG), H.lprot(PCFG)], np.int32)
    groups = [f(k) for k in ("e_oold", "e_old", "mag_chg_1st", "xavg")]
    lib.rehearse_subst(ptr(f("Xr")), ptr(f("Xi")), ptr(f("f0est")), *(ptr(g) for g in groups),
                       vecs, meta, ptr(tab), ptr(outr), ptr(outi), B, ptr(gi))
    return outr, outi


def plain_subst(r: dict):
    t_ = lambda k: torch.from_numpy(np.asarray(r[k]))
    return [v.numpy() for v in H.phecu_subst_plain(PCFG, *(t_(k) for k in C.PHECU_SUBST_ARGS))]


def subst_differing(lib, n: int | None = None, rows: dict | None = None) -> int:
    rows = subst_rows() if rows is None else rows
    r = rows if n is None else tiled(rows, n)
    return C.count_differing(list(lane_subst(lib, r)), plain_subst(r))


# ---- K17b ----

def damp_rows() -> dict[str, np.ndarray]:
    parts = [C.damp_stream_rows(0), C.damp_stream_rows(1), C.damp_edge_rows()]
    return {k: np.concatenate([np.asarray(p[k]) for p in parts]) for k in C.DAMP_ARGS}


def lane_damp(lib, d: dict):
    B, N = d["x"].shape
    b_ = lambda k: np.asarray(d[k]) != 0
    i_ = lambda k: np.asarray(d[k], np.int32)
    f_ = lambda k: np.asarray(d[k], np.float32)
    # the decoder's types: bool masks, int32 counters, the LTPF flag a column
    held = [b_("ns_lane"), b_("lost"), b_("is_pc"), i_("nb_cur"), i_("pc_nb_lost"), i_("pitch_int"),
            column(i_("pc_pitch"), np.int32), i_("ns_seed"), i_("pc_seed"),
            i_("spec_inv_idx"), f_("stab_fac"), f_("cum_fflc"), f_("cum_slow"), f_("cum_fast")]
    vecs, meta = stream_vecs(held)
    spec = np.zeros((B, N), np.float32)
    fout, iout = np.zeros((3, B), np.float32), np.zeros((2, B), np.int32)
    pows = np.ascontiguousarray(plc_adv.lcg_pows(N), np.int32)
    lib.rehearse_damp(ptr(np.ascontiguousarray(f_("x"))), ptr(np.ascontiguousarray(f_("q_d_prev"))),
                      vecs, meta, ptr(pows), ptr(spec), ptr(fout), ptr(iout), B, N)
    return [spec, fout[0], fout[1], fout[2], iout[0], iout[1]]


def plain_damp(d: dict):
    t_ = lambda k: torch.from_numpy(np.asarray(d[k]))
    args = [t_(k) != 0 if k in C.DAMP_MASKS else t_(k) for k in C.DAMP_ARGS]
    return [v.numpy() for v in plc_adv.damp_scramble_plain(PCFG, *args)]


def damp_differing(lib, n: int | None = None, rows: dict | None = None) -> int:
    rows = damp_rows() if rows is None else rows
    d = rows if n is None else tiled(rows, n)
    return C.count_differing(lane_damp(lib, d), plain_damp(d))


# ---- the tests ----

def test_generator_phases_take_32_values():
    """The premise of the phase table: the plain version's phases (both
    draws, every bin, any seed) are float32(2 pi / 32) times 0..31, the
    kernel's step kPhStep (0x1.921fb6p-3) times the lane."""
    assert np.float32(2.0 * math.pi / 32.0) == np.float32(float.fromhex("0x1.921fb6p-3"))
    seeds = torch.arange(-70000, 70000, 997, dtype=torch.int32)
    ph = H.rand_phases(seeds, H.search_bins(PCFG))
    table = np.float32(2.0 * math.pi / 32.0) * np.arange(32, dtype=np.float32)
    assert set(np.unique(ph.numpy()).tolist()) <= set(table.tolist())
    assert len(np.unique(ph.numpy())) == 32


@pytest.mark.parametrize("streams", STREAMS)
def test_phecu_subst_warp_matches_plain(lib, exact_trig, streams):  # noqa: F811
    assert subst_differing(lib, streams) == 0


def test_phecu_subst_warp_on_every_row(lib, exact_trig):  # noqa: F811
    """Every row, and every edge the edge rows are made for."""
    assert subst_differing(lib) == 0
    reached = C.phecu_subst_edges_reached(C.phecu_subst_edge_rows())
    assert all(reached.values()), reached


@pytest.mark.parametrize("streams", STREAMS)
def test_plc_damp_warp_matches_plain(lib, streams):
    assert damp_differing(lib, streams) == 0


def test_plc_damp_warp_on_every_row(lib):
    """Every row, and every edge the edge rows are made for."""
    assert damp_differing(lib) == 0
    reached = C.damp_edges_reached(C.damp_edge_rows())
    assert all(reached.values()), reached


@pytest.mark.parametrize("mutation", list(MUTATIONS))
def test_rehearsal_catches_mutated_subst_and_damp(tmp_path, exact_trig, mutation):  # noqa: F811
    lib_m = build_wrapper(tmp_path, WRAPPER, "subst_damp", MUTATIONS, mutation)
    bad = subst_differing(lib_m) if MUTATIONS[mutation][0] == "phecu.cuh" else damp_differing(lib_m)
    assert bad > 0, f"the rehearsal did not see the mutation {mutation}"
