"""The channel coder's encoder and the Phase ECU's first-loss analysis, their
designs compiled for the CPU, against their plain versions.

csrc/fec.cuh (K19 enc, `fec_encode_warp`: the payload staged as nibbles,
the CRCs split over the lanes, a codeword a lane with its parity from packed
lookups, each output byte assembled by a lane) and csrc/phecu.cuh (K18a,
`ph_spec_ana_warp`: the rows staged once, the extremes warp reductions, the
group energies a lane a group over its own bins, the hysteresis scan one
short select chain, the count and the low-frequency test ballots) run over
the host warp of csrc/warp.cuh, which runs the 32 lanes of a step in turn,
every shuffle, ballot and reduction reading all lanes before any is
written. g++ builds them into a shared library called through ctypes. The
scratch and every output are filled with a byte pattern before each slot or
stream, so a value read before it is written shows. Every output must equal
the plain version's (ops/fec.py:fec_encode_plain,
ops/plc_phecu.py:phecu_spec_ana_plain, both unchanged) bit for bit at 1
and 33 slots or streams: K19 enc on fec_rows at every slot of FEC_SLOTS and
at 241 (the first slot of 33 codewords), EP1-4, with and without combined
channel coding, and on EPMR values outside 0..3 (clamped); K18a on
phecu_peak_rows (the phase-7-like spectra) and phecu_edge_rows (a tie of
equal magnitudes, peaks at the edge bins, a scan that ends in mode 1, bin
0, an all-zero row, a many-peak noise row, the drop rule taken and not).
Copies of the headers with one line changed must fail. It skips where there
is no g++."""
from __future__ import annotations

import functools

import numpy as np
import pytest
import torch

import audio_codec_torch as P
from audio_codec_torch import kernels as K
from audio_codec_torch.ops import fec, plc_phecu as H

from tests import torch_kernel_cases as C
from tests.test_torch_lane_rehearsal import build_wrapper, ptr

WRAPPER = r"""
#include "fec.cuh"
#include "phecu.cuh"
#include <cstring>
using namespace acx;

extern "C" {
void rehearse_fec_encode(const int* data, const int* epmr, const int* tabs, int B, int D,
                         int slot, int mode, int ccc, int* out) {
  FecEncScratch ws;
  for (int b = 0; b < B; ++b) {
    const size_t s = b;
    std::memset(&ws, 0x5A, sizeof ws);
    std::memset(out + s * slot, 0x5A, slot * sizeof(int));
    fec_encode_warp(CoderHostWarp{}, data + s * D, epmr[b], tabs, slot, mode, ccc, &ws,
                    out + s * slot);
  }
}
// the kernel's work a stream: -1 and zeros off the active streams, the
// analysis's warp on the others
void rehearse_spec_ana(const float* xr, const float* xi, const float* xor_, const float* xoi,
                       const float* nc, const int32_t* active, float* f0, int32_t* npl, float* e,
                       int B, int ns, int n_lgw) {
  PhAnaWork ws;
  const PhGeom g = {ns, 0, n_lgw, 0, 0, 0};
  for (int b = 0; b < B; ++b) {
    const size_t row = static_cast<size_t>(b) * ns;
    float* eo = e + static_cast<size_t>(b) * kPhGroups;
    float* el = e + (static_cast<size_t>(B) + b) * kPhGroups;
    std::memset(&ws, 0x5A, sizeof ws);
    std::memset(f0 + row, 0x5A, ns * sizeof(float));
    std::memset(eo, 0x5A, kPhGroups * sizeof(float));
    std::memset(el, 0x5A, kPhGroups * sizeof(float));
    std::memset(npl + b, 0x5A, sizeof(int32_t));
    if (!active[b]) {
      for (int k = 0; k < ns; ++k) f0[row + k] = -1.0f;
      for (int k = 0; k < kPhGroups; ++k) eo[k] = el[k] = 0.0f;
      npl[b] = 0;
      continue;
    }
    ph_spec_ana_warp(CoderHostWarp{}, g, xr + row, xi + row, xor_ + row, xoi + row, nc[b], &ws,
                     f0 + row, npl + b, eo, el);
  }
}
int fec_enc_table_words() { return kFecEncTableWords; }
}
"""

# mutations the rehearsal must catch. K19 enc: each CRC term's power of x
# one nibble on (fec_crc_warp, which the decoder shares), the interleave's
# codeword index one on, the bit swap left out, the signalling polynomial
# on five codewords. K18a: `>` for `>=` where a later equal magnitude takes
# the peak candidate, a group's range one bin short.
MUTATIONS = {
    "crc_power_offset": ("fec.cuh", "      int p = pw[i + 2 * h];", "      int p = pw[i + 2 * h + 1];"),
    "interleave_codeword": ("fec.cuh", "      const int i = t % p.ncw, j = t / p.ncw;",
                            "      const int i = (t + 1) % p.ncw, j = t / p.ncw;"),
    "bitswap_dropped": ("fec.cuh", "        if (i == 0) d = fec_bitswap64(d, p.ind0, p.ind1);", ""),
    "signalling_five_codewords": ("fec.cuh", "          if (i < 6) cw ^= sig;\n        }\n        ws->cw[i]",
                                  "          if (i < 5) cw ^= sig;\n        }\n        ws->cw[i]"),
    "scan_better_gt": ("phecu.cuh", "    const uint32_t better = all_if(m >= cand) & mode;",
                       "    const uint32_t better = all_if(m > cand) & mode;"),
    "group_range_short": ("phecu.cuh",
                          "hi = imin(ph_group_start(src + 1), ns);",
                          "hi = imin(ph_group_start(src + 1) - 1, ns);"),
}

STREAMS = [1, 33]
ENC_SLOTS = C.FEC_SLOTS + (241,)
PCFG = P.Config(fs_in=48000, bitrate=64000, plc_mode=1)


@pytest.fixture(scope="module")
def lib(tmp_path_factory):
    return build_wrapper(tmp_path_factory.mktemp("fecenc_phecu"), WRAPPER, "fecenc_phecu", MUTATIONS)


# ---- K19 enc ----

def lane_fec_encode(lib, data, epmr, slot, mode, ccc) -> np.ndarray:
    data = np.ascontiguousarray(data, np.int32)
    epmr = np.ascontiguousarray(epmr, np.int32)
    B, D = data.shape
    out = np.zeros((B, slot), np.int32)
    lib.rehearse_fec_encode(ptr(data), ptr(epmr), ptr(K.fec_enc_tables("cpu").numpy()), B, D,
                            slot, mode, ccc, ptr(out))
    return out


@functools.cache
def enc_case(slot: int, mode: int, ccc: int, clamp: bool = False):
    """fec_rows' payloads and EPMR (0..3, or values outside that range) and
    the plain encoder's slots."""
    data, epmr, _, _ = C.fec_rows(slot, mode, ccc)
    if clamp:
        epmr = np.resize(np.array([-7, -1, 4, 5, 100, 3, 0, -(1 << 31)], np.int32), len(epmr))
    ref = fec.fec_encode_plain(torch.from_numpy(data), torch.from_numpy(epmr), slot, mode,
                               ccc).numpy()
    return data, epmr, ref


def enc_differing(lib, slot: int, mode: int, ccc: int, n: int | None = None,
                  clamp: bool = False) -> int:
    data, epmr, ref = enc_case(slot, mode, ccc, clamp)
    n = len(data) if n is None else n
    return C.count_differing(lane_fec_encode(lib, data[:n], epmr[:n], slot, mode, ccc), ref[:n])


# ---- K18a ----

def spec_rows() -> dict[str, np.ndarray]:
    """The phase-7-like spectra of phecu_peak_rows (both seeds, the window a
    frame earlier their neighbour's) and the edge rows, with every seventh
    stream inactive."""
    parts = []
    for seed in (0, 1):
        r = C.phecu_peak_rows(seed)
        parts.append(dict(Xr=r["Xr"], Xi=r["Xi"], Xor=np.roll(r["Xr"], 1, 0),
                          Xoi=np.roll(r["Xi"], 1, 0), nc=r["nc"]))
    parts.append(C.phecu_edge_rows())
    rows = {k: np.ascontiguousarray(np.concatenate([p[k] for p in parts])) for k in parts[0]}
    rows["active"] = (np.arange(len(rows["nc"])) % 7 != 6).astype(np.int32)
    return rows


def tiled(rows: dict, n: int) -> dict:
    idx = np.arange(n) % len(rows["nc"])
    return {k: np.ascontiguousarray(v[idx]) for k, v in rows.items()}


def lane_spec_ana(lib, r: dict):
    B, ns = r["Xr"].shape
    f0, npl = np.zeros((B, ns), np.float32), np.zeros(B, np.int32)
    e = np.zeros((2, B, H.MAX_LGW), np.float32)
    lib.rehearse_spec_ana(*(ptr(r[k]) for k in ("Xr", "Xi", "Xor", "Xoi", "nc", "active")),
                          ptr(f0), ptr(npl), ptr(e), B, ns, H.n_lgw(PCFG))
    return f0, npl, e[0], e[1]


def plain_spec_ana(r: dict):
    t_ = lambda v: torch.from_numpy(np.asarray(v))
    out = H.phecu_spec_ana_plain(PCFG, *(t_(r[k]) for k in ("Xr", "Xi", "Xor", "Xoi", "nc")),
                                 t_(r["active"] != 0))
    return [v.numpy() for v in out]


def spec_differing(lib, n: int | None = None) -> int:
    rows = spec_rows()
    r = tiled(rows, len(rows["nc"]) if n is None else n)
    return C.count_differing(list(lane_spec_ana(lib, r)), plain_spec_ana(r))


# ---- the tests ----

def test_table_layout_matches_header(lib):
    assert lib.fec_enc_table_words() == K.fec_enc_tables("cpu").numel()


def bitswap_plan(slot: int, mode: int) -> tuple[int, int, int, int]:
    """(len0, nd0, ind0, ind1) of a slot and mode, from the channel coder's
    formulas (fec.py:_slot_plan and _mode_plan)."""
    ncw = (2 * slot + 14) // 15
    len0 = (2 * slot - 1) // ncw + 1
    nd0 = len0 - (fec._HD_MODE0[mode] - 1)
    return len0, nd0, 2 * fec.crc1_bytes(mode, slot) - 1, nd0 - 1


def test_bit_swap_lies_in_codeword_0s_data():
    """The premise of the warp's bit swap: at every slot of 40..300 bytes
    and EP1-4 (ccc does not change them), ind0 < ind1 < nd0 (codeword 0's
    data nibbles), and codeword 0 is 14 or 15 nibbles long; the formulas
    agree with the plain version's plans at the rows' slots."""
    for slot in ENC_SLOTS:
        for mode in (1, 2, 3, 4):
            mp = fec._mode_plan(slot, mode, 0)
            assert bitswap_plan(slot, mode) == (mp["sp"]["lens"][0], mp["sp"]["lens"][0] - mp["red"][0],
                                                mp["ind0"], mp["ind1"])
    for slot in range(fec.FEC_SLOT_BYTES_MIN, fec.FEC_SLOT_BYTES_MAX + 1):
        for mode in (1, 2, 3, 4):
            len0, nd0, ind0, ind1 = bitswap_plan(slot, mode)
            assert 14 <= len0 <= 15 and ind0 < ind1 < nd0, (slot, mode)


@pytest.mark.parametrize("slot", ENC_SLOTS)
@pytest.mark.parametrize("slots", STREAMS)
def test_fec_encode_warp_matches_plain(lib, slot, slots):
    bad = {(m, ccc): enc_differing(lib, slot, m, ccc, slots) for m in (1, 2, 3, 4) for ccc in (0, 1)}
    assert not any(bad.values()), bad


@pytest.mark.parametrize("slot", (40, 241))
def test_fec_encode_warp_clamps_epmr(lib, slot):
    """EPMR values outside 0..3 are clamped, as the plain version clamps
    them; slot 40 carries the 2-byte CRC1 at EP2-4."""
    bad = {m: enc_differing(lib, slot, m, 0, clamp=True) for m in (1, 2, 3, 4)}
    assert not any(bad.values()), bad


def test_fec_rows_reach_every_plan():
    """The encoder's rows cover 2- and 3-byte CRC1, CRC2 (EP3/EP4 with a
    partial-concealment block), codeword 0's CRC nibbles spilling into
    codeword 1 (EP4 with CRC2: 10 CRC nibbles, 9 data nibbles in codeword
    0 at 80 bytes) and more than 32 codewords."""
    plans = [fec._mode_plan(s, m, c) for s in ENC_SLOTS for m in (1, 2, 3, 4) for c in (0, 1)]
    assert {2, 3} <= {p["n_crc1"] for p in plans}
    assert any(p["n_crc2"] for p in plans)
    spill = [p for p in plans if 2 * (p["n_crc1"] + p["n_crc2"]) > p["sp"]["lens"][0] - p["red"][0]]
    assert spill and max(p["sp"]["ncw"] for p in plans) > 32


@pytest.mark.parametrize("streams", STREAMS)
def test_phecu_spec_ana_warp_matches_plain(lib, streams):
    assert spec_differing(lib, streams) == 0


def test_phecu_spec_ana_warp_on_every_row(lib):
    """Every row, and the branches the edge rows must take in the plain
    version."""
    assert spec_differing(lib) == 0
    r = C.phecu_edge_rows()
    r["active"] = np.ones(len(r["nc"]), np.int32)
    f0, npl, _, _ = plain_spec_ana(r)
    reached = C.phecu_edges_reached(f0, npl)
    assert all(reached.values()), reached


@pytest.mark.parametrize("mutation", list(MUTATIONS))
def test_rehearsal_catches_mutated_fecenc_and_phecu(tmp_path, mutation):
    lib_m = build_wrapper(tmp_path, WRAPPER, "fecenc_phecu", MUTATIONS, mutation)
    if MUTATIONS[mutation][0] == "fec.cuh":
        bad = sum(enc_differing(lib_m, slot, m, ccc) for slot in (40, 80, 241)
                  for m in (1, 2, 3, 4) for ccc in (0, 1))
    else:
        bad = spec_differing(lib_m)
    assert bad > 0, f"the rehearsal did not see the mutation {mutation}"
