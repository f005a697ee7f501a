"""The fixed-point decoder's DCT-IV and the channel coder's decoder, their
designs compiled for the CPU, against their plain versions.

csrc/fx_dct4.cuh (K20c, `fx_dct4_row`: every value a Word32 in an int32,
the stages spread over the lanes of a row's group) runs over the host group
of csrc/fixed.cuh, one thread running every node of a stage in turn; and
csrc/fec.cuh (K19 dec, `fec_decode_warp`: a codeword a lane, the 18
detections on 18 lanes, the CRCs split over the lanes) over the host warp
of csrc/warp.cuh, which runs the 32 lanes of a step in turn, every shuffle,
ballot and reduction reading all lanes before any is written. g++ builds
them into a shared library called through ctypes. The scratch and every
output are filled with a byte pattern before each row or slot, so a value
read before it is written shows. Every output must equal the plain
version's (ops/fixed_dev.py:batch_dct4_plain, ops/fec.py:fec_decode_plain,
both unchanged) bit for bit at 1 and 33 rows or slots: K20c on
tests/torch_kernel_cases.py's fx_dct4_rows and fx_dct4_edge_rows (-2^31,
headroom 0, 30 and 31, rows the pre-scale takes to full scale, all-zero rows
among nonzero ones); K19 dec on fec_rows at every slot of FEC_SLOTS, EP1-4,
with and without combined channel coding, on wrong_mode_rows,
epmr_risk_rows, fec_failure_rows (the EPMR estimate of a total failure) and
fec_cap_rows (slot 40 at the low-rate cap). The 32-bit primitives the DCT-IV
adds (neg_sat32, shl_sat32) must equal the 64-bit ones on a grid of edge
values: for Word32 inputs the transform's scaling keeps every sum inside 32
bits, so no row reaches their saturation. Copies of the headers with one
line changed must fail. It skips where there is no g++."""
from __future__ import annotations

import functools
import itertools

import numpy as np
import pytest
import torch

from audio_codec_torch import kernels as K
from audio_codec_torch.ops import fec, fixed_dev

from tests import torch_kernel_cases as C
from tests.test_torch_lane_rehearsal import build_wrapper, ptr

WRAPPER = r"""
#include "fx_dct4.cuh"
#include "fec.cuh"
#include <cstring>
using namespace acx;

extern "C" {
void rehearse_dct4(const fx::i64* y, const fx::i64* y_e, const int32_t* tab, int L, fx::i64* ytda,
                   fx::i64* ye, fx::i64* ys, bool* zero) {
  fx::w32 a[fx::kDctN], b[fx::kDctN];
  for (int l = 0; l < L; ++l) {
    const size_t r = l;
    std::memset(a, 0x5A, sizeof a);
    std::memset(b, 0x5A, sizeof b);
    std::memset(ytda + r * fx::kDctN, 0x5A, fx::kDctN * sizeof(fx::i64));
    std::memset(ye + r, 0x5A, sizeof(fx::i64));
    std::memset(ys + r, 0x5A, sizeof(fx::i64));
    std::memset(zero + r, 0x5A, 1);
    fx::fx_dct4_row(fx::Host{}, y + r * fx::kDctN, y_e[l], tab, a, b, ytda + r * fx::kDctN,
                    ye + r, ys + r, zero + r);
  }
}
// the 32-bit forms against the 64-bit ones (fixed.cuh): values that differ
int w32_differing(const int32_t* xs, int n) {
  int bad = 0;
  for (int i = 0; i < n; ++i) {
    const fx::i64 x = xs[i];
    if (fx::neg_sat32(xs[i]) != fx::lneg(x)) ++bad;
    for (int s = 0; s < 32; ++s)
      if (fx::shl_sat32(xs[i], s) != fx::L_shl(x, s)) ++bad;
  }
  return bad;
}
void rehearse_fec(const int* frames, const int* bfi_in, const int* tabs, int B, int slot, int ccc,
                  int* data, int* out) {
  FecWarpScratch ws;
  for (int b = 0; b < B; ++b) {
    const size_t s = b;
    std::memset(&ws, 0x5A, sizeof ws);
    std::memset(data + s * slot, 0x5A, slot * sizeof(int));
    for (int k = 0; k < N_FEC_OUT; ++k) out[k * B + b] = 0x5A5A5A5A;
    fec_decode_warp(CoderHostWarp{}, frames + s * slot, bfi_in[b], tabs, tabs + kFecCrcPow, slot,
                    ccc, &ws, data + s * slot, out + b, B);
  }
}
int dct4_table_words() { return fx::kFxDctTableWords; }
int fec_dec_table_words() { return kFecDecTableWords; }
}
"""

# mutations the rehearsal must catch. K20c: L_negate's saturation dropped
# (-(-2^31) wraps), L_shl's saturation dropped, the radix-8 rows' first
# input shifted by 2 (the twiddle-free column), fft30's last stage summing
# where it subtracts. K19 dec: each CRC lane's nibbles one on, the first
# codeword's risk left out of the chain (the chain's order itself is not
# observable: test_risk_chain_order_is_not_observable), the trust of a PC
# codeword from the wrong risk row.
MUTATIONS = {
    "neg_saturation_dropped": ("fx_dct4.cuh",
                               "ACX_HD w32 neg_sat32(w32 a) { return sub_sat32(0, a); }",
                               "ACX_HD w32 neg_sat32(w32 a) { return static_cast<w32>(0u - "
                               "static_cast<uint32_t>(a)); }"),
    "shl_saturation_dropped": ("fx_dct4.cuh",
                               "  return (r >> s) == x ? r : (x < 0 ? kW32Min : kW32Max);",
                               "  return r;"),
    "radix8_shift": ("fx_dct4.cuh", "      x[2 * k] = a >> 1;\n      x[2 * k + 1] = b >> 1;",
                     "      x[2 * k] = a >> 2;\n      x[2 * k + 1] = b >> 1;"),
    "fft30_sum_parity": ("fx_dct4.cuh", "  const bool sum = (i < 15) == ((t & 1) == 0);",
                         "  const bool sum = (i < 15) == ((t & 1) == 1);"),
    "crc_lane_offset": ("fec.cuh", "    for (int i = l; i < n; i += 32) {\n      const int vi = v[i];",
                        "    for (int i = l + 1; i < n; i += 32) {\n      const int vi = v[i];"),
    "risk_chain_skips_codeword_0": ("fec.cuh", "    for (int i = 0; i < 6; ++i) {\n      IL from;",
                                    "    for (int i = 1; i < 6; ++i) {\n      IL from;"),
    "trust_risk_row": ("fec.cuh", "      const int risk_e = kFecRiskE + (m + 1) * 4;",
                       "      const int risk_e = kFecRiskE + m * 4;"),
}

STREAMS = [1, 33]


@pytest.fixture(scope="module")
def lib(tmp_path_factory):
    return build_wrapper(tmp_path_factory.mktemp("fxdct_fec"), WRAPPER, "fxdct_fec", MUTATIONS)


# ---- K20c ----

@functools.cache
def dct_rows() -> tuple[np.ndarray, np.ndarray]:
    y0, e0 = C.fx_dct4_rows()
    y1, e1 = C.fx_dct4_edge_rows()
    return np.concatenate([y1, y0]), np.concatenate([e1, e0])


def lane_dct4(lib, y: np.ndarray, y_e: np.ndarray):
    y, y_e = np.ascontiguousarray(y, np.int64), np.ascontiguousarray(y_e, np.int64)
    L = y.shape[0]
    ytda, ye, ys = np.zeros_like(y), np.zeros(L, np.int64), np.zeros(L, np.int64)
    zero = np.zeros(L, np.bool_)
    tab = np.ascontiguousarray(K.fx_dct4_table_pack(), np.int32)
    lib.rehearse_dct4(ptr(y), ptr(y_e), ptr(tab), L, ptr(ytda), ptr(ye), ptr(ys), ptr(zero))
    return ytda, ye, ys, zero


@functools.cache
def plain_dct4_all():
    y, y_e = dct_rows()
    return [t.numpy() for t in fixed_dev.batch_dct4_plain(torch.from_numpy(y),
                                                          torch.from_numpy(y_e), 480)]


def dct4_differing(lib, n: int | None = None) -> int:
    y, y_e = dct_rows()
    n = len(y) if n is None else n
    return C.count_differing(list(lane_dct4(lib, y[:n], y_e[:n])), [v[:n] for v in plain_dct4_all()])


W32_EDGES = np.array([-(1 << 31), -(1 << 31) + 1, -(1 << 30) - 1, -(1 << 30), -(1 << 30) + 1,
                      -65536, -32769, -32768, -2, -1, 0, 1, 2, 32767, 65535, (1 << 30) - 1,
                      1 << 30, (1 << 31) - 2, (1 << 31) - 1], np.int32)


def w32_bad(lib) -> int:
    return lib.w32_differing(ptr(W32_EDGES), len(W32_EDGES))


# ---- K19 dec ----

def lane_fec(lib, frames, bfi_in, slot, ccc) -> dict:
    frames = np.ascontiguousarray(frames, np.int32)
    bfi_in = np.ascontiguousarray(bfi_in, np.int32)
    B = frames.shape[0]
    data, out = np.zeros((B, slot), np.int32), np.zeros((9, B), np.int32)
    lib.rehearse_fec(ptr(frames), ptr(bfi_in), ptr(K.fec_dec_tables("cpu").numpy()), B, slot, ccc,
                     ptr(data), ptr(out))
    return dict(zip(fec.DECODE_FIELDS, [data, *out]))


@functools.cache
def fec_case(slot: int, mode: int, ccc: int) -> tuple[np.ndarray, np.ndarray]:
    data, epmr, kinds, bfi_in = C.fec_rows(slot, mode, ccc)
    enc = fec.fec_encode_plain(torch.from_numpy(data), torch.from_numpy(epmr), slot, mode,
                               ccc).numpy()
    return C.channel_errors(enc, slot, mode, kinds, np.random.default_rng(1)), bfi_in


@functools.cache
def plain_fec(slot: int, ccc: int, key: str) -> dict:
    frames, bfi_in = FEC_INPUTS[key](slot, ccc)
    out = fec.fec_decode_plain(torch.from_numpy(frames), slot, ccc, torch.from_numpy(bfi_in))
    return {k: v.numpy() for k, v in out.items()}


def _synthetic(frames: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    return frames, np.zeros(len(frames), np.int32)


FEC_INPUTS = {
    **{f"ep{m}": (lambda slot, ccc, m=m: fec_case(slot, m, ccc)) for m in (1, 2, 3, 4)},
    "wrong_mode": lambda slot, ccc: _synthetic(C.wrong_mode_rows(slot)),
    "epmr_risk": lambda slot, ccc: _synthetic(C.epmr_risk_rows(slot)),
    "failure": lambda slot, ccc: _synthetic(C.fec_failure_rows(slot)),
    **{f"cap{m}": (lambda slot, ccc, m=m: _synthetic(C.fec_cap_rows(m))) for m in (2, 3, 4)},
}
SYNTHETIC = (("wrong_mode", 80), ("epmr_risk", 80), ("failure", 40), ("failure", 80),
             ("failure", 300), ("cap2", 40), ("cap3", 40), ("cap4", 40))


def fec_differing(lib, slot: int, ccc: int, key: str, n: int | None = None) -> int:
    frames, bfi_in = FEC_INPUTS[key](slot, ccc)
    n = len(frames) if n is None else n
    got = lane_fec(lib, frames[:n], bfi_in[:n], slot, ccc)
    ref = plain_fec(slot, ccc, key)
    return sum(C.count_differing(got[k], ref[k][:n]) for k in fec.DECODE_FIELDS)


# ---- the tests ----

def test_table_layouts_match_headers(lib):
    assert lib.dct4_table_words() == K.FX_DCT4_TABLE_WORDS == len(K.fx_dct4_table_pack())
    assert lib.fec_dec_table_words() == K.fec_dec_tables("cpu").numel()


def test_w32_primitives_match_the_64_bit_ones(lib):
    assert w32_bad(lib) == 0


@pytest.mark.parametrize("rows", STREAMS)
def test_dct4_rows_match_plain(lib, rows):
    assert dct4_differing(lib, rows) == 0


def test_dct4_rows_reach_every_edge(lib):
    """All rows; input headrooms 0, 30 and 31, a value of -2^31, rows taken
    to full scale, and all-zero rows between nonzero ones."""
    assert dct4_differing(lib) == 0
    y, _ = dct_rows()
    nz = y != 0
    nl = C._norm_l(np.where(nz, y, 1))
    head = np.where(nz.any(1), np.where(nz, nl, 32).min(1), 32)
    assert {0, 30, 31} <= set(head.tolist())
    assert (y == -(1 << 31)).any(1).sum() >= 3
    full = [(np.abs(r).max() < 1 << 30) and head[i] < 32 and
            ((r << head[i]) == -(1 << 31)).any() for i, r in enumerate(y)]
    assert sum(full) >= 3
    zero = plain_dct4_all()[3]
    assert zero.sum() >= 2 and not zero[:2].any()


@pytest.mark.parametrize("slot", C.FEC_SLOTS)
@pytest.mark.parametrize("slots", STREAMS)
def test_fec_decode_warp_matches_plain(lib, slot, slots):
    """EP1-4 with and without combined channel coding: clean, corrected,
    PC-destroyed, heavily damaged and lost frames, every EPMR."""
    bad = {(m, ccc): fec_differing(lib, slot, ccc, f"ep{m}", slots) for m in (1, 2, 3, 4)
           for ccc in (0, 1)}
    assert not any(bad.values()), bad


@pytest.mark.parametrize("key,slot", SYNTHETIC)
def test_fec_decode_warp_on_synthetic_rows(lib, key, slot):
    assert fec_differing(lib, slot, 0, key, 1) == 0
    assert fec_differing(lib, slot, 0, key) == 0


def test_fec_rows_reach_every_path():
    """The plain decoder's outcomes over the rows: EP1 passes, corrected
    modes, bfi 2 with a span, total failures with an estimated EPMR, the
    cap's rejections and its cleared flags."""
    outs = [plain_fec(slot, ccc, f"ep{m}") for slot in C.FEC_SLOTS for m in (1, 2, 3, 4)
            for ccc in (0, 1)]
    outs += [plain_fec(slot, 0, key) for key, slot in SYNTHETIC]
    cat = {k: np.concatenate([o[k].ravel() for o in outs]) for k in ("mode", "bfi", "error_report",
                                                                      "be_bp_left", "epmr")}
    failure = (cat["mode"] == -1) & (cat["error_report"] == 0x7FF)
    assert failure.sum() >= 8 and (cat["epmr"][failure] >= 4).any()
    assert {1, 2, 3, 4} <= set(cat["mode"].tolist())
    assert ((cat["bfi"] == 2) & (cat["be_bp_left"] >= 0)).any()
    cap = np.concatenate([plain_fec(40, 0, f"cap{m}")["error_report"] for m in (2, 3, 4)])
    mode = np.concatenate([plain_fec(40, 0, f"cap{m}")["mode"] for m in (2, 3, 4)])
    rejected = (mode == -1) & (cap != 0x7FF)
    cleared = (mode >= 3) & ((cap & 0x1000) == 0) & (cap != -1)
    assert rejected.sum() >= 4 and cleared.sum() >= 4


def test_risk_chain_order_is_not_observable():
    """The six risk factors of a mode multiplied in reverse order change
    the product's last bits for some degree patterns, but no threshold test
    and no pick between two modes that pass it (al_fec.c:1190-1290): every
    pattern of degrees 0-3 over codewords 0..5, both slot classes. So the
    kernel keeps the order 0..5, and no rehearsal can tell it from
    another."""
    rm, re = fec._RISK_M, fec._RISK_E

    def mul(p, m2, e2):
        aux = (p[0] * m2) >> 14
        return (aux >> 1, p[1] + e2 + 1) if aux & 32768 else (aux, p[1] + e2)

    le = lambda a, b: a[1] < b[1] or (a[1] == b[1] and a[0] <= b[0])
    lt = lambda a, b: a[1] < b[1] or (a[1] == b[1] and a[0] < b[0])
    prods, differ = {}, 0
    for m in (0, 1, 2):
        seen = set()
        for dcs in itertools.product(range(4), repeat=6):
            f = b = (16384, 0)
            for d in dcs:
                f = mul(f, int(rm[m + 1, d]), int(re[m + 1, d]))
            for d in reversed(dcs):
                b = mul(b, int(rm[m + 1, d]), int(re[m + 1, d]))
            differ += f != b
            seen.add((f, b))
        prods[m] = seen
    assert differ > 0
    for thr in ((21990, -23), (25166, -10)):
        ok = {m: [(f, b) for f, b in prods[m] if le(f, thr) and le(b, thr)] for m in prods}
        assert all(le(f, thr) == le(b, thr) for m in prods for f, b in prods[m])
        for m1, m2 in ((0, 1), (0, 2), (1, 2)):
            assert all(lt(f2, f1) == lt(b2, b1) for f1, b1 in ok[m1] for f2, b2 in ok[m2])


@pytest.mark.parametrize("mutation", list(MUTATIONS))
def test_rehearsal_catches_mutated_dct4_and_fec(tmp_path, mutation):
    lib_m = build_wrapper(tmp_path, WRAPPER, "fxdct_fec", MUTATIONS, mutation)
    if MUTATIONS[mutation][0] == "fx_dct4.cuh":
        bad = dct4_differing(lib_m) + w32_bad(lib_m)
    else:
        bad = sum(fec_differing(lib_m, slot, ccc, f"ep{m}") for slot in C.FEC_SLOTS
                  for m in (2, 3, 4) for ccc in (0, 1))
        bad += sum(fec_differing(lib_m, slot, 0, key) for key, slot in SYNTHETIC)
    assert bad > 0, f"the rehearsal did not see the mutation {mutation}"
