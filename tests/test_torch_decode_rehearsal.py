"""The range decoder's warp design and the resampler's biquad, compiled for
the CPU, against their plain versions.

csrc/ari_decode.cuh (K11, `ari_decode_warp`) is a template over the warp
that runs it. Here g++ builds it with the host warp (`CoderHostWarp`: one
thread runs the 32 lanes of each step in turn) into a shared library, called through ctypes, with the warp's shared rows filled
with a byte pattern before each warp, as the card leaves them. Every output
(x, tns_order, tns_idx, res_bits and the seven scalars) must equal
ops/ari.py:decode_plain's bit for bit: on the port's encoder payloads at 48
kHz and 64 and 32 kbps, the same payloads corrupted (bfi), frames coded by
ops/ari.py:encode_plain from tests/torch_kernel_cases.py:coder_rows at 160
kbps (LSB mode) and in the high-resolution mode (x as int32; decode_rows), and
the partial-concealment rows of pc_decode_rows in the decoder's and the
encoder's simulation mode. The quotient that picks a spectral symbol's byte of
the inverse table (dec_quotient) must be floor(low / tmp), clipped, on
seeded pairs. csrc/hp50_biquad.cu's step, run over
3 frames with its memories carried, must equal
ops/analysis.py:hp50_biquad_plain in the card's order. Copies of the
headers with one line changed must fail. It skips where there is no g++."""
from __future__ import annotations

import ctypes
import functools

import numpy as np
import pytest
import torch

import audio_codec_torch as P
from audio_codec_torch import kernels as K
from audio_codec_torch.ops import analysis, ari, bits, numerics
from audio_codec_torch.ops.quant import residual_max_bits

from tests import torch_kernel_cases as C
from tests.test_torch_lane_rehearsal import build_wrapper, ptr

WRAPPER = r"""
#include "ari_decode.cuh"
#include "hp50_biquad.cu"
#include <cstring>
#include <vector>
using namespace acx;

template <int kPc, typename XT>
static void run(const DecIo& io, const DecTables& tb, const DecGeom& g) {
  const int F = 32, S = F + 1;
  std::vector<XT> x(static_cast<size_t>(g.N) * S);
  std::vector<uint32_t> lev(dec_lev_words(g.N) * S), res(dec_res_words(g.max_res) * S);
  std::vector<int32_t> tns(18 * S), len(2 * S);
  std::vector<uint8_t> fbuf(static_cast<size_t>(F) * io.nbytes);
  for (int s0 = 0; s0 < io.L; s0 += F) {
    // what the warp before left in shared memory
    std::memset(x.data(), 0x5A, x.size() * sizeof(XT));
    std::memset(lev.data(), 0xA5, lev.size() * 4);
    std::memset(res.data(), 0x5A, res.size() * 4);
    std::memset(tns.data(), 0x5A, tns.size() * 4);
    std::memset(len.data(), 0x5A, len.size() * 4);
    std::memset(fbuf.data(), 0xA5, fbuf.size());
    const DecRows<XT> rows = {x.data(), lev.data(), res.data(), tns.data(), len.data(), S};
    ari_decode_warp<kPc>(CoderHostWarp{}, io, s0, imin(F, io.L - s0), tb, g, fbuf.data(),
                         rows);
  }
}

// x as int16 but in the high-resolution mode, as the kernel
template <int kPc>
static void run_mode(const DecIo& io, const DecTables& tb, const DecGeom& g) {
  if (g.hrmode) run<kPc, int32_t>(io, tb, g);
  else run<kPc, int16_t>(io, tb, g);
}

extern "C" {
// side [9][L], pc_in [3][L] (bfi_in, be_l, be_r), geom: N max_lev hrmode
// tns_max lpcw rate_flag total_bits max_res res_iters pc_bytes numbytes;
// tabs: kernels._decoder_tables, the inverse from word inv_word
void rehearse_ari_decode(const int* frames, const int* side, const int* pc_in, const int* tabs,
                         int inv_word, const int* geom, int pc_mode, int L, int nbytes,
                         int* x, int* tns_order, int* tns_idx, int* res, int* out) {
  const DecGeom g = {geom[0], geom[1], geom[2], geom[3], geom[4], geom[5], geom[6], geom[7],
                     geom[8], geom[9], geom[10]};
  DecTables tb;
  tb.lookup = tabs;
  tb.cumf = tabs + 4096;
  tb.order_cf = tb.cumf + 64 * 18;
  tb.coef_cf = tb.order_cf + 2 * 9;
  tb.inv = reinterpret_cast<const uint8_t*>(tabs + inv_word);
  const DecIo io = {frames, side, pc_mode == 0 ? nullptr : pc_in, x, tns_order, tns_idx, res,
                    out, L, nbytes};
#ifndef NO_PC_MODES
  if (pc_mode == 1) run_mode<kPcDecode>(io, tb, g);
  if (pc_mode == 2) run_mode<kPcEncSim>(io, tb, g);
#endif
  if (pc_mode == 0) run_mode<kPcNone>(io, tb, g);
}
// q[i] = dec_quotient(low[i], tmp[i])
void rehearse_quotient(const int* low, const int* tmp, int* q, int n) {
  for (int i = 0; i < n; ++i) q[i] = dec_quotient(low[i], tmp[i]);
}
// x [B][N] in place, mem [B][2]; c: b0 b1 b2 a1 a2
void rehearse_hp50(float* x, float* mem, const float* c, int B, int N) {
  const Hp50Coefs k = {c[0], c[1], c[2], c[3], c[4]};
  for (int b = 0; b < B; ++b) hp50_lane(x + static_cast<size_t>(b) * N, N, mem + 2 * b, k);
}
}
"""

# mutations the rehearsal must catch: the count's `<=` made `<` (the TNS
# symbols), the quotient's correction taken on equality, the row's zeros
# started one tuple late, the LSB pass's seed correction dropped, the
# biquad's two memories swapped
MUTATIONS = {
    "count_lt": ("ari_decode.cuh", "cnt += tmp * row[j] <= low ? 1 : 0;",
                 "cnt += tmp * row[j] < low ? 1 : 0;"),
    "quotient_correction": ("ari_decode.cuh", "if (tmp * q > low) q -= 1;",
                            "if (tmp * q >= low) q -= 1;"),
    "zeros_one_tuple_late": ("ari_decode.cuh", "io.x[s * N + i] = i < x_len ?",
                             "io.x[s * N + i] = i < x_len + 2 ?"),
    "lsb_seed_dropped": ("ari_decode.cuh",
                         "          r.x[j * S] = static_cast<XT>(xn);\n          seed +=",
                         "          r.x[j * S] = static_cast<XT>(xn);\n          seed +=  0u *"),
    "biquad_memories_swapped": ("hp50_biquad.cu", "  u1 = u1n;\n  u2 = u2n;",
                                "  u1 = u2n;\n  u2 = u1n;"),
}
NAMES = ("nf_seed", "zero_frame", "n_res", "residual_present", "bfi", "spec_inv_idx", "b_left")


@pytest.fixture(scope="module")
def lib(tmp_path_factory):
    return build_wrapper(tmp_path_factory.mktemp("decode"), WRAPPER, "decode", MUTATIONS)


def np32(a) -> np.ndarray:
    a = a.numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
    return np.ascontiguousarray(a, dtype=np.int32)


def side_rows(side: dict) -> np.ndarray:
    """The kernel's [9, L] side rows of a side dict."""
    cols = [side[k] for k in ("lastnz", "lsb_mode", "num_tns")] + [
        side["tns_on"][:, 0], side["tns_on"][:, 1]] + [
        side[k] for k in ("bp_side", "mask_side", "gg_idx", "fac_ns_idx")]
    return np32(np.stack([np32(c) for c in cols]))


def lane_decode(lib, cfg, case: dict, pc_mode: int) -> dict:
    frames = np32(case["frames"])
    L, nbytes = frames.shape
    N = cfg.yLen
    max_res = min(residual_max_bits(cfg), cfg.targetBytes * 8)
    pc = ari.pc_params(cfg, pc_mode == 2) if pc_mode else None
    geom = np32([N, 22 if cfg.hrmode else 14, int(cfg.hrmode), 8 if cfg.frame_dms == 100 else 4,
                 int(cfg.enable_lpc_weighting), cfg.rateFlag if cfg.fs_idx != 5 else 0,
                 cfg.targetBytes * 8, max_res, 20 if cfg.hrmode else 1,
                 0 if pc is None else pc["pc_bytes"], cfg.targetBytes])
    pc_in = np32(np.stack([case.get(k, np.full(L, v)) for k, v in
                           (("bfi_in", 0), ("be_l", -1), ("be_r", -1))]))
    x, tns_order = np.zeros((L, N), np.int32), np.zeros((L, 2), np.int32)
    tns_idx, res = np.zeros((L, 2, 8), np.int32), np.zeros((L, max_res), np.int32)
    out = np.zeros((7, L), np.int32)
    lib.rehearse_ari_decode(ptr(frames), ptr(side_rows(case["side"])), ptr(pc_in),
                            ptr(np32(K._decoder_tables("cpu"))), K.DEC_INV_WORD, ptr(geom),
                            pc_mode, L, nbytes,
                            ptr(x), ptr(tns_order), ptr(tns_idx), ptr(res), ptr(out))
    return dict(x=x, tns_order=tns_order, tns_idx=tns_idx, res_bits=res, **dict(zip(NAMES, out)))


@functools.cache
def plain_decode(key: str, pc_mode: int) -> dict:
    cfg, case = CASES[key]()
    t_ = lambda k: torch.from_numpy(np32(case[k])) if k in case else None
    ref = ari.decode_plain(cfg, t_("frames"), case["side"], t_("bfi_in"), t_("be_l"), t_("be_r"),
                           pc_enc_sim=pc_mode == 2)
    return {k: v.numpy() for k, v in ref.items()}


def differing(lib, key: str, pc_mode: int) -> dict:
    cfg, case = CASES[key]()
    got, ref = lane_decode(lib, cfg, case, pc_mode), plain_decode(key, pc_mode)
    return {k: int((np32(got[k]) != np32(ref[k])).sum()) for k in ref
            if int((np32(got[k]) != np32(ref[k])).sum())}


@functools.cache
def encoder_case(bitrate: int, corrupt: bool = False):
    """The port's payloads of 6 streams of seeded tones and noise over 2
    frames at 48 kHz (on the CPU), their side information parsed; with
    `corrupt` the same payloads, every second row with 1-24 bytes replaced
    and every fifth random bytes."""
    cfg = P.Config(fs_in=48000, bitrate=bitrate)
    rng = np.random.default_rng(bitrate)
    if corrupt:
        frames = encoder_case(bitrate)[1]["frames"].copy()
        for i in range(0, len(frames), 2):
            at = rng.integers(0, frames.shape[1], rng.integers(1, 25))
            frames[i, at] = rng.integers(0, 256, at.size)
        frames[::5] = rng.integers(0, 256, frames[::5].shape)
    else:
        B, T, n = 6, 2, cfg.frame_length
        k = np.arange(T * n)
        pcm = np.stack([np.sin(2 * np.pi * (150 + 410 * s) * k / 48000) * 6000 * (1 + s % 3)
                        + rng.standard_normal(k.size) * 10.0 ** (1 + s % 4) for s in range(B)])
        pcm = torch.from_numpy(pcm.reshape(B, T, n).transpose(1, 0, 2).astype(np.float32))
        _, frames = P.encode_block(cfg, P.enc_state_init(cfg, B, device="cpu"), pcm)
        frames = np32(frames.reshape(T * B, -1))
    side = bits.parse_side_info_plain(cfg, torch.from_numpy(frames))
    return cfg, {"frames": frames, "side": side}


@functools.cache
def coded_case(name: str):
    """tests/torch_kernel_cases.py:decode_rows at DECODE_CONFIGS[name]:
    coder_rows coded by the plain range encoder with the side information it
    set, every seventh row with bytes replaced."""
    d = C.decode_rows(name)
    side = {k: torch.from_numpy(d[k]) for k in C.DECODE_SIDE_KEYS}
    return P.Config(**C.DECODE_CONFIGS[name]), {"frames": d["frames"], "side": side}


@functools.cache
def pc_case(epmode: int):
    a = C.pc_decode_rows(epmode)
    cfg = P.Config(fs_in=48000, bitrate=64000, epmode=epmode)
    side = bits.parse_side_info_plain(cfg, torch.from_numpy(a["frames"]))
    return cfg, {**a, "side": side}


CASES = {
    "enc_64k": lambda: encoder_case(64000),
    "enc_32k": lambda: encoder_case(32000),
    "enc_64k_corrupt": lambda: encoder_case(64000, corrupt=True),
    "enc_32k_corrupt": lambda: encoder_case(32000, corrupt=True),
    "coded_160k": lambda: coded_case("48k_160k"),
    "coded_hr": lambda: coded_case("48k_hr"),
    "pc_ep3": lambda: pc_case(3),
    "pc_ep4": lambda: pc_case(4),
}
# (case, PC mode)
KEPT_RUNS = [(k, 0) for k in CASES if not k.startswith("pc_")] + \
            [(k, m) for k in CASES if k.startswith("pc_") for m in (1, 2)]


@pytest.mark.parametrize("key,pc_mode", KEPT_RUNS)
def test_ari_decode_warp_matches_plain(lib, key, pc_mode):
    bad = differing(lib, key, pc_mode)
    assert not bad, bad


# (low, tmp) ranges of dec_quotient's domain, 0 <= low < 2^24, 1 <= tmp < 2^14:
# the small divisors of a nearly spent range, the quotients near the clip at
# kDecInvQ, and the whole domain
QUOTIENT_RANGES = {"small_tmp": ((0, 1 << 24), (1, 64)),
                   "near_clip": ((1 << 14, 1 << 24), (1 << 12, 1 << 14)),
                   "whole": ((0, 1 << 24), (1, 1 << 14))}


@pytest.mark.parametrize("span", list(QUOTIENT_RANGES))
def test_quotient_is_the_clipped_floor(lib, span):
    """dec_quotient(low, tmp) = min(floor(low / tmp), kDecInvQ - 1) on 200 000
    seeded pairs of the span, each multiple of tmp near low and near the clip
    included, where the float quotient rounds across the integer."""
    (l0, l1), (t0, t1) = QUOTIENT_RANGES[span]
    rng = np.random.default_rng(l0 + t0)
    n = 200_000
    tmp = rng.integers(t0, t1, n)
    low = rng.integers(l0, l1, n)
    k = np.minimum(low // tmp, K.DEC_INV_Q + 1)
    edge = np.clip(np.concatenate([k * tmp, k * tmp - 1, (k + 1) * tmp - 1,
                                   (K.DEC_INV_Q - 1) * tmp, K.DEC_INV_Q * tmp - 1]), 0, (1 << 24) - 1)
    low, tmp = np32(np.concatenate([low, edge])), np32(np.tile(tmp, 6))
    q = np.zeros_like(low)
    lib.rehearse_quotient(ptr(low), ptr(tmp), ptr(q), low.size)
    want = np.minimum(low.astype(np.int64) // tmp, K.DEC_INV_Q - 1)
    assert np.array_equal(q, want), int((q != want).sum())


def test_decode_cases_reach_what_they_are_for():
    """The cases take the paths they stand for: LSB-mode frames that change
    x, frames that set bfi (and bfi 2 with spec_inv_idx < N in the PC
    decode), residual bits, zero frames, the high-resolution mode's values
    past 2^15, escapes to the last level, and TNS filters of every order."""
    lsb = plain_decode("coded_160k", 0)
    side = coded_case("48k_160k")[1]["side"]
    assert int((side["lsb_mode"].numpy() == 1).sum()) >= 4
    assert int(((lsb["bfi"] == 0) & (side["lsb_mode"].numpy() == 1)).sum()) >= 4
    for key in ("enc_64k_corrupt", "coded_160k"):
        b = plain_decode(key, 0)["bfi"]
        assert (b == 1).any() and (b == 0).any(), (key, np.bincount(b))
    pc = plain_decode("pc_ep3", 1)
    assert ((pc["bfi"] == 2) & (pc["spec_inv_idx"] < 400)).any()
    for key in ("enc_64k", "enc_32k"):
        r = plain_decode(key, 0)
        assert (r["bfi"] == 0).all() and (r["n_res"] > 0).any(), key
    assert plain_decode("coded_160k", 0)["zero_frame"].any()
    assert np.abs(plain_decode("coded_hr", 0)["x"]).max() > 2 ** 15
    orders = plain_decode("coded_160k", 0)["tns_order"]
    assert set(range(9)) <= set(orders.ravel().tolist())


def test_tables_are_non_decreasing_and_the_inverse_covers_them():
    """Every row of cumulative frequencies (spectrum, TNS order and
    coefficients) is non-decreasing, so the symbol is the count of entries
    at or below the quotient, less one. The inverse table's premise: every
    spectral entry j < 17 is below kDecInvQ, and the table in the kernel's
    words is decoder_inverse's, its count at each q."""
    tabs = np32(K._decoder_tables("cpu"))
    cumf = tabs[4096: 4096 + 64 * 18].reshape(64, 18)
    rows = [cumf, tabs[4096 + 64 * 18: 4096 + 64 * 18 + 18].reshape(2, 9),
            tabs[4096 + 64 * 18 + 18: 5410].reshape(8, 18)]
    assert all((np.diff(r, axis=1) >= 0).all() for r in rows)
    assert cumf[:, :17].max() < K.DEC_INV_Q
    inv = tabs[K.DEC_INV_WORD:].view(np.uint8).reshape(64, K.DEC_INV_Q)
    q = np.arange(K.DEC_INV_Q)
    assert np.array_equal(inv, (cumf[:, None, :17] <= q[None, :, None]).sum(-1))


def hp50_differing(lib, card_order) -> int:
    """The biquad's lane over 3 frames of 33 streams (the memories carried),
    against hp50_biquad_plain run as on the card."""
    rng = np.random.default_rng(7)
    B, N = 33, 128
    c = np.float32([*P.tables.t("highpass50_filt_b"), *P.tables.t("highpass50_filt_a")[1:]])
    mem_l = np.zeros((B, 2), np.float32)
    mem_p = torch.zeros((B, 2))
    bad = 0
    for f in range(3):
        x = (rng.standard_normal((B, N)) * 10.0 ** rng.uniform(0, 4, (B, 1))).astype(np.float32)
        x[0] = 0.0
        y = np.ascontiguousarray(x.copy())
        lib.rehearse_hp50(ptr(y), ptr(mem_l), ptr(c), B, N)
        ry, mem_p = analysis.hp50_biquad_plain(torch.from_numpy(x), mem_p)
        bad += C.count_differing(torch.from_numpy(y), ry)
        bad += C.count_differing(torch.from_numpy(mem_l.copy()), mem_p)
    return bad


@pytest.fixture
def card_order(monkeypatch):
    monkeypatch.setattr(numerics, "on_cpu", lambda x: False)


def test_hp50_lane_matches_plain_over_three_frames(lib, card_order):
    assert hp50_differing(lib, card_order) == 0


@pytest.mark.parametrize("mutation", list(MUTATIONS))
def test_rehearsal_catches_mutated_decode(tmp_path, card_order, mutation):
    # the main path's mode only: a shorter build
    lib = build_wrapper(tmp_path, "#define NO_PC_MODES\n" + WRAPPER, "decode", MUTATIONS,
                        mutation)
    if MUTATIONS[mutation][0] == "hp50_biquad.cu":
        assert hp50_differing(lib, card_order) > 0
        return
    bad = 0
    for key in ("coded_160k", "enc_64k"):
        bad += sum(differing(lib, key, 0).values())
        if bad:
            break
    assert bad > 0, f"the rehearsal did not see the mutation {mutation}"
