"""The decoder's entropy phase in one launch: the range decoder's parsed mode
(csrc/ari_decode.cuh, `ari_decode_warp<kPc, true>`), which parses each
frame's side information with csrc/side_info.cuh:side_info_parse_bits
before it decodes the frame.

Here g++ builds the string parse and the parsed warp (on the host warp,
`CoderHostWarp`) into shared libraries, called through ctypes:
- the string parse must equal ops/bits.py:parse_side_info_plain on all 21
  words of the side dict, on rows of int32 (device memory) and of bytes (the
  warp's staged rows): the encoder's fields, random bytes and each of the
  parser's bad-frame triggers (tests/torch_kernel_cases.py:PARSE_CASES), and
  rows of 12 bytes or fewer, where the clipped index repeats byte 0;
- the parsed warp must equal parse_side_info_plain followed by
  ops/ari.py:decode_plain bit for bit, on both dicts: the port's encoder
  payloads at 64 and 160 kbps, the same payloads corrupted, the
  high-resolution rows of decode_rows, and pc_decode_rows in the decoder's
  and the encoder's partial-concealment modes (the PC inputs given, or left
  to their defaults);
- copies of the headers with one line changed must fail (a field one bit
  narrower, the split's threshold, the cursor's mask, the side rows' write-out
  one word off).
They skip where there is no g++. Beside them, ops/ari.py:parse_and_decode
on the CPU must equal the JAX package's bits.parse_side_info followed by
ari.decode exactly: clean, flipped and random frames at 64 and 160 kbps, EP3
frames with bfi_in 2 and corrupt ranges, and the encoder's simulation."""
from __future__ import annotations

import functools
from types import SimpleNamespace

import jax
import numpy as np
import pytest
import torch

import audio_codec_torch as P
from audio_codec_torch import kernels as K
from audio_codec_torch.ops import ari, bits
from audio_codec_torch.ops.quant import residual_max_bits
from audio_codec_tpu.config import Config as JConfig
from audio_codec_tpu.ops import ari as JAR, bits as JB

from tests import torch_kernel_cases as C
from tests.test_torch_decode_rehearsal import NAMES, coded_case, encoder_case, np32, pc_case
from tests.test_torch_lane_rehearsal import build_wrapper, lane_parse, plain_pack, ptr
from tests.torch_port_data import n, t

PARSE_WRAPPER = r"""
#include "side_info.cuh"
#include <vector>
using namespace acx;

static SideLayout layout(const int* L) { return {L[0], L[1], L[2], L[3], L[4], L[5], L[6]}; }

template <typename RowT>
static void parse_rows(const RowT* buf, const int* L, int* out, int B) {
  for (int b = 0; b < B; ++b) {
    SideFields s;
    int bfi;
    const SideCursor c = side_info_parse_bits(buf + L[0] * b, layout(L), s, &bfi);
    int* o = out + 21 * b;
    const int v[9] = {bfi, s.bw_idx, s.lastnz, s.lsb_mode, s.gg_idx, s.num_tns, s.fac_ns_idx,
                      c.bp, c.mask};
    for (int k = 0; k < 9; ++k) o[k] = v[k];
    o[9] = s.tns_on[0];
    o[10] = s.tns_on[1];
    for (int k = 0; k < 7; ++k) o[11 + k] = s.scf_idx[k];
    for (int k = 0; k < 3; ++k) o[18 + k] = s.ltpf[k];
  }
}

extern "C" {
// out [B][21]: the order of test_torch_lane_rehearsal.py's rehearse_parse
void rehearse_parse(const int* buf, const int* L, int* out, int B) { parse_rows(buf, L, out, B); }
// the same rows as bytes, as the range decoder's warp stages them
void rehearse_parse_u8(const int* buf, const int* L, int* out, int B) {
  std::vector<uint8_t> bytes(static_cast<size_t>(L[0]) * B);
  for (size_t i = 0; i < bytes.size(); ++i) bytes[i] = static_cast<uint8_t>(buf[i]);
  parse_rows(bytes.data(), L, out, B);
}
}
"""

WARP_WRAPPER = r"""
#include "ari_decode.cuh"
#include <cstring>
#include <vector>
using namespace acx;

template <int kPc, typename XT>
static void run(const DecIo& io, const DecTables& tb, const DecGeom& g) {
  const int F = 32, S = F + 1;
  std::vector<XT> x(static_cast<size_t>(g.N) * S);
  std::vector<uint32_t> lev(dec_lev_words(g.N) * S), res(dec_res_words(g.max_res) * S);
  std::vector<int32_t> tns(18 * S), len(2 * S);
  std::vector<int32_t> fbuf((dec_fbuf_bytes(io.nbytes) + 3) / 4);
  for (int s0 = 0; s0 < io.L; s0 += F) {
    // what the warp before left in shared memory
    std::memset(x.data(), 0x5A, x.size() * sizeof(XT));
    std::memset(lev.data(), 0xA5, lev.size() * 4);
    std::memset(res.data(), 0x5A, res.size() * 4);
    std::memset(tns.data(), 0x5A, tns.size() * 4);
    std::memset(len.data(), 0x5A, len.size() * 4);
    std::memset(fbuf.data(), 0xA5, fbuf.size() * 4);
    const DecRows<XT> rows = {x.data(), lev.data(), res.data(), tns.data(), len.data(), S};
    ari_decode_warp<kPc, true>(CoderHostWarp{}, io, s0, imin(F, io.L - s0), tb, g,
                               reinterpret_cast<uint8_t*>(fbuf.data()), rows);
  }
}

template <int kPc>
static void run_mode(const DecIo& io, const DecTables& tb, const DecGeom& g) {
  if (g.hrmode) run<kPc, int32_t>(io, tb, g);
  else run<kPc, int16_t>(io, tb, g);
}

extern "C" {
// pc_in [3][L] (bfi_in, be_l, be_r) or null (their defaults); geom as
// test_torch_decode_rehearsal.py's; lay: the side layout (SideLayout's
// order); side_out [21 * L] (DecIo's parsed-mode layout)
void rehearse_ari_decode_frames(const int* frames, const int* pc_in, const int* tabs,
                                int inv_word, const int* geom, const int* lay, int pc_mode,
                                int L, int nbytes, int* side_out, int* x, int* tns_order,
                                int* tns_idx, int* res, int* out) {
  const DecGeom g = {geom[0], geom[1], geom[2], geom[3], geom[4], geom[5], geom[6], geom[7],
                     geom[8], geom[9], geom[10]};
  DecTables tb;
  tb.lookup = tabs;
  tb.cumf = tabs + 4096;
  tb.order_cf = tb.cumf + 64 * 18;
  tb.coef_cf = tb.order_cf + 2 * 9;
  tb.inv = reinterpret_cast<const uint8_t*>(tabs + inv_word);
  DecIo io = {frames, nullptr, nullptr, x, tns_order, tns_idx, res, out, L, nbytes, side_out};
  for (int k = 0; k < 3; ++k)
    io.flags[k] = {pc_in == nullptr ? nullptr : pc_in + k * L, 1, kVecInt32};
  io.lay = {lay[0], lay[1], lay[2], lay[3], lay[4], lay[5], lay[6]};
#ifndef NO_PC_MODES
  if (pc_mode == 1) run_mode<kPcDecode>(io, tb, g);
  if (pc_mode == 2) run_mode<kPcEncSim>(io, tb, g);
#endif
  if (pc_mode == 0) run_mode<kPcNone>(io, tb, g);
}
}
"""

# mutations the rehearsals must catch: a field one bit narrower (the
# global gain), the split set's threshold one set lower, the cursor's mask
# from the wrong bits, the side rows' write-out one word off
PARSE_MUTATIONS = {
    "gain_field_narrower": ("side_info.cuh", "  s.gg_idx = take(8);", "  s.gg_idx = take(7);"),
    "split_threshold": ("side_info.cuh", "submode_msb == 0 ? 14 * kMpvqSplit",
                        "submode_msb == 0 ? 13 * kMpvqSplit"),
    "cursor_mask": ("side_info.cuh", "1 << (b.n & 7)}", "1 << (b.n & 3)}"),
}
WARP_MUTATIONS = {
    "side_rows_one_word_off": ("ari_decode.cuh", "scf_idx[s * 7 + i] = sh[kScf + i];",
                               "scf_idx[s * 7 + i] = sh[kScf + i + 1];"),
}
SIDE_NAMES = ("bfi", "bw_idx", "lastnz", "lsb_mode", "gg_idx", "num_tns", "fac_ns_idx",
              "bp_side", "mask_side")


@pytest.fixture(scope="module")
def lib_parse(tmp_path_factory):
    return build_wrapper(tmp_path_factory.mktemp("parse_bits"), PARSE_WRAPPER, "parse_bits",
                         PARSE_MUTATIONS)


@pytest.fixture(scope="module")
def lib_warp(tmp_path_factory):
    return build_wrapper(tmp_path_factory.mktemp("entropy"), WARP_WRAPPER, "entropy",
                         WARP_MUTATIONS)


# ---- the string parse ----

def short_cfg(cfg, nbytes: int):
    """cfg with frames of nbytes bytes: the side bits start at its last byte."""
    return SimpleNamespace(targetBytes=nbytes, BW_cutoff_bits=cfg.BW_cutoff_bits,
                           lastnz_bits=cfg.lastnz_bits, fs_idx=cfg.fs_idx, yLen=cfg.yLen,
                           frame_dms=cfg.frame_dms)


def parse_rows(name: str, rows: str):
    """(configuration, rows) of a parse case: PARSE_CASES' rows, or `short`:
    random rows of 1 to 12 bytes, 64 of each length, in a configuration
    whose frames are that long."""
    cfg = P.Config(**C.CONFIGS[name])
    if rows == "short":
        rng = np.random.default_rng(9)
        return [(short_cfg(cfg, nb), rng.integers(0, 256, (64, nb)).astype(np.int32))
                for nb in range(1, 13)]
    if rows == "random":
        return [(cfg, np.random.default_rng(5).integers(0, 256, (64, cfg.targetBytes))
                 .astype(np.int32))]
    f = C.side_fields(cfg, 48, seed=4) if rows == "packed" else C.corrupt_fields(cfg, rows)
    return [(cfg, plain_pack(cfg, f)[0])]


def parse_differing(lib, name: str, rows: str, u8: bool = False) -> int:
    bad = 0
    fn = lib.rehearse_parse_u8 if u8 else lib.rehearse_parse
    for cfg, buf in parse_rows(name, rows):
        got = lane_parse(SimpleNamespace(rehearse_parse=fn), cfg, buf)
        ref = bits.parse_side_info_plain(cfg, torch.from_numpy(buf))
        assert set(got) == set(ref)
        bad += sum(C.count_differing(got[k], ref[k].numpy()) for k in ref)
    return bad


PARSE_RUNS = C.PARSE_CASES + [(name, "short") for name in C.CONFIGS]


@pytest.mark.parametrize("name,rows", PARSE_RUNS)
@pytest.mark.parametrize("u8", [False, True], ids=["int32_rows", "staged_bytes"])
def test_parse_bits_matches_plain(lib_parse, name, rows, u8):
    assert parse_differing(lib_parse, name, rows, u8) == 0
    if rows in C.BFI_TRIGGERS:
        cfg, buf = parse_rows(name, rows)[0]
        got = lane_parse(lib_parse, cfg, buf)
        assert (got["bfi"] == 1).all(), f"{rows}: the trigger did not fire"


def test_short_rows_repeat_byte_0():
    """The premise of the short rows: the side information takes at least 7
    whole bytes, so in rows of up to 7 bytes its string runs past byte 0
    (the clipped index repeats it) and the cursor's byte index falls below
    0, as the bit reader leaves it."""
    for c, buf in parse_rows("48k", "short"):
        if c.targetBytes <= 7:
            side = bits.parse_side_info_plain(c, torch.from_numpy(buf))
            assert (side["bp_side"].numpy() < 0).all(), c.targetBytes


# ---- the parsed warp ----

def lane_frames(lib, cfg, case: dict, pc_mode: int, flags: bool = True) -> tuple[dict, dict]:
    """The parsed warp on case's frames: (side, dec) in the plain versions'
    dicts."""
    frames = np32(case["frames"])
    L, nbytes = frames.shape
    N = cfg.yLen
    max_res = min(residual_max_bits(cfg), cfg.targetBytes * 8)
    pc = ari.pc_params(cfg, pc_mode == 2) if pc_mode else None
    geom = np32([N, 22 if cfg.hrmode else 14, int(cfg.hrmode), 8 if cfg.frame_dms == 100 else 4,
                 int(cfg.enable_lpc_weighting), cfg.rateFlag if cfg.fs_idx != 5 else 0,
                 cfg.targetBytes * 8, max_res, 20 if cfg.hrmode else 1,
                 0 if pc is None else pc["pc_bytes"], cfg.targetBytes])
    lay = np32([nbytes, cfg.targetBytes - 1, cfg.BW_cutoff_bits, cfg.lastnz_bits, cfg.fs_idx,
                N, int(cfg.frame_dms == 25)])
    pc_in = None
    if flags and "bfi_in" in case:
        pc_in = np32(np.stack([case[k] for k in ("bfi_in", "be_l", "be_r")]))
    side_out = np.full(21 * L, -7, np.int32)
    x, tns_order = np.zeros((L, N), np.int32), np.zeros((L, 2), np.int32)
    tns_idx, res = np.zeros((L, 2, 8), np.int32), np.zeros((L, max_res), np.int32)
    out = np.zeros((7, L), np.int32)
    lib.rehearse_ari_decode_frames(ptr(frames), None if pc_in is None else ptr(pc_in),
                                   ptr(np32(K._decoder_tables("cpu"))), K.DEC_INV_WORD,
                                   ptr(geom), ptr(lay), pc_mode, L, nbytes, ptr(side_out),
                                   ptr(x), ptr(tns_order), ptr(tns_idx), ptr(res), ptr(out))
    m = 9 * L
    side = dict(zip(SIDE_NAMES, side_out[:m].reshape(9, L)))
    side.update(tns_on=side_out[m: m + 2 * L].reshape(L, 2),
                scf_idx=side_out[m + 2 * L: m + 9 * L].reshape(L, 7),
                ltpf_param=side_out[m + 9 * L:].reshape(L, 3))
    dec = dict(x=x, tns_order=tns_order, tns_idx=tns_idx, res_bits=res, **dict(zip(NAMES, out)))
    return side, dec


@functools.cache
def plain_frames(key: str, pc_mode: int, flags: bool = True) -> tuple[dict, dict]:
    cfg, case = CASES[key]()
    f = lambda k: torch.from_numpy(np32(case[k])) if flags and k in case else None
    side, dec = ari.parse_and_decode_plain(cfg, torch.from_numpy(np32(case["frames"])),
                                           f("bfi_in"), f("be_l"), f("be_r"),
                                           pc_enc_sim=pc_mode == 2)
    return {k: v.numpy() for k, v in side.items()}, {k: v.numpy() for k, v in dec.items()}


def frames_differing(lib, key: str, pc_mode: int, flags: bool = True) -> dict:
    cfg, case = CASES[key]()
    got = lane_frames(lib, cfg, case, pc_mode, flags)
    ref = plain_frames(key, pc_mode, flags)
    bad = {}
    for g, r in zip(got, ref):
        assert set(g) == set(r)
        bad.update({k: C.count_differing(g[k], r[k]) for k in r})
    return {k: v for k, v in bad.items() if v}


CASES = {
    "enc_64k": lambda: encoder_case(64000),
    "enc_160k": lambda: encoder_case(160000),
    "enc_64k_corrupt": lambda: encoder_case(64000, corrupt=True),
    "enc_160k_corrupt": lambda: encoder_case(160000, corrupt=True),
    "coded_hr": lambda: coded_case("48k_hr"),
    "pc_ep3": lambda: pc_case(3),
    "pc_ep4": lambda: pc_case(4),
}
# (case, PC mode, the PC inputs given); the encoder's simulation also with
# them left to their defaults, as the encoder calls it
WARP_RUNS = [(k, 0, True) for k in CASES if not k.startswith("pc_")] + \
            [(k, m, True) for k in CASES if k.startswith("pc_") for m in (1, 2)] + \
            [("pc_ep3", 2, False), ("pc_ep3", 1, False)]


@pytest.mark.parametrize("key,pc_mode,flags", WARP_RUNS)
def test_parsed_warp_matches_plain(lib_warp, key, pc_mode, flags):
    bad = frames_differing(lib_warp, key, pc_mode, flags)
    assert not bad, bad


def test_warp_cases_reach_what_they_are_for():
    """The frames take the paths they stand for: bad frames from the parse
    and from the decode, LSB-mode frames at 160 kbps, bfi 2 in the PC decode,
    the LTPF's pitch fields, every SNS submode, two TNS filters."""
    side, dec = plain_frames("enc_64k_corrupt", 0)
    assert (side["bfi"] == 1).any() and (dec["bfi"] == 1).any() and (side["bfi"] == 0).any()
    side, dec = plain_frames("enc_160k", 0)
    assert (side["lsb_mode"] == 1).any() and (dec["bfi"] == 0).all()
    _, dec = plain_frames("pc_ep3", 1)
    assert (dec["bfi"] == 2).any()
    subs, two, ltpf = set(), False, False
    for key in ("enc_64k", "enc_160k", "enc_64k_corrupt", "enc_160k_corrupt"):
        side, _ = plain_frames(key, 0)
        subs |= set(side["scf_idx"][:, 2].tolist())
        two |= bool((side["num_tns"] == 2).any())
        ltpf |= bool((side["ltpf_param"][:, 0] == 1).any())
    assert subs == {0, 1, 2, 3} and two and ltpf, (subs, two, ltpf)


# ---- mutations ----

@pytest.mark.parametrize("mutation", list(PARSE_MUTATIONS))
def test_rehearsal_catches_mutated_parse(tmp_path, mutation):
    lib = build_wrapper(tmp_path, PARSE_WRAPPER, "parse_bits", PARSE_MUTATIONS, mutation)
    bad = sum(parse_differing(lib, name, rows) for name, rows in PARSE_RUNS)
    assert bad > 0, f"the rehearsal did not see the mutation {mutation}"


@pytest.mark.parametrize("mutation", list(WARP_MUTATIONS))
def test_rehearsal_catches_mutated_warp(tmp_path, mutation):
    # the main path's mode only: a shorter build
    lib = build_wrapper(tmp_path, "#define NO_PC_MODES\n" + WARP_WRAPPER, "entropy",
                        WARP_MUTATIONS, mutation)
    assert frames_differing(lib, "enc_64k", 0), \
        f"the rehearsal did not see the mutation {mutation}"


# ---- against the JAX package ----

@functools.cache
def jax_entropy(jcfg, pc_enc_sim: bool):
    """The JAX package's entropy phase, jitted: parse_side_info, then decode
    on its fields."""
    def phase(buf, bfi_in, be_l, be_r):
        side = JB.parse_side_info(jcfg, buf)
        return side, JAR.decode(jcfg, buf, side, bfi_in, be_l, be_r, pc_enc_sim=pc_enc_sim)
    return jax.jit(phase)


def damaged(frames: np.ndarray, damage: str) -> np.ndarray:
    rng = np.random.default_rng({"clean": 0, "flipped": 1, "random": 2}[damage])
    frames = frames.copy()
    if damage == "flipped":
        pos = rng.integers(0, frames.size, 12)
        frames.reshape(-1)[pos] ^= 1 << rng.integers(0, 8, 12)
    elif damage == "random":
        frames = rng.integers(0, 256, frames.shape)
    return np32(frames)


def same_as_jax(kw: dict, frames: np.ndarray, flags=None, pc_enc_sim: bool = False):
    jcfg, pcfg = JConfig(**kw), P.Config(**kw)
    f = flags if flags is not None else (None, None, None)
    side, dec = jax_entropy(jcfg, pc_enc_sim)(frames, *f)
    got = ari.parse_and_decode(pcfg, t(frames), *(None if v is None else t(v) for v in f),
                               pc_enc_sim=pc_enc_sim)
    for ours, ref in zip(got, (side, dec)):
        for k in ref:
            np.testing.assert_array_equal(n(ours[k]), np.asarray(ref[k]), err_msg=k)
    return dec


@pytest.mark.parametrize("bitrate", [64000, 160000])
@pytest.mark.parametrize("damage", ["clean", "flipped", "random"])
def test_parse_and_decode_equals_jax(bitrate, damage):
    frames = damaged(encoder_case(bitrate)[1]["frames"], damage)
    dec = same_as_jax(dict(fs_in=48000, bitrate=bitrate), frames)
    if damage == "clean":
        assert (np.asarray(dec["bfi"]) == 0).all()


def test_parse_and_decode_equals_jax_with_pc_block():
    """EP3 frames with their block moved, bfi_in 0 and 2 in turn over four
    corrupt ranges, and the encoder's simulation on the logical payloads."""
    a = C.pc_decode_rows(3)
    kw = dict(fs_in=48000, bitrate=64000, epmode=3)
    dec = same_as_jax(kw, np32(a["frames"]), tuple(np32(a[k]) for k in ("bfi_in", "be_l", "be_r")))
    assert (np.asarray(dec["bfi"]) == 2).any()
    dec = same_as_jax(kw, np32(C.core_frames(3)), pc_enc_sim=True)
    assert (np.asarray(dec["b_left"]) > 0).all()
