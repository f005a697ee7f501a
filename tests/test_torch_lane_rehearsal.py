"""The kernels' lane functions, compiled for the CPU, against the plain
versions.

The per-stream functions of csrc/side_info.cuh and csrc/sns_vq.cuh compile
as plain C++ as well as for the card. Here g++ builds them (with
-ffp-contract=off, so that every product and sum is rounded on its own, as
the kernels round them) into a shared library in a temporary directory,
called through ctypes. The plain versions run with `numerics.on_cpu` patched
to return False, so they compute in the order they state for a tensor on a
card. Every output must be equal bit for bit (two NaNs count as equal).
This guards the kernels' logic where there is no card; it skips where there
is no g++."""
from __future__ import annotations

import ctypes
import shutil
import subprocess
from pathlib import Path

import numpy as np
import pytest
import torch

import audio_codec_torch as P
from audio_codec_torch import kernels as K
from audio_codec_torch.ops import bits, numerics, sns

from tests import torch_kernel_cases as C

CSRC = Path(K.__file__).resolve().parent / "csrc"

WRAPPER = r"""
#include "side_info.cuh"
#include "sns_vq.cuh"
using namespace acx;

static SideLayout layout(const int* L) { return {L[0], L[1], L[2], L[3], L[4], L[5], L[6]}; }

extern "C" {
// fields [B][18]: bw_idx lastnz lsb_mode gg_idx num_tns tns_order[2] ltpf[3] scf_idx[7] fac_ns
void rehearse_pack(const int* fields, const int* L, int* buf, int* cursor, int B) {
  for (int b = 0; b < B; ++b) {
    const int* f = fields + 18 * b;
    SideFields s = {f[0], f[1], f[2], f[3], f[4], {f[5], f[6]}, {f[7], f[8], f[9]},
                    {f[10], f[11], f[12], f[13], f[14], f[15], f[16]}, f[17]};
    int* row = buf + L[0] * b;
    for (int i = 0; i < L[0]; ++i) row[i] = 0;
    const SideCursor c = side_info_pack_lane(row, layout(L), s);
    cursor[b] = c.bp;
    cursor[B + b] = c.mask;
  }
}
// out [B][21]: bfi bw_idx lastnz lsb_mode gg_idx num_tns fac_ns bp mask tns_on[2] scf_idx[7] ltpf[3]
void rehearse_parse(const int* buf, const int* L, int* out, int B) {
  for (int b = 0; b < B; ++b) {
    SideFields s;
    int bfi;
    const SideCursor c = side_info_parse_lane(buf + L[0] * b, layout(L), s, &bfi);
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
void rehearse_sns_enc(const float* scf, const int* tables, int* idx, float* q, int B) {
  for (int b = 0; b < B; ++b) sns_vq_enc_lane(scf + 16 * b, sns_tables(tables), idx + 7 * b, q + 16 * b);
}
void rehearse_sns_dec(const int* idx, const int* tables, float* q, int B) {
  for (int b = 0; b < B; ++b) sns_vq_dec_lane(idx + 7 * b, sns_tables(tables), q + 16 * b);
}
// shape 0..3: the four searches of the encoder (lanes, pulses)
void rehearse_pvq_search(const float* x, int shape, int* ys, float* en, int B) {
  for (int b = 0; b < B; ++b) {
    float xv[16], e[16];
    int y[16];
    for (int i = 0; i < 16; ++i) xv[i] = x[16 * b + i];
    if (shape == 0) pvq_search<10, 10>(xv, y, e);
    if (shape == 1) pvq_search<6, 1>(xv, y, e);
    if (shape == 2) pvq_search<16, 8>(xv, y, e);
    if (shape == 3) pvq_search<16, 6>(xv, y, e);
    for (int i = 0; i < 16; ++i) {
      ys[16 * b + i] = y[i];
      en[16 * b + i] = e[i];
    }
  }
}
int table_words() { return kSnsTableWords; }
}
"""


@pytest.fixture(scope="module")
def lib(tmp_path_factory):
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("needs g++ to compile the lane functions for the CPU")
    out = tmp_path_factory.mktemp("lanes")
    (out / "lanes.cpp").write_text(WRAPPER)
    r = subprocess.run([gxx, "-x", "c++", "-std=c++17", "-O1", "-ffp-contract=off", "-shared",
                        "-fPIC", f"-I{CSRC}", str(out / "lanes.cpp"), "-o", str(out / "lanes.so")],
                       capture_output=True, text=True, timeout=600)
    assert r.returncode == 0, r.stderr
    return ctypes.CDLL(str(out / "lanes.so"))


@pytest.fixture
def card_order(monkeypatch):
    """The plain versions compute as they do for a tensor on a card."""
    monkeypatch.setattr(numerics, "on_cpu", lambda x: False)


def ptr(a: np.ndarray):
    assert a.flags.c_contiguous
    return a.ctypes.data_as(ctypes.c_void_p)


def same_bits(got: np.ndarray, ref: np.ndarray):
    bad = C.count_differing(got, ref)
    assert bad == 0, f"{bad} of {ref.size} values differ"


def layout(cfg, nbytes: int) -> np.ndarray:
    return np.array([nbytes, cfg.targetBytes - 1, cfg.BW_cutoff_bits, cfg.lastnz_bits,
                     cfg.fs_idx, cfg.yLen, int(cfg.frame_dms == 25)], np.int32)


def lane_pack(lib, cfg, f: dict):
    B = f["scf_idx"].shape[0]
    cols = [np.asarray(f[k], np.int32).reshape(B, -1) for k in C.FIELD_ORDER]
    fields = np.ascontiguousarray(np.concatenate(cols, axis=1))
    assert fields.shape == (B, 18)
    buf = np.full((B, cfg.targetBytes), -1, np.int32)
    cursor = np.zeros((2, B), np.int32)
    lib.rehearse_pack(ptr(fields), ptr(layout(cfg, cfg.targetBytes)), ptr(buf), ptr(cursor), B)
    return buf, cursor[0], cursor[1]


def lane_parse(lib, cfg, buf: np.ndarray) -> dict:
    B = buf.shape[0]
    out = np.zeros((B, 21), np.int32)
    buf = np.ascontiguousarray(buf, np.int32)
    lib.rehearse_parse(ptr(buf), ptr(layout(cfg, buf.shape[1])), ptr(out), B)
    names = ("bfi", "bw_idx", "lastnz", "lsb_mode", "gg_idx", "num_tns", "fac_ns_idx",
             "bp_side", "mask_side")
    side = {k: out[:, i] for i, k in enumerate(names)}
    side.update(tns_on=out[:, 9:11], scf_idx=out[:, 11:18], ltpf_param=out[:, 18:21])
    return side


def plain_pack(cfg, f: dict):
    return tuple(v.numpy() for v in bits.pack_side_info_plain(
        cfg, *(torch.from_numpy(np.asarray(f[k], np.int32)) for k in C.FIELD_ORDER)))


@pytest.mark.parametrize("name", list(C.CONFIGS))
def test_pack_lane_matches_plain(lib, name):
    cfg = P.Config(**C.CONFIGS[name])
    f = C.side_fields(cfg, 48, seed=3)
    for got, ref in zip(lane_pack(lib, cfg, f), plain_pack(cfg, f)):
        same_bits(got, ref)


@pytest.mark.parametrize("name,rows", C.PARSE_CASES)
def test_parse_lane_matches_plain(lib, name, rows):
    cfg = P.Config(**C.CONFIGS[name])
    if rows == "random":
        buf = np.random.default_rng(5).integers(0, 256, (64, cfg.targetBytes)).astype(np.int32)
    else:
        f = C.side_fields(cfg, 48, seed=4) if rows == "packed" else C.corrupt_fields(cfg, rows)
        buf = plain_pack(cfg, f)[0]
    ref = bits.parse_side_info_plain(cfg, torch.from_numpy(buf))
    got = lane_parse(lib, cfg, buf)
    assert set(got) == set(ref)
    for k in ref:
        same_bits(got[k], ref[k].numpy())
    if rows in C.BFI_TRIGGERS:
        assert (got["bfi"] == 1).all(), f"{rows}: the trigger did not fire"
    if rows == "packed":
        assert (got["bfi"] == 0).all()
        for k in ("bw_idx", "lastnz", "lsb_mode", "gg_idx", "scf_idx", "ltpf_param",
                  "fac_ns_idx"):
            same_bits(got[k], np.asarray(f[k], np.int32))


def tables() -> np.ndarray:
    return K._sns_tables("cpu").numpy()


def test_table_layout_matches_header(lib):
    assert lib.table_words() == tables().size


@pytest.mark.parametrize("submode", [0, 1, 2, 3])
def test_sns_dec_lane_matches_plain(lib, card_order, submode):
    idx = C.scf_idx_grid(submode, 32, seed=7)
    q = np.zeros((idx.shape[0], 16), np.float32)
    lib.rehearse_sns_dec(ptr(idx), ptr(tables()), ptr(q), idx.shape[0])
    ref = sns.sns_vq_dec_plain(torch.from_numpy(idx)).numpy()
    assert np.isfinite(ref).all()
    same_bits(q, ref)


def test_sns_dec_lane_matches_plain_on_random_indices(lib, card_order):
    """Indices a damaged frame can parse to: any MPVQ index, any tail."""
    rng = np.random.default_rng(8)
    idx = np.concatenate([C.scf_idx_grid(s, 16, seed=9) for s in range(4)])
    idx[:, 5] = rng.integers(0, 1 << 25, idx.shape[0])
    idx[:, 6] = rng.integers(-2, 12, idx.shape[0])
    q = np.zeros((idx.shape[0], 16), np.float32)
    lib.rehearse_sns_dec(ptr(idx), ptr(tables()), ptr(q), idx.shape[0])
    same_bits(q, sns.sns_vq_dec_plain(torch.from_numpy(idx)).numpy())


PVQ_SHAPES = ((10, 10), (6, 1), (16, 8), (16, 6))


@pytest.mark.parametrize("shape", range(4))
def test_pvq_search_lane_ties_and_silent_targets(lib, card_order, shape):
    """The pulse search alone, on targets the quantizer's residual seldom
    gives: equal magnitudes in several lanes (the strict > keeps the first
    maximum), zeros among them, and silent targets (the pulses go to lane 0
    and to the lane one past the active range, with the target's signs)."""
    rng = np.random.default_rng(12)
    x = np.concatenate([
        rng.integers(-3, 4, (96, 16)) * 0.25, np.ones((1, 16)), -np.ones((1, 16)),
        np.tile([0.5, -0.5], (1, 8)), np.zeros((1, 16)),
        np.concatenate([np.zeros((4, 10)), rng.standard_normal((4, 6))], axis=1),
        np.concatenate([rng.standard_normal((4, 6)) * 1e-9, -np.ones((4, 10))], axis=1),
        rng.standard_normal((16, 16))]).astype(np.float32)
    B = x.shape[0]
    ys = np.zeros((B, 16), np.int32)
    en = np.zeros((B, 16), np.float32)
    lib.rehearse_pvq_search(ptr(x), shape, ptr(ys), ptr(en), B)
    dim, pulses = PVQ_SHAPES[shape]
    ref_y, ref_en = sns._pvq_subpyr_search(torch.from_numpy(x), dim, pulses)
    same_bits(ys, ref_y.numpy())
    same_bits(en, ref_en.numpy())
    silent = np.abs(x[:, :dim]).sum(-1) <= 2.0 ** -24
    assert silent.any() and (np.abs(ys[~silent]).sum(-1) == pulses).all()


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_sns_enc_lane_matches_plain(lib, card_order, seed):
    scf = C.scf_rows(seed, 120)
    B = scf.shape[0]
    idx = np.zeros((B, 7), np.int32)
    q = np.zeros((B, 16), np.float32)
    lib.rehearse_sns_enc(ptr(scf), ptr(tables()), ptr(idx), ptr(q), B)
    ref_idx, ref_q = sns.sns_vq_enc_plain(torch.from_numpy(scf))
    same_bits(idx, ref_idx.numpy())
    same_bits(q, ref_q.numpy())
    seen = np.bincount(idx[:, 2], minlength=4)
    assert (seen > 0).all(), f"submodes seen: {seen.tolist()}"


def test_sns_enc_lane_matches_plain_on_encoder_scale_factors(lib, card_order):
    """Scale factors of the port's own encoder on seeded noise, its level
    spread over four decades."""
    from audio_codec_torch.ops import analysis, transforms
    cfg = P.Config(**C.CONFIGS["48k"])
    rng = np.random.default_rng(11)
    pcm = torch.from_numpy((rng.standard_normal((64, 480)) *
                            10.0 ** rng.uniform(0, 4, (64, 1))).astype(np.float32))
    st = P.enc_state_init(cfg, 64, device="cpu")
    d, _ = transforms.mdct(cfg, pcm, st.mdct_mem)
    scf = sns.compute_scf(cfg, analysis.per_band_energy(cfg, d),
                          torch.zeros(64, dtype=torch.int32)).numpy()
    idx = np.zeros((64, 7), np.int32)
    q = np.zeros((64, 16), np.float32)
    lib.rehearse_sns_enc(ptr(np.ascontiguousarray(scf)), ptr(tables()), ptr(idx), ptr(q), 64)
    ref_idx, ref_q = sns.sns_vq_enc_plain(torch.from_numpy(scf))
    same_bits(idx, ref_idx.numpy())
    same_bits(q, ref_q.numpy())
