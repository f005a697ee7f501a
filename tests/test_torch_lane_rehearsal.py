"""The kernels' lane functions, compiled for the CPU, against the plain
versions.

The per-stream functions of csrc/side_info.cuh, csrc/sns_vq.cuh,
csrc/tns_analysis.cuh, csrc/pc_classify.cuh, csrc/olpa.cuh,
csrc/ltpf_encode.cuh, csrc/noise_residual_enc.cuh and csrc/spec_decode.cuh,
and the DCT-IV, fold and unfold of csrc/dct4.cuh, compile as plain C++ as
well as for the card (the warp kernels of olpa and ltpf_encode share their
steps with a lane function that runs them in order). Here g++ builds them (with
-ffp-contract=off, so that every product and sum is rounded on its own, as
the kernels round them) into a shared library in a temporary directory,
called through ctypes. The plain versions run with `numerics.on_cpu` patched
to return False, so they compute in the order they state for a tensor on a
card. Every output must be equal bit for bit (two NaNs count as equal).
This guards the kernels' logic where there is no card; it skips where there
is no g++. Copies of the lane functions with one comparison, one rounding or
one constant changed must fail it (test_rehearsal_catches_mutated_lanes)."""
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
    d, _ = transforms.mdct_plain(cfg, pcm, st.mdct_mem)
    scf = sns.compute_scf(cfg, analysis.per_band_energy(cfg, d),
                          torch.zeros(64, dtype=torch.int32)).numpy()
    idx = np.zeros((64, 7), np.int32)
    q = np.zeros((64, 16), np.float32)
    lib.rehearse_sns_enc(ptr(np.ascontiguousarray(scf)), ptr(tables()), ptr(idx), ptr(q), 64)
    ref_idx, ref_q = sns.sns_vq_enc_plain(torch.from_numpy(scf))
    same_bits(idx, ref_idx.numpy())
    same_bits(q, ref_q.numpy())


# ---- slice 4: the TNS filter analysis, the concealment classifier, the DCT-IV ----

WRAPPER4 = r"""
#include "tns_analysis.cuh"
#include "pc_classify.cuh"
#include "dct4.cuh"
using namespace acx;

extern "C" {
void rehearse_tns(const float* x, const int* bw, const int* tab, int B, int N, int startfreq0,
                  int nf_max, int max_order, float max_pg, float inv_nsub, float c_alpha,
                  float inv_span, int* order, int* rc_idx, float* rc_q, int* nf, int* bits) {
  const TnsGeom g = {N, startfreq0, nf_max, max_pg, inv_nsub, c_alpha, inv_span};
  for (int b = 0; b < B; ++b) {
    if (max_order == 8)
      tns_filter_analysis_lane<8, 3>(x + N * b, bw[b], tab, g, order + 2 * b, rc_idx + 16 * b,
                                     rc_q + 16 * b, nf + b, bits + b);
    else
      tns_filter_analysis_lane<4, 2>(x + N * b, bw[b], tab, g, order + 2 * b, rc_idx + 16 * b,
                                     rc_q + 16 * b, nf + b, bits + b);
  }
}
void rehearse_pc(const int* bfi, const int* inv, const float* stab, const int* pitch,
                 const float* qd, const float* qres, int* out, int B, int N, int frame_dms,
                 float inv_n) {
  for (int b = 0; b < B; ++b)
    out[b] = pc_classify_lane(bfi[b], inv[b], stab[b], pitch[b], qd + N * b, qres + N * b, N,
                              frame_dms, inv_n);
}
void rehearse_peak(const float* sig, int* out, int B, int N, float inv_n) {
  for (int b = 0; b < B; ++b) out[b] = pc_peak_detector(sig + N * b, N, inv_n);
}
void rehearse_mdct(const float* x, const float* mem, const float* win, const float* Mt,
                   float* d, float* new_mem, int B, int N, int la) {
  float folded[kDctMaxN];
  for (int b = 0; b < B; ++b) {
    for (int k = 0; k < N; ++k) folded[k] = mdct_fold(x + N * b, mem + (N - la) * b, win, N, la, k);
    for (int n = 0; n < N; ++n) d[N * b + n] = dct4_out(folded, Mt, N, n);
    for (int i = 0; i < N - la; ++i) new_mem[(N - la) * b + i] = x[N * b + la + i];
  }
}
void rehearse_imdct(const float* y, const float* mem, const float* win, const float* Mt,
                    float* out, float* new_mem, int B, int N, int la) {
  for (int b = 0; b < B; ++b)
    for (int c = 0; c < N; ++c)
      imdct_scatter(dct4_out(y + N * b, Mt, N, c), c, N, la, win, mem + (N - la) * b,
                    out + N * b, new_mem + (N - la) * b);
}
void rehearse_levinson(const float* r, float* lpc, float* rc, float* err, float* rc_w, int B) {
  for (int b = 0; b < B; ++b) {
    float rr[9], l[9], k[8], w[8];
    for (int i = 0; i < 9; ++i) rr[i] = r[9 * b + i];
    tns_levinson<8>(rr, l, k, err[b]);
    tns_poly2rc<8>(l, w);
    for (int i = 0; i < 9; ++i) lpc[9 * b + i] = l[i];
    for (int i = 0; i < 8; ++i) {
      rc[8 * b + i] = k[i];
      rc_w[8 * b + i] = w[i];
    }
  }
}
int tns_table_words() { return kTnsTableWords; }
}
"""

# mutations of the lane functions that the rehearsal must catch
MUTATIONS = {
    "locmax_strict": ("pc_classify.cuh", "ak1 >= ak && ak1 >= ak2", "ak1 > ak && ak1 >= ak2"),
    "levinson_fma": ("tns_analysis.cuh", "radd(rmul(-g, a[t - j]), a[j - 1])",
                     "fmaf(-g, a[t - j], a[j - 1])"),
    "hysteresis_factor": ("pc_classify.cuh", "rmul(0.3f, max_peak)", "rmul(0.25f, max_peak)"),
}


def build_lanes(out: Path, mutation: str | None = None) -> ctypes.CDLL:
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("needs g++ to compile the lane functions for the CPU")
    inc = CSRC
    if mutation is not None:
        inc = out / "csrc"
        shutil.copytree(CSRC, inc)
        name, old, new = MUTATIONS[mutation]
        text = (inc / name).read_text()
        assert text.count(old) == 1, f"{mutation}: the line to mutate is not in {name}"
        (inc / name).write_text(text.replace(old, new))
    (out / "lanes4.cpp").write_text(WRAPPER4)
    r = subprocess.run([gxx, "-x", "c++", "-std=c++17", "-O1", "-ffp-contract=off", "-shared",
                        "-fPIC", f"-I{inc}", str(out / "lanes4.cpp"), "-o", str(out / "lanes4.so")],
                       capture_output=True, text=True, timeout=600)
    assert r.returncode == 0, r.stderr
    return ctypes.CDLL(str(out / "lanes4.so"))


@pytest.fixture(scope="module")
def lib4(tmp_path_factory):
    return build_lanes(tmp_path_factory.mktemp("lanes4"))


def f32p(v: float):
    return ctypes.c_float(float(np.float32(v)))


def lane_tns(lib, cfg, x: np.ndarray, bw: np.ndarray):
    from audio_codec_torch.ops import tns
    _, startfreq0, nf_max, max_order, n_sub, max_pg, _ = tns._tns_geometry(cfg)
    B, N = x.shape
    order = np.zeros((B, 2), np.int32)
    idx = np.zeros((B, 2, 8), np.int32)
    q = np.zeros((B, 2, 8), np.float32)
    nf = np.zeros(B, np.int32)
    bits = np.zeros(B, np.int32)
    tab = K._tns_tables("cpu", cfg.frame_dms, max_pg == 1.5).numpy()
    inv_span = 1.0 / (max_pg - 1.5) if max_pg > 1.5 else 0.0
    lib.rehearse_tns(ptr(np.ascontiguousarray(x)), ptr(bw), ptr(tab), B, N, startfreq0, nf_max,
                     max_order, f32p(max_pg), f32p(1.0 / n_sub), f32p(0.85 - 1.0), f32p(inv_span),
                     ptr(order), ptr(idx), ptr(q), ptr(nf), ptr(bits))
    return order, idx, q, nf, bits


def test_tns_table_layout_matches_header(lib4):
    assert lib4.tns_table_words() == K._tns_tables("cpu", 100, True).numel()


@pytest.mark.parametrize("name", list(C.TNS_CONFIGS))
def test_tns_filter_analysis_lane_matches_plain(lib4, card_order, name):
    """Dead subdivisions, filters of order 8 in both ranges, and (at 32
    kbps, max_pg 2.0) prediction gains where the LPC weighting decides."""
    from audio_codec_torch.ops import tns
    cfg = P.Config(**C.TNS_CONFIGS[name])
    x, bw = C.tns_rows(seed=1)
    ref, gains = tns._analyze(cfg, torch.from_numpy(x), torch.from_numpy(bw))
    for got, r in zip(lane_tns(lib4, cfg, x, bw), ref, strict=True):
        same_bits(got, r.numpy())
    order = ref[0].numpy()
    assert (order[:, 0] == 8).any() and (order[:, 1] == 8).any() and (order == 0).any()
    if name == "48k_32kbps":
        g = gains.numpy()
        assert ((g > 1.5) & (g < 2.0)).sum() >= 4, "the weighting never decided"


def test_tns_filter_analysis_lane_matches_plain_on_encoder_spectra(lib4, encoder_spectra,
                                                                   card_order):
    """The shaped spectra of the port's own encoder on seeded noise."""
    from audio_codec_torch.ops import tns
    r = encoder_spectra
    ref = tns.tns_filter_analysis_plain(C_CFG48, torch.from_numpy(r[0]), torch.from_numpy(r[1]))
    for got, e in zip(lane_tns(lib4, C_CFG48, *r), ref, strict=True):
        same_bits(got, e.numpy())


C_CFG48 = P.Config(**C.TNS_CONFIGS["48k"])


@pytest.fixture(scope="module")
def encoder_spectra():
    """Shaped spectra [32, 480] and bandwidths of the port's encoder front
    end on seeded noise at four decades of level, on the CPU (computed
    before card_order patches the numerics)."""
    from audio_codec_torch.ops import analysis, transforms
    cfg = C_CFG48
    rng = np.random.default_rng(13)
    pcm = torch.from_numpy((rng.standard_normal((32, 480)) *
                            10.0 ** rng.uniform(0, 4, (32, 1))).astype(np.float32))
    st = P.enc_state_init(cfg, 32, device="cpu")
    d, _ = transforms.mdct(cfg, pcm, st.mdct_mem)
    ener = analysis.per_band_energy(cfg, d)
    scf = sns.compute_scf(cfg, ener, torch.zeros(32, dtype=torch.int32))
    _, scf_q = sns.quantize_scf_enc(cfg, scf)
    d = sns.mdct_shaping(cfg, d, sns.interpolate_scf(cfg, scf_q, encoder_side=True))
    bw = analysis.detect_cutoff_warped(cfg, ener)
    return np.ascontiguousarray(d.numpy()), np.ascontiguousarray(bw.numpy().astype(np.int32))


def autocorrelations(n: int = 64, seed: int = 0) -> np.ndarray:
    """[n, 9] float32 normalised, lag-windowed autocorrelations of AR(2)
    rows over two decades of correlation strength."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((n, 400))
    c1, c2 = rng.uniform(-1.6, 1.6, n), rng.uniform(-0.9, 0.0, n)
    for i in range(2, 400):
        x[:, i] += c1 * x[:, i - 1] + c2 * x[:, i - 2]
    r = np.stack([(x[:, : 400 - k] * x[:, k:]).sum(-1) for k in range(9)], -1)
    return (r / r[:, :1] * T_LAGW).astype(np.float32)


T_LAGW = P.tables.t("lagw_tns")[:9]


def lane_levinson(lib, r: np.ndarray):
    B = r.shape[0]
    lpc, rc, err, rc_w = (np.zeros(s, np.float32) for s in ((B, 9), (B, 8), B, (B, 8)))
    lib.rehearse_levinson(ptr(r), ptr(lpc), ptr(rc), ptr(err), ptr(rc_w), B)
    return lpc, rc, err, rc_w


def plain_levinson(r: np.ndarray):
    from audio_codec_torch.ops import tns
    lpc, rc, err = tns._levinson(torch.from_numpy(r), 8)
    return [v.numpy() for v in (lpc, rc, err, tns._poly2rc(lpc, 8))]


def test_levinson_and_poly2rc_lanes_match_plain(lib4, card_order):
    """The two recursions alone, on their float outputs (the analysis's
    outputs are quantised and would hide a last-place difference)."""
    r = autocorrelations()
    for got, ref in zip(lane_levinson(lib4, r), plain_levinson(r), strict=True):
        same_bits(got, ref)


def pc_case_rows():
    d, r = C.pc_base_rows(8, seed=5)
    return C.pc_rows(d, r, seed=5)


def lane_pc(lib, cfg, a: dict) -> np.ndarray:
    B, N = a["q_old_d"].shape
    out = np.zeros(B, np.int32)
    lib.rehearse_pc(*(ptr(a[k]) for k in C.PC_ORDER), ptr(out), B, N, cfg.frame_dms,
                    f32p(1.0 / N))
    return out


def test_pc_classify_lane_matches_plain(lib4, card_order):
    from audio_codec_torch.ops import pc
    a = pc_case_rows()
    ref = pc.pc_classify_plain(C_CFG48, *(torch.from_numpy(a[k]) for k in C.PC_ORDER)).numpy()
    got = lane_pc(lib4, C_CFG48, a)
    same_bits(got, ref)
    branches = C.pc_branches(a, ref)
    assert all(v > 0 for v in branches.values()), branches
    sig = a["q_old_d"]
    xo = np.zeros(sig.shape[0], np.int32)
    lib4.rehearse_peak(ptr(sig), ptr(xo), sig.shape[0], sig.shape[1], f32p(1.0 / sig.shape[1]))
    same_bits(xo, pc._peak_detector(torch.from_numpy(sig)).numpy())


@pytest.mark.parametrize("fs,bitrate", [(48000, 64000), (16000, 32000)])
def test_dct4_lanes_match_plain(lib4, card_order, fs, bitrate):
    """The MDCT (fold and DCT-IV) and the IMDCT (DCT-IV, unfold, window and
    overlap-add) at N = 480 and 160 on full-scale, silent and alternating
    rows."""
    from audio_codec_torch.ops import transforms
    cfg = P.Config(fs_in=fs, bitrate=bitrate)
    N, la = cfg.frame_length, cfg.la_zeroes
    x, mem = C.transform_rows(N, la, seed=2)
    B = x.shape[0]
    win = transforms.window(cfg, "cpu").numpy()
    rwin = np.ascontiguousarray(transforms.window(cfg, "cpu", reverse=True).numpy())
    Mt = transforms.dct4_mt(N, "cpu").numpy()
    d, nm_ = np.zeros((B, N), np.float32), np.zeros((B, N - la), np.float32)
    lib4.rehearse_mdct(ptr(x), ptr(mem), ptr(win), ptr(Mt), ptr(d), ptr(nm_), B, N, la)
    ref = transforms.mdct_plain(cfg, torch.from_numpy(x), torch.from_numpy(mem))
    same_bits(d, ref[0].numpy())
    same_bits(nm_, np.ascontiguousarray(ref[1].numpy()))
    y = np.ascontiguousarray(d / np.float32(64.0))
    out, nm2 = np.zeros((B, N), np.float32), np.zeros((B, N - la), np.float32)
    lib4.rehearse_imdct(ptr(y), ptr(mem), ptr(rwin), ptr(Mt), ptr(out), ptr(nm2), B, N, la)
    ref = transforms.imdct_plain(cfg, torch.from_numpy(y), torch.from_numpy(mem))
    same_bits(out, ref[0].numpy())
    same_bits(nm2, ref[1].numpy())


@pytest.mark.parametrize("mutation", list(MUTATIONS))
def test_rehearsal_catches_mutated_lanes(tmp_path, card_order, mutation):
    """A copy of the lane functions with one comparison, one rounding or one
    constant changed must disagree with the plain versions on the cases."""
    from audio_codec_torch.ops import pc
    lib = build_lanes(tmp_path, mutation)
    if mutation == "levinson_fma":
        r = autocorrelations()
        bad = sum(C.count_differing(g, e)
                  for g, e in zip(lane_levinson(lib, r), plain_levinson(r)))
    else:
        a = pc_case_rows()
        ref = pc.pc_classify_plain(C_CFG48, *(torch.from_numpy(a[k]) for k in C.PC_ORDER))
        bad = C.count_differing(lane_pc(lib, C_CFG48, a), ref.numpy())
    assert bad > 0, f"the rehearsal did not see the mutation {mutation}"



# ---- the pitch analysis, the noise factor and residual coder, the decoder's
# spectrum reconstruction ----

WRAPPER_PITCH = r"""
#include "olpa.cuh"
#include "ltpf_encode.cuh"
#include "noise_residual_enc.cuh"
#include "spec_decode.cuh"
using namespace acx;

extern "C" {
void rehearse_olpa(const float* s, const float* m12, const float* m64, const int* mp,
                   const float* tab, int B, int s_stride, int length, int len2, int mem_in_len,
                   int acflen, int base, int* pitch2, float* nc, int* t0, float* n12, float* n64) {
  const OlpaGeom g = {length, len2, mem_in_len, acflen, base};
  float row[kOlpaMaxRow];
  for (int b = 0; b < B; ++b)
    olpa_lane(s + s_stride * b, m12 + 3 * b, m64 + mem_in_len * b, mp[b], tab, g, row, pitch2 + b,
              nc + b, t0 + b, n12 + 3 * b, n64 + mem_in_len * b);
}
void rehearse_ltpf(const float* s, const int* pol, const float* ncol, const float* mem_in,
                   const float* mnc, const float* mmnc, const int* on, const float* mpitch,
                   const float* tab, int B, int xlen, int N, int mem_len, int acflen, int xbase,
                   int frame_dms, int enable, int* param, int* bits, float* new_mem, float* nc,
                   float* mm, int* on_out, float* pitch) {
  const LtpfGeom g = {xlen, N, mem_len, acflen, xbase, frame_dms, enable};
  float buf[kLtpfMaxRow];
  for (int b = 0; b < B; ++b) {
    const LtpfOut o = ltpf_encode_lane(s + xlen * b, pol[b], ncol[b], mem_in + mem_len * b, mnc[b],
                                       mmnc[b], on[b], mpitch[b], tab, g, buf,
                                       new_mem + mem_len * b);
    for (int k = 0; k < 3; ++k) param[3 * b + k] = o.param[k];
    bits[b] = o.bits;
    nc[b] = o.nc;
    mm[b] = o.mem_mem_nc;
    on_out[b] = o.on;
    pitch[b] = o.pitch;
  }
}
void rehearse_nre(const float* x, const int* xq, const float* gain, const int* bw,
                  const int* target, const int* nbits2, const int* lsb, int B, int N, int width,
                  int start, int half, int max_res, int* fac, int* res, int* n_res) {
  const NfEncGeom g = {N, width, start, half, max_res};
  float v[kNfMaxLines];
  for (int b = 0; b < B; ++b)
    noise_residual_enc_lane(x + N * b, xq + N * b, gain[b], bw[b], target[b], nbits2[b], lsb[b],
                            g, v, fac + b, res + max_res * b, n_res + b);
}
// ints [11][B]: bfi rframe inv bw_idx fac_ns res_present n_res seed zero prev_bw nb_lost;
// floats [3][B]: gain prev_gg prev_fac_ns (the layout of spec_decode.cu)
void rehearse_spec(const float* x, const int* ints, const float* floats, const int* res_bits,
                   const float* qr, const float* qd, const int* bins, const int* lcg, int B,
                   int N, int width,
                   int start, int res_width, float* x_out, float* q_out, float* pgg, int* pbw,
                   float* pfac, int* nbl) {
  const SpecGeom g = {N, width, start, res_width};
  for (int b = 0; b < B; ++b) {
    const int* in = ints + b;
    SpecScalars s;
    s.gain = floats[b];
    s.bfi = in[0];
    s.rframe = in[B];
    s.spec_inv_idx = in[2 * B];
    s.bw_idx = in[3 * B];
    s.fac_ns_idx = in[4 * B];
    s.residual_present = in[5 * B];
    s.n_res = in[6 * B];
    s.nf_seed = in[7 * B];
    s.zero_frame = in[8 * B];
    s.prev_bw_idx = in[9 * B];
    s.nb_lost = in[10 * B];
    s.prev_gg = floats[B + b];
    s.prev_fac_ns = floats[2 * B + b];
    const SpecHistory h = spec_decode_lane(x + N * b, qr + N * b, qd + N * b,
                                           res_bits + res_width * b, s, bins, lcg, g,
                                           x_out + N * b, q_out + N * b);
    pgg[b] = h.prev_gg;
    pbw[b] = h.prev_bw_idx;
    pfac[b] = h.prev_fac_ns;
    nbl[b] = h.nb_lost;
  }
}
}
"""

# mutations of the slice's lane functions that the rehearsal must catch, one
# per kernel (the first maximum is shared by olpa and ltpf_encode)
MUTATIONS_PITCH = {
    "first_max_ge": ("olpa.cuh", "return v > bv || (v == bv && i < bi);",
                     "return v >= bv || (v == bv && i < bi);"),
    "take2_factor": ("olpa.cuh", "rmul(nc1, 0.85f)", "rmul(nc1, 0.8f)"),
    "ltpf_corr_fma": ("ltpf_encode.cuh", "acc = radd(acc, rmul(a[j], b[j]));",
                      "acc = fmaf(a[j], b[j], acc);"),
    "zero_line_window": ("noise_residual_enc.cuh", "imin(k + g.width, bw - 1)",
                         "imin(k + g.width - 1, bw - 1)"),
    "lcg_skipped_step": ("spec_decode.cuh", "const int steps = iclamp(r + 1, 0, N);",
                         "const int steps = iclamp(r, 0, N);"),
}


def build_pitch_lanes(out: Path, mutation: str | None = None) -> ctypes.CDLL:
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("needs g++ to compile the lane functions for the CPU")
    inc = CSRC
    if mutation is not None:
        inc = out / "csrc"
        shutil.copytree(CSRC, inc)
        name, old, new = MUTATIONS_PITCH[mutation]
        text = (inc / name).read_text()
        assert text.count(old) == 1, f"{mutation}: the line to mutate is not in {name}"
        (inc / name).write_text(text.replace(old, new))
    (out / "lanes_pitch.cpp").write_text(WRAPPER_PITCH)
    r = subprocess.run([gxx, "-x", "c++", "-std=c++17", "-O1", "-ffp-contract=off", "-shared",
                        "-fPIC", f"-I{inc}", str(out / "lanes_pitch.cpp"), "-o",
                        str(out / "lanes_pitch.so")],
                       capture_output=True, text=True, timeout=600)
    assert r.returncode == 0, r.stderr
    return ctypes.CDLL(str(out / "lanes_pitch.so"))


@pytest.fixture(scope="module")
def lib_pitch(tmp_path_factory):
    return build_pitch_lanes(tmp_path_factory.mktemp("lanes_pitch"))


def _c(a: np.ndarray, dtype) -> np.ndarray:
    return np.ascontiguousarray(a, dtype)


def lane_olpa(lib, cfg, a: dict):
    s, m12, m64, mp = (_c(a[k], np.int32 if k == "mem_pitch" else np.float32) for k in C.OLPA_ORDER)
    B = s.shape[0]
    length = cfg.len_12k8
    mem_in_len = m64.shape[1]
    acflen = length // 2 + (16 if cfg.frame_dms == 25 else 0)
    base = mem_in_len - 16 if cfg.frame_dms == 25 else mem_in_len
    pitch2, t0 = np.zeros(B, np.int32), np.zeros(B, np.int32)
    nc = np.zeros(B, np.float32)
    n12, n64 = np.zeros((B, 3), np.float32), np.zeros((B, mem_in_len), np.float32)
    lib.rehearse_olpa(ptr(s), ptr(m12), ptr(m64), ptr(mp), ptr(K._olpa_tables("cpu").numpy()), B,
                      s.shape[1], length, length // 2, mem_in_len, acflen, base, ptr(pitch2),
                      ptr(nc), ptr(t0), ptr(n12), ptr(n64))
    return pitch2, nc, t0, n12, n64


def plain_olpa(cfg, a: dict):
    from audio_codec_torch.ops import analysis
    return [np.ascontiguousarray(v.numpy()) for v in analysis.olpa_plain(
        cfg, *(torch.from_numpy(_c(a[k], a[k].dtype)) for k in C.OLPA_ORDER))]


def lane_ltpf(lib, cfg, a: dict):
    args = [_c(a[k], np.int32 if k in ("pitch_ol", "mem_on") else np.float32) for k in C.LTPF_ORDER]
    B = args[0].shape[0]
    xlen = cfg.len_12k8 + 1
    N, mem_len = xlen - 1, cfg.ltpf_mem_in_len
    acflen, xbase = (2 * N, mem_len - N) if cfg.frame_dms == 25 else (N, mem_len)
    param, bits, on = np.zeros((B, 3), np.int32), np.zeros(B, np.int32), np.zeros(B, np.int32)
    new_mem = np.zeros((B, mem_len), np.float32)
    nc, mm, pitch = (np.zeros(B, np.float32) for _ in range(3))
    lib.rehearse_ltpf(*(ptr(v) for v in args), ptr(K._ltpf_tables("cpu").numpy()), B, xlen, N,
                      mem_len, acflen, xbase, cfg.frame_dms, int(bool(cfg.ltpf_enable)),
                      ptr(param), ptr(bits), ptr(new_mem), ptr(nc), ptr(mm), ptr(on), ptr(pitch))
    return param, bits, new_mem, nc, mm, on, pitch


def plain_ltpf(cfg, a: dict):
    from audio_codec_torch.ops import analysis
    return [np.ascontiguousarray(v.numpy()) for v in analysis.ltpf_encode_plain(
        cfg, *(torch.from_numpy(a[k]) for k in C.LTPF_ORDER))]


def lane_nre(lib, cfg, a: dict):
    max_res, width, start = K._spectral_geometry(cfg, "noise_residual_enc")
    args = [_c(a[k], np.float32 if k in ("dy", "gain") else np.int32) for k in C.NRE_ORDER]
    B, N = args[0].shape
    fac, n_res = np.zeros(B, np.int32), np.zeros(B, np.int32)
    res = np.zeros((B, max_res), np.int32)
    lib.rehearse_nre(*(ptr(v) for v in args), B, N, width, start,
                     int(cfg.frame_dms == 100 and cfg.targetBytes <= 20), max_res, ptr(fac),
                     ptr(res), ptr(n_res))
    return fac, res, n_res


def plain_nre(cfg, a: dict):
    from audio_codec_torch.ops import quant
    return [v.numpy() for v in quant.noise_residual_enc_plain(
        cfg, *(torch.from_numpy(a[k]) for k in C.NRE_ORDER))]


SPEC_INTS = ("bfi", "rframe", "spec_inv_idx", "bw_idx", "fac_ns_idx", "residual_present", "n_res",
             "nf_seed", "zero_frame", "prev_bw_idx", "nb_lost")


def lane_spec(lib, cfg, a: dict):
    res_width, width, start = K._spectral_geometry(cfg, "spec_decode")
    B, N = a["x"].shape
    ints = _c(np.stack([a[k] for k in SPEC_INTS]), np.int32)
    floats = _c(np.stack([a[k] for k in ("gain", "prev_gg", "prev_fac_ns")]), np.float32)
    x_out, q_out = np.zeros((B, N), np.float32), np.zeros((B, N), np.float32)
    pgg, pfac = np.zeros(B, np.float32), np.zeros(B, np.float32)
    pbw, nbl = np.zeros(B, np.int32), np.zeros(B, np.int32)
    lib.rehearse_spec(ptr(_c(a["x"], np.float32)), ptr(ints), ptr(floats),
                      ptr(_c(a["res_bits"], np.int32)), ptr(_c(a["q_old_res"], np.float32)),
                      ptr(_c(a["q_old_d"], np.float32)),
                      ptr(K._bw_bins("cpu", cfg.frame_dms).numpy()),
                      ptr(K._lcg_table("cpu", N).numpy()), B, N, width, start,
                      res_width, ptr(x_out), ptr(q_out), ptr(pgg), ptr(pbw), ptr(pfac), ptr(nbl))
    return x_out, q_out, pgg, pbw, pfac, nbl


def plain_spec(cfg, a: dict):
    from audio_codec_torch.ops import quant
    return [np.ascontiguousarray(v.numpy()) for v in quant.spectrum_decode_plain(
        cfg, *(torch.from_numpy(a[k]) for k in C.SPEC_ORDER))]


def same_all(got, ref):
    for g, r in zip(got, ref, strict=True):
        same_bits(g, r)


def test_olpa_lane_matches_plain(lib_pitch, card_order):
    a = C.olpa_rows(seed=1)
    got = lane_olpa(lib_pitch, PCFG_FLAG, a)
    same_all(got, plain_olpa(PCFG_FLAG, a))
    branches = C.olpa_branches(a, got)
    assert all(v > 0 for v in branches.values()), branches


def test_ltpf_encode_lane_matches_plain(lib_pitch, card_order):
    a = C.ltpf_rows(seed=1)
    got = lane_ltpf(lib_pitch, PCFG_FLAG, a)
    same_all(got, plain_ltpf(PCFG_FLAG, a))
    branches = C.ltpf_branches(a, got)
    assert all(v > 0 for v in branches.values()), branches


@pytest.mark.parametrize("bitrate", [64000, 16000])
def test_noise_residual_enc_lane_matches_plain(lib_pitch, card_order, bitrate):
    """At 64 kbps and at 16 kbps (20 bytes: the noise factor is the smaller
    of two half means)."""
    cfg = P.Config(fs_in=48000, bitrate=bitrate)
    assert (cfg.targetBytes <= 20) == (bitrate == 16000)
    a = C.nre_rows(cfg, seed=2)
    got = lane_nre(lib_pitch, cfg, a)
    same_all(got, plain_nre(cfg, a))
    branches = C.nre_branches(a, got, cfg)
    assert all(v > 0 for v in branches.values()), branches


def test_spec_decode_lane_matches_plain(lib_pitch, card_order):
    a = C.spec_rows(PCFG_FLAG, seed=3)
    got = lane_spec(lib_pitch, PCFG_FLAG, a)
    same_all(got, plain_spec(PCFG_FLAG, a))
    branches = C.spec_branches(a, PCFG_FLAG)
    assert all(v > 0 for v in branches.values()), branches


PCFG_FLAG = P.Config(fs_in=48000, bitrate=64000)


@pytest.mark.parametrize("mutation", list(MUTATIONS_PITCH))
def test_rehearsal_catches_mutated_pitch_and_spectrum_lanes(tmp_path, card_order, mutation):
    """A copy of the lane functions with one comparison, one rounding, one
    constant, one window bound or one generator step changed must disagree
    with the plain versions on the cases."""
    lib = build_pitch_lanes(tmp_path, mutation)
    cfg20 = P.Config(fs_in=48000, bitrate=16000)
    o, l_, n, s_ = (C.olpa_rows(seed=1), C.ltpf_rows(seed=1), C.nre_rows(cfg20, seed=2),
                    C.spec_rows(PCFG_FLAG, seed=3))
    bad = {"olpa": C.count_differing(lane_olpa(lib, PCFG_FLAG, o), plain_olpa(PCFG_FLAG, o)),
           "ltpf_encode": C.count_differing(lane_ltpf(lib, PCFG_FLAG, l_),
                                            plain_ltpf(PCFG_FLAG, l_)),
           "noise_residual_enc": C.count_differing(lane_nre(lib, cfg20, n), plain_nre(cfg20, n)),
           "spec_decode": C.count_differing(lane_spec(lib, PCFG_FLAG, s_),
                                            plain_spec(PCFG_FLAG, s_))}
    assert sum(bad.values()) > 0, f"the rehearsal did not see the mutation {mutation}: {bad}"
