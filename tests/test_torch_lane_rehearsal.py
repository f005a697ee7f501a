"""The kernels' lane functions, compiled for the CPU, against the plain
versions.

The per-stream functions of csrc/side_info.cuh, csrc/sns_vq.cuh,
csrc/tns_analysis.cuh, csrc/pc_classify.cuh, csrc/olpa.cuh,
csrc/ltpf_encode.cuh, csrc/noise_residual_enc.cuh, csrc/spec_decode.cuh,
csrc/fec.cuh (the channel coder) and csrc/ari_decode.cuh (the range decoder,
here with its partial-concealment hooks), the DCT-IV, fold and unfold of
csrc/dct4.cuh, the concealment's csrc/plc*.cuh and phecu.cuh, the
fixed-point decoder's csrc/fx_*.cuh and the TNS synthesis lattice compile as
plain C++ as
well as for the card (the warp kernels of olpa and ltpf_encode share their
steps with a lane function that runs them in order). Here g++ builds them (with
-ffp-contract=off, so that every product and sum is rounded on its own, as
the kernels round them) into a shared library in a temporary directory,
called through ctypes. The plain versions run with `numerics.on_cpu` patched
to return False, so they compute in the order they state for a tensor on a
card. Every output must be equal bit for bit (two NaNs count as equal).
This guards the kernels' logic where there is no card; it skips where there
is no g++. Copies of the lane functions with one comparison, one rounding or
one constant changed must fail it (test_rehearsal_catches_mutated_lanes and
the tests after it)."""
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
      imdct_scatter(xla_dct4_out(y + N * b, Mt, N, c), c, N, la, win, mem + (N - la) * b,
                    out + N * b, new_mem + (N - la) * b);
}
void rehearse_imdct_row(const float* y, const float* mem, const float* win, const float* Mt,
                        float* out, float* new_mem, int N, int la) {
  for (int c = 0; c < N; ++c)
    imdct_scatter(xla_dct4_out_row(y, Mt, N, c), c, N, la, win, mem, out, new_mem);
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


@pytest.mark.parametrize("fs,bitrate", [(48000, 64000), (16000, 32000)])
def test_imdct_single_stream_lane_matches_plain(lib4, fs, bitrate):
    """The IMDCT of one stream (the matrix-vector product's eight chains)
    on each of the synthetic rows."""
    from audio_codec_torch.ops import transforms
    cfg = P.Config(fs_in=fs, bitrate=bitrate)
    N, la = cfg.frame_length, cfg.la_zeroes
    x, mem = C.transform_rows(N, la, seed=5)
    rwin = np.ascontiguousarray(transforms.window(cfg, "cpu", reverse=True).numpy())
    Mt = transforms.dct4_mt(N, "cpu").numpy()
    for b in range(x.shape[0]):
        y, m = np.ascontiguousarray(x[b: b + 1] / np.float32(64.0)), np.ascontiguousarray(mem[b: b + 1])
        out, nm2 = np.zeros((1, N), np.float32), np.zeros((1, N - la), np.float32)
        lib4.rehearse_imdct_row(ptr(y), ptr(m), ptr(rwin), ptr(Mt), ptr(out), ptr(nm2), N, la)
        ref = transforms.imdct_plain(cfg, torch.from_numpy(y), torch.from_numpy(m))
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


# ---- the channel coder (csrc/fec.cuh) ----

WRAPPER_PC = r"""
#include "ari_decode.cuh"

extern "C" {
// side [9][L], pc_in [3][L] (bfi_in, be_l, be_r), geom: N max_lev hrmode tns_max lpcw
// rate_flag total_bits max_res res_iters pc_bytes numbytes
void rehearse_ari_decode(const int* frames, const int* side, const int* pc_in, const int* tabs,
                         const int* geom, int pc_mode, int L, int nbytes, int* x, int* tns_order,
                         int* tns_idx, int* res, int* out) {
  const DecGeom g = {geom[0], geom[1], geom[2], geom[3], geom[4], geom[5], geom[6], geom[7],
                     geom[8], geom[9], geom[10]};
  DecTables tb;
  tb.lookup = tabs;
  tb.cumf = tabs + 4096;
  tb.order_cf = tb.cumf + 64 * 18;
  tb.coef_cf = tb.order_cf + 2 * 9;
  uint8_t buf[1024], levs[512];
  for (int s = 0; s < L; ++s) {
    for (int i = 0; i < nbytes; ++i) buf[i] = static_cast<uint8_t>(frames[s * nbytes + i]);
    int sd[9];
    for (int j = 0; j < 9; ++j) sd[j] = side[j * L + s];
    int* xs = x + s * g.N;
    int* rs = res + s * g.max_res;
    if (pc_mode == 1)
      ari_decode_lane<kPcDecode>(buf, nbytes, sd, tb, g, pc_in[s], pc_in[L + s], pc_in[2 * L + s],
                                 xs, tns_order + 2 * s, tns_idx + 16 * s, rs, levs, out + s, L);
    else if (pc_mode == 2)
      ari_decode_lane<kPcEncSim>(buf, nbytes, sd, tb, g, pc_in[s], pc_in[L + s], pc_in[2 * L + s],
                                 xs, tns_order + 2 * s, tns_idx + 16 * s, rs, levs, out + s, L);
    else
      ari_decode_lane<kPcNone>(buf, nbytes, sd, tb, g, pc_in[s], pc_in[L + s], pc_in[2 * L + s],
                               xs, tns_order + 2 * s, tns_idx + 16 * s, rs, levs, out + s, L);
  }
}
}
"""
# mutations of the range decoder's PC hooks that the rehearsal must catch
MUTATIONS_PC = {
    "bp_side_jump": ("ari_decode.cuh", "d.bp_side = d.pcb - 1;", "d.bp_side = d.pcb;"),
}

WRAPPER_FEC = r"""
#include "fec.cuh"
using namespace acx;

extern "C" {
void rehearse_fec_encode(const int* data, const int* epmr, const int* tabs, int B, int D,
                         int slot, int mode, int ccc, int* out) {
  FecTables tb;
  tb.w = tabs;
  uint8_t dw[kFecMaxNib], cw[kFecMaxNib];
  for (int b = 0; b < B; ++b)
    fec_encode_lane(data + D * b, epmr[b], tb, slot, mode, ccc, dw, cw, out + slot * b);
}
void rehearse_fec_decode(const int* frames, const int* bfi_in, const int* tabs, int B, int slot,
                         int ccc, int* data, int* out) {
  FecTables tb;
  tb.w = tabs;
  FecDecScratch sc;
  for (int b = 0; b < B; ++b)
    fec_decode_lane(frames + slot * b, bfi_in[b], tb, slot, ccc, sc, data + slot * b, out + b, B);
}
int fec_table_words() { return kFecTableWords; }
}
"""

# mutations of the channel coder's lanes that the rehearsal must catch
MUTATIONS_FEC = {
    # a `<` for `<=` in a risk compare: the EPMR increment by codeword 0's risk
    # (the risk thresholds themselves are no reachable risk product, so a
    # changed compare against them gives the same results)
    "risk_compare_lt": ("fec.cuh", "4 * (exp0 <= -8 ? 1 : 0)", "4 * (exp0 < -8 ? 1 : 0)"),
    "deinterleave_length": ("fec.cuh", "      if (j < len) {\n        const int o",
                            "      if (j < len - 1) {\n        const int o"),
}


def build_fec_lanes(out: Path, mutation: str | None = None) -> ctypes.CDLL:
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("needs g++ to compile the lane functions for the CPU")
    inc = CSRC
    if mutation is not None:
        inc = out / "csrc"
        shutil.copytree(CSRC, inc)
        name, old, new = {**MUTATIONS_FEC, **MUTATIONS_PC}[mutation]
        text = (inc / name).read_text()
        assert text.count(old) == 1, f"{mutation}: the line to mutate is not in {name}"
        (inc / name).write_text(text.replace(old, new))
    (out / "lanes_fec.cpp").write_text(WRAPPER_FEC + WRAPPER_PC)
    r = subprocess.run([gxx, "-x", "c++", "-std=c++17", "-O1", "-shared", "-fPIC", f"-I{inc}",
                        str(out / "lanes_fec.cpp"), "-o", str(out / "lanes_fec.so")],
                       capture_output=True, text=True, timeout=600)
    assert r.returncode == 0, r.stderr
    return ctypes.CDLL(str(out / "lanes_fec.so"))


@pytest.fixture(scope="module")
def lib_fec(tmp_path_factory):
    return build_fec_lanes(tmp_path_factory.mktemp("lanes_fec"))


def lane_fec_encode(lib, data, epmr, slot, mode, ccc):
    data, epmr = _c(data, np.int32), _c(epmr, np.int32)
    out = np.zeros((data.shape[0], slot), np.int32)
    lib.rehearse_fec_encode(ptr(data), ptr(epmr), ptr(K.fec_tables("cpu").numpy()),
                            data.shape[0], data.shape[1], slot, mode, ccc, ptr(out))
    return out


def lane_fec_decode(lib, frames, bfi_in, slot, ccc) -> dict:
    from audio_codec_torch.ops import fec
    frames, bfi_in = _c(frames, np.int32), _c(bfi_in, np.int32)
    B = frames.shape[0]
    data, out = np.zeros((B, slot), np.int32), np.zeros((9, B), np.int32)
    lib.rehearse_fec_decode(ptr(frames), ptr(bfi_in), ptr(K.fec_tables("cpu").numpy()), B, slot,
                            ccc, ptr(data), ptr(out))
    return dict(zip(fec.DECODE_FIELDS, [data, *out]))


def fec_case(slot, mode, ccc):
    """(data, epmr, frames after the channel, bfi_in) of one case."""
    from audio_codec_torch.ops import fec
    data, epmr, kinds, bfi_in = C.fec_rows(slot, mode, ccc)
    enc = fec.fec_encode_plain(torch.from_numpy(data), torch.from_numpy(epmr), slot, mode,
                               ccc).numpy()
    return data, epmr, C.channel_errors(enc, slot, mode, kinds, np.random.default_rng(1)), bfi_in


def fec_differing(lib, slot, mode, ccc) -> int:
    from audio_codec_torch.ops import fec
    data, epmr, frames, bfi_in = fec_case(slot, mode, ccc)
    bad = C.count_differing(lane_fec_encode(lib, data, epmr, slot, mode, ccc),
                            fec.fec_encode_plain(torch.from_numpy(data), torch.from_numpy(epmr),
                                                 slot, mode, ccc).numpy())
    ref = fec.fec_decode_plain(torch.from_numpy(frames), slot, ccc, torch.from_numpy(bfi_in))
    got = lane_fec_decode(lib, frames, bfi_in, slot, ccc)
    return bad + sum(C.count_differing(got[k], ref[k].numpy()) for k in fec.DECODE_FIELDS)


def test_fec_table_layout_matches_header(lib_fec):
    assert lib_fec.fec_table_words() == K.fec_tables("cpu").numel()


@pytest.mark.parametrize("slot", C.FEC_SLOTS)
def test_fec_lanes_match_plain(lib_fec, slot):
    """Encoder and decoder lanes at EP1-4 with and without combined channel
    coding, on clean, corrected, PC-destroyed, heavily damaged and lost
    frames, with every EPMR."""
    for mode in (1, 2, 3, 4):
        for ccc in (0, 1):
            assert fec_differing(lib_fec, slot, mode, ccc) == 0, (slot, mode, ccc)


def synthetic_differing(lib, frames) -> tuple[int, dict]:
    from audio_codec_torch.ops import fec
    bfi_in = np.zeros(frames.shape[0], np.int32)
    ref = fec.fec_decode_plain(torch.from_numpy(frames), 80)
    got = lane_fec_decode(lib, frames, bfi_in, 80, 0)
    return sum(C.count_differing(got[k], ref[k].numpy()) for k in fec.DECODE_FIELDS), got


def test_fec_decode_lane_on_wrong_mode_and_risk_frames(lib_fec):
    bad, got = synthetic_differing(lib_fec, C.wrong_mode_rows())
    assert bad == 0 and (got["mode"] > 2).all() and (got["bfi"] == 1).all()
    bad, got = synthetic_differing(lib_fec, C.epmr_risk_rows())
    assert bad == 0 and (got["mode"] == 2).all() and (got["bfi"] == 1).all()
    assert (got["epmr"] >= 4).all()


@pytest.mark.parametrize("mutation", list(MUTATIONS_FEC))
def test_rehearsal_catches_mutated_fec_lanes(tmp_path, mutation):
    lib = build_fec_lanes(tmp_path, mutation)
    bad = sum(fec_differing(lib, slot, mode, 0) for slot in (40, 80) for mode in (2, 3, 4))
    bad += synthetic_differing(lib, C.epmr_risk_rows())[0]
    assert bad > 0, f"the rehearsal did not see the mutation {mutation}"


# ---- the range decoder's partial-concealment hooks (csrc/ari_decode.cuh) ----

def lane_ari_decode(lib, cfg, frames, bfi_in, be_l, be_r, pc_mode: int) -> dict:
    from audio_codec_torch.ops import ari, bits
    from audio_codec_torch.ops.quant import residual_max_bits
    frames = _c(frames, np.int32)
    L, nbytes = frames.shape
    side = bits.parse_side_info_plain(cfg, torch.from_numpy(frames))
    cols = [side[k] for k in ("lastnz", "lsb_mode", "num_tns")] + [
        side["tns_on"][:, 0], side["tns_on"][:, 1]] + [
        side[k] for k in ("bp_side", "mask_side", "gg_idx", "fac_ns_idx")]
    side_in = _c(torch.stack([c.to(torch.int32) for c in cols]).numpy(), np.int32)
    pc_in = _c(np.stack([bfi_in, be_l, be_r]), np.int32)
    N = cfg.yLen
    max_res = min(residual_max_bits(cfg), cfg.targetBytes * 8)
    pc = ari.pc_params(cfg, pc_mode == 2)
    geom = np.array([N, 14, 0, 8, int(cfg.enable_lpc_weighting), cfg.rateFlag, cfg.targetBytes * 8,
                     max_res, 1, 0 if pc is None else pc["pc_bytes"], cfg.targetBytes], np.int32)
    x, tns_order = np.zeros((L, N), np.int32), np.zeros((L, 2), np.int32)
    tns_idx, res = np.zeros((L, 2, 8), np.int32), np.zeros((L, max_res), np.int32)
    out = np.zeros((7, L), np.int32)
    lib.rehearse_ari_decode(ptr(frames), ptr(side_in), ptr(pc_in),
                            ptr(K._decoder_tables("cpu").numpy()), ptr(geom), pc_mode, L, nbytes,
                            ptr(x), ptr(tns_order), ptr(tns_idx), ptr(res), ptr(out))
    names = ("nf_seed", "zero_frame", "n_res", "residual_present", "bfi", "spec_inv_idx", "b_left")
    return dict(x=x, tns_order=tns_order, tns_idx=tns_idx, res_bits=res, **dict(zip(names, out))), side


def pc_differing(lib, epmode: int) -> tuple[int, dict]:
    """Differing values of the PC decode and the encoder's simulation on
    pc_decode_rows, lanes against the plain version."""
    from audio_codec_torch.ops import ari
    cfg = P.Config(fs_in=48000, bitrate=64000, epmode=epmode)
    a = C.pc_decode_rows(epmode)
    bad = 0
    for mode in (1, 2):
        got, side = lane_ari_decode(lib, cfg, a["frames"], a["bfi_in"], a["be_l"], a["be_r"], mode)
        t_ = lambda k: torch.from_numpy(a[k])
        ref = ari.decode_plain(cfg, t_("frames"), side, t_("bfi_in"), t_("be_l"), t_("be_r"),
                               pc_enc_sim=mode == 2)
        bad += sum(C.count_differing(got[k], ref[k].numpy()) for k in got)
        if mode == 1:
            dec = got
    return bad, dec


@pytest.mark.parametrize("epmode", C.PC_EP_MODES)
def test_pc_decode_lane_matches_plain(lib_fec, epmode):
    """The range decoder with a relocated PC block, on bfi 0 and bfi 2 rows
    over four corrupt ranges, and the encoder's simulation (b_left)."""
    bad, dec = pc_differing(lib_fec, epmode)
    assert bad == 0
    assert (dec["bfi"] == 2).any() and (dec["bfi"] == 0).any(), np.bincount(dec["bfi"])


def test_rehearsal_catches_mutated_pc_lanes(tmp_path):
    lib = build_fec_lanes(tmp_path, "bp_side_jump")
    assert sum(pc_differing(lib, m)[0] for m in C.PC_EP_MODES) > 0


# ---- advanced concealment (csrc/plc_tdc.cuh, plc_damp.cuh, phecu.cuh) ----
# The steps are templates over the warp that runs them (csrc/plc.cuh); here
# HostWarp runs every lane's share in turn. The plain versions take the
# reference's order on every device, so they need no card_order; the Phase
# ECU's sine and cosine are the double's, correctly rounded, on both sides
# (the card's sinf and cosf are first seen on the card).

WRAPPER_PLC = r"""
#include "plc_tdc.cuh"
#include "plc_damp.cuh"
#include "phecu.cuh"
#include <vector>
using namespace acx;

extern "C" {
void rehearse_plc_tdc(const float* x, const float* scf, const float* q, const float* a_in,
                      const float* harm_in, const float* hist_in, const int32_t* ints,
                      const float* floats, const float* ftab, const int32_t* itab, float* a_out,
                      float* synth, float* harm, float* hist, int32_t* iout, float* fout, int B,
                      const int* gi, const float* gf) {
  const TdcGeom g = {gi[0], gi[1], gi[2], gi[3], gi[4], gi[5], gi[6], gi[7], gi[8], gi[9],
                     gf[0], gf[1], gf[2]};
  std::vector<TdcWork> work(1);
  const HostWarp w;
  for (int b = 0; b < B; ++b) {
    const size_t bb = b;
    TdcStream s;
    s.x = x + bb * g.L; s.scf = scf + bb * 16; s.q = q + bb * g.N; s.a_in = a_in + bb * 17;
    s.harm_in = harm_in + bb * g.MP; s.hist_in = hist_in + bb * 16;
    s.lost = ints[b]; s.nb = ints[B + b]; s.pitch = ints[2 * B + b];
    s.pitch_fr = ints[3 * B + b]; s.meth_in = ints[4 * B + b]; s.seed_in = ints[5 * B + b];
    s.fract_in = ints[6 * B + b]; s.hlen_in = ints[7 * B + b];
    s.stab = floats[b]; s.gain_c_in = floats[B + b]; s.alpha_in = floats[2 * B + b];
    s.a = a_out + bb * 17; s.synth = synth + bb * g.length; s.harm = harm + bb * g.MP;
    s.hist = hist + bb * 16;
    s.meth = iout + b; s.seed = iout + B + b; s.fract = iout + 2 * B + b; s.hlen = iout + 3 * B + b;
    s.nc = fout + b; s.gain_c = fout + B + b; s.alpha = fout + 2 * B + b;
    plc_tdc_stream(w, s, g, tdc_tables(ftab, itab, g.n_bands), work.data());
  }
}
void rehearse_damp(const float* x, const float* q, const int32_t* ints, const float* floats,
                   const int32_t* pows, float* spec, float* fout, int32_t* iout, int B, int N) {
  std::vector<DampWork> work(1);
  const HostWarp w;
  for (int b = 0; b < B; ++b) {
    int iv[10];
    float fv[4], fo[3];
    int io[2];
    for (int k = 0; k < 10; ++k) iv[k] = ints[k * B + b];
    for (int k = 0; k < 4; ++k) fv[k] = floats[k * B + b];
    damp_stream(w, x + (size_t)b * N, q + (size_t)b * N, iv, fv, pows, N, work.data(),
                spec + (size_t)b * N, fo, io);
    for (int k = 0; k < 3; ++k) fout[k * B + b] = fo[k];
    iout[b] = io[0];
    iout[B + b] = io[1];
  }
}
void rehearse_spec_ana(const float* xr, const float* xi, const float* xor_, const float* xoi,
                       const float* nc, const int32_t* active, float* f0, int32_t* npl, float* e,
                       int B, int ns, int n_lgw) {
  std::vector<PhWork> work(1);
  const HostWarp w;
  const PhGeom g = {ns, 0, n_lgw, 0, 0, 0};
  for (int b = 0; b < B; ++b) {
    const size_t row = (size_t)b * ns;
    float* eo = e + (size_t)b * 9;
    float* el = e + ((size_t)B + b) * 9;
    if (!active[b]) {
      for (int k = 0; k < ns; ++k) f0[row + k] = -1.0f;
      for (int k = 0; k < 9; ++k) eo[k] = el[k] = 0.0f;
      npl[b] = 0;
      continue;
    }
    int count;
    ph_spec_ana_stream(w, g, xr + row, xi + row, xor_ + row, xoi + row, nc[b], work.data(),
                       f0 + row, &count, eo, el);
    npl[b] = count;
  }
}
void rehearse_subst(const float* xr, const float* xi, const float* f0, const int32_t* ints,
                    const float* groups, const float* beta_mute, const int32_t* tab, float* outr,
                    float* outi, int B, const int* gi) {
  std::vector<PhWork> work(1);
  const HostWarp w;
  const PhGeom g = {gi[0], gi[1], gi[2], gi[3], gi[4], gi[5]};
  for (int b = 0; b < B; ++b) {
    const size_t row = (size_t)b * g.nsf;
    if (!ints[3 * B + b]) {
      for (int k = 0; k < g.nsf; ++k) outr[row + k] = outi[row + k] = 0.0f;
      continue;
    }
    const int nb = ints[B + b];
    const size_t gb = (size_t)b * 9, gB = (size_t)B * 9;
    ph_burst(w, nb, groups + gb, groups + gB + gb, groups + 2 * gB + gb, beta_mute[b],
             work.data());
    ph_subst_stream(w, g, xr + row, xi + row, f0 + (size_t)b * g.ns, ints[b], nb,
                    ints[2 * B + b], groups + 3 * gB + gb, tab, work.data(), outr + row,
                    outi + row);
  }
}
}
"""

MUTATIONS_PLC = {
    # the TD-PLC noise one generator step late
    "tdc_lcg_step": ("plc_tdc.cuh", "lcg16_at(s.seed_in, k + 1, t.pows, nr)",
                     "lcg16_at(s.seed_in, k + 2, t.pows, nr)"),
    # the rapid fade of a full-frame loss starts a frame late
    "damp_fade_late": ("plc_damp.cuh", "(nb > 2 ? 0.5f : 1.0f)", "(nb > 3 ? 0.5f : 1.0f)"),
    # `>` for `>=` where a later equal magnitude takes the peak candidate
    "peak_better_gt": ("phecu.cuh", "const bool better = mode == 1 && m >= cand;",
                       "const bool better = mode == 1 && m > cand;"),
    # the upper neighbour's peak before the lower one's at equal distance
    "subst_lower_first": ("phecu.cuh", "if (!assigned && k + d < ns && is_peak(k + d)) {",
                          "if (!assigned && k - d >= 0 && is_peak(k - d)) {"),
}


def build_plc_lanes(out: Path, mutation: str | None = None) -> ctypes.CDLL:
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("needs g++ to compile the lane functions for the CPU")
    inc = CSRC
    if mutation is not None:
        inc = out / "csrc"
        shutil.copytree(CSRC, inc)
        name, old, new = MUTATIONS_PLC[mutation]
        text = (inc / name).read_text()
        assert text.count(old) == 1, f"{mutation}: the line to mutate is not in {name}"
        (inc / name).write_text(text.replace(old, new))
    (out / "lanes_plc.cpp").write_text(WRAPPER_PLC)
    r = subprocess.run([gxx, "-x", "c++", "-std=c++17", "-O1", "-ffp-contract=off", "-shared",
                        "-fPIC", f"-I{inc}", str(out / "lanes_plc.cpp"), "-o",
                        str(out / "lanes_plc.so")], capture_output=True, text=True, timeout=600)
    assert r.returncode == 0, r.stderr
    return ctypes.CDLL(str(out / "lanes_plc.so"))


@pytest.fixture(scope="module")
def lib_plc(tmp_path_factory):
    return build_plc_lanes(tmp_path_factory.mktemp("lanes_plc"))


@pytest.fixture
def exact_trig(monkeypatch):
    """The Phase ECU's sine and cosine as the host build computes them."""
    from audio_codec_torch.ops import plc_phecu
    monkeypatch.setattr(plc_phecu, "_cos", lambda v: torch.cos(v.double()).float())
    monkeypatch.setattr(plc_phecu, "_sin", lambda v: torch.sin(v.double()).float())


PLCFG = P.Config(fs_in=48000, bitrate=64000, plc_mode=1)
TDC_ORDER = ("lost", "nb", "pitch", "fract", "meth", "seed", "fract_st", "harm_len", "stab",
             "gain_c", "alpha")


def lane_tdc(lib, d) -> dict:
    ftab, itab, geom = K.tdc_tables(PLCFG, "cpu")
    B = d["nb"].shape[0]
    L, MP, fl, length, N = geom[:5]
    ints, floats = K.plc_tdc_pack(*(torch.as_tensor(np.asarray(d[k])) for k in TDC_ORDER))
    ints, floats = _c(ints.numpy(), np.int32), _c(floats.numpy(), np.float32)
    rows = [_c(d[k], np.float32) for k in ("x_old_tot", "scf", "q_d", "a_st", "harm", "synth_hist")]
    a, synth = np.zeros((B, 17), np.float32), np.zeros((B, length), np.float32)
    harm, hist = np.zeros((B, MP), np.float32), np.zeros((B, 16), np.float32)
    iout, fout = np.zeros((4, B), np.int32), np.zeros((3, B), np.float32)
    gi, gf = np.array(geom[:10], np.int32), np.array(geom[10:], np.float32)
    lib.rehearse_plc_tdc(*(ptr(v) for v in rows), ptr(ints), ptr(floats), ptr(ftab.numpy()),
                         ptr(itab.numpy()), ptr(a), ptr(synth), ptr(harm), ptr(hist), ptr(iout),
                         ptr(fout), B, ptr(gi), ptr(gf))
    return dict(meth=iout[0], nc=fout[0], a=a, synth=synth, seed=iout[1], gain_c=fout[1],
                alpha=fout[2], fract=iout[2], harmonic_buf=harm, harmonic_len=iout[3],
                synth_hist=hist)


def plain_tdc(d) -> dict:
    from audio_codec_torch.ops import plc_adv
    t_ = lambda k: torch.as_tensor(np.asarray(d[k]))
    out = plc_adv.plc_tdc_plain(PLCFG, t_("lost"), t_("nb"), t_("x_old_tot"), t_("scf"), t_("q_d"),
                                t_("pitch"), t_("fract"), t_("stab"), t_("meth"), t_("a_st"),
                                t_("seed"), t_("gain_c"), t_("alpha"), t_("fract_st"), t_("harm"),
                                t_("harm_len"), t_("synth_hist"))
    return {k: v.numpy() for k, v in out.items()}


def tdc_differing(lib, group: int) -> int:
    d = C.tdc_stream_rows(group)
    got, ref = lane_tdc(lib, d), plain_tdc(d)
    return sum(C.count_differing(got[k], ref[k]) for k in ref)


def test_plc_tdc_table_layout():
    ftab, itab, geom = K.tdc_tables(PLCFG, "cpu")
    n_bands = geom[6]
    assert ftab.numel() == 48 + n_bands * 19 + 16 + 22 + 2048
    assert itab.numel() == n_bands + 1 + 2 * (geom[3] + 11)


@pytest.mark.parametrize("group", sorted(C.TDC_LANES))
def test_plc_tdc_lane_matches_plain(lib_plc, group):
    """The classifier and LPC at first losses, TD-PLC on first, later,
    fractional-pitch, stable, fading and silent lanes, lanes passed through."""
    d = C.tdc_stream_rows(group)
    assert tdc_differing(lib_plc, group) == 0
    assert (plain_tdc(d)["meth"] == 3).any()


def damp_call(d: dict):
    ints = [d[k] for k in ("ns_lane", "lost", "is_pc", "nb_cur", "pc_nb_lost", "pitch_int",
                           "pc_pitch")] + [d["ns_seed"], d["pc_seed"], d["spec_inv_idx"]]
    floats = [d[k] for k in ("stab_fac", "cum_fflc", "cum_slow", "cum_fast")]
    return ints, floats


def damp_differing(lib, seed: int) -> int:
    from audio_codec_torch.ops import plc_adv
    d = C.damp_stream_rows(seed)
    ints, floats = damp_call(d)
    B, N = d["x"].shape
    spec, fout, iout = np.zeros((B, N), np.float32), np.zeros((3, B), np.float32), np.zeros((2, B), np.int32)
    pows = _c(plc_adv.lcg_pows(N), np.int32)
    lib.rehearse_damp(ptr(_c(d["x"], np.float32)), ptr(_c(d["q_d_prev"], np.float32)),
                      ptr(_c(np.stack(ints), np.int32)), ptr(_c(np.stack(floats), np.float32)),
                      ptr(pows), ptr(spec), ptr(fout), ptr(iout), B, N)
    t_ = lambda v: torch.as_tensor(np.asarray(v))
    ref = plc_adv.damp_scramble_plain(
        PLCFG, t_(d["x"]), t_(d["q_d_prev"]), t_(d["ns_lane"] != 0), t_(d["lost"] != 0),
        t_(d["is_pc"] != 0), t_(d["nb_cur"]), t_(d["pc_nb_lost"]), t_(d["stab_fac"]),
        t_(d["pitch_int"]), t_(d["pc_pitch"]), t_(d["cum_fflc"]), t_(d["cum_slow"]),
        t_(d["cum_fast"]), t_(d["ns_seed"]), t_(d["pc_seed"]), t_(d["spec_inv_idx"]))
    got = [spec, fout[0], fout[1], fout[2], iout[0], iout[1]]
    return sum(C.count_differing(g, r.numpy()) for g, r in zip(got, ref))


@pytest.mark.parametrize("seed", [0, 1])
def test_plc_damp_scramble_lane_matches_plain(lib_plc, seed):
    """Noise substitution lanes at first, third and past-fade-out losses, a
    TD-PLC lane, partially concealed lanes from bins 0, 120 and 399, a
    clean lane."""
    assert damp_differing(lib_plc, seed) == 0


def spec_ana_differing(lib, seed: int) -> tuple[int, np.ndarray]:
    from audio_codec_torch.ops import plc_phecu as H
    r = C.phecu_peak_rows(seed)
    B, ns = r["Xr"].shape
    xor_, xoi = np.roll(r["Xr"], 1, axis=0), np.roll(r["Xi"], 1, axis=0)
    active = np.array([1, 1, 1, 1, 1, 1, 0, 1], np.int32)[:B]
    f0, npl, e = np.zeros((B, ns), np.float32), np.zeros(B, np.int32), np.zeros((2, B, 9), np.float32)
    lib.rehearse_spec_ana(ptr(_c(r["Xr"], np.float32)), ptr(_c(r["Xi"], np.float32)), ptr(_c(xor_, np.float32)),
                          ptr(_c(xoi, np.float32)), ptr(_c(r["nc"], np.float32)), ptr(active), ptr(f0),
                          ptr(npl), ptr(e), B, ns, H.n_lgw(PLCFG))
    t_ = lambda v: torch.as_tensor(np.asarray(v))
    ref = H.phecu_spec_ana_plain(PLCFG, t_(r["Xr"]), t_(r["Xi"]), t_(xor_), t_(xoi), t_(r["nc"]),
                                 t_(active != 0))
    got = [f0, npl, e[0], e[1]]
    return sum(C.count_differing(g, v.numpy()) for g, v in zip(got, ref)), ref[1].numpy()


@pytest.mark.parametrize("seed", [0, 1])
def test_phecu_spec_ana_lane_matches_plain(lib_plc, seed):
    """Tones, harmonics, noise, a peak-dense comb (the drop rule), one and
    two peaks, an inactive lane."""
    bad, npl = spec_ana_differing(lib_plc, seed)
    assert bad == 0
    assert (npl == 0).any() and ((npl > 0) & (npl < 3)).any() and (npl > 3).any(), npl


def subst_differing(lib, seed: int) -> int:
    from audio_codec_torch.ops import plc_phecu as H
    r = C.phecu_peak_rows(seed)
    d = C.phecu_subst_rows(seed)
    t_ = lambda v: torch.as_tensor(np.asarray(v))
    f0, npl = H._peaks(t_(r["Xr"]), t_(r["Xi"]), t_(r["nc"]))
    f0, npl = f0.numpy(), npl.numpy().copy()
    npl[5] = 1
    B = f0.shape[0]
    ints = np.stack([npl, d["nb_cur"], d["is_trans"], d["active"]]).astype(np.int32)
    groups = np.stack([d["e_oold"], d["e_old"], d["mag_chg_1st"], d["xavg"]]).astype(np.float32)
    tab = _c(H.lcg_tables(H.search_bins(PLCFG)), np.int32)
    outr, outi = np.zeros((B, 385), np.float32), np.zeros((B, 385), np.float32)
    gi = np.array([H.search_bins(PLCFG), H.nbins(PLCFG), H.n_lgw(PLCFG), PLCFG.frame_length,
                   H.t_adv(PLCFG), H.lprot(PLCFG)], np.int32)
    lib.rehearse_subst(ptr(_c(d["Xr"], np.float32)), ptr(_c(d["Xi"], np.float32)), ptr(_c(f0, np.float32)),
                       ptr(ints), ptr(groups), ptr(_c(d["beta_mute"], np.float32)), ptr(tab), ptr(outr),
                       ptr(outi), B, ptr(gi))
    ref = H.phecu_subst_plain(PLCFG, t_(d["Xr"]), t_(d["Xi"]), t_(f0), t_(npl), t_(d["nb_cur"]),
                              t_(d["e_oold"]), t_(d["e_old"]), t_(d["mag_chg_1st"]),
                              t_(d["beta_mute"]), t_(d["xavg"]), t_(d["is_trans"]),
                              t_(d["active"] != 0))
    return C.count_differing(outr, ref[0].numpy()) + C.count_differing(outi, ref[1].numpy())


@pytest.mark.parametrize("seed", [0, 1])
def test_phecu_subst_lane_matches_plain(lib_plc, exact_trig, seed):
    """First losses and bursts of 2 to 9 frames (DC and Nyquist
    attenuation), a transient lane, lanes of no, one and many peaks, an
    inactive lane."""
    assert subst_differing(lib_plc, seed) == 0


@pytest.mark.parametrize("mutation", list(MUTATIONS_PLC))
def test_rehearsal_catches_mutated_plc_lanes(tmp_path, exact_trig, mutation):
    lib = build_plc_lanes(tmp_path, mutation)
    bad = sum(tdc_differing(lib, g) for g in C.TDC_LANES)
    bad += sum(damp_differing(lib, s) for s in (0, 1))
    bad += sum(spec_ana_differing(lib, s)[0] for s in (0, 1))
    bad += sum(subst_differing(lib, s) for s in (0, 1))
    assert bad > 0, f"the rehearsal did not see the mutation {mutation}"


# ---- the bit-exact fixed-point decoder (csrc/fx_*.cuh) and the repaired
# TNS synthesis lattice ----
# The fixed-point steps are templates over the group of threads that runs
# them (csrc/fixed.cuh: a warp or a block on the card, `Host` here). Their
# arithmetic is integer, so the plain versions need no card order and every
# output must be equal.

WRAPPER_FX = r"""
#include "fx_sns_dec.cuh"
#include "fx_spec_decode.cuh"
#include "fx_dct4.cuh"
#include "fx_ola_ltpf.cuh"
#include "tns_synthesis_lattice.cu"
#include <vector>
using namespace acx::fx;

extern "C" {
void rehearse_fx_sns_dec(const int32_t* idx, const i64* tab, int n_bands, int L, i64* scf,
                         i64* scf_e) {
  i64 scratch[kSnsScratch];
  for (int l = 0; l < L; ++l)
    fx_sns_dec_lane(idx + 7 * l, tab, n_bands, scratch, scf + l * n_bands, scf_e + l * n_bands, 1);
}
// geom: yLen N n_bands frame_dms gg_off R
void rehearse_fx_spec_decode(const int32_t* x, const int32_t* res, const int32_t* side,
                             const int32_t* tidx, const i64* scf, const i64* scf_e,
                             const i64* tab, const int* geom, int L, i64* out, i64* x_e) {
  const SpecGeom g{geom[0], geom[1], geom[2], geom[3], geom[4], geom[5]};
  std::vector<i64> xs(g.yLen);
  std::vector<int32_t> run(g.yLen);
  const Host w;
  for (int l = 0; l < L; ++l)
    fx_spec_decode_lane(w, x + l * g.yLen, res + l * g.R, side + l * kSpecSideWords, tidx + 16 * l,
                        scf + l * g.n_bands, scf_e + l * g.n_bands, tab, g, xs.data(), run.data(),
                        out + l * g.N, x_e + l);
}
void rehearse_fx_dct4(const i64* y, const i64* y_e, const i64* tab, int L, i64* ytda, i64* ye,
                      i64* ys, bool* zero) {
  i64 a[kDctN], b[kDctN];
  const Host g;
  for (int l = 0; l < L; ++l)
    fx_dct4_row(g, y + l * kDctN, y_e[l], tab, a, b, ytda + l * kDctN, ye + l, ys + l, zero + l);
}
// st: the ten state arrays in the order of kernels.FX_STATE_KEYS
void rehearse_fx_ola_ltpf(const i64* ytda, const i64* y_e, const i64* y_s, const bool* zero,
                          const int32_t* lp, const i64* tab, i64** st, const int* geom, int B,
                          int16_t* pcm) {
  const OlaGeom g{geom[0], geom[1], geom[2], geom[3], geom[4], geom[5], geom[6], geom[7],
                  geom[8], geom[9], geom[10], geom[11], geom[12], geom[13]};
  std::vector<i64> sc(ola_scratch_words(g));
  const Host w;
  const int memLen = g.wLen - g.N;
  for (int b = 0; b < B; ++b) {
    const OlaState s{st[0] + b * memLen, st[1] + b, st[2] + b * g.x_len, st[3] + b * g.y_len,
                     st[4] + b, st[5] + b, st[6] + b, st[7] + b, st[8] + b, st[9] + b};
    fx_ola_ltpf_lane(w, ytda + b * g.N, y_e[b], y_s[b], zero[b], lp + 3 * b, tab, g, s, sc.data(),
                     pcm + b * g.N);
  }
}
void rehearse_tns_synthesis(float* x, const float* rc, const int* order, const int* lo,
                            const int* hi, int B, int N) {
  for (int b = 0; b < B; ++b)
    tns_synthesis_lane(x + b * N, N, rc + 16 * b, order + 2 * b, lo + 2 * b, hi + 2 * b, B == 1);
}
int fx_sns_table_words() { return kFxSnsTableWords; }
int fx_dct4_table_words() { return kFxDctTableWords; }
}
"""

# one mutated copy per kernel that the rehearsal must catch: a rounding, a
# saturation and a shift clamp removed, a scale shift changed (the DCT-IV
# has no rounding constant, and its scaling leaves no sum that saturates);
# and the group scans' rank made inclusive
MUTATIONS_FX = {
    # fx_sns_dec: the normalised pulses truncated, not rounded
    "sns_en1_rounding": ("fx_sns_dec.cuh",
                         "y[k] = round_fx(L_shl(L_mult(iq, shl16(y[k], shift_num)), 13 - shift_num));",
                         "y[k] = sat16(L_shl(L_mult(iq, shl16(y[k], shift_num)), 13 - shift_num) >> 16);"),
    # fx_spec_decode: a lattice tap without its saturation
    "spec_lattice_saturation": ("fx_spec_decode.cuh",
                                "xi = sat32(xi - mpy_32_16(st[kk], rc[kk]));",
                                "xi = xi - mpy_32_16(st[kk], rc[kk]);"),
    # fx_spec_decode's prefix counts (the residual's and the noise filler's
    # ranks): a bin counted in its own rank
    "scan_rank_inclusive": ("fixed.cuh",
                            "f(base + j, r + popc32(m & below32(j)), ((m >> j) & 1u) != 0);",
                            "f(base + j, r + popc32(m & upto32(j)), ((m >> j) & 1u) != 0);"),
    # fx_dct4: the radix-8 rows' SCALEFACTORN2 - 1 shift one short
    "dct4_bfly_shift": ("fx_dct4.cuh", "auto ps = [](i64 v) { return v >> 2; };",
                        "auto ps = [](i64 v) { return v >> 1; };"),
    # fx_ola_ltpf: the passthrough's shift of the frame without its clamp at 15
    "ola_shift_clamp": ("fx_ola_ltpf.cuh",
                        "v = k < keep ? ybuf[k + N] : (sA > 15 ? 0 : shr64(x_in[k - keep], sA));",
                        "v = k < keep ? ybuf[k + N] : shr64(x_in[k - keep], sA);"),
}


def build_fx_lanes(out: Path, mutation: str | None = None) -> ctypes.CDLL:
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("needs g++ to compile the lane functions for the CPU")
    inc = CSRC
    if mutation is not None:
        inc = out / "csrc"
        shutil.copytree(CSRC, inc)
        name, old, new = MUTATIONS_FX[mutation]
        text = (inc / name).read_text()
        assert text.count(old) == 1, f"{mutation}: the line to mutate is not in {name}"
        (inc / name).write_text(text.replace(old, new))
    (out / "lanes_fx.cpp").write_text(WRAPPER_FX)
    r = subprocess.run([gxx, "-x", "c++", "-std=c++17", "-O1", "-ffp-contract=off", "-shared",
                        "-fPIC", f"-I{inc}", str(out / "lanes_fx.cpp"), "-o",
                        str(out / "lanes_fx.so")], capture_output=True, text=True, timeout=600)
    assert r.returncode == 0, r.stderr
    return ctypes.CDLL(str(out / "lanes_fx.so"))


@pytest.fixture(scope="module")
def lib_fx(tmp_path_factory):
    return build_fx_lanes(tmp_path_factory.mktemp("lanes_fx"))


def lane_fx_sns(lib, idx: np.ndarray, n_bands: int = 64):
    idx = _c(idx, np.int32)
    L = idx.shape[0]
    scf, scf_e = np.zeros((L, n_bands), np.int64), np.zeros((L, n_bands), np.int64)
    lib.rehearse_fx_sns_dec(ptr(idx), ptr(K.fx_sns_table_pack()), n_bands, L, ptr(scf),
                            ptr(scf_e))
    return scf, scf_e


def fx_spec_args(cfg, d: dict) -> tuple:
    """The arguments of fixed_dev.spectrum_decode for the rows d of
    C.fx_spec_rows (the SNS indices decoded by the plain version)."""
    from audio_codec_torch.ops import fixed_dev
    scf, scf_e = fixed_dev.sns_decode_plain(torch.from_numpy(d["scf_idx"]), cfg.bands_number)
    return (cfg, *(torch.from_numpy(d[k]) for k in C.FX_SPEC_ORDER), scf, scf_e)


def lane_fx_spec(lib, args):
    cfg, x, res, n_res, seed, zf, fac, bw, gg, tidx, order, scf, scf_e = args
    L = x.shape[0]
    side = _c(torch.stack([n_res, seed, zf, fac, bw, gg, order[:, 0], order[:, 1]], 1).numpy(),
              np.int32)
    geom = np.array([cfg.yLen, cfg.frame_length, cfg.bands_number, cfg.frame_dms,
                     cfg.quantizedGainOff, res.shape[1]], np.int32)
    out, x_e = np.zeros((L, cfg.frame_length), np.int64), np.zeros(L, np.int64)
    tab = K.fx_spec_table_pack(cfg.yLen, cfg.fs_idx, cfg.frame_dms, cfg.hrmode)
    lib.rehearse_fx_spec_decode(ptr(_c(x.numpy(), np.int32)), ptr(_c(res.numpy(), np.int32)),
                                ptr(side), ptr(_c(tidx.reshape(L, 16).numpy(), np.int32)),
                                ptr(_c(scf.numpy(), np.int64)), ptr(_c(scf_e.numpy(), np.int64)),
                                ptr(tab), ptr(geom), L, ptr(out), ptr(x_e))
    return out, x_e


def lane_fx_dct4(lib, y: np.ndarray, y_e: np.ndarray):
    y, y_e = _c(y, np.int64), _c(y_e, np.int64)
    L = y.shape[0]
    ytda, ye, ys = np.zeros_like(y), np.zeros(L, np.int64), np.zeros(L, np.int64)
    zero = np.zeros(L, np.bool_)
    lib.rehearse_fx_dct4(ptr(y), ptr(y_e), ptr(K.fx_dct4_table_pack()), L, ptr(ytda), ptr(ye),
                         ptr(ys), ptr(zero))
    return ytda, ye, ys, zero


def fx_ola_run(lib, plan: dict):
    """Every frame of the plan through the lane functions and through the
    plain version, each from its own state. Returns (frames that differ,
    pattern histogram, mismatch count)."""
    from audio_codec_torch.fixed_decoder_dev import DeviceFixedDecoder
    from audio_codec_torch.ops import fixed_ltpf_dev
    T_, B = plan["y_e"].shape
    dec = DeviceFixedDecoder(PCFG_FLAG, B, device="cpu")
    st_p = dec.state
    st_l = {k: st_p[k].numpy().copy() for k in K.FX_STATE_KEYS}
    geom = np.array(K.fx_ola_geometry(PCFG_FLAG, dec.sfi), np.int32)
    tab = K.fx_ola_table_pack(PCFG_FLAG.frame_length, PCFG_FLAG.fs_idx)
    hist, bad = np.zeros(5, np.int64), 0
    for t in range(T_):
        f = {k: torch.from_numpy(np.ascontiguousarray(plan[k][t]))
             for k in ("ytda", "y_e", "y_s", "zero", "lp")}
        hist += torch.bincount(fixed_ltpf_dev.ltpf_patterns(st_p, f["lp"], PCFG_FLAG.fs_idx),
                               minlength=5).numpy()
        ref = fixed_ltpf_dev.ola_ltpf_plain(PCFG_FLAG, st_p, f["ytda"], f["y_e"], f["y_s"],
                                            f["zero"], f["lp"], dec.sfi)
        pcm = np.zeros((B, PCFG_FLAG.frame_length), np.int16)
        arrs = [st_l[k] for k in K.FX_STATE_KEYS]
        pp = (ctypes.c_void_p * len(arrs))(*[a.ctypes.data for a in arrs])
        lib.rehearse_fx_ola_ltpf(*(ptr(_c(plan[k][t], dt)) for k, dt in (
            ("ytda", np.int64), ("y_e", np.int64), ("y_s", np.int64), ("zero", np.bool_),
            ("lp", np.int32))), ptr(tab), pp, ptr(geom), B, ptr(pcm))
        bad += C.count_differing(pcm, ref.numpy())
        bad += sum(C.count_differing(st_l[k], st_p[k].numpy()) for k in K.FX_STATE_KEYS)
    return bad, hist


def test_fx_table_layouts_match_headers(lib_fx):
    assert len(K.fx_sns_table_pack()) == lib_fx.fx_sns_table_words() == K.FX_SNS_TABLE_WORDS
    assert len(K.fx_dct4_table_pack()) == lib_fx.fx_dct4_table_words() == K.FX_DCT4_TABLE_WORDS


def test_fx_sns_dec_lane_matches_plain(lib_fx):
    """Every submode, both leading signs, and indices past their sets."""
    from audio_codec_torch.ops import fixed_dev
    idx = C.fx_sns_rows()
    got = lane_fx_sns(lib_fx, idx)
    ref = fixed_dev.sns_decode_plain(torch.from_numpy(idx), 64)
    assert C.count_differing(got, ref) == 0
    _, ber = fixed_dev.sns_decode_scf(torch.from_numpy(idx))
    assert int(ber.sum()) == 10 and set(idx[:, 2].tolist()) == {0, 1, 2, 3}


def test_fx_spec_decode_lane_matches_plain(lib_fx):
    """Silent, full-scale, zero-frame and order-8 rows, every bandwidth."""
    from audio_codec_torch.ops import fixed_dev
    args = fx_spec_args(PCFG_FLAG, C.fx_spec_rows(PCFG_FLAG))
    assert C.count_differing(lane_fx_spec(lib_fx, args), fixed_dev.spectrum_decode_plain(*args)) == 0


def test_fx_dct4_lane_matches_plain(lib_fx):
    from audio_codec_torch.ops import fixed_dev
    y, y_e = C.fx_dct4_rows()
    got = lane_fx_dct4(lib_fx, y, y_e)
    ref = fixed_dev.batch_dct4_plain(torch.from_numpy(y), torch.from_numpy(y_e), 480)
    assert C.count_differing(got, ref) == 0
    assert bool(ref[3][0]) and int(ref[1][0]) == 0       # the all-zero row


def test_fx_ola_ltpf_lane_matches_plain(lib_fx):
    """Every stream through passthrough, pat2, pat3, pat4 and pat1."""
    bad, hist = fx_ola_run(lib_fx, C.fx_ola_plan())
    assert bad == 0
    assert bool((hist > 0).all()), hist.tolist()


@pytest.mark.parametrize("B", [1, 6])
def test_tns_synthesis_lane_matches_plain_on_the_cpus_contraction(lib_fx, card_order, B):
    """The repaired lattice: the plain version in the card's order (which is
    now the CPU's contraction for every tap) against the lane, order-8
    filters in both ranges and random orders; B = 1 contracts the first
    product too."""
    rng = np.random.default_rng(B)
    N = 400
    x = (rng.standard_normal((B, N)) * 10 ** rng.uniform(-2, 4, (B, 1))).astype(np.float32)
    rc = T_tns_pts()[rng.integers(2, 15, (B, 2, 8))]
    order = rng.integers(0, 9, (B, 2)).astype(np.int32)
    order[0] = 8
    lo = np.tile(np.array([[12, 200]], np.int32), (B, 1))
    hi = np.tile(np.array([[199, N - 1]], np.int32), (B, 1))
    from audio_codec_torch.ops import tns
    ref = tns.tns_synthesis_lattice_plain(*(torch.from_numpy(a) for a in (x, rc, order, lo, hi)))
    got = x.copy()
    lib_fx.rehearse_tns_synthesis(ptr(got), ptr(_c(rc, np.float32)), ptr(order), ptr(lo), ptr(hi),
                                  B, N)
    assert C.count_differing(got, ref.numpy()) == 0


def T_tns_pts() -> np.ndarray:
    from audio_codec_torch import tables
    return tables.t("quants_pts_tns").astype(np.float32)


@pytest.mark.parametrize("mutation", list(MUTATIONS_FX))
def test_rehearsal_catches_mutated_fx_lanes(tmp_path, mutation):
    """A copy of the fixed-point lanes with one rounding, saturation or
    shift clamp removed must disagree with the plain versions."""
    from audio_codec_torch.ops import fixed_dev
    lib = build_fx_lanes(tmp_path, mutation)
    idx = C.fx_sns_rows()
    args = fx_spec_args(PCFG_FLAG, C.fx_spec_rows(PCFG_FLAG))
    y, y_e = C.fx_dct4_rows()
    bad = {"fx_sns_dec": C.count_differing(lane_fx_sns(lib, idx), fixed_dev.sns_decode_plain(
               torch.from_numpy(idx), 64)),
           "fx_spec_decode": C.count_differing(lane_fx_spec(lib, args),
                                               fixed_dev.spectrum_decode_plain(*args)),
           "fx_dct4": C.count_differing(lane_fx_dct4(lib, y, y_e), fixed_dev.batch_dct4_plain(
               torch.from_numpy(y), torch.from_numpy(y_e), 480)),
           "fx_ola_ltpf": fx_ola_run(lib, C.fx_ola_plan())[0]}
    assert sum(bad.values()) > 0, f"the rehearsal did not see the mutation {mutation}: {bad}"


# ---- slice 9: the standard concealment (plc_main) ----

WRAPPER_PLC0 = r"""
#include "plc_main.cuh"
using namespace acx;

extern "C" {
void rehearse_plc_main(const float* spec, const float* q, const int* bfi, const int* nb,
                       const float* cum, const int* seed, const int* lcg, int B, int N,
                       float* spec_out, float* q_out, int* nb_out, float* cum_out,
                       int* seed_out) {
  for (int b = 0; b < B; ++b) {
    const PlcMainScalars s = plc_main_scalars(bfi[b], nb[b], cum[b], seed[b], lcg, N);
    nb_out[b] = s.nb_lost;
    cum_out[b] = s.cum;
    seed_out[b] = s.seed;
    for (int k = 0; k < N; ++k)
      plc_main_bin(s, k, spec[b * N + k], q[b * N + k], lcg, N, spec_out + b * N + k,
                   q_out + b * N + k);
  }
}
}
"""

MUTATIONS_PLC0 = {
    # the damping of 0.85 a frame later
    "alpha_late": ("plc_main.cuh", "(s.nb_lost < 8 ? 0.9f : 0.85f)", "(s.nb_lost <= 8 ? 0.9f : 0.85f)"),
}


def build_plc0_lanes(out: Path, mutation: str | None = None) -> ctypes.CDLL:
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("needs g++ to compile the lane functions for the CPU")
    inc = CSRC
    if mutation is not None:
        inc = out / "csrc"
        shutil.copytree(CSRC, inc)
        name, old, new = MUTATIONS_PLC0[mutation]
        text = (inc / name).read_text()
        assert text.count(old) == 1, f"{mutation}: the line to mutate is not in {name}"
        (inc / name).write_text(text.replace(old, new))
    (out / "lanes_plc0.cpp").write_text(WRAPPER_PLC0)
    r = subprocess.run([gxx, "-x", "c++", "-std=c++17", "-O1", "-ffp-contract=off", "-shared",
                        "-fPIC", f"-I{inc}", str(out / "lanes_plc0.cpp"), "-o",
                        str(out / "lanes_plc0.so")], capture_output=True, text=True, timeout=600)
    assert r.returncode == 0, r.stderr
    return ctypes.CDLL(str(out / "lanes_plc0.so"))


def plc0_differing(lib, seed: int) -> int:
    """plc_main's lane function against plc_main_plain on the rows of every
    damping branch, the generator's edge seeds and bfi 0, 1 and 2."""
    from audio_codec_torch import kernels
    from audio_codec_torch.ops import plc
    d = C.plc_main_rows(seed)
    B, N = d["spec"].shape
    lcg = _c(kernels._plc_lcg(N), np.int32)
    spec, q = np.zeros((B, N), np.float32), np.zeros((B, N), np.float32)
    nb, sd = np.zeros(B, np.int32), np.zeros(B, np.int32)
    cum = np.zeros(B, np.float32)
    lib.rehearse_plc_main(*(ptr(_c(d[k], np.float32 if k in ("spec", "q_d_prev", "cum_alpha")
                                     else np.int32)) for k in C.PLC_MAIN_ORDER),
                          ptr(lcg), B, N, ptr(spec), ptr(q), ptr(nb), ptr(cum), ptr(sd))
    ref = plc.plc_main_plain(PCFG_FLAG, *(torch.from_numpy(d[k]) for k in C.PLC_MAIN_ORDER))
    return C.count_differing((spec, q, nb, cum, sd), ref)


@pytest.mark.parametrize("seed", [0, 1])
def test_plc_main_lane_matches_plain(tmp_path, seed):
    assert plc0_differing(build_plc0_lanes(tmp_path), seed) == 0


@pytest.mark.parametrize("mutation", list(MUTATIONS_PLC0))
def test_rehearsal_catches_mutated_plc_main_lane(tmp_path, mutation):
    lib = build_plc0_lanes(tmp_path, mutation)
    assert sum(plc0_differing(lib, s) for s in (0, 1)) > 0, mutation
