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
well as for the card (the open-loop pitch search (csrc/olpa.cuh), the LTPF
parameter coder (csrc/ltpf_encode.cuh), the TNS filter analysis,
the SNS quantizer's encoder (csrc/sns_vq_enc.cuh) and decoder
(csrc/sns_vq.cuh), the noise factor and residual coder and the decoder's
spectrum reconstruction (csrc/spec_decode.cuh) are templates over the warp,
here the host warp of csrc/warp.cuh). Here g++ builds them (with
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

# the SNS quantizer's encoder warp on the host warp (inside extern "C"), and
# the noise factor and residual coder's (at file scope); shared with
# tests/test_torch_sns_nf_rehearsal.py
SNS_ENC_REHEARSE = r"""
// the encoder's warp design (sns_vq_enc.cuh) on the host warp, a stream at
// a time, its scratch filled with a byte pattern before each stream
static SnsEncTables enc_tables(const int* tables, float* d2t) {
  const SnsTables st = sns_tables(tables);
  for (int i = 0; i < kSnsM * kSnsM; ++i) d2t[i] = st.f[kOffD2 + (i % kSnsM) * kSnsM + i / kSnsM];
  return {st.f, st.A, d2t};
}
void rehearse_sns_enc(const float* scf, const int* tables, int* idx, float* q, int B) {
  float d2t[kSnsM * kSnsM];
  const SnsEncTables t = enc_tables(tables, d2t);
  SnsEncScratch S;
  for (int b = 0; b < B; ++b) {
    std::memset(&S, 0x5A, sizeof S);
    sns_vq_enc_warp(CoderHostWarp{}, scf + 16 * b, t, S, idx + 7 * b, q + 16 * b);
  }
}
"""
NRE_REHEARSE = r"""
// the noise factor and residual coder's warp (noise_residual_enc.cuh) on the
// host warp, NC = ceil(N / 32), its shared values filled with a byte pattern
// before each stream
template <int NC>
static void nre_rows(const float* x, const int* xq, const float* gain, const int* bw,
                     const int* target, const int* nbits2, const int* lsb, int B,
                     const NfEncGeom& g, int* fac, int* res, int* n_res) {
  alignas(16) float vz[kNfScratch];
  for (int b = 0; b < B; ++b) {
    std::memset(vz, 0x5A, sizeof vz);   // what the warp before left
    noise_residual_enc_warp<NC>(CoderHostWarp{}, x + g.N * b, xq + g.N * b, gain[b], bw[b],
                                target[b], nbits2[b], lsb[b], g, vz, fac + b,
                                res + g.max_res * b, n_res + b);
  }
}

extern "C" void rehearse_nre(const float* x, const int* xq, const float* gain, const int* bw,
                  const int* target, const int* nbits2, const int* lsb, int B, int N, int width,
                  int start, int half, int max_res, int* fac, int* res, int* n_res) {
  const NfEncGeom g = {N, width, start, half, max_res};
  switch ((N + 31) / 32) {
#define NRE_CASE(c) \
  case c: nre_rows<c>(x, xq, gain, bw, target, nbits2, lsb, B, g, fac, res, n_res); break;
    NRE_CASE(1) NRE_CASE(2) NRE_CASE(3) NRE_CASE(4) NRE_CASE(5) NRE_CASE(6) NRE_CASE(7)
    NRE_CASE(8) NRE_CASE(9) NRE_CASE(10) NRE_CASE(11) NRE_CASE(12)
#undef NRE_CASE
    default: nre_rows<13>(x, xq, gain, bw, target, nbits2, lsb, B, g, fac, res, n_res);
  }
}
"""

# the decoder's two warps on the host warp, a stream at a time, their
# outputs filled with a byte pattern before each stream (at file scope);
# shared with tests/test_torch_dec_rehearsal.py
SNS_DEC_REHEARSE = r"""
extern "C" void rehearse_sns_dec(const int* idx, const int* tables, float* q, int B) {
  std::memset(q, 0x5A, sizeof(float) * 16 * B);
  for (int b = 0; b < B; ++b) sns_vq_dec_warp(CoderHostWarp{}, idx + 7 * b, tables, q + 16 * b);
}
"""
SPEC_DEC_REHEARSE = r"""
// ints [11][B]: bfi rframe inv bw_idx fac_ns res_present n_res seed zero prev_bw nb_lost;
// floats [3][B]: gain prev_gg prev_fac_ns (the layout of spec_decode.cu)
template <int NC>
static void spec_rows(const float* x, const int* ints, const float* floats, const int* res_bits,
                      const float* qr, const float* qd, const int* bins, int B,
                      const SpecGeom& g, float* x_out, float* q_out, float* pgg, int* pbw,
                      float* pfac, int* nbl) {
  const int N = g.N;
  std::memset(x_out, 0x5A, sizeof(float) * N * B);   // a value no path writes
  std::memset(q_out, 0x5A, sizeof(float) * N * B);
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
    const SpecHistory h = spec_decode_warp<NC>(CoderHostWarp{}, x + N * b, qr + N * b,
                                               qd + N * b, res_bits + g.res_width * b, s, bins,
                                               g, x_out + N * b, q_out + N * b);
    pgg[b] = h.prev_gg;
    pbw[b] = h.prev_bw_idx;
    pfac[b] = h.prev_fac_ns;
    nbl[b] = h.nb_lost;
  }
}

extern "C" void rehearse_spec(const float* x, const int* ints, const float* floats,
                              const int* res_bits, const float* qr, const float* qd,
                              const int* bins, int B, int N, int width,
                              int start, int res_width, float* x_out, float* q_out, float* pgg,
                              int* pbw, float* pfac, int* nbl) {
  const SpecGeom g = {N, width, start, res_width};
  switch ((N + 31) / 32) {
#define SPEC_CASE(c) \
  case c: spec_rows<c>(x, ints, floats, res_bits, qr, qd, bins, B, g, x_out, q_out, pgg, pbw, \
                       pfac, nbl); break;
    SPEC_CASE(1) SPEC_CASE(2) SPEC_CASE(3) SPEC_CASE(4) SPEC_CASE(5) SPEC_CASE(6) SPEC_CASE(7)
    SPEC_CASE(8) SPEC_CASE(9) SPEC_CASE(10) SPEC_CASE(11) SPEC_CASE(12)
#undef SPEC_CASE
    default: spec_rows<13>(x, ints, floats, res_bits, qr, qd, bins, B, g, x_out, q_out, pgg,
                           pbw, pfac, nbl);
  }
}
"""

# the LTPF parameter coder's warp on the host warp (at file scope), shared
# with tests/test_torch_pitch_side_rehearsal.py: the warp's shared memory
# and the stream's outputs are filled with a byte pattern before each stream;
# mem_stride is the distance between the memory rows (the memory's 16-byte
# loads are taken where a row is aligned)
LTPF_REHEARSE = r"""
extern "C" void rehearse_ltpf(const float* s, const int* pol, const float* ncol,
                              const float* mem_in, const float* mnc, const float* mmnc,
                              const int* on, const float* mpitch, const float* tab, int B,
                              int xlen, int N, int mem_len, int acflen, int xbase, int frame_dms,
                              int enable, int* param, int* bits, float* new_mem, float* nc,
                              float* mm, int* on_out, float* pitch, int mem_stride) {
  const LtpfGeom g = {xlen, N, mem_len, acflen, xbase, frame_dms, enable};
  static LtpfScratch S;
  for (int b = 0; b < B; ++b) {
    std::memset(&S, 0x5A, sizeof S);
    std::memset(new_mem + mem_len * b, 0x5A, sizeof(float) * mem_len);
    std::memset(param + 3 * b, 0x5A, 3 * sizeof(int));
    const LtpfStream st = {s + xlen * b, mem_in + mem_stride * b, pol[b], ncol[b], mnc[b], mmnc[b],
                           on[b], mpitch[b]};
    const LtpfOut o = acflen == 128
        ? ltpf_encode_warp<128>(CoderHostWarp{}, st, tab, g, S, new_mem + mem_len * b)
        : ltpf_encode_warp<64>(CoderHostWarp{}, st, tab, g, S, new_mem + mem_len * b);
    for (int k = 0; k < 3; ++k) param[3 * b + k] = o.param[k];
    bits[b] = o.bits;
    nc[b] = o.nc;
    mm[b] = o.mem_mem_nc;
    on_out[b] = o.on;
    pitch[b] = o.pitch;
  }
}
"""

WRAPPER = r"""
#include "side_info.cuh"
#include "sns_vq_enc.cuh"
#include <cstring>
using namespace acx;

static SideLayout layout(const int* L) { return {L[0], L[1], L[2], L[3], L[4], L[5], L[6]}; }
""" + SNS_DEC_REHEARSE + r"""

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
""" + SNS_ENC_REHEARSE + r"""
// shape 0..3: the four searches of the encoder (lanes, pulses), each a group
// of the warp's search; every group gets the same target
void rehearse_pvq_search(const float* x, int shape, int* ys, float* en, int B) {
  SnsEncScratch S;
  for (int b = 0; b < B; ++b) {
    std::memset(&S, 0x5A, sizeof S);
    for (int g = 0; g < kPvqGroups; ++g)
      for (int i = 0; i < 16; ++i) S.x[g][i] = x[16 * b + i];
    sns_pvq_search_warp(CoderHostWarp{}, S);
    for (int i = 0; i < 16; ++i) {
      ys[16 * b + i] = S.ys[shape][i];
      en[16 * b + i] = S.en[shape][i];
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

# the TNS filter analysis of B streams on the host warp, each row staged as
# the kernel stages it (the bins from tns_row_bins on NaN, so that a read
# past them shows); gains [B][2] the prediction gains
TNS_REHEARSE = r"""
void rehearse_tns(const float* x, const int* bw, const int* tab, int B, int N, int startfreq0,
                  int nf_max, int max_order, float max_pg, float inv_nsub, float c_alpha,
                  float inv_span, int* order, int* rc_idx, float* rc_q, int* nf, int* bits,
                  float* gains) {
  const TnsGeom g = {N, startfreq0, nf_max, max_pg, inv_nsub, c_alpha, inv_span};
  float row[2048];
  for (int b = 0; b < B; ++b) {
    const int n = tns_row_bins(bw[b], tab, g);
    for (int i = 0; i < N; ++i) row[i] = i < n ? x[static_cast<size_t>(N) * b + i] : NAN;
    if (max_order == 8)
      tns_filter_analysis_warp<8, 3>(CoderHostWarp{}, row, bw[b], tab, g, order + 2 * b,
                                     rc_idx + 16 * b, rc_q + 16 * b, nf + b, bits + b,
                                     gains + 2 * b);
    else
      tns_filter_analysis_warp<4, 2>(CoderHostWarp{}, row, bw[b], tab, g, order + 2 * b,
                                     rc_idx + 16 * b, rc_q + 16 * b, nf + b, bits + b,
                                     gains + 2 * b);
  }
}
"""

WRAPPER4 = r"""
#include "tns_analysis.cuh"
#include "pc_classify.cuh"
#include "dct4.cuh"
using namespace acx;

extern "C" {
""" + TNS_REHEARSE + r"""
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
  for (int b0 = 0; b0 < B; b0 += 32) pc_classify_warp(CoderHostWarp{}, p, b0, stage);
}
// the warp's peak detector on rows of sig, the mean energy its chain
void rehearse_peak(const float* sig, int* out, int B, int N, float inv_n) {
  for (int b = 0; b < B; ++b) {
    float sum = 0.0f;
    for (int i = 0; i < N; ++i) sum = radd(sum, rmul(sig[N * b + i], sig[N * b + i]));
    const float mean_nrg = rmul(rmul(sum, inv_n), static_cast<float>(kPcBlock * kPcThr1));
    out[b] = pc_detect_warp(CoderHostWarp{}, sig + N * b, N, mean_nrg);
  }
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
void rehearse_mdct_compensated(const float* x, const float* mem, const float* win,
                               const float* Mt, float* d, int B, int N, int la) {
  float folded[kDctMaxN];
  for (int b = 0; b < B; ++b) {
    for (int k = 0; k < N; ++k)
      folded[k] = mdct_fold(x + N * b, mem + (N - la) * b, win, N, la, k, true);
    for (int n = 0; n < N; ++n) d[N * b + n] = dct4_out_compensated(folded, Mt, N, n);
  }
}
// the IMDCT's chain step (xfma_d, the double it keeps) and xfma on the
// same triples
void rehearse_xfma_step(const float* a, const float* b, const float* p, double* step,
                        double* ref, int n) {
  for (int i = 0; i < n; ++i) {
    step[i] = xfma_d(a[i], b[i], p[i]);
    ref[i] = xfma(a[i], b[i], p[i]);
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
// the compensated product's term: compensated_step_fast where the row value
// is in range, against compensated_step with the Veltkamp halves
void rehearse_compensated_step(const float* a, const float* b, const float* s, const float* comp,
                               float* fast, float* ref, int* in_range, int n) {
  for (int i = 0; i < n; ++i) {
    float ah, al, bh, bl;
    veltkamp(a[i], ah, al);
    veltkamp(b[i], bh, bl);
    float s1 = s[i], c1 = comp[i], s2 = s[i], c2 = comp[i];
    compensated_step(a[i], ah, al, b[i], bh, bl, s1, c1);
    compensated_step_fast(a[i], b[i], static_cast<double>(a[i]), static_cast<double>(b[i]), s2, c2);
    ref[2 * i] = s1, ref[2 * i + 1] = c1;
    fast[2 * i] = s2, fast[2 * i + 1] = c2;
    in_range[i] = compensated_fast_input(a[i]);
  }
}
int tns_table_words() { return kTnsTableWords; }
}
"""

# mutations of the lane functions that the rehearsal must catch
MUTATIONS = {
    "locmax_strict": ("pc_classify.cuh", "b1 >= b0 && b1 >= b2 && cent", "b1 > b0 && b1 >= b2 && cent"),
    "levinson_fma": ("tns_analysis.cuh", "radd(rmul(-g, a[t - j]), a[j - 1])",
                     "fmaf(-g, a[t - j], a[j - 1])"),
    "hysteresis_factor": ("pc_classify.cuh", "rmul(0.3f, pm)", "rmul(0.25f, pm)"),
}


# mutations of the IMDCT's chain step (dct4.cuh:round_float_near) that the
# rehearsal must catch: M a power of two too small (the sum rounds to 25
# bits), and -0 let through the trick (it comes out +0)
MUTATIONS_DCT4 = {
    "round_m_28": ("dct4.cuh", "(29u << 20)", "(28u << 20)"),
    "zero_guard": ("dct4.cuh", "(e < kFloatExpLo && hi != 0u)", "(e < kFloatExpLo && e != 0u)"),
}


# mutations of the compensated product's fast step (dct4.cuh) that the
# rehearsal must catch: its range one exponent wider at the top (the split
# overflows just below 2^116), and the Dekker term as a rounded product
# instead of one fused multiply-add
MUTATIONS_COMP = {
    "range_wider": ("dct4.cuh", "242u << 23;", "243u << 23;"),
    "err_rmul": ("dct4.cuh", "const float err = rfmaf(a, b, -p);",
                 "const float err = rsub(rmul(a, b), p);"),
}


def build_lanes(out: Path, mutation: str | None = None) -> ctypes.CDLL:
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("needs g++ to compile the lane functions for the CPU")
    inc = CSRC
    if mutation is not None:
        inc = out / "csrc"
        shutil.copytree(CSRC, inc)
        name, old, new = {**MUTATIONS, **MUTATIONS_DCT4, **MUTATIONS_COMP}[mutation]
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
    """The warp function of tns_filter_analysis on the host warp: (order,
    rc_idx, rc_q, numfilters, bits) and the prediction gains [B, 2]."""
    from audio_codec_torch.ops import tns
    _, startfreq0, nf_max, max_order, n_sub, max_pg, _ = tns._tns_geometry(cfg)
    B, N = x.shape
    order = np.zeros((B, 2), np.int32)
    idx = np.zeros((B, 2, 8), np.int32)
    q = np.zeros((B, 2, 8), np.float32)
    nf = np.zeros(B, np.int32)
    bits = np.zeros(B, np.int32)
    gains = np.zeros((B, 2), np.float32)
    tab = K._tns_tables("cpu", cfg.frame_dms, max_pg == 1.5).numpy()
    inv_span = 1.0 / (max_pg - 1.5) if max_pg > 1.5 else 0.0
    lib.rehearse_tns(ptr(np.ascontiguousarray(x, np.float32)), ptr(np.ascontiguousarray(bw, np.int32)),
                     ptr(tab), B, N, startfreq0, nf_max, max_order, f32p(max_pg),
                     f32p(1.0 / n_sub), f32p(0.85 - 1.0), f32p(inv_span), ptr(order), ptr(idx),
                     ptr(q), ptr(nf), ptr(bits), ptr(gains))
    return (order, idx, q, nf, bits), gains


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
    got, got_gains = lane_tns(lib4, cfg, x, bw)
    for g, r in zip(got, ref, strict=True):
        same_bits(g, r.numpy())
    same_bits(got_gains, gains.numpy())
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
    ref, gains = tns._analyze(C_CFG48, torch.from_numpy(r[0]), torch.from_numpy(r[1]))
    got, got_gains = lane_tns(lib4, C_CFG48, *r)
    for g, e in zip(got, ref, strict=True):
        same_bits(g, e.numpy())
    same_bits(got_gains, gains.numpy())


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
    return C.pc_fused_rows(d, r, seed=5)


def lane_pc(lib, cfg, a: dict) -> tuple[np.ndarray, np.ndarray]:
    """The classifier's warp function with the stability factor on the host
    warp: (bfi', stab_fac)."""
    B, N = a["q_old_d"].shape
    out, stab = np.zeros(B, np.int32), np.zeros(B, np.float32)
    lib.rehearse_pc(*(ptr(a[k]) for k in C.PC_FUSED_ORDER), B, N, cfg.frame_dms,
                    f32p(1.0 / N), ptr(out), ptr(stab))
    return out, stab


def plain_pc(cfg, a: dict) -> list[np.ndarray]:
    from audio_codec_torch.ops import pc
    return [t.numpy() for t in pc.pc_classify_plain(
        cfg, *(torch.from_numpy(a[k]) for k in C.PC_FUSED_ORDER))]


def test_pc_classify_lane_matches_plain(lib4, card_order):
    from audio_codec_torch.ops import pc
    a = pc_case_rows()
    ref_bfi, ref_stab = plain_pc(C_CFG48, a)
    got_bfi, got_stab = lane_pc(lib4, C_CFG48, a)
    same_bits(got_bfi, ref_bfi)
    same_bits(got_stab, ref_stab)
    branches = C.pc_branches({**a, "stab_fac": ref_stab}, ref_bfi)
    assert all(v > 0 for v in branches.values()), branches
    sig = a["q_old_d"]
    xo = np.zeros(sig.shape[0], np.int32)
    lib4.rehearse_peak(ptr(sig), ptr(xo), sig.shape[0], sig.shape[1], f32p(1.0 / sig.shape[1]))
    same_bits(xo, pc._peak_detector(torch.from_numpy(sig)).numpy())


def xfma_triples(n: int = 1_000_000, seed: int = 0) -> dict[str, tuple[np.ndarray, ...]]:
    """(a, b, p) float32 triples for the IMDCT's chain step, by kind: seeded
    triples over the float exponents; triples whose exact double sum lies on
    a float midpoint, with the lower neighbour's last bit even and odd, and
    ones whose exact sum lies just below a midpoint, which the double sum
    rounds onto it; signed zeros; sums near 2^-126 and subnormal; sums near
    the float maximum and past it."""
    rng = np.random.default_rng(seed)
    f = np.float32
    sgn = lambda k: rng.choice([-1.0, 1.0], k)
    rand = lambda k, lo, hi: (sgn(k) * 2.0 ** rng.uniform(lo, hi, k)).astype(f)
    out = {"seeded": (rand(n, -60, 60), rand(n, -60, 60), rand(n, -100, 100))}
    k = 4096
    E = rng.integers(-100, 100, k)
    m = rng.integers(2 ** 23, 2 ** 24, k)
    m[: k // 2] &= ~1          # lower neighbour even, then odd
    m[k // 2:] |= 1
    s = sgn(k)
    p = (s * m * 2.0 ** (E - 23)).astype(f)
    odd = (2 * rng.integers(0, 64, k) + 1).astype(f)
    half = (s * 2.0 ** (E - 24)).astype(f)          # odd * half an ulp of p
    below_a = np.full(k, 1 + 2.0 ** -23, f)          # (1 + 2^-23)(1 - 2^-23) half ulps
    below_b = (s * (1 - 2.0 ** -23) * 2.0 ** (E - 24)).astype(f)
    out["midpoint"] = (np.concatenate([odd, below_a]), np.concatenate([half, below_b]),
                       np.concatenate([p, p]))
    z = np.array([0.0, -0.0], f)
    za, zb, zp = (v.ravel() for v in np.meshgrid(np.r_[z, f(1.5), f(-2.0)], np.r_[z, f(3.0)], z))
    # a product cancelling p exactly (+0), and -0 from the products of zeros
    out["zeros"] = (np.r_[za, f(2.0), f(-2.0)], np.r_[zb, f(3.0), f(3.0)],
                    np.r_[zp, f(-6.0), f(6.0)])
    tiny = 2.0 ** rng.uniform(-150, -120, k)
    out["near 2^-126"] = ((sgn(k) * tiny).astype(f), np.ones(k, f),
                          (sgn(k) * 2.0 ** rng.uniform(-150, -124, k)).astype(f))
    big = np.finfo(f).max
    out["near the float maximum"] = (
        (sgn(k) * big * rng.uniform(0.25, 1.0, k)).astype(f), rng.uniform(0.5, 2.0, k).astype(f),
        (sgn(k) * big * rng.uniform(0.0, 1.0, k)).astype(f))
    return out


def xfma_numpy(a, b, p) -> np.ndarray:
    """xfma as its definition: the double product, one double add, rounded
    to float."""
    return (a.astype(np.float64) * b.astype(np.float64) + p.astype(np.float64)).astype(np.float32)


def xfma_step_differing(lib) -> dict[str, int]:
    """Per kind of triple: values where the double that the lane's xfma_d
    keeps differs, as bits, from xfma's float (and xfma from its definition
    in numpy). Two NaNs count as equal."""
    bad = {}
    with np.errstate(over="ignore"):
        for kind, (a, b, p) in xfma_triples().items():
            step, ref = np.zeros(a.size), np.zeros(a.size)
            lib.rehearse_xfma_step(ptr(a), ptr(b), ptr(p), ptr(step), ptr(ref), a.size)
            nan = np.isnan(step) & np.isnan(ref)
            bad[kind] = (int(((step.view(np.int64) != ref.view(np.int64)) & ~nan).sum()) +
                         C.count_differing(ref.astype(np.float32), xfma_numpy(a, b, p)))
    return bad


def test_xfma_triples_reach_midpoints_in_both_parities():
    """The midpoint triples' exact double sums lie halfway between two
    floats whose lower neighbour's last bit is even in some and odd in
    others; the others round onto a midpoint only in double."""
    a, b, p = (v.astype(np.float64) for v in xfma_triples(n=1)["midpoint"])
    x = a * b + p
    lo = x.astype(np.float32)
    lo = np.where(np.abs(lo.astype(np.float64)) > np.abs(x), np.nextafter(lo, np.float32(0)), lo)
    hi = np.nextafter(lo, np.copysign(np.float32(np.inf), lo))
    on_mid = (lo.astype(np.float64) + hi.astype(np.float64)) / 2 == x
    assert on_mid.all()
    parity = lo.view(np.int32) & 1
    assert (parity == 0).sum() > 1000 and (parity == 1).sum() > 1000


def test_imdct_chain_step_equals_xfma(lib4):
    """dct4.cuh:xfma_d, the IMDCT kernel's step without conversions, equals
    xfma bit for bit on 10^6 seeded triples and on every adversarial kind."""
    bad = xfma_step_differing(lib4)
    assert not any(bad.values()), bad


@pytest.mark.parametrize("mutation", list(MUTATIONS_DCT4))
def test_rehearsal_catches_mutated_chain_step(tmp_path, mutation):
    bad = xfma_step_differing(build_lanes(tmp_path, mutation))
    assert sum(bad.values()) > 0, f"the rehearsal did not see the mutation {mutation}: {bad}"


def compensated_tuples(n: int = 1_000_000, seed: int = 0) -> dict[str, tuple[np.ndarray, ...]]:
    """(a, b, s, comp) float32 tuples for the compensated product's term, by
    kind. b is drawn from the DCT-IV matrices of N = 480, 240, 160 and 80
    (the frames at 10 ms), a over the fast range 2^-89 <= |a| < 2^115, s and
    comp over wide exponents: seeded; the range's edges (its first and last
    floats, and floats just below 2^116, where the split overflows); signed
    zeros of a, s and comp; the matrices' smallest and largest entries; and
    values that must take the split step (about 1e37 and 1e-39, and just
    outside the range)."""
    from audio_codec_torch import tables as TT
    rng = np.random.default_rng(seed)
    f = np.float32
    entries = np.concatenate([TT.dct4_matrix(N).astype(f).ravel() for N in (480, 240, 160, 80)])
    sgn = lambda k: rng.choice([-1.0, 1.0], k)
    rand = lambda k, lo, hi: (sgn(k) * 2.0 ** rng.uniform(lo, hi, k)).astype(f)
    pick = lambda k: rng.choice(entries, k)
    sc = lambda k: (rand(k, -60, 60), rand(k, -60, 60))
    out = {"seeded": (rand(n, -89, 115), pick(n), *sc(n))}
    k = 8192
    lo, hi = f(2.0 ** -89), f(2.0 ** 115)
    edge = np.concatenate([
        np.full(k // 4, lo), np.full(k // 4, np.nextafter(hi, f(0))),
        (2.0 ** 116 * (1.0 - 2.0 ** -rng.integers(1, 24, k // 4))).astype(f),
        (2.0 ** 115 * (1.0 + 2.0 ** -rng.integers(1, 24, k // 4))).astype(f)])
    out["edges"] = ((sgn(k) * edge).astype(f), pick(k), *sc(k))
    z = np.array([0.0, -0.0], f)
    za, zs, zc = (v.ravel() for v in np.meshgrid(z, np.r_[z, f(3.5), f(-1e-20)], np.r_[z, f(2e-9)]))
    m = za.size
    out["signed zeros"] = (np.tile(za, 8), np.repeat(pick(8), m), np.tile(zs, 8), np.tile(zc, 8))
    ext = np.concatenate([entries[np.argsort(np.abs(entries))[:64]],
                          entries[np.argsort(np.abs(entries))[-64:]]])
    out["extreme entries"] = (rand(k, -89, 115), rng.choice(ext, k), *sc(k))
    # the Neumaier tail's edges: products near a fraction of an ulp of s
    # (absorbed, or reaching the neighbour's midpoint through the double's
    # rounding), s on a power of two with a product of the other sign
    sv = rand(k, -40, 40)
    sv[: k // 4] = (np.sign(sv[: k // 4]) * 2.0 ** rng.integers(-40, 40, k // 4)).astype(f)
    bv = pick(k)
    near = np.spacing(np.abs(sv)).astype(np.float64) * 2.0 ** rng.uniform(-4, 1.5, k)
    near[k // 2:] = np.spacing(np.abs(sv[k // 2:])).astype(np.float64) / 2 * (
        1 + sgn(k - k // 2) * 2.0 ** -rng.uniform(18, 30, k - k // 2))
    av = (-np.sign(sv) * sgn(k) ** 0 * near / bv.astype(np.float64)).astype(f)
    av[k // 8: k // 4] = -av[k // 8: k // 4]
    out["tail edges"] = (av, bv, sv, rand(k, -60, 60))
    out["split step"] = (np.concatenate([(sgn(k // 4) * rng.uniform(0.5, 3.0, k // 4) * 1e37),
                                         (sgn(k // 4) * rng.uniform(0.5, 3.0, k // 4) * 1e-39),
                                         np.full(k // 4, np.nextafter(lo, f(0))),
                                         np.full(k // 4, hi)]).astype(f), pick(k), *sc(k))
    return out


def compensated_step_differing(lib) -> tuple[dict[str, int], dict[str, int]]:
    """Per kind of tuple: terms in the fast step's range whose (s, comp)
    differ from compensated_step's (two NaNs count as equal), and terms in
    the range."""
    bad, fast = {}, {}
    with np.errstate(over="ignore"):
        for kind, (a, b, s, c) in compensated_tuples().items():
            got, ref = np.zeros(2 * a.size, np.float32), np.zeros(2 * a.size, np.float32)
            inr = np.zeros(a.size, np.int32)
            lib.rehearse_compensated_step(ptr(a), ptr(b), ptr(s), ptr(c), ptr(got), ptr(ref),
                                          ptr(inr), a.size)
            keep = np.repeat(inr != 0, 2)
            bad[kind] = C.count_differing(got[keep], ref[keep])
            fast[kind] = int(inr.sum())
    return bad, fast


def test_compensated_fast_step_equals_split_step(lib4):
    """dct4.cuh:compensated_step_fast, the compensated MDCT's term without
    the Veltkamp halves (the Dekker term one fused multiply-add), equals
    compensated_step bit for bit on 10^6 seeded tuples and every kind of
    compensated_tuples; the values about 1e37 and 1e-39, and just outside
    the range, are outside compensated_fast_input's range."""
    bad, fast = compensated_step_differing(lib4)
    assert not any(bad.values()), bad
    assert fast["seeded"] == 1_000_000 and fast["signed zeros"] > 0
    assert fast["split step"] == 0
    assert fast["edges"] == 4096      # 2^-89 and the last float below 2^115


@pytest.mark.parametrize("mutation", list(MUTATIONS_COMP))
def test_rehearsal_catches_mutated_compensated_step(tmp_path, mutation):
    bad, _ = compensated_step_differing(build_lanes(tmp_path, mutation))
    assert sum(bad.values()) > 0, f"the rehearsal did not see the mutation {mutation}: {bad}"


@pytest.mark.parametrize("fs,bitrate", [(48000, 64000), (16000, 32000)])
def test_compensated_mdct_lane_matches_plain(lib4, card_order, fs, bitrate):
    """The TDAC's MDCT in the CPU's compensated order (fold with the CPU's
    contraction, Dekker products, Neumaier sums) at N = 480 and 160, on the
    synthetic rows with the extreme ones: the plain version computes it as
    it does for a tensor on a card."""
    from audio_codec_torch.ops import transforms
    cfg = P.Config(fs_in=fs, bitrate=bitrate)
    N, la = cfg.frame_length, cfg.la_zeroes
    x, mem = C.transform_rows(N, la, seed=3, extreme=True)
    win = transforms.window(cfg, "cpu").numpy()
    Mt = transforms.dct4_mt(N, "cpu").numpy()
    d = np.zeros((x.shape[0], N), np.float32)
    lib4.rehearse_mdct_compensated(ptr(x), ptr(mem), ptr(win), ptr(Mt), ptr(d), x.shape[0], N, la)
    ref = transforms.mdct_plain(cfg, torch.from_numpy(x), torch.from_numpy(mem), compensated=True)
    same_bits(d, ref[0].numpy())
    assert np.isfinite(d[:-2]).all() and np.isnan(d[-2:]).all()


@pytest.mark.parametrize("fs,bitrate", [(48000, 64000), (16000, 32000)])
def test_dct4_lanes_match_plain(lib4, card_order, fs, bitrate):
    """The MDCT (fold and DCT-IV) and the IMDCT (DCT-IV, unfold, window and
    overlap-add) at N = 480 and 160 on full-scale, silent and alternating
    rows, rows of negative zeros, subnormal-scale rows and rows near 1e37."""
    from audio_codec_torch.ops import transforms
    cfg = P.Config(fs_in=fs, bitrate=bitrate)
    N, la = cfg.frame_length, cfg.la_zeroes
    x, mem = C.transform_rows(N, la, seed=2, extreme=True)
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
    x, mem = C.transform_rows(N, la, seed=5, extreme=True)
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
        bad = C.count_differing(list(lane_pc(lib, C_CFG48, a)), plain_pc(C_CFG48, a))
    assert bad > 0, f"the rehearsal did not see the mutation {mutation}"



# ---- the pitch analysis, the noise factor and residual coder, the decoder's
# spectrum reconstruction ----

WRAPPER_PITCH = r"""
#include "olpa.cuh"
#include "ltpf_encode.cuh"
#include "noise_residual_enc.cuh"
#include "spec_decode.cuh"
#include <cstring>
using namespace acx;
""" + NRE_REHEARSE + SPEC_DEC_REHEARSE + r"""
extern "C" {
void rehearse_olpa(const float* s, const float* m12, const float* m64, const int* mp,
                   const float* tab, int B, int s_stride, int length, int len2, int mem_in_len,
                   int acflen, int base, int* pitch2, float* nc, int* t0, float* n12, float* n64) {
  const OlpaGeom g = {length, len2, mem_in_len, acflen, base};
  OlpaScratch S;
  for (int b = 0; b < B; ++b) {
    const OlpaStream st = {s + s_stride * b, m12 + 3 * b, m64 + mem_in_len * b, mp[b]};
    const OlpaOut o = acflen == 64
        ? olpa_warp<64>(CoderHostWarp{}, st, tab, g, S, n12 + 3 * b, n64 + mem_in_len * b)
        : olpa_warp<32>(CoderHostWarp{}, st, tab, g, S, n12 + 3 * b, n64 + mem_in_len * b);
    t0[b] = o.t0;
    pitch2[b] = 2 * o.t0;
    nc[b] = o.nc;
  }
}
}
""" + LTPF_REHEARSE

# mutations of the slice's lane functions that the rehearsal must catch, one
# per kernel (the first maximum is shared by olpa and ltpf_encode)
MUTATIONS_PITCH = {
    "first_max_ge": ("olpa.cuh", "return v > bv || (v == bv && i < bi);",
                     "return v >= bv || (v == bv && i < bi);"),
    "take2_factor": ("olpa.cuh", "rmul(nc1, 0.85f)", "rmul(nc1, 0.8f)"),
    "ltpf_corr_fma": ("ltpf_encode.cuh",
                      "*cf = radd(radd(rmul(buf[imin(n + 1, last)], ef[0]), rmul(buf[n], ef[1])),",
                      "*cf = radd(fmaf(buf[imin(n + 1, last)], ef[0], rmul(buf[n], ef[1])),"),
    "zero_line_window": ("noise_residual_enc.cuh", "(uint64_t{2} << width) - 1u",
                         "(uint64_t{1} << width) - 1u"),
    "lcg_skipped_step": ("spec_decode.cuh", "  return (kLcgMul * uj + kLcgAdd) & 0xffffu;",
                         "  return uj;"),
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
                      ptr(param), ptr(bits), ptr(new_mem), ptr(nc), ptr(mm), ptr(on), ptr(pitch),
                      mem_len)
    return param, bits, new_mem, nc, mm, on, pitch


def plain_ltpf(cfg, a: dict):
    from audio_codec_torch.ops import analysis
    return [np.ascontiguousarray(v.numpy()) for v in analysis.ltpf_encode_plain(
        cfg, *(torch.from_numpy(a[k]) for k in C.LTPF_ORDER))]


def lane_nre(lib, cfg, a: dict):
    max_res, width, start = K._spectral_geometry(cfg, "noise_residual_enc")
    args = [_c(a[k], np.float32 if k in ("dy", "gain") else np.int32) for k in C.NRE_ORDER]
    B, N = args[0].shape
    fac, n_res = np.full(B, -7, np.int32), np.full(B, -7, np.int32)
    res = np.full((B, max_res), -7, np.int32)   # a value no path writes
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
    res_width = min(res_width, a["res_bits"].shape[1])   # as kernels.spec_decode takes it
    ints = _c(np.stack([a[k] for k in SPEC_INTS]), np.int32)
    floats = _c(np.stack([a[k] for k in ("gain", "prev_gg", "prev_fac_ns")]), np.float32)
    x_out, q_out = np.zeros((B, N), np.float32), np.zeros((B, N), np.float32)
    pgg, pfac = np.zeros(B, np.float32), np.zeros(B, np.float32)
    pbw, nbl = np.zeros(B, np.int32), np.zeros(B, np.int32)
    lib.rehearse_spec(ptr(_c(a["x"], np.float32)), ptr(ints), ptr(floats),
                      ptr(_c(a["res_bits"], np.int32)), ptr(_c(a["q_old_res"], np.float32)),
                      ptr(_c(a["q_old_d"], np.float32)),
                      ptr(K._bw_bins("cpu", cfg.frame_dms).numpy()),
                      B, N, width, start,
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
#include <vector>

extern "C" {
// side [9][L], pc_in [3][L] (bfi_in, be_l, be_r), geom: N max_lev hrmode tns_max lpcw
// rate_flag total_bits max_res res_iters pc_bytes numbytes; the kernel's warp
// (a thread a frame) run by the host warp
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
  tb.inv = reinterpret_cast<const uint8_t*>(tabs + 5412);
  const DecIo io = {frames, side, pc_in, x, tns_order, tns_idx, res, out, L, nbytes};
  const int S = 33;
  std::vector<int32_t> xs(g.N * S), tns(18 * S), len(2 * S);
  std::vector<uint32_t> lev(dec_lev_words(g.N) * S), rs(dec_res_words(g.max_res) * S);
  std::vector<uint8_t> fbuf(32 * nbytes);
  const DecRows<int32_t> rows = {xs.data(), lev.data(), rs.data(), tns.data(), len.data(), S};
  for (int s0 = 0; s0 < L; s0 += 32) {
    const int nf = imin(32, L - s0);
    if (pc_mode == 1)
      ari_decode_warp<kPcDecode>(CoderHostWarp{}, io, s0, nf, tb, g, fbuf.data(), rows);
    else if (pc_mode == 2)
      ari_decode_warp<kPcEncSim>(CoderHostWarp{}, io, s0, nf, tb, g, fbuf.data(), rows);
    else
      ari_decode_warp<kPcNone>(CoderHostWarp{}, io, s0, nf, tb, g, fbuf.data(), rows);
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
// the encoder's warp (a warp a slot) run by the host warp; tabs: the
// encoder's table
void rehearse_fec_encode(const int* data, const int* epmr, const int* tabs, int B, int D,
                         int slot, int mode, int ccc, int* out) {
  FecEncScratch ws;
  for (int b = 0; b < B; ++b)
    fec_encode_warp(CoderHostWarp{}, data + D * b, epmr[b], tabs, slot, mode, ccc, &ws,
                    out + slot * b);
}
// the kernel's warp (a warp a slot) run by the host warp; tabs: the
// decoder's table
void rehearse_fec_decode(const int* frames, const int* bfi_in, const int* tabs, int B, int slot,
                         int ccc, int* data, int* out) {
  FecWarpScratch ws;
  for (int b = 0; b < B; ++b)
    fec_decode_warp(CoderHostWarp{}, frames + slot * b, bfi_in[b], tabs, tabs + kFecCrcPow,
                    slot, ccc, &ws, data + slot * b, out + b, B);
}
int fec_table_words() { return kFecTableWords; }
int fec_dec_table_words() { return kFecDecTableWords; }
int fec_enc_table_words() { return kFecEncTableWords; }
}
"""

# mutations of the channel coder's lanes that the rehearsal must catch
MUTATIONS_FEC = {
    # a `<` for `<=` in a risk compare: the EPMR increment by codeword 0's risk
    # (the risk thresholds themselves are no reachable risk product, so a
    # changed compare against them gives the same results)
    "risk_compare_lt": ("fec.cuh", "4 * (exp0 <= -8 ? 1 : 0)", "4 * (exp0 < -8 ? 1 : 0)"),
    "deinterleave_length": ("fec.cuh", "    if (j < len) {\n      const int o",
                            "    if (j < len - 1) {\n      const int o"),
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
    lib.rehearse_fec_encode(ptr(data), ptr(epmr), ptr(K.fec_enc_tables("cpu").numpy()),
                            data.shape[0], data.shape[1], slot, mode, ccc, ptr(out))
    return out


def lane_fec_decode(lib, frames, bfi_in, slot, ccc) -> dict:
    from audio_codec_torch.ops import fec
    frames, bfi_in = _c(frames, np.int32), _c(bfi_in, np.int32)
    B = frames.shape[0]
    data, out = np.zeros((B, slot), np.int32), np.zeros((9, B), np.int32)
    lib.rehearse_fec_decode(ptr(frames), ptr(bfi_in), ptr(K.fec_dec_tables("cpu").numpy()), B, slot,
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
    assert lib_fec.fec_dec_table_words() == K.fec_dec_tables("cpu").numel()
    assert lib_fec.fec_enc_table_words() == K.fec_enc_tables("cpu").numel()


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
# The steps are templates over the warp that runs them: plc_tdc's over
# csrc/plc.cuh's, here HostWarp, which runs every lane's share in turn; the
# others' over csrc/warp.cuh's, here CoderHostWarp. The plain versions take the
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
// the damping's warp (plc_damp.cuh:damp_warp) run by the host warp, the
// vectors int32 and float32 rows of ints and floats
void rehearse_damp(const float* x, const float* q, const int32_t* ints, const float* floats,
                   const int32_t* pows, float* spec, float* fout, int32_t* iout, int B, int N) {
  std::vector<DampWork> work(1);
  StreamVec v[kDampVecs];
  for (int k = 0; k < 10; ++k) v[k] = {ints + (size_t)k * B, 1, kVecInt32};
  for (int k = 0; k < 4; ++k) v[10 + k] = {floats + (size_t)k * B, 1, kVecFloat32};
  for (int b = 0; b < B; ++b) {
    DampOut o;
    damp_warp(CoderHostWarp{}, damp_in(v, b), x + (size_t)b * N, q + (size_t)b * N, pows, N,
              work.data(), spec + (size_t)b * N, o);
    fout[b] = o.st.cf;
    fout[B + b] = o.st.cs;
    fout[2 * B + b] = o.st.cfa;
    iout[b] = o.ns_seed;
    iout[B + b] = o.pc_seed;
  }
}
// the analysis's warp (phecu.cuh:ph_spec_ana_warp) run by the host warp
void rehearse_spec_ana(const float* xr, const float* xi, const float* xor_, const float* xoi,
                       const float* nc, const int32_t* active, float* f0, int32_t* npl, float* e,
                       int B, int ns, int n_lgw) {
  std::vector<PhAnaWork> work(1);
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
    ph_spec_ana_warp(CoderHostWarp{}, g, xr + row, xi + row, xor_ + row, xoi + row, nc[b],
                     work.data(), f0 + row, npl + b, eo, el);
  }
}
// the substitution's warp (phecu.cuh:ph_subst_warp) run by the host warp
void rehearse_subst(const float* xr, const float* xi, const float* f0, const int32_t* ints,
                    const float* groups, const float* beta_mute, const int32_t* tab, float* outr,
                    float* outi, int B, const int* gi) {
  std::vector<PhWork> work(1);
  const PhGeom g = {gi[0], gi[1], gi[2], gi[3], gi[4], gi[5]};
  for (int b = 0; b < B; ++b) {
    const size_t row = (size_t)b * g.nsf;
    if (!ints[3 * B + b]) {
      for (int k = 0; k < g.nsf; ++k) outr[row + k] = outi[row + k] = 0.0f;
      continue;
    }
    const size_t gb = (size_t)b * 9, gB = (size_t)B * 9;
    ph_subst_warp(CoderHostWarp{}, g, xr + row, xi + row, f0 + (size_t)b * g.ns, ints[b],
                  ints[B + b], ints[2 * B + b], groups + gb, groups + gB + gb,
                  groups + 2 * gB + gb, beta_mute[b], groups + 3 * gB + gb, tab, work.data(),
                  outr + row, outi + row);
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
    "peak_better_gt": ("phecu.cuh", "const uint32_t better = all_if(m >= cand) & mode;",
                       "const uint32_t better = all_if(m > cand) & mode;"),
    # the upper neighbour's peak before the lower one's at equal distance
    "subst_lower_first": ("phecu.cuh", "const int kp = du <= dd ? k + du : k - dd",
                          "const int kp = du < dd ? k + du : k - dd"),
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


# ---- the bit-exact fixed-point decoder (csrc/fx_*.cuh) ----
# The fixed-point steps are templates over the group of threads that runs
# them (csrc/fixed.cuh: a warp or a block on the card, `Host` here). Their
# arithmetic is integer, so the plain versions need no card order and every
# output must be equal.

WRAPPER_FX = r"""
#include "fx_sns_dec.cuh"
#include "fx_spec_decode.cuh"
#include "fx_dct4.cuh"
#include "fx_ola_ltpf.cuh"
#include <vector>
using namespace acx::fx;

extern "C" {
void rehearse_fx_sns_dec(const int32_t* idx, const int32_t* tab, int n_bands, int L, i64* scf,
                         i64* scf_e) {
  int32_t bands[64];
  for (int l = 0; l < L; ++l)
    fx_sns_dec_warp(acx::CoderHostWarp{}, idx + 7 * l, tab, n_bands, bands, scf + l * n_bands,
                    scf_e + l * n_bands);
}
// geom: yLen N n_bands frame_dms gg_off R; frames in groups of kFxSpecFrames,
// the lattices of a group at once on the host's coder-warp
void rehearse_fx_spec_decode(const int32_t* x, const int32_t* res, const int32_t* side,
                             const int32_t* tidx, const i64* scf, const i64* scf_e,
                             const i64* tab, const int* geom, int L, i64* out, i64* x_e) {
  const SpecGeom g{geom[0], geom[1], geom[2], geom[3], geom[4], geom[5]};
  std::vector<SpecWord> xs(kFxSpecFrames * g.yLen);
  std::vector<int16_t> run(g.yLen);
  FxTnsFrame tf[kFxSpecFrames];
  const Host w;
  for (int l = 0; l < L; l += kFxSpecFrames)
    fx_spec_decode_lane(w, acx::CoderHostWarp{}, L - l < kFxSpecFrames ? L - l : kFxSpecFrames,
                        x + l * g.yLen, res + l * g.R, side + l * kSpecSideWords, tidx + 16 * l,
                        scf + l * g.n_bands, scf_e + l * g.n_bands, tab, g, xs.data(), run.data(),
                        tf, out + l * g.N, x_e + l);
}
void rehearse_fx_dct4(const i64* y, const i64* y_e, const w32* tab, int L, i64* ytda, i64* ye,
                      i64* ys, bool* zero) {
  w32 a[kDctN], b[kDctN];
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
  std::vector<OlaWord> sc(ola_scratch_words(g));
  const Host w;
  const int memLen = g.wLen - g.N;
  for (int b = 0; b < B; ++b) {
    const OlaState s{st[0] + b * memLen, st[1] + b, st[2] + b * g.x_len, st[3] + b * g.y_len,
                     st[4] + b, st[5] + b, st[6] + b, st[7] + b, st[8] + b, st[9] + b};
    fx_ola_ltpf_lane(w, ytda + b * g.N, y_e[b], y_s[b], zero[b], lp + 3 * b, tab, g, s, sc.data(),
                     pcm + b * g.N);
  }
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
                         "en1[j] = round_w(L_shlw(L_multw(iq, shl16w(y[j], shift_num)), 13 - shift_num));",
                         "en1[j] = L_shlw(L_multw(iq, shl16w(y[j], shift_num)), 13 - shift_num) >> 16;"),
    # fx_spec_decode: a lattice tap without its saturation (a 32-bit wrap)
    "spec_lattice_saturation": ("fx_spec_decode.cuh",
                                "const int32_t sub = sub_sat32(x, mpy32_16(s, rc));",
                                "const int32_t sub = static_cast<int32_t>(static_cast<uint32_t>(x)"
                                " - static_cast<uint32_t>(mpy32_16(s, rc)));"),
    # fx_spec_decode's prefix counts (the residual's and the noise filler's
    # ranks): a bin counted in its own rank
    "scan_rank_inclusive": ("fixed.cuh",
                            "f(base + j, r + popc32(m & below32(j)), ((m >> j) & 1u) != 0);",
                            "f(base + j, r + popc32(m & upto32(j)), ((m >> j) & 1u) != 0);"),
    # fx_dct4: the radix-8 rows' SCALEFACTORN2 - 1 shift one short
    "dct4_bfly_shift": ("fx_dct4.cuh", "auto ps = [](w32 v) { return v >> 2; };",
                        "auto ps = [](w32 v) { return v >> 1; };"),
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
    lib.rehearse_fx_sns_dec(ptr(idx), ptr(_c(K.fx_sns_table_pack(), np.int32)), n_bands, L,
                            ptr(scf), ptr(scf_e))
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
    tab = _c(K.fx_dct4_table_pack(), np.int32)
    lib.rehearse_fx_dct4(ptr(y), ptr(y_e), ptr(tab), L, ptr(ytda), ptr(ye),
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


# ---- the LTPF decoder whole (ltpf_decode.cuh) ----

WRAPPER_LTPF = r"""
#include "ltpf_decode.cuh"
using namespace acx;

template <int NI, int NT>
static void run(const LtpfGeom& g, const float* x, const int* bfi, const int* param,
                const int* mem_param, const float* mem_x, const float* mem_y, const int* mpi,
                const int* mpf, const float* mgain, const int* mbeta, const float* inter,
                const float* tilt, float* y, float* nmx, float* nmy, int* oparam, int* ints,
                float* ogain, int B) {
  static float yr[kLtpfRing], zr[kLtpfRing], xs[kLtpfMaxX], zc[kLtpfRing];
  const LtpfRows rows = {yr, zr, xs, zc};
  for (int b = 0; b < B; ++b) {
    const LtpfParams p = ltpf_params(g, bfi[b], param + 3 * b, mem_param + 3 * b, mpi[b], mpf[b]);
    for (int i = 0; i < 3; ++i) oparam[3 * b + i] = p.param[i];
    ints[b] = p.pitch_int;
    ints[B + b] = p.pitch_fr;
    ints[2 * B + b] = g.beta_idx;
    ogain[b] = p.gain;
    LtpfFilters<NI, NT> f;
    ltpf_filters(g, p, mgain[b], mpf[b], mbeta[b], inter, tilt, f);
    ltpf_frame(LtpfHostLanes{}, g, p, f, x + g.N * b, mem_x + g.Lx * b, mem_y + g.Ly * b, rows,
               y + g.N * b, nmx + g.Lx * b, nmy + g.Ly * b);
  }
}

extern "C" void rehearse_ltpf_decode(const float* x, const int* bfi, const int* param,
                                     const int* mem_param, const float* mem_x, const float* mem_y,
                                     const int* mpi, const int* mpf, const float* mgain,
                                     const int* mbeta, const float* inter, const float* tilt,
                                     float* y, float* nmx, float* nmy, int* oparam, int* ints,
                                     float* ogain, int B, int N, int Lx, int Ly, int n_inter,
                                     int inter_len, int N4, int fs, int beta_idx, float beta) {
  const LtpfGeom g = {N, Lx, Ly, inter_len, N4, fs, beta_idx, beta};
  if (n_inter == 12)
    run<12, 11>(g, x, bfi, param, mem_param, mem_x, mem_y, mpi, mpf, mgain, mbeta, inter, tilt,
                y, nmx, nmy, oparam, ints, ogain, B);
  else
    run<4, 3>(g, x, bfi, param, mem_param, mem_x, mem_y, mpi, mpf, mgain, mbeta, inter, tilt,
              y, nmx, nmy, oparam, ints, ogain, B);
}
"""

# mutations of the LTPF decoder's steps that the rehearsal must catch: chunks
# of 128 samples whatever the read distance, the y phase before the z phase,
# case A (neither filter on) not writing its memories, a fused float
# multiply-add in place of the tap chains' xfma (seen on the crafted
# midpoint lane of ltpf_decode_rows)
MUTATIONS_LTPF = {
    "chunk_128": ("ltpf_decode.cuh", "return iclamp(dist, 1, kLtpfChunk);", "return 128;"),
    "y_before_z": ("ltpf_decode.cuh",
                   "    ltpf_z_phase(w, g, p, f, s, n0, lanes);\n"
                   "    ltpf_y_phase(w, g, p, f, s, n0, lanes, y);",
                   "    ltpf_y_phase(w, g, p, f, s, n0, lanes, y);\n"
                   "    ltpf_z_phase(w, g, p, f, s, n0, lanes);"),
    "case_a_no_mems": ("ltpf_decode.cuh", "  ltpf_write_mems(w, g, s, new_mx, new_my);",
                       "  if (p.cases != 0) ltpf_write_mems(w, g, s, new_mx, new_my);"),
    "tap_fma": ("ltpf_decode.cuh",
                "return static_cast<float>(std::fma(w, static_cast<double>(v), "
                "static_cast<double>(acc)));",
                "return std::fmaf(static_cast<float>(w), v, acc);"),
}


def build_wrapper(out: Path, wrapper: str, stem: str, mutations: dict,
                  mutation: str | None = None) -> ctypes.CDLL:
    """g++ builds `wrapper` over csrc/ (or over a copy with one mutation)."""
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("needs g++ to compile the lane functions for the CPU")
    inc = CSRC
    if mutation is not None:
        inc = out / "csrc"
        shutil.copytree(CSRC, inc)
        name, old, new = mutations[mutation]
        text = (inc / name).read_text()
        assert text.count(old) == 1, f"{mutation}: the line to mutate is not in {name}"
        (inc / name).write_text(text.replace(old, new))
    (out / f"{stem}.cpp").write_text(wrapper)
    r = subprocess.run([gxx, "-x", "c++", "-std=c++17", "-O1", "-ffp-contract=off", "-shared",
                        "-fPIC", f"-I{inc}", str(out / f"{stem}.cpp"), "-o", str(out / f"{stem}.so")],
                       capture_output=True, text=True, timeout=600)
    assert r.returncode == 0, r.stderr
    return ctypes.CDLL(str(out / f"{stem}.so"))


@pytest.fixture(scope="module")
def lib_ltpf(tmp_path_factory):
    return build_wrapper(tmp_path_factory.mktemp("lanes_ltpf"), WRAPPER_LTPF, "lanes_ltpf",
                         MUTATIONS_LTPF)


LTPF_RATES = {"48k": dict(fs_in=48000, bitrate=64000), "16k": dict(fs_in=16000, bitrate=32000)}


def ltpf_differing(lib, name: str, seed: int = 0) -> int:
    """The lane functions of ltpf_decode on ltpf_decode_rows (with the
    midpoint lane at 48 kHz) against ltpf_decode_plain in the card's order:
    values that differ over y, the new memories and the parameters."""
    from audio_codec_torch.models.state import ltpf_dec_lens
    from audio_codec_torch.ops import ltpf_dec
    cfg = P.Config(**LTPF_RATES[name])
    d = C.ltpf_decode_rows(cfg, seed, midpoint=cfg.fs == 48000)
    B, N = d["x"].shape
    Lx, Ly, _, _ = ltpf_dec_lens(cfg)
    inter, tilt = (_c(ltpf_dec._filter(cfg.fs, k), np.float32) for k in (0, 1))
    y, nmx, nmy = (np.zeros((B, n), np.float32) for n in (N, Lx, Ly))
    oparam, ints, gain = np.zeros((B, 3), np.int32), np.zeros((3, B), np.int32), np.zeros(B, np.float32)
    lib.rehearse_ltpf_decode(*(ptr(d[k]) for k in C.LTPF_DEC_ORDER), ptr(inter), ptr(tilt),
                             ptr(y), ptr(nmx), ptr(nmy), ptr(oparam), ptr(ints), ptr(gain), B, N,
                             Lx, Ly, inter.shape[1], max(cfg.fs, 16000) // 8000,
                             int(cfg.fs * 0.0025), cfg.fs, cfg.ltpf_conf_beta_idx,
                             f32p(cfg.ltpf_conf_beta))
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(numerics, "on_cpu", lambda x: False)
        ref = ltpf_dec.ltpf_decode_plain(cfg, *(torch.from_numpy(d[k]) for k in C.LTPF_DEC_ORDER))
    m = ref[3]
    return C.count_differing((y, nmx, nmy, oparam, ints[0], ints[1], gain, ints[2]),
                             (*ref[:3], m["param"], m["pitch_int"], m["pitch_fr"], m["gain"],
                              m["beta_idx"]))


@pytest.mark.parametrize("name", list(LTPF_RATES))
def test_ltpf_decode_lane_matches_plain(lib_ltpf, name):
    """The LTPF decoder's parameter decode and chunked sample loop, the
    lanes of a chunk emulated as a warp runs them (every lane of a phase
    reads before any writes), against ltpf_decode_plain in the card's order
    at 48 and 16 kHz on every case of ltpf_decode_rows."""
    assert ltpf_differing(lib_ltpf, name) == 0


@pytest.mark.parametrize("mutation", list(MUTATIONS_LTPF))
def test_rehearsal_catches_mutated_ltpf_decode(tmp_path, mutation):
    lib = build_wrapper(tmp_path, WRAPPER_LTPF, "lanes_ltpf", MUTATIONS_LTPF, mutation)
    assert sum(ltpf_differing(lib, name) for name in LTPF_RATES) > 0, mutation


# ---- the TNS lattices (csrc/tns_lattice.cuh) ----
# K6 runs a chunk of the stream a lane: the lanes read only x and write
# disjoint bins, so here they run one after the other. K12 runs a tap a
# lane over the wavefront: every step, each lane first reads its
# neighbours' values of the step before (as __shfl_down_sync and
# __shfl_up_sync do), then every lane takes its step. Both lattices' plain
# versions compute the CPU's contraction on every device, so they run here
# on CPU tensors as they are.

WRAPPER_TNS = r"""
#include "tns_lattice.cuh"
#include <vector>
using namespace acx;

static TnsStream stream_of(const int* order, const int* lo, const int* hi, int b, int N) {
  return tns_stream(order + 2 * b, lo + 2 * b, hi + 2 * b, N);
}

extern "C" {
void rehearse_tns_analysis(const float* x, const float* rc, const int* order, const int* lo,
                           const int* hi, float* y, int B, int N) {
  std::vector<float> ys(N);
  for (int b = 0; b < B; ++b) {
    const TnsStream s = stream_of(order, lo, hi, b, N);
    double r[2 * kTnsLags];
    for (int k = 0; k < 2 * kTnsLags; ++k) r[k] = rc[2 * kTnsLags * b + k];
    for (int lane = 0; lane < kTnsLanes; ++lane) {
      int w, c, e;
      tns_analysis_span(s, N, lane, w, c, e);
      tns_analysis_run(x + b * N, ys.data(), w, c, e, s, r, B == 1);
    }
    for (int i = 0; i < N; ++i) y[b * N + i] = tns_analysis_wrote(s, N, i) ? ys[i] : x[b * N + i];
  }
}
// x in place; warps of 4 streams as the kernel lays them
void rehearse_tns_synthesis(float* x, const float* rc, const int* order, const int* lo,
                            const int* hi, int B, int N) {
  constexpr int kRows = 32 / kTnsLags;
  for (int row0 = 0; row0 < B; row0 += kRows) {
    const int rows = B - row0 < kRows ? B - row0 : kRows;
    TnsWaveLane L[32];
    TnsStream s[32];
    int len[32], steps = 0;
    double r0[32], r1[32];
    for (int lane = 0; lane < 32; ++lane) {
      const int g = lane / kTnsLags, el = lane % kTnsLags;
      const int b = row0 + imin(g, rows - 1);
      s[lane] = stream_of(order, lo, hi, b, N);
      len[lane] = g < rows ? s[lane].b - s[lane].a + 1 : 0;
      r0[lane] = rc[2 * kTnsLags * b + el];
      r1[lane] = rc[2 * kTnsLags * b + kTnsLags + el];
      L[lane] = {0.0, 0.0, 0.0, 0.0, false};
      steps = imax(steps, tns_wave_steps(len[lane]));
    }
    for (int t = 0; t < steps; ++t) {
      double s_in[32], sf_in[32], u_in[32];
      for (int lane = 0; lane < 32; ++lane) {
        s_in[lane] = L[lane < 31 ? lane + 1 : lane].s;
        sf_in[lane] = L[lane < 31 ? lane + 1 : lane].sf;
        u_in[lane] = L[lane > 0 ? lane - 1 : lane].upd;
      }
      for (int lane = 0; lane < 32; ++lane) {
        float* row = x + static_cast<size_t>(row0 + imin(lane / kTnsLags, rows - 1)) * N;
        tns_synthesis_step(L[lane], t, lane % kTnsLags, row, s[lane], len[lane], r0[lane],
                           r1[lane], s_in[lane], sf_in[lane], u_in[lane], B == 1);
      }
    }
  }
}
}
"""

# mutations the rehearsal must catch: a 7-bin warm-up, a K6 tap's product
# rounded on its own (the encoder lattice's earlier order), the wavefront
# one step late (lane 0 misses its last bin), a lane >= 4 updating its
# state from s instead of s_f, the fast rounding without its test for
# subnormals or without the sign of zero, and the exact rounding without
# its conversion out of range
MUTATIONS_TNS = {
    "warmup_7": ("tns_lattice.cuh", "constexpr int kTnsWarmup = 8;",
                 "constexpr int kTnsWarmup = 7;"),
    "k6_tap_rounded": ("tns_lattice.cuh", "const double sn = tns_fma<kExact>(rj, st[j], sv, far);",
                       "const double sn = tns_add<kExact>(sv, tns_mul<kExact>(rj, st[j], far), far);"),
    "wave_offset": ("tns_lattice.cuh", "const int k = t - (kTnsLags - 1 - el);",
                    "const int k = t - (kTnsLags - el);"),
    "upd_from_s": ("tns_lattice.cuh",
                   "const double upd = tns_fma<kExact>(r, el >= 4 ? sf : s, st, far);",
                   "const double upd = tns_fma<kExact>(r, s, st, far);"),
    "range_test_dropped": ("tns_lattice.cuh",
                           "  far = far || e > kFloatExpHi || (e < kFloatExpLo && (hi & 0x7FFFFFFFu) != 0u);",
                           "  far = far || e > kFloatExpHi;"),
    "zero_sign_lost": ("tns_lattice.cuh", "  return std::copysign(round_float_in_range(x), x);",
                       "  return round_float_in_range(x);"),
    "exact_unranged": ("tns_lattice.cuh", "    return round_float(x);",
                       "    return round_float_in_range(x);"),
}


@pytest.fixture(scope="module")
def lib_tns(tmp_path_factory):
    return build_wrapper(tmp_path_factory.mktemp("lanes_tns"), WRAPPER_TNS, "lanes_tns",
                         MUTATIONS_TNS)


def lattice_args(d: dict) -> tuple:
    return tuple(np.ascontiguousarray(d[k]) for k in C.TNS_LATTICE_ORDER)


def lane_lattice(lib, name: str, args: tuple) -> np.ndarray:
    x, rc, order, lo, hi = args
    B, N = x.shape
    if name == "analysis":
        y = np.empty_like(x)
        lib.rehearse_tns_analysis(ptr(x), ptr(rc), ptr(order), ptr(lo), ptr(hi), ptr(y), B, N)
        return y
    y = x.copy()
    lib.rehearse_tns_synthesis(ptr(y), ptr(rc), ptr(order), ptr(lo), ptr(hi), B, N)
    return y


def plain_lattice(name: str, args: tuple) -> np.ndarray:
    from audio_codec_torch.ops import tns
    fn = tns.tns_analysis_lattice_plain if name == "analysis" else tns.tns_synthesis_lattice_plain
    return fn(*(torch.from_numpy(a) for a in args)).numpy()


def lattice_differing(lib, name: str, args: tuple) -> int:
    return C.count_differing(lane_lattice(lib, name, args), plain_lattice(name, args))


@pytest.fixture(scope="module")
def encoder_lattices(encoder_spectra):
    """The lattices' arguments from the port's encoder: its filters on its
    own shaped spectra and on tns_rows (filters of order 8 in both ranges),
    the analysis lattice's output as the synthesis lattice's input."""
    from audio_codec_torch.ops import tns
    cfg = C_CFG48
    x = np.concatenate([encoder_spectra[0], C.tns_rows(seed=1)[0]])
    bw = np.concatenate([encoder_spectra[1], C.tns_rows(seed=1)[1]])
    xt, bwt = torch.from_numpy(x), torch.from_numpy(bw)
    order, _, rc, nf, _ = tns.tns_filter_analysis_plain(cfg, xt, bwt)
    lo, hi = tns._filter_ranges(cfg, bwt, nf, x.shape[0], "cpu")
    ana = tuple(np.ascontiguousarray(a.numpy() if hasattr(a, "numpy") else a)
                for a in (x, rc, order, lo, hi))
    y = plain_lattice("analysis", ana)
    syn = (np.ascontiguousarray(y),) + ana[1:]
    return {"analysis": ana, "synthesis": syn}


@pytest.mark.parametrize("name", ["analysis", "synthesis"])
def test_tns_lattice_lanes_match_plain_on_encoder_spectra(lib_tns, encoder_lattices, name):
    args = encoder_lattices[name]
    assert int((args[2] == 8).sum()) > 0, "no filter of order 8"
    assert lattice_differing(lib_tns, name, args) == 0


@pytest.mark.parametrize("B", [1, 63])
@pytest.mark.parametrize("name", ["analysis", "synthesis"])
def test_tns_lattice_lanes_match_plain_on_synthetic_rows(lib_tns, name, B):
    """Every row of tns_lattice_rows together, and one at a time (B = 1:
    the last tap of K6, the first of K12, contracted)."""
    args = lattice_args(C.tns_lattice_rows(seed=2))
    if B == 1:
        bad = sum(lattice_differing(lib_tns, name, tuple(a[i: i + 1] for a in args))
                  for i in range(0, args[0].shape[0], 7))
    else:
        bad = lattice_differing(lib_tns, name, args)
    assert bad == 0


def test_tns_lattice_rows_reach_both_analysis_paths_and_every_chunk_offset(lib_tns):
    """The chunked and the general path of K6 both run, and the switch
    between the filters falls on every offset of a 15-bin chunk."""
    d = C.tns_lattice_rows(seed=2)
    lo, hi, order = d["lo"], d["hi"], d["order"]
    on = order > 0
    both = on.all(-1)
    joined = np.maximum(lo[:, 0], lo[:, 1]) <= np.minimum(hi[:, 0], hi[:, 1]) + 1
    inside = (lo[:, 1] > lo[:, 0]) & (hi[:, 1] < hi[:, 0])
    general = both & ~(joined & ~inside)
    assert 0 < int(general.sum()) < len(order)
    switch = lo[both & ~general, 1] - lo[both & ~general, 0]
    assert set(range(C.TNS_CHUNK)) <= set((switch % C.TNS_CHUNK).tolist())
    assert int((order > 8).sum()) >= 2 and int((~on).all(-1).sum()) >= 1


@pytest.mark.parametrize("B", [1, 6])
def test_tns_synthesis_lane_matches_plain_on_the_cpus_contraction(lib_tns, B):
    """The repaired lattice (the CPU's contraction for every tap, on every
    device) against the wavefront's lanes: order-8 filters in both ranges and
    random orders; B = 1 contracts the first product too."""
    rng = np.random.default_rng(B)
    N = 400
    x = (rng.standard_normal((B, N)) * 10 ** rng.uniform(-2, 4, (B, 1))).astype(np.float32)
    pts = P.tables.t("quants_pts_tns").astype(np.float32)
    rc = pts[rng.integers(2, 15, (B, 2, 8))]
    order = rng.integers(0, 9, (B, 2)).astype(np.int32)
    order[0] = 8
    lo = np.tile(np.array([[12, 200]], np.int32), (B, 1))
    hi = np.tile(np.array([[199, N - 1]], np.int32), (B, 1))
    assert lattice_differing(lib_tns, "synthesis", (x, rc, order, lo, hi)) == 0


@pytest.mark.parametrize("mutation", list(MUTATIONS_TNS))
def test_rehearsal_catches_mutated_tns_lattice(tmp_path, encoder_lattices, mutation):
    lib = build_wrapper(tmp_path, WRAPPER_TNS, "lanes_tns", MUTATIONS_TNS, mutation)
    rows = lattice_args(C.tns_lattice_rows(seed=2))
    bad = {name: lattice_differing(lib, name, encoder_lattices[name])
           + lattice_differing(lib, name, rows) for name in ("analysis", "synthesis")}
    assert sum(bad.values()) > 0, f"the rehearsal did not see the mutation {mutation}: {bad}"
