"""The advanced concealment's time-domain kernel and the fixed-point
decoder's spectral chain, their warp designs compiled for the CPU, against
their plain versions.

csrc/plc_tdc.cuh (K17a, `plc_tdc_stream`, its LPC synthesis in transposed
order on 16 lanes in `tdc_synth_warp`) is written over the warp policy of
csrc/plc.cuh, whose `coder()` is the host warp of csrc/warp.cuh here; and
csrc/fx_spec_decode.cuh (K20b, `fx_spec_decode_lane`: the stages before and
after the TNS lattice over the host group of csrc/fixed.cuh, the lattices of
four frames at once as a wavefront of a tap a lane in `fx_tns_wave`, over
the host warp). The host warp runs the 32 lanes of a step in turn and every
shuffle reads all lanes before any is written, so a wrong lane offset in a
synthesis or wave step shows. g++ builds them into a shared library called
through ctypes. The work space and every output are filled with a byte
pattern before each stream (K17a) or group of frames (K20b), so a buffer
read after its storage is taken over shows. Every output must equal the
plain version's (ops/plc_adv.py:plc_tdc_plain, ops/fixed_dev.py:
spectrum_decode_plain, both unchanged) bit for bit at 1 and 33 streams or
frames: K17a on tests/torch_kernel_cases.py's TDC_LANES and on rows at a
first loss with a full-scale history, at a first loss and a later loss
with a subnormal history, with a synthesis memory of +0 and -0, and past
the fade-out; K20b on fx_spec_rows and on rows with TNS off, one filter,
two filters, filter 0 off and filter 1 on, every order 1-8 in each filter,
and full-scale spectra whose taps saturate, zero frames among them. Copies
of the headers with one line changed must fail. It skips where there is no
g++."""
from __future__ import annotations

import functools

import numpy as np
import pytest
import torch

import audio_codec_torch as P
from audio_codec_torch import kernels as K
from audio_codec_torch.ops import fixed_dev, plc_adv

from tests import torch_kernel_cases as C
from tests.test_torch_lane_rehearsal import build_wrapper, ptr

WRAPPER = r"""
#include "plc_tdc.cuh"
#include "fx_spec_decode.cuh"
#include <cstring>
#include <vector>
using namespace acx;

extern "C" {
void rehearse_tdc(const float* x, const float* scf, const float* q, const float* a_in,
                  const float* harm_in, const float* hist_in, const int32_t* ints,
                  const float* floats, const float* ftab, const int32_t* itab, float* a_out,
                  float* synth, float* harm, float* hist, int32_t* iout, float* fout, int B,
                  const int* gi, const float* gf) {
  const TdcGeom g = {gi[0], gi[1], gi[2], gi[3], gi[4], gi[5], gi[6], gi[7], gi[8], gi[9],
                     gf[0], gf[1], gf[2]};
  TdcWork work;
  const HostWarp w;
  for (int b = 0; b < B; ++b) {
    const size_t bb = b;
    std::memset(&work, 0x5A, sizeof work);
    std::memset(a_out + bb * 17, 0x5A, 17 * 4);
    std::memset(synth + bb * g.length, 0x5A, g.length * 4);
    std::memset(harm + bb * g.MP, 0x5A, g.MP * 4);
    std::memset(hist + bb * 16, 0x5A, 16 * 4);
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
    plc_tdc_stream(w, s, g, tdc_tables(ftab, itab, g.n_bands), &work);
  }
}
// geom: yLen N n_bands frame_dms gg_off R; frames in groups of kFxSpecFrames
void rehearse_spec(const int32_t* x, const int32_t* res, const int32_t* side,
                   const int32_t* tidx, const fx::i64* scf, const fx::i64* scf_e,
                   const fx::i64* tab, const int* geom, int L, fx::i64* out, fx::i64* x_e) {
  using namespace acx::fx;
  const SpecGeom g{geom[0], geom[1], geom[2], geom[3], geom[4], geom[5]};
  std::vector<SpecWord> xs(kFxSpecFrames * g.yLen);
  std::vector<int16_t> run(g.yLen);
  FxTnsFrame tf[kFxSpecFrames];
  for (int l = 0; l < L; l += kFxSpecFrames) {
    const int nf = L - l < kFxSpecFrames ? L - l : kFxSpecFrames;
    std::memset(xs.data(), 0x5A, xs.size() * sizeof(SpecWord));
    std::memset(run.data(), 0x5A, run.size() * sizeof(int16_t));
    std::memset(tf, 0x5A, sizeof tf);
    std::memset(out + l * g.N, 0x5A, nf * g.N * sizeof(i64));
    std::memset(x_e + l, 0x5A, nf * sizeof(i64));
    fx_spec_decode_lane(Host{}, CoderHostWarp{}, nf, x + l * g.yLen, res + l * g.R,
                        side + l * kSpecSideWords, tidx + 16 * l, scf + l * g.n_bands,
                        scf_e + l * g.n_bands, tab, g, xs.data(), run.data(), tf, out + l * g.N,
                        x_e + l);
  }
}
}
"""

# mutations the rehearsal must catch. K17a: a pending sum fed the
# coefficient of the sample after (one sample late), the taps fed in
# reverse order, the de-emphasis seeded from the wrong sample of the
# history, the synthesis memory read from pe after the generator's values
# took its storage, the restart lane one off. K20b: the wave offset one
# step off, the state update made from the tap's input (read before its
# tap), the switch to filter 1 a bin late, the state update's saturation
# dropped (a 32-bit wrap).
MUTATIONS = {
    "sum_fed_one_sample_late": ("plc_tdc.cuh", "      const int j = ((l & 15) - k) & 15;",
                                "      const int j = ((l & 15) - k + 1) & 15;"),
    "taps_reversed": ("plc_tdc.cuh",
                      "      c[k][l] = static_cast<double>(a[j == 0 ? kTdcOrder : j]);",
                      "      c[k][l] = static_cast<double>(a[j == 0 ? kTdcOrder : kTdcOrder - j]);"),
    "deemphasis_wrong_memory": ("plc_tdc.cuh",
                                "tdc_synth_warp(w.coder(), ws->a, mem, e2, length, fl, g.pre_fac, s.x[L - 1], s.hist);",
                                "tdc_synth_warp(w.coder(), ws->a, mem, e2, length, fl, g.pre_fac, s.x[L - 2], s.hist);"),
    "memory_read_after_rnd": ("plc_tdc.cuh", "  const float* mem = ws->mem;",
                              "  const float* mem = first ? pe + npe - kTdcOrder : s.hist_in;"),
    "restart_lane_off_by_one": ("plc_tdc.cuh", "      const float p = (l & 15) == k ? 0.0f : P[l];",
                                "      const float p = (l & 15) == ((k + 1) & 15) ? 0.0f : P[l];"),
    "wave_offset_off_by_one": ("fx_spec_decode.cuh", "      const int d = t - (kTnsTaps - 1 - kk);",
                               "      const int d = t - (kTnsTaps - kk);"),
    "update_before_tap": ("fx_spec_decode.cuh", "      upd[l] = add_sat32(s, mpy32_16(yi, rc));",
                          "      upd[l] = add_sat32(s, mpy32_16(x, rc));"),
    "filter1_a_bin_late": ("fx_spec_decode.cuh", "      const bool in2 = (i >= lo2[l]) & (i < hi2[l]);",
                           "      const bool in2 = (i > lo2[l]) & (i < hi2[l]);"),
    "update_saturation_dropped": ("fx_spec_decode.cuh", "      upd[l] = add_sat32(s, mpy32_16(yi, rc));",
                                  "      upd[l] = static_cast<int32_t>(static_cast<uint32_t>(s) + "
                                  "static_cast<uint32_t>(mpy32_16(yi, rc)));"),
}

PLCFG = P.Config(fs_in=48000, bitrate=64000, plc_mode=1)
CFG = P.Config(fs_in=48000, bitrate=64000)
TDC_ORDER = ("lost", "nb", "pitch", "fract", "meth", "seed", "fract_st", "harm_len", "stab",
             "gain_c", "alpha")
TDC_ROWS = ("x_old_tot", "scf", "q_d", "a_st", "harm", "synth_hist")
STREAMS = [1, 33]


@pytest.fixture(scope="module")
def lib(tmp_path_factory):
    return build_wrapper(tmp_path_factory.mktemp("tdc_fxspec"), WRAPPER, "tdc_fxspec", MUTATIONS)


# ---- K17a ----

@functools.cache
def tdc_rows() -> dict:
    return C.tdc_edge_rows()


def rows_of(d: dict, sl: slice) -> dict:
    return {k: np.ascontiguousarray(v[sl]) for k, v in d.items()}


def lane_tdc(lib, d: dict) -> dict:
    ftab, itab, geom = K.tdc_tables(PLCFG, "cpu")
    B = d["nb"].shape[0]
    L, MP, fl, length, N = geom[:5]
    ints, floats = K.plc_tdc_pack(*(torch.as_tensor(np.asarray(d[k])) for k in TDC_ORDER))
    ints = np.ascontiguousarray(ints.numpy(), np.int32)
    floats = np.ascontiguousarray(floats.numpy(), np.float32)
    rows = [np.ascontiguousarray(d[k], np.float32) for k in TDC_ROWS]
    a, synth = np.zeros((B, 17), np.float32), np.zeros((B, length), np.float32)
    harm, hist = np.zeros((B, MP), np.float32), np.zeros((B, 16), np.float32)
    iout, fout = np.zeros((4, B), np.int32), np.zeros((3, B), np.float32)
    gi, gf = np.array(geom[:10], np.int32), np.array(geom[10:], np.float32)
    lib.rehearse_tdc(*(ptr(v) for v in rows), ptr(ints), ptr(floats), ptr(ftab.numpy()),
                     ptr(itab.numpy()), ptr(a), ptr(synth), ptr(harm), ptr(hist), ptr(iout),
                     ptr(fout), B, ptr(gi), ptr(gf))
    return dict(meth=iout[0], nc=fout[0], a=a, synth=synth, seed=iout[1], gain_c=fout[1],
                alpha=fout[2], fract=iout[2], harmonic_buf=harm, harmonic_len=iout[3],
                synth_hist=hist)


@functools.cache
def plain_tdc_all() -> dict:
    d = tdc_rows()
    t_ = lambda k: torch.as_tensor(np.asarray(d[k]))
    out = plc_adv.plc_tdc_plain(PLCFG, t_("lost"), t_("nb"), t_("x_old_tot"), t_("scf"), t_("q_d"),
                                t_("pitch"), t_("fract"), t_("stab"), t_("meth"), t_("a_st"),
                                t_("seed"), t_("gain_c"), t_("alpha"), t_("fract_st"), t_("harm"),
                                t_("harm_len"), t_("synth_hist"))
    return {k: v.numpy() for k, v in out.items()}


def tdc_differing(lib, n: int) -> int:
    got = lane_tdc(lib, rows_of(tdc_rows(), slice(0, n)))
    return C.count_differing(got, {k: v[:n] for k, v in plain_tdc_all().items()})


# ---- K20b ----

@functools.cache
def spec_rows() -> dict:
    return C.fx_spec_tns_rows()


def spec_args(d: dict) -> tuple:
    scf, scf_e = fixed_dev.sns_decode_plain(torch.from_numpy(d["scf_idx"]), CFG.bands_number)
    return (CFG, *(torch.from_numpy(np.ascontiguousarray(d[k])) for k in C.FX_SPEC_ORDER),
            scf, scf_e)


def lane_spec(lib, args):
    cfg, x, res, n_res, seed, zf, fac, bw, gg, tidx, order, scf, scf_e = args
    L = x.shape[0]
    side = np.ascontiguousarray(
        torch.stack([n_res, seed, zf, fac, bw, gg, order[:, 0], order[:, 1]], 1).numpy(), np.int32)
    geom = np.array([cfg.yLen, cfg.frame_length, cfg.bands_number, cfg.frame_dms,
                     cfg.quantizedGainOff, res.shape[1]], np.int32)
    out, x_e = np.zeros((L, cfg.frame_length), np.int64), np.zeros(L, np.int64)
    tab = K.fx_spec_table_pack(cfg.yLen, cfg.fs_idx, cfg.frame_dms, cfg.hrmode)
    c = lambda t, dt: np.ascontiguousarray(t.numpy(), dt)
    lib.rehearse_spec(ptr(c(x, np.int32)), ptr(c(res, np.int32)), ptr(side),
                      ptr(c(tidx.reshape(L, 16), np.int32)), ptr(c(scf, np.int64)),
                      ptr(c(scf_e, np.int64)), ptr(tab), ptr(geom), L, ptr(out), ptr(x_e))
    return out, x_e


@functools.cache
def plain_spec_all():
    return [t.numpy() for t in fixed_dev.spectrum_decode_plain(*spec_args(spec_rows()))]


def spec_differing(lib, n: int | None = None) -> int:
    d = spec_rows()
    n = len(d["x"]) if n is None else n
    got = lane_spec(lib, spec_args(rows_of(d, slice(0, n))))
    return C.count_differing(list(got), [v[:n] for v in plain_spec_all()])


def spec_kinds(d: dict) -> dict[str, int]:
    """Frames by TNS filters (bandwidth index >= 3 allows two at 10 ms)."""
    o0, o1, bw = d["tns_order"][:, 0], d["tns_order"][:, 1], d["bw_idx"]
    two = bw >= 3
    return {"TNS off": int(((o0 == 0) & ((o1 == 0) | ~two)).sum()),
            "one filter": int(((o0 > 0) & ((o1 == 0) | ~two)).sum()),
            "two filters": int(((o0 > 0) & (o1 > 0) & two).sum()),
            "filter 0 off, filter 1 on": int(((o0 == 0) & (o1 > 0) & two).sum()),
            "zero frames": int((d["zero_frame"] != 0).sum())}


# ---- the tests ----

@pytest.mark.parametrize("streams", STREAMS)
def test_tdc_warp_matches_plain(lib, streams):
    assert tdc_differing(lib, streams) == 0


def test_tdc_rows_reach_every_branch(lib):
    """All 33 streams; TD-PLC at first and later losses, the full-scale
    first loss among them, and the classifier's other methods."""
    assert tdc_differing(lib, 33) == 0
    d, ref = tdc_rows(), plain_tdc_all()
    tdc = d["lost"] & (ref["meth"] == 3)
    assert (tdc & (d["nb"] == 1)).sum() >= 4 and (tdc & (d["nb"] > 1)).sum() >= 4
    assert ref["meth"][24] == 3                       # the full-scale first loss
    assert {2, 4} <= set(ref["meth"][d["lost"] & (d["nb"] == 1)].tolist())
    sub = np.abs(ref["synth"][26])                  # the subnormal synthesis
    assert 0 < sub.max() < 2.0 ** -100 and (sub[sub > 0] < 2.0 ** -126).any()
    assert not ref["synth"][27].any()                 # from a memory of +0 and -0


@pytest.mark.parametrize("frames", STREAMS)
def test_spec_warp_matches_plain(lib, frames):
    assert spec_differing(lib, frames) == 0


def test_spec_rows_reach_every_filter_kind(lib):
    """All frames; each filter kind, every order 1-8 in each filter, and
    saturating taps occur."""
    assert spec_differing(lib) == 0
    kinds = spec_kinds(spec_rows())
    assert all(v > 0 for v in kinds.values()), kinds
    o = spec_rows()["tns_order"]
    assert set(range(1, 9)) <= set(o[:, 0].tolist()) and set(range(1, 9)) <= set(o[:, 1].tolist())


@pytest.mark.parametrize("mutation", list(MUTATIONS))
def test_rehearsal_catches_mutated_tdc_and_spec_warps(tmp_path, mutation):
    lib_m = build_wrapper(tmp_path, WRAPPER, "tdc_fxspec", MUTATIONS, mutation)
    if MUTATIONS[mutation][0] == "plc_tdc.cuh":
        bad = tdc_differing(lib_m, 33)
    else:
        bad = spec_differing(lib_m)
    assert bad > 0, f"the rehearsal did not see the mutation {mutation}"
