"""The encoder's open-loop pitch search and the fixed-point decoder's back
end, their warp designs compiled for the CPU, against their plain versions.

csrc/olpa.cuh (K3, `olpa_warp`) is a template over the warp that runs it,
and csrc/fx_ola_ltpf.cuh (K21, `fx_ola_ltpf_lane` with the post-filter's
passes in `synth_filter_warp`) is written over the group of threads
(csrc/fixed.cuh). Here g++ builds them with the host warp (`CoderHostWarp`)
and the host group (`Host`, whose `chunk` reads every sample of a chunk
before it writes any, as a warp does) into a shared library called through
ctypes. The warp's shared memory and every output are filled with a byte
pattern before each stream. Every output must equal the plain version's
(ops/analysis.py:olpa_plain run in the card's order;
ops/fixed_ltpf_dev.py:ola_ltpf_plain, integer code) bit for bit, at 1 and
33 streams: K3 on tests/torch_kernel_cases.py:olpa_rows at 10, 5 and 2.5 ms
(T0 at both lag limits, tied maxima in silent rows, the previous pitch at
each lag limit and out of range, the windowed search taken and not) and on
the port's own encoder rows at each frame size; K21 on fx_ola_plan (every
stream through the passthrough, pat2, pat3, pat4 and pat1) and
fx_ola_edge_plan (the pitch indices at the ends of their ranges, passes at
pitch 0, where pitch_int <= shift, with each fade sign, silent and
full-scale frames) at 48 kHz (chunks of 32) and at 8 kHz (pitch lags from
19: chunks shorter than a warp). Copies of the headers with one line
changed must fail. It skips where there is no g++."""
from __future__ import annotations

import ctypes
import functools

import numpy as np
import pytest
import torch

import audio_codec_torch as P
from audio_codec_torch import kernels as K
from audio_codec_torch.ops import analysis, numerics

from tests import torch_kernel_cases as C
from tests.test_torch_lane_rehearsal import build_wrapper, ptr

ON_CPU = numerics.on_cpu   # the port's own test, for the encoder's CPU path

WRAPPER = r"""
#include "olpa.cuh"
#include "fx_ola_ltpf.cuh"
#include <cstring>
#include <vector>
using namespace acx;

extern "C" {
void rehearse_olpa_warp(const float* s, int s_stride, const float* m12, const float* m64,
                        const int* mp, const float* tab, int B, int length, int len2,
                        int mem_in_len, int acflen, int base, int* pitch2, float* nc, int* t0,
                        float* n12, float* n64) {
  const OlpaGeom g = {length, len2, mem_in_len, acflen, base};
  OlpaScratch S;
  for (int b = 0; b < B; ++b) {
    std::memset(&S, 0x5A, sizeof S);
    float* o12 = n12 + 3 * b;
    float* o64 = n64 + mem_in_len * b;
    std::memset(o12, 0x5A, 3 * sizeof(float));
    std::memset(o64, 0x5A, mem_in_len * sizeof(float));
    const OlpaStream st = {s + s_stride * b, m12 + 3 * b, m64 + mem_in_len * b, mp[b]};
    const OlpaOut o = acflen == 64 ? olpa_warp<64>(CoderHostWarp{}, st, tab, g, S, o12, o64)
                                   : olpa_warp<32>(CoderHostWarp{}, st, tab, g, S, o12, o64);
    t0[b] = o.t0;
    pitch2[b] = 2 * o.t0;
    nc[b] = o.nc;
  }
}
// st: the ten state arrays in the order of kernels.FX_STATE_KEYS
void rehearse_fx_ola_warp(const fx::i64* ytda, const fx::i64* y_e, const fx::i64* y_s,
                          const bool* zero, const int32_t* lp, const fx::i64* tab, fx::i64** st,
                          const int* geom, int B, int16_t* pcm) {
  using namespace acx::fx;
  const OlaGeom g{geom[0], geom[1], geom[2], geom[3], geom[4], geom[5], geom[6], geom[7],
                  geom[8], geom[9], geom[10], geom[11], geom[12], geom[13]};
  std::vector<OlaWord> sc(ola_scratch_words(g));
  const Host w;
  const int memLen = g.wLen - g.N;
  for (int b = 0; b < B; ++b) {
    std::memset(sc.data(), 0x5A, sc.size() * sizeof(OlaWord));
    std::memset(pcm + b * g.N, 0x5A, g.N * sizeof(int16_t));
    const OlaState s{st[0] + b * memLen, st[1] + b, st[2] + b * g.x_len, st[3] + b * g.y_len,
                     st[4] + b, st[5] + b, st[6] + b, st[7] + b, st[8] + b, st[9] + b};
    fx_ola_ltpf_lane(w, ytda + b * g.N, y_e[b], y_s[b], zero[b], lp + 3 * b, tab, g, s,
                     sc.data(), pcm + b * g.N);
  }
}
// the post-filter alone on rows of W_ words (its history below ybase), the
// input rows of xlen words; per row its pitch, gain, fade, interpolation row
// ic [12] and tilt row tc [11]
void rehearse_synth_filter(int32_t* ybuf, int W_, int ybase, const int32_t* x, int xlen,
                           int xbase, int len, const fx::i64* pint, const fx::i64* gain,
                           const int* fade, const fx::i64* ic, const fx::i64* tc,
                           const int* geom, int B) {
  using namespace acx::fx;
  const OlaGeom g{geom[0], geom[1], geom[2], geom[3], geom[4], geom[5], geom[6], geom[7],
                  geom[8], geom[9], geom[10], geom[11], geom[12], geom[13]};
  const Host w;
  for (int b = 0; b < B; ++b) {
    synth_filter_warp(w, ybuf + b * W_, W_, ybase, x + b * xlen, xbase, len, pint[b], gain[b],
                      ic + 12 * b, tc + 11 * b, g, fade[b]);
  }
}
}
"""

# mutations the rehearsal must catch: K3's energy chain started from zero
# (its first square dropped), a lag one off, e0 on the wrong offset, the
# first-maximum tree's tie rule strict (a tie keeps a lane's own entry);
# K21's chunk one sample longer than d, the interpolation tap loop reversed
# (the history walked the other way against the coefficients), the fade's
# closed form one step off, and a sat32 dropped (the tilt chain's: the
# headroom scaling keeps the filter's sums below 2^31 on the plans' frames,
# so the filter alone sees it, on full-scale buffers)
MUTATIONS = {
    "energy_chain_from_zero": ("olpa.cuh", "ee[k] = n == 0 ? q : radd(ee[k], q);",
                               "ee[k] = n == 0 ? 0.0f : radd(ee[k], q);"),
    "lag_one_off": ("olpa.cuh", "const float* win = cur - kOlpaMinPitch - (l + 64);",
                    "const float* win = cur - kOlpaMinPitch - (l + 63);"),
    "e0_wrong_offset": ("olpa.cuh", "const float* s3 = l + 96 < kOlpaLags ? win - 32 : cur;",
                        "const float* s3 = l + 96 < kOlpaLags ? win - 32 : cur - 1;"),
    "tie_rule_strict": ("olpa.cuh", "if (first_max_beats(pv[l], pi[l], v[l], i[l])) {",
                        "if (pv[l] > v[l]) {"),
    "chunk_past_d": ("fx_ola_ltpf.cuh", "const int c = static_cast<int>(min64(d, kOlaChunk));",
                     "const int c = static_cast<int>(min64(d + 1, kOlaChunk));"),
    "tap_loop_reversed": ("fx_ola_ltpf.cuh",
                          "for (int l = 0; l < kOlaMaxIlen; ++l) y[l] = ybuf[xb - l];",
                          "for (int l = 0; l < kOlaMaxIlen; ++l) y[l] = ybuf[xb - (kOlaMaxIlen - 1 - l)];"),
    "fade_one_step_off": ("fx_ola_ltpf.cuh", "return sat16_32(t.alpha0 + j * t.step);",
                          "return sat16_32(t.alpha0 + (j + 1) * t.step);"),
    "sat32_dropped": ("fx_ola_ltpf.cuh",
                      "for (int l = 0; l < kOlaMaxTlen; ++l) s = sub_sat32(s, lmult16(xj[-l], t.tc[l]));",
                      "for (int l = 0; l < kOlaMaxTlen; ++l) s = static_cast<int32_t>("
                      "static_cast<uint32_t>(s) - static_cast<uint32_t>(lmult16(xj[-l], t.tc[l])));"),
}

FRAMES = {"10ms": 100, "5ms": 50, "2.5ms": 25}
OLPA_CASES = [(name, frames) for name in ("olpa_rows", "encoder_rows") for frames in FRAMES]
RATES = {"48k": dict(fs_in=48000, bitrate=64000), "8k": dict(fs_in=8000, bitrate=24000)}
PLANS = ("plan", "edge_plan")


@pytest.fixture(scope="module")
def lib(tmp_path_factory):
    return build_wrapper(tmp_path_factory.mktemp("olpa_ola"), WRAPPER, "olpa_ola", MUTATIONS)


@pytest.fixture
def card_order(monkeypatch):
    """The plain versions compute as they do for a tensor on a card."""
    monkeypatch.setattr(numerics, "on_cpu", lambda x: False)


def rows_of(a: dict, sl: slice) -> dict:
    return {k: v[sl] for k, v in a.items()}


# ---- K3 ----

def config(frame_dms: int = 100):
    return P.Config(fs_in=48000, bitrate=64000, frame_dms=frame_dms)


@functools.cache
def encoder_rows(frame_dms: int) -> dict:
    """The arguments of the port's olpa at each frame of 6 streams of seeded
    tones, pulses and noise over 4 frames at 48 kHz and this frame size (the
    CPU path)."""
    cfg = config(frame_dms)
    rng = np.random.default_rng(frame_dms + 11)
    B, T_, n = 6, 4, cfg.frame_length
    k = np.arange(T_ * n)
    pcm = np.stack([np.sin(2 * np.pi * (70 + 83 * s) * k / 48000) * 6000 * (1 + s % 3)
                    + (np.where(k % (150 + 37 * s) == 0, 9000.0, 0.0) if s % 2 else 0.0)
                    + rng.standard_normal(k.size) * 10.0 ** (s % 4) for s in range(B)])
    pcm = torch.from_numpy(pcm.reshape(B, T_, n).transpose(1, 0, 2).astype(np.float32))
    calls = []
    olpa = analysis.olpa

    def rec(c, *a):
        calls.append([t.clone() for t in a])
        return olpa(c, *a)
    patched = numerics.on_cpu
    analysis.olpa, numerics.on_cpu = rec, ON_CPU
    try:
        P.encode_block(cfg, P.enc_state_init(cfg, B, device="cpu"), pcm)
    finally:
        analysis.olpa, numerics.on_cpu = olpa, patched
    return {k_: np.ascontiguousarray(np.concatenate([c[i].numpy() for c in calls]),
                                     np.int32 if k_ == "mem_pitch" else np.float32)
            for i, k_ in enumerate(C.OLPA_ORDER)}


def olpa_cases(name: str, frame_dms: int) -> dict:
    if name == "olpa_rows":
        return C.olpa_rows(seed=1, frame_dms=frame_dms)
    return encoder_rows(frame_dms)


def warp_olpa(lib, cfg, a: dict):
    s, m12, m64, mp = (np.ascontiguousarray(a[k], np.int32 if k == "mem_pitch" else np.float32)
                       for k in C.OLPA_ORDER)
    B = s.shape[0]
    length = cfg.len_12k8
    mem_in_len = m64.shape[1]
    acflen = length // 2 + (16 if cfg.frame_dms == 25 else 0)
    base = mem_in_len - 16 if cfg.frame_dms == 25 else mem_in_len
    pitch2, t0 = np.zeros(B, np.int32), np.zeros(B, np.int32)
    nc = np.zeros(B, np.float32)
    n12, n64 = np.zeros((B, 3), np.float32), np.zeros((B, mem_in_len), np.float32)
    lib.rehearse_olpa_warp(ptr(s), s.shape[1], ptr(m12), ptr(m64), ptr(mp),
                           ptr(K._olpa_tables("cpu").numpy()), B, length, length // 2,
                           mem_in_len, acflen, base, ptr(pitch2), ptr(nc), ptr(t0), ptr(n12),
                           ptr(n64))
    return pitch2, nc, t0, n12, n64


def plain_olpa(cfg, a: dict):
    return [np.ascontiguousarray(v.numpy()) for v in analysis.olpa_plain(
        cfg, *(torch.from_numpy(np.asarray(a[k])) for k in C.OLPA_ORDER))]


def olpa_differing(lib, cfg, a: dict) -> int:
    return C.count_differing(list(warp_olpa(lib, cfg, a)), plain_olpa(cfg, a))


# ---- K21 ----

def rate_config(rate: str):
    return P.Config(**RATES[rate])


@functools.cache
def ola_plan(rate: str, plan: str) -> dict:
    N = rate_config(rate).frame_length
    return (C.fx_ola_plan if plan == "plan" else C.fx_ola_edge_plan)(B=33, seed=3, N=N)


@functools.cache
def ola_plain(rate: str, plan: str):
    """The plan's frames through the plain version from a fresh state:
    (per frame the PCM and the state after it, pattern histogram, pass
    lags). A stream's frames depend on its own state alone, so a slice of
    streams is the slice of these."""
    from audio_codec_torch.fixed_decoder_dev import DeviceFixedDecoder
    from audio_codec_torch.ops import fixed_ltpf_dev
    cfg, p = rate_config(rate), ola_plan(rate, plan)
    T_, B = p["y_e"].shape
    dec = DeviceFixedDecoder(cfg, B, device="cpu")
    st = dec.state
    frames, hist, lags = [], np.zeros(5, np.int64), {}
    for t in range(T_):
        f = {k: torch.from_numpy(np.ascontiguousarray(p[k][t]))
             for k in ("ytda", "y_e", "y_s", "zero", "lp")}
        hist += torch.bincount(fixed_ltpf_dev.ltpf_patterns(st, f["lp"], cfg.fs_idx),
                               minlength=5).numpy()
        for k, v in C.fx_ola_pass_lags(st, p["lp"][t], cfg.fs_idx, dec.sfi).items():
            lags[k] = lags.get(k, 0) + v
        pcm = fixed_ltpf_dev.ola_ltpf_plain(cfg, st, f["ytda"], f["y_e"], f["y_s"], f["zero"],
                                            f["lp"], dec.sfi)
        frames.append((pcm.numpy(), {k: st[k].numpy().copy() for k in K.FX_STATE_KEYS}))
    return frames, hist, lags


def ola_differing(lib, rate: str, plan: str, sl: slice = slice(None)) -> int:
    """The streams sl of the plan through the warp design, frame by frame
    from a fresh state, against the plain version: values that differ over
    the PCM and the state."""
    from audio_codec_torch.fixed_decoder_dev import DeviceFixedDecoder
    cfg = rate_config(rate)
    p = {k: np.ascontiguousarray(v[:, sl]) for k, v in ola_plan(rate, plan).items()}
    frames = ola_plain(rate, plan)[0]
    T_, B = p["y_e"].shape
    dec = DeviceFixedDecoder(cfg, B, device="cpu")
    st = {k: dec.state[k].numpy().copy() for k in K.FX_STATE_KEYS}
    geom = np.array(K.fx_ola_geometry(cfg, dec.sfi), np.int32)
    tab = K.fx_ola_table_pack(cfg.frame_length, cfg.fs_idx)
    bad = 0
    for t in range(T_):
        pcm = np.zeros((B, cfg.frame_length), np.int16)
        arrs = [st[k] for k in K.FX_STATE_KEYS]
        pp = (ctypes.c_void_p * len(arrs))(*[a.ctypes.data for a in arrs])
        lib.rehearse_fx_ola_warp(*(ptr(np.ascontiguousarray(p[k][t], dt)) for k, dt in (
            ("ytda", np.int64), ("y_e", np.int64), ("y_s", np.int64), ("zero", np.bool_),
            ("lp", np.int32))), ptr(tab), pp, ptr(geom), B, ptr(pcm))
        ref_pcm, ref_st = frames[t]
        bad += C.count_differing(pcm, ref_pcm[sl])
        bad += sum(C.count_differing(st[k], ref_st[k][sl]) for k in K.FX_STATE_KEYS)
    return bad


def synth_rows(cfg, seed: int = 0) -> dict:
    """Passes of the post-filter alone: pitch_int from 0 (d <= 0) through
    every d from 1 to 40 and beyond, each fade sign, over histories and
    inputs at full scale (the history's signs those of the interpolation
    taps, the input's against the tilt taps: the sums saturate) and seeded
    Word16 values; a pass of 2 N4 samples, so that the fade saturates."""
    from audio_codec_torch.ops import fixed_ltpf_dev as fld
    from audio_codec_torch import tables as T
    geo = fld.filter_geometry(cfg.fs_idx)
    shift, N4 = geo["shift"], geo["N4"]
    rng = np.random.default_rng(seed)
    y_len = K.fx_ola_geometry(cfg, 0)[3]
    pints = [0, 1, shift] + list(range(shift + 1, shift + 41)) + [shift + 64, 3 * y_len // 4]
    rows = [(pi, fade, kind) for pi in pints for fade in (-1, 0, 1) for kind in ("full", "seeded")]
    B, L = len(rows), 2 * N4
    W = y_len + L
    xbase = geo["tlen"] + 3
    inter = np.asarray(T.t("fx_inter_filter")[cfg.fs_idx], np.int64)
    tilt = np.asarray(T.t("fx_tilt_filter")[cfg.fs_idx], np.int64)
    ybuf = np.zeros((B, W), np.int64)
    x = np.zeros((B, xbase + L), np.int64)
    ic, tc = np.zeros((B, 12), np.int64), np.zeros((B, 11), np.int64)
    pint, gain, fade = (np.zeros(B, np.int64) for _ in range(3))
    for b, (pi, fd_, kind) in enumerate(rows):
        ic[b] = inter[b % 4]
        tc[b] = tilt[(b // 4) % 4]
        if kind == "full":
            ybuf[b, :y_len] = np.where(np.resize(ic[b, :geo["ilen"]], y_len) >= 0, 32767, -32768)
            x[b] = np.where(np.resize(tc[b, :geo["tlen"] + 1], x.shape[1]) >= 0, -32768, 32767)
        else:
            ybuf[b, :y_len] = rng.integers(-32768, 32768, y_len)
            x[b] = rng.integers(-32768, 32768, x.shape[1])
        pint[b], gain[b], fade[b] = pi, (13108, 11468, 9832, 8192)[b % 4], fd_
    return dict(ybuf=ybuf, x=x, ic=ic, tc=tc, pint=pint, gain=gain, fade=fade, y_len=y_len,
                xbase=xbase, L=L)


def synth_differing(lib, cfg, r: dict) -> int:
    """The host group's synth_filter_warp against the plain _synth_filter."""
    from audio_codec_torch.ops import fixed_ltpf_dev as fld
    geo = fld.filter_geometry(cfg.fs_idx)
    B, W = r["ybuf"].shape
    y = np.ascontiguousarray(r["ybuf"], np.int32)
    x = np.ascontiguousarray(r["x"], np.int32)
    geom = np.array(K.fx_ola_geometry(cfg, 0), np.int32)
    lib.rehearse_synth_filter(ptr(y), W, r["y_len"], ptr(x), x.shape[1], r["xbase"], r["L"],
                              ptr(r["pint"]), ptr(r["gain"]),
                              ptr(np.ascontiguousarray(r["fade"], np.int32)), ptr(r["ic"]),
                              ptr(r["tc"]), ptr(geom), B)
    g = lambda a: torch.from_numpy(np.asarray(a))
    ilen, tlen = geo["ilen"], geo["tlen"]
    ref = fld._synth_filter(g(r["ybuf"].copy()), r["y_len"],
                            fld._windows(g(r["x"]), r["xbase"], r["L"], tlen), r["L"],
                            g(r["pint"]), g(r["gain"]), g(r["ic"][:, :ilen]),
                            g(r["tc"][:, :tlen + 1]), ilen, tlen, geo["shift"], g(r["fade"]),
                            geo["N4"], torch.ones(B, dtype=torch.bool))
    return C.count_differing(y.astype(np.int64), ref.numpy())


# ---- the tests ----

@pytest.mark.parametrize("streams", [1, 33])
@pytest.mark.parametrize("name,frames", OLPA_CASES)
def test_olpa_warp_matches_plain(lib, card_order, name, frames, streams):
    cfg = config(FRAMES[frames])
    a = olpa_cases(name, cfg.frame_dms)
    assert olpa_differing(lib, cfg, rows_of(a, slice(0, streams))) == 0
    assert olpa_differing(lib, cfg, rows_of(a, slice(-streams, None))) == 0


@pytest.mark.parametrize("name,frames", OLPA_CASES)
def test_olpa_warp_matches_plain_on_every_row_and_branch(lib, card_order, name, frames):
    """Every row of the case at once; on the synthetic rows T0 reaches both
    lag limits and the windowed search is taken and not taken."""
    cfg = config(FRAMES[frames])
    a = olpa_cases(name, cfg.frame_dms)
    got = warp_olpa(lib, cfg, a)
    assert C.count_differing(list(got), plain_olpa(cfg, a)) == 0
    if name == "olpa_rows":
        hist = C.olpa_branches(a, got)
        assert all(v > 0 for v in hist.values()), hist


@pytest.mark.parametrize("streams", [1, 33])
@pytest.mark.parametrize("plan", PLANS)
@pytest.mark.parametrize("rate", list(RATES))
def test_ola_warp_matches_plain(lib, rate, plan, streams):
    assert ola_differing(lib, rate, plan, slice(0, streams)) == 0
    assert ola_differing(lib, rate, plan, slice(-streams, None)) == 0


@pytest.mark.parametrize("plan", PLANS)
@pytest.mark.parametrize("rate", list(RATES))
def test_ola_warp_reaches_every_branch_and_lag(lib, rate, plan):
    """All 33 streams at once; every post-filter pattern; at 8 kHz passes
    with d < 32; on the edge plan passes with pitch_int <= shift."""
    assert ola_differing(lib, rate, plan) == 0
    _, hist, lags = ola_plain(rate, plan)
    assert bool((hist > 0).all()), hist.tolist()
    assert lags["d >= 32"] > 0, lags
    if rate == "8k":
        assert lags["d < 32"] > 0, lags
    if plan == "edge_plan":
        assert lags["d <= 0"] > 0, lags


@pytest.mark.parametrize("rate", list(RATES))
def test_synth_filter_warp_matches_plain_at_every_lag(lib, rate):
    """The filter's passes alone, at every d from 1 to 40 (chunks of d where
    d < 32), at d <= 0 and at full scale, where its sums saturate."""
    assert synth_differing(lib, rate_config(rate), synth_rows(rate_config(rate))) == 0


def test_fade_closed_form_equals_the_iteration():
    """alpha after j steps of sat16(alpha + step) from 0x7FFF (step < 0) or
    0 (step > 0) is clamp(alpha0 + j step, -32768, 32767), at every rate's
    step and at steps that saturate within the pass."""
    from audio_codec_torch.ops.fixed_ltpf import _FADE_STEP
    for step in [*(_FADE_STEP.values()), 5000, 32767]:
        for sign, a0 in ((-1, 0x7FFF), (1, 0)):
            a, s = a0, sign * step
            for j in range(200):
                assert a == max(-32768, min(32767, a0 + j * s)), (step, sign, j)
                a = max(-32768, min(32767, a + s))


@pytest.mark.parametrize("mutation", list(MUTATIONS))
def test_rehearsal_catches_mutated_olpa_ola_warps(tmp_path, card_order, mutation):
    lib_m = build_wrapper(tmp_path, WRAPPER, "olpa_ola", MUTATIONS, mutation)
    bad = 0
    if MUTATIONS[mutation][0] == "olpa.cuh":
        for frame_dms in FRAMES.values():
            cfg = config(frame_dms)
            bad += olpa_differing(lib_m, cfg, C.olpa_rows(seed=1, frame_dms=frame_dms))
    else:
        for rate in RATES:
            cfg = rate_config(rate)
            bad += synth_differing(lib_m, cfg, synth_rows(cfg))
            for plan in PLANS:
                bad += ola_differing(lib_m, rate, plan)
    assert bad > 0, f"the rehearsal did not see the mutation {mutation}"
