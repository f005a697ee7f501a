"""The CUDA kernels of audio_codec_torch against their plain versions, on a
card. Run where a CUDA device is present:

    python -m pytest -m gpu tests/test_torch_kernels_gpu.py

Elsewhere every test here skips. Each kernel is compared on every launch of
an 8-frame main-path run over speech, music and noise (LTPF is off in every
stream at the first frames, and the encoder calls bit_estimate in two
modes). Every kernel but ltpf_postfilter must match bit for bit;
ltpf_postfilter within 1e-2 on the +-32768 PCM scale (the kernel fuses each
tap's multiply-add, the plain version on the card rounds the product first).
Synthetic cases add what the main path may not reach: TNS filters of order 8
in both ranges, and a stream whose gain bisection never leaves `iszero`."""
from __future__ import annotations

import wave
from pathlib import Path

import numpy as np
import pytest
import torch

import audio_codec_torch as P
from audio_codec_torch import kernels as K
from audio_codec_torch import tables as T
from audio_codec_torch.ops import analysis, ari, ltpf_dec, quant, tns

pytestmark = pytest.mark.gpu

CFG = P.Config(fs_in=48000, bitrate=64000)
LTPF_TOL = 1e-2
ROOT = Path(__file__).resolve().parent.parent
CASE_BITS = (ltpf_dec.CASE_B, ltpf_dec.CASE_C, ltpf_dec.CASE_D, ltpf_dec.CASE_E,
             ltpf_dec.NEW_ON)


def material(name: str) -> np.ndarray:
    with wave.open(str(ROOT / "material" / f"{name}48.wav")) as w:
        return np.frombuffer(w.readframes(w.getnframes()), np.int16).astype(np.float32)


@pytest.fixture(scope="module")
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU build)")
    K.library()
    return torch.device("cuda")


def record(store: dict):
    """Wrap every kernel so that each launch's arguments are appended to
    store[name]; returns a function that undoes the wrapping."""
    saved = {n: getattr(K, n) for n in K.KERNELS}

    def wrap(name, fn):
        def rec(*a, **k):
            store.setdefault(name, []).append((a, k))
            return fn(*a, **k)
        return rec
    for n, fn in saved.items():
        setattr(K, n, wrap(n, fn))

    def undo():
        for n, fn in saved.items():
            setattr(K, n, fn)
    return undo


@pytest.fixture(scope="module")
def recorded(dev):
    """Arguments of every kernel launch of an 8-frame main-path run of 96
    streams: speech, music (each at its own offset) and seeded noise."""
    rng = np.random.default_rng(0)
    B, T, n = 96, 8, CFG.frame_length
    srcs = (material("speech"), material("music"))
    pcm = np.zeros((T, B, n), np.float32)
    for b in range(B):
        if b % 3 == 2:
            pcm[:, b] = rng.standard_normal((T, n)) * (3000.0 / (1 + b % 7))
        else:
            src = srcs[b % 3]
            off = (b * 4801) % (len(src) - T * n)
            pcm[:, b] = src[off: off + T * n].reshape(T, n)
    store: dict = {}
    undo = record(store)
    try:
        _, frames = P.encode_block(CFG, P.enc_state_init(CFG, B, device=dev),
                                   torch.from_numpy(pcm).to(dev))
        P.decode_block(CFG, P.dec_state_init(CFG, B, device=dev), frames)
    finally:
        undo()
    torch.cuda.synchronize()
    return store


def test_bit_estimate_matches_plain(recorded):
    launches = recorded["bit_estimate"]
    assert sorted({a[3] for a, _ in launches}) == sorted({-1, CFG.modeFlag})
    for args, _ in launches:
        got, ref = K.bit_estimate(*args), quant.bit_estimate_plain(*args)
        for k in ref:
            assert torch.equal(got[k], ref[k]), k
    args = launches[-1][0]
    for mode in (-1, 0, 1):
        a = (args[0], args[1], args[2], mode)
        got, ref = K.bit_estimate(*a), quant.bit_estimate_plain(*a)
        for k in ref:
            assert torch.equal(got[k], ref[k]), (mode, k)


def test_ari_encode_matches_plain(recorded):
    for args, _ in recorded["ari_encode"]:
        assert torch.equal(K.ari_encode(*args), ari.encode_plain(*args))


def test_ari_decode_matches_plain(recorded, dev):
    (args, kw), = recorded["ari_decode"]
    got, ref = K.ari_decode(*args), ari.decode_plain(*args)
    for k in ref:
        assert torch.equal(got[k], ref[k]), k
    cfg, buf, side = args
    bad = torch.randint(0, 256, buf.shape, device=dev, dtype=torch.int32,
                        generator=torch.Generator(device=dev).manual_seed(1))
    from audio_codec_torch.ops import bits
    bside = bits.parse_side_info(cfg, bad)
    got, ref = K.ari_decode(cfg, bad, bside), ari.decode_plain(cfg, bad, bside)
    for k in ref:
        assert torch.equal(got[k], ref[k]), k


def check_ltpf(launches):
    """Every launch against the plain version; returns the number of lanes
    in each case bit over the launches."""
    seen = dict.fromkeys(CASE_BITS, 0)
    for args, _ in launches:
        got, ref = K.ltpf_postfilter(*args), ltpf_dec.ltpf_postfilter_plain(*args)
        assert float((got - ref).abs().max()) <= LTPF_TOL
        for bit in CASE_BITS:
            seen[bit] += int(((args[10] & bit) != 0).sum())
    return seen


def test_ltpf_postfilter_matches_plain(recorded):
    seen = check_ltpf(recorded["ltpf_postfilter"])
    assert all(v > 0 for v in seen.values()), seen


def test_ltpf_postfilter_all_cases(dev):
    """One stream in each cross-fade case, plus a lost frame."""
    cases = [([0, 0, 0], [0, 0, 0]), ([1, 1, 300], [1, 0, 300]),
             ([1, 0, 0], [1, 1, 120]), ([1, 1, 250], [1, 1, 250]),
             ([1, 1, 250], [1, 1, 410]), ([1, 1, 31], [1, 1, 50])]
    rng = np.random.default_rng(2)
    B = len(cases) + 1
    s = material("speech")
    x = np.stack([s[20000 + 997 * b: 20000 + 997 * b + 480] for b in range(B)])
    mem_param = np.array([c[0] for c in cases] + [[1, 1, 200]], np.int32)
    param = np.array([c[1] for c in cases] + [[1, 1, 200]], np.int32)
    bfi = np.zeros(B, np.int32)
    bfi[-1] = 1
    g = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)
    pi, pf = ltpf_dec.decode_pitch(CFG, g(mem_param))
    mem_x = (rng.standard_normal((B, 10)) * 1000).astype(np.float32)
    mem_y = (rng.standard_normal((B, 861)) * 1000).astype(np.float32)
    mem_gain = np.where(mem_param[:, 1] == 1, np.float32(CFG.ltpf_conf_beta), 0)
    mem_beta = np.full(B, CFG.ltpf_conf_beta_idx, np.int32)
    store: dict = {}
    undo = record(store)
    try:
        y = ltpf_dec.ltpf_decode(CFG, g(x), g(bfi), g(param), g(mem_param), g(mem_x),
                                 g(mem_y), pi, pf, g(mem_gain.astype(np.float32)),
                                 g(mem_beta))[0]
    finally:
        undo()
    seen = check_ltpf(store["ltpf_postfilter"])
    assert all(v > 0 for v in seen.values()), seen
    assert not torch.equal(y, g(x))


def same_bits(got, ref) -> bool:
    return torch.equal(got.view(torch.int32), ref.view(torch.int32))


def test_gain_bisection_matches_plain(recorded, dev):
    launches = recorded["gain_bisection"]
    assert len(launches) == 8
    for args, _ in launches:
        assert torch.equal(K.gain_bisection(*args), quant.gain_bisection_plain(*args))
    en, target, offset0 = launches[-1][0]
    en = en.clone()
    en[0] = -200.0            # every block below the low threshold: iszero throughout
    got, ref = K.gain_bisection(en, target, offset0), quant.gain_bisection_plain(en, target, offset0)
    assert torch.equal(got, ref)
    assert int(got[0]) == offset0 - 255   # never raised: the bisection ends at its floor


def order8_filters(dev, B: int = 64, N: int = 400):
    """Seeded spectra and filters of order 8 in two adjoining ranges."""
    rng = np.random.default_rng(4)
    g = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)
    x = g((rng.standard_normal((B, N)) * 10 ** rng.uniform(-2, 4, (B, 1))).astype(np.float32))
    pts = T.t("quants_pts_tns").astype(np.float32)
    rc = g(pts[rng.integers(2, 15, (B, 2, 8))])
    order = g(np.full((B, 2), 8, np.int32))
    lo = g(np.tile(np.array([[12, 200]], np.int32), (B, 1)))
    hi = g(np.tile(np.array([[199, N - 1]], np.int32), (B, 1)))
    return x, rc, order, lo, hi


@pytest.mark.parametrize("name", ["tns_analysis_lattice", "tns_synthesis_lattice"])
def test_tns_lattice_matches_plain(recorded, dev, name):
    plain = getattr(tns, name + "_plain")
    launches = recorded[name]
    assert len(launches) == 8
    for args, _ in launches:
        assert same_bits(getattr(K, name)(*args), plain(*args))
    args = order8_filters(dev, N=launches[0][0][0].shape[1])
    got = getattr(K, name)(*args)
    assert same_bits(got, plain(*args)) and not torch.equal(got, args[0])


def test_hp50_biquad_matches_plain(recorded):
    launches = recorded["hp50_biquad"]
    assert len(launches) == 8
    for args, _ in launches:
        (y, mem), (ry, rmem) = K.hp50_biquad(*args), analysis.hp50_biquad_plain(*args)
        assert same_bits(y, ry) and same_bits(mem, rmem)


def test_launch_counts_move(dev):
    K.reset_launch_counts()
    B = 8
    pcm = torch.zeros((2, B, 480), device=dev)
    _, frames = P.encode_block(CFG, P.enc_state_init(CFG, B, device=dev), pcm)
    P.decode_block(CFG, P.dec_state_init(CFG, B, device=dev), frames)
    assert K.launches == {"ari_encode": 2, "ari_decode": 1, "bit_estimate": 4,
                          "ltpf_postfilter": 2, "gain_bisection": 2,
                          "tns_analysis_lattice": 2, "tns_synthesis_lattice": 2,
                          "hp50_biquad": 2}
