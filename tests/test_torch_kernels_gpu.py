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
in both ranges, a stream whose gain bisection never leaves `iszero`, every
SNS submode with its field widths, the pulse search's silent-target branch,
frames that fire each of the side-info parser's bad-frame triggers, TNS
spectra with dead subdivisions, filters of order 8 and (at 32 kbps) gains
where the LPC weighting decides, concealment rows that take every branch of
the classifier, full-scale, silent and alternating rows for the MDCT and
IMDCT at N = 480 and 160, pitch-analysis rows at the lag limits with the
windowed search taken and not, LTPF rows with each activation rule firing
alone, residual-coder rows with no zero line and a cut n_res at 64 and
16 kbps, and spectrum rows in every branch of the partial concealment
(tests/torch_kernel_cases.py)."""
from __future__ import annotations

import wave
from pathlib import Path

import numpy as np
import pytest
import torch

import audio_codec_torch as P
from audio_codec_torch import kernels as K
from audio_codec_torch import tables as T
from audio_codec_torch.ops import analysis, ari, bits, ltpf_dec, pc, quant, sns, tns, transforms

from tests import torch_kernel_cases as C

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


def same_tensors(got, ref):
    """Every output equal bit for bit; two NaNs count as equal."""
    bad = C.count_differing(got, ref)
    assert bad == 0, f"{bad} values differ"


def pack_args(cfg, fields: dict, dev):
    return (cfg, *(torch.from_numpy(np.asarray(fields[k], np.int32)).to(dev)
                   for k in C.FIELD_ORDER))


def test_side_info_kernels_match_plain_on_the_main_path(recorded):
    assert len(recorded["side_info_pack"]) == 8 and len(recorded["side_info_parse"]) == 1
    for args, _ in recorded["side_info_pack"]:
        same_tensors(K.side_info_pack(*args), bits.pack_side_info_plain(*args))
    (args, _), = recorded["side_info_parse"]
    got = K.side_info_parse(*args)
    same_tensors(got, bits.parse_side_info_plain(*args))
    assert int(got["bfi"].sum()) == 0


@pytest.mark.parametrize("name", list(C.CONFIGS))
def test_side_info_pack_per_stream_widths(dev, name):
    """Every submode's gain and index widths, LTPF on and off, one and two
    TNS filters; with and without the bandwidth field, and a 2.5 ms frame."""
    cfg = P.Config(**C.CONFIGS[name])
    fields = C.side_fields(cfg, 256, seed=3)
    args = pack_args(cfg, fields, dev)
    packed = K.side_info_pack(*args)
    same_tensors(packed, bits.pack_side_info_plain(*args))
    got = K.side_info_parse(cfg, packed[0])
    same_tensors(got, bits.parse_side_info_plain(cfg, packed[0]))
    assert int(got["bfi"].sum()) == 0
    assert torch.equal(got["scf_idx"], args[8]) and torch.equal(got["ltpf_param"], args[7])
    assert torch.equal(got["bp_side"], packed[1]) and torch.equal(got["mask_side"], packed[2])


@pytest.mark.parametrize("trigger", C.BFI_TRIGGERS)
def test_side_info_parse_bad_frame_triggers(dev, trigger):
    packed = bits.pack_side_info_plain(*pack_args(CFG, C.corrupt_fields(CFG, trigger, 32), dev))
    got = K.side_info_parse(CFG, packed[0])
    same_tensors(got, bits.parse_side_info_plain(CFG, packed[0]))
    assert bool((got["bfi"] == 1).all())


def test_side_info_parse_random_bytes(dev):
    rows = torch.randint(0, 256, (4096, CFG.targetBytes), device=dev, dtype=torch.int32,
                         generator=torch.Generator(device=dev).manual_seed(1))
    same_tensors(K.side_info_parse(CFG, rows), bits.parse_side_info_plain(CFG, rows))


def test_sns_vq_kernels_match_plain_on_the_main_path(recorded):
    assert len(recorded["sns_vq_enc"]) == 8 and len(recorded["sns_vq_dec"]) == 8
    seen = torch.zeros(4, dtype=torch.long)
    for args, _ in recorded["sns_vq_enc"]:
        got = K.sns_vq_enc(*args)
        same_tensors(got, sns.sns_vq_enc_plain(*args))
        seen += torch.bincount(got[0][:, 2].long().cpu(), minlength=4)
    assert bool((seen > 0).all()), seen.tolist()
    for args, _ in recorded["sns_vq_dec"]:
        same_tensors([K.sns_vq_dec(*args)], [sns.sns_vq_dec_plain(*args)])


@pytest.mark.parametrize("submode", [0, 1, 2, 3])
def test_sns_vq_dec_every_submode(dev, submode):
    idx = torch.from_numpy(C.scf_idx_grid(submode, 256, seed=7)).to(dev)
    got = K.sns_vq_dec(idx)
    assert bool(torch.isfinite(got).all())
    same_tensors([got], [sns.sns_vq_dec_plain(idx)])


def test_sns_vq_dec_damaged_indices(dev):
    rng = np.random.default_rng(8)
    idx = np.concatenate([C.scf_idx_grid(s, 64, seed=9) for s in range(4)])
    idx[:, 5] = rng.integers(0, 1 << 25, idx.shape[0])
    idx[:, 6] = rng.integers(-2, 12, idx.shape[0])
    idx = torch.from_numpy(idx).to(dev)
    same_tensors([K.sns_vq_dec(idx)], [sns.sns_vq_dec_plain(idx)])


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_sns_vq_enc_synthetic_rows(dev, seed):
    """Seeded rows, an all-zero row, rows with a silent residual (the
    degenerate branch of every pulse search) and rows of every submode."""
    scf = torch.from_numpy(C.scf_rows(seed, 400)).to(dev)
    got = K.sns_vq_enc(scf)
    same_tensors(got, sns.sns_vq_enc_plain(scf))
    seen = torch.bincount(got[0][:, 2].long().cpu(), minlength=4)
    assert bool((seen > 0).all()), seen.tolist()


def test_launch_counts_move(dev):
    K.reset_launch_counts()
    B = 8
    pcm = torch.zeros((2, B, 480), device=dev)
    _, frames = P.encode_block(CFG, P.enc_state_init(CFG, B, device=dev), pcm)
    P.decode_block(CFG, P.dec_state_init(CFG, B, device=dev), frames)
    assert K.launches == {"ari_encode": 2, "ari_decode": 1, "bit_estimate": 4,
                          "ltpf_postfilter": 2, "gain_bisection": 2,
                          "tns_analysis_lattice": 2, "tns_synthesis_lattice": 2,
                          "hp50_biquad": 2, "side_info_pack": 2, "side_info_parse": 1,
                          "sns_vq_dec": 2, "sns_vq_enc": 2, "tns_filter_analysis": 2,
                          "pc_classify": 2, "mdct": 2, "imdct": 2, "olpa": 2,
                          "ltpf_encode": 2, "noise_residual_enc": 2, "spec_decode": 2}


def test_tns_filter_analysis_matches_plain_on_the_main_path(recorded):
    launches = recorded["tns_filter_analysis"]
    assert len(launches) == 8
    on = torch.zeros(2, 2, dtype=torch.long)
    for args, _ in launches:
        got = K.tns_filter_analysis(*args)
        same_tensors(got, tns.tns_filter_analysis_plain(*args))
        two = got[3] == 2
        for f, rows in ((0, torch.ones_like(two)), (1, two)):
            o = got[0][rows, f]
            on[f] += torch.stack([(o == 0).sum(), (o > 0).sum()]).cpu()
    assert bool((on > 0).all()), on.tolist()


@pytest.mark.parametrize("name", list(C.TNS_CONFIGS))
def test_tns_filter_analysis_synthetic_rows(dev, name):
    """All-zero rows, dead subdivisions, order 8 in both filters; at 32 kbps
    (max_pg 2.0) gains in (1.5, 2.0), where the weighting decides."""
    cfg = P.Config(**C.TNS_CONFIGS[name])
    x, bw = C.tns_rows(seed=1)
    args = (cfg, torch.from_numpy(x).to(dev), torch.from_numpy(bw).to(dev))
    got = K.tns_filter_analysis(*args)
    ref, gains = tns._analyze(*args)
    same_tensors(got, ref)
    assert bool((got[0][:, 0] == 8).any()) and bool((got[0][:, 1] == 8).any())
    if name == "48k_32kbps":
        assert int(((gains > 1.5) & (gains < 2.0)).sum()) >= 4


def test_pc_classify_matches_plain_on_the_main_path(recorded):
    launches = recorded["pc_classify"]
    assert len(launches) == 8
    for args, _ in launches:
        same_tensors([K.pc_classify(*args)], [pc.pc_classify_plain(*args)])


def pc_case_args(recorded, dev):
    """Synthetic classifier rows built from the recorded q_old_d and
    q_old_res of the last frame's launch (tests/torch_kernel_cases.py)."""
    args = recorded["pc_classify"][-1][0]
    base = [a[:16].cpu().numpy() for a in args[5:7]]
    a = C.pc_rows(*base, seed=3)
    return a, (CFG, *(torch.from_numpy(a[k]).to(dev) for k in C.PC_ORDER))


def test_pc_classify_every_branch(recorded, dev):
    a, args = pc_case_args(recorded, dev)
    got = K.pc_classify(*args)
    same_tensors([got], [pc.pc_classify_plain(*args)])
    branches = C.pc_branches(a, got.cpu().numpy())
    assert all(v > 0 for v in branches.values()), branches


def test_pc_classify_does_not_synchronise(recorded, dev):
    """The kernel path of pc.pc_classify reads nothing back to the host."""
    _, args = pc_case_args(recorded, dev)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        out = pc.pc_classify(*args)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert out.shape == args[1].shape


@pytest.mark.parametrize("name", ["mdct", "imdct"])
def test_transform_matches_plain_on_the_main_path(recorded, name):
    launches = recorded[name]
    assert len(launches) == 8
    plain = getattr(transforms, name + "_plain")
    for args, _ in launches:
        same_tensors(getattr(K, name)(*args), [t.contiguous() for t in plain(*args)])


@pytest.mark.parametrize("fs,bitrate", [(48000, 64000), (16000, 32000)])
@pytest.mark.parametrize("name", ["mdct", "imdct"])
def test_transform_synthetic_rows(dev, name, fs, bitrate):
    """Full-scale, silent and alternating-sign rows at N = 480 and 160."""
    cfg = P.Config(fs_in=fs, bitrate=bitrate)
    x, mem = C.transform_rows(cfg.frame_length, cfg.la_zeroes, seed=4)
    args = (cfg, torch.from_numpy(x).to(dev), torch.from_numpy(mem).to(dev))
    got = getattr(K, name)(*args)
    same_tensors(got, [t.contiguous() for t in getattr(transforms, name + "_plain")(*args)])
    assert bool(torch.isfinite(got[0]).all())


def test_transform_rejects_hr_frames(dev):
    cfg = P.Config(fs_in=48000, bitrate=64000)
    x = torch.zeros((2, 960), device=dev)
    with pytest.raises(ValueError):
        K.mdct(cfg, x, torch.zeros((2, 960 - cfg.la_zeroes), device=dev))


PITCH_SPECTRUM_PLAIN = {"olpa": analysis.olpa_plain, "ltpf_encode": analysis.ltpf_encode_plain,
                "noise_residual_enc": quant.noise_residual_enc_plain,
                "spec_decode": quant.spectrum_decode_plain}


@pytest.mark.parametrize("name", list(PITCH_SPECTRUM_PLAIN))
def test_pitch_and_spectrum_kernel_matches_plain_on_the_main_path(recorded, name):
    launches = recorded[name]
    assert len(launches) == 8
    for args, _ in launches:
        ref = PITCH_SPECTRUM_PLAIN[name](*args)
        same_tensors(getattr(K, name)(*args), [t.contiguous() for t in ref])


def on_card(a: dict, order, dev) -> tuple:
    return tuple(torch.from_numpy(np.ascontiguousarray(a[k])).to(dev) for k in order)


def test_olpa_synthetic_rows(dev):
    """Pulse trains and tones at the lag limits, the windowed search taken
    and not, silent rows, empty windows."""
    a = C.olpa_rows(seed=2)
    args = (CFG, *on_card(a, C.OLPA_ORDER, dev))
    got = K.olpa(*args)
    same_tensors(got, [t.contiguous() for t in analysis.olpa_plain(*args)])
    branches = C.olpa_branches(a, [t.cpu().numpy() for t in got])
    assert all(v > 0 for v in branches.values()), branches


def test_ltpf_encode_synthetic_rows(dev):
    """Periods at both lag limits and across the resolution steps, the
    search's lowest lag, each activation rule firing alone, nc_ol on both
    sides of 0.6."""
    a = C.ltpf_rows(seed=2)
    args = (CFG, *on_card(a, C.LTPF_ORDER, dev))
    got = K.ltpf_encode(*args)
    same_tensors(got, [t.contiguous() for t in analysis.ltpf_encode_plain(*args)])
    branches = C.ltpf_branches(a, [t.cpu().numpy() for t in got])
    assert all(v > 0 for v in branches.values()), branches


@pytest.mark.parametrize("bitrate", [64000, 16000])
def test_noise_residual_enc_synthetic_rows(dev, bitrate):
    """No zero line, silent rows, n_res cut below the nonzero lines, lsbMode;
    at 16 kbps (20 bytes) the two half means."""
    cfg = P.Config(fs_in=48000, bitrate=bitrate)
    a = C.nre_rows(cfg, seed=3)
    args = (cfg, *on_card(a, C.NRE_ORDER, dev))
    got = K.noise_residual_enc(*args)
    same_tensors(got, quant.noise_residual_enc_plain(*args))
    branches = C.nre_branches(a, [t.cpu().numpy() for t in got], cfg)
    assert all(v > 0 for v in branches.values()), branches


def spec_case_args(dev, seed: int = 4):
    a = C.spec_rows(CFG, seed=seed)
    return a, (CFG, *on_card(a, C.SPEC_ORDER, dev))


def test_spec_decode_synthetic_rows(dev):
    """bfi 0, 1 and 2, the bandwidth redo, zero frames, cut residuals and
    every branch of the partial concealment."""
    a, args = spec_case_args(dev)
    same_tensors(K.spec_decode(*args), [t.contiguous() for t in quant.spectrum_decode_plain(*args)])
    branches = C.spec_branches(a, CFG)
    assert all(v > 0 for v in branches.values()), branches


def test_spec_decode_does_not_synchronise(dev):
    """The kernel path of quant.spectrum_decode reads nothing back to the
    host."""
    _, args = spec_case_args(dev, seed=5)
    quant.spectrum_decode(*args)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        out = quant.spectrum_decode(*args)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert out[0].shape == args[1].shape
