"""The CUDA kernels of audio_codec_torch against their plain versions, on a
card. Run where a CUDA device is present:

    python -m pytest -m gpu tests/test_torch_kernels_gpu.py

Elsewhere every test here skips. Each kernel is compared on every launch of
an 8-frame main-path run over speech, music and noise (LTPF is off in every
stream at the first frames, and the encoder calls bit_estimate in two
modes). Every kernel must match its plain version bit for bit.
Synthetic cases add what the main path may not reach: TNS filters of order 8
in both ranges, a stream whose gain bisection never leaves `iszero`, every
SNS submode with its field widths, gain_rows at M = 25-120 from every
configuration's starting offset (iszero throughout, blocks on both
thresholds, targets within an ulp of a tested ener; 1, 24, 33 and 2047
streams a launch), tns_rows 1, 33 and 2047 streams a launch, the pulse
search's silent-target branch,
frames that fire each of the side-info parser's bad-frame triggers, TNS
spectra with dead subdivisions, filters of order 8 and (at 32 kbps) gains
where the LPC weighting decides, concealment rows that take every branch of
the classifier, full-scale, silent and alternating rows, rows of negative
zeros, subnormal-scale rows and rows near 1e37 for the MDCT (in both of its
orders) and the IMDCT at N = 480 and 160, pitch-analysis rows at the lag limits with the
windowed search taken and not, LTPF rows with each activation rule firing
alone, residual-coder rows with no zero line and a cut n_res at 64 and
16 kbps, spectrum rows in every branch of the partial concealment and
spec_edge_rows (lines at the bandwidth and the windows' and chunks' edges,
lines a nudge makes zero) at 48 and 16 kHz, and SNS indices of every submode
and damaged ones, at 1, 33 and 2048 streams a launch, and
both TNS lattices on tns_lattice_rows (also one stream a launch) and, on
every launch and those rows, against their plain versions run on the CPU,
and both range coders on coder_rows at 64 and 160 kbps and in the
high-resolution mode, 2048 streams a launch and one (ari_encode's lane-0
path never taken on the main path, taken on the rows over their budget)
(tests/torch_kernel_cases.py). The channel coder's kernels run on slots of
40-300 bytes at EP1-4 with and without combined channel coding and on
injected errors (the decoder also at 1, 33 and 2048 slots a launch, on
total failures and on the 40-byte slot's cap; the encoder at every slot of
FEC_SLOTS and at 241, the first of 33 codewords, at 1, 33 and 2048 slots
a launch), the range decoder on frames with a partial-concealment
block (bfi 0 and 2, and the encoder's simulation) and on decode_rows (coded
coder_rows with LSB-mode and bad frames, in all three of its modes) at 1, 33,
2047 and 16 384 frames a launch, the resampler's biquad at 1, 33 and 2047
streams over 3 frames, also on rows that take its general loop; the four concealment
kernels and the TDAC's compensated MDCT (plc_mode 1) and the standard concealment's plc_main (plc_mode 0) on
every launch of a lossy block over speech, music, noise and tones and on
their synthetic rows (plc_main: every damping branch, the generator's edge
seeds, bfi 2; phecu_spec_ana also on phecu_edge_rows at 1, 8, 33 and 2048
streams a launch: a tie, edge peaks, a scan that ends in mode 1, an all-zero
row, a many-peak row, the drop rule taken and not; phecu_subst and
plc_damp_scramble on their edge rows and with every stream at work at 1, 33,
2047 and 2048 streams a launch); a warmed encode_frame, decode_frame (plc_mode 0, clean and
lossy, and 1) and the stream path's device step at EP3 run under
torch.cuda.set_sync_debug_mode("error"). The four kernels of the
bit-exact fixed-point decoder (DeviceFixedDecoder) run on every launch of a
B = 64 block with silent streams and on their synthetic rows (every SNS
submode and out-of-range indices, silent, full-scale and order-8 spectra,
all-zero, full-scale and alternating DCT rows, the post-filter through
passthrough and its four patterns, at 48 and 8 kHz with passes at
pitch_int <= shift, 1, 33 and 2048 streams a launch; the DCT-IV's edge rows
at 1, 33 and 16 384 rows), equal to their plain
versions with no tolerance; the card's PCM equals the stored reference's and
the CPU's. The pitch search runs its rows at 10, 5 and 2.5 ms, 1, 33 and
2048 streams a launch."""
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
    """Wrap every kernel (and ari_decode_frames, the parsed mode of
    ari_decode) so that each launch's arguments are appended to
    store[wrapper name]; returns a function that undoes the wrapping."""
    saved = {n: getattr(K, n) for n in K.KERNELS + ("ari_decode_frames",)}

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


def coder_case_args(name: str, dev, B: int | None = None) -> tuple:
    """coder_rows at a configuration of C.CODER_CONFIGS on the card, tiled
    to B streams where B is given: (cfg, the rows as tensors)."""
    cfg = P.Config(**C.CODER_CONFIGS[name])
    d = C.coder_rows(cfg, seed=2)
    n = d["xq"].shape[0]
    pick = np.arange(n) if B is None else np.resize(np.arange(n), B)
    return cfg, {k: torch.from_numpy(np.ascontiguousarray(v[pick])).to(dev) for k, v in d.items()}


def test_bit_estimate_matches_plain(recorded, dev):
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
    # coder_rows at each configuration and mode, all at once (B = 2048) and
    # every seventh alone (B = 1)
    for name in C.CODER_CONFIGS:
        for B in (2048, None):
            cfg, d = coder_case_args(name, dev, B)
            for mode in (-1, 0, 1):
                rows = range(d["xq"].shape[0]) if B is None else [None]
                for i in rows:
                    if i is not None and i % 7:
                        continue
                    one = slice(None) if i is None else slice(i, i + 1)
                    a = (cfg, d["xq"][one], d["target"][one], mode)
                    got, ref = K.bit_estimate(*a), quant.bit_estimate_plain(*a)
                    for k in ref:
                        assert torch.equal(got[k], ref[k]), (name, B, i, mode, k)


def test_ari_encode_matches_plain(recorded, dev):
    """Every main-path launch takes the warp path (the lane-0 counter stays
    0); coder_rows at each configuration, at B = 2048 and every seventh row
    alone, equal the plain version, and the rows over their budget take the
    lane-0 path."""
    K.reset_ari_encode_lane0_streams(dev)
    for args, _ in recorded["ari_encode"]:
        assert torch.equal(K.ari_encode(*args), ari.encode_plain(*args))
    assert K.ari_encode_lane0_streams(dev) == 0
    for name in C.CODER_CONFIGS:
        cfg, d = coder_case_args(name, dev, 2048)
        args = tuple(d[k] for k in C.CODER_ARI_ORDER)
        K.reset_ari_encode_lane0_streams(dev)
        assert torch.equal(K.ari_encode(cfg, *args), ari.encode_plain(cfg, *args)), name
        lane0 = K.ari_encode_lane0_streams(dev)
        assert 0 < lane0 < 2048, (name, lane0)
        cfg, d = coder_case_args(name, dev)
        for i in range(0, d["xq"].shape[0], 7):
            one = tuple(d[k][i: i + 1] for k in C.CODER_ARI_ORDER)
            assert torch.equal(K.ari_encode(cfg, *one), ari.encode_plain(cfg, *one)), (name, i)


def test_ari_decode_matches_plain(recorded, dev):
    """The block's one launch (parsed mode) on both dicts; random bytes in
    the parsed mode and, with the plain parse's fields, in the read mode."""
    (args, kw), = recorded["ari_decode_frames"]
    same_tensors(K.ari_decode_frames(*args, **kw), ari.parse_and_decode_plain(*args, **kw))
    cfg, buf = args[:2]
    bad = torch.randint(0, 256, buf.shape, device=dev, dtype=torch.int32,
                        generator=torch.Generator(device=dev).manual_seed(1))
    ref = ari.parse_and_decode_plain(cfg, bad)
    same_tensors(K.ari_decode_frames(cfg, bad), ref)
    same_tensors(K.ari_decode(cfg, bad, ref[0]), ref[1])


def decode_rows_on_card(name: str, dev, pick=None) -> tuple:
    """tests/torch_kernel_cases.py:decode_rows at DECODE_CONFIGS[name] on the
    card, the rows `pick` (all where None): (cfg, frames, side, the PC
    flags or [])."""
    cfg = P.Config(**C.DECODE_CONFIGS[name])
    d = C.decode_rows(name)
    pick = np.arange(len(d["frames"])) if pick is None else np.asarray(pick)
    t = {k: torch.from_numpy(np.ascontiguousarray(v[pick])).to(dev) for k, v in d.items()}
    flags = [t[k] for k in ("bfi_in", "be_l", "be_r")] if cfg.n_pc else []
    return cfg, t["frames"], {k: t[k] for k in C.DECODE_SIDE_KEYS}, flags


@pytest.mark.parametrize("name", list(C.DECODE_CONFIGS))
def test_ari_decode_decode_rows_at_every_size(dev, name):
    """decode_rows every 25th row alone, and tiled to 33, 2047 and 16 384
    frames a launch, in each of the kernel's modes (no PC block; the PC
    decode and the encoder's simulation at EP3/EP4): every output equals the
    plain version's rows of the same inputs."""
    cfg, frames, side, flags = decode_rows_on_card(name, dev)
    n = frames.shape[0]
    for sim in ((False, True) if cfg.n_pc else (False,)):
        ref = ari.decode_plain(cfg, frames, side, *flags, pc_enc_sim=sim)
        assert bool((ref["bfi"] != 0).any()) and bool((ref["bfi"] == 0).any())
        picks = [[i] for i in range(0, n, 25)] + [np.resize(np.arange(n), L)
                                                  for L in (33, 2047, 16384)]
        for pick in picks:
            c, f, sd, fl = decode_rows_on_card(name, dev, pick)
            got = K.ari_decode(c, f, sd, *fl, pc_enc_sim=sim)
            idx = torch.as_tensor(pick, device=dev)
            same_tensors([got[k] for k in ref], [v[idx] for v in ref.values()])


@pytest.mark.parametrize("B", [1, 33, 2047])
def test_hp50_biquad_rows_over_three_frames(dev, B):
    """biquad_rows over 3 frames, the memories carried, through the
    register path (N = 128, aligned rows) and the general loop (N = 100,
    and N = 128 rows 4 bytes off a 16-byte boundary)."""
    x = C.biquad_rows(B)
    for N, shift in ((128, 0), (100, 0), (128, 1)):
        mem_k = torch.zeros((B, 2), device=dev)
        mem_p = mem_k.clone()
        for f in range(3):
            buf = torch.empty(B * N + shift, device=dev)
            xf = buf[shift:].view(B, N)
            xf.copy_(torch.from_numpy(x[f, :, :N]).to(dev))
            (y, mem_k), (ry, mem_p) = K.hp50_biquad(xf, mem_k), analysis.hp50_biquad_plain(xf, mem_p)
            assert same_bits(y, ry) and same_bits(mem_k, mem_p), (N, shift, f)


def check_ltpf(launches):
    """Every launch of ltpf_decode against its plain version; returns the
    number of lanes in each case bit over the launches."""
    seen = dict.fromkeys(CASE_BITS, 0)
    for args, _ in launches:
        got, ref = K.ltpf_decode(*args), ltpf_dec.ltpf_decode_plain(*args)
        assert C.count_differing(got, ref) == 0
        cases = ltpf_dec.case_word(*args)
        for bit in CASE_BITS:
            seen[bit] += int(((cases & bit) != 0).sum())
    return seen


def test_ltpf_decode_matches_plain(recorded):
    seen = check_ltpf(recorded["ltpf_decode"])
    assert all(v > 0 for v in seen.values()), seen


def test_ltpf_decode_all_cases(dev):
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
    seen = check_ltpf(store["ltpf_decode"])
    assert all(v > 0 for v in seen.values()), seen
    assert not torch.equal(y, g(x))


@pytest.mark.parametrize("rate", [dict(fs_in=48000, bitrate=64000),
                                  dict(fs_in=16000, bitrate=32000)])
def test_ltpf_decode_pitch_zero_and_smallest_pitch(dev, rate):
    """tests/torch_kernel_cases.py:ltpf_decode_rows: the smallest pitch
    (the nearest read a chunk allows), pitch 0 with the filter flags set
    (chunks of one sample), the largest pitch, every case, and at 48 kHz the
    midpoint lane; bit for bit."""
    cfg = P.Config(**rate)
    d = C.ltpf_decode_rows(cfg, seed=4, midpoint=cfg.fs == 48000)
    args = (cfg, *(torch.from_numpy(d[k]).to(dev) for k in C.LTPF_DEC_ORDER))
    got, ref = K.ltpf_decode(*args), ltpf_dec.ltpf_decode_plain(*args)
    assert C.count_differing(got, ref) == 0
    cases = ltpf_dec.case_word(*args)
    assert all(bool(((cases & bit) != 0).any()) for bit in CASE_BITS)


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


@pytest.mark.parametrize("M", list(C.GAIN_OFFSETS))
def test_gain_bisection_gain_rows(dev, M):
    """gain_rows from every starting offset of the configurations with M
    blocks, 24, 33 and 2047 streams a launch, and each row alone from the
    first offset."""
    g = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)
    for offset0 in C.GAIN_OFFSETS[M]:
        en, target = C.gain_rows(M, offset0)
        n = en.shape[0]
        picks = [np.arange(n), np.arange(33) % n, np.arange(2047) % n]
        if offset0 == C.GAIN_OFFSETS[M][0]:
            picks += [[i] for i in range(n)]
        for pick in picks:
            args = (g(en[pick]), g(target[pick]), offset0)
            assert torch.equal(K.gain_bisection(*args), quant.gain_bisection_plain(*args)), \
                (offset0, len(pick))


def test_gain_bisection_rejects_rows_it_does_not_stage(dev):
    en = torch.zeros((4, K.GAIN_MAX_M + 1), device=dev)
    with pytest.raises(ValueError):
        K.gain_bisection(en, torch.zeros(4, device=dev), 119)


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
    # the synthetic rows (switch offsets, orders above 8, general ranges,
    # zeros, subnormal and near-overflow rows), all at once and one a launch
    rows = C.tns_lattice_rows(seed=3)
    args = tuple(torch.from_numpy(rows[k]).to(dev) for k in C.TNS_LATTICE_ORDER)
    same_tensors(getattr(K, name)(*args), plain(*args))
    for i in range(0, args[0].shape[0], 5):
        one = tuple(a[i: i + 1] for a in args)
        same_tensors(getattr(K, name)(*one), plain(*one))


@pytest.mark.parametrize("name", ["tns_analysis_lattice", "tns_synthesis_lattice"])
def test_tns_lattice_card_equals_cpu_plain(recorded, name):
    """Both lattices take the CPU's contraction on every device: the kernel
    on the card equals the plain version run on CPU tensors, on every
    recorded launch and on the synthetic rows."""
    plain = getattr(tns, name + "_plain")
    for args, _ in recorded[name]:
        same_tensors(getattr(K, name)(*args), plain(*(a.cpu() for a in args)))
    rows = C.tns_lattice_rows(seed=4)
    args = tuple(torch.from_numpy(rows[k]) for k in C.TNS_LATTICE_ORDER)
    same_tensors(getattr(K, name)(*(a.cuda() for a in args)), plain(*args))


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
    """side_info_pack's 8 launches, and the side information parsed in the
    decoder's one ari_decode launch."""
    assert len(recorded["side_info_pack"]) == 8 and len(recorded["ari_decode_frames"]) == 1
    for args, _ in recorded["side_info_pack"]:
        same_tensors(K.side_info_pack(*args), bits.pack_side_info_plain(*args))
    (args, kw), = recorded["ari_decode_frames"]
    got = K.ari_decode_frames(*args, **kw)
    same_tensors(got, ari.parse_and_decode_plain(*args, **kw))
    assert int(got[0]["bfi"].sum()) == 0


@pytest.mark.parametrize("name", list(C.CONFIGS))
def test_side_info_pack_per_stream_widths(dev, name):
    """Every submode's gain and index widths, LTPF on and off, one and two
    TNS filters; with and without the bandwidth field, and a 2.5 ms frame."""
    cfg = P.Config(**C.CONFIGS[name])
    fields = C.side_fields(cfg, 256, seed=3)
    args = pack_args(cfg, fields, dev)
    packed = K.side_info_pack(*args)
    same_tensors(packed, bits.pack_side_info_plain(*args))
    both = K.ari_decode_frames(cfg, packed[0])
    same_tensors(both, ari.parse_and_decode_plain(cfg, packed[0]))
    got = both[0]
    assert int(got["bfi"].sum()) == 0
    assert torch.equal(got["scf_idx"], args[8]) and torch.equal(got["ltpf_param"], args[7])
    assert torch.equal(got["bp_side"], packed[1]) and torch.equal(got["mask_side"], packed[2])


@pytest.mark.parametrize("trigger", C.BFI_TRIGGERS)
def test_side_info_parse_bad_frame_triggers(dev, trigger):
    """Each trigger in the range decoder's parsed mode, both dicts."""
    packed = bits.pack_side_info_plain(*pack_args(CFG, C.corrupt_fields(CFG, trigger, 32), dev))
    got = K.ari_decode_frames(CFG, packed[0])
    same_tensors(got, ari.parse_and_decode_plain(CFG, packed[0]))
    assert bool((got[0]["bfi"] == 1).all())
    same_tensors(K.side_info_parse(CFG, packed[0]), got[0])


def test_side_info_parse_random_bytes(dev):
    rows = torch.randint(0, 256, (4096, CFG.targetBytes), device=dev, dtype=torch.int32,
                         generator=torch.Generator(device=dev).manual_seed(1))
    same_tensors(K.ari_decode_frames(CFG, rows), ari.parse_and_decode_plain(CFG, rows))


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


@pytest.mark.parametrize("B", [1, 33, 2048])
def test_sns_vq_dec_rows_at_every_size(dev, B):
    """The warp design at 1, 33 and 2048 streams a launch: scf_idx_grid of
    every submode and damaged indices."""
    rng = np.random.default_rng(10)
    bad = np.concatenate([C.scf_idx_grid(s, 64, seed=11) for s in range(4)])
    bad[:, 5] = rng.integers(0, 1 << 25, bad.shape[0])
    bad[:, 6] = rng.integers(-2, 12, bad.shape[0])
    rows = np.concatenate([C.scf_idx_grid(s, 64, seed=12) for s in range(4)] + [bad])
    idx = torch.from_numpy(tiled(rows, B)).to(dev)
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


def tiled(rows: np.ndarray, B: int) -> np.ndarray:
    """rows cycled to B rows."""
    return np.ascontiguousarray(rows[np.resize(np.arange(rows.shape[0]), B)])


@pytest.mark.parametrize("B", [1, 33, 2047, 2048])
def test_sns_vq_enc_rows_at_every_size(recorded, dev, B):
    """The warp design at 1, 33, 2047 and 2048 streams a launch: codebook
    halves tied at their minimum, rows whose distances and gain errors are
    all infinite, scf_rows and the main path's scale factors."""
    main = torch.cat([a[0] for a, _ in recorded["sns_vq_enc"]]).cpu().numpy()
    rows = np.concatenate([C.sns_tie_rows(), C.scf_rows(1, 400), main])
    scf = torch.from_numpy(tiled(rows, B)).to(dev)
    same_tensors(K.sns_vq_enc(scf), sns.sns_vq_enc_plain(scf))


def test_launch_counts_move(dev):
    K.reset_launch_counts()
    B = 8
    pcm = torch.zeros((2, B, 480), device=dev)
    _, frames = P.encode_block(CFG, P.enc_state_init(CFG, B, device=dev), pcm)
    P.decode_block(CFG, P.dec_state_init(CFG, B, device=dev), frames)
    assert K.launches == {"ari_encode": 2, "ari_decode": 1, "bit_estimate": 4,
                          "ltpf_decode": 2, "gain_bisection": 2,
                          "tns_analysis_lattice": 2, "tns_synthesis_lattice": 2,
                          "hp50_biquad": 2, "side_info_pack": 2,
                          "sns_vq_dec": 2, "sns_vq_enc": 2, "tns_filter_analysis": 2,
                          "pc_classify": 2, "mdct": 2, "imdct": 2, "mdct_compensated": 0,
                          "olpa": 2,
                          "ltpf_encode": 2, "noise_residual_enc": 2, "spec_decode": 2,
                          "fec_encode": 0, "fec_decode": 0, "plc_tdc": 0,
                          "plc_damp_scramble": 0, "phecu_spec_ana": 0, "phecu_subst": 0,
                          "fx_sns_dec": 0, "fx_spec_decode": 0, "fx_dct4": 0, "fx_ola_ltpf": 0,
                          "plc_main": 2}


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


@pytest.mark.parametrize("B", [1, 33, 2047])
@pytest.mark.parametrize("name", list(C.TNS_CONFIGS))
def test_tns_filter_analysis_batches(dev, name, B):
    """tns_rows B streams a launch: each row alone, or the rows tiled."""
    cfg = P.Config(**C.TNS_CONFIGS[name])
    x, bw = C.tns_rows(seed=2)
    n = x.shape[0]
    picks = [[i] for i in range(n)] if B == 1 else [np.arange(s, s + B) % n for s in (0, 26)]
    g = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)
    for pick in picks:
        args = (cfg, g(x[pick]), g(bw[pick]))
        same_tensors(K.tns_filter_analysis(*args), tns.tns_filter_analysis_plain(*args))


def test_pc_classify_matches_plain_on_the_main_path(recorded):
    """Both outputs, the flags and the stability factor, of every launch."""
    launches = recorded["pc_classify"]
    assert len(launches) == 8
    for args, _ in launches:
        same_tensors(K.pc_classify(*args), pc.pc_classify_plain(*args))


def pc_case_args(recorded, dev):
    """Synthetic rows of the classifier with the stability factor, built
    from the recorded q_old_d and q_old_res of the last frame's launch
    (tests/torch_kernel_cases.py:pc_fused_rows)."""
    args = recorded["pc_classify"][-1][0]
    base = [a[:16].cpu().numpy() for a in args[4:6]]
    a = C.pc_fused_rows(*base, seed=3)
    return a, (CFG, *(torch.from_numpy(a[k]).to(dev) for k in C.PC_FUSED_ORDER))


def test_pc_classify_every_branch(recorded, dev):
    a, args = pc_case_args(recorded, dev)
    got = K.pc_classify(*args)
    same_tensors(got, pc.pc_classify_plain(*args))
    branches = C.pc_fused_branches(a, *(t.cpu().numpy() for t in got))
    assert all(v > 0 for v in branches.values()), branches


def test_pc_classify_does_not_synchronise(recorded, dev):
    """The kernel path of pc.pc_classify reads nothing back to the host."""
    _, args = pc_case_args(recorded, dev)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        out, stab = pc.pc_classify(*args)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert out.shape == args[1].shape and stab.shape == args[1].shape


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
    """Full-scale, silent and alternating-sign rows, rows of negative zeros,
    subnormal-scale rows and rows near 1e37 at N = 480 and 160."""
    cfg = P.Config(fs_in=fs, bitrate=bitrate)
    x, mem = C.transform_rows(cfg.frame_length, cfg.la_zeroes, seed=4, extreme=True)
    args = (cfg, torch.from_numpy(x).to(dev), torch.from_numpy(mem).to(dev))
    got = getattr(K, name)(*args)
    same_tensors(got, [t.contiguous() for t in getattr(transforms, name + "_plain")(*args)])
    assert bool(torch.isfinite(got[0]).all())


@pytest.mark.parametrize("fs,bitrate", [(48000, 64000), (16000, 32000)])
def test_mdct_compensated_synthetic_rows(dev, fs, bitrate):
    """The TDAC's MDCT in the CPU's compensated order on the same rows; the
    rows near 1e37 overflow its split to NaN, as on the CPU, and with the
    subnormal-scale rows take the split step."""
    cfg = P.Config(fs_in=fs, bitrate=bitrate)
    x, mem = C.transform_rows(cfg.frame_length, cfg.la_zeroes, seed=4, extreme=True)
    args = (cfg, torch.from_numpy(x).to(dev), torch.from_numpy(mem).to(dev))
    got = K.mdct_compensated(*args)
    same_tensors(got, [t.contiguous() for t in transforms.mdct_plain(*args, compensated=True)])
    assert bool(torch.isfinite(got[0][:-2]).all()) and bool(torch.isnan(got[0][-2:]).all())
    # the extreme rows (1e-39, 1e37) take the split step, the rows at 16-bit scale not
    fast = K.mdct_compensated(*args, fast_rows=True)[2]
    assert torch.equal(fast, transforms.compensated_fast_rows(*args))
    assert not bool(fast[-4:].any()) and bool(fast[: fast.shape[0] - 7].all())


@pytest.mark.parametrize("fs,bitrate", [(48000, 64000), (16000, 32000)])
def test_imdct_single_stream(dev, fs, bitrate):
    """One stream a launch (the matrix-vector product's order) on each
    synthetic row."""
    cfg = P.Config(fs_in=fs, bitrate=bitrate)
    x, mem = C.transform_rows(cfg.frame_length, cfg.la_zeroes, seed=5, extreme=True)
    for b in range(x.shape[0]):
        args = (cfg, torch.from_numpy(x[b: b + 1]).to(dev), torch.from_numpy(mem[b: b + 1]).to(dev))
        same_tensors(K.imdct(*args), [t.contiguous() for t in transforms.imdct_plain(*args)])


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


OLPA_FRAMES = {"10ms": 100, "5ms": 50, "2.5ms": 25}


@pytest.mark.parametrize("B", [1, 33, 2048])
@pytest.mark.parametrize("frames", list(OLPA_FRAMES))
def test_olpa_rows_at_every_size(dev, frames, B):
    """The warp's chains at both correlation lengths (64, 32) on the
    synthetic rows, tiled to B streams a launch."""
    dms = OLPA_FRAMES[frames]
    cfg = P.Config(fs_in=48000, bitrate=64000, frame_dms=dms)
    a = C.olpa_rows(seed=2, frame_dms=dms)
    pick = np.resize(np.arange(a["mem_pitch"].shape[0]), B)
    args = (cfg, *on_card({k: v[pick] for k, v in a.items()}, C.OLPA_ORDER, dev))
    got = K.olpa(*args)
    same_tensors(got, [t.contiguous() for t in analysis.olpa_plain(*args)])
    if B == 2048:
        branches = C.olpa_branches({k: v[pick] for k, v in a.items()},
                                   [t.cpu().numpy() for t in got])
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


LTPF_FRAMES = {"10ms": 100, "5ms": 50, "2.5ms": 25}


@pytest.mark.parametrize("aligned", [True, False])
@pytest.mark.parametrize("B", [1, 33, 2048])
@pytest.mark.parametrize("frames", list(LTPF_FRAMES))
def test_ltpf_encode_rows_at_every_size(dev, frames, B, aligned):
    """The warp design at 1, 33 and 2048 streams a launch and every frame
    size (correlation lengths 128 and 64): ltpf_edge_rows (the pitch at each
    lag limit and resolution step, tied window values and candidates,
    negative correlations), with ltpf_rows at 10 ms; the memory rows aligned
    for 16-byte loads and a word off."""
    cfg = P.Config(fs_in=48000, bitrate=64000, frame_dms=LTPF_FRAMES[frames])
    a = C.ltpf_edge_rows(cfg, seed=2)
    if cfg.frame_dms == 100:
        b = C.ltpf_rows(seed=3)
        a = {k: np.concatenate([a[k], b[k]]) for k in a}
    args = [cfg, *on_card({k: tiled(v, B) for k, v in a.items()}, C.LTPF_ORDER, dev)]
    if not aligned:
        m = args[4]
        args[4] = torch.empty(m.numel() + 1, device=dev)[1:].view_as(m).copy_(m)
        assert args[4].data_ptr() % 16 != 0
    got = K.ltpf_encode(*args)
    same_tensors(got, [t.contiguous() for t in analysis.ltpf_encode_plain(*args)])


@pytest.mark.parametrize("B", [1, 33, 2048])
@pytest.mark.parametrize("name", list(C.CONFIGS))
def test_side_info_pack_rows_at_every_size(dev, name, B):
    """The warp design at 1, 33 and 2048 streams a launch on side_fields of
    every configuration, and on rows of 1, 5 and 9 bytes, shorter than the
    side bits (the string clipped at the row's first byte)."""
    from types import SimpleNamespace
    cfg = P.Config(**C.CONFIGS[name])
    f = {k: tiled(v, B) for k, v in C.side_fields(cfg, 256, seed=5).items()}
    for nbytes in (cfg.targetBytes, 1, 5, 9):
        c = SimpleNamespace(targetBytes=nbytes, BW_cutoff_bits=cfg.BW_cutoff_bits,
                            lastnz_bits=cfg.lastnz_bits)
        args = pack_args(c, f, dev)
        same_tensors(K.side_info_pack(*args), bits.pack_side_info_plain(*args))


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


@pytest.mark.parametrize("B", [1, 33, 2047, 2048])
@pytest.mark.parametrize("name", list(C.NRE_CONFIGS))
def test_noise_residual_enc_rows_at_every_size(dev, name, B):
    """nre_rows at 48 and 16 kHz (at 16 kbps the half means) at 1, 33, 2047
    and 2048 streams a launch."""
    cfg = P.Config(**C.NRE_CONFIGS[name])
    a = C.nre_rows(cfg, seed=5)
    args = (cfg, *(torch.from_numpy(tiled(a[k], B)).to(dev) for k in C.NRE_ORDER))
    same_tensors(K.noise_residual_enc(*args), quant.noise_residual_enc_plain(*args))


@pytest.mark.parametrize("B", [1, 33, 2047, 2048])
def test_noise_residual_enc_main_path_rows_at_every_size(recorded, dev, B):
    launches = recorded["noise_residual_enc"]
    cfg = launches[0][0][0]
    rows = [torch.cat([a[i] for a, _ in launches]).cpu().numpy() for i in range(1, 8)]
    args = (cfg, *(torch.from_numpy(tiled(r, B)).to(dev) for r in rows))
    same_tensors(K.noise_residual_enc(*args), quant.noise_residual_enc_plain(*args))


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


SPEC_RATES = {"48k": CFG, "16k": P.Config(fs_in=16000, bitrate=32000)}


@pytest.mark.parametrize("B", [1, 33, 2048])
@pytest.mark.parametrize("rows", ["spec_rows", "spec_edge_rows", "spec_edge_rows_42_bits"])
@pytest.mark.parametrize("rate", list(SPEC_RATES))
def test_spec_decode_rows_at_every_size(dev, rate, rows, B):
    """The warp design at 1, 33 and 2048 streams a launch at 48 and 16 kHz:
    spec_rows, and spec_edge_rows (nonzero lines at the bandwidth and the
    windows' and chunks' edges, n_res 0, the full count and above, lines a
    nudge makes zero, synthesised lines at the 0.625 threshold), also with
    42 residual bits a frame."""
    cfg = SPEC_RATES[rate]
    a = (C.spec_rows(cfg, seed=7) if rows == "spec_rows"
         else C.spec_edge_rows(cfg, seed=8, res_width=42 if rows.endswith("42_bits") else None))
    args = (cfg, *(torch.from_numpy(tiled(a[k], B)).to(dev) for k in C.SPEC_ORDER))
    same_tensors(K.spec_decode(*args), [t.contiguous() for t in quant.spectrum_decode_plain(*args)])


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


# ---- slice 6: the channel coder, the range decoder's PC hooks, no uploads ----

def no_sync(fn):
    """Run fn under torch.cuda.set_sync_debug_mode("error"): any operation
    that synchronises the host with the card raises."""
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        return fn()
    finally:
        torch.cuda.set_sync_debug_mode("default")


def test_warmed_frame_steps_do_not_synchronise(dev):
    """A warmed encode_frame and decode_frame at the flagship upload no
    table and read nothing back (every table is cached on the device)."""
    B = 64
    pcm = torch.from_numpy(np.random.default_rng(0).standard_normal((B, 480)) * 3000).float().to(dev)
    st, ds = P.enc_state_init(CFG, B, device=dev), P.dec_state_init(CFG, B, device=dev)
    for _ in range(2):
        st, out, _ = P.encode_frame(CFG, st, pcm)
        ds, _, _ = P.decode_frame(CFG, ds, out)
    st, out, _ = no_sync(lambda: P.encode_frame(CFG, st, pcm))
    ds, y, _ = no_sync(lambda: P.decode_frame(CFG, ds, out))
    assert y.shape == (B, 480)


def fec_case_on_card(dev, slot, mode, ccc):
    from audio_codec_torch.ops import fec
    data, epmr, kinds, bfi_in = C.fec_rows(slot, mode, ccc)
    enc = fec.fec_encode_plain(torch.from_numpy(data), torch.from_numpy(epmr), slot, mode, ccc)
    frames = C.channel_errors(enc.numpy(), slot, mode, kinds, np.random.default_rng(1))
    return [torch.from_numpy(v).to(dev) for v in (data, epmr, frames, bfi_in)]


@pytest.mark.parametrize("slot", C.FEC_SLOTS)
def test_fec_kernels_match_plain(dev, slot):
    from audio_codec_torch.ops import fec
    for mode in (1, 2, 3, 4):
        for ccc in (0, 1):
            data, epmr, frames, bfi_in = fec_case_on_card(dev, slot, mode, ccc)
            same_tensors([K.fec_encode(data, epmr, slot, mode, ccc)],
                         [fec.fec_encode_plain(data, epmr, slot, mode, ccc)])
            got = K.fec_decode(frames, slot, ccc, bfi_in)
            ref = fec.fec_decode_plain(frames, slot, ccc, bfi_in)
            same_tensors([got[k] for k in ref], list(ref.values()))


def test_fec_decode_wrong_mode_and_risk_rows(dev):
    from audio_codec_torch.ops import fec
    frames = torch.from_numpy(np.concatenate([C.wrong_mode_rows(), C.epmr_risk_rows()])).to(dev)
    got, ref = K.fec_decode(frames, 80, 0), fec.fec_decode_plain(frames, 80, 0)
    same_tensors([got[k] for k in ref], list(ref.values()))
    assert bool((got["bfi"] == 1).all())


@pytest.mark.parametrize("slots", [1, 33, 2048])
@pytest.mark.parametrize("slot", C.FEC_SLOTS)
def test_fec_decode_every_mode_at_scale(dev, slot, slots):
    """The warp decoder at each slot size x EP1-4 x ccc 0/1 on 1, 33 and
    2048 slots a launch (the case's rows tiled), and on the total-failure
    rows; at slot 40 also the low-rate cap's rows."""
    from audio_codec_torch.ops import fec
    tile = lambda t: t[torch.arange(slots, device=t.device) % t.shape[0]].contiguous()
    cases = []
    for mode in (1, 2, 3, 4):
        for ccc in (0, 1):
            _, _, frames, bfi_in = fec_case_on_card(dev, slot, mode, ccc)
            cases.append((tile(frames), ccc, tile(bfi_in)))
    synth = [C.fec_failure_rows(slot)] + ([C.fec_cap_rows(m) for m in (2, 3, 4)] if slot == 40 else [])
    cases += [(tile(torch.from_numpy(f).to(dev)), 0, None) for f in synth]
    for frames, ccc, bfi_in in cases:
        got = K.fec_decode(frames, slot, ccc, bfi_in)
        ref = fec.fec_decode_plain(frames, slot, ccc, bfi_in)
        same_tensors([got[k] for k in ref], list(ref.values()))


@pytest.mark.parametrize("slots", [1, 33, 2048])
@pytest.mark.parametrize("slot", C.FEC_SLOTS + (241,))
def test_fec_encode_every_mode_at_scale(dev, slot, slots):
    """The warp encoder at each slot size (and 241, the first slot of 33
    codewords) x EP1-4 x ccc 0/1 on 1, 33 and 2048 slots a launch (the
    rows tiled)."""
    from audio_codec_torch.ops import fec
    tile = lambda t: t[torch.arange(slots, device=t.device) % t.shape[0]].contiguous()
    for mode in (1, 2, 3, 4):
        for ccc in (0, 1):
            data, epmr, _, _ = C.fec_rows(slot, mode, ccc)
            data, epmr = (tile(torch.from_numpy(v).to(dev)) for v in (data, epmr))
            same_tensors([K.fec_encode(data, epmr, slot, mode, ccc)],
                         [fec.fec_encode_plain(data, epmr, slot, mode, ccc)])


def pc_args(dev, epmode):
    a = C.pc_decode_rows(epmode)
    cfg = P.Config(fs_in=48000, bitrate=64000, epmode=epmode)
    frames = torch.from_numpy(a["frames"]).to(dev)
    side = bits.parse_side_info(cfg, frames)
    return cfg, frames, side, [torch.from_numpy(a[k]).to(dev) for k in ("bfi_in", "be_l", "be_r")]


@pytest.mark.parametrize("epmode", C.PC_EP_MODES)
def test_ari_decode_pc_hooks_match_plain(dev, epmode):
    """Both PC modes, the side information read and parsed; parsed also
    with the corrupt range left to its default."""
    cfg, frames, side, flags = pc_args(dev, epmode)
    for sim in (False, True):
        got = K.ari_decode(cfg, frames, side, *flags, pc_enc_sim=sim)
        ref = ari.decode_plain(cfg, frames, side, *flags, pc_enc_sim=sim)
        same_tensors([got[k] for k in ref], list(ref.values()))
        if not sim:
            assert bool((got["bfi"] == 2).any())
        for fl in (flags, flags[:1]):
            same_tensors(K.ari_decode_frames(cfg, frames, *fl, pc_enc_sim=sim),
                         ari.parse_and_decode_plain(cfg, frames, *fl, pc_enc_sim=sim))


def test_ep_step_does_not_synchronise(dev):
    """The stream path's device step at EP3: the encoder's PC simulation,
    the block move and fec_encode, then fec_decode and decode_frame with
    the PC hooks, read nothing back to the host once warmed."""
    from audio_codec_torch import engine
    from audio_codec_torch.ops import fec
    cfg = P.Config(fs_in=48000, bitrate=64000, epmode=3)
    B = 64
    pcm = torch.from_numpy(np.random.default_rng(1).standard_normal((B, 480)) * 3000).float().to(dev)
    st, ds = P.enc_state_init(cfg, B, device=dev), P.dec_state_init(cfg, B, device=dev)
    epmr = torch.zeros(B, dtype=torch.int32, device=dev)

    def step():
        s, out, _ = P.encode_frame(cfg, st, pcm)
        buf = out.to(torch.int32)
        buf = engine.reorder_payload(buf, engine.b_left_step(cfg, buf), cfg.n_pc)
        slots = fec.fec_encode(buf, epmr, slot_bytes=cfg.slotBytes, mode=3)
        d = fec.fec_decode(slots, slot_bytes=cfg.slotBytes)
        bfi = torch.where(d["bfi"] == 1, 1, torch.where(d["bfi"] == 2, 2, 0))
        return P.decode_frame(cfg, ds, d["data"][:, : cfg.targetBytes], bfi,
                              d["be_bp_left"], d["be_bp_right"])
    step()
    _, y, aux = no_sync(step)
    assert y.shape == (B, 480) and bool((aux["bfi"] == 0).all())


# ---- slice 7: advanced concealment (plc_mode 1) ----

PLC_CFG = P.Config(fs_in=48000, bitrate=64000, plc_mode=1)
PLC_KERNELS = ("plc_tdc", "plc_damp_scramble", "phecu_spec_ana", "phecu_subst",
               "mdct_compensated")


def plc_plain():
    from audio_codec_torch.ops import plc_adv, plc_phecu
    return {"plc_tdc": plc_adv.plc_tdc_plain, "plc_damp_scramble": plc_adv.damp_scramble_plain,
            "phecu_spec_ana": plc_phecu.phecu_spec_ana_plain,
            "phecu_subst": plc_phecu.phecu_subst_plain,
            "mdct_compensated": lambda *a: tuple(
                t.contiguous() for t in transforms.mdct_plain(*a, compensated=True))}


def lossy_block(dev, B: int = 48, T: int = 12):
    """Payloads of speech, music, noise and tones with every stream clean
    for 4 frames, then bursts of 1, 2, 4 and 8 lost frames and redundancy
    frames, by stream; returns (frames, bfi)."""
    rng = np.random.default_rng(7)
    n = PLC_CFG.frame_length
    srcs = [material("speech"), material("music"), None, None]
    pcm = np.zeros((T, B, n), np.float32)
    tt = np.arange(T * n)
    for b in range(B):
        src = srcs[b % 4]
        if src is not None:
            off = 30000 + 7001 * b
            pcm[:, b] = src[off: off + T * n].reshape(T, n)
        elif b % 4 == 2:
            pcm[:, b] = rng.standard_normal((T, n)) * 2000
        else:
            f = rng.uniform(300, 3000)
            pcm[:, b] = (4000 * np.sin(2 * np.pi * f * tt / 48000)).reshape(T, n)
    bfi = np.zeros((T, B), np.int32)
    for b in range(B):
        burst = (1, 2, 4, 8)[(b // 4) % 4]
        bfi[4: 4 + burst, b] = 1
        if (b // 16) % 2:
            bfi[min(4 + burst + 1, T - 1), b] = 3
    st = P.enc_state_init(PLC_CFG, B, device=dev)
    _, frames = P.encode_block(PLC_CFG, st, torch.from_numpy(pcm).to(dev))
    return frames, torch.from_numpy(bfi).to(dev)


@pytest.fixture(scope="module")
def plc_recorded(dev):
    store: dict = {}
    frames, bfi = lossy_block(dev)
    undo = record(store)
    try:
        P.decode_block(PLC_CFG, P.dec_state_init(PLC_CFG, frames.shape[1], device=dev), frames, bfi)
    finally:
        undo()
    torch.cuda.synchronize()
    return store


@pytest.mark.parametrize("name", PLC_KERNELS)
def test_plc_kernels_match_plain_on_a_lossy_run(plc_recorded, name):
    """Every launch of a plc_mode 1 decode over bursts of 1-8 frames."""
    assert plc_recorded.get(name), f"{name} was not launched"
    plain = plc_plain()[name]
    for a, k in plc_recorded[name]:
        same_tensors(getattr(K, name)(*a, **k), plain(*a, **k))


TDC_ARGS = ("lost", "nb", "x_old_tot", "scf", "q_d", "pitch", "fract", "stab", "meth", "a_st",
            "seed", "gain_c", "alpha", "fract_st", "harm", "harm_len", "synth_hist")


@pytest.mark.parametrize("B", [1, 33, 2048])
def test_plc_tdc_synthetic_rows(dev, B):
    """Every TDC_LANES group as it is, and tdc_edge_rows (first losses with a
    full-scale and a subnormal history, a subnormal and a signed-zero
    synthesis, past the fade-out) tiled to B streams."""
    from audio_codec_torch.ops import plc_adv
    for group in C.TDC_LANES:
        d = C.tdc_stream_rows(group)
        t_ = lambda k: torch.as_tensor(np.asarray(d[k])).to(dev)
        args = (PLC_CFG, *(t_(k) for k in TDC_ARGS))
        same_tensors(K.plc_tdc(*args), plc_adv.plc_tdc_plain(*args))
    d = C.tdc_edge_rows()
    idx = np.arange(B) % len(d["nb"])
    args = (PLC_CFG, *(torch.as_tensor(np.ascontiguousarray(np.asarray(d[k])[idx])).to(dev)
                       for k in TDC_ARGS))
    same_tensors(K.plc_tdc(*args), plc_adv.plc_tdc_plain(*args))


def test_plc_tdc_all_streams_at_a_tdplc_first_loss(dev):
    """The launch whose 2048 streams all run TD-PLC from a first loss
    (chip_smoke.all_tdc_args), the one whose streams fill the card."""
    import chip_smoke
    from audio_codec_torch.ops import plc_adv
    args = chip_smoke.all_tdc_args(dev, 2048)
    got = K.plc_tdc(*args)
    same_tensors(got, plc_adv.plc_tdc_plain(*args))
    assert bool((got["meth"] == 3).all())


def test_plc_damp_and_phecu_synthetic_rows(dev):
    from audio_codec_torch.ops import plc_adv, plc_phecu as H
    for seed in (0, 1):
        d = C.damp_stream_rows(seed)
        t_ = lambda v: torch.as_tensor(np.asarray(v)).to(dev)
        args = (PLC_CFG, t_(d["x"]), t_(d["q_d_prev"]), t_(d["ns_lane"] != 0), t_(d["lost"] != 0),
                t_(d["is_pc"] != 0), t_(d["nb_cur"]), t_(d["pc_nb_lost"]), t_(d["stab_fac"]),
                t_(d["pitch_int"]), t_(d["pc_pitch"]), t_(d["cum_fflc"]), t_(d["cum_slow"]),
                t_(d["cum_fast"]), t_(d["ns_seed"]), t_(d["pc_seed"]), t_(d["spec_inv_idx"]))
        same_tensors(K.plc_damp_scramble(*args), plc_adv.damp_scramble_plain(*args))
        r = C.phecu_peak_rows(seed)
        act = t_(np.array([1, 1, 1, 1, 1, 1, 0, 1]) != 0)
        args = (PLC_CFG, t_(r["Xr"]), t_(r["Xi"]), t_(np.roll(r["Xr"], 1, 0)),
                t_(np.roll(r["Xi"], 1, 0)), t_(r["nc"]), act)
        same_tensors(K.phecu_spec_ana(*args), H.phecu_spec_ana_plain(*args))
        s = C.phecu_subst_rows(seed)
        f0, npl = H._peaks(t_(r["Xr"]), t_(r["Xi"]), t_(r["nc"]))
        args = (PLC_CFG, t_(s["Xr"]), t_(s["Xi"]), f0, npl, t_(s["nb_cur"]), t_(s["e_oold"]),
                t_(s["e_old"]), t_(s["mag_chg_1st"]), t_(s["beta_mute"]), t_(s["xavg"]),
                t_(s["is_trans"]), t_(s["active"] != 0))
        same_tensors(K.phecu_subst(*args), H.phecu_subst_plain(*args))


@pytest.mark.parametrize("B", [1, 8, 33, 2048])
def test_phecu_spec_ana_edge_rows(dev, B):
    """phecu_edge_rows tiled to B streams a launch; at 8 (the rows once)
    every edge they are made for is taken."""
    from audio_codec_torch.ops import plc_phecu as H
    e = C.phecu_edge_rows()
    t_ = lambda v: torch.as_tensor(np.asarray(v))[torch.arange(B) % len(e["nc"])].contiguous().to(dev)
    args = (PLC_CFG, t_(e["Xr"]), t_(e["Xi"]), t_(e["Xor"]), t_(e["Xoi"]), t_(e["nc"]),
            t_(np.arange(len(e["nc"])) % 7 != 6))
    got = K.phecu_spec_ana(*args)
    same_tensors(got, H.phecu_spec_ana_plain(*args))
    if B == 8:
        args = args[:6] + (torch.ones(8, dtype=torch.bool, device=dev),)
        got = K.phecu_spec_ana(*args)
        same_tensors(got, H.phecu_spec_ana_plain(*args))
        reached = C.phecu_edges_reached(got[0].cpu().numpy(), got[1].cpu().numpy())
        assert all(reached.values()), reached


@pytest.mark.parametrize("B", [1, 33, 2047, 2048])
def test_phecu_subst_and_damp_edge_rows(dev, B):
    """phecu_subst_edge_rows and damp_edge_rows tiled to B streams a launch
    (the damping's also with its rows off 16-byte alignment); the rows hold
    every edge they are made for (peaks at the edge bins, equidistant and
    adjacent peaks, the zero rule, a transient, angles on sinf's slow path;
    partial concealment from bins 0, 1, 398, 399, 400, an all-zero and a
    60 dB row, generator values on the sign threshold)."""
    from audio_codec_torch.ops import plc_adv, plc_phecu as H
    r, d = C.phecu_subst_edge_rows(), C.damp_edge_rows()
    assert all(C.phecu_subst_edges_reached(r).values()) and all(C.damp_edges_reached(d).values())
    t_ = lambda v: torch.as_tensor(np.asarray(v))[torch.arange(B) % len(v)].contiguous().to(dev)
    args = (PLC_CFG, *(t_(r[k]) for k in C.PHECU_SUBST_ARGS))
    same_tensors(K.phecu_subst(*args), H.phecu_subst_plain(*args))
    args = (PLC_CFG, *(t_(d[k] != 0) if k in C.DAMP_MASKS else t_(d[k]) for k in C.DAMP_ARGS))
    same_tensors(K.plc_damp_scramble(*args), plc_adv.damp_scramble_plain(*args))
    # rows 4 bytes off 16-byte alignment: the kernel's 4-byte loads
    off = lambda t: torch.empty(t.numel() + 1, dtype=t.dtype, device=dev)[1:].view(t.shape).copy_(t)
    args = (*args[:1], off(args[1]), off(args[2]), *args[3:])
    same_tensors(K.plc_damp_scramble(*args), plc_adv.damp_scramble_plain(*args))


@pytest.mark.parametrize("B", [1, 33, 2047, 2048])
def test_phecu_subst_and_damp_all_active(plc_recorded, B):
    """Each kernel's busiest launch of the lossy run with every stream at
    work, at B streams (chip_smoke.all_active_args: every stream concealed by
    the Phase ECU; every stream lost and noise-substituted)."""
    import chip_smoke
    plain = plc_plain()
    for name in ("phecu_subst", "plc_damp_scramble"):
        a, k = max(plc_recorded[name], key=lambda c: chip_smoke.plc_work(name, c[0], None)[1])
        args = chip_smoke.all_active_args(name, a, B)
        same_tensors(getattr(K, name)(*args, **k), plain[name](*args, **k))


def test_warmed_plc_mode1_decode_frame_does_not_synchronise(dev):
    """A warmed plc_mode 1 decode_frame with lost, redundancy and clean
    streams reads nothing back and uploads no table."""
    frames, bfi = lossy_block(dev, B=16, T=8)
    ds = P.dec_state_init(PLC_CFG, 16, device=dev)
    for t in range(6):
        ds, _, _ = P.decode_frame(PLC_CFG, ds, frames[t], bfi[t])
    ds, y, _ = no_sync(lambda: P.decode_frame(PLC_CFG, ds, frames[6], bfi[6]))
    assert y.shape == (16, 480) and bool(torch.isfinite(y).all())


# ---- the standard concealment (plc_mode 0) ----

@pytest.fixture(scope="module")
def plc0_recorded(dev):
    """Every plc_main launch of a plc_mode 0 decode of lossy_block's payloads
    (bursts of 1, 2, 4 and 8 lost frames, redundancy frames)."""
    store: dict = {}
    frames, bfi = lossy_block(dev)
    undo = record(store)
    try:
        P.decode_block(CFG, P.dec_state_init(CFG, frames.shape[1], device=dev), frames, bfi)
    finally:
        undo()
    torch.cuda.synchronize()
    return store


def test_plc_main_matches_plain_on_a_lossy_run(plc0_recorded):
    from audio_codec_torch.ops import plc
    launches = plc0_recorded["plc_main"]
    assert len(launches) == 12
    seen = {}
    for a, k in launches:
        same_tensors(K.plc_main(*a, **k), plc.plc_main_plain(*a, **k))
        for key, v in C.plc_main_branches(a[3].cpu(), a[4].cpu()).items():
            seen[key] = seen.get(key, 0) + v
    assert all(v > 0 for v in seen.values()), seen


def test_plc_main_synthetic_rows(dev):
    """Every damping branch, the generator's edge seeds, bfi 0 and 2."""
    from audio_codec_torch.ops import plc
    for seed in (0, 1):
        d = C.plc_main_rows(seed)
        args = (CFG, *(torch.from_numpy(d[k]).to(dev) for k in C.PLC_MAIN_ORDER))
        same_tensors(K.plc_main(*args), plc.plc_main_plain(*args))


def test_warmed_lossy_plc_mode0_decode_frame_does_not_synchronise(dev):
    """A warmed plc_mode 0 decode_frame with lost, redundancy and clean
    streams reads nothing back and uploads no table."""
    frames, bfi = lossy_block(dev, B=16, T=8)
    ds = P.dec_state_init(CFG, 16, device=dev)
    for t in range(5):
        ds, _, _ = P.decode_frame(CFG, ds, frames[t], bfi[t])
    assert bool((bfi[5] == 1).any())
    ds, y, _ = no_sync(lambda: P.decode_frame(CFG, ds, frames[5], bfi[5]))
    assert y.shape == (16, 480) and bool(torch.isfinite(y).all())


# ---- the bit-exact fixed-point decoder ----

FIXED = ("fx_sns_dec", "fx_spec_decode", "fx_dct4", "fx_ola_ltpf")


def fixed_same(name, args):
    """One launch against the plain version (fx_ola_ltpf from two copies of
    its state, which it updates in place); returns the kernel's outputs."""
    got, ref = C.fixed_pair(K, name, args)
    same_tensors(got, ref)
    return got


@pytest.fixture(scope="module")
def fixed_recorded(dev):
    """(frames, copies of the arguments of every fixed-point launch) of a
    DeviceFixedDecoder block of 64 streams x 4 frames: the port's payloads of
    speech, music and noise, the last 8 streams silent."""
    from audio_codec_torch.fixed_decoder_dev import DeviceFixedDecoder
    rng = np.random.default_rng(3)
    B, T, n = 64, 4, CFG.frame_length
    srcs = (material("speech"), material("music"))
    pcm = np.zeros((T, B, n), np.float32)
    for b in range(B - 8):
        if b % 3 == 2:
            pcm[:, b] = rng.standard_normal((T, n)) * (3000.0 / (1 + b % 7))
        else:
            src = srcs[b % 3]
            off = (b * 4801) % (len(src) - T * n)
            pcm[:, b] = src[off: off + T * n].reshape(T, n)
    _, frames = P.encode_block(CFG, P.enc_state_init(CFG, B, device=dev),
                               torch.from_numpy(pcm).to(dev))
    store: dict = {}
    with C.recording(store, FIXED, copy=True):
        K.reset_launch_counts()
        pcm_out = DeviceFixedDecoder(CFG, B, device=dev).decode_block(frames)
        counts = dict(K.launches)
    torch.cuda.synchronize()
    return frames, store, counts, pcm_out


@pytest.mark.parametrize("name", FIXED)
def test_fixed_kernel_matches_plain_on_every_launch(fixed_recorded, name):
    _, store, counts, _ = fixed_recorded
    assert len(store[name]) == counts[name] == (4 if name == "fx_ola_ltpf" else 1)
    for args, _ in store[name]:
        fixed_same(name, args)


@pytest.mark.parametrize("rows", [1, 33, 16384])
def test_fx_dct4_edge_rows(dev, rows):
    """The DCT-IV on fx_dct4_edge_rows and fx_dct4_rows (-2^31, headroom 0,
    30 and 31, rows the pre-scale takes to full scale, all-zero rows among
    nonzero ones) tiled to 1, 33 and 16 384 rows a launch."""
    y0, e0 = C.fx_dct4_edge_rows()
    y1, e1 = C.fx_dct4_rows()
    y, e = np.concatenate([y0, y1]), np.concatenate([e0, e1])
    idx = np.arange(rows) % len(y)
    g = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)
    fixed_same("fx_dct4", (g(y[idx]), g(e[idx]), 480))


@pytest.mark.parametrize("rows", [1, 33, 16384])
def test_fx_sns_dec_sample_and_edge_rows(dev, rows):
    """The SNS decode on fx_sns_sample_rows (a seeded sample of every
    shape's indices with the first and last) and fx_sns_edge_rows
    (out-of-range indices, every clamp) at every band count of the
    configurations, 1, 33 and 16 384 frames a launch."""
    idx = np.concatenate([C.fx_sns_edge_rows(), C.fx_sns_sample_rows()])
    pick = torch.from_numpy(np.ascontiguousarray(idx[np.arange(rows) % len(idx)])).to(dev)
    for nb in C.FX_SNS_BANDS:
        fixed_same("fx_sns_dec", (pick, nb))


def test_fixed_kernels_synthetic_rows(dev):
    from audio_codec_torch.fixed_decoder_dev import DeviceFixedDecoder
    from audio_codec_torch.ops import fixed_dev, fixed_ltpf_dev
    g = lambda a: torch.from_numpy(a).to(dev)
    fixed_same("fx_sns_dec", (g(C.fx_sns_rows()), CFG.bands_number))
    d = C.fx_spec_rows(CFG)
    scf, scf_e = fixed_dev.sns_decode_plain(g(d["scf_idx"]), CFG.bands_number)
    fixed_same("fx_spec_decode", (CFG, *(g(d[k]) for k in C.FX_SPEC_ORDER), scf, scf_e))
    y, y_e = C.fx_dct4_rows()
    fixed_same("fx_dct4", (g(y), g(y_e), 480))
    plan = C.fx_ola_plan(B=16)
    dec = DeviceFixedDecoder(CFG, 16, device=dev)
    seen = torch.zeros(5, dtype=torch.long)
    for t in range(len(C.LTPF_PLAN)):
        args = (CFG, dec.state, *(g(plan[k][t]) for k in ("ytda", "y_e", "y_s", "zero", "lp")),
                dec.sfi)
        seen += torch.bincount(fixed_ltpf_dev.ltpf_patterns(dec.state, args[6], CFG.fs_idx),
                               minlength=5).cpu()
        fixed_same("fx_ola_ltpf", args)
        K.fx_ola_ltpf(*args)
    assert bool((seen > 0).all()), seen.tolist()


@pytest.mark.parametrize("streams", [1, 33, 2048])
def test_fx_spec_decode_tns_rows_at_every_size(dev, streams):
    """fx_spec_tns_rows (every TNS filter kind, every order 1-8 in each
    filter, saturating taps, zero frames) tiled to streams x 8 frames, so
    that the wave's groups of four frames end short and full."""
    from audio_codec_torch.ops import fixed_dev
    d = C.fx_spec_tns_rows()
    L = 1 if streams == 1 else streams * 8
    idx = np.arange(L) % len(d["x"])
    g = lambda a: torch.from_numpy(np.ascontiguousarray(a[idx])).to(dev)
    scf, scf_e = fixed_dev.sns_decode_plain(g(d["scf_idx"]), CFG.bands_number)
    fixed_same("fx_spec_decode", (CFG, *(g(d[k]) for k in C.FX_SPEC_ORDER), scf, scf_e))


OLA_RATES = {"48k": dict(fs_in=48000, bitrate=64000), "8k": dict(fs_in=8000, bitrate=24000)}


@pytest.mark.parametrize("B", [1, 33, 2048])
@pytest.mark.parametrize("plan", ["plan", "edge_plan"])
@pytest.mark.parametrize("rate", list(OLA_RATES))
def test_fx_ola_ltpf_plans_at_every_size(dev, rate, plan, B):
    """The post-filter across the lanes at 48 kHz (chunks of 32) and 8 kHz
    (chunks from 19), the edge plan's passes at pitch_int <= shift, every
    stream from its own state, B streams a launch (the plan's streams
    tiled)."""
    from audio_codec_torch.fixed_decoder_dev import DeviceFixedDecoder
    from audio_codec_torch.ops import fixed_ltpf_dev
    cfg = P.Config(**OLA_RATES[rate])
    make = C.fx_ola_plan if plan == "plan" else C.fx_ola_edge_plan
    p = make(B=33, seed=4, N=cfg.frame_length)
    pick = np.resize(np.arange(33), B)
    g = lambda a: torch.from_numpy(np.ascontiguousarray(a[:, pick])).to(dev)
    p = {k: g(v) for k, v in p.items()}
    dec = DeviceFixedDecoder(cfg, B, device=dev)
    seen, lags = torch.zeros(5, dtype=torch.long), {}
    for t in range(len(C.LTPF_PLAN)):
        args = (cfg, dec.state, *(p[k][t] for k in ("ytda", "y_e", "y_s", "zero", "lp")), dec.sfi)
        seen += torch.bincount(fixed_ltpf_dev.ltpf_patterns(dec.state, args[6], cfg.fs_idx),
                               minlength=5).cpu()
        for k, v in C.fx_ola_pass_lags(dec.state, args[6].cpu(), cfg.fs_idx, dec.sfi).items():
            lags[k] = lags.get(k, 0) + v
        fixed_same("fx_ola_ltpf", args)
        K.fx_ola_ltpf(*args)
    if B > 1:
        assert bool((seen > 0).all()), seen.tolist()
        assert lags["d < 32" if rate == "8k" else "d >= 32"] > 0, lags
        if plan == "edge_plan":
            assert lags["d <= 0"] > 0, lags


def test_fixed_decoder_card_equals_stored_reference_and_cpu(dev, fixed_recorded):
    from audio_codec_torch.fixed_decoder_dev import DeviceFixedDecoder
    with np.load(ROOT / "audio_codec_torch" / "data" / "fixed_pcm_ref.npz") as z:
        frames, pcm = z["frames"], z["pcm"]
    got = DeviceFixedDecoder(CFG, frames.shape[1], device=dev).decode_block(frames)
    assert np.array_equal(got.cpu().numpy(), pcm)
    fr, _, _, card = fixed_recorded
    pick = [0, 1, 2, 60, 61]
    cpu = DeviceFixedDecoder(CFG, len(pick), device="cpu").decode_block(fr[:, pick].cpu())
    assert torch.equal(cpu, card[:, pick].cpu())
