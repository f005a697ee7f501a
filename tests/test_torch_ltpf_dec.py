"""LTPF decoder post-filter of audio_codec_torch against audio_codec_tpu, in
all five cross-fade cases. The whole stage is the ltpf_decode kernel on the
card and its plain version (ltpf_decode_plain) here. Pitches and parameter
memories must be equal; the filtered PCM is held to 2**-18 of the frame's
peak plus 2**-16 (a few float32 ulp on the 16-bit scale) on speech, and bit
for bit on the lanes of tests/torch_kernel_cases.py:ltpf_decode_rows, both
on the CPU and with the plain version in the card's order: the taps are
summed as one fused multiply-add chain, which is XLA:CPU's order too."""
from __future__ import annotations

import numpy as np
import pytest

import audio_codec_torch as P
from audio_codec_torch.ops import ltpf_dec as PL
from audio_codec_torch.ops import numerics
from audio_codec_tpu.config import Config as JConfig
from audio_codec_tpu.ops import ltpf_dec as JL

from tests import torch_kernel_cases as C
from tests.torch_port_data import JCFG, PCFG, J, material, n, t

# (old param [present, active, index], new param, old pitch = new pitch?)
CASES = [
    ([0, 0, 0], [0, 0, 0]),          # off -> off
    ([1, 1, 300], [1, 0, 300]),      # on -> off: fade out
    ([1, 0, 0], [1, 1, 120]),        # off -> on: fade in
    ([1, 1, 250], [1, 1, 250]),      # on -> on, same pitch
    ([1, 1, 250], [1, 1, 410]),      # on -> on, pitch change
    ([1, 1, 31], [1, 1, 50]),        # on -> on, short lags
]


def inputs(seed: int):
    rng = np.random.default_rng(seed)
    B = len(CASES) + 1
    s = material("speech")
    x = np.stack([s[20000 + 997 * b: 20000 + 997 * b + 480] for b in range(B)]).astype(np.float32)
    mem_param = np.array([c[0] for c in CASES] + [[1, 1, 200]], np.int32)
    param = np.array([c[1] for c in CASES] + [[1, 1, 200]], np.int32)
    bfi = np.zeros(B, np.int32)
    bfi[-1] = 1                                   # a lost frame: zero parameters
    pi, pf = (np.asarray(v) for v in J(JL.decode_pitch, JCFG)(mem_param))
    mem_x = (rng.standard_normal((B, 10)) * 1000).astype(np.float32)
    mem_y = (rng.standard_normal((B, 861)) * 1000).astype(np.float32)
    mem_gain = np.where(mem_param[:, 1] == 1, np.float32(JCFG.ltpf_conf_beta), 0).astype(np.float32)
    mem_beta = np.full(B, JCFG.ltpf_conf_beta_idx, np.int32)
    return x, bfi, param, (mem_param, mem_x, mem_y, pi, pf, mem_gain, mem_beta)


@pytest.mark.parametrize("seed", [0, 1])
def test_ltpf_decode_all_cases(seed):
    x, bfi, param, mems = inputs(seed)
    ref = J(JL.ltpf_decode, JCFG)(x, bfi, param, *mems)
    got = PL.ltpf_decode(PCFG, t(x), t(bfi), t(param), *map(t, mems))
    y_ref = np.asarray(ref[0])
    tol = float(np.abs(y_ref).max()) * 2.0 ** -18 + 2.0 ** -16
    np.testing.assert_allclose(n(got[0]), y_ref, rtol=0, atol=tol)
    np.testing.assert_array_equal(n(got[1]), np.asarray(ref[1]))
    np.testing.assert_allclose(n(got[2]), np.asarray(ref[2]), rtol=0, atol=tol)
    for k in ref[3]:
        np.testing.assert_array_equal(n(got[3][k]), np.asarray(ref[3][k]), err_msg=k)
    assert not np.array_equal(y_ref, x)           # the filter did act


def test_decode_pitch():
    p = np.stack([np.ones(512, np.int32), np.ones(512, np.int32),
                  np.arange(512, dtype=np.int32)], axis=1)
    for g, e in zip(PL.decode_pitch(PCFG, t(p)), J(JL.decode_pitch, JCFG)(p)):
        np.testing.assert_array_equal(n(g), np.asarray(e))


RATES = {"48k": dict(fs_in=48000, bitrate=64000), "16k": dict(fs_in=16000, bitrate=32000)}


@pytest.mark.parametrize("name", list(RATES))
def test_ltpf_decode_bit_exact_every_lane(monkeypatch, name):
    """Every lane of ltpf_decode_rows (each cross-fade case, the smallest
    and largest pitch, a pitch with the filter off, pitch 0 with the flags
    set, a lost frame) at 48 and 16 kHz: the port on the CPU, and the plain
    version in the card's order, equal the reference bit for bit."""
    pcfg, jcfg = P.Config(**RATES[name]), JConfig(**RATES[name])
    d = C.ltpf_decode_rows(pcfg, seed=1)
    args = [d[k] for k in C.LTPF_DEC_ORDER]
    ref = J(JL.ltpf_decode, jcfg)(*args)
    ref = [*ref[:3], *(ref[3][k] for k in ("param", "pitch_int", "pitch_fr", "gain", "beta_idx"))]
    got_cpu = PL.ltpf_decode(pcfg, *map(t, args))
    monkeypatch.setattr(numerics, "on_cpu", lambda x: False)
    got_card = PL.ltpf_decode_plain(pcfg, *map(t, args))
    for got in (got_cpu, got_card):
        flat = [*got[:3], *(got[3][k] for k in ("param", "pitch_int", "pitch_fr", "gain",
                                                "beta_idx"))]
        assert C.count_differing([n(g) for g in flat], [np.asarray(r) for r in ref]) == 0
    assert not np.array_equal(n(got_cpu[0]), d["x"])


@pytest.mark.parametrize("name", ["8k", "16k", "24k", "32k", "44.1k", "48k"])
def test_pitch_division_by_12800_is_exact_for_every_index(monkeypatch, name):
    """The pitch decode divides by 12800: the CPU (and the reference)
    multiplies by the float reciprocal, a tensor on the card (and the
    ltpf_decode kernel) divides. Both give the same pitch for every index."""
    fs = {"8k": 8000, "16k": 16000, "24k": 24000, "32k": 32000, "44.1k": 44100, "48k": 48000}[name]
    cfg = P.Config(fs_in=fs, bitrate=32000)
    p = t(np.stack([np.ones(512, np.int32), np.ones(512, np.int32),
                    np.arange(512, dtype=np.int32)], axis=1))
    cpu = PL.decode_pitch(cfg, p)
    monkeypatch.setattr(numerics, "on_cpu", lambda x: False)
    for g, e in zip(PL.decode_pitch(cfg, p), cpu):
        np.testing.assert_array_equal(n(g), n(e))
