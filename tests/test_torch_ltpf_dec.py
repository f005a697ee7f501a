"""LTPF decoder post-filter of audio_codec_torch against audio_codec_tpu, in
all five cross-fade cases. Its sample loop is the ltpf_postfilter kernel on
the card and its plain version here. Pitches and parameter memories must be
equal; the filtered PCM is held to 2**-18 of the frame's peak plus 2**-16
(a few float32 ulp on the 16-bit scale): the taps are summed as one
fused multiply-add chain, which is XLA:CPU's order too."""
from __future__ import annotations

import numpy as np
import pytest

from audio_codec_torch.ops import ltpf_dec as PL
from audio_codec_tpu.ops import ltpf_dec as JL

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
