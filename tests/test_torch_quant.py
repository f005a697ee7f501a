"""Quantizer, rate loop and spectral decode ops of audio_codec_torch against
audio_codec_tpu. bit_estimate (a CUDA kernel on the card; its plain
version here) must be exact, as must every index, count and bit. Gains
are correctly rounded powers in both packages and must be equal; spectra
after a gain are held to 2**-20 relative (one or two float32 ulp)."""
from __future__ import annotations

import jax
import numpy as np
import pytest

import audio_codec_torch as P
from audio_codec_torch.ops import quant as PQ
from audio_codec_tpu.config import Config as JConfig
from audio_codec_tpu.ops import quant as JQ

from tests.torch_port_data import JCFG, PCFG, J, encoder_stages, n, t


def eq(got, ref):
    np.testing.assert_array_equal(n(got), np.asarray(ref))


def rate_loop_inputs(frame):
    r = encoder_stages()[frame]
    B = r["dy"].shape[0]
    s = r["state"]
    return r, (r["dy"], r["target"], s["targetBitsOff"], s["mem_targetBits"],
               s["mem_specBits"]), B


@pytest.mark.parametrize("frame", [0, 1])
def test_global_gain_quantize_adjust(frame):
    r, args, B = rate_loop_inputs(frame)
    ref = J(JQ.estimate_global_gain, JCFG)(*args)
    got = PQ.estimate_global_gain(PCFG, *map(t, args))
    for g, e in zip(got, ref):
        eq(g, e)
    gain = np.asarray(ref[0])
    xq = J(JQ.quantize_spectrum, JCFG)(r["dy"], gain)
    eq(PQ.quantize_spectrum(PCFG, t(r["dy"]), t(gain)), xq)
    nbits = np.asarray(jax.jit(lambda q, tg: JQ.bit_estimate(JCFG, q, tg, -1))(
        xq, r["target"])["nbits"])
    aref = J(JQ.adjust_global_gain, JCFG)(ref[1], ref[2], gain, r["target"], nbits)
    agot = PQ.adjust_global_gain(PCFG, *map(t, (ref[1], ref[2], gain, r["target"], nbits)))
    for g, e in zip(agot, aref):
        eq(g, e)


def spectra():
    """Quantized spectra: the encoder's, and seeded ones with escapes,
    sparse tails and all-zero rows."""
    r, args, B = rate_loop_inputs(1)
    gain = np.asarray(J(JQ.estimate_global_gain, JCFG)(*args)[0])
    xq = np.asarray(J(JQ.quantize_spectrum, JCFG)(r["dy"], gain))
    rng = np.random.default_rng(7)
    big = (rng.standard_normal((4, PCFG.yLen)) * np.array([1, 20, 300, 3000])[:, None]).astype(np.int32)
    big[1, 200:] = 0
    big[2, ::3] = 0
    zero = np.zeros((1, PCFG.yLen), np.int32)
    zero_tail = zero.copy()
    zero_tail[0, 1] = -2
    xqs = np.concatenate([xq, big, zero, zero_tail])
    targets = np.concatenate([r["target"], np.array([150, 200, 400, 600, 100, 100], np.int32)])
    return xqs, targets


@pytest.mark.parametrize("mode", [-1, 0, 1])
@pytest.mark.parametrize("bitrate", [64000, 160000])
def test_bit_estimate_exact(mode, bitrate):
    jcfg, pcfg = JConfig(fs_in=48000, bitrate=bitrate), P.Config(fs_in=48000, bitrate=bitrate)
    xq, target = spectra()
    ref = jax.jit(lambda q, tg: JQ.bit_estimate(jcfg, q, tg, mode))(xq, target)
    got = PQ.bit_estimate(pcfg, t(xq), t(target), mode)
    for k in ("nbits", "nbits2", "lastnz", "lastnz2", "lsbMode"):
        eq(got[k], ref[k])


@pytest.mark.parametrize("frame", [0, 1])
def test_noise_factor_and_residual_coding(frame):
    r, args, B = rate_loop_inputs(frame)
    gain = np.asarray(J(JQ.estimate_global_gain, JCFG)(*args)[0])
    xq = np.asarray(J(JQ.quantize_spectrum, JCFG)(r["dy"], gain))
    est = jax.jit(lambda q, tg: JQ.bit_estimate(JCFG, q, tg, 0))(xq, r["target"])
    xq = np.asarray(JQ.truncate_spectrum(xq, est["lastnz"], est["lastnz2"]))
    eq(PQ.truncate_spectrum(t(np.asarray(J(JQ.quantize_spectrum, JCFG)(r["dy"], gain))),
                            t(est["lastnz"]), t(est["lastnz2"])), xq)
    bw_bin = np.array([400, 320, 240, 400], np.int32)[:B]
    eq(PQ.noise_factor(PCFG, t(r["dy"]), t(xq), t(gain), t(bw_bin)),
       J(JQ.noise_factor, JCFG)(r["dy"], xq, gain, bw_bin))
    nb2 = np.asarray(est["nbits2"])
    ref = J(JQ.residual_encode, JCFG)(r["dy"], xq, gain, r["target"], nb2)
    got = PQ.residual_encode(PCFG, *map(t, (r["dy"], xq, gain, r["target"], nb2)))
    eq(got[0], ref[0])
    eq(got[1], ref[1])


def test_decoder_spectral_ops():
    xq, _ = spectra()
    B = xq.shape[0]
    rng = np.random.default_rng(8)
    x = xq.astype(np.float32)
    res_bits = rng.integers(0, 2, (B, PQ.residual_max_bits(PCFG))).astype(np.int32)
    n_res = rng.integers(0, 300, B).astype(np.int32)
    eq(PQ.residual_decode(PCFG, t(x), t(res_bits), t(n_res)),
       J(JQ.residual_decode, JCFG)(x, res_bits, n_res))
    seed = rng.integers(-32768, 32768, B).astype(np.int32)
    fac = rng.integers(0, 8, B).astype(np.int32)
    bw_bin = rng.choice(np.array([80, 160, 240, 320, 400], np.int32), B)
    inv = rng.integers(0, PCFG.yLen + 1, B).astype(np.int32)
    fac_pc = (rng.random(B) * 0.5).astype(np.float32)
    eq(PQ.noise_filling(PCFG, t(x), t(seed), t(fac), t(bw_bin)),
       J(JQ.noise_filling, JCFG)(x, seed, fac, bw_bin))
    eq(PQ.noise_filling(PCFG, t(x), t(seed), t(fac), t(bw_bin), t(inv), t(fac_pc)),
       J(JQ.noise_filling, JCFG)(x, seed, fac, bw_bin, inv, fac_pc))
    gg = rng.integers(0, 256, B).astype(np.int32)
    ref = np.asarray(J(JQ.apply_global_gain, JCFG)(x, gg))
    np.testing.assert_allclose(n(PQ.apply_global_gain(PCFG, t(x), t(gg))), ref,
                               rtol=2.0 ** -20, atol=0)
    eq(PQ.round_c(t(np.array([-2.5, -0.5, 0.5, 1.5, 2.4999], np.float32))),
       np.array([-3, -1, 1, 2, 2], np.float32))
