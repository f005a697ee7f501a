"""Encoder analysis stages of audio_codec_torch against audio_codec_tpu.

Integer outputs (pitch lags, LTPF parameters, bandwidth index, attack
flags) must be equal. Float outputs may differ where a sum runs in another
order than XLA's: they are held to 2**-16 relative plus 2**-16 of the
array's peak (16 float32 ulp of its largest value)."""
from __future__ import annotations

import numpy as np
import pytest
import torch

import audio_codec_torch as P
from audio_codec_torch.ops import analysis as PA
from audio_codec_tpu.config import Config as JConfig
from audio_codec_tpu.ops import analysis as JA

from tests.torch_port_data import JCFG, PCFG, J, encoder_stages, n, t


def close(got, ref, rel=2.0 ** -16):
    ref = np.asarray(ref)
    tol = rel * float(np.abs(ref).max(initial=0.0))
    np.testing.assert_allclose(n(got), ref, rtol=rel, atol=tol)


@pytest.mark.parametrize("frame", [0, 1])
def test_resample_12k8(frame):
    """Bit for bit: the port's CPU branch follows XLA:CPU's split of the
    product over [mem_in, x] (a 60-tap product plus a 480-tap one in 256-deep
    blocks) and its contraction of the 50 Hz high-pass, a recursion with
    poles near 1 that would carry a one-ulp difference into every later
    sample. This holds for 2 to 5 streams (see the tests below)."""
    r = encoder_stages()[frame]
    s = r["state"]
    args = (r["x"], s["r12k8_mem_in"], s["r12k8_mem_50"], s["r12k8_mem_out"])
    ref = J(JA.resample_12k8, JCFG)(*args)
    got = PA.resample_12k8(PCFG, *map(t, args))
    for g, e in zip(got, ref):
        np.testing.assert_array_equal(n(g).view(np.int32), np.asarray(e).view(np.int32))


def resampler_inputs(B: int):
    rng = np.random.default_rng(B)
    f = lambda n, scale: (rng.standard_normal((B, n)) * scale).astype(np.float32)
    return f(480, 3000.0), f(60, 3000.0), f(2, 100.0), f(24, 100.0)


@pytest.mark.parametrize("B", [2, 3, 5])
def test_resample_12k8_bit_exact_for_2_to_5_streams(B):
    args = resampler_inputs(B)
    ref = J(JA.resample_12k8, JCFG)(*args)
    got = PA.resample_12k8(PCFG, *map(t, args))
    for g, e in zip(got, ref):
        np.testing.assert_array_equal(n(g).view(np.int32), np.asarray(e).view(np.int32))


@pytest.mark.parametrize("fs,bitrate,frame_dms", [
    (32000, 64000, 100), (24000, 48000, 100), (16000, 32000, 100),
    (48000, 64000, 50), (48000, 64000, 25)])
def test_resample_12k8_bit_exact_at_other_frame_lengths(fs, bitrate, frame_dms):
    """The split and the 256-deep blocks of the frame's product hold at the
    other frame lengths too: 320 taps (32 kHz) is the one besides 480 that is
    longer than a block; the shorter frames are one chain either way."""
    jcfg = JConfig(fs_in=fs, bitrate=bitrate, frame_dms=frame_dms)
    pcfg = P.Config(fs_in=fs, bitrate=bitrate, frame_dms=frame_dms)
    n_mem = P.enc_state_init(pcfg, 3, device="cpu").r12k8_mem_in.shape[1]
    rng = np.random.default_rng(fs + frame_dms)
    f = lambda k, scale: (rng.standard_normal((3, k)) * scale).astype(np.float32)
    args = f(jcfg.frame_length, 3000.0), f(n_mem, 3000.0), f(2, 100.0), f(24, 100.0)
    ref = J(JA.resample_12k8, jcfg)(*args)
    got = PA.resample_12k8(pcfg, *map(t, args))
    for g, e in zip(got, ref):
        np.testing.assert_array_equal(n(g).view(np.int32), np.asarray(e).view(np.int32))


@pytest.mark.parametrize("B", [1, 6, 8, 16])
def test_resample_12k8_other_stream_counts(B):
    """XLA:CPU compiles the function otherwise for one stream and for six or
    more; the port follows the form it takes for 2 to 5 streams, so these
    are held to 2**-11 of the peak (the high-pass carries a one-ulp
    difference into every later sample). Read from the object code: from 6
    streams the scan body stores its output y = b0*x + u1 contracted into a
    fused multiply-add on some streams (at 6 the first four, at 7 to 9 all)
    while the state update keeps the rounded product; one stream fuses the
    frame's product with the add into a matrix-vector kernel of another
    order, and from 12 streams the two products' orders change too."""
    args = resampler_inputs(B)
    ref = J(JA.resample_12k8, JCFG)(*args)
    got = PA.resample_12k8(PCFG, *map(t, args))
    np.testing.assert_array_equal(n(got[1]), np.asarray(ref[1]))
    for g, e in zip(got, ref):
        close(g, e, 2.0 ** -11)


@pytest.mark.parametrize("frame", [0, 1])
def test_olpa_and_ltpf_encode(frame):
    r = encoder_stages()[frame]
    s = r["state"]
    y = r["y12k8"]
    ref = J(JA.olpa, JCFG)(y, s["olpa_mem_s12k8"], s["olpa_mem_s6k4"], s["olpa_mem_pitch"])
    got = PA.olpa(PCFG, t(y), t(s["olpa_mem_s12k8"]), t(s["olpa_mem_s6k4"]),
                  t(s["olpa_mem_pitch"]))
    for k in (0, 2):
        np.testing.assert_array_equal(n(got[k]), np.asarray(ref[k]))
    for k in (1, 3, 4):
        close(got[k], ref[k])
    T0, nc = np.asarray(ref[0]), np.asarray(ref[1])
    largs = (s["ltpf_mem_in"], s["ltpf_mem_normcorr"], s["ltpf_mem_mem_normcorr"],
             s["ltpf_mem_ltpf_on"], s["ltpf_mem_pitch"])
    lref = J(JA.ltpf_encode, JCFG)(y, T0, nc, *largs)
    lgot = PA.ltpf_encode(PCFG, t(y), t(T0), t(nc), *map(t, largs))
    for k in (0, 1, 5):
        np.testing.assert_array_equal(n(lgot[k]), np.asarray(lref[k]))
    for k in (2, 3, 4, 6):
        close(lgot[k], lref[k])


def test_ltpf_encode_at_the_lag_limits():
    """Open-loop pitches at both ends of the range, where the reference's
    correlation window runs past the lags it computed."""
    r = encoder_stages()[1]
    s = r["state"]
    y = r["y12k8"]
    pitch_ol = np.array([228, 226, 34, 157], np.int32)
    nc_ol = np.full(4, 0.9, np.float32)
    largs = (s["ltpf_mem_in"], s["ltpf_mem_normcorr"], s["ltpf_mem_mem_normcorr"],
             s["ltpf_mem_ltpf_on"], s["ltpf_mem_pitch"])
    lref = J(JA.ltpf_encode, JCFG)(y, pitch_ol, nc_ol, *largs)
    lgot = PA.ltpf_encode(PCFG, t(y), t(pitch_ol), t(nc_ol), *map(t, largs))
    for k in (0, 1, 5):
        np.testing.assert_array_equal(n(lgot[k]), np.asarray(lref[k]))
    close(lgot[6], lref[6])


def test_attack_detector():
    jcfg, pcfg = JConfig(fs_in=48000, bitrate=128000), P.Config(fs_in=48000, bitrate=128000)
    assert pcfg.attack_handling
    rng = np.random.default_rng(5)
    B = 6
    x = (rng.standard_normal((B, 480)) * np.array([10, 100, 1000, 3000, 30, 5000])[:, None])
    x[2, 300:] *= 40
    x = x.astype(np.float32)
    pos = np.array([0, 3, -1, 1, 4, 0], np.int32)
    acc = (rng.random(B) * 1e6).astype(np.float32)
    fmem = (rng.standard_normal((B, 2)) * 100).astype(np.float32)
    ref = J(JA.attack_detector, jcfg)(x, pos, acc, fmem)
    got = PA.attack_detector(pcfg, t(x), t(pos), t(acc), t(fmem))
    np.testing.assert_array_equal(n(got[0]), np.asarray(ref[0]))
    np.testing.assert_array_equal(n(got[1]), np.asarray(ref[1]))
    close(got[2], ref[2])
    close(got[3], ref[3])


@pytest.mark.parametrize("frame", [0, 1])
def test_band_energy_and_bandwidth(frame):
    r = encoder_stages()[frame]
    ener = J(JA.per_band_energy, JCFG)(r["d"])
    close(PA.per_band_energy(PCFG, t(r["d"])), ener)
    ener = np.asarray(ener)
    # also quiet high bands, so the detector leaves full band on some streams
    quiet = ener.copy()
    quiet[:, 40:] *= 1e-9
    for e in (ener, quiet):
        np.testing.assert_array_equal(
            n(PA.detect_cutoff_warped(PCFG, t(e))),
            np.asarray(J(JA.detect_cutoff_warped, JCFG)(e)))


@pytest.mark.parametrize("bw", [4000, 8000, 16000])
def test_cutoff_bandwidth(bw):
    jcfg = JConfig(fs_in=48000, bitrate=64000, bandwidth=bw)
    pcfg = P.Config(fs_in=48000, bitrate=64000, bandwidth=bw)
    d = encoder_stages()[1]["d"]
    np.testing.assert_array_equal(n(PA.cutoff_bandwidth(pcfg, t(d))),
                                  np.asarray(J(JA.cutoff_bandwidth, jcfg)(d)))
    assert torch.is_tensor(PA.cutoff_bandwidth(pcfg, t(d)))
