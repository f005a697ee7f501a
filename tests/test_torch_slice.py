"""The port's main path against the reference: 48 kHz / 10 ms / 64 kbps
encode_frame over T frames of B streams must give payload bytes identical
to audio_codec_tpu's, and decode_block must give int16 PCM identical to
audio_codec_tpu's decode_block, on the port's payloads and on the
reference's."""
from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import audio_codec_torch as P
from audio_codec_tpu.models import decoder as JD
from audio_codec_tpu.models import encoder as JE
from audio_codec_tpu.models import state as JS

from tests.torch_port_data import JCFG, PCFG, material

T, B = 4, 2


def block(T: int, streams: tuple[str, ...], seed: int = 0, offset: int = 96000):
    """[T, len(streams), 480] PCM: 'noise' (seeded) or a material cut."""
    n = JCFG.frame_length
    rng = np.random.default_rng(seed)
    cols = [rng.standard_normal(T * n) * 3000.0 if s == "noise"
            else material(s)[offset: offset + T * n] for s in streams]
    return np.stack([c.reshape(T, n) for c in cols], axis=1).astype(np.float32)


def jax_encode(pcm):
    def body(st, x):
        st, out, _ = JE.encode_frame(JCFG, st, x)
        return st, out
    _, out = jax.jit(lambda st, p: jax.lax.scan(body, st, p))(
        JS.enc_state_init(JCFG, pcm.shape[1]), jnp.asarray(pcm))
    return np.asarray(out)


def jax_decode(frames):
    _, pcm = jax.jit(lambda st, f: JD.decode_block(JCFG, st, f))(
        JS.dec_state_init(JCFG, frames.shape[1]), jnp.asarray(frames.astype(np.int32)))
    return np.asarray(JD.round_pcm(pcm))


def port_encode(pcm):
    st = P.enc_state_init(PCFG, pcm.shape[1], device="cpu")
    _, out = P.encode_block(PCFG, st, torch.from_numpy(pcm))
    return out.numpy()


def port_decode(frames):
    st = P.dec_state_init(PCFG, frames.shape[1], device="cpu")
    _, pcm = P.decode_block(PCFG, st, torch.from_numpy(frames))
    return P.round_pcm(pcm).numpy()


@functools.cache
def payloads():
    pcm = block(T, ("noise", "speech"))
    return jax_encode(pcm), port_encode(pcm)


def test_encode_payload_bytes_identical():
    ref, got = payloads()
    assert got.dtype == np.uint8 and got.shape == ref.shape == (T, B, JCFG.targetBytes)
    bad = [(f, b) for f in range(T) for b in range(B) if not np.array_equal(got[f, b], ref[f, b])]
    assert bad == [], f"frames (t, stream) with differing bytes: {bad}"


@pytest.mark.parametrize("source", ["port", "reference"])
def test_decode_block_pcm_identical(source):
    ref_frames, port_frames = payloads()
    frames = port_frames if source == "port" else ref_frames
    ref = jax_decode(frames)
    got = port_decode(frames)
    assert got.dtype == np.int16 and got.shape == ref.shape == (T, B, JCFG.frame_length)
    mism = [(f, b, int((got[f, b] != ref[f, b]).sum())) for f in range(T) for b in range(B)
            if not np.array_equal(got[f, b], ref[f, b])]
    assert mism == [], f"(frame, stream, differing samples): {mism}"


@functools.cache
def long_payloads(name: str):
    """200 frames (2 s) of a material file beside seeded noise."""
    pcm = block(200, (name, "noise"), seed=3, offset=0)
    return jax_encode(pcm), port_encode(pcm)


@pytest.mark.slow
@pytest.mark.parametrize("name", ["speech", "music"])
def test_long_material_payload_bytes_identical(name):
    ref, got = long_payloads(name)
    bad = np.nonzero((got != ref).any(axis=2))
    assert len(bad[0]) == 0, f"(frame, stream) with differing bytes: {list(zip(*bad))[:10]}"


@pytest.mark.slow
@pytest.mark.parametrize("name", ["speech", "music"])
def test_long_material_pcm_identical(name):
    """Reports the differing samples per (frame, stream) if any."""
    ref, _ = long_payloads(name)
    pcm_ref = jax_decode(ref)
    pcm_got = port_decode(ref)
    diff = pcm_got != pcm_ref
    where = [(int(f), int(b), int(diff[f, b].sum()))
             for f, b in zip(*np.nonzero(diff.any(axis=2)))]
    assert not diff.any(), f"{int(diff.sum())} of {diff.size} samples differ: {where[:20]}"
