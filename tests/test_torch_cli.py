"""The port's file tools against the reference: the WAV and bitstream
containers (`audio_codec_torch/utils`), byte for byte against
`audio_codec_tpu/utils`; the IMDCT's product of a single stream, which the
CLI's mono files take, against the reference's; and the CLI
(`python -m audio_codec_torch.cli`) with device="cpu".

Tier 1 holds the CLI to itself: -E then -D gives what encdec gives over the
same loss pattern, G.192 what the container gives, and -edf flags the lost
frames. The byte comparison of every output file with
`audio_codec_tpu.cli.main` (EP0 with -epf/-edf, EP3 with -ep_dbg, on a
6-frame mono WAV) is `-m slow`: each reference configuration is a new JAX
compile of the stream engine's encoder and decoder, about 2-3 minutes."""
from __future__ import annotations

import wave

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from audio_codec_torch import cli as PC
from audio_codec_torch import tables as PT
from audio_codec_torch.ops import numerics as nm
from audio_codec_torch.utils import bitstream_io as PB, native as PN, wavio as PW
from audio_codec_tpu import tables as JT
from audio_codec_tpu.utils import bitstream_io as JB, native as JN, wavio as JW

from tests.torch_port_data import material

FRAMES = 6


@pytest.mark.parametrize("sampwidth", [2, 3, 4])
def test_wavio_matches_reference(tmp_path, sampwidth):
    rng = np.random.default_rng(sampwidth)
    lim = 1 << (8 * sampwidth - 1)
    data = rng.integers(-lim, lim, (300, 2)).astype(np.int64)
    data[:2] = [[-lim, lim - 1], [0, -1]]
    PW.write_wav(tmp_path / "p.wav", data, 48000, sampwidth=sampwidth)
    JW.write_wav(tmp_path / "j.wav", data, 48000, sampwidth=sampwidth)
    assert (tmp_path / "p.wav").read_bytes() == (tmp_path / "j.wav").read_bytes()
    got, ref = PW.read_wav(tmp_path / "p.wav"), JW.read_wav(tmp_path / "j.wav")
    assert got[1] == ref[1] == 48000
    np.testing.assert_array_equal(got[0], ref[0])


def frames_of(seed: int, n: int = 7) -> list[bytes]:
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 256, int(rng.integers(0, 90)), dtype=np.uint8).tobytes()
            for _ in range(n)]


@pytest.mark.parametrize("compact", [False, True])
def test_bitstream_container_matches_reference(tmp_path, compact):
    kw = dict(samplerate=44100, bitrate=96000, channels=2, frame_ms=7.5, epmode=3,
              signal_len=70000 + (1 << 16), hrmode=0 if compact else 1)
    frames = frames_of(1)
    PB.write_all(tmp_path / "p.bin", PB.StreamHeader(**kw), frames, compact=compact)
    JB.write_all(tmp_path / "j.bin", JB.StreamHeader(**kw), frames, compact=compact)
    assert (tmp_path / "p.bin").read_bytes() == (tmp_path / "j.bin").read_bytes()
    (h, got), (hj, ref) = PB.read_all(tmp_path / "p.bin"), JB.read_all(tmp_path / "j.bin")
    assert got == ref == frames and vars(h) == vars(hj)


def test_g192_matches_reference(tmp_path):
    frames = frames_of(2)
    flags = [(True, False), (False, False), (True, True)] * 3
    for mod, name in ((PB, "p"), (JB, "j")):
        with open(tmp_path / f"{name}.g192", "wb") as f:
            for fr, (good, red) in zip(frames, flags):
                mod.write_g192_frame(f, fr, good=good, redundancy=red)
    assert (tmp_path / "p.g192").read_bytes() == (tmp_path / "j.g192").read_bytes()
    with open(tmp_path / "p.g192", "rb") as fp, open(tmp_path / "j.g192", "rb") as fj:
        for _ in range(len(frames) + 1):
            assert PB.read_g192_frame(fp) == JB.read_g192_frame(fj)


def test_native_host_loops_match_reference():
    rng = np.random.default_rng(3)
    pcm = rng.integers(-32768, 32768, (50, 3)).astype(np.int16)
    np.testing.assert_array_equal(PN.pcm16_deinterleave(pcm, 3), JN.pcm16_deinterleave(pcm, 3))
    x = (rng.standard_normal((3, 50)) * 40000).astype(np.float32)
    x[0, :4] = [0.5, -0.5, 1.5, -2.5]
    np.testing.assert_array_equal(PN.pcm16_interleave(x), JN.pcm16_interleave(x))
    payloads = rng.integers(0, 256, (5, 13)).astype(np.uint8)
    body = PN.bs_emit_frames(payloads)
    assert body == JN.bs_emit_frames(payloads)
    offs, lens = PN.bs_scan_frames(body)
    ref = JN.bs_scan_frames(body)
    np.testing.assert_array_equal(offs, ref[0])
    np.testing.assert_array_equal(lens, ref[1])
    np.testing.assert_array_equal(PN.bs_gather_frames(body, offs, 13), payloads)


@pytest.mark.parametrize("N", [480, 160])
def test_imdct_single_stream_product_matches_reference(N):
    """The IMDCT's product of one row (transforms.py:107 on a mono stream)
    against the reference's: eight interleaved chains, on one core or many."""
    M = jnp.asarray(JT.dct4_matrix(N), jnp.float32)
    dot = jax.jit(lambda y: jnp.dot(y, M.T, preferred_element_type=jnp.float32))
    Mt = nm.const(PT.dct4_matrix(N).T, "cpu")
    rng = np.random.default_rng(N)
    for scale in (1.0, 1e-3, 3e4):
        y = (rng.standard_normal((1, N)) * scale).astype(np.float32)
        got = nm.xla_gemv(torch.from_numpy(y), Mt).numpy()
        np.testing.assert_array_equal(got.view(np.int32), np.asarray(dot(y)).view(np.int32))


def mono_wav(path, frames: int = FRAMES):
    PW.write_wav(path, material("speech")[48000: 48000 + frames * 480, None].astype(np.int16),
                 48000)
    return str(path)


def loss_pattern(path, lost=(2, 3), frames: int = FRAMES):
    pat = np.zeros(frames, "<i2")
    pat[list(lost)] = 1
    pat.tofile(path)
    return str(path)


def test_cli_encode_then_decode_equals_encdec(tmp_path):
    """-E then -D equals encdec over the same loss pattern, and so does the
    G.192 route; -edf flags the lost frame (3 frames, the second lost)."""
    p = lambda name: str(tmp_path / name)
    wav, epf = mono_wav(tmp_path / "in.wav", 3), loss_pattern(tmp_path / "loss.epf", (1,), 3)
    run = lambda *a: PC.main(["-q", *a], device="cpu")
    assert run("-E", wav, p("s.bin"), "64000") == 0
    assert run("-D", "-epf", epf, "-edf", p("s.edf"), p("s.bin"), p("s.wav")) == 0
    assert run("-epf", epf, wav, p("encdec.wav"), "64000") == 0
    assert (tmp_path / "s.wav").read_bytes() == (tmp_path / "encdec.wav").read_bytes()
    np.testing.assert_array_equal(np.fromfile(p("s.edf"), "<i2"), [0, 1, 0])
    with wave.open(p("s.wav")) as w:
        assert w.getnchannels() == 1 and w.getframerate() == 48000
    assert run("-E", "-formatG192", wav, p("s.g192"), "64000") == 0
    assert run("-D", "-formatG192", "-epf", epf, p("s.g192"), p("g.wav")) == 0
    assert (tmp_path / "g.wav").read_bytes() == (tmp_path / "s.wav").read_bytes()


def test_tools_raise_without_a_card(tmp_path):
    """Without device="cpu" the tools run on the card, and there is none."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is usable")
    from audio_codec_torch import ccconvert
    wav = mono_wav(tmp_path / "in.wav", 1)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        PC.main(["-q", "-E", wav, str(tmp_path / "s.bin"), "64000"])
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ccconvert.pack_frames(PB.StreamHeader(48000, 64000, 1, 10.0, 0, 480), [b""], 40, 2)


CASES = {
    "ep0_epf_edf": (["-E", "{wav}", "{out}.bin", "64000"],
                    ["-D", "-epf", "{epf}", "-edf", "{out}.edf", "{out}.bin", "{out}.wav"]),
    "ep3_ep_dbg": (["-E", "-epmode", "3", "{wav}", "{out}.bin", "64000"],
                   ["-D", "-ep_dbg", "{out}_dbg", "{out}.bin", "{out}.wav"]),
}


@pytest.mark.slow
@pytest.mark.parametrize("case", list(CASES))
def test_cli_matches_reference(tmp_path, case):
    """Every output file of the port's CLI (device="cpu") byte-equal to
    audio_codec_tpu.cli.main's, on a 6-frame mono WAV."""
    from audio_codec_tpu import cli as JC
    wav, epf = mono_wav(tmp_path / "in.wav"), loss_pattern(tmp_path / "loss.epf")
    for who, main in (("p", lambda a: PC.main(a, device="cpu")), ("j", JC.main)):
        for step in CASES[case]:
            args = [a.format(wav=wav, epf=epf, out=tmp_path / who) for a in step]
            assert main(["-q", *args]) == 0
    outs = sorted(f.name[1:] for f in tmp_path.glob("p*"))
    assert len(outs) >= 3
    for name in outs:
        assert (tmp_path / ("p" + name)).read_bytes() == (tmp_path / ("j" + name)).read_bytes(), name
