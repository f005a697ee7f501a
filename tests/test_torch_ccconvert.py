"""The port's ccConvert (`audio_codec_torch/ccconvert.py`) against the
reference's (`audio_codec_tpu/ccconvert.py`), with device="cpu": the packed
frames, the unpacked frames and the count of undecodable frames byte for
byte, on a stereo stream at two slot sizes (40 bytes a channel at EP2, where
the two channels share one combined slot, and 100 bytes a channel at EP2,
coded per channel), with one frame corrupted past correction; and the
converter's files. Packing at EP3 into 100-byte slots, where the encoder's
partial-concealment simulation moves a block of each payload, runs real
frames of the port's encoder and is `-m slow`: the reference compiles its
range decoder twice there (about 100 s)."""
from __future__ import annotations

import numpy as np
import pytest
import torch

import audio_codec_torch as P
from audio_codec_torch import ccconvert as PC
from audio_codec_torch.ops import fec
from audio_codec_torch.utils import bitstream_io as PB
from audio_codec_tpu import ccconvert as JC
from audio_codec_tpu.utils import bitstream_io as JB

from tests.torch_port_data import pcm_block

N_FRAMES = 4


def header(mod, per_channel_bytes: int, epmode: int = 0):
    return mod.StreamHeader(samplerate=48000, bitrate=per_channel_bytes * 800 * 2, channels=2,
                            frame_ms=10.0, epmode=epmode, signal_len=N_FRAMES * 480)


def random_frames(gross: int, epmode: int, seed: int = 0) -> list[bytes]:
    """Stereo EP0 frames that fill the protected payload of the slot."""
    ccc = 2 * gross <= 160
    size = fec.fec_get_data_size(epmode, 1, 2 * gross) if ccc else \
        2 * fec.fec_get_data_size(epmode, 0, gross)
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 256, size, dtype=np.uint8).tobytes() for _ in range(N_FRAMES)]


def corrupt(frames: list[bytes], k: int = 1) -> list[bytes]:
    """Frame k with its first 30 bytes overwritten: past what the code corrects."""
    out = list(frames)
    raw = bytearray(out[k])
    raw[:30] = np.random.default_rng(9).integers(0, 256, 30, dtype=np.uint8).tobytes()
    out[k] = bytes(raw)
    return out


def both(frames: list[bytes], gross: int, epmode: int):
    """(port, reference) of pack, then unpack of the packed frames with one
    corrupted."""
    per = len(frames[0]) // 2
    packed = (PC.pack_frames(header(PB, per), frames, gross, epmode, device="cpu"),
              JC.pack_frames(header(JB, per), frames, gross, epmode))
    bad = corrupt(packed[1])
    unpacked = (PC.unpack_frames(header(PB, per, epmode), bad, device="cpu"),
                JC.unpack_frames(header(JB, per, epmode), bad))
    return packed, unpacked


@pytest.mark.parametrize("gross", [40, 100])
def test_pack_unpack_match_reference(gross):
    frames = random_frames(gross, 2)
    (p, j), ((pu, pn), (ju, jn)) = both(frames, gross, 2)
    assert p == j and all(len(f) == 2 * gross for f in p)
    assert pu == ju and pn == jn == 1
    assert [f for k, f in enumerate(pu) if k != 1] == [f for k, f in enumerate(frames) if k != 1]
    assert PC.unpack_frames(header(PB, 0, 2), p, device="cpu") == (frames, 0)


def test_main_files_match_reference(tmp_path):
    frames = random_frames(40, 2, seed=1)
    per = len(frames[0]) // 2
    PB.write_all(tmp_path / "in.bin", header(PB, per), frames)
    for mod, main, who in ((PC, lambda a: PC.main(a, device="cpu"), "p"), (JC, JC.main, "j")):
        assert main(["-pack", "40", "2", str(tmp_path / "in.bin"), str(tmp_path / f"{who}.bin")]) == 0
        assert main(["-unpack", str(tmp_path / f"{who}.bin"), str(tmp_path / f"{who}_u.bin")]) == 0
    for name in ("{}.bin", "{}_u.bin"):
        assert (tmp_path / name.format("p")).read_bytes() == (tmp_path / name.format("j")).read_bytes()
    assert PB.read_all(tmp_path / "p_u.bin")[1] == frames


@pytest.mark.slow
def test_pack_unpack_with_block_move_match_reference():
    """EP3 in 100-byte slots: the encoder's PC simulation finds each
    payload's convergence byte and moves a block; unpack finds it again."""
    gross, epmode = 100, 3
    per = fec.fec_get_data_size(epmode, 0, gross)
    cfg = P.Config(fs_in=48000, bitrate=per * 800)
    _, fr = P.encode_block(cfg, P.enc_state_init(cfg, 2, device="cpu"),
                           torch.from_numpy(pcm_block(N_FRAMES, 2)))
    fr = fr.numpy()
    frames = [fr[t, 0].tobytes() + fr[t, 1].tobytes() for t in range(N_FRAMES)]
    (p, j), ((pu, pn), (ju, jn)) = both(frames, gross, epmode)
    assert p == j
    assert pu == ju and pn == jn
    assert PC.unpack_frames(header(PB, per, epmode), p, device="cpu") == (frames, 0)
