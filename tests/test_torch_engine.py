"""The stream engine of audio_codec_torch against audio_codec_tpu's, on the
CPU: StreamEncoder -> channel -> StreamDecoder with the channel coder, EP
modes 1-4 at 48 kHz / 64 kbps (an 80-byte slot), 4 streams, with channel
errors (corrected symbols, a destroyed partial-concealment codeword, heavy
corruption) and a lost and a redundancy frame. Payload bytes, int16 PCM,
last_bfi, the EPMR and the error report must be equal. The reference
decodes in a process pinned to one core (the IMDCT's product order,
tests/test_torch_transforms.py:run_pinned); EP3 runs in tier 1, the other
modes, a mid-stream EP switch, PLC trigger frames and a 2-channel stream
under combined channel coding are slow (each Config is a new JAX compile)."""
from __future__ import annotations

import json

import numpy as np
import pytest

import audio_codec_torch as P
from audio_codec_torch import engine as PE
from audio_codec_tpu import engine as JE
from audio_codec_tpu.config import Config as JConfig

from tests import torch_kernel_cases as C
from tests.test_torch_transforms import run_pinned
from tests.torch_port_data import pcm_block

T_FRAMES, B = 6, 4

JAX_DECODE = """
import json
from audio_codec_tpu import engine as JE
from audio_codec_tpu.config import Config
from tests import torch_kernel_cases as C
cfg = Config(**json.loads(bytes(args["cfg"]).decode()))
pays = [bytes(r) for r in args["payloads"].astype(np.uint8)]
lens = args["lens"]
pays = [p[:n] for p, n in zip(pays, lens)]
out = C.decode_stream(JE.StreamDecoder(cfg, int(args["n"])), pays, args["frame_bfi"])
"""


def run_both(cfg_kw: dict, n: int = B, T: int = T_FRAMES, epmode_at=None, trigger_at=()):
    jcfg, pcfg = JConfig(**cfg_kw), P.Config(**cfg_kw)
    pcm = pcm_block(T, n)
    ref_frames = C.encode_stream(JE.StreamEncoder(jcfg, n), pcm, epmode_at, trigger_at)
    got_frames = C.encode_stream(PE.StreamEncoder(pcfg, n, device="cpu"), pcm, epmode_at,
                                 trigger_at)
    assert got_frames == ref_frames
    modes = [cfg_kw.get("epmode", 0)]
    for f in range(1, T):
        modes.append((epmode_at or {}).get(f, modes[-1]))
    slot_of = lambda f: (len(ref_frames[f][0]), modes[f])
    kinds, frame_bfi = C.stream_plan(T, n)
    payloads = C.channel(ref_frames, slot_of, kinds)
    width = max(len(p) for p in payloads)
    ref = run_pinned(JAX_DECODE, cfg=np.frombuffer(json.dumps(cfg_kw).encode(), np.uint8),
                     payloads=np.stack([np.frombuffer(p.ljust(width, b"\0"), np.uint8)
                                        for p in payloads]),
                     lens=np.array([len(p) for p in payloads]), n=np.array(n),
                     frame_bfi=frame_bfi)
    got = C.decode_stream(PE.StreamDecoder(pcfg, n, device="cpu"), payloads, frame_bfi)
    np.testing.assert_array_equal(got[..., : pcfg.frame_length], ref[..., : pcfg.frame_length])
    np.testing.assert_array_equal(got, ref)
    return ref


def test_stream_engine_ep3_with_channel_errors():
    out = run_both(dict(fs_in=48000, bitrate=64000, epmode=3))
    bfi = out[..., 480]      # last_bfi, after the PCM
    # a destroyed PC codeword gives bfi 2, heavy corruption and the lost
    # frame bfi 1, clean and corrected frames bfi 0
    assert {0, 1, 2} <= set(np.unique(bfi).tolist()), bfi


@pytest.mark.slow
@pytest.mark.parametrize("epmode", [1, 2, 4])
def test_stream_engine_other_ep_modes(epmode):
    run_both(dict(fs_in=48000, bitrate=64000, epmode=epmode))


@pytest.mark.slow
def test_stream_engine_mid_stream_ep_switch_and_plc_trigger():
    run_both(dict(fs_in=48000, bitrate=64000, epmode=2), epmode_at={2: 4, 4: 1},
             trigger_at=(5,))


@pytest.mark.slow
def test_stream_engine_two_channels_combined_channel_coding():
    cfg_kw = dict(fs_in=48000, bitrate=64000, channels=2, epmode=3)
    assert P.Config(**cfg_kw).ccc == 1
    run_both(cfg_kw)
