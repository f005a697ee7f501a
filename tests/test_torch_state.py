"""EncState / DecState of audio_codec_torch against audio_codec_tpu: init,
the numpy converters, and the stepped-state signature."""
from __future__ import annotations

import numpy as np
import pytest
import torch

import audio_codec_torch as P
from audio_codec_torch.models import state as PS
from audio_codec_tpu.config import Config as JConfig
from audio_codec_tpu.models import state as JS

from tests.torch_port_data import pcm_block, state_dict


@pytest.mark.parametrize("fs,br", [(48000, 64000), (16000, 32000), (32000, 96000)])
def test_state_init_matches_reference(fs, br):
    jcfg, pcfg = JConfig(fs_in=fs, bitrate=br), P.Config(fs_in=fs, bitrate=br)
    for jinit, pinit, to_np in ((JS.enc_state_init, PS.enc_state_init, PS.enc_state_to_numpy),
                                (JS.dec_state_init, PS.dec_state_init, PS.dec_state_to_numpy)):
        ref = state_dict(jinit(jcfg, 3))
        got = to_np(pinit(pcfg, 3, device="cpu"))
        assert list(got) == list(ref)
        for k in ref:
            assert got[k].dtype == ref[k].dtype and got[k].shape == ref[k].shape, k
            np.testing.assert_array_equal(got[k], ref[k], err_msg=k)


def test_converters_round_trip():
    cfg = JConfig(fs_in=48000, bitrate=64000)
    rng = np.random.default_rng(3)
    for jinit, from_np, to_np in ((JS.enc_state_init, PS.enc_state_from_numpy, PS.enc_state_to_numpy),
                                  (JS.dec_state_init, PS.dec_state_from_numpy, PS.dec_state_to_numpy)):
        ref = {k: (rng.standard_normal(v.shape) * 100).astype(v.dtype)
               for k, v in state_dict(jinit(cfg, 2)).items()}
        back = to_np(from_np(ref, device="cpu"))
        for k in ref:
            assert back[k].dtype == ref[k].dtype
            np.testing.assert_array_equal(back[k], ref[k], err_msg=k)
    with pytest.raises(ValueError, match="missing"):
        PS.enc_state_from_numpy({"mdct_mem": np.zeros((1, 300), np.float32)}, device="cpu")


def test_state_signature_stable_across_step():
    """Dtypes and shapes of the stepped state equal the init state's (the
    port's counterpart of test_engine_state.py's signature test)."""
    cfg = P.Config(fs_in=48000, bitrate=64000)
    B = 2
    sig = lambda st: [(k, v.dtype, v.shape) for k, v in PS.enc_state_to_numpy(st).items()]
    est = P.enc_state_init(cfg, B, device="cpu")
    est2, out, _ = P.encode_frame(cfg, est, torch.from_numpy(pcm_block(1, B)[0]))
    assert sig(est2) == sig(est)
    assert out.dtype == torch.uint8 and tuple(out.shape) == (B, cfg.targetBytes)
    dsig = lambda st: [(k, v.dtype, v.shape) for k, v in PS.dec_state_to_numpy(st).items()]
    dst = P.dec_state_init(cfg, B, device="cpu")
    dst2, pcm, _ = P.decode_frame(cfg, dst, out)
    assert dsig(dst2) == dsig(dst)
    assert pcm.dtype == torch.float32 and tuple(pcm.shape) == (B, cfg.frame_length)


@pytest.mark.parametrize("fs,br", [(48000, 64000), (16000, 32000)])
def test_plc_mode1_state_matches_reference_and_round_trips(fs, br):
    """At plc_mode 1 the advanced-concealment and Phase ECU fields take the
    reference's widths and initial values, and the numpy converters carry
    them, the complex64 prototype spectrum included."""
    jcfg = JConfig(fs_in=fs, bitrate=br, plc_mode=1)
    pcfg = P.Config(fs_in=fs, bitrate=br, plc_mode=1)
    ref = state_dict(JS.dec_state_init(jcfg, 3))
    got = PS.dec_state_to_numpy(PS.dec_state_init(pcfg, 3, device="cpu"))
    assert list(got) == list(ref)
    for k in ref:
        assert got[k].dtype == ref[k].dtype and got[k].shape == ref[k].shape, k
        np.testing.assert_array_equal(got[k], ref[k], err_msg=k)
    rng = np.random.default_rng(4)
    rows = {k: (rng.standard_normal(v.shape) * 100).astype(v.dtype) for k, v in ref.items()}
    rows["phecu_X_sav"] = (rows["phecu_X_sav"] + 1j * rng.standard_normal(
        rows["phecu_X_sav"].shape)).astype(np.complex64)
    back = PS.dec_state_to_numpy(PS.dec_state_from_numpy(rows, device="cpu"))
    for k in rows:
        assert back[k].dtype == rows[k].dtype
        np.testing.assert_array_equal(back[k], rows[k], err_msg=k)
