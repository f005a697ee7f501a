"""Side information of audio_codec_torch against audio_codec_tpu on the CPU:
the plain versions of the `side_info_pack` and `side_info_parse` kernels
must give the reference's bytes, cursors and parsed fields exactly, with and
without the bandwidth field (48 kHz, 8 kHz), for a 2.5 ms frame (always one
TNS filter), on every SNS submode's field widths, on random bytes, and on
frames that fire each of the parser's bad-frame triggers."""
from __future__ import annotations

import functools

import numpy as np
import pytest

import audio_codec_torch as P
from audio_codec_torch.ops import bits as PB
from audio_codec_tpu.config import Config as JConfig
from audio_codec_tpu.ops import bits as JB

from tests import torch_kernel_cases as C
from tests.torch_port_data import J, n, t


@functools.cache
def configs(name: str):
    return JConfig(**C.CONFIGS[name]), P.Config(**C.CONFIGS[name])


def jax_pack(jcfg, fields: dict):
    B = fields["scf_idx"].shape[0]
    out = J(JB.pack_side_info, jcfg)(np.zeros((B, jcfg.targetBytes), np.int32),
                                     *(fields[k] for k in C.FIELD_ORDER))
    return tuple(np.asarray(v) for v in out)


@pytest.mark.parametrize("name", list(C.CONFIGS))
def test_pack_side_info_matches_reference(name):
    jcfg, pcfg = configs(name)
    assert (jcfg.BW_cutoff_bits, jcfg.lastnz_bits) == (pcfg.BW_cutoff_bits, pcfg.lastnz_bits)
    fields = C.side_fields(pcfg, 48, seed=3)
    got = PB.pack_side_info(pcfg, *(t(fields[k]) for k in C.FIELD_ORDER))
    for g, e in zip(got, jax_pack(jcfg, fields)):
        np.testing.assert_array_equal(n(g), e)
    assert set(np.unique(fields["scf_idx"][:, 2])) == {0, 1, 2, 3}
    assert set(np.unique(fields["ltpf_param"][:, 0])) == {0, 1}


@pytest.mark.parametrize("name,rows", C.PARSE_CASES)
def test_parse_side_info_matches_reference(name, rows):
    jcfg, pcfg = configs(name)
    if rows == "random":
        buf = np.random.default_rng(5).integers(0, 256, (64, pcfg.targetBytes)).astype(np.int32)
    else:
        fields = (C.side_fields(pcfg, 48, seed=4) if rows == "packed"
                  else C.corrupt_fields(pcfg, rows))
        buf = jax_pack(jcfg, fields)[0]
    ref = J(JB.parse_side_info, jcfg)(buf)
    got = PB.parse_side_info(pcfg, t(buf))
    assert set(got) == set(ref)
    for k in ref:
        np.testing.assert_array_equal(n(got[k]), np.asarray(ref[k]), err_msg=k)
    bfi = n(got["bfi"])
    if rows in C.BFI_TRIGGERS:
        assert (bfi == 1).all(), f"{rows}: the trigger did not fire"
    elif rows == "packed":
        assert (bfi == 0).all()
        for k in ("bw_idx", "lastnz", "lsb_mode", "gg_idx", "scf_idx", "ltpf_param",
                  "fac_ns_idx"):
            np.testing.assert_array_equal(n(got[k]), fields[k], err_msg=k)
        if pcfg.frame_dms == 25:
            assert (n(got["num_tns"]) == 1).all()
    else:
        assert 0 < bfi.sum() < bfi.size
