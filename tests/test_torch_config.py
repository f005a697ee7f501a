"""Config derivation and tables of audio_codec_torch against audio_codec_tpu."""
from __future__ import annotations

import dataclasses
import itertools

import numpy as np
import pytest

import audio_codec_torch as P
from audio_codec_torch import tables as PT
from audio_codec_tpu import tables as JT
from audio_codec_tpu.config import Config as JConfig

from tests import torch_threads  # noqa: F401  (one torch thread a test process)

GRID = [
    (fs, dms, br, hr)
    for fs, dms, br, hr in itertools.product(
        (8000, 16000, 24000, 32000, 44100, 48000, 96000), (25, 50, 100),
        (16000, 32000, 64000, 128000, 256000), (False, True))
]


def _derive(cls, fs, dms, br, hr, **kw):
    try:
        return cls(fs_in=fs, bitrate=br, frame_dms=dms, hrmode=hr, **kw)
    except (ValueError, KeyError) as e:
        return type(e).__name__


@pytest.mark.parametrize("fs,dms,br,hr", GRID)
def test_config_fields_equal(fs, dms, br, hr):
    a = _derive(JConfig, fs, dms, br, hr)
    b = _derive(P.Config, fs, dms, br, hr)
    if isinstance(a, str) or isinstance(b, str):
        assert a == b
        return
    assert dataclasses.asdict(a) == dataclasses.asdict(b)
    for prop in ("frame_ms", "len_12k8", "mem_in_len", "ltpf_mem_in_len",
                 "lastnz_bits", "rateFlag", "modeFlag"):
        assert getattr(a, prop) == getattr(b, prop), prop


@pytest.mark.parametrize("epmode,channels", [(1, 1), (2, 1), (3, 1), (4, 1), (3, 2), (4, 2)])
def test_config_channel_coder_budgets_equal(epmode, channels):
    kw = dict(fs_in=48000, bitrate=128000 * channels, epmode=epmode, channels=channels)
    for ch in range(channels):
        a, b = JConfig(**kw, ch_idx=ch), P.Config(**kw, ch_idx=ch)
        assert dataclasses.asdict(a) == dataclasses.asdict(b)


def test_tables_file_is_a_byte_copy():
    src = JT._DATA.read_bytes()
    assert PT._DATA.read_bytes() == src
    ja, pa = JT._npz(), PT._npz()
    assert sorted(ja) == sorted(pa)


@pytest.mark.parametrize("fs_idx,n", [(0, 80), (2, 240), (4, 480), (5, 960)])
def test_derived_matrices_equal(fs_idx, n):
    np.testing.assert_array_equal(PT.dct4_matrix(n), JT.dct4_matrix(n))
    np.testing.assert_array_equal(PT.dct2_matrix(), JT.dct2_matrix())
    np.testing.assert_array_equal(PT.resampler_matrix(fs_idx, n),
                                  JT.resampler_matrix(fs_idx, n))
    hr = fs_idx == 5
    np.testing.assert_array_equal(PT.band_energy_matrix(fs_idx, 100, hr, n),
                                  JT.band_energy_matrix(fs_idx, 100, hr, n))
    np.testing.assert_array_equal(PT.band_expand_indices(fs_idx, 100, hr, n),
                                  JT.band_expand_indices(fs_idx, 100, hr, n))
