"""Temporal noise shaping of audio_codec_torch against audio_codec_tpu.

Filter orders, coefficient indices and bit counts must be equal. The
lattice-filtered spectra are held to 2**-16 relative plus 2**-16 of the
spectrum's peak: the port contracts the lattice's products as XLA:CPU does
in most steps, not in all."""
from __future__ import annotations

import numpy as np
import pytest

import audio_codec_torch as P
from audio_codec_torch.ops import tns as PT
from audio_codec_tpu.config import Config as JConfig
from audio_codec_tpu.ops import tns as JT

from tests.torch_port_data import JCFG, PCFG, J, encoder_stages, n, t


def close(got, ref):
    ref = np.asarray(ref)
    tol = 2.0 ** -16 * float(np.abs(ref).max(initial=0.0))
    np.testing.assert_allclose(n(got), ref, rtol=2.0 ** -16, atol=tol)


@pytest.mark.parametrize("frame", [0, 1])
@pytest.mark.parametrize("bitrate", [64000, 32000])
def test_tns_encode(frame, bitrate):
    jcfg, pcfg = JConfig(fs_in=48000, bitrate=bitrate), P.Config(fs_in=48000, bitrate=bitrate)
    r = encoder_stages()[frame]
    bw = np.array([4, 4, 3, 2], np.int32)[: r["d_shaped"].shape[0]]
    for bw_idx in (r["bw_idx"], bw):
        ref = J(JT.tns_encode, jcfg)(r["d_shaped"], bw_idx)
        got = PT.tns_encode(pcfg, t(r["d_shaped"]), t(bw_idx))
        close(got[0], ref[0])
        for k in range(1, 5):
            np.testing.assert_array_equal(n(got[k]), np.asarray(ref[k]))


@pytest.mark.parametrize("frame", [0, 1])
def test_tns_decode(frame):
    """On the encoder's own filters, and on seeded random ones (orders 0-8,
    one or two filters) so that every lattice branch runs."""
    r = encoder_stages()[frame]
    x = r["d2"][:, : PCFG.yLen]
    B = x.shape[0]
    rng = np.random.default_rng(10 + frame)
    rand = (rng.integers(2, 15, (B, 2, 8)).astype(np.int32),
            rng.integers(0, 9, (B, 2)).astype(np.int32),
            np.array([2, 1, 2, 2], np.int32)[:B], np.array([4, 4, 3, 4], np.int32)[:B])
    for args in ((r["tns_idx"], r["tns_order"], r["num_tns"], r["bw_idx"]), rand):
        close(PT.tns_decode(PCFG, t(x), *map(t, args)), J(JT.tns_decode, JCFG)(x, *args))
