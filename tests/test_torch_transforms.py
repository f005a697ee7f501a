"""MDCT / IMDCT of audio_codec_torch against audio_codec_tpu on the CPU.

The forward transform replays the reference's compensated CPU product, so
its spectra must be bit-identical. The inverse transform's 480x480 product
is accumulated in another order than XLA's, so its output is held to
float32 rounding: 2**-18 of the frame's peak (a few ulp of the largest
sample) plus 2**-16 absolute on the 16-bit scale."""
from __future__ import annotations

import numpy as np
import pytest

from audio_codec_torch.ops import transforms as PT
from audio_codec_tpu.ops import transforms as JT

from tests.torch_port_data import JCFG, PCFG, J, encoder_stages, n, t


@pytest.mark.parametrize("frame", [0, 1])
def test_mdct_bit_exact(frame):
    r = encoder_stages()[frame]
    ref_d, ref_mem = J(JT.mdct, JCFG)(r["x"], r["state"]["mdct_mem"])
    d, mem = PT.mdct(PCFG, t(r["x"]), t(r["state"]["mdct_mem"]))
    np.testing.assert_array_equal(n(d), np.asarray(ref_d))
    np.testing.assert_array_equal(n(mem), np.asarray(ref_mem))


@pytest.mark.parametrize("frame", [0, 1])
def test_imdct_within_float32_rounding(frame):
    r = encoder_stages()[frame]
    y = r["d"] / 64.0
    mem = r["x"][:, PCFG.la_zeroes:] / 7.0
    ref_x, ref_mem = (np.asarray(v) for v in J(JT.imdct, JCFG)(y, mem))
    x, new_mem = PT.imdct(PCFG, t(y), t(mem))
    tol = float(np.abs(ref_x).max()) * 2.0 ** -18 + 2.0 ** -16
    np.testing.assert_allclose(n(x), ref_x, rtol=0, atol=tol)
    np.testing.assert_allclose(n(new_mem), ref_mem, rtol=0, atol=tol)
