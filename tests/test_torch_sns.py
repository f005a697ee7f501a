"""Spectral noise shaping of audio_codec_torch against audio_codec_tpu.

Quantizer indices must be equal. Float outputs (scale factors, gains,
shaped spectra) are held to 2**-16 relative plus 2**-16 of the array's peak:
their products and logs follow XLA:CPU's order, but a few of its sums run
in another order."""
from __future__ import annotations

import numpy as np
import pytest

from audio_codec_torch.ops import sns as PS
from audio_codec_tpu.ops import sns as JS

from tests import torch_kernel_cases as C
from tests.torch_port_data import JCFG, PCFG, J, encoder_stages, n, t


def close(got, ref):
    ref = np.asarray(ref)
    tol = 2.0 ** -16 * float(np.abs(ref).max(initial=0.0))
    np.testing.assert_allclose(n(got), ref, rtol=2.0 ** -16, atol=tol)


@pytest.mark.parametrize("frame", [0, 1])
def test_compute_scf(frame):
    r = encoder_stages()[frame]
    att = np.zeros(r["ener"].shape[0], np.int32)
    close(PS.compute_scf(PCFG, t(r["ener"]), t(att)),
          J(JS.compute_scf, JCFG)(r["ener"], att))


@pytest.mark.parametrize("frame", [0, 1])
def test_quantize_scf_enc_dec(frame):
    r = encoder_stages()[frame]
    rng = np.random.default_rng(frame)
    scf = np.concatenate([r["scf"], (rng.standard_normal((12, 16)) * 2.5).astype(np.float32),
                          np.zeros((1, 16), np.float32)])
    ref_idx, ref_q = J(JS.quantize_scf_enc, JCFG)(scf)
    idx, q = PS.quantize_scf_enc(PCFG, t(scf))
    np.testing.assert_array_equal(n(idx), np.asarray(ref_idx))
    close(q, ref_q)
    close(PS.quantize_scf_dec(t(ref_idx)), jax_scf_dec(np.asarray(ref_idx)))


def jax_scf_dec(idx):
    return J(JS.quantize_scf_dec)(idx)


@pytest.mark.parametrize("submode", [0, 1, 2, 3])
def test_quantize_scf_dec_every_submode(submode):
    """Valid indices of one submode, its first and last MPVQ index among
    them: each decodes its own pulse shape."""
    idx = C.scf_idx_grid(submode, 24, seed=7)
    got = PS.quantize_scf_dec(t(idx))
    assert np.isfinite(n(got)).all()
    close(got, jax_scf_dec(idx))


@pytest.mark.parametrize("seed", [0, 1])
def test_quantize_scf_enc_synthetic_rows(seed):
    """Seeded rows at three spreads, an all-zero row, rows whose residual is
    silent (every pulse search takes its silent-target branch) and rows the
    decoder gives for each submode, so that all four are chosen."""
    scf = C.scf_rows(seed, 40)
    assert not scf[40].any()
    ref_idx, ref_q = J(JS.quantize_scf_enc, JCFG)(scf)
    idx, q = PS.quantize_scf_enc(PCFG, t(scf))
    np.testing.assert_array_equal(n(idx), np.asarray(ref_idx))
    close(q, ref_q)
    assert set(np.unique(n(idx)[:, 2])) == {0, 1, 2, 3}


@pytest.mark.parametrize("encoder_side", [True, False])
def test_interpolate_and_shaping(encoder_side):
    r = encoder_stages()[1]
    import jax
    g_ref = jax.jit(lambda s: JS.interpolate_scf(JCFG, s, encoder_side))(r["scf_q"])
    g = PS.interpolate_scf(PCFG, t(r["scf_q"]), encoder_side)
    close(g, g_ref)
    g_ref = np.asarray(g_ref)
    close(PS.mdct_shaping(PCFG, t(r["d"]), t(g_ref)), J(JS.mdct_shaping, JCFG)(r["d"], g_ref))
    y = r["d"][:, : PCFG.yLen]
    close(PS.mdct_shaping(PCFG, t(y), t(g_ref)), J(JS.mdct_shaping, JCFG)(y, g_ref))
