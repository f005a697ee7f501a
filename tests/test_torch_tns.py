"""Temporal noise shaping of audio_codec_torch against audio_codec_tpu.

Filter orders, coefficient indices, bit counts and the lattice-filtered
spectra must all be equal, bit for bit: the port's lattices contract each
product where XLA:CPU contracts it in the reference's scan body."""
from __future__ import annotations

import numpy as np
import pytest

import audio_codec_torch as P
from audio_codec_torch.ops import tns as PT
from audio_codec_tpu.config import Config as JConfig
from audio_codec_tpu.ops import tns as JT

from tests import torch_kernel_cases as C
from tests.torch_port_data import JCFG, PCFG, J, encoder_stages, n, t


def same_bits(got, ref):
    np.testing.assert_array_equal(n(got).view(np.int32), np.asarray(ref).view(np.int32))


def check_encode(jcfg, pcfg, x, bw_idx):
    ref = J(JT.tns_encode, jcfg)(x, bw_idx)
    got = PT.tns_encode(pcfg, t(x), t(bw_idx))
    same_bits(got[0], ref[0])
    for k in range(1, 5):
        np.testing.assert_array_equal(n(got[k]), np.asarray(ref[k]))
    return np.asarray(ref[1])


@pytest.mark.parametrize("frame", [0, 1])
@pytest.mark.parametrize("bitrate", [64000, 32000])
def test_tns_encode(frame, bitrate):
    jcfg, pcfg = JConfig(fs_in=48000, bitrate=bitrate), P.Config(fs_in=48000, bitrate=bitrate)
    r = encoder_stages()[frame]
    bw = np.array([4, 4, 3, 2], np.int32)[: r["d_shaped"].shape[0]]
    for bw_idx in (r["bw_idx"], bw):
        check_encode(jcfg, pcfg, r["d_shaped"], bw_idx)


@pytest.mark.parametrize("seed", [0, 1])
def test_tns_encode_high_orders(seed):
    """Seeded spectra with a rising, strongly correlated envelope, so that
    both filters run at orders up to 8."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((4, 480)) * np.linspace(1, 50, 480)[None]
    x *= 10 ** rng.uniform(-1, 3, (4, 1))
    x[:, 1:] += 0.9 * x[:, :-1]
    order = check_encode(JCFG, PCFG, x.astype(np.float32), np.array([4, 4, 3, 4], np.int32))
    assert order.max() >= 7 and (order[:, 1] > 0).any(), order


def random_filters(rng, B: int, order8: bool):
    """rc indices, orders (0-8, or all 8), filter counts and bandwidths."""
    order = (np.full((B, 2), 8) if order8 else rng.integers(0, 9, (B, 2))).astype(np.int32)
    return (rng.integers(2, 15, (B, 2, 8)).astype(np.int32), order,
            np.array([2, 1, 2, 2], np.int32)[:B], np.array([4, 4, 3, 4], np.int32)[:B])


@pytest.mark.parametrize("frame", [0, 1])
def test_tns_decode(frame):
    """On the encoder's own filters, and on seeded random ones (orders 0-8,
    one or two filters) so that every lattice branch runs."""
    r = encoder_stages()[frame]
    x = r["d2"][:, : PCFG.yLen]
    rand = random_filters(np.random.default_rng(10 + frame), x.shape[0], False)
    for args in ((r["tns_idx"], r["tns_order"], r["num_tns"], r["bw_idx"]), rand):
        same_bits(PT.tns_decode(PCFG, t(x), *map(t, args)), J(JT.tns_decode, JCFG)(x, *args))


@pytest.mark.parametrize("frame", [0, 1])
def test_tns_decode_all_order_8(frame):
    """Every stream's filters at order 8, so the taps of orders 6-8 always
    run; on the spectrum and on it scaled by 1000."""
    r = encoder_stages()[frame]
    x = r["d2"][:, : PCFG.yLen]
    args = random_filters(np.random.default_rng(20 + frame), x.shape[0], True)
    for xs in (x, (x * 1000).astype(np.float32)):
        same_bits(PT.tns_decode(PCFG, t(xs), *map(t, args)), J(JT.tns_decode, JCFG)(xs, *args))


@pytest.mark.parametrize("name", list(C.TNS_CONFIGS))
def test_tns_encode_synthetic_rows(name):
    """All-zero rows, rows with dead subdivisions, order 8 in both filters,
    and AR(1) rows whose prediction gains straddle 1.5 and 2.0: at 32 kbps
    (max_pg 2.0) the LPC weighting decides the coefficients of those in
    (1.5, 2.0). Four streams a call, as the other parity tests run."""
    kw = C.TNS_CONFIGS[name]
    jcfg, pcfg = JConfig(**kw), P.Config(**kw)
    x, bw = C.tns_rows(seed=1)
    x, bw = x[:56], bw[:56]
    for lo in range(0, x.shape[0], 4):
        check_encode(jcfg, pcfg, x[lo: lo + 4], bw[lo: lo + 4])
    gains = PT._analyze(pcfg, t(x), t(bw))[1].numpy()
    assert ((gains > 1.5) & (gains < 2.0)).sum() >= 4
