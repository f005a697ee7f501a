"""Advanced concealment (plc_mode 1) of audio_codec_torch against
audio_codec_tpu: the method classifier, the TD-PLC LPC analysis and frame,
the TDAC blend, noise substitution, damping and sign scrambling, and the
numerics they rest on. Every output is held to bit equality: the port
follows XLA:CPU's order (its windowed reductions, its contractions and its
reciprocal square root) on every device."""
from __future__ import annotations

import numpy as np
import pytest
import torch

from audio_codec_torch.ops import numerics as nm, plc_adv as P
from audio_codec_tpu.ops import plc_adv as JP

from tests import torch_kernel_cases as C
from tests.test_torch_transforms import run_pinned
from tests.torch_port_data import JCFG, PCFG, J, n, t


def same_bits(got, ref, what=""):
    got, ref = n(got), np.asarray(ref)
    assert got.shape == ref.shape and got.dtype == ref.dtype, what
    if ref.dtype == np.float32:
        bad = got.view(np.int32) != ref.view(np.int32)
    else:
        bad = got != ref
    assert not bad.any(), f"{what}: {int(bad.sum())} of {bad.size} differ"


@pytest.mark.parametrize("size", [16, 240, 400, 480, 1095])
def test_xla_sum_and_rsqrt_match_xla(size):
    """numerics.xla_sum (XLA's windowed tree reduction), xla_dot_row (its
    fused chain up to 32 terms) and xla_rsqrt (the x86 estimate and two
    Newton steps) against jitted JAX."""
    import jax
    import jax.numpy as jnp
    rng = np.random.default_rng(size)
    x = (rng.standard_normal((16, size)) * 1000).astype(np.float32)
    same_bits(nm.xla_sum(t(x)), jax.jit(lambda a: jnp.sum(a, 1))(x), "sum")
    # up to 32 terms XLA fuses the products into the reduction's chain
    sq = nm.xla_dot_row(t(x), t(x)) if size <= 32 else nm.xla_sum(t(x) * t(x))
    same_bits(sq, jax.jit(lambda a: jnp.sum(a * a, 1))(x), "sum of squares")
    y = np.exp(rng.uniform(-30, 30, size)).astype(np.float32)
    same_bits(nm.xla_rsqrt(t(y)), jax.jit(jax.lax.rsqrt)(y), "rsqrt")


@pytest.mark.parametrize("group", sorted(C.TDC_LANES))
def test_classify(group):
    d = C.plc_adv_rows(group)
    args = (d["x_old_tot"], d["scf"], d["pitch"])
    meth, nc = J(JP.classify, JCFG)(*args)
    got_m, got_nc = P.classify(PCFG, *map(t, args))
    same_bits(got_m, meth, "method")
    same_bits(got_nc, nc, "norm_corr")
    assert set(np.asarray(meth).tolist()) == {2, 3, 4}


@pytest.mark.parametrize("group", sorted(C.TDC_LANES))
def test_tdc_lpc(group):
    q = C.plc_adv_rows(group)["q_d"]
    same_bits(P.tdc_lpc(PCFG, t(q)), J(JP.tdc_lpc, JCFG)(q), "a")


@pytest.mark.parametrize("group", sorted(C.TDC_LANES))
def test_tdc_apply(group):
    """First-loss, later-loss, fractional-pitch, stab_fac >= 1, past the
    fade-out and inactive lanes (C.plc_adv_rows): synth on the active lanes,
    every state output on all lanes."""
    d = C.plc_adv_rows(group)
    a = np.asarray(J(JP.tdc_lpc, JCFG)(d["q_d"]))
    args = (d["pitch_t"], d["fract"], a, d["x_old_tot"], d["nb"], d["stab"], d["seed"],
            d["gain_c"], d["alpha"], d["harm"], d["synth_hist"], d["harm_len"], d["active"])
    ref = J(JP.tdc_apply, JCFG)(*args)
    got = P.tdc_apply(PCFG, *map(t, args))
    act = d["active"]
    for k, v in ref.items():
        if k == "synth":
            same_bits(got[k][torch.from_numpy(act)], np.asarray(v)[act], k)
        else:
            same_bits(got[k], v, k)


def test_lcg16_matches_reference_scan():
    seed = np.array([-32768, -1, 0, 1, 24607, 32767], np.int32)
    vals, fin = JP._lcg16(seed, 790)
    got_v, got_f = P.lcg16(t(seed), 790)
    same_bits(got_v, vals, "values")
    same_bits(got_f, fin, "final seed")


TDAC = """
from audio_codec_tpu.config import Config
from audio_codec_tpu.ops import plc_adv as JP
cfg = Config(fs_in=48000, bitrate=64000, plc_mode=1)
out = jax.jit(lambda s: JP.tdac(cfg, s))(args["synth"])
"""


def test_tdac_bit_exact_to_pinned_reference():
    """The TDAC blend runs the MDCT and the IMDCT; the reference's IMDCT
    product has a fixed order in a process pinned to one core."""
    rng = np.random.default_rng(5)
    synth = (rng.standard_normal((4, 780)) * 3000).astype(np.float32)
    same_bits(P.tdac(PCFG, t(synth)), run_pinned(TDAC, synth=synth), "ola")


@pytest.mark.parametrize("group", sorted(C.DAMP_LANES))
def test_noise_substitution_and_damping(group):
    """bfi 1 and bfi 2 lanes, with and without pitch, spec_inv_idx 0 and
    above, scrambled and not, active and not."""
    d = C.damping_rows(group)
    args = (d["spec"], d["nb"], d["stab"], d["scramble"], d["cum_fflc"], d["cum_slow"],
            d["cum_fast"], d["pitch_present"], d["seed"], d["inv"], d["active"])

    def ref_fn(cfg, *a):
        return JP.damping_scrambling(cfg, *a[:3], scramble=a[3], cum_fflc=a[4], cum_slow=a[5],
                                     cum_fast=a[6], pitch_present=a[7], seed=a[8],
                                     spec_inv_idx=a[9], active=a[10])
    ref = J(ref_fn, JCFG)(*args)
    got = P.damping_scrambling(PCFG, *map(t, args))
    for k, (g, r) in enumerate(zip(got, ref)):
        same_bits(g, r, f"output {k}")
    same_bits(P.noise_substitution(t(d["spec"])), J(JP.noise_substitution)(d["spec"]), "ns")


def test_plc_tdc_plain_composes_the_reference():
    """The kernel's plain version: the method and norm_corr on first-loss
    lanes, the LPC and the TD-PLC frame as the reference decoder composes
    them (decoder.py:_plc_advanced), synth zero off the TD-PLC lanes."""
    d = C.plc_adv_rows(0)
    B = d["nb"].shape[0]
    lost = d["nb"] > 0
    meth_st = np.full(B, 4, np.int32)
    a_st = np.zeros((B, 17), np.float32)
    fract_st = np.zeros(B, np.int32)
    args = (lost, d["nb"], d["x_old_tot"], d["scf"], d["q_d"], d["pitch"], d["fract"],
            d["stab"], meth_st, a_st, d["seed"], d["gain_c"], d["alpha"], fract_st,
            d["harm"], d["harm_len"], d["synth_hist"])
    got = P.plc_tdc_plain(PCFG, *map(t, args))
    first = lost & (d["nb"] == 1)
    m_new, nc = (np.asarray(v) for v in J(JP.classify, JCFG)(d["x_old_tot"], d["scf"], d["pitch"]))
    meth = np.where(first, m_new, meth_st)
    same_bits(got["meth"], meth.astype(np.int32), "meth")
    same_bits(got["nc"], np.where(first, nc, 0.0).astype(np.float32), "nc")
    a = np.where(first[:, None], np.asarray(J(JP.tdc_lpc, JCFG)(d["q_d"])), a_st)
    same_bits(got["a"], a, "a")
    tdc_lane = lost & (meth == 3)
    assert tdc_lane.any() and (~tdc_lane).any()
    ref = J(JP.tdc_apply, JCFG)(d["pitch"], np.where(first, d["fract"], fract_st), a,
                               d["x_old_tot"], d["nb"], d["stab"], d["seed"], d["gain_c"],
                               d["alpha"], d["harm"], d["synth_hist"], d["harm_len"], tdc_lane)
    same_bits(got["synth"], np.where(tdc_lane[:, None], np.asarray(ref["synth"]), 0.0)
              .astype(np.float32), "synth")
    for k in ("seed", "gain_c", "alpha", "fract", "harmonic_buf", "harmonic_len", "synth_hist"):
        same_bits(got[k], ref[k], k)
