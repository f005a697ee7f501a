"""Partial concealment and standard PLC of audio_codec_torch against
audio_codec_tpu, on good, lost (bfi 1) and partially lost (bfi 2) lanes.
Flags, counters and seeds must be equal; float outputs are held to 2**-20
relative plus 2**-20 of their peak (their sums may run in another order)."""
from __future__ import annotations

import numpy as np
import pytest

from audio_codec_torch.ops import pc as PP, plc as PLC
from audio_codec_tpu.ops import pc as JP, plc as JPLC

from tests.torch_port_data import JCFG, PCFG, J, n, t

B = 8


def close(got, ref):
    ref = np.asarray(ref)
    atol = 2.0 ** -20 * float(np.abs(ref).max(initial=0.0))
    np.testing.assert_allclose(n(got), ref, rtol=2.0 ** -20, atol=atol)


def eq(got, ref):
    np.testing.assert_array_equal(n(got), np.asarray(ref))


def data(seed):
    rng = np.random.default_rng(seed)
    N = PCFG.yLen
    f = lambda *s, sc=1.0: (rng.standard_normal(s) * sc).astype(np.float32)
    spec = f(B, N, sc=300.0)
    spec[:, 100:] *= 0.01
    spec[3, 40] = 9000.0                           # one dominant peak
    return dict(
        scf=f(B, 16), old=f(B, 16), old_old=f(B, 16),
        bfi=np.array([0, 1, 2, 2, 0, 1, 2, 0], np.int32),
        prev=np.array([0, 0, 1, 0, 1, 1, 0, 2], np.int32),
        prev2=np.array([1, 0, 0, 1, 0, 1, 0, 0], np.int32),
        inv=np.array([400, 30, 20, 300, 5, 200, 120, 400], np.int32),
        pitch=np.array([0, 1, 1, 0, 1, 0, 0, 1], np.int32),
        q_d=spec, q_res=np.round(f(B, N, sc=4.0)), x=np.round(f(B, N, sc=4.0)),
        gg=rng.integers(100, 200, B).astype(np.int32), prev_gg=f(B, sc=3.0) ** 2 + 1,
        nb_lost=rng.integers(0, 4, B).astype(np.int32),
        rframe=np.array([0, 0, 1, 1, 0, 0, 0, 1], np.int32),
        bw=np.array([4, 3, 2, 4, 4, 1, 0, 4], np.int32),
        prev_bw=np.array([4, 4, 4, 3, 4, 1, 0, 4], np.int32),
        prev_fac=(rng.random(B) * 0.5).astype(np.float32),
        fac_ns=rng.integers(0, 8, B).astype(np.int32),
        cum=(rng.random(B) * 0.5 + 0.5).astype(np.float32),
        seed=rng.integers(-32768, 32768, B).astype(np.int32),
    )


@pytest.mark.parametrize("seed", [0, 1])
def test_partial_concealment(seed):
    d = data(seed)
    sargs = (d["scf"], d["old"], d["old_old"], d["bfi"], d["prev"], d["prev2"])
    stab = np.asarray(J(JP.compute_stab_fac)(*sargs))
    close(PP.compute_stab_fac(*map(t, sargs)), stab)
    eq(PP._peak_detector(t(d["q_d"])), J(JP._peak_detector)(d["q_d"]))
    cargs = (d["bfi"], d["inv"], stab, d["pitch"], d["q_d"], d["q_res"])
    bfi = np.asarray(J(JP.pc_classify, JCFG)(*cargs))
    eq(PP.pc_classify(PCFG, *map(t, cargs)), bfi)
    aargs = (bfi, d["x"], d["q_res"], d["q_d"], d["inv"], d["gg"], d["prev_gg"], d["nb_lost"])
    ref = J(JP.pc_apply, JCFG)(*aargs)
    got = PP.pc_apply(PCFG, *map(t, aargs))
    close(got[0], ref[0])
    close(got[1], ref[1])
    eq(got[2], ref[2])
    uargs = (bfi, d["rframe"], np.asarray(ref[0]), d["inv"], d["gg"], np.asarray(ref[1]),
             d["bw"], d["q_res"], d["prev_gg"], d["prev_bw"], d["prev_fac"], d["fac_ns"])
    uref = J(JP.pc_update, JCFG)(*uargs)
    ugot = PP.pc_update(PCFG, *map(t, uargs))
    for k, (g, e) in enumerate(zip(ugot, uref)):
        (eq if k in (2, 3) else close)(g, e)


@pytest.mark.parametrize("seed", [0, 1])
def test_plc_main_and_update(seed):
    d = data(seed)
    margs = (d["x"], d["q_d"], d["bfi"], d["nb_lost"], d["cum"], d["seed"])
    ref = J(JPLC.plc_main, JCFG)(*margs)
    got = PLC.plc_main(PCFG, *map(t, margs))
    for k, (g, e) in enumerate(zip(got, ref)):
        (eq if k in (2, 4) else close)(g, e)
    uargs = (d["bfi"], np.asarray(ref[2]), np.asarray(ref[3]), d["prev"], d["prev2"])
    for g, e in zip(PLC.plc_update(*map(t, uargs)), J(JPLC.plc_update)(*uargs)):
        eq(g, e)
