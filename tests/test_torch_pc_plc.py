"""Partial concealment and standard PLC of audio_codec_torch against
audio_codec_tpu, on good, lost (bfi 1) and partially lost (bfi 2) lanes.
Flags, counters and seeds must be equal; float outputs are held to 2**-20
relative plus 2**-20 of their peak (their sums may run in another order)."""
from __future__ import annotations

import numpy as np
import pytest

from audio_codec_torch.ops import pc as PP, plc as PLC
from audio_codec_tpu.ops import pc as JP, plc as JPLC

from tests import torch_kernel_cases as C
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
    eq(PP.classify_given_stab(PCFG, *map(t, cargs)), bfi)
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


@pytest.mark.parametrize("seed", [0, 1])
def test_peak_detector_and_classifier_every_branch(seed):
    """The rows of tests/torch_kernel_cases.py:pc_rows (a dominant peak, a
    peak in the first block, a flat-topped peak, the hysteresis at 0.5 and
    0.28 of the maximum) with bfi 2 swept across the low region, both
    pitch flags and both sides of the stability limit, eight streams a
    call."""
    d, r = C.pc_base_rows(4, seed=seed)
    a = C.pc_rows(d, r, seed=seed)
    rows = np.arange(0, a["bfi"].shape[0], 9)      # each base row once for the detector
    sig = a["q_old_d"][rows]
    for lo in range(0, sig.shape[0], 8):
        eq(PP._peak_detector(t(sig[lo: lo + 8])), J(JP._peak_detector)(sig[lo: lo + 8]))
    outs = []
    for lo in range(0, a["bfi"].shape[0], 8):
        args = [a[k][lo: lo + 8] for k in C.PC_ORDER]
        ref = J(JP.pc_classify, JCFG)(*args)
        got = PP.classify_given_stab(PCFG, *map(t, args))
        eq(got, ref)
        outs.append(n(got))
    branches = C.pc_branches(a, np.concatenate(outs))
    assert all(v > 0 for v in branches.values()), branches


@pytest.mark.parametrize("seed", [0, 1])
def test_fused_stability_and_classifier_match_jax(seed):
    """ops/pc.py:pc_classify (the stability factor and the classifier in one
    call, as the decoder makes it) against the reference's compute_stab_fac
    followed by pc_classify, on rows that take every branch of both
    (tests/torch_kernel_cases.py:pc_fused_rows): equal flags; the factors
    within this file's float tolerance, as compute_stab_fac's above (the CPU
    branch sums the 16 squares with torch.sum, whose order differs from
    XLA's in the last place on about a tenth of the streams)."""
    d, r = C.pc_base_rows(4, seed=seed)
    a = C.pc_fused_rows(d, r, seed=seed)
    stab = np.asarray(J(JP.compute_stab_fac)(*(a[k] for k in (
        "scf_q", "old_scf", "old_old_scf", "bfi", "prev_bfi", "prev_prev_bfi"))))
    bfi = np.asarray(J(JP.pc_classify, JCFG)(*(a[k] if k != "stab_fac" else stab for k in (
        "bfi", "spec_inv_idx", "stab_fac", "pitch_present", "q_old_d", "q_old_res"))))
    got_bfi, got_stab = PP.pc_classify(PCFG, *(t(a[k]) for k in C.PC_FUSED_ORDER))
    eq(got_bfi, bfi)
    close(got_stab, stab)
    branches = C.pc_fused_branches(a, bfi, stab)
    assert all(v > 0 for v in branches.values()), branches


def test_decode_synthesis_without_the_classifier_where_is_unchanged(monkeypatch):
    """The decoder once wrapped the classifier in torch.where(bfi != 1, ...,
    bfi); the classifier returns bfi wherever it is not 2, so the where
    changed nothing. Four frames of 8 streams, with lost, partially corrupt
    and redundancy frames, decode to the same PCM, flags and state with the
    where put back."""
    import torch
    import audio_codec_torch as P
    from audio_codec_torch.models import decoder as D
    B, T = 8, 4
    rng = np.random.default_rng(3)
    pcm = (rng.standard_normal((T, B, PCFG.frame_length)) * 3000.0).astype(np.float32)
    _, frames = P.encode_block(PCFG, P.enc_state_init(PCFG, B, device="cpu"),
                               torch.from_numpy(pcm))
    bfi_ext = np.array([[0] * 8, [2, 1, 0, 3, 2, 2, 0, 1], [2, 2, 1, 0, 3, 2, 2, 0],
                        [0, 2, 2, 1, 2, 3, 0, 2]], np.int32)

    def run():
        st, outs = P.dec_state_init(PCFG, B, device="cpu"), []
        for f in range(T):
            st, y, aux = D.decode_frame(PCFG, st, frames[f], torch.from_numpy(bfi_ext[f]))
            outs.append((y, aux["bfi"], aux["spec"]))
        return outs, st

    ref, st_ref = run()
    fused = PP.pc_classify

    def with_where(cfg, bfi, *args):
        out, stab = fused(cfg, bfi, *args)
        return torch.where(bfi != 1, out, bfi), stab
    monkeypatch.setattr(PP, "pc_classify", with_where)
    got, st_got = run()
    assert C.count_differing(got, ref) == 0
    assert C.count_differing(list(vars(st_got).values()), list(vars(st_ref).values())) == 0
    assert (np.concatenate([n(o[1]) for o in ref]) == 2).any()
