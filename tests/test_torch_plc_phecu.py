"""Phase ECU (advanced concealment, method 2) of audio_codec_torch against
audio_codec_tpu, and the advanced-concealment decode chain at plc_mode 1.

Where no FFT and no sine enters, outputs are held to bit equality
(trans_burst_ana). The FFTs (torch.fft against jnp.fft) differ: on the rows
here the windowed rFFT differs by at most 7.3e-8 of the spectrum's peak
magnitude (0.07 on 9.5e5), and seeded [4, 768] rows at +-3000 differed by
1.6e-7 (0.035 on 2.2e5). So the spectra are held to 2^-20 (9.5e-7) of their peak, the band
energies (squares of them) to 2^-18 of their peak, and the peak sets
exactly. `subst_spec` also takes sines and cosines of arbitrary phases, and
XLA:CPU's vectorised sin/cos are not correctly rounded (98.7 % of float32
arguments agree with the correctly rounded value, 95 % with PyTorch's): it
is held to 2^-16 of the spectrum's peak (1.2e-6 measured). The time signal
after the inverse FFT is held to 2^-16 of its peak. In the decode chain the
TD-PLC and noise-substitution lanes give equal int16 PCM; a Phase ECU lane's
PCM may differ by PHECU_PCM_TOL (the FFT's difference, seen as 1)."""
from __future__ import annotations

import os
import subprocess
import sys
import tempfile

import numpy as np
import pytest
import torch

import audio_codec_torch as P
from audio_codec_torch.models import state as PS
from audio_codec_torch.ops import plc_phecu as PH
from audio_codec_tpu.ops import plc_phecu as JPH

from tests import torch_kernel_cases as C
from tests.test_torch_transforms import PINNED, ROOT
from tests.torch_port_data import JCFG, PCFG, J, material, n, t

PHECU_PCM_TOL = 2
SPEC_TOL = 2.0 ** -20
ENERGY_TOL = 2.0 ** -18
SUBST_TOL = 2.0 ** -16


def close_to_peak(got, ref, tol, what):
    got, ref = n(got), np.asarray(ref)
    peak = float(np.abs(ref).max())
    err = float(np.abs(got - ref).max())
    assert err <= tol * peak, f"{what}: max |diff| {err} > {tol} x peak {peak}"


@pytest.mark.parametrize("seed", [0, 1])
def test_spec_ana(seed):
    """The windowed rFFT within SPEC_TOL, the peak set exactly, the
    fractional positions within 2^-12 bins and the peak counts exactly."""
    x = C.phecu_history(seed)
    nc = np.array([0.9, 0.8, 0.3, 0.6], np.float32)
    X, f0, npl = J(JPH.spec_ana, JCFG)(x[:, -C.PHECU_LPROT:], nc)
    gX, gf0, gnpl = PH.spec_ana(PCFG, t(x[:, -C.PHECU_LPROT:]), t(nc))
    close_to_peak(gX, X, SPEC_TOL, "X")
    f0 = np.asarray(f0)
    np.testing.assert_array_equal(n(gf0) >= 0, f0 >= 0)
    peaks = f0 >= 0
    assert peaks.any()
    np.testing.assert_allclose(n(gf0)[peaks], f0[peaks], rtol=0, atol=2.0 ** -12)
    np.testing.assert_array_equal(n(gnpl), np.asarray(npl))


@pytest.mark.parametrize("seed", [0, 1])
def test_band_energies(seed):
    x = C.phecu_history(seed)
    eo, e = J(JPH.band_energies, JCFG)(x)
    geo, ge = PH.band_energies(PCFG, t(x))
    close_to_peak(geo, eo, ENERGY_TOL, "e_oold")
    close_to_peak(ge, e, ENERGY_TOL, "e_old")


def _burst_inputs(seed: int):
    rng = np.random.default_rng(500 + seed)
    x = C.phecu_history(seed)
    eo, e = (np.asarray(v) for v in J(JPH.band_energies, JCFG)(x))
    burst = np.array([1, 2, 3, 6], np.int32)
    mc1 = (rng.random((4, 9)) * 1.2).astype(np.float32)
    beta_mute = rng.random(4).astype(np.float32)
    return x, eo, e, burst, mc1, beta_mute


@pytest.mark.parametrize("seed", [0, 1])
def test_trans_burst_ana(seed):
    """No FFT in it: bit equality, on the first loss and bursts of 2, 3, 6."""
    _, eo, e, burst, mc1, bm = _burst_inputs(seed)
    ref = J(JPH.trans_burst_ana, JCFG)(eo, e, burst, mc1, bm)
    got = PH.trans_burst_ana(PCFG, t(eo), t(e), t(burst), t(mc1), t(bm))
    for k, (g, r) in enumerate(zip(got, ref)):
        r = np.asarray(r)
        if r.dtype == np.float32:
            np.testing.assert_array_equal(n(g).view(np.int32), r.view(np.int32), err_msg=str(k))
        else:
            np.testing.assert_array_equal(n(g), r, err_msg=str(k))


@pytest.mark.parametrize("seed", [0, 1])
def test_subst_spec_and_rec_frame(seed):
    """The same X and f0est on both sides; lanes with many peaks, none and
    two (the isolated-peak rule), in first-loss and burst frames."""
    x, eo, e, burst, mc1, bm = _burst_inputs(seed)
    nc = np.array([0.9, 0.8, 0.3, 0.6], np.float32)
    X, f0, npl = (np.asarray(v) for v in J(JPH.spec_ana, JCFG)(x[:, -C.PHECU_LPROT:], nc))
    npl = npl.copy()
    npl[2] = 0
    mc, al, be, xa, _, tr = (np.asarray(v) for v in J(JPH.trans_burst_ana, JCFG)(eo, e, burst, mc1, bm))
    toffs = ((burst - 1) * PCFG.frame_length).astype(np.int32)
    args = (X, f0, npl, toffs, mc, al, be, xa, tr)
    ref = np.asarray(J(JPH.subst_spec, JCFG)(*args))
    got = PH.subst_spec(PCFG, *map(t, args))
    close_to_peak(got, ref, SUBST_TOL, "Xev")
    rec = np.asarray(J(JPH.rec_frame, JCFG)(ref, x))
    close_to_peak(PH.rec_frame(PCFG, t(ref), t(x)), rec, SUBST_TOL, "synth")


# ---------------------------------------------------------------------------
# the decode chain at plc_mode 1
# ---------------------------------------------------------------------------

JAX_DECODE = """
import dataclasses
from audio_codec_tpu.config import Config
from audio_codec_tpu.models import decoder as JD, state as JS
cfg = Config(fs_in=48000, bitrate=64000, plc_mode=1)
f, b = args["frames"], args["bfi"]
st, pcm = jax.jit(lambda s, f, b: JD.decode_block(cfg, s, f, b))(
    JS.dec_state_init(cfg, f.shape[1]), jnp.asarray(f.astype(np.int32)), jnp.asarray(b))
out = dict(pcm=np.asarray(JD.round_pcm(pcm)),
           **{"st_" + k.name: np.asarray(getattr(st, k.name)) for k in dataclasses.fields(st)})
"""


def run_pinned_dict(body: str, timeout: int = 900, **arrays) -> dict:
    """Like test_torch_transforms.run_pinned, for a body that sets `out` to
    a dict of arrays."""
    env = {k: v for k, v in os.environ.items() if k != "XLA_FLAGS"}
    env["JAX_PLATFORMS"] = "cpu"
    env["PYTHONPATH"] = os.pathsep.join([str(ROOT)] + [p for p in [env.get("PYTHONPATH")] if p])
    script = PINNED.replace("np.save(sys.argv[2], np.asarray(out))", "np.savez(sys.argv[2], **out)")
    with tempfile.TemporaryDirectory() as d:
        np.savez(os.path.join(d, "in.npz"), **arrays)
        r = subprocess.run([sys.executable, "-c", script % body, os.path.join(d, "in.npz"),
                            os.path.join(d, "out.npz")], cwd=ROOT, env=env,
                           capture_output=True, text=True, timeout=timeout)
        assert r.returncode == 0, r.stderr[-4000:]
        with np.load(os.path.join(d, "out.npz")) as z:
            return {k: z[k] for k in z.files}


def chain_pcm(T: int) -> np.ndarray:
    """[T, 4, 480]: speech, music, seeded noise and two tones."""
    n_ = PCFG.frame_length
    rng = np.random.default_rng(0)
    tt = np.arange(T * n_)
    cols = [material("speech")[96000: 96000 + T * n_], material("music")[96000: 96000 + T * n_],
            rng.standard_normal(T * n_) * 3000.0,
            4000 * np.sin(2 * np.pi * 1500.5 * tt / 48000) + 3000 * np.sin(2 * np.pi * 4200 * tt / 48000)]
    return np.stack([c.reshape(T, n_) for c in cols], axis=1).astype(np.float32)


# bfi per frame (all four streams): clean frames fill the PCM history, then
# bursts of 1, 2 and 8 lost frames and a redundancy frame (bfi_ext 3)
LOSS_PLANS = {6: [0, 0, 0, 1, 1, 3],
              18: [0, 0, 0, 0, 1, 0, 1, 1, 3, 0] + [1] * 8}


@pytest.mark.parametrize("T", [6, pytest.param(18, marks=pytest.mark.slow)])
def test_decode_chain_plc_mode1(T):
    """decode_block at plc_mode 1, the port on the CPU against the
    reference pinned to one core, on the port's own payloads: int16 PCM
    equal on the TD-PLC and noise-substitution lanes and within
    PHECU_PCM_TOL on Phase ECU lanes; the method of each burst, the
    counters, seeds and TD-PLC state equal; the Phase ECU fields within
    the spectra's tolerance."""
    cfg = P.Config(fs_in=48000, bitrate=64000, plc_mode=1)
    pcm = chain_pcm(T)
    _, frames = P.encode_block(cfg, P.enc_state_init(cfg, 4, device="cpu"), torch.from_numpy(pcm))
    frames = frames.numpy()
    bfi = np.repeat(np.asarray(LOSS_PLANS[T], np.int32)[:, None], 4, axis=1)
    ref = run_pinned_dict(JAX_DECODE, frames=frames, bfi=bfi)
    st, out = P.decode_block(cfg, P.dec_state_init(cfg, 4, device="cpu"),
                             torch.from_numpy(frames), torch.from_numpy(bfi))
    got = P.round_pcm(out).numpy().astype(np.int32)
    meth = ref["st_plc_meth"]
    assert {2, 3, 4} <= set(meth.tolist()), meth
    np.testing.assert_array_equal(PS.dec_state_to_numpy(st)["plc_meth"], meth)
    ph = meth == 2
    gap = np.abs(got - ref["pcm"].astype(np.int32))
    assert not gap[:, ~ph].any(), f"PCM differs on TD-PLC/NS lanes: {gap[:, ~ph].max()}"
    assert gap[:, ph].max(initial=0) <= PHECU_PCM_TOL
    state = PS.dec_state_to_numpy(st)
    for k, v in state.items():
        r = ref["st_" + k]
        assert v.shape == r.shape and v.dtype == r.dtype, k
        if k.startswith("phecu_") or k in ("imdct_mem", "ltpf_mem_x", "ltpf_mem_y",
                                          "plc_x_old_tot", "plc_q_d_prev", "pc_q_old_res"):
            lanes = ~ph if not k.startswith("phecu_") else np.ones_like(ph)
            if k.startswith("phecu_") and v.ndim == 2:
                close_to_peak(v[ph], r[ph], SUBST_TOL, k)
            elif v.ndim == 2:
                np.testing.assert_array_equal(v[lanes], r[lanes], err_msg=k)
            continue
        np.testing.assert_array_equal(v, r, err_msg=k)
