"""MDCT / IMDCT of audio_codec_torch against audio_codec_tpu on the CPU.

The forward transform replays the reference's compensated CPU product, so
its spectra must be bit-identical. The inverse transform's 480x480 product
is accumulated in another order than XLA's, so its output is held to
float32 rounding: 2**-18 of the frame's peak (a few ulp of the largest
sample) plus 2**-16 absolute on the 16-bit scale.

XLA:CPU hands that product to YNNPACK, whose accumulation order depends on
the cores the process may use. In a process pinned to one core, with
XLA_FLAGS unset, the order is fixed, and the port's CPU product
(`ops/numerics.py:dot`) reproduces it bit for bit; `run_pinned` computes
such a reference."""
from __future__ import annotations

import os
import subprocess
import sys
import tempfile
from pathlib import Path

import numpy as np
import pytest
import torch

from audio_codec_torch import tables as PTab
from audio_codec_torch.ops import numerics as nm

from audio_codec_torch.ops import transforms as PT
from audio_codec_tpu.ops import transforms as JT

import audio_codec_torch as P
from audio_codec_tpu.config import Config as JConfig

from tests import torch_kernel_cases as C
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


ROOT = Path(__file__).resolve().parent.parent
PINNED = """
import os, sys
os.sched_setaffinity(0, {0})
import numpy as np
import jax
jax.config.update("jax_platforms", "cpu")
import jax.numpy as jnp
args = dict(np.load(sys.argv[1]))
%s
np.save(sys.argv[2], np.asarray(out))
"""


def run_pinned(body: str, timeout: int = 900, **arrays) -> np.ndarray:
    """Run `body` (JAX code that reads `args` and sets `out`) in a new
    Python process pinned to one CPU core, with XLA_FLAGS unset."""
    env = {k: v for k, v in os.environ.items() if k != "XLA_FLAGS"}
    env["JAX_PLATFORMS"] = "cpu"
    env["PYTHONPATH"] = os.pathsep.join([str(ROOT)] + [p for p in [env.get("PYTHONPATH")] if p])
    with tempfile.TemporaryDirectory() as d:
        np.savez(os.path.join(d, "in.npz"), **arrays)
        r = subprocess.run([sys.executable, "-c", PINNED % body, os.path.join(d, "in.npz"),
                            os.path.join(d, "out.npy")], cwd=ROOT, env=env,
                           capture_output=True, text=True, timeout=timeout)
        assert r.returncode == 0, r.stderr[-4000:]
        return np.load(os.path.join(d, "out.npy"))


IMDCT_DOT = """
from audio_codec_tpu import tables as T
M = jnp.asarray(T.dct4_matrix(480), jnp.float32)
out = jax.jit(lambda y: jnp.dot(y, M.T, preferred_element_type=jnp.float32))(args["y"])
"""


@pytest.mark.parametrize("scale", [1.0, 1e-3, 3e4])
def test_imdct_dot_bit_exact_to_pinned_reference(scale):
    """The IMDCT's [2, 480] x [480, 480] product (transforms.py:107) against
    the reference computed on one core."""
    rng = np.random.default_rng(3)
    y = (rng.standard_normal((2, 480)) * scale).astype(np.float32)
    ref = run_pinned(IMDCT_DOT, y=y)
    got = nm.dot(torch.from_numpy(y), nm.const(PTab.dct4_matrix(480).T, "cpu"))
    np.testing.assert_array_equal(got.numpy().view(np.int32), ref.view(np.int32))


@pytest.mark.parametrize("fs,bitrate", [(48000, 64000), (16000, 32000)])
def test_mdct_bit_exact_on_synthetic_rows(fs, bitrate):
    """Full-scale, silent and alternating-sign rows at N = 480 and 160,
    four streams a call."""
    jcfg, pcfg = JConfig(fs_in=fs, bitrate=bitrate), P.Config(fs_in=fs, bitrate=bitrate)
    x, mem = C.transform_rows(pcfg.frame_length, pcfg.la_zeroes, seed=2)
    for lo in range(0, x.shape[0], 4):
        xs, ms = x[lo: lo + 4], mem[lo: lo + 4]
        ref_d, ref_mem = J(JT.mdct, jcfg)(xs, ms)
        d, new_mem = PT.mdct(pcfg, t(xs), t(ms))
        np.testing.assert_array_equal(n(d).view(np.int32), np.asarray(ref_d).view(np.int32))
        np.testing.assert_array_equal(n(new_mem), np.asarray(ref_mem))


@pytest.mark.parametrize("fs,bitrate", [(48000, 64000), (16000, 32000)])
def test_compensated_mdct_on_the_card_path_bit_exact(monkeypatch, fs, bitrate):
    """The TDAC's MDCT in the compensated order that the card takes
    (`mdct_plain(compensated=True)` with `numerics.on_cpu` false, so every
    fused multiply-add is `xla_fma` as on a card), run on CPU tensors,
    against the reference's CPU transform: the synthetic rows, negative
    zeros and rows near 1e37 (whose split overflows to NaN in both) at
    N = 480 and 160, four streams a call. (XLA:CPU flushes subnormal inputs
    to zero, so the subnormal-scale rows are left to the card's tests.)"""
    jcfg, pcfg = JConfig(fs_in=fs, bitrate=bitrate), P.Config(fs_in=fs, bitrate=bitrate)
    x, mem = C.transform_rows_jax_safe(pcfg.frame_length, pcfg.la_zeroes, seed=2)
    monkeypatch.setattr(nm, "on_cpu", lambda v: False)
    for lo in range(0, x.shape[0], 4):
        xs, ms = x[lo: lo + 4], mem[lo: lo + 4]
        ref_d, ref_mem = J(JT.mdct, jcfg)(xs, ms)
        d, new_mem = PT.mdct_plain(pcfg, t(xs), t(ms), compensated=True)
        np.testing.assert_array_equal(n(d).view(np.int32), np.asarray(ref_d).view(np.int32))
        np.testing.assert_array_equal(n(new_mem), np.asarray(ref_mem))


def test_compensated_mdct_on_the_card_path_bit_exact_on_a_tdac_input(monkeypatch):
    """As above on the TDAC's input (ops/plc_adv.py:tdac): the synthesized
    extension's next frame with its zero tail, and the frame's tail as the
    memory."""
    fl, la = PCFG.frame_length, PCFG.la_zeroes
    rng = np.random.default_rng(7)
    synth = (rng.standard_normal((4, 2 * fl - la)) * 3000.0).astype(np.float32)
    synth[1] *= np.float32(1e-3)
    mem_t = np.ascontiguousarray(synth[:, la:fl])
    x_next = np.concatenate([synth[:, fl: 2 * fl - la], np.zeros((4, la), np.float32)], 1)
    ref_d, _ = J(JT.mdct, JCFG)(x_next, mem_t)
    monkeypatch.setattr(nm, "on_cpu", lambda v: False)
    d, _ = PT.mdct_plain(PCFG, t(x_next), t(mem_t), compensated=True)
    np.testing.assert_array_equal(n(d).view(np.int32), np.asarray(ref_d).view(np.int32))
