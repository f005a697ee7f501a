"""The standard concealment (plc_mode 0) of the port against the reference.

`ops/plc.py:plc_main_plain` (the plain version of the `plc_main` kernel:
the concealment with the update's counter rule fused after it) and
`plc_update` against the reference's `plc_main` followed by `plc_update`,
bit for bit, on rows at each damping branch, bfi 0, 1 and 2, and seeds at
the generator's edges (tests/torch_kernel_cases.py:plc_main_rows); and a
lossy `decode_block` chain at plc_mode 0, 4 streams x 12 frames with a
burst of 9 lost frames, a single loss and a redundancy frame, whose int16
PCM must equal the reference's decode_block (decoded in a process pinned to
one core, where its IMDCT product has a fixed order). The chain is
`-m slow`: the reference's decoder compiles on that one core, about 90 s on
an idle machine and 280 s beside a full test run."""
from __future__ import annotations

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import audio_codec_torch as P
from audio_codec_torch.ops import plc as PLC
from audio_codec_tpu.ops import plc as JPLC

from tests import torch_kernel_cases as C
from tests.test_torch_transforms import PINNED, ROOT
from tests.torch_port_data import JCFG, PCFG, J, n, port_frames, t

T, B = 12, 4


def same(got, ref):
    g, r = n(got), np.asarray(ref)
    assert g.dtype == r.dtype and g.shape == r.shape
    if g.dtype == np.float32:
        g, r = g.view(np.int32), r.view(np.int32)
    np.testing.assert_array_equal(g, r)


@pytest.mark.parametrize("seed", [0, 1])
def test_plc_main_plain_and_update_match_reference(seed):
    d = C.plc_main_rows(seed)
    args = [d[k] for k in C.PLC_MAIN_ORDER]
    branches = C.plc_main_branches(d["bfi"], d["nb_lost"])
    assert all(v > 0 for v in branches.values()), branches
    ref = J(JPLC.plc_main, JCFG)(*args)
    prev, prev2 = np.roll(d["bfi"], 1), np.roll(d["bfi"], 2)
    uref = J(JPLC.plc_update)(d["bfi"], ref[2], ref[3], prev, prev2)
    got = PLC.plc_main_plain(PCFG, *map(t, args))
    for g, r in zip(got, (ref[0], ref[1], uref[0], uref[1], ref[4])):
        same(g, r)
    for g, r in zip(PLC.plc_update(*map(t, (d["bfi"], np.asarray(ref[2]), np.asarray(ref[3]),
                                            prev, prev2))), uref):
        same(g, r)


def loss_plan() -> np.ndarray:
    """bfi [T, B]: stream 0 a burst of 9 from frame 2 (every damping
    factor), stream 1 one loss then a redundancy frame, stream 2 clean,
    stream 3 two losses."""
    bfi = np.zeros((T, B), np.int32)
    bfi[2:11, 0] = 1
    bfi[5, 1], bfi[6, 1] = 1, 3
    bfi[7:9, 3] = 1
    return bfi


JAX_LOSSY_DECODE = """
from audio_codec_tpu.config import Config
from audio_codec_tpu.models import decoder as JD
from audio_codec_tpu.models import state as JS
cfg = Config(fs_in=48000, bitrate=64000)
f = args["frames"].astype(np.int32)
dec = jax.jit(lambda st, f, b: JD.decode_block(cfg, st, f, b))
out = JD.round_pcm(dec(JS.dec_state_init(cfg, f.shape[1]), jnp.asarray(f),
                       jnp.asarray(args["bfi"]))[1])
"""


def start_pinned(tmp_path, body: str, **arrays) -> subprocess.Popen:
    """run_pinned's process (tests/test_torch_transforms.py), started in the
    background: the reference compiles on one core while the port works."""
    env = {k: v for k, v in os.environ.items() if k != "XLA_FLAGS"}
    env["JAX_PLATFORMS"] = "cpu"
    env["PYTHONPATH"] = os.pathsep.join([str(ROOT)] + [p for p in [env.get("PYTHONPATH")] if p])
    np.savez(tmp_path / "in.npz", **arrays)
    return subprocess.Popen([sys.executable, "-c", PINNED % body, str(tmp_path / "in.npz"),
                             str(tmp_path / "out.npy")], cwd=ROOT, env=env,
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)


@pytest.mark.slow
def test_lossy_decode_block_pcm_identical(tmp_path):
    frames, bfi = port_frames(T, B), loss_plan()
    proc = start_pinned(tmp_path, JAX_LOSSY_DECODE, frames=frames, bfi=bfi)
    try:
        st = P.dec_state_init(PCFG, B, device="cpu")
        _, pcm = P.decode_block(PCFG, st, torch.from_numpy(frames), torch.from_numpy(bfi))
        got = P.round_pcm(pcm).numpy()
        _, err = proc.communicate(timeout=900)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    assert proc.returncode == 0, err[-4000:]
    ref = np.load(tmp_path / "out.npy")
    assert got.shape == ref.shape == (T, B, PCFG.frame_length)
    mism = [(f, b, int((got[f, b] != ref[f, b]).sum())) for f in range(T) for b in range(B)
            if not np.array_equal(got[f, b], ref[f, b])]
    assert mism == [], f"(frame, stream, differing samples): {mism}"
    assert np.any(got[2:11, 0] != 0)


def test_plc_main_wrapper_refuses_cpu_tensors():
    """The kernel's wrapper launches or raises; plc_main_update picks the
    plain version for CPU tensors only."""
    from audio_codec_torch import kernels as K
    d = C.plc_main_rows(0)
    args = (PCFG, *(torch.from_numpy(d[k]) for k in C.PLC_MAIN_ORDER))
    with pytest.raises(ValueError, match="CUDA tensor"):
        K.plc_main(*args)
    for g, r in zip(PLC.plc_main_update(*args), PLC.plc_main_plain(*args)):
        same(g, n(r))
