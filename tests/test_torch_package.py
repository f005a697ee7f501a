"""audio_codec_torch stands alone: it imports neither JAX nor anything of
audio_codec_tpu, and its entry points run on a CUDA card unless the caller
asks for the CPU."""
from __future__ import annotations

import re
import subprocess
import sys
from pathlib import Path

import pytest
import torch

import audio_codec_torch as P
from audio_codec_torch.ops import ari, quant

PKG = Path(P.__file__).resolve().parent


def test_import_loads_no_jax_and_no_reference_package():
    code = ("import sys, audio_codec_torch, audio_codec_torch.kernels; "
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'flax', 'audio_codec_tpu')]; print(bad)")
    r = subprocess.run([sys.executable, "-c", code], cwd=PKG.parent,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr
    assert r.stdout.strip() == "[]"


def test_sources_import_no_jax_and_no_reference_package():
    pat = re.compile(r"^\s*(from|import)\s+(jax|jaxlib|flax|audio_codec_tpu)\b", re.M)
    files = sorted(PKG.rglob("*.py"))
    assert len(files) > 10
    hits = [str(f) for f in files if pat.search(f.read_text())]
    assert hits == []


def test_entry_points_raise_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is usable")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        P.enc_state_init(P.Config(fs_in=48000, bitrate=64000), 2)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        P.dec_state_init(P.Config(fs_in=48000, bitrate=64000), 2)


def test_kernel_wrappers_refuse_cpu_tensors():
    """The CUDA wrappers launch or raise; only the ops pick the plain version
    for CPU tensors."""
    from audio_codec_torch import kernels as K
    cfg = P.Config(fs_in=48000, bitrate=64000)
    xq = torch.zeros((2, cfg.yLen), dtype=torch.int32)
    with pytest.raises(ValueError, match="CUDA tensor"):
        K.bit_estimate(cfg, xq, torch.zeros(2, dtype=torch.int32), -1)
    assert quant.bit_estimate(cfg, xq, torch.full((2,), 100, dtype=torch.int32), -1)["nbits"].shape == (2,)


def test_kernel_build_directory_is_named_by_its_inputs():
    """Processes building the same sources with the same flags share one
    library directory; another compiler or other flags get another."""
    from audio_codec_torch import kernels as K
    key = K._build_key("/usr/local/cuda/bin/nvcc")
    assert key == K._build_key("/usr/local/cuda/bin/nvcc")
    assert re.fullmatch(r"[0-9a-f]{16}", key)
    assert key != K._build_key("/opt/cuda/bin/nvcc")


def test_unported_modes_raise():
    pc_cfg = P.Config(fs_in=48000, bitrate=128000, epmode=3)
    assert pc_cfg.n_pc > 0
    buf = torch.zeros((1, pc_cfg.targetBytes), dtype=torch.int32)
    with pytest.raises(NotImplementedError, match="Queue 1 item 10"):
        ari.decode(pc_cfg, buf, {})
    with pytest.raises(NotImplementedError, match="Queue 1 item 10"):
        P.dec_state_init(P.Config(fs_in=48000, bitrate=64000, plc_mode=1), 1, device="cpu")
