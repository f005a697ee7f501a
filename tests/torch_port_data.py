"""Shared inputs of the parity tests between audio_codec_tpu (JAX, the
reference) and audio_codec_torch (the PyTorch port).

Inputs are made with numpy from a seed and from the material/ files, and
handed to both packages as numpy arrays. The stage tests take realistic
intermediate signals from the port's own encoder (encoder_stages), run the
reference stage jitted alone and the port's stage on the same arrays, and
compare the outputs.
"""
from __future__ import annotations

import dataclasses
import functools
import wave
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import torch

import audio_codec_torch as P
from audio_codec_tpu.config import Config as JConfig
from audio_codec_tpu.models import encoder as JE
from audio_codec_tpu.models import state as JS

from tests import torch_threads  # noqa: F401  (one torch thread a test process)

ROOT = Path(__file__).resolve().parent.parent
FLAGSHIP = dict(fs_in=48000, bitrate=64000)
JCFG = JConfig(**FLAGSHIP)
PCFG = P.Config(**FLAGSHIP)


@functools.cache
def material(name: str) -> np.ndarray:
    with wave.open(str(ROOT / "material" / f"{name}48.wav")) as w:
        return np.frombuffer(w.readframes(w.getnframes()), np.int16).astype(np.float32)


def pcm_block(T: int, B: int, seed: int = 0, offset: int = 48000) -> np.ndarray:
    """[T, B, 480]: stream 0 seeded noise, 1 speech, 2 music, 3 quiet noise."""
    n = JCFG.frame_length
    rng = np.random.default_rng(seed)
    pcm = np.zeros((T, B, n), np.float32)
    srcs = [None, material("speech"), material("music"), None]
    for b in range(B):
        src = srcs[b % 4]
        if src is None:
            pcm[:, b] = rng.standard_normal((T, n)) * (3000.0 if b % 4 == 0 else 30.0)
        else:
            pcm[:, b] = src[offset: offset + T * n].reshape(T, n)
    return pcm


def t(a) -> torch.Tensor:
    """numpy/JAX array -> CPU tensor (a copy)."""
    return torch.from_numpy(np.array(a))


def n(x) -> np.ndarray:
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def state_dict(st) -> dict[str, np.ndarray]:
    return {f.name: np.asarray(getattr(st, f.name)) for f in dataclasses.fields(st)}


@functools.cache
def _jit(fn, *static):
    return jax.jit(functools.partial(fn, *static))


def J(fn, *static):
    """fn jitted on the CPU with leading static arguments."""
    return _jit(fn, *static)


@functools.cache
def jax_encode(T: int, B: int, seed: int = 0):
    """Frames [T, B, nbytes] uint8 of the JAX encoder on pcm_block(T, B, seed)."""
    pcm = pcm_block(T, B, seed)

    def body(st, x):
        st, out, _ = JE.encode_frame(JCFG, st, x)
        return st, out
    _, frames = jax.jit(lambda st, p: jax.lax.scan(body, st, p))(
        JS.enc_state_init(JCFG, B), jnp.asarray(pcm))
    return np.asarray(frames)


@functools.cache
def encoder_stages(T: int = 2, B: int = 4):
    """Per frame, every intermediate of the port's encoder on
    pcm_block(T, B), as numpy arrays: realistic inputs for the stage tests,
    which run the reference stage (jitted alone) and the port's stage on
    them."""
    from audio_codec_torch.ops import analysis as A, sns as S, tns as TN, transforms as TR
    from audio_codec_torch.models import state as PS
    cfg = PCFG
    pcm = torch.from_numpy(pcm_block(T, B))
    st = P.enc_state_init(cfg, B, device="cpu")
    frames = []
    for f in range(T):
        r = dict(state=PS.enc_state_to_numpy(st), x=pcm[f])
        x = pcm[f]
        r["d"], _ = TR.mdct(cfg, x, st.mdct_mem)
        r["y12k8"] = A.resample_12k8(cfg, x, st.r12k8_mem_in, st.r12k8_mem_50,
                                     st.r12k8_mem_out)[0]
        r["olpa"] = A.olpa(cfg, r["y12k8"], st.olpa_mem_s12k8, st.olpa_mem_s6k4,
                           st.olpa_mem_pitch)
        r["ener"] = A.per_band_energy(cfg, r["d"])
        r["bw_idx"] = A.detect_cutoff_warped(cfg, r["ener"])
        r["scf"] = S.compute_scf(cfg, r["ener"], torch.zeros(B, dtype=torch.int32))
        r["scf_idx"], r["scf_q"] = S.quantize_scf_enc(cfg, r["scf"])
        r["gains"] = S.interpolate_scf(cfg, r["scf_q"], True)
        r["d_shaped"] = S.mdct_shaping(cfg, r["d"], r["gains"])
        d2, tns_order, tns_idx, num_tns, tns_bits = TN.tns_encode(cfg, r["d_shaped"],
                                                                  r["bw_idx"])
        r.update(d2=d2, tns_order=tns_order, tns_idx=tns_idx, num_tns=num_tns)
        ltpf_bits = torch.where(r["olpa"][1] > 0.6, 11, 1)
        r["target"] = (cfg.targetBitsInit - (tns_bits + ltpf_bits)).to(torch.int32)
        r["dy"] = d2[:, : cfg.yLen].contiguous()
        frames.append({k: (v.numpy() if isinstance(v, torch.Tensor) else
                           tuple(n(u) for u in v) if isinstance(v, tuple) else v)
                       for k, v in r.items()})
        st, _, _ = P.encode_frame(cfg, st, x)
    return frames


@functools.cache
def port_frames(T: int, B: int, seed: int = 0) -> np.ndarray:
    """Frames [T, B, nbytes] uint8 of the port's encoder on pcm_block."""
    st = P.enc_state_init(PCFG, B, device="cpu")
    _, frames = P.encode_block(PCFG, st, torch.from_numpy(pcm_block(T, B, seed)))
    return frames.numpy()
