"""Range coder and side information of audio_codec_torch against
audio_codec_tpu. encode (the ari_encode kernel on the card, its plain
version here) must give identical bytes; decode (ari_decode) must give
every output of the reference exactly, on clean and on damaged frames, and
with a partial-concealment block (EP3/EP4) on bfi 0 and bfi 2 frames and in
the encoder's simulation (pc_enc_sim's b_left)."""
from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import audio_codec_torch as P
from audio_codec_torch.ops import ari as PAR, bits as PB
from audio_codec_tpu.config import Config as JConfig
from audio_codec_tpu.ops import ari as JAR, bits as JB, quant as JQ

from tests import torch_kernel_cases as C
from tests.torch_port_data import J, encoder_stages, n, t


def eq(got, ref, msg=""):
    np.testing.assert_array_equal(n(got), np.asarray(ref), err_msg=msg)


@functools.cache
def coder_inputs(frame: int, bitrate: int):
    """All inputs of ari.encode, made by the reference stages from the
    encoder's spectrum (and, at 160 kbps, in LSB mode)."""
    cfg = JConfig(fs_in=48000, bitrate=bitrate)
    r = encoder_stages()[frame]
    B = r["dy"].shape[0]
    s = r["state"]
    target = r["target"] + (cfg.targetBitsInit - JConfig(fs_in=48000, bitrate=64000).targetBitsInit)
    gain = np.asarray(J(JQ.estimate_global_gain, cfg)(
        r["dy"], target, s["targetBitsOff"], s["mem_targetBits"], s["mem_specBits"])[0])
    xq = np.asarray(J(JQ.quantize_spectrum, cfg)(r["dy"], gain))
    est = jax.jit(lambda q, tg: JQ.bit_estimate(cfg, q, tg, cfg.modeFlag))(xq, target)
    xq = np.asarray(JQ.truncate_spectrum(xq, est["lastnz"], est["lastnz2"]))
    res_bits, n_res = J(JQ.residual_encode, cfg)(r["dy"], xq, gain, target, est["nbits2"])
    n_res = jnp.where(est["lsbMode"] == 0, n_res, 0)
    fac = np.full((B,), 3, np.int32)
    ltpf = np.array([[1, 1, 100], [0, 0, 0], [1, 0, 37], [1, 1, 400]], np.int32)[:B]
    side = J(JB.pack_side_info, cfg)(
        jnp.zeros((B, cfg.targetBytes), jnp.int32), r["bw_idx"], est["lastnz2"],
        est["lsbMode"], np.full((B,), 170, np.int32), r["num_tns"], r["tns_order"],
        ltpf, r["scf_idx"], fac)
    args = (side[0], side[1], side[2], xq, r["tns_order"], r["tns_idx"], r["num_tns"],
            est["lastnz2"], est["lsbMode"], res_bits, n_res)
    return cfg, P.Config(fs_in=48000, bitrate=bitrate), tuple(np.asarray(a) for a in args), \
        (r["bw_idx"], est["lastnz2"], est["lsbMode"], r["num_tns"], r["tns_order"], ltpf,
         r["scf_idx"], fac)


@pytest.mark.parametrize("frame", [0, 1])
@pytest.mark.parametrize("bitrate", [64000, 160000])
def test_pack_side_info_and_encode_bytes_exact(frame, bitrate):
    jcfg, pcfg, args, side_args = coder_inputs(frame, bitrate)
    B = args[0].shape[0]
    got = PB.pack_side_info(pcfg, t(side_args[0]), t(side_args[1]), t(side_args[2]),
                            t(np.full((B,), 170, np.int32)), *map(t, side_args[3:]))
    for g, e in zip(got, args[:3]):
        eq(g, e)
    ref = np.asarray(J(JAR.encode, jcfg)(*args))
    eq(PAR.encode(pcfg, *map(t, args)), ref)


@functools.cache
def jax_decode(cfg, frames_bytes: bytes, shape):
    buf = np.frombuffer(frames_bytes, np.int32).reshape(shape)
    side = J(JB.parse_side_info, cfg)(buf)
    return side, jax.jit(lambda b, s: JAR.decode(cfg, b, s))(buf, side)


@pytest.mark.parametrize("bitrate", [64000, 160000])
@pytest.mark.parametrize("damage", ["clean", "flipped", "random"])
def test_side_parse_and_decode_exact(bitrate, damage):
    jcfg, pcfg = coder_inputs(0, bitrate)[:2]
    bufs = np.concatenate([np.asarray(J(JAR.encode, jcfg)(*coder_inputs(f, bitrate)[2]))
                           for f in (0, 1)])
    rng = np.random.default_rng({"clean": 0, "flipped": 1, "random": 2}[damage])
    if damage == "flipped":
        pos = rng.integers(0, bufs.size, 12)
        bufs.reshape(-1)[pos] ^= 1 << rng.integers(0, 8, 12)
    elif damage == "random":
        bufs = rng.integers(0, 256, bufs.shape).astype(np.int32)
    bufs = bufs.astype(np.int32)
    side, dec = jax_decode(jcfg, bufs.tobytes(), bufs.shape)
    pside = PB.parse_side_info(pcfg, t(bufs))
    for k in side:
        eq(pside[k], side[k], k)
    got = PAR.decode(pcfg, t(bufs), {k: t(v) for k, v in side.items()})
    for k in dec:
        eq(got[k], dec[k], k)


# ---- frames with a partial-concealment block (EP3/EP4 in an 80-byte slot) ----

@functools.cache
def jax_b_left(epmode: int) -> tuple[np.ndarray, np.ndarray]:
    """The JAX engine's encoder-side simulation and block move on the core
    payloads: (b_left, reordered frames)."""
    from audio_codec_tpu import engine as JEng
    cfg = JConfig(fs_in=48000, bitrate=64000, epmode=epmode)
    logical = C.core_frames(epmode)
    b_left = np.asarray(JEng._b_left_step(cfg)(jnp.asarray(logical)))
    return b_left, np.stack([JEng._reorder_payload(row, int(b), cfg.n_pc)
                             for row, b in zip(logical, b_left)]).astype(np.int32)


@pytest.mark.parametrize("epmode", C.PC_EP_MODES)
def test_pc_enc_sim_b_left_exact(epmode):
    """pc_enc_sim's convergence byte, and the engine's block move as a gather."""
    from audio_codec_torch import engine
    pcfg = P.Config(fs_in=48000, bitrate=64000, epmode=epmode)
    b_left, reordered = jax_b_left(epmode)
    logical = t(C.core_frames(epmode))
    got = engine.b_left_step(pcfg, logical)
    eq(got, b_left)
    assert (b_left > 0).all() and (b_left <= pcfg.targetBytes).all()
    eq(engine.reorder_payload(logical, got, pcfg.n_pc), reordered)


@pytest.mark.parametrize("epmode", C.PC_EP_MODES)
def test_pc_decode_exact(epmode):
    """The range decoder with the relocated block, on bfi_in 0 and 2 over
    four corrupt ranges (the first byte of the block to its end, its second
    half, one byte, the first byte), and on random frames."""
    jcfg = JConfig(fs_in=48000, bitrate=64000, epmode=epmode)
    pcfg = P.Config(fs_in=48000, bitrate=64000, epmode=epmode)
    a = C.pc_decode_rows(epmode)
    frames = np.concatenate([jax_b_left(epmode)[1], a["frames"][2::3]])
    L = frames.shape[0]
    bfi_in = np.resize(a["bfi_in"], L)
    be_l, be_r = np.resize(a["be_l"], L), np.resize(a["be_r"], L)
    side = J(JB.parse_side_info, jcfg)(frames)
    ref = jax.jit(lambda b, s, i, l, r: JAR.decode(jcfg, b, s, i, l, r))(frames, side, bfi_in,
                                                                         be_l, be_r)
    got = PAR.decode(pcfg, t(frames), {k: t(v) for k, v in side.items()}, t(bfi_in), t(be_l),
                     t(be_r))
    for k in ref:
        eq(got[k], ref[k], k)
    bfi = np.asarray(ref["bfi"])
    assert (bfi == 2).any() and (bfi == 0).any(), np.bincount(bfi)
