"""The port's bit-exact fixed-point decoder (audio_codec_torch.fixed_decoder_dev,
ops/fixed_dev.py, ops/fixed_ltpf_dev.py, ops/fixed_imdct.py,
ops/fixed_dec.py) on the CPU, which runs the plain versions of its four
kernels, against the reference: the BASOP primitives and every stage with a
kernel against the reference's host oracle (the numpy modules that
tests/test_fixed_dev.py ties to the reference's device decoder), and the
decoder against the reference's FixedDecoder (the MD5-gate decoder). The
arithmetic is integer: everything must be equal.

The reference's device decoder (audio_codec_tpu/fixed_decoder_dev.py) needs
jax_enable_x64, which is process-wide, so it runs in a subprocess, and only
under -m slow (its compile takes minutes); so do the other 10 ms rates."""
from __future__ import annotations

import functools
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest
import torch

import audio_codec_torch as P
from audio_codec_torch.fixed_decoder_dev import DeviceFixedDecoder, fixed_state_from_numpy
from audio_codec_torch.ops import ari, bits
from audio_codec_torch.ops import fixed_dec as pd
from audio_codec_torch.ops import fixed_dev as pv
from audio_codec_torch.ops import fixed_ltpf_dev as pl
from audio_codec_tpu import tables as JT
from audio_codec_tpu.config import Config as JConfig
from audio_codec_tpu.fixed_decoder import FixedDecoder
from audio_codec_tpu.ops import fixed_dec as fd
from audio_codec_tpu.ops import fixed_imdct as fi
from audio_codec_tpu.ops import fixed_ltpf as fl

from tests import torch_kernel_cases as C
from tests.torch_port_data import port_frames

ROOT = Path(__file__).resolve().parent.parent
CFG = P.Config(fs_in=48000, bitrate=64000)
JCFG = JConfig(fs_in=48000, bitrate=64000)
REF = ROOT / "audio_codec_torch" / "data" / "fixed_pcm_ref.npz"

EDGE = np.array([0, 1, -1, 2, -2, 3, 100, -100, (1 << 15) - 1, 1 << 15, -(1 << 15), -(1 << 15) - 1,
                 (1 << 16) + 5, (1 << 31) - 1, 1 << 31, -(1 << 31), -(1 << 31) - 1, 123456789,
                 -987654321], np.int64)
SHIFTS = np.arange(-40, 41, dtype=np.int64)


def same(got, ref):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    ref = np.asarray(ref)
    assert got.shape == ref.shape, (got.shape, ref.shape)
    bad = np.argwhere(got.astype(np.int64) != ref.astype(np.int64))
    assert len(bad) == 0, f"{len(bad)} values differ, first at {bad[0].tolist()}"


def test_int64_shifts_agree_with_numpy():
    """torch's int64 << and >> on the CPU against numpy's at counts 0..63
    (the ports clamp every count into this range); >> of a negative value
    is arithmetic."""
    s = np.arange(64, dtype=np.int64)
    X, S = np.meshgrid(EDGE, s, indexing="ij")
    same(torch.from_numpy(X) << torch.from_numpy(S), X << S)
    same(torch.from_numpy(X) >> torch.from_numpy(S), X >> S)
    assert int(torch.tensor(-5) >> 1) == -3


UNARY = ("sat32", "sat16", "norm_s", "norm_l", "round_fx")
BINARY = ("mpy_32_16", "mpy_32_32", "mult_r", "L_mult")


@pytest.mark.parametrize("name", UNARY)
def test_unary_primitives_match_reference(name):
    x = EDGE if name not in ("norm_s",) else np.clip(EDGE, -(1 << 15), (1 << 15) - 1)
    if name == "norm_l":
        x = np.clip(EDGE, -(1 << 31), (1 << 31) - 1)
    same(getattr(pd, name)(torch.from_numpy(x)), getattr(fd, name)(x))


@pytest.mark.parametrize("name", BINARY)
def test_binary_primitives_match_reference(name):
    w32 = np.clip(EDGE, -(1 << 31), (1 << 31) - 1)
    w16 = np.clip(EDGE, -(1 << 15), (1 << 15) - 1)
    b = w32 if name == "mpy_32_32" else w16
    a = w16 if name in ("mult_r", "L_mult") else w32
    A, Bm = np.meshgrid(a, b, indexing="ij")
    same(getattr(pd, name)(torch.from_numpy(A), torch.from_numpy(Bm)), getattr(fd, name)(A, Bm))


@pytest.mark.parametrize("name", ["mac_r", "msu_r"])
def test_mac_msu_match_reference(name):
    w32 = np.clip(EDGE, -(1 << 31), (1 << 31) - 1)
    w16 = np.clip(EDGE, -(1 << 15), (1 << 15) - 1)
    L, A, Bm = np.meshgrid(w32, w16, w16, indexing="ij")
    same(getattr(pd, name)(*(torch.from_numpy(v) for v in (L, A, Bm))), getattr(fd, name)(L, A, Bm))


def test_shifts_match_reference_at_counts_minus_40_to_40():
    w32 = np.clip(EDGE, -(1 << 31), (1 << 31) - 1)
    X, S = np.meshgrid(w32, SHIFTS, indexing="ij")
    same(pd.L_shl(torch.from_numpy(X), torch.from_numpy(S)), fd.L_shl(X, S))
    w16 = np.clip(EDGE, -(1 << 15), (1 << 15) - 1)
    ref = np.array([[fd.shl16(int(x), int(s)) for s in SHIFTS] for x in w16])
    X16, S16 = np.meshgrid(w16, SHIFTS, indexing="ij")
    same(pd.shl16(torch.from_numpy(X16), torch.from_numpy(S16)), ref)


def test_mpvq_offsets_match_reference():
    assert pd._MPVQ_OFFS == fd._MPVQ_OFFS


# ---- the stages against the reference's host oracle ----

@functools.cache
def stored() -> dict[str, np.ndarray]:
    with np.load(REF) as z:
        return {k: z[k] for k in z.files}


@functools.cache
def frontend(T: int = 8, B: int = 12):
    """The port's CPU frontend on the stored payloads (first T frames of B
    streams), flattened frame-major to T*B rows, as numpy."""
    fr = stored()["frames"][:T, :B]
    buf = torch.from_numpy(fr.reshape(T * B, -1).astype(np.int32))
    side = bits.parse_side_info(CFG, buf)
    dec = ari.decode(CFG, buf, side)
    return {k: v.numpy() for k, v in side.items()}, {k: v.numpy() for k, v in dec.items()}


@pytest.mark.parametrize("submode", [0, 1, 2, 3])
def test_sns_decode_matches_host_oracle(submode):
    """Every submode, both leading signs, and the out-of-range indices of
    the ber lanes (the port's plain version runs every submode's de-index
    and selects the lane's, as the reference's device port does)."""
    rows = C.fx_sns_rows()
    rows = rows[rows[:, 2] == submode]
    scf_q, ber = pv.sns_decode_scf(torch.from_numpy(rows))
    for r, q, b in zip(rows, scf_q.numpy(), ber.numpy()):
        ref_q, ref_b = fd.sns_decode_scf(r)
        same(q, ref_q)
        assert b == ref_b
    ok = ber.numpy() == 0
    scf, scf_e = pv.sns_decode_plain(torch.from_numpy(rows[ok]), CFG.bands_number)
    for q, s, e in zip(scf_q.numpy()[ok], scf.numpy(), scf_e.numpy()):
        ref_s, ref_e = fd.sns_interpolate(q, CFG.bands_number)
        same(s, ref_s)
        same(e, ref_e)


def host_chain(side, dec, f: int):
    """fixed_decoder.py:336-356 for frame row f: (shaped [N], x_e)."""
    scf_q, ber = fd.sns_decode_scf(side["scf_idx"][f])
    assert ber == 0
    x, x_e = fd.ari_scaling(dec["x"][f])
    x = fd.residual_decode(x, x_e, dec["res_bits"][f], int(dec["n_res"][f]))
    if not dec["zero_frame"][f]:
        x, _ = fd.noise_filling(x, int(dec["nf_seed"][f]), x_e, int(side["fac_ns_idx"][f]),
                                int(side["bw_idx"][f]), JCFG.frame_dms)
    x, x_e = fd.apply_global_gain(x, x_e, int(side["gg_idx"][f]), JCFG.quantizedGainOff)
    x, x_e = fd.tns_decode(dec["tns_idx"][f].reshape(16), x, x_e, dec["tns_order"][f],
                           int(side["bw_idx"][f]), JCFG.frame_dms)
    scf, scf_e = fd.sns_interpolate(scf_q, JCFG.bands_number)
    scf_e, x_e = fd.scf_scaling(scf_e, x_e)
    bo = np.asarray(JT.bands_offset(JCFG.fs_idx, JCFG.frame_dms, JCFG.hrmode))
    out = np.zeros(JCFG.frame_length, np.int64)
    out[: JCFG.yLen] = fd.mdct_shaping(x, scf, scf_e, bo)
    return out, x_e


def port_chain(side, dec):
    t = {k: torch.from_numpy(v) for k, v in {**side, **dec}.items()}
    scf, scf_e = pv.sns_decode_plain(t["scf_idx"], CFG.bands_number)
    return pv.spectrum_decode_plain(CFG, t["x"], t["res_bits"], t["n_res"], t["nf_seed"],
                                    t["zero_frame"], t["fac_ns_idx"], t["bw_idx"], t["gg_idx"],
                                    t["tns_idx"], t["tns_order"], scf, scf_e)


def test_spectral_chain_matches_host_oracle():
    """The SNS decode and the spectral chain (fx_sns_dec, fx_spec_decode)
    on the stored payloads' 96 frames: speech, music, noise, a pulse train
    and silence (zero frames), TNS on and off, every SNS submode."""
    side, dec = frontend()
    shaped, x_e = port_chain(side, dec)
    assert int(dec["zero_frame"].sum()) > 0 and int((dec["tns_order"] > 0).sum()) > 0
    for f in range(len(x_e)):
        ref, ref_e = host_chain(side, dec, f)
        same(shaped[f], ref)
        assert int(x_e[f]) == int(ref_e), f


def test_batch_dct4_matches_host_oracle():
    """fx_dct4's plain version on the chain's rows and on all-zero,
    +-(2^31 - 1), alternating and capped rows."""
    side, dec = frontend()
    shaped, x_e = port_chain(side, dec)
    y, y_e = C.fx_dct4_rows()
    rows = np.concatenate([shaped.numpy(), y])
    exps = np.concatenate([x_e.numpy(), y_e])
    got = pv.batch_dct4_plain(torch.from_numpy(rows), torch.from_numpy(exps), 480)
    ref = fi.batch_dct4(rows, exps, 480, 100)
    for g, r in zip(got, ref):
        same(g, r)


def host_ola_ltpf(frames: list, lps, B: int):
    """imdct_ola + ltpf_decode + round_pcm16 of the reference's host oracle,
    stream by stream over the frames (ytda, y_e, y_s, zero numpy [B, ...])."""
    from audio_codec_tpu.fixed_decoder import round_pcm16
    w = fi.window_table(480)
    sfi = fl.scale_fac_idx_for(JCFG.total_bits, JCFG.fs_idx, JCFG.frame_dms)
    out = np.zeros((len(frames), B, 480), np.int16)
    for b in range(B):
        ist, lst = fi.ImdctState(480, len(w)), fl.LtpfState(JCFG.fs)
        for t, (ytda, ye, ys, zero) in enumerate(frames):
            x, xe = fi.imdct_ola(ytda[b], ye[b], ys[b], zero[b], w, 480, len(w), ist)
            lp = lps[t][b]
            y, ye2 = fl.ltpf_decode(lst, x, xe, JCFG.fs_idx, 480, int(lp[0]), int(lp[1]),
                                    int(lp[2]), sfi)
            out[t, b] = round_pcm16(y, ye2)
    return out


def port_ola_ltpf(frames: list, lps, B: int):
    dec = DeviceFixedDecoder(CFG, B, device="cpu")
    hist = np.zeros(5, np.int64)
    out = []
    for (ytda, ye, ys, zero), lp in zip(frames, lps):
        lp = torch.from_numpy(np.ascontiguousarray(lp))
        hist += torch.bincount(pl.ltpf_patterns(dec.state, lp, CFG.fs_idx), minlength=5).numpy()
        out.append(pl.ola_ltpf_plain(CFG, dec.state, *(torch.from_numpy(np.ascontiguousarray(v))
                                                       for v in (ytda, ye, ys, zero)),
                                     lp, dec.sfi).numpy())
    return np.stack(out), hist


def test_ola_ltpf_matches_host_oracle_over_frames():
    """fx_ola_ltpf's plain version, frame by frame with its state, on the
    stored payloads' frames and on the plan that walks every stream through
    the passthrough and the four patterns."""
    side, dec = frontend()
    shaped, x_e = port_chain(side, dec)
    ytda, y_e, y_s, zero = (v.numpy() for v in pv.batch_dct4_plain(shaped, x_e, 480))
    T_, B = 8, 12
    frames = [(ytda.reshape(T_, B, 480)[t], y_e.reshape(T_, B)[t], y_s.reshape(T_, B)[t],
               zero.reshape(T_, B)[t]) for t in range(T_)]
    lps = side["ltpf_param"].reshape(T_, B, 3)
    got, hist_real = port_ola_ltpf(frames, lps, B)
    same(got, host_ola_ltpf(frames, lps, B))
    plan = C.fx_ola_plan()
    pf = [tuple(plan[k][t] for k in ("ytda", "y_e", "y_s", "zero")) for t in range(5)]
    got, hist = port_ola_ltpf(pf, plan["lp"], plan["y_e"].shape[1])
    same(got, host_ola_ltpf(pf, plan["lp"], plan["y_e"].shape[1]))
    assert bool((hist > 0).all()) and hist_real[0] > 0 and hist_real[2:].sum() > 0, \
        (hist.tolist(), hist_real.tolist())


# ---- the decoder against the reference's FixedDecoder ----

def test_device_fixed_decoder_matches_reference_fixed_decoder():
    """DeviceFixedDecoder(B=4, device="cpu") on 6 frames of the port's
    encoder (noise, speech, music, quiet noise) against FixedDecoder.decode
    of each stream, bit for bit."""
    frames = port_frames(6, 4)
    pcm = DeviceFixedDecoder(CFG, 4, device="cpu").decode_block(frames)
    assert pcm.dtype == torch.int16 and tuple(pcm.shape) == (6, 4, 480)
    for b in range(4):
        same(pcm[:, b], FixedDecoder(JCFG).decode(frames[:, b]))


def test_state_carried_across_blocks_from_the_reference():
    """A decoder started from fixed_state_from_numpy of the reference's
    state after 4 frames gives the reference's PCM for the next 4: the
    stored pulse-train stream, whose LTPF is on across the cut."""
    fr = stored()["frames"][:, 10]
    host = FixedDecoder(JCFG)
    host.decode(fr[:4])
    st = dict(mem=host.imdct_st.mem[None], mem_e=np.array([host.imdct_st.mem_e]),
              ltpf={k: np.asarray(getattr(host.ltpf_st, a))[None] if np.ndim(
                  getattr(host.ltpf_st, a)) else np.array([getattr(host.ltpf_st, a)])
                  for k, a in (("old_x", "old_x"), ("old_y", "old_y"), ("old_e", "old_e"),
                               ("pitch_int", "pitch_int"), ("pitch_fr", "pitch_fr"),
                               ("gain", "gain"), ("mem_active", "mem_active"),
                               ("old_sfi", "old_scale_fac_idx"))})
    assert int(st["ltpf"]["mem_active"][0]) == 1
    dec = DeviceFixedDecoder(CFG, 1, device="cpu")
    dec.state = fixed_state_from_numpy(st, device="cpu")
    same(dec.decode_block(fr[4:, None]), stored()["pcm"][4:, 10:11])
    same(stored()["pcm"][4:, 10], host.decode(fr[4:]))


def test_stored_reference_decodes_bit_for_bit():
    """The first 4 stored streams through the reference's FixedDecoder and
    the port on the CPU: both equal the stored PCM (which chip_smoke.py holds
    the card to)."""
    ref = stored()
    pcm = DeviceFixedDecoder(CFG, 4, device="cpu").decode_block(ref["frames"][:, :4])
    same(pcm, ref["pcm"][:, :4])
    for b in range(4):
        same(FixedDecoder(JCFG).decode(ref["frames"][:, b]), ref["pcm"][:, b])


def test_device_decoder_refuses_to_fall_back_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is usable")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        DeviceFixedDecoder(CFG, 2)


# ---- slow: the other rates, the reference's device decoder, regeneration ----

RATES = [(8000, 32000), (16000, 32000), (24000, 48000), (32000, 64000), (44100, 64000),
         (48000, 64000)]


def rate_material(fs: int, T: int, B: int) -> np.ndarray:
    """[T, B, N] PCM at fs: a pulse train with a tone, noise, and speech
    taken every 48000/fs-th sample."""
    n = JConfig(fs_in=fs, bitrate=32000).frame_length
    t = np.arange(T * n) / fs
    from tests.torch_port_data import material
    sp = material("speech")
    idx = (np.arange(T * n) * (48000 / fs)).astype(int) + 96000
    pulses = np.zeros(T * n)
    pulses[:: max(fs // 200, 1)] = 10000.0
    cols = [pulses + 800 * np.sin(2 * np.pi * 180 * t),
            np.random.default_rng(fs).standard_normal(T * n) * 2000, sp[idx]]
    return np.stack([cols[b % 3].reshape(T, n) for b in range(B)], 1).astype(np.float32)


@pytest.mark.slow
@pytest.mark.parametrize("fs,bitrate", RATES)
def test_device_fixed_decoder_at_the_md5_gate_rates(fs, bitrate):
    """The six 10 ms rates of the reference's MD5 gate
    (tools/fixed_dev_check.py:33-35), on the reference encoder's payloads:
    slow because each rate compiles the reference's encoder and frontend."""
    import jax
    import jax.numpy as jnp
    from audio_codec_tpu.models import encoder as JE
    from audio_codec_tpu.models import state as JS
    jc = JConfig(fs_in=fs, bitrate=bitrate)
    pcm = rate_material(fs, 6, 3)

    def body(st, x):
        st, out, _ = JE.encode_frame(jc, st, x)
        return st, out
    _, frames = jax.jit(lambda st, p: jax.lax.scan(body, st, p))(JS.enc_state_init(jc, 3),
                                                                  jnp.asarray(pcm))
    frames = np.asarray(frames, np.uint8)
    pcm = DeviceFixedDecoder(P.Config(fs_in=fs, bitrate=bitrate), 3, device="cpu").decode_block(
        frames)
    for b in range(3):
        same(pcm[:, b], FixedDecoder(jc).decode(frames[:, b]))


JAX_DEVICE_DECODER = textwrap.dedent("""
    import sys
    import jax
    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", True)
    import numpy as np
    from audio_codec_tpu.config import Config
    from audio_codec_tpu.fixed_decoder_dev import DeviceFixedDecoder
    z = np.load(sys.argv[1])
    fr = z["frames"][:4, :4]
    dec = DeviceFixedDecoder(Config(fs_in=48000, bitrate=64000), B=4)
    pcm = dec.decode_block(fr)
    st = {k: np.asarray(v) for k, v in dec.state.items() if k != "ltpf"}
    st.update({"ltpf_" + k: np.asarray(v) for k, v in dec.state["ltpf"].items()})
    np.savez(sys.argv[2], pcm=pcm, **st)
""")


@pytest.mark.slow
def test_against_the_reference_device_decoder(tmp_path):
    """The reference's DeviceFixedDecoder itself (jax_enable_x64 in a
    subprocess; slow: its XLA compile takes minutes) on 4 stored streams x 4
    frames: the same PCM and the same state after the block."""
    out = tmp_path / "jax.npz"
    r = subprocess.run([sys.executable, "-c", JAX_DEVICE_DECODER, str(REF), str(out)], cwd=ROOT,
                       capture_output=True, text=True, timeout=5400)
    assert r.returncode == 0, r.stderr[-3000:]
    with np.load(out) as z:
        j = {k: z[k] for k in z.files}
    dec = DeviceFixedDecoder(CFG, 4, device="cpu")
    same(dec.decode_block(stored()["frames"][:4, :4]), j["pcm"])
    for k, v in dec.state.items():
        same(v, j[k] if k in ("mem", "mem_e") else j["ltpf_" + k])


@pytest.mark.slow
def test_stored_reference_regenerates_unchanged():
    """tools/torch_fixed_reference.py makes the stored file again, equal
    (slow: it runs the reference's encoder and FixedDecoder on 12 streams)."""
    sys.path.insert(0, str(ROOT / "tools"))
    import torch_fixed_reference as R
    new = R.build()
    for k, v in stored().items():
        same(new[k], v)
