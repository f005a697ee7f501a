#!/usr/bin/env python3
"""Write audio_codec_torch/data/fixed_pcm_ref.npz: payloads of the
reference's encoder and the int16 PCM that the reference's bit-exact
fixed-point decoder (audio_codec_tpu.fixed_decoder.FixedDecoder) makes of
them, at 48 kHz / 64 kbps, 10 ms (80-byte payloads).

chip_smoke.py decodes the stored payloads with the port on the card and
requires the stored PCM bit for bit, without importing JAX; the tests
decode the first streams with both packages on the CPU
(tests/test_torch_fixed_dev.py). The streams reach LTPF on and off, every
SNS submode, TNS on and off and zero frames (a silent stream); the script
prints what they reach and fails if one is missing.

    JAX_PLATFORMS=cpu python3 tools/torch_fixed_reference.py [--out PATH]
"""
from __future__ import annotations

import argparse
import sys
import wave
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))
OUT = ROOT / "audio_codec_torch" / "data" / "fixed_pcm_ref.npz"
STREAMS, FRAMES, N = 12, 8, 480
FS, BITRATE = 48000, 64000


def _wav(name: str) -> np.ndarray:
    with wave.open(str(ROOT / "material" / f"{name}48.wav")) as w:
        return np.frombuffer(w.readframes(w.getnframes()), np.int16).astype(np.float32)


def material() -> np.ndarray:
    """[FRAMES, STREAMS, N] float PCM: speech (four offsets, and one quiet),
    music (three offsets), noise at two levels, a pitched pulse train and
    a silent stream."""
    speech, music = _wav("speech"), _wav("music")
    rng = np.random.default_rng(0)
    n = FRAMES * N
    t = np.arange(n) / FS
    rows = [speech[o: o + n] for o in (0, 160000, 320000, 280000)]
    rows += [speech[200000: 200000 + n] * 0.02]
    rows += [music[o: o + n] for o in (0, 250000, 50000)]
    rows += [rng.standard_normal(n) * 3000.0, rng.standard_normal(n) * 20.0]
    pulses = np.zeros(n)
    pulses[::240] = 12000.0               # a 200 Hz pulse train: the LTPF's material
    rows += [np.convolve(pulses, np.hanning(31), "same") + 500.0 * np.sin(2 * np.pi * 200 * t)]
    rows += [np.zeros(n)]
    assert len(rows) == STREAMS
    return np.stack(rows, 1).reshape(FRAMES, N, STREAMS).transpose(0, 2, 1).astype(np.float32)


def encode(pcm: np.ndarray) -> np.ndarray:
    """[FRAMES, STREAMS, 80] uint8 payloads of the reference's encoder."""
    import jax
    import jax.numpy as jnp
    from audio_codec_tpu.config import Config
    from audio_codec_tpu.models import encoder as JE
    from audio_codec_tpu.models import state as JS
    cfg = Config(fs_in=FS, bitrate=BITRATE)

    def body(st, x):
        st, out, _ = JE.encode_frame(cfg, st, x)
        return st, out
    _, frames = jax.jit(lambda st, p: jax.lax.scan(body, st, p))(
        JS.enc_state_init(cfg, pcm.shape[1]), jnp.asarray(pcm))
    return np.asarray(frames, np.uint8)


def reference_pcm(frames: np.ndarray) -> np.ndarray:
    """[FRAMES, STREAMS, N] int16: the reference FixedDecoder, stream by stream."""
    from audio_codec_tpu.config import Config
    from audio_codec_tpu.fixed_decoder import FixedDecoder
    cfg = Config(fs_in=FS, bitrate=BITRATE)
    return np.stack([FixedDecoder(cfg).decode(frames[:, b]) for b in range(frames.shape[1])], 1)


def coverage(frames: np.ndarray) -> dict[str, int]:
    """Frames that reach each feature, read with the port's CPU frontend."""
    import torch

    import audio_codec_torch as P
    from audio_codec_torch.ops import ari, bits
    cfg = P.Config(fs_in=FS, bitrate=BITRATE)
    buf = torch.from_numpy(frames.reshape(-1, frames.shape[-1]).astype(np.int32))
    side = bits.parse_side_info(cfg, buf)
    dec = ari.decode(cfg, buf, side)
    sub = side["scf_idx"][:, 2]
    tns = dec["tns_order"] > 0
    out = {f"submode {k}": int((sub == k).sum()) for k in range(4)}
    out.update({"LTPF on": int((side["ltpf_param"][:, 1] != 0).sum()),
                "LTPF off": int((side["ltpf_param"][:, 1] == 0).sum()),
                "TNS on": int(tns.any(dim=1).sum()), "TNS off": int((~tns.any(dim=1)).sum()),
                "zero frames": int((dec["zero_frame"] != 0).sum())})
    return out


def build() -> dict[str, np.ndarray]:
    frames = encode(material())
    return dict(frames=frames, pcm=reference_pcm(frames), fs_in=np.int64(FS),
                bitrate=np.int64(BITRATE))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", type=Path, default=OUT)
    opt = ap.parse_args()
    ref = build()
    cov = coverage(ref["frames"])
    print(f"coverage over {FRAMES} x {STREAMS} frames: {cov}")
    if min(cov.values()) == 0:
        print("a feature is not reached", file=sys.stderr)
        return 1
    np.savez_compressed(opt.out, **ref)
    print(f"wrote {opt.out} ({opt.out.stat().st_size} bytes)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
