#!/usr/bin/env python3
"""Where the time of audio_codec_torch's main path goes, stage by stage.

Runs the 48 kHz / 10 ms / 64 kbps encoder and decoder on a CUDA card and
times every stage that models/encoder.py:encode_frame and
models/decoder.py:decode_synthesis call, by wrapping the stage functions
with a device synchronise on each side (host clock). The stages are mostly
launch-bound chains of small PyTorch ops, so the wrapper's synchronise
costs little next to them. Prints one JSON line per path with the stage
times in ms, largest first, and the card's name and power limit.

    python3 tools/torch_stage_times.py [--streams 2048] [--frames 3]
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from collections import defaultdict
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent

ENCODER_STAGES = {
    "transforms": ["mdct"],
    "analysis": ["resample_12k8", "olpa", "ltpf_encode", "attack_detector",
                 "per_band_energy", "detect_cutoff_warped"],
    "sns": ["compute_scf", "quantize_scf_enc", "interpolate_scf", "mdct_shaping"],
    "tns": ["tns_encode"],
    "quant": ["estimate_global_gain", "quantize_spectrum", "bit_estimate",
              "adjust_global_gain", "truncate_spectrum", "noise_residual_enc"],
    "bits": ["pack_side_info"],
    "ari": ["encode"],
}
DECODER_STAGES = {
    "bits": ["parse_side_info"],
    "ari": ["decode"],
    "sns": ["quantize_scf_dec", "interpolate_scf", "mdct_shaping"],
    "pc": ["compute_stab_fac", "pc_classify"],
    "quant": ["global_gain", "spectrum_decode"],
    "tns": ["tns_decode"],
    "plc": ["plc_main_update"],
    "transforms": ["imdct"],
    "ltpf_dec": ["ltpf_decode"],
}


def timed(stages: dict, totals: dict):
    """Wrap the stage functions; returns a function that restores them."""
    import importlib

    import torch
    saved = []
    for mod_name, fns in stages.items():
        mod = importlib.import_module(f"audio_codec_torch.ops.{mod_name}")
        for fn_name in fns:
            fn = getattr(mod, fn_name)
            saved.append((mod, fn_name, fn))

            def wrap(*a, _fn=fn, _key=f"{mod_name}.{fn_name}", **k):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                r = _fn(*a, **k)
                torch.cuda.synchronize()
                totals[_key] += (time.perf_counter() - t0) * 1e3
                return r
            setattr(mod, fn_name, wrap)

    def restore():
        for mod, name, fn in saved:
            setattr(mod, name, fn)
    return restore


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--streams", type=int, default=2048)
    ap.add_argument("--frames", type=int, default=3)
    opt = ap.parse_args()
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("torch_stage_times: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    import audio_codec_torch as P

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True)
    card = smi.stdout.strip().splitlines()[0] if smi.returncode == 0 else "unknown card"
    cfg = P.Config(fs_in=48000, bitrate=64000)
    B, T = opt.streams, opt.frames
    rng = np.random.default_rng(0)
    pcm = torch.from_numpy((rng.standard_normal((T + 1, B, 480)) * 3000).astype(np.float32)).cuda()

    st = P.enc_state_init(cfg, B)
    st, frames = P.encode_block(cfg, st, pcm[:1])          # warm-up
    enc = defaultdict(float)
    restore = timed(ENCODER_STAGES, enc)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    st, frames = P.encode_block(cfg, st, pcm[1:])
    torch.cuda.synchronize()
    enc_total = (time.perf_counter() - t0) * 1e3
    restore()

    ds = P.dec_state_init(cfg, B)
    P.decode_block(cfg, ds, frames[:1])                      # warm-up
    dec = defaultdict(float)
    restore = timed(DECODER_STAGES, dec)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    P.decode_block(cfg, ds, frames)
    torch.cuda.synchronize()
    dec_total = (time.perf_counter() - t0) * 1e3
    restore()

    for path, total, table in (("encode_block", enc_total, enc), ("decode_block", dec_total, dec)):
        rows = dict(sorted(((k, round(v / T, 3)) for k, v in table.items()),
                           key=lambda kv: -kv[1]))
        print(json.dumps({"path": path, "card": card, "streams": B, "frames": T,
                          "ms_per_frame": round(total / T, 3),
                          "stage_ms_per_frame": rows}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
