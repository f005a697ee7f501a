#!/usr/bin/env python3
"""Times the LTPF decoder of audio_codec_torch on a CUDA card: its stage
(ops/ltpf_dec.py:ltpf_decode, the parameter code and the post-filter) and
its kernel, on the inputs the flagship decoder gives it. Every line printed
carries the card's name and power limit.

The inputs: chip_smoke.make_pcm's material (a third speech, a third music, a
third noise) at 48 kHz / 64 kbps, B streams, encoded and decoded for T
frames by the checkout's own encode_block and decode_block; the arguments of
ltpf_decode at the last frame are recorded and timed: the stage (median loop
ms of 5 loops of 20 calls, and graph ms: 20 calls replayed from a CUDA graph,
the best of 3) and the kernel inside it (the same), checked against its
plain version bit for bit. The kernel is `ltpf_decode` where the checkout
has it, else the `ltpf_postfilter` launch the stage makes.

  (default)    this checkout, one JSON line.
  --other DIR  the same for a checkout of another commit (for example the
               parent unpacked with `git archive` into a directory that
               .gitignore lists), in turns with this one, each in a process
               of its own: other, this, this, other.

    python3 tools/torch_ltpf_times.py [--streams 2048] [--frames 8] [--other DIR]
"""
from __future__ import annotations

import argparse
import importlib.util
import json
import statistics
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT / "tools"))
from torch_dct4_times import card, graph_ms, loop_ms  # noqa: E402


def times(fn) -> dict:
    return {"loop_ms": statistics.median(loop_ms(fn) for _ in range(5)),
            "graph_ms": min(graph_ms(fn) for _ in range(3))}


def make_pcm(T: int, B: int, n: int):
    """chip_smoke.make_pcm of this checkout (its material), seed 0."""
    spec = importlib.util.spec_from_file_location("chip_smoke_pcm", ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.make_pcm(T, B, n, 0)


def measure(root: Path, B: int, T: int) -> dict:
    """The times of the checkout at root, in this process."""
    import torch
    pcm_np = make_pcm(T, B, 480)
    sys.path.insert(0, str(root))
    import audio_codec_torch as P
    from audio_codec_torch import kernels as K
    from audio_codec_torch.ops import ltpf_dec as L
    from tests.torch_kernel_cases import count_differing

    K.library()
    cfg = P.Config(fs_in=48000, bitrate=64000)
    pcm = torch.from_numpy(pcm_np).cuda()
    _, frames = P.encode_block(cfg, P.enc_state_init(cfg, B), pcm)
    calls = []
    stage = L.ltpf_decode

    def record(*a):
        calls.append(a)
        return stage(*a)
    L.ltpf_decode = record
    try:
        P.decode_block(cfg, P.dec_state_init(cfg, B), frames)
    finally:
        L.ltpf_decode = stage
    args = calls[-1]
    torch.cuda.synchronize()
    out = {"root": str(root), "card": card(), "streams": B, "frame": len(calls) - 1,
           "stage": times(lambda: stage(*args))}
    if hasattr(L, "ltpf_decode_plain"):
        name, kernel, kargs, plain = "ltpf_decode", K.ltpf_decode, args, L.ltpf_decode_plain
        on = int(((L.case_word(*args) & L.NEW_ON) != 0).sum())
    else:
        inner = []
        post = K.ltpf_postfilter

        def rec(*a):
            inner.append(a)
            return post(*a)
        K.ltpf_postfilter = rec
        try:
            stage(*args)
        finally:
            K.ltpf_postfilter = post
        name, kernel, kargs, plain = "ltpf_postfilter", post, inner[0], L.ltpf_postfilter_plain
        on = int(((kargs[10] & L.NEW_ON) != 0).sum())
    got, ref = kernel(*kargs), plain(*kargs)
    torch.cuda.synchronize()
    out["kernel"] = {"name": name, "differ": count_differing(got, ref), "streams_on": on,
                     **times(lambda: kernel(*kargs))}
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--streams", type=int, default=2048)
    ap.add_argument("--frames", type=int, default=8)
    ap.add_argument("--other", type=Path, default=None)
    ap.add_argument("--root", type=Path, default=None, help=argparse.SUPPRESS)
    opt = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("torch_ltpf_times: no CUDA device")
    if opt.root is not None or opt.other is None:
        print(json.dumps(measure((opt.root or ROOT).resolve(), opt.streams, opt.frames)),
              flush=True)
        return 0
    rc = 0
    for root in (opt.other, ROOT, ROOT, opt.other):
        r = subprocess.run([sys.executable, __file__, "--streams", str(opt.streams), "--frames",
                            str(opt.frames), "--root", str(root.resolve())])
        rc = rc or r.returncode
    return rc


if __name__ == "__main__":
    sys.exit(main())
