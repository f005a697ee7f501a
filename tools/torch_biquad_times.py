#!/usr/bin/env python3
"""Times the resampler's high-pass biquad of audio_codec_torch on a CUDA
card: the kernel `hp50_biquad` (csrc/hp50_biquad.cu) and its stage
(ops/analysis.py:resample_12k8) on the inputs the flagship path gives them.
Every line printed carries the card's name and power limit.

The inputs: chip_smoke.make_pcm's material at 48 kHz / 64 kbps, B streams,
encoded for T frames by the checkout's own encode_block; the arguments of
the stage and of the kernel at the last frame are recorded. Each is timed
as median loop ms (5 loops of 20 calls) and graph ms (20 calls replayed
from a CUDA graph, the best of 3), the kernel checked against its plain
version bit for bit.

  (default)     this checkout, one JSON line.
  --other DIR   the same for a checkout of another commit (the parent
                unpacked with `git archive` into a directory that .gitignore
                lists), in turns with this one, each in a process of its
                own: other, this, this, other.
  --step-bench  ns a dependent biquad step (csrc/hp50_biquad.cu:hp50_step),
                one chain a thread over registers, at one warp and at 8
                warps on each of 132 blocks.
  --scaling     the kernel at 1, 32, 512 and 2048 streams of the recorded
                rows (tiled): graph ms.
  --variants    the kept design (a thread a stream, the row in registers
                through 16-byte loads, N a template parameter) at blocks of
                16, 32 and 64 threads, and its general loop (4-byte loads,
                any N) at 16 and 32, each built from this checkout's source
                with text substitutions (VARIANTS); with --phases DIR also the first design's kernel
                (a block of 32 rows staged through shared memory by DIR's
                csrc/acodec.cuh:acx_load_rows, one thread a row) of the
                checkout DIR with one phase removed at a time (PHASES: the
                filter; the division in the staging; the staging), each
                built from DIR's sources with text substitutions: graph ms,
                two rounds, at 2048 streams (and 1 stream).

    python3 tools/torch_biquad_times.py [--streams 2048] [--frames 8] [--other DIR]
    python3 tools/torch_biquad_times.py --step-bench --scaling --variants [--phases DIR]
"""
from __future__ import annotations

import argparse
import ctypes
import json
import shutil
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT / "tools"))
from torch_dct4_times import NVCC_FLAGS, card, graph_ms, nvcc  # noqa: E402
from torch_ltpf_times import make_pcm, times  # noqa: E402

CSRC = ROOT / "audio_codec_torch" / "csrc"
OUT = ROOT / "build" / "biquad_times"

STEP_BENCH = r"""
#include "hp50_biquad.cu"
// one chain a thread: 64 steps on registers a round, the input the output
// of the step before (so the load of x is on no path)
__global__ void bench(const float* seed, float* out, int iters) {
  const acx::Hp50Coefs c = {0.9f, -1.8f, 0.9f, -1.9f, 0.91f};
  float u1 = seed[threadIdx.x % 32], u2 = seed[(threadIdx.x + 7) % 32], v = seed[0];
  for (int it = 0; it < iters; ++it) {
#pragma unroll
    for (int k = 0; k < 64; ++k) v = acx::hp50_step(u1, u2, v, c);
  }
  out[blockIdx.x * blockDim.x + threadIdx.x] = v + u1 + u2;
}
extern "C" int run(const void* seed, void* out, int iters, int blocks, int threads,
                   void* stream) {
  bench<<<blocks, threads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(seed), static_cast<float*>(out), iters);
  return static_cast<int>(cudaGetLastError());
}
"""

# the kept design and the others it was compared with: text substitutions
# (old, new) of this checkout's hp50_biquad.cu
_THREADS = "constexpr int kHpThreads = 16;"
_GENERAL = ("  const bool aligned = (ends & 15) == 0;", "  const bool aligned = false;")
VARIANTS = {
    "kept: a thread a stream, the row in registers (16-byte loads), blocks of 16": (),
    "the same, blocks of 32": ((_THREADS, "constexpr int kHpThreads = 32;"),),
    "the same, blocks of 64": ((_THREADS, "constexpr int kHpThreads = 64;"),),
    "the general loop (4-byte loads), blocks of 16": (_GENERAL,),
    "the general loop, blocks of 32": (_GENERAL, (_THREADS, "constexpr int kHpThreads = 32;")),
}

# the first design (a block of 32 rows staged in shared memory, one thread a
# row) with one phase removed: text substitutions of DIR's hp50_biquad.cu
_LOAD = "  acx_load_rows(tile, x, row0, rows, N);\n"
_STORE = "  acx_store_rows(y, tile, row0, rows, N);\n"
_FILTER = "    hp50_lane(tile + t * ACX_ROW_STRIDE(N), N, m, b0, b1, b2, a1, a2);\n"
_LOAD_NODIV = ("  for (int r = 0; r < rows; ++r)\n"
               "    for (int i = threadIdx.x; i < N; i += blockDim.x)\n"
               "      tile[r * ACX_ROW_STRIDE(N) + i] =\n"
               "          x[static_cast<size_t>(row0 + r) * N + i];\n")
_STORE_NODIV = ("  for (int r = 0; r < rows; ++r)\n"
                "    for (int i = threadIdx.x; i < N; i += blockDim.x)\n"
                "      y[static_cast<size_t>(row0 + r) * N + i] =\n"
                "          tile[r * ACX_ROW_STRIDE(N) + i];\n")
PHASES = {
    "first design as it is": (),
    "no filter (staging in and out only)": ((_FILTER, ""),),
    "staging without the division (row and column loops)": ((_LOAD, _LOAD_NODIV),
                                                            (_STORE, _STORE_NODIV)),
    "no filter, staging without the division": ((_FILTER, ""), (_LOAD, _LOAD_NODIV),
                                                (_STORE, _STORE_NODIV)),
    "no staging (the filter on uninitialised shared memory, nothing stored)": ((_LOAD, ""),
                                                                              (_STORE, "")),
}


def build(d: Path, files: dict[str, str], main: str) -> ctypes.CDLL:
    """nvcc builds `main` of the sources `files` (name -> text) in d."""
    shutil.rmtree(d, ignore_errors=True)
    d.mkdir(parents=True)
    for name, text in files.items():
        (d / name).write_text(text)
    r = subprocess.run([nvcc(), *NVCC_FLAGS, f"-I{d}", "-o", str(d / "lib.so"), str(d / main)],
                       capture_output=True, text=True)
    if r.returncode:
        raise SystemExit(f"nvcc failed in {d.name}:\n{r.stdout}{r.stderr}")
    return ctypes.CDLL(str(d / "lib.so"))


def sources(csrc: Path, subs=()) -> dict[str, str]:
    text = (csrc / "hp50_biquad.cu").read_text()
    for old, new in subs:
        if old not in text:
            raise SystemExit(f"{old!r} is not in {csrc / 'hp50_biquad.cu'}")
        text = text.replace(old, new)
    return {"acodec.cuh": (csrc / "acodec.cuh").read_text(), "hp50_biquad.cu": text}


def record(root: Path, B: int, T: int):
    """The flagship's T-frame encode of B streams with the checkout at root:
    (the stage's calls, the kernel's calls, the stage, the kernel, the plain
    version)."""
    import torch
    sys.path.insert(0, str(root))
    import audio_codec_torch as P
    from audio_codec_torch import kernels as K
    from audio_codec_torch.ops import analysis
    K.library()
    cfg = P.Config(fs_in=48000, bitrate=64000)
    pcm = torch.from_numpy(make_pcm(T, B, 480)).cuda()
    stage_calls, kernel_calls = [], []
    stage, kernel = analysis.resample_12k8, K.hp50_biquad

    def rec(store, fn):
        def f(*a):
            store.append(a)
            return fn(*a)
        return f
    analysis.resample_12k8 = rec(stage_calls, stage)
    K.hp50_biquad = rec(kernel_calls, kernel)
    try:
        P.encode_block(cfg, P.enc_state_init(cfg, B), pcm)
    finally:
        analysis.resample_12k8, K.hp50_biquad = stage, kernel
    torch.cuda.synchronize()
    return stage_calls, kernel_calls, stage, kernel, analysis.hp50_biquad_plain


def measure(root: Path, B: int, T: int) -> dict:
    """The times of the checkout at root, in this process."""
    import torch
    stage_calls, kernel_calls, stage, kernel, plain = record(root, B, T)
    from tests.torch_kernel_cases import count_differing
    out = {"root": str(root), "card": card(), "streams": B, "frames": T}
    kargs, sargs = kernel_calls[-1], stage_calls[-1]
    got, ref = kernel(*kargs), plain(*kargs)
    torch.cuda.synchronize()
    out["hp50_biquad"] = {"differ": count_differing(got, ref), **times(lambda: kernel(*kargs))}
    out["analysis.resample_12k8"] = times(lambda: stage(*sargs))
    return out


def coefs():
    import numpy as np
    from audio_codec_torch import tables as T
    b = [float(v) for v in np.float32(T.t("highpass50_filt_b"))]
    a = [float(v) for v in np.float32(T.t("highpass50_filt_a"))]
    return b[0], b[1], b[2], a[1], a[2]


def step_bench() -> None:
    import torch
    d = OUT / "step_bench"
    lib = build(d, {**sources(CSRC), "bench.cu": STEP_BENCH}, "bench.cu")
    lib.run.argtypes = [ctypes.c_void_p, ctypes.c_void_p] + [ctypes.c_int] * 3 + [ctypes.c_void_p]
    seed = torch.linspace(-0.5, 0.5, 32, device="cuda")
    out = torch.empty(132 * 256, device="cuda")
    iters = 200
    st = lambda: torch.cuda.current_stream().cuda_stream
    for warps in (1, 8):
        ms = min(graph_ms(lambda: lib.run(seed.data_ptr(), out.data_ptr(), iters, 132, 32 * warps,
                                          st())) for _ in range(3))
        print(f"[step] {card()} | hp50_step, {warps} warp(s) an SM: "
              f"{ms * 1e6 / (64 * iters):.3f} ns a dependent step", flush=True)


def tile(a, n):
    import torch
    idx = torch.arange(n, device=a.device) % a.shape[0]
    return a[idx].contiguous()


def scaling(root: Path, B: int, T: int) -> None:
    _, kernel_calls, _, kernel, _ = record(root, B, T)
    x, mem = kernel_calls[-1]
    for n in (1, 32, 512, 2048):
        a = (tile(x, n), tile(mem, n))
        ms = min(graph_ms(lambda: kernel(*a)) for _ in range(3))
        print(f"[scaling] {card()} | hp50_biquad ({root.name}): {n} streams: graph {ms:.5f} ms",
              flush=True)


def variants(B: int, T: int, phases: Path | None) -> None:
    import torch
    _, kernel_calls, _, _, plain = record(ROOT, B, T)
    x0, mem0 = kernel_calls[-1]
    P_, I_, F_ = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    jobs = [(f"variant{i}", name, CSRC, subs) for i, (name, subs) in enumerate(VARIANTS.items())]
    if phases is not None:
        csrc = phases.resolve() / "audio_codec_torch" / "csrc"
        jobs += [(f"phase{i}", name, csrc, subs) for i, (name, subs) in enumerate(PHASES.items())]
    runs = []
    for tag, name, csrc, subs in jobs:
        lib = build(OUT / tag, sources(csrc, subs), "hp50_biquad.cu")
        lib.acx_hp50_biquad.argtypes = [P_] * 4 + [I_] * 2 + [F_] * 5 + [P_]
        runs.append((name, lambda x, m, y, mo, n, lib=lib: lib.acx_hp50_biquad(
            x, m, y, mo, n, x0.shape[1], *coefs(), st())))
    st = lambda: torch.cuda.current_stream().cuda_stream
    for rnd in range(2):
        for n in (2048, 1):
            x, mem = tile(x0, n), tile(mem0, n)
            ry, rmem = plain(x, mem)
            for name, call in runs:
                y, mo = torch.empty_like(x), torch.empty_like(mem)
                f = lambda: call(x.data_ptr(), mem.data_ptr(), y.data_ptr(), mo.data_ptr(), n)
                rc = f()
                torch.cuda.synchronize()
                differ = int((y.view(torch.int32) != ry.view(torch.int32)).sum()
                             + (mo.view(torch.int32) != rmem.view(torch.int32)).sum())
                ms = min(graph_ms(f) for _ in range(3))
                print(f"[biquad variants] {card()} | round {rnd}, {n} streams, {name}: rc {rc}, "
                      f"{differ} values differ from the plain version, graph {ms:.5f} ms",
                      flush=True)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--streams", type=int, default=2048)
    ap.add_argument("--frames", type=int, default=8)
    ap.add_argument("--other", type=Path, default=None)
    ap.add_argument("--step-bench", action="store_true")
    ap.add_argument("--scaling", action="store_true")
    ap.add_argument("--variants", action="store_true")
    ap.add_argument("--phases", type=Path, default=None)
    ap.add_argument("--root", type=Path, default=None, help=argparse.SUPPRESS)
    opt = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("torch_biquad_times: no CUDA device")
    if opt.step_bench or opt.scaling or opt.variants:
        if opt.step_bench:
            step_bench()
        if opt.scaling:
            scaling((opt.root or ROOT).resolve(), opt.streams, opt.frames)
        if opt.variants:
            variants(opt.streams, opt.frames, opt.phases)
        return 0
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
