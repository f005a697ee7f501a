#!/usr/bin/env python3
"""Times the DCT-IV kernels of audio_codec_torch on a CUDA card: a tool for
the PRs that make csrc/mdct.cu and csrc/imdct.cu fast. Every line printed
carries the card's name and power limit.

  (default)        mdct, imdct and, where the checkout has it,
                   mdct_compensated at B streams of the 48 kHz / 10 ms frame
                   (N = 480), beside torch.matmul of the same rows, each
                   checked against its plain version bit for bit: median
                   loop ms (5 loops of 20 launches) and graph ms (the best
                   of 3 replays of 20 launches captured in a CUDA graph),
                   one JSON line.
  --other DIR      the same for a checkout of another commit (for example
                   the parent unpacked with `git archive` into a directory
                   that .gitignore lists), in turns with this one, each in a
                   process of its own: other, this, this, other.
  --variants FILE  a JSON list of [name, "mdct.cu" or "imdct.cu",
                   [[old, new], ...]] (a name with "compensated" in it runs
                   mdct.cu's compensated entry): each variant is a copy of
                   the source with the text replaced (tile constants, loop
                   forms), built alone with nvcc into a library of its own,
                   compared bit for bit with this checkout's kernel and
                   timed (graph ms, two rounds); tools/torch_dct4_variants.json
                   holds the tiles compared when the kernels were designed.
  --step-bench     the IMDCT's chain step alone, 16 chains a thread, 480
                   threads on each of 132 blocks, no memory traffic: chain
                   steps a second for a double FMA, FMA and two adds (a
                   constant M), FMA and dct4.cuh:round_float_in_range, and
                   float adds.

The rows: x and mem uniform at 16-bit scale; the spectrum decaying, nothing
above bin 400, one stream in 17 silent (for --variants also one value of
1e-30, whose IMDCT tile takes the tested step).

    python3 tools/torch_dct4_times.py [--streams 2048] [--other DIR]
    python3 tools/torch_dct4_times.py --step-bench --variants tools/torch_dct4_variants.json
"""
from __future__ import annotations

import argparse
import ctypes
import json
import shutil
import statistics
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
CSRC = ROOT / "audio_codec_torch" / "csrc"
OUT = ROOT / "build" / "dct4_variants"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3", "-Xcompiler",
              "-fPIC", "-Xptxas", "-v", "-shared"]


STEP_BENCH = r"""
#include "dct4.cuh"
// 16 chains a thread; V 0: a double FMA chain; 1: FMA and two adds of a
// constant; 2: FMA and round_float_in_range; 3: float adds (32 chains)
template <int V>
__global__ void __launch_bounds__(480, 1) bench(const double* ab, double* out, int iters) {
  double p[16], a[4], b[4];
  float f[32], fb[4];
  for (int i = 0; i < 4; ++i) {
    a[i] = ab[threadIdx.x % 7 + i];
    b[i] = ab[threadIdx.x % 5 + 8 + i];
    fb[i] = static_cast<float>(b[i]);
  }
  for (int i = 0; i < 16; ++i) p[i] = 0.0;
  for (int i = 0; i < 32; ++i) f[i] = 0.0f;
  const double M = 1.5 * 1099511627776.0;
  for (int it = 0; it < iters; ++it) {
    if (V < 3) {
#pragma unroll
      for (int i = 0; i < 16; ++i) {
        const double x = acx::rfma_f64(a[i / 4], b[i % 4], p[i]);
        p[i] = V == 0 ? x : V == 1 ? acx::radd_f64(acx::radd_f64(x, M), -M)
                                   : acx::round_float_in_range(x);
      }
    } else {
#pragma unroll
      for (int i = 0; i < 32; ++i) f[i] = acx::radd(f[i], fb[i % 4]);
    }
  }
  double s = 0.0;
  for (int i = 0; i < 16; ++i) s += p[i];
  for (int i = 0; i < 32; ++i) s += f[i];
  out[blockIdx.x * blockDim.x + threadIdx.x] = s;
}
extern "C" int run(int v, const void* ab, void* out, int iters, int blocks, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const double* A = static_cast<const double*>(ab);
  double* O = static_cast<double*>(out);
  if (v == 0) bench<0><<<blocks, 480, 0, st>>>(A, O, iters);
  if (v == 1) bench<1><<<blocks, 480, 0, st>>>(A, O, iters);
  if (v == 2) bench<2><<<blocks, 480, 0, st>>>(A, O, iters);
  if (v == 3) bench<3><<<blocks, 480, 0, st>>>(A, O, iters);
  return static_cast<int>(cudaGetLastError());
}
"""


def card() -> str:
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True)
    return smi.stdout.strip().splitlines()[0] if smi.returncode == 0 else "nvidia-smi failed"


def rows(B: int, N: int, la: int, tested: bool = False):
    """(x, mem, y) on the card: frames and memories at 16-bit scale, and a
    decoder's spectrum (decaying, nothing above the 400 coded bins, one
    stream in 17 silent; with `tested` one value of 1e-30 too)."""
    import numpy as np
    import torch
    rng = np.random.default_rng(0)
    f32 = lambda a: torch.tensor(a, dtype=torch.float32, device="cuda")
    x = f32(rng.uniform(-20000, 20000, (B, N)))
    mem = f32(rng.uniform(-20000, 20000, (B, N - la)))
    y = rng.standard_normal((B, N)) * 300.0 * np.exp(-np.arange(N) / 150.0)[None]
    y[:, 400:] = 0.0
    y[::17] = 0.0
    if tested:
        y[5, 100] = 1e-30
    return x, mem, f32(y)


def loop_ms(fn, reps: int = 20) -> float:
    import torch
    fn()
    torch.cuda.synchronize()
    e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    e0.record()
    for _ in range(reps):
        fn()
    e1.record()
    torch.cuda.synchronize()
    return e0.elapsed_time(e1) / reps


def graph_ms(fn, reps: int = 20) -> float:
    import torch
    fn()
    torch.cuda.synchronize()
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        for _ in range(reps):
            fn()
    g.replay()
    torch.cuda.synchronize()
    e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    e0.record()
    g.replay()
    e1.record()
    torch.cuda.synchronize()
    return e0.elapsed_time(e1) / reps


def differing(got, ref) -> int:
    import torch
    return sum(int((g.contiguous().view(torch.int32) != r.contiguous().view(torch.int32)).sum())
               for g, r in zip(got, ref))


def measure(root: Path, B: int) -> dict:
    """The times of the checkout at root, in this process."""
    sys.path.insert(0, str(root))
    import torch
    import audio_codec_torch as P
    from audio_codec_torch import kernels as K
    from audio_codec_torch.ops import transforms as TR

    K.library()
    cfg = P.Config(fs_in=48000, bitrate=64000)
    N = cfg.frame_length
    x, mem, y = rows(B, N, cfg.la_zeroes)
    runs = {"mdct": (K.mdct, TR.mdct_plain, (cfg, x, mem)),
            "imdct": (K.imdct, TR.imdct_plain, (cfg, y, mem))}
    if hasattr(K, "mdct_compensated"):
        runs["mdct_compensated"] = (K.mdct_compensated,
                                    lambda *a: TR.mdct_plain(*a, compensated=True), (cfg, x, mem))
    out = {"root": str(root), "card": card(), "streams": B}
    for name, (kernel, plain, args) in runs.items():
        got, ref = kernel(*args), plain(*args)
        torch.cuda.synchronize()
        out[name] = {"differ": differing(got, ref),
                     "loop_ms": statistics.median(loop_ms(lambda: kernel(*args)) for _ in range(5)),
                     "graph_ms": min(graph_ms(lambda: kernel(*args)) for _ in range(3))}
    if torch.backends.cuda.matmul.allow_tf32:
        raise SystemExit("torch_dct4_times: TF32 is on for torch.matmul")
    Mt = TR.dct4_mt(N, "cuda")
    out["matmul_ms"] = statistics.median(loop_ms(lambda: torch.matmul(x, Mt)) for _ in range(5))
    return out


def nvcc() -> str:
    return shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"


def step_bench() -> None:
    import torch
    d = OUT / "step_bench"
    shutil.rmtree(d, ignore_errors=True)
    d.mkdir(parents=True)
    (d / "bench.cu").write_text(STEP_BENCH)
    r = subprocess.run([nvcc(), *NVCC_FLAGS, f"-I{CSRC}", "-o", str(d / "bench.so"),
                        str(d / "bench.cu")], capture_output=True, text=True)
    if r.returncode:
        raise SystemExit(f"nvcc failed:\n{r.stdout}{r.stderr}")
    lib = ctypes.CDLL(str(d / "bench.so"))
    lib.run.argtypes = [ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
                        ctypes.c_void_p]
    ab = torch.linspace(0.5, 1.5, 32, dtype=torch.float64, device="cuda")
    out = torch.empty(132 * 480, dtype=torch.float64, device="cuda")
    iters = 4000
    names = ("double FMA", "FMA + two adds", "FMA + round_float_in_range", "float add")
    for v, name in enumerate(names):
        st = torch.cuda.current_stream().cuda_stream
        ms = loop_ms(lambda: lib.run(v, ab.data_ptr(), out.data_ptr(), iters, 132, st), 5)
        steps = 132 * 480 * (32 if v == 3 else 16) * iters
        print(f"[step] {card()} | {name}: {ms:.3f} ms, {steps / ms / 1e9:.3f} T chain steps/s",
              flush=True)


def variants(spec: Path) -> None:
    import torch
    sys.path.insert(0, str(ROOT))
    import audio_codec_torch as P
    from audio_codec_torch import kernels as K
    from audio_codec_torch.ops import transforms as TR

    shutil.rmtree(OUT, ignore_errors=True)
    OUT.mkdir(parents=True)
    procs = []
    for name, fname, subs in json.loads(spec.read_text()):
        d = OUT / name
        d.mkdir()
        for f in ("acodec.cuh", "dct4.cuh", fname):
            shutil.copy(CSRC / f, d / f)
        text = (d / fname).read_text()
        for old, new in subs:
            if old not in text:
                raise SystemExit(f"{name}: {old!r} is not in {fname}")
            text = text.replace(old, new)
        (d / fname).write_text(text)
        procs.append((name, fname, subprocess.Popen(
            [nvcc(), *NVCC_FLAGS, "-o", str(d / "lib.so"), str(d / fname)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    K.library()
    P_, I_ = ctypes.c_void_p, ctypes.c_int
    libs = {}
    for name, fname, p in procs:
        log, _ = p.communicate()
        if p.returncode:
            print(f"[{name}] build failed:\n{log[-3000:]}", flush=True)
            continue
        for line in log.splitlines():
            if "registers" in line or "spill stores" in line and not line.strip().startswith("0 bytes"):
                print(f"[{name}] {line.strip()}", flush=True)
        lib = ctypes.CDLL(str(OUT / name / "lib.so"))
        if fname == "imdct.cu":
            lib.acx_imdct.argtypes = [P_] * 7 + [I_] * 3 + [P_]
        else:
            lib.acx_mdct.argtypes = [P_] * 7 + [I_] * 4 + [P_]
            lib.acx_mdct_compensated.argtypes = [P_] * 8 + [I_] * 4 + [P_]
        libs[name] = (fname, lib)

    cfg = P.Config(fs_in=48000, bitrate=64000)
    B, N, la = 2048, cfg.frame_length, cfg.la_zeroes
    dev = torch.device("cuda")
    x, mem, y = rows(B, N, la, tested=True)
    win, rwin = TR.window(cfg, "cuda"), TR.window(cfg, "cuda", True)
    Mt, Mt64 = TR.dct4_mt(N, "cuda"), TR.dct4_mt64(N, "cuda")
    st = lambda: torch.cuda.current_stream().cuda_stream

    def call(name):
        fname, lib = libs[name]
        if fname == "imdct.cu":
            out, nm_ = torch.empty_like(y), torch.empty_like(mem)
            rc = lib.acx_imdct(y.data_ptr(), mem.data_ptr(), rwin.data_ptr(), Mt.data_ptr(),
                               Mt64.data_ptr(), out.data_ptr(), nm_.data_ptr(), B, N, la, st())
            return rc, (out, nm_)
        fold = torch.empty((N, B), dtype=torch.float32, device=dev)
        d, nm_ = torch.empty_like(x), torch.empty_like(mem)
        ptrs = [x.data_ptr(), mem.data_ptr(), win.data_ptr(), Mt.data_ptr(), fold.data_ptr()]
        if "compensated" in name:
            fast = torch.empty((-(-N // 32), B), dtype=torch.int32, device=dev)
            rc = lib.acx_mdct_compensated(*ptrs, fast.data_ptr(), d.data_ptr(), nm_.data_ptr(),
                                          B, B, N, la, st())
        else:
            rc = lib.acx_mdct(*ptrs, d.data_ptr(), nm_.data_ptr(), B, B, N, la, st())
        return rc, (d, nm_)

    ref = {"imdct.cu": K.imdct(cfg, y, mem), "mdct.cu": K.mdct(cfg, x, mem),
           "compensated": K.mdct_compensated(cfg, x, mem)}
    torch.cuda.synchronize()
    for rnd in range(2):
        for name, (fname, _) in libs.items():
            rc, got = call(name)
            torch.cuda.synchronize()
            differ = differing(got, ref["compensated" if "compensated" in name else fname])
            ms = min(graph_ms(lambda: call(name)) for _ in range(3))
            print(f"[variant] {card()} | round {rnd} {name}: rc {rc}, {differ} values differ "
                  f"from the checkout's kernel, graph {ms:.4f} ms", flush=True)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--streams", type=int, default=2048)
    ap.add_argument("--other", type=Path, default=None)
    ap.add_argument("--variants", type=Path, default=None)
    ap.add_argument("--step-bench", action="store_true")
    ap.add_argument("--root", type=Path, default=None, help=argparse.SUPPRESS)
    opt = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("torch_dct4_times: no CUDA device")
    if opt.step_bench or opt.variants is not None:
        if opt.step_bench:
            step_bench()
        if opt.variants is not None:
            variants(opt.variants)
        return 0
    if opt.root is not None or opt.other is None:
        print(json.dumps(measure((opt.root or ROOT).resolve(), opt.streams)), flush=True)
        return 0
    rc = 0
    for root in (opt.other, ROOT, ROOT, opt.other):
        r = subprocess.run([sys.executable, __file__, "--streams", str(opt.streams),
                            "--root", str(root.resolve())])
        rc = rc or r.returncode
    return rc


if __name__ == "__main__":
    sys.exit(main())
