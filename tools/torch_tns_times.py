#!/usr/bin/env python3
"""Times the TNS kernels of audio_codec_torch on a CUDA card: each kernel
(tns_filter_analysis, tns_analysis_lattice, tns_synthesis_lattice) and its
stage (ops/tns.py: tns_encode, which holds the first two, and tns_decode) on
the inputs the flagship path gives them. Every line printed carries the
card's name and power limit.

The inputs: chip_smoke.make_pcm's material (a third speech, a third music, a
third noise) at 48 kHz / 64 kbps, B streams, encoded and decoded for T
frames by the checkout's own encode_block and decode_block; the arguments of
tns_encode and tns_decode at the last frame are recorded, and those of the
three kernel launches inside them. Each is timed as median loop ms (5 loops
of 20 calls) and graph ms (20 calls replayed from a CUDA graph, the best of
3), each kernel checked against its plain version bit for bit.

  (default)     this checkout, one JSON line.
  --other DIR   the same for a checkout of another commit (for example the
                parent unpacked with `git archive` into a directory that
                .gitignore lists), in turns with this one, each in a process
                of its own: other, this, this, other.
  --step-bench  the lattices' dependent step alone, one chain a thread and
                no memory traffic, at one warp and at 16 warps on each of
                132 blocks: ns a step of an xfma (floats, four conversions),
                an xfma_d (doubles holding floats, csrc/dct4.cuh), a shuffle
                followed by an xfma_d (the synthesis wavefront's step), and a
                product and a sum rounded one by one (rmul, radd: the
                encoder lattice's earlier, separately rounded step); and
                the lattices' fast step (csrc/tns_lattice.cuh:tns_fma
                without its branch), alone and after a shuffle.
  --scaling     both kernels on seeded rows whose streams all filter, order
                8 in both ranges: at 4, 32, 512 and 2048 streams over a hull
                of 388 bins, and at 2048 streams over hulls of 25-200 bins
                (graph ms and us a bin). A stream's recursion is one warp's
                work in tns_synthesis_lattice and one lane's chunk in
                tns_analysis_lattice: a time that stays as the streams grow
                is one warp's latency, a time that grows is the card's
                throughput. Then tns_filter_analysis (a warp a stream) on
                tests/torch_kernel_cases.py:tns_rows tiled, every stream with
                two filters, at 4, 32, 512 and 2048 streams.
  --analysis-variants  tns_filter_analysis built from changes of its header's
                text side by side (ANALYSIS_VARIANTS: the kept source, whose
                chain lanes divide their lags by the energy; the first warp
                design, where lanes 0 and 1 divide all of them; the kept
                source with the lag chains unrolled by 4) on tns_rows at 4
                and 2048 streams, checked against the plain version, graph
                ms.

    python3 tools/torch_tns_times.py [--streams 2048] [--frames 8] [--other DIR]
    python3 tools/torch_tns_times.py --step-bench --scaling --analysis-variants
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
from torch_dct4_times import NVCC_FLAGS, card, graph_ms, loop_ms, nvcc  # noqa: E402
from torch_ltpf_times import make_pcm, times  # noqa: E402

CSRC = ROOT / "audio_codec_torch" / "csrc"
OUT = ROOT / "build" / "tns_step_bench"

STEP_BENCH = r"""
#include "tns_lattice.cuh"
// One dependent chain p <- a p + b a thread, unrolled by 8; V 0: xfma on
// floats; 1: xfma_d on doubles; 2: a shuffle of p, then xfma_d; 3: rmul
// then radd on floats; 4: the lattices' fast step (tns_fma<false>, no
// branch); 5: a shuffle, then the fast step.
template <int V>
__global__ void bench(const double* ab, double* out, int iters) {
  const double a = ab[threadIdx.x % 7], b = ab[8 + threadIdx.x % 5];
  const float af = static_cast<float>(a), bf = static_cast<float>(b);
  double p = b;
  float pf = bf;
  bool far = false;
  for (int it = 0; it < iters; ++it) {
#pragma unroll
    for (int u = 0; u < 8; ++u) {
      if (V == 0) pf = acx::xfma(af, pf, bf);
      if (V == 1) p = acx::xfma_d(a, p, b);
      if (V == 2) p = acx::xfma_d(a, __shfl_down_sync(0xFFFFFFFFu, p, 1), b);
      if (V == 3) pf = acx::radd(acx::rmul(af, pf), bf);
      if (V == 4) p = acx::tns_fma<false>(a, p, b, far);
      if (V == 5) p = acx::tns_fma<false>(a, __shfl_down_sync(0xFFFFFFFFu, p, 1), b, far);
    }
  }
  out[blockIdx.x * blockDim.x + threadIdx.x] = p + pf + (far ? 1.0 : 0.0);
}
extern "C" int run(int v, const void* ab, void* out, int iters, int blocks, int threads,
                   void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const double* A = static_cast<const double*>(ab);
  double* O = static_cast<double*>(out);
  if (v == 0) bench<0><<<blocks, threads, 0, st>>>(A, O, iters);
  if (v == 1) bench<1><<<blocks, threads, 0, st>>>(A, O, iters);
  if (v == 2) bench<2><<<blocks, threads, 0, st>>>(A, O, iters);
  if (v == 3) bench<3><<<blocks, threads, 0, st>>>(A, O, iters);
  if (v == 4) bench<4><<<blocks, threads, 0, st>>>(A, O, iters);
  if (v == 5) bench<5><<<blocks, threads, 0, st>>>(A, O, iters);
  return static_cast<int>(cudaGetLastError());
}
"""
STEPS = ("xfma", "xfma_d", "shuffle + xfma_d", "rmul + radd", "fast xfma_d",
         "shuffle + fast xfma_d")


def step_bench() -> None:
    import torch
    shutil.rmtree(OUT, ignore_errors=True)
    OUT.mkdir(parents=True)
    (OUT / "bench.cu").write_text(STEP_BENCH)
    r = subprocess.run([nvcc(), *NVCC_FLAGS, f"-I{CSRC}", "-o", str(OUT / "bench.so"),
                        str(OUT / "bench.cu")], capture_output=True, text=True)
    if r.returncode:
        raise SystemExit(f"nvcc failed:\n{r.stdout}{r.stderr}")
    lib = ctypes.CDLL(str(OUT / "bench.so"))
    lib.run.argtypes = [ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
                        ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    ab = torch.linspace(0.5, 0.9, 16, dtype=torch.float64, device="cuda")
    out = torch.empty(132 * 512, dtype=torch.float64, device="cuda")
    iters = 2000
    for warps in (1, 16):
        for v, name in enumerate(STEPS):
            st = torch.cuda.current_stream().cuda_stream
            ms = min(loop_ms(lambda: lib.run(v, ab.data_ptr(), out.data_ptr(), iters, 132,
                                             32 * warps, st), 3) for _ in range(3))
            steps = 8 * iters
            print(f"[step] {card()} | {name}, {warps} warp(s) an SM: {ms * 1e6 / steps:.3f} ns a "
                  f"dependent step, {132 * 32 * warps * steps / ms / 1e9:.3f} T steps/s",
                  flush=True)


def scaling() -> None:
    import numpy as np
    import torch
    sys.path.insert(0, str(ROOT))
    from audio_codec_torch import kernels as K
    K.library()
    rng = np.random.default_rng(0)
    pts = np.float32([-0.9, -0.5, 0.3, 0.7])

    def rows(B: int, N: int, hull: int):
        t = lambda a, dt=torch.int32: torch.tensor(a, dtype=dt, device="cuda")
        half = hull // 2
        return (t(rng.standard_normal((B, N)) * 100, torch.float32),
                t(pts[rng.integers(0, 4, (B, 2, 8))], torch.float32),
                t(np.full((B, 2), 8)), t([[12, 12 + half]] * B), t([[11 + half, 11 + hull]] * B))
    for name, N in (("tns_synthesis_lattice", 400), ("tns_analysis_lattice", 480)):
        fn = getattr(K, name)
        for B, hull in ((4, 388), (32, 388), (512, 388), (2048, 388), (2048, 25), (2048, 50),
                        (2048, 100), (2048, 200)):
            args = rows(B, N, hull)
            ms = min(graph_ms(lambda: fn(*args)) for _ in range(3))
            print(f"[scaling] {card()} | {name}: {B} streams, hull {hull} bins: graph {ms:.5f} "
                  f"ms, {ms * 1e3 / hull:.4f} us a bin", flush=True)
    import audio_codec_torch as P
    from tests.torch_kernel_cases import tns_rows
    cfg = P.Config(fs_in=48000, bitrate=64000)
    x, _ = tns_rows(seed=2)
    for B in (4, 32, 512, 2048):
        idx = np.arange(B) % x.shape[0]
        args = (cfg, torch.tensor(x[idx], device="cuda"),
                torch.full((B,), 4, dtype=torch.int32, device="cuda"))
        ms = min(graph_ms(lambda: K.tns_filter_analysis(*args)) for _ in range(3))
        print(f"[scaling] {card()} | tns_filter_analysis: {B} streams of tns_rows, two filters "
              f"each: graph {ms:.5f} ms", flush=True)


# the gather of the first warp design: lanes 0 and 1 divide every chain by
# its energy
GATHER_LANES_01 = """#pragma unroll
  for (int sub = 0; sub < NSUB; ++sub) {
    const float e0 = w.shfl(acf0, sub * kLags), e1 = w.shfl(acf1, sub * kLags);
#pragma unroll
    for (int l = 0; l < kLags; ++l) {
      const float a0 = w.shfl(acf0, sub * kLags + l), a1 = w.shfl(acf1, sub * kLags + l);
      w.lanes([&](int ln) {
        if (ln < 2) {
          const float e = ln == 0 ? e0 : e1;
          const float den = e < static_cast<float>(1e-30) ? static_cast<float>(1e-30) : e;
          sum[ln].r[l] = radd(sum[ln].r[l], rdiv(ln == 0 ? a0 : a1, den));
          if (l == 0) sum[ln].dead = sum[ln].dead || e == 0.0f;
        }
      });
    }
  }
"""
# the kept gather (csrc/tns_analysis.cuh): the same quotients, each on its
# chain's lane, then lanes 0 and 1 add them
GATHER_KEPT_START = "  float den0[NSUB], den1[NSUB];\n"
GATHER_KEPT_END = "\n  typename W::template Lanes<TnsFilter> f;"


def gather_lanes_01(text: str) -> str:
    """tns_analysis.cuh with the first design's gather in place of the kept one."""
    i, j = text.index(GATHER_KEPT_START), text.index(GATHER_KEPT_END)
    return text[:i] + GATHER_LANES_01 + text[j:]


# tns_filter_analysis built from csrc/tns_analysis.cuh and changes of its text
ANALYSIS_VARIANTS = {
    "kept (quotients on the chain lanes)": lambda s: s,
    "quotients on lanes 0 and 1 (the first warp design)": gather_lanes_01,
    "kept, the lag chains unrolled by 4": lambda s: s.replace(
        "      for (int k = 0; k < n; ++k) {\n        if (k < n0)",
        "#pragma unroll 4\n      for (int k = 0; k < n; ++k) {\n        if (k < n0)", 1),
}


def analysis_variants() -> None:
    """tns_filter_analysis of each of ANALYSIS_VARIANTS, built side by side,
    on tns_rows tiled (every stream with two filters, and the rows' own
    bandwidths) at 4 and 2048 streams: differing values against the plain
    version and graph ms, two rounds."""
    import numpy as np
    import torch
    sys.path.insert(0, str(ROOT))
    import audio_codec_torch as P
    from audio_codec_torch import kernels as K
    from audio_codec_torch.ops import tns
    from tests.torch_kernel_cases import count_differing, tns_rows
    argtypes = K.library().acx_tns_filter_analysis.argtypes
    libs = {}
    for i, (name, change) in enumerate(ANALYSIS_VARIANTS.items()):
        d = OUT / "analysis_variants" / str(i)
        shutil.rmtree(d, ignore_errors=True)
        shutil.copytree(CSRC, d)
        text = (d / "tns_analysis.cuh").read_text()
        changed = change(text)
        if i > 0 and changed == text:
            raise SystemExit(f"{name}: the change does not apply to tns_analysis.cuh")
        (d / "tns_analysis.cuh").write_text(changed)
        r = subprocess.run([nvcc(), *NVCC_FLAGS, "-o", str(d / "lib.so"),
                            str(d / "tns_filter_analysis.cu")], capture_output=True, text=True)
        if r.returncode:
            raise SystemExit(f"nvcc failed on {name}:\n{r.stdout}{r.stderr}")
        libs[name] = ctypes.CDLL(str(d / "lib.so"))
        libs[name].acx_tns_filter_analysis.argtypes = argtypes
        libs[name].acx_tns_filter_analysis.restype = ctypes.c_int
    cfg = P.Config(fs_in=48000, bitrate=64000)
    x, bw = tns_rows(seed=2)
    library = K.library
    try:
        for rnd in range(2):
            for B in (4, 2048):
                idx = np.arange(B) % x.shape[0]
                for bws in ("two filters", "the rows' bandwidths"):
                    b = np.full(B, 4, np.int32) if bws == "two filters" else bw[idx]
                    args = (cfg, torch.tensor(x[idx], device="cuda"), torch.tensor(b, device="cuda"))
                    ref = tns.tns_filter_analysis_plain(*args)
                    for name, lib in libs.items():
                        K.library = lambda lib=lib: lib
                        differ = count_differing(K.tns_filter_analysis(*args), ref)
                        ms = min(graph_ms(lambda: K.tns_filter_analysis(*args)) for _ in range(3))
                        print(f"[analysis variants] {card()} | round {rnd}, {B} streams, {bws}, "
                              f"{name}: {differ} values differ from the plain version, graph "
                              f"{ms:.5f} ms", flush=True)
    finally:
        K.library = library


def stage_times(fn) -> dict:
    """times(fn), or the loop time alone where the stage cannot be captured
    in a CUDA graph."""
    import statistics
    try:
        return times(fn)
    except RuntimeError as e:
        return {"loop_ms": statistics.median(loop_ms(fn) for _ in range(5)), "graph_ms": None,
                "graph_error": str(e).splitlines()[0][:200]}


def measure(root: Path, B: int, T: int) -> dict:
    """The times of the checkout at root, in this process."""
    import torch
    pcm_np = make_pcm(T, B, 480)
    sys.path.insert(0, str(root))
    import audio_codec_torch as P
    from audio_codec_torch import kernels as K
    from audio_codec_torch.ops import tns
    from tests.torch_kernel_cases import count_differing

    K.library()
    cfg = P.Config(fs_in=48000, bitrate=64000)
    pcm = torch.from_numpy(pcm_np).cuda()
    stages = {"tns_encode": [], "tns_decode": []}
    kernels = {"tns_filter_analysis": [], "tns_analysis_lattice": [],
               "tns_synthesis_lattice": []}
    saved = {n: getattr(tns, n) for n in stages} | {n: getattr(K, n) for n in kernels}

    def recorder(store, fn):
        def rec(*a):
            store.append(a)
            return fn(*a)
        return rec
    for n in stages:
        setattr(tns, n, recorder(stages[n], saved[n]))
    for n in kernels:
        setattr(K, n, recorder(kernels[n], saved[n]))
    try:
        _, frames = P.encode_block(cfg, P.enc_state_init(cfg, B), pcm)
        P.decode_block(cfg, P.dec_state_init(cfg, B), frames)
    finally:
        for n, fn in saved.items():
            setattr(tns if n in stages else K, n, fn)
    torch.cuda.synchronize()
    out = {"root": str(root), "card": card(), "streams": B, "frames": T}
    for stage, kernel in (("tns_encode", "tns_filter_analysis"),
                          ("tns_encode", "tns_analysis_lattice"),
                          ("tns_decode", "tns_synthesis_lattice")):
        sargs, kargs = stages[stage][-1], kernels[kernel][-1]
        fn, plain = getattr(K, kernel), getattr(tns, kernel + "_plain")
        got, ref = fn(*kargs), plain(*kargs)
        torch.cuda.synchronize()
        orders = got[0] if kernel == "tns_filter_analysis" else kargs[2]
        orders = torch.bincount(orders.clamp(0, 8).flatten().long(), minlength=9).tolist()
        if stage not in out:
            out[stage] = stage_times(lambda: getattr(tns, stage)(*sargs))
        out[kernel] = {"differ": count_differing(got, ref), "orders_0_8": orders,
                       **times(lambda: fn(*kargs))}
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--streams", type=int, default=2048)
    ap.add_argument("--frames", type=int, default=8)
    ap.add_argument("--other", type=Path, default=None)
    ap.add_argument("--step-bench", action="store_true")
    ap.add_argument("--scaling", action="store_true")
    ap.add_argument("--analysis-variants", action="store_true")
    ap.add_argument("--root", type=Path, default=None, help=argparse.SUPPRESS)
    opt = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("torch_tns_times: no CUDA device")
    if opt.step_bench or opt.scaling or opt.analysis_variants:
        if opt.step_bench:
            step_bench()
        if opt.scaling:
            scaling()
        if opt.analysis_variants:
            analysis_variants()
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
