#!/usr/bin/env python3
"""Times the rate-path kernels of audio_codec_torch on a CUDA card: each
kernel (bit_estimate, ari_encode, gain_bisection) and its stage
(ops/quant.py:bit_estimate, ops/ari.py:encode,
ops/quant.py:estimate_global_gain) on the inputs the flagship path gives
them. Every line printed carries the card's name and power limit.

The inputs: chip_smoke.make_pcm's material (a third speech, a third music, a
third noise) at 48 kHz / 64 kbps, B streams, encoded for T frames by the
checkout's own encode_block; the arguments of the stages at the last frame
are recorded (bit_estimate twice a frame: modes -1 and 0), and those of the
kernel launches inside them. Each is timed as median loop ms (5 loops of 20
calls) and graph ms (20 calls replayed from a CUDA graph, the best of 3),
each kernel checked against its plain version bit for bit.

  (default)     this checkout, one JSON line.
  --other DIR   the same for a checkout of another commit (for example the
                parent unpacked with `git archive` into a directory that
                .gitignore lists), in turns with this one, each in a process
                of its own: other, this, this, other.
  --step-bench  the dependent steps alone, one chain a thread, at one warp
                and at 8 warps on each of 132 blocks: ns a symbol step of the
                range coder (csrc/ari_encode.cuh:enc_symbol with its
                renormalisations, on a cycle of the spectrum table's
                symbols; its byte stores go to one clipped byte of shared
                memory) and ns a tuple step of bit_estimate (be_tuple_bits
                and the context update, the tables in shared memory). K10's
                lane 0 runs one symbol step a coded symbol, so the symbol
                step times the symbols of a stream are its floor.
  --scaling     the three kernels at 4, 32, 512 and 2048 streams of the
                recorded flagship rows (tiled), and the range coders on
                all-busy rows (every tuple nonzero with an escape level,
                lastnz = N: bit_estimate at 64 kbps, ari_encode at 160 kbps,
                whose frame holds them): graph ms, and ari_encode's lane-0
                streams.
  --gain-variants  gain_bisection's warp designs built side by side
                (GAIN_VARIANTS): the kept one, two rounds of one chain a lane
                (the 31 offsets of halvings 1-5, then the 7 of halvings 6-8),
                each step's values computed and then selected, the block loop
                unrolled by 4; one round of all 255 offsets of the decision
                tree, 8 chains a lane interleaved; the two rounds with the
                first warp design's step (its conditions compiled to
                branches, which diverge), rolled and unrolled by 8; the kept
                step rolled; and the row staged with one ballot and no chain
                (the floor of the launch, the staging and the write); each
                bisection checked against the plain version and timed (graph
                ms, two rounds) at 4, 32, 512 and 2048 streams of the
                recorded flagship rows.
  --tables      both kernels with their tables read from global memory
                through L1 (the kept sources) and staged in shared memory
                once a block (TABLE_VARIANTS, text substitutions), built side
                by side, on the recorded launches: graph ms, two rounds.

    python3 tools/torch_coder_times.py [--streams 2048] [--frames 8] [--other DIR]
    python3 tools/torch_coder_times.py --step-bench --scaling --tables --gain-variants
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
from torch_tns_times import stage_times  # noqa: E402

CSRC = ROOT / "audio_codec_torch" / "csrc"
OUT = ROOT / "build" / "coder_times"

STEP_BENCH = r"""
#include "ari_encode.cuh"
// V 0: the range coder's symbol step, one chain a thread over 16 symbols of
// the spectrum table's row 0, the same in every lane (a frame of 64 bytes a
// thread in shared memory, every store clipped to its last byte once the
// pointer passes it);
// V 1: bit_estimate's tuple step, the context carried from tuple to tuple.
template <int V>
__global__ void bench(const int32_t* tabs, const int32_t* bits_g, int32_t* out, int iters) {
  __shared__ int32_t lookup[4096];
  __shared__ int32_t bits_tab[64 * 17];
  __shared__ uint8_t frames[8 * 32 * 64];
  for (int i = threadIdx.x; i < 4096; i += blockDim.x) lookup[i] = tabs[i];
  for (int i = threadIdx.x; i < 64 * 17; i += blockDim.x) bits_tab[i] = bits_g[i];
  __syncthreads();
  const int32_t* row = tabs + 4096;   // cumfreq row 0
  int acc = 0;
  if (V == 0) {
    acx::Enc e;
    e.buf = frames + threadIdx.x * 64;
    e.nbytes = 64;
    e.bp = 0;
    e.low = 0;
    e.range = acx::MASK24;
    e.cache = -1;
    e.carry = 0;
    e.cc = 0;
    int cum[16], freq[16];
#pragma unroll
    for (int s = 0; s < 16; ++s) {
      const int j = (s * 5) & 15;   // every lane the same symbols: no divergence
      cum[s] = row[j];
      freq[s] = (row[j + 1] - row[j]) | 1;
    }
    for (int it = 0; it < iters; ++it) {
#pragma unroll
      for (int s = 0; s < 16; ++s) acx::enc_symbol(e, freq[s], cum[s]);
    }
    acc = e.low + e.range + e.bp;
  } else {
    acx::BeTuple q[16];
#pragma unroll
    for (int s = 0; s < 16; ++s) {
      const int a = (s * 7) % 13, b = (s * 3) % 9;   // the same in every lane
      q[s].a = a;
      q[s].b = b;
      q[s].nlev = acx::escape_count(a, b);
      q[s].nl = q[s].nlev;
      q[s].aa = a >> q[s].nlev;
      q[s].bb = b >> q[s].nlev;
      q[s].tn = acx::tuple_tn(q[s].nlev, q[s].aa, q[s].bb);
    }
    int c = 0;
    for (int it = 0; it < iters; ++it) {
#pragma unroll
      for (int s = 0; s < 16; ++s) {
        int lsb;
        acc += acx::be_tuple_bits(q[s], c + (s > 8 ? 256 : 0), 0, lookup, bits_tab, lsb);
        c = (c & 15) * 16 + q[s].tn + (acc & 1);
      }
    }
  }
  out[blockIdx.x * blockDim.x + threadIdx.x] = acc;
}
extern "C" int run(int v, const void* tabs, const void* bits, void* out, int iters, int blocks,
                   int threads, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int32_t* T = static_cast<const int32_t*>(tabs);
  const int32_t* Bt = static_cast<const int32_t*>(bits);
  int32_t* O = static_cast<int32_t*>(out);
  if (v == 0) bench<0><<<blocks, threads, 0, st>>>(T, Bt, O, iters);
  if (v == 1) bench<1><<<blocks, threads, 0, st>>>(T, Bt, O, iters);
  return static_cast<int>(cudaGetLastError());
}
"""
STEPS = ("range coder symbol step (enc_symbol)", "bit_estimate tuple step (be_tuple_bits)")


def build_bench(d: Path, source: str) -> ctypes.CDLL:
    shutil.rmtree(d, ignore_errors=True)
    d.mkdir(parents=True)
    (d / "bench.cu").write_text(source)
    r = subprocess.run([nvcc(), *NVCC_FLAGS, f"-I{CSRC}", "-o", str(d / "bench.so"),
                        str(d / "bench.cu")], capture_output=True, text=True)
    if r.returncode:
        raise SystemExit(f"nvcc failed:\n{r.stdout}{r.stderr}")
    return ctypes.CDLL(str(d / "bench.so"))


def step_bench() -> None:
    import torch
    sys.path.insert(0, str(ROOT))
    from audio_codec_torch import kernels as K
    lib = build_bench(OUT / "step_bench", STEP_BENCH)
    lib.run.argtypes = [ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    tabs = K._coder_tables("cuda")
    bits = K._bits_tables("cuda")[1]
    out = torch.empty(132 * 256, dtype=torch.int32, device="cuda")
    iters = 500
    for warps in (1, 8):
        for v, name in enumerate(STEPS):
            st = torch.cuda.current_stream().cuda_stream
            ms = min(loop_ms(lambda: lib.run(v, tabs.data_ptr(), bits.data_ptr(), out.data_ptr(),
                                             iters, 132, 32 * warps, st), 3) for _ in range(3))
            steps = 16 * iters
            print(f"[step] {card()} | {name}, {warps} warp(s) an SM: {ms * 1e6 / steps:.3f} ns a "
                  f"dependent step", flush=True)


def record_launches(B: int, T: int):
    """The flagship's T-frame encode of B streams: (cfg, its stage calls,
    its kernel launches, the stage and kernel functions), the calls as
    {name: [(args, kwargs), ...]}."""
    import torch
    import audio_codec_torch as P
    from audio_codec_torch import kernels as K
    from audio_codec_torch.ops import ari, quant
    cfg = P.Config(fs_in=48000, bitrate=64000)
    pcm = torch.from_numpy(make_pcm(T, B, 480)).cuda()
    stages = {"quant.bit_estimate": [], "ari.encode": [], "quant.estimate_global_gain": []}
    kernels = {"bit_estimate": [], "ari_encode": [], "gain_bisection": []}
    mods = {"quant.bit_estimate": (quant, "bit_estimate"), "ari.encode": (ari, "encode"),
            "quant.estimate_global_gain": (quant, "estimate_global_gain"),
            "bit_estimate": (K, "bit_estimate"), "ari_encode": (K, "ari_encode"),
            "gain_bisection": (K, "gain_bisection")}
    saved = {n: getattr(m, a) for n, (m, a) in mods.items()}

    def recorder(store, fn):
        def rec(*a, **kw):
            store.append((a, kw))
            return fn(*a, **kw)
        return rec
    for n, (m, a) in mods.items():
        setattr(m, a, recorder((stages | kernels)[n], saved[n]))
    try:
        P.encode_block(cfg, P.enc_state_init(cfg, B), pcm)
    finally:
        for n, (m, a) in mods.items():
            setattr(m, a, saved[n])
    torch.cuda.synchronize()
    return cfg, stages, kernels, saved


def measure(root: Path, B: int, T: int) -> dict:
    """The times of the checkout at root, in this process."""
    import torch
    sys.path.insert(0, str(root))
    from audio_codec_torch import kernels as K
    from audio_codec_torch.ops import ari, quant
    from tests.torch_kernel_cases import count_differing

    K.library()
    cfg, stages, kernels, fns = record_launches(B, T)
    out = {"root": str(root), "card": card(), "streams": B, "frames": T}
    plain = {"bit_estimate": quant.bit_estimate_plain, "ari_encode": ari.encode_plain,
             "gain_bisection": quant.gain_bisection_plain}
    # the last frame: bit_estimate in modes -1 and cfg.modeFlag, one
    # ari_encode, one gain_bisection
    for tag, stage, kernel, back in (("bit_estimate mode -1", "quant.bit_estimate",
                                      "bit_estimate", 2),
                                     (f"bit_estimate mode {cfg.modeFlag}",
                                      "quant.bit_estimate", "bit_estimate", 1),
                                     ("ari_encode", "ari.encode", "ari_encode", 1),
                                     ("gain_bisection", "quant.estimate_global_gain",
                                      "gain_bisection", 1)):
        (sargs, skw), (kargs, kkw) = stages[stage][-back], kernels[kernel][-back]
        lane0 = None
        if hasattr(K, "reset_ari_encode_lane0_streams") and kernel == "ari_encode":
            K.reset_ari_encode_lane0_streams("cuda")
        got, ref = fns[kernel](*kargs, **kkw), plain[kernel](*kargs, **kkw)
        torch.cuda.synchronize()
        if hasattr(K, "ari_encode_lane0_streams") and kernel == "ari_encode":
            lane0 = K.ari_encode_lane0_streams("cuda")
        out[tag] = {"differ": count_differing(got, ref), "lane0_streams": lane0,
                    "kernel": times(lambda: fns[kernel](*kargs, **kkw)),
                    "stage": stage_times(lambda: fns[stage](*sargs, **skw))}
    return out


def busy_rows(cfg, B: int, seed: int = 0):
    """[B, N] int32 rows on the card whose every tuple is nonzero with one
    escape level (magnitudes 4-7 beside 0-3)."""
    import numpy as np
    import torch
    rng = np.random.default_rng(seed)
    x = rng.integers(0, 4, (B, cfg.yLen))
    x[:, 0::2] = rng.integers(4, 8, (B, cfg.yLen // 2))
    x *= np.where(rng.random(x.shape) < 0.5, -1, 1)
    return torch.from_numpy(x.astype(np.int32)).cuda()


def scaling(B: int, T: int) -> None:
    import torch
    sys.path.insert(0, str(ROOT))
    import audio_codec_torch as P
    from audio_codec_torch import kernels as K
    from audio_codec_torch.ops import bits
    K.library()
    cfg, _, kernels, _ = record_launches(B, T)
    be, ae = kernels["bit_estimate"][-1][0], kernels["ari_encode"][-1][0]
    gb = kernels["gain_bisection"][-1][0]

    def tile(a, n):
        if not isinstance(a, torch.Tensor) or a.dim() == 0:
            return a
        idx = torch.arange(n, device=a.device) % a.shape[0]
        return a[idx].contiguous()
    for n in (4, 32, 512, 2048):
        a = tuple(tile(v, n) for v in be)
        ms = min(graph_ms(lambda: K.bit_estimate(*a)) for _ in range(3))
        print(f"[scaling] {card()} | bit_estimate: {n} streams of the flagship rows: graph "
              f"{ms:.5f} ms", flush=True)
        a = tuple(tile(v, n) for v in ae)
        K.reset_ari_encode_lane0_streams("cuda")
        K.ari_encode(*a)
        lane0 = K.ari_encode_lane0_streams("cuda")
        ms = min(graph_ms(lambda: K.ari_encode(*a)) for _ in range(3))
        print(f"[scaling] {card()} | ari_encode: {n} streams of the flagship rows: graph "
              f"{ms:.5f} ms, lane-0 streams {lane0}", flush=True)
        a = tuple(tile(v, n) for v in gb)
        ms = min(graph_ms(lambda: K.gain_bisection(*a)) for _ in range(3))
        print(f"[scaling] {card()} | gain_bisection: {n} streams of the flagship rows (M = "
              f"{gb[0].shape[1]}): graph {ms:.5f} ms", flush=True)
    # all-busy rows
    cfg160 = P.Config(fs_in=48000, bitrate=160000)
    for n in (4, 32, 512, 2048):
        x = busy_rows(cfg, n)
        tgt = torch.full((n,), 10 ** 6, dtype=torch.int32, device="cuda")
        ms = min(graph_ms(lambda: K.bit_estimate(cfg, x, tgt, 0)) for _ in range(3))
        print(f"[scaling] {card()} | bit_estimate: {n} all-busy streams (200 tuples with "
              f"escapes): graph {ms:.5f} ms", flush=True)
        x = busy_rows(cfg160, n, seed=1)
        z = lambda v: torch.full((n,), v, dtype=torch.int32, device="cuda")
        buf, bp, mask = bits.pack_side_info(
            cfg160, z(4), z(cfg160.yLen), z(0), z(170), z(1),
            torch.zeros((n, 2), dtype=torch.int32, device="cuda"),
            torch.zeros((n, 3), dtype=torch.int32, device="cuda"),
            torch.zeros((n, 7), dtype=torch.int32, device="cuda"), z(3))
        args = (cfg160, buf, bp, mask, x, torch.zeros((n, 2), dtype=torch.int32, device="cuda"),
                torch.zeros((n, 2, 8), dtype=torch.int32, device="cuda"), z(1), z(cfg160.yLen),
                z(0), torch.zeros((n, cfg160.yLen), dtype=torch.int32, device="cuda"), z(0))
        K.reset_ari_encode_lane0_streams("cuda")
        K.ari_encode(*args)
        lane0 = K.ari_encode_lane0_streams("cuda")
        ms = min(graph_ms(lambda: K.ari_encode(*args)) for _ in range(3))
        print(f"[scaling] {card()} | ari_encode at 160 kbps: {n} all-busy streams (200 tuples "
              f"with escapes): graph {ms:.5f} ms, lane-0 streams {lane0}", flush=True)


# the kept sources read their tables from global memory through L1; these
# substitutions stage them in shared memory once a block instead
TABLE_VARIANTS = {
    "bit_estimate.cu": (
        ("  extern __shared__ int32_t rows[];\n",
         "  extern __shared__ int32_t smem[];\n"
         "  acx_load_shared(smem, lookup, 4096);\n"
         "  acx_load_shared(smem + 4096, bits_tab, 64 * 17);\n"
         "  __syncthreads();\n"
         "  lookup = smem;\n"
         "  bits_tab = smem + 4096;\n"
         "  int32_t* rows = smem + 4096 + 64 * 17;\n"),
        ("const size_t smem = static_cast<size_t>(kBitEstWarps) * N * sizeof(int32_t);",
         "const size_t smem = (4096 + 64 * 17 + static_cast<size_t>(kBitEstWarps) * N) * "
         "sizeof(int32_t);")),
    "ari_encode.cu": (
        ("  const int32_t* tab = tabs;\n  int32_t* warps = smem;\n",
         "  acx_load_shared(smem, tabs, 5410);\n  __syncthreads();\n"
         "  const int32_t* tab = smem;\n  int32_t* warps = smem + 5410;\n"),
        ("const size_t smem = static_cast<size_t>(kAriEncWarps) * ari_warp_words(N, nbytes) *",
         "const size_t smem = (5410 + static_cast<size_t>(kAriEncWarps) * "
         "ari_warp_words(N, nbytes)) *")),
}


def build_variant(name: str, source: str, subs) -> ctypes.CDLL:
    """A library of csrc/<source> alone with the text substitutions subs."""
    d = OUT / "tables" / name
    shutil.rmtree(d, ignore_errors=True)
    d.mkdir(parents=True)
    for f in ("acodec.cuh", "warp.cuh", "bit_estimate.cuh", "ari_encode.cuh"):
        shutil.copy(CSRC / f, d / f)
    text = (CSRC / source).read_text()
    for old, new in subs:
        if old not in text:
            raise SystemExit(f"{name}: {old!r} is not in {source}")
        text = text.replace(old, new)
    (d / source).write_text(text)
    r = subprocess.run([nvcc(), *NVCC_FLAGS, "-o", str(d / "lib.so"), str(d / source)],
                       capture_output=True, text=True)
    if r.returncode:
        raise SystemExit(f"nvcc failed on {name}:\n{r.stdout}{r.stderr}")
    return ctypes.CDLL(str(d / "lib.so"))


def tables(B: int, T: int) -> None:
    """Both kernels with their tables read through L1 (the kept sources) and
    staged in shared memory once a block, built side by side and run on the
    recorded launches."""
    import torch
    sys.path.insert(0, str(ROOT))
    from audio_codec_torch import kernels as K
    from audio_codec_torch.ops import ari, quant
    K.library()
    cfg, _, kernels, _ = record_launches(B, T)
    P_, I_ = ctypes.c_void_p, ctypes.c_int
    libs = {}
    for source, subs in TABLE_VARIANTS.items():
        for where, sub in (("L1", ()), ("shared", subs)):
            lib = build_variant(f"{source[:-3]}_{where}", source, sub)
            if source == "bit_estimate.cu":
                lib.acx_bit_estimate.argtypes = [P_] * 5 + [I_] * 5 + [P_]
            else:
                lib.acx_ari_encode.argtypes = [P_] * 14 + [I_] * 8 + [P_]
            libs[(source, where)] = lib
    lookup, bits_tab = K._bits_tables("cuda")
    tabs = K._coder_tables("cuda")
    counter = torch.zeros(1, dtype=torch.int32, device="cuda")
    st = lambda: torch.cuda.current_stream().cuda_stream
    calls = []
    for args, _ in kernels["bit_estimate"][-2:]:
        _, xq, target, mode = args
        n, N = xq.shape
        tgt = target.to(torch.int32).expand(n).contiguous()
        o = torch.empty((5, n), dtype=torch.int32, device="cuda")
        ref = quant.bit_estimate_plain(*args)
        ref = torch.stack([ref[k] for k in ("nbits", "nbits2", "lastnz", "lastnz2", "lsbMode")])
        calls.append(("bit_estimate.cu", f"mode {mode}", o, ref,
                      lambda lib, xq=xq, tgt=tgt, o=o, n=n, N=N, mode=mode: lib.acx_bit_estimate(
                          xq.data_ptr(), tgt.data_ptr(), o.data_ptr(), lookup.data_ptr(),
                          bits_tab.data_ptr(), n, N, mode, cfg.rateFlag, 14, st())))
    args = kernels["ari_encode"][-1][0]
    c, buf, bp, mask, xq, order, idx, num_tns, lastnz, lsb, res, n_res = args
    buf, order, idx, res = (t.to(torch.int32).contiguous() for t in (buf, order, idx, res))
    n, N = xq.shape
    side = [K._i32(v, n, xq.device) for v in (bp, mask, num_tns, lastnz, lsb, n_res)]
    o = torch.empty_like(buf)
    calls.append(("ari_encode.cu", "", o, ari.encode_plain(*args),
                  lambda lib: lib.acx_ari_encode(
                      buf.data_ptr(), o.data_ptr(), xq.data_ptr(), *(v.data_ptr() for v in side),
                      order.data_ptr(), idx.data_ptr(), res.data_ptr(), tabs.data_ptr(),
                      counter.data_ptr(), n, N, buf.shape[1], res.shape[1], 14, c.rateFlag,
                      1 if c.enable_lpc_weighting else 0, c.targetBitsAri, st())))
    for rnd in range(2):
        for source, what, o, ref, call in calls:
            for where in ("L1", "shared"):
                lib = libs[(source, where)]
                rc = call(lib)
                torch.cuda.synchronize()
                differ = int((o != ref).sum())
                ms = min(graph_ms(lambda: call(lib)) for _ in range(3))
                print(f"[tables] {card()} | round {rnd} {source[:-3]} {what} tables {where}: rc "
                      f"{rc}, {differ} values differ from the plain version, graph {ms:.5f} ms",
                      flush=True)


# gain_bisection's warp designs: V 0 the kept one
# (gain_bisection.cuh:gain_bisection_warp: two rounds of one chain a lane,
# every value of a step computed and then selected, the block loop unrolled
# by 4), V 1 one round of every node of the decision tree, 8 chains a lane,
# V 2-3 the two rounds with the first warp design's step, V 4 the kept step
# not unrolled, V 5 the floor (the row staged, one ballot, no chain)
GAIN_VARIANTS = r"""
#include "gain_bisection.cuh"
using namespace acx;

// all 255 nodes at once: node ln + 1 + 32 c on lane ln (c = 0..7; lane 31's
// last chain repeats node 255, and the walk never reads its bit), one
// ballot a chain, an 8-level walk
__device__ int gain_bisection_all(int lane, const float* en, int M, float target, int offset0) {
  int offs[8];
  bool pass[8];
#pragma unroll
  for (int c = 0; c < 8; ++c) offs[c] = gain_node_test(offset0, 8, imin(lane + 1 + 32 * c, 255));
  gain_tests<8>(en, M, target, offs, pass);
  unsigned mask[8];
#pragma unroll
  for (int c = 0; c < 8; ++c) mask[c] = __ballot_sync(0xFFFFFFFFu, pass[c]);
  int h = 1;
  for (int k = 0; k < 8; ++k) {
    const int i = h - 1;
    unsigned word = 0u;
#pragma unroll
    for (int c = 0; c < 8; ++c) word = c == (i >> 5) ? mask[c] : word;
    h = 2 * h + static_cast<int>((word >> (i & 31)) & 1u);
  }
  return gain_node_offset(offset0, 8, h);
}

// the first warp design's step (its conditions as nvcc compiled them: a
// branch each), the block loop unrolled U times
template <int U>
__device__ bool gain_test_branches(const float* en, int M, float target, int offset) {
  const float offs_f = static_cast<float>(offset);
  float ener = 0.0f;
  bool iszero = true;
#pragma unroll (U)
  for (int j = M - 1; j >= 0; --j) {
    const float t = rsub(en[j], offs_f);
    const bool low = t < kGainLow;
    const float add = low ? ((!iszero) ? kGainGap : 0.0f)
                          : (t >= kGainHigh ? rsub(rmul(2.0f, t), kGainHigh) : t);
    ener = radd(ener, add);
    iszero = iszero && low;
  }
  return ener > target && !iszero;
}

// the kept step, the block loop not unrolled
__device__ bool gain_test_rolled(const float* en, int M, float target, int offset) {
  const float offs_f = static_cast<float>(offset);
  float ener = 0.0f;
  unsigned iszero = 1u;
#pragma unroll 1
  for (int j = M - 1; j >= 0; --j) {
    const float t = rsub(en[j], offs_f);
    const float high = rsub(rmul(2.0f, t), kGainHigh);
    const unsigned low = t < kGainLow ? 1u : 0u;
    const float above = t >= kGainHigh ? high : t;
    const float gap = iszero != 0u ? 0.0f : kGainGap;
    ener = radd(ener, low != 0u ? gap : above);
    iszero &= low;
  }
  return ener > target && iszero == 0u;
}

// the kept two rounds over another step (S 1: the first design's, unrolled
// U times; S 2: the kept step not unrolled)
template <int S, int U>
__device__ int gain_bisection_step(int lane, const float* en, int M, float target, int offset0) {
  auto test = [&](int offset) {
    return S == 1 ? gain_test_branches<U>(en, M, target, offset)
                  : gain_test_rolled(en, M, target, offset);
  };
  const bool pa = lane < 31 && test(gain_node_test(offset0, 8, lane + 1));
  const int o5 = gain_node_offset(offset0, 8, gain_walk(__ballot_sync(0xFFFFFFFFu, pa), 1, 5));
  const bool pb = lane < 7 && test(gain_node_test(o5, 3, lane + 1));
  return gain_node_offset(o5, 3, gain_walk(__ballot_sync(0xFFFFFFFFu, pb), 1, 3));
}

template <int V>
__global__ void __launch_bounds__(256) kernel(const float* en, const float* target, int* out,
                                              int B, int M, int offset0) {
  extern __shared__ float rows[];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int s = blockIdx.x * 8 + warp;
  if (s >= B) return;
  float* row = rows + static_cast<size_t>(warp) * M;
  for (int i = lane; i < M; i += 32) row[i] = en[static_cast<size_t>(s) * M + i];
  __syncwarp();
  int o = 0;
  if (V == 0) o = gain_bisection_warp(CoderCardWarp{lane}, row, M, target[s], offset0);
  if (V == 1) o = gain_bisection_all(lane, row, M, target[s], offset0);
  if (V == 2) o = gain_bisection_step<1, 1>(lane, row, M, target[s], offset0);
  if (V == 3) o = gain_bisection_step<1, 8>(lane, row, M, target[s], offset0);
  if (V == 4) o = gain_bisection_step<2, 1>(lane, row, M, target[s], offset0);
  if (V == 5) o = __ballot_sync(0xFFFFFFFFu, row[lane % M] > target[s]);   // no chain: the floor
  if (lane == 0) out[s] = o;
}
extern "C" int run(int v, const void* en, const void* target, void* out, int B, int M,
                   int offset0, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const size_t smem = 8 * static_cast<size_t>(M) * sizeof(float);
  const int blocks = (B + 7) / 8;
  const float* E = static_cast<const float*>(en);
  const float* T = static_cast<const float*>(target);
  int* O = static_cast<int*>(out);
  if (v == 0) kernel<0><<<blocks, 256, smem, st>>>(E, T, O, B, M, offset0);
  if (v == 1) kernel<1><<<blocks, 256, smem, st>>>(E, T, O, B, M, offset0);
  if (v == 2) kernel<2><<<blocks, 256, smem, st>>>(E, T, O, B, M, offset0);
  if (v == 3) kernel<3><<<blocks, 256, smem, st>>>(E, T, O, B, M, offset0);
  if (v == 4) kernel<4><<<blocks, 256, smem, st>>>(E, T, O, B, M, offset0);
  if (v == 5) kernel<5><<<blocks, 256, smem, st>>>(E, T, O, B, M, offset0);
  return static_cast<int>(cudaGetLastError());
}
"""
GAIN_DESIGNS = ("kept: two rounds (31 + 7 nodes, one chain a lane), steps selected, unrolled by 4",
                "one round (255 nodes, 8 chains a lane)",
                "two rounds, the first design's step (a branch a condition)",
                "two rounds, the first design's step, unrolled by 8",
                "two rounds, the kept step not unrolled",
                "the row staged and one ballot, no chain (the floor; not a bisection)")


def gain_variants(B: int, T: int) -> None:
    import torch
    sys.path.insert(0, str(ROOT))
    from audio_codec_torch.ops import quant
    lib = build_bench(OUT / "gain_variants", GAIN_VARIANTS)
    lib.run.argtypes = [ctypes.c_int] + [ctypes.c_void_p] * 3 + [ctypes.c_int] * 3 + \
        [ctypes.c_void_p]
    _, _, kernels, _ = record_launches(B, T)
    en, target, offset0 = kernels["gain_bisection"][-1][0]
    st = lambda: torch.cuda.current_stream().cuda_stream
    for rnd in range(2):
        for n in (4, 32, 512, 2048):
            idx = torch.arange(n, device="cuda") % en.shape[0]
            e, tg = en[idx].contiguous(), target[idx].contiguous()
            ref = quant.gain_bisection_plain(e, tg, offset0)
            out = torch.empty(n, dtype=torch.int32, device="cuda")
            for v, name in enumerate(GAIN_DESIGNS):
                call = lambda: lib.run(v, e.data_ptr(), tg.data_ptr(), out.data_ptr(), n,
                                       e.shape[1], offset0, st())
                rc = call()
                torch.cuda.synchronize()
                differ = None if v == 5 else int((out != ref).sum())
                ms = min(graph_ms(call) for _ in range(3))
                print(f"[gain variants] {card()} | round {rnd}, {n} streams, {name}: rc {rc}, "
                      f"{differ} offsets differ from the plain version, graph {ms:.5f} ms",
                      flush=True)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--streams", type=int, default=2048)
    ap.add_argument("--frames", type=int, default=8)
    ap.add_argument("--other", type=Path, default=None)
    ap.add_argument("--step-bench", action="store_true")
    ap.add_argument("--scaling", action="store_true")
    ap.add_argument("--tables", action="store_true")
    ap.add_argument("--gain-variants", action="store_true")
    ap.add_argument("--root", type=Path, default=None, help=argparse.SUPPRESS)
    opt = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("torch_coder_times: no CUDA device")
    if opt.step_bench or opt.scaling or opt.tables or opt.gain_variants:
        if opt.step_bench:
            step_bench()
        if opt.scaling:
            scaling(opt.streams, opt.frames)
        if opt.tables:
            tables(opt.streams, opt.frames)
        if opt.gain_variants:
            gain_variants(opt.streams, opt.frames)
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
