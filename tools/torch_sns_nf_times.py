#!/usr/bin/env python3
"""Times the SNS quantizer's encoder and the noise factor and residual coder
of audio_codec_torch on a CUDA card: the kernels `sns_vq_enc`
(csrc/sns_vq_enc.cu) and `noise_residual_enc` (csrc/noise_residual_enc.cu)
and their stages (ops/sns.py:quantize_scf_enc, ops/quant.py:
noise_residual_enc) on the inputs the flagship path gives them, the
kernels that stage their tables through csrc/acodec.cuh:acx_load_shared
(`tns_filter_analysis`, `fec_encode`, `fec_decode`) and `sns_vq_dec` (which
read its tables through L1 from its redesign on; tools/torch_spec_dec_times.py
times it with the decoder's inputs). Every line printed carries the card's
name and power limit.

The inputs: chip_smoke.make_pcm's material at 48 kHz / 64 kbps, B streams,
encoded for T frames by the checkout's own encode_block; the arguments of
the stages and kernels at the last frame are recorded. `sns_vq_dec` decodes
the recorded `sns_vq_enc` output, `fec_encode` codes tests/torch_kernel_cases
.py:fec_rows (80-byte slot, EP1-4, tiled to B rows) and `fec_decode` decodes
what it coded. Each is timed as median loop ms (5 loops of 20 calls) and
graph ms (20 calls replayed from a CUDA graph, the best of 3), each kernel
checked against its plain version bit for bit.

  (default)     this checkout, one JSON line.
  --other DIR   the same for a checkout of another commit (the parent
                unpacked with `git archive` into a directory that .gitignore
                lists), in turns with this one, each in a process of its
                own: other, this, this, other.
  --phases DIR  the first designs of the two kernels in the checkout DIR
                (sns_vq_enc a thread a stream, noise_residual_enc a warp a
                stream with lane 0's chain), each with one phase removed
                (PHASES_FIRST), built from DIR's sources with text
                substitutions: graph ms at B streams, two rounds.
  --variants    this checkout's kept designs at other block sizes and with
                their other choices, and with one phase removed at a time
                (VARIANTS), built from this checkout's sources with text
                substitutions: graph ms at B streams and at 1, two rounds.
  --step-bench  ns a step of the pulse search's best-position scan (16
                positions, csrc/sns_vq_enc.cuh:pvq_scan) and of the noise
                factor's chain (csrc/noise_residual_enc.cuh:nf_chain), each
                the difference of two lengths, so that the staging drops out.
  --scaling     both kernels at 4, 32, 512 and 2048 streams of the recorded
                rows (tiled): graph ms.

    python3 tools/torch_sns_nf_times.py [--streams 2048] [--frames 8] [--other DIR]
    python3 tools/torch_sns_nf_times.py --phases DIR --variants --step-bench --scaling
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
OUT = ROOT / "build" / "sns_nf_times"
P_, I_ = ctypes.c_void_p, ctypes.c_int
ARGTYPES = {"sns_vq_enc": [P_] * 4 + [I_] + [P_],
            "noise_residual_enc": [P_] * 10 + [I_] * 6 + [P_]}

# the first designs with one phase removed: text substitutions (file, old,
# new) of the sources of the checkout given to --phases
_ENC_LANE = "  sns_vq_enc_lane(in, sns_tables(tab), idx, q);\n"
_ENC_STAGE = "  acx_load_shared(tab, tables, kSnsTableWords);\n  __syncthreads();\n"
_PULSE_LOOP = "    for (int p = 0; p < PULSES && pulse_tot < static_cast<float>(PULSES); ++p) {"
_NF_INDEX = "    fac_ns_idx[b] = nf_enc_index(v, g.N, kcnt, mid, nlo, g);\n"
_NF_WINDOW = "    if (xq[imin(i, g.N - 1)] != 0) return false;\n"
_NF_RES = "    if (nz && rank < g.max_res) {\n"
PHASES_FIRST = {
    "sns_vq_enc": {
        "first design as it is": (),
        "staging alone (the tables staged, the row read and written, no search)": (
            ("sns_vq_enc.cu", _ENC_LANE, "  for (int k = 0; k < 7; ++k) idx[k] = tab[k];\n"
                                         "  for (int i = 0; i < kSnsM; ++i) q[i] = in[i];\n"),),
        "no staging (the search reads its tables through L1)": (
            ("sns_vq_enc.cu", _ENC_STAGE, ""),
            ("sns_vq_enc.cu", "sns_tables(tab)", "sns_tables(tables)")),
        "no pulse loops (the projections only)": (
            ("sns_vq.cuh", _PULSE_LOOP, "    for (int p = 0; p < 0; ++p) {"),),
        "no staging, no pulse loops": (
            ("sns_vq_enc.cu", _ENC_STAGE, ""),
            ("sns_vq_enc.cu", "sns_tables(tab)", "sns_tables(tables)"),
            ("sns_vq.cuh", _PULSE_LOOP, "    for (int p = 0; p < 0; ++p) {")),
    },
    "noise_residual_enc": {
        "first design as it is": (),
        "no chain (lane 0's index from a sum of its inputs)": (
            ("noise_residual_enc.cu", _NF_INDEX,
             "    fac_ns_idx[b] = nlo + mid + static_cast<int>(v[0]);\n"),),
        "no zero-line reads (the window tested without reading xq)": (
            ("noise_residual_enc.cuh", _NF_WINDOW, "    if (i < 0) return false;\n"),),
        "no residual bits written": (
            ("noise_residual_enc.cu", _NF_RES, "    if (nz && rank < 0) {\n"),),
        "no chain, no zero-line reads": (
            ("noise_residual_enc.cu", _NF_INDEX,
             "    fac_ns_idx[b] = nlo + mid + static_cast<int>(v[0]);\n"),
            ("noise_residual_enc.cuh", _NF_WINDOW, "    if (i < 0) return false;\n")),
    },
}

# the kept designs at other block sizes, with their other choices, and with
# one phase removed: text substitutions (file, old, new) of this checkout
_ENC_WARPS = "constexpr int kSnsEncWarps = 4;"
_NF_WARPS = "constexpr int kNfWarps = 4;"
_LOAD_ROUND = """  for (int i0 = threadIdx.x; i0 < n; i0 += kAcxLoadRound * blockDim.x) {
    int32_t v[kAcxLoadRound];
#pragma unroll
    for (int u = 0; u < kAcxLoadRound; ++u) {
      const int i = i0 + u * static_cast<int>(blockDim.x);
      v[u] = i < n ? __ldg(src + i) : 0;
    }
#pragma unroll
    for (int u = 0; u < kAcxLoadRound; ++u) {
      const int i = i0 + u * static_cast<int>(blockDim.x);
      if (i < n) dst[i] = v[u];
    }
  }
"""
_LOAD_ONE = "  for (int i = threadIdx.x; i < n; i += blockDim.x) dst[i] = src[i];\n"
_ENC_CALL = "  sns_vq_enc_warp(CoderCardWarp{lane},"
_NF_STORE = "      if (zero_line) vz[kcnt + popc32(zm[c] & before)] = v;\n"
_NF_BOUNDS = "  const int n_all = kcnt, n_lo = nlo;"
_NF_CHAIN = "    sums[ln] = nf_chain(vz, lo, hi);"
_NF_RES_KEPT = "      if (q != 0 && rank < g.max_res) res[rank] = bit;"
_SCAN = """  for (int i = 0; i < kSnsM; ++i) {
    const float n = xy2[i], d = yyt[i];
    const bool better = i < dim && rmul(n, bd) > rmul(d, bn);
    best = better ? i : best;
    bn = better ? n : bn;
    bd = better ? d : bd;
  }
"""
_SCAN2 = """  for (int i = 0; i < kSnsM; i += 2) {
    const float n0 = xy2[i], d0 = yyt[i], n1 = xy2[i + 1], d1 = yyt[i + 1];
    const bool t0 = i < dim && rmul(n0, bd) > rmul(d0, bn);
    const bool keep1 = i + 1 < dim && rmul(n1, bd) > rmul(d1, bn);
    const bool take1 = i + 1 < dim && rmul(n1, d0) > rmul(d1, n0);
    const bool t1 = t0 ? take1 : keep1;
    best = t1 ? i + 1 : (t0 ? i : best);
    bn = t1 ? n1 : (t0 ? n0 : bn);
    bd = t1 ? d1 : (t0 ? d0 : bd);
  }
"""
_NF_ZERO = """    w.lanes([&](int ln) {
      const int k = 32 * c + ln;
      z[ln] = (k >= g.start && k < bw && nf_window_clear(prev, nzb[c], next, ln, g.width)) ? 1 : 0;
    });
"""
_NF_DILATED = """    uint32_t near = nzb[c];
    for (int s = 1; s <= g.width; ++s) {
      near |= static_cast<uint32_t>(((static_cast<uint64_t>(nzb[c]) << 32) | prev) >> (32 - s));
      near |= static_cast<uint32_t>(((static_cast<uint64_t>(next) << 32) | nzb[c]) >> s);
    }
    w.lanes([&](int ln) {
      const int k = 32 * c + ln;
      z[ln] = (k >= g.start && k < bw && ((near >> ln) & 1u) == 0u) ? 1 : 0;
    });
"""
_NF_SELECTED = """      const float v = fabsf(rdiv(row[ln].x[c], gain));
      if (zero_line) vz[kcnt + popc32(zm[c] & before)] = v;
      lines[ln] += zero_line ? static_cast<unsigned>(32 * c + ln + 1) : 0u;
"""
_NF_BRANCHED = """      if (zero_line) {
        vz[kcnt + popc32(zm[c] & before)] = fabsf(rdiv(row[ln].x[c], gain));
        lines[ln] += static_cast<unsigned>(32 * c + ln + 1);
      }
"""
VARIANTS = {
    "sns_vq_enc": {
        "kept: a warp a stream, blocks of 4 warps": (),
        "blocks of 2 warps": (("sns_vq_enc.cu", _ENC_WARPS, "constexpr int kSnsEncWarps = 2;"),),
        "blocks of 8 warps": (("sns_vq_enc.cu", _ENC_WARPS, "constexpr int kSnsEncWarps = 8;"),),
        "the tables staged one load in flight a thread (the first acx_load_shared)": (
            ("acodec.cuh", _LOAD_ROUND, _LOAD_ONE),),
        "the scan two positions a step (position i + 1 also compared with i)": (
            ("sns_vq_enc.cuh", _SCAN, _SCAN2),),
        "phase cut: staging alone (no warp step)": (
            ("sns_vq_enc.cu", _ENC_CALL, "  if (lane < 7) scf_idx[7 * b + lane] = tab[lane];\n"
                                         "  if (B < 0) sns_vq_enc_warp(CoderCardWarp{lane},"),),
        "phase cut: no pulse loop (the projections only)": (
            ("sns_vq_enc.cuh", "  for (int p = 0; p < kPvqMaxPulses; ++p) {",
             "  for (int p = 0; p < 0; ++p) {"),),
        "phase cut: no table staging (the tables through L1, D2t staged)": (
            ("sns_vq_enc.cu", "  acx_load_shared(tab, tables, kSnsTableWords);\n", ""),
            ("sns_vq_enc.cu", "sns_tables(tab)", "sns_tables(tables)")),
    },
    "noise_residual_enc": {
        "kept: a warp a stream, blocks of 4 warps, chains over the zero lines": (),
        "blocks of 2 warps": (("noise_residual_enc.cu", _NF_WARPS, "constexpr int kNfWarps = 2;"),),
        "blocks of 8 warps": (("noise_residual_enc.cu", _NF_WARPS, "constexpr int kNfWarps = 8;"),),
        "chains over every line (+0 off the zero lines)": (
            ("noise_residual_enc.cuh", _NF_STORE,
             "      if (32 * c + ln < N) vz[32 * c + ln] = zero_line ? v : 0.0f;\n"),
            ("noise_residual_enc.cuh", _NF_BOUNDS, "  const int n_all = N, n_lo = mid;")),
        "the zero-line test one bit of the ballot dilated once a chunk (an earlier build)": (
            ("noise_residual_enc.cuh", _NF_ZERO, _NF_DILATED),),
        "the zero lines' values under a branch (the earlier builds)": (
            ("noise_residual_enc.cuh", _NF_SELECTED, _NF_BRANCHED),),
        "every round of the chains masked (the earliest build)": (
            ("noise_residual_enc.cuh", "    if (j < lo || j + 8 > hi) {", "    if (true) {"),),
        "phase cut: no chains": (
            ("noise_residual_enc.cuh", _NF_CHAIN,
             "    sums[ln] = radd(vz[lo], static_cast<float>(hi));"),),
        "phase cut: no residual bits": (
            ("noise_residual_enc.cuh", _NF_RES_KEPT, "      if (q != 0 && rank < 0) res[rank] = bit;"),),
    },
}

STEP_BENCH = r"""
#include "sns_vq_enc.cuh"
#include "noise_residual_enc.cuh"
// one dependent chain a thread: ITERS pulse scans of 16 positions, each
// scan's first position moved by the one before
__global__ void scan_bench(const float* seed, float* out, int iters) {
  float xy2[acx::kSnsM], yyt[acx::kSnsM];
  for (int i = 0; i < acx::kSnsM; ++i) {
    xy2[i] = seed[(threadIdx.x + i) % 32] + 4.0f;
    yyt[i] = seed[(threadIdx.x + 3 * i) % 32] + 8.0f;
  }
  int best = 0;
  for (int it = 0; it < iters; ++it) {
    best = acx::pvq_scan(xy2, yyt, acx::kSnsM);
    xy2[0] = acx::radd(xy2[0], static_cast<float>(best) * 1e-7f);
  }
  out[blockIdx.x * blockDim.x + threadIdx.x] = xy2[0] + best;
}
// lane 0 of each warp: ITERS chains over n values in shared memory, each
// chain's first value the sum of the one before
__global__ void chain_bench(const float* seed, float* out, int iters, int n) {
  __shared__ alignas(16) float v[8][acx::kNfScratch];
  const int w = threadIdx.x / 32, l = threadIdx.x % 32;
  for (int i = l; i < acx::kNfScratch; i += 32) v[w][i] = seed[i % 32] + 1.0f;
  __syncwarp();
  float acc = 0.0f;
  if (l == 0) {
    for (int it = 0; it < iters; ++it) {
      acc = acx::nf_chain(v[w], 0, n);
      v[w][0] = acc * 1e-9f;
    }
  }
  out[blockIdx.x * blockDim.x + threadIdx.x] = acc;
}
extern "C" int run_scan(const void* seed, void* out, int iters, int blocks, int threads,
                        void* stream) {
  scan_bench<<<blocks, threads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(seed), static_cast<float*>(out), iters);
  return static_cast<int>(cudaGetLastError());
}
extern "C" int run_chain(const void* seed, void* out, int iters, int n, int blocks,
                         int threads, void* stream) {
  chain_bench<<<blocks, threads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(seed), static_cast<float*>(out), iters, n);
  return static_cast<int>(cudaGetLastError());
}
"""


def build(d: Path, csrc: Path, main: str, subs=()) -> ctypes.CDLL:
    """nvcc builds `main` of a copy of csrc with the substitutions (file,
    old, new) applied, in d."""
    shutil.rmtree(d, ignore_errors=True)
    shutil.copytree(csrc, d)
    for name, old, new in subs:
        text = (d / name).read_text()
        if old not in text:
            raise SystemExit(f"{old!r} is not in {csrc / name}")
        (d / name).write_text(text.replace(old, new))
    r = subprocess.run([nvcc(), *NVCC_FLAGS, f"-I{d}", "-o", str(d / "lib.so"), str(d / main)],
                       capture_output=True, text=True)
    if r.returncode:
        raise SystemExit(f"nvcc failed in {d.name}:\n{r.stdout}{r.stderr}")
    return ctypes.CDLL(str(d / "lib.so"))


def record(root: Path, B: int, T: int) -> dict:
    """The flagship's T-frame encode of B streams with the checkout at root:
    the last call of each recorded stage and kernel, with the functions."""
    import torch
    sys.path.insert(0, str(root))
    import audio_codec_torch as P
    from audio_codec_torch import kernels as K
    from audio_codec_torch.ops import quant, sns
    K.library()
    cfg = P.Config(fs_in=48000, bitrate=64000)
    pcm = torch.from_numpy(make_pcm(T, B, 480)).cuda()
    wrapped = {"sns.quantize_scf_enc": (sns, "quantize_scf_enc"),
               "quant.noise_residual_enc": (quant, "noise_residual_enc"),
               "sns_vq_enc": (K, "sns_vq_enc"), "noise_residual_enc": (K, "noise_residual_enc"),
               "tns_filter_analysis": (K, "tns_filter_analysis")}
    calls = {name: [] for name in wrapped}
    saved = {name: getattr(mod, attr) for name, (mod, attr) in wrapped.items()}

    def rec(name):
        def f(*a):
            calls[name].append(a)
            return saved[name](*a)
        return f
    for name, (mod, attr) in wrapped.items():
        setattr(mod, attr, rec(name))
    try:
        P.encode_block(cfg, P.enc_state_init(cfg, B), pcm)
    finally:
        for name, (mod, attr) in wrapped.items():
            setattr(mod, attr, saved[name])
    torch.cuda.synchronize()
    return {name: (calls[name][-1], saved[name]) for name in wrapped}


def fec_inputs(B: int, mode: int):
    """fec_rows of the 80-byte slot at EP `mode`, tiled to B rows, on the card."""
    import numpy as np
    import torch
    from tests.torch_kernel_cases import fec_rows
    data, epmr, _, _ = fec_rows(80, mode, 0)
    idx = np.arange(B) % data.shape[0]
    g = lambda a: torch.from_numpy(np.ascontiguousarray(a[idx])).cuda()
    return g(data), g(epmr)


def measure(root: Path, B: int, T: int) -> dict:
    """The times of the checkout at root, in this process."""
    import torch
    r = record(root, B, T)
    from audio_codec_torch import kernels as K
    from audio_codec_torch.ops import fec, quant, sns, tns
    from tests.torch_kernel_cases import count_differing
    out = {"root": str(root), "card": card(), "streams": B, "frames": T}

    def kernel(name, fn, args, plain):
        got, ref = fn(*args), plain(*args)
        torch.cuda.synchronize()
        out[name] = {"differ": count_differing(got, ref), **times(lambda: fn(*args))}
    (scf,), enc = r["sns_vq_enc"]
    kernel("sns_vq_enc", enc, (scf,), sns.sns_vq_enc_plain)
    nargs, nre = r["noise_residual_enc"]
    kernel("noise_residual_enc", nre, nargs, quant.noise_residual_enc_plain)
    scf_idx = enc(scf)[0]
    kernel("sns_vq_dec", K.sns_vq_dec, (scf_idx,), sns.sns_vq_dec_plain)
    targs, tfa = r["tns_filter_analysis"]
    kernel("tns_filter_analysis", tfa, targs, tns.tns_filter_analysis_plain)
    for mode in (1, 2, 3, 4):
        data, epmr = fec_inputs(B, mode)
        kernel(f"fec_encode EP{mode}", K.fec_encode, (data, epmr, 80, mode, 0),
               fec.fec_encode_plain)
        frames = K.fec_encode(data, epmr, 80, mode, 0)
        kernel(f"fec_decode EP{mode}", K.fec_decode, (frames, 80, 0), fec.fec_decode_plain)
    for name in ("sns.quantize_scf_enc", "quant.noise_residual_enc"):
        args, fn = r[name]
        out[name] = times(lambda: fn(*args))
    return out


def tile(a, n):
    import torch
    if not isinstance(a, torch.Tensor) or a.dim() == 0:
        return a
    idx = torch.arange(n, device=a.device) % a.shape[0]
    return a[idx].contiguous()


def raw_call(name: str, lib, args, n: int):
    """A call of the C entry point `name` of lib on the recorded arguments
    tiled to n streams: (run, outputs)."""
    import torch
    st = lambda: torch.cuda.current_stream().cuda_stream
    getattr(lib, f"acx_{name}").argtypes = ARGTYPES[name]
    fn = getattr(lib, f"acx_{name}")
    if name == "sns_vq_enc":
        scf = tile(args[0], n)
        idx = torch.empty((n, 7), dtype=torch.int32, device="cuda")
        q = torch.empty_like(scf)
        return (lambda: fn(scf.data_ptr(), tables_ptr(), idx.data_ptr(), q.data_ptr(), n, st()),
                (idx, q), (scf,))
    cfg, *rest = args
    from audio_codec_torch import kernels as K
    max_res, width, start = K._spectral_geometry(cfg, name)
    a = [tile(v, n) for v in rest]
    N = a[0].shape[1]
    fac, n_res = (torch.empty((n,), dtype=torch.int32, device="cuda") for _ in range(2))
    res = torch.empty((n, max_res), dtype=torch.int32, device="cuda")
    half = int(cfg.frame_dms == 100 and cfg.targetBytes <= 20)
    return (lambda: fn(*(v.data_ptr() for v in a), fac.data_ptr(), res.data_ptr(),
                       n_res.data_ptr(), n, N, width, start, half, max_res, st()),
            (fac, res, n_res), (cfg, *a))


def tables_ptr() -> int:
    from audio_codec_torch import kernels as K
    return K._sns_tables("cuda:0").data_ptr()


def builds(jobs, B: int, kinds=(2048,)) -> None:
    """Each job (tag, kernel name, label, csrc, substitutions) built and timed
    against the plain version on the recorded rows, two rounds."""
    import torch
    r = record(ROOT, B, 8)
    from audio_codec_torch.ops import quant, sns
    from tests.torch_kernel_cases import count_differing
    plain = {"sns_vq_enc": sns.sns_vq_enc_plain, "noise_residual_enc": quant.noise_residual_enc_plain}
    libs = [(tag, name, label, build(OUT / tag, csrc, f"{name}.cu", subs))
            for tag, name, label, csrc, subs in jobs]
    for rnd in range(2):
        for n in kinds:
            for tag, name, label, lib in libs:
                run, outs, args = raw_call(name, lib, r[name][0], n)
                rc = run()
                torch.cuda.synchronize()
                ref = plain[name](*args)
                differ = count_differing(list(outs), [t.contiguous() for t in ref])
                ms = min(graph_ms(run) for _ in range(3))
                print(f"[{name} builds] {card()} | round {rnd}, {n} streams, {label}: rc {rc}, "
                      f"{differ} values differ from the plain version, graph {ms:.5f} ms",
                      flush=True)


def phases(other: Path, B: int) -> None:
    csrc = other.resolve() / "audio_codec_torch" / "csrc"
    jobs = [(f"first_{name}_{i}", name, label, csrc, subs)
            for name, cuts in PHASES_FIRST.items()
            for i, (label, subs) in enumerate(cuts.items())]
    builds(jobs, B)


def variants(B: int) -> None:
    jobs = [(f"kept_{name}_{i}", name, label, CSRC, subs)
            for name, cuts in VARIANTS.items() for i, (label, subs) in enumerate(cuts.items())]
    builds(jobs, B, kinds=(B, 1))


def step_bench() -> None:
    """ns a step: (time of 2n - time of n) / n of one launch (graph_ms is a
    launch's time), so that the set-up drops out."""
    import torch
    d = OUT / "step_bench"
    shutil.rmtree(d, ignore_errors=True)
    shutil.copytree(CSRC, d)
    (d / "bench.cu").write_text(STEP_BENCH)
    r = subprocess.run([nvcc(), *NVCC_FLAGS, f"-I{d}", "-o", str(d / "bench.so"),
                        str(d / "bench.cu")], capture_output=True, text=True)
    if r.returncode:
        raise SystemExit(f"nvcc failed on the step bench:\n{r.stdout}{r.stderr}")
    lib = ctypes.CDLL(str(d / "bench.so"))
    lib.run_scan.argtypes = [P_, P_] + [I_] * 3 + [P_]
    lib.run_chain.argtypes = [P_, P_] + [I_] * 4 + [P_]
    seed = torch.linspace(0.1, 0.9, 32, device="cuda")
    out = torch.empty(132 * 256, device="cuda")
    st = lambda: torch.cuda.current_stream().cuda_stream
    ms = lambda f: min(graph_ms(f) for _ in range(3))
    for warps in (1, 8):
        t = [ms(lambda n=n: lib.run_scan(seed.data_ptr(), out.data_ptr(), n, 132, 32 * warps, st()))
             for n in (100, 200)]
        print(f"[step] {card()} | pulse scan (16 positions, pvq_scan), {warps} warp(s) an SM: "
              f"{(t[1] - t[0]) * 1e6 / 100:.2f} ns a scan", flush=True)
    for warps in (1, 8):
        t = [ms(lambda n=n: lib.run_chain(seed.data_ptr(), out.data_ptr(), 20, n, 132, 32 * warps,
                                          st())) for n in (200, 400)]
        print(f"[step] {card()} | noise factor chain (nf_chain), {warps} warp(s) an SM: "
              f"{(t[1] - t[0]) * 1e6 / (20 * 200):.3f} ns a chain step", flush=True)


def scaling(root: Path, B: int, T: int) -> None:
    r = record(root, B, T)
    for name in ("sns_vq_enc", "noise_residual_enc"):
        args, fn = r[name]
        for n in (4, 32, 512, 2048):
            a = tuple(tile(v, n) for v in args)
            ms = min(graph_ms(lambda: fn(*a)) for _ in range(3))
            print(f"[scaling] {card()} | {name} ({root.name}): {n} streams: graph {ms:.5f} ms",
                  flush=True)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--streams", type=int, default=2048)
    ap.add_argument("--frames", type=int, default=8)
    ap.add_argument("--other", type=Path, default=None)
    ap.add_argument("--phases", type=Path, default=None)
    ap.add_argument("--variants", action="store_true")
    ap.add_argument("--step-bench", action="store_true")
    ap.add_argument("--scaling", action="store_true")
    ap.add_argument("--root", type=Path, default=None, help=argparse.SUPPRESS)
    opt = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("torch_sns_nf_times: no CUDA device")
    if opt.phases or opt.variants or opt.step_bench or opt.scaling:
        if opt.phases:
            phases(opt.phases, opt.streams)
        if opt.variants:
            variants(opt.streams)
        if opt.step_bench:
            step_bench()
        if opt.scaling:
            scaling((opt.root or ROOT).resolve(), opt.streams, opt.frames)
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
