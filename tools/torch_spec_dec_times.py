#!/usr/bin/env python3
"""Times the decoder's spectrum reconstruction and SNS quantizer decoder of
audio_codec_torch on a CUDA card: the kernels `spec_decode`
(csrc/spec_decode.cu) and `sns_vq_dec` (csrc/sns_vq_dec.cu) and their stages
(ops/quant.py:spectrum_decode, ops/sns.py:quantize_scf_dec) on the inputs the
flagship decode gives them. Every line printed carries the card's name and
power limit.

The inputs: chip_smoke.make_pcm's material at 48 kHz / 64 kbps, B streams,
encoded and decoded for T frames by the checkout's own encode_block and
decode_block; the arguments of the stages and kernels at the last frame are
recorded. Each kernel is checked against its plain version bit for bit, then
timed as median loop ms (5 loops of 20 calls) and graph ms (20 calls replayed
from a CUDA graph, the best of 3). The wrapper of `spec_decode` stacks its
[B] vectors with two copies, which its graph ms include; `raw` is the C
entry point alone on the stacked vectors.

  (default)     this checkout, one JSON line.
  --other DIR   the same for a checkout of another commit (the parent
                unpacked with `git archive` into a directory that .gitignore
                lists), in turns with this one, each in a process of its
                own: other, this, this, other.
  --phases DIR  the first designs of the two kernels in the checkout DIR
                (spec_decode a warp a stream over a shared row, sns_vq_dec a
                thread a stream), each with one phase removed
                (PHASES_FIRST), built from DIR's sources with text
                substitutions: raw graph ms at B streams, two rounds.
  --variants    this checkout's kept designs at other block sizes and with
                their other choices, and with one phase removed at a time
                (VARIANTS), built from this checkout's sources with text
                substitutions: raw graph ms at B streams and at 1, two rounds.
  --scaling     both kernels at 4, 32, 512 and 2048 streams of the recorded
                rows (tiled): graph ms of the wrappers.

    python3 tools/torch_spec_dec_times.py [--streams 2048] [--frames 8] [--other DIR]
    python3 tools/torch_spec_dec_times.py --phases DIR --variants --scaling
"""
from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT / "tools"))
from torch_dct4_times import card, graph_ms  # noqa: E402
from torch_ltpf_times import make_pcm, times  # noqa: E402
from torch_sns_nf_times import build, tile  # noqa: E402

CSRC = ROOT / "audio_codec_torch" / "csrc"
OUT = ROOT / "build" / "spec_dec_times"
P_, I_ = ctypes.c_void_p, ctypes.c_int
ARGTYPES = {"spec_decode": [P_] * 14 + [I_] * 5 + [P_],
            "sns_vq_dec": [P_] * 3 + [I_] + [P_]}

# the first designs with one phase removed: text substitutions (file, old,
# new) of the sources of the checkout given to --phases
_SPEC_SYNC = "  __syncthreads();\n  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;\n"
_SPEC_STAGE = ("  for (int i = threadIdx.x; i < 2 * (N + 1); i += blockDim.x) "
               "lcg_s[i] = lcg[i];\n")
_SPEC_GATHER = ("spec_nudge(v, res_bits[static_cast<size_t>(b) * g.res_width +\n"
                "                                 iclamp(rank, 0, g.res_width - 1)])")
_SPEC_ZERO = "spec_zero_line(v_row, k, h.bw_bin_nf, g)"
_SPEC_FILL = "spec_fill(k, filled0 + __popc(m & below), s, lcg_s, N)"
_DEC_LANE = "  sns_vq_dec_lane(idx, sns_tables(tab), q);\n"
_DEC_STAGE = "  acx_load_shared(tab, tables, kSnsTableWords);\n  __syncthreads();\n"
_DEC_DEINDEX = """  if (sub < 2) {
    mpvq_dec<10, 10, 0>(idx[4], idx[5], t.A, p);
    if (sub == 0) mpvq_dec<1, 6, 10>(idx[6] & 1, idx[6] >> 1, t.A, p);
  } else if (sub == 2) {
    mpvq_dec<8, 16, 0>(idx[4], idx[5], t.A, p);
  } else {
    mpvq_dec<6, 16, 0>(idx[4], idx[5], t.A, p);
  }
"""
_DEC_DCT = "  sns_dct_chains4(v, t.f + kOffD2, w);\n"
PHASES_FIRST = {
    "spec_decode": {
        "first design as it is": (),
        "the LCG table staged alone (one value written a stream)": (
            ("spec_decode.cu", _SPEC_SYNC,
             _SPEC_SYNC + "  if (B > 0) {\n    const int b0 = blockIdx.x * kSpecWarps + warp;\n"
                          "    if (b0 < B && lane == 0) x_out[static_cast<size_t>(b0) * N] = "
                          "static_cast<float>(lcg_s[warp] + bins[0]);\n    return;\n  }\n"),),
        "the LCG table staged 8 loads in flight a thread (acx_load_shared)": (
            ("spec_decode.cu", _SPEC_STAGE, "  acx_load_shared(lcg_s, lcg, 2 * (N + 1));\n"),),
        "no residual gather (a line's bit from its rank)": (
            ("spec_decode.cu", _SPEC_GATHER, "spec_nudge(v, rank & 1)"),),
        "no zero-line test (every fourth line from start to the bandwidth)": (
            ("spec_decode.cu", _SPEC_ZERO,
             "(k >= g.start && k < h.bw_bin_nf && (k & 3) == 0)"),),
        "no fills (a filled line's value without the table)": (
            ("spec_decode.cu", _SPEC_FILL, "s.prev_fac_ns"),),
        "no residual gather, no zero-line test": (
            ("spec_decode.cu", _SPEC_GATHER, "spec_nudge(v, rank & 1)"),
            ("spec_decode.cu", _SPEC_ZERO, "(k >= g.start && k < h.bw_bin_nf && (k & 3) == 0)")),
    },
    "sns_vq_dec": {
        "first design as it is": (),
        "staging alone (the tables staged, the indices read, one row written)": (
            ("sns_vq_dec.cu", _DEC_LANE,
             "#pragma unroll\n  for (int i = 0; i < kSnsM; ++i) "
             "q[i] = static_cast<float>(idx[i % 7] + tab[i]);\n"),),
        "no staging (the tables through L1)": (
            ("sns_vq_dec.cu", _DEC_STAGE, ""),
            ("sns_vq_dec.cu", "sns_tables(tab)", "sns_tables(tables)")),
        "no de-index (one pulse from the index)": (
            ("sns_vq.cuh", _DEC_DEINDEX, "  p[0] = 1 + (idx[5] & 3) + (sub & 1);\n"),),
        "no DCT (the normalised pulses as the transform)": (
            ("sns_vq.cuh", _DEC_DCT,
             "#pragma unroll\n  for (int i = 0; i < kSnsM; ++i) w[i] = v[i];\n"),),
    },
}

# the kept designs at other block sizes, with their other choices, and with
# one phase removed: text substitutions (file, old, new) of this checkout
_SPEC_WARPS = "constexpr int kSpecWarps = 4;   // streams a block"
_SPEC_ENTRY = ("  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;\n"
               "  const int b = blockIdx.x * kSpecWarps + warp;\n")
_SPEC_RES_LOAD = "      row[ln].r[c] = k < n_bits ? res_bits[k] : 0;"
_SPEC_RES_RANK = "      nz[ln] = nz[ln] != 0 && rank < s.n_res ? 1 : 0;"
_SPEC_WINDOW = "nf_window_clear(prev, nzb[c], next, ln, g.width)"
# the kept generator (carried by shuffles) and the closed form of the first
# design at each filled line's rank: from the table through L1, from the
# table staged in shared memory, or by 9 conditional powers
_SPEC_GEN = "  uint32_t gen = static_cast<uint32_t>(s.nf_seed + 32768) & 0xffffu;   // after the filled lines\n"
_SPEC_STEP = """    const auto m = w.shfl_from(pm, j), a = w.shfl_from(pa, j);
    w.lanes([&](int ln) {
      const int k = 32 * c + ln;
      u[ln] = spec_lcg_next(m[ln], a[ln], gen);
"""
_SPEC_CARRY = "    if (zm != 0u) gen = w.shfl(u, msb32(static_cast<int>(zm)));\n"
_SPEC_TABLE_STEP = """    w.lanes([&](int ln) {
      const int k = 32 * c + ln;
      const int steps = iclamp(filled0 + j[ln] + 1, 0, N);
      u[ln] = (static_cast<unsigned>(s.nf_seed + 32768) * static_cast<unsigned>(lcg[steps]) +
               static_cast<unsigned>(lcg[N + 1 + steps])) & 0xffffu;
"""
_SPEC_POWER_STEP = """    w.lanes([&](int ln) {
      const int k = 32 * c + ln;
      const int steps = iclamp(filled0 + j[ln] + 1, 0, N);
      unsigned uu = static_cast<unsigned>(s.nf_seed + 32768) & 0xffffu, am = kLcgMul, ac = kLcgAdd;
      for (int bit = 0; bit < 9; ++bit) {
        if ((steps >> bit) & 1) uu = (am * uu + ac) & 0xffffu;
        ac = (am * ac + ac) & 0xffffu;
        am = (am * am) & 0xffffu;
      }
      u[ln] = uu;
"""
_SPEC_RANKED = (("spec_decode.cuh", _SPEC_GEN, "  int filled0 = 0;\n"),
                ("spec_decode.cuh", _SPEC_CARRY, "    filled0 += popc32(zm);\n"))
# the table handed from the entry point to the warp
_SPEC_TABLE_ARG = (
    ("spec_decode.cuh", "                                    const SpecScalars& s, const int32_t* bw_bins,\n",
     "                                    const SpecScalars& s, const int32_t* bw_bins,\n"
     "                                    const int32_t* lcg,\n"),
    ("spec_decode.cu", "const int32_t* __restrict__ bw_bins, float* __restrict__ x_out,",
     "const int32_t* __restrict__ bw_bins, const int32_t* __restrict__ lcg,\n"
     "                       float* __restrict__ x_out,"),
    ("spec_decode.cu", "      static_cast<const int32_t*>(a[6]), static_cast<float*>(o[0]),",
     "      static_cast<const int32_t*>(a[6]), static_cast<const int32_t*>(a[7]),\n"
     "      static_cast<float*>(o[0]),"),
    ("spec_decode.cu", "  const void* a[7] = {x, ints, floats, res_bits, q_old_res, q_old_d, bw_bins};",
     "  const void* a[8] = {x, ints, floats, res_bits, q_old_res, q_old_d, bw_bins, lcg};"))
_SPEC_CALL = "s, bw_bins, g, x_out + row,"
_DEC_WARPS = "constexpr int kSnsDecWarps = 4;   // streams a block"
_DEC_CALL = ("  sns_vq_dec_warp(CoderCardWarp{lane}, scf_idx + 7 * static_cast<size_t>(b), tables,\n"
             "                  scf_q + kSnsM * static_cast<size_t>(b));\n")
_DEC_DEINDEX_KEPT = """  if (sub < 2) {
    mpvq_dec_warp<10, 10, 0>(w, idx[4], idx[5], col, p);
    if (sub == 0) mpvq_dec_warp<1, 6, 10>(w, idx[6] & 1, idx[6] >> 1, col, p);
  } else if (sub == 2) {
    mpvq_dec_warp<8, 16, 0>(w, idx[4], idx[5], col, p);
  } else {
    mpvq_dec_warp<6, 16, 0>(w, idx[4], idx[5], col, p);
  }
"""
_DEC_DCT_KEPT = """  for (int k = 0; k < kSnsM; ++k) {
    const float vk = w.shfl(v, k);
    w.lanes([&](int ln) { ln_[ln].c[k % 4] = xfma(vk, ln_[ln].d2[k], ln_[ln].c[k % 4]); });
  }
"""
# half a warp a stream: a warp type over 16 lanes, the collectives on the
# half's mask
_HALF_WARP = """
struct HalfWarp {
  int lane;
  unsigned mask;
  template <class T>
  struct Lanes {
    T v;
    __host__ __device__ T& operator[](int) { return v; }
    __host__ __device__ const T& operator[](int) const { return v; }
  };
  template <class F>
  __host__ __device__ void lanes(F&& f) const { f(lane); }
  template <class T>
  __host__ __device__ T shfl(const Lanes<T>& x, int src) const {
#ifdef __CUDA_ARCH__
    return __shfl_sync(mask, x.v, src, 16);
#else
    return x.v;
#endif
  }
  __host__ __device__ unsigned ballot(const Lanes<int>& p) const {
#ifdef __CUDA_ARCH__
    return (__ballot_sync(mask, p.v != 0) & mask) >> (mask == 0xFFFFu ? 0 : 16);
#else
    return 0u;
#endif
  }
  __host__ __device__ unsigned reduce_add(const Lanes<unsigned>& x) const {
#ifdef __CUDA_ARCH__
    return __reduce_add_sync(mask, x.v);
#else
    return x.v;
#endif
  }
};
"""
VARIANTS = {
    "spec_decode": {
        "kept: a warp a stream, blocks of 4 warps, the generator carried by shuffles": (),
        "blocks of 2 warps": (("spec_decode.cu", _SPEC_WARPS, "constexpr int kSpecWarps = 2;"),),
        "blocks of 8 warps": (("spec_decode.cu", _SPEC_WARPS, "constexpr int kSpecWarps = 8;"),),
        "the closed form at the rank, the table through L1 (the first build)": (
            *_SPEC_RANKED, ("spec_decode.cuh", _SPEC_STEP, _SPEC_TABLE_STEP), *_SPEC_TABLE_ARG,
            ("spec_decode.cu", _SPEC_CALL, "s, bw_bins, lcg, g, x_out + row,")),
        "the closed form at the rank, the table staged in shared memory": (
            *_SPEC_RANKED, ("spec_decode.cuh", _SPEC_STEP, _SPEC_TABLE_STEP), *_SPEC_TABLE_ARG,
            ("spec_decode.cu", _SPEC_ENTRY,
             "  __shared__ int32_t lcg_s[2 * (kSpecMaxLines + 1)];\n"
             "  acx_load_shared(lcg_s, lcg, 2 * (g.N + 1));\n  __syncthreads();\n" + _SPEC_ENTRY),
            ("spec_decode.cu", _SPEC_CALL, "s, bw_bins, lcg_s, g, x_out + row,")),
        "the closed form at the rank by 9 conditional powers (no table)": (
            *_SPEC_RANKED, ("spec_decode.cuh", _SPEC_STEP, _SPEC_POWER_STEP)),
        "the residual bits loaded only below n_res": (
            ("spec_decode.cuh", _SPEC_RES_LOAD,
             "      row[ln].r[c] = k < imin(n_bits, s.n_res) ? res_bits[k] : 0;"),),
        "phase cut: no residual": (
            ("spec_decode.cuh", _SPEC_RES_RANK, "      nz[ln] = 0;"),),
        "phase cut: no zero-line test (every fourth line)": (
            ("spec_decode.cuh", _SPEC_WINDOW, "((ln & 3) == 0)"),),
        "phase cut: no generator (a filled line's sign from its rank)": (
            ("spec_decode.cuh", _SPEC_STEP, _SPEC_STEP.replace(
                "spec_lcg_next(m[ln], a[ln], gen)", "static_cast<uint32_t>(j[ln]) << 11")),
            ("spec_decode.cuh", _SPEC_CARRY, "")),
    },
    "sns_vq_dec": {
        "kept: a warp a stream, blocks of 4 warps, the tables through L1": (),
        "blocks of 2 warps": (("sns_vq_dec.cu", _DEC_WARPS, "constexpr int kSnsDecWarps = 2;"),),
        "blocks of 8 warps": (("sns_vq_dec.cu", _DEC_WARPS, "constexpr int kSnsDecWarps = 8;"),),
        "blocks of 16 warps": (("sns_vq_dec.cu", _DEC_WARPS, "constexpr int kSnsDecWarps = 16;"),),
        "the tables staged in shared memory (acx_load_shared)": (
            ("sns_vq_dec.cu", _DEC_CALL,
             "  __shared__ alignas(16) int32_t tab[kSnsTableWords];\n"
             "  acx_load_shared(tab, tables, kSnsTableWords);\n  __syncthreads();\n"
             "  if (b >= B) return;\n" + _DEC_CALL.replace("tables,", "tab,")),
            ("sns_vq_dec.cu", "  if (b >= B) return;   // the whole warp leaves together\n", "")),
        "half a warp a stream (blocks of 8 streams)": (
            ("sns_vq_dec.cu", _DEC_WARPS, _HALF_WARP + _DEC_WARPS),
            ("sns_vq_dec.cu", "  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;\n"
                              "  const int b = blockIdx.x * kSnsDecWarps + warp;\n",
             "  const int lane = threadIdx.x % 16;\n"
             "  const unsigned mask = (threadIdx.x & 16) ? 0xFFFF0000u : 0xFFFFu;\n"
             "  const int b = blockIdx.x * 2 * kSnsDecWarps + threadIdx.x / 16;\n"),
            ("sns_vq_dec.cu", "sns_vq_dec_warp(CoderCardWarp{lane},", "sns_vq_dec_warp(HalfWarp{lane, mask},"),
            ("sns_vq_dec.cu", "  const int blocks = (B + kSnsDecWarps - 1) / kSnsDecWarps;",
             "  const int blocks = (B + 2 * kSnsDecWarps - 1) / (2 * kSnsDecWarps);")),
        "phase cut: launch and loads alone (no warp step)": (
            ("sns_vq_dec.cu", _DEC_CALL,
             "  if (lane < kSnsM) scf_q[kSnsM * static_cast<size_t>(b) + lane] = "
             "static_cast<float>(tables[lane] + scf_idx[7 * static_cast<size_t>(b) + lane % 7]);\n"),),
        "phase cut: no de-index (one pulse from the index)": (
            ("sns_vq.cuh", _DEC_DEINDEX_KEPT,
             "  w.lanes([&](int ln) { p[ln] = ln == (idx[5] & 15) ? 1 + col[ln].a[0] % 3 : 0; });\n"),),
        "phase cut: no DCT (one term a lane)": (
            ("sns_vq.cuh", _DEC_DCT_KEPT,
             "  for (int k = 0; k < 1; ++k) {\n"
             "    w.lanes([&](int ln) { ln_[ln].c[0] = radd(v[ln], ln_[ln].d2[0]); });\n  }\n"),),
    },
}


def record(root: Path, B: int, T: int) -> dict:
    """The flagship's T-frame encode and decode of B streams with the
    checkout at root: the last call of each recorded stage and kernel of the
    decoder, with the functions."""
    import torch
    sys.path.insert(0, str(root))
    import audio_codec_torch as P
    from audio_codec_torch import kernels as K
    from audio_codec_torch.ops import quant, sns
    K.library()
    cfg = P.Config(fs_in=48000, bitrate=64000)
    pcm = torch.from_numpy(make_pcm(T, B, 480)).cuda()
    _, frames = P.encode_block(cfg, P.enc_state_init(cfg, B), pcm)
    wrapped = {"quant.spectrum_decode": (quant, "spectrum_decode"),
               "sns.quantize_scf_dec": (sns, "quantize_scf_dec"),
               "spec_decode": (K, "spec_decode"), "sns_vq_dec": (K, "sns_vq_dec")}
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
        P.decode_block(cfg, P.dec_state_init(cfg, B), frames)
    finally:
        for name, (mod, attr) in wrapped.items():
            setattr(mod, attr, saved[name])
    torch.cuda.synchronize()
    return {name: (calls[name][-1], saved[name]) for name in wrapped}


def plain(name: str):
    from audio_codec_torch.ops import quant, sns
    return {"spec_decode": quant.spectrum_decode_plain, "sns_vq_dec": sns.sns_vq_dec_plain}[name]


def measure(root: Path, B: int, T: int) -> dict:
    """The times of the checkout at root, in this process."""
    import torch
    r = record(root, B, T)
    from audio_codec_torch import kernels as K
    from tests.torch_kernel_cases import count_differing
    out = {"root": str(root), "card": card(), "streams": B, "frames": T}
    for name in ("spec_decode", "sns_vq_dec"):
        args, fn = r[name]
        got, ref = fn(*args), plain(name)(*args)
        torch.cuda.synchronize()
        run, _, _ = raw_call(name, K.library(), args, args[1 if name == "spec_decode" else 0]
                             .shape[0])
        out[name] = {"differ": count_differing(got, ref), **times(lambda: fn(*args)),
                     "raw_graph_ms": min(graph_ms(run) for _ in range(3))}
    for name in ("quant.spectrum_decode", "sns.quantize_scf_dec"):
        args, fn = r[name]
        out[name] = times(lambda: fn(*args))
    return out


def raw_call(name: str, lib, args, n: int):
    """A call of the C entry point `name` of lib on the recorded arguments
    tiled to n streams, prepared as the wrapper prepares them: (run,
    outputs, the tiled arguments)."""
    import numpy as np
    import torch
    from audio_codec_torch import kernels as K
    from audio_codec_torch.ops import quant
    st = lambda: torch.cuda.current_stream().cuda_stream
    fn = getattr(lib, f"acx_{name}")
    fn.argtypes = ARGTYPES[name]
    if name == "sns_vq_dec":
        idx = tile(args[0], n)
        q = torch.empty((n, 16), dtype=torch.float32, device="cuda")
        tab = K._sns_tables(str(idx.device))
        return lambda: fn(idx.data_ptr(), tab.data_ptr(), q.data_ptr(), n, st()), (q,), (idx,)
    cfg, *rest = args
    a = [tile(v, n) for v in rest]
    (x, gain, bfi, rframe, inv, bw_idx, fac_ns_idx, res_present, res_bits, n_res, seed, zero,
     q_old_res, q_old_d, prev_gg, prev_bw, prev_fac, nb_lost) = a
    res_width, width, start = K._spectral_geometry(cfg, name)
    res_width = res_bits.shape[1] if 0 < res_bits.shape[1] <= res_width else res_width
    N = x.shape[1]
    ints = torch.stack([bfi, rframe, inv, bw_idx, fac_ns_idx, res_present, n_res, seed, zero,
                        prev_bw, nb_lost])
    floats = torch.stack([gain, prev_gg, prev_fac])
    x_out, q_out = torch.empty_like(x), torch.empty_like(x)
    pgg, pfac = (torch.empty((n,), dtype=torch.float32, device="cuda") for _ in range(2))
    pbw, nbl = (torch.empty((n,), dtype=torch.int32, device="cuda") for _ in range(2))
    # the first design's generator table (the kept warp carries the
    # generator by shuffles and reads none)
    lcg = torch.as_tensor(np.concatenate(quant.lcg_tables(N + 1)).astype(np.int32),
                          device=x.device)
    bins = K._bw_bins(str(x.device), cfg.frame_dms)
    return (lambda: fn(x.data_ptr(), ints.data_ptr(), floats.data_ptr(), res_bits.data_ptr(),
                       q_old_res.data_ptr(), q_old_d.data_ptr(), bins.data_ptr(),
                       lcg.data_ptr(), x_out.data_ptr(), q_out.data_ptr(), pgg.data_ptr(),
                       pbw.data_ptr(), pfac.data_ptr(), nbl.data_ptr(), n, N, width, start,
                       res_width, st()),
            (x_out, q_out, pgg, pbw, pfac, nbl), (cfg, *a))


def builds(jobs, B: int, kinds=(2048,)) -> None:
    """Each job (tag, kernel name, label, csrc, substitutions) built and timed
    against the plain version on the recorded rows, two rounds."""
    import torch
    r = record(ROOT, B, 8)
    from tests.torch_kernel_cases import count_differing
    libs = [(tag, name, label, build(OUT / tag, csrc, f"{name}.cu", subs))
            for tag, name, label, csrc, subs in jobs]
    for rnd in range(2):
        for n in kinds:
            for tag, name, label, lib in libs:
                run, outs, args = raw_call(name, lib, r[name][0], n)
                rc = run()
                torch.cuda.synchronize()
                ref = plain(name)(*args)
                ref = ref if isinstance(ref, (tuple, list)) else (ref,)
                differ = count_differing(list(outs), [t.contiguous() for t in ref])
                ms = min(graph_ms(run) for _ in range(3))
                print(f"[{name} builds] {card()} | round {rnd}, {n} streams, {label}: rc {rc}, "
                      f"{differ} values differ from the plain version, raw graph {ms:.5f} ms",
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


def scaling(root: Path, B: int, T: int) -> None:
    r = record(root, B, T)
    for name in ("spec_decode", "sns_vq_dec"):
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
    ap.add_argument("--scaling", action="store_true")
    ap.add_argument("--root", type=Path, default=None, help=argparse.SUPPRESS)
    opt = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("torch_spec_dec_times: no CUDA device")
    if opt.phases or opt.variants or opt.scaling:
        if opt.phases:
            phases(opt.phases, opt.streams)
        if opt.variants:
            variants(opt.streams)
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
