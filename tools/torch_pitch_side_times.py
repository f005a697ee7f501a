#!/usr/bin/env python3
"""Times the encoder's LTPF parameter coder and side-information packer of
audio_codec_torch on a CUDA card: the kernels `ltpf_encode`
(csrc/ltpf_encode.cu) and `side_info_pack` (csrc/side_info_pack.cu) and
their stages (ops/analysis.py:ltpf_encode, ops/bits.py:pack_side_info) on
the inputs the flagship encode gives them. Every line printed carries the
card's name and power limit.

The inputs: chip_smoke.make_pcm's material at 48 kHz / 64 kbps, B streams,
encoded for T frames by the checkout's own encode_block; the arguments of
the stages and kernels at the last frame are recorded. Each kernel is
checked against its plain version bit for bit, then timed as median loop ms
(5 loops of 20 calls) and graph ms (20 calls replayed from a CUDA graph, the
best of 3). `raw` is the C entry point alone on the arguments as the wrapper
hands them over, so that wrapper graph ms - raw graph ms is what the
wrapper's conversions cost on the card.

  (default)     this checkout, one JSON line.
  --other DIR   the same for a checkout of another commit (the parent
                unpacked with `git archive` into a directory that .gitignore
                lists), in turns with this one, each in a process of its
                own: other, this, this, other.
  --phases DIR  the first designs of the two kernels in the checkout DIR
                (ltpf_encode a warp a stream over a shared row with lane 0's
                searches, side_info_pack a thread a stream of shared
                read-modify-writes), each with one phase removed
                (PHASES_FIRST), built from DIR's sources with text
                substitutions and run on DIR's recorded rows: raw graph ms
                at B streams, two rounds.
  --variants    this checkout's kept designs at other block sizes and with
                their other choices, and with one phase removed at a time
                (VARIANTS), built from this checkout's sources with text
                substitutions: raw graph ms at B streams and at 1, two rounds.
  --scaling     both kernels at 4, 32, 512 and 2048 streams of the recorded
                rows (tiled): graph ms of the wrappers.

    python3 tools/torch_pitch_side_times.py [--streams 2048] [--frames 8] [--other DIR]
    python3 tools/torch_pitch_side_times.py --phases DIR --variants --scaling
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
OUT = ROOT / "build" / "pitch_side_times"
P_, I_ = ctypes.c_void_p, ctypes.c_int
ARGTYPES = {"ltpf_encode": [P_] * 16 + [I_] * 8 + [P_],
            "side_info_pack": [P_] * 11 + [I_] * 5 + [P_]}

# the first designs with one phase removed: text substitutions (file, old,
# new) of the sources of the checkout given to --phases
_LT_POL = "  const int pol = pitch_ol[b];\n"
_LT_WINDOW = "    cors[warp][lane] = ltpf_window_nc(buf, g, pol, lane, ltpf_energy(buf, g));\n"
_LT_FRAC = "      v = ltpf_interp(cor, inter, iclamp(i, 0, kLtpfInterOut - 1));\n"
_LT_CHAINS = ("  if (lane == 0) sums[warp][0] = ltpf_chain(cfs[warp], pfs[warp], g.acflen);\n"
              "  if (lane == 1) sums[warp][1] = ltpf_chain(cfs[warp], cfs[warp], g.acflen);\n"
              "  if (lane == 2) sums[warp][2] = ltpf_chain(pfs[warp], pfs[warp], g.acflen);\n")
_SP_LANE = "    const SideCursor c = side_info_pack_lane(tile + t * stride, L, s);\n"
_SP_FIELDS = ("s.bw_idx ^ s.lastnz ^ s.lsb_mode ^ s.gg_idx ^ s.num_tns ^ s.tns_on[0] ^ "
              "s.tns_on[1] ^ s.ltpf[0] ^ s.ltpf[1] ^ s.ltpf[2] ^ s.scf_idx[0] ^ s.scf_idx[1] ^ "
              "s.scf_idx[2] ^ s.scf_idx[3] ^ s.scf_idx[4] ^ s.scf_idx[5] ^ s.scf_idx[6] ^ "
              "s.fac_ns_idx")
PHASES_FIRST = {
    "ltpf_encode": {
        "first design as it is": (),
        "staging alone (the row staged, the memory written, one value a stream)": (
            ("ltpf_encode.cu", _LT_POL,
             "  if (B > 0) {\n    if (lane == 0) nc_out[b] = buf[g.xbase] + buf[g.xlen];\n"
             "    return;\n  }\n" + _LT_POL),),
        "no energy chain (the window lanes' energy one sample)": (
            ("ltpf_encode.cu", "ltpf_energy(buf, g)", "buf[g.xbase]"),),
        "no window chains (the energy chain kept, an entry one product)": (
            ("ltpf_encode.cu", _LT_WINDOW,
             "    cors[warp][lane] = rmul(ltpf_energy(buf, g), buf[g.xbase + lane]);\n"),),
        "no fractional search (a candidate a window entry)": (
            ("ltpf_encode.cuh", _LT_FRAC,
             "      v = cor[iclamp(i, 0, kLtpfInterOut - 1) % kLtpfWin];\n"),),
        "no normcorr chains (a sum one product)": (
            ("ltpf_encode.cu", _LT_CHAINS,
             "  if (lane < 3) sums[warp][lane] = rmul(cfs[warp][lane], pfs[warp][lane]);\n"),),
    },
    "side_info_pack": {
        "first design as it is": (),
        "field loads and the row's store alone (no bit writes)": (
            ("side_info_pack.cu", _SP_LANE,
             f"    tile[t * stride] = {_SP_FIELDS};\n"
             "    const SideCursor c = {s.gg_idx, s.lsb_mode};\n"),),
    },
}

# the kept designs at other block sizes, with their other choices, and with
# one phase removed: text substitutions (file, old, new) of this checkout
_LT_WARPS = "constexpr int kLtpfWarps = 4;   // streams a block"
_LT_COR = "    cor[l] = nc < 0.0f ? 0.0f : nc;\n  });\n"
_LT_CAND = "    const float cm = w.shfl(cor, m);\n"
_LT_EF = "  const float* ef = tab + kLtpfInterTaps;\n"
_LT_WIN_CHAINS = "    ltpf_window_chains<ACF>(x, lag, &c[l], &en[l]);\n"
_LT_ANCHOR = "// The chain over ACF values from the first, ascending (a 16-byte aligned).\n"
_LT_ENTRY = ("  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;\n"
             "  const int b = blockIdx.x * kLtpfWarps + warp;\n"
             "  if (b >= B) return;   // the whole warp leaves together\n")
# two warps a stream: the second runs the lags' energy chains (and the
# block's) while the first runs the correlation chains; the pair meets at a
# named barrier after the staging and after the chains
_LT_PAIR = r"""__shared__ float ltpf_en_pair[8][32];
__device__ __forceinline__ void ltpf_pair_sync() {
#ifdef __CUDA_ARCH__
  asm volatile("bar.sync %0, 64;" :: "r"(1 + static_cast<int>(threadIdx.x) / 64) : "memory");
#endif
}
template <int ACF>
ACX_HD float ltpf_corr_only(const float* x, const float* lag) {
  float c = 0.0f;
#pragma unroll
  for (int n0 = 0; n0 < ACF; n0 += 4) {
    const LtpfQuad xq = ltpf_quad(x + n0);
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const float p = rmul(xq.v[k], lag[n0 + k]);
      c = n0 + k == 0 ? p : radd(c, p);
    }
  }
  return c;
}
template <int ACF>
ACX_HD float ltpf_en_only(const float* lag) {
  float en = 0.0f;
#pragma unroll
  for (int n = 0; n < ACF; ++n) {
    const float q = rmul(lag[n], lag[n]);
    en = n == 0 ? q : radd(en, q);
  }
  return en;
}
"""
_LT_PAIR_CHAINS = """#ifdef __CUDA_ARCH__
    ltpf_pair_sync();
    c[l] = ltpf_corr_only<ACF>(x, lag);
    ltpf_pair_sync();
    en[l] = ltpf_en_pair[threadIdx.x / 64][l];
#endif
"""
_LT_PAIR_ENTRY = """  const int warp = threadIdx.x / 64, lane = threadIdx.x % 32;
  const int b = blockIdx.x * kLtpfWarps + warp;
  if (b >= B) return;   // both warps of the stream leave together
  if ((threadIdx.x / 32) & 1) {
    const float* row = scratch[warp].row;
    const int li = iclamp(ltpf_t0_min(pitch_ol[b]) - 4 - kLtpfLag0 + lane, 0, kLtpfLags - 1);
    const float* lag = lane < kLtpfWin ? row + imax(g.xbase - kLtpfLag0 - li, 0) : row + g.xbase;
    ltpf_pair_sync();
    ltpf_en_pair[warp][lane] = ltpf_en_only<ACF>(lag);
    ltpf_pair_sync();
    return;
  }
"""
_SP_WARPS = "constexpr int kPackWarps = 4;   // streams a block"
_SP_ENTRY = ("  const int lane = threadIdx.x % 32;\n"
             "  const int b = blockIdx.x * kPackWarps + threadIdx.x / 32;\n"
             "  if (b >= B) return;   // the whole warp leaves together\n")
_SP_CALL = ("  const SideCursor c = side_info_pack_warp(CoderCardWarp{lane}, L, s,\n"
            "                                           buf + static_cast<size_t>(b) * L.nbytes);\n"
            "  if (lane == 0) {\n    cursor[b] = c.bp;\n    cursor[B + b] = c.mask;\n  }\n")
_SP_BLOCKS = "  const int blocks = (B + kPackWarps - 1) / kPackWarps;\n"
_SP_LAUNCH = "side_info_pack_kernel<<<blocks, 32 * kPackWarps, 0,"
VARIANTS = {
    "ltpf_encode": {
        "kept: a warp a stream, blocks of 4 warps, the window entries by shuffle": (),
        "blocks of 2 warps": (("ltpf_encode.cu", _LT_WARPS, "constexpr int kLtpfWarps = 2;"),),
        "blocks of 8 warps": (("ltpf_encode.cu", _LT_WARPS, "constexpr int kLtpfWarps = 8;"),),
        "the candidates' window entries from shared memory": (
            ("ltpf_encode.cuh", _LT_COR,
             "    cor[l] = nc < 0.0f ? 0.0f : nc;\n    if (l < kLtpfWin) S.prod[0][l] = cor[l];\n"
             "  });\n  w.sync();\n"),
            ("ltpf_encode.cuh", _LT_CAND, "    const float cm = S.prod[0][m];\n"),
            ("ltpf_encode.cuh", _LT_EF, "  w.sync();\n" + _LT_EF)),
        "two warps a stream (the energy chains on the second)": (
            ("ltpf_encode.cuh", _LT_ANCHOR, _LT_PAIR + _LT_ANCHOR),
            ("ltpf_encode.cuh", _LT_WIN_CHAINS, _LT_PAIR_CHAINS),
            ("ltpf_encode.cu", _LT_ENTRY, _LT_PAIR_ENTRY),
            ("ltpf_encode.cu", "<<<blocks, 32 * kLtpfWarps, 0, stream>>>",
             "<<<blocks, 64 * kLtpfWarps, 0, stream>>>")),
        "phase cut: staging alone (the row staged, the memory written)": (
            ("ltpf_encode.cuh", "  // the window's chains on lanes 0-16, the block's energy on lane 17\n",
             "  if (g.enable >= 0) {\n    LtpfOut o = {};\n    o.nc = row[g.xbase] + row[g.xlen];\n"
             "    return o;\n  }\n"),),
        "phase cut: no window chains (an entry one product)": (
            ("ltpf_encode.cuh", _LT_WIN_CHAINS,
             "    c[l] = rmul(x[0], lag[0]);\n    en[l] = rmul(lag[0], lag[0]);\n"),),
        "phase cut: no interpolation chains (one term a candidate)": (
            ("ltpf_encode.cuh", "  for (int m = 0; m < kLtpfWin; ++m) {\n",
             "  for (int m = 0; m < 1; ++m) {\n"),),
        "phase cut: no normcorr sums (a sum one product)": (
            ("ltpf_encode.cuh", "ltpf_sum_chain<ACF>(S.prod[imin(l, 2)])", "S.prod[imin(l, 2)][l]"),),
    },
    "side_info_pack": {
        "kept: a warp a stream, blocks of 4 warps": (),
        "blocks of 2 warps": (("side_info_pack.cu", _SP_WARPS, "constexpr int kPackWarps = 2;"),),
        "blocks of 8 warps": (("side_info_pack.cu", _SP_WARPS, "constexpr int kPackWarps = 8;"),),
        "a thread a stream, the register string, the block's shared tile stored coalesced": (
            ("side_info_pack.cu", _SP_ENTRY,
             "  extern __shared__ int32_t tile[];\n"
             "  const int row0 = blockIdx.x * blockDim.x;\n"
             "  const int rows = imin(static_cast<int>(blockDim.x), B - row0);\n"
             "  const int stride = L.nbytes | 1;\n"
             "  const int b = imin(row0 + static_cast<int>(threadIdx.x), B - 1);\n"),
            ("side_info_pack.cu", _SP_CALL,
             "  const SideBits bb = side_info_pack_bits(L, s);\n"
             "  if (static_cast<int>(threadIdx.x) < rows) {\n"
             "    for (int t = 0; t < L.nbytes; ++t)\n"
             "      tile[threadIdx.x * stride + t] = side_row_byte(bb, L, t);\n"
             "    const SideCursor c = side_string_cursor(bb, L);\n"
             "    cursor[b] = c.bp;\n    cursor[B + b] = c.mask;\n  }\n  __syncthreads();\n"
             "  for (int i = threadIdx.x; i < rows * L.nbytes; i += blockDim.x)\n"
             "    buf[static_cast<size_t>(row0) * L.nbytes + i] =\n"
             "        tile[(i / L.nbytes) * stride + i % L.nbytes];\n"),
            ("side_info_pack.cu", _SP_BLOCKS,
             "  const int blocks = (B + 32 * kPackWarps - 1) / (32 * kPackWarps);\n"),
            ("side_info_pack.cu", _SP_LAUNCH,
             "side_info_pack_kernel<<<blocks, 32 * kPackWarps, "
             "32 * kPackWarps * (nbytes | 1) * 4,")),
        "phase cut: loads and the row's store alone (no string)": (
            ("side_info.cuh", "  const SideBits b = side_info_pack_bits(L, s);\n",
             "  const SideBits b = {{static_cast<uint32_t>(" + _SP_FIELDS + "), 0u, 0u}, 64};\n"),),
    },
}


def record(root: Path, B: int, T: int) -> dict:
    """The flagship's T-frame encode of B streams with the checkout at root:
    the last call of each recorded stage and kernel, with the functions."""
    import torch
    sys.path.insert(0, str(root))
    import audio_codec_torch as P
    from audio_codec_torch import kernels as K
    from audio_codec_torch.ops import analysis, bits
    K.library()
    cfg = P.Config(fs_in=48000, bitrate=64000)
    pcm = torch.from_numpy(make_pcm(T, B, 480)).cuda()
    wrapped = {"analysis.ltpf_encode": (analysis, "ltpf_encode"),
               "bits.pack_side_info": (bits, "pack_side_info"),
               "ltpf_encode": (K, "ltpf_encode"), "side_info_pack": (K, "side_info_pack")}
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


def plain(name: str):
    from audio_codec_torch.ops import analysis, bits
    return {"ltpf_encode": analysis.ltpf_encode_plain,
            "side_info_pack": bits.pack_side_info_plain}[name]


def measure(root: Path, B: int, T: int) -> dict:
    """The times of the checkout at root, in this process."""
    import torch
    r = record(root, B, T)
    from audio_codec_torch import kernels as K
    from tests.torch_kernel_cases import count_differing
    out = {"root": str(root), "card": card(), "streams": B, "frames": T}
    for name in ("ltpf_encode", "side_info_pack"):
        args, fn = r[name]
        got, ref = fn(*args), plain(name)(*args)
        torch.cuda.synchronize()
        run, _, _ = raw_call(name, K.library(), args, B)
        out[name] = {"differ": count_differing(list(got), list(ref)),
                     **times(lambda: fn(*args)),
                     "raw_graph_ms": min(graph_ms(run) for _ in range(3))}
    for name in ("analysis.ltpf_encode", "bits.pack_side_info"):
        args, fn = r[name]
        out[name] = times(lambda: fn(*args))
    return out


def raw_call(name: str, lib, args, n: int):
    """A call of the C entry point `name` of lib on the recorded arguments
    tiled to n streams, converted as the wrapper converts them: (run,
    outputs, the tiled arguments)."""
    import torch
    from audio_codec_torch import kernels as K
    st = lambda: torch.cuda.current_stream().cuda_stream
    fn = getattr(lib, f"acx_{name}")
    fn.argtypes = ARGTYPES[name]
    cfg, *rest = args
    dev = "cuda"
    if name == "ltpf_encode":
        a = [tile(v, n) for v in rest]
        s12k8, pitch_ol, nc_ol, mem_in, mnc, mmnc, mem_on, mpitch = a
        xlen = cfg.len_12k8 + 1
        N, mem_len = xlen - 1, cfg.ltpf_mem_in_len
        acflen, xbase = (2 * N, mem_len - N) if cfg.frame_dms == 25 else (N, mem_len)
        e = lambda *sh, dt=torch.float32: torch.empty((n, *sh), dtype=dt, device=dev)
        param, bits_, on = e(3, dt=torch.int32), e(dt=torch.int32), e(dt=torch.int32)
        new_mem, nc, mm, pitch = e(mem_len), e(), e(), e()
        outs = (param, bits_, new_mem, nc, mm, on, pitch)
        tab = K._ltpf_tables(dev)
        return (lambda: fn(s12k8.data_ptr(), pitch_ol.data_ptr(), nc_ol.data_ptr(),
                           mem_in.data_ptr(), mnc.data_ptr(), mmnc.data_ptr(), mem_on.data_ptr(),
                           mpitch.data_ptr(), tab.data_ptr(), *(t.data_ptr() for t in outs), n,
                           xlen, N, mem_len, acflen, xbase, cfg.frame_dms,
                           int(bool(cfg.ltpf_enable)), st()),
                outs, (cfg, *a))
    bw, lastnz, lsb, gg, ntns, tns_order, ltpf, scf_idx, fac = rest
    B = scf_idx.shape[0]
    conv = [K._i32(v, B, dev) for v in (bw, lastnz, lsb, gg, ntns)]
    conv += [tns_order.to(torch.int32).contiguous(), ltpf.to(torch.int32).contiguous(),
             scf_idx.to(torch.int32).contiguous(), K._i32(fac, B, dev)]
    a = [tile(v, n) for v in conv]
    nbytes = cfg.targetBytes
    buf = torch.empty((n, nbytes), dtype=torch.int32, device=dev)
    cursor = torch.empty((2, n), dtype=torch.int32, device=dev)
    return (lambda: fn(*(t.data_ptr() for t in a), buf.data_ptr(), cursor.data_ptr(), n, nbytes,
                       nbytes - 1, cfg.BW_cutoff_bits, cfg.lastnz_bits, st()),
            (buf, cursor[0], cursor[1]), (cfg, *a))


def builds(root: Path, jobs, B: int, kinds=(2048,)) -> None:
    """Each job (tag, kernel name, label, csrc, substitutions) built and timed
    against the plain version on the rows recorded with the checkout at
    root, two rounds."""
    import torch
    r = record(root, B, 8)
    from tests.torch_kernel_cases import count_differing
    libs = []
    for tag, name, label, csrc, subs in jobs:
        try:
            libs.append((tag, name, label, build(OUT / tag, csrc, f"{name}.cu", subs)))
        except SystemExit as e:   # a variant that does not build is reported, not timed
            print(f"[{name} builds] {card()} | {label}: not built: {e}", flush=True)
    for rnd in range(2):
        for n in kinds:
            for tag, name, label, lib in libs:
                run, outs, args = raw_call(name, lib, r[name][0], n)
                rc = run()
                torch.cuda.synchronize()
                ref = plain(name)(*args)
                differ = count_differing(list(outs), [t.contiguous() for t in ref])
                ms = min(graph_ms(run) for _ in range(3))
                print(f"[{name} builds] {card()} | round {rnd}, {n} streams, {label}: rc {rc}, "
                      f"{differ} values differ from the plain version, raw graph {ms:.5f} ms",
                      flush=True)


def phases(other: Path, B: int) -> None:
    other = other.resolve()
    csrc = other / "audio_codec_torch" / "csrc"
    jobs = [(f"first_{name}_{i}", name, label, csrc, subs)
            for name, cuts in PHASES_FIRST.items()
            for i, (label, subs) in enumerate(cuts.items())]
    builds(other, jobs, B)


def variants(B: int) -> None:
    jobs = [(f"kept_{name}_{i}", name, label, CSRC, subs)
            for name, cuts in VARIANTS.items() for i, (label, subs) in enumerate(cuts.items())]
    builds(ROOT, jobs, B, kinds=(B, 1))


def scaling(root: Path, B: int, T: int) -> None:
    r = record(root, B, T)
    for name in ("ltpf_encode", "side_info_pack"):
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
        raise SystemExit("torch_pitch_side_times: no CUDA device")
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
