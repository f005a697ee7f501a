#!/usr/bin/env python3
"""Times the encoder's open-loop pitch search and the fixed-point decoder's
back end of audio_codec_torch on a CUDA card: the kernels `olpa`
(csrc/olpa.cu, K3) and `fx_ola_ltpf` (csrc/fx_ola_ltpf.cu, K21) on the
inputs the flagship gives them. Every line printed carries the card's name
and power limit.

The inputs: chip_smoke.make_pcm's material at 48 kHz / 64 kbps, B streams,
encoded for T frames by the checkout's own encode_block; olpa's arguments
at the last frame are recorded. The payloads are then decoded by
DeviceFixedDecoder (chip_smoke's phase 8 block, its last 64 streams
silent), and fx_ola_ltpf's arguments at the last frame, with a copy of the
state it met, are recorded. Each kernel is checked against its plain
version bit for bit, then timed as median loop ms (5 loops of 20 calls)
and graph ms (20 calls replayed from a CUDA graph, the best of 3); every
timed fx_ola_ltpf call first copies the recorded state into the working
state, and the copy, timed alone, is taken off. `raw` is the C entry point
alone on the arguments as the wrapper hands them over.

  (default)     this checkout, one JSON line.
  --other DIR   the same for a checkout of another commit (the parent
                unpacked with `git archive` into a directory that .gitignore
                lists), in turns with this one, each in a process of its
                own: other, this, this, other.
  --phases DIR  the kernels of the checkout DIR with one phase removed
                (PHASES_FIRST: olpa's staging alone, no lag chains, no e0,
                no searches; fx_ola_ltpf with no filter passes, the OLA and
                rescaling alone, the PCM and state writes alone), built from
                DIR's sources with text substitutions and run on DIR's
                recorded rows: raw graph ms at B streams, two rounds; and
                DIR's registers, shared memory and streams resident at B.
  --variants    this checkout's kept designs at other block sizes and with
                their other choices, and with one phase removed at a time
                (VARIANTS), built from this checkout's sources with text
                substitutions: raw graph ms at B streams and at 1, two
                rounds; and this checkout's registers, shared memory and
                streams resident at B.
  --scaling     both kernels at 4, 32, 512 and 2048 streams of the recorded
                rows (tiled): graph ms of the wrappers.

    python3 tools/torch_olpa_ola_times.py [--streams 2048] [--frames 8] [--other DIR]
    python3 tools/torch_olpa_ola_times.py --phases DIR --variants --scaling
"""
from __future__ import annotations

import argparse
import ctypes
from concurrent.futures import ThreadPoolExecutor
import json
import re
import shutil
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT / "tools"))
from torch_dct4_times import NVCC_FLAGS, card, graph_ms, nvcc  # noqa: E402
from torch_ltpf_times import make_pcm, times  # noqa: E402
from torch_sns_nf_times import tile  # noqa: E402

CSRC = ROOT / "audio_codec_torch" / "csrc"
OUT = ROOT / "build" / "olpa_ola_times"
SILENT = 64     # chip_smoke.FIXED_SILENT
P_, I_ = ctypes.c_void_p, ctypes.c_int
ARGTYPES = {"olpa": [P_] * 10 + [I_] * 8 + [P_],
            "fx_ola_ltpf": [P_] * 17 + [I_, P_, P_]}
MAIN = {"olpa": "olpa.cu", "fx_ola_ltpf": "fx_ola_ltpf.cu"}

# streams resident on the card: a query appended to a build of the kernel's
# file (cudaOccupancyMaxActiveBlocksPerMultiprocessor times the SMs times the
# streams a block); KERNEL is the kernel's name, a template's at ACF 64
OCCUPANCY = {
    "olpa": r"""
#ifdef __CUDACC__
extern "C" int acx_resident(int) {
  int n = 0, sms = 0;
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, KERNEL, 32 * kOlpaWarps, 0);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, 0);
  return n * sms * kOlpaWarps;
}
#endif
""",
    "fx_ola_ltpf": r"""
extern "C" int acx_resident(int words) {
  int n = 0, sms = 0;
  const size_t smem = static_cast<size_t>(kFxOlaWarps) * words * sizeof(SCRATCH_WORD);
  cudaFuncSetAttribute(fx_ola_ltpf_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                       static_cast<int>(smem));
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, fx_ola_ltpf_kernel, 32 * kFxOlaWarps, smem);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, 0);
  return n * sms * kFxOlaWarps;
}
""",
}

# the parent's designs with one phase removed: text substitutions (file,
# old, new) of the sources of the checkout given to --phases
_OP_MP = "  const int mp = mem_pitch[b];\n"
_OP_LAG = "      olpa_lag_sums(row, g, l, &r, &e);\n"
_OP_E0 = "    const float e0 = olpa_energy(row, g);\n"
_OP_SEARCH = "  warp_first_max(&bv, &bi);\n  warp_first_max(&bv2, &bi2);\n"
_FX_LEADER = "    if (w.leader()) {\n      // the four first-phase patterns; the filters on lane 0\n"
_FX_OLA = "  // ---- imdct_ola: exponent alignment\n"
_FX_RESCALED = ("    w.each(Wy, [&](int i) { ybuf[i] = i < y_len ? scale_sig(ybuf[i], h_scale) : 0; });\n"
                "    w.sync();\n")
PHASES_FIRST = {
    "olpa": {
        "first design as it is": (),
        "staging alone (the row staged and decimated, the memories written)": (
            ("olpa.cu", _OP_MP, "  if (B > 0) {\n    if (lane == 0) nc[b] = row[g.base] + row[0];\n"
                                "    return;\n  }\n" + _OP_MP),),
        "no lag chains (R and E of a lag one product each)": (
            ("olpa.cu", _OP_LAG,
             "      r = rmul(row[g.base], row[g.base - kOlpaMinPitch - l]);\n"
             "      e = rmul(row[g.base - kOlpaMinPitch - l], row[g.base - kOlpaMinPitch - l]);\n"),),
        "no e0 (lane 0's energy chain one sample)": (
            ("olpa.cu", _OP_E0, "    const float e0 = row[g.base];\n"),),
        "no searches (the shuffle trees skipped)": (("olpa.cu", _OP_SEARCH, ""),),
    },
    "fx_ola_ltpf": {
        "first design as it is": (),
        "no filter passes (lane 0's passes skipped)": (
            ("fx_ola_ltpf.cuh", _FX_LEADER, _FX_LEADER.replace("w.leader()", "w.leader() && g.N < 0")),),
        "the OLA and rescaling alone (no filter, no PCM, no history writes)": (
            ("fx_ola_ltpf.cuh", _FX_RESCALED, _FX_RESCALED + "    if (g.N > 0) return;\n"),),
        "the PCM and state writes alone": (
            ("fx_ola_ltpf.cuh", _FX_OLA,
             "  if (g.N > 0) {\n"
             "    w.each(N, [&](int i) { pcm[i] = static_cast<int16_t>(ytda[i]); });\n"
             "    w.each(x_len, [&](int k) { st.old_x[k] = ytda[k]; });\n"
             "    w.each(y_len, [&](int k) { st.old_y[k] = ytda[k % N]; });\n"
             "    w.each(memLen, [&](int k) { st.mem[k] = ytda[k]; });\n"
             "    return;\n  }\n" + _FX_OLA),),
    },
}

# the kept designs at other block sizes, with their other choices, and with
# one phase removed: text substitutions (file, old, new) of this checkout
_OK_WARPS = "constexpr int kOlpaWarps = 4;   // streams a block"
_OK_CUR = "  float c[ACF];\n#pragma unroll\n  for (int n = 0; n < ACF; n += 4) olpa_quad(cur + n, c + n);\n"
_OK_SQ = "      const float q = rmul(x, x);\n"
_OK_SQ3 = "        const float p = rmul(c[i], y), q3 = rmul(y, y);\n"
_OK_CHAINS = "  olpa_chains<ACF>(w, olpa_row(S, g), g, r, e);\n"
_OK_STAGE = "  olpa_stage(w, s, tab, g, S, new_mem12, new_mem64);\n"
_FK_WARPS = "constexpr int kFxOlaWarps = 4;"
_FK_CHUNK = "  const int c = static_cast<int>(min64(d, kOlaChunk));\n"
_FK_FILTERS = "    synth_filter_warp(w, ybuf, Wy, y_len, xbuf, x_len, g.N4, pint_A, gain_A, icA, tcA, g, fade_A);\n"
_FK_PCM = "  // ---- round_pcm16 (dec_lc3.c:289-295)\n"
_FK_NO_ASM = tuple(("fixed.cuh", f'#ifdef __CUDA_ARCH__\n  int32_t r;\n  asm("{op}.sat.s32',
                     f'#if 0\n  int32_t r;\n  asm("{op}.sat.s32') for op in ("add", "sub"))
VARIANTS = {
    "olpa": {
        "kept: blocks of 4 warps, the block in registers, squares in registers": (),
        "blocks of 2 warps": (("olpa.cu", _OK_WARPS, "constexpr int kOlpaWarps = 2;"),),
        "blocks of 8 warps": (("olpa.cu", _OK_WARPS, "constexpr int kOlpaWarps = 8;"),),
        "the block by broadcast loads from shared memory": (
            ("olpa.cuh", _OK_CUR, "  const float* c = cur;\n"),),
        "squares in shared memory (made once a warp, lane-parallel)": (
            ("olpa.cuh", "  alignas(16) float row[kOlpaMaxRow + 4];\n",
             "  alignas(16) float row[kOlpaMaxRow + 4];\n  float sq[kOlpaMaxRow + 4];\n"),
            ("olpa.cuh", _OK_CHAINS,
             "  {\n    const float* rw = olpa_row(S, g);\n    const int n = g.mem_in_len + g.len2;\n"
             "    w.lanes([&](int l) {\n      for (int i = l; i < n; i += kCoderLanes) "
             "S.sq[i] = rmul(rw[i], rw[i]);\n    });\n    w.sync();\n  }\n"
             "  olpa_chains<ACF>(w, olpa_row(S, g), g, r, e, S.sq - olpa_row(S, g));\n"),
            ("olpa.cuh", "                        typename W::template Lanes<float> (&e)[kOlpaSlots]) {\n",
             "                        typename W::template Lanes<float> (&e)[kOlpaSlots], long sqo) {\n"),
            ("olpa.cuh", _OK_SQ, "      const float q = win[sqo + i];\n"),
            ("olpa.cuh", _OK_SQ3, "        const float p = rmul(c[i], y), q3 = s3[sqo + i];\n")),
        "phase cut: staging alone (the row staged and decimated, the memories written)": (
            ("olpa.cuh", _OK_STAGE, _OK_STAGE + "  if (g.acflen > 0) {\n    OlpaOut o = {0, olpa_row(S, g)[g.base]};\n"
                                    "    return o;\n  }\n"),),
        "phase cut: no lag chains (R and E one product each)": (
            ("olpa.cuh", "    for (int i = 0; i < ACF + 64; ++i) {\n", "    for (int i = 64; i < 65; ++i) {\n"),),
        "phase cut: no e0 (slot 3 on lanes 0-1 alone)": (
            ("olpa.cuh", "      if (i < ACF) {\n        const float y = s3[i];\n",
             "      if (i < ACF && l < 2) {\n        const float y = s3[i];\n"),),
    },
    "fx_ola_ltpf": {
        "kept: blocks of 4 warps, int32 buffers, chunks of min(32, d)": (),
        "blocks of 1 warp": (("fx_ola_ltpf.cu", _FK_WARPS, "constexpr int kFxOlaWarps = 1;"),),
        "blocks of 2 warps": (("fx_ola_ltpf.cu", _FK_WARPS, "constexpr int kFxOlaWarps = 2;"),),
        "int64 buffers": (("fx_ola_ltpf.cuh", "using OlaWord = int32_t;", "using OlaWord = i64;"),),
        "chunks of 32 whatever d (right only where d >= 32, as at 48 kHz)": (
            ("fx_ola_ltpf.cuh", _FK_CHUNK, "  const int c = kOlaChunk;\n"),),
        "saturating adds in C (no inline asm)": _FK_NO_ASM,
        "phase cut: no filter passes": (
            ("fx_ola_ltpf.cuh", "  if (d <= 0) {\n", "  if (g.N > 0) return;\n  if (d <= 0) {\n"),),
        "phase cut: the OLA and rescaling alone": (
            ("fx_ola_ltpf.cuh", _FK_FILTERS, "    if (g.N > 0) return;\n" + _FK_FILTERS),),
        "phase cut: no PCM rounding (nor the scalar state writes)": (
            ("fx_ola_ltpf.cuh", _FK_PCM, "  if (g.N > 0) return;\n" + _FK_PCM),),
    },
}


def build(d: Path, csrc: Path, main: str, subs=(), append: str = "") -> tuple[ctypes.CDLL, str]:
    """nvcc builds `main` of a copy of csrc with the substitutions (file,
    old, new) applied and `append` at the end of main, in d: (library,
    ptxas's register and shared-memory lines)."""
    shutil.rmtree(d, ignore_errors=True)
    shutil.copytree(csrc, d)
    for name, old, new in subs:
        text = (d / name).read_text()
        if old not in text:
            raise SystemExit(f"{old!r} is not in {csrc / name}")
        (d / name).write_text(text.replace(old, new))
    if append:
        (d / main).write_text((d / main).read_text() + append)
    r = subprocess.run([nvcc(), *NVCC_FLAGS, f"-I{d}", "-o", str(d / "lib.so"), str(d / main)],
                       capture_output=True, text=True)
    if r.returncode:
        raise SystemExit(f"nvcc failed in {d.name}:\n{r.stdout}{r.stderr}")
    usage = " | ".join(m.strip() for m in re.findall(r"ptxas info\s*: (?:Function properties for \S+|"
                                                    r"Compiling entry function '[^']*'|Used [^\n]*)",
                                                    r.stdout + r.stderr))
    return ctypes.CDLL(str(d / "lib.so")), usage


_RECORDED: dict = {}


def record(root: Path, B: int, T: int) -> dict:
    """The flagship's T-frame encode of B streams and the fixed-point decode
    of its payloads with the checkout at root: olpa's last call (the stage
    and the kernel) and fx_ola_ltpf's last call, its state copied before it.
    The first checkout a process imports runs the encode and decode: every
    checkout's kernels equal the same plain versions, so their rows are the
    same."""
    key = (B, T)
    if key not in _RECORDED:
        _RECORDED[key] = _record(root, B, T)
    return _RECORDED[key]


def _record(root: Path, B: int, T: int) -> dict:
    import torch
    sys.path.insert(0, str(root))
    import audio_codec_torch as P
    from audio_codec_torch import kernels as K
    from audio_codec_torch.fixed_decoder_dev import DeviceFixedDecoder
    from audio_codec_torch.ops import analysis
    K.library()
    cfg = P.Config(fs_in=48000, bitrate=64000)
    pcm = torch.from_numpy(make_pcm(T, B, 480)).cuda()
    calls = {"analysis.olpa": [], "olpa": [], "fx_ola_ltpf": []}
    saved = (analysis.olpa, K.olpa, K.fx_ola_ltpf)

    def rec(name, fn):
        def f(*a):
            calls[name].append(a)
            return fn(*a)
        return f

    def rec_state(*a):
        cfg_, st, *rest = a
        calls["fx_ola_ltpf"].append((cfg_, {k: v.clone() for k, v in st.items()}, *rest))
        return saved[2](*a)
    analysis.olpa, K.olpa = rec("analysis.olpa", saved[0]), rec("olpa", saved[1])
    try:
        _, frames = P.encode_block(cfg, P.enc_state_init(cfg, B), pcm)
        analysis.olpa, K.olpa = saved[:2]     # the flagship's calls only
        silent = torch.zeros((T, SILENT, cfg.frame_length), device="cuda")
        _, quiet = P.encode_block(cfg, P.enc_state_init(cfg, SILENT), silent)
        frames[:, B - SILENT:] = quiet
        K.fx_ola_ltpf = rec_state
        DeviceFixedDecoder(cfg, B).decode_block(frames)
    finally:
        analysis.olpa, K.olpa, K.fx_ola_ltpf = saved
    torch.cuda.synchronize()
    return {"analysis.olpa": (calls["analysis.olpa"][-1], saved[0]),
            "olpa": (calls["olpa"][-1], saved[1]),
            "fx_ola_ltpf": (calls["fx_ola_ltpf"][-1], saved[2]), "frames": frames}


def plain(name: str):
    from audio_codec_torch.ops import analysis, fixed_ltpf_dev
    return {"olpa": analysis.olpa_plain, "fx_ola_ltpf": fixed_ltpf_dev.ola_ltpf_plain}[name]


def with_state(args):
    """fx_ola_ltpf's recorded arguments with a working state of its own, and
    the copy of the recorded state into it (restore)."""
    cfg, snap, *rest = args
    work = {k: v.clone() for k, v in snap.items()}

    def restore():
        for k, v in snap.items():
            work[k].copy_(v)
    return (cfg, work, *rest), restore


def check(name: str, fn, args) -> int:
    """Values of the kernel's outputs (and state) that differ from the plain
    version's on the same inputs."""
    import torch
    from tests.torch_kernel_cases import count_differing
    if name == "olpa":
        got, ref = fn(*args), plain(name)(*args)
        torch.cuda.synchronize()
        return count_differing(list(got), list(ref))
    a_k, restore = with_state(args)
    a_p, _ = with_state(args)
    restore()
    got, ref = fn(*a_k), plain(name)(*a_p)
    torch.cuda.synchronize()
    return count_differing([got, a_k[1]], [ref, a_p[1]])


def timed(name: str, fn, args) -> dict:
    """times() of fn on args; for fx_ola_ltpf every call from the recorded
    state, the copy's own times taken off."""
    if name == "olpa":
        return times(lambda: fn(*args))
    a, restore = with_state(args)
    t = times(lambda: (restore(), fn(*a)))
    c = times(restore)
    return {k: t[k] - c[k] for k in t} | {"state_copy_" + k: c[k] for k in c}


def measure(root: Path, B: int, T: int) -> dict:
    """The times of the checkout at root, in this process."""
    r = record(root, B, T)
    from audio_codec_torch import kernels as K
    out = {"root": str(root), "card": card(), "streams": B, "frames": T}
    for name in ("olpa", "fx_ola_ltpf"):
        args, fn = r[name]
        run, _, _, restore = raw_call(name, K.library(), args, B)
        raw = min(graph_ms(lambda: (restore(), run())) for _ in range(3))
        if name == "fx_ola_ltpf":
            raw -= min(graph_ms(restore) for _ in range(3))
        out[name] = {"differ": check(name, fn, args), **timed(name, fn, args),
                     "raw_graph_ms": raw}
    args, fn = r["analysis.olpa"]
    out["analysis.olpa"] = times(lambda: fn(*args))
    out["fixed_decode_streams"] = decode_streams(r["frames"])
    return out


def decode_streams(frames) -> dict:
    """chip_smoke's phase 8 metric on the recorded block: T·B frames / s /
    100 of DeviceFixedDecoder.decode_block (CUDA events around one block
    after a warm-up block), five blocks: their median and all."""
    import statistics
    import torch
    from audio_codec_torch.fixed_decoder_dev import DeviceFixedDecoder
    import audio_codec_torch as P
    T, B = frames.shape[:2]
    dd = DeviceFixedDecoder(P.Config(fs_in=48000, bitrate=64000), B)
    dd.decode_block(frames)
    runs = []
    for _ in range(5):
        e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        e0.record()
        dd.decode_block(frames)
        e1.record()
        torch.cuda.synchronize()
        runs.append(T * B / (e0.elapsed_time(e1) / 1e3) / 100.0)
    return {"median": statistics.median(runs), "runs": runs}


def raw_call(name: str, lib, args, n: int):
    """A call of the C entry point `name` of lib on the recorded arguments
    tiled to n streams, converted as the wrapper converts them: (run,
    outputs, the tiled arguments, restore). For fx_ola_ltpf the outputs
    include the working state, and restore copies the recorded state into
    it; for olpa restore does nothing."""
    import torch
    from audio_codec_torch import kernels as K
    st = lambda: torch.cuda.current_stream().cuda_stream
    fn = getattr(lib, f"acx_{name}")
    fn.argtypes = ARGTYPES[name]
    dev = "cuda"
    if name == "olpa":
        cfg, s12k8, m12, m64, mp = args
        a = [tile(v, n) for v in (s12k8, m12, m64, mp.to(torch.int32))]
        length = cfg.len_12k8
        mem_in_len = m64.shape[1]
        acflen = length // 2 + (16 if cfg.frame_dms == 25 else 0)
        base = mem_in_len - 16 if cfg.frame_dms == 25 else mem_in_len
        pitch2, t0 = (torch.empty((n,), dtype=torch.int32, device=dev) for _ in range(2))
        nc = torch.empty((n,), dtype=torch.float32, device=dev)
        n12, n64 = torch.empty_like(a[1]), torch.empty_like(a[2])
        outs = (pitch2, nc, t0, n12, n64)
        tab = K._olpa_tables(dev)
        return (lambda: fn(*(v.data_ptr() for v in a), tab.data_ptr(),
                           *(v.data_ptr() for v in outs), n, a[0].shape[1], mem_in_len, length,
                           length // 2, mem_in_len, acflen, base, st()),
                outs, (cfg, *a), lambda: None)
    cfg, snap, ytda, y_e, y_s, zero, lp, sfi = args
    snap = {k: tile(v, n) for k, v in snap.items()}
    a = [tile(v, n) for v in (ytda, y_e, y_s, zero, lp.to(torch.int32))]
    work = {k: v.clone() for k, v in snap.items()}
    geom = K.fx_ola_geometry(cfg, sfi)
    g = (ctypes.c_int * len(geom))(*geom)
    tab = K.nm.table(K.fx_ola_table_pack, cfg.frame_length, cfg.fs_idx, device=dev,
                     dtype=torch.int64)
    pcm = torch.empty((n, cfg.frame_length), dtype=torch.int16, device=dev)

    def restore():
        for k, v in snap.items():
            work[k].copy_(v)
    return (lambda: fn(*(v.data_ptr() for v in a), tab.data_ptr(),
                       *(work[k].data_ptr() for k in K.FX_STATE_KEYS), pcm.data_ptr(), n,
                       ctypes.cast(g, ctypes.c_void_p), st()),
            (pcm, work), (cfg, snap, *a, sfi), restore)


def resident(name: str, csrc: Path, tag: str, args) -> str:
    """The streams of `name` resident on the card at once, from a build of
    csrc with the occupancy query appended."""
    from audio_codec_torch import kernels as K
    text = (csrc / MAIN[name]).read_text()
    word = "OlaWord" if "OlaWord smem" in text else "i64"
    kernel = "olpa_kernel<64>" if "template <int ACF>\n__global__ void olpa_kernel" in text \
        else "olpa_kernel"
    query = OCCUPANCY[name].replace("SCRATCH_WORD", word).replace("KERNEL", kernel)
    lib, _ = build(OUT / f"resident_{tag}_{name}", csrc, MAIN[name], append=query)
    lib.acx_resident.argtypes = [I_]
    cfg = args[0]
    if name == "olpa":
        return f"{lib.acx_resident(cfg.len_12k8 // 2)} streams resident"
    g = K.fx_ola_geometry(cfg, args[-1])
    N, wLen, x_len, y_len, tlen, N4 = g[0], g[1], g[2], g[3], g[5], g[7]
    pad = 10 if "kOlaPad" in (csrc / "fx_ola_ltpf.cuh").read_text() else 0
    words = pad + (x_len + N) + (y_len + N) + (wLen - N) + (tlen + N4)
    return f"{lib.acx_resident(words)} streams resident ({words} words of {word} a stream)"


def usage(root: Path, csrc: Path, tag: str, B: int) -> None:
    """ptxas's registers and shared memory and the streams resident, for the
    two kernels of csrc."""
    r = record(root, B, 8)
    names = ("olpa", "fx_ola_ltpf")
    with ThreadPoolExecutor(max_workers=4) as ex:
        ptx = list(ex.map(lambda n: build(OUT / f"usage_{tag}_{n}", csrc, MAIN[n])[1], names))
        res = list(ex.map(lambda n: resident(n, csrc, tag, r[n][0]), names))
    for name, p, s in zip(names, ptx, res):
        print(f"[{name} usage] {card()} | {tag}: {p}", flush=True)
        print(f"[{name} usage] {card()} | {tag}: {s}", flush=True)


def builds(root: Path, jobs, B: int, kinds=(2048,)) -> None:
    """Each job (tag, kernel name, label, csrc, substitutions) built and timed
    against the plain version on the rows recorded with the checkout at
    root, two rounds."""
    import torch
    r = record(root, B, 8)
    from tests.torch_kernel_cases import count_differing
    libs = []

    def one(job):
        tag, name, label, csrc, subs = job
        try:
            return tag, name, label, build(OUT / tag, csrc, MAIN[name], subs)[0]
        except SystemExit as e:   # a variant that does not build is reported, not timed
            print(f"[{name} builds] {card()} | {label}: not built: {e}", flush=True)
            return None
    with ThreadPoolExecutor(max_workers=8) as ex:   # one nvcc a job, all started together
        libs = [b for b in ex.map(one, jobs) if b is not None]
    for rnd in range(2):
        for n in kinds:
            for tag, name, label, lib in libs:
                run, outs, args, restore = raw_call(name, lib, r[name][0], n)
                restore()
                rc = run()
                torch.cuda.synchronize()
                if name == "olpa":
                    ref = plain(name)(*args)
                    differ = count_differing(list(outs), [t.contiguous() for t in ref])
                else:
                    cfg, snap, *rest = args
                    st = {k: v.clone() for k, v in snap.items()}
                    ref = plain(name)(cfg, st, *rest)
                    differ = count_differing([outs[0], outs[1]], [ref, st])
                ms = min(graph_ms(lambda: (restore(), run())) for _ in range(3))
                if name == "fx_ola_ltpf":
                    ms -= min(graph_ms(restore) for _ in range(3))
                print(f"[{name} builds] {card()} | round {rnd}, {n} streams, {label}: rc {rc}, "
                      f"{differ} values differ from the plain version, raw graph {ms:.5f} ms",
                      flush=True)


def phases(other: Path, B: int) -> None:
    other = other.resolve()
    csrc = other / "audio_codec_torch" / "csrc"
    usage(other, csrc, "other", B)
    jobs = [(f"first_{name}_{i}", name, label, csrc, subs)
            for name, cuts in PHASES_FIRST.items()
            for i, (label, subs) in enumerate(cuts.items())]
    builds(other, jobs, B)


def variants(B: int) -> None:
    usage(ROOT, CSRC, "this", B)
    jobs = [(f"kept_{name}_{i}", name, label, CSRC, subs)
            for name, cuts in VARIANTS.items() for i, (label, subs) in enumerate(cuts.items())]
    builds(ROOT, jobs, B, kinds=(B, 1))


def scaling(root: Path, B: int, T: int) -> None:
    r = record(root, B, T)
    for name in ("olpa", "fx_ola_ltpf"):
        args, fn = r[name]
        for n in (4, 32, 512, 2048):
            a = tuple({k: tile(v, n) for k, v in x.items()} if isinstance(x, dict) else tile(x, n)
                      for x in args)
            if name == "olpa":
                ms = min(graph_ms(lambda: fn(*a)) for _ in range(3))
            else:
                aw, restore = with_state(a)
                ms = (min(graph_ms(lambda: (restore(), fn(*aw))) for _ in range(3))
                      - min(graph_ms(restore) for _ in range(3)))
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
        raise SystemExit("torch_olpa_ola_times: no CUDA device")
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
