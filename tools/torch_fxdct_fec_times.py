#!/usr/bin/env python3
"""Times the fixed-point decoder's DCT-IV and the channel coder's decoder of
audio_codec_torch on a CUDA card: the kernels `fx_dct4` (csrc/fx_dct4.cu,
K20c) and `fec_decode` (csrc/fec_decode.cu, K19 dec) on the inputs the smoke
run's phases give them. Every line printed carries the card's name and power
limit.

The inputs. K20c: chip_smoke's phase 8 block (make_pcm's material encoded
for 8 frames, its last 64 streams silent) through
DeviceFixedDecoder.decode_block; its one fx_dct4 launch over the T x B rows
is recorded. K19 dec: chip_smoke's phase 6 at EP3 (StreamEncoder, the
channel's errors of stream_plan, StreamDecoder; B streams, 8 frames); its
last fec_decode launch is recorded. Each kernel is checked against its plain
version bit for bit, then timed as median loop ms (5 loops of 20 calls) and
graph ms (20 calls replayed from a CUDA graph, the best of 3); `raw` is the
C entry point alone on the arguments as the wrapper hands them over (graph
ms).

  (default)     this checkout, one JSON line.
  --other DIR   the same for a checkout of another commit (the parent
                unpacked with `git archive` into a directory that .gitignore
                lists), in turns with this one, each in a process of its
                own: other, this, this, other.
  --phases DIR  the kernels of the checkout DIR with one phase removed, and
                K19 dec's thread design in blocks of 32 and 16 (PHASES_FIRST),
                built from DIR's sources with text substitutions and run on
                the recorded rows: raw graph ms, two rounds; and DIR's
                registers, spills, shared memory and rows or slots resident.
  --variants    this checkout's kept designs with their other choices and
                with one phase removed (VARIANTS), built from this
                checkout's sources with text substitutions: raw graph ms,
                two rounds, each checked against the plain version; and this
                checkout's registers, spills, shared memory and rows or slots
                resident.
  --scaling     K20c at 16, 256, 4096 and 16384 rows, K19 dec at 4, 32, 512
                and 2048 slots of the recorded rows (tiled): graph ms of the
                wrappers.
  --clocks      the kernels built with clock64() stamps at their stage
                boundaries (CLOCKS): each stage's cycles on the recorded
                launches, median and 90th percentile over the warps.

    python3 tools/torch_fxdct_fec_times.py [--streams 2048] [--other DIR]
    python3 tools/torch_fxdct_fec_times.py --phases DIR --variants --scaling --clocks
"""
from __future__ import annotations

import argparse
import ctypes
from concurrent.futures import ThreadPoolExecutor
import json
import re
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT / "tools"))
sys.path.insert(0, str(ROOT))
from torch_dct4_times import NVCC_FLAGS, card, graph_ms, nvcc  # noqa: E402,F401
from torch_ltpf_times import make_pcm, times  # noqa: E402
from torch_sns_nf_times import tile  # noqa: E402
from torch_tdc_fxspec_times import CLOCK_PRELUDE, CLOCK_READ, OCCUPANCY  # noqa: E402

CSRC = ROOT / "audio_codec_torch" / "csrc"
OUT = ROOT / "build" / "fxdct_fec_times"
SILENT = 64            # chip_smoke.FIXED_SILENT
FIXED_T = 8            # phase 8's block
STREAM_T = 8           # phase 6's frames
P_, I_ = ctypes.c_void_p, ctypes.c_int
ARGTYPES = {"fx_dct4": [P_] * 7 + [I_] + [P_], "fec_decode": [P_] * 5 + [I_] * 3 + [P_]}
MAIN = {"fx_dct4": "fx_dct4.cu", "fec_decode": "fec_decode.cu"}
KERNEL = {"fx_dct4": "fx_dct4_kernel", "fec_decode": "fec_decode_kernel"}
CASES = {"fx_dct4": ("block",), "fec_decode": ("ep3",)}

# the parent's designs with one phase removed, and K19 dec's cheap change:
# text substitutions (file, old, new) of the sources of the checkout given to
# --phases
_FP_FFT30 = "  g.each(8, [&](int c) { fft30_col(a, b, c); });\n"
_FP_RADIX8 = "  g.each(30, [&](int i) { n2_8_row(b, a, i, tab + kDctRot); });\n"
_FP_PRE = "  g.each(kDctM / 2, [&](int k) { dct4_pre(b, a, k, tab + kDctTw); });\n"
_FP_POST = "  g.each(kDctM / 2, [&](int t) { dct4_post(a, b, t, tab + kDctSin); });\n"
_FP_HEAD = (("fx_dct4.cuh", "  const i64 hs = headroom32_0(g, a, kDctN);", "  const i64 hs = 1;"),
            ("fx_dct4.cuh", "  const i64 s2 = headroom32_0(g, b, kDctN) - 1;", "  const i64 s2 = 0;"))
PHASES_FIRST = {
    "fx_dct4": {
        "first design as it is": (),
        "no fft30 columns": (("fx_dct4.cuh", _FP_FFT30, ""),),
        "no radix-8 rows": (("fx_dct4.cuh", _FP_RADIX8, ""),),
        "no headroom minima": _FP_HEAD,
        "staging and the writes alone (no twiddles, FFTs or minima)": _FP_HEAD + (
            ("fx_dct4.cuh", _FP_PRE, ""), ("fx_dct4.cuh", _FP_FFT30, ""),
            ("fx_dct4.cuh", _FP_RADIX8, ""), ("fx_dct4.cuh", _FP_POST, "")),
    },
    "fec_decode": {
        "first design as it is (a thread a slot, blocks of 64)": (),
        "a thread a slot, blocks of 32": (
            ("fec_decode.cu", "constexpr int kFecDecThreads = 64;", "constexpr int kFecDecThreads = 32;"),),
        "a thread a slot, blocks of 16": (
            ("fec_decode.cu", "constexpr int kFecDecThreads = 64;", "constexpr int kFecDecThreads = 16;"),),
    },
}

# this checkout's kept designs with their other choices and one phase
# removed: text substitutions (file, old, new)
_FK_FFT15 = "  g.each(16, [&](int q) { fft15_half(a, b, q >> 1, q & 1); });\n"
_FK_RADIX8 = "  g.each(30, [&](int i) { n2_8_row(b, a, i, tab + kDctRot); });\n"
_FK_PRE = "  g.each(kDctM / 2, [&](int k) { dct4_pre(a, k, ys, tab + kDctTw); });\n"
_FK_L1 = (
    ("fx_dct4.cu", "  __shared__ w32 tabs[kFxDctTableWords];\n  acx_load_shared(tabs, tab, kFxDctTableWords);\n"
     "  __syncthreads();\n", ""),
    ("fx_dct4.cu", "y_e_in[r], tabs, buf", "y_e_in[r], tab, buf"))
_FK_ROW = (("fx_dct4.cu", "constexpr int kFxDctRowLanes = 16;", "constexpr int kFxDctRowLanes = 32;"),)
_KM_MUL = "  ACX_HDM int mul(int a, int b) const { return w[kFecMul + a * 16 + b]; }"
# the GF(16) product in registers: a carry-less multiply, then x^4 = x + 1
_KM_MUL_REG = ("  ACX_HDM int mul(int a, int b) const {\n"
               "    int r = (b & 1 ? a : 0) ^ (b & 2 ? a << 1 : 0) ^ (b & 4 ? a << 2 : 0) ^ (b & 8 ? a << 3 : 0);\n"
               "    r ^= (r & 64 ? 0x13 << 2 : 0);\n    r ^= (r & 32 ? 0x13 << 1 : 0);\n"
               "    return r ^ (r & 16 ? 0x13 : 0);\n  }")
VARIANTS = {
    "fx_dct4": {
        "kept: two rows a warp, blocks of 4 warps, int32 words, tables in shared memory": (),
        "a warp a row": _FK_ROW,
        "tables through L1": _FK_L1,
        "a warp a row, tables through L1": _FK_ROW + _FK_L1,
        "blocks of 2 warps": (("fx_dct4.cu", "constexpr int kFxDctWarps = 4;", "constexpr int kFxDctWarps = 2;"),),
        "blocks of 8 warps": (("fx_dct4.cu", "constexpr int kFxDctWarps = 4;", "constexpr int kFxDctWarps = 8;"),),
        "at most 64 registers (8 blocks an SM)": (
            ("fx_dct4.cu", "__launch_bounds__(32 * kFxDctWarps)", "__launch_bounds__(32 * kFxDctWarps, 8)"),),
        "phase cut: no fft15 halves": (("fx_dct4.cuh", _FK_FFT15, ""),),
        "phase cut: no radix-8 rows": (("fx_dct4.cuh", _FK_RADIX8, ""),),
        "phase cut: staging and writes alone (no FFTs, no pre-twiddle)": (
            ("fx_dct4.cuh", _FK_FFT15, ""), ("fx_dct4.cuh", _FK_RADIX8, ""),
            ("fx_dct4.cuh", _FK_PRE, "")),
    },
    "fec_decode": {
        "kept: a warp a slot, blocks of 4 warps, GF(16) products from the shared table, CRC terms over the lanes": (),
        "blocks of 1 warp": (("fec_decode.cu", "constexpr int kFecDecWarps = 4;", "constexpr int kFecDecWarps = 1;"),),
        "blocks of 2 warps": (("fec_decode.cu", "constexpr int kFecDecWarps = 4;", "constexpr int kFecDecWarps = 2;"),),
        "blocks of 8 warps": (("fec_decode.cu", "constexpr int kFecDecWarps = 4;", "constexpr int kFecDecWarps = 8;"),),
        "GF(16) products in registers (carry-less multiply)": (("fec.cuh", _KM_MUL, _KM_MUL_REG),),
        "phase cut: no detections": (
            ("fec.cuh", "      const int d = l < 18 ? fec_detect_word(", "      const int d = l < 0 ? fec_detect_word("),),
        "phase cut: no CRC terms (the remainders zero)": (
            ("fec.cuh", "    for (int i = l; i < n; i += 32) {\n      const int vi = v[i];",
             "    for (int i = l; i < 0; i += 32) {\n      const int vi = v[i];"),),
    },
}


def build(d: Path, csrc: Path, main: str, subs=(), append: str = "") -> tuple[ctypes.CDLL, str]:
    """nvcc builds `main` of a copy of csrc with the substitutions (file,
    old, new) applied and `append` at the end of main, in d: (library,
    ptxas's register, spill and shared-memory lines)."""
    import shutil
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
    usage = " | ".join(m.strip() for m in re.findall(
        r"ptxas info\s*: (?:Compiling entry function '[^']*'|Used [^\n]*)|\d+ bytes stack frame[^\n]*",
        r.stdout + r.stderr))
    return ctypes.CDLL(str(d / "lib.so")), usage


_RECORDED: dict = {}


def record(root: Path, B: int) -> dict:
    """The recorded arguments (see the module's docstring), made once a
    process with the first checkout it imports: every checkout's kernels
    equal the same plain versions, so their rows are the same."""
    if B not in _RECORDED:
        _RECORDED[B] = _record(root, B)
    return _RECORDED[B]


def _record(root: Path, B: int) -> dict:
    import numpy as np
    import torch
    sys.path.insert(0, str(root))
    import audio_codec_torch as P
    from audio_codec_torch import engine, kernels as K
    from audio_codec_torch.fixed_decoder_dev import DeviceFixedDecoder
    from tests import torch_kernel_cases as C
    K.library()
    dev = "cuda"
    # K20c: phase 8's block
    cfg = P.Config(fs_in=48000, bitrate=64000)
    pcm = torch.from_numpy(make_pcm(FIXED_T, B, 480)).to(dev)
    _, frames = P.encode_block(cfg, P.enc_state_init(cfg, B, device=dev), pcm)
    silent = torch.zeros((FIXED_T, SILENT, 480), device=dev)
    _, quiet = P.encode_block(cfg, P.enc_state_init(cfg, SILENT, device=dev), silent)
    frames[:, B - SILENT:] = quiet
    dct, saved = [], K.fx_dct4

    def rec_dct(*a):
        dct.append(a)
        return saved(*a)
    K.fx_dct4 = rec_dct
    try:
        DeviceFixedDecoder(cfg, B, device=dev).decode_block(frames)
    finally:
        K.fx_dct4 = saved
    # K19 dec: phase 6 at EP3
    cfg3 = P.Config(fs_in=48000, bitrate=64000, epmode=3)
    kinds, frame_bfi = C.stream_plan(STREAM_T, B)
    enc = engine.StreamEncoder(cfg3, B, device=dev)
    dec = engine.StreamDecoder(cfg3, B, device=dev)
    rng = np.random.default_rng(3)
    fecs, saved_f = [], K.fec_decode

    def rec_fec(*a):
        fecs.append((a,))
        return saved_f(*a)
    K.fec_decode = rec_fec
    try:
        for f in range(STREAM_T):
            pay = enc.encode(pcm[f])
            rows = np.stack([np.frombuffer(b, np.uint8) for b in pay]).astype(np.int32)
            payload = C.channel_errors(rows, cfg3.slotBytes, 3, kinds[f], rng)
            dec.decode(payload.astype(np.uint8).tobytes(), int(frame_bfi[f]))
    finally:
        K.fec_decode = saved_f
    torch.cuda.synchronize()
    return {"fx_dct4": {"block": dct[-1]}, "fec_decode": {"ep3": fecs[-1][0]}, "frames8": frames}


def plain(name: str):
    from audio_codec_torch.ops import fec, fixed_dev
    return {"fx_dct4": fixed_dev.batch_dct4_plain, "fec_decode": fec.fec_decode_plain}[name]


def differing(name: str, got, args) -> int:
    import torch
    from tests.torch_kernel_cases import count_differing
    ref = plain(name)(*args)
    torch.cuda.synchronize()
    if name == "fec_decode":
        return count_differing({k: got[k] for k in ref}, ref)
    return count_differing(list(got), list(ref))


def branches(name: str, args, got) -> dict:
    if name == "fx_dct4":
        return {"rows": int(args[0].shape[0]), "all-zero rows": int(got[3].sum())}
    import torch
    bfi, mode = got["bfi"].cpu(), got["mode"].cpu()
    return {"slots": int(bfi.numel()), "slot bytes": int(args[1]),
            "bfi 0/1/2": torch.bincount(bfi.long(), minlength=3).tolist(),
            "mode -1..4": torch.bincount((mode + 1).long(), minlength=6).tolist()}


def measure(root: Path, B: int) -> dict:
    """The times of the checkout at root, in this process."""
    r = record(root, B)
    from audio_codec_torch import kernels as K
    out = {"root": str(root), "card": card(), "streams": B}
    for name, cases in CASES.items():
        for case in cases:
            args = r[name][case]
            fn = getattr(K, name)
            got = fn(*args)
            run, _ = raw_call(name, K.library(), args, None, root / "audio_codec_torch" / "csrc")
            raw = min(graph_ms(run) for _ in range(3))
            out[f"{name} {case}"] = {"differ": differing(name, got, args),
                                     **branches(name, args, got), **times(lambda: fn(*args)),
                                     "raw_graph_ms": raw}
    out["fixed_decode_streams"] = decode_streams(r["frames8"])
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


def fec_dec_tables(dev) -> "torch.Tensor":
    """kernels.fec_dec_tables of this checkout, made from the channel coder's
    host tables of whichever checkout this process imported."""
    import numpy as np
    import torch
    from audio_codec_torch import kernels as K
    from audio_codec_torch.ops import fec as F
    syn = np.zeros((15, 16), np.int64)
    for j in range(15):
        for v in range(16):
            for k in range(6):
                syn[j, v] |= int(F._MUL[v, F._SYND_POW[k, j]]) << (4 * k)
    polys = (F._CRC1_POLY[2][0], F._CRC1_POLY[3][0], F._CRC2_POLY[2][0])
    pw = np.array([[F._clmod(1 << (4 * k), poly) for k in range(608)] for poly in polys], np.int64)
    words = np.concatenate([K.fec_tables("cpu").numpy(), syn.ravel(), pw.ravel()])
    return torch.as_tensor(words.astype(np.int32), device=dev)


def raw_call(name: str, lib, args, n: int | None, csrc: Path):
    """A call of the C entry point `name` of lib, built from the sources in
    csrc, on the recorded arguments (tiled to n rows or slots where n is
    given), converted as that checkout's wrapper converts them: (run,
    (outputs, the arguments))."""
    import torch
    from audio_codec_torch import kernels as K
    st = lambda: torch.cuda.current_stream().cuda_stream
    fn = getattr(lib, f"acx_{name}")
    fn.argtypes = ARGTYPES[name]
    dev = "cuda"
    if n is not None:
        args = tuple(tile(a, n) for a in args)
    if name == "fx_dct4":
        y, y_e = args[0].contiguous(), args[1].contiguous()
        L = y.shape[0]
        # the first design takes the table as int64, this one as int32
        wide = "const i64* __restrict__ tab" in (csrc / "fx_dct4.cu").read_text()
        tab = K.nm.table(K.fx_dct4_table_pack, device=dev, dtype=torch.int64 if wide else torch.int32)
        ytda = torch.empty_like(y)
        ye, ys = (torch.empty((L,), dtype=torch.int64, device=dev) for _ in range(2))
        zero = torch.empty((L,), dtype=torch.bool, device=dev)
        outs = (ytda, ye, ys, zero)
        return (lambda: fn(y.data_ptr(), y_e.data_ptr(), tab.data_ptr(), *(o.data_ptr() for o in outs),
                           L, st())), (outs, args)
    frames, slot, ccc, bfi_in = args
    frames = frames.to(torch.int32).contiguous()
    B = frames.shape[0]
    bfi = None if bfi_in is None else bfi_in.to(torch.int32).contiguous()
    # the first design takes fec_tables, this one fec_dec_tables (which
    # begins with them)
    tabs = fec_dec_tables(dev) if "kFecDecTableWords" in (csrc / "fec.cuh").read_text() \
        else K.fec_tables(dev)
    data = torch.empty((B, slot), dtype=torch.int32, device=dev)
    out = torch.empty((9, B), dtype=torch.int32, device=dev)
    names = ("data_bytes", "bfi", "epmr", "error_report", "mode", "n_pccw", "n_pc", "be_bp_left",
             "be_bp_right")
    got = dict(data=data, **dict(zip(names, out)))
    return (lambda: fn(frames.data_ptr(), None if bfi is None else bfi.data_ptr(), tabs.data_ptr(),
                       data.data_ptr(), out.data_ptr(), B, slot, int(ccc), st())), (got, args)


def resident(name: str, csrc: Path, tag: str) -> str:
    """The rows (K20c) or slots (K19 dec) of `name` resident on the card at
    once, from a build of csrc with the occupancy query appended (static
    shared memory only)."""
    text = (csrc / MAIN[name]).read_text()
    if name == "fx_dct4":
        if "kFxDctRows" in text:
            threads, per_block = "32 * kFxDctWarps", "kFxDctRows"
        else:   # the first design: a block of 128 threads a row
            threads, per_block = "kFxDctThreads", "1"
    elif "kFecDecWarps" in text:
        threads, per_block = "32 * kFecDecWarps", "kFecDecWarps"
    else:       # the first design: a thread a slot
        threads, per_block = "kFecDecThreads", "kFecDecThreads"
    query = (f'extern "C" int acx_threads() {{ return {threads}; }}\n'
             f'extern "C" int acx_per_block() {{ return {per_block}; }}\n')
    lib, _ = build(OUT / f"resident_{tag}_{name}", csrc, MAIN[name],
                   append=OCCUPANCY.replace("KERNEL", KERNEL[name]) + query)
    lib.acx_resident.argtypes = [I_, I_, I_]
    threads_n, per = lib.acx_threads(), lib.acx_per_block()
    n = lib.acx_resident(0, threads_n, per)
    unit = "rows" if name == "fx_dct4" else "slots"
    return f"{n} {unit} resident (blocks of {threads_n} threads, {per} {unit} a block)"


def usage(csrc: Path, tag: str) -> None:
    """ptxas's registers, spills and shared memory and the rows or slots
    resident, for the two kernels of csrc."""
    names = tuple(CASES)
    with ThreadPoolExecutor(max_workers=4) as ex:
        ptx = list(ex.map(lambda n: build(OUT / f"usage_{tag}_{n}", csrc, MAIN[n])[1], names))
        res = list(ex.map(lambda n: resident(n, csrc, tag), names))
    for name, p, s in zip(names, ptx, res):
        print(f"[{name} usage] {card()} | {tag}: {p}", flush=True)
        print(f"[{name} usage] {card()} | {tag}: {s}", flush=True)


def builds(root: Path, jobs, B: int) -> None:
    """Each job (tag, kernel name, label, csrc, substitutions) built and timed
    on every recorded case against the plain version, two rounds."""
    import torch
    r = record(root, B)

    def one(job):
        tag, name, label, csrc, subs = job
        try:
            return tag, name, label, build(OUT / tag, csrc, MAIN[name], subs)[0]
        except SystemExit as e:   # a variant that does not build is reported, not timed
            print(f"[{name} builds] {card()} | {label}: not built: {e}", flush=True)
            return None
    with ThreadPoolExecutor(max_workers=8) as ex:   # one nvcc a job, all started together
        libs = [b for b in ex.map(one, jobs) if b is not None]
    csrc_of = {job[0]: job[3] for job in jobs}
    for rnd in range(2):
        for tag, name, label, lib in libs:
            for case in CASES[name]:
                run, (outs, args) = raw_call(name, lib, r[name][case], None, csrc_of[tag])
                rc = run()
                torch.cuda.synchronize()
                bad = differing(name, outs, args)
                ms = min(graph_ms(run) for _ in range(3))
                print(f"[{name} builds] {card()} | round {rnd}, {case}, {label}: rc {rc}, {bad} "
                      f"values differ from the plain version, raw graph {ms:.5f} ms", flush=True)


def phases(other: Path, B: int) -> None:
    other = other.resolve()
    csrc = other / "audio_codec_torch" / "csrc"
    usage(csrc, "other")
    jobs = [(f"first_{name}_{i}", name, label, csrc, subs)
            for name, cuts in PHASES_FIRST.items()
            for i, (label, subs) in enumerate(cuts.items())]
    builds(other, jobs, B)


def variants(B: int) -> None:
    usage(CSRC, "this")
    jobs = [(f"kept_{name}_{i}", name, label, CSRC, subs)
            for name, cuts in VARIANTS.items() for i, (label, subs) in enumerate(cuts.items())]
    builds(ROOT, jobs, B)


def scaling(root: Path, B: int) -> None:
    r = record(root, B)
    from audio_codec_torch import kernels as K
    sizes = {"fx_dct4": (16, 256, 4096, 16384), "fec_decode": (4, 32, 512, 2048)}
    for name, cases in CASES.items():
        for case in cases:
            args = r[name][case]
            for n in sizes[name]:
                a = tuple(tile(x, n) for x in args)
                ms = min(graph_ms(lambda: getattr(K, name)(*a)) for _ in range(3))
                unit = "rows" if name == "fx_dct4" else "slots"
                print(f"[scaling] {card()} | {name} {case} ({root.name}): {n} {unit}: graph "
                      f"{ms:.5f} ms", flush=True)


# --clocks: each kernel built with clock64() stamps at its stage boundaries
# (a stamp a warp, lane 0), read back after one launch on each recorded case
CLOCKS = {
    "fx_dct4": (
        ("fx_dct4.cuh", '#include "fixed.cuh"\n', '#include "fixed.cuh"\n' + CLOCK_PRELUDE),
        ("fx_dct4.cuh", "  uint32_t norm_or = 0, value_or = 0;\n",
         "  ACX_CLK(0);\n  uint32_t norm_or = 0, value_or = 0;\n"),
        ("fx_dct4.cuh", "  const bool is_zero = hs >= 32;\n", "  const bool is_zero = hs >= 32;\n  ACX_CLK(1);\n"),
        ("fx_dct4.cuh", _FK_PRE + "  g.sync();\n", _FK_PRE + "  g.sync();\n  ACX_CLK(2);\n"),
        ("fx_dct4.cuh", _FK_FFT15 + "  g.sync();\n", _FK_FFT15 + "  g.sync();\n  ACX_CLK(3);\n"),
        ("fx_dct4.cuh", _FK_RADIX8 + "  g.sync();\n", _FK_RADIX8 + "  g.sync();\n  ACX_CLK(4);\n"),
        ("fx_dct4.cuh", "  if (g.leader()) {\n    *y_e =", "  ACX_CLK(5);\n  if (g.leader()) {\n    *y_e ="),
    ),
    "fec_decode": (
        ("fec.cuh", '#include "warp.cuh"\n', '#include "warp.cuh"\n' + CLOCK_PRELUDE),
        ("fec.cuh", "  const int ncw = fec_ncw(slot), len0 = fec_cw_len(slot, 0);\n  // the slot's bytes",
         "  const int ncw = fec_ncw(slot), len0 = fec_cw_len(slot, 0);\n  ACX_CLK(0);\n  // the slot's bytes"),
        ("fec.cuh", "  // the codewords and their syndromes, codeword l",
         "  ACX_CLK(1);\n  // the codewords and their syndromes, codeword l"),
        ("fec.cuh", "  const uint32_t syn0 = w.shfl(synA, 0);\n", "  const uint32_t syn0 = w.shfl(synA, 0);\n  ACX_CLK(2);\n"),
        ("fec.cuh", "  if (!ep1_ok) {\n", "  ACX_CLK(3);\n  if (!ep1_ok) {\n"),
        ("fec.cuh", "    const unsigned cleanB = w.ballot(cleanL)", "    ACX_CLK(4);\n    const unsigned cleanB = w.ballot(cleanL)"),
        ("fec.cuh", "    const int det_m = clean_m >= 0 ? clean_m : sel_m;\n",
         "    const int det_m = clean_m >= 0 ? clean_m : sel_m;\n    ACX_CLK(5);\n"),
        ("fec.cuh", "      typename W::template Lanes<unsigned> bitsU;\n",
         "      ACX_CLK(6);\n      typename W::template Lanes<unsigned> bitsU;\n"),
        ("fec.cuh", "      fec_data_word(w, cwA, cwB, p, ws->dw);\n",
         "      ACX_CLK(7);\n      fec_data_word(w, cwA, cwB, p, ws->dw);\n      ACX_CLK(8);\n"),
        ("fec.cuh", "      // EPMR of the corrected path", "      ACX_CLK(9);\n      // EPMR of the corrected path"),
        ("fec.cuh", "  // the payload bytes of the data word", "  ACX_CLK(10);\n  // the payload bytes of the data word"),
        ("fec.cuh", "    out[FEC_BE_RIGHT * stride] = be_r;\n  });\n", "    out[FEC_BE_RIGHT * stride] = be_r;\n  });\n  ACX_CLK(11);\n"),
    ),
}
CLOCK_PHASES = {
    "fx_dct4": ((0, 1, "loads, cap and headroom"), (1, 2, "pre-scale and pre-twiddle"),
                (2, 3, "fft15 halves"), (3, 4, "radix-8 rows"), (4, 5, "post-twiddle, stores, headroom"),
                (0, 5, "the row")),
    "fec_decode": ((0, 1, "staging"), (1, 2, "codewords and syndromes"), (2, 3, "EP1 check"),
                   (3, 4, "18 detections"), (4, 5, "risk chain and pick"), (5, 6, "correction"),
                   (6, 7, "flags"), (7, 8, "data word"), (8, 9, "CRCs"), (9, 10, "decisions"),
                   (10, 11, "payload and outputs"), (0, 11, "the slot")),
}


def clocks(B: int) -> None:
    """Median and 90th-percentile cycles of each stage, over the warps that
    run it (K19 dec: the corrected slots and the others apart)."""
    import numpy as np
    import torch
    r = record(ROOT, B)
    for name, subs in CLOCKS.items():
        lib, _ = build(OUT / f"clocks_{name}", CSRC, MAIN[name], subs, append=CLOCK_READ)
        lib.acx_clk_read.argtypes = [P_, I_]
        lib.acx_clk_zero.argtypes = [I_]
        for case in CASES[name]:
            args = r[name][case]
            run, (outs, a) = raw_call(name, lib, args, None, CSRC)
            run()
            torch.cuda.synchronize()
            text = (CSRC / MAIN[name]).read_text()
            per_warp = 32 // int(re.search(r"kFxDctRowLanes = (\d+)", text).group(1)) \
                if name == "fx_dct4" else 1
            warps = -(-args[0].shape[0] // per_warp)
            warps = -(-warps // 4) * 4
            n = warps * 32
            lib.acx_clk_zero(n)
            run()
            torch.cuda.synchronize()
            clk = np.zeros(n, np.int64)
            lib.acx_clk_read(clk.ctypes.data, n)
            clk = clk.reshape(warps, 32)
            if name == "fx_dct4":
                groups = {"rows": clk[clk[:, 5] > 0]}
            else:
                groups = {"corrected slots": clk[clk[:, 9] > 0],
                          "the others": clk[(clk[:, 11] > 0) & (clk[:, 9] == 0)]}
            for gname, rows in groups.items():
                parts = []
                for a_, b_, label in CLOCK_PHASES[name]:
                    ok = (rows[:, a_] > 0) & (rows[:, b_] > 0)
                    d = (rows[ok, b_] - rows[ok, a_]).astype(np.float64)
                    if len(d):
                        parts.append(f"{label} {np.median(d):.0f} ({np.percentile(d, 90):.0f})")
                print(f"[clocks] {card()} | {name} {case}, {gname} ({len(rows)} warps): cycles, "
                      f"median (90th percentile): " + "; ".join(parts), flush=True)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--streams", type=int, default=2048)
    ap.add_argument("--other", type=Path, default=None)
    ap.add_argument("--phases", type=Path, default=None)
    ap.add_argument("--variants", action="store_true")
    ap.add_argument("--scaling", action="store_true")
    ap.add_argument("--clocks", action="store_true")
    ap.add_argument("--root", type=Path, default=None, help=argparse.SUPPRESS)
    opt = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("torch_fxdct_fec_times: no CUDA device")
    if opt.phases or opt.variants or opt.scaling or opt.clocks:
        if opt.phases:
            phases(opt.phases, opt.streams)
        if opt.variants:
            variants(opt.streams)
        if opt.scaling:
            scaling((opt.root or ROOT).resolve(), opt.streams)
        if opt.clocks:
            clocks(opt.streams)
        return 0
    if opt.root is not None or opt.other is None:
        print(json.dumps(measure((opt.root or ROOT).resolve(), opt.streams)), flush=True)
        return 0
    rc = 0
    for root in (opt.other, ROOT, ROOT, opt.other):
        r = subprocess.run([sys.executable, __file__, "--streams", str(opt.streams), "--root",
                            str(root.resolve())])
        rc = rc or r.returncode
    return rc


if __name__ == "__main__":
    sys.exit(main())
