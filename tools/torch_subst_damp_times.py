#!/usr/bin/env python3
"""Times the Phase ECU's substitution and the concealment's damping and
scrambling of audio_codec_torch on a CUDA card: the kernels `phecu_subst`
(csrc/phecu_subst.cu, K18b) and `plc_damp_scramble`
(csrc/plc_damp_scramble.cu, K17b) on the inputs the smoke run's phase 7
gives them. Every line printed carries the card's name and power limit.

The inputs: chip_smoke's phase 7 block (plc_pcm's material at plc_mode=1,
B streams, 16 frames, plc_loss_plan's losses) through decode_block; of each
kernel's launches the busiest, as chip_smoke.plc_work ranks them, is
recorded as `busiest`. Beside it K18b's `all_active` and K17b's `all_ns`
(chip_smoke.all_active_args: the busiest launch's Phase ECU streams tiled
to B, every stream concealed by the Phase ECU; every stream lost and
noise-substituted from its first loss on, the scrambling pass on every
warp). This checkout's chip_smoke.py makes the inputs for either checkout.
Each kernel is checked against its plain version bit for bit, then
timed as median loop ms (5 loops of 20 calls) and graph ms (20 calls
replayed from a CUDA graph, the best of 3); `raw` is the C entry point alone
on the arguments as the wrapper hands them over (graph ms), so that wrapper
minus raw is the wrapper's own preparation.

  (default)     this checkout, one JSON line.
  --other DIR   the same for a checkout of another commit (the parent
                unpacked with `git archive` into a directory that .gitignore
                lists), in turns with this one, each in a process of its
                own: other, this, this, other.
  --phases DIR  the kernels of the checkout DIR with a phase removed
                (PHASES_FIRST), built from DIR's sources with text
                substitutions and run on the recorded rows: raw graph ms, two
                rounds; and DIR's registers, stack frame, shared memory and
                streams resident.
  --variants    this checkout's kept designs with their other choices and
                with a phase removed (VARIANTS), built from this checkout's
                sources with text substitutions: raw graph ms, two rounds,
                each checked against the plain version; and this checkout's
                registers, stack frame, shared memory and streams resident.
  --scaling     both kernels at 4, 32, 512 and 2048 streams of the recorded
                rows (tiled): graph ms of the wrappers.
  --clocks      the kernels built with clock64() stamps at their stage
                boundaries (CLOCKS): each stage's cycles on the recorded
                launches, median and 90th percentile over the warps.

    python3 tools/torch_subst_damp_times.py [--streams 2048] [--other DIR]
    python3 tools/torch_subst_damp_times.py --phases DIR --variants --scaling --clocks
"""
from __future__ import annotations

import argparse
import ctypes
from concurrent.futures import ThreadPoolExecutor
import importlib.util
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT / "tools"))
sys.path.insert(0, str(ROOT))
from torch_dct4_times import card, graph_ms  # noqa: E402
from torch_fxdct_fec_times import build  # noqa: E402
from torch_ltpf_times import times  # noqa: E402
from torch_sns_nf_times import tile  # noqa: E402
from torch_tdc_fxspec_times import CLOCK_PRELUDE, CLOCK_READ, OCCUPANCY  # noqa: E402

CSRC = ROOT / "audio_codec_torch" / "csrc"
OUT = ROOT / "build" / "subst_damp_times"
PLC_T = 16             # chip_smoke.PLC_FRAMES
P_, I_ = ctypes.c_void_p, ctypes.c_int
MAIN = {"phecu_subst": "phecu_subst.cu", "plc_damp_scramble": "plc_damp_scramble.cu"}
KERNEL = {"phecu_subst": "phecu_subst_kernel", "plc_damp_scramble": "plc_damp_kernel"}
WARPS = {"phecu_subst": "kPhSubstWarps", "plc_damp_scramble": "kDampWarps"}
CASES = {"phecu_subst": ("busiest", "all_active"), "plc_damp_scramble": ("busiest", "all_ns")}

# the parent's designs with a phase removed: text substitutions (file, old,
# new) of the sources of the checkout given to --phases
_PS_SEARCH = (("phecu.cuh", "#pragma unroll\n      for (int d = 1; d <= kPhDelta; ++d) {",
               "      for (int d = 1; d <= 0; ++d) {"),)
_PS_TRIG = (("phecu.cuh", "const float c = ph_cos(theta), s = ph_sin(theta);",
             "const float c = theta, s = rsub(theta, 1.0f);"),
            ("phecu.cuh", "rmul(0.5f, ph_cos(ph1))", "rmul(0.5f, ph1)"),
            ("phecu.cuh", "rmul(amp, ph_cos(ph2))", "rmul(amp, ph2)"),
            ("phecu.cuh", "rmul(amp, ph_sin(ph2))", "rmul(amp, rsub(ph2, 1.0f))"))
_PS_RAND = (("phecu.cuh", "const float ph1 = ph_rand(time_offs, k, tab, ns), ph2 = ph_rand(time_offs + 1, k, tab, ns);",
             "const float ph1 = rmul(0x1.921fb6p-3f, static_cast<float>(k & 31)), "
             "ph2 = rmul(0x1.921fb6p-3f, static_cast<float>((k + time_offs) & 31));"),)
_PS_ZERO = (("phecu_subst.cu", "  if (!ints[3 * B + b]) {", "  if (true) {"),)
_PD_WSUM = (("plc_damp.cuh", "const float e = wsum(w, N, ws->scratch", "const float e = wsum(w, 0, ws->scratch"),)
_PD_CLEAN = (("plc_damp.cuh", "const bool ns = iv[0] != 0, lost = iv[1] != 0, is_pc = iv[2] != 0;",
              "const bool ns = false, lost = false, is_pc = false;"),)
_PD_STAGE = (("plc_damp.cuh", "  if (lost || ns) {\n", "  if (false) {\n"),
             ("plc_damp.cuh", "  if (is_pc) {\n", "  if (false) {\n"))
_PD_SIGN = (("plc_damp.cuh", "    if (k >= inv && neg) ws->spec[k] = -ws->spec[k];", ""),)
PHASES_FIRST = {
    "phecu_subst": {
        "first design as it is": (),
        "no neighbour search": _PS_SEARCH,
        "no sines or cosines": _PS_TRIG,
        "no generator draws (table loads)": _PS_RAND,
        "no neighbour search, no sines or cosines, no generator draws": _PS_SEARCH + _PS_TRIG + _PS_RAND,
        "zero writes alone (every stream inactive)": _PS_ZERO,
    },
    "plc_damp_scramble": {
        "first design as it is": (),
        "no wsum": _PD_WSUM,
        "no sign flips (the generator's values unused)": _PD_SIGN,
        "clean streams only (every stream copied through shared memory)": _PD_CLEAN,
        "staging alone (noise substitution and the copies, no pass)": _PD_STAGE,
    },
}

# this checkout's kept designs with their other choices and a phase removed:
# text substitutions (file, old, new)
_KS_PEAK_PASS = ("phecu.cuh", "    for (int j = l; j < npk; j += 32) {", "    for (int j = l; j < 0; j += 32) {")
_KS_TABLE = "    const float ph = rmul(kPhStep, static_cast<float>(l));\n    ws->tc[l] = ph_cos(ph);\n    ws->ts[l] = ph_sin(ph);\n"
_KS_ANGLES_END = "            rmul(rmul(rmul(0x1.921fb6p+2f, fk[u][l]), adv), inv_lp);\n      }\n    }\n"
_SEL_BOOL = (("plc.cuh", "  return float_of(static_cast<int>((static_cast<uint32_t>(bits_of(a)) & mask) |\n"
                           "                                   (static_cast<uint32_t>(bits_of(b)) & ~mask)));",
              "  return mask ? a : b;"),)
VARIANTS = {
    "phecu_subst": {
        "kept: peak mask bits, a cosine and sine a peak, the phases' table": (),
        "blocks of 2 warps": (("phecu_subst.cu", "constexpr int kPhSubstWarps = 4;", "constexpr int kPhSubstWarps = 2;"),),
        "blocks of 8 warps": (("phecu_subst.cu", "constexpr int kPhSubstWarps = 4;", "constexpr int kPhSubstWarps = 8;"),),
        "a peak's cosine and sine on every bin it claims": (
            _KS_PEAK_PASS,
            ("phecu.cuh", "fsel_bits(am, ws->pc[rank], ws->tc[p1])", "fsel_bits(am, ph_cos(ws->pc[rank]), ws->tc[p1])"),
            ("phecu.cuh", "fsel_bits(am, ws->ps[rank], ws->ts[p1])", "fsel_bits(am, ph_sin(ws->pc[rank]), ws->ts[p1])")),
        "the generator phases' cosines and sines on every bin (no table)": (
            ("phecu.cuh", "fsel_bits(am, ws->pc[rank], ws->tc[p1])",
             "fsel_bits(am, ws->pc[rank], ph_cos(rmul(kPhStep, static_cast<float>(p1))))"),
            ("phecu.cuh", "fsel_bits(am, ws->ps[rank], ws->ts[p1])",
             "fsel_bits(am, ws->ps[rank], ph_sin(rmul(kPhStep, static_cast<float>(p1))))"),
            ("phecu.cuh", "rmul(0.5f, ws->tc[p1])", "rmul(0.5f, ph_cos(rmul(kPhStep, static_cast<float>(p1))))"),
            ("phecu.cuh", "rmul(amp, ws->tc[p2])", "rmul(amp, ph_cos(rmul(kPhStep, static_cast<float>(p2))))"),
            ("phecu.cuh", "rmul(amp, ws->ts[p2])", "rmul(amp, ph_sin(rmul(kPhStep, static_cast<float>(p2))))")),
        "each bin stored as it is made": (
            ("phecu.cuh", "      re[u][l] = r;\n      im[u][l] = i;\n    }\n",
             "      re[u][l] = r;\n      im[u][l] = i;\n      if (k < nsf) {\n        outr[k] = r;\n"
             "        outi[k] = i;\n      }\n    }\n"),
            ("phecu.cuh", "      if (k < nsf) {\n        outr[k] = re[u][l];", "      if (false) {\n        outr[k] = re[u][l];")),
        "the phase table made after the mask": (
            ("phecu.cuh", _KS_TABLE + "  });\n  ph_burst_warp", "  });\n  ph_burst_warp"),
            ("phecu.cuh", _KS_ANGLES_END, _KS_ANGLES_END + _KS_TABLE)),
        "phase cut: no peak trigonometry": (_KS_PEAK_PASS,),
        "the bins' choices as selects of bools (which the compiler may branch on)": _SEL_BOOL,
        "phase cut: no bin work (the loads, mask, table and peaks only)": (
            ("phecu.cuh", "      if (u < kPhWords) {", "      if (false) {"),),
    },
    "plc_damp_scramble": {
        "kept: both rows and the jumps loaded first, 16-byte words, terms at stride 33": (),
        "blocks of 2 warps": (("plc_damp_scramble.cu", "constexpr int kDampWarps = 4;", "constexpr int kDampWarps = 2;"),),
        "blocks of 8 warps": (("plc_damp_scramble.cu", "constexpr int kDampWarps = 4;", "constexpr int kDampWarps = 8;"),),
        "terms at stride 32 (the 13-way conflict back)": (
            ("plc_damp.cuh", "constexpr int kDampStride = 33;", "constexpr int kDampStride = 32;"),
            ("plc_damp.cuh", "m + (m >> 5)", "m")),
        "4-byte loads and stores": (("plc_damp.cuh", "  bool vec = (N & 3) == 0;\n", "  bool vec = false;\n"),),
        "the window sums' shuffles in a loop of the windows": (
            ("plc_damp.cuh", "#pragma unroll\n  for (int j = 0; j < kDampRounds; ++j) e = radd(e, w.shfl(part, j));",
             "#pragma unroll 1\n  for (int j = 0; j < nwin; ++j) e = radd(e, w.shfl(part, j));"),),
        "the bins' choices as selects of bools (which the compiler may branch on)": _SEL_BOOL,
        "phase cut: no window sums": (("plc_damp.cuh", "    if (l < nwin) {", "    if (false) {"),),
    },
}

# --clocks: each kernel built with clock64() stamps at its stage boundaries
# (a stamp a warp, lane 0), read back after one launch on each recorded case
CLOCKS = {
    "phecu_subst": (
        ("phecu.cuh", '#include "plc.cuh"\n', '#include "plc.cuh"\n' + CLOCK_PRELUDE),
        ("phecu.cuh", "  // every load of a lane first;", "  ACX_CLK(0);\n  // every load of a lane first;"),
        ("phecu.cuh", "  ph_burst_warp(w, nb, gr,", "  ACX_CLK(1);\n  ph_burst_warp(w, nb, gr,"),
        ("phecu.cuh", "  // each peak's angle at its rank", "  ACX_CLK(2);\n  // each peak's angle at its rank"),
        ("phecu.cuh", "  // each peak's cosine and sine, a peak a lane", "  ACX_CLK(3);\n  // each peak's cosine and sine, a peak a lane"),
        ("phecu.cuh", "  // the bins into registers", "  ACX_CLK(4);\n  // the bins into registers"),
        ("phecu.cuh", "      re[u][l] = r;\n      im[u][l] = i;\n    }\n", "      re[u][l] = r;\n      im[u][l] = i;\n    }\n    ACX_CLK(5);\n"),
        ("phecu.cuh", "        outi[k] = im[u][l];\n      }\n    }\n  });\n}\n", "        outi[k] = im[u][l];\n      }\n    }\n  });\n  ACX_CLK(6);\n}\n"),
    ),
    "plc_damp_scramble": (
        ("plc_damp.cuh", '#include "plc.cuh"\n', '#include "plc.cuh"\n' + CLOCK_PRELUDE),
        ("plc_damp.cuh", "  bool vec = (N & 3) == 0;\n", "  ACX_CLK(0);\n  bool vec = (N & 3) == 0;\n"),
        ("plc_damp.cuh", "  if (in.lost || in.ns) {\n", "  ACX_CLK(1);\n  if (in.lost || in.ns) {\n"),
        ("plc_damp.cuh", "  // the signs; the energy terms", "  ACX_CLK(2);\n  // the signs; the energy terms"),
        ("plc_damp.cuh", "  // window j from +0 on lane j", "  ACX_CLK(3);\n  // window j from +0 on lane j"),
        ("plc_damp.cuh", "  const float ad_fac = xfma(0x1.19999ap+3f, lin", "  ACX_CLK(4);\n  const float ad_fac = xfma(0x1.19999ap+3f, lin"),
        ("plc_damp.cuh", "  return seed_out;\n}\n\n// plc_damp_scramble for one stream", "  ACX_CLK(5);\n  return seed_out;\n}\n\n// plc_damp_scramble for one stream"),
        ("plc_damp.cuh", "  o.st = st;\n", "  ACX_CLK(6);\n  o.st = st;\n"),
    ),
}
# (from, to, label); a warp counts in a stage where it stamped both ends
CLOCK_PHASES = {
    "phecu_subst": ((0, 1, "loads issued, phase table"), (1, 2, "burst factors and mask"),
                    (2, 3, "angles"), (3, 4, "peak trigonometry"), (4, 5, "bins"), (5, 6, "stores"),
                    (0, 6, "the stream")),
    "plc_damp_scramble": ((0, 1, "loads and taper"), (2, 3, "signs and terms"), (3, 4, "window sums"),
                          (4, 5, "damping"), (0, 6, "the stream")),
}

_RECORDED: dict = {}


def record(root: Path, B: int) -> dict:
    """The recorded arguments (see the module's docstring), made once a
    process with the first checkout it imports: every checkout's kernels
    equal the same plain versions, so their rows are the same."""
    if B not in _RECORDED:
        _RECORDED[B] = _record(root, B)
    return _RECORDED[B]


def _record(root: Path, B: int) -> dict:
    import torch
    sys.path.insert(0, str(root))
    import audio_codec_torch as P
    from audio_codec_torch import kernels as K
    S = smoke()
    K.library()
    dev = "cuda"
    cfg = P.Config(fs_in=48000, bitrate=64000, plc_mode=1)
    pcm = torch.from_numpy(S.plc_pcm(PLC_T, B, 0)).to(dev)
    _, frames = P.encode_block(cfg, P.enc_state_init(cfg, B, device=dev), pcm)
    bfi = torch.from_numpy(S.plc_loss_plan(PLC_T, B)).to(dev)
    calls = {name: [] for name in CASES}
    saved = {name: getattr(K, name) for name in CASES}

    def recorder(name):
        def rec(*a):
            res = saved[name](*a)
            calls[name].append((a, res))
            return res
        return rec
    for name in CASES:
        setattr(K, name, recorder(name))
    try:
        P.decode_block(cfg, P.dec_state_init(cfg, B, device=dev), frames, bfi)
    finally:
        for name in CASES:
            setattr(K, name, saved[name])
    torch.cuda.synchronize()
    out = {}
    for name in CASES:
        busiest = max(calls[name], key=lambda c: S.plc_work(name, c[0], c[1])[1])[0]
        out[name] = {"busiest": busiest}
    for name, case in (("phecu_subst", "all_active"), ("plc_damp_scramble", "all_ns")):
        out[name][case] = S.all_active_args(name, out[name]["busiest"], B)
    torch.cuda.synchronize()
    return out


def smoke():
    """This checkout's chip_smoke.py (its material, loss plan, work counts and
    all-active arguments), whichever checkout is timed."""
    if "subst_damp_smoke" not in sys.modules:
        spec = importlib.util.spec_from_file_location("subst_damp_smoke", ROOT / "chip_smoke.py")
        mod = importlib.util.module_from_spec(spec)
        sys.modules["subst_damp_smoke"] = mod
        spec.loader.exec_module(mod)
    return sys.modules["subst_damp_smoke"]


def plain(name: str):
    from audio_codec_torch.ops import plc_adv, plc_phecu
    return {"phecu_subst": plc_phecu.phecu_subst_plain,
            "plc_damp_scramble": plc_adv.damp_scramble_plain}[name]


def differing(name: str, got, args) -> int:
    import torch
    from tests.torch_kernel_cases import count_differing
    ref = plain(name)(*args)
    torch.cuda.synchronize()
    return count_differing(list(got), list(ref))


def branches(name: str, args) -> dict:
    if name == "phecu_subst":
        act, nb, npl = args[12], args[5], args[4]
        return {"streams": int(act.numel()), "active": int(act.sum()),
                "burst > 3": int((act & (nb > 3)).sum()),
                "1-2 peaks": int((act & (npl > 0) & (npl < 3)).sum()),
                "no peak": int((act & (npl == 0)).sum())}
    ns, lost, is_pc = args[3], args[4], args[5]
    return {"streams": int(ns.numel()), "noise substitution": int(ns.sum()),
            "lost, not substituted": int((lost & ~ns).sum()), "bfi 2": int(is_pc.sum()),
            "clean": int((~(lost | is_pc)).sum())}


def _this():
    return sys.modules[__name__]


def measure(root: Path, B: int, sl=None) -> dict:
    """The times of the checkout at root, in this process. sl: the module of
    the slice's tables and hooks (CASES, MAIN, KERNEL, WARPS or block, OUT,
    PHASES_FIRST, VARIANTS, CLOCKS, CLOCK_PHASES; record, raw_call,
    differing, branches, clock_warps; SCALING and measure where they
    differ), this one by default; the other slices' tools pass theirs to
    each mode function below."""
    sl = sl or _this()
    r = sl.record(root, B)
    from audio_codec_torch import kernels as K
    out = {"root": str(root), "card": card(), "streams": B}
    for name, cases in sl.CASES.items():
        for case in cases:
            args = r[name][case]
            fn = getattr(K, name)
            got = fn(*args)
            run, _ = sl.raw_call(name, K.library(), args, root / "audio_codec_torch" / "csrc")
            raw = min(graph_ms(run) for _ in range(3))
            out[f"{name} {case}"] = {"differ": sl.differing(name, got, args),
                                     **sl.branches(name, args), **times(lambda: fn(*args)),
                                     "raw_graph_ms": raw}
    return out


def _first_design(csrc: Path) -> bool:
    """Whether csrc holds the first designs (stacked int and float vectors)."""
    return "const int32_t* __restrict__ ints," in (csrc / "phecu_subst.cu").read_text()


def raw_call(name: str, lib, args, csrc: Path):
    """A call of the C entry point `name` of lib, built from the sources in
    csrc, on the recorded arguments, converted as that checkout's wrapper
    converts them (outside the call): (run, (outputs, the arguments))."""
    if _first_design(csrc):
        return _raw_first(name, lib, args)
    return _raw_kept(name, lib, args)


def _stream() -> int:
    import torch
    return torch.cuda.current_stream().cuda_stream


def _raw_first(name: str, lib, args):
    import torch
    from audio_codec_torch import kernels as K
    fn = getattr(lib, f"acx_{name}")
    dev = "cuda"
    if name == "phecu_subst":
        fn.argtypes = [P_] * 9 + [I_] * 7 + [P_]
        cfg, Xr, Xi, f0est, npl, nb, e_oold, e_old, mc1, bm, xavg, is_trans, active = args
        ns, nsf, lgw, H = K._phecu_geom(cfg)
        B = Xr.shape[0]
        f0 = f0est.to(torch.float32).contiguous()
        ints = torch.stack([t.to(torch.int32) for t in (npl, nb, is_trans, active)]).contiguous()
        groups = torch.stack([t.to(torch.float32) for t in (e_oold, e_old, mc1, xavg)]).contiguous()
        bm = bm.to(torch.float32).contiguous()
        tab = K.nm.table(H.lcg_tables, ns, device=dev, dtype=torch.int32)
        outr, outi = torch.empty_like(Xr), torch.empty_like(Xi)
        return (lambda: fn(Xr.data_ptr(), Xi.data_ptr(), f0.data_ptr(), ints.data_ptr(),
                           groups.data_ptr(), bm.data_ptr(), tab.data_ptr(), outr.data_ptr(),
                           outi.data_ptr(), B, ns, nsf, lgw, cfg.frame_length, H.t_adv(cfg),
                           H.lprot(cfg), _stream())), ((outr, outi), args)
    from audio_codec_torch.ops.plc_adv import lcg_pows
    fn.argtypes = [P_] * 8 + [I_] * 3 + [P_]
    cfg, x, q = args[:3]
    B, N = x.shape
    ints = torch.stack([args[i].to(torch.int32) for i in (3, 4, 5, 6, 7, 9, 10, 14, 15, 16)]).contiguous()
    floats = torch.stack([args[i].to(torch.float32) for i in (8, 11, 12, 13)]).contiguous()
    pows = K.nm.table(lcg_pows, N, device=dev, dtype=torch.int32)
    spec = torch.empty_like(x)
    fout = torch.empty((3, B), dtype=torch.float32, device=dev)
    iout = torch.empty((2, B), dtype=torch.int32, device=dev)
    got = (spec, fout[0], fout[1], fout[2], iout[0], iout[1])
    return (lambda: fn(x.data_ptr(), q.data_ptr(), ints.data_ptr(), floats.data_ptr(),
                       pows.data_ptr(), spec.data_ptr(), fout.data_ptr(), iout.data_ptr(), B, N,
                       cfg.frame_dms, _stream())), (got, args)


def _raw_kept(name: str, lib, args):
    import torch
    from audio_codec_torch import kernels as K
    fn = getattr(lib, f"acx_{name}")
    dev = "cuda"
    if name == "phecu_subst":
        fn.argtypes = [P_] * 12 + [I_] * 7 + [P_]
        cfg, Xr, Xi, f0est, npl, nb, e_oold, e_old, mc1, bm, xavg, is_trans, active = args
        ns, nsf, lgw, H = K._phecu_geom(cfg)
        B = Xr.shape[0]
        vecs, meta = K._stream_vecs(B, dict(num_plocs=npl, nb_cur=nb, is_trans=is_trans,
                                            active=active), dict(beta_mute=bm))
        tab = K.nm.table(H.lcg_tables, ns, device=dev, dtype=torch.int32)
        outr, outi = torch.empty_like(Xr), torch.empty_like(Xi)
        return (lambda: fn(Xr.data_ptr(), Xi.data_ptr(), f0est.data_ptr(), e_oold.data_ptr(),
                           e_old.data_ptr(), mc1.data_ptr(), xavg.data_ptr(), vecs, meta,
                           tab.data_ptr(), outr.data_ptr(), outi.data_ptr(), B, ns, nsf, lgw,
                           cfg.frame_length, H.t_adv(cfg), H.lprot(cfg), _stream())), ((outr, outi), args)
    from audio_codec_torch.ops.plc_adv import lcg_pows
    fn.argtypes = [P_] * 8 + [I_] * 3 + [P_]
    cfg, x, q = args[:3]
    B, N = x.shape
    names = ("ns_lane", "lost", "is_pc", "nb_cur", "pc_nb_lost", "stab_fac", "pitch_int", "pc_pitch",
             "cum_fflc", "cum_slow", "cum_fast", "ns_seed", "pc_seed", "spec_inv_idx")
    a = dict(zip(names, args[3:]))
    floats = {k: a.pop(k) for k in ("stab_fac", "cum_fflc", "cum_slow", "cum_fast")}
    vecs, meta = K._stream_vecs(B, a, floats)
    pows = K.nm.table(lcg_pows, N, device=dev, dtype=torch.int32)
    spec = torch.empty_like(x)
    fout = torch.empty((3, B), dtype=torch.float32, device=dev)
    iout = torch.empty((2, B), dtype=torch.int32, device=dev)
    got = (spec, fout[0], fout[1], fout[2], iout[0], iout[1])
    return (lambda: fn(x.data_ptr(), q.data_ptr(), vecs, meta, pows.data_ptr(), spec.data_ptr(),
                       fout.data_ptr(), iout.data_ptr(), B, N, cfg.frame_dms, _stream())), (got, args)


def resident(name: str, csrc: Path, tag: str, sl=None) -> str:
    """The streams of `name` resident on the card at once, from a build of
    csrc with the occupancy query appended (static shared memory only)."""
    sl = sl or _this()
    if hasattr(sl, "block"):   # (threads, streams) a block, as C expressions
        threads, per_block = sl.block(name, csrc)
    else:                      # a warp a stream
        per_block = sl.WARPS[name]
        threads = f"32 * {per_block}"
    query = (f'extern "C" int acx_threads() {{ return {threads}; }}\n'
             f'extern "C" int acx_per_block() {{ return {per_block}; }}\n')
    lib, _ = build(sl.OUT / f"resident_{tag}_{name}", csrc, sl.MAIN[name],
                   append=OCCUPANCY.replace("KERNEL", sl.KERNEL[name]) + query)
    lib.acx_resident.argtypes = [I_, I_, I_]
    threads_n, per = lib.acx_threads(), lib.acx_per_block()
    n = lib.acx_resident(0, threads_n, per)
    return f"{n} streams resident (blocks of {threads_n} threads, {per} streams a block)"


def usage(csrc: Path, tag: str, sl=None) -> None:
    """ptxas's registers, stack frame, spills and shared memory and the
    streams resident, for the two kernels of csrc."""
    sl = sl or _this()
    names = tuple(sl.CASES)
    with ThreadPoolExecutor(max_workers=4) as ex:
        ptx = list(ex.map(lambda n: build(sl.OUT / f"usage_{tag}_{n}", csrc, sl.MAIN[n])[1], names))
        res = list(ex.map(lambda n: resident(n, csrc, tag, sl), names))
    for name, p, s in zip(names, ptx, res):
        print(f"[{name} usage] {card()} | {tag}: {p}", flush=True)
        print(f"[{name} usage] {card()} | {tag}: {s}", flush=True)


def builds(root: Path, jobs, B: int, sl=None) -> None:
    """Each job (tag, kernel name, label, csrc, substitutions) built and timed
    on every recorded case against the plain version, two rounds."""
    import torch
    sl = sl or _this()
    r = sl.record(root, B)

    def one(job):
        tag, name, label, csrc, subs = job
        try:
            return tag, name, label, build(sl.OUT / tag, csrc, sl.MAIN[name], subs)[0]
        except SystemExit as e:   # a variant that does not build is reported, not timed
            print(f"[{name} builds] {card()} | {label}: not built: {e}", flush=True)
            return None
    with ThreadPoolExecutor(max_workers=8) as ex:   # one nvcc a job, all started together
        libs = [b for b in ex.map(one, jobs) if b is not None]
    csrc_of = {job[0]: job[3] for job in jobs}
    for rnd in range(2):
        for tag, name, label, lib in libs:
            for case in sl.CASES[name]:
                run, (outs, args) = sl.raw_call(name, lib, r[name][case], csrc_of[tag])
                rc = run()
                torch.cuda.synchronize()
                bad = sl.differing(name, outs, args)
                ms = min(graph_ms(run) for _ in range(3))
                print(f"[{name} builds] {card()} | round {rnd}, {case}, {label}: rc {rc}, {bad} "
                      f"values differ from the plain version, raw graph {ms:.5f} ms", flush=True)


def phases(other: Path, B: int, sl=None) -> None:
    sl = sl or _this()
    other = other.resolve()
    csrc = other / "audio_codec_torch" / "csrc"
    usage(csrc, "other", sl)
    jobs = [(f"first_{name}_{i}", name, label, csrc, subs)
            for name, cuts in sl.PHASES_FIRST.items()
            for i, (label, subs) in enumerate(cuts.items())]
    builds(other, jobs, B, sl)


def variants(B: int, sl=None) -> None:
    sl = sl or _this()
    usage(CSRC, "this", sl)
    jobs = [(f"kept_{name}_{i}", name, label, CSRC, subs)
            for name, cuts in sl.VARIANTS.items() for i, (label, subs) in enumerate(cuts.items())]
    builds(ROOT, jobs, B, sl)


def scaling(root: Path, B: int, sl=None) -> None:
    sl = sl or _this()
    r = sl.record(root, B)
    from audio_codec_torch import kernels as K
    for name, cases in sl.CASES.items():
        for case in cases:
            args = r[name][case]
            for n in getattr(sl, "SCALING", (4, 32, 512, 2048)):
                a = tuple(tile(x, n) for x in args)
                ms = min(graph_ms(lambda: getattr(K, name)(*a)) for _ in range(3))
                print(f"[scaling] {card()} | {name} {case} ({root.name}): {n} streams: graph "
                      f"{ms:.5f} ms", flush=True)


def clock_warps(name: str, args) -> int:
    """The warps a launch runs: a stream a warp, blocks of 4."""
    return -(-args[1].shape[0] // 4) * 4


def clocks(B: int, sl=None) -> None:
    """Median and 90th-percentile cycles of each stage, over the warps that
    ran it to its end."""
    import numpy as np
    import torch
    sl = sl or _this()
    r = sl.record(ROOT, B)
    for name, subs in sl.CLOCKS.items():
        lib, _ = build(sl.OUT / f"clocks_{name}", CSRC, sl.MAIN[name], subs, append=CLOCK_READ)
        lib.acx_clk_read.argtypes = [P_, I_]
        lib.acx_clk_zero.argtypes = [I_]
        last = sl.CLOCK_PHASES[name][-1][1]
        for case in sl.CASES[name]:
            args = r[name][case]
            run, _ = sl.raw_call(name, lib, args, CSRC)
            run()
            torch.cuda.synchronize()
            warps = sl.clock_warps(name, args)
            n = warps * 32
            lib.acx_clk_zero(n)
            run()
            torch.cuda.synchronize()
            clk = np.zeros(n, np.int64)
            lib.acx_clk_read(clk.ctypes.data, n)
            rows = clk.reshape(warps, 32)
            rows = rows[rows[:, last] > 0]
            parts = []
            for a_, b_, label in sl.CLOCK_PHASES[name]:
                both = rows[(rows[:, a_] > 0) & (rows[:, b_] > 0)]
                d = (both[:, b_] - both[:, a_]).astype(np.float64)
                if len(d):
                    parts.append(f"{label} {np.median(d):.0f} ({np.percentile(d, 90):.0f}, "
                                 f"{len(d)} warps)")
            print(f"[clocks] {card()} | {name} {case} ({len(rows)} warps): cycles, median "
                  f"(90th percentile): " + "; ".join(parts), flush=True)


def main(sl=None) -> int:
    sl = sl or _this()
    ap = argparse.ArgumentParser(description=sl.__doc__.splitlines()[0])
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
        raise SystemExit(f"{Path(sl.__file__).stem}: no CUDA device")
    if opt.phases or opt.variants or opt.scaling or opt.clocks:
        if opt.phases:
            phases(opt.phases, opt.streams, sl)
        if opt.variants:
            variants(opt.streams, sl)
        if opt.scaling:
            scaling((opt.root or ROOT).resolve(), opt.streams, sl)
        if opt.clocks:
            clocks(opt.streams, sl)
        return 0
    if opt.root is not None or opt.other is None:
        print(json.dumps(sl.measure((opt.root or ROOT).resolve(), opt.streams)), flush=True)
        return 0
    rc = 0
    for root in (opt.other, ROOT, ROOT, opt.other):
        r = subprocess.run([sys.executable, sl.__file__, "--streams", str(opt.streams), "--root",
                            str(root.resolve())])
        rc = rc or r.returncode
    return rc


if __name__ == "__main__":
    sys.exit(main())
