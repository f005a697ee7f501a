#!/usr/bin/env python3
"""Times the channel coder's encoder and the Phase ECU's first-loss analysis
of audio_codec_torch on a CUDA card: the kernels `fec_encode`
(csrc/fec_encode.cu, K19 enc) and `phecu_spec_ana` (csrc/phecu_spec_ana.cu,
K18a) on the inputs the smoke run's phases give them. Every line printed
carries the card's name and power limit.

The inputs. K19 enc: chip_smoke's phase 6 encoder at EP3 and at EP4 (make_pcm's
material through StreamEncoder, the 80-byte slot, B streams, 8 frames); the
last fec_encode launch of each is recorded (`ep3`, `ep4`). K18a: chip_smoke's
phase 7 block (plc_pcm's material at plc_mode=1, B streams, 16 frames,
plc_loss_plan's losses) through decode_block; of its phecu_spec_ana
launches the busiest (the most streams at a first loss, the launch
chip_smoke times) is recorded as `busiest`; beside it `all_active`, the same
spectra with every stream at a Phase ECU first loss, and `noise`,
tests/torch_kernel_cases.py:phecu_edge_rows' noise row (about 90 peaks)
tiled to B streams, all active. Each kernel is checked against its plain
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
                K19 enc's thread design in blocks of 32 and 16 (PHASES_FIRST),
                built from DIR's sources with text substitutions and run on
                the recorded rows: raw graph ms, two rounds; and DIR's
                registers, stack frame, shared memory and slots or streams
                resident.
  --variants    this checkout's kept designs with their other choices and
                with one phase removed (VARIANTS), built from this
                checkout's sources with text substitutions: raw graph ms,
                two rounds, each checked against the plain version; and this
                checkout's registers, stack frame, shared memory and slots
                or streams resident.
  --scaling     both kernels at 4, 32, 512 and 2048 slots or streams of the
                recorded rows (tiled): graph ms of the wrappers.
  --clocks      the kernels built with clock64() stamps at their stage
                boundaries (CLOCKS): each stage's cycles on the recorded
                launches, median and 90th percentile over the warps.

    python3 tools/torch_fecenc_phecu_times.py [--streams 2048] [--other DIR]
    python3 tools/torch_fecenc_phecu_times.py --phases DIR --variants --scaling --clocks
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
from torch_ltpf_times import make_pcm, times  # noqa: E402
from torch_sns_nf_times import tile  # noqa: E402
from torch_tdc_fxspec_times import CLOCK_PRELUDE, CLOCK_READ, OCCUPANCY  # noqa: E402

CSRC = ROOT / "audio_codec_torch" / "csrc"
OUT = ROOT / "build" / "fecenc_phecu_times"
STREAM_T = 8           # phase 6's frames
PLC_T = 16             # chip_smoke.PLC_FRAMES
P_, I_ = ctypes.c_void_p, ctypes.c_int
ARGTYPES = {"fec_encode": [P_] * 4 + [I_] * 5 + [P_], "phecu_spec_ana": [P_] * 9 + [I_] * 3 + [P_]}
MAIN = {"fec_encode": "fec_encode.cu", "phecu_spec_ana": "phecu_spec_ana.cu"}
KERNEL = {"fec_encode": "fec_encode_kernel", "phecu_spec_ana": "phecu_spec_ana_kernel"}
CASES = {"fec_encode": ("ep3", "ep4"), "phecu_spec_ana": ("busiest", "all_active", "noise")}

# the parent's designs with one phase removed, and K19 enc's cheap change:
# text substitutions (file, old, new) of the sources of the checkout given to
# --phases
_PE_CRC = (("fec.cuh", "  const int rem1 = crc1_rem(dw + c12, p.crc1_n, p.n_crc1, epmr);",
            "  const int rem1 = 0;"),
           ("fec.cuh", "    const int rem2 = crc2_rem(dw + c12 + p.crc1_n, p.pc_split);",
            "    const int rem2 = 0;"))
_PE_PARITY = (("fec.cuh", "        for (int c = 0; c < imin(nd, 13); ++c) par ^= tb.mul(dw[k + c], basis[c * 6 + q]);\n",
               ""),)
_PE_GATHER = (("fec.cuh", """  for (int b = 0; b < slot; ++b) out[b] = 0;
  off = 0;
  for (int i = 0; i < p.ncw; ++i) {
    const int len = fec_cw_len(slot, i);
    for (int j = 0; j < len; ++j) {
      const int o = p.n_nib - 1 - (j * p.ncw + i);
      out[o >> 1] |= cw[off + j] << (4 * (o & 1));
    }
    off += len;
  }
""", """  {
    const int q = p.n_nib / p.ncw, rr = p.n_nib % p.ncw;
    for (int b = 0; b < slot; ++b) {
      int v = 0;
      for (int h = 0; h < 2; ++h) {
        const int t = p.n_nib - 1 - (2 * b + h), i = t % p.ncw, j = t / p.ncw;
        v |= cw[i * q + imin(i, rr) + j] << (4 * h);
      }
      out[b] = v;
    }
  }
"""),)
_PP_MAXMIN = (("phecu.cuh", """    for (int k = 1; k < ns; ++k) {
      mx = fmax2(mx, ws->mag[k]);
      mn = fmin2(mn, ws->mag[k]);
    }
""", ""),)
_PP_SCAN = (("phecu.cuh", "    for (int k = 0; k < ns; ++k) {\n      const float m = ws->mag[k];",
             "    for (int k = 0; k < 0; ++k) {\n      const float m = ws->mag[k];"),)
_PP_COUNT = (("phecu.cuh", "    for (int k = 0; k < ns; ++k) {\n      count += ws->mask[k];",
              "    for (int k = 0; k < 0; ++k) {\n      count += ws->mask[k];"),)
_PP_GROUPS = (("phecu.cuh", "    for (int k = 0; k < ns; ++k) {\n      if (ph_group(k) == src)",
               "    for (int k = 0; k < 0; ++k) {\n      if (ph_group(k) == src)"),)
PHASES_FIRST = {
    "fec_encode": {
        "first design as it is (a thread a slot, blocks of 64)": (),
        "a thread a slot, blocks of 32": (
            ("fec_encode.cu", "constexpr int kFecEncThreads = 64;", "constexpr int kFecEncThreads = 32;"),),
        "a thread a slot, blocks of 16": (
            ("fec_encode.cu", "constexpr int kFecEncThreads = 64;", "constexpr int kFecEncThreads = 16;"),),
        "the interleave gathered, each byte stored once (no global read-modify-write)": _PE_GATHER,
        "no CRCs": _PE_CRC,
        "no parity": _PE_PARITY,
        "staging and writes alone (no CRCs, no parity, the interleave gathered)":
            _PE_CRC + _PE_PARITY + _PE_GATHER,
    },
    "phecu_spec_ana": {
        "first design as it is": (),
        "no max/min loop": _PP_MAXMIN,
        "no hysteresis scan": _PP_SCAN,
        "no count loop": _PP_COUNT,
        "no group sums": _PP_GROUPS,
        "staging alone (magnitudes and writes)": _PP_MAXMIN + _PP_SCAN + _PP_COUNT + _PP_GROUPS,
    },
}

# this checkout's kept designs with their other choices and one phase
# removed: text substitutions (file, old, new)
_KE_PARITY = """  const int32_t* par = tw + kFecParity + (red / 2 - 1) * 13 * 16;
  uint32_t r = 0;
#pragma unroll
  for (int c = 0; c < 13; ++c)
    if (c < nd) r ^= static_cast<uint32_t>(par[16 * c + nib64(d, c)]);
  return r;
"""
# the first design's parity: a basis row times the nibble, GF(16) products
# from the table, a parity nibble at a time
_KE_PARITY_MUL = """  const int32_t* basis = tw + kFecBasis + (red / 2 - 1) * 78;
  uint32_t r = 0;
  for (int q = 0; q < red; ++q) {
    int v = 0;
    for (int c = 0; c < 13; ++c)
      if (c < nd) v ^= tw[kFecMul + nib64(d, c) * 16 + basis[c * 6 + q]];
    r |= static_cast<uint32_t>(v) << (4 * q);
  }
  return r;
"""
_KE_CRC = (("fec.cuh", "    for (int i = l; i < n; i += 32) {\n      const int vi = v[i];",
            "    for (int i = l; i < 0; i += 32) {\n      const int vi = v[i];"),)
_KE_NOPAR = (("fec.cuh", "          cw |= fec_parity(tw, red, d, nd);\n", ""),)
_KP_SCAN = (("phecu.cuh", "    if (32 * c + 32 <= ns) {", "    if (false) {"),
            ("phecu.cuh", "      for (int j = 0; j < ns - 32 * c; ++j) step(", "      for (int j = 0; j < 0; ++j) step("))
_KP_GROUPS = (("phecu.cuh", "      for (int k0 = lo; k0 < hi; k0 += 8) {", "      for (int k0 = lo; k0 < lo; k0 += 8) {"),)
_KP_STEP = """  float thr = radd(ws->mag[0], sens);   // radd(ref, sens)
  float thp = rsub(0.0f, sens);         // rsub(cand, sens)
  float cand = 0.0f;
  uint32_t mode = 0;                    // mode 1: all ones
  auto step = [&](float m, int j, uint32_t& tb, uint32_t& nb) {
    const float mr = radd(m, sens), mp = rsub(m, sens);
    const uint32_t rising = all_if(m > thr) & ~mode;
    const uint32_t new_peak = all_if(m < thp) & mode;
    const uint32_t better = all_if(m >= cand) & mode;
    const uint32_t take = rising | better;
    cand = fsel_bits(take, m, cand);
    thp = fsel_bits(take, mp, thp);
    thr = fsel_bits(new_peak, mr, fsel_bits(mode, thr, fmin2(thr, mr)));
    mode = rising | (mode & ~new_peak);
    tb |= take & (1u << j);
    nb |= new_peak & (1u << j);
  };
"""
# the step on values a step old (the state before a step held as the state
# before the step before and that step's values and masks): more bit
# operations and registers, and slower
_KP_STEP_LAGGED = """  // The state before a step (thr = radd(ref, sens), thp = rsub(cand, sens),
  // cand, mode) is held as the state before the step before (thr1, thp1,
  // cand1), that step's values (m1, mr1, mp1) and masks (np1: a new peak,
  // tk1: a take, md1: its mode), so that each comparison reads values a step
  // old and only masks carry the chain: m > thr is m > mr1 after a new peak,
  // m > thr1 in mode 1, else either (m > min(a, b) is m > a or m > b); m <
  // thp and m >= cand compare with mp1 and m1 after a take, else thp1 and
  // cand1. The step then moves the state one step on, off the chain.
  float thr1 = radd(ws->mag[0], sens), thp1 = rsub(0.0f, sens), cand1 = 0.0f;
  float m1 = 0.0f, mr1 = 0.0f, mp1 = 0.0f;
  uint32_t np1 = 0, tk1 = 0, md1 = ~0u;
  uint32_t mode = 0;                    // mode 1: all ones
  auto step = [&](float m, int j, uint32_t& tb, uint32_t& nb) {
    const float mr = radd(m, sens), mp = rsub(m, sens);
    const uint32_t ga = all_if(m > mr1), gb = all_if(m > thr1);
    const uint32_t gt = (np1 & ga) | (~np1 & ((md1 & gb) | (~md1 & (ga | gb))));
    const uint32_t lt = (tk1 & all_if(m < mp1)) | (~tk1 & all_if(m < thp1));
    const uint32_t ge = (tk1 & all_if(m >= m1)) | (~tk1 & all_if(m >= cand1));
    const uint32_t rising = gt & ~mode;
    const uint32_t new_peak = lt & mode;
    const uint32_t better = ge & mode;
    const uint32_t take = rising | better;
    thr1 = fsel_bits(np1, mr1, fsel_bits(md1, thr1, fmin2(thr1, mr1)));
    thp1 = fsel_bits(tk1, mp1, thp1);
    cand1 = fsel_bits(tk1, m1, cand1);
    m1 = m;
    mr1 = mr;
    mp1 = mp;
    np1 = new_peak;
    tk1 = take;
    md1 = mode;
    mode = rising | (mode & ~new_peak);
    tb |= take & (1u << j);
    nb |= new_peak & (1u << j);
  };
"""
# the step as selects of bools, which the compiler may turn into branches
_KP_STEP_BOOL = """  float thr = radd(ws->mag[0], sens);
  float thp = rsub(0.0f, sens);
  float cand = 0.0f;
  bool mode = false;
  auto step = [&](float m, int j, uint32_t& tb, uint32_t& nb) {
    const float mr = radd(m, sens), mp = rsub(m, sens);
    const bool rising = !mode && m > thr;
    const bool new_peak = mode && m < thp;
    const bool better = mode && m >= cand;
    const bool take = rising || better;
    cand = take ? m : cand;
    thp = take ? mp : thp;
    thr = new_peak ? mr : (mode ? thr : fmin2(thr, mr));
    mode = rising || (mode && !new_peak);
    tb |= static_cast<uint32_t>(take) << j;
    nb |= static_cast<uint32_t>(new_peak) << j;
  };
"""
VARIANTS = {
    "fec_encode": {
        "kept: a warp a slot, blocks of 4 warps, packed parity terms through L1": (),
        "blocks of 1 warp": (("fec_encode.cu", "constexpr int kFecEncWarps = 4;", "constexpr int kFecEncWarps = 1;"),),
        "blocks of 2 warps": (("fec_encode.cu", "constexpr int kFecEncWarps = 4;", "constexpr int kFecEncWarps = 2;"),),
        "blocks of 8 warps": (("fec_encode.cu", "constexpr int kFecEncWarps = 4;", "constexpr int kFecEncWarps = 8;"),),
        "parity as basis x GF(16) products (the first design's form)": (("fec.cuh", _KE_PARITY, _KE_PARITY_MUL),),
        "phase cut: no CRC terms": _KE_CRC,
        "phase cut: no parity": _KE_NOPAR,
        "phase cut: staging and writes alone (no CRC terms, no parity)": _KE_CRC + _KE_NOPAR,
    },
    "phecu_spec_ana": {
        "kept: staged rows, reductions, group ranges on 18 lanes, the scan on every lane": (),
        "blocks of 2 warps": (("phecu_spec_ana.cu", "constexpr int kPhWarps = 4;", "constexpr int kPhWarps = 2;"),),
        "blocks of 8 warps": (("phecu_spec_ana.cu", "constexpr int kPhWarps = 4;", "constexpr int kPhWarps = 8;"),),
        "the scan's step as selects of bools": (("phecu.cuh", _KP_STEP, _KP_STEP_BOOL),),
        "the scan's step on values a step old": (("phecu.cuh", _KP_STEP, _KP_STEP_LAGGED),),
        "the scan on lane 0 alone": (
            ("phecu.cuh", "  float thr = radd(ws->mag[0], sens);", "  w.leader([&] {\n  float thr = radd(ws->mag[0], sens);"),
            ("phecu.cuh", "    ws->peak[c] = nb;\n  }\n  w.sync();\n", "    ws->peak[c] = nb;\n  }\n  });\n  w.sync();\n")),
        "group sums over every bin with a group test (the first design's loop)": (
            ("phecu.cuh", "      for (int k0 = lo; k0 < hi; k0 += 8) {",
             "      for (int k = 0; k < ns; ++k)\n        if (ph_group(k) == src) acc = radd(acc, e[k]);\n"
             "      for (int k0 = lo; k0 < lo; k0 += 8) {"),),
        "phase cut: no scan": _KP_SCAN,
        "phase cut: no group sums": _KP_GROUPS,
        "phase cut: staging, reductions and the refinement alone": _KP_SCAN + _KP_GROUPS,
    },
}


_RECORDED: dict = {}


def noise_row() -> dict:
    """The noise row of tests/torch_kernel_cases.py:phecu_edge_rows, from
    this checkout's file (the parent's may not have the edge rows)."""
    spec = importlib.util.spec_from_file_location("fecenc_phecu_cases",
                                                  ROOT / "tests" / "torch_kernel_cases.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    e, row = mod.phecu_edge_rows(), mod.PHECU_EDGE_ROWS.index("noise")
    return {k: v[row: row + 1] for k, v in e.items()}


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
    import chip_smoke as S
    K.library()
    dev = "cuda"
    # K19 enc: phase 6's encoder at EP3 and EP4
    pcm = torch.from_numpy(make_pcm(STREAM_T, B, 480)).to(dev)
    encs, saved_e = [], K.fec_encode

    def rec_enc(*a):
        encs.append(a)
        return saved_e(*a)
    out = {"fec_encode": {}}
    K.fec_encode = rec_enc
    try:
        for mode in (3, 4):
            enc = engine.StreamEncoder(P.Config(fs_in=48000, bitrate=64000, epmode=mode), B,
                                       device=dev)
            for f in range(STREAM_T):
                enc.encode(pcm[f])
            out["fec_encode"][f"ep{mode}"] = encs[-1]
    finally:
        K.fec_encode = saved_e
    # K18a: phase 7's block
    cfg = P.Config(fs_in=48000, bitrate=64000, plc_mode=1)
    pcm7 = torch.from_numpy(S.plc_pcm(PLC_T, B, 0)).to(dev)
    _, frames = P.encode_block(cfg, P.enc_state_init(cfg, B, device=dev), pcm7)
    bfi = torch.from_numpy(S.plc_loss_plan(PLC_T, B)).to(dev)
    calls, saved = [], K.phecu_spec_ana

    def rec(*a):
        res = saved(*a)
        calls.append((a, res))
        return res
    K.phecu_spec_ana = rec
    try:
        P.decode_block(cfg, P.dec_state_init(cfg, B, device=dev), frames, bfi)
    finally:
        K.phecu_spec_ana = saved
    torch.cuda.synchronize()
    busiest = max(calls, key=lambda c: int(c[0][6].sum()))[0]
    all_active = busiest[:6] + (torch.ones_like(busiest[6]),)
    e = noise_row()
    t_ = lambda k: tile(torch.from_numpy(e[k]).to(dev), B)
    noise = (cfg, t_("Xr"), t_("Xi"), t_("Xor"), t_("Xoi"), t_("nc"),
             torch.ones(B, dtype=torch.bool, device=dev))
    out["phecu_spec_ana"] = {"busiest": busiest, "all_active": all_active, "noise": noise}
    torch.cuda.synchronize()
    return out


def plain(name: str):
    from audio_codec_torch.ops import fec, plc_phecu
    return {"fec_encode": fec.fec_encode_plain, "phecu_spec_ana": plc_phecu.phecu_spec_ana_plain}[name]


def differing(name: str, got, args) -> int:
    import torch
    from tests.torch_kernel_cases import count_differing
    ref = plain(name)(*args)
    torch.cuda.synchronize()
    if name == "fec_encode":
        return count_differing(got, ref)
    return count_differing(list(got), list(ref))


def branches(name: str, args, got) -> dict:
    if name == "fec_encode":
        return {"slots": int(args[0].shape[0]), "slot bytes": int(args[2]), "mode": int(args[3])}
    act, npl = args[6], got[1]
    return {"streams": int(act.numel()), "first losses": int(act.sum()),
            "peaks (median over the first losses)": int(npl[act].float().median()) if bool(act.any()) else 0}


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
    return out


def raw_call(name: str, lib, args, n: int | None, csrc: Path):
    """A call of the C entry point `name` of lib, built from the sources in
    csrc, on the recorded arguments (tiled to n slots or streams where n is
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
    if name == "fec_encode":
        data, epmr, slot, mode, ccc = args
        data = data.to(torch.int32).contiguous()
        epmr = epmr.to(torch.int32).contiguous()
        B, D = data.shape
        # the first design takes fec_tables, this one fec_enc_tables (which
        # begins with them)
        tabs = K.fec_enc_tables(dev) if "kFecEncTableWords" in (csrc / "fec.cuh").read_text() \
            else K.fec_tables(dev)
        o = torch.empty((B, slot), dtype=torch.int32, device=dev)
        return (lambda: fn(data.data_ptr(), epmr.data_ptr(), tabs.data_ptr(), o.data_ptr(), B, D,
                           slot, mode, int(ccc), st())), (o, args)
    cfg, Xr, Xi, Xor, Xoi, nc, active = args
    from audio_codec_torch.ops import plc_phecu as H
    B, ns = Xr.shape
    nc = nc.to(torch.float32).contiguous()
    act = active.to(torch.int32).contiguous()
    f0 = torch.empty((B, ns), dtype=torch.float32, device=dev)
    npl = torch.empty((B,), dtype=torch.int32, device=dev)
    e = torch.empty((2, B, H.MAX_LGW), dtype=torch.float32, device=dev)
    got = (f0, npl, e[0], e[1])
    return (lambda: fn(Xr.data_ptr(), Xi.data_ptr(), Xor.data_ptr(), Xoi.data_ptr(), nc.data_ptr(),
                       act.data_ptr(), f0.data_ptr(), npl.data_ptr(), e.data_ptr(), B, ns,
                       H.n_lgw(cfg), st())), (got, args)


def resident(name: str, csrc: Path, tag: str) -> str:
    """The slots (K19 enc) or streams (K18a) of `name` resident on the card
    at once, from a build of csrc with the occupancy query appended (static
    shared memory only)."""
    text = (csrc / MAIN[name]).read_text()
    if name == "fec_encode" and "kFecEncWarps" in text:
        threads, per_block = "32 * kFecEncWarps", "kFecEncWarps"
    elif name == "fec_encode":   # the first design: a thread a slot
        threads, per_block = "kFecEncThreads", "kFecEncThreads"
    else:
        threads, per_block = "32 * kPhWarps", "kPhWarps"
    query = (f'extern "C" int acx_threads() {{ return {threads}; }}\n'
             f'extern "C" int acx_per_block() {{ return {per_block}; }}\n')
    lib, _ = build(OUT / f"resident_{tag}_{name}", csrc, MAIN[name],
                   append=OCCUPANCY.replace("KERNEL", KERNEL[name]) + query)
    lib.acx_resident.argtypes = [I_, I_, I_]
    threads_n, per = lib.acx_threads(), lib.acx_per_block()
    n = lib.acx_resident(0, threads_n, per)
    unit = "slots" if name == "fec_encode" else "streams"
    return f"{n} {unit} resident (blocks of {threads_n} threads, {per} {unit} a block)"


def usage(csrc: Path, tag: str) -> None:
    """ptxas's registers, stack frame, spills and shared memory and the slots
    or streams resident, for the two kernels of csrc."""
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
    for name, cases in CASES.items():
        for case in cases:
            args = r[name][case]
            for n in (4, 32, 512, 2048):
                a = tuple(tile(x, n) for x in args)
                ms = min(graph_ms(lambda: getattr(K, name)(*a)) for _ in range(3))
                unit = "slots" if name == "fec_encode" else "streams"
                print(f"[scaling] {card()} | {name} {case} ({root.name}): {n} {unit}: graph "
                      f"{ms:.5f} ms", flush=True)


# --clocks: each kernel built with clock64() stamps at its stage boundaries
# (a stamp a warp, lane 0), read back after one launch on each recorded case
CLOCKS = {
    "fec_encode": (
        ("fec.cuh", '#include "warp.cuh"\n', '#include "warp.cuh"\n' + CLOCK_PRELUDE),
        ("fec.cuh", "  const FecPlan p = fec_plan(slot, mode, ccc);\n  const int D = p.data_bytes, c12",
         "  ACX_CLK(0);\n  const FecPlan p = fec_plan(slot, mode, ccc);\n  const int D = p.data_bytes, c12"),
        ("fec.cuh", "  // the CRCs over the lanes, then", "  ACX_CLK(1);\n  // the CRCs over the lanes, then"),
        ("fec.cuh", "  // codewords l and l + 32: data", "  ACX_CLK(2);\n  // codewords l and l + 32: data"),
        ("fec.cuh", "  // the interleave: codeword i nibble j", "  ACX_CLK(3);\n  // the interleave: codeword i nibble j"),
        ("fec.cuh", "      out[b] = nib64(ws->cw[i], j) | nib64(ws->cw[i1], j1) << 4;\n    }\n  });\n",
         "      out[b] = nib64(ws->cw[i], j) | nib64(ws->cw[i1], j1) << 4;\n    }\n  });\n  ACX_CLK(4);\n"),
    ),
    "phecu_spec_ana": (
        ("phecu.cuh", '#include "plc.cuh"\n', '#include "plc.cuh"\n' + CLOCK_PRELUDE),
        ("phecu.cuh", "  // stage the rows; each lane's", "  ACX_CLK(0);\n  // stage the rows; each lane's"),
        ("phecu.cuh", "  // group energies: lane j sums", "  ACX_CLK(1);\n  // group energies: lane j sums"),
        ("phecu.cuh", "  // the hysteresis scan (every lane alike)", "  ACX_CLK(2);\n  // the hysteresis scan (every lane alike)"),
        ("phecu.cuh", "  // the peaks: a new peak marks", "  ACX_CLK(3);\n  // the peaks: a new peak marks"),
        ("phecu.cuh", "  // the refinement, a bin a lane", "  ACX_CLK(4);\n  // the refinement, a bin a lane"),
        ("phecu.cuh", "      f0[k] = v;\n    }\n  });\n}\n", "      f0[k] = v;\n    }\n  });\n  ACX_CLK(5);\n}\n"),
    ),
}
CLOCK_PHASES = {
    "fec_encode": ((0, 1, "staging"), (1, 2, "CRCs"), (2, 3, "codewords"), (3, 4, "interleave"),
                   (0, 4, "the slot")),
    "phecu_spec_ana": ((0, 1, "staging and extremes"), (1, 2, "group energies"), (2, 3, "scan"),
                       (3, 4, "peaks and count"), (4, 5, "refinement"), (0, 5, "the stream")),
}


def clocks(B: int) -> None:
    """Median and 90th-percentile cycles of each stage, over the warps that
    ran it to its end (K18a: the streams at a first loss)."""
    import numpy as np
    import torch
    r = record(ROOT, B)
    for name, subs in CLOCKS.items():
        lib, _ = build(OUT / f"clocks_{name}", CSRC, MAIN[name], subs, append=CLOCK_READ)
        lib.acx_clk_read.argtypes = [P_, I_]
        lib.acx_clk_zero.argtypes = [I_]
        last = CLOCK_PHASES[name][-1][1]
        for case in CASES[name]:
            args = r[name][case]
            run, _ = raw_call(name, lib, args, None, CSRC)
            run()
            torch.cuda.synchronize()
            rows_n = args[0].shape[0] if name == "fec_encode" else args[1].shape[0]
            warps = -(-rows_n // 4) * 4
            n = warps * 32
            lib.acx_clk_zero(n)
            run()
            torch.cuda.synchronize()
            clk = np.zeros(n, np.int64)
            lib.acx_clk_read(clk.ctypes.data, n)
            rows = clk.reshape(warps, 32)
            rows = rows[rows[:, last] > 0]
            parts = []
            for a_, b_, label in CLOCK_PHASES[name]:
                d = (rows[:, b_] - rows[:, a_]).astype(np.float64)
                if len(d):
                    parts.append(f"{label} {np.median(d):.0f} ({np.percentile(d, 90):.0f})")
            print(f"[clocks] {card()} | {name} {case} ({len(rows)} warps): cycles, median "
                  f"(90th percentile): " + "; ".join(parts), flush=True)


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
        raise SystemExit("torch_fecenc_phecu_times: no CUDA device")
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
