#!/usr/bin/env python3
"""Times the advanced concealment's time-domain part and the fixed-point
decoder's spectral chain of audio_codec_torch on a CUDA card: the kernels
`plc_tdc` (csrc/plc_tdc.cu, K17a) and `fx_spec_decode`
(csrc/fx_spec_decode.cu, K20b) on the inputs the smoke run's phases give
them. Every line printed carries the card's name and power limit.

The inputs. K17a: chip_smoke's phase 7 block (plc_pcm's material at 48 kHz /
64 kbps with plc_mode=1, B streams, 16 frames, plc_loss_plan's losses),
decoded by the checkout's decode_block; of its plc_tdc launches the busiest
(chip_smoke.plc_work's operations, the launch chip_smoke times) is recorded
as `busiest`. Beside it `all_tdc`: every stream at a TD-PLC first loss, the
lanes of tests/torch_kernel_cases.py:tdc_stream_rows that the classifier
sends to TD-PLC at a first loss, tiled to B streams (the launch whose wave
count matters). K20b: chip_smoke's phase 8 block (make_pcm's material
encoded for 8 frames, its last 64 streams silent) through
DeviceFixedDecoder.decode_block; its one fx_spec_decode launch over the T x B
frames is recorded. Each kernel is checked against its plain version bit for
bit, then timed as median loop ms (5 loops of 20 calls) and graph ms (20
calls replayed from a CUDA graph, the best of 3); `raw` is the C entry point
alone on the arguments as the wrapper hands them over (graph ms).

  (default)     this checkout, one JSON line.
  --other DIR   the same for a checkout of another commit (the parent
                unpacked with `git archive` into a directory that .gitignore
                lists), in turns with this one, each in a process of its
                own: other, this, this, other.
  --phases DIR  the kernels of the checkout DIR with one phase removed
                (PHASES_FIRST), built from DIR's sources with text
                substitutions and run on the recorded rows: raw graph ms,
                two rounds; and DIR's registers, shared memory and streams
                or frames resident.
  --variants    this checkout's kept designs with their other choices and
                with one phase removed (VARIANTS), built from this
                checkout's sources with text substitutions: raw graph ms,
                two rounds, each checked against the plain version; and this
                checkout's registers, shared memory and streams or frames
                resident.
  --scaling     both kernels at 4, 32, 512 and 2048 streams of the recorded
                rows (tiled; K20b at 8 frames a stream): graph ms of the
                wrappers.
  --step-bench  ns of one step of K17a's synthesis (a sample) and of one
                step of K20b's lattice wave, each the difference of two
                lengths run by one warp (the chain's latency).
  --clocks      the kernels built with clock64() stamps at their phase
                boundaries (CLOCKS): each phase's cycles on the recorded
                launches, median and 90th percentile over the warps that
                run it.

    python3 tools/torch_tdc_fxspec_times.py [--streams 2048] [--other DIR]
    python3 tools/torch_tdc_fxspec_times.py --phases DIR --variants --scaling --step-bench
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
sys.path.insert(0, str(ROOT))
from torch_dct4_times import NVCC_FLAGS, card, graph_ms, nvcc  # noqa: E402
from torch_ltpf_times import make_pcm, times  # noqa: E402
from torch_sns_nf_times import tile  # noqa: E402

CSRC = ROOT / "audio_codec_torch" / "csrc"
OUT = ROOT / "build" / "tdc_fxspec_times"
SILENT = 64            # chip_smoke.FIXED_SILENT
PLC_T = 16             # chip_smoke.PLC_FRAMES
FIXED_T = 8            # phase 8's block
P_, I_, F_ = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
ARGTYPES = {"plc_tdc": [P_] * 16 + [I_] * 11 + [F_] * 3 + [P_],
            "fx_spec_decode": [P_] * 9 + [I_] * 7 + [P_]}
MAIN = {"plc_tdc": "plc_tdc.cu", "fx_spec_decode": "fx_spec_decode.cu"}
CASES = {"plc_tdc": ("busiest", "all_tdc"), "fx_spec_decode": ("block",)}

# streams (K17a) or frames (K20b) resident on the card at once: a query
# appended to a build of the kernel's file. K17a: one block a stream of
# THREADS threads and SMEM bytes; K20b: FRAMES frames a block of THREADS
# threads and SMEM bytes (its words a warp given by the file).
OCCUPANCY = r"""
#ifdef __CUDACC__
extern "C" int acx_resident(int smem, int threads, int per_block) {
  int n = 0, sms = 0;
  cudaFuncSetAttribute(KERNEL, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, KERNEL, threads, smem);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, 0);
  return n * sms * per_block;
}
#endif
"""

# the parent's designs with one phase removed: text substitutions (file,
# old, new) of the sources of the checkout given to --phases
_TP_SYNTH = "  // LPC synthesis and de-emphasis: one lane, sample by sample\n  if (w.leader()) {\n"
_TP_RES = "      for (int j = 2; j <= kTdcOrder; ++j) acc = xfma(a[j], ws->pe[kTdcOrder - j + tt], acc);\n"
_TP_FIR = "    for (int m = 2; m < kTdcFir; ++m) hp = xfma(ws->rnd[i + m], t.hp[m], hp);\n"
_TP_APPLY = "  if (lost && meth == 3) {\n    tdc_apply(w, s, g, t, ws, fract);\n"
_TP_CLASSIFY = "  if (first) {\n    tdc_classify(w, s, g, t, ws);\n"
_FP_LATTICE = "    if (w.leader()) {\n      // the lattice, its state carried from bin to bin (lane 0): state and\n"
_FP_RES_SCAN = "  w.scan_count(n, [&](int i) { return xs[i] != 0; }, [&](int i, int rank, bool nz) {\n"
_FP_NF = "  if (sd[kZeroFrame] == 0) {\n"
_FP_GAIN = "  // ---- processApplyGlobalGain_fx\n"
PHASES_FIRST = {
    "plc_tdc": {
        "first design as it is": (),
        "no synthesis nor de-emphasis (lane 0's recurrences skipped)": (
            ("plc_tdc.cuh", _TP_SYNTH, _TP_SYNTH.replace("w.leader()", "w.leader() && g.fl < 0")),),
        "no residual (a tap a residual sample)": (("plc_tdc.cuh", _TP_RES, ""),),
        "no noise FIR (two taps a sample)": (("plc_tdc.cuh", _TP_FIR, ""),),
        "classify and LPC alone (no TD-PLC; the copy-through)": (
            ("plc_tdc.cuh", _TP_APPLY, _TP_APPLY.replace("meth == 3", "meth == 3 && g.fl < 0")),),
        "staging and the writes alone (no classify, LPC or TD-PLC)": (
            ("plc_tdc.cuh", _TP_APPLY, _TP_APPLY.replace("meth == 3", "meth == 3 && g.fl < 0")),
            ("plc_tdc.cuh", _TP_CLASSIFY, _TP_CLASSIFY.replace("(first)", "(first && g.fl < 0)"))),
    },
    "fx_spec_decode": {
        "first design as it is": (),
        "no lattice (lane 0's loop skipped)": (
            ("fx_spec_decode.cuh", _FP_LATTICE, _FP_LATTICE.replace("w.leader()", "w.leader() && g.N < 0")),),
        "the lattice alone (no residual or noise-filling scans)": (
            ("fx_spec_decode.cuh", _FP_RES_SCAN, "  if (g.N < 0)\n" + _FP_RES_SCAN),
            ("fx_spec_decode.cuh", _FP_NF, _FP_NF.replace("== 0)", "== 0 && g.N < 0)"))),
        "the three scans alone (and the staging)": (
            ("fx_spec_decode.cuh", _FP_GAIN,
             "  if (g.N > 0) {\n    if (w.leader()) *x_e_out = x_e;\n    return;\n  }\n" + _FP_GAIN),),
        "the staging and the shaped writes alone (no scans, no lattice)": (
            ("fx_spec_decode.cuh", _FP_RES_SCAN, "  if (g.N < 0)\n" + _FP_RES_SCAN),
            ("fx_spec_decode.cuh", _FP_NF, _FP_NF.replace("== 0)", "== 0 && g.N < 0)")),
            ("fx_spec_decode.cuh", _FP_LATTICE, _FP_LATTICE.replace("w.leader()", "w.leader() && g.N < 0"))),
    },
}

# this checkout's kept designs with their other choices and one phase
# removed: text substitutions (file, old, new)
_TK_CALL = "  tdc_synth_warp(w.coder(), ws->a, mem, e2, length, fl, g.pre_fac, s.x[L - 1], s.hist);\n"
_TK_APPLY = "// tdc_apply for one lane concealed by TD-PLC this frame (active), a in ws->a\n"
# form (a): the synthesis on one lane, the 16 pending sums floats held in
# doubles and rounded by (x + M) - M (no conversion on the chain; the loop
# unrolled by 16, every index static), a block of 16 samples taken again
# exactly where a rounding left its range
_TK_LANE = r"""
template <bool kExact>
ACX_HD double tdc_round(double x, bool& far) {
  if constexpr (kExact) {
    return round_float(x);
  } else {
    return round_float_near(x, far);
  }
}
template <bool kExact, bool kGiven>
ACX_HD bool tdc_lane_block(double (&P)[16], const double (&ad)[17], double& m, double pre,
                           const float* e, int n0, float (&ys)[16], float (&ms)[16]) {
  bool far = false;
#pragma unroll
  for (int k = 0; k < 16; ++k) {
    const double ek = static_cast<double>(kGiven ? e[k] : e[tdc_pad(n0 + k)]);
    const double y = kGiven ? ek : tdc_round<kExact>(radd_f64(ek, -P[k]), far);
#pragma unroll
    for (int j = 1; j <= 16; ++j) {
      const int q = (k + j) & 15;
      P[q] = tdc_round<kExact>(rfma_f64(y, ad[j], j == 16 ? 0.0 : P[q]), far);
    }
    if (!kGiven) {
      m = tdc_round<kExact>(rfma_f64(pre, m, y), far);
      ys[k] = to_float(y);
      ms[k] = to_float(m);
    }
  }
  return far;
}
ACX_HD void tdc_synth_lane(const float* a, const float* mem, float* e2, int length, int fl,
                           float pre_fac, float m0, float* hist) {
  double ad[17], P[16], P0[16];
  float ys[16], ms[16];
  for (int j = 0; j <= 16; ++j) ad[j] = static_cast<double>(a[j]);
  for (int k = 0; k < 16; ++k) P[k] = 0.0;
  double m = static_cast<double>(m0), m_0;
  const double pre = static_cast<double>(pre_fac);
  if (tdc_lane_block<false, true>(P, ad, m, pre, mem, 0, ys, ms)) {
    for (int k = 0; k < 16; ++k) P[k] = 0.0;
    tdc_lane_block<true, true>(P, ad, m, pre, mem, 0, ys, ms);
  }
  for (int n0 = 0; n0 < tdc_synth_len(length); n0 += 16) {
    for (int k = 0; k < 16; ++k) P0[k] = P[k];
    m_0 = m;
    if (tdc_lane_block<false, false>(P, ad, m, pre, e2, n0, ys, ms)) {
      for (int k = 0; k < 16; ++k) P[k] = P0[k];
      m = m_0;
      tdc_lane_block<true, false>(P, ad, m, pre, e2, n0, ys, ms);
    }
    for (int k = 0; k < 16; ++k) {
      const int n = n0 + k;
      e2[tdc_pad(n)] = ms[k];
      if (n >= fl - 16 && n < fl) hist[n - (fl - 16)] = ys[k];
    }
  }
}

"""
_TK_WORK = "  float mem[kTdcOrder];     // the synthesis memory: pe's last 16 values or hist_in\n"
_FK_WAVE = "  fx_tns_wave(v, nf, tf, xs, n, tidx, tab);\n"
_FK_POST = "// The stages after the lattice, one frame: processScfScaling,\n"
# the lattice on lane 0, bin after bin, in 32-bit arithmetic with no branch
_FK_LANE0 = r"""template <class W>
ACX_HD void fx_tns_lane0(const W& w, const FxTnsFrame& F, SpecWord* xs, const int32_t* ti,
                         const i64* tab) {
  if (w.leader()) {
    int32_t rc0[8], rc1[8], st[8], nst[8];
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      rc0[k] = static_cast<int32_t>(tab[kSpecPts + clamp64(ti[k], 0, 16)]);
      rc1[k] = static_cast<int32_t>(tab[kSpecPts + clamp64(ti[8 + k], 0, 16)]);
      st[k] = 0;
    }
    for (int i = F.lo; i < F.hi; ++i) {
      const bool in2 = F.numf2 != 0 && i >= F.start1 && i < F.bw_stop && F.o1 > 0;
      const bool act = in2 || (i >= F.start0 && i < F.stop1 && F.o0 > 0);
      const int om1 = iclamp((in2 ? F.o1 : F.o0) - 1, 0, 7);
      int32_t xi = static_cast<int32_t>(xs[i]);
#pragma unroll
      for (int kk = 7; kk >= 0; --kk) {
        const int32_t rc = in2 ? rc1[kk] : rc0[kk];
        const int32_t s = st[kk];
        xi = act && kk <= om1 ? sub_sat32(xi, mpy32_16(s, rc)) : xi;
        if (kk < 7) nst[kk + 1] = act && kk < om1 ? add_sat32(s, mpy32_16(xi, rc)) : st[kk + 1];
      }
      nst[0] = act ? xi : st[0];
#pragma unroll
      for (int k = 0; k < 8; ++k) st[k] = nst[k];
      xs[i] = xi;
    }
  }
  w.sync();
}

"""
_FK_CU = (CSRC / "fx_spec_decode.cu").read_text()
_FK_WAVE_CU = ("    fx_tns_wave(CoderCardWarp{lane}, nf, tf, xs, g.yLen, tidx + static_cast<size_t>(l0) * 16, "
               "tab);\n")
_FK_BODY_START = "  const int l0 = blockIdx.x * kFxSpecFrames;\n"
_FK_BODY_END = "                 tf[wi].x_e, out + l * g.N, x_e + l);\n  }\n}\n"
_FK_BODY_B = (_FK_CU[_FK_CU.index(_FK_BODY_START):_FK_CU.index(_FK_BODY_END) + len(_FK_BODY_END)]
              if _FK_BODY_START in _FK_CU and _FK_BODY_END in _FK_CU else "(the kept body)")
# layout (a): a warp takes four frames end to end (fx_spec_decode_lane), the
# stages before and after the lattice frame after frame
_FK_BODY_A = r"""  const int l0 = (blockIdx.x * kFxSpecWarps + wi) * kFxSpecFrames;
  if (l0 >= L) return;           // whole warps leave together
  unsigned char* base = smem + wi * (spec_frames_bytes(g.yLen) + spec_run_bytes(g.yLen));
  FxTnsFrame* tf = reinterpret_cast<FxTnsFrame*>(base);
  SpecWord* xs = reinterpret_cast<SpecWord*>(tf + kFxSpecFrames);
  int16_t* run = reinterpret_cast<int16_t*>(base + spec_frames_bytes(g.yLen));
  const size_t ls = static_cast<size_t>(l0);
  fx_spec_decode_lane(Warp{lane}, CoderCardWarp{lane}, imin(kFxSpecFrames, L - l0),
                      x + ls * g.yLen, res + ls * g.R, side + ls * kSpecSideWords, tidx + ls * 16,
                      scf + ls * g.n_bands, scf_e + ls * g.n_bands, tab, g, xs, run, tf,
                      out + ls * g.N, x_e + ls);
}
"""
_FK_LAYOUT_A = (
    ("fx_spec_decode.cu", "static_assert(kFxSpecWarps == kFxSpecFrames, \"a block's warps are its frames\");\n", ""),
    ("fx_spec_decode.cu", _FK_BODY_B, _FK_BODY_A),
    ("fx_spec_decode.cu", "  return spec_frames_bytes(yLen) + kFxSpecWarps * spec_run_bytes(yLen);\n",
     "  return kFxSpecWarps * (spec_frames_bytes(yLen) + spec_run_bytes(yLen));\n"),
    ("fx_spec_decode.cu", "  const int blocks = (L + kFxSpecFrames - 1) / kFxSpecFrames;\n",
     "  const int blocks = (L + kFxSpecWarps * kFxSpecFrames - 1) / (kFxSpecWarps * kFxSpecFrames);\n"),
)
VARIANTS = {
    "plc_tdc": {
        "kept: form (b), 16 lanes; rnd and e2 aliased; blocks of 1 warp; 2 chains a lane; staged": (),
        "form (a): one lane, the sums in doubles, unrolled by 16": (
            ("plc_tdc.cuh", _TK_APPLY, _TK_LANE + _TK_APPLY),
            ("plc_tdc.cuh", _TK_CALL,
             "  if (w.leader()) tdc_synth_lane(ws->a, mem, e2, length, fl, g.pre_fac, s.x[L - 1], s.hist);\n"
             "  w.sync();\n")),
        "separate buffers (rnd and e2 not aliased)": (
            ("plc_tdc.cuh", _TK_WORK, _TK_WORK + "  float rnd_s[kTdcRndWords];\n  float e2_s[808];\n"),
            ("plc_tdc.cuh", "ACX_HD float* tdc_rnd(TdcWork* ws) { return ws->buf + (kTdcPeSpan - kTdcRndWords); }",
             "ACX_HD float* tdc_rnd(TdcWork* ws) { return ws->rnd_s; }"),
            ("plc_tdc.cuh", "ACX_HD float* tdc_e2(TdcWork* ws) { return tdc_exc(ws); }",
             "ACX_HD float* tdc_e2(TdcWork* ws) { return ws->e2_s; }")),
        "no register cap (__launch_bounds__ without a minimum of blocks)": (
            ("plc_tdc.cu", "__launch_bounds__(32 * kTdcWarps, 16 / kTdcWarps)", "__launch_bounds__(32 * kTdcWarps)"),),
        "blocks of 2 warps": (("plc_tdc.cu", "constexpr int kTdcWarps = 1;", "constexpr int kTdcWarps = 2;"),),
        "blocks of 4 warps": (("plc_tdc.cu", "constexpr int kTdcWarps = 1;", "constexpr int kTdcWarps = 4;"),),
        "1 chain a lane in the residual and FIRs": (
            ("plc_tdc.cuh", "constexpr int kTdcChains = 2;", "constexpr int kTdcChains = 1;"),),
        "4 chains a lane in the residual and FIRs": (
            ("plc_tdc.cuh", "constexpr int kTdcChains = 2;", "constexpr int kTdcChains = 4;"),),
        "8 chains a lane in the residual and FIRs": (
            ("plc_tdc.cuh", "constexpr int kTdcChains = 2;", "constexpr int kTdcChains = 8;"),),
        "phase cut: no synthesis nor de-emphasis": (("plc_tdc.cuh", _TK_CALL, ""),),
        "phase cut: no classifier (method 3)": (
            ("plc_tdc.cuh", "    tdc_classify(w, s, g, t, ws);\n    meth = ws->meth;\n    nc = ws->nc;\n",
             "    meth = 3;\n"),),
        "phase cut: no band energies nor autocorrelation": (
            ("plc_tdc.cuh", "  w.each(g.n_bands, [&](int b) {", "  if (g.fl < 0) w.each(g.n_bands, [&](int b) {"),
            ("plc_tdc.cuh", "  w.each(ord + 1, [&](int i) {", "  if (g.fl < 0) w.each(ord + 1, [&](int i) {")),
        "phase cut: no Levinson recursion": (
            ("plc_tdc.cuh", "  if (w.leader()) {\n    // the recursion's rows",
             "  if (w.leader() && g.fl < 0) {\n    // the recursion's rows"),),
    },
    "fx_spec_decode": {
        "kept: layout (b), a frame a warp, warp 0 the block's four lattices; int32 words": (),
        "layout (a): a warp four frames end to end, blocks of 4 warps": _FK_LAYOUT_A,
        "layout (a), blocks of 1 warp": _FK_LAYOUT_A + (
            ("fx_spec_decode.cu", "constexpr int kFxSpecWarps = 4;   // a frame a warp",
             "constexpr int kFxSpecWarps = 1;   // a frame a warp"),),
        "the lattice on lane 0 in 32-bit, no branch (each warp its frame)": (
            ("fx_spec_decode.cuh", _FK_POST, _FK_LANE0 + _FK_POST),
            ("fx_spec_decode.cu", "  if (wi == 0) {\n" + _FK_WAVE_CU + "  }\n",
             "  if (wi < nf) fx_tns_lane0(Warp{lane}, tf[wi], xs + wi * g.yLen, tidx + l * 16, tab);\n")),
        "int64 words in shared memory": (
            ("fx_spec_decode.cuh", "using SpecWord = int32_t;", "using SpecWord = i64;"),),
        "at most 40 registers (12 blocks an SM)": (
            ("fx_spec_decode.cu", "__global__ void fx_spec_decode_kernel(",
             "__global__ void __launch_bounds__(128, 12) fx_spec_decode_kernel("),),
        "at most 32 registers (16 blocks an SM)": (
            ("fx_spec_decode.cu", "__global__ void fx_spec_decode_kernel(",
             "__global__ void __launch_bounds__(128, 16) fx_spec_decode_kernel("),),
        "phase cut: no lattice": (("fx_spec_decode.cu", _FK_WAVE_CU, ""),),
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
    usage = " | ".join(m.strip() for m in re.findall(r"ptxas info\s*: (?:Compiling entry function "
                                                    r"'[^']*'|Used [^\n]*)", r.stdout + r.stderr))
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
    from audio_codec_torch import kernels as K
    from audio_codec_torch.fixed_decoder_dev import DeviceFixedDecoder
    import chip_smoke as S
    from tests import torch_kernel_cases as C
    K.library()
    dev = "cuda"
    # K17a: phase 7's block
    cfg = P.Config(fs_in=48000, bitrate=64000, plc_mode=1)
    pcm = torch.from_numpy(S.plc_pcm(PLC_T, B, 0)).to(dev)
    _, frames = P.encode_block(cfg, P.enc_state_init(cfg, B, device=dev), pcm)
    bfi = torch.from_numpy(S.plc_loss_plan(PLC_T, B)).to(dev)
    calls, saved = [], K.plc_tdc

    def rec(*a):
        out = saved(*a)
        calls.append((a, out))
        return out
    K.plc_tdc = rec
    try:
        P.decode_block(cfg, P.dec_state_init(cfg, B, device=dev), frames, bfi)
    finally:
        K.plc_tdc = saved
    torch.cuda.synchronize()
    busiest = max(calls, key=lambda c: S.plc_work("plc_tdc", c[0], c[1])[1])[0]
    # every stream at a TD-PLC first loss: the synthetic lanes that take it
    lanes = []
    for group in C.TDC_LANES:
        d = C.tdc_stream_rows(group)
        for b in range(len(d["nb"])):
            if d["lost"][b] and d["nb"][b] == 1 and d["pitch"][b] > 0:
                lanes.append((group, b))
    rows = {k: [] for k in C.tdc_stream_rows(0)}
    for group, b in lanes:
        d = C.tdc_stream_rows(group)
        for k in rows:
            rows[k].append(np.asarray(d[k])[b])
    t_ = lambda k: tile(torch.as_tensor(np.stack(rows[k])).to(dev), B)
    all_tdc = (cfg, t_("lost"), t_("nb"), t_("x_old_tot"), t_("scf"), t_("q_d"), t_("pitch"),
               t_("fract"), t_("stab"), t_("meth"), t_("a_st"), t_("seed"), t_("gain_c"),
               t_("alpha"), t_("fract_st"), t_("harm"), t_("harm_len"), t_("synth_hist"))
    out = K.plc_tdc(*all_tdc)
    keep = (out["meth"] == 3).cpu()
    if not bool(keep.all()):       # only the lanes the classifier sends to TD-PLC
        sel = torch.nonzero(keep).flatten()
        all_tdc = tuple(tile(a[sel.to(dev)], B) if isinstance(a, torch.Tensor) else a
                        for a in all_tdc)
    # K20b: phase 8's block
    cfg8 = P.Config(fs_in=48000, bitrate=64000)
    pcm8 = torch.from_numpy(make_pcm(FIXED_T, B, 480)).to(dev)
    _, fr8 = P.encode_block(cfg8, P.enc_state_init(cfg8, B, device=dev), pcm8)
    silent = torch.zeros((FIXED_T, SILENT, 480), device=dev)
    _, quiet = P.encode_block(cfg8, P.enc_state_init(cfg8, SILENT, device=dev), silent)
    fr8[:, B - SILENT:] = quiet
    spec, saved8 = [], K.fx_spec_decode

    def rec8(*a):
        spec.append(a)
        return saved8(*a)
    K.fx_spec_decode = rec8
    try:
        DeviceFixedDecoder(cfg8, B, device=dev).decode_block(fr8)
    finally:
        K.fx_spec_decode = saved8
    torch.cuda.synchronize()
    return {"plc_tdc": {"busiest": busiest, "all_tdc": all_tdc},
            "fx_spec_decode": {"block": spec[-1]}, "frames8": fr8}


def plain(name: str):
    from audio_codec_torch.ops import fixed_dev, plc_adv
    return {"plc_tdc": plc_adv.plc_tdc_plain, "fx_spec_decode": fixed_dev.spectrum_decode_plain}[name]


def differing(name: str, got, args) -> int:
    import torch
    from tests.torch_kernel_cases import count_differing
    ref = plain(name)(*args)
    torch.cuda.synchronize()
    if name == "plc_tdc":
        return count_differing({k: got[k] for k in ref}, ref)
    return count_differing(list(got), list(ref))


def tdc_branches(args, out) -> dict:
    lost, nb, fr = args[1].bool(), args[2], args[7]
    first = lost & (nb == 1)
    tdc = lost & (out["meth"] == 3)
    return {"streams": int(lost.numel()), "TD-PLC first losses": int((tdc & first).sum()),
            "TD-PLC later losses": int((tdc & ~first).sum()),
            "fractional pitch": int((tdc & first & (fr > 0)).sum())}


def spec_branches(args) -> dict:
    order, bw = args[10], args[7]
    on = (order > 0).any(dim=1)
    two = (order[:, 0] > 0) & (order[:, 1] > 0) & (bw >= 3)
    return {"frames": int(order.shape[0]), "TNS on": int(on.sum()), "two filters": int(two.sum())}


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
            run, _ = raw_call(name, K.library(), args, None)
            raw = min(graph_ms(run) for _ in range(3))
            info = tdc_branches(args, got) if name == "plc_tdc" else spec_branches(args)
            out[f"{name} {case}"] = {"differ": differing(name, got, args), **info,
                                     **times(lambda: fn(*args)), "raw_graph_ms": raw}
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


def raw_call(name: str, lib, args, n: int | None):
    """A call of the C entry point `name` of lib on the recorded arguments
    (tiled to n streams, or frames for K20b, where n is given), converted as
    the wrapper converts them: (run, (outputs, the arguments))."""
    import torch
    from audio_codec_torch import kernels as K
    st = lambda: torch.cuda.current_stream().cuda_stream
    fn = getattr(lib, f"acx_{name}")
    fn.argtypes = ARGTYPES[name]
    dev = "cuda"
    if n is not None:
        args = tuple(tile(a, n) for a in args)
    if name == "plc_tdc":
        (cfg, lost, nb, x_old, scf, q, pitch, pfr, stab, meth, a, seed, gain_c, alpha, fract,
         harm, hlen, hist) = args
        ftab, itab, geom = K.tdc_tables(cfg, dev)
        B, length = x_old.shape[0], geom[3]
        ints, floats = K.plc_tdc_pack(lost, nb, pitch, pfr, meth, seed, fract, hlen, stab,
                                      gain_c, alpha)
        a_out, harm_out, hist_out = torch.empty_like(a), torch.empty_like(harm), torch.empty_like(hist)
        synth = torch.empty((B, length), dtype=torch.float32, device=dev)
        iout = torch.empty((4, B), dtype=torch.int32, device=dev)
        fout = torch.empty((3, B), dtype=torch.float32, device=dev)
        ins = (x_old, scf, q, a, harm, hist, ints, floats, ftab, itab)
        outs = (a_out, synth, harm_out, hist_out, iout, fout)
        return (lambda: fn(*(v.data_ptr() for v in ins + outs), B, *geom, st())), (outs, args)
    (cfg, x, res, n_res, seed, zf, fac, bw, gg, tidx, order, scf, scf_e) = args
    L, yLen = x.shape
    side = torch.stack([v.to(torch.int32) for v in (n_res, seed, zf, fac, bw, gg)]
                       + [order[:, 0], order[:, 1]], dim=1).contiguous()
    tab = K.nm.table(K.fx_spec_table_pack, yLen, cfg.fs_idx, cfg.frame_dms, cfg.hrmode, device=dev,
                     dtype=torch.int64)
    out = torch.empty((L, cfg.frame_length), dtype=torch.int64, device=dev)
    x_e = torch.empty((L,), dtype=torch.int64, device=dev)
    tidx = tidx.reshape(L, 16).contiguous()
    ins = (x, res, side, tidx, scf, scf_e, tab)
    return (lambda: fn(*(v.data_ptr() for v in ins), out.data_ptr(), x_e.data_ptr(), L, yLen,
                       cfg.frame_length, cfg.bands_number, cfg.frame_dms, cfg.quantizedGainOff,
                       res.shape[1], st())), ((out, x_e), args)


def resident(name: str, csrc: Path, tag: str, args) -> str:
    """The streams (K17a) or frames (K20b) of `name` resident on the card at
    once, from a build of csrc with the occupancy query appended."""
    text = (csrc / MAIN[name]).read_text()
    if name == "plc_tdc":
        lib, _ = build(OUT / f"resident_{tag}_{name}", csrc, MAIN[name],
                       append=OCCUPANCY.replace("KERNEL", "plc_tdc_kernel")
                       + 'extern "C" int acx_tdc_work_bytes() { return sizeof(acx::TdcWork); }\n'
                       + _tdc_block_query(text))
        lib.acx_resident.argtypes = [I_, I_, I_]
        warps = lib.acx_tdc_warps()
        smem = lib.acx_tdc_work_bytes() * warps
        n = lib.acx_resident(smem, 32 * warps, warps)
        return f"{n} streams resident ({smem} bytes of shared memory a block of {warps} warps)"
    lib, _ = build(OUT / f"resident_{tag}_{name}", csrc, MAIN[name],
                   append=OCCUPANCY.replace("KERNEL", "fx_spec_decode_kernel")
                   + _spec_block_query(text))
    lib.acx_resident.argtypes = [I_, I_, I_]
    warps, frames = lib.acx_spec_warps(), lib.acx_spec_frames()
    smem = lib.acx_spec_smem(args[1].shape[1])
    n = lib.acx_resident(smem, 32 * warps, frames)
    return f"{n} frames resident ({smem} bytes of shared memory a block of {warps} warps, {frames} frames)"


def _tdc_block_query(text: str) -> str:
    warps = "kTdcWarps" if "kTdcWarps" in text else "1"
    return f'extern "C" int acx_tdc_warps() {{ return {warps}; }}\n'


def _spec_block_query(text: str) -> str:
    """The block's warps, frames and shared bytes of the kernel file's
    design (the first design: a frame a warp, int64 words; the second a
    frame a warp, or four a warp where its warps are not its frames)."""
    if "spec_block_bytes" in text:
        frames = ("kFxSpecFrames" if "static_assert(kFxSpecWarps == kFxSpecFrames" in text
                  else "kFxSpecWarps * kFxSpecFrames")
        smem = "spec_block_bytes(yLen)"
    else:
        frames, smem = "kFxSpecWarps", "kFxSpecWarps * spec_smem_words(yLen) * sizeof(i64)"
    return (f'extern "C" int acx_spec_warps() {{ return kFxSpecWarps; }}\n'
            f'extern "C" int acx_spec_frames() {{ return {frames}; }}\n'
            f'extern "C" int acx_spec_smem(int yLen) {{ return static_cast<int>({smem}); }}\n')


def usage(root: Path, csrc: Path, tag: str, B: int) -> None:
    """ptxas's registers and shared memory and the streams or frames
    resident, for the two kernels of csrc."""
    r = record(root, B)
    names = tuple(CASES)
    with ThreadPoolExecutor(max_workers=4) as ex:
        ptx = list(ex.map(lambda n: build(OUT / f"usage_{tag}_{n}", csrc, MAIN[n])[1], names))
        res = list(ex.map(lambda n: resident(n, csrc, tag, r[n][CASES[n][0]]), names))
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
    for rnd in range(2):
        for tag, name, label, lib in libs:
            for case in CASES[name]:
                run, (outs, args) = raw_call(name, lib, r[name][case], None)
                rc = run()
                torch.cuda.synchronize()
                if name == "plc_tdc":
                    a_out, synth, harm, hist, iout, fout = outs
                    got = dict(meth=iout[0], nc=fout[0], a=a_out, synth=synth, seed=iout[1],
                               gain_c=fout[1], alpha=fout[2], fract=iout[2], harmonic_buf=harm,
                               harmonic_len=iout[3], synth_hist=hist)
                else:
                    got = outs
                bad = differing(name, got, args)
                ms = min(graph_ms(run) for _ in range(3))
                print(f"[{name} builds] {card()} | round {rnd}, {case}, {label}: rc {rc}, {bad} "
                      f"values differ from the plain version, raw graph {ms:.5f} ms", flush=True)


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
    builds(ROOT, jobs, B)


def scaling(root: Path, B: int) -> None:
    r = record(root, B)
    from audio_codec_torch import kernels as K
    for name, cases in CASES.items():
        for case in cases:
            args = r[name][case]
            for n in (4, 32, 512, 2048):
                m = n * FIXED_T if name == "fx_spec_decode" else n
                a = tuple(tile(x, m) for x in args)
                ms = min(graph_ms(lambda: getattr(K, name)(*a)) for _ in range(3))
                unit = f"{n} streams x {FIXED_T} frames" if name == "fx_spec_decode" else f"{n} streams"
                print(f"[scaling] {card()} | {name} {case} ({root.name}): {unit}: graph {ms:.5f} ms",
                      flush=True)


STEP_BENCH = r"""
#include "plc_tdc.cuh"
#include "fx_spec_decode.cuh"
using namespace acx;
// K17a: one warp runs tdc_synth_warp over e2 [n] (n a multiple of 16),
// staged in shared memory as in the kernel
__global__ void synth_bench(const float* a, const float* mem, float* e2, int n, float* hist) {
  extern __shared__ float sm[];
  for (int i = threadIdx.x; i < n; i += 32) sm[tdc_pad(i)] = e2[i];
  __syncwarp();
  const CardWarp w{static_cast<int>(threadIdx.x)};
  tdc_synth_warp(w.coder(), a, mem, sm, n, 480, 0.6f, 0.5f, hist);
  for (int i = threadIdx.x; i < n; i += 32) e2[i] = sm[tdc_pad(i)];
}
// K20b: one warp runs fx_tns_wave over four frames of bins [0, n), order 8,
// their rows staged in shared memory as in the kernel
__global__ void wave_bench(fx::SpecWord* xs, int stride, const int32_t* tidx, const fx::i64* tab,
                           int n) {
  extern __shared__ fx::SpecWord sx[];
  __shared__ fx::FxTnsFrame tf[fx::kFxSpecFrames];
  for (int i = threadIdx.x; i < 4 * stride; i += 32) sx[i] = xs[i];
  if (threadIdx.x < fx::kFxSpecFrames) tf[threadIdx.x] = fx::FxTnsFrame{0, n, 0, n, n, n, 8, 0, 0, 0};
  __syncwarp();
  fx::fx_tns_wave(CoderCardWarp{static_cast<int>(threadIdx.x)}, fx::kFxSpecFrames, tf, sx, stride,
                  tidx, tab);
  for (int i = threadIdx.x; i < 4 * stride; i += 32) xs[i] = sx[i];
}
extern "C" int synth(const void* a, const void* mem, void* e2, int n, void* hist, void* st) {
  synth_bench<<<1, 32, tdc_padded(n) * sizeof(float), static_cast<cudaStream_t>(st)>>>(
      static_cast<const float*>(a), static_cast<const float*>(mem), static_cast<float*>(e2), n,
      static_cast<float*>(hist));
  return static_cast<int>(cudaGetLastError());
}
extern "C" int wave(void* xs, int stride, const void* tidx, const void* tab, int n, void* st) {
  wave_bench<<<1, 32, 4 * stride * sizeof(fx::SpecWord), static_cast<cudaStream_t>(st)>>>(
      static_cast<fx::SpecWord*>(xs), stride, static_cast<const int32_t*>(tidx),
      static_cast<const fx::i64*>(tab), n);
  return static_cast<int>(cudaGetLastError());
}
"""


# --clocks: each kernel built with clock64() stamps at its phase boundaries
# (a stamp a warp, lane 0), read back after one launch on each recorded case
CLOCK_PRELUDE = r"""
#ifdef __CUDACC__
__device__ long long acx_clk[1 << 20];
#endif
#ifdef __CUDA_ARCH__
#define ACX_CLK(k) do { if ((threadIdx.x & 31) == 0) \
  acx_clk[(blockIdx.x * (blockDim.x >> 5) + (threadIdx.x >> 5)) * 32 + (k)] = clock64(); } while (0)
#else
#define ACX_CLK(k) do {} while (0)
#endif
"""
CLOCK_READ = r"""
extern "C" int acx_clk_read(void* dst, int n) {
  return static_cast<int>(cudaMemcpyFromSymbol(dst, acx_clk, n * sizeof(long long)));
}
extern "C" int acx_clk_zero(int n) {
  void* p = nullptr;
  cudaGetSymbolAddress(&p, acx_clk);
  return static_cast<int>(cudaMemset(p, 0, n * sizeof(long long)));
}
"""
CLOCKS = {
    "plc_tdc": (
        ("plc_tdc.cuh", '#include "plc.cuh"\n', '#include "plc.cuh"\n' + CLOCK_PRELUDE),
        ("plc_tdc.cu", "  plc_tdc_stream(w, s, g, tdc_tables(ftab, itab, g.n_bands), ws);\n",
         "  ACX_CLK(0);\n  plc_tdc_stream(w, s, g, tdc_tables(ftab, itab, g.n_bands), ws);\n  ACX_CLK(15);\n"),
        ("plc_tdc.cuh", "    tdc_classify(w, s, g, t, ws);\n", "    tdc_classify(w, s, g, t, ws);\n    ACX_CLK(1);\n"),
        ("plc_tdc.cuh", "    tdc_lpc(w, s, g, t, ws);\n", "    tdc_lpc(w, s, g, t, ws);\n    ACX_CLK(2);\n"),
        ("plc_tdc.cuh", "    auto pe_at = ", "    ACX_CLK(3);\n    auto pe_at = "),
        ("plc_tdc.cuh", "    gain_p = gain_p0;\n", "    gain_p = gain_p0;\n    ACX_CLK(4);\n"),
        ("plc_tdc.cuh", "  w.sync();     // exc is dead from here", "  ACX_CLK(5);\n  w.sync();     // exc is dead from here"),
        ("plc_tdc.cuh", "  const float ss = wsum", "  ACX_CLK(6);\n  const float ss = wsum"),
        ("plc_tdc.cuh", "  // LPC synthesis and de-emphasis in transposed order",
         "  ACX_CLK(7);\n  // LPC synthesis and de-emphasis in transposed order"),
        ("plc_tdc.cuh", "  const bool last = nb_loc == 6;", "  ACX_CLK(8);\n  const bool last = nb_loc == 6;"),
        ("plc_tdc.cuh", "  auto cur = [&](int k) {", "  ACX_CLK(9);\n  auto cur = [&](int k) {"),
        ("plc_tdc.cuh", "  const float ec = wsum(", "  ACX_CLK(16);\n  const float ec = wsum("),
        ("plc_tdc.cuh", "  const float ep = wsum(", "  ACX_CLK(17);\n  const float ep = wsum("),
        ("plc_tdc.cuh", "  if (w.leader()) {\n    const float den", "  ACX_CLK(10);\n  if (w.leader()) {\n    const float den"),
        ("plc_tdc.cuh", "  w.each(g.n_bands, [&](int b) {", "  ACX_CLK(11);\n  w.each(g.n_bands, [&](int b) {"),
        ("plc_tdc.cuh", "  // the inverse ODFT's column", "  ACX_CLK(12);\n  // the inverse ODFT's column"),
        ("plc_tdc.cuh", "  if (w.leader()) {\n    // the recursion's rows", "  ACX_CLK(13);\n  if (w.leader()) {\n    // the recursion's rows"),
        ("plc_tdc.cuh", "    float a[kTdcOrder + 1];\n", "    ACX_CLK(14);\n    float a[kTdcOrder + 1];\n"),
    ),
    "fx_spec_decode": (
        ("fx_spec_decode.cuh", '#include "warp.cuh"\n', '#include "warp.cuh"\n' + CLOCK_PRELUDE),
        ("fx_spec_decode.cu", "  if (wi < nf) {\n    fx_spec_pre(", "  ACX_CLK(0);\n  if (wi < nf) {\n    fx_spec_pre("),
        ("fx_spec_decode.cu", "  __syncthreads();\n  if (wi == 0) {",
         "  ACX_CLK(1);\n  __syncthreads();\n  ACX_CLK(2);\n  if (wi == 0) {"),
        ("fx_spec_decode.cu", "  }\n  __syncthreads();\n  if (wi < nf) {\n    fx_spec_post(",
         "  }\n  ACX_CLK(3);\n  __syncthreads();\n  ACX_CLK(4);\n  if (wi < nf) {\n    fx_spec_post("),
        ("fx_spec_decode.cu", "                 tf[wi].x_e, out + l * g.N, x_e + l);\n  }\n}\n",
         "                 tf[wi].x_e, out + l * g.N, x_e + l);\n  }\n  ACX_CLK(5);\n}\n"),
    ),
}
CLOCK_PHASES = {
    "plc_tdc": ((0, 9, "classify's staging"), (9, 16, "classify's first windowed sum"),
                (16, 17, "its second"), (17, 10, "its third"),
                (10, 1, "classify's leader (centroid)"), (1, 11, "LPC's staging"),
                (11, 12, "band energies"), (12, 13, "autocorrelation"), (13, 2, "Levinson recursion"),
                (2, 14, "pre-emphasis"), (14, 3, "residual"), (3, 4, "pitch and gains (windowed sums)"),
                (4, 5, "damping, memory, harmonic cycle"), (5, 6, "generator and noise FIR"),
                (6, 7, "noise energy and the ramps"), (7, 8, "synthesis and de-emphasis"),
                (8, 15, "the writes"), (0, 15, "the stream")),
    "fx_spec_decode": ((0, 1, "stages before the lattice (warp 0's frame)"), (1, 2, "waiting for the block"),
                       (2, 3, "the lattices (warp 0)"), (4, 5, "stages after the lattice"),
                       (0, 5, "the block (warp 0)")),
}


def clocks(B: int) -> None:
    """Median and 90th-percentile cycles of each phase, over the warps that
    run it: K17a's TD-PLC first-loss streams, K20b's blocks with and
    without a lattice (warp 0)."""
    import numpy as np
    import torch
    r = record(ROOT, B)
    for name, subs in CLOCKS.items():
        lib, _ = build(OUT / f"clocks_{name}", CSRC, MAIN[name], subs, append=CLOCK_READ)
        lib.acx_clk_read.argtypes = [P_, I_]
        lib.acx_clk_zero.argtypes = [I_]
        for case in CASES[name]:
            args = r[name][case]
            run, (outs, a) = raw_call(name, lib, args, None)
            run()
            torch.cuda.synchronize()
            warps = args[1].shape[0] if name == "plc_tdc" else -(-args[1].shape[0] // 4) * 4
            n = warps * 32
            lib.acx_clk_zero(n)
            run()
            torch.cuda.synchronize()
            clk = np.zeros(n, np.int64)
            lib.acx_clk_read(clk.ctypes.data, n)
            clk = clk.reshape(warps, 32)
            if name == "plc_tdc":
                rows = clk[(clk[:, 1] > 0) & (clk[:, 8] > 0)]
                groups = {"TD-PLC first losses": rows}
            else:
                w0 = clk[0::4]
                order = args[10].reshape(-1, 4, 2)
                tns = (order > 0).any(axis=(1, 2)).cpu().numpy()[: len(w0)]
                groups = {"blocks with a lattice": w0[tns], "blocks without": w0[~tns]}
            for gname, rows in groups.items():
                parts = []
                for a_, b_, label in CLOCK_PHASES[name]:
                    d = (rows[:, b_] - rows[:, a_]).astype(np.float64)
                    if len(d):
                        parts.append(f"{label} {np.median(d):.0f} ({np.percentile(d, 90):.0f})")
                print(f"[clocks] {card()} | {name} {case}, {gname} ({len(rows)} warps): cycles, "
                      f"median (90th percentile): " + "; ".join(parts), flush=True)


def step_bench() -> None:
    """ns a step of the two chains: one warp's graph ms at two lengths, their
    difference over the steps between (the staging taken off)."""
    import numpy as np
    import torch
    from audio_codec_torch import kernels as K
    d = OUT / "step_bench"
    shutil.rmtree(d, ignore_errors=True)
    d.mkdir(parents=True)
    (d / "bench.cu").write_text(STEP_BENCH)
    r = subprocess.run([nvcc(), *NVCC_FLAGS, f"-I{CSRC}", "-o", str(d / "bench.so"),
                        str(d / "bench.cu")], capture_output=True, text=True)
    if r.returncode:
        raise SystemExit(f"nvcc failed:\n{r.stdout}{r.stderr}")
    lib = ctypes.CDLL(str(d / "bench.so"))
    lib.synth.argtypes = [P_, P_, P_, I_, P_, P_]
    lib.wave.argtypes = [P_, I_, P_, P_, I_, P_]
    st = lambda: torch.cuda.current_stream().cuda_stream
    rng = np.random.default_rng(0)
    # a stable order-16 filter (a decaying impulse response) and signals in
    # the fast range
    a = torch.tensor(np.concatenate([[1.0], -0.9 * 0.5 ** np.arange(1, 17)]), dtype=torch.float32,
                     device="cuda")
    mem = torch.tensor(rng.standard_normal(16) * 100, dtype=torch.float32, device="cuda")
    hist = torch.empty(16, dtype=torch.float32, device="cuda")
    ms = {}
    for n in (784, 3136):
        e = torch.tensor(rng.standard_normal(n) * 100, dtype=torch.float32, device="cuda")
        ms[n] = min(graph_ms(lambda: lib.synth(a.data_ptr(), mem.data_ptr(), e.data_ptr(), n,
                                               hist.data_ptr(), st())) for _ in range(3))
    ns = (ms[3136] - ms[784]) * 1e6 / (3136 - 784)
    print(f"[step] {card()} | K17a synthesis (tdc_synth_warp, one warp): {ns:.2f} ns a sample "
          f"({ms[784]:.5f} ms at 784 samples, {ms[3136]:.5f} at 3136)", flush=True)
    tab = K.nm.table(K.fx_spec_table_pack, 400, 4, 100, False, device="cuda", dtype=torch.int64)
    tidx = torch.tensor(rng.integers(0, 17, 64), dtype=torch.int32, device="cuda")
    ms = {}
    for n in (100, 400):
        xs = torch.tensor(rng.integers(-2 ** 24, 2 ** 24, 4 * 400), device="cuda").to(
            torch.int64 if "using SpecWord = i64;" in (CSRC / "fx_spec_decode.cuh").read_text()
            else torch.int32)
        ms[n] = min(graph_ms(lambda: lib.wave(xs.data_ptr(), 400, tidx.data_ptr(), tab.data_ptr(),
                                              n, st())) for _ in range(3))
    ns = (ms[400] - ms[100]) * 1e6 / (2 * (400 - 100))
    print(f"[step] {card()} | K20b lattice wave (fx_tns_wave, one warp, four frames): {ns:.2f} ns "
          f"a step ({ms[100]:.5f} ms at 100 bins, {ms[400]:.5f} at 400)", flush=True)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--streams", type=int, default=2048)
    ap.add_argument("--other", type=Path, default=None)
    ap.add_argument("--phases", type=Path, default=None)
    ap.add_argument("--variants", action="store_true")
    ap.add_argument("--scaling", action="store_true")
    ap.add_argument("--step-bench", action="store_true")
    ap.add_argument("--clocks", action="store_true")
    ap.add_argument("--root", type=Path, default=None, help=argparse.SUPPRESS)
    opt = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("torch_tdc_fxspec_times: no CUDA device")
    if opt.phases or opt.variants or opt.scaling or opt.step_bench or opt.clocks:
        if opt.phases:
            phases(opt.phases, opt.streams)
        if opt.variants:
            variants(opt.streams)
        if opt.scaling:
            scaling((opt.root or ROOT).resolve(), opt.streams)
        if opt.step_bench:
            step_bench()
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
