#!/usr/bin/env python3
"""Times the fixed-point decoder's SNS decode and the partial-concealment
classifier with the stability factor of audio_codec_torch on a CUDA card:
the kernels `fx_sns_dec` (csrc/fx_sns_dec.cu, K20a) and `pc_classify`
(csrc/pc_classify.cu, K15) on the inputs of the smoke run's block. Every line
printed carries the card's name and power limit.

The inputs: chip_smoke's flagship block (make_pcm's material, B streams, 8
frames) encoded, then decoded by DeviceFixedDecoder (K20a's one launch over
the block's T x B frames, `block`) and by decode_block (K15's last launch,
`clean`: every stream's frame clean); beside it K15's `all_detector` and
`all_energy` (chip_smoke.pc_all_path_args: every stream a bfi 2 frame in the
low region, stable, on the peak detector's path or on the energy path). Each
kernel is checked against its plain version bit for bit, then timed as median
loop ms (5 loops of 20 calls) and graph ms (20 calls replayed from a CUDA
graph, the best of 3); `raw` is the C entry point alone on the arguments as
the wrapper hands them over (graph ms); K15's `stage` is what the decoder
calls for it (graph ms): the fused call, or in a checkout of the first design
compute_stab_fac, the classifier's casts and copies and the no-op where. A
checkout of the first designs (the parent) takes its own arguments: K15 the
stability factor as an input, K20a its int64 table.

  (default)     this checkout, one JSON line.
  --other DIR   the same for a checkout of another commit (the parent
                unpacked with `git archive` into a directory that .gitignore
                lists), in turns with this one, each in a process of its
                own: other, this, this, other.
  --phases DIR  the first designs of the checkout DIR with a phase removed
                (PHASES_FIRST), raw graph ms, two rounds; and DIR's
                registers, stack frame, shared memory and streams resident.
  --variants    this checkout's designs with their other choices and with a
                phase removed (VARIANTS), raw graph ms, two rounds, each
                checked against the plain version; and this checkout's
                registers, stack frame, shared memory and streams resident.
  --scaling     both kernels at 4 to 16 384 frames or streams of the
                recorded rows (tiled): graph ms of the wrappers.
  --clocks      the kernels built with clock64() stamps at their stage
                boundaries (CLOCKS): each stage's cycles, median and 90th
                percentile over the warps.

The modes run through tools/torch_subst_damp_times.py's functions, given
this module's tables and hooks.

    python3 tools/torch_snsdec_pc_times.py [--streams 2048] [--other DIR]
    python3 tools/torch_snsdec_pc_times.py --phases DIR
    python3 tools/torch_snsdec_pc_times.py --variants --scaling --clocks

--phases runs in a process of its own: a process imports one checkout's
package, and the other modes time this checkout's.
"""
from __future__ import annotations

import ctypes
import importlib.util
import inspect
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT / "tools"))
sys.path.insert(0, str(ROOT))
import torch_subst_damp_times as SD  # noqa: E402
from torch_dct4_times import graph_ms  # noqa: E402
from torch_tdc_fxspec_times import CLOCK_PRELUDE  # noqa: E402

OUT = ROOT / "build" / "snsdec_pc_times"
FRAMES = 8             # chip_smoke's --frames
P_, I_, F_ = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
MAIN = {"fx_sns_dec": "fx_sns_dec.cu", "pc_classify": "pc_classify.cu"}
KERNEL = {"fx_sns_dec": "fx_sns_dec_kernel", "pc_classify": "pc_classify_kernel"}
CASES = {"fx_sns_dec": ("block",), "pc_classify": ("clean", "all_detector", "all_energy")}
SCALING = (4, 32, 512, 2048, 16384)

# the parent's designs with a phase removed: text substitutions (file, old,
# new) of the sources of the checkout given to --phases
_FS_DEINDEX = (("fx_sns_dec.cuh", "  i64 y[16];\n  i64* h = scratch;\n",
                "  i64 y[16] = {};\n  i64* h = scratch;\n  if (false)\n"),)
_FS_IDCT = (("fx_sns_dec.cuh", "  idct16(y);\n", ""),)
_FS_INVLOG = (("fx_sns_dec.cuh",
               "    scf[b * os] = mac_r(tab_at(tab, kSnsInvLog1, 64, t1), tab_at(tab, kSnsInvLog2, 64, t1), t2);",
               "    scf[b * os] = x + t1 + t2;"),)
_FS_STORES = (("fx_sns_dec.cu", "  fx_sns_dec_lane(idx + 7 * static_cast<size_t>(l), tab, n_bands,",
               "  for (int b = 0; b < n_bands; ++b) {\n"
               "    scf[static_cast<size_t>(l) * n_bands + b] = idx[7 * static_cast<size_t>(l)];\n"
               "    scf_e[static_cast<size_t>(l) * n_bands + b] = b;\n  }\n"
               "  if (false) fx_sns_dec_lane(idx + 7 * static_cast<size_t>(l), tab, n_bands,"),)
_PC_NO_DETECTOR = (("pc_classify.cuh", "  if (pitch_present == 1) {", "  if (false) {"),)
_PC_NO_MEAN = (("pc_classify.cuh", "  for (int i = 0; i < N; ++i) sum = radd(sum, rmul(sig[i], sig[i]));",
                "  for (int i = 0; i < 0; ++i) sum = radd(sum, rmul(sig[i], sig[i]));"),)
_PC_NO_ENERGY = (("pc_classify.cuh", "    float part = 0.0f, full = 0.0f;\n    for (int i = 0; i < N; ++i) {",
                  "    float part = 0.0f, full = 0.0f;\n    for (int i = 0; i < 0; ++i) {"),)
_PC_EARLY = (("pc_classify.cuh", "  if (!(bfi == 2 && low_region)) return bfi;", "  return bfi;"),)
PHASES_FIRST = {
    "fx_sns_dec": {
        "first design as it is": (),
        "no de-index (every pulse 0)": _FS_DEINDEX,
        "no idct": _FS_IDCT,
        "no InvLog2 (the bands stored as they are)": _FS_INVLOG,
        "stores alone": _FS_STORES,
    },
    "pc_classify": {
        "first design as it is": (),
        "no peak detector (the energy path for every stream)": _PC_NO_DETECTOR,
        "no mean-energy chain in the detector": _PC_NO_MEAN,
        "no energy chains": _PC_NO_ENERGY,
        "early return only": _PC_EARLY,
    },
}

# this checkout's designs with their other choices and a phase removed
VARIANTS = {
    "fx_sns_dec": {
        "kept: a warp a frame, 32-bit words, the offsets table, blocks of 4 warps": (),
        "blocks of 2 warps": (("fx_sns_dec.cu", "constexpr int kFxSnsWarps = 4;",
                               "constexpr int kFxSnsWarps = 2;"),),
        "blocks of 8 warps": (("fx_sns_dec.cu", "constexpr int kFxSnsWarps = 4;",
                               "constexpr int kFxSnsWarps = 8;"),),
        "phase cut: no de-index (every pulse 0)": (
            ("fx_sns_dec.cuh", "  if (submode == 0 || submode == 1) {",
             "  if (true) {\n  } else if (submode == 0 || submode == 1) {"),),
        "phase cut: no idct (input 0 taken as every output)": (
            ("fx_sns_dec.cuh", "q[j] = sat16w(base + mult_rw(gval, idct16_pick(v, k)));",
             "q[j] = sat16w(base + mult_rw(gval, v[0]));"),),
        "phase cut: no InvLog2 (the bands stored as they are)": (
            ("fx_sns_dec.cuh", "scf[b] = mac_rw(tab[kSnsInvLog1 + t1], tab[kSnsInvLog2 + t1], t2);",
             "scf[b] = x + t1 + t2;"),),
    },
    "pc_classify": {
        "kept: a stream a lane, rows staged 16 at a time, the detector on the warp": (),
        "groups of 8 rows": (("pc_classify.cuh", "constexpr int kPcGroup = 16;",
                              "constexpr int kPcGroup = 8;"),),
        "the chains a value at a time": (("pc_classify.cuh", "constexpr int kPcChunk = 16;",
                                          "constexpr int kPcChunk = 1;"),),
        "phase cut: no peak detector": (("pc_classify.cuh", "      if (w.shfl(pitch, src) == 1) {",
                                         "      if (false) {"),),
        "phase cut: no energy chains": (("pc_classify.cuh",
                                         "        for (int i0 = 0; i0 < p.N; i0 += kPcChunk) {",
                                         "        for (int i0 = 0; i0 < 0; i0 += kPcChunk) {"),),
        "phase cut: no staging": (("pc_classify.cuh", "for (int c = l; c < n4; c += 32) pc_copy16",
                                   "for (int c = l; c < 0; c += 32) pc_copy16"),),
        "phase cut: the vectors and the stability factor alone": (
            ("pc_classify.cuh", "  unsigned todo = w.ballot(need);", "  unsigned todo = 0u * w.ballot(need);"),),
    },
}

# --clocks: stamps at the stage boundaries (a stamp a warp, lane 0)
CLOCKS = {
    "fx_sns_dec": (
        ("fx_sns_dec.cuh", '#include "warp.cuh"\n', '#include "warp.cuh"\n' + CLOCK_PRELUDE),
        ("fx_sns_dec.cuh", "  typename W::template Lanes<SnsMpvqColumn> col;\n  IL iv, y;\n",
         "  ACX_CLK(0);\n  typename W::template Lanes<SnsMpvqColumn> col;\n  IL iv, y;\n"),
        ("fx_sns_dec.cuh", "  // the pulses' energy:", "  ACX_CLK(1);\n  // the pulses' energy:"),
        ("fx_sns_dec.cuh", "  // processSnsInterpolateScf_fx into the band words",
         "  ACX_CLK(2);\n  // processSnsInterpolateScf_fx into the band words"),
        ("fx_sns_dec.cuh", "  // BASOP_Util_InvLog2_16 of bands l and l + 32",
         "  ACX_CLK(3);\n  // BASOP_Util_InvLog2_16 of bands l and l + 32"),
        ("fx_sns_dec.cuh", "        scf_e[b] = (x >> 11) + 1;\n      }\n    }\n  });\n}\n",
         "        scf_e[b] = (x >> 11) + 1;\n      }\n    }\n  });\n  ACX_CLK(4);\n}\n"),
    ),
    "pc_classify": (
        ("pc_classify.cuh", '#include "warp.cuh"\n', '#include "warp.cuh"\n' + CLOCK_PRELUDE),
        ("pc_classify.cuh", "  const int max_pitch_bin = p.frame_dms == 50 ? 4 : 8;\n  w.lanes(",
         "  const int max_pitch_bin = p.frame_dms == 50 ? 4 : 8;\n  ACX_CLK(0);\n  w.lanes("),
        ("pc_classify.cuh", "  const int n4 = p.N / 4;\n", "  ACX_CLK(1);\n  const int n4 = p.N / 4;\n"),
        ("pc_classify.cuh", "    pc_stage_wait(w);\n", "    pc_stage_wait(w);\n    ACX_CLK(2);\n"),
        ("pc_classify.cuh", "    // each stream's verdict, onto its own lane\n",
         "    ACX_CLK(3);\n    // each stream's verdict, onto its own lane\n"),
        ("pc_classify.cuh", "    w.sync();\n  }\n  w.lanes([&](int l) {\n    const int b = b0 + l;\n    if (b < p.B) {",
         "    w.sync();\n  }\n  ACX_CLK(4);\n  w.lanes([&](int l) {\n    const int b = b0 + l;\n    if (b < p.B) {"),
    ),
}
CLOCK_PHASES = {
    "fx_sns_dec": ((0, 1, "loads and de-index"), (1, 2, "energy, isqrt, idct, gain"),
                   (2, 3, "interpolation"), (3, 4, "InvLog2 and stores"), (0, 4, "the frame")),
    "pc_classify": ((0, 1, "vectors and stability factors"), (1, 2, "last group's staging"),
                    (2, 3, "last group's chains"), (3, 4, "last group's verdicts"),
                    (0, 4, "the warp")),
}

_RECORDED: dict = {}


def record(root: Path, B: int) -> dict:
    """The recorded arguments (see the module's docstring), in the format of
    the checkout at root, made once a process."""
    if B not in _RECORDED:
        _RECORDED[B] = _record(root, B)
    return _RECORDED[B]


def fused_design() -> bool:
    """Whether the imported checkout's classifier takes the stability
    factor's inputs (this design) or the factor itself (the first)."""
    from audio_codec_torch.ops import pc
    return "prev_prev_bfi" in inspect.signature(pc.pc_classify).parameters


def _record(root: Path, B: int) -> dict:
    import torch
    sys.path.insert(0, str(root))
    import audio_codec_torch as P
    from audio_codec_torch import kernels as K
    from audio_codec_torch.fixed_decoder_dev import DeviceFixedDecoder
    from audio_codec_torch.ops import pc
    S = smoke()
    K.library()
    dev = "cuda"
    cfg = P.Config(fs_in=48000, bitrate=64000)
    pcm = torch.from_numpy(S.make_pcm(FRAMES, B, cfg.frame_length, 0)).to(dev)
    _, frames = P.encode_block(cfg, P.enc_state_init(cfg, B, device=dev), pcm)
    calls: dict = {}
    saved = {("K", "fx_sns_dec"): K.fx_sns_dec, ("pc", "pc_classify"): pc.pc_classify}
    if not fused_design():
        saved[("pc", "compute_stab_fac")] = pc.compute_stab_fac
    mods = {"K": K, "pc": pc}

    def recorder(key, fn):
        def rec(*a):
            calls[key] = a
            return fn(*a)
        return rec
    for key, fn in saved.items():
        setattr(mods[key[0]], key[1], recorder(key, fn))
    try:
        DeviceFixedDecoder(cfg, B, device=dev).decode_block(frames)
        P.decode_block(cfg, P.dec_state_init(cfg, B, device=dev), frames)
    finally:
        for key, fn in saved.items():
            setattr(mods[key[0]], key[1], fn)
    torch.cuda.synchronize()
    if fused_design():
        fused = calls[("pc", "pc_classify")]
    else:
        scf, old, old_old, bfi, prev, prev2 = calls[("pc", "compute_stab_fac")]
        c, bfi, inv, _, pitch, q_d, q_res = calls[("pc", "pc_classify")]
        fused = (c, bfi, inv, pitch, q_d, q_res, scf, old, old_old, prev, prev2)
    pcs = {"clean": fused, "all_detector": S.pc_all_path_args(fused, 1),
           "all_energy": S.pc_all_path_args(fused, 0)}
    out = {"fx_sns_dec": {"block": calls[("K", "fx_sns_dec")]},
           "pc_classify": {k: kernel_args(v) for k, v in pcs.items()},
           "stage": pcs}
    torch.cuda.synchronize()
    return out


def kernel_args(fused):
    """The classifier kernel's arguments in the imported checkout's format:
    the fused ones as they are, or the first design's (the stability factor
    from the checkout's compute_stab_fac, the vectors cast to contiguous
    int32 as its wrapper's caller did)."""
    import torch
    from audio_codec_torch.ops import pc
    if fused_design():
        return fused
    cfg, bfi, inv, pitch, q_d, q_res, scf, old, old_old, prev, prev2 = fused
    i32 = lambda t: t.to(torch.int32).contiguous()
    stab = pc.compute_stab_fac(scf, old, old_old, bfi, prev, prev2).contiguous()
    return (cfg, i32(bfi), i32(inv), stab, i32(pitch), q_d.contiguous(), q_res.contiguous())


def stage_call(fused):
    """What the imported checkout's decoder calls for the classifier."""
    import torch
    from audio_codec_torch.ops import pc
    if fused_design():
        return lambda: pc.pc_classify(*fused)
    cfg, bfi, inv, pitch, q_d, q_res, scf, old, old_old, prev, prev2 = fused

    def first():
        stab = pc.compute_stab_fac(scf, old, old_old, bfi, prev, prev2)
        return torch.where(bfi != 1, pc.pc_classify(cfg, bfi, inv, stab, pitch, q_d, q_res), bfi)
    return first


def smoke():
    """This checkout's chip_smoke.py (its material and the classifier's
    all-path arguments), whichever checkout is timed."""
    if "snsdec_pc_smoke" not in sys.modules:
        spec = importlib.util.spec_from_file_location("snsdec_pc_smoke", ROOT / "chip_smoke.py")
        mod = importlib.util.module_from_spec(spec)
        sys.modules["snsdec_pc_smoke"] = mod
        spec.loader.exec_module(mod)
    return sys.modules["snsdec_pc_smoke"]


def differing(name: str, got, args) -> int:
    """Values of a launch that differ from the imported checkout's plain
    version on the same arguments."""
    import torch
    from audio_codec_torch.ops import fixed_dev, pc
    from tests.torch_kernel_cases import count_differing
    plain = fixed_dev.sns_decode_plain if name == "fx_sns_dec" else pc.pc_classify_plain
    ref = plain(*args)
    torch.cuda.synchronize()
    listed = lambda r: list(r) if isinstance(r, tuple) else [r]
    return count_differing(listed(got), listed(ref))


def branches(name: str, args) -> dict:
    import torch
    if name == "fx_sns_dec":
        sub = torch.bincount(args[0][:, 2].clamp(0, 3).long(), minlength=4).tolist()
        return {"frames": int(args[0].shape[0]), **{f"submode {k}": sub[k] for k in range(4)}}
    bfi, inv = args[1], args[2]
    pitch = args[4] if not fused_design() else args[3]
    low = (bfi == 2) & (inv * 10 < 4 * args[0].frame_dms)
    return {"streams": int(bfi.numel()), "bfi 2 in the low region": int(low.sum()),
            "on the detector's path": int((low & (pitch == 1)).sum())}


def measure(root: Path, B: int) -> dict:
    """torch_subst_damp_times.measure, and K15's stage (graph ms) on each
    case."""
    out = SD.measure(root, B, sys.modules[__name__])
    r = record(root, B)
    for case, fused in r["stage"].items():
        fn = stage_call(fused)
        out[f"pc_classify {case}"]["stage_graph_ms"] = min(graph_ms(fn) for _ in range(3))
    return out


def _stream() -> int:
    import torch
    return torch.cuda.current_stream().cuda_stream


def raw_call(name: str, lib, args, csrc: Path):
    """A call of the C entry point `name` of lib, built from the sources in
    csrc, on the recorded arguments as that checkout's wrapper hands them
    over: (run, (outputs, the arguments))."""
    import numpy as np
    import torch
    from audio_codec_torch import kernels as K
    fn = getattr(lib, f"acx_{name}")
    first = "kSnsScratch" in (csrc / "fx_sns_dec.cuh").read_text()
    if name == "fx_sns_dec":
        fn.argtypes = [P_] * 4 + [I_] * 2 + [P_]
        idx, nb = args
        L = idx.shape[0]
        pack = K.fx_sns_table_pack()
        tab = (torch.as_tensor(pack[:787], dtype=torch.int64) if first else
               torch.as_tensor(pack, dtype=torch.int32)).to(idx.device)
        scf = torch.empty((L, nb), dtype=torch.int64, device=idx.device)
        scf_e = torch.empty_like(scf)
        return (lambda: fn(idx.data_ptr(), tab.data_ptr(), scf.data_ptr(), scf_e.data_ptr(), L,
                           nb, _stream())), ((scf, scf_e), args)
    if len(args) == 7:    # the first design
        fn.argtypes = [P_] * 7 + [I_] * 3 + [F_] + [P_]
        cfg, bfi, inv, stab, pitch, q_d, q_res = args
        B, N = q_d.shape
        f32 = float(np.float32(1.0 / N))
        out = torch.empty_like(bfi)
        return (lambda: fn(bfi.data_ptr(), inv.data_ptr(), stab.data_ptr(), pitch.data_ptr(),
                           q_d.data_ptr(), q_res.data_ptr(), out.data_ptr(), B, N, cfg.frame_dms,
                           f32, _stream())), ((out,), args)
    fn.argtypes = [P_] * 9 + [I_] * 3 + [F_] + [P_]
    cfg, bfi, inv, pitch, q_d, q_res, scf, old, old_old, prev, prev2 = args
    B, N = q_d.shape
    f32 = float(np.float32(1.0 / N))
    vecs, meta = K._stream_vecs(B, dict(bfi=bfi, spec_inv_idx=inv, pitch_present=pitch,
                                        prev_bfi=prev, prev_prev_bfi=prev2), {})
    out = torch.empty((B,), dtype=torch.int32, device=q_d.device)
    stab = torch.empty((B,), dtype=torch.float32, device=q_d.device)
    return (lambda: fn(vecs, meta, q_d.data_ptr(), q_res.data_ptr(), scf.data_ptr(),
                       old.data_ptr(), old_old.data_ptr(), out.data_ptr(), stab.data_ptr(), B, N,
                       cfg.frame_dms, f32, _stream())), ((out, stab), args)


def block(name: str, csrc: Path) -> tuple[str, str]:
    """Threads and frames or streams a block of the kernel `name` built from
    csrc, as C expressions of its constants: the first designs a thread a
    frame or stream, K20a a warp a frame, K15 a lane a stream."""
    first = {"fx_sns_dec": "kSnsScratch" in (csrc / "fx_sns_dec.cuh").read_text(),
             "pc_classify": "kPcThreads" in (csrc / "pc_classify.cu").read_text()}[name]
    if first:
        t = "kFxSnsThreads" if name == "fx_sns_dec" else "kPcThreads"
        return t, t
    return ("32 * kFxSnsWarps", "kFxSnsWarps") if name == "fx_sns_dec" else ("32", "32")


def clock_warps(name: str, args) -> int:
    """The warps a launch runs: K20a a frame a warp in blocks of 4, K15 32
    streams a warp in blocks of one."""
    if name == "fx_sns_dec":
        return -(-args[0].shape[0] // 4) * 4
    return -(-args[1].shape[0] // 32)


if __name__ == "__main__":
    sys.exit(SD.main(sys.modules[__name__]))
