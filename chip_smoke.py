#!/usr/bin/env python3
"""Smoke run of audio_codec_torch on one CUDA card.

Drives the port's paths on the card through the CUDA kernels of
audio_codec_torch/csrc and checks them: the 48 kHz / 10 ms / 64 kbps block
path (`encode_block` then `decode_block`), the error-protected stream path
(`engine.StreamEncoder` -> channel errors -> `engine.StreamDecoder`) at
EP1-4 in the flagship's 80-byte slot, the advanced concealment
(`decode_block` at plc_mode=1), the bit-exact fixed-point decoder
(`DeviceFixedDecoder.decode_block`), the standard concealment (`decode_block`
at plc_mode=0 over lost frames) and the file tools (`python -m
audio_codec_torch.cli`, `python -m audio_codec_torch.ccconvert`).

  1. card      name and power limit (nvidia-smi), torch's device name;
  2. build     every kernel from the sources, with nvcc's -Xptxas -v report;
  3. kernels   each block-path kernel against its plain PyTorch version on
               the card, on every launch of a --frames run of the block path
               (speech, music, noise); every kernel must match exactly
               (bit_estimate in both of its modes); each of
               the post-filter's five cases, TNS filters of order 8, every SNS
               submode 0-3, LTPF on and off, one and two TNS filters in
               the side information, and TNS on and off in both filters
               must occur, and the branches of the pitch analysis, the
               residual coder and the spectrum reconstruction that the
               material reaches are printed; then the side-info parser on
               frames that fire each of its bad-frame triggers, the SNS
               quantizer on all-zero and silent-residual rows (and, at 1,
               33 and 2047 streams a launch, on codebook halves tied at
               their minimum and rows whose distances and gain errors are
               all infinite), the TNS filter
               analysis on silent, all-zero and order-8 spectra at 64 and 32
               kbps (where the LPC weighting decides), the concealment
               classifier with the stability factor on rows that take each
               branch of both and of the peak detector (both outputs), and
               with every stream of a launch on the detector's path and on
               the energy path (their graph ms), the MDCT
               (in both orders) and IMDCT (also one stream a launch) on
               full-scale, silent and alternating rows, rows of negative
               zeros, subnormal-scale rows and rows near 1e37 at N = 480 and
               160 (with the compensated order's rows on its fast and split
               steps printed; the extreme rows must take the split step),
               the pitch analysis, the LTPF coder, the noise factor and
               residual coder (48 kHz at 64 and 16 kbps, 16 kHz at 32 and
               16 kbps; also at 1, 33 and 2047 streams a launch) and the spectrum
               reconstruction on rows that take each of their branches, and
               the LTPF decoder on lanes of every case at 48 and 16 kHz
               (the smallest and largest pitch, pitch 0 with the filter
               flags set); both TNS lattices on the synthetic rows of
               tns_lattice_rows (also one stream a launch), and on those
               rows and every main-path launch against their plain versions
               run on the CPU (the CPU's contraction, on every device); both
               range coders on coder_rows at 64 and 160 kbps and in the
               high-resolution mode (2048 streams, and every 25th row
               alone), with ari_encode's two paths counted: the warp path on
               every main-path launch, the lane-0 path on rows over budget;
               the TNS filter analysis on tns_rows one stream, 33 and 2047
               streams a launch, and the gain bisection on gain_rows (M =
               25, 50, 100 and 120 blocks from every configuration's starting
               offset; 24, 33 and 2047 streams a launch, and each row alone
               at two of them); the range decoder on decode_rows (coded
               coder_rows with LSB-mode and bad frames at 64 and 160 kbps,
               in the high-resolution mode and at EP3/EP4 in both PC modes)
               every 25th row alone and at 33, 2047 and 16 384 frames a
               launch, and the resampler's biquad on biquad_rows at 1, 33
               and 2047 streams over 3 frames;
  4. block path encode_block + decode_block at --streams x --frames with the
               launch counters (and ari_encode's lane-0 counter, which must
               stay 0) reset before and read after; on a few streams
               over all frames the kernel path's payload must equal the plain
               path's and its PCM must be within +-1, with LTPF on; the same
               streams through the port on the CPU (the path the tests hold
               against the reference) must give the same payloads but for a
               CPU_FRAMES_DIFFER_MAX share, and PCM within +-CPU_PCM_TOL from
               the card's payloads; every decoder stage of that decode, card
               against CPU, with the first stage that differs (payload-side
               stages exactly, float stages with the first differing element
               and its distance in ulps); every encoder stage of that encode,
               card against CPU, with the first that differs and the payload
               bytes apart (a record: the encoder keeps the card's order); a
               segmental SNR;
  5. times     CUDA-event times of each block-path kernel (the median of
               TIME_LOOPS loops of TIME_LAUNCHES launches, with their min and
               max; and the same launches replayed from a CUDA graph, which is
               the device's time where the host launches slower than the
               kernel runs) and of its plain version, for the MDCT and IMDCT
               the library's product (torch.matmul) of the same rows by the
               same matrix (and the TDAC's compensated MDCT on the MDCT's
               rows), and of the encode and decode blocks, as real-time
               stream equivalents;
  6. stream    StreamEncoder -> channel -> StreamDecoder at EP1-4 over the
               block's first STREAM_FRAMES frames, the counters reset before
               and read after (every
               kernel must launch); each frame's streams take clean, corrected
               symbol errors, a destroyed partial-concealment codeword and
               heavy corruption in turn, frame 3 is lost and frame 4 a
               redundancy frame; every launch of fec_encode, fec_decode and of
               ari_decode with a PC block (decode and the encoder's
               simulation, both with the side information parsed in the
               launch) must equal its plain versions, the other kernels on
               the last frame at the EP core sizes; a bfi 0 frame gives back
               the encoder's payload; the bfi and detected-mode histograms are
               printed and bfi 0/1 (and 2 at EP3/EP4) must occur; synthetic
               rows (slots 40/80/150/241/300, combined channel coding, the 40-byte
               cap, every EPMR, a wrong but CRC-failing mode, the EPMR risk,
               PC decodes over four corrupt ranges); on a few streams at EP3
               the kernel path's payloads, flags and PCM (+-1) against the
               plain path's; CUDA-event times of the new kernels and of
               encode/decode per frame at each mode;
  7. concealment the plc_mode=1 path (see concealment_phase): every launch of
               its four kernels, of the TDAC's compensated MDCT and of the
               IMDCT equal to its plain version, plc_tdc also with all B
               streams at a TD-PLC first loss (all_tdc_args),
               phecu_spec_ana also on the peak analysis's edge rows (a tie,
               edge peaks, a scan that ends in mode 1, the drop rule),
               phecu_subst and plc_damp_scramble also with every stream at
               work (all_active_args, their graph ms) and on their edge rows
               (every edge required), its stage-by-stage trace card against
               CPU, whose first difference must not be the TDAC's MDCT;
  8. fixed     DeviceFixedDecoder (the bit-exact fixed-point decoder) over
               phase 4's payloads with a group of silent streams (zero
               frames), B x T: the launch counts (the frontend's one
               ari_decode, one fx_sns_dec, fx_spec_decode and fx_dct4, T
               fx_ola_ltpf); every
               launch of the four fixed-point kernels equal to its plain
               version with no tolerance, with the SNS submodes, TNS on/off,
               zero frames and the post-filter's branches printed, and
               fx_spec_decode's one-filter, two-filter and filter-1-only
               frames required (on the block or the synthetic rows); the
               synthetic rows of tests/torch_kernel_cases.py (every submode,
               out-of-range MPVQ indices, a seeded sample of each shape's
               indices and every index's clamps at every band count of the
               configurations, silent, full-scale and order-8
               spectra, all-zero, full-scale and alternating DCT rows, the
               post-filter plan through passthrough, pat2, pat3, pat4, pat1
               at 48 and 8 kHz with its edge streams: passes with d =
               pitch_int - shift >= 32, < 32 and <= 0 each required);
               the stored reference (audio_codec_torch/data/fixed_pcm_ref.npz,
               the reference FixedDecoder's PCM) decoded on the card bit for
               bit; 12 streams of the block against the port on the CPU bit
               for bit; the kernels' times (fx_ola_ltpf over the block's
               recorded frames from its first state) and the block's, as
               real-time stream equivalents;
  9. standard concealment and the file tools (standard_concealment_phase,
               file_tools_phase): phase 7's payloads decoded at plc_mode=0
               over its loss plan with T plc_main launches, each equal to its
               plain version (and each imdct launch), every branch of it, the stage-by-stage trace
               card against CPU, times; then the CLI and ccConvert as
               subprocesses on the card and with -device cpu on a 2-channel
               WAV;
 10. a JSON line with one entry per kernel.

The last line is {"ok": true, "device": {...}}. Any failed check exits
non-zero. Run from the repository root: python3 chip_smoke.py
"""
from __future__ import annotations

import argparse
import contextlib
import json
import subprocess
import sys
import time
import wave
from pathlib import Path

ROOT = Path(__file__).resolve().parent
# The card's float numerics are plain torch, the CPU port's follow the
# reference's XLA:CPU rounding: at most this share of payload frames may
# differ, and int16 PCM decoded from the same payloads by at most this much.
CPU_FRAMES_DIFFER_MAX = 0.05
CPU_PCM_TOL = 4
TIME_LOOPS, TIME_LAUNCHES = 5, 20
HBM_BYTES_PER_S = 3.35e12  # H100 SXM memory rate
SCALAR_OPS_PER_S = 67e12   # H100 SXM float32 rate outside the tensor cores

KERNEL_INFO = {
    "ari_encode": ("audio_codec_torch/csrc/ari_encode.cu",
                   "audio_codec_tpu/ops/ari.py:218"),
    "ari_decode": ("audio_codec_torch/csrc/ari_decode.cu",
                   "audio_codec_tpu/ops/ari.py:491"),
    "bit_estimate": ("audio_codec_torch/csrc/bit_estimate.cu",
                     "audio_codec_tpu/ops/quant.py:135"),
    "ltpf_decode": ("audio_codec_torch/csrc/ltpf_decode.cu",
                    "audio_codec_tpu/ops/ltpf_dec.py:59"),
    "gain_bisection": ("audio_codec_torch/csrc/gain_bisection.cu",
                       "audio_codec_tpu/ops/quant.py:108"),
    "tns_analysis_lattice": ("audio_codec_torch/csrc/tns_analysis_lattice.cu",
                             "audio_codec_tpu/ops/tns.py:219"),
    "tns_synthesis_lattice": ("audio_codec_torch/csrc/tns_synthesis_lattice.cu",
                              "audio_codec_tpu/ops/tns.py:276"),
    "hp50_biquad": ("audio_codec_torch/csrc/hp50_biquad.cu",
                    "audio_codec_tpu/ops/analysis.py:57"),
    "side_info_pack": ("audio_codec_torch/csrc/side_info_pack.cu",
                       "audio_codec_tpu/ops/bits.py:66"),
    "sns_vq_dec": ("audio_codec_torch/csrc/sns_vq_dec.cu",
                   "audio_codec_tpu/ops/sns.py:311"),
    "sns_vq_enc": ("audio_codec_torch/csrc/sns_vq_enc.cu",
                   "audio_codec_tpu/ops/sns.py:214"),
    "tns_filter_analysis": ("audio_codec_torch/csrc/tns_filter_analysis.cu",
                            "audio_codec_tpu/ops/tns.py:113"),
    "pc_classify": ("audio_codec_torch/csrc/pc_classify.cu",
                    "audio_codec_tpu/ops/pc.py:114"),
    "mdct": ("audio_codec_torch/csrc/mdct.cu", "audio_codec_tpu/ops/transforms.py:69"),
    "imdct": ("audio_codec_torch/csrc/imdct.cu", "audio_codec_tpu/ops/transforms.py:96"),
    # the TDAC's MDCT (plc_adv.py:444) in the CPU branch's compensated order
    "mdct_compensated": ("audio_codec_torch/csrc/mdct.cu", "audio_codec_tpu/ops/transforms.py:24"),
    "olpa": ("audio_codec_torch/csrc/olpa.cu", "audio_codec_tpu/ops/analysis.py:77"),
    "ltpf_encode": ("audio_codec_torch/csrc/ltpf_encode.cu",
                    "audio_codec_tpu/ops/analysis.py:163"),
    "noise_residual_enc": ("audio_codec_torch/csrc/noise_residual_enc.cu",
                           "audio_codec_tpu/ops/quant.py:279"),
    "spec_decode": ("audio_codec_torch/csrc/spec_decode.cu",
                    "audio_codec_tpu/models/decoder.py:103"),
    "fec_encode": ("audio_codec_torch/csrc/fec_encode.cu", "audio_codec_tpu/ops/fec.py:628"),
    "fec_decode": ("audio_codec_torch/csrc/fec_decode.cu", "audio_codec_tpu/ops/fec.py:696"),
    # the range decoder with a partial-concealment block, and the encoder's
    # simulation: rows of their own for the kernel table (K11-PC)
    "ari_decode_pc": ("audio_codec_torch/csrc/ari_decode.cu", "audio_codec_tpu/ops/ari.py:379"),
    "ari_decode_pc_enc_sim": ("audio_codec_torch/csrc/ari_decode.cu",
                              "audio_codec_tpu/ops/ari.py:759"),
    "plc_tdc": ("audio_codec_torch/csrc/plc_tdc.cu", "audio_codec_tpu/ops/plc_adv.py:236"),
    "plc_damp_scramble": ("audio_codec_torch/csrc/plc_damp_scramble.cu",
                          "audio_codec_tpu/ops/plc_adv.py:461"),
    "phecu_spec_ana": ("audio_codec_torch/csrc/phecu_spec_ana.cu",
                       "audio_codec_tpu/ops/plc_phecu.py:135"),
    "phecu_subst": ("audio_codec_torch/csrc/phecu_subst.cu",
                    "audio_codec_tpu/ops/plc_phecu.py:273"),
    "fx_sns_dec": ("audio_codec_torch/csrc/fx_sns_dec.cu", "audio_codec_tpu/ops/fixed_dev.py:525"),
    "fx_spec_decode": ("audio_codec_torch/csrc/fx_spec_decode.cu",
                       "audio_codec_tpu/ops/fixed_dev.py:185"),
    "fx_dct4": ("audio_codec_torch/csrc/fx_dct4.cu", "audio_codec_tpu/ops/fixed_dev.py:574"),
    "fx_ola_ltpf": ("audio_codec_torch/csrc/fx_ola_ltpf.cu",
                    "audio_codec_tpu/ops/fixed_ltpf_dev.py:169"),
    "plc_main": ("audio_codec_torch/csrc/plc_main.cu", "audio_codec_tpu/ops/plc.py:64"),
}
# the kernels of the flagship block path (phases 3-5); the stream path
# (phase 6) runs them and the channel coder's two
STREAM_KERNELS = ("fec_encode", "fec_decode")
# the wrapper each path calls for a kernel where it is not the kernel's
# name: the decoder's entropy phase launches ari_decode in its parsed mode
# (the side information parsed in the launch; also K11 side's row of the
# reference, audio_codec_tpu/ops/bits.py:123)
MAIN_CALL = {"ari_decode": "ari_decode_frames"}
# the advanced concealment's kernels (phase 7, plc_mode 1), the TDAC's MDCT
# among them
PLC_KERNELS = ("plc_tdc", "plc_damp_scramble", "phecu_spec_ana", "phecu_subst",
               "mdct_compensated")
# operations of a term of the compensated product (the Dekker error, two
# Neumaier steps, a multiply-add counted as two)
COMPENSATED_TERM_OPS = 25
PLC_FRAMES = 16
# the bit-exact fixed-point decoder's kernels (phase 8, DeviceFixedDecoder)
FIXED_KERNELS = ("fx_sns_dec", "fx_spec_decode", "fx_dct4", "fx_ola_ltpf")
FIXED_SILENT = 64          # streams of silence in phase 8's block: zero frames
# the standard concealment's kernel: on the main path at every frame, timed
# on the lossy run of phase 9
PLC0_KERNELS = ("plc_main",)
PC_ROWS = ("ari_decode_pc", "ari_decode_pc_enc_sim")
STREAM_MODES = (1, 2, 3, 4)
# frames of the stream path: the block's first 6 (frame 3 lost, frame 4 a
# redundancy frame, every channel kind on every stream by frame 3); 8 until
# the run approached its time limit
STREAM_FRAMES = 6
TNS_BINS = 400     # the highest bandwidth cutoff: the TNS analysis reads no bin above it


class Failed(Exception):
    pass


def check(cond: bool, what: str):
    if not cond:
        raise Failed(what)


def read_wav(path: Path):
    import numpy as np
    with wave.open(str(path)) as w:
        return np.frombuffer(w.readframes(w.getnframes()), np.int16).astype(np.float32)


def make_pcm(T: int, B: int, n: int, seed: int):
    """[T, B, n] float PCM: a third speech, a third music (each stream at
    its own offset), a third seeded noise at several levels."""
    import numpy as np
    speech = read_wav(ROOT / "material" / "speech48.wav")
    music = read_wav(ROOT / "material" / "music48.wav")
    rng = np.random.default_rng(seed)
    pcm = np.zeros((T, B, n), np.float32)
    for b in range(B):
        kind = b % 3
        if kind == 2:
            pcm[:, b] = rng.standard_normal((T, n)) * (3000.0 / (1 + b % 7))
        else:
            src = speech if kind == 0 else music
            off = (b * 4801) % (len(src) - T * n)
            pcm[:, b] = src[off: off + T * n].reshape(T, n)
    return pcm


def cuda_ms(fn, reps: int) -> float:
    import torch
    fn()
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    for _ in range(reps):
        fn()
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / reps


def cuda_ms_spread(fn) -> tuple[float, float, float]:
    """(median, min, max) ms per call over TIME_LOOPS timing loops of
    TIME_LAUNCHES calls each."""
    import statistics
    loops = [cuda_ms(fn, TIME_LAUNCHES) for _ in range(TIME_LOOPS)]
    return statistics.median(loops), min(loops), max(loops)


def graph_ms(fn) -> float:
    """ms per call of TIME_LAUNCHES calls captured in one CUDA graph and
    replayed: the device's time for the calls back to back, which the loops
    of cuda_ms cannot show for a kernel shorter than the host's time to
    launch it."""
    import torch
    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(TIME_LAUNCHES):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    graph.replay()
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / TIME_LAUNCHES


def matmul_ms(rows) -> float:
    """Median ms of torch.matmul of these [B, N] rows by the DCT-IV matrix in
    full float32 (TF32 off): the library call beside the transform kernels."""
    import torch
    from audio_codec_torch.ops import transforms
    Mt = transforms.dct4_mt(rows.shape[1], str(rows.device))
    check(not torch.backends.cuda.matmul.allow_tf32, "TF32 is on for torch.matmul")
    return cuda_ms_spread(lambda: torch.matmul(rows, Mt))[0]


def paired(got, ref) -> list:
    """(kernel, plain) tensor pairs of two results, dicts key for key."""
    if isinstance(ref, dict):
        return [p for k in ref for p in paired(got[k], ref[k])]
    if isinstance(ref, tuple):
        return [p for g, r in zip(got, ref) for p in paired(g, r)]
    return [(got, ref)]


def outputs(res) -> list:
    """A kernel's result as a list of tensors (the values of a dict in it
    too)."""
    if isinstance(res, dict):
        return list(res.values())
    if isinstance(res, tuple):
        return [t for r in res for t in outputs(r)]
    return [res]


def nbytes(*ts) -> int:
    import torch
    return sum(t.numel() * t.element_size() for t in ts if isinstance(t, torch.Tensor))


@contextlib.contextmanager
def plain_path():
    """Route the kernels' call sites to their plain versions, so the main
    path runs on the card without the kernels (the reference for phase 4)."""
    from audio_codec_torch.ops import analysis, ari, bits, fec, ltpf_dec, pc, quant, sns, tns
    from audio_codec_torch.ops import plc, plc_adv, plc_phecu, transforms
    sites = [(transforms, "mdct", transforms.mdct_plain),
             (transforms, "imdct", transforms.imdct_plain),
             (tns, "tns_filter_analysis", tns.tns_filter_analysis_plain),
             (pc, "pc_classify", pc.pc_classify_plain),
             (quant, "bit_estimate", quant.bit_estimate_plain),
             (ari, "encode", lambda cfg, *a: ari.encode_plain(cfg, *a)),
             (ari, "decode", ari.decode_plain),
             (fec, "fec_encode", lambda data, epmr, *, slot_bytes, mode, ccc_flag=0:
              fec.fec_encode_plain(data, epmr, slot_bytes, mode, ccc_flag)),
             (fec, "fec_decode", lambda frames, *, slot_bytes, ccc_flag=0, bfi_in=None:
              fec.fec_decode_plain(frames, slot_bytes, ccc_flag, bfi_in)),
             (ltpf_dec, "ltpf_decode", ltpf_dec.ltpf_decode_plain),
             (quant, "gain_bisection", quant.gain_bisection_plain),
             (tns, "tns_analysis_lattice", tns.tns_analysis_lattice_plain),
             (tns, "tns_synthesis_lattice", tns.tns_synthesis_lattice_plain),
             (analysis, "hp50_biquad", analysis.hp50_biquad_plain),
             (bits, "pack_side_info", bits.pack_side_info_plain),
             (bits, "parse_side_info", bits.parse_side_info_plain),
             (sns, "quantize_scf_dec", sns.sns_vq_dec_plain),
             (sns, "quantize_scf_enc", lambda cfg, scf: sns.sns_vq_enc_plain(scf)),
             (analysis, "olpa", analysis.olpa_plain),
             (analysis, "ltpf_encode", analysis.ltpf_encode_plain),
             (quant, "noise_residual_enc", quant.noise_residual_enc_plain),
             (quant, "spectrum_decode", quant.spectrum_decode_plain),
             (plc, "plc_main_update", plc.plc_main_plain),
             (plc_adv, "plc_tdc", plc_adv.plc_tdc_plain),
             (plc_adv, "damp_scramble", plc_adv.damp_scramble_plain),
             (plc_phecu, "phecu_spec_ana", plc_phecu.phecu_spec_ana_plain),
             (plc_phecu, "phecu_subst", plc_phecu.phecu_subst_plain)]
    saved = [(mod, name, getattr(mod, name)) for mod, name, _ in sites]
    for mod, name, plain in sites:
        setattr(mod, name, plain)
    try:
        yield
    finally:
        for mod, name, fn in saved:
            setattr(mod, name, fn)


def recording(store: dict, names=None, copy: bool = False):
    """tests/torch_kernel_cases.py:recording, imported once the repo is on
    the path."""
    from tests.torch_kernel_cases import recording as rec
    return rec(store, names, copy)


def ltpf_case_counts(launches) -> dict[str, int]:
    """Stream-frames of the recorded ltpf_decode launches in each of the
    post-filter's cases (the CASE_* bits of the stream's parameters)."""
    from audio_codec_torch.ops import ltpf_dec as L
    bits = {"on->off": L.CASE_B, "off->on": L.CASE_C, "on->on same pitch": L.CASE_D,
            "on->on new pitch": L.CASE_E, "on": L.NEW_ON}
    words = [L.case_word(*args) for args, _ in launches]
    return {k: sum(int(((w & bit) != 0).sum()) for w in words) for k, bit in bits.items()}


def segmental_snr(ref, out, n: int) -> tuple[float, int]:
    """Mean per-frame SNR (dB) of out against ref after the best lag, and
    that lag in samples."""
    import numpy as np
    best = max(range(0, 2 * n), key=lambda d: float(np.dot(ref[: -2 * n], out[d: d + len(ref) - 2 * n])))
    r = ref[: len(ref) - best]
    o = out[best:]
    snrs = []
    for k in range(0, len(r) - n, n):
        e = np.sum((r[k: k + n] - o[k: k + n]) ** 2) + 1e-9
        s = np.sum(r[k: k + n] ** 2)
        if s > 1e3 * n:
            snrs.append(10 * np.log10(s / e))
    return float(np.mean(snrs)), best


def side_bits(cfg, num_tns, submode, ltpf_on):
    """Side-information bits of each of these frames (fields of fixed width,
    the TNS flags, the submode's gain and joint index, the LTPF pitch)."""
    import torch
    fixed = cfg.BW_cutoff_bits + cfg.lastnz_bits + 1 + 8 + 1 + 5 + 5 + 1 + 1 + 3
    return fixed + num_tns + torch.where(submode < 2, 1 + 25, 2 + 24) + 10 * ltpf_on


def sns_enc_ops(scf, scf_idx) -> float:
    """Operations of sns_vq_enc on these rows: the codebook searches, four
    transforms and 18 gain candidates are fixed; each pulse search scans its
    lanes once for every pulse its projection left to place."""
    import torch
    from audio_codec_torch import tables as T
    dev = scf.device
    f = lambda a: torch.as_tensor(a, dtype=torch.float32, device=dev)
    C1, C2, D2 = f(T.t("sns_C1")), f(T.t("sns_C2")), f(T.dct2_matrix(16))
    st1 = torch.cat([C1[:, scf_idx[:, 0].long()].T, C2[:, scf_idx[:, 1].long()].T], dim=-1)
    target = (scf - st1) @ D2.T
    ops = scf.shape[0] * (2 * 32 * 8 * 3 + 4 * 512 + 18 * 16 * 4 + 4 * 150 + 100)
    for lo, dim, pulses in ((0, 10, 10), (10, 6, 1), (0, 16, 8), (0, 16, 6)):
        xa = target[:, lo: lo + dim].abs()
        placed = torch.floor(xa * ((pulses - 1) / xa.sum(-1, keepdim=True))).sum(-1)
        left = (pulses - torch.nan_to_num(placed, nan=float(pulses))).clamp(0, pulses)
        ops += float(left.sum()) * dim * 7
    return float(ops)


def work_ops(name: str, args) -> float:
    """Scalar operations the kernel does on these inputs (approximate, from
    the data: symbols coded, tuples visited, samples filtered, bits written,
    pulses placed)."""
    import torch
    from audio_codec_torch import kernels as K
    if name in ("mdct", "imdct"):
        B, N = args[1].shape
        return float(2 * B * N * N)
    if name == "olpa":
        # the low-pass, R and E at 98 lags over 64 samples, e0, the searches
        return float(args[1].shape[0] * (64 * 10 + 98 * 64 * 4 + 64 * 2 + 98 * 4 + 30))
    if name == "ltpf_encode":
        # 17 lags x 2 chains over 128 samples, the energy, <= 7 x 17 taps,
        # the filtered samples and their three chains, the decision
        return float(args[1].shape[0] * (17 * 128 * 4 + 128 * 2 + 7 * 17 * 2 + 128 * 24 + 60))
    if name == "noise_residual_enc":
        # the zero-line window tests; |x / gain| and a sum on a zero line, a
        # product and a comparison on a nonzero one
        xq = args[2]
        nz = float((xq != 0).sum())
        return 7.0 * xq.numel() + 2.0 * nz + 3.0 * (xq.numel() - nz)
    if name == "spec_decode":
        # per good stream the concealed, nudged, filled and scaled line; the
        # concealment's four energies and synthesis where bfi is 2
        N, bfi = args[1].shape[1], args[3]
        return float(N * (6 * int((bfi != 1).sum()) + 8 * int((bfi == 2).sum())))
    if name == "tns_filter_analysis":
        # per filter: a multiply and an add per bin and lag, about 400
        # operations of recursions; a stream with two filters covers the
        # same bins once
        cfg, x, bw_idx = args
        from audio_codec_torch import tables as T
        cut = torch.as_tensor(T.bw_cutoff_bins(cfg.frame_dms), device=x.device)
        bins = cut[bw_idx.long()].to(torch.float64)
        return float((2 * 9 * bins + 400 * torch.where(bw_idx >= 3, 2, 1)).sum())
    if name == "pc_classify":
        # the stability factor's 16 differences, squares and adds where it
        # reads its rows; the detector's chain and candidate tests, or the
        # two energy chains, where the frame is past the early return
        bfi, inv, pitch, q_d = args[1], args[2], args[3], args[4]
        N = q_d.shape[1]
        rows, active = pc_row_streams(args)
        per = torch.where(pitch == 1, 2 * N + 12 * (N - 5), 4 * N)
        return float(torch.where(active, per, 0).sum()) + 48.0 * float(rows.sum())
    if name == "side_info_pack":
        cfg, num_tns, ltpf, scf_idx = args[0], args[5], args[7], args[8]
        return 8 * float(side_bits(cfg, num_tns, scf_idx[:, 2], ltpf[:, 0]).sum())
    if name == "sns_vq_dec":
        sub = args[0][:, 2].clamp(0, 3).long()
        deindex = torch.tensor([10 * 21 + 6 * 12, 10 * 21, 16 * 19, 16 * 17], device=sub.device)
        return float((deindex[sub] + 576).sum())
    if name == "sns_vq_enc":
        return sns_enc_ops(args[0], K.sns_vq_enc(*args)[0])
    if name == "gain_bisection":
        return float(8 * args[0].numel() * 4)       # 8 halvings x (sub, compare, 2 ops)
    if name in ("tns_analysis_lattice", "tns_synthesis_lattice"):
        from audio_codec_torch.ops import tns
        x, _, order, lo, hi = args
        _, active, ordsel = tns._filter_bins(order, lo, hi, x.shape[1])
        taps = torch.where(active, 4 * (ordsel - 1).clamp(min=0) + 2, 0)
        return float(taps.sum())
    if name == "hp50_biquad":
        return float(args[0].numel() * 9)
    if name == "ltpf_decode":
        # the tap chains a stream's case runs, 2 operations a tap, and the
        # crossfade's 2 multiply-adds and weight: z (the old filter) in the
        # crossfade of a fade-out and every sample of a pitch change, y (the
        # new filter) at every sample where it is on
        from audio_codec_torch.ops import ltpf_dec as L
        from audio_codec_torch.models.state import ltpf_dec_lens
        cfg, N = args[0], args[1].shape[1]
        _, _, tilt_len, inter_taps = ltpf_dec_lens(cfg)
        per = 2 * (inter_taps + tilt_len + 1) + 6
        w = L.case_word(*args)
        n4 = int(cfg.fs * 0.0025)
        z = n4 * int(((w & L.CASE_B) != 0).sum()) + N * int(((w & L.CASE_E) != 0).sum())
        y = N * int(((w & L.NEW_ON) != 0).sum())
        return float(per * (z + y))
    if name == "ari_decode_frames":
        # the side bits' extracts (as the packer's, 8 a bit), then the decode
        from audio_codec_torch.ops import bits
        cfg, buf = args[0], args[1]
        side = bits.parse_side_info_plain(cfg, buf.to(torch.int32))
        nbits = side_bits(cfg, side["num_tns"], side["scf_idx"][:, 2], side["ltpf_param"][:, 0])
        return 8 * float(nbits.sum()) + work_ops("ari_decode", (cfg, buf, side))
    if name == "ari_decode":
        side = args[2]
        tuples = torch.div(side["lastnz"] + 1, 2, rounding_mode="floor").clamp(max=args[0].yLen // 2)
        return float(tuples.sum()) * 2 * 17 * 4
    xq = args[1] if name == "bit_estimate" else args[4]
    m = torch.maximum(xq[:, 0::2].abs(), xq[:, 1::2].abs()).to(torch.float64)
    lev = torch.where(m >= 4, torch.floor(torch.log2(m.clamp(min=1))) - 1, torch.zeros_like(m))
    per = 25 if name == "bit_estimate" else 40
    return float(((lev + 1) * per).sum())


def kernel_bytes(name: str, args, outs) -> int:
    """Bytes the kernel must move on these inputs: each input read once,
    each output written once, counting only what the kernel reads."""
    import torch
    from audio_codec_torch.ops import transforms
    ins = [a for a in args if isinstance(a, torch.Tensor)]
    if name == "ari_decode":
        ins += [v for v in args[2].values() if isinstance(v, torch.Tensor)]
    if name in ("mdct", "imdct"):
        cfg, a = args[0], args[1]
        return nbytes(*ins, *outs, transforms.dct4_mt(a.shape[1], str(a.device)),
                      transforms.window(cfg, str(a.device)))
    if name == "tns_filter_analysis":
        x, bw_idx = args[1], args[2]
        return 4 * x.shape[0] * min(x.shape[1], TNS_BINS) + nbytes(bw_idx, *outs)
    if name == "spec_decode":
        # the spectrum and the [B] vectors; the residual bits a good frame
        # uses (one a nonzero line up to n_res); the history rows of a lost
        # (copied) or partially corrupt frame; the two rows and four vectors out
        cfg, x, bfi, res_present, n_res = args[0], args[1], args[3], args[8], args[10]
        N = x.shape[1]
        vecs = [a for a in args[2:] if isinstance(a, torch.Tensor) and a.dim() == 1]
        good = bfi != 1
        used = torch.minimum((x != 0).sum(-1), n_res.clamp(min=0))
        res_words = int(torch.where(good & (res_present == 1), used, 0).sum())
        hist_rows = int((bfi == 1).sum()) + 2 * int((bfi == 2).sum())
        return nbytes(x, *vecs, *outs) + 4 * res_words + 4 * N * hist_rows
    if name == "pc_classify":
        # the five [B] vectors (4 bytes a stream each, the pitch flag a
        # strided column) and the two outputs; two [16] scale-factor rows of
        # each stream whose stability factor reads them; one [N] row of each
        # stream past the early return (the peak detector reads q_old_d, the
        # energy path q_old_res)
        B, N = args[4].shape
        rows, active = pc_row_streams(args)
        return 4 * 5 * B + nbytes(*outs) + 2 * 64 * int(rows.sum()) + 4 * N * int(active.sum())
    if name == "ltpf_decode":
        from audio_codec_torch.ops import ltpf_dec as L, numerics
        cfg, dev = args[0], args[1].device
        tables = [numerics.table(L._filter, cfg.fs, k, device=dev) for k in (0, 1)]
        return nbytes(*ins, *outs, *tables)
    return nbytes(*ins, *outs)


def same_bits(got, ref, what: str):
    """got equals ref bit for bit (dicts key for key); two NaNs are equal."""
    from tests.torch_kernel_cases import count_differing
    bad = count_differing(got, ref)
    check(bad == 0, f"{what}: {bad} values differ from the plain version")


def synthetic_cases(cfg, dev, K, side, sns):
    """Cases clean material never reaches (tests/torch_kernel_cases.py):
    frames that fire each of the parser's bad-frame triggers (the range
    decoder's parsed mode, both of its dicts), the quantizer's
    decoder on every submode's first and last index, its encoder on an
    all-zero row and on rows whose residual is silent (every pulse search
    takes its silent-target branch)."""
    import numpy as np
    import torch
    from audio_codec_torch.ops import ari
    from tests import torch_kernel_cases as C
    g = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)
    cases = {"clean": C.side_fields(cfg, 256, seed=3),
             **{trig: C.corrupt_fields(cfg, trig, 32) for trig in C.BFI_TRIGGERS}}
    for what, f in cases.items():
        args = (cfg, *(g(np.asarray(f[k], np.int32)) for k in C.FIELD_ORDER))
        packed, ref = K.side_info_pack(*args), side.pack_side_info_plain(*args)
        same_bits(packed, ref, f"side_info_pack ({what})")
        got = K.ari_decode_frames(cfg, packed[0])
        ref = ari.parse_and_decode_plain(cfg, packed[0])
        torch.cuda.synchronize()
        same_bits(got, ref, f"ari_decode parsed ({what})")
        fired = got[0]["bfi"].tolist()
        check(fired == [0 if what == "clean" else 1] * len(fired),
              f"ari_decode parsed ({what}): side bfi {fired}")
    # rows shorter than the side bits: the string clipped at the row's first byte
    from types import SimpleNamespace
    f = C.side_fields(cfg, 256, seed=5)
    for nbytes in (1, 5, 9):
        short = SimpleNamespace(targetBytes=nbytes, BW_cutoff_bits=cfg.BW_cutoff_bits,
                                lastnz_bits=cfg.lastnz_bits)
        args = (short, *(g(np.asarray(f[k], np.int32)) for k in C.FIELD_ORDER))
        packed, ref = K.side_info_pack(*args), side.pack_side_info_plain(*args)
        torch.cuda.synchronize()
        same_bits(packed, ref, f"side_info_pack ({nbytes}-byte rows)")
    rows = torch.randint(0, 256, (4096, cfg.targetBytes), device=dev, dtype=torch.int32,
                         generator=torch.Generator(device=dev).manual_seed(1))
    got = K.ari_decode_frames(cfg, rows)
    same_bits(got, ari.parse_and_decode_plain(cfg, rows), "ari_decode parsed (random bytes)")
    print(f"[kernels] ari_decode parsed: each of {len(C.BFI_TRIGGERS)} bad-frame triggers fires "
          f"and both dicts equal the plain parse and decode; random bytes: side bfi in "
          f"{int(got[0]['bfi'].sum())}, decoder bfi in {int((got[1]['bfi'] > 0).sum())} of 4096 "
          f"rows", flush=True)

    grid = g(np.concatenate([C.scf_idx_grid(sub, 64, seed=7) for sub in range(4)]))
    q = K.sns_vq_dec(grid)
    same_bits(q, sns.sns_vq_dec_plain(grid), "sns_vq_dec (index grid)")
    check(bool(torch.isfinite(q).all()), "sns_vq_dec (index grid): not finite")
    n_seeded = 400
    scf = g(C.scf_rows(0, n_seeded))
    got, ref = K.sns_vq_enc(scf), sns.sns_vq_enc_plain(scf)
    torch.cuda.synchronize()
    same_bits(got, ref, "sns_vq_enc (all-zero, silent-residual and decoded rows)")
    check(not bool(scf[n_seeded].any()), "the all-zero row is not where it is expected")
    check(got[0][n_seeded + 1: n_seeded + 3, :2].tolist() == [[3, 17], [31, 0]],
          "sns_vq_enc: a codebook row did not find its own stage-1 indices")
    back = torch.bincount(got[0][-16:, 2].long(), minlength=4).tolist()
    check(all(v > 0 for v in back), f"sns_vq_enc: a decoded submode was not found again: {back}")
    print(f"[kernels] sns_vq_dec on {grid.shape[0]} grid indices and sns_vq_enc on an all-zero "
          f"row, silent-residual rows and the decoded rows equal their plain versions; "
          f"submodes found again {back}", flush=True)
    # the warp design at 1, 33 and 2047 streams a launch: codebook halves tied
    # at their minimum, rows whose every distance and gain error is infinite
    ties = C.sns_tie_rows()
    for n in (1, 33, 2047):
        scf = g(ties[np.resize(np.arange(ties.shape[0]), n)])
        got, ref = K.sns_vq_enc(scf), sns.sns_vq_enc_plain(scf)
        torch.cuda.synchronize()
        same_bits(got, ref, f"sns_vq_enc (tie rows, {n} streams)")
    print(f"[kernels] sns_vq_enc on {ties.shape[0]} tie and silent rows at 1, 33 and 2047 "
          f"streams a launch equals its plain version", flush=True)


def tns_on_off(out):
    """[[off, on] of filter 0, [off, on] of filter 1] over the streams of a
    tns_filter_analysis output (filter 1 only where a stream has two)."""
    import torch
    order, nf = out[0], out[3]
    counts = torch.zeros((2, 2), dtype=torch.long)
    for f, rows in ((0, torch.ones_like(nf, dtype=torch.bool)), (1, nf == 2)):
        o = order[rows, f]
        counts[f] = torch.stack([(o == 0).sum(), (o > 0).sum()]).cpu()
    return counts


def pc_branch_counts(args, out) -> dict[str, int]:
    """Streams of a pc_classify launch in each branch of the stability
    factor, the classifier and the peak detector (out: bfi', stab_fac)."""
    from tests import torch_kernel_cases as C
    a = {k: v.cpu().numpy() for k, v in zip(C.PC_FUSED_ORDER, args[1:])}
    return C.pc_fused_branches(a, *(t.cpu().numpy() for t in out), args[0].frame_dms)


def pc_row_streams(args):
    """Of a pc_classify launch's streams: those whose stability factor reads
    its two scale-factor rows (bfi 1 after a good frame, bfi 2; not where the
    previous frame's flag makes it 0.8), and those past the early return
    (bfi 2 in the low region, stable), which read one [N] row."""
    from audio_codec_torch.ops import pc
    cfg, bfi, inv, _, _, _, scf, old, old_old, prev, prev2 = args
    rows = ((bfi == 1) & (prev != 1) & (prev2 != 1)) | ((bfi == 2) & (prev != 1))
    stab = pc.compute_stab_fac(scf, old, old_old, bfi, prev, prev2)
    active = (bfi == 2) & (inv * 10 < 4 * cfg.frame_dms) & ~(stab < 0.5)
    return rows, active


def pc_all_path_args(args, pitch: int):
    """A pc_classify launch's arguments with every stream past the early
    return on one path: bfi 2 after a good frame, the frame's scale factors
    the last good ones (stability 1), spec_inv_idx 20 (the low region), the
    pitch flag `pitch` (1: the peak detector on q_old_d, 0: the two energy
    chains on q_old_res)."""
    import torch
    cfg, bfi, inv, _, q_d, q_res, scf, old, old_old, prev, prev2 = args
    full = lambda v: torch.full_like(bfi, v)
    return (cfg, full(2), full(20), full(pitch), q_d, q_res, old.clone(), old, old_old, full(0),
            full(0))


def tns_lattice_cases(dev, K, rec):
    """Both TNS lattices: on the synthetic rows of
    tests/torch_kernel_cases.py:tns_lattice_rows (the filter switch at every
    offset of a 15-bin chunk, rising and falling orders, orders above 8, one
    filter or none, the analysis lattice's general path, zeros, subnormal
    and near-overflow rows), all at once and every fifth alone (B = 1),
    against their plain versions on the card; and on every recorded launch
    and the rows against the plain versions run on the CPU, which compute the
    CPU's contraction as the card's do."""
    import torch
    from tests import torch_kernel_cases as C
    from audio_codec_torch.ops import tns
    rows = C.tns_lattice_rows(seed=3)
    cpu_args = tuple(torch.from_numpy(rows[k]) for k in C.TNS_LATTICE_ORDER)
    args = tuple(a.to(dev) for a in cpu_args)
    n = args[0].shape[0]
    for name in ("tns_analysis_lattice", "tns_synthesis_lattice"):
        plain = getattr(tns, name + "_plain")
        kernel = getattr(K, name)
        same_bits(kernel(*args), plain(*args), f"{name} (synthetic rows)")
        for i in range(0, n, 5):
            one = tuple(a[i: i + 1] for a in args)
            same_bits(kernel(*one), plain(*one), f"{name} (synthetic row {i}, B = 1)")
        same_bits(kernel(*args), plain(*cpu_args), f"{name} (synthetic rows, plain on the CPU)")
        for j, (largs, _) in enumerate(rec[name]):
            same_bits(kernel(*largs), plain(*(a.cpu() for a in largs)),
                      f"{name} (launch {j}, plain on the CPU)")
        torch.cuda.synchronize()
        print(f"[kernels] {name}: {n} synthetic rows (and every fifth alone, B = 1) equal the plain "
              f"version on the card and on the CPU; {len(rec[name])} main-path launches equal "
              f"the plain version on the CPU", flush=True)


def coder_cases(dev, K, rec):
    """Both range-coder kernels on the synthetic rows of
    tests/torch_kernel_cases.py:coder_rows at 48 kHz 64 kbps, 160 kbps (LSB
    mode) and in the high-resolution mode (all-zero rows, a single nonzero
    tuple first or last, |x| up to 2^23, lastnz2 on both sides of every
    lane boundary, LSB lists past N, TNS orders 0-12, rows over their bit
    budget), tiled to 2048 streams and every 25th row alone (B = 1):
    bit_estimate in modes -1, 0 and 1, ari_encode with the histogram of its
    two paths; the main-path launches of ari_encode must all take the warp
    path, and the rows over their budget must reach the lane-0 path."""
    import numpy as np
    import torch
    import audio_codec_torch as P
    from tests import torch_kernel_cases as C
    from audio_codec_torch.ops import ari, quant
    K.reset_ari_encode_lane0_streams(dev)
    for args, _ in rec["ari_encode"]:
        K.ari_encode(*args)
    main_lane0 = K.ari_encode_lane0_streams(dev)
    launched = sum(int(args[3].shape[0]) for args, _ in rec["ari_encode"])
    print(f"[kernels] ari_encode paths over the {len(rec['ari_encode'])} main-path launches: "
          f"warp {launched - main_lane0}, lane 0 {main_lane0}", flush=True)
    check(main_lane0 == 0, f"ari_encode: {main_lane0} main-path streams took the lane-0 path")
    for name, kw in C.CODER_CONFIGS.items():
        cfg = P.Config(**kw)
        d = C.coder_rows(cfg, seed=3)
        n = d["xq"].shape[0]
        for B in (2048, 1):
            picks = [np.resize(np.arange(n), 2048)] if B > 1 else [[i] for i in range(0, n, 25)]
            lane0 = 0
            for pick in picks:
                t = {k: torch.from_numpy(np.ascontiguousarray(v[pick])).to(dev)
                     for k, v in d.items()}
                for mode in (-1, 0, 1):
                    a = (cfg, t["xq"], t["target"], mode)
                    same_bits(K.bit_estimate(*a), quant.bit_estimate_plain(*a),
                              f"bit_estimate ({name}, mode {mode}, B = {B}, rows {pick[:3]}..)")
                args = (cfg,) + tuple(t[k] for k in C.CODER_ARI_ORDER)
                K.reset_ari_encode_lane0_streams(dev)
                same_bits(K.ari_encode(*args), ari.encode_plain(*args),
                          f"ari_encode ({name}, B = {B}, rows {pick[:3]}..)")
                lane0 += K.ari_encode_lane0_streams(dev)
            streams = sum(len(p) for p in picks)
            print(f"[kernels] coder_rows {name}, {streams} streams at B = {B}: bit_estimate "
                  f"(modes -1, 0, 1) and ari_encode equal their plain versions; ari_encode "
                  f"paths: warp {streams - lane0}, lane 0 {lane0}", flush=True)
            if B > 1:
                check(0 < lane0 < streams, f"ari_encode ({name}): the rows took {lane0} of "
                      f"{streams} streams to the lane-0 path")


def slice4_cases(cfg, dev, K, rec, card):
    """The TNS filter analysis on all-zero, half-silent, order-8 and AR(1)
    spectra, at the flagship and at 32 kbps (max_pg 2.0, where the LPC
    weighting decides); the concealment classifier on rows built from the
    recorded q_old_d and q_old_res that take each of its branches; the MDCT
    and IMDCT on full-scale, silent and alternating rows at N = 480 and 160
    (tests/torch_kernel_cases.py). Each must equal its plain version."""
    import torch
    from tests import torch_kernel_cases as C
    import audio_codec_torch as P
    from audio_codec_torch.ops import pc, tns, transforms
    g = lambda a: torch.from_numpy(a).to(dev)
    for name, kw in C.TNS_CONFIGS.items():
        c = P.Config(**kw)
        x, bw = C.tns_rows(seed=1)
        args = (c, g(x), g(bw))
        got = K.tns_filter_analysis(*args)
        ref, gains = tns._analyze(*args)
        torch.cuda.synchronize()
        same_bits(got, ref, f"tns_filter_analysis (synthetic rows, {name})")
        weighted = int(((gains > 1.5) & (gains < 2.0)).sum())
        on = tns_on_off(got)
        print(f"[kernels] tns_filter_analysis synthetic rows at {name}: off/on {on.tolist()}, "
              f"order 8 in filter 0/1 {[int((got[0][:, f] == 8).sum()) for f in (0, 1)]}, "
              f"gains in (1.5, 2) {weighted}", flush=True)
        check(bool((got[0] == 8).any(dim=0).all()), f"{name}: no order 8 in a filter")
        if name == "48k_32kbps":
            check(weighted > 0, "no prediction gain where the weighting decides")
    # the classifier with the stability factor: rows that take each branch of
    # both and of the detector (bfi', stab_fac against the plain version),
    # then every stream of the recorded launch on the detector's path and on
    # the energy path (each launch's graph ms)
    args = rec["pc_classify"][-1][0]
    a = C.pc_fused_rows(*(t[:16].cpu().numpy() for t in args[4:6]), seed=3)
    pargs = (cfg, *(g(a[k]) for k in C.PC_FUSED_ORDER))
    got = K.pc_classify(*pargs)
    same_bits(got, pc.pc_classify_plain(*pargs), "pc_classify (synthetic rows)")
    branches = pc_branch_counts(pargs, got)
    print(f"[kernels] pc_classify synthetic rows ({got[0].shape[0]} streams): {branches}",
          flush=True)
    check(all(v > 0 for v in branches.values()), f"a pc_classify branch was not taken: {branches}")
    for pitch, what in ((1, "the detector"), (0, "the energy path")):
        pargs = pc_all_path_args(args, pitch)
        got = K.pc_classify(*pargs)
        same_bits(got, pc.pc_classify_plain(*pargs), f"pc_classify (every stream on {what})")
        gms = graph_ms(lambda: K.pc_classify(*pargs))
        print(f"[times] {card} | pc_classify, all {got[0].shape[0]} streams on {what}: "
              f"{gms:.5f} ms replayed from a CUDA graph; downgraded {int((got[0] == 1).sum())}",
              flush=True)
    for fs, bitrate in ((48000, 64000), (16000, 32000)):
        c = P.Config(fs_in=fs, bitrate=bitrate)
        x, mem = C.transform_rows(c.frame_length, c.la_zeroes, seed=4, extreme=True)
        targs = (c, g(x), g(mem))
        for name in ("mdct", "imdct", "mdct_compensated"):
            got = getattr(K, name)(*targs)
            if name == "mdct_compensated":
                ref = transforms.mdct_plain(*targs, compensated=True)
            else:
                ref = getattr(transforms, name + "_plain")(*targs)
            torch.cuda.synchronize()
            same_bits(got, [t.contiguous() for t in ref], f"{name} (synthetic rows, N = {c.frame_length})")
            # the rows near 1e37 overflow the compensated order's split, as on the CPU
            finite = got[0][:-2] if name == "mdct_compensated" else got[0]
            check(bool(torch.isfinite(finite).all()), f"{name}: not finite")
        # which rows the compensated kernel gave the step without the split:
        # the plain range test's, the extreme rows (1e-39, 1e37) not
        fast = K.mdct_compensated(*targs, fast_rows=True)[2]
        want = transforms.compensated_fast_rows(*targs)
        print(f"[kernels] mdct_compensated synthetic rows at N = {c.frame_length}: "
              f"{int(fast.sum())} rows on the fast step, {int((~fast).sum())} on the split step "
              f"(rows {torch.nonzero(~fast).flatten().tolist()})", flush=True)
        check(torch.equal(fast, want), "mdct_compensated: fast rows differ from the range test's")
        check(not bool(fast[-4:].any()), "mdct_compensated: an extreme row took the fast step")
        check(bool(fast[: fast.shape[0] - 7].all()),
              "mdct_compensated: a row at 16-bit scale took the split step")
        for b in range(x.shape[0]):   # one stream a launch: the single-row order
            one = (c, g(x[b: b + 1]), g(mem[b: b + 1]))
            same_bits(K.imdct(*one), [t.contiguous() for t in transforms.imdct_plain(*one)],
                      f"imdct (single stream, synthetic row {b}, N = {c.frame_length})")
    print("[kernels] mdct, imdct (also one stream a launch) and mdct_compensated on full-scale, "
          "silent and alternating rows, negative zeros, subnormal-scale rows and rows near 1e37 "
          "at N = 480 and 160 equal their plain versions", flush=True)


def rate_cases(dev, K):
    """The two warp kernels of the rate path in launches of other sizes: the
    TNS filter analysis on tns_rows (silent subdivisions, order 8 in both
    filters, the weighting deciding) at both TNS configurations, each row
    alone (B = 1), 33 and 2047 streams of the rows tiled; the gain bisection
    on gain_rows (tests/torch_kernel_cases.py: iszero throughout, blocks on
    both thresholds, targets within an ulp of a tested ener) at M = 25, 50,
    100 and 120 from every configuration's starting offset, 24, 33 and 2047
    streams a launch, and each row alone at the first offset of M = 25 and
    100. The plain version runs once a case, on the 2047 streams (its rows
    are computed independently); every launch's rows must equal its rows of
    the same inputs."""
    import numpy as np
    import torch
    import audio_codec_torch as P
    from tests import torch_kernel_cases as C
    from audio_codec_torch.ops import quant, tns
    g = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)
    rows = lambda res, pick: [r[torch.as_tensor(pick, device=dev)] for r in outputs(res)]
    launches = 0
    for name, kw in C.TNS_CONFIGS.items():
        c = P.Config(**kw)
        x, bw = C.tns_rows(seed=2)
        n = x.shape[0]
        big = np.arange(2047) % n
        ref = tns.tns_filter_analysis_plain(c, g(x[big]), g(bw[big]))
        picks = [[i] for i in range(n)] + [np.arange(s, s + 33) % n for s in (0, 26)] + [big]
        for pick in picks:
            got = K.tns_filter_analysis(c, g(x[pick]), g(bw[pick]))
            same_bits(got, rows(ref, pick),
                      f"tns_filter_analysis (tns_rows at {name}, B = {len(pick)}, rows {list(pick[:3])}..)")
            launches += 1
    torch.cuda.synchronize()
    print(f"[kernels] tns_filter_analysis on tns_rows at {list(C.TNS_CONFIGS)}: {launches} launches "
          f"(each row alone, B = 33 twice, B = 2047) equal the plain version", flush=True)
    launches, finals = 0, set()
    for M, offsets in C.GAIN_OFFSETS.items():
        for offset0 in offsets:
            en, target = C.gain_rows(M, offset0)
            n = en.shape[0]
            big = np.arange(2047) % n
            ref = quant.gain_bisection_plain(g(en[big]), g(target[big]), offset0)
            picks = [np.arange(n), np.arange(33) % n, big]
            if offset0 == offsets[0] and M in (25, 100):
                picks += [[i] for i in range(n)]
            for pick in picks:
                got = K.gain_bisection(g(en[pick]), g(target[pick]), offset0)
                same_bits(got, rows(ref, pick)[0],
                          f"gain_bisection (gain_rows M = {M}, offset0 {offset0}, B = {len(pick)})")
                launches += 1
            finals |= set((ref[:n].cpu().numpy() - offset0).tolist())
    torch.cuda.synchronize()
    print(f"[kernels] gain_bisection on gain_rows, M = {list(C.GAIN_OFFSETS)} from "
          f"{sum(len(v) for v in C.GAIN_OFFSETS.values())} starting offsets: {launches} launches "
          f"equal the plain version; {len(finals)} distinct final offsets", flush=True)
    check(len(finals) >= 100, f"gain_bisection: the rows reached {len(finals)} final offsets")


def decode_cases(dev, K):
    """The range decoder on tests/torch_kernel_cases.py:decode_rows
    (coder_rows coded by the plain range encoder: escapes to the last level
    and past it, LSB-mode rows, TNS orders 0-12, rows over their budget and
    rows with bytes replaced) at 64 and 160 kbps, in the high-resolution mode
    and at EP3/EP4 with the PC block (the decoder's hooks over four corrupt
    ranges, and the encoder's simulation): every 25th row alone, 33, 2047 and
    16 384 frames a launch, the side information read from the rows' fields;
    and once each in the parsed mode, the side information parsed from the
    frames' own bytes (both dicts against the plain parse and decode); the
    resampler's biquad on biquad_rows at 1, 33 and
    2047 streams over 3 frames, the memories carried. The plain version runs
    once a case on all its rows (rows are decoded independently); every
    launch's rows must equal its rows of the same inputs."""
    import numpy as np
    import torch
    import audio_codec_torch as P
    from tests import torch_kernel_cases as C
    from audio_codec_torch.ops import analysis, ari
    launches = 0
    for name, kw in C.DECODE_CONFIGS.items():
        cfg = P.Config(**kw)
        d = C.decode_rows(name)
        n = len(d["frames"])

        def rows(pick):
            t = {k: torch.from_numpy(np.ascontiguousarray(v[pick])).to(dev) for k, v in d.items()}
            flags = [t[k] for k in ("bfi_in", "be_l", "be_r")] if cfg.n_pc else []
            return t["frames"], {k: t[k] for k in C.DECODE_SIDE_KEYS}, flags
        frames, side, flags = rows(np.arange(n))
        for sim in ((False, True) if cfg.n_pc else (False,)):
            ref = ari.decode_plain(cfg, frames, side, *flags, pc_enc_sim=sim)
            picks = [[i] for i in range(0, n, 25)] + [np.resize(np.arange(n), L)
                                                      for L in (33, 2047, 16384)]
            for pick in picks:
                f_, sd, fl = rows(pick)
                got = K.ari_decode(cfg, f_, sd, *fl, pc_enc_sim=sim)
                idx = torch.as_tensor(pick, device=dev)
                same_bits([got[k] for k in ref], [v[idx] for v in ref.values()],
                          f"ari_decode (decode_rows {name}, pc_enc_sim {sim}, L = {len(pick)})")
                launches += 1
            bfi = torch.bincount(ref["bfi"].long().cpu(), minlength=3).tolist()
            lsb = int(((side["lsb_mode"] == 1) & (ref["bfi"] == 0)).sum())
            print(f"[kernels] ari_decode on decode_rows {name} ({n} rows, pc_enc_sim {sim}): bfi "
                  f"0/1/2 {bfi}, good LSB-mode rows {lsb}", flush=True)
            check(bfi[0] > 0 and bfi[1] > 0, f"ari_decode {name}: bfi {bfi}")
            if cfg.n_pc and not sim:
                check(bfi[2] > 0, f"ari_decode {name}: no bfi 2 row")
            if name == "48k_160k":
                check(lsb > 0, "ari_decode: no good LSB-mode row")
            same_bits(K.ari_decode_frames(cfg, frames, *flags, pc_enc_sim=sim),
                      ari.parse_and_decode_plain(cfg, frames, *flags, pc_enc_sim=sim),
                      f"ari_decode parsed (decode_rows {name}, pc_enc_sim {sim})")
            launches += 1
    torch.cuda.synchronize()
    print(f"[kernels] ari_decode on decode_rows at {list(C.DECODE_CONFIGS)}: {launches} launches "
          f"(every 25th row alone, L = 33, 2047, 16384; and all rows parsed) equal the plain "
          f"versions", flush=True)
    launches = 0
    for B in (1, 33, 2047):
        x = C.biquad_rows(B)
        mem_k = torch.zeros((B, 2), device=dev)
        mem_p = mem_k.clone()
        for f in range(3):
            xf = torch.from_numpy(x[f]).to(dev)
            (y, mem_k), (ry, mem_p) = K.hp50_biquad(xf, mem_k), analysis.hp50_biquad_plain(xf, mem_p)
            same_bits([y, mem_k], [ry, mem_p], f"hp50_biquad (biquad_rows, B = {B}, frame {f})")
            launches += 1
    torch.cuda.synchronize()
    print(f"[kernels] hp50_biquad on biquad_rows at B = 1, 33, 2047 over 3 frames: {launches} "
          f"launches equal the plain version", flush=True)


BRANCHED_KERNELS = ("olpa", "ltpf_encode", "noise_residual_enc", "spec_decode")


def branch_counts(name: str, args, got) -> dict[str, int]:
    """Rows of a launch of the pitch analysis, the LTPF coder, the residual
    coder or the spectrum reconstruction in each of its branches
    (tests/torch_kernel_cases.py)."""
    from tests import torch_kernel_cases as C
    cfg = args[0]
    order = {"olpa": C.OLPA_ORDER, "ltpf_encode": C.LTPF_ORDER, "noise_residual_enc": C.NRE_ORDER,
             "spec_decode": C.SPEC_ORDER}[name]
    a = {k: v.cpu().numpy() for k, v in zip(order, args[1:])}
    out = [t.cpu().numpy() for t in got]
    if name == "olpa":
        return C.olpa_branches(a, out)
    if name == "ltpf_encode":
        return C.ltpf_branches(a, out, cfg.frame_dms)
    if name == "noise_residual_enc":
        return C.nre_branches(a, out, cfg)
    return C.spec_branches(a, cfg)


def pitch_and_spectrum_cases(cfg, dev, K):
    """The pitch analysis on pulse trains and tones at the lag limits (the
    windowed search taken and not, silent rows, empty windows), the LTPF
    coder with each activation rule firing alone and at the search's lowest
    lag, the noise factor and residual coder at 64 and 16 kbps (no zero
    line, a cut n_res, lsbMode), and the spectrum reconstruction in every
    branch of the partial concealment (tests/torch_kernel_cases.py). Each
    must equal its plain version and take every branch."""
    import numpy as np
    import torch
    from tests import torch_kernel_cases as C
    import audio_codec_torch as P
    from audio_codec_torch.ops import analysis, quant
    g = lambda a, order: tuple(torch.from_numpy(np.ascontiguousarray(a[k])).to(dev) for k in order)
    nre_cfgs = [P.Config(**c) for c in C.NRE_CONFIGS.values()]
    cases = [("olpa", cfg, C.olpa_rows(seed=2), C.OLPA_ORDER, analysis.olpa_plain),
             ("ltpf_encode", cfg, C.ltpf_rows(seed=2), C.LTPF_ORDER, analysis.ltpf_encode_plain)]
    cases += [("noise_residual_enc", c, C.nre_rows(c, seed=3), C.NRE_ORDER,
               quant.noise_residual_enc_plain) for c in nre_cfgs]
    cases += [("spec_decode", cfg, C.spec_rows(cfg, seed=4), C.SPEC_ORDER,
               quant.spectrum_decode_plain)]
    for name, c, a, order, plain in cases:
        args = (c, *g(a, order))
        got = getattr(K, name)(*args)
        ref = [t.contiguous() for t in plain(*args)]
        torch.cuda.synchronize()
        what = f"{name} (synthetic rows, {c.bitrate // 1000} kbps, {args[1].shape[0]} streams)"
        same_bits(got, ref, what)
        branches = branch_counts(name, args, got)
        print(f"[kernels] {what}: {branches}", flush=True)
        check(all(v > 0 for v in branches.values()), f"{what}: a branch was not taken: {branches}")
    # the pitch search's warp at every frame size (correlation lengths 64 and
    # 32) on the synthetic rows, at 1, 33 and 2047 streams a launch
    for dms in (100, 50, 25):
        c = P.Config(fs_in=cfg.fs, bitrate=cfg.bitrate, frame_dms=dms)
        a = C.olpa_rows(seed=2, frame_dms=dms)
        for n in (1, 33, 2047):
            pick = np.resize(np.arange(a["mem_pitch"].shape[0]), n)
            args = (c, *(torch.from_numpy(np.ascontiguousarray(a[k][pick])).to(dev)
                         for k in C.OLPA_ORDER))
            got = K.olpa(*args)
            ref = [t.contiguous() for t in analysis.olpa_plain(*args)]
            torch.cuda.synchronize()
            same_bits(got, ref, f"olpa (synthetic rows, {dms / 10} ms, {n} streams)")
        hist = branch_counts("olpa", args, got)
        check(all(v > 0 for v in hist.values()), f"olpa (synthetic rows, {dms / 10} ms): {hist}")
    print("[kernels] olpa on olpa_rows at 10, 5 and 2.5 ms, 1, 33 and 2047 streams a launch, "
          "equals its plain version and takes both window branches", flush=True)
    # the LTPF coder's warp at every frame size (correlation lengths 128 and
    # 64) on the edge rows (the pitch at each lag limit and resolution step,
    # tied window values and candidates, negative correlations), at 1, 33
    # and 2047 streams a launch, the last also with unaligned memory rows
    for dms in (100, 50, 25):
        c = P.Config(fs_in=cfg.fs, bitrate=cfg.bitrate, frame_dms=dms)
        a = C.ltpf_edge_rows(c, seed=2)
        for n in (1, 33, 2047):
            pick = np.resize(np.arange(a["pitch_ol"].shape[0]), n)
            args = [c, *(torch.from_numpy(np.ascontiguousarray(a[k][pick])).to(dev)
                         for k in C.LTPF_ORDER)]
            for aligned in (True, False) if n == 2047 else (True,):
                if not aligned:   # rows a word off 16-byte alignment
                    m = args[4]
                    args[4] = torch.empty(m.numel() + 1, device=dev)[1:].view_as(m).copy_(m)
                got = K.ltpf_encode(*args)
                ref = [t.contiguous() for t in analysis.ltpf_encode_plain(*args)]
                torch.cuda.synchronize()
                what = (f"ltpf_encode (edge rows, {dms / 10} ms, {n} streams"
                        f"{'' if aligned else ', unaligned memory'})")
                same_bits(got, ref, what)
        hist = branch_counts("ltpf_encode", args, got)
        check(all(hist[k] > 0 for k in ("searched", "not searched", "fresh alone")),
              f"ltpf_encode (edge rows, {dms / 10} ms): {hist}")
    print("[kernels] ltpf_encode on ltpf_edge_rows at 10, 5 and 2.5 ms, 1, 33 and 2047 streams a "
          "launch and unaligned memory rows, equals its plain version", flush=True)
    # the residual coder's warp at 1, 33 and 2047 streams a launch, at 48 and 16 kHz
    for c in nre_cfgs:
        a = C.nre_rows(c, seed=6)
        for n in (1, 33, 2047):
            pick = np.resize(np.arange(a["dy"].shape[0]), n)
            args = (c, *(torch.from_numpy(np.ascontiguousarray(a[k][pick])).to(dev)
                         for k in C.NRE_ORDER))
            got, ref = K.noise_residual_enc(*args), quant.noise_residual_enc_plain(*args)
            torch.cuda.synchronize()
            same_bits(got, [t.contiguous() for t in ref],
                      f"noise_residual_enc ({c.fs // 1000} kHz, {c.bitrate // 1000} kbps, {n} streams)")
    print(f"[kernels] noise_residual_enc on nre_rows at {len(nre_cfgs)} configurations, 1, 33 "
          f"and 2047 streams a launch, equals its plain version", flush=True)
    # the LTPF decoder on lanes of every case, the smallest and largest pitch,
    # pitch 0 with the filter flags set (chunks of one sample) and, at 48 kHz,
    # a tap chain whose double sum falls on a float midpoint
    from audio_codec_torch.ops import ltpf_dec
    for c in (cfg, P.Config(fs_in=16000, bitrate=32000)):
        a = C.ltpf_decode_rows(c, seed=5, midpoint=c.fs == 48000)
        args = (c, *g(a, C.LTPF_DEC_ORDER))
        got, ref = K.ltpf_decode(*args), ltpf_dec.ltpf_decode_plain(*args)
        torch.cuda.synchronize()
        what = f"ltpf_decode (synthetic rows, {c.fs // 1000} kHz, {args[1].shape[0]} streams)"
        same_bits(got, ref, what)
        cases = ltpf_case_counts([(args, {})])
        print(f"[kernels] {what}: lanes per case {cases}", flush=True)
        check(all(v > 0 for v in cases.values()), f"{what}: a case was not taken: {cases}")

# the decoder's stages in the order decode_block calls them
DECODER_STAGES = (("ari", "parse_and_decode"), ("sns", "quantize_scf_dec"),
                  ("pc", "pc_classify"), ("quant", "global_gain"),
                  ("quant", "spectrum_decode"), ("tns", "tns_decode"), ("sns", "interpolate_scf"),
                  ("sns", "mdct_shaping"), ("plc", "plc_main_update"), ("transforms", "imdct"),
                  ("plc", "plc_update"), ("ltpf_dec", "ltpf_decode"))


def _tensors(v) -> list:
    import torch
    if isinstance(v, torch.Tensor):
        return [v.detach().cpu()]
    if isinstance(v, dict):
        return [t for k in sorted(v) for t in _tensors(v[k])]
    if isinstance(v, (tuple, list)):
        return [t for x in v for t in _tensors(x)]
    return []


# the encoder's stages in the order encode_frame calls them
ENCODER_STAGES = (("transforms", "mdct"), ("analysis", "resample_12k8"), ("analysis", "olpa"),
                  ("analysis", "ltpf_encode"), ("analysis", "attack_detector"),
                  ("analysis", "per_band_energy"), ("analysis", "detect_cutoff_warped"),
                  ("sns", "compute_scf"), ("sns", "quantize_scf_enc"), ("sns", "interpolate_scf"),
                  ("sns", "mdct_shaping"), ("analysis", "cutoff_bandwidth"), ("tns", "tns_encode"),
                  ("quant", "estimate_global_gain"), ("quant", "quantize_spectrum"),
                  ("quant", "bit_estimate"), ("quant", "adjust_global_gain"),
                  ("quant", "truncate_spectrum"), ("quant", "noise_residual_enc"),
                  ("bits", "pack_side_info"), ("ari", "encode"))


# at plc_mode 1 the concealment's stages come in besides, and the TDAC's
# forward transform
PLC_STAGES = DECODER_STAGES + (("transforms", "mdct"), ("plc_adv", "plc_tdc"), ("plc_adv", "tdac"),
                               ("plc_phecu", "spectrum"), ("plc_phecu", "rec_frame"),
                               ("plc_phecu", "apply"), ("plc_adv", "damp_scramble"),
                               ("plc_adv", "update_pcm_hist"))


def tdac_rows_apart(card: list, cpu: list) -> dict[str, set]:
    """Streams whose TDAC forward MDCT differs card against CPU in two
    traces of one plc_mode 1 decode, by the synthesis it transforms: the
    TD-PLC's (after plc_adv.plc_tdc) or the Phase ECU's (after
    plc_phecu.rec_frame, which runs for every lane and whose FFTs are
    torch.fft's on each device)."""
    import torch
    rows = {"plc_adv.plc_tdc": set(), "plc_phecu.rec_frame": set()}
    ctx = None
    for (name, a), (name_c, b) in zip(card, cpu):
        if name != name_c:
            break
        if name in rows:
            ctx = name
        elif name == "transforms.mdct" and ctx is not None:
            apart = (a[0].view(torch.int32) != b[0].view(torch.int32)).any(-1)
            rows[ctx] |= set(torch.nonzero(apart).flatten().tolist())
    return rows


@contextlib.contextmanager
def stage_trace(store: list, stages=DECODER_STAGES):
    """Record the outputs of every decoder stage call, in order, in store as
    (stage, [tensors on the CPU])."""
    import importlib
    saved = []
    for mod_name, fn_name in stages:
        mod = importlib.import_module(f"audio_codec_torch.ops.{mod_name}")
        fn = getattr(mod, fn_name)
        saved.append((mod, fn_name, fn))

        def wrap(*a, _fn=fn, _name=f"{mod_name}.{fn_name}", **k):
            out = _fn(*a, **k)
            store.append((_name, _tensors(out)))
            return out
        setattr(mod, fn_name, wrap)
    try:
        yield
    finally:
        for mod, fn_name, fn in saved:
            setattr(mod, fn_name, fn)


def first_difference(card: list, cpu: list, may_diverge: bool = False):
    """The first stage call (in call order) whose output differs between two
    traces of the same decode, with per-stage counts of differing calls:
    (stage, call, output, element, card value, cpu value, ulps or None).
    The two traces must take the same stages in the same order; with
    may_diverge (a concealment path that a differing value can steer), the
    first stage where they part is reported instead, and the rest is not
    compared."""
    import torch
    if not may_diverge:
        check(len(card) == len(cpu) and all(a[0] == b[0] for a, b in zip(card, cpu)),
              f"the card's and the CPU's decodes took different stages: "
              f"{[a[0] for a in card]} vs {[b[0] for b in cpu]}")
    first, per_stage = None, {}
    for i, ((name, a), (name_c, b)) in enumerate(zip(card, cpu)):
        if name != name_c:          # the two decodes took different stages from here
            per_stage[name] = per_stage.get(name, 0) + 1
            if first is None:
                first = (f"{name} (cpu: {name_c})", i, None, None, None, None, None)
            break
        for j, (x, y) in enumerate(zip(a, b, strict=True)):
            if x.dtype == torch.float32:
                diff = x.view(torch.int32) != y.view(torch.int32)
            else:
                diff = x != y
            if bool(diff.any()):
                per_stage[name] = per_stage.get(name, 0) + 1
                if first is None:
                    k = int(torch.nonzero(diff.flatten())[0])
                    xv, yv = x.flatten()[k].item(), y.flatten()[k].item()
                    ulp = None
                    if x.dtype == torch.float32:
                        ulp = abs(int(x.view(torch.int32).flatten()[k]) -
                                  int(y.view(torch.int32).flatten()[k]))
                    first = (name, i, j, k, xv, yv, ulp)
                break
    return first, per_stage


def pc_enc_sim(args, kw) -> bool:
    """Whether a recorded ari_decode_frames launch ran the encoder's
    simulation."""
    return bool(args[5] if len(args) > 5 else kw.get("pc_enc_sim", False))


def fec_ops(name: str, args) -> float:
    """Integer operations of the channel coder on these slots (approximate):
    encode, a CRC step a nibble and 13 products a parity nibble; decode, six
    syndromes of 15 products a codeword, three detections on six codewords,
    one correction of every codeword and the CRCs."""
    slot = args[2] if name == "fec_encode" else args[1]
    B = args[0].shape[0]
    ncw = (2 * slot + 14) // 15
    if name == "fec_encode":
        return float(B * (2 * slot * 8 + ncw * 6 * 13 * 2 + 2 * slot * 3))
    return float(B * (ncw * 6 * 15 * 2 + 3 * 6 * 250 + ncw * 250 + 2 * slot * 8 * 2))


def stream_phase(dev, pcm, K, plain, card):
    """Phase 6: the error-protected stream path, StreamEncoder -> channel ->
    StreamDecoder, at EP1-4 with the flagship's 80-byte slot. Returns the
    kernel rows of the channel coder and the PC decoder, and the launch
    counts of the run."""
    import numpy as np
    import torch
    import audio_codec_torch as P
    from audio_codec_torch import engine
    from audio_codec_torch.ops import ari, fec
    from tests import torch_kernel_cases as C
    B, T = pcm.shape[1], pcm.shape[0]
    kinds, frame_bfi = C.stream_plan(T, B)
    rec: dict = {}
    per_mode = {}
    torch.cuda.synchronize()
    K.reset_launch_counts()
    for mode in STREAM_MODES:
        cfg = P.Config(fs_in=48000, bitrate=64000, epmode=mode)
        enc = engine.StreamEncoder(cfg, B, device=dev)
        dec = engine.StreamDecoder(cfg, B, device=dev)
        rec_m: dict = {}
        enc_ms, dec_ms, last_bfi = [], [], []
        rng = np.random.default_rng(mode)
        with recording(rec_m):
            for f in range(T):
                t0, t1, t2 = (torch.cuda.Event(enable_timing=True) for _ in range(3))
                t0.record()
                pay = enc.encode(pcm[f])
                t1.record()
                rows = np.stack([np.frombuffer(b, np.uint8) for b in pay]).astype(np.int32)
                payload = C.channel_errors(rows, cfg.slotBytes, mode, kinds[f], rng)
                payload = payload.astype(np.uint8).tobytes()
                torch.cuda.synchronize()
                t1b = torch.cuda.Event(enable_timing=True)
                t1b.record()
                y = dec.decode(payload, int(frame_bfi[f]))
                t2.record()
                torch.cuda.synchronize()
                enc_ms.append(t0.elapsed_time(t1))
                dec_ms.append(t1b.elapsed_time(t2))
                last_bfi.append(dec.last_bfi.copy())
                check(y.shape == (B, cfg.frame_length) and y.dtype == np.int16,
                      f"EP{mode}: decoded PCM of shape {y.shape} and type {y.dtype}")
                check(len(pay) == B and all(len(b) == cfg.slotBytes for b in pay),
                      f"EP{mode}: frames of the wrong size")
        per_mode[mode] = (cfg, rec_m, enc_ms, dec_ms, np.stack(last_bfi))
        for k, v in rec_m.items():
            rec.setdefault(k, []).extend((mode, a) for a in v)
    torch.cuda.synchronize()
    counts = dict(K.launches)
    print(f"[stream] EP1-4 x {T} frames x {B} streams: launches {counts}", flush=True)
    check(all(counts[k] > 0 for k in K.KERNELS if k not in PLC_KERNELS + FIXED_KERNELS),
          f"a kernel was not launched: {counts}")

    # every launch of the channel coder and of the PC decoder against its
    # plain version; the other kernels on the last frame of each mode
    errs, hist, pc_launches = {}, {}, {r: 0 for r in PC_ROWS}
    plain = dict(plain, fec_encode=fec.fec_encode_plain, fec_decode=fec.fec_decode_plain)
    for mode in STREAM_MODES:
        cfg, rec_m, enc_ms, dec_ms, last_bfi = per_mode[mode]
        for name, launches in rec_m.items():
            pc_mode = name == MAIN_CALL["ari_decode"] and launches[0][0][0].n_pc > 0
            every = name in STREAM_KERNELS or pc_mode
            for i, (args, kw) in enumerate(launches):
                if not every and i < len(launches) - 1:
                    continue
                got = getattr(K, name)(*args, **kw)
                ref = plain[name](*args, **kw)
                same_bits(got, ref, f"EP{mode} {name} launch {i}")
                if pc_mode:
                    row = PC_ROWS[1] if pc_enc_sim(args, kw) else PC_ROWS[0]
                    pc_launches[row] += 1
                    errs[row] = 0.0
                else:
                    errs[name] = 0.0
        # corrected frames give back the encoder's payload
        outs = [K.fec_decode(*a, **k) for a, k in rec_m["fec_decode"]]
        # a lost frame (frame_bfi 1) never reaches the channel decoder
        sent = [a[0] for f, (a, _) in enumerate(rec_m["fec_encode"]) if frame_bfi[f] != 1]
        check(len(sent) == len(outs), f"EP{mode}: {len(outs)} channel decodes of {len(sent)}")
        bfis = torch.cat([o["bfi"] for o in outs]).cpu()
        modes = torch.cat([o["mode"] for o in outs]).cpu()
        corrected = 0
        for o, d in zip(outs, sent):
            ok = (o["bfi"] == 0) & ((o["error_report"] & 0x7FF) > 0)
            db = d.shape[1]
            check(bool((o["data"][:, :db] == d)[o["bfi"] == 0].all()),
                  f"EP{mode}: a frame with bfi 0 does not give back the encoder's payload")
            corrected += int(ok.sum())
        hist[mode] = dict(fec_bfi=torch.bincount(bfis.long(), minlength=3).tolist(),
                          modes=torch.bincount((modes + 1).long(), minlength=6).tolist(),
                          corrected=corrected,
                          last_bfi=np.bincount(last_bfi.ravel(), minlength=3).tolist())
        print(f"[stream] EP{mode} ({cfg.targetBytes}-byte core in an {cfg.slotBytes}-byte slot): "
              f"fec_decode bfi 0/1/2 {hist[mode]['fec_bfi']}, detected mode -1/0/1/2/3/4 "
              f"{hist[mode]['modes']}, {corrected} frames corrected back to the payload, "
              f"decoder bfi 0/1/2 {hist[mode]['last_bfi']}; encode per frame "
              f"{sorted(enc_ms)[len(enc_ms) // 2]:.2f} ms (median), decode "
              f"{sorted(dec_ms)[len(dec_ms) // 2]:.2f} ms, {card}", flush=True)
        check(hist[mode]["fec_bfi"][0] > 0 and hist[mode]["fec_bfi"][1] > 0,
              f"EP{mode}: bfi 0 or 1 never came out of fec_decode: {hist[mode]}")
        check(hist[mode]["last_bfi"][1] > 0, f"EP{mode}: the decoder never concealed a frame")
        if mode > 1:
            check(corrected > 0, f"EP{mode}: no frame was corrected")
        if cfg.n_pc > 0:
            check(hist[mode]["fec_bfi"][2] > 0 and hist[mode]["last_bfi"][2] > 0,
                  f"EP{mode}: a destroyed PC codeword never gave bfi 2: {hist[mode]}")
    check(all(v > 0 for v in pc_launches.values()), f"PC decodes not launched: {pc_launches}")
    print(f"[stream] every launch of fec_encode, fec_decode and of ari_decode with a PC block "
          f"({pc_launches}) equals its plain version; the other kernels at the EP core sizes "
          f"76/66/53/42 bytes too", flush=True)

    # the synthetic rows: slots 40/150/300 and 241 (the first slot of 33
    # codewords), ccc, the 40-byte cap, every EPMR, a wrong mode whose CRC
    # fails, the EPMR risk
    g = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)
    n_rows = 0
    for slot in C.FEC_SLOTS + (241,):
        for mode in STREAM_MODES:
            for ccc in (0, 1):
                data, epmr, kinds_s, bfi_in = C.fec_rows(slot, mode, ccc)
                args = (g(data), g(epmr), slot, mode, ccc)
                enc_k = K.fec_encode(*args)
                same_bits(enc_k, fec.fec_encode_plain(*args), f"fec_encode rows {slot} EP{mode}")
                frames = C.channel_errors(enc_k.cpu().numpy(), slot, mode, kinds_s,
                                          np.random.default_rng(1))
                dargs = (g(frames), slot, ccc, g(bfi_in))
                same_bits(K.fec_decode(*dargs), fec.fec_decode_plain(*dargs),
                          f"fec_decode rows {slot} EP{mode} ccc {ccc}")
                n_rows += data.shape[0]
    synth = g(np.concatenate([C.wrong_mode_rows(), C.epmr_risk_rows()]))
    got = K.fec_decode(synth, 80, 0)
    same_bits(got, fec.fec_decode_plain(synth, 80, 0), "fec_decode (wrong-mode and risk rows)")
    check(bool((got["bfi"] == 1).all()), "fec_decode: a wrong-mode or risk row was not lost")
    # total failures (the EPMR estimate) at three slot sizes, and the
    # 40-byte slot's low-rate cap at EP2-4
    failures, capped = 0, []
    for slot in (40, 80, 300):
        rows_f = g(C.fec_failure_rows(slot))
        got = K.fec_decode(rows_f, slot, 0)
        same_bits(got, fec.fec_decode_plain(rows_f, slot, 0), f"fec_decode failure rows {slot}")
        failures += int(((got["mode"] == -1) & (got["error_report"] == 0x7FF)).sum())
    for ep in (2, 3, 4):
        rows_c = g(C.fec_cap_rows(ep))
        got = K.fec_decode(rows_c, 40, 0)
        same_bits(got, fec.fec_decode_plain(rows_c, 40, 0), f"fec_decode cap rows EP{ep}")
        capped.append(got)
    er = torch.cat([o["error_report"] for o in capped])
    md = torch.cat([o["mode"] for o in capped])
    rejected = int(((md == -1) & (er != 0x7FF)).sum())
    cleared = int(((md >= 3) & ((er & 0x1000) == 0)).sum())
    print(f"[stream] fec_decode edge rows: {failures} total failures at slots 40/80/300, at the "
          f"40-byte cap {rejected} rejected and {cleared} with flags cleared, equal to the plain "
          f"version", flush=True)
    check(failures == 24 and rejected > 0 and cleared > 0,
          f"fec_decode edge rows missed a path: {failures} failures, {rejected} rejected, "
          f"{cleared} cleared")
    for ep in (3, 4):
        a = C.pc_decode_rows(ep)
        cfg = P.Config(fs_in=48000, bitrate=64000, epmode=ep)
        fr = g(a["frames"])
        flags = [g(a[k]) for k in ("bfi_in", "be_l", "be_r")]
        for sim in (False, True):
            ref = ari.parse_and_decode_plain(cfg, fr, *flags, pc_enc_sim=sim)
            same_bits(K.ari_decode_frames(cfg, fr, *flags, pc_enc_sim=sim), ref,
                      f"ari_decode parsed PC rows EP{ep} (pc_enc_sim {sim})")
            same_bits(K.ari_decode(cfg, fr, ref[0], *flags, pc_enc_sim=sim), ref[1],
                      f"ari_decode PC rows EP{ep} (pc_enc_sim {sim})")
    print(f"[stream] synthetic rows: fec_encode and fec_decode on {n_rows} rows at slots "
          f"{C.FEC_SLOTS + (241,)} x EP1-4 x ccc 0/1 (clean, corrected, PC codeword destroyed, heavy, "
          f"bfi_in 1, EPMR 0-3), wrong-mode and EPMR-risk rows, and the PC decoder on EP3/EP4 "
          f"rows with bfi_in 2 over four corrupt ranges equal their plain versions", flush=True)

    # a few streams: the kernel path's payloads against the plain path's
    nb = min(12, B)
    cfg = P.Config(fs_in=48000, bitrate=64000, epmode=3)
    small = pcm[:, :nb].contiguous()
    kinds_s, frame_bfi_s = C.stream_plan(T, nb)

    def run():
        enc = engine.StreamEncoder(cfg, nb, device=dev)
        dec = engine.StreamDecoder(cfg, nb, device=dev)
        pays = C.encode_stream(enc, small)
        payloads = C.channel(pays, lambda f: (cfg.slotBytes, 3), kinds_s, seed=7)
        return pays, C.decode_stream(dec, payloads, frame_bfi_s)
    pays_k, out_k = run()
    with plain_path():
        pays_p, out_p = run()
    gap = int(np.abs(out_k[..., : cfg.frame_length] - out_p[..., : cfg.frame_length]).max())
    print(f"[stream] EP3 kernel path vs plain path on the card, {nb} streams x {T} frames: "
          f"payloads identical {pays_k == pays_p}, max |PCM diff| {gap}, flags identical "
          f"{bool((out_k[..., cfg.frame_length:] == out_p[..., cfg.frame_length:]).all())}",
          flush=True)
    check(pays_k == pays_p, "EP3 payloads of the kernel path differ from the plain path")
    check(gap <= 1, f"EP3 PCM of the kernel path differs by {gap} > 1")
    check(bool((out_k[..., cfg.frame_length:] == out_p[..., cfg.frame_length:]).all()),
          "EP3 bfi, EPMR or error report of the kernel path differ from the plain path")

    # times of the new kernels on the last frame's launches at EP3
    rows = []
    rec3 = per_mode[3][1]
    timed = [("fec_encode", rec3["fec_encode"][-1]), ("fec_decode", rec3["fec_decode"][-1])]
    pcs = [(a, k) for a, k in rec3[MAIN_CALL["ari_decode"]] if a[0].n_pc > 0]
    timed += [(PC_ROWS[0], next(x for x in reversed(pcs) if not pc_enc_sim(*x))),
              (PC_ROWS[1], next(x for x in reversed(pcs) if pc_enc_sim(*x)))]
    for row, (args, kw) in timed:
        name = row if row in STREAM_KERNELS else MAIN_CALL["ari_decode"]
        fn = lambda: getattr(K, name)(*args, **kw)
        ms, ms_min, ms_max = cuda_ms_spread(fn)
        gms = graph_ms(fn)
        pms = cuda_ms(lambda: plain[name](*args, **kw), 2)
        outs = outputs(fn())
        byts = kernel_bytes(name, args, outs)
        ops = fec_ops(name, args) if name in STREAM_KERNELS else work_ops(name, args)
        b_bytes, b_ops = byts / HBM_BYTES_PER_S * 1e3, ops / SCALAR_OPS_PER_S * 1e3
        src, replaces = KERNEL_INFO[row]
        launches = counts[name] if name in STREAM_KERNELS else pc_launches[row]
        rows.append(dict(name=row, route="cuda", source=src, replaces=replaces,
                         launches=launches, max_abs_err=errs.get(row, 0.0), ms=ms, plain_ms=pms,
                         bound_ms=max(b_bytes, b_ops),
                         bound_by="bytes" if b_bytes >= b_ops else "operations",
                         library_ms=None, graph_ms=gms))
        print(f"[times] {card} | {row}: kernel {ms:.4f} ms (median of {TIME_LOOPS} loops of "
              f"{TIME_LAUNCHES}; min {ms_min:.4f}, max {ms_max:.4f}; {gms:.4f} ms replayed from "
              f"a CUDA graph), plain {pms:.2f} ms, bound {max(b_bytes, b_ops):.6f} ms "
              f"({byts} B, {ops:.3g} ops), {launches} launches in the stream run", flush=True)
    for mode in STREAM_MODES:
        cfg, _, enc_ms, dec_ms, _ = per_mode[mode]
        print(f"[times] {card} | StreamEncoder.encode / StreamDecoder.decode EP{mode} B={B}: "
              f"{np.median(enc_ms):.2f} / {np.median(dec_ms):.2f} ms per frame (median of {T}; "
              f"min {min(enc_ms):.2f} / {min(dec_ms):.2f}, max {max(enc_ms):.2f} / "
              f"{max(dec_ms):.2f})", flush=True)
    return rows


def transforms_equal(rec: dict, what: str) -> int:
    """Every recorded launch of the MDCT and IMDCT kernels against its plain
    version, bit for bit; returns the count."""
    from audio_codec_torch import kernels as K
    from audio_codec_torch.ops import transforms
    n = 0
    for name in ("mdct", "imdct"):
        for args, kw in rec.get(name, []):
            ref = getattr(transforms, name + "_plain")(*args, **kw)
            same_bits(getattr(K, name)(*args, **kw), [t.contiguous() for t in ref],
                      f"{name} ({what})")
            n += 1
    return n


def plc_pcm(T: int, B: int, seed: int):
    """make_pcm's material, with every twelfth stream a seeded pair of tones
    (pitched content of high spectral centroid, which the classifier sends
    to the Phase ECU)."""
    import numpy as np
    pcm = make_pcm(T, B, 480, seed)
    rng = np.random.default_rng(seed + 11)
    t = np.arange(T * 480)
    for b in range(11, B, 12):
        f1, f2 = rng.uniform(900, 2500), rng.uniform(3000, 6000)
        pcm[:, b] = (4000 * np.sin(2 * np.pi * f1 * t / 48000)
                     + 2500 * np.sin(2 * np.pi * f2 * t / 48000)).reshape(T, 480)
    return pcm


def plc_loss_plan(T: int, B: int):
    """bfi_ext [T, B] by stream group (b % 6): clean for the first 4 frames
    (the PCM history fills), then a burst of 1, 2, 4 or 8 lost frames, a
    lost frame between redundancy frames (bfi_ext 3), and a clean group."""
    import numpy as np
    bfi = np.zeros((T, B), np.int32)
    for b in range(B):
        g = b % 6
        if g < 4:
            burst = (1, 2, 4, 8)[g]
            bfi[4: 4 + burst, b] = 1
            bfi[min(5 + burst, T - 1), b] = 3
        elif g == 4:
            bfi[[4, 9], b] = 3
            bfi[6, b] = 1
    return bfi


def plc_work(name: str, args, out) -> tuple[int, float]:
    """(bytes, float operations) the concealment kernel needs on this
    launch's data: every stream's scalars and state rows in and out, the
    history rows only where a first loss reads them, and the operations of
    the lanes that do the work (approximate counts of the plain version's
    multiply-adds, two operations each)."""
    import torch
    B = args[1].shape[0]
    if name == "mdct_compensated":
        from audio_codec_torch.ops import transforms
        N = args[1].shape[1]
        byts = nbytes(args[1], args[2], *out, transforms.dct4_mt(N, str(args[1].device)),
                      transforms.window(args[0], str(args[1].device)))
        return byts, float(B * N * N * COMPENSATED_TERM_OPS)
    if name == "plc_tdc":
        lost, nb = args[1].bool(), args[2]
        meth = out["meth"]
        first = lost & (nb == 1)
        tdc = lost & (meth == 3)
        tdc_first = tdc & first
        nf, nt, ntf = (int(v.sum()) for v in (first, tdc, tdc_first))
        byts = B * (11 + 7) * 4 + B * (17 + 855 + 16) * 4 * 2 + B * 780 * 4 + nf * (1335 + 16 + 400) * 4
        ops = nf * (3 * 480 * 2 + 400 * 2 + 17 * 80 * 2 + 16 * 16 * 4) + \
            ntf * (17 * 1095 * 2 + 855 * 11 * 2 + 6 * 240 * 2) + \
            nt * (780 * 11 * 2 + 780 * 16 * 2 + 780 * 2 + 780 * 12 + 480 * 2)
        return byts, float(ops)
    if name == "plc_damp_scramble":
        x = args[1]
        N = x.shape[1]
        work = int((args[4] | args[5]).sum())
        # one row read a stream (q_d_prev where noise-substituted, else x),
        # its output row written, and its 19 scalars
        return B * N * 4 * 2 + B * 19 * 4, float(work * N * 12)
    if name == "phecu_spec_ana":
        act = int(args[6].sum())
        ns = args[1].shape[1]
        return act * 4 * ns * 4 + B * (ns + 18 + 1) * 4 + B * 8, float(act * ns * 30)
    act = int(args[12].sum())
    nsf, ns = args[1].shape[1], args[3].shape[1]
    return act * (2 * nsf + ns + 40) * 4 + B * 2 * nsf * 4 + B * 20, float(act * ns * 60)


def plc_branches(name: str, args, out) -> dict[str, int]:
    """Stream counts of the branches a concealment kernel's launch took."""
    if name == "mdct_compensated":
        from audio_codec_torch.ops import transforms
        silent = ~(args[1] != 0).any(-1) & ~(args[2] != 0).any(-1)
        fast = transforms.compensated_fast_rows(*args)
        return {"silent rows": int(silent.sum()), "rows with signal": int((~silent).sum()),
                "rows on the fast step": int(fast.sum()),
                "rows on the split step": int((~fast).sum())}
    if name == "plc_tdc":
        lost, nb, pitch, fr, stab = args[1].bool(), args[2], args[6], args[7], args[8]
        first = lost & (nb == 1)
        meth = out["meth"]
        tdc = lost & (meth == 3)
        return {"method 2": int((first & (meth == 2)).sum()),
                "method 3": int((first & (meth == 3)).sum()),
                "method 4": int((first & (meth == 4)).sum()),
                "no pitch at a first loss": int((first & (pitch == 0)).sum()),
                "TD-PLC first loss, fractional pitch": int((tdc & first & (fr > 0)).sum()),
                "TD-PLC first loss, whole pitch": int((tdc & first & (fr == 0)).sum()),
                "TD-PLC stab_fac >= 1": int((tdc & first & (stab >= 1)).sum()),
                "TD-PLC later loss": int((tdc & ~first).sum()),
                "TD-PLC past the fade-out": int((tdc & (nb > 6)).sum())}
    if name == "plc_damp_scramble":
        ns, lost, is_pc, inv = args[3], args[4], args[5], args[16]
        return {"noise substitution": int(ns.sum()), "lost, not substituted": int((lost & ~ns).sum()),
                "bfi 2 from bin 0": int((is_pc & (inv == 0)).sum()),
                "bfi 2 above bin 0": int((is_pc & (inv > 0)).sum())}
    if name == "phecu_spec_ana":
        act, npl = args[6], out[1]
        return {"first losses": int(act.sum()), "no peak (or dropped)": int((act & (npl == 0)).sum()),
                "1-2 peaks": int((act & (npl > 0) & (npl < 3)).sum()),
                "3 or more peaks": int((act & (npl >= 3)).sum())}
    act, nb = args[12], args[5]
    return {"first frame": int((act & (nb == 1)).sum()), "burst 2-3": int((act & (nb > 1) & (nb <= 3)).sum()),
            "burst > 3 (DC/Nyquist attenuated)": int((act & (nb > 3)).sum())}


def plc_synthetic(dev, K):
    """The concealment kernels on tests/torch_kernel_cases.py's rows, which
    take the branches a material run may miss: pitch 0, a fractional pitch,
    stab_fac >= 1, past the fade-out, the peak-dense drop rule, one and two
    peaks, bursts past 3 frames, and the edge rows of the peak analysis, the
    substitution and the damping (its rows also off 16-byte alignment).
    Returns the branch counts, under "phecu_spec_ana edges" which of its
    edge rows' edges the card took, and under "<kernel> edge inputs" which
    edges the other two kernels' rows hold (a guard on the inputs)."""
    import numpy as np
    import torch
    from audio_codec_torch.ops import plc_adv, plc_phecu as H
    from tests import torch_kernel_cases as C
    cfg = __import__("audio_codec_torch").Config(fs_in=48000, bitrate=64000, plc_mode=1)
    hist: dict = {}
    t_ = lambda v: torch.as_tensor(np.asarray(v)).to(dev)

    def one(name, kernel, plain, args):
        got, ref = kernel(*args), plain(*args)
        same_bits(got, ref, f"{name} (synthetic rows)")
        for k, v in plc_branches(name, args, got).items():
            hist.setdefault(name, {})
            hist[name][k] = hist[name].get(k, 0) + v
    for group in C.TDC_LANES:
        d = C.tdc_stream_rows(group)
        one("plc_tdc", K.plc_tdc, plc_adv.plc_tdc_plain,
            (cfg, t_(d["lost"]), t_(d["nb"]), t_(d["x_old_tot"]), t_(d["scf"]), t_(d["q_d"]),
             t_(d["pitch"]), t_(d["fract"]), t_(d["stab"]), t_(d["meth"]), t_(d["a_st"]),
             t_(d["seed"]), t_(d["gain_c"]), t_(d["alpha"]), t_(d["fract_st"]), t_(d["harm"]),
             t_(d["harm_len"]), t_(d["synth_hist"])))
    for seed in (0, 1):
        d = C.damp_stream_rows(seed)
        one("plc_damp_scramble", K.plc_damp_scramble, plc_adv.damp_scramble_plain,
            (cfg, t_(d["x"]), t_(d["q_d_prev"]), t_(d["ns_lane"] != 0), t_(d["lost"] != 0),
             t_(d["is_pc"] != 0), t_(d["nb_cur"]), t_(d["pc_nb_lost"]), t_(d["stab_fac"]),
             t_(d["pitch_int"]), t_(d["pc_pitch"]), t_(d["cum_fflc"]), t_(d["cum_slow"]),
             t_(d["cum_fast"]), t_(d["ns_seed"]), t_(d["pc_seed"]), t_(d["spec_inv_idx"])))
        r = C.phecu_peak_rows(seed)
        act = t_(np.array([1, 1, 1, 1, 1, 1, 0, 1]) != 0)
        one("phecu_spec_ana", K.phecu_spec_ana, H.phecu_spec_ana_plain,
            (cfg, t_(r["Xr"]), t_(r["Xi"]), t_(np.roll(r["Xr"], 1, 0)), t_(np.roll(r["Xi"], 1, 0)),
             t_(r["nc"]), act))
        s = C.phecu_subst_rows(seed)
        f0, npl = H._peaks(t_(r["Xr"]), t_(r["Xi"]), t_(r["nc"]))
        one("phecu_subst", K.phecu_subst, H.phecu_subst_plain,
            (cfg, t_(s["Xr"]), t_(s["Xi"]), f0, npl, t_(s["nb_cur"]), t_(s["e_oold"]),
             t_(s["e_old"]), t_(s["mag_chg_1st"]), t_(s["beta_mute"]), t_(s["xavg"]),
             t_(s["is_trans"]), t_(s["active"] != 0)))
    # the peak analysis's edge rows: which of their edges the card took
    e = C.phecu_edge_rows()
    args = (cfg, t_(e["Xr"]), t_(e["Xi"]), t_(e["Xor"]), t_(e["Xoi"]), t_(e["nc"]),
            t_(np.ones(len(e["nc"]), bool)))
    one("phecu_spec_ana", K.phecu_spec_ana, H.phecu_spec_ana_plain, args)
    f0, npl = K.phecu_spec_ana(*args)[:2]
    hist["phecu_spec_ana edges"] = C.phecu_edges_reached(f0.cpu().numpy(), npl.cpu().numpy())
    # the substitution's and the damping's edge rows, held bit for bit against
    # their plain versions; which edges the rows hold is a guard on these
    # inputs (it reads nothing the card computed)
    r = C.phecu_subst_edge_rows()
    one("phecu_subst", K.phecu_subst, H.phecu_subst_plain,
        (cfg, *(t_(r[k]) for k in C.PHECU_SUBST_ARGS)))
    hist["phecu_subst edge inputs"] = C.phecu_subst_edges_reached(r)
    d = C.damp_edge_rows()
    args = (cfg, *(t_(d[k] != 0) if k in C.DAMP_MASKS else t_(d[k]) for k in C.DAMP_ARGS))
    one("plc_damp_scramble", K.plc_damp_scramble, plc_adv.damp_scramble_plain, args)
    # the same rows 4 bytes off 16-byte alignment (the kernel's 4-byte loads)
    off = lambda t: torch.empty(t.numel() + 1, dtype=t.dtype, device=dev)[1:].view(t.shape).copy_(t)
    one("plc_damp_scramble", K.plc_damp_scramble, plc_adv.damp_scramble_plain,
        (cfg, off(args[1]), off(args[2]), *args[3:]))
    hist["plc_damp_scramble edge inputs"] = C.damp_edges_reached(d)
    return hist


def all_active_args(name: str, args, B: int):
    """The arguments of a concealment launch with every stream at work, at B
    streams: phecu_subst's Phase ECU streams tiled (every stream concealed
    by the Phase ECU), plc_damp_scramble's streams tiled and all lost and
    noise-substituted from their first loss on (the scrambling pass on every
    warp)."""
    import torch
    dev = args[1].device
    act = torch.nonzero(args[12]).flatten() if name == "phecu_subst" else \
        torch.arange(args[1].shape[0], device=dev)
    sel = act[torch.arange(B, device=dev) % len(act)]
    a = [x[sel].contiguous() if isinstance(x, torch.Tensor) else x for x in args]
    if name == "plc_damp_scramble":
        ones = torch.ones(B, dtype=torch.bool, device=dev)
        a[3], a[4], a[5] = ones, ones.clone(), torch.zeros_like(ones)
        a[6] = torch.clamp(a[6], min=1)
    return tuple(a)


def all_active_launches(K, busiest: dict, B: int, card: str):
    """phecu_subst and plc_damp_scramble with every stream at work
    (all_active_args of their busiest launches), against their plain
    versions; their graph ms."""
    import torch
    from audio_codec_torch.ops import plc_adv, plc_phecu
    plain = {"phecu_subst": plc_phecu.phecu_subst_plain,
             "plc_damp_scramble": plc_adv.damp_scramble_plain}
    what = {"phecu_subst": "concealed by the Phase ECU",
            "plc_damp_scramble": "lost and noise-substituted"}
    for name in ("phecu_subst", "plc_damp_scramble"):
        args = all_active_args(name, busiest[name][1], B)
        got, ref = getattr(K, name)(*args), plain[name](*args)
        torch.cuda.synchronize()
        same_bits(got, ref, f"{name} (every stream {what[name]})")
        gms = graph_ms(lambda: getattr(K, name)(*args))
        print(f"[plc] {name} with all {B} streams {what[name]} equals its plain version bit for "
              f"bit; branches {plc_branches(name, args, got)}", flush=True)
        print(f"[times] {card} | {name}, all {B} streams {what[name]}: {gms:.4f} ms replayed "
              f"from a CUDA graph", flush=True)


def all_tdc_args(dev, B: int):
    """plc_tdc's arguments with every stream at a TD-PLC first loss: the
    lanes of tests/torch_kernel_cases.py:tdc_stream_rows at a first loss
    with a pitch that the classifier sends to TD-PLC (method 3 in the plain
    version), tiled to B streams."""
    import numpy as np
    import torch
    from audio_codec_torch.ops import plc_adv
    from tests import torch_kernel_cases as C
    cfg = __import__("audio_codec_torch").Config(fs_in=48000, bitrate=64000, plc_mode=1)
    keys = ("lost", "nb", "x_old_tot", "scf", "q_d", "pitch", "fract", "stab", "meth", "a_st",
            "seed", "gain_c", "alpha", "fract_st", "harm", "harm_len", "synth_hist")
    lanes = []
    for group in C.TDC_LANES:
        d = C.tdc_stream_rows(group)
        for b in range(len(d["nb"])):
            if d["lost"][b] and d["nb"][b] == 1 and d["pitch"][b] > 0:
                lanes.append({k: np.asarray(d[k])[b] for k in keys})
    rows = {k: torch.as_tensor(np.stack([e[k] for e in lanes])) for k in keys}
    meth = plc_adv.plc_tdc_plain(cfg, *(rows[k] for k in keys))["meth"]
    sel = torch.nonzero(meth == 3).flatten()
    idx = sel[torch.arange(B) % len(sel)]
    return (cfg, *(rows[k][idx].contiguous().to(dev) for k in keys))


def all_tdc_launch(dev, K, B: int, card: str) -> float:
    """plc_tdc at B streams all at a TD-PLC first loss (the launch whose
    streams fill the card), against its plain version; its graph ms."""
    import torch
    from audio_codec_torch.ops import plc_adv
    args = all_tdc_args(dev, B)
    got, ref = K.plc_tdc(*args), plc_adv.plc_tdc_plain(*args)
    torch.cuda.synchronize()
    same_bits(got, ref, "plc_tdc (every stream at a TD-PLC first loss)")
    b = plc_branches("plc_tdc", args, got)
    check(b["method 3"] == B, f"plc_tdc's all-TD-PLC launch: {b}")
    gms = graph_ms(lambda: K.plc_tdc(*args))
    print(f"[plc] plc_tdc with all {B} streams at a TD-PLC first loss equals its plain version "
          f"bit for bit; branches {b}", flush=True)
    print(f"[times] {card} | plc_tdc, all {B} streams at a TD-PLC first loss: {gms:.4f} ms "
          f"replayed from a CUDA graph", flush=True)
    return gms


def concealment_phase(dev, opt, K, card):
    """Phase 7: decode_block at plc_mode 1 over a loss plan; the four
    concealment kernels against their plain versions; times. Returns the
    kernel rows, and the payloads and loss plan for phase 9."""
    import statistics
    import numpy as np
    import torch
    import audio_codec_torch as P
    from audio_codec_torch.ops import plc_adv, plc_phecu, transforms
    t_start = time.time()
    B, T = opt.streams, PLC_FRAMES
    cfg = P.Config(fs_in=48000, bitrate=64000, plc_mode=1)
    pcm = torch.from_numpy(plc_pcm(T, B, opt.seed)).to(dev)
    _, frames = P.encode_block(cfg, P.enc_state_init(cfg, B, device=dev), pcm)
    bfi = torch.from_numpy(plc_loss_plan(T, B)).to(dev)
    print(f"[plc] material: make_pcm's speech, music and noise, every twelfth stream seeded "
          f"tones; loss plan by b % 6: bursts of 1, 2, 4, 8 lost frames each followed by a "
          f"redundancy frame, a lost frame between redundancy frames, clean; B={B} T={T}",
          flush=True)

    # the main path's run, its launch counts
    ds = P.dec_state_init(cfg, B, device=dev)
    torch.cuda.synchronize()
    K.reset_launch_counts()
    ds, out = P.decode_block(cfg, ds, frames, bfi)
    torch.cuda.synchronize()
    counts = dict(K.launches)
    print(f"[plc] decode_block at plc_mode 1, B={B} T={T}: launches {counts}", flush=True)
    check(all(counts[k] > 0 for k in PLC_KERNELS), f"a concealment kernel was not launched: {counts}")
    check(tuple(out.shape) == (T, B, 480) and bool(torch.isfinite(out).all()),
          "plc_mode 1 PCM not finite or of the wrong shape")

    # every launch of the four kernels against its plain version
    plain = {"plc_tdc": plc_adv.plc_tdc_plain, "plc_damp_scramble": plc_adv.damp_scramble_plain,
             "phecu_spec_ana": plc_phecu.phecu_spec_ana_plain,
             "phecu_subst": plc_phecu.phecu_subst_plain,
             "mdct_compensated": lambda *a: tuple(
                 t.contiguous() for t in transforms.mdct_plain(*a, compensated=True))}
    rec: dict = {}
    with recording(rec):
        P.decode_block(cfg, P.dec_state_init(cfg, B, device=dev), frames, bfi)
    torch.cuda.synchronize()
    errs, hist, busiest = {}, {}, {}
    for name in PLC_KERNELS:
        err, best = 0.0, None
        for args, kw in rec[name]:
            got = getattr(K, name)(*args, **kw)
            ref = plain[name](*args, **kw)
            torch.cuda.synchronize()
            same_bits(got, ref, name)
            pairs = [(got[k], ref[k]) for k in ref] if isinstance(ref, dict) else list(zip(got, ref))
            err = max(err, max(float((g.double() - r.double()).abs().max()) for g, r in pairs))
            b = plc_branches(name, args, got)
            hist[name] = {k: hist.get(name, {}).get(k, 0) + v for k, v in b.items()}
            work = plc_work(name, args, got)[1]
            if best is None or work > best[0]:
                best = (work, args, kw)
        errs[name], busiest[name] = err, best
        print(f"[plc] {name}: {len(rec[name])} launches equal their plain version bit for bit; "
              f"branches {hist[name]}", flush=True)
    n = transforms_equal(rec, "plc_mode 1")
    print(f"[plc] mdct and imdct: {n} launches equal their plain versions bit for bit", flush=True)
    meth = {k: hist["plc_tdc"][f"method {k}"] for k in (2, 3, 4)}
    print(f"[plc] methods chosen at first losses: {meth}", flush=True)
    check(all(v > 0 for v in meth.values()), f"a concealment method never occurred: {meth}")
    all_tdc_launch(dev, K, B, card)
    all_active_launches(K, busiest, B, card)
    syn = plc_synthetic(dev, K)
    print(f"[plc] synthetic rows equal their plain versions; branches {syn}", flush=True)
    check(syn["plc_tdc"]["no pitch at a first loss"] > 0 and
          syn["plc_tdc"]["TD-PLC first loss, fractional pitch"] > 0 and
          syn["plc_tdc"]["TD-PLC stab_fac >= 1"] > 0 and syn["plc_tdc"]["TD-PLC past the fade-out"] > 0,
          f"plc_tdc: a rare branch was not reached: {syn['plc_tdc']}")
    check(syn["phecu_spec_ana"]["1-2 peaks"] > 0 and syn["phecu_spec_ana"]["no peak (or dropped)"] > 0,
          f"phecu_spec_ana: a rare branch was not reached: {syn['phecu_spec_ana']}")
    check(all(syn["phecu_spec_ana edges"].values()),
          f"phecu_spec_ana: an edge row missed its branch: {syn['phecu_spec_ana edges']}")
    check(syn["phecu_subst"]["burst > 3 (DC/Nyquist attenuated)"] > 0, "phecu_subst: no burst > 3")
    for name in ("phecu_subst", "plc_damp_scramble"):
        check(all(syn[f"{name} edge inputs"].values()),
              f"{name}: an edge row lacks its edge: {syn[f'{name} edge inputs']}")

    # a few streams: the kernel path against the plain path, and the card
    # against the port on the CPU (the path the tests hold to the reference)
    nb = min(12, B)
    fr_s, bfi_s = frames[:, :nb].contiguous(), bfi[:, :nb].contiguous()
    trace_k, trace_c = [], []
    ph_streams = torch.zeros(nb, dtype=torch.bool)    # streams the Phase ECU conceals
    apply = plc_phecu.apply

    def apply_seen(*a, **k):
        ph_streams.logical_or_(a[12].cpu())
        return apply(*a, **k)
    plc_phecu.apply = apply_seen
    try:
        with stage_trace(trace_k, PLC_STAGES):
            _, out_k = P.decode_block(cfg, P.dec_state_init(cfg, nb, device=dev), fr_s, bfi_s)
    finally:
        plc_phecu.apply = apply
    with plain_path():
        _, out_p = P.decode_block(cfg, P.dec_state_init(cfg, nb, device=dev), fr_s, bfi_s)
    cpu = torch.device("cpu")
    with stage_trace(trace_c, PLC_STAGES):
        _, out_c = P.decode_block(cfg, P.dec_state_init(cfg, nb, device=cpu), fr_s.cpu(),
                                  bfi_s.cpu())
    first, per_stage = first_difference(trace_k, trace_c, may_diverge=True)
    print(f"[plc] card vs CPU port at plc_mode 1, stage by stage over {len(trace_k)} stage "
          f"calls: first difference {first} (stage, call, output, element, card, cpu, ulps); "
          f"stage calls that differ {per_stage}", flush=True)
    check(first is None or not first[0].startswith("transforms.mdct"),
          "the TDAC's forward MDCT is still where the card's concealment departs from the CPU's")
    apart = tdac_rows_apart(trace_k, trace_c)
    ph = set(torch.nonzero(ph_streams).flatten().tolist())
    print(f"[plc] streams whose TDAC MDCT differs, card vs CPU: of the TD-PLC's synthesis "
          f"{sorted(apart['plc_adv.plc_tdc'])}, of the Phase ECU's {sorted(apart['plc_phecu.rec_frame'])}; "
          f"streams the Phase ECU concealed {sorted(ph)}", flush=True)
    check(apart["plc_adv.plc_tdc"] <= ph, "the TD-PLC's TDAC MDCT differs from the CPU's on a "
          "stream the Phase ECU never concealed")
    pk = P.round_pcm(out_k).to(torch.int32)
    gap_p = int((pk - P.round_pcm(out_p).to(torch.int32)).abs().max())
    gap_c = (pk.cpu() - P.round_pcm(out_c).to(torch.int32)).abs()
    other = gap_c[:, ~ph_streams]
    print(f"[plc] {nb} streams x {T} frames at plc_mode 1: kernel path vs plain path on the card "
          f"max |PCM diff| {gap_p}; card vs the port on the CPU max |PCM diff| "
          f"{int(gap_c.max())}, {int((gap_c > 0).sum())} of {gap_c.numel()} samples differ; "
          f"on the {other.shape[1]} streams the Phase ECU never concealed (TD-PLC, noise "
          f"substitution) {int((other > 0).sum())} of {other.numel()}", flush=True)
    check(gap_p <= 1, f"plc_mode 1 PCM of the kernel path differs by {gap_p} > 1")
    check(int(gap_c.max()) <= CPU_PCM_TOL, f"plc_mode 1 PCM differs from the CPU port's by "
          f"{int(gap_c.max())}")

    # times
    rows = []
    for name in PLC_KERNELS:
        _, args, kw = busiest[name]
        fn = lambda: getattr(K, name)(*args, **kw)
        ms, ms_min, ms_max = cuda_ms_spread(fn)
        gms = graph_ms(fn)
        pms = cuda_ms(lambda: plain[name](*args, **kw), 1)
        byts, ops = plc_work(name, args, fn())
        b_bytes, b_ops = byts / HBM_BYTES_PER_S * 1e3, ops / SCALAR_OPS_PER_S * 1e3
        src, replaces = KERNEL_INFO[name]
        lib_ms = None
        if name == "mdct_compensated":   # the library's product of the same rows
            lib_ms = matmul_ms(args[1])
        rows.append(dict(name=name, route="cuda", source=src, replaces=replaces,
                         launches=counts[name], max_abs_err=errs[name], ms=ms, plain_ms=pms,
                         bound_ms=max(b_bytes, b_ops),
                         bound_by="bytes" if b_bytes >= b_ops else "operations",
                         library_ms=lib_ms, graph_ms=gms))
        print(f"[times] {card} | {name}: kernel {ms:.4f} ms (median of {TIME_LOOPS} loops of "
              f"{TIME_LAUNCHES}; min {ms_min:.4f}, max {ms_max:.4f}; {gms:.4f} ms replayed from "
              f"a CUDA graph), plain {pms:.2f} ms, "
              + (f"torch.matmul {lib_ms:.4f} ms, " if lib_ms is not None else "") +
              f"bound {max(b_bytes, b_ops):.6f} ms ({byts} B, {ops:.3g} ops) on its busiest "
              f"launch, {counts[name]} launches in the block", flush=True)
    seg = torch.randn((B, 768), device=dev)
    spec = torch.fft.rfft(seg)
    r_ms = cuda_ms_spread(lambda: torch.fft.rfft(seg))
    i_ms = cuda_ms_spread(lambda: torch.fft.irfft(spec, n=768))
    print(f"[times] {card} | library torch.fft.rfft [{B}, 768]: {r_ms[0]:.4f} ms (min {r_ms[1]:.4f}, "
          f"max {r_ms[2]:.4f}); torch.fft.irfft [{B}, 385]: {i_ms[0]:.4f} ms (min {i_ms[1]:.4f}, "
          f"max {i_ms[2]:.4f})", flush=True)
    ds = P.dec_state_init(cfg, B, device=dev)
    per = []
    for t in range(T):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ds, _, _ = P.decode_frame(cfg, ds, frames[t], bfi[t])
        torch.cuda.synchronize()
        per.append((time.perf_counter() - t0) * 1e3)
    lossy = [per[t] for t in range(T) if bool((bfi[t] > 0).any())]
    print(f"[times] {card} | decode_frame at plc_mode 1 B={B}: {statistics.median(lossy):.2f} ms "
          f"per lossy frame (median of {len(lossy)}; min {min(lossy):.2f}, max {max(lossy):.2f}); "
          f"clean frames {statistics.median(per[:4]):.2f} ms", flush=True)
    print(f"[plc] phase 7 took {time.time() - t_start:.1f} s", flush=True)
    return rows, frames, bfi


def fixed_work_bytes(name: str, args, outs) -> int:
    """Bytes the fixed-point kernel must move: each input read once, each
    output written once (the state of fx_ola_ltpf read and written); the
    residual bits only as far as each frame's n_res reaches, and of each DCT
    row only the bins below the bandwidth cap (fixed_imdct.MAX_BW)."""
    if name == "fx_sns_dec":
        return nbytes(args[0]) + nbytes(*outs)
    if name == "fx_spec_decode":
        cfg, x, res, n_res = args[:4]
        return (nbytes(x, *args[4:]) + int(n_res.clamp(0, res.shape[1]).sum()) * 4 + 4 * len(n_res)
                + nbytes(*outs))
    if name == "fx_dct4":
        from audio_codec_torch.ops.fixed_imdct import MAX_BW
        y, y_e, N, frame_dms = args[:4]
        cols = min(N, MAX_BW >> {25: 2, 50: 1, 100: 0}[frame_dms])
        return y.shape[0] * cols * y.element_size() + nbytes(y_e) + nbytes(*outs)
    st = args[1]
    return nbytes(*args[2:7], *st.values()) + nbytes(outs[0], *st.values())


def fixed_branches(name: str, args, out, fs_idx: int) -> dict[str, int]:
    """What the recorded launch's frames reach: SNS submodes, TNS on and off
    and zero frames, the post-filter's branches (0 passthrough, 1-4 pat1-4)."""
    import torch
    from audio_codec_torch.ops import fixed_ltpf_dev as fld
    if name == "fx_sns_dec":
        from audio_codec_torch.ops import fixed_dev as fv
        sub = torch.bincount(args[0][:, 2].clamp(0, 3).long(), minlength=4).tolist()
        ber = int(fv.sns_decode_scf(args[0])[1].sum())
        return {f"submode {k}": sub[k] for k in range(4)} | {"MPVQ index out of range": ber}
    if name == "fx_spec_decode":
        on = (args[10] > 0).any(dim=1)
        o0, o1, two = args[10][:, 0] > 0, args[10][:, 1] > 0, args[7] >= 3   # 10 ms frames
        return {"TNS on": int(on.sum()), "TNS off": int((~on).sum()),
                "zero frames": int((args[5] != 0).sum()),
                "one filter": int((o0 & ~(o1 & two)).sum()),
                "two filters": int((o0 & o1 & two).sum()),
                "filter 0 off, filter 1 on": int((~o0 & o1 & two).sum())}
    if name == "fx_dct4":
        return {"all-zero rows": int((out[3]).sum()), "rows": int(out[3].numel())}
    pats = torch.bincount(fld.ltpf_patterns(args[1], args[6], fs_idx), minlength=5).tolist()
    return dict(zip(("passthrough", "pat1", "pat2", "pat3", "pat4"), pats))


def fixed_equal(K, name: str, args) -> tuple[list, int]:
    """One launch of a fixed-point kernel against its plain version on the
    same inputs (tests/torch_kernel_cases.py:fixed_pair); fails on any
    difference. Returns the kernel's outputs and the largest |kernel -
    plain|."""
    import torch
    from tests.torch_kernel_cases import fixed_pair
    got, ref = fixed_pair(K, name, args)
    torch.cuda.synchronize()
    err = max(int((g.long() - r.long()).abs().max()) for g, r in zip(got, ref, strict=True))
    same_bits(got, ref, name)
    return got, err


def fixed_args_copy(args) -> list:
    """The arguments with a copy of each state dict (fx_ola_ltpf steps its
    state in place)."""
    return [{k: v.clone() for k, v in a.items()} if isinstance(a, dict) else a for a in args]


def ola_block_times(K, launches, final: dict) -> tuple[float, float, float, float, float]:
    """fx_ola_ltpf's ms a launch over the block's recorded frames: each timed
    call copies the block's first state into a working state and runs the T
    recorded launches in order, so every launch meets the state and takes
    the branches it took in the main path (the working state must end equal
    to the main path's, `final`); the copy is timed alone and taken off.
    Returns (median, min, max over the loops, CUDA-graph replay, the plain
    version), each ms a launch."""
    import torch
    from tests.torch_kernel_cases import fixed_plain
    cfg, first = launches[0][0][:2]
    frames = [args[2:] for args, _ in launches]
    T = len(frames)
    snap = {k: v.clone() for k, v in first.items()}
    work = {k: v.clone() for k, v in first.items()}

    def restore():
        for k, v in snap.items():
            work[k].copy_(v)

    def block():
        restore()
        for rest in frames:
            K.fx_ola_ltpf(cfg, work, *rest)
    block()
    torch.cuda.synchronize()
    check(all(torch.equal(work[k], final[k]) for k in final),
          "fx_ola_ltpf's timed frames do not end in the main path's state")
    loops = sorted(cuda_ms(block, TIME_LAUNCHES) for _ in range(TIME_LOOPS))
    copy_ms = sorted(cuda_ms(restore, TIME_LAUNCHES) for _ in range(TIME_LOOPS))[TIME_LOOPS // 2]
    per = [(v - copy_ms) / T for v in loops]
    gms = (graph_ms(block) - graph_ms(restore)) / T

    def plain_block():
        st = {k: v.clone() for k, v in snap.items()}
        for rest in frames:
            fixed_plain("fx_ola_ltpf")(cfg, st, *rest)
    pms = cuda_ms(plain_block, 1) / T
    print(f"[times] fx_ola_ltpf: {T} recorded frames from the block's first state a timed call; "
          f"the state copy {copy_ms:.4f} ms taken off", flush=True)
    return per[TIME_LOOPS // 2], per[0], per[-1], gms, pms


def fixed_synthetic(cfg, dev, K) -> dict:
    """The synthetic rows of tests/torch_kernel_cases.py through each
    fixed-point kernel against its plain version: every SNS submode, both
    leading signs and out-of-range indices; silent, full-scale, zero-frame
    and order-8 spectra; all-zero, full-scale and alternating DCT rows and
    the DCT's edge rows (fx_dct4_edge_rows); the
    post-filter plan through passthrough, pat2, pat3, pat4 and pat1 at 48
    and 8 kHz, with its edge streams (passes at pitch_int <= shift, chunks
    shorter than a warp at 8 kHz)."""
    import numpy as np
    import torch
    import audio_codec_torch as P
    from audio_codec_torch.fixed_decoder_dev import DeviceFixedDecoder
    from audio_codec_torch.ops import fixed_dev as fv
    from tests import torch_kernel_cases as C
    g = lambda a: torch.from_numpy(a).to(dev)
    hist = {}
    idx = g(C.fx_sns_rows())
    fixed_equal(K, "fx_sns_dec", (idx, cfg.bands_number))
    hist["fx_sns_dec"] = fixed_branches("fx_sns_dec", (idx,), None, cfg.fs_idx)
    # a seeded sample of every shape's indices with the first and last, and
    # the out-of-range indices and clamps, at every band count of the
    # configurations (the card path runs 64)
    idx = g(np.concatenate([C.fx_sns_edge_rows(), C.fx_sns_sample_rows()]))
    for nb in C.FX_SNS_BANDS:
        fixed_equal(K, "fx_sns_dec", (idx, nb))
    hist["fx_sns_dec sample and edge rows"] = fixed_branches("fx_sns_dec", (idx,), None,
                                                             cfg.fs_idx)
    d = C.fx_spec_rows(cfg)
    scf, scf_e = fv.sns_decode_plain(g(d["scf_idx"]), cfg.bands_number)
    args = (cfg, *(g(d[k]) for k in C.FX_SPEC_ORDER), scf, scf_e)
    fixed_equal(K, "fx_spec_decode", args)
    hist["fx_spec_decode"] = fixed_branches("fx_spec_decode", args, None, cfg.fs_idx)
    y, y_e = C.fx_dct4_rows()
    out, _ = fixed_equal(K, "fx_dct4", (g(y), g(y_e), cfg.frame_length, cfg.frame_dms))
    hist["fx_dct4"] = fixed_branches("fx_dct4", None, out, cfg.fs_idx)
    # the edge rows of its 32-bit words (-2^31, headroom 0, 30 and 31, rows
    # the pre-scale takes to full scale, all-zero rows among nonzero ones),
    # alone and tiled to 2047 rows
    y, y_e = C.fx_dct4_edge_rows()
    for n in (len(y), 2047):
        i = np.arange(n) % len(y)
        out, _ = fixed_equal(K, "fx_dct4", (g(y[i]), g(y_e[i]), cfg.frame_length, cfg.frame_dms))
    hist["fx_dct4 edge rows"] = fixed_branches("fx_dct4", None, out, cfg.fs_idx)
    # the post-filter plan at 48 kHz, and at 8 kHz (pitch lags from 19:
    # chunks shorter than a warp), each also with its edge streams (pitch
    # indices at their ranges' ends, passes at pitch 0 where pitch_int <=
    # shift, silent and full-scale frames)
    pats, lags = {}, {}
    cfg8 = P.Config(fs_in=8000, bitrate=24000)
    for c, plan in ((cfg, C.fx_ola_plan(B=64)), (cfg, C.fx_ola_edge_plan(B=64)),
                    (cfg8, C.fx_ola_plan(B=64, N=80)), (cfg8, C.fx_ola_edge_plan(B=64, N=80))):
        dec = DeviceFixedDecoder(c, 64, device=dev)
        for t in range(len(C.LTPF_PLAN)):
            args = (c, dec.state, *(g(plan[k][t]) for k in ("ytda", "y_e", "y_s", "zero", "lp")),
                    dec.sfi)
            b = fixed_branches("fx_ola_ltpf", args, None, c.fs_idx)
            pats = {k: pats.get(k, 0) + v for k, v in b.items()}
            key = f"{c.fs // 1000} kHz"
            for k, v in C.fx_ola_pass_lags(dec.state, plan["lp"][t], c.fs_idx, dec.sfi).items():
                lags[f"{key} {k}"] = lags.get(f"{key} {k}", 0) + v
            fixed_equal(K, "fx_ola_ltpf", args)
            K.fx_ola_ltpf(*args)               # step the plan's state
    hist["fx_ola_ltpf"] = pats
    hist["fx_ola_ltpf passes"] = lags
    return hist


def fixed_phase(dev, frames, K, card) -> list:
    """Phase 8: DeviceFixedDecoder over phase 4's payloads (and a group of
    silent streams) at B x T; the four fixed-point kernels against their
    plain versions on every launch and on synthetic rows; the card against
    the stored reference PCM and against the port on the CPU; times."""
    import numpy as np
    import torch
    import audio_codec_torch as P
    from audio_codec_torch.fixed_decoder_dev import DeviceFixedDecoder
    from tests.torch_kernel_cases import fixed_plain
    t_start = time.time()
    cfg = P.Config(fs_in=48000, bitrate=64000)
    T, B = frames.shape[:2]
    silent = torch.zeros((T, FIXED_SILENT, cfg.frame_length), device=dev)
    _, quiet = P.encode_block(cfg, P.enc_state_init(cfg, FIXED_SILENT, device=dev), silent)
    frames = frames.clone()
    frames[:, B - FIXED_SILENT:] = quiet
    print(f"[fixed] payloads: phase 4's block, its last {FIXED_SILENT} streams silent; "
          f"B={B} T={T}", flush=True)

    # the main path's run and its launch counts
    dd = DeviceFixedDecoder(cfg, B, device=dev)
    torch.cuda.synchronize()
    K.reset_launch_counts()
    pcm = dd.decode_block(frames)
    torch.cuda.synchronize()
    counts = {k: v for k, v in K.launches.items() if v}
    print(f"[fixed] DeviceFixedDecoder.decode_block at B={B} T={T}: launches {counts}", flush=True)
    want = {"ari_decode": 1, "fx_sns_dec": 1, "fx_spec_decode": 1, "fx_dct4": 1,
            "fx_ola_ltpf": T}
    check(counts == want, f"fixed-point launches {counts}, expected {want}")
    check(tuple(pcm.shape) == (T, B, cfg.frame_length) and pcm.dtype == torch.int16,
          f"fixed-point PCM {tuple(pcm.shape)} {pcm.dtype}")

    # every launch against its plain version, with no tolerance
    rec: dict = {}
    rd = DeviceFixedDecoder(cfg, B, device=dev)
    with recording(rec, FIXED_KERNELS, copy=True):
        rd.decode_block(frames)
    torch.cuda.synchronize()
    hist, errs = {}, {}
    for name in FIXED_KERNELS:
        for args, _ in rec[name]:
            out, err = fixed_equal(K, name, args)
            errs[name] = max(errs.get(name, 0), err)
            b = fixed_branches(name, args, out, cfg.fs_idx)
            hist[name] = {k: hist.get(name, {}).get(k, 0) + v for k, v in b.items()}
        print(f"[fixed] {name}: {len(rec[name])} launches equal their plain version; "
              f"{hist[name]}", flush=True)
    check(hist["fx_spec_decode"]["zero frames"] > 0, "no zero frame in the fixed-point block")
    kinds = ("one filter", "two filters", "filter 0 off, filter 1 on")
    check(all(hist["fx_sns_dec"][f"submode {k}"] > 0 for k in range(4)),
          f"an SNS submode never occurred: {hist['fx_sns_dec']}")
    syn = fixed_synthetic(cfg, dev, K)
    print(f"[fixed] synthetic rows equal their plain versions; {syn}", flush=True)
    check(all(v > 0 for v in syn["fx_ola_ltpf"].values()),
          f"a post-filter branch was not reached: {syn['fx_ola_ltpf']}")
    reached = {k: hist["fx_spec_decode"][k] + syn["fx_spec_decode"][k] for k in kinds}
    print(f"[fixed] fx_spec_decode's TNS filters on the block and the synthetic rows: {reached}",
          flush=True)
    check(all(v > 0 for v in reached.values()), f"a TNS filter kind was not reached: {reached}")
    lags = syn["fx_ola_ltpf passes"]
    check(all(lags[k] > 0 for k in ("48 kHz d >= 32", "48 kHz d <= 0", "8 kHz d < 32",
                                    "8 kHz d <= 0")),
          f"a post-filter pass lag was not reached: {lags}")
    check(all(v > 0 for v in syn["fx_sns_dec"].values())
          and all(v > 0 for v in syn["fx_sns_dec sample and edge rows"].values())
          and syn["fx_dct4"]["all-zero rows"] > 0,
          "a synthetic SNS submode, out-of-range index or all-zero DCT row is missing")

    # the card against the reference: the stored PCM, bit for bit
    ref = np.load(ROOT / "audio_codec_torch" / "data" / "fixed_pcm_ref.npz")
    nref = ref["frames"].shape[1]
    got = DeviceFixedDecoder(cfg, nref, device=dev).decode_block(
        torch.from_numpy(ref["frames"]).to(dev)).cpu().numpy()
    diff = int((got != ref["pcm"]).sum())
    print(f"[fixed] stored reference ({nref} streams x {ref['frames'].shape[0]} frames of the "
          f"reference's FixedDecoder): {diff} samples differ on the card", flush=True)
    check(diff == 0, f"the card's fixed-point PCM differs from the reference's in {diff} samples")
    # a few streams of this run against the port on the CPU
    pick = list(range(8)) + list(range(B - 4, B))
    cpu = DeviceFixedDecoder(cfg, len(pick), device="cpu").decode_block(frames[:, pick].cpu())
    diff = int((cpu != pcm[:, pick].cpu()).sum())
    print(f"[fixed] card vs the port on the CPU, streams {pick}: {diff} samples differ",
          flush=True)
    check(diff == 0, f"the card's fixed-point PCM differs from the CPU port's in {diff} samples")

    # times
    rows = []
    for name in FIXED_KERNELS:
        args, _ = rec[name][-1]
        if name == "fx_ola_ltpf":
            ms, ms_min, ms_max, gms, pms = ola_block_times(K, rec[name], rd.state)
        else:
            fn = lambda: getattr(K, name)(*args)
            ms, ms_min, ms_max = cuda_ms_spread(fn)
            gms = graph_ms(fn)
            pms = cuda_ms(lambda: fixed_plain(name)(*args), 1)
        byts = fixed_work_bytes(name, args, outputs(getattr(K, name)(*fixed_args_copy(args))))
        b_bytes = byts / HBM_BYTES_PER_S * 1e3
        src, replaces = KERNEL_INFO[name]
        rows.append(dict(name=name, route="cuda", source=src, replaces=replaces,
                         launches=counts[name], max_abs_err=errs[name], ms=ms, plain_ms=pms,
                         bound_ms=b_bytes, bound_by="bytes", library_ms=None, graph_ms=gms))
        print(f"[times] {card} | {name}: kernel {ms:.4f} ms (median of {TIME_LOOPS} loops of "
              f"{TIME_LAUNCHES}; min {ms_min:.4f}, max {ms_max:.4f}; {gms:.4f} ms replayed from "
              f"a CUDA graph), plain {pms:.2f} ms, bound {b_bytes:.6f} ms ({byts} B), "
              f"{counts[name]} launches in the block", flush=True)
    dd = DeviceFixedDecoder(cfg, B, device=dev)
    dec_ms = cuda_ms(lambda: dd.decode_block(frames), 1)
    print(f"[times] {card} | DeviceFixedDecoder.decode_block B={B} T={T}: {dec_ms:.1f} ms, "
          f"{T * B / (dec_ms / 1e3) / 100.0:.1f} real-time 10 ms streams", flush=True)
    print(f"[fixed] phase 8 took {time.time() - t_start:.1f} s", flush=True)
    return rows


# the file tools (phase 9): a 2-channel WAV of FILE_FRAMES frames, at
# FILE_RATE in total (64 kbps a channel); at EP3 FILE_EP_RATE gives a 100-byte
# slot a channel, coded per channel with partial-concealment codewords; the
# loss pattern holds a burst of 9 frames and a later single loss; ccConvert packs
# into CC_SLOT-byte slots at EP CC_MODE. The commands run with -device cpu take
# 2-3 s a frame, the most of this script's time: FILE_FRAMES stays small.
FILE_FRAMES = 24
FILE_RATE = 128000
FILE_EP_RATE = 160000
CC_SLOT, CC_MODE = 100, 3


def plc_main_bytes(args) -> int:
    """Bytes plc_main needs on this launch's data: a stream reads one row
    (its spectrum, or on a lost frame the history) and writes two (the
    spectrum and the history), reads four scalars and writes three; the
    generator's table is read once."""
    B, N = args[1].shape
    return B * N * 4 * 3 + B * 7 * 4 + 2 * (N + 1) * 4


def standard_concealment_phase(dev, frames, bfi, K, card) -> list:
    """Phase 9 (a): decode_block at plc_mode 0 over phase 7's payloads and
    loss plan; plc_main against its plain version on every launch and on
    synthetic rows; 12 streams card against the port on the CPU, stage by
    stage; times. Returns the kernel row of plc_main."""
    import numpy as np
    import torch
    import audio_codec_torch as P
    from audio_codec_torch.ops import plc
    from tests import torch_kernel_cases as C
    t_start = time.time()
    T, B = frames.shape[0], frames.shape[1]
    cfg = P.Config(fs_in=48000, bitrate=64000)

    # the main path's run, its launch counts
    ds = P.dec_state_init(cfg, B, device=dev)
    torch.cuda.synchronize()
    K.reset_launch_counts()
    ds, out = P.decode_block(cfg, ds, frames, bfi)
    torch.cuda.synchronize()
    counts = dict(K.launches)
    print(f"[plc0] decode_block at plc_mode 0 over phase 7's loss plan, B={B} T={T}: launches "
          f"{counts}", flush=True)
    check(counts["plc_main"] == T, f"plc_main launched {counts['plc_main']} times, not {T}")
    check(tuple(out.shape) == (T, B, 480) and bool(torch.isfinite(out).all()),
          "plc_mode 0 PCM not finite or of the wrong shape")

    # every launch against its plain version, the branches taken
    rec: dict = {}
    with recording(rec, ["plc_main", "imdct"]):
        P.decode_block(cfg, P.dec_state_init(cfg, B, device=dev), frames, bfi)
    torch.cuda.synchronize()
    n = transforms_equal(rec, "plc_mode 0")
    print(f"[plc0] imdct: {n} launches equal their plain version bit for bit", flush=True)
    hist, busiest, err = {}, None, 0.0
    for args, kw in rec["plc_main"]:
        got, ref = K.plc_main(*args, **kw), plc.plc_main_plain(*args, **kw)
        same_bits(got, ref, "plc_main")
        err = max(err, max(float((g.double() - r.double()).abs().max()) for g, r in zip(got, ref)))
        for k, v in C.plc_main_branches(args[3].cpu(), args[4].cpu()).items():
            hist[k] = hist.get(k, 0) + v
        lost = int((args[3] == 1).sum())
        if busiest is None or lost > busiest[0]:
            busiest = (lost, args, kw)
    print(f"[plc0] plc_main: {len(rec['plc_main'])} launches equal their plain version bit for "
          f"bit; stream-frames per branch {hist}", flush=True)
    check(all(v > 0 for v in hist.values()), f"plc_main: a branch never occurred: {hist}")
    syn = {}
    for seed in (0, 1):
        d = C.plc_main_rows(seed)
        args = (cfg, *(torch.from_numpy(d[k]).to(dev) for k in C.PLC_MAIN_ORDER))
        same_bits(K.plc_main(*args), plc.plc_main_plain(*args), "plc_main (synthetic rows)")
        for k, v in C.plc_main_branches(d["bfi"], d["nb_lost"]).items():
            syn[k] = syn.get(k, 0) + v
    print(f"[plc0] plc_main on the synthetic rows (seeds -32768, 32767, 32768) equals its plain "
          f"version; branches {syn}", flush=True)

    # a few streams: the kernel path against the plain path, and the card
    # against the port on the CPU, stage by stage
    nb = min(12, B)
    fr_s, bfi_s = frames[:, :nb].contiguous(), bfi[:, :nb].contiguous()
    trace_k, trace_c = [], []
    with stage_trace(trace_k):
        _, out_k = P.decode_block(cfg, P.dec_state_init(cfg, nb, device=dev), fr_s, bfi_s)
    with plain_path():
        _, out_p = P.decode_block(cfg, P.dec_state_init(cfg, nb, device=dev), fr_s, bfi_s)
    cpu = torch.device("cpu")
    with stage_trace(trace_c):
        _, out_c = P.decode_block(cfg, P.dec_state_init(cfg, nb, device=cpu), fr_s.cpu(),
                                  bfi_s.cpu())
    first, per_stage = first_difference(trace_k, trace_c)
    print(f"[plc0] card vs CPU port at plc_mode 0, decoder stage by stage over {len(trace_k)} "
          f"stage calls: first difference {first} (stage, call, output, element, card, cpu, "
          f"ulps); stage calls that differ {per_stage}", flush=True)
    pk = P.round_pcm(out_k).to(torch.int32)
    gap_p = int((pk - P.round_pcm(out_p).to(torch.int32)).abs().max())
    gap_c = (pk.cpu() - P.round_pcm(out_c).to(torch.int32)).abs()
    print(f"[plc0] {nb} streams x {T} frames at plc_mode 0: kernel path vs plain path on the "
          f"card max |PCM diff| {gap_p}; card vs the port on the CPU max |PCM diff| "
          f"{int(gap_c.max())}, {int((gap_c > 0).sum())} of {gap_c.numel()} samples differ",
          flush=True)
    check(gap_p <= 1, f"plc_mode 0 PCM of the kernel path differs by {gap_p} > 1")
    check(int(gap_c.max()) <= CPU_PCM_TOL,
          f"plc_mode 0 PCM differs from the CPU port's by {int(gap_c.max())}")

    # times: the kernel on its busiest launch, the lossy block against a clean one
    lost, args, kw = busiest
    fn = lambda: K.plc_main(*args, **kw)
    ms, ms_min, ms_max = cuda_ms_spread(fn)
    gms = graph_ms(fn)
    pms = cuda_ms(lambda: plc.plc_main_plain(*args, **kw), 2)
    byts = plc_main_bytes(args)
    bound = byts / HBM_BYTES_PER_S * 1e3
    src, replaces = KERNEL_INFO["plc_main"]
    row = dict(name="plc_main", route="cuda", source=src, replaces=replaces,
               launches=counts["plc_main"], max_abs_err=err, ms=ms, plain_ms=pms,
               bound_ms=bound, bound_by="bytes", library_ms=None, graph_ms=gms)
    print(f"[times] {card} | plc_main: kernel {ms:.4f} ms (median of {TIME_LOOPS} loops of "
          f"{TIME_LAUNCHES}; min {ms_min:.4f}, max {ms_max:.4f}; {gms:.4f} ms replayed from a "
          f"CUDA graph), plain {pms:.2f} ms, bound {bound:.6f} ms ({byts} B) on its busiest "
          f"launch ({lost} of {B} streams lost), {counts['plc_main']} launches in the block",
          flush=True)
    ds0 = P.dec_state_init(cfg, B, device=dev)
    clean = torch.zeros_like(bfi)
    for what, b_ in (("lossy", bfi), ("clean", clean)):
        ms = cuda_ms(lambda: P.decode_block(cfg, ds0, frames, b_), 1)
        print(f"[times] {card} | decode_block at plc_mode 0, {what} (phase 7's loss plan"
              f"{'' if what == 'lossy' else ' off'}), B={B} T={T}: {ms:.1f} ms, "
              f"{T * B / (ms / 1e3) / 100.0:.1f} real-time 10 ms streams", flush=True)
    print(f"[plc0] phase 9 (a) took {time.time() - t_start:.1f} s", flush=True)
    return [row]


def file_tools_phase(card) -> None:
    """Phase 9 (b): the CLI and ccConvert as subprocesses on the card (no
    -device: the default) and with -device cpu on a 2-channel WAV. The card
    runs its commands one after another; the CPU's run beside them, one
    thread each, on the card's files where they decode or convert, so that
    each pair reads the same input. Checks: the card's encdec equals its
    -E then -D over the same loss pattern; the payload frames of the two
    devices differ in at most CPU_FRAMES_DIFFER_MAX of them; PCM decoded
    from the same bitstream within CPU_PCM_TOL, the concealment flags
    (-edf, -ep_dbg) equal; ccConvert's packed bytes equal, and unpacking
    the packed stream gives back the input's frames."""
    import os
    import shutil
    import threading
    import numpy as np
    from audio_codec_torch.ops import fec
    from audio_codec_torch.utils import bitstream_io as bio, wavio
    t_start = time.time()
    frames = FILE_FRAMES
    work = ROOT / "build" / "chip_smoke_files"
    shutil.rmtree(work, ignore_errors=True)
    work.mkdir(parents=True)
    n = frames * 480
    speech = read_wav(ROOT / "material" / "speech48.wav")
    music = read_wav(ROOT / "material" / "music48.wav")
    wavio.write_wav(work / "in.wav", np.stack([speech[48000: 48000 + n],
                                               music[96000: 96000 + n]], 1).astype(np.int16),
                    48000)
    pattern = np.zeros(frames, "<i2")
    pattern[frames // 5: frames // 5 + 9] = 1
    pattern[2 * frames // 3] = 1
    pattern.tofile(work / "loss.epf")
    cc_rate = fec.fec_get_data_size(CC_MODE, 0, CC_SLOT) * 8 * 100 * 2
    w = lambda name: str(work / name)
    # (name, tool, arguments with {dev} for this device's files and {card}
    # for the card's, when the CPU repeats it: at the start, after the card's
    # step that writes its input, or not at all)
    steps = [
        ("E", "cli", ["-E", w("in.wav"), "{dev}s.bin", str(FILE_RATE)], "start"),
        ("E epmode 3", "cli", ["-E", "-epmode", "3", w("in.wav"), "{dev}ep3.bin",
                               str(FILE_EP_RATE)], "start"),
        ("E G.192", "cli", ["-E", "-formatG192", w("in.wav"), "{dev}s.g192", str(FILE_RATE)],
         None),
        ("E for ccConvert", "cli", ["-E", w("in.wav"), "{dev}cc_in.bin", str(cc_rate)], None),
        ("ccConvert -pack", "ccconvert", ["-pack", str(CC_SLOT), str(CC_MODE),
                                          "{card}cc_in.bin", "{dev}cc_packed.bin"],
         "E for ccConvert"),
        ("encdec", "cli", ["-epf", w("loss.epf"), w("in.wav"), "{dev}encdec.wav",
                           str(FILE_RATE)], None),
        ("D", "cli", ["-D", "-epf", w("loss.epf"), "-edf", "{dev}s.edf", "-ep_dbg",
                      "{dev}s_dbg", "{card}s.bin", "{dev}s.wav"], "E"),
        ("D G.192", "cli", ["-D", "-formatG192", "{card}s.g192", "{dev}g192.wav"], "E G.192"),
        ("D epmode 3", "cli", ["-D", "-ep_dbg", "{dev}ep3_dbg", "{card}ep3.bin",
                               "{dev}ep3.wav"], "E epmode 3"),
        ("ccConvert -unpack", "ccconvert", ["-unpack", "{card}cc_packed.bin",
                                            "{dev}cc_unpacked.bin"], "ccConvert -pack"),
    ]
    module = {"cli": "audio_codec_torch.cli", "ccconvert": "audio_codec_torch.ccconvert"}

    def command(tool, args, dev):
        flag = [] if dev == "card" else ["-device", "cpu"]
        quiet = ["-q"] if tool == "cli" else []
        args = [a.replace("{dev}", w(dev + "_")).replace("{card}", w("card_")) for a in args]
        return [sys.executable, "-m", module[tool], *quiet, *flag, *args]

    cpu_env = dict(os.environ, OMP_NUM_THREADS="1", MKL_NUM_THREADS="1")
    cpu_jobs, times = {}, {}

    def start_cpu(when):
        for i, (name, tool, args, cpu) in enumerate(steps):
            if cpu != when:
                continue
            t0 = time.time()
            with open(work / f"cpu_{i}.log", "w") as log:
                p = subprocess.Popen(command(tool, args, "cpu"), cwd=ROOT, env=cpu_env,
                                     stdout=log, stderr=subprocess.STDOUT)

            def wait(p=p, name=name, t0=t0):   # the command's own end
                p.wait()
                times[("cpu", name)] = time.time() - t0
            waiter = threading.Thread(target=wait)
            waiter.start()
            cpu_jobs[name] = (p, waiter, work / f"cpu_{i}.log")

    try:
        start_cpu("start")
        for name, tool, args, _ in steps:
            t0 = time.time()
            r = subprocess.run(command(tool, args, "card"), cwd=ROOT, capture_output=True,
                               text=True)
            times[("card", name)] = time.time() - t0
            check(r.returncode == 0, f"{name} on the card failed:\n{(r.stdout + r.stderr)[-3000:]}")
            start_cpu(name)       # the CPU's repeats that read this step's files
        for name, (p, waiter, log) in cpu_jobs.items():
            waiter.join()
            check(p.returncode == 0, f"{name} on the CPU failed:\n{log.read_text()[-3000:]}")
    finally:
        for p, waiter, _ in cpu_jobs.values():
            if p.poll() is None:
                p.kill()
            waiter.join()

    for name, _, _, cpu in steps:
        on_cpu = f"CPU {times[('cpu', name)] * 1e3 / frames:.1f} ms a frame (one thread)" \
            if cpu else "not repeated on the CPU"
        print(f"[files] {card} | {name}: card {times[('card', name)] * 1e3 / frames:.1f} ms a "
              f"frame, {on_cpu} (whole command, process start included, {frames} frames of 2 "
              f"channels)", flush=True)

    pcm = lambda name: wavio.read_wav(w(name))[0].astype(np.int32)
    shape = pcm("card_encdec.wav").shape
    check(len(shape) == 2 and shape[1] == 2 and n - 480 < shape[0] <= n,
          f"encdec output of shape {shape}")
    same = (work / "card_encdec.wav").read_bytes() == (work / "card_s.wav").read_bytes()
    print(f"[files] card: encdec with -epf equals -E then -D -epf: {same}", flush=True)
    check(same, "the card's encdec output differs from its -E then -D output")
    for ext in ("s.bin", "ep3.bin"):
        hc, fc = bio.read_all(w("card_" + ext))
        hp, fp = bio.read_all(w("cpu_" + ext))
        check(hc == hp and len(fc) == len(fp) == frames, f"{ext}: headers or frame counts differ")
        differ = sum(a != b for a, b in zip(fc, fp))
        print(f"[files] {ext}: {differ} of {frames} payload frames differ card vs CPU", flush=True)
        check(differ <= CPU_FRAMES_DIFFER_MAX * frames, f"{ext}: {differ} payload frames differ")
    with open(w("card_s.g192"), "rb") as f:
        g192 = [fr for fr, _ in iter(lambda: bio.read_g192_frame(f), (None, 0))]
    same = g192 == bio.read_all(w("card_s.bin"))[1]
    print(f"[files] card: the G.192 stream carries the container's frames: {same}", flush=True)
    check(same, "the card's G.192 frames differ from its container frames")
    for name in ("s.wav", "g192.wav", "ep3.wav"):
        a, b = pcm("card_" + name), pcm("cpu_" + name)
        check(a.shape == b.shape == shape, f"{name}: shapes {a.shape} {b.shape}")
        gap = np.abs(a - b)
        print(f"[files] {name} (decoded from the card's bitstream): card vs CPU max |PCM diff| "
              f"{int(gap.max())}, {int((gap > 0).sum())} of {gap.size} samples differ",
              flush=True)
        check(int(gap.max()) <= CPU_PCM_TOL, f"{name}: PCM differs by {int(gap.max())}")
    edf = np.fromfile(w("card_s.edf"), "<i2")
    print(f"[files] -edf: {int(edf.sum())} of {frames} frames concealed "
          f"(pattern {int(pattern.sum())})", flush=True)
    check(bool((edf[pattern != 0] == 1).all()), "-edf misses a frame of the loss pattern")
    for f in ("s.edf", "s_dbg.bfi", "s_dbg.epmr", "s_dbg.error_report", "ep3_dbg.bfi",
              "ep3_dbg.epmr", "ep3_dbg.error_report"):
        check((work / ("card_" + f)).read_bytes() == (work / ("cpu_" + f)).read_bytes(),
              f"{f} differs card vs CPU")
    print("[files] -edf and -ep_dbg files equal card vs CPU", flush=True)
    packed = (work / "card_cc_packed.bin").read_bytes()
    check(packed == (work / "cpu_cc_packed.bin").read_bytes(),
          "ccConvert -pack: the card's bytes differ from the CPU's")
    h_in, f_in = bio.read_all(w("card_cc_in.bin"))
    hp, fpk = bio.read_all(w("card_cc_packed.bin"))
    check(hp.epmode == CC_MODE and all(len(f) == 2 * CC_SLOT for f in fpk),
          f"ccConvert -pack: epmode {hp.epmode}, frame sizes {sorted({len(f) for f in fpk})}")
    for dev in ("card", "cpu"):
        hu, fu = bio.read_all(w(dev + "_cc_unpacked.bin"))
        check(fu == f_in and hu.epmode == 0, f"ccConvert: unpack(pack(x)) != x ({dev})")
    print(f"[files] ccConvert -pack {CC_SLOT} {CC_MODE}: card and CPU bytes identical "
          f"({len(packed)} bytes), unpack(pack(x)) == x on both", flush=True)
    print(f"[files] phase 9 (b) took {time.time() - t_start:.1f} s", flush=True)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--streams", type=int, default=2048)
    ap.add_argument("--frames", type=int, default=8)
    ap.add_argument("--seed", type=int, default=0)
    opt = ap.parse_args()

    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    if not (ROOT / "audio_codec_torch").is_dir():
        print("chip_smoke: audio_codec_torch not found beside chip_smoke.py", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    import audio_codec_torch as P
    from audio_codec_torch import kernels as K
    from audio_codec_torch.ops import analysis, ari, bits as side, ltpf_dec, pc, plc, quant, sns
    from audio_codec_torch.ops import tns, transforms

    # ---- 1. card ----
    try:
        smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True)
        card = smi.stdout.strip().splitlines()[0] if smi.returncode == 0 else "nvidia-smi failed"
    except FileNotFoundError:
        card = "nvidia-smi not found"
    kind = torch.cuda.get_device_name(0)
    print(f"[card] {card} | torch: {kind} | torch {torch.__version__} cuda {torch.version.cuda}",
          flush=True)

    # ---- 2. build ----
    t0 = time.time()
    _, log = K.build()
    K.library()
    print(f"[build] {len(K.SOURCES)} sources in {time.time() - t0:.1f} s", flush=True)
    for line in log.splitlines():
        if "registers" in line or "bytes stack" in line or line.startswith("=="):
            print("[build] " + line.strip(), flush=True)

    cfg = P.Config(fs_in=48000, bitrate=64000)
    B, T = opt.streams, opt.frames
    dev = torch.device("cuda")
    pcm = torch.from_numpy(make_pcm(T, B, cfg.frame_length, opt.seed)).to(dev)

    # ---- 3. kernels against their plain versions, on main-path inputs ----
    t_phase = [time.time()]

    def phase_took(n: int):
        print(f"[time] phase {n} took {time.time() - t_phase[0]:.1f} s", flush=True)
        t_phase[0] = time.time()
    # every launch of a T-frame run is compared: LTPF is off in every stream
    # at frame 0, and the encoder calls bit_estimate in two modes
    rec: dict = {}
    with recording(rec):
        st = P.enc_state_init(cfg, B, device=dev)
        st, frames = P.encode_block(cfg, st, pcm)
        ds = P.dec_state_init(cfg, B, device=dev)
        P.decode_block(cfg, ds, frames)
    torch.cuda.synchronize()
    MAIN = [k for k in K.KERNELS if k not in STREAM_KERNELS + PLC_KERNELS + FIXED_KERNELS]
    calls = {MAIN_CALL.get(k, k) for k in MAIN}
    check(set(rec) == calls, f"kernels not reached on the main path: {calls - set(rec)}")
    modes = sorted({args[3] for args, _ in rec["bit_estimate"]})
    check(modes == sorted({-1, cfg.modeFlag}), f"bit_estimate modes launched: {modes}")
    cases = ltpf_case_counts(rec["ltpf_decode"])
    print(f"[kernels] ltpf_decode stream-frames per case over {T} frames: {cases}", flush=True)
    check(all(v > 0 for v in cases.values()), f"an LTPF case never occurred: {cases}")
    for name in ("tns_analysis_lattice", "tns_synthesis_lattice"):
        orders = torch.cat([args[2] for args, _ in rec[name]]).flatten()
        hist = torch.bincount(orders.clamp(0, 8).long(), minlength=9).tolist()
        print(f"[kernels] {name}: filters of order 0..8 over {T} frames: {hist}", flush=True)
        check(hist[8] > 0, f"{name}: no filter of order 8 on the main path")
    # the material must reach every SNS submode, LTPF on and off, and frames
    # with one and with two TNS filters (fields of per-stream width)
    sent = [args for args, _ in rec["side_info_pack"]]
    submodes = torch.bincount(torch.cat([a[8][:, 2] for a in sent]).long(), minlength=4).tolist()
    filters = torch.bincount(torch.cat([a[5] for a in sent]).long(), minlength=3).tolist()
    ltpf_flags = torch.bincount(torch.cat([a[7][:, 0] for a in sent]).long(), minlength=2).tolist()
    print(f"[kernels] side information over {T} frames: SNS submodes 0..3 {submodes}, "
          f"TNS filters 0..2 {filters}, LTPF off/on {ltpf_flags}", flush=True)
    check(len(submodes) == 4 and all(v > 0 for v in submodes),
          f"an SNS submode never occurred: {submodes}")
    check(filters[1] > 0 and filters[2] > 0, f"one or two TNS filters never occurred: {filters}")
    check(all(v > 0 for v in ltpf_flags), f"LTPF was never on or never off: {ltpf_flags}")
    plain = {"bit_estimate": quant.bit_estimate_plain, "ari_encode": ari.encode_plain,
             "ari_decode": ari.decode_plain, "ari_decode_frames": ari.parse_and_decode_plain,
             "ltpf_decode": ltpf_dec.ltpf_decode_plain,
             "gain_bisection": quant.gain_bisection_plain,
             "tns_analysis_lattice": tns.tns_analysis_lattice_plain,
             "tns_synthesis_lattice": tns.tns_synthesis_lattice_plain,
             "hp50_biquad": analysis.hp50_biquad_plain,
             "side_info_pack": side.pack_side_info_plain,
             "sns_vq_dec": sns.sns_vq_dec_plain, "sns_vq_enc": sns.sns_vq_enc_plain,
             "tns_filter_analysis": tns.tns_filter_analysis_plain,
             "pc_classify": pc.pc_classify_plain, "mdct": transforms.mdct_plain,
             "imdct": transforms.imdct_plain, "olpa": analysis.olpa_plain,
             "ltpf_encode": analysis.ltpf_encode_plain,
             "noise_residual_enc": quant.noise_residual_enc_plain,
             "spec_decode": quant.spectrum_decode_plain, "plc_main": plc.plc_main_plain}
    tns_on = torch.zeros((2, 2), dtype=torch.long)
    branches = None
    branch_hist: dict = {}
    errs = {}
    for kernel in MAIN:
        name, err = MAIN_CALL.get(kernel, kernel), 0.0
        for args, kw in rec[name]:
            got = getattr(K, name)(*args, **kw)
            ref = plain[name](*args, **kw)
            torch.cuda.synchronize()
            e = max(float((g.to(torch.float64) - r.to(torch.float64)).abs().max())
                    for g, r in paired(got, ref))
            same_bits(got, ref, f"{name} (max |diff| {e})")
            err = max(err, e)
            if name == "tns_filter_analysis":
                tns_on += tns_on_off(got)
            if name == "pc_classify":
                b = pc_branch_counts(args, got)
                branches = b if branches is None else {k: branches[k] + b[k] for k in b}
            if name in BRANCHED_KERNELS:
                b = branch_counts(name, args, got)
                old = branch_hist.get(name, {})
                branch_hist[name] = {k: old.get(k, 0) + v for k, v in b.items()}
        errs[kernel] = err
        what = f"modes {modes}" if name == "bit_estimate" else ""
        shape = next(tuple(a.shape) for a in rec[name][0][0] if isinstance(a, torch.Tensor))
        print(f"[kernels] {name}: max |kernel - plain| = {err} over {len(rec[name])} "
              f"launches at {shape} {what}", flush=True)

    print(f"[kernels] tns_filter_analysis over {T} frames: filter 0 off/on "
          f"{tns_on[0].tolist()}, filter 1 off/on {tns_on[1].tolist()}", flush=True)
    check(bool((tns_on > 0).all()), f"TNS never on or never off in a filter: {tns_on.tolist()}")
    print(f"[kernels] pc_classify branches over {T} frames: {branches}", flush=True)
    for name in BRANCHED_KERNELS:
        print(f"[kernels] {name} branches over {T} frames: {branch_hist[name]}", flush=True)
    # what clean material reaches of the four: the synthetic rows take the rest
    needed = {"olpa": ("window taken", "window not taken"),
              "ltpf_encode": ("searched", "not searched", "fresh alone"),
              "noise_residual_enc": ("zero lines",), "spec_decode": ("bfi 0", "residual")}
    for name, keys in needed.items():
        check(all(branch_hist[name][k] > 0 for k in keys),
              f"{name}: a branch the material reaches was not taken: {branch_hist[name]}")
    synthetic_cases(cfg, dev, K, side, sns)
    slice4_cases(cfg, dev, K, rec, card)
    pitch_and_spectrum_cases(cfg, dev, K)
    tns_lattice_cases(dev, K, rec)
    coder_cases(dev, K, rec)
    rate_cases(dev, K)
    decode_cases(dev, K)

    phase_took(3)
    # ---- 4. the main path ----
    st = P.enc_state_init(cfg, B, device=dev)
    ds = P.dec_state_init(cfg, B, device=dev)
    torch.cuda.synchronize()
    K.reset_ari_encode_lane0_streams(dev)
    K.reset_launch_counts()
    st, frames = P.encode_block(cfg, st, pcm)
    ds, out = P.decode_block(cfg, ds, frames)
    torch.cuda.synchronize()
    counts = dict(K.launches)
    lane0 = K.ari_encode_lane0_streams(dev)
    print(f"[main] encode_block + decode_block at B={B} T={T}: launches {counts}; ari_encode "
          f"streams on its lane-0 path {lane0} of {T * B}", flush=True)
    check(lane0 == 0, f"ari_encode took its lane-0 path on {lane0} main-path streams")
    check(all(counts[k] > 0 for k in MAIN), f"a kernel was not launched: {counts}")
    check(counts["plc_main"] == T, f"plc_main launched {counts['plc_main']} times, not {T}")
    check(tuple(frames.shape) == (T, B, cfg.targetBytes) and frames.dtype == torch.uint8,
          f"payload shape {tuple(frames.shape)}")
    check(tuple(out.shape) == (T, B, cfg.frame_length) and bool(torch.isfinite(out).all()),
          "decoded PCM not finite or of the wrong shape")
    pcm16 = P.round_pcm(out)

    # a few streams over all T frames: the kernel path against the plain
    # path on the card, then the card against the port on the CPU (the
    # path the tests hold against the reference)
    nb = min(12, B)
    small = pcm[:, :nb].contiguous()
    rec_k: dict = {}
    etrace_k, etrace_c = [], []
    with recording(rec_k):
        st_k = P.enc_state_init(cfg, nb, device=dev)
        with stage_trace(etrace_k, ENCODER_STAGES):
            st_k, fr_k = P.encode_block(cfg, st_k, small)
        _, out_k = P.decode_block(cfg, P.dec_state_init(cfg, nb, device=dev), fr_k)
    with plain_path():
        st_p = P.enc_state_init(cfg, nb, device=dev)
        st_p, fr_p = P.encode_block(cfg, st_p, small)
        _, out_p = P.decode_block(cfg, P.dec_state_init(cfg, nb, device=dev), fr_p)
    torch.cuda.synchronize()
    pcm16_k = P.round_pcm(out_k).to(torch.int32)
    ltpf_on = ltpf_case_counts(rec_k["ltpf_decode"])["on"]
    bytes_equal = bool(torch.equal(fr_k, fr_p))
    pcm_diff = int((pcm16_k - P.round_pcm(out_p).to(torch.int32)).abs().max())
    print(f"[main] kernel path vs plain path on the card, {nb} streams x {T} frames: "
          f"payload identical {bytes_equal}, max |PCM diff| {pcm_diff}, "
          f"LTPF on in {ltpf_on} stream-frames", flush=True)
    check(ltpf_on > 0, "the LTPF post-filter was never on in the compared streams")
    check(bytes_equal, "payload bytes of the kernel path differ from the plain path")
    check(pcm_diff <= 1, f"PCM of the kernel path differs by {pcm_diff} > 1")

    cpu = torch.device("cpu")
    with stage_trace(etrace_c, ENCODER_STAGES):
        _, fr_c = P.encode_block(cfg, P.enc_state_init(cfg, nb, device=cpu), small.cpu())
    _, out_c = P.decode_block(cfg, P.dec_state_init(cfg, nb, device=cpu), fr_k.cpu())
    frames_differ = int((fr_c != fr_k.cpu()).any(dim=-1).sum())
    gap = (P.round_pcm(out_c).to(torch.int32) - pcm16_k.cpu()).abs()
    print(f"[main] card vs the port on the CPU, {nb} streams x {T} frames: "
          f"{frames_differ} of {nb * T} payload frames differ (encode), "
          f"decode of the card's payloads: max |PCM diff| {int(gap.max())}, "
          f"{int((gap > 0).sum())} of {gap.numel()} samples differ", flush=True)
    check(frames_differ <= CPU_FRAMES_DIFFER_MAX * nb * T,
          f"{frames_differ} payload frames differ from the CPU port's")
    check(int(gap.max()) <= CPU_PCM_TOL, f"PCM differs from the CPU port's by {int(gap.max())}")
    # where the card's encode first departs from the CPU port's (a record:
    # the encoder keeps the card's own order, the MDCT's blocked sum first)
    first_e, per_stage_e = first_difference(etrace_k, etrace_c, may_diverge=True)
    print(f"[main] card vs CPU port, encoder stage by stage over {len(etrace_k)} stage calls: "
          f"first difference {first_e} (stage, call, output, element, card, cpu, ulps); "
          f"stage calls that differ {per_stage_e}; payload bytes that differ "
          f"{int((fr_c != fr_k.cpu()).sum())} of {fr_c.numel()}", flush=True)
    # where the card's decode first departs from the CPU port's: every
    # decoder stage of the same payloads, payload-side stages exactly, float
    # stages with the first differing element and its distance in ulps
    trace_k, trace_c = [], []
    with stage_trace(trace_k):
        P.decode_block(cfg, P.dec_state_init(cfg, nb, device=dev), fr_k)
    with stage_trace(trace_c):
        P.decode_block(cfg, P.dec_state_init(cfg, nb, device=cpu), fr_k.cpu())
    first, per_stage = first_difference(trace_k, trace_c)
    print(f"[main] card vs CPU port, decoder stage by stage over {len(trace_k)} stage calls: "
          f"first difference {first} (stage, call, output, element, card, cpu, ulps); "
          f"stage calls that differ {per_stage}", flush=True)
    ref = pcm.cpu().numpy()
    snr_rows = []
    for b in range(min(B, 6)):
        if b % 3 == 2:
            continue
        snr, lag = segmental_snr(ref[:, b].reshape(-1), pcm16[:, b].cpu().numpy().reshape(-1).astype(np.float32),
                                 cfg.frame_length)
        snr_rows.append(snr)
    print(f"[main] segmental SNR of decoded material: {['%.2f dB' % s for s in snr_rows]} "
          f"(lag {lag} samples)", flush=True)

    phase_took(4)
    # ---- 5. times ----
    rows = []
    for kernel in (k for k in MAIN if k not in PLC0_KERNELS):
        name = MAIN_CALL.get(kernel, kernel)
        args, kw = rec[name][-1]   # the last frame's launch
        ms, ms_min, ms_max = cuda_ms_spread(lambda: getattr(K, name)(*args, **kw))
        gms = graph_ms(lambda: getattr(K, name)(*args, **kw))
        pms = cuda_ms(lambda: plain[name](*args, **kw), 2)
        outs = outputs(getattr(K, name)(*args, **kw))
        byts = kernel_bytes(name, args, outs)
        lib_ms = None
        if name in ("mdct", "imdct"):
            # the library's product of the same rows by the same matrix
            lib_ms = matmul_ms(args[1])
        ops = work_ops(name, args)
        b_bytes, b_ops = byts / HBM_BYTES_PER_S * 1e3, ops / SCALAR_OPS_PER_S * 1e3
        src, replaces = KERNEL_INFO[kernel]
        rows.append(dict(name=kernel, route="cuda", source=src, replaces=replaces,
                         launches=counts[kernel], max_abs_err=errs[kernel], ms=ms, plain_ms=pms,
                         bound_ms=max(b_bytes, b_ops),
                         bound_by="bytes" if b_bytes >= b_ops else "operations",
                         library_ms=lib_ms, graph_ms=gms))
        print(f"[times] {card} | {name}: kernel {ms:.4f} ms (median of {TIME_LOOPS} loops of "
              f"{TIME_LAUNCHES}; min {ms_min:.4f}, max {ms_max:.4f}; {gms:.4f} ms replayed from "
              f"a CUDA graph), plain {pms:.2f} ms, "
              + (f"torch.matmul {lib_ms:.4f} ms, " if lib_ms is not None else "") +
              f"bound {max(b_bytes, b_ops):.6f} ms ({byts} B, {ops:.3g} ops)", flush=True)

    # the TDAC's compensated MDCT on the encoder's rows (its row in the
    # kernels line comes from phase 7, whose decode launches it)
    args, _ = rec["mdct"][-1]
    fn = lambda: K.mdct_compensated(*args)
    ms, ms_min, ms_max = cuda_ms_spread(fn)
    print(f"[times] {card} | mdct_compensated on mdct's rows: kernel {ms:.4f} ms (min "
          f"{ms_min:.4f}, max {ms_max:.4f}; {graph_ms(fn):.4f} ms replayed from a CUDA graph), "
          f"torch.matmul {matmul_ms(args[1]):.4f} ms", flush=True)

    st = P.enc_state_init(cfg, B, device=dev)
    ds = P.dec_state_init(cfg, B, device=dev)
    enc_ms = cuda_ms(lambda: P.encode_block(cfg, st, pcm), 1)
    dec_ms = cuda_ms(lambda: P.decode_block(cfg, ds, frames), 1)
    for what, ms in (("encode_block", enc_ms), ("decode_block", dec_ms)):
        streams = T * B / (ms / 1e3) / 100.0
        print(f"[times] {card} | {what} B={B} T={T}: {ms:.1f} ms, "
              f"{streams:.1f} real-time 10 ms streams", flush=True)

    phase_took(5)
    # ---- 6. the stream path ----
    rows += stream_phase(dev, pcm[:STREAM_FRAMES], K, plain, card)

    phase_took(6)
    # ---- 7. the concealment path ----
    plc_rows, plc_frames, plc_bfi = concealment_phase(dev, opt, K, card)
    rows += plc_rows

    phase_took(7)
    # ---- 8. the bit-exact fixed-point decoder ----
    rows += fixed_phase(dev, frames, K, card)

    phase_took(8)
    # ---- 9. the standard concealment and the file tools ----
    rows += standard_concealment_phase(dev, plc_frames, plc_bfi, K, card)
    file_tools_phase(card)

    phase_took(9)
    # ---- 10. kernels line ----
    print(json.dumps({"kernels": rows}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except Failed as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
        sys.exit(1)
