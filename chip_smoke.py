#!/usr/bin/env python3
"""Smoke run of audio_codec_torch on one CUDA card.

Drives the port's main path, the 48 kHz / 10 ms / 64 kbps encoder and
decoder (`encode_block` then `decode_block`), through the CUDA kernels of
audio_codec_torch/csrc, and checks it:

  1. card      name and power limit (nvidia-smi), torch's device name;
  2. build     every kernel from the sources, with nvcc's -Xptxas -v report;
  3. kernels   each kernel against its plain PyTorch version on the card, on
               every launch of a --frames run of the main path (speech,
               music, noise); every kernel but ltpf_postfilter must match
               exactly (bit_estimate in both of its modes), ltpf_postfilter
               within LTPF_TOL on the +-32768 scale; each of the
               post-filter's five cases, TNS filters of order 8, every SNS
               submode 0-3, LTPF on and off, one and two TNS filters in
               the side information, and TNS on and off in both filters
               must occur, and the branches of the pitch analysis, the
               residual coder and the spectrum reconstruction that the
               material reaches are printed; then the side-info parser on
               frames that fire each of its bad-frame triggers, the SNS
               quantizer on all-zero and silent-residual rows, the TNS filter
               analysis on silent, all-zero and order-8 spectra at 64 and 32
               kbps (where the LPC weighting decides), the concealment
               classifier on rows that take each of its branches, the MDCT
               and IMDCT on full-scale, silent and alternating rows at N = 480
               and 160, and the pitch analysis, the LTPF coder, the noise
               factor and residual coder (64 and 16 kbps) and the spectrum
               reconstruction on rows that take each of their branches;
  4. main path encode_block + decode_block at --streams x --frames with the
               launch counters read around it; on a few streams over all
               frames the kernel path's payload must equal the plain path's
               and its PCM must be within +-1, with LTPF on; the same
               streams through the port on the CPU (the path the tests hold
               against the reference) must give the same payloads but for a
               CPU_FRAMES_DIFFER_MAX share, and PCM within +-CPU_PCM_TOL from
               the card's payloads; a segmental SNR of the decoded material;
  5. times     CUDA-event times of each kernel (the median of TIME_LOOPS
               loops of TIME_LAUNCHES launches, with their min and max; and
               the same launches replayed from a CUDA graph, which is the
               device's time where the host launches slower than the kernel
               runs) and of its plain version, for the MDCT and IMDCT the
               library's product (torch.matmul) of the same rows by the
               same matrix, and of the encode and decode blocks, as
               real-time stream equivalents;
  6. a JSON line with one entry per kernel.

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
LTPF_TOL = 1e-2          # |y_kernel - y_plain| on the +-32768 PCM scale
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
    "ltpf_postfilter": ("audio_codec_torch/csrc/ltpf_postfilter.cu",
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
    "side_info_parse": ("audio_codec_torch/csrc/side_info_parse.cu",
                        "audio_codec_tpu/ops/bits.py:123"),
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
    "olpa": ("audio_codec_torch/csrc/olpa.cu", "audio_codec_tpu/ops/analysis.py:77"),
    "ltpf_encode": ("audio_codec_torch/csrc/ltpf_encode.cu",
                    "audio_codec_tpu/ops/analysis.py:163"),
    "noise_residual_enc": ("audio_codec_torch/csrc/noise_residual_enc.cu",
                           "audio_codec_tpu/ops/quant.py:279"),
    "spec_decode": ("audio_codec_torch/csrc/spec_decode.cu",
                    "audio_codec_tpu/models/decoder.py:103"),
}
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


def outputs(res) -> list:
    """A kernel's result as a list of tensors."""
    if isinstance(res, dict):
        return list(res.values())
    return list(res) if isinstance(res, tuple) else [res]


def nbytes(*ts) -> int:
    import torch
    return sum(t.numel() * t.element_size() for t in ts if isinstance(t, torch.Tensor))


@contextlib.contextmanager
def plain_path():
    """Route the kernels' call sites to their plain versions, so the main
    path runs on the card without the kernels (the reference for phase 4)."""
    from audio_codec_torch.ops import analysis, ari, bits, ltpf_dec, pc, quant, sns, tns
    from audio_codec_torch.ops import transforms
    sites = [(transforms, "mdct", transforms.mdct_plain),
             (transforms, "imdct", transforms.imdct_plain),
             (tns, "tns_filter_analysis", tns.tns_filter_analysis_plain),
             (pc, "pc_classify", pc.pc_classify_plain),
             (quant, "bit_estimate", quant.bit_estimate_plain),
             (ari, "encode", lambda cfg, *a: ari.encode_plain(cfg, *a)),
             (ari, "decode", lambda cfg, buf, side, *a, **k: ari.decode_plain(cfg, buf, side)),
             (ltpf_dec, "ltpf_postfilter", ltpf_dec.ltpf_postfilter_plain),
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
             (quant, "spectrum_decode", quant.spectrum_decode_plain)]
    saved = [(mod, name, getattr(mod, name)) for mod, name, _ in sites]
    for mod, name, plain in sites:
        setattr(mod, name, plain)
    try:
        yield
    finally:
        for mod, name, fn in saved:
            setattr(mod, name, fn)


@contextlib.contextmanager
def recording(store: dict):
    """Keep the arguments of every kernel launch, in order, in
    store[kernel name]."""
    from audio_codec_torch import kernels as K
    saved = {n: getattr(K, n) for n in K.KERNELS}

    def wrap(name, fn):
        def rec(*args, **kw):
            store.setdefault(name, []).append((args, kw))
            return fn(*args, **kw)
        return rec
    for n, fn in saved.items():
        setattr(K, n, wrap(n, fn))
    try:
        yield
    finally:
        for n, fn in saved.items():
            setattr(K, n, fn)


def ltpf_case_counts(launches) -> dict[str, int]:
    """Stream-frames of the recorded ltpf_postfilter launches in each of
    the post-filter's cases (the CASE_* bits of its `cases` argument)."""
    from audio_codec_torch.ops import ltpf_dec as L
    bits = {"on->off": L.CASE_B, "off->on": L.CASE_C, "on->on same pitch": L.CASE_D,
            "on->on new pitch": L.CASE_E, "on": L.NEW_ON}
    return {k: sum(int(((args[10] & bit) != 0).sum()) for args, _ in launches)
            for k, bit in bits.items()}


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


def parsed_side_bits(args):
    """side_bits of the frames that this side_info_parse launch reads."""
    from audio_codec_torch import kernels as K
    side = K.side_info_parse(*args)
    return side_bits(args[0], side["num_tns"], side["scf_idx"][:, 2], side["ltpf_param"][:, 0])


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
        _, bfi, inv, stab, pitch, q_d, _ = args
        N = q_d.shape[1]
        active = (bfi == 2) & (inv * 10 < 400) & (stab >= 0.5)
        per = torch.where(pitch == 1, 2 * N + 12 * (N - 5), 4 * N)
        return float(torch.where(active, per, 0).sum())
    if name == "side_info_pack":
        cfg, num_tns, ltpf, scf_idx = args[0], args[5], args[7], args[8]
        return 8 * float(side_bits(cfg, num_tns, scf_idx[:, 2], ltpf[:, 0]).sum())
    if name == "side_info_parse":
        return 8 * float(parsed_side_bits(args).sum())
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
    if name == "ltpf_postfilter":
        x, a1, b1 = args[1], args[4], args[5]
        return float(x.numel() * (4 * (a1.shape[1] + b1.shape[1]) + 20))
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
    if name == "side_info_parse":
        # Of each row the parser needs only the bytes that hold its side
        # bits (one int32 word each), not the whole frame.
        words = torch.div(parsed_side_bits(args) + 7, 8, rounding_mode="floor")
        return 4 * int(words.sum()) + nbytes(*outs)
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
        # the four [B] vectors, and one [N] row of each stream whose frame is
        # partially corrupt in the low region and stable (the peak detector
        # reads q_old_d, the energy path q_old_res)
        _, bfi, inv, stab, _, q_d, _ = args
        rows = int(((bfi == 2) & (inv * 10 < 400) & (stab >= 0.5)).sum())
        return nbytes(*ins[:4], *outs) + 4 * q_d.shape[1] * rows
    return nbytes(*ins, *outs)


def same_bits(got, ref, what: str):
    """got equals ref bit for bit (dicts key for key); two NaNs are equal."""
    from tests.torch_kernel_cases import count_differing
    bad = count_differing(got, ref)
    check(bad == 0, f"{what}: {bad} values differ from the plain version")


def synthetic_cases(cfg, dev, K, side, sns):
    """Cases clean material never reaches (tests/torch_kernel_cases.py):
    frames that fire each of the parser's bad-frame triggers, the quantizer's
    decoder on every submode's first and last index, its encoder on an
    all-zero row and on rows whose residual is silent (every pulse search
    takes its silent-target branch)."""
    import numpy as np
    import torch
    from tests import torch_kernel_cases as C
    g = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)
    cases = {"clean": C.side_fields(cfg, 256, seed=3),
             **{trig: C.corrupt_fields(cfg, trig, 32) for trig in C.BFI_TRIGGERS}}
    for what, f in cases.items():
        args = (cfg, *(g(np.asarray(f[k], np.int32)) for k in C.FIELD_ORDER))
        packed, ref = K.side_info_pack(*args), side.pack_side_info_plain(*args)
        same_bits(packed, ref, f"side_info_pack ({what})")
        got, ref = K.side_info_parse(cfg, packed[0]), side.parse_side_info_plain(cfg, packed[0])
        torch.cuda.synchronize()
        same_bits(got, ref, f"side_info_parse ({what})")
        fired = got["bfi"].tolist()
        check(fired == [0 if what == "clean" else 1] * len(fired),
              f"side_info_parse ({what}): bfi {fired}")
    rows = torch.randint(0, 256, (4096, cfg.targetBytes), device=dev, dtype=torch.int32,
                         generator=torch.Generator(device=dev).manual_seed(1))
    got = K.side_info_parse(cfg, rows)
    same_bits(got, side.parse_side_info_plain(cfg, rows), "side_info_parse (random bytes)")
    print(f"[kernels] side_info_parse: each of {len(C.BFI_TRIGGERS)} bad-frame triggers fires and "
          f"equals the plain version; random bytes: bfi in {int(got['bfi'].sum())} of 4096 rows",
          flush=True)

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
    """Streams of a pc_classify launch in each of the classifier's branches."""
    from tests import torch_kernel_cases as C
    a = {k: v.cpu().numpy() for k, v in zip(C.PC_ORDER, args[1:])}
    return C.pc_branches(a, out.cpu().numpy(), args[0].frame_dms)


def slice4_cases(cfg, dev, K, rec):
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
    args = rec["pc_classify"][-1][0]
    a = C.pc_rows(*(t[:16].cpu().numpy() for t in args[5:7]), seed=3)
    pargs = (cfg, *(g(a[k]) for k in C.PC_ORDER))
    got = K.pc_classify(*pargs)
    same_bits(got, pc.pc_classify_plain(*pargs), "pc_classify (synthetic rows)")
    branches = pc_branch_counts(pargs, got)
    print(f"[kernels] pc_classify synthetic rows ({got.shape[0]} streams): {branches}", flush=True)
    check(all(v > 0 for v in branches.values()), f"a pc_classify branch was not taken: {branches}")
    for fs, bitrate in ((48000, 64000), (16000, 32000)):
        c = P.Config(fs_in=fs, bitrate=bitrate)
        x, mem = C.transform_rows(c.frame_length, c.la_zeroes, seed=4)
        for name in ("mdct", "imdct"):
            targs = (c, g(x), g(mem))
            got = getattr(K, name)(*targs)
            ref = [t.contiguous() for t in getattr(transforms, name + "_plain")(*targs)]
            torch.cuda.synchronize()
            same_bits(got, ref, f"{name} (synthetic rows, N = {c.frame_length})")
            check(bool(torch.isfinite(got[0]).all()), f"{name}: not finite")
    print("[kernels] mdct and imdct on full-scale, silent and alternating rows at N = 480 and "
          "160 equal their plain versions", flush=True)


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
    cfg16 = P.Config(fs_in=48000, bitrate=16000)
    cases = [("olpa", cfg, C.olpa_rows(seed=2), C.OLPA_ORDER, analysis.olpa_plain),
             ("ltpf_encode", cfg, C.ltpf_rows(seed=2), C.LTPF_ORDER, analysis.ltpf_encode_plain),
             ("noise_residual_enc", cfg, C.nre_rows(cfg, seed=3), C.NRE_ORDER,
              quant.noise_residual_enc_plain),
             ("noise_residual_enc", cfg16, C.nre_rows(cfg16, seed=3), C.NRE_ORDER,
              quant.noise_residual_enc_plain),
             ("spec_decode", cfg, C.spec_rows(cfg, seed=4), C.SPEC_ORDER,
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
    from audio_codec_torch.ops import analysis, ari, bits as side, ltpf_dec, pc, quant, sns, tns
    from audio_codec_torch.ops import transforms

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
    # every launch of a T-frame run is compared: LTPF is off in every stream
    # at frame 0, and the encoder calls bit_estimate in two modes
    rec: dict = {}
    with recording(rec):
        st = P.enc_state_init(cfg, B, device=dev)
        st, frames = P.encode_block(cfg, st, pcm)
        ds = P.dec_state_init(cfg, B, device=dev)
        P.decode_block(cfg, ds, frames)
    torch.cuda.synchronize()
    check(set(rec) == set(K.KERNELS), f"kernels not reached on the main path: {set(K.KERNELS) - set(rec)}")
    modes = sorted({args[3] for args, _ in rec["bit_estimate"]})
    check(modes == sorted({-1, cfg.modeFlag}), f"bit_estimate modes launched: {modes}")
    cases = ltpf_case_counts(rec["ltpf_postfilter"])
    print(f"[kernels] ltpf_postfilter stream-frames per case over {T} frames: {cases}", flush=True)
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
             "ari_decode": ari.decode_plain, "ltpf_postfilter": ltpf_dec.ltpf_postfilter_plain,
             "gain_bisection": quant.gain_bisection_plain,
             "tns_analysis_lattice": tns.tns_analysis_lattice_plain,
             "tns_synthesis_lattice": tns.tns_synthesis_lattice_plain,
             "hp50_biquad": analysis.hp50_biquad_plain,
             "side_info_pack": side.pack_side_info_plain,
             "side_info_parse": side.parse_side_info_plain,
             "sns_vq_dec": sns.sns_vq_dec_plain, "sns_vq_enc": sns.sns_vq_enc_plain,
             "tns_filter_analysis": tns.tns_filter_analysis_plain,
             "pc_classify": pc.pc_classify_plain, "mdct": transforms.mdct_plain,
             "imdct": transforms.imdct_plain, "olpa": analysis.olpa_plain,
             "ltpf_encode": analysis.ltpf_encode_plain,
             "noise_residual_enc": quant.noise_residual_enc_plain,
             "spec_decode": quant.spectrum_decode_plain}
    tns_on = torch.zeros((2, 2), dtype=torch.long)
    branches = None
    branch_hist: dict = {}
    errs = {}
    for name in K.KERNELS:
        err = 0.0
        for args, kw in rec[name]:
            got = getattr(K, name)(*args, **kw)
            ref = plain[name](*args, **kw)
            torch.cuda.synchronize()
            pairs = ([(got[k], ref[k]) for k in ref] if isinstance(ref, dict)
                     else list(zip(outputs(got), outputs(ref))))
            e = max(float((g.to(torch.float64) - r.to(torch.float64)).abs().max())
                    for g, r in pairs)
            if name == "ltpf_postfilter":
                check(e <= LTPF_TOL, f"{name}: max |diff| {e} > {LTPF_TOL}")
            else:
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
        errs[name] = err
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
    slice4_cases(cfg, dev, K, rec)
    pitch_and_spectrum_cases(cfg, dev, K)

    # ---- 4. the main path ----
    st = P.enc_state_init(cfg, B, device=dev)
    ds = P.dec_state_init(cfg, B, device=dev)
    torch.cuda.synchronize()
    K.reset_launch_counts()
    st, frames = P.encode_block(cfg, st, pcm)
    ds, out = P.decode_block(cfg, ds, frames)
    torch.cuda.synchronize()
    counts = dict(K.launches)
    print(f"[main] encode_block + decode_block at B={B} T={T}: launches {counts}", flush=True)
    check(all(counts[k] > 0 for k in K.KERNELS), f"a kernel was not launched: {counts}")
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
    with recording(rec_k):
        st_k = P.enc_state_init(cfg, nb, device=dev)
        st_k, fr_k = P.encode_block(cfg, st_k, small)
        _, out_k = P.decode_block(cfg, P.dec_state_init(cfg, nb, device=dev), fr_k)
    with plain_path():
        st_p = P.enc_state_init(cfg, nb, device=dev)
        st_p, fr_p = P.encode_block(cfg, st_p, small)
        _, out_p = P.decode_block(cfg, P.dec_state_init(cfg, nb, device=dev), fr_p)
    torch.cuda.synchronize()
    pcm16_k = P.round_pcm(out_k).to(torch.int32)
    ltpf_on = ltpf_case_counts(rec_k["ltpf_postfilter"])["on"]
    bytes_equal = bool(torch.equal(fr_k, fr_p))
    pcm_diff = int((pcm16_k - P.round_pcm(out_p).to(torch.int32)).abs().max())
    print(f"[main] kernel path vs plain path on the card, {nb} streams x {T} frames: "
          f"payload identical {bytes_equal}, max |PCM diff| {pcm_diff}, "
          f"LTPF on in {ltpf_on} stream-frames", flush=True)
    check(ltpf_on > 0, "the LTPF post-filter was never on in the compared streams")
    check(bytes_equal, "payload bytes of the kernel path differ from the plain path")
    check(pcm_diff <= 1, f"PCM of the kernel path differs by {pcm_diff} > 1")

    cpu = torch.device("cpu")
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

    # ---- 5. times ----
    rows = []
    for name in K.KERNELS:
        args, kw = rec[name][-1]   # the last frame's launch
        ms, ms_min, ms_max = cuda_ms_spread(lambda: getattr(K, name)(*args, **kw))
        gms = graph_ms(lambda: getattr(K, name)(*args, **kw))
        pms = cuda_ms(lambda: plain[name](*args, **kw), 2)
        outs = outputs(getattr(K, name)(*args, **kw))
        byts = kernel_bytes(name, args, outs)
        lib_ms = None
        if name in ("mdct", "imdct"):
            # the library's product of the same rows by the same matrix
            from audio_codec_torch.ops import transforms
            lhs = args[1]
            Mt = transforms.dct4_mt(lhs.shape[1], str(lhs.device))
            check(not torch.backends.cuda.matmul.allow_tf32, "TF32 is on for torch.matmul")
            lib_ms = cuda_ms_spread(lambda: torch.matmul(lhs, Mt))[0]
        ops = work_ops(name, args)
        b_bytes, b_ops = byts / HBM_BYTES_PER_S * 1e3, ops / SCALAR_OPS_PER_S * 1e3
        src, replaces = KERNEL_INFO[name]
        rows.append(dict(name=name, route="cuda", source=src, replaces=replaces,
                         launches=counts[name], max_abs_err=errs[name], ms=ms, plain_ms=pms,
                         bound_ms=max(b_bytes, b_ops),
                         bound_by="bytes" if b_bytes >= b_ops else "operations",
                         library_ms=lib_ms, graph_ms=gms))
        print(f"[times] {card} | {name}: kernel {ms:.4f} ms (median of {TIME_LOOPS} loops of "
              f"{TIME_LAUNCHES}; min {ms_min:.4f}, max {ms_max:.4f}; {gms:.4f} ms replayed from "
              f"a CUDA graph), plain {pms:.2f} ms, "
              + (f"torch.matmul {lib_ms:.4f} ms, " if lib_ms is not None else "") +
              f"bound {max(b_bytes, b_ops):.6f} ms ({byts} B, {ops:.3g} ops)", flush=True)

    st = P.enc_state_init(cfg, B, device=dev)
    ds = P.dec_state_init(cfg, B, device=dev)
    enc_ms = cuda_ms(lambda: P.encode_block(cfg, st, pcm), 1)
    dec_ms = cuda_ms(lambda: P.decode_block(cfg, ds, frames), 1)
    for what, ms in (("encode_block", enc_ms), ("decode_block", dec_ms)):
        streams = T * B / (ms / 1e3) / 100.0
        print(f"[times] {card} | {what} B={B} T={T}: {ms:.1f} ms, "
              f"{streams:.1f} real-time 10 ms streams", flush=True)

    # ---- 6. kernels line ----
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
