#!/usr/bin/env python3
"""Smoke run of audio_codec_torch on one CUDA card.

Drives the port's main path, the 48 kHz / 10 ms / 64 kbps encoder and
decoder (`encode_block` then `decode_block`), through the CUDA kernels of
audio_codec_torch/csrc, and checks it:

  1. card      name and power limit (nvidia-smi), torch's device name;
  2. build     every kernel from the sources, with nvcc's -Xptxas -v report;
  3. kernels   each kernel against its plain PyTorch version on the card, on
               every launch of a --frames run of the main path (speech,
               music, noise); ari_encode, ari_decode and bit_estimate (in
               both of its modes) must match exactly, ltpf_postfilter within
               LTPF_TOL on the +-32768 scale, and each of the post-filter's
               five cases must occur;
  4. main path encode_block + decode_block at --streams x --frames with the
               launch counters read around it; on a few streams over all
               frames the kernel path's payload must equal the plain path's
               and its PCM must be within +-1, with LTPF on; the same
               streams through the port on the CPU (the path the tests hold
               against the reference) must give the same payloads but for a
               CPU_FRAMES_DIFFER_MAX share, and PCM within +-CPU_PCM_TOL from
               the card's payloads; a segmental SNR of the decoded material;
  5. times     CUDA-event times of each kernel and its plain version and of
               the encode and decode blocks, as real-time stream equivalents;
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
}


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


def nbytes(*ts) -> int:
    import torch
    return sum(t.numel() * t.element_size() for t in ts if isinstance(t, torch.Tensor))


@contextlib.contextmanager
def plain_path():
    """Route the four kernel call sites to their plain versions, so the main
    path runs on the card without the kernels (the reference for phase 4)."""
    from audio_codec_torch.ops import ari, ltpf_dec, quant
    saved = (quant.bit_estimate, ari.encode, ari.decode, ltpf_dec.ltpf_postfilter)
    quant.bit_estimate = quant.bit_estimate_plain
    ari.encode = lambda cfg, *a: ari.encode_plain(cfg, *a)
    ari.decode = lambda cfg, buf, side, *a, **k: ari.decode_plain(cfg, buf, side)
    ltpf_dec.ltpf_postfilter = ltpf_dec.ltpf_postfilter_plain
    try:
        yield
    finally:
        quant.bit_estimate, ari.encode, ari.decode, ltpf_dec.ltpf_postfilter = saved


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


def work_ops(name: str, args) -> float:
    """Scalar operations the kernel does on these inputs (approximate, from
    the data: symbols coded, tuples visited, samples filtered)."""
    import torch
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
    from audio_codec_torch.ops import ari, ltpf_dec, quant

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
    plain = {"bit_estimate": quant.bit_estimate_plain, "ari_encode": ari.encode_plain,
             "ari_decode": ari.decode_plain, "ltpf_postfilter": ltpf_dec.ltpf_postfilter_plain}
    errs = {}
    for name in K.KERNELS:
        err = 0.0
        for args, kw in rec[name]:
            got = getattr(K, name)(*args, **kw)
            ref = plain[name](*args, **kw)
            torch.cuda.synchronize()
            if isinstance(got, dict):
                diffs = {k: int((got[k].to(torch.int64) != ref[k].to(torch.int64)).sum())
                         for k in ref}
                e = float(max((got[k].to(torch.int64) - ref[k].to(torch.int64)).abs().max()
                              for k in ref))
                check(e == 0, f"{name}: differs from its plain version: {diffs}")
            else:
                e = float((got.to(torch.float64) - ref.to(torch.float64)).abs().max())
                if name == "ltpf_postfilter":
                    check(e <= LTPF_TOL, f"{name}: max |diff| {e} > {LTPF_TOL}")
                else:
                    check(e == 0, f"{name}: differs from its plain version, max |diff| {e}")
            err = max(err, e)
        errs[name] = err
        what = f"modes {modes}" if name == "bit_estimate" else ""
        print(f"[kernels] {name}: max |kernel - plain| = {err} over {len(rec[name])} "
              f"launches at {tuple(rec[name][0][0][1].shape)} {what}", flush=True)

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
        ms = cuda_ms(lambda: getattr(K, name)(*args, **kw), 20)
        pms = cuda_ms(lambda: plain[name](*args, **kw), 2)
        res = getattr(K, name)(*args, **kw)
        outs = list(res.values()) if isinstance(res, dict) else [res]
        ins = [a for a in args if isinstance(a, torch.Tensor)]
        if name == "ari_decode":
            ins += [v for v in args[2].values() if isinstance(v, torch.Tensor)]
        byts = nbytes(*ins, *outs)
        ops = work_ops(name, args)
        b_bytes, b_ops = byts / HBM_BYTES_PER_S * 1e3, ops / SCALAR_OPS_PER_S * 1e3
        src, replaces = KERNEL_INFO[name]
        rows.append(dict(name=name, route="cuda", source=src, replaces=replaces,
                         launches=counts[name], max_abs_err=errs[name], ms=ms, plain_ms=pms,
                         bound_ms=max(b_bytes, b_ops),
                         bound_by="bytes" if b_bytes >= b_ops else "operations",
                         library_ms=None))
        print(f"[times] {card} | {name}: kernel {ms:.4f} ms, plain {pms:.2f} ms, "
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
