#!/usr/bin/env python3
"""The bytes bound of the fixed-point device decoder's kernels still to port
(K20: audio_codec_tpu/ops/fixed_dev.py, K21: ops/fixed_ltpf_dev.py), one
frame of B streams at a configuration: every array the chain reads counted
once, every array it writes counted once, over the H100's 3.35 TB/s. The
reference keeps this path in int64 (jax_enable_x64), so its rows and
memories are 8 bytes an element; the range decoder's outputs it reads are
int32. Prints one line per kernel.

    python3 tools/torch_fixed_bounds.py [--streams 2048] [--fs 48000] [--bitrate 64000]
"""
from __future__ import annotations

import argparse
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

HBM_BYTES_PER_S = 3.35e12


def ltpf_mem_lens(fs: int) -> tuple[int, int]:
    """ltpf_mem_x_len / ltpf_mem_y_len (setup_dec_lc3.c:105-107), as
    audio_codec_tpu/ops/fixed_ltpf.py:mem_lens computes them."""
    f = max(16000, fs)
    return ((f * 16778) >> 15 >> 11) - 2, ((((fs * 18678) >> 15) - 1) >> 5) + 1 + ((f * 16778) >> 15 >> 12)


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--streams", type=int, default=2048)
    ap.add_argument("--fs", type=int, default=48000)
    ap.add_argument("--bitrate", type=int, default=64000)
    opt = ap.parse_args()
    from audio_codec_torch.config import Config
    cfg = Config(fs_in=opt.fs, bitrate=opt.bitrate)
    B, N, Y = opt.streams, cfg.frame_length, cfg.yLen
    mem = N - cfg.la_zeroes                         # imdct_ola's overlap memory
    i32, i64 = 4, 8
    # K20 (residual_decode, noise_filling, apply_global_gain, tns_decode,
    # sns_decode_scf with _mpvq_deindex_batch and idct16, sns_interpolate,
    # mdct_shaping, batch_dct4, imdct_ola): reads the decoded spectrum, a
    # residual bit a line at most, the SNS and TNS indices, six side fields
    # and the overlap memory with its exponent; writes the time frame with
    # its exponent and the memory
    k20_in = Y * i32 + Y * i32 + 7 * i32 + (2 + 16) * i32 + 6 * i32 + mem * i64 + i64
    k20_out = N * i64 + i64 + mem * i64 + i64
    # K21 (ltpf_decode with _synth_filter): reads the frame, its exponent,
    # the x and y histories and the eight state words, and the three LTPF
    # fields; writes the filtered frame rounded to int16 and the state
    x_len, y_len = ltpf_mem_lens(cfg.fs)
    k21_in = N * i64 + i64 + (x_len + y_len) * i64 + 6 * i64 + 3 * i32
    k21_out = N * 2 + (x_len + y_len) * i64 + 6 * i64
    for name, per in (("K20 ops/fixed_dev.py chain", k20_in + k20_out),
                      ("K21 ops/fixed_ltpf_dev.py:ltpf_decode", k21_in + k21_out)):
        total = per * B
        print(f"{name}: {per} B a stream, {total} B a frame at B={B} "
              f"(fs {cfg.fs}, {cfg.frame_dms / 10:g} ms), bound "
              f"{total / HBM_BYTES_PER_S * 1e3:.6f} ms (bytes)")


if __name__ == "__main__":
    main()
