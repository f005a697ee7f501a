#!/usr/bin/env python3
"""The bytes bound of the fixed-point decoder's four kernels
(audio_codec_torch/csrc/fx_*.cu; the reference's
audio_codec_tpu/ops/fixed_dev.py and ops/fixed_ltpf_dev.py), one block of
T frames of B streams at a configuration: every array a kernel reads
counted once, every array it writes counted once, over the H100's
3.35 TB/s. The port carries Word16 and Word32 values in int64 between the
kernels, as the reference does (jax_enable_x64): 8 bytes an element; the
range decoder's outputs and the side words are int32, the PCM int16.
Every input is counted whole but the DCT-IV's rows, of which the kernel
reads only the bins below the bandwidth cap (fixed_imdct.MAX_BW);
chip_smoke.py phase 8 also counts the residual bits only as far as each
frame's n_res, from its run's data. Prints one line per kernel.

    python3 tools/torch_fixed_bounds.py [--streams 2048] [--frames 8] [--fs 48000] [--bitrate 64000]
"""
from __future__ import annotations

import argparse
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

HBM_BYTES_PER_S = 3.35e12


def kernel_bytes(cfg, B: int, T: int) -> dict[str, tuple[int, int]]:
    """{kernel: (bytes a launch, launches a block)} at B streams x T frames."""
    from audio_codec_torch.ops.fixed_imdct import MAX_BW, window_table
    from audio_codec_torch.ops.fixed_ltpf import mem_lens
    i8, i4, i2 = 8, 4, 2
    L = T * B
    N, Y, nb = cfg.frame_length, cfg.yLen, cfg.bands_number
    R = min(Y, cfg.targetBytes * 8)                 # the residual bits' row
    bw = min(N, MAX_BW >> {25: 2, 50: 1, 100: 0}[cfg.frame_dms])  # the DCT rows' bins read
    mem = len(window_table(N)) - N                  # imdct_ola's overlap memory
    x_len, y_len = mem_lens(cfg.fs)
    state = (mem + x_len + y_len + 7) * i8          # + mem_e and the six LTPF words
    return {
        # [L, 7] side indices -> scf, scf_e [L, n_bands]
        "fx_sns_dec": (L * (7 * i4 + 2 * nb * i8), 1),
        # x [L, yLen], residual bits [L, R], 8 side words, 16 TNS indices,
        # scf and scf_e -> the shaped row [L, N] and its exponent
        "fx_spec_decode": (L * ((Y + R + 8 + 16) * i4 + 2 * nb * i8 + (N + 1) * i8), 1),
        # rows [L, N] (their first bw bins) and exponents -> rows, y_e,
        # y_s, zero
        "fx_dct4": (L * ((bw + 1) * i8 + (N + 2) * i8 + 1), 1),
        # ytda [B, N], y_e, y_s, zero, 3 LTPF words and the state -> PCM and
        # the state
        "fx_ola_ltpf": (B * ((N + 2) * i8 + 1 + 3 * i4 + state + N * i2 + state), T),
    }


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--streams", type=int, default=2048)
    ap.add_argument("--frames", type=int, default=8)
    ap.add_argument("--fs", type=int, default=48000)
    ap.add_argument("--bitrate", type=int, default=64000)
    opt = ap.parse_args()
    from audio_codec_torch.config import Config
    cfg = Config(fs_in=opt.fs, bitrate=opt.bitrate)
    for name, (per, n) in kernel_bytes(cfg, opt.streams, opt.frames).items():
        print(f"{name}: {per} B a launch, {n} launches a block of {opt.frames} frames x "
              f"{opt.streams} streams (fs {cfg.fs}, {cfg.frame_dms / 10:g} ms): bound "
              f"{per / HBM_BYTES_PER_S * 1e3:.6f} ms a launch (bytes)")


if __name__ == "__main__":
    main()
