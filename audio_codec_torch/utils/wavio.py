"""Minimal WAV I/O (16/24/32-bit PCM), mirroring tinywavein_c.h usage.

A copy of `audio_codec_tpu/utils/wavio.py` (whose package imports JAX).
"""
from __future__ import annotations

import struct
import wave
from pathlib import Path

import numpy as np


def read_wav(path: Path | str) -> tuple[np.ndarray, int]:
    """Returns ([n, channels] int array scaled like the reference input, fs)."""
    with wave.open(str(path), "rb") as w:
        n = w.getnframes()
        ch = w.getnchannels()
        sw = w.getsampwidth()
        fs = w.getframerate()
        raw = w.readframes(n)
    if sw == 2:
        data = np.frombuffer(raw, "<i2").astype(np.int32)
    elif sw == 3:
        b = np.frombuffer(raw, np.uint8).reshape(-1, 3)
        data = (b[:, 0].astype(np.int32) | (b[:, 1].astype(np.int32) << 8)
                | (b[:, 2].astype(np.int32) << 16))
        data = (data << 8) >> 8  # sign extend
    elif sw == 4:
        data = np.frombuffer(raw, "<i4")
    else:
        raise ValueError(f"unsupported sample width {sw}")
    return data.reshape(-1, ch), fs


def write_wav(path: Path | str, data: np.ndarray, fs: int, sampwidth: int = 2) -> None:
    data = np.atleast_2d(data)
    if data.shape[0] < data.shape[1]:
        data = data.T
    with wave.open(str(path), "wb") as w:
        w.setnchannels(data.shape[1])
        w.setsampwidth(sampwidth)
        w.setframerate(fs)
        if sampwidth == 2:
            w.writeframes(data.astype("<i2").tobytes())
        elif sampwidth == 3:
            d = data.astype(np.int32)
            b = np.empty((d.size, 3), np.uint8)
            flat = d.reshape(-1)
            b[:, 0] = flat & 0xFF
            b[:, 1] = (flat >> 8) & 0xFF
            b[:, 2] = (flat >> 16) & 0xFF
            w.writeframes(b.tobytes())
        else:
            w.writeframes(data.astype("<i4").tobytes())
