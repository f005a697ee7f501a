"""ctypes bindings for the native host runtime (native/lc3tpu_host.cpp).

Batch framing and PCM conversion hot loops run in C++ when the shared
library is present (tools/build_native.sh); every entry point has a NumPy
path with the same outputs, so the package works without the native build.
This is host code: nothing here runs on the card. A copy of
`audio_codec_tpu/utils/native.py` (whose package imports JAX), loading the
same library.
"""
from __future__ import annotations

import ctypes
from pathlib import Path

import numpy as np

_LIB_PATH = Path(__file__).resolve().parent.parent.parent / "native/liblc3tpu_host.so"
_lib = None
if _LIB_PATH.exists():
    _lib = ctypes.CDLL(str(_LIB_PATH))
    _lib.bs_scan_frames.restype = ctypes.c_int
    _lib.bs_emit_frames.restype = ctypes.c_int64
    _lib.g192_pack.restype = ctypes.c_int
    _lib.g192_unpack.restype = ctypes.c_int


def have_native() -> bool:
    return _lib is not None


def _ptr(a: np.ndarray):
    return a.ctypes.data_as(ctypes.c_void_p)


def pcm16_deinterleave(pcm: np.ndarray, n_streams: int) -> np.ndarray:
    """[n_samples, n_streams] int16 → [n_streams, n_samples] float32."""
    n_samples = pcm.shape[0]
    if _lib is not None:
        pcm = np.ascontiguousarray(pcm, np.int16)
        out = np.empty((n_streams, n_samples), np.float32)
        _lib.pcm16_deinterleave(_ptr(pcm), n_samples, n_streams, _ptr(out))
        return out
    return pcm.T.astype(np.float32)


def pcm16_interleave(x: np.ndarray) -> np.ndarray:
    """[n_streams, n_samples] float32 → [n_samples, n_streams] int16."""
    n_streams, n_samples = x.shape
    if _lib is not None:
        x = np.ascontiguousarray(x, np.float32)
        out = np.empty((n_samples, n_streams), np.int16)
        _lib.pcm16_interleave(_ptr(x), n_samples, n_streams, _ptr(out))
        return out
    v = np.sign(x) * np.floor(np.abs(x) + 0.5)
    return np.clip(v, -32768, 32767).astype(np.int16).T


def bs_scan_frames(body: bytes, max_frames: int = 1 << 20):
    """Container body → (offsets int64[n], lengths int32[n])."""
    if _lib is not None:
        buf = np.frombuffer(body, np.uint8)
        offsets = np.empty(max_frames, np.int64)
        lengths = np.empty(max_frames, np.int32)
        n = _lib.bs_scan_frames(_ptr(buf), ctypes.c_int64(len(body)),
                                _ptr(offsets), _ptr(lengths), max_frames)
        if n < 0:
            raise ValueError("truncated bitstream record")
        return offsets[:n], lengths[:n]
    offsets, lengths = [], []
    off = 0
    while off + 2 <= len(body):
        ln = body[off] | (body[off + 1] << 8)
        if off + 2 + ln > len(body):
            raise ValueError("truncated bitstream record")
        offsets.append(off + 2)
        lengths.append(ln)
        off += 2 + ln
    return np.asarray(offsets, np.int64), np.asarray(lengths, np.int32)


def bs_gather_frames(body: bytes, offsets: np.ndarray, nbytes: int) -> np.ndarray:
    """Equal-length frames → dense [n_frames, nbytes] uint8 matrix."""
    n = len(offsets)
    if _lib is not None:
        buf = np.frombuffer(body, np.uint8)
        out = np.empty((n, nbytes), np.uint8)
        _lib.bs_gather_frames(_ptr(buf), _ptr(np.ascontiguousarray(offsets)),
                              n, nbytes, _ptr(out))
        return out
    return np.stack([np.frombuffer(body[o: o + nbytes], np.uint8) for o in offsets])


def bs_emit_frames(payloads: np.ndarray) -> bytes:
    """[n_frames, nbytes] uint8 → container body bytes."""
    n, nbytes = payloads.shape
    if _lib is not None:
        payloads = np.ascontiguousarray(payloads, np.uint8)
        out = np.empty(n * (2 + nbytes), np.uint8)
        written = _lib.bs_emit_frames(_ptr(payloads), n, nbytes, _ptr(out))
        return out[:written].tobytes()
    parts = []
    for f in range(n):
        parts.append(int(nbytes).to_bytes(2, "little"))
        parts.append(payloads[f].tobytes())
    return b"".join(parts)
