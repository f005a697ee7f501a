"""LC3plus bitstream file container (ETSI CLI format) and G.192 support.

Format per the reference CLI (codec_exe.c:636-766): a 20-byte header of ten
little-endian u16 words {magic 0xcc1c, header size, fs/100, bitrate/100,
channels, frame_ms*100, epmode, signal_len lo, signal_len hi, hrmode},
followed by one record per frame: u16 byte-count + payload bytes.

A copy of `audio_codec_tpu/utils/bitstream_io.py` (whose package imports
JAX).
"""
from __future__ import annotations

import struct
from dataclasses import dataclass
from pathlib import Path

import numpy as np

MAGIC = 0xCC1C

G192_GOOD_FRAME = 0x6B21
G192_BAD_FRAME = 0x6B20
G192_REDUNDANCY_FRAME = 0x6B22
G192_ZERO = 0x007F
G192_ONE = 0x0081


@dataclass
class StreamHeader:
    samplerate: int
    bitrate: int
    channels: int
    frame_ms: float
    epmode: int
    signal_len: int
    hrmode: int = 0


def write_header(f, h: StreamHeader, compact: bool = False) -> None:
    """Writes the container header. epmode goes out verbatim: the codec CLI
    stores 0/1 (codec_exe.c open_bitstream_writer `epmode > 0 ? 1 : 0` — the
    caller clamps), while ccConvert stores the full mode 0..4
    (ccConvert.c:353-362). `compact` selects ccConvert's 18-byte / 9-word
    header (no hrmode word) for byte-identical tool output."""
    if compact:
        f.write(struct.pack("<9H", MAGIC, 18, h.samplerate // 100,
                            h.bitrate // 100, h.channels,
                            int(h.frame_ms * 100), h.epmode,
                            h.signal_len & 0xFFFF,
                            (h.signal_len >> 16) & 0xFFFF))
        return
    f.write(struct.pack("<10H", MAGIC, 20, h.samplerate // 100, h.bitrate // 100,
                        h.channels, int(h.frame_ms * 100), h.epmode,
                        h.signal_len & 0xFFFF, (h.signal_len >> 16) & 0xFFFF,
                        h.hrmode))


def read_header(f) -> StreamHeader:
    words = struct.unpack("<10H", f.read(20))
    assert words[0] == MAGIC, "bad bitstream magic"
    hdr_size = words[1]
    assert hdr_size >= 18
    h = StreamHeader(samplerate=words[2] * 100, bitrate=words[3] * 100,
                     channels=words[4], frame_ms=words[5] / 100.0,
                     epmode=words[6], signal_len=words[7] | (words[8] << 16),
                     hrmode=words[9] if hdr_size > 18 else 0)
    f.seek(hdr_size)
    return h


def write_frame(f, payload: bytes) -> None:
    f.write(struct.pack("<H", len(payload)))
    f.write(payload)


def read_frame(f) -> bytes | None:
    raw = f.read(2)
    if len(raw) < 2:
        return None
    (n,) = struct.unpack("<H", raw)
    data = f.read(n)
    return data if len(data) == n else None


def read_all(path: Path | str) -> tuple[StreamHeader, list[bytes]]:
    with open(path, "rb") as f:
        h = read_header(f)
        frames = []
        while (fr := read_frame(f)) is not None:
            frames.append(fr)
    return h, frames


def write_all(path: Path | str, h: StreamHeader, frames: list[bytes],
              compact: bool = False) -> None:
    with open(path, "wb") as f:
        write_header(f, h, compact=compact)
        for fr in frames:
            write_frame(f, fr)


# --------------------------------------------------------------------------
# G.192 softbit format (write_bitstream_frame_G192, codec_exe.c:705-735)
# --------------------------------------------------------------------------

def write_g192_frame(f, payload: bytes, good: bool = True,
                     redundancy: bool = False) -> None:
    sync = G192_REDUNDANCY_FRAME if redundancy else (
        G192_GOOD_FRAME if good else G192_BAD_FRAME)
    f.write(struct.pack("<HH", sync, len(payload) * 8))
    bits = np.unpackbits(np.frombuffer(payload, np.uint8)[:, None], axis=1,
                         bitorder="little").ravel()
    vals = np.where(bits, G192_ONE, G192_ZERO).astype("<u2")
    f.write(vals.tobytes())


def read_g192_frame(f) -> tuple[bytes | None, int]:
    """Returns (payload or None at EOF, bfi flag: 0 good / 1 bad /
    3 redundancy frame — read_bitstream_frame_G192, codec_exe.c:845-895)."""
    raw = f.read(4)
    if len(raw) < 4:
        return None, 0
    sync, nbits = struct.unpack("<HH", raw)
    vals = np.frombuffer(f.read(2 * nbits), "<u2")
    bits = (vals == G192_ONE).astype(np.uint8)
    payload = np.packbits(bits.reshape(-1, 8), axis=1, bitorder="little").ravel()
    if sync == G192_BAD_FRAME:
        return b"", 1
    bfi = 3 if sync == G192_REDUNDANCY_FRAME else 0
    return payload.tobytes(), bfi
