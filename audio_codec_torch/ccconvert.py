"""Channel coder converter: pack and unpack LC3plus FEC protection.

The port of `audio_codec_tpu/ccconvert.py`, the analog of the reference's
standalone ccConvert tool (fixed_point/ccConvert.c:107-796): converts an
unprotected LC3plus bitstream into a channel-coded one (``pack``) and back
(``unpack``) without re-encoding the audio. It writes the same bytes as the
reference package.

pack  (ccConvert.c channel_coder_pack, :525-626): per channel, the core
frame is re-decoded just far enough to find the partial-concealment
pointer-convergence byte b_left (processAriDecoder mode 1), the most
error-sensitive block is relocated to the front when the slot carries PC
codewords (processReorderBitstream_fx), and the payload is Reed-Solomon
encoded into the gross slot (fec_encoder with the decoder-default
EPMR = LC3_EPMR_ZERO, lc3.c:305).

unpack (ccConvert.c channel_coder_unpack, :628-773): each slot is FEC
decoded, the convergence point is re-discovered on the transmitted
(reordered) stream (processAriDecoder mode 2) and the block swap undone
(processReorderBitstream_dec_fx, :776-796), yielding the original
unprotected core bitstream.

The work runs on the stream engine's device code: on the card the CUDA
kernels fec_encode, fec_decode and ari_decode (the encoder's PC simulation
and the decoder's PC hooks), with device="cpu" their plain versions. The
frames of a file go through each step together, as one batch a frame size;
this module only handles framing.

Usage:  python -m audio_codec_torch.ccconvert (-pack GROSS_BYTES EPMODE | -unpack)
            [-device cuda|cpu] INPUT OUTPUT
"""
from __future__ import annotations

import argparse
import sys
from pathlib import Path

import numpy as np
import torch

from .config import Config
from .engine import b_left_step, reorder_payload
from .models.state import resolve_device
from .ops import fec
from .utils import bitstream_io as bio

I32 = torch.int32


def _slot_cfg(h: bio.StreamHeader, slot_bytes: int, epmode: int) -> Config:
    """Single-channel Config for a protected slot (targetBytes = data size,
    n_pc/n_pccw derived from the slot), as update_dec_bitrate would build."""
    frame_dms = int(round(h.frame_ms * 10))
    fl = h.samplerate * frame_dms // 10000
    bitrate = slot_bytes * 8 * h.samplerate // fl
    return Config(fs_in=h.samplerate, bitrate=bitrate, frame_dms=frame_dms,
                  channels=1, epmode=epmode, hrmode=bool(h.hrmode))


def _rows(frames: list[bytes], dev) -> torch.Tensor:
    """Equal-length frames as one [n, bytes] int32 tensor on dev."""
    return torch.as_tensor(np.stack([np.frombuffer(f, np.uint8) for f in frames])
                           .astype(np.int32), device=dev)


def _host(t: torch.Tensor) -> np.ndarray:
    return t.to(torch.uint8).cpu().numpy()


def pack_frames(h: bio.StreamHeader, frames: list[bytes], gross_bytes: int,
                epmode: int, device=None) -> list[bytes]:
    """EP0 frames -> channel-coded frames of ch*gross_bytes each.

    Multichannel frames whose total slot fits 160 bytes use combined channel
    coding (one FEC slot over the concatenated channel payloads): a
    conformant EP decoder engages ccc whenever channels > 1 and the frame is
    <= 160 bytes (dec_lc3.c:343), so emitting per-channel slots in that
    regime would be undecodable. The reference tool sidesteps this by being
    effectively mono-only (ccConvert.c:578 assert)."""
    if not 1 <= epmode <= 4:
        raise ValueError(f"epmode must be 1..4, got {epmode}")
    dev = resolve_device(device)
    if not frames:
        return []
    ch = h.channels
    ccc = ch > 1 and ch * gross_bytes <= 160
    if ccc:
        total_slot = ch * gross_bytes
        data_total = fec.fec_get_data_size(epmode, 1, total_slot)
        for fr in frames:
            if len(fr) != data_total:
                raise ValueError(
                    f"frame carries {len(fr)} bytes but epmode {epmode} at "
                    f"{total_slot} combined gross bytes protects {data_total}")
        coded = fec.fec_encode(_rows(frames, dev),
                               torch.zeros((len(frames),), dtype=I32, device=dev),
                               slot_bytes=total_slot, mode=epmode, ccc_flag=1)
        return [r.tobytes() for r in _host(coded)]
    data_bytes = fec.fec_get_data_size(epmode, 0, gross_bytes)
    n_pccw = fec.fec_get_n_pccw(gross_bytes, epmode, 0)
    n_pc = fec.fec_get_n_pc(epmode, n_pccw, gross_bytes)
    per_ch = []
    for fr in frames:
        for c in range(ch):
            nb = len(fr) // ch + (c < len(fr) % ch)
            if nb != data_bytes:
                raise ValueError(
                    f"channel {c}: frame carries {nb} bytes but epmode "
                    f"{epmode} at {gross_bytes} gross bytes protects "
                    f"{data_bytes} (ccConvert.c:578)")
    cfg = _slot_cfg(h, gross_bytes, epmode)
    assert cfg.targetBytes == data_bytes and cfg.n_pc == n_pc
    for c in range(ch):
        # every frame splits alike: channel c's bytes start at c * data_bytes
        data = _rows([fr[c * data_bytes:(c + 1) * data_bytes] for fr in frames], dev)
        if n_pc > 0:
            b_left = b_left_step(cfg, data)
            data = torch.where((b_left > 0)[:, None], reorder_payload(data, b_left, n_pc), data)
        coded = fec.fec_encode(data, torch.zeros((len(frames),), dtype=I32, device=dev),
                               slot_bytes=gross_bytes, mode=epmode, ccc_flag=0)
        per_ch.append(_host(coded))
    return [b"".join(per_ch[c][i].tobytes() for c in range(ch)) for i in range(len(frames))]


def _unreorder_payload(data: np.ndarray, b_left: int, n_pc: int) -> np.ndarray:
    """processReorderBitstream_dec_fx (ccConvert.c:776-796): inverse of the
    encoder-side block relocation — put the first (n_pc+1)//2 bytes back at
    b_left."""
    blk = (n_pc + 1) >> 1
    return np.concatenate([data[blk:blk + b_left], data[:blk],
                           data[blk + b_left:]])


def _b_left(h: bio.StreamHeader, slot: int, mode: int, db: int, n_pc: int,
            rows: np.ndarray, dev) -> np.ndarray:
    """The convergence byte of each transmitted core frame [n, db] of one
    slot and mode, as the decoder finds it (processAriDecoder mode 2)."""
    from .ops import ari, bits
    scfg = _slot_cfg(h, slot, mode)
    assert scfg.targetBytes == db and scfg.n_pc == n_pc
    buf = torch.as_tensor(rows.astype(np.int32), device=dev)
    side = bits.parse_side_info(scfg, buf)
    return ari.decode(scfg, buf, side)["b_left"].cpu().numpy()


def _unpack_slots(h: bio.StreamHeader, raw: np.ndarray, slot: int, dev):
    """FEC-decode one channel's slots [n, slot] of equal-length frames and
    undo the block move. Returns a list of payloads, None where the channel
    failed."""
    dec = fec.fec_decode(torch.as_tensor(raw.astype(np.int32), device=dev), slot_bytes=slot,
                         ccc_flag=0)
    bfi, mode, dbs = (dec[k].cpu().numpy() for k in ("bfi", "mode", "data_bytes"))
    data = _host(dec["data"])
    out: list = [None] * len(raw)
    moved: dict[tuple[int, int], list[int]] = {}
    for i in range(len(raw)):
        if bfi[i] == 1 or mode[i] < 1 or dbs[i] == 0:
            continue
        out[i] = data[i, :dbs[i]]
        n_pccw = fec.fec_get_n_pccw(slot, int(mode[i]), 0)
        if n_pccw > 0 and fec.fec_get_n_pc(int(mode[i]), n_pccw, slot) > 0:
            moved.setdefault((int(mode[i]), int(dbs[i])), []).append(i)
    for (m, db), idx in moved.items():
        n_pc = fec.fec_get_n_pc(m, fec.fec_get_n_pccw(slot, m, 0), slot)
        b_left = _b_left(h, slot, m, db, n_pc, np.stack([out[i] for i in idx]), dev)
        blk = (n_pc + 1) >> 1
        for i, bl in zip(idx, b_left):
            # b_left > db is the no-convergence sentinel (ari.py inits
            # b_left to numbytes + 1): the transmitted frame was never
            # reordered, so there is nothing to undo
            if 0 < bl <= db:
                # reference asserts the adjusted offset is non-negative
                # (processReorderBitstream_dec_fx, ccConvert.c:787); a
                # convergence point inside the moved block on a frame that
                # passed FEC is a corrupt frame, not a crash
                out[i] = None if bl < blk else _unreorder_payload(out[i], int(bl) - blk, n_pc)
    return out


def unpack_frames(h: bio.StreamHeader, frames: list[bytes], device=None
                  ) -> tuple[list[bytes], int]:
    """Protected frames -> EP0 core frames. Returns (frames, n_bad).

    Mirrors the reference binary-format path (ccConvert.c:195-240): every
    frame is written with whatever the FEC decoder produced — a channel that
    fails FEC decode contributes zero bytes while successfully decoded
    channels are kept; n_bad counts frames with at least one failed channel.
    Combined channel coding (channels > 1, frame <= 160 bytes, dec_lc3.c:343)
    is detected per frame and decoded as one slot."""
    dev = resolve_device(device)
    ch = h.channels
    out: list[bytes] = [b""] * len(frames)
    bad = [False] * len(frames)
    by_len: dict[int, list[int]] = {}
    for i, fr in enumerate(frames):
        by_len.setdefault(len(fr), []).append(i)
    for n, idx in by_len.items():
        raw = np.stack([np.frombuffer(frames[i], np.uint8) for i in idx])
        if ch > 1 and n <= 160:
            # combined channel coding: one FEC slot over all channels; ccc
            # never carries PC codewords (fec_get_n_pccw, al_fec.c:379-390)
            # so no de-reordering is needed
            dec = fec.fec_decode(torch.as_tensor(raw.astype(np.int32), device=dev),
                                 slot_bytes=n, ccc_flag=1)
            bfi, mode, dbs = (dec[k].cpu().numpy() for k in ("bfi", "mode", "data_bytes"))
            data = _host(dec["data"])
            for g, i in enumerate(idx):
                if bfi[g] == 1 or mode[g] < 1 or dbs[g] == 0:
                    bad[i] = True
                else:
                    out[i] = data[g, :dbs[g]].tobytes()
            continue
        parts: list[list[bytes]] = [[] for _ in idx]
        off = 0
        for c in range(ch):
            slot = n // ch + (c < n % ch)
            got = _unpack_slots(h, raw[:, off:off + slot], slot, dev)
            off += slot
            for g, i in enumerate(idx):
                if got[g] is None:
                    bad[i] = True
                else:
                    parts[g].append(got[g].tobytes())
        for g, i in enumerate(idx):
            out[i] = b"".join(parts[g])
    return out, sum(bad)


def main(argv: list[str] | None = None, device=None) -> int:
    """Run the converter on argv (sys.argv by default); device, where given,
    overrides -device."""
    ap = argparse.ArgumentParser(
        prog="ccconvert",
        description="Convert between protected and unprotected LC3plus "
                    "bitstreams (ccConvert analog).")
    ap.add_argument("-pack", nargs=2, metavar=("GROSS_BYTES", "EPMODE"),
                    type=int, default=None)
    ap.add_argument("-unpack", action="store_true")
    ap.add_argument("-device", type=str, default=None,
                    help="device of the channel coder: cuda (the default) or cpu")
    ap.add_argument("input", type=Path)
    ap.add_argument("output", type=Path)
    args = ap.parse_args(argv)
    if (args.pack is None) == (not args.unpack):
        ap.error("exactly one of -pack / -unpack is required")
    device = device if device is not None else args.device

    h, frames = bio.read_all(args.input)
    if args.pack is not None:
        gross, epmode = args.pack
        if h.epmode != 0:
            ap.error("pack mode needs an unprotected input bitstream")
        out = pack_frames(h, frames, gross, epmode, device=device)
        # ccConvert writes an 18-byte header with the full epmode 0..4
        # (ccConvert.c:353-362); compact keeps tool output byte-identical
        bio.write_all(args.output, bio.StreamHeader(
            samplerate=h.samplerate, bitrate=h.bitrate, channels=h.channels,
            frame_ms=h.frame_ms, epmode=epmode, signal_len=h.signal_len,
            hrmode=h.hrmode), out, compact=not h.hrmode)
        print(f"packed {len(out)} frames -> ep{epmode}, "
              f"{h.channels}x{gross} bytes/frame")
    else:
        if h.epmode == 0:
            ap.error("unpack mode needs a protected input bitstream")
        out, n_bad = unpack_frames(h, frames, device=device)
        bio.write_all(args.output, bio.StreamHeader(
            samplerate=h.samplerate, bitrate=h.bitrate, channels=h.channels,
            frame_ms=h.frame_ms, epmode=0, signal_len=h.signal_len,
            hrmode=h.hrmode), out, compact=not h.hrmode)
        print(f"unpacked {len(out)} frames ({n_bad} undecodable)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
