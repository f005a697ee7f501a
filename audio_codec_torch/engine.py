"""Streaming codec engine: one frame step a call over a batch of streams.

The port of `audio_codec_tpu/engine.py`. The API mirrors the reference's
contract (lc3.h:193-340): a state-carrying encoder and decoder, one frame
a call, bitrate, EP mode and bandwidth switchable between frames without a
state reset. Lane g*ch + c is channel c of multichannel stream g; byte
budgets split across channels with the remainder to the lowest channels
(setup_enc_lc3.c:192-196). With epmode > 0 the channel coder runs per
channel or, for total frames of at most 160 bytes, once over the
concatenated channel payloads (combined channel coding, enc_lc3.c:283-316,
dec_lc3.c:324-447).

Both classes run on the card unless the caller passes device="cpu". The
payloads of a frame stay one [lanes, bytes] tensor on the device, through
the encoder-side partial-concealment simulation, the block move and the
channel coder, until the API returns them as bytes. The decoder reads the
channel decoder's detected modes and byte counts on the host, as the
reference does, because the Config of the next step depends on them.
"""
from __future__ import annotations

import dataclasses
from dataclasses import replace

import numpy as np
import torch

from .config import Config
from .models import decoder as dec_m
from .models import encoder as enc_m
from .models import state as S
from .ops import ari, bits, fec

I32 = torch.int32


def b_left_step(cfg: Config, buf):
    """Encoder-side PC simulation: re-decode the frames [B, nbytes] to find
    the pointers' convergence byte b_left for the reorder
    (enc_lc3.c:245-259)."""
    side = bits.parse_side_info(cfg, buf)
    return ari.decode(cfg, buf, side, pc_enc_sim=True)["b_left"]


def reorder_payload(data, b_left, n_pc: int):
    """processReorderBitstream_fx as a gather: move the block of
    (n_pc+1)//2 bytes at b_left [B] to the front of each payload [B, n]."""
    blk = (n_pc + 1) >> 1
    n = data.shape[1]
    j = torch.arange(n, device=data.device)[None, :]
    bl = b_left.to(torch.int64)[:, None]
    src = torch.where(j < blk, bl + j, torch.where(j < bl + blk, j - blk, j))
    return torch.gather(data, 1, src.clamp(0, n - 1))


def _lane_groups(cfgs: tuple[Config, ...], n: int) -> list[tuple[Config, list[int]]]:
    """Lane indices grouped by identical per-channel Config (lane % channels
    selects the channel; remainder bytes make at most two groups)."""
    ch = len(cfgs)
    groups: dict[Config, list[int]] = {}
    for lane in range(n):
        groups.setdefault(cfgs[lane % ch], []).append(lane)
    return list(groups.items())


def _tree_gather(st, idx):
    return dataclasses.replace(st, **{f.name: getattr(st, f.name)[idx]
                                      for f in dataclasses.fields(st)})


def _tree_scatter(st, idx, sub):
    out = {}
    for f in dataclasses.fields(st):
        t = getattr(st, f.name).clone()
        t[idx] = getattr(sub, f.name)
        out[f.name] = t
    return dataclasses.replace(st, **out)


def _to_bytes(rows: torch.Tensor) -> list[bytes]:
    arr = rows.to(torch.uint8).cpu().numpy()
    return [r.tobytes() for r in arr]


class StreamEncoder:
    """Persistent-state encoder over n_streams independent lanes."""

    def __init__(self, cfg: Config, n_streams: int = 1, device=None):
        if n_streams % cfg.channels:
            raise ValueError("n_streams must be a multiple of cfg.channels")
        self.device = S.resolve_device(device)
        self.cfg = cfg
        self.n = n_streams
        self.state = S.enc_state_init(cfg, n_streams, device=self.device)
        self.epmr = 0  # error-protection mode request (lc3.h epmr setter)

    def set_bitrate(self, bitrate: int) -> None:
        if bitrate != self.cfg.bitrate:
            self.cfg = self.cfg.with_bitrate(bitrate)

    def set_ep_mode(self, epmode: int) -> None:
        """lc3_enc_set_ep_mode: re-derives the payload split, keeps state."""
        if epmode != self.cfg.epmode:
            self.cfg = replace(self.cfg, epmode=epmode)

    def set_bandwidth(self, bandwidth: int) -> None:
        """lc3_enc_set_bandwidth (lc3.c:187-207): per-frame switchable."""
        if bandwidth != self.cfg.bandwidth:
            self.cfg = replace(self.cfg, bandwidth=bandwidth)

    def _encode_core(self, pcm: torch.Tensor) -> list[tuple[Config, list[int], torch.Tensor]]:
        """Core (pre-FEC) encode of every lane: (channel Config, lanes,
        payloads [len(lanes), targetBytes]) per lane group."""
        cfgs = self.cfg.channel_configs()
        if len(set(cfgs)) == 1:
            self.state, out, _ = enc_m.encode_frame(cfgs[0], self.state, pcm)
            return [(cfgs[0], list(range(self.n)), out)]
        groups = []
        for ccfg, lanes in _lane_groups(cfgs, self.n):
            idx = torch.as_tensor(lanes, device=self.device)
            sub, out, _ = enc_m.encode_frame(ccfg, _tree_gather(self.state, idx), pcm[idx])
            self.state = _tree_scatter(self.state, idx, sub)
            groups.append((ccfg, lanes, out))
        return groups

    def encode(self, pcm) -> list[bytes]:
        """pcm: [n_streams, frame_length] at cfg.bps scale (16/24/32-bit
        integer range, scaled to the codec's 16-bit working range like
        lc3_enc24/enc32, enc_lc3_fl.c:30-42). Returns frame bytes: one entry
        per lane, channel-coded to cfg.slotBytes when epmode > 0 per channel,
        or one entry per multichannel group under combined channel coding."""
        pcm = torch.as_tensor(pcm, dtype=torch.float32).to(self.device)
        if self.cfg.bps != 16:
            pcm = pcm * (2.0 ** (16 - self.cfg.bps))
        return self._package(self._encode_core(pcm))

    def encode_plc_trigger(self) -> list[bytes]:
        """-ept frames: the side information's lastnz field set to its
        all-ones trigger value (fixed_point/enc_entropy.c:31,65), so the
        decoder's side parse finds an invalid lastnz and conceals. The
        trigger payload passes through the channel coder like any frame."""
        groups = []
        for ccfg, lanes in _lane_groups(self.cfg.channel_configs(), self.n):
            buf = np.zeros(ccfg.targetBytes, np.uint8)
            for k in range(ccfg.lastnz_bits):
                p = ccfg.BW_cutoff_bits + k   # backward, LSB first from the last byte
                buf[ccfg.targetBytes - 1 - p // 8] |= 1 << (p % 8)
            rows = torch.as_tensor(np.tile(buf, (len(lanes), 1)), device=self.device)
            groups.append((ccfg, lanes, rows))
        return self._package(groups, reorder=False)

    def _package(self, groups, reorder: bool = True) -> list[bytes]:
        cfg = self.cfg
        if cfg.epmode == 0:
            out: list[bytes] = [b""] * self.n
            for _, lanes, rows in groups:
                for lane, b in zip(lanes, _to_bytes(rows)):
                    out[lane] = b
            return out
        ch = cfg.channels
        if cfg.ccc:
            # combined channel coding: concatenate the channel payloads of a
            # group and run the coder once over the full slot (enc_lc3.c:303-313)
            per_lane = [None] * self.n
            for _, lanes, rows in groups:
                for k, lane in enumerate(lanes):
                    per_lane[lane] = rows[k]
            G = self.n // ch
            data = torch.stack([torch.cat(per_lane[g * ch:(g + 1) * ch]) for g in range(G)])
            epmr = torch.full((G,), self.epmr, dtype=I32, device=self.device)
            return _to_bytes(fec.fec_encode(data.to(I32), epmr, slot_bytes=cfg.slotBytes,
                                            mode=cfg.epmode, ccc_flag=1))
        coded: list[bytes] = [b""] * self.n
        for ccfg, lanes, rows in groups:
            stack = rows.to(I32)
            bad = None
            if ccfg.n_pc > 0 and reorder:
                # EP3/EP4 at a slot of 80 bytes or more: move the most
                # error-sensitive block to where the PC codewords protect it
                # (before the channel coder, enc_lc3.c:245-259)
                b_left = b_left_step(ccfg, stack)
                bad = (b_left < 0).any()
                stack = reorder_payload(stack, b_left, ccfg.n_pc)
            epmr = torch.full((len(lanes),), self.epmr, dtype=I32, device=self.device)
            enc = fec.fec_encode(stack, epmr, slot_bytes=ccfg.slotBytes, mode=ccfg.epmode,
                                 ccc_flag=0)
            out = _to_bytes(enc)
            if bad is not None and bool(bad):
                raise RuntimeError("the encoder's PC simulation found no convergence byte")
            for lane, b in zip(lanes, out):
                coded[lane] = b
        return coded


class StreamDecoder:
    """Persistent-state decoder over n_streams independent lanes."""

    def __init__(self, cfg: Config, n_streams: int = 1, device=None):
        if n_streams % cfg.channels:
            raise ValueError("n_streams must be a multiple of cfg.channels")
        self.device = S.resolve_device(device)
        self.cfg = cfg
        self.n = n_streams
        self.state = S.dec_state_init(cfg, n_streams, device=self.device)
        self.epmr = 0      # decoder-estimated EP mode request (0..11)
        self.error_report = np.zeros((n_streams,), np.int32)
        self.last_bfi = np.zeros((n_streams,), np.int32)  # post-decode bfi

    def _decode_core(self, full: torch.Tensor, bfis: torch.Tensor, be_l=None,
                     be_r=None) -> np.ndarray:
        """Core decode of every lane. full: [n, bytes] payloads on the device
        (zero where lost, each lane's bytes from 0), bfis [n] in {0,1,2,3},
        be_l/be_r the corrupt bit range of bfi 2 lanes."""
        cfgs = self.cfg.channel_configs()
        if be_l is None:
            be_l = torch.full((self.n,), -1, dtype=I32, device=self.device)
            be_r = be_l
        full = torch.where((bfis == 1)[:, None], 0, full)
        if len(set(cfgs)) == 1:
            self.state, y, aux = dec_m.decode_frame(cfgs[0], self.state,
                                                    full[:, : cfgs[0].targetBytes], bfis,
                                                    be_l, be_r)
            pcm = dec_m.round_pcm(y, self.cfg.bps)
            self.last_bfi = aux["bfi"].cpu().numpy()
            return pcm.cpu().numpy()
        pcm = torch.zeros((self.n, self.cfg.frame_length), dtype=I32, device=self.device)
        last_bfi = torch.zeros((self.n,), dtype=I32, device=self.device)
        for ccfg, lanes in _lane_groups(cfgs, self.n):
            idx = torch.as_tensor(lanes, device=self.device)
            sub, y, aux = dec_m.decode_frame(ccfg, _tree_gather(self.state, idx),
                                             full[idx][:, : ccfg.targetBytes], bfis[idx],
                                             be_l[idx], be_r[idx])
            self.state = _tree_scatter(self.state, idx, sub)
            last_bfi[idx] = aux["bfi"].to(I32)
            pcm[idx] = dec_m.round_pcm(y, self.cfg.bps).to(I32)
        self.last_bfi = last_bfi.cpu().numpy()
        return pcm.cpu().numpy()

    def decode(self, payload: bytes, bfi: bool | int = False) -> np.ndarray:
        """payload: the concatenated per-channel frame bytes (may be empty on
        a loss). bfi: 0/False good, 1/True lost, 3 redundancy frame (G.192,
        a fully suspect frame -> partial concealment). Returns [n_streams,
        frame_length] PCM (int16 at 16 bits per sample)."""
        ch = self.cfg.channels
        bfi = int(bfi)
        full_n = lambda v: torch.full((self.n,), v, dtype=I32, device=self.device)
        width = max(c.targetBytes for c in self.cfg.channel_configs())
        if bfi == 1 or not len(payload):
            return self._decode_core(
                torch.zeros((self.n, width), dtype=I32, device=self.device), full_n(1))
        if self.cfg.epmode > 0:
            full, bfis, be_l, be_r = self._fec_unwrap(payload)
            if bfi == 3:
                bfis = torch.where(bfis == 0, 3, bfis)
            return self._decode_core(full, bfis, be_l, be_r)
        # plain path: split across groups and channels with the remainder to
        # the lowest channels (Dec_LC3, dec_lc3.c:449-456)
        G = self.n // ch
        gbytes = len(payload) // G
        per = gbytes // ch + (0 < gbytes % ch)
        if per != self.cfg.targetBytes:
            # a frame-size switch without a state reset (update_dec_bitrate,
            # setup_dec_lc3.c:203): derive the bitrate giving this count
            self._resize(gbytes)
        raw = np.frombuffer(payload, np.uint8)
        rows = np.zeros((self.n, per), np.int32)
        for g in range(G):
            off = g * gbytes
            for c in range(ch):
                nb = gbytes // ch + (c < gbytes % ch)
                rows[g * ch + c, :nb] = raw[off:off + nb]
                off += nb
        return self._decode_core(torch.as_tensor(rows, device=self.device), full_n(bfi))

    def _resize(self, group_bytes: int) -> None:
        """Re-derive the Config for a new per-group byte count: the smallest
        bitrate whose floor-derived payload equals group_bytes, for any
        in-range count, as update_dec_bitrate (setup_dec_lc3.c:203+)."""
        ch = self.cfg.channels
        per = group_bytes // ch + (0 < group_bytes % ch)
        if not 20 <= per <= 625:  # MIN/MAX_NBYTES per channel (defines.h)
            raise ValueError(
                f"invalid frame size {group_bytes} bytes for {ch} channel(s)"
                " (LC3_NUMBYTES_ERROR)")
        new_rate = -(-group_bytes * 8 * self.cfg.fs_in // self.cfg.frame_length)
        cfg = self.cfg.with_bitrate(new_rate)
        if cfg.bitrate * cfg.frame_length // (8 * cfg.fs_in) != group_bytes:
            raise ValueError(f"cannot derive a bitrate for {group_bytes}-byte frames")
        self.cfg = cfg

    def _switch(self, mode: int, db: int, expect, gbytes: int) -> None:
        """A frame of another EP mode or payload size switches the Config
        (the reference's per-frame rederivation)."""
        if mode != self.cfg.epmode or db != expect(self.cfg):
            self.cfg = replace(self.cfg, epmode=mode,
                               bitrate=gbytes * 8 * 10000 // self.cfg.frame_dms)

    def _fec_unwrap(self, payload: bytes):
        """Channel-coder decode (Dec_LC3 framing, dec_lc3.c:324-447).
        Returns (per-lane core payloads [n, bytes], bfi [n], be_bp_left,
        be_bp_right) on the device: the corrupt bit range feeds partial
        concealment."""
        ch = self.cfg.channels
        G = self.n // ch
        gbytes = len(payload) // G
        raw = torch.frombuffer(bytearray(payload[: G * gbytes]), dtype=torch.uint8)
        raw = raw.reshape(G, gbytes).to(self.device).to(I32)
        dev = self.device
        if ch > 1 and gbytes <= 160:   # combined channel coding (dec_lc3.c:343)
            out = fec.fec_decode(raw, slot_bytes=gbytes, ccc_flag=1)
            host = torch.stack([out[k] for k in ("epmr", "error_report", "bfi", "data_bytes",
                                                 "mode")]).cpu().numpy()
            epmr, self.error_report, obfi, dbs, modes = host
            self.epmr = int(epmr.min())
            data = out["data"].cpu().numpy()
            rows = np.zeros((self.n, gbytes), np.int32)
            bfis = np.zeros((self.n,), np.int32)
            for g in range(G):
                # ccc never carries PC codewords (al_fec.c:379-390): a bfi 2
                # frame is concealed
                if obfi[g] in (1, 2) or dbs[g] == 0 or modes[g] < 1:
                    bfis[g * ch:(g + 1) * ch] = 1
                    continue
                db = int(dbs[g])
                self._switch(int(modes[g]), db,
                             lambda c: sum(cc.targetBytes for cc in c.channel_configs()), gbytes)
                off = 0
                for c in range(ch):
                    nb = db // ch + (c < db % ch)
                    rows[g * ch + c, :nb] = data[g, off:off + nb]
                    off += nb
            none = torch.full((self.n,), -1, dtype=I32, device=dev)
            return (torch.as_tensor(rows, device=dev), torch.as_tensor(bfis, device=dev),
                    none, none)
        # per-channel slots: channel c of each group gets gbytes//ch (+1 for
        # the first gbytes%ch channels)
        lane_slots = [gbytes // ch + (c < gbytes % ch) for c in range(ch)]
        offs = np.concatenate([[0], np.cumsum(lane_slots)]).astype(int)
        width = max(lane_slots)
        full = torch.zeros((G, ch, width), dtype=I32, device=dev)
        bfis = torch.zeros((G, ch), dtype=I32, device=dev)
        be_l = torch.full((G, ch), -1, dtype=I32, device=dev)
        be_r = be_l.clone()
        epmr_min = 12
        for c in range(ch):
            slot = lane_slots[c]
            out = fec.fec_decode(raw[:, offs[c]:offs[c + 1]].contiguous(), slot_bytes=slot,
                                 ccc_flag=0)
            dead = (out["bfi"] == 1) | (out["data_bytes"] == 0) | (out["mode"] < 1)
            two = ~dead & (out["bfi"] == 2)
            bfis[:, c] = torch.where(dead, 1, torch.where(two, 2, 0))
            be_l[:, c] = torch.where(two, out["be_bp_left"], -1)
            be_r[:, c] = torch.where(two, out["be_bp_right"], -1)
            # a payload with a PC block stays in transmitted (reordered)
            # order: the range decoder undoes the block move in-stream
            # (check_pc_bytes, ari_codec.c:1824-1921)
            full[:, c, :slot] = torch.where(dead[:, None], 0, out["data"])
            host = torch.stack([out["epmr"], out["error_report"], dead.to(I32),
                                out["data_bytes"], out["mode"]]).cpu().numpy()
            epmr, self.error_report, dead_h, dbs, modes = host
            epmr_min = min(epmr_min, int(epmr.min()))
            expect = lambda cfg, c=c: cfg.channel_configs()[c].targetBytes
            tb = expect(self.cfg)
            for g in np.nonzero(dead_h == 0)[0]:
                if modes[g] != self.cfg.epmode or dbs[g] != tb:
                    self._switch(int(modes[g]), int(dbs[g]), expect, gbytes)
                    tb = expect(self.cfg)
        self.epmr = epmr_min
        return (full.reshape(self.n, width), bfis.reshape(self.n), be_l.reshape(self.n),
                be_r.reshape(self.n))
