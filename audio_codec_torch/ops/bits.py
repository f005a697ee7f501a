"""Backward bit-level side-info packing/parsing, batched over streams.

The LC3plus frame packs side information backward from the frame end
(processEncoderEntropy_fl, enc_entropy.c:13-115; processDecoderEntropy_fl,
dec_entropy.c:121-270) while the arithmetic coder writes forward. The byte
buffer is an int32 [B, nbytes] tensor; each bit write or read touches one
byte per stream. Counterpart of `audio_codec_tpu/ops/bits.py`.

`pack_side_info` runs as the CUDA kernel `side_info_pack` (csrc/side_info.cuh)
for tensors on a card. `parse_side_info` on a card is the side dict of the
range decoder's parsed mode (`ari_decode`, kernels.ari_decode_frames: each
lane parses its frame with csrc/side_info.cuh:side_info_parse_bits); the
decoder's paths take both of its dicts through ops/ari.py:parse_and_decode.
On the CPU they run as `pack_side_info_plain` and `parse_side_info_plain`.
"""
from __future__ import annotations

import numpy as np
import torch

from .. import kernels
from ..config import Config
from . import numerics as nm

I32 = torch.int32


def _rows(buf):
    return torch.arange(buf.shape[0], device=buf.device)


def write_bit_backward(buf, bp, mask, bit, active=None):
    """One backward bit write (write_bit_backward_fl). All args [B]; the
    byte index is clipped into the buffer."""
    rows = _rows(buf)
    at = bp.clamp(0, buf.shape[1] - 1).long()
    cur = buf[rows, at]
    new = torch.where(bit == 0, cur & (255 - mask), cur | mask)
    step = mask == 128
    if active is not None:
        new = torch.where(active, new, cur)
        step = step & active
        mask_n = torch.where(active, torch.where(mask == 128, 1, mask * 2), mask)
    else:
        mask_n = torch.where(mask == 128, 1, mask * 2)
    buf = buf.clone()
    buf[rows, at] = new.to(buf.dtype)
    return buf, (bp - step.to(I32)).to(I32), mask_n.to(I32)


def _active(k: int, nbits, buf) -> torch.Tensor:
    """[B] bool: k < nbits, for nbits a [B] tensor or a number."""
    if isinstance(nbits, torch.Tensor):
        return k < nbits
    return torch.full((buf.shape[0],), k < nbits, dtype=torch.bool, device=buf.device)


def write_uint_backward(buf, bp, mask, val, nbits, max_bits: int):
    """LSB-first backward uint write; nbits may be per-stream ([B] or int)."""
    for k in range(max_bits):
        buf, bp, mask = write_bit_backward(buf, bp, mask, (val >> k) & 1,
                                           _active(k, nbits, buf))
    return buf, bp, mask


def read_bit(buf, bp, mask):
    rows = _rows(buf)
    byte = buf[rows, bp.clamp(0, buf.shape[1] - 1).long()]
    bit = ((byte & mask) != 0).to(I32)
    bp_n = torch.where(mask == 128, bp - 1, bp).to(I32)
    mask_n = torch.where(mask == 128, 1, mask * 2).to(I32)
    return bit, bp_n, mask_n


def read_uint(buf, bp, mask, nbits, max_bits: int):
    val = torch.zeros(buf.shape[0], dtype=I32, device=buf.device)
    for k in range(max_bits):
        act = _active(k, nbits, buf)
        bit, bp_n, mask_n = read_bit(buf, bp, mask)
        val = torch.where(act, val + (bit << k), val)
        bp = torch.where(act, bp_n, bp)
        mask = torch.where(act, mask_n, mask)
    return val, bp, mask


def _gain_bits(which: int) -> np.ndarray:
    """Bits of the SNS gain index's MSB (which 0) and LSB (1) field by submode."""
    return np.array([[1, 1, 2, 2], [0, 1, 0, 1]][which], np.int32)


def pack_side_info_plain(cfg: Config, bw_idx, lastnz, lsb_mode, gg_idx,
                         num_tns_filters, tns_order, ltpf_param, scf_idx, fac_ns_idx):
    """processEncoderEntropy_fl -> (buf, bp_side, mask_side), the plain
    version of the `side_info_pack` kernel. All args [B] / [B, k] int32; buf
    is a new [B, targetBytes] int32 buffer, zero but for the side bits."""
    B = scf_idx.shape[0]
    dev = scf_idx.device
    buf = torch.zeros((B, cfg.targetBytes), dtype=I32, device=dev)
    bp = torch.full((B,), cfg.targetBytes - 1, dtype=I32, device=dev)
    mask = torch.ones((B,), dtype=I32, device=dev)
    w = write_uint_backward
    if cfg.BW_cutoff_bits > 0:
        buf, bp, mask = w(buf, bp, mask, bw_idx, cfg.BW_cutoff_bits, cfg.BW_cutoff_bits)
    buf, bp, mask = w(buf, bp, mask, torch.div(lastnz, 2, rounding_mode="floor") - 1,
                      cfg.lastnz_bits, cfg.lastnz_bits)
    buf, bp, mask = write_bit_backward(buf, bp, mask, lsb_mode)
    buf, bp, mask = w(buf, bp, mask, gg_idx, 8, 8)
    for f in range(2):
        buf, bp, mask = write_bit_backward(buf, bp, mask, torch.clamp(tns_order[:, f], max=1),
                                           f < num_tns_filters)
    buf, bp, mask = write_bit_backward(buf, bp, mask, ltpf_param[:, 0])
    buf, bp, mask = w(buf, bp, mask, scf_idx[:, 0], 5, 5)
    buf, bp, mask = w(buf, bp, mask, scf_idx[:, 1], 5, 5)

    # SNS-VQ 2nd stage side info (enc_entropy.c:60-92)
    submode = scf_idx[:, 2].long()
    submode_msb = torch.div(scf_idx[:, 2], 2, rounding_mode="floor")
    submode_lsb = scf_idx[:, 2] & 1
    gain_msb_bits = nm.table(_gain_bits, 0, device=dev, dtype=I32)[submode]
    gain_lsb_bits = nm.table(_gain_bits, 1, device=dev, dtype=I32)[submode]
    buf, bp, mask = write_bit_backward(buf, bp, mask, submode_msb)
    gain_msb = scf_idx[:, 3] >> gain_lsb_bits
    gain_lsb = scf_idx[:, 3] & 1
    buf, bp, mask = w(buf, bp, mask, gain_msb, gain_msb_bits, 2)
    buf, bp, mask = write_bit_backward(buf, bp, mask, scf_idx[:, 4])
    tmp0 = torch.where(submode_lsb == 0, scf_idx[:, 6] + 2, gain_lsb) * 2390004 \
        + scf_idx[:, 5]
    tmp1 = torch.where(submode_lsb != 0, 2 * scf_idx[:, 5] + gain_lsb + 15158272,
                       scf_idx[:, 5])
    payload = torch.where(submode_msb == 0, tmp0, tmp1)
    nbits_payload = torch.where(submode_msb == 0, 25, 24)
    buf, bp, mask = w(buf, bp, mask, payload, nbits_payload, 25)

    ltpf_on = ltpf_param[:, 0] == 1
    buf, bp, mask = w(buf, bp, mask, ltpf_param[:, 1], torch.where(ltpf_on, 1, 0), 1)
    buf, bp, mask = w(buf, bp, mask, ltpf_param[:, 2], torch.where(ltpf_on, 9, 0), 9)
    buf, bp, mask = w(buf, bp, mask, fac_ns_idx, 3, 3)
    return buf, bp, mask


def pack_side_info(cfg: Config, bw_idx, lastnz, lsb_mode, gg_idx,
                   num_tns_filters, tns_order, ltpf_param, scf_idx, fac_ns_idx):
    """Side information of a frame -> (buf [B, targetBytes] int32, bp_side,
    mask_side). The `side_info_pack` kernel for tensors on a card,
    `pack_side_info_plain` on the CPU."""
    args = (cfg, bw_idx, lastnz, lsb_mode, gg_idx, num_tns_filters, tns_order,
            ltpf_param, scf_idx, fac_ns_idx)
    if nm.on_cpu(scf_idx):
        return pack_side_info_plain(*args)
    return kernels.side_info_pack(*args)


def parse_side_info_plain(cfg: Config, buf):
    """processDecoderEntropy_fl -> dict of parsed fields + (bp_side, mask_side),
    the plain version of the `ari_decode` kernel's side parse (its parsed
    mode).
    buf: [B, nbytes] int32; the reference's bfi triggers become a per-stream
    bfi flag (dec_entropy.c:152-270)."""
    B = buf.shape[0]
    dev = buf.device
    full = lambda v: torch.full((B,), v, dtype=I32, device=dev)
    bp = full(cfg.targetBytes - 1)
    mask = full(1)
    bfi = full(0)

    if cfg.BW_cutoff_bits > 0:
        bw_idx, bp, mask = read_uint(buf, bp, mask, cfg.BW_cutoff_bits, cfg.BW_cutoff_bits)
        bfi = torch.where(cfg.fs_idx < bw_idx, 1, bfi).to(I32)
    else:
        bw_idx = full(cfg.fs_idx)

    if cfg.frame_dms == 25:
        num_tns = full(1)
    else:
        num_tns = torch.where(bw_idx < 3, 1, 2).to(I32)
    lastnz, bp, mask = read_uint(buf, bp, mask, cfg.lastnz_bits, cfg.lastnz_bits)
    lastnz = (lastnz + 1) * 2
    bfi = torch.where(lastnz > cfg.yLen, 1, bfi).to(I32)
    lsb_mode, bp, mask = read_bit(buf, bp, mask)
    gg_idx, bp, mask = read_uint(buf, bp, mask, 8, 8)
    tns_on = []
    for f in range(2):
        bit, bp_n, mask_n = read_bit(buf, bp, mask)
        act = f < num_tns
        tns_on.append(torch.where(act, bit, 0))
        bp = torch.where(act, bp_n, bp)
        mask = torch.where(act, mask_n, mask)
    tns_on = torch.stack(tns_on, dim=1).to(I32)
    ltpf0, bp, mask = read_bit(buf, bp, mask)
    s0, bp, mask = read_uint(buf, bp, mask, 5, 5)
    s1, bp, mask = read_uint(buf, bp, mask, 5, 5)

    submode_msb, bp, mask = read_bit(buf, bp, mask)
    gain_msb_bits = torch.where(submode_msb == 0, 1, 2)
    s3, bp, mask = read_uint(buf, bp, mask, gain_msb_bits, 2)
    s4, bp, mask = read_bit(buf, bp, mask)
    nbits_payload = torch.where(submode_msb == 0, 25, 24)
    tmp, bp, mask = read_uint(buf, bp, mask, nbits_payload, 25)
    ind = torch.div(tmp, 2390004, rounding_mode="floor")
    bfi = torch.where((submode_msb == 0) & (tmp >= 33460056), 1, bfi)
    lsb0 = ind < 2
    s3_m0 = torch.where(lsb0, s3 * 2 + ind, s3)
    s5_m0 = tmp - ind * 2390004
    s6_m0 = torch.where(lsb0, -2, ind - 2)
    bfi = torch.where((submode_msb == 1) & (tmp >= 16708096), 1, bfi)
    lsb1 = tmp >= 15158272
    s3_m1 = torch.where(lsb1, s3 * 2 + ((tmp - 15158272) & 1), s3)
    s5_m1 = torch.where(lsb1, torch.div(tmp - 15158272, 2, rounding_mode="floor"), tmp)
    s6_m1 = torch.where(lsb1, -2, -1)
    is0 = submode_msb == 0
    s3 = torch.where(is0, s3_m0, s3_m1)
    s5 = torch.where(is0, s5_m0, s5_m1)
    s6 = torch.where(is0, s6_m0, s6_m1)
    submode_lsb = torch.where(is0, lsb0, lsb1).to(I32)
    s2 = submode_msb * 2 + submode_lsb
    scf_idx = torch.stack([s0, s1, s2, s3, s4, s5, s6], dim=1).to(I32)

    ltpf_on = ltpf0 == 1
    l1, bp, mask = read_uint(buf, bp, mask, torch.where(ltpf_on, 1, 0), 1)
    l2, bp, mask = read_uint(buf, bp, mask, torch.where(ltpf_on, 9, 0), 9)
    ltpf_param = torch.stack([ltpf0, l1, l2], dim=1).to(I32)
    fac_ns, bp, mask = read_uint(buf, bp, mask, 3, 3)
    return dict(bfi=bfi.to(I32), bw_idx=bw_idx, lastnz=lastnz.to(I32),
                lsb_mode=lsb_mode, gg_idx=gg_idx, tns_on=tns_on, num_tns=num_tns,
                scf_idx=scf_idx, ltpf_param=ltpf_param, fac_ns_idx=fac_ns,
                bp_side=bp, mask_side=mask)


def parse_side_info(cfg: Config, buf):
    """Frames [B, nbytes] int32 -> dict of the parsed side fields, bfi, and
    the range decoder's (bp_side, mask_side). For a tensor on a card the side
    dict of one `ari_decode` launch in its parsed mode
    (kernels.side_info_parse), `parse_side_info_plain` on the CPU."""
    if nm.on_cpu(buf):
        return parse_side_info_plain(cfg, buf)
    return kernels.side_info_parse(cfg, buf)
