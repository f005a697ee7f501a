"""The bit-exact fixed-point decoder over [T, B] frame blocks of clean
frames (`audio_codec_tpu/fixed_decoder_dev.py`; dec_lc3.c:103-293).

The frontend (side-info parse and range decoder, `ops/ari.py:
parse_and_decode`, one `ari_decode` launch on the card) runs once over all
T x B frames of a block, then the BASOP
chain of `ops/fixed_dev.py` over the same T x B lanes: the SNS decode
(`fx_sns_dec`), the spectral chain (`fx_spec_decode`) and the integer
DCT-IV (`fx_dct4`). Only the stateful overlap-add, LTPF post-filter and
PCM rounding step through the T frames, one `fx_ola_ltpf` launch a frame.
Every stage is integer arithmetic, so the int16 PCM equals the
reference's bit for bit on any device. Concealment frames (PLC, partial
concealment) are not decoded here: they stay with the reference's host
decoder (`audio_codec_tpu/fixed_decoder.py:decode_plc`) for now.
"""
from __future__ import annotations

import numpy as np
import torch

from .config import Config
from .models.state import resolve_device
from .ops import ari
from .ops import fixed_dev as fv
from .ops import fixed_imdct as fi
from .ops import fixed_ltpf as fl
from .ops import fixed_ltpf_dev as fld

I64 = torch.int64


class DeviceFixedDecoder:
    """Decode [T, B, nbytes] frame blocks of B streams, bit-exact. Runs on
    the card unless device="cpu" is passed (the plain versions)."""

    def __init__(self, cfg: Config, B: int, device=None):
        self.cfg = cfg
        self.B = B
        self.device = resolve_device(device)
        N = cfg.frame_length
        self.wLen = len(fi.window_table(N))
        self.sfi = fl.scale_fac_idx_for(cfg.total_bits, cfg.fs_idx, cfg.frame_dms)
        dev = self.device
        self.state = dict(mem=torch.zeros((B, self.wLen - N), dtype=I64, device=dev),
                          mem_e=torch.zeros((B,), dtype=I64, device=dev),
                          **fld.state_init(cfg.fs, B, dev))

    def decode_block(self, frames) -> torch.Tensor:
        """frames [T, B, nbytes] uint8 (tensor or numpy) -> PCM [T, B, N]
        int16 on the decoder's device; steps the state."""
        cfg = self.cfg
        N = cfg.frame_length
        if not isinstance(frames, torch.Tensor):
            frames = torch.from_numpy(np.array(frames, np.uint8))
        frames = frames.to(self.device)
        Tn, B, nb = frames.shape
        assert B == self.B, f"a block of {B} streams for a decoder of {self.B}"
        flat = frames.reshape(Tn * B, nb).to(torch.int32)
        side, dec = ari.parse_and_decode(cfg, flat)
        scf, scf_e = fv.sns_decode(side["scf_idx"], cfg.bands_number)
        shaped, x_e = fv.spectrum_decode(
            cfg, dec["x"], dec["res_bits"], dec["n_res"], dec["nf_seed"], dec["zero_frame"],
            side["fac_ns_idx"], side["bw_idx"], side["gg_idx"], dec["tns_idx"],
            dec["tns_order"], scf, scf_e)
        ytda, y_e, y_s, zero = fv.batch_dct4(shaped, x_e, N, cfg.frame_dms)
        ytda = ytda.reshape(Tn, B, N)
        y_e, y_s, zero = (v.reshape(Tn, B) for v in (y_e, y_s, zero))
        lp = side["ltpf_param"].reshape(Tn, B, 3)
        pcm = torch.empty((Tn, B, N), dtype=torch.int16, device=self.device)
        for t in range(Tn):
            pcm[t] = fld.ola_ltpf(cfg, self.state, ytda[t], y_e[t], y_s[t], zero[t], lp[t],
                                  self.sfi)
        return pcm


def fixed_state_from_numpy(state: dict, device=None) -> dict[str, torch.Tensor]:
    """The reference DeviceFixedDecoder's state (mem, mem_e and the LTPF
    tree, as numpy arrays) as the port's state dict on `device`: assign it
    to DeviceFixedDecoder.state to continue a stream mid-way."""
    dev = resolve_device(device)
    flat = dict(mem=state["mem"], mem_e=state["mem_e"], **state["ltpf"])
    return {k: torch.as_tensor(np.asarray(v, np.int64), device=dev).clone()
            for k, v in flat.items()}
