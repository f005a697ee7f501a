"""Static frame/bitrate configuration of the LC3plus codec.

The configuration-derivation math of the reference (setup_enc_lc3.c:31-393,
setup_dec_lc3.c:33-300) as a frozen dataclass. Field names, defaults and
derived values are those of `audio_codec_tpu.config.Config`, so the two
packages agree on every operating point.
"""
from __future__ import annotations

import math
from dataclasses import dataclass, replace

from . import tables as T
from .ops.fec import (FEC_SLOT_BYTES_MAX, FEC_SLOT_BYTES_MIN, fec_get_data_size,
                      fec_get_n_pc, fec_get_n_pccw)


def _codec_fs(fs: int) -> int:
    return 48000 if fs == 44100 else fs


def _fs_idx(fs: int) -> int:
    return min(fs // 10000, 5)


@dataclass(frozen=True)
class Config:
    """All static, shape-determining parameters for one operating point."""

    fs_in: int              # input/output sampling rate (44100 allowed)
    bitrate: int            # total bitrate, bits/s
    frame_dms: int = 100    # frame duration in 0.1 ms units: 25 / 50 / 100
    channels: int = 1
    hrmode: bool = False
    bandwidth: int = 0      # bandwidth controller cutoff in Hz, 0 = off
    bps: int = 16           # PCM bits per sample (16/24/32)
    epmode: int = 0         # channel-coder error protection mode, 0..4
    ch_idx: int = 0         # which channel this Config's budgets describe
    plc_mode: int = 0       # 0 = standard concealment, 1 = advanced PLC

    # ---- derived (filled by __post_init__ via object.__setattr__) ----
    fs: int = 0
    fs_idx: int = 0
    frame_length: int = 0
    yLen: int = 0
    la_zeroes: int = 0
    bands_number: int = 0
    tilt: int = 0
    nSubdivisions: int = 0
    tnsMaxOrder: int = 0
    sns_damping: float = 0.0
    BW_cutoff_bits: int = 0
    bw_ctrl_cutoff_bin: int = 0
    bw_ctrl_index: int = 0
    ccc: int = 0
    slotBytes: int = 0
    n_pccw: int = 0
    n_pc: int = 0
    targetBytes: int = 0
    total_bits: int = 0
    targetBitsInit: int = 0
    targetBitsAri: int = 0
    enable_lpc_weighting: bool = False
    ltpf_enable: bool = False
    quantizedGainOff: int = 0
    attack_handling: bool = False
    regBits: int = -1
    ltpf_conf_beta: float = 0.0
    ltpf_conf_beta_idx: int = -1
    N_red_tns: int = 0
    fs_red_tns: int = 0

    def __post_init__(self):
        s = object.__setattr__
        fs = _codec_fs(self.fs_in)
        fs_idx = _fs_idx(fs)
        hrmode = self.hrmode or fs_idx == 5
        s(self, "fs", fs)
        s(self, "fs_idx", fs_idx)
        s(self, "hrmode", hrmode)
        frame_ms = self.frame_dms / 10.0

        frame_length = math.ceil(fs * 10 / 1000)
        yLen = frame_length if hrmode else min(T.MAX_NBYTES, 400, frame_length)
        if self.frame_dms == 25:
            frame_length >>= 2
            yLen //= 4
        elif self.frame_dms == 50:
            frame_length >>= 1
            yLen //= 2
        s(self, "frame_length", frame_length)
        s(self, "yLen", yLen)
        s(self, "la_zeroes", T.la_zeroes(fs_idx, self.frame_dms))
        s(self, "bands_number", T.bands_number(fs_idx, self.frame_dms, hrmode))
        s(self, "tilt", T.tilt(fs))
        s(self, "nSubdivisions", 3 if self.frame_dms == 100 else 2)
        s(self, "tnsMaxOrder", 8 if self.frame_dms > 50 else 4)
        s(self, "sns_damping", 0.6 if hrmode else 0.85)
        s(self, "BW_cutoff_bits",
          0 if hrmode else int(T.t("BW_cutoff_bits_all")[fs_idx]))

        # --- bandwidth controller (lc3_enc_set_bandwidth, lc3.c:187-207) ---
        if self.bandwidth:
            if hrmode:
                raise ValueError("high resolution mode and bandwidth "
                                 "switching are exclusive (LC3_HRMODE_BW_ERROR)")
            effective_fs = min(self.fs_in, 40000)
            if self.bandwidth * 2 > effective_fs:
                raise ValueError(f"invalid bandwidth frequency "
                                 f"{self.bandwidth} (LC3_BW_WARNING)")
            s(self, "bw_ctrl_cutoff_bin",
              self.bandwidth * self.frame_dms // 5000)
            s(self, "bw_ctrl_index", max(0, self.bandwidth // 4000 - 1))

        # --- bitrate-derived (update_enc_bitrate, setup_enc_lc3.c:146-260) ---
        ch = self.channels
        if not 0 <= self.epmode <= 4:
            raise ValueError(f"epmode must be in 0..4, got {self.epmode}")
        if not 0 <= self.ch_idx < ch:
            raise ValueError(f"ch_idx {self.ch_idx} out of range for "
                             f"{ch} channels")
        total_bytes = self.bitrate * frame_length // (8 * self.fs_in)
        ccc = 1 if (ch > 1 and self.epmode and total_bytes <= 160) else 0
        s(self, "ccc", ccc)
        if self.epmode > 0:
            max_bytes = self.bitrate * frame_length // (8 * self.fs_in * ch)
            if not FEC_SLOT_BYTES_MIN <= max_bytes <= FEC_SLOT_BYTES_MAX:
                raise ValueError(
                    f"epmode {self.epmode}: per-channel slot of {max_bytes} "
                    f"bytes outside [{FEC_SLOT_BYTES_MIN}, "
                    f"{FEC_SLOT_BYTES_MAX}] (LC3_BITRATE_ERROR)")
            if ccc:
                data_total = fec_get_data_size(self.epmode, 1, total_bytes)
                target_bytes = (data_total // ch
                                + (self.ch_idx < data_total % ch))
                s(self, "slotBytes", total_bytes)
                s(self, "n_pccw", fec_get_n_pccw(total_bytes, self.epmode, 1))
                s(self, "n_pc", fec_get_n_pc(self.epmode, self.n_pccw,
                                             total_bytes))
            else:
                slot_bytes = total_bytes // ch + (self.ch_idx < total_bytes % ch)
                s(self, "slotBytes", slot_bytes)
                s(self, "n_pccw", fec_get_n_pccw(slot_bytes, self.epmode, 0))
                s(self, "n_pc", fec_get_n_pc(self.epmode, self.n_pccw,
                                             slot_bytes))
                target_bytes = fec_get_data_size(self.epmode, 0, slot_bytes)
        else:
            target_bytes = total_bytes // ch + (self.ch_idx < total_bytes % ch)
            s(self, "slotBytes", target_bytes)
            s(self, "n_pccw", 0)
            s(self, "n_pc", 0)
        s(self, "targetBytes", target_bytes)
        total_bits = target_bytes * 8
        s(self, "total_bits", total_bits)
        tbi = (total_bits - 38 - 8 - 3 - self.BW_cutoff_bits
               - math.ceil(math.log2(frame_length / 2)) - 2 - 1)
        if total_bits > 1280:
            tbi -= 1
        if total_bits > 2560:
            tbi -= 1
        if hrmode:
            tbi -= 1
        s(self, "targetBitsInit", tbi)
        s(self, "targetBitsAri", total_bits)
        lpc_thresh = {100: 480, 50: 240, 25: 120}[self.frame_dms]
        s(self, "enable_lpc_weighting", total_bits < lpc_thresh)
        s(self, "quantizedGainOff",
          -(min(115, total_bits // (10 * (fs_idx + 1))) + 105 + 5 * (fs_idx + 1)))

        attack = False
        if self.frame_dms == 100 and not hrmode:
            if (((self.fs_in >= 44100 and target_bytes >= 100)
                 or (self.fs_in == 32000 and target_bytes >= 81))
                    and target_bytes < 340):
                attack = True
        s(self, "attack_handling", attack)

        bits_tmp = total_bits
        if self.frame_dms == 25:
            bits_tmp = int(total_bits * 4.0 * 0.6)
        elif self.frame_dms == 50:
            bits_tmp = total_bits * 2 - 160
        s(self, "ltpf_enable", bits_tmp < 640 + (fs_idx - 1) * 80 and not hrmode)

        if hrmode and fs_idx >= 4:
            real_rate = target_bytes * 8000 / frame_ms
            reg = int(real_rate / 12500)
            if fs_idx == 5:
                reg += {100: 2, 50: 0, 25: -6}[self.frame_dms]
            else:
                reg += {100: 5, 50: 0, 25: -6}[self.frame_dms]
            s(self, "regBits", reg)
        else:
            s(self, "regBits", -1)

        # --- decoder-side (update_dec_bitrate, setup_dec_lc3.c:203-300) ---
        if bits_tmp < 400 + (fs_idx - 1) * 80:
            beta, beta_idx = 0.4, 0
        elif bits_tmp < 480 + (fs_idx - 1) * 80:
            beta, beta_idx = 0.35, 1
        elif bits_tmp < 560 + (fs_idx - 1) * 80:
            beta, beta_idx = 0.3, 2
        elif bits_tmp < 640 + (fs_idx - 1) * 80:
            beta, beta_idx = 0.25, 3
        else:
            beta, beta_idx = 0.0, -1
        if hrmode:
            beta, beta_idx = 0.0, -1
        s(self, "ltpf_conf_beta", beta)
        s(self, "ltpf_conf_beta_idx", beta_idx)
        if frame_length > 4 * self.frame_dms:
            s(self, "N_red_tns", 4 * self.frame_dms)
            s(self, "fs_red_tns", 40000)
        else:
            s(self, "N_red_tns", frame_length)
            s(self, "fs_red_tns", fs)

    # ---- convenience ----
    @property
    def frame_ms(self) -> float:
        return self.frame_dms / 10.0

    @property
    def len_12k8(self) -> int:
        return T.LEN_12K8 * self.frame_dms // 100

    @property
    def mem_in_len(self) -> int:
        """12.8 kHz resampler input history length (r12k8_mem_in_len)."""
        return 2 * 8 * self.fs // 12800

    @property
    def ltpf_mem_in_len(self) -> int:
        n = T.LTPF_MEMIN_LEN
        if self.frame_dms == 25:
            n += T.LEN_12K8 >> 2
        return n

    @property
    def lastnz_bits(self) -> int:
        return math.ceil(math.log2(self.yLen / 2))

    @property
    def rateFlag(self) -> int:
        """Context-model rate flag (quantize_spec.c:55-58)."""
        fs = self.fs
        if (fs < 48000 and self.total_bits > 320 + (fs // 8000 - 2) * 160) or \
           (fs == 48000 and self.total_bits > 800):
            return 512
        return 0

    @property
    def modeFlag(self) -> int:
        """Initial lsb-mode eligibility (quantize_spec.c:61-64)."""
        fs = self.fs
        if (fs < 48000 and self.total_bits >= 640 + (fs // 8000 - 2) * 160) or \
           (fs == 48000 and self.total_bits >= 1120):
            return 1
        return 0

    def with_bitrate(self, bitrate: int) -> "Config":
        return replace(self, bitrate=bitrate)

    def channel_configs(self) -> tuple["Config", ...]:
        if self.channels == 1:
            return (self,)
        return tuple(replace(self, ch_idx=c) for c in range(self.channels))
