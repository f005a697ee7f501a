"""Per-stream codec state as dataclasses of [n_streams, ...] tensors.

Field names, shapes, dtypes and initial values are those of
`audio_codec_tpu/models/state.py` (EncState, DecState), so a state moves
between the two packages as a dict of numpy arrays (`*_from_numpy`,
`*_to_numpy`). The reference keeps this state in malloc'd structs
(EncSetup, setup_enc_lc3.h:17-63; DecSetup, setup_dec_lc3.h:17-58).
"""
from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from .. import tables as T
from ..config import Config

F32, I32 = torch.float32, torch.int32


def resolve_device(device=None) -> torch.device:
    """The device the codec runs on: CUDA unless the caller names another.
    There is no silent fallback: without a card, only an explicit
    device="cpu" runs (the plain versions of the kernels)."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "audio_codec_torch runs on a CUDA device and none is available; "
                "pass device='cpu' to run the plain versions on the CPU")
        device = "cuda"
    dev = torch.device(device)
    if dev.type == "cuda":
        # the DCT-IV products must stay in full float32 (no TF32)
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    return dev


@dataclasses.dataclass
class EncState:
    mdct_mem: torch.Tensor          # [B, frame_length - la_zeroes]
    r12k8_mem_in: torch.Tensor      # [B, mem_in_len]
    r12k8_mem_50: torch.Tensor      # [B, 2] biquad state
    r12k8_mem_out: torch.Tensor     # [B, 24]
    olpa_mem_s12k8: torch.Tensor    # [B, 3]
    olpa_mem_s6k4: torch.Tensor     # [B, MAX_PITCH_6K4 (+16 at 2.5 ms)]
    olpa_mem_pitch: torch.Tensor    # [B] int32, init 17
    ltpf_mem_in: torch.Tensor       # [B, ltpf_mem_in_len]
    ltpf_mem_normcorr: torch.Tensor       # [B]
    ltpf_mem_mem_normcorr: torch.Tensor   # [B]
    ltpf_mem_ltpf_on: torch.Tensor        # [B] int32
    ltpf_mem_pitch: torch.Tensor          # [B] float32
    attdec_filter_mem: torch.Tensor  # [B, 2]
    attdec_acc_energy: torch.Tensor  # [B]
    attdec_detected: torch.Tensor    # [B] int32
    attdec_position: torch.Tensor    # [B] int32
    targetBitsOff: torch.Tensor      # [B] float32
    mem_targetBits: torch.Tensor     # [B] int32
    mem_specBits: torch.Tensor       # [B] int32

    def replace(self, **kw):
        return dataclasses.replace(self, **kw)


def enc_state_init(cfg: Config, n_streams: int, device=None) -> EncState:
    dev = resolve_device(device)
    B = n_streams
    z = lambda *shape: torch.zeros((B, *shape), dtype=F32, device=dev)
    zi = lambda *shape: torch.zeros((B, *shape), dtype=I32, device=dev)
    return EncState(
        mdct_mem=z(cfg.frame_length - cfg.la_zeroes),
        r12k8_mem_in=z(cfg.mem_in_len),
        r12k8_mem_50=z(2),
        r12k8_mem_out=z(24),
        olpa_mem_s12k8=z(3),
        olpa_mem_s6k4=z(T.MAX_PITCH_6K4 + (16 if cfg.frame_dms == 25 else 0)),
        olpa_mem_pitch=torch.full((B,), 17, dtype=I32, device=dev),
        ltpf_mem_in=z(cfg.ltpf_mem_in_len),
        ltpf_mem_normcorr=z(),
        ltpf_mem_mem_normcorr=z(),
        ltpf_mem_ltpf_on=zi(),
        ltpf_mem_pitch=z(),
        attdec_filter_mem=z(2),
        attdec_acc_energy=z(),
        attdec_detected=zi(),
        attdec_position=zi(),
        targetBitsOff=z(),
        mem_targetBits=zi(),
        mem_specBits=zi(),
    )


def ltpf_dec_lens(cfg: Config) -> tuple[int, int, int, int]:
    """(old_x_len, old_y_len, tilt_len, inter_len_r) per ltpf_decoder.c:88-150."""
    fs = cfg.fs
    if fs in (8000, 16000):
        inter_len_r, tilt_len_r = 4, 3
    elif fs == 24000:
        inter_len_r, tilt_len_r = 6, 5
    elif fs == 32000:
        inter_len_r, tilt_len_r = 8, 7
    else:
        inter_len_r, tilt_len_r = 12, 11
    tilt_len = tilt_len_r - 1
    inter_len = max(fs, 16000) // 8000
    return tilt_len, math.ceil(228 * fs / 12800) + inter_len, tilt_len, inter_len_r


@dataclasses.dataclass
class DecState:
    imdct_mem: torch.Tensor         # [B, frame_length - la_zeroes]
    ltpf_mem_x: torch.Tensor        # [B, old_x_len]
    ltpf_mem_y: torch.Tensor        # [B, old_y_len]
    ltpf_mem_pitch_int: torch.Tensor  # [B] int32
    ltpf_mem_pitch_fr: torch.Tensor   # [B] int32
    ltpf_mem_gain: torch.Tensor       # [B] float32
    ltpf_mem_beta_idx: torch.Tensor   # [B] int32, init -1
    ltpf_param_mem: torch.Tensor      # [B, 3] int32
    plc_q_d_prev: torch.Tensor      # [B, yLen]
    plc_nbLostCmpt: torch.Tensor    # [B] int32
    plc_prevBfi: torch.Tensor       # [B] int32
    plc_prevprevBfi: torch.Tensor   # [B] int32
    plc_cum_alpha: torch.Tensor     # [B] float32, init 1
    plc_seed: torch.Tensor          # [B] int32, init 24607
    plc_scf_q: torch.Tensor         # [B, 16]
    plc_old_scf_q: torch.Tensor     # [B, 16]
    # advanced PLC (plc_mode 1; AplcSetup, setup_dec_lc3.c:118-160):
    # zero-width at plc_mode 0
    plc_x_old_tot: torch.Tensor     # [B, max_pitch + frame] PCM history
    plc_meth: torch.Tensor          # [B] i32 concealment method of the burst
    plc_tdc_a: torch.Tensor         # [B, 17] LPC coefficients
    plc_tdc_seed: torch.Tensor      # [B] i32, init 24607
    plc_tdc_gain_c: torch.Tensor    # [B]
    plc_tdc_alpha: torch.Tensor     # [B] damping / gain_p memory
    plc_tdc_fract: torch.Tensor     # [B] i32 pitch fraction
    plc_harmonic: torch.Tensor      # [B, max_pitch] repeated pitch cycle
    plc_harmonic_len: torch.Tensor  # [B] i32
    plc_synth_hist: torch.Tensor    # [B, 16] LPC synthesis memory
    plc_cum_fflc: torch.Tensor      # [B] cumulative rapid-fade factor
    plc_cum_slow: torch.Tensor      # [B]
    plc_cum_fast: torch.Tensor      # [B]
    plc_ns_seed: torch.Tensor       # [B] i32, init 24607 (scrambling, bfi 1)
    pc_seed: torch.Tensor           # [B] i32, init 24607 (scrambling, bfi 2)
    # Phase ECU (method 2): zero-width unless plc_mode 1 at 10 ms frames
    phecu_X_sav: torch.Tensor       # [B, Lprot/2+1] complex64 prototype spectrum
    phecu_f0est: torch.Tensor       # [B, search bins] fractional peaks, -1 elsewhere
    phecu_num_plocs: torch.Tensor   # [B] i32
    phecu_mag_chg_1st: torch.Tensor  # [B, 9] per-band transient attenuation
    phecu_Xavg: torch.Tensor        # [B, 9] band magnitude to fade to
    phecu_beta_mute: torch.Tensor   # [B] long-term mute factor, init 0.5
    phecu_is_trans: torch.Tensor    # [B] i32 transient flag
    # partial concealment
    pc_q_old_res: torch.Tensor      # [B, yLen]
    pc_prev_gg: torch.Tensor        # [B] float32
    pc_prev_bw_idx: torch.Tensor    # [B] int32
    pc_prev_fac_ns: torch.Tensor    # [B] float32
    pc_nb_lost: torch.Tensor        # [B] int32

    def replace(self, **kw):
        return dataclasses.replace(self, **kw)


def check_plc_mode(cfg: Config):
    """The concealment modes of the reference package: 0 (standard) and 1
    (advanced: classifier, TD-PLC, noise substitution, Phase ECU)."""
    if cfg.plc_mode not in (0, 1):
        raise NotImplementedError(
            f"plc_mode {cfg.plc_mode}: the codec knows modes 0 (standard) and 1 (advanced)")


def dec_state_init(cfg: Config, n_streams: int, device=None) -> DecState:
    from ..ops import plc_adv, plc_phecu
    check_plc_mode(cfg)
    dev = resolve_device(device)
    B = n_streams
    z = lambda *shape: torch.zeros((B, *shape), dtype=F32, device=dev)
    zi = lambda *shape: torch.zeros((B, *shape), dtype=I32, device=dev)
    full = lambda v, dt: torch.full((B,), v, dtype=dt, device=dev)
    adv = lambda n: n if cfg.plc_mode else 0
    ph = lambda n: n if cfg.plc_mode and cfg.frame_dms == 100 else 0
    old_x_len, old_y_len, _, _ = ltpf_dec_lens(cfg)
    return DecState(
        imdct_mem=z(cfg.frame_length - cfg.la_zeroes),
        ltpf_mem_x=z(old_x_len),
        ltpf_mem_y=z(old_y_len),
        ltpf_mem_pitch_int=zi(),
        ltpf_mem_pitch_fr=zi(),
        ltpf_mem_gain=z(),
        ltpf_mem_beta_idx=full(-1, I32),
        ltpf_param_mem=zi(3),
        plc_q_d_prev=z(cfg.yLen),
        plc_nbLostCmpt=zi(),
        plc_prevBfi=zi(),
        plc_prevprevBfi=zi(),
        plc_cum_alpha=full(1.0, F32),
        plc_seed=full(24607, I32),
        plc_scf_q=z(16),
        plc_old_scf_q=z(16),
        plc_x_old_tot=z(adv(plc_adv.pcm_hist_len(cfg))),
        plc_meth=zi(),
        plc_tdc_a=z(adv(17)),
        plc_tdc_seed=full(24607, I32),
        plc_tdc_gain_c=z(),
        plc_tdc_alpha=z(),
        plc_tdc_fract=zi(),
        plc_harmonic=z(adv(plc_adv.max_pitch(cfg))),
        plc_harmonic_len=full(1, I32),
        plc_synth_hist=z(adv(16)),
        plc_cum_fflc=full(1.0, F32),
        plc_cum_slow=full(1.0, F32),
        plc_cum_fast=full(1.0, F32),
        plc_ns_seed=full(24607, I32),
        pc_seed=full(24607, I32),
        phecu_X_sav=torch.zeros((B, ph(plc_phecu.nbins(cfg))), dtype=torch.complex64,
                                device=dev),
        phecu_f0est=torch.full((B, ph(plc_phecu.search_bins(cfg))), -1.0, dtype=F32,
                               device=dev),
        phecu_num_plocs=zi(),
        phecu_mag_chg_1st=torch.ones((B, ph(plc_phecu.MAX_LGW)), dtype=F32, device=dev),
        phecu_Xavg=z(ph(plc_phecu.MAX_LGW)),
        phecu_beta_mute=full(0.5, F32),
        phecu_is_trans=zi(),
        pc_q_old_res=z(cfg.yLen),
        pc_prev_gg=z(),
        pc_prev_bw_idx=zi(),
        pc_prev_fac_ns=z(),
        pc_nb_lost=zi(),
    )


def _from_numpy(cls, arrays: dict, device):
    dev = resolve_device(device)
    names = [f.name for f in dataclasses.fields(cls)]
    if set(arrays) != set(names):
        raise ValueError(f"state fields differ: missing {set(names) - set(arrays)}, "
                         f"extra {set(arrays) - set(names)}")
    return cls(**{n: torch.as_tensor(np.ascontiguousarray(arrays[n]), device=dev)
                  for n in names})


def _to_numpy(st) -> dict[str, np.ndarray]:
    return {f.name: getattr(st, f.name).detach().cpu().numpy()
            for f in dataclasses.fields(st)}


def enc_state_from_numpy(arrays: dict, device=None) -> EncState:
    """EncState from a dict of numpy arrays keyed by field name (the leaves
    of `audio_codec_tpu.models.state.EncState`)."""
    return _from_numpy(EncState, arrays, device)


def enc_state_to_numpy(st: EncState) -> dict[str, np.ndarray]:
    return _to_numpy(st)


def dec_state_from_numpy(arrays: dict, device=None) -> DecState:
    """DecState from a dict of numpy arrays keyed by field name."""
    return _from_numpy(DecState, arrays, device)


def dec_state_to_numpy(st: DecState) -> dict[str, np.ndarray]:
    return _to_numpy(st)
