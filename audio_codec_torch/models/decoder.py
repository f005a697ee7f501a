"""Batched LC3plus decoder: one frame step over [B] streams, and a block.

Mirrors Dec_LC3_Channel (dec_lc3.c:60-322, dec_lc3_fl.c:13-130) as
`audio_codec_tpu/models/decoder.py` does: entropy parse -> arithmetic
decode -> SNS decode -> partial concealment -> residual -> noise filling
-> global gain -> TNS synthesis -> SNS shaping -> PLC -> IMDCT/OLA ->
LTPF post-filter. Concealment is the standard one (plc_mode 0) or the
advanced one (plc_mode 1: classifier, TD-PLC, Phase ECU, damped and
scrambled noise substitution; `_plc_advanced`).
"""
from __future__ import annotations

import torch

from .. import tables as T
from ..config import Config
from ..ops import ari, bits, ltpf_dec, pc, plc, plc_adv, plc_phecu, quant, sns, tns, transforms
from ..ops import numerics as nm
from .state import DecState, check_plc_mode

I32 = torch.int32
F32 = torch.float32


def decode_entropy(cfg: Config, frame_bytes: torch.Tensor, bfi_ext=None,
                   be_bp_left=None, be_bp_right=None):
    """Stateless entropy phase: side parse + arithmetic decode over [B]
    frames. Callers holding several frames per stream flatten [T, B] to
    [T*B] and run it once (decode_block)."""
    buf = frame_bytes.to(I32)
    B = buf.shape[0]
    bfi = torch.zeros((B,), dtype=I32, device=buf.device) if bfi_ext is None \
        else bfi_ext.to(I32)
    bfi_in = torch.where(bfi == 3, 2, bfi)
    side = bits.parse_side_info(cfg, buf)
    dec = ari.decode(cfg, buf, side, bfi_in=bfi_in, be_bp_left=be_bp_left,
                     be_bp_right=be_bp_right)
    return side, dec


def decode_frame(cfg: Config, st: DecState, frame_bytes: torch.Tensor, bfi_ext=None,
                 be_bp_left=None, be_bp_right=None):
    """frame_bytes: [B, nbytes] uint8/int32 on the state's device; bfi_ext:
    [B] i32 (0 good, 1 lost, 2 partially corrupt, 3 redundancy frame).
    Returns (st, pcm [B, frame_length] float in 16-bit range, aux)."""
    side, dec = decode_entropy(cfg, frame_bytes, bfi_ext, be_bp_left, be_bp_right)
    return decode_synthesis(cfg, st, side, dec, bfi_ext)


def decode_synthesis(cfg: Config, st: DecState, side, dec, bfi_ext=None):
    """Stateful phase of the decode step, consuming decode_entropy's
    (side, dec): everything from partial concealment through LTPF."""
    check_plc_mode(cfg)
    B = dec["x"].shape[0]
    N = cfg.yLen
    dev = dec["x"].device
    bfi = torch.zeros((B,), dtype=I32, device=dev) if bfi_ext is None else bfi_ext.to(I32)
    rframe = (bfi == 3).to(I32)
    bfi = torch.where(bfi == 3, 2, bfi)
    bfi = torch.where(side["bfi"] == 1, 1, torch.where(bfi == 1, 1, dec["bfi"])).to(I32)
    full_n = torch.full((B,), N, dtype=I32, device=dev)
    spec_inv_idx = torch.where(bfi == 2, dec["spec_inv_idx"], full_n)

    bw_bin_tab = nm.table(T.bw_cutoff_bins, cfg.frame_dms, device=dev, dtype=I32)
    n_bw = bw_bin_tab.shape[0]
    # a corrupt frame may signal an out-of-range bandwidth (bfi is set then)
    bw_bin = bw_bin_tab[side["bw_idx"].clamp(0, n_bw - 1).long()]

    rf = (rframe == 1) & (dec["zero_frame"] == 0) & (bfi != 1)
    bfi = torch.where(rf, 2, bfi).to(I32)
    spec_inv_idx = torch.where(rf, torch.maximum(side["lastnz"], bw_bin), spec_inv_idx)

    good = bfi != 1
    x = dec["x"].to(F32)
    scf_q = sns.quantize_scf_dec(side["scf_idx"])

    stab_fac = pc.compute_stab_fac(scf_q, st.plc_scf_q, st.plc_old_scf_q,
                                   bfi, st.plc_prevBfi, st.plc_prevprevBfi)
    bfi = torch.where(good, pc.pc_classify(cfg, bfi, spec_inv_idx, stab_fac,
                                           side["ltpf_param"][:, 0],
                                           st.plc_q_d_prev, st.pc_q_old_res), bfi)
    good = bfi != 1
    # partial concealment, residual, noise filling and global gain: one
    # kernel on the card (csrc/spec_decode.cu)
    x, q_old_res, pc_prev_gg, pc_prev_bw, pc_prev_fac_ns, pc_nb_lost = quant.spectrum_decode(
        cfg, x, quant.global_gain(cfg, side["gg_idx"]), bfi, rframe, spec_inv_idx,
        side["bw_idx"], side["fac_ns_idx"], dec["residual_present"], dec["res_bits"],
        dec["n_res"], dec["nf_seed"], dec["zero_frame"], st.pc_q_old_res, st.plc_q_d_prev,
        st.pc_prev_gg, st.pc_prev_bw_idx, st.pc_prev_fac_ns, st.pc_nb_lost)
    x = torch.where(good[:, None], tns.tns_decode(cfg, x, dec["tns_idx"], dec["tns_order"],
                                                  side["num_tns"], side["bw_idx"]), x)
    gains = sns.interpolate_scf(cfg, scf_q, encoder_side=False)
    x = torch.where(good[:, None], sns.mdct_shaping(cfg, x, gains), x)

    adv = {}
    if cfg.plc_mode == 0:
        # the concealment and its counter update: one kernel on the card
        # (csrc/plc_main.cu); nothing before the update reads the counters
        x, q_d_prev, nb_lost, cum_alpha, seed = plc.plc_main_update(
            cfg, x, st.plc_q_d_prev, bfi, st.plc_nbLostCmpt, st.plc_cum_alpha, st.plc_seed)
    else:
        x, q_d_prev, nb_lost, cum_alpha, seed, adv = _plc_advanced(
            cfg, st, x, bfi, side, spec_inv_idx, stab_fac)

    if cfg.frame_length > N:
        x_full = torch.nn.functional.pad(x, (0, cfg.frame_length - N))
    else:
        x_full = x
    pcm, imdct_mem = transforms.imdct(cfg, x_full, st.imdct_mem)
    if adv:
        # time-domain concealment (TD-PLC or Phase ECU) replaces the frame
        td = adv.pop("td_lane")[:, None]
        pcm = torch.where(td, adv.pop("td_pcm"), pcm)
        imdct_mem = torch.where(td, adv.pop("td_ola"), imdct_mem)

    if cfg.plc_mode == 0:
        prev_bfi, prevprev_bfi = bfi, st.plc_prevBfi
    else:
        nb_lost, cum_alpha, prev_bfi, prevprev_bfi = plc.plc_update(
            bfi, nb_lost, cum_alpha, st.plc_prevBfi, st.plc_prevprevBfi)
    y, mem_x, mem_y, lm = ltpf_dec.ltpf_decode(
        cfg, pcm, bfi, side["ltpf_param"], st.ltpf_param_mem, st.ltpf_mem_x,
        st.ltpf_mem_y, st.ltpf_mem_pitch_int, st.ltpf_mem_pitch_fr,
        st.ltpf_mem_gain, st.ltpf_mem_beta_idx)

    if adv:
        st = st.replace(plc_x_old_tot=plc_adv.update_pcm_hist(st.plc_x_old_tot, pcm), **adv)
    st = st.replace(
        imdct_mem=imdct_mem, ltpf_mem_x=mem_x, ltpf_mem_y=mem_y,
        ltpf_mem_pitch_int=lm["pitch_int"], ltpf_mem_pitch_fr=lm["pitch_fr"],
        ltpf_mem_gain=lm["gain"], ltpf_mem_beta_idx=lm["beta_idx"],
        ltpf_param_mem=lm["param"], plc_q_d_prev=q_d_prev,
        plc_nbLostCmpt=nb_lost, plc_prevBfi=prev_bfi, plc_prevprevBfi=prevprev_bfi,
        plc_cum_alpha=cum_alpha, plc_seed=seed, plc_old_scf_q=st.plc_scf_q,
        plc_scf_q=torch.where((bfi != 1)[:, None], scf_q, st.plc_scf_q),
        pc_q_old_res=q_old_res, pc_prev_gg=pc_prev_gg, pc_prev_bw_idx=pc_prev_bw,
        pc_prev_fac_ns=pc_prev_fac_ns, pc_nb_lost=pc_nb_lost)
    aux = dict(bfi=bfi, bw_idx=side["bw_idx"], gg_idx=side["gg_idx"], spec=x,
               spec_inv_idx=spec_inv_idx)
    return st, y, aux


def decode_block(cfg: Config, st: DecState, frames: torch.Tensor, bfi_ext=None):
    """Decode T frames of B streams: frames [T, B, nbytes] -> (st, pcm
    [T, B, frame_length]). The entropy phase runs once over the flattened
    T*B lanes; the synthesis phase steps over T."""
    check_plc_mode(cfg)
    T_, B, nb = frames.shape
    flat_bfi = None if bfi_ext is None else bfi_ext.reshape(T_ * B)
    side, dec = decode_entropy(cfg, frames.reshape(T_ * B, nb), flat_bfi)
    per_t = lambda d: {k: v.reshape(T_, B, *v.shape[1:]) for k, v in d.items()}
    side_t, dec_t = per_t(side), per_t(dec)
    pcm = []
    for t in range(T_):
        bfi_f = None if bfi_ext is None else bfi_ext[t]
        st, y, _ = decode_synthesis(cfg, st, {k: v[t] for k, v in side_t.items()},
                                    {k: v[t] for k, v in dec_t.items()}, bfi_f)
        pcm.append(y)
    return st, torch.stack(pcm, dim=0)


def _plc_advanced(cfg: Config, st: DecState, x, bfi, side, spec_inv_idx, stab_fac):
    """Advanced concealment (plc_mode 1; processPLCclassify/apply,
    plc_apply_fx.c), as `audio_codec_tpu/models/decoder.py:_plc_advanced`:
    the method chosen per lane at the first loss of a burst, TD-PLC for
    pitched low-centroid content, Phase ECU for pitched high-centroid 10 ms
    frames, damped and scrambled noise substitution otherwise, and the
    damping and scrambling of partially concealed (bfi 2) spectra.
    Returns (x, q_d_prev, nb_lost, cum_alpha, seed, adv): adv holds the
    state fields to replace and the time-domain override (td_lane, td_pcm,
    td_ola)."""
    fl = cfg.frame_length
    lost = bfi == 1
    nb_cur = torch.where(lost, st.plc_nbLostCmpt + 1, st.plc_nbLostCmpt).to(I32)
    first = lost & (nb_cur == 1)
    pitch_int = st.ltpf_mem_pitch_int
    tdc = plc_adv.plc_tdc(
        cfg, lost, nb_cur, st.plc_x_old_tot, st.plc_scf_q, st.plc_q_d_prev, pitch_int,
        st.ltpf_mem_pitch_fr, stab_fac, st.plc_meth, st.plc_tdc_a, st.plc_tdc_seed,
        st.plc_tdc_gain_c, st.plc_tdc_alpha, st.plc_tdc_fract, st.plc_harmonic,
        st.plc_harmonic_len, st.plc_synth_hist)
    meth = tdc["meth"]
    tdc_lane = lost & (meth == 3)
    ph_lane = lost & (meth == 2)
    ns_lane = lost & (meth != 3) & (meth != 2)
    td_pcm = tdc["synth"][:, :fl]
    td_ola = plc_adv.tdac(cfg, tdc["synth"])
    adv = dict(plc_meth=meth, plc_tdc_a=tdc["a"], plc_tdc_seed=tdc["seed"],
               plc_tdc_gain_c=tdc["gain_c"], plc_tdc_alpha=tdc["alpha"],
               plc_tdc_fract=tdc["fract"], plc_harmonic=tdc["harmonic_buf"],
               plc_harmonic_len=tdc["harmonic_len"], plc_synth_hist=tdc["synth_hist"])
    td_lane = tdc_lane
    if cfg.frame_dms == 100:
        ph = plc_phecu.apply(
            cfg, st.phecu_f0est, st.phecu_X_sav, st.phecu_num_plocs, st.phecu_mag_chg_1st,
            st.phecu_Xavg, st.phecu_beta_mute, st.phecu_is_trans, st.plc_x_old_tot, nb_cur,
            first & (meth == 2), ph_lane, tdc["nc"])
        td_pcm = torch.where(tdc_lane[:, None], td_pcm, ph.pop("pcm"))
        td_ola = torch.where(tdc_lane[:, None], td_ola, ph.pop("ola"))
        td_lane = tdc_lane | ph_lane
        adv.update(ph)

    x, cum_fflc, cum_slow, cum_fast, ns_seed, pc_seed = plc_adv.damp_scramble(
        cfg, x, st.plc_q_d_prev, ns_lane, lost, bfi == 2, nb_cur, st.pc_nb_lost, stab_fac,
        pitch_int, side["ltpf_param"][:, 0], st.plc_cum_fflc, st.plc_cum_slow, st.plc_cum_fast,
        st.plc_ns_seed, st.pc_seed, spec_inv_idx)
    # the history keeps the last good spectrum through a burst; bfi 2 frames
    # store their scrambled spectrum
    q_d_prev = torch.where(lost[:, None], st.plc_q_d_prev, x)
    adv.update(plc_cum_fflc=cum_fflc, plc_cum_slow=cum_slow, plc_cum_fast=cum_fast,
               plc_ns_seed=ns_seed, pc_seed=pc_seed, td_lane=td_lane, td_pcm=td_pcm,
               td_ola=td_ola)
    return x, q_d_prev, nb_cur, st.plc_cum_alpha, st.plc_seed, adv


def round_pcm(y, bps: int = 16):
    """Float synthesis -> integer PCM with saturation (dec_lc3_fl.c:116-128)."""
    if bps == 16:
        return torch.clamp(quant.round_c(y), -32768, 32767).to(torch.int16)
    return quant.round_c(y * 2.0 ** (bps - 16)).to(torch.int32)
