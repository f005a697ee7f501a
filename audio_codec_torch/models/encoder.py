"""Batched LC3plus encoder: one frame step over [B] streams, and a block of
T frames.

Mirrors the channel pipeline Enc_LC3_Channel_fl (enc_lc3_fl.c:13-160), as
`audio_codec_tpu/models/encoder.py:encode_frame` does. The state's device
decides where the frame runs: on the card the transform, the pitch and LTPF
analysis, the high-pass, the SNS quantizer, the TNS analysis and lattice,
the gain bisection, the bit estimate, the noise factor and residual coder,
the side-info packer and the range coder are CUDA kernels (kernels.py), on
the CPU their plain versions.
"""
from __future__ import annotations

import torch

from .. import tables as T
from ..config import Config
from ..ops import analysis, ari, bits, quant, sns, tns, transforms
from .state import EncState

I32 = torch.int32
F32 = torch.float32


def encode_frame(cfg: Config, st: EncState, pcm: torch.Tensor):
    """pcm: [B, frame_length] float (16-bit range), on the state's device.
    Returns (st, bytes [B, nbytes] uint8, aux)."""
    dev = st.mdct_mem.device
    x = pcm.to(device=dev, dtype=F32)

    d, mdct_mem = transforms.mdct(cfg, x, st.mdct_mem)
    y12k8, mi, m50, mo = analysis.resample_12k8(
        cfg, x, st.r12k8_mem_in, st.r12k8_mem_50, st.r12k8_mem_out)
    T0, nc, mem_pitch, ms12, ms6 = analysis.olpa(
        cfg, y12k8, st.olpa_mem_s12k8, st.olpa_mem_s6k4, st.olpa_mem_pitch)
    (ltpf_param, ltpf_bits, ltpf_mem_in, nc_out, mem_mem_nc, mem_on,
     pitch_out) = analysis.ltpf_encode(
        cfg, y12k8, T0, nc, st.ltpf_mem_in, st.ltpf_mem_normcorr,
        st.ltpf_mem_mem_normcorr, st.ltpf_mem_ltpf_on, st.ltpf_mem_pitch)
    att, att_pos, att_acc, att_fmem = analysis.attack_detector(
        cfg, x, st.attdec_position, st.attdec_acc_energy, st.attdec_filter_mem)
    ener = analysis.per_band_energy(cfg, d)
    bw_idx = analysis.detect_cutoff_warped(cfg, ener)

    scf = sns.compute_scf(cfg, ener, att)
    scf_idx, scf_q = sns.quantize_scf_enc(cfg, scf)
    gains = sns.interpolate_scf(cfg, scf_q, encoder_side=True)
    d = sns.mdct_shaping(cfg, d, gains)
    if cfg.bandwidth:
        d = analysis.cutoff_bandwidth(cfg, d)
        bw_idx = torch.clamp(bw_idx, max=cfg.bw_ctrl_index)

    d, tns_order, tns_idx, num_tns, tns_bits = tns.tns_encode(cfg, d, bw_idx)

    target = (cfg.targetBitsInit - (tns_bits + ltpf_bits)).to(I32)
    dy = d[:, : cfg.yLen].contiguous()
    gain, gg_idx, gg_min, tbo, otb = quant.estimate_global_gain(
        cfg, dy, target, st.targetBitsOff, st.mem_targetBits, st.mem_specBits)

    xq = quant.quantize_spectrum(cfg, dy, gain)
    est = quant.bit_estimate(cfg, xq, target, mode=-1)
    gg_idx2, gain2, gain_change = quant.adjust_global_gain(
        cfg, gg_idx, gg_min, gain, target, est["nbits"])
    xq2 = quant.quantize_spectrum(cfg, dy, gain2)
    est2 = quant.bit_estimate(cfg, xq2, target, mode=cfg.modeFlag)
    changed = gain_change == 1
    pick = lambda k: torch.where(changed, est2[k], est[k])
    xq = torch.where(changed[:, None], xq2, xq)
    gain_f = torch.where(changed, gain2, gain)
    nbits2 = pick("nbits2")
    lastnz_wire = pick("lastnz2")
    lsb_mode = pick("lsbMode")
    xq = quant.truncate_spectrum(xq, pick("lastnz"), lastnz_wire)

    bw_tab = torch.as_tensor(T.bw_cutoff_bins(cfg.frame_dms), dtype=I32, device=dev)
    bw_bin = bw_tab[bw_idx.long()]
    fac_ns_idx, res_bits, n_res = quant.noise_residual_enc(
        cfg, dy, xq, gain_f, bw_bin, target, nbits2, lsb_mode)

    buf, bp_side, mask_side = bits.pack_side_info(
        cfg, bw_idx, lastnz_wire, lsb_mode, gg_idx2, num_tns, tns_order,
        ltpf_param, scf_idx, fac_ns_idx)
    out = ari.encode(cfg, buf, bp_side, mask_side, xq, tns_order, tns_idx, num_tns,
                     lastnz_wire, lsb_mode, res_bits, n_res)

    st = st.replace(
        mdct_mem=mdct_mem, r12k8_mem_in=mi, r12k8_mem_50=m50, r12k8_mem_out=mo,
        olpa_mem_s12k8=ms12, olpa_mem_s6k4=ms6, olpa_mem_pitch=mem_pitch.to(I32),
        ltpf_mem_in=ltpf_mem_in, ltpf_mem_normcorr=nc_out,
        ltpf_mem_mem_normcorr=mem_mem_nc, ltpf_mem_ltpf_on=mem_on.to(I32),
        ltpf_mem_pitch=pitch_out, attdec_filter_mem=att_fmem,
        attdec_acc_energy=att_acc, attdec_detected=att.to(I32),
        attdec_position=att_pos.to(I32), targetBitsOff=tbo, mem_targetBits=otb,
        mem_specBits=est["nbits"])
    aux = dict(bw_idx=bw_idx, gain=gain_f, xq=xq, lastnz=lastnz_wire,
               lsb_mode=lsb_mode, fac_ns_idx=fac_ns_idx, tns_order=tns_order,
               ltpf_param=ltpf_param)
    return st, out.to(torch.uint8), aux


def encode_block(cfg: Config, st: EncState, pcm: torch.Tensor):
    """Encode T frames of B streams: pcm [T, B, frame_length] ->
    (st, bytes [T, B, nbytes] uint8), the frame loop of bench.py:89-94."""
    outs = []
    for t in range(pcm.shape[0]):
        st, out, _ = encode_frame(cfg, st, pcm[t])
        outs.append(out)
    return st, torch.stack(outs, dim=0)
