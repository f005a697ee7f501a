"""audio_codec_torch stands alone: it imports neither JAX nor anything of
audio_codec_tpu, and its entry points run on a CUDA card unless the caller
asks for the CPU."""
from __future__ import annotations

import re
import subprocess
import sys
from pathlib import Path

import pytest
import torch

import audio_codec_torch as P
from audio_codec_torch.ops import analysis, ari, bits, quant, tns

PKG = Path(P.__file__).resolve().parent


def test_import_loads_no_jax_and_no_reference_package():
    code = ("import sys, audio_codec_torch, audio_codec_torch.kernels, "
            "audio_codec_torch.fixed_decoder_dev, audio_codec_torch.ops.fixed_dev, "
            "audio_codec_torch.ops.fixed_ltpf_dev, audio_codec_torch.ops.fixed_imdct, "
            "audio_codec_torch.cli, audio_codec_torch.ccconvert, "
            "audio_codec_torch.utils.wavio, audio_codec_torch.utils.bitstream_io, "
            "audio_codec_torch.utils.native; "
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'flax', 'audio_codec_tpu')]; print(bad)")
    r = subprocess.run([sys.executable, "-c", code], cwd=PKG.parent,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr
    assert r.stdout.strip() == "[]"


def test_sources_import_no_jax_and_no_reference_package():
    pat = re.compile(r"^\s*(from|import)\s+(jax|jaxlib|flax|audio_codec_tpu)\b", re.M)
    files = sorted(PKG.rglob("*.py"))
    assert len(files) > 10
    hits = [str(f) for f in files if pat.search(f.read_text())]
    assert hits == []


def test_entry_points_raise_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is usable")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        P.enc_state_init(P.Config(fs_in=48000, bitrate=64000), 2)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        P.dec_state_init(P.Config(fs_in=48000, bitrate=64000), 2)


def test_kernel_wrappers_refuse_cpu_tensors():
    """The CUDA wrappers launch or raise; only the ops pick the plain version
    for CPU tensors."""
    from audio_codec_torch import kernels as K
    cfg = P.Config(fs_in=48000, bitrate=64000)
    xq = torch.zeros((2, cfg.yLen), dtype=torch.int32)
    with pytest.raises(ValueError, match="CUDA tensor"):
        K.bit_estimate(cfg, xq, torch.zeros(2, dtype=torch.int32), -1)
    assert quant.bit_estimate(cfg, xq, torch.full((2,), 100, dtype=torch.int32), -1)["nbits"].shape == (2,)

    f32 = lambda *s: torch.zeros(s, dtype=torch.float32)
    i32 = lambda *s: torch.zeros(s, dtype=torch.int32)
    with pytest.raises(ValueError, match="CUDA tensor"):
        K.gain_bisection(f32(2, cfg.yLen // 4), f32(2), 255)
    assert quant.gain_bisection(f32(2, cfg.yLen // 4), f32(2), 255).shape == (2,)
    lattice = (f32(2, cfg.yLen), f32(2, 2, 8), i32(2, 2), i32(2, 2), i32(2, 2))
    for name in ("tns_analysis_lattice", "tns_synthesis_lattice"):
        with pytest.raises(ValueError, match="CUDA tensor"):
            getattr(K, name)(*lattice)
        assert torch.equal(getattr(tns, name)(*lattice), lattice[0])
    with pytest.raises(ValueError, match="CUDA tensor"):
        K.hp50_biquad(f32(2, 128), f32(2, 2))
    y, mem = analysis.hp50_biquad(f32(2, 128), f32(2, 2))
    assert y.shape == (2, 128) and mem.shape == (2, 2)


def _sns_and_side_info_calls():
    from audio_codec_torch import kernels as K
    from audio_codec_torch.ops import bits, pc, sns, transforms
    cfg = P.Config(fs_in=48000, bitrate=64000)
    i32 = lambda *s: torch.zeros(s, dtype=torch.int32)
    fields = (i32(2), i32(2) + 2, i32(2), i32(2), i32(2) + 1, i32(2, 2), i32(2, 3), i32(2, 7),
              i32(2))
    return {
        "side_info_pack": (K.side_info_pack, bits.pack_side_info, (cfg, *fields)),
        "side_info_parse": (K.side_info_parse, bits.parse_side_info,
                            (cfg, i32(2, cfg.targetBytes))),
        "sns_vq_dec": (K.sns_vq_dec, sns.quantize_scf_dec, (i32(2, 7),)),
        "sns_vq_enc": (K.sns_vq_enc, lambda scf: sns.quantize_scf_enc(cfg, scf),
                       (torch.zeros((2, 16)),)),
        "tns_filter_analysis": (K.tns_filter_analysis, tns.tns_filter_analysis,
                                (cfg, torch.zeros((2, cfg.frame_length)), i32(2) + 4)),
        "pc_classify": (K.pc_classify, pc.pc_classify,
                        (cfg, i32(2) + 2, i32(2) + 5, torch.ones(2), i32(2) + 1,
                         torch.zeros((2, cfg.yLen)), torch.zeros((2, cfg.yLen)))),
        "mdct": (K.mdct, transforms.mdct, (cfg, torch.zeros((2, cfg.frame_length)),
                                           torch.zeros((2, cfg.frame_length - cfg.la_zeroes)))),
        "imdct": (K.imdct, transforms.imdct, (cfg, torch.zeros((2, cfg.frame_length)),
                                              torch.zeros((2, cfg.frame_length - cfg.la_zeroes)))),
        "olpa": (K.olpa, analysis.olpa,
                 (cfg, torch.zeros((2, cfg.len_12k8 + 1)), torch.zeros((2, 3)), torch.zeros((2, 114)),
                  i32(2) + 17)),
        "ltpf_encode": (K.ltpf_encode, analysis.ltpf_encode,
                        (cfg, torch.zeros((2, cfg.len_12k8 + 1)), i32(2) + 100, torch.ones(2),
                         torch.zeros((2, cfg.ltpf_mem_in_len)), torch.zeros(2), torch.zeros(2),
                         i32(2), torch.zeros(2))),
        "noise_residual_enc": (K.noise_residual_enc, quant.noise_residual_enc,
                               (cfg, torch.zeros((2, cfg.yLen)), i32(2, cfg.yLen), torch.ones(2),
                                i32(2) + 400, i32(2) + 200, i32(2) + 150, i32(2))),
        "spec_decode": (K.spec_decode, quant.spectrum_decode,
                        (cfg, torch.zeros((2, cfg.yLen)), torch.ones(2), i32(2), i32(2),
                         i32(2) + cfg.yLen, i32(2) + 4, i32(2), i32(2), i32(2, cfg.yLen), i32(2),
                         i32(2), i32(2), torch.zeros((2, cfg.yLen)), torch.zeros((2, cfg.yLen)),
                         torch.ones(2), i32(2) + 4, torch.zeros(2), i32(2))),
        **_concealment_calls(),
    }


def _concealment_calls():
    """The advanced concealment's kernels (plc_mode 1), with the ops that
    pick their plain versions for CPU tensors."""
    from audio_codec_torch import kernels as K
    from audio_codec_torch.ops import plc_adv, plc_phecu
    cfg = P.Config(fs_in=48000, bitrate=64000, plc_mode=1)
    i32 = lambda *s: torch.zeros(s, dtype=torch.int32)
    f32 = lambda *s: torch.zeros(s, dtype=torch.float32)
    yes = torch.ones(2, dtype=torch.bool)
    tdc = (cfg, yes, i32(2) + 1, f32(2, plc_adv.pcm_hist_len(cfg)), f32(2, 16), f32(2, cfg.yLen),
           i32(2) + 300, i32(2), f32(2), i32(2), f32(2, 17), i32(2) + 24607, f32(2), f32(2),
           i32(2), f32(2, plc_adv.max_pitch(cfg)), i32(2) + 1, f32(2, 16))
    damp = (cfg, f32(2, cfg.yLen), f32(2, cfg.yLen), yes, yes, ~yes, i32(2) + 1, i32(2), f32(2),
            i32(2), i32(2), f32(2) + 1, f32(2) + 1, f32(2) + 1, i32(2), i32(2), i32(2))
    ns, nb = plc_phecu.search_bins(cfg), plc_phecu.nbins(cfg)
    ana = (cfg, f32(2, ns), f32(2, ns), f32(2, ns), f32(2, ns), f32(2), yes)
    subst = (cfg, f32(2, nb), f32(2, nb), f32(2, ns) - 1, i32(2), i32(2) + 1, f32(2, 9),
             f32(2, 9), f32(2, 9) + 1, f32(2), f32(2, 9), i32(2), yes)
    return {"plc_tdc": (K.plc_tdc, plc_adv.plc_tdc, tdc),
            "plc_damp_scramble": (K.plc_damp_scramble, plc_adv.damp_scramble, damp),
            "phecu_spec_ana": (K.phecu_spec_ana, plc_phecu.phecu_spec_ana, ana),
            "phecu_subst": (K.phecu_subst, plc_phecu.phecu_subst, subst),
            **_fixed_decoder_calls()}


def _fixed_decoder_calls():
    """The bit-exact fixed-point decoder's kernels, with the ops that pick
    their plain versions for CPU tensors."""
    from audio_codec_torch import kernels as K
    from audio_codec_torch.fixed_decoder_dev import DeviceFixedDecoder
    from audio_codec_torch.ops import fixed_dev, fixed_ltpf_dev
    cfg = P.Config(fs_in=48000, bitrate=64000)
    i32 = lambda *s: torch.zeros(s, dtype=torch.int32)
    i64 = lambda *s: torch.zeros(s, dtype=torch.int64)
    nb = cfg.bands_number
    spec = (cfg, i32(2, cfg.yLen), i32(2, cfg.yLen), i32(2), i32(2), i32(2), i32(2), i32(2) + 4,
            i32(2), i32(2, 2, 8), i32(2, 2), i64(2, nb), i64(2, nb))
    st = DeviceFixedDecoder(cfg, 2, device="cpu").state
    ola = (cfg, st, i64(2, 480), i64(2), i64(2), torch.ones(2, dtype=torch.bool), i32(2, 3), 1)
    return {"fx_sns_dec": (K.fx_sns_dec, fixed_dev.sns_decode, (i32(2, 7), nb)),
            "fx_spec_decode": (K.fx_spec_decode, fixed_dev.spectrum_decode, spec),
            "fx_dct4": (K.fx_dct4, fixed_dev.batch_dct4, (i64(2, 480), i64(2), 480)),
            "fx_ola_ltpf": (K.fx_ola_ltpf, fixed_ltpf_dev.ola_ltpf, ola)}


@pytest.mark.parametrize("name", ["side_info_pack", "side_info_parse", "sns_vq_dec",
                                  "sns_vq_enc", "tns_filter_analysis", "pc_classify", "mdct",
                                  "imdct", "olpa", "ltpf_encode", "noise_residual_enc",
                                  "spec_decode", "plc_tdc", "plc_damp_scramble",
                                  "phecu_spec_ana", "phecu_subst", "fx_sns_dec",
                                  "fx_spec_decode", "fx_dct4", "fx_ola_ltpf"])
def test_sns_and_side_info_wrappers_refuse_cpu_tensors(name):
    """As above for the SNS quantizer, the side information, the TNS filter
    analysis, the concealment classifier, the transforms, the pitch and LTPF
    analysis, the noise factor and residual coder and the decoder's spectrum
    reconstruction: the wrapper raises on a CPU tensor, the op of the same
    arguments runs its plain version."""
    wrapper, op, args = _sns_and_side_info_calls()[name]
    with pytest.raises(ValueError, match="CUDA tensor"):
        wrapper(*args)
    out = op(*args)
    first = next(iter(out.values())) if isinstance(out, dict) else \
        out[0] if isinstance(out, tuple) else out
    assert first.shape[0] == 2


def test_fixed_dct4_refuses_sizes_it_does_not_take():
    """fx_dct4 takes the 48 kHz 10 ms row (N = 480) only; other sizes raise
    before the tensors are looked at."""
    from audio_codec_torch import kernels as K
    for N, dms in ((160, 100), (480, 50), (240, 100)):
        with pytest.raises(ValueError, match="not ported"):
            K.fx_dct4(torch.zeros((2, N), dtype=torch.int64), torch.zeros(2, dtype=torch.int64),
                      N, dms)


def test_kernel_list_holds_the_fixed_point_kernels():
    from audio_codec_torch import kernels as K
    fixed = ("fx_sns_dec", "fx_spec_decode", "fx_dct4", "fx_ola_ltpf")
    assert all(k in K.KERNELS and k in K.launches for k in fixed)
    assert {p.stem for p in K.SOURCES} >= set(fixed)
    assert len(K.KERNELS) == len(set(K.KERNELS)) == 31


def test_kernel_build_directory_is_named_by_its_inputs():
    """Processes building the same sources with the same flags share one
    library directory; another compiler or other flags get another."""
    from audio_codec_torch import kernels as K
    key = K._build_key("/usr/local/cuda/bin/nvcc")
    assert key == K._build_key("/usr/local/cuda/bin/nvcc")
    assert re.fullmatch(r"[0-9a-f]{16}", key)
    assert key != K._build_key("/opt/cuda/bin/nvcc")


def test_unported_modes_raise():
    """A concealment mode the codec does not know (plc_mode 2) raises; the
    advanced one (plc_mode 1) builds the reference's state widths. Frames
    with a partial-concealment block (EP3/EP4) are ported: they decode."""
    with pytest.raises(NotImplementedError, match="plc_mode 2"):
        P.dec_state_init(P.Config(fs_in=48000, bitrate=64000, plc_mode=2), 1, device="cpu")
    st = P.dec_state_init(P.Config(fs_in=48000, bitrate=64000, plc_mode=1), 1, device="cpu")
    widths = {k: tuple(getattr(st, k).shape[1:]) for k in (
        "plc_x_old_tot", "plc_harmonic", "plc_tdc_a", "plc_synth_hist", "phecu_X_sav",
        "phecu_f0est", "phecu_mag_chg_1st", "phecu_Xavg")}
    assert widths == {"plc_x_old_tot": (1335,), "plc_harmonic": (855,), "plc_tdc_a": (17,),
                      "plc_synth_hist": (16,), "phecu_X_sav": (385,), "phecu_f0est": (321,),
                      "phecu_mag_chg_1st": (9,), "phecu_Xavg": (9,)}
    assert st.phecu_X_sav.dtype == torch.complex64
    pc_cfg = P.Config(fs_in=48000, bitrate=128000, epmode=3)
    assert pc_cfg.n_pc > 0
    buf = torch.zeros((1, pc_cfg.targetBytes), dtype=torch.int32)
    side = bits.parse_side_info(pc_cfg, buf)
    assert ari.decode(pc_cfg, buf, side)["x"].shape == (1, pc_cfg.yLen)


def test_channel_coder_wrappers_refuse_cpu_tensors_and_bad_slots():
    from audio_codec_torch import kernels as K
    from audio_codec_torch.ops import fec
    data = torch.zeros((2, fec.fec_get_data_size(3, 0, 80)), dtype=torch.int32)
    epmr = torch.zeros(2, dtype=torch.int32)
    with pytest.raises(ValueError, match="CUDA tensor"):
        K.fec_encode(data, epmr, 80, 3, 0)
    with pytest.raises(ValueError, match="CUDA tensor"):
        K.fec_decode(torch.zeros((2, 80), dtype=torch.int32), 80, 0)
    with pytest.raises(ValueError, match="slot of 39 bytes"):
        K.fec_decode(torch.zeros((2, 39), dtype=torch.int32), 39, 0)
    with pytest.raises(ValueError, match="payload bytes"):
        fec.fec_encode(data[:, 1:], epmr, slot_bytes=80, mode=3)
    assert fec.fec_encode(data, epmr, slot_bytes=80, mode=3).shape == (2, 80)


@pytest.mark.parametrize("name", ["noise_residual_enc", "spec_decode"])
def test_spectral_kernels_refuse_hr_mode(name):
    """HR mode's 20 residual rounds are not ported: the wrappers raise for
    an HR configuration before they look at the tensors."""
    from audio_codec_torch import kernels as K
    hr = P.Config(fs_in=48000, bitrate=128000, hrmode=True)
    assert hr.hrmode
    with pytest.raises(ValueError, match="HR mode"):
        getattr(K, name)(hr, *([torch.zeros(1)] * (7 if name == "noise_residual_enc" else 18)))
