"""The channel coder of audio_codec_torch against audio_codec_tpu.

fec_encode and fec_decode (the fec_encode and fec_decode kernels on the card,
their plain versions here) must give every output of the reference bit for
bit: at slots of 40, 80, 150 and 300 bytes, EP1-4 and with combined channel
coding, on clean frames, correctable symbol errors, a destroyed
partial-concealment codeword, heavy corruption, frames flagged lost on the
way in, every EPMR, frames that decode as a wrong mode whose CRC fails, and
lost frames whose EPMR carries codeword 0's risk."""
from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from audio_codec_torch.ops import fec as PF
from audio_codec_tpu.ops import fec as JF

from tests import torch_kernel_cases as C


ROWS = 48   # every decode runs 48 rows with a bfi_in: one JAX compile per (slot, ccc)


def check_decode(frames: np.ndarray, slot: int, ccc: int = 0, bfi_in=None) -> dict:
    frames = np.ascontiguousarray(frames, np.int32)
    assert frames.shape == (ROWS, slot)
    bfi_in = np.zeros(ROWS, np.int32) if bfi_in is None else np.asarray(bfi_in, np.int32)
    ref = {k: np.asarray(v) for k, v in JF.fec_decode(
        jnp.asarray(frames), slot_bytes=slot, ccc_flag=ccc, bfi_in=jnp.asarray(bfi_in)).items()}
    got = PF.fec_decode(torch.from_numpy(frames.copy()), slot_bytes=slot, ccc_flag=ccc,
                        bfi_in=torch.from_numpy(bfi_in.copy()))
    assert set(got) == set(ref) == set(PF.DECODE_FIELDS)
    for k in ref:
        np.testing.assert_array_equal(got[k].numpy(), ref[k], err_msg=k)
    return ref


def roundtrip(slot: int, mode: int, ccc: int):
    data, epmr, kinds, bfi_in = C.fec_rows(slot, mode, ccc, n=ROWS)
    ref = np.asarray(JF.fec_encode(jnp.asarray(data), jnp.asarray(epmr), slot_bytes=slot,
                                   mode=mode, ccc_flag=ccc))
    got = PF.fec_encode(torch.from_numpy(data), torch.from_numpy(epmr), slot_bytes=slot,
                        mode=mode, ccc_flag=ccc)
    np.testing.assert_array_equal(got.numpy(), ref)
    clean = check_decode(ref, slot, ccc)
    assert (clean["bfi"] == 0).all() and (clean["mode"] == mode).all()
    np.testing.assert_array_equal(clean["data"][:, : data.shape[1]], data)
    np.testing.assert_array_equal(clean["epmr"], epmr)
    frames = C.channel_errors(ref, slot, mode, kinds, np.random.default_rng(1))
    return check_decode(frames, slot, ccc, bfi_in), kinds, bfi_in


@pytest.mark.parametrize("slot", C.FEC_SLOTS)
@pytest.mark.parametrize("mode", [1, 2, 3, 4])
def test_fec_encode_and_decode_bit_exact(slot, mode):
    out, kinds, bfi_in = roundtrip(slot, mode, 0)
    heavy = (kinds == C.CHANNEL_KINDS.index("heavy")) & (bfi_in == 0)
    assert (out["bfi"][heavy] == 1).all()
    assert (out["bfi"][bfi_in == 1] == 1).all() and (out["error_report"][bfi_in == 1] == -1).all()
    corrected = (kinds == C.CHANNEL_KINDS.index("correctable")) & (bfi_in == 0) & (out["bfi"] == 0)
    if mode > 1 and slot > 40:
        assert corrected.any() and ((out["error_report"][corrected] & PF.BEC_MASK) > 0).all()
    pc = (kinds == C.CHANNEL_KINDS.index("pc_codeword")) & (bfi_in == 0)
    if mode > 2 and slot >= 80:
        # a destroyed PC codeword: bfi 2 with the corrupt bits' range
        assert (out["bfi"][pc] == 2).all()
        assert (out["be_bp_right"][pc] > out["be_bp_left"][pc]).all()
        assert (out["be_bp_left"][pc] >= 0).all()


@pytest.mark.parametrize("slot", C.FEC_SLOTS)
def test_fec_combined_channel_coding_bit_exact(slot):
    """ccc_flag 1 carries no partial-concealment codewords."""
    for mode in (1, 2, 3, 4):
        out, _, _ = roundtrip(slot, mode, 1)
        assert (out["n_pccw"] == 0).all() and not (out["bfi"] == 2).any()


def test_fec_decode_wrong_mode_and_risk_frames_bit_exact():
    wrong, risk = C.wrong_mode_rows(n=4), C.epmr_risk_rows(n=8)
    rest = np.tile(risk, (ROWS // 8, 1))[: ROWS - 12]
    out = check_decode(np.concatenate([wrong, risk, rest]), 80)
    assert (out["mode"][:4] > 2).all() and (out["bfi"][:4] == 1).all()
    assert (out["mode"][4:12] == 2).all() and (out["bfi"][4:12] == 1).all()
    assert (out["epmr"][4:12] >= 4).all()


def test_slot_geometry_is_the_reference_one():
    for slot in range(PF.FEC_SLOT_BYTES_MIN, PF.FEC_SLOT_BYTES_MAX + 1):
        for mode in (1, 2, 3, 4):
            for ccc in (0, 1):
                assert PF.fec_get_data_size(mode, ccc, slot) == JF.fec_get_data_size(mode, ccc, slot)
                n = PF.fec_get_n_pccw(slot, mode, ccc)
                assert n == JF.fec_get_n_pccw(slot, mode, ccc)
                assert PF.fec_get_n_pc(mode, n, slot) == JF.fec_get_n_pc(mode, n, slot)
                assert n <= max(PF.n_codewords(slot) - 6, 0)
