"""Packet loss concealment, standard noise substitution (method 0).

Counterpart of `audio_codec_tpu/ops/plc.py`: processPlcMain_fl
(plc_main.c:13-53) with processNoiseSubstitution0_fl
(plc_noise_substitution0.c:14-46), a spectrum repeat with per-bin sign
scrambling and cumulative damping, plus processPlcUpdate_fl
(plc_update.c:13-30). The per-bin LCG runs in closed form (an affine map
modulo 2^16), as in the reference package.

The decoder's plc_mode 0 step is `plc_main_update`: on the card the CUDA
kernel `plc_main` (csrc/plc_main.cu), which fuses the update's counter rule
after the concealment; on the CPU its plain version `plc_main_plain`.
`plc_main` and `plc_update` are the reference's two functions; the
advanced concealment (plc_mode 1) calls `plc_update` on its own.
"""
from __future__ import annotations

import functools

import numpy as np
import torch

from .. import kernels
from ..config import Config
from . import numerics as nm

F32 = torch.float32
I32 = torch.int32


@functools.cache
def _lcg_tables(n: int):
    """seed' = 16831 + seed * 12821 folded into [-32768, 32767]; on
    u = seed + 32768: u' = (u * 12821 + C0) mod 2^16."""
    a = 12821
    c0 = (16831 - 32768 * a + 32768) % 65536
    mult = np.zeros(n, np.int64)
    add = np.zeros(n, np.int64)
    m, ad = 1, 0
    for k in range(n):
        mult[k], add[k] = m, ad
        m = (m * a) % 65536
        ad = (ad * a + c0) % 65536
    return mult, add


def _lcg_part(n: int, which: int) -> np.ndarray:
    return _lcg_tables(n)[which]


def noise_substitution(cfg: Config, q_d_prev, nb_lost, cum_alpha, seed):
    """One concealed frame: (spec [B, yLen], new_cum_alpha, new_seed).
    nb_lost: [B] loss counter already incremented for this frame."""
    dev = q_d_prev.device
    alpha = torch.where(nb_lost < 4, 1.0, torch.where(nb_lost < 8, 0.9, 0.85)).to(F32)
    cum = cum_alpha * alpha
    mult, add = (nm.table(_lcg_part, cfg.yLen + 1, k, device=dev, dtype=torch.int64)
                 for k in (0, 1))
    u0 = seed.to(torch.int64) + 32768
    uk = (u0[:, None] * mult[None, 1:] + add[None, 1:]) & 65535
    spec = torch.where(uk < 32768, -q_d_prev * cum[:, None], q_d_prev * cum[:, None])
    return spec, cum, (uk[:, -1] - 32768).to(I32)


def plc_main(cfg: Config, spec, q_d_prev, bfi, nb_lost, cum_alpha, seed):
    """processPlcMain_fl for method 0: conceal iff bfi == 1, update the
    previous spectrum. Returns (spec_out, q_d_prev, nb_lost, cum_alpha, seed)."""
    lost = bfi == 1
    nb_lost_new = torch.where(lost, nb_lost + 1, nb_lost).to(I32)
    conc, cum2, seed2 = noise_substitution(cfg, q_d_prev, nb_lost_new, cum_alpha, seed)
    spec_out = torch.where(lost[:, None], conc, spec)
    q_d_prev_new = torch.where(lost[:, None], q_d_prev, spec)
    return (spec_out, q_d_prev_new, nb_lost_new, torch.where(lost, cum2, cum_alpha),
            torch.where(lost, seed2, seed))


def plc_update(bfi, nb_lost, cum_alpha, prev_bfi, prevprev_bfi):
    """processPlcUpdate_fl (plc_update.c:13-30)."""
    good = bfi != 1
    nb_lost = torch.where(good, 0, nb_lost).to(I32)
    cum_alpha = torch.where(good, 1.0, cum_alpha).to(F32)
    return nb_lost, cum_alpha, bfi.to(I32), prev_bfi


def plc_main_plain(cfg: Config, spec, q_d_prev, bfi, nb_lost, cum_alpha, seed):
    """Plain version of the `plc_main` kernel: plc_main, then plc_update's
    counter rule (a frame that is not lost resets the loss counter and the
    damping). Returns (spec_out, q_d_prev, nb_lost, cum_alpha, seed)."""
    spec_out, q_d_prev, nb_lost, cum_alpha, seed = plc_main(
        cfg, spec, q_d_prev, bfi, nb_lost, cum_alpha, seed)
    good = bfi != 1     # plc_update's rule
    return (spec_out, q_d_prev, torch.where(good, 0, nb_lost).to(I32),
            torch.where(good, 1.0, cum_alpha).to(F32), seed)


def plc_main_update(cfg: Config, spec, q_d_prev, bfi, nb_lost, cum_alpha, seed):
    """The standard concealment with its counter update: the CUDA kernel for
    tensors on the card, its plain version for tensors on the CPU."""
    if nm.on_cpu(spec):
        return plc_main_plain(cfg, spec, q_d_prev, bfi, nb_lost, cum_alpha, seed)
    return kernels.plc_main(cfg, spec.contiguous(), q_d_prev.contiguous(), bfi, nb_lost,
                            cum_alpha, seed)
