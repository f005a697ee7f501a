"""The SNS quantizer's encoder and the noise factor and residual coder, their
warp designs compiled for the CPU, against their plain versions.

csrc/sns_vq_enc.cuh (K5, `sns_vq_enc_warp`) and csrc/noise_residual_enc.cuh
(K9, `noise_residual_enc_warp`) are templates over the warp that runs them.
Here g++ builds them with the host warp (`CoderHostWarp`: one thread runs the
32 lanes of each step in turn) into a shared library called through ctypes,
the warp's shared memory filled with a byte pattern before each stream, as
the card leaves it, and the residual rows with a value no path writes. Every
output must equal the plain version's (ops/sns.py:sns_vq_enc_plain,
ops/quant.py:noise_residual_enc_plain), run in the card's order, bit for
bit: on the port's own encoder rows at 48 kHz and 64 and 32 kbps; on
tests/torch_kernel_cases.py:nre_rows at 48 and 16 kHz, among them 16 kbps
(20 bytes at 48 kHz: the noise factor is the smaller of two half means); on
SNS rows whose codebook distances tie at their minimum, rows whose distances
and gain errors are all infinite (every argmin a tie), the silent targets
and all-zero rows of scf_rows; at 1 and 33 streams. The pulse search's
best-position scan alone must equal the plain version's scan on rows where
a tree of comparisons picks another position and on rows of equal
positions. Copies of the headers with one line changed must fail. It skips
where there is no g++."""
from __future__ import annotations

import functools

import numpy as np
import pytest
import torch

import audio_codec_torch as P
from audio_codec_torch import kernels as K
from audio_codec_torch import tables as T
from audio_codec_torch.ops import numerics, quant, sns

from tests import torch_kernel_cases as C
from tests.test_torch_lane_rehearsal import (NRE_REHEARSE, SNS_ENC_REHEARSE, build_wrapper,
                                             lane_nre, ptr)

ON_CPU = numerics.on_cpu   # the port's own test, for the encoder's CPU path

WRAPPER = r"""
#include "sns_vq_enc.cuh"
#include "noise_residual_enc.cuh"
#include <cstring>
using namespace acx;
""" + NRE_REHEARSE + r"""
extern "C" {
""" + SNS_ENC_REHEARSE + r"""
// best[b] = pvq_scan(xy2[b], yyt[b], dim)
void rehearse_pvq_scan(const float* xy2, const float* yyt, int dim, int* best, int B) {
  for (int b = 0; b < B; ++b) best[b] = pvq_scan(xy2 + kSnsM * b, yyt + kSnsM * b, dim);
}
}
"""

_SCAN = """  int best = 0;
  float bn = -32768.0f, bd = 0.0f;
#pragma unroll
  for (int i = 0; i < kSnsM; ++i) {
    const float n = xy2[i], d = yyt[i];
    const bool better = i < dim && rmul(n, bd) > rmul(d, bn);
    best = better ? i : best;
    bn = better ? n : bn;
    bd = better ? d : bd;
  }
  return best;
"""
_TREE = """  int bi[kSnsM];
  float bn[kSnsM], bd[kSnsM];
  for (int i = 0; i < kSnsM; ++i) {
    bi[i] = i;
    bn[i] = i < dim ? xy2[i] : -32768.0f;
    bd[i] = i < dim ? yyt[i] : 0.0f;
  }
  for (int s = 1; s < kSnsM; s *= 2)
    for (int i = 0; i + s < kSnsM; i += 2 * s)
      if (rmul(bn[i + s], bd[i]) > rmul(bd[i + s], bn[i])) {
        bi[i] = bi[i + s];
        bn[i] = bn[i + s];
        bd[i] = bd[i + s];
      }
  return bi[0];
"""
# mutations the rehearsal must catch: >= for > in the pulse scan, a tree of
# comparisons in place of the scan, the last index winning an argmin's ties,
# a chain started one zero line late, a zero-line window one line narrower
MUTATIONS = {
    "scan_ge": ("sns_vq_enc.cuh", "rmul(n, bd) > rmul(d, bn)", "rmul(n, bd) >= rmul(d, bn)"),
    "scan_tree": ("sns_vq_enc.cuh", _SCAN, _TREE),
    "argmin_last_index": ("sns_vq_enc.cuh", "oi[ln] < i[q][ln]", "oi[ln] > i[q][ln]"),
    "chain_from_line_1": ("noise_residual_enc.cuh",
                          "const int lo = (half && ln == 2) ? n_lo : 0;",
                          "const int lo = (half && ln == 2) ? n_lo : 1;"),
    "window_narrower": ("noise_residual_enc.cuh", "(below >> (l + 32 - width))",
                        "(below >> (l + 33 - width))"),
}


@pytest.fixture(scope="module")
def lib(tmp_path_factory):
    return build_wrapper(tmp_path_factory.mktemp("sns_nf"), WRAPPER, "sns_nf", MUTATIONS)


@pytest.fixture
def card_order(monkeypatch):
    """The plain versions compute as they do for a tensor on a card."""
    monkeypatch.setattr(numerics, "on_cpu", lambda x: False)


def np32(a, dtype=np.int32) -> np.ndarray:
    a = a.numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
    return np.ascontiguousarray(a, dtype=dtype)


# ---- the inputs ----

@functools.cache
def encoder_rows(bitrate: int) -> tuple:
    """The arguments of the port's quantize_scf_enc and noise_residual_enc at
    each frame of 8 streams of seeded tones and noise over 3 frames at 48 kHz
    (the CPU path): (scf [24, 16], cfg, the residual coder's rows)."""
    from audio_codec_torch.ops import quant as Q, sns as S
    cfg = P.Config(fs_in=48000, bitrate=bitrate)
    rng = np.random.default_rng(bitrate + 1)
    B, T_, n = 8, 3, cfg.frame_length
    k = np.arange(T_ * n)
    pcm = np.stack([np.sin(2 * np.pi * (110 + 530 * s) * k / 48000) * 4000 * (1 + s % 3)
                    + rng.standard_normal(k.size) * 10.0 ** (s % 5) for s in range(B)])
    pcm[B - 1] = 0.0
    pcm = torch.from_numpy(pcm.reshape(B, T_, n).transpose(1, 0, 2).astype(np.float32))
    scf, nre = [], []
    enc, res = S.quantize_scf_enc, Q.noise_residual_enc

    def rec_scf(c, s):
        scf.append(s.clone())
        return enc(c, s)

    def rec_nre(c, *a):
        nre.append([t.clone() for t in a])
        return res(c, *a)
    patched = numerics.on_cpu
    S.quantize_scf_enc, Q.noise_residual_enc, numerics.on_cpu = rec_scf, rec_nre, ON_CPU
    try:
        P.encode_block(cfg, P.enc_state_init(cfg, B, device="cpu"), pcm)
    finally:
        S.quantize_scf_enc, Q.noise_residual_enc, numerics.on_cpu = enc, res, patched
    rows = {k_: np.concatenate([np32(r[i], np.float32 if k_ in ("dy", "gain") else np.int32)
                                for r in nre]) for i, k_ in enumerate(C.NRE_ORDER)}
    return np32(torch.cat(scf), np.float32), cfg, rows


def scan_rows(n: int = 4000, seed: int = 5) -> tuple[np.ndarray, np.ndarray]:
    """(xy2, yyt) [rows, 16] of pulse scans: ratios within a few ulps of each
    other, so that the rounded cross-products are not transitive and a tree
    of comparisons picks another position than the scan on some rows, and
    rows whose positions are all equal."""
    rng = np.random.default_rng(seed)
    f = np.float32
    yyt = (rng.integers(1, 64, (n, 16)) + f(0.5)).astype(f)
    xy2 = (yyt * f(3.7) * (1 + rng.integers(-3, 4, (n, 16)) * f(2.0 ** -23))).astype(f)
    same = np.tile(np.float32([[9.0, 2.5]]), (8, 1))
    xy2 = np.concatenate([xy2, np.repeat(same[:, :1], 16, 1) * np.arange(1, 9, dtype=f)[:, None]])
    yyt = np.concatenate([yyt, np.repeat(same[:, 1:], 16, 1)])
    return np.ascontiguousarray(xy2, f), np.ascontiguousarray(yyt, f)


def plain_scan(xy2: np.ndarray, yyt: np.ndarray, dim: int) -> np.ndarray:
    """The best-position scan of ops/sns.py:_pvq_subpyr_search, in torch."""
    x, y = torch.from_numpy(xy2), torch.from_numpy(yyt)
    best = torch.zeros(x.shape[0], dtype=torch.long)
    bn = torch.full((x.shape[0],), -(2.0 ** 15))
    bd = torch.zeros(x.shape[0])
    for i in range(dim):
        better = x[:, i] * bd > y[:, i] * bn
        best = torch.where(better, i, best)
        bn = torch.where(better, x[:, i], bn)
        bd = torch.where(better, y[:, i], bd)
    return best.numpy().astype(np.int32)


def tree_differs(xy2: np.ndarray, yyt: np.ndarray) -> int:
    """Rows where a pairwise tree of the same comparisons picks another
    position than the scan (all 16 positions)."""
    bi = np.tile(np.arange(16), (xy2.shape[0], 1))
    bn, bd = xy2.copy(), yyt.copy()
    s = 1
    while s < 16:
        for i in range(0, 16 - s, 2 * s):
            t = bn[:, i + s] * bd[:, i] > bd[:, i + s] * bn[:, i]
            bi[:, i] = np.where(t, bi[:, i + s], bi[:, i])
            bn[:, i] = np.where(t, bn[:, i + s], bn[:, i])
            bd[:, i] = np.where(t, bd[:, i + s], bd[:, i])
        s *= 2
    return int((bi[:, 0] != plain_scan(xy2, yyt, 16)).sum())


# ---- the warps and the plain versions ----

def lane_sns(lib, scf: np.ndarray):
    scf = np32(scf, np.float32)
    B = scf.shape[0]
    idx, q = np.zeros((B, 7), np.int32), np.zeros((B, 16), np.float32)
    lib.rehearse_sns_enc(ptr(scf), ptr(np32(K._sns_tables("cpu"))), ptr(idx), ptr(q), B)
    return idx, q


def sns_differing(lib, scf: np.ndarray) -> int:
    idx, q = lane_sns(lib, scf)
    ref = sns.sns_vq_enc_plain(torch.from_numpy(np32(scf, np.float32)))
    return C.count_differing([idx, q], [r.numpy() for r in ref])


def nre_differing(lib, cfg, a: dict) -> int:
    ref = quant.noise_residual_enc_plain(cfg, *(torch.from_numpy(np.asarray(a[k]))
                                               for k in C.NRE_ORDER))
    return C.count_differing(list(lane_nre(lib, cfg, a)), [r.numpy() for r in ref])


def first(a: dict, n: int) -> dict:
    return {k: v[:n] for k, v in a.items()}


# ---- the tests ----

@pytest.mark.parametrize("bitrate", [64000, 32000])
@pytest.mark.parametrize("streams", [1, 33])
def test_warps_match_plain_on_encoder_rows(lib, card_order, bitrate, streams):
    scf, cfg, rows = encoder_rows(bitrate)
    assert sns_differing(lib, scf[:streams]) == 0
    assert nre_differing(lib, cfg, first(rows, streams)) == 0


@pytest.mark.parametrize("name", list(C.NRE_CONFIGS))
@pytest.mark.parametrize("streams", [1, 33])
def test_noise_residual_warp_matches_plain_on_nre_rows(lib, card_order, name, streams):
    cfg = P.Config(**C.NRE_CONFIGS[name])
    a = C.nre_rows(cfg, seed=4)
    assert nre_differing(lib, cfg, first(a, streams)) == 0
    if streams > 1:
        got = lane_nre(lib, cfg, first(a, streams))
        branches = C.nre_branches(first(a, streams), got, cfg)
        assert all(v > 0 for v in branches.values()), branches


@pytest.mark.parametrize("streams", [1, 33])
def test_sns_warp_matches_plain_on_ties_and_silent_rows(lib, card_order, streams):
    scf = C.sns_tie_rows()
    assert sns_differing(lib, scf[:streams]) == 0
    # the tie rows keep every stream's own data at any offset
    assert sns_differing(lib, scf[-streams:]) == 0


def test_sns_warp_matches_plain_on_all_tie_rows(lib, card_order):
    scf = C.sns_tie_rows()
    assert sns_differing(lib, scf) == 0
    idx, _ = lane_sns(lib, scf)
    huge = scf[72:76]
    assert (np.abs(huge) >= 3e19).all()
    assert (idx[72:76, :2] == 0).all(), idx[72:76]       # every distance infinite: entry 0


@pytest.mark.parametrize("book", ["sns_C1", "sns_C2"])
def test_tie_rows_tie(book):
    """The tied halves tie at their minimum, some between entries on the two
    halves of the warp (lanes below and from 16: the tree's last level)."""
    cb = T.t(book).astype(np.float32)
    d = C.codebook_distances(C.tied_halves(cb), cb)
    tied = d == d.min(-1, keepdims=True)
    assert (tied.sum(-1) >= 2).all()
    first_, last = tied.argmax(-1), 31 - tied[:, ::-1].argmax(-1)
    assert ((first_ < 16) & (last >= 16)).any()


def test_pvq_scan_matches_plain(lib):
    xy2, yyt = scan_rows()
    assert tree_differs(xy2, yyt) > 0
    for dim in (16, 10, 6):
        best = np.zeros(xy2.shape[0], np.int32)
        lib.rehearse_pvq_scan(ptr(xy2), ptr(yyt), dim, ptr(best), xy2.shape[0])
        assert np.array_equal(best, plain_scan(xy2, yyt, dim)), int(
            (best != plain_scan(xy2, yyt, dim)).sum())


@pytest.mark.parametrize("mutation", list(MUTATIONS))
def test_rehearsal_catches_mutated_warps(tmp_path, card_order, mutation):
    lib_m = build_wrapper(tmp_path, WRAPPER, "sns_nf", MUTATIONS, mutation)
    bad = 0
    if MUTATIONS[mutation][0] == "sns_vq_enc.cuh":
        xy2, yyt = scan_rows()
        best = np.zeros(xy2.shape[0], np.int32)
        lib_m.rehearse_pvq_scan(ptr(xy2), ptr(yyt), 16, ptr(best), xy2.shape[0])
        bad += int((best != plain_scan(xy2, yyt, 16)).sum())
        bad += sns_differing(lib_m, C.sns_tie_rows())
    else:
        for name in ("48k_16k", "16k_32k"):
            cfg = P.Config(**C.NRE_CONFIGS[name])
            bad += nre_differing(lib_m, cfg, C.nre_rows(cfg, seed=4))
    assert bad > 0, f"the rehearsal did not see the mutation {mutation}"
