"""Normative LC3plus constant tables (ETSI TS 103 634) and derived matrices.

Loads `data/tables.npz`, a byte-identical copy of the table pack of
`audio_codec_tpu` (tools/extract_tables.py), and builds the dense operators
the codec runs as matrix products: the DCT-IV and DCT-II matrices, the
band-aggregation matrices and the 12.8 kHz resampler. Everything here is
host-side NumPy; the ops turn what they need into tensors on their device.
"""
from __future__ import annotations

import functools
from pathlib import Path

import numpy as np

_DATA = Path(__file__).parent / "data" / "tables.npz"

# sampling-rate index: 8k→0, 16k→1, 24k→2, 32k→3, 48k(&44.1k)→4, 96k→5
FS_TABLE = (8000, 16000, 24000, 32000, 48000, 96000)
SNS_M = 16
MIN_PITCH_6K4, MAX_PITCH_6K4, RANGE_PITCH_6K4 = 17, 114, 98
MIN_PITCH_12K8, MAX_PITCH_12K8 = 32, 228
RES2_PITCH_12K8, RES4_PITCH_12K8 = 157, 127
LEN_12K8, LEN_6K4 = 128, 64
LTPF_MEMIN_LEN = MAX_PITCH_12K8 + 4
MAX_RESBITS = 5000
MIN_NBYTES, MAX_NBYTES, MAX_NBYTES2 = 20, 400, 625


@functools.cache
def _npz() -> dict[str, np.ndarray]:
    with np.load(_DATA) as z:
        return {k: z[k] for k in z.files}


def t(name: str) -> np.ndarray:
    """Raw table by its normative name (same name as in the ETSI constants)."""
    return _npz()[name]


@functools.cache
def dct4_matrix(n: int) -> np.ndarray:
    """DCT-IV matrix of the reference dct4_apply (dct4.c:51-95):
    X[k] = sqrt(2/N) * sum_n x[n] cos(pi/N (n+1/2)(k+1/2)), float64 [N, N].
    It is its own inverse, so the IMDCT uses it too."""
    k = np.arange(n)[:, None]
    m = np.arange(n)[None, :]
    return np.sqrt(2.0 / n) * np.cos(np.pi / n * (m + 0.5) * (k + 0.5))


@functools.cache
def dct2_matrix(n: int = SNS_M) -> np.ndarray:
    """Orthonormal DCT-II matrix (dct4.c:13-48); its inverse is M.T."""
    k = np.arange(n)[:, None]
    m = np.arange(n)[None, :]
    mat = np.sqrt(2.0 / n) * np.cos(np.pi * (2 * m + 1) * k / (2 * n))
    mat[0, :] /= np.sqrt(2.0)
    return mat


_WIN_10MS = {80: "MDCT_WINDOW_80", 160: "MDCT_WINDOW_160", 240: "MDCT_WINDOW_240",
             320: "MDCT_WINDOW_320", 480: "MDCT_WINDOW_480"}
_WIN_5MS = {40: "MDCT_WINDOW_80_5ms", 80: "MDCT_WINDOW_160_5ms", 120: "MDCT_WINDOW_240_5ms",
            160: "MDCT_WINDOW_320_5ms", 240: "MDCT_WINDOW_480_5ms"}
_WIN_2_5MS = {20: "MDCT_WINDOW_80_2_5ms", 40: "MDCT_WINDOW_160_2_5ms", 60: "MDCT_WINDOW_240_2_5ms",
              80: "MDCT_WINDOW_320_2_5ms", 120: "MDCT_WINDOW_480_2_5ms"}
_WIN_HR = {(100, 480): "MDCT_HRA_WINDOW_480_10ms", (100, 960): "MDCT_HRA_WINDOW_960_10ms",
           (50, 240): "MDCT_HRA_WINDOW_480_5ms", (50, 480): "MDCT_HRA_WINDOW_960_5ms",
           (25, 120): "MDCT_HRA_WINDOW_480_2_5ms", (25, 240): "MDCT_HRA_WINDOW_960_2_5ms"}


def mdct_window(frame_length: int, frame_dms: int, hrmode: bool) -> np.ndarray:
    """Analysis window of length 2*frame_length (mdct.c:13-69)."""
    if hrmode:
        return t(_WIN_HR[(frame_dms, frame_length)])
    table = {100: _WIN_10MS, 50: _WIN_5MS, 25: _WIN_2_5MS}[frame_dms]
    return t(table[frame_length])


def la_zeroes(fs_idx: int, frame_dms: int) -> int:
    name = {100: "MDCT_la_zeroes", 50: "MDCT_la_zeroes_5ms",
            25: "MDCT_la_zeroes_2_5ms"}[frame_dms]
    return int(t(name)[fs_idx])


def bands_offset(fs_idx: int, frame_dms: int, hrmode: bool) -> np.ndarray:
    """Band boundary bins (length bands_number+1)."""
    fs_name = {0: "8", 1: "16", 2: "24", 3: "32", 4: "48", 5: "96"}[fs_idx]
    suffix = {100: "", 50: "_5ms", 25: "_2_5ms"}[frame_dms]
    hr = "_HR" if hrmode else ""
    return t(f"ACC_COEFF_PER_BAND_{fs_name}{suffix}{hr}")


def bands_number(fs_idx: int, frame_dms: int, hrmode: bool) -> int:
    if frame_dms == 100:
        return 64
    if frame_dms == 50:
        return int(t("bands_number_5ms")[fs_idx])
    name = "bands_number_2_5ms_HR" if hrmode else "bands_number_2_5ms"
    return int(t(name)[fs_idx])


@functools.cache
def band_energy_matrix(fs_idx: int, frame_dms: int, hrmode: bool,
                       n_bins: int) -> np.ndarray:
    """[n_bins, n_bands] averaging matrix: ener = (d*d) @ M (per_band_energy.c)."""
    off = bands_offset(fs_idx, frame_dms, hrmode)
    nb = bands_number(fs_idx, frame_dms, hrmode)
    mat = np.zeros((n_bins, nb), dtype=np.float64)
    for b in range(nb):
        lo, hi = int(off[b]), int(off[b + 1])
        mat[lo:hi, b] = 1.0 / (hi - lo)
    return mat


@functools.cache
def band_expand_indices(fs_idx: int, frame_dms: int, hrmode: bool,
                        n_bins: int) -> np.ndarray:
    """[n_bins] band index of each spectral bin (for MDCT shaping gather)."""
    off = bands_offset(fs_idx, frame_dms, hrmode)
    nb = bands_number(fs_idx, frame_dms, hrmode)
    idx = np.zeros(n_bins, dtype=np.int32)
    for b in range(nb):
        idx[int(off[b]): int(off[b + 1])] = b
    return idx


@functools.cache
def resampler_matrix(fs_idx: int, frame_length: int) -> np.ndarray:
    """Dense [len_12k8, mem_in_len + frame_length] resampling operator: the
    upsample / 240-tap lowpass / downsample index arithmetic of
    process_resamp12k8_fl (resamp12k8.c:44-58) as one matrix."""
    fs = FS_TABLE[fs_idx]
    stride = int(t("up_fac")[fs_idx])
    sf = float(t("lp_scale_factors")[fs_idx])
    lp = t("lp_filter")
    n12k8 = frame_length * 12800 // fs
    mem_in_len = 2 * 8 * fs // 12800
    buflen = mem_in_len + frame_length
    mat = np.zeros((n12k8, buflen), dtype=np.float64)
    for k in range(n12k8):
        i = 15 * k
        start = (-i) % stride
        for j in range(start, 240, stride):
            mat[k, (i + j) // stride] += sf * lp[240 - j - 1]
    return mat


def tilt(fs: int) -> int:
    return {8000: 14, 16000: 18, 24000: 22, 32000: 26, 48000: 30, 96000: 34}[fs]


def bw_cutoff_bins(frame_dms: int) -> np.ndarray:
    """Bandwidth cutoff bin of each bandwidth index at this frame duration."""
    name = {100: "BW_cutoff_bin_all", 50: "BW_cutoff_bin_all_5ms",
            25: "BW_cutoff_bin_all_2_5ms"}[frame_dms]
    return t(name)
