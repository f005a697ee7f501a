"""Build, bind and launch the CUDA kernels of the port (csrc/*.cu).

Each source compiles with nvcc for sm_90a into an object, all sources at
once, and the objects link into one shared library with a plain C
interface, loaded with ctypes. The build runs at the first launch of the
first process, into `build/audio_codec_torch/<hash of sources and flags>/`
beside the package; later processes load that library. Every C entry
point returns `cudaGetLastError()` and the wrappers raise if it is not 0.

The wrappers check device, dtype, shape and contiguity, allocate outputs
with `torch.empty`, launch on PyTorch's current stream, and add one to
`launches[name]` per launch. They take CUDA tensors only: the ops modules
call the plain versions for tensors on the CPU.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

import numpy as np
import torch

from . import tables as T
from .ops import numerics as nm

_PKG = Path(__file__).resolve().parent
SOURCES = tuple(sorted((_PKG / "csrc").glob("*.cu")))
BUILD_DIR = _PKG.parent / "build" / "audio_codec_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC", "-Xptxas", "-v")
KERNELS = ("ari_encode", "ari_decode", "bit_estimate", "ltpf_postfilter", "gain_bisection",
           "tns_analysis_lattice", "tns_synthesis_lattice", "hp50_biquad",
           "side_info_pack", "side_info_parse", "sns_vq_dec", "sns_vq_enc",
           "tns_filter_analysis", "pc_classify", "mdct", "imdct",
           "olpa", "ltpf_encode", "noise_residual_enc", "spec_decode", "fec_encode",
           "fec_decode", "plc_tdc", "plc_damp_scramble", "phecu_spec_ana", "phecu_subst",
           "fx_sns_dec", "fx_spec_decode", "fx_dct4", "fx_ola_ltpf", "plc_main")

# launches of each kernel since the last reset_launch_counts()
launches = dict.fromkeys(KERNELS, 0)


def reset_launch_counts():
    for k in launches:
        launches[k] = 0


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels build on a machine "
                           "with the CUDA toolkit")
    return path


def _build_key(nvcc: str) -> str:
    """Hash of the sources, the header, the flags and the compiler path."""
    h = hashlib.sha256()
    for path in sorted((_PKG / "csrc").iterdir()):
        h.update(path.name.encode())
        h.update(path.read_bytes())
    h.update(" ".join((nvcc, *NVCC_FLAGS)).encode())
    return h.hexdigest()[:16]


@functools.cache
def build() -> tuple[Path, str]:
    """Compile every source in parallel and link the library, or reuse the
    one already built from the same sources and flags. Returns its path and
    the compiler's -Xptxas -v report.

    The library lives in `BUILD_DIR/<hash>/`. A build runs in a temporary
    directory beside it, which is renamed into place when it is complete,
    so processes building at once never load a partial library."""
    nvcc = _nvcc()
    final = BUILD_DIR / _build_key(nvcc)
    lib_name = "libacodec_kernels.so"
    if not (final / lib_name).exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = Path(tempfile.mkdtemp(prefix=".tmp-", dir=BUILD_DIR))
        try:
            _compile(nvcc, tmp, lib_name)
            try:
                os.rename(tmp, final)
            except OSError:   # another process renamed its build first
                if not (final / lib_name).exists():
                    raise
        finally:
            shutil.rmtree(tmp, ignore_errors=True)
    return final / lib_name, (final / "build.log").read_text()


def _compile(nvcc: str, out: Path, lib_name: str):
    procs = []
    for src in SOURCES:
        obj = out / (src.stem + ".o")
        procs.append((src, subprocess.Popen(
            [nvcc, *NVCC_FLAGS, "-c", str(src), "-o", str(obj)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    log, objs = [], []
    for src, p in procs:
        text, _ = p.communicate()
        log.append(f"== {src.name}\n{text}")
        if p.returncode != 0:
            raise RuntimeError(f"nvcc failed on {src.name}:\n{text}")
        objs.append(str(out / (src.stem + ".o")))
    r = subprocess.run([nvcc, "-shared", "-o", str(out / lib_name), *objs],
                       capture_output=True, text=True)
    if r.returncode != 0:
        raise RuntimeError(f"link failed:\n{r.stdout}{r.stderr}")
    (out / "build.log").write_text("".join(log))


@functools.cache
def library() -> ctypes.CDLL:
    lib = ctypes.CDLL(str(build()[0]))
    P, I, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    sigs = {
        "acx_bit_estimate": [P] * 5 + [I] * 5 + [P],
        "acx_ari_encode": [P] * 8 + [I] * 8 + [P],
        "acx_ari_decode": [P] * 10 + [I] * 14 + [P],
        "acx_ltpf_postfilter": [P] * 11 + [I] * 8 + [P],
        "acx_gain_bisection": [P] * 3 + [I] * 3 + [P],
        "acx_tns_analysis_lattice": [P] * 6 + [I] * 2 + [P],
        "acx_tns_synthesis_lattice": [P] * 6 + [I] * 2 + [P],
        "acx_hp50_biquad": [P] * 4 + [I] * 2 + [F] * 5 + [P],
        "acx_side_info_pack": [P] * 11 + [I] * 5 + [P],
        "acx_side_info_parse": [P] * 5 + [I] * 8 + [P],
        "acx_sns_vq_dec": [P] * 3 + [I] + [P],
        "acx_sns_vq_enc": [P] * 4 + [I] + [P],
        "acx_tns_filter_analysis": [P] * 8 + [I] * 5 + [F] * 4 + [P],
        "acx_pc_classify": [P] * 7 + [I] * 3 + [F] + [P],
        "acx_mdct": [P] * 6 + [I] * 3 + [P],
        "acx_imdct": [P] * 6 + [I] * 3 + [P],
        "acx_olpa": [P] * 10 + [I] * 8 + [P],
        "acx_ltpf_encode": [P] * 16 + [I] * 8 + [P],
        "acx_noise_residual_enc": [P] * 10 + [I] * 6 + [P],
        "acx_spec_decode": [P] * 14 + [I] * 5 + [P],
        "acx_fec_encode": [P] * 4 + [I] * 5 + [P],
        "acx_fec_decode": [P] * 5 + [I] * 3 + [P],
        "acx_plc_tdc": [P] * 16 + [I] * 11 + [F] * 3 + [P],
        "acx_plc_damp_scramble": [P] * 8 + [I] * 3 + [P],
        "acx_phecu_spec_ana": [P] * 9 + [I] * 3 + [P],
        "acx_phecu_subst": [P] * 9 + [I] * 7 + [P],
        "acx_fx_sns_dec": [P] * 4 + [I] * 2 + [P],
        "acx_fx_spec_decode": [P] * 9 + [I] * 7 + [P],
        "acx_fx_dct4": [P] * 7 + [I] + [P],
        "acx_fx_ola_ltpf": [P] * 17 + [I] + [P] * 2,
        "acx_plc_main": [P] * 12 + [I] * 2 + [P],
    }
    for name, args in sigs.items():
        fn = getattr(lib, name)
        fn.argtypes = args
        fn.restype = ctypes.c_int
    return lib


def _check(t: torch.Tensor, name: str, dtype, ndim: int):
    if t.device.type != "cuda":
        raise ValueError(f"{name}: expected a CUDA tensor, got {t.device}")
    if t.dtype != dtype or t.dim() != ndim:
        raise ValueError(f"{name}: expected {dtype} with {ndim} dims, got "
                         f"{t.dtype} {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: expected a contiguous tensor")


def _run(name: str, rc: int):
    if rc != 0:
        raise RuntimeError(f"CUDA kernel {name} failed to launch: cudaError {rc}")
    launches[name] += 1


def _stream() -> int:
    return torch.cuda.current_stream().cuda_stream


def _i32(v, B: int, device) -> torch.Tensor:
    return nm.vec_i32(v, B, device).contiguous()


@functools.cache
def _coder_tables(device: str) -> torch.Tensor:
    """lookup [4096] ++ cumfreq [64,18] ++ tns tables, int32 on `device`
    (the layout the range-coder kernels copy into shared memory)."""
    return torch.as_tensor(np.concatenate([
        T.t("ari_spec_lookup_fl").ravel(), T.t("ari_spec_cumfreq_fl").ravel(),
        T.t("tns_freq_cf").ravel(), T.t("tns_cf").ravel()]).astype(np.int32),
        device=device)


@functools.cache
def _decoder_tables(device: str) -> torch.Tensor:
    return torch.as_tensor(np.concatenate([
        T.t("ari_spec_lookup_fl").ravel(), T.t("ari_spec_cumfreq_fl").ravel(),
        T.t("ari_tns_order_cf").ravel(), T.t("ari_tns_freq_cf").ravel()]).astype(np.int32),
        device=device)


@functools.cache
def _bits_tables(device: str) -> tuple[torch.Tensor, torch.Tensor]:
    return (torch.as_tensor(T.t("ari_spec_lookup_fl").astype(np.int32), device=device),
            torch.as_tensor(T.t("ari_spec_bits_fl").astype(np.int32), device=device))


def bit_estimate(cfg, xq, target, mode: int):
    """Launch `bit_estimate` (csrc/bit_estimate.cu); see
    ops/quant.py:bit_estimate_plain for the outputs."""
    _check(xq, "xq", torch.int32, 2)
    B, N = xq.shape
    tgt = _i32(target, B, xq.device)
    lookup, bits_tab = _bits_tables(str(xq.device))
    out = torch.empty((5, B), dtype=torch.int32, device=xq.device)
    _run("bit_estimate", library().acx_bit_estimate(
        xq.data_ptr(), tgt.data_ptr(), out.data_ptr(), lookup.data_ptr(),
        bits_tab.data_ptr(), B, N, int(mode), cfg.rateFlag, 21 if cfg.hrmode else 14,
        _stream()))
    return dict(nbits=out[0], nbits2=out[1], lastnz=out[2], lastnz2=out[3], lsbMode=out[4])


def ari_encode(cfg, buf, bp_side, mask_side, xq, tns_order, tns_idx,
               num_tns_filters, lastnz_wire, lsb_mode, res_bits, n_res):
    """Launch `ari_encode` (csrc/ari_encode.cu); see ops/ari.py:encode_plain."""
    _check(xq, "xq", torch.int32, 2)
    B, N = xq.shape
    if N > 1024:
        raise ValueError("ari_encode keeps at most 1024 LSB bits a stream")
    buf = buf.to(torch.int32).contiguous()
    _check(buf, "buf", torch.int32, 2)
    dev = xq.device
    side = torch.stack([_i32(v, B, dev) for v in (
        bp_side, mask_side, num_tns_filters, lastnz_wire, lsb_mode, n_res)]).contiguous()
    tns_order = tns_order.to(torch.int32).contiguous()
    tns_idx = tns_idx.to(torch.int32).contiguous()
    res = res_bits.to(torch.int32).contiguous()
    _check(tns_order, "tns_order", torch.int32, 2)
    _check(tns_idx, "tns_idx", torch.int32, 3)
    _check(res, "res_bits", torch.int32, 2)
    out = torch.empty_like(buf)
    _run("ari_encode", library().acx_ari_encode(
        buf.data_ptr(), out.data_ptr(), xq.data_ptr(), side.data_ptr(),
        tns_order.data_ptr(), tns_idx.data_ptr(), res.data_ptr(),
        _coder_tables(str(dev)).data_ptr(), B, N, buf.shape[1], res.shape[1],
        21 if cfg.hrmode else 14, cfg.rateFlag, 1 if cfg.enable_lpc_weighting else 0,
        cfg.targetBitsAri, _stream()))
    return out


def ari_decode(cfg, buf, side, bfi_in=None, be_bp_left=None, be_bp_right=None,
               pc_enc_sim: bool = False):
    """Launch `ari_decode` (csrc/ari_decode.cu); returns the dict of
    ops/ari.py:decode_plain. With a partial-concealment block (cfg.n_pc > 0)
    or pc_enc_sim the lanes run the PC hooks; bfi_in and the corrupt bit
    range enter only there."""
    from .ops.ari import pc_params
    from .ops.quant import residual_max_bits
    buf = buf.to(torch.int32).contiguous()
    _check(buf, "buf", torch.int32, 2)
    L, nbytes = buf.shape
    dev = buf.device
    N = cfg.yLen
    side_in = torch.stack([_i32(side[k], L, dev) for k in (
        "lastnz", "lsb_mode", "num_tns")] + [_i32(side["tns_on"][:, 0], L, dev),
                                             _i32(side["tns_on"][:, 1], L, dev)]
        + [_i32(side[k], L, dev) for k in ("bp_side", "mask_side", "gg_idx",
                                           "fac_ns_idx")]).contiguous()
    pc = pc_params(cfg, pc_enc_sim)
    pc_mode, pc_in = 0, None
    if pc is not None:
        pc_mode = 2 if pc_enc_sim else 1
        pc_in = torch.stack([_i32(d if v is None else v, L, dev) for v, d in zip(
            (bfi_in, be_bp_left, be_bp_right), (0, -1, -1))])
    total_bits = cfg.targetBytes * 8
    max_res = min(residual_max_bits(cfg), total_bits)
    e = lambda *s, dt=torch.int32: torch.empty((L, *s), dtype=dt, device=dev)
    x, tns_order, tns_idx, res = e(N), e(2), e(2, 8), e(max_res)
    levs = e(N // 2, dt=torch.uint8)
    out = torch.empty((7, L), dtype=torch.int32, device=dev)
    _run("ari_decode", library().acx_ari_decode(
        buf.data_ptr(), side_in.data_ptr(), None if pc_in is None else pc_in.data_ptr(),
        _decoder_tables(str(dev)).data_ptr(),
        x.data_ptr(), tns_order.data_ptr(), tns_idx.data_ptr(), res.data_ptr(),
        levs.data_ptr(), out.data_ptr(), L, nbytes, N, 22 if cfg.hrmode else 14,
        int(cfg.hrmode), 8 if cfg.frame_dms == 100 else 4,
        1 if cfg.enable_lpc_weighting else 0,
        cfg.rateFlag if cfg.fs_idx != 5 else 0, total_bits, max_res,
        20 if cfg.hrmode else 1, pc_mode, 0 if pc is None else pc["pc_bytes"],
        cfg.targetBytes, _stream()))
    return dict(x=x, tns_order=tns_order, tns_idx=tns_idx, nf_seed=out[0],
                zero_frame=out[1], res_bits=res, n_res=out[2], residual_present=out[3],
                bfi=out[4], spec_inv_idx=out[5], b_left=out[6])


def ltpf_postfilter(cfg, x, mem_x, mem_y, a1, b1, a2, b2, p1, p2, cases):
    """Launch `ltpf_postfilter` (csrc/ltpf_postfilter.cu); see
    ops/ltpf_dec.py:ltpf_postfilter_plain."""
    for name, t in (("x", x), ("mem_x", mem_x), ("mem_y", mem_y), ("a1", a1),
                    ("b1", b1), ("a2", a2), ("b2", b2)):
        _check(t, name, torch.float32, 2)
    for name, t in (("p1", p1), ("p2", p2), ("cases", cases)):
        _check(t, name, torch.int32, 1)
    B, N = x.shape
    y = torch.empty_like(x)
    _run("ltpf_postfilter", library().acx_ltpf_postfilter(
        x.data_ptr(), mem_x.data_ptr(), mem_y.data_ptr(), a1.data_ptr(), b1.data_ptr(),
        a2.data_ptr(), b2.data_ptr(), p1.data_ptr(), p2.data_ptr(), cases.data_ptr(),
        y.data_ptr(), B, N, mem_x.shape[1], mem_y.shape[1], a1.shape[1], b1.shape[1],
        max(cfg.fs, 16000) // 8000, int(cfg.fs * 0.0025), _stream()))
    return y


def gain_bisection(en, target, offset0: int):
    """Launch `gain_bisection` (csrc/gain_bisection.cu); see
    ops/quant.py:gain_bisection_plain."""
    _check(en, "en", torch.float32, 2)
    _check(target, "target", torch.float32, 1)
    B, M = en.shape
    if target.shape[0] != B:
        raise ValueError(f"target: expected {B} streams, got {target.shape[0]}")
    out = torch.empty((B,), dtype=torch.int32, device=en.device)
    _run("gain_bisection", library().acx_gain_bisection(
        en.data_ptr(), target.data_ptr(), out.data_ptr(), B, M, int(offset0), _stream()))
    return out


def _tns_lattice(name: str, x, rc, order, lo, hi):
    _check(x, "x", torch.float32, 2)
    _check(rc, "rc", torch.float32, 3)
    for arg, t in (("order", order), ("lo", lo), ("hi", hi)):
        _check(t, arg, torch.int32, 2)
    B, N = x.shape
    if tuple(rc.shape) != (B, 2, 8) or any(tuple(t.shape) != (B, 2) for t in (order, lo, hi)):
        raise ValueError(f"{name}: expected rc [{B}, 2, 8] and order, lo, hi [{B}, 2]")
    y = torch.empty_like(x)
    _run(name, getattr(library(), "acx_" + name)(
        x.data_ptr(), rc.data_ptr(), order.data_ptr(), lo.data_ptr(), hi.data_ptr(),
        y.data_ptr(), B, N, _stream()))
    return y


def tns_analysis_lattice(x, rc, order, lo, hi):
    """Launch `tns_analysis_lattice` (csrc/tns_analysis_lattice.cu); see
    ops/tns.py:tns_analysis_lattice_plain."""
    return _tns_lattice("tns_analysis_lattice", x, rc, order, lo, hi)


def tns_synthesis_lattice(x, rc, order, lo, hi):
    """Launch `tns_synthesis_lattice` (csrc/tns_synthesis_lattice.cu); see
    ops/tns.py:tns_synthesis_lattice_plain."""
    return _tns_lattice("tns_synthesis_lattice", x, rc, order, lo, hi)


def hp50_biquad(x, mem_50):
    """Launch `hp50_biquad` (csrc/hp50_biquad.cu); see
    ops/analysis.py:hp50_biquad_plain. Returns (y, new memories)."""
    _check(x, "x", torch.float32, 2)
    _check(mem_50, "mem_50", torch.float32, 2)
    B, N = x.shape
    if tuple(mem_50.shape) != (B, 2):
        raise ValueError(f"mem_50: expected [{B}, 2], got {tuple(mem_50.shape)}")
    b = [float(v) for v in np.float32(T.t("highpass50_filt_b"))]
    a = [float(v) for v in np.float32(T.t("highpass50_filt_a"))]
    y = torch.empty_like(x)
    mem_out = torch.empty_like(mem_50)
    _run("hp50_biquad", library().acx_hp50_biquad(
        x.data_ptr(), mem_50.data_ptr(), y.data_ptr(), mem_out.data_ptr(), B, N,
        b[0], b[1], b[2], a[1], a[2], _stream()))
    return y, mem_out


def side_info_pack(cfg, bw_idx, lastnz, lsb_mode, gg_idx, num_tns_filters, tns_order,
                   ltpf_param, scf_idx, fac_ns_idx):
    """Launch `side_info_pack` (csrc/side_info_pack.cu); see
    ops/bits.py:pack_side_info_plain. Returns (buf, bp_side, mask_side)."""
    scf_idx = scf_idx.to(torch.int32).contiguous()
    _check(scf_idx, "scf_idx", torch.int32, 2)
    B = scf_idx.shape[0]
    dev = scf_idx.device
    if scf_idx.shape[1] != 7:
        raise ValueError(f"scf_idx: expected [{B}, 7], got {tuple(scf_idx.shape)}")
    scalars = [_i32(v, B, dev) for v in (bw_idx, lastnz, lsb_mode, gg_idx, num_tns_filters)]
    fac_ns_idx = _i32(fac_ns_idx, B, dev)
    tns_order = tns_order.to(torch.int32).contiguous()
    ltpf_param = ltpf_param.to(torch.int32).contiguous()
    _check(tns_order, "tns_order", torch.int32, 2)
    _check(ltpf_param, "ltpf_param", torch.int32, 2)
    if tuple(tns_order.shape) != (B, 2) or tuple(ltpf_param.shape) != (B, 3):
        raise ValueError(f"side_info_pack: expected tns_order [{B}, 2] and ltpf_param [{B}, 3]")
    nbytes = cfg.targetBytes
    buf = torch.empty((B, nbytes), dtype=torch.int32, device=dev)
    cursor = torch.empty((2, B), dtype=torch.int32, device=dev)
    _run("side_info_pack", library().acx_side_info_pack(
        *(t.data_ptr() for t in scalars), tns_order.data_ptr(), ltpf_param.data_ptr(),
        scf_idx.data_ptr(), fac_ns_idx.data_ptr(), buf.data_ptr(), cursor.data_ptr(),
        B, nbytes, nbytes - 1, cfg.BW_cutoff_bits, cfg.lastnz_bits, _stream()))
    return buf, cursor[0], cursor[1]


def side_info_parse(cfg, buf):
    """Launch `side_info_parse` (csrc/side_info_parse.cu); returns the dict
    of ops/bits.py:parse_side_info_plain."""
    buf = buf.to(torch.int32).contiguous()
    _check(buf, "buf", torch.int32, 2)
    L, nbytes = buf.shape
    dev = buf.device
    names = ("bfi", "bw_idx", "lastnz", "lsb_mode", "gg_idx", "num_tns", "fac_ns_idx",
             "bp_side", "mask_side")
    out = torch.empty((len(names) + 2 + 7 + 3, L), dtype=torch.int32, device=dev).view(-1)
    n = len(names) * L
    scalars = out[:n].view(len(names), L)
    tns_on = out[n: n + 2 * L].view(L, 2)
    scf_idx = out[n + 2 * L: n + 9 * L].view(L, 7)
    ltpf_param = out[n + 9 * L:].view(L, 3)
    _run("side_info_parse", library().acx_side_info_parse(
        buf.data_ptr(), scalars.data_ptr(), tns_on.data_ptr(), scf_idx.data_ptr(),
        ltpf_param.data_ptr(), L, nbytes, cfg.targetBytes - 1, cfg.BW_cutoff_bits,
        cfg.lastnz_bits, cfg.fs_idx, cfg.yLen, 1 if cfg.frame_dms == 25 else 0, _stream()))
    side = dict(zip(names, scalars))
    side.update(tns_on=tns_on, scf_idx=scf_idx, ltpf_param=ltpf_param)
    return side


@functools.cache
def _sns_tables(device: str) -> torch.Tensor:
    """The SNS quantizer's tables as one int32 buffer on `device`, float
    tables as their bit patterns, in the layout of csrc/sns_vq.cuh."""
    f = lambda a: np.ascontiguousarray(a, dtype=np.float32).ravel().view(np.int32)
    words = np.concatenate([
        f(T.t("sns_C1")), f(T.t("sns_C2")), f(T.dct2_matrix(T.SNS_M)),
        T.t("pvq_enc_A").astype(np.int32).ravel(),
        f(T.t("sns_vq_reg_adj_gains_fl")), f(T.t("sns_vq_reg_lf_adj_gains_fl")),
        f(T.t("sns_vq_near_adj_gains_fl")), f(T.t("sns_vq_far_adj_gains_fl")),
        f(T.t("sns_dec_gains")), f(T.t("q_g_sns"))])
    if words.size != 1000:
        raise RuntimeError(f"SNS tables: {words.size} words, the kernels expect 1000")
    return torch.as_tensor(words, device=device)


def sns_vq_dec(scf_idx):
    """Launch `sns_vq_dec` (csrc/sns_vq_dec.cu); see
    ops/sns.py:sns_vq_dec_plain."""
    _check(scf_idx, "scf_idx", torch.int32, 2)
    B = scf_idx.shape[0]
    if scf_idx.shape[1] != 7:
        raise ValueError(f"scf_idx: expected [{B}, 7], got {tuple(scf_idx.shape)}")
    scf_q = torch.empty((B, T.SNS_M), dtype=torch.float32, device=scf_idx.device)
    _run("sns_vq_dec", library().acx_sns_vq_dec(
        scf_idx.data_ptr(), _sns_tables(str(scf_idx.device)).data_ptr(), scf_q.data_ptr(),
        B, _stream()))
    return scf_q


def sns_vq_enc(scf):
    """Launch `sns_vq_enc` (csrc/sns_vq_enc.cu); see
    ops/sns.py:sns_vq_enc_plain. Returns (scf_idx, scf_q)."""
    _check(scf, "scf", torch.float32, 2)
    B = scf.shape[0]
    if scf.shape[1] != T.SNS_M:
        raise ValueError(f"scf: expected [{B}, {T.SNS_M}], got {tuple(scf.shape)}")
    scf_idx = torch.empty((B, 7), dtype=torch.int32, device=scf.device)
    scf_q = torch.empty_like(scf)
    _run("sns_vq_enc", library().acx_sns_vq_enc(
        scf.data_ptr(), _sns_tables(str(scf.device)).data_ptr(), scf_idx.data_ptr(),
        scf_q.data_ptr(), B, _stream()))
    return scf_idx, scf_q


@functools.cache
def _tns_tables(device: str, frame_dms: int, limited: bool) -> torch.Tensor:
    """The TNS analysis tables as one int32 buffer on `device`, float tables
    as their bit patterns, in the layout of csrc/tns_analysis.cuh."""
    f = lambda a: np.ascontiguousarray(a, dtype=np.float32).ravel().view(np.int32)
    words = np.concatenate([
        T.bw_cutoff_bins(frame_dms).astype(np.int32), f(T.t("lagw_tns")),
        f(T.t("quants_thr_tns")), f(T.t("quants_pts_tns")),
        T.t("huff_bits_tns").astype(np.int32).ravel(),
        T.t("order1_tns" if limited else "order2_tns").astype(np.int32)])
    if words.size != 194:
        raise RuntimeError(f"TNS tables: {words.size} words, the kernel expects 194")
    return torch.as_tensor(words, device=device)


def tns_filter_analysis(cfg, x, bw_idx):
    """Launch `tns_filter_analysis` (csrc/tns_filter_analysis.cu); see
    ops/tns.py:tns_filter_analysis_plain. Returns (order [B, 2], rc_idx
    [B, 2, 8], rc_q [B, 2, 8], numfilters [B], bits [B])."""
    from .ops.tns import _tns_geometry
    _check(x, "x", torch.float32, 2)
    bw_idx = bw_idx.to(torch.int32).contiguous()
    _check(bw_idx, "bw_idx", torch.int32, 1)
    B, N = x.shape
    if bw_idx.shape[0] != B:
        raise ValueError(f"bw_idx: expected {B} streams, got {bw_idx.shape[0]}")
    _, startfreq0, nf_max, max_order, n_sub, max_pg, _ = _tns_geometry(cfg)
    dev = x.device
    e = lambda *s, dt=torch.int32: torch.empty((B, *s), dtype=dt, device=dev)
    order, rc_idx, rc_q, numfilters, bits = e(2), e(2, 8), e(2, 8, dt=torch.float32), e(), e()
    f32 = lambda v: float(np.float32(v))
    inv_span = f32(1.0 / f32(max_pg - 1.5)) if max_pg > 1.5 else 0.0
    _run("tns_filter_analysis", library().acx_tns_filter_analysis(
        x.data_ptr(), bw_idx.data_ptr(), _tns_tables(str(dev), cfg.frame_dms, max_pg == 1.5).data_ptr(),
        order.data_ptr(), rc_idx.data_ptr(), rc_q.data_ptr(), numfilters.data_ptr(),
        bits.data_ptr(), B, N, startfreq0, nf_max, max_order, f32(max_pg), f32(1.0 / n_sub),
        f32(0.85 - 1.0), inv_span, _stream()))
    return order, rc_idx, rc_q, numfilters, bits


def pc_classify(cfg, bfi, spec_inv_idx, stab_fac, pitch_present, q_old_d, q_old_res):
    """Launch `pc_classify` (csrc/pc_classify.cu); see
    ops/pc.py:pc_classify_plain. Returns bfi' [B] int32."""
    for name, t in (("bfi", bfi), ("spec_inv_idx", spec_inv_idx),
                    ("pitch_present", pitch_present)):
        _check(t, name, torch.int32, 1)
    _check(stab_fac, "stab_fac", torch.float32, 1)
    _check(q_old_d, "q_old_d", torch.float32, 2)
    _check(q_old_res, "q_old_res", torch.float32, 2)
    B, N = q_old_d.shape
    if tuple(q_old_res.shape) != (B, N) or any(
            t.shape[0] != B for t in (bfi, spec_inv_idx, stab_fac, pitch_present)):
        raise ValueError(f"pc_classify: expected [{B}] vectors and [{B}, {N}] rows")
    out = torch.empty_like(bfi)
    _run("pc_classify", library().acx_pc_classify(
        bfi.data_ptr(), spec_inv_idx.data_ptr(), stab_fac.data_ptr(), pitch_present.data_ptr(),
        q_old_d.data_ptr(), q_old_res.data_ptr(), out.data_ptr(), B, N, cfg.frame_dms,
        float(np.float32(1.0 / N)), _stream()))
    return out


DCT4_MAX_N = 480    # csrc/dct4.cuh:kDctMaxN


def _transform(name: str, cfg, a, mem, reverse: bool):
    from .ops.transforms import dct4_mt, window
    _check(a, "x" if name == "mdct" else "y", torch.float32, 2)
    _check(mem, "mem", torch.float32, 2)
    B, N = a.shape
    la = cfg.la_zeroes
    if N != cfg.frame_length or N > DCT4_MAX_N or N % 2:
        raise ValueError(f"{name}: frames of {N} samples; the kernel takes the configuration's "
                         f"frame of at most {DCT4_MAX_N} (HR mode is not ported)")
    if tuple(mem.shape) != (B, N - la):
        raise ValueError(f"{name}: expected mem [{B}, {N - la}], got {tuple(mem.shape)}")
    dev = str(a.device)
    out = torch.empty_like(a)
    new_mem = torch.empty_like(mem)
    _run(name, getattr(library(), "acx_" + name)(
        a.data_ptr(), mem.data_ptr(), window(cfg, dev, reverse).data_ptr(),
        dct4_mt(N, dev).data_ptr(), out.data_ptr(), new_mem.data_ptr(), B, N, la, _stream()))
    return out, new_mem


def mdct(cfg, x, mem):
    """Launch `mdct` (csrc/mdct.cu); see ops/transforms.py:mdct_plain.
    Returns (d [B, N], new_mem [B, N - la])."""
    return _transform("mdct", cfg, x, mem, False)


def imdct(cfg, y, mem):
    """Launch `imdct` (csrc/imdct.cu); see ops/transforms.py:imdct_plain.
    Returns (x [B, N], new_mem [B, N - la])."""
    return _transform("imdct", cfg, y, mem, True)


def _check_vectors(B: int, dtype, **named):
    """Each named tensor is a contiguous CUDA vector of B values of dtype."""
    for name, t in named.items():
        _check(t, name, dtype, 1)
        if t.shape[0] != B:
            raise ValueError(f"{name}: expected {B} streams, got {t.shape[0]}")


def _rows(t, name: str, shape: tuple, dtype=torch.float32):
    _check(t, name, dtype, len(shape))
    if tuple(t.shape) != shape:
        raise ValueError(f"{name}: expected {list(shape)}, got {list(t.shape)}")


@functools.cache
def _olpa_tables(device: str) -> torch.Tensor:
    """olpa_down2 (5) ++ olpa_acw (98) as float32 on `device` (csrc/olpa.cuh)."""
    return torch.as_tensor(np.concatenate([T.t("olpa_down2"), T.t("olpa_acw")]).astype(np.float32),
                           device=device)


def olpa(cfg, s12k8, mem_s12k8, mem_s6k4, mem_pitch):
    """Launch `olpa` (csrc/olpa.cu); see ops/analysis.py:olpa_plain.
    Returns (2*T0, normcorr, T0, new mem_s12k8, new mem_s6k4)."""
    _check(s12k8, "s12k8", torch.float32, 2)
    B = s12k8.shape[0]
    length = cfg.len_12k8
    mem_in_len = T.MAX_PITCH_6K4 + (16 if cfg.frame_dms == 25 else 0)
    acflen = length // 2 + (16 if cfg.frame_dms == 25 else 0)
    base = mem_in_len - 16 if cfg.frame_dms == 25 else mem_in_len
    if s12k8.shape[1] < length:
        raise ValueError(f"s12k8: expected at least {length} samples, got {s12k8.shape[1]}")
    _rows(mem_s12k8, "mem_s12k8", (B, 3))
    _rows(mem_s6k4, "mem_s6k4", (B, mem_in_len))
    _check_vectors(B, torch.int32, mem_pitch=mem_pitch)
    dev = s12k8.device
    pitch2, t0 = (torch.empty((B,), dtype=torch.int32, device=dev) for _ in range(2))
    nc = torch.empty((B,), dtype=torch.float32, device=dev)
    new12, new64 = torch.empty_like(mem_s12k8), torch.empty_like(mem_s6k4)
    _run("olpa", library().acx_olpa(
        s12k8.data_ptr(), mem_s12k8.data_ptr(), mem_s6k4.data_ptr(), mem_pitch.data_ptr(),
        _olpa_tables(str(dev)).data_ptr(), pitch2.data_ptr(), nc.data_ptr(), t0.data_ptr(),
        new12.data_ptr(), new64.data_ptr(), B, s12k8.shape[1], mem_s6k4.shape[1], length,
        length // 2, mem_in_len, acflen, base, _stream()))
    return pitch2, nc, t0, new12, new64


@functools.cache
def _ltpf_tables(device: str) -> torch.Tensor:
    """inter4_1[:32] ++ enc_inter_filter [4][4] as float32 on `device`
    (csrc/ltpf_encode.cuh)."""
    return torch.as_tensor(np.concatenate([T.t("inter4_1")[:32], T.t("enc_inter_filter").ravel()])
                           .astype(np.float32), device=device)


def ltpf_encode(cfg, s12k8, pitch_ol, nc_ol, mem_in, mem_normcorr, mem_mem_normcorr, mem_on,
                mem_pitch):
    """Launch `ltpf_encode` (csrc/ltpf_encode.cu); see
    ops/analysis.py:ltpf_encode_plain. Returns (param [B, 3], bits, new
    mem_in, normcorr, mem_mem_normcorr, ltpf_on, pitch)."""
    _check(s12k8, "s12k8", torch.float32, 2)
    B = s12k8.shape[0]
    xlen = cfg.len_12k8 + 1
    N, mem_len = xlen - 1, cfg.ltpf_mem_in_len
    acflen, xbase = (2 * N, mem_len - N) if cfg.frame_dms == 25 else (N, mem_len)
    _rows(s12k8, "s12k8", (B, xlen))
    _rows(mem_in, "mem_in", (B, mem_len))
    _check_vectors(B, torch.int32, pitch_ol=pitch_ol, mem_on=mem_on)
    _check_vectors(B, torch.float32, nc_ol=nc_ol, mem_normcorr=mem_normcorr,
                   mem_mem_normcorr=mem_mem_normcorr, mem_pitch=mem_pitch)
    dev = s12k8.device
    e = lambda *sh, dt=torch.float32: torch.empty((B, *sh), dtype=dt, device=dev)
    param, bits, on = e(3, dt=torch.int32), e(dt=torch.int32), e(dt=torch.int32)
    new_mem_in, nc, mem_mem, pitch = e(mem_len), e(), e(), e()
    _run("ltpf_encode", library().acx_ltpf_encode(
        s12k8.data_ptr(), pitch_ol.data_ptr(), nc_ol.data_ptr(), mem_in.data_ptr(),
        mem_normcorr.data_ptr(), mem_mem_normcorr.data_ptr(), mem_on.data_ptr(),
        mem_pitch.data_ptr(), _ltpf_tables(str(dev)).data_ptr(), param.data_ptr(),
        bits.data_ptr(), new_mem_in.data_ptr(), nc.data_ptr(), mem_mem.data_ptr(),
        on.data_ptr(), pitch.data_ptr(), B, xlen, N, mem_len, acflen, xbase, cfg.frame_dms,
        int(bool(cfg.ltpf_enable)), _stream()))
    return param, bits, new_mem_in, nc, mem_mem, on, pitch


def _spectral_geometry(cfg, name: str) -> tuple[int, int, int]:
    """(residual bits a stream, zero-line window half width, first line) of
    the noise filling and residual kernels; HR mode is not ported."""
    from .ops.quant import residual_max_bits
    if cfg.hrmode:
        raise ValueError(f"{name}: HR mode (20 residual rounds) is not ported")
    width, start = (3, 24) if cfg.frame_dms == 100 else (1, {50: 12, 25: 6}[cfg.frame_dms])
    return residual_max_bits(cfg), width, start


def noise_residual_enc(cfg, dy, xq, gain, bw_bin, target, nbits2, lsb_mode):
    """Launch `noise_residual_enc` (csrc/noise_residual_enc.cu); see
    ops/quant.py:noise_residual_enc_plain. Returns (fac_ns_idx, res_bits
    [B, max_res], n_res)."""
    max_res, width, start = _spectral_geometry(cfg, "noise_residual_enc")
    _check(dy, "dy", torch.float32, 2)
    B, N = dy.shape
    _rows(xq, "xq", (B, N), torch.int32)
    _check_vectors(B, torch.float32, gain=gain)
    _check_vectors(B, torch.int32, bw_bin=bw_bin, target=target, nbits2=nbits2, lsb_mode=lsb_mode)
    dev = dy.device
    fac, n_res = (torch.empty((B,), dtype=torch.int32, device=dev) for _ in range(2))
    res = torch.empty((B, max_res), dtype=torch.int32, device=dev)
    half_means = int(cfg.frame_dms == 100 and cfg.targetBytes <= 20)
    _run("noise_residual_enc", library().acx_noise_residual_enc(
        dy.data_ptr(), xq.data_ptr(), gain.data_ptr(), bw_bin.data_ptr(), target.data_ptr(),
        nbits2.data_ptr(), lsb_mode.data_ptr(), fac.data_ptr(), res.data_ptr(), n_res.data_ptr(),
        B, N, width, start, half_means, max_res, _stream()))
    return fac, res, n_res


@functools.cache
def _bw_bins(device: str, frame_dms: int) -> torch.Tensor:
    return torch.as_tensor(T.bw_cutoff_bins(frame_dms).astype(np.int32), device=device)


@functools.cache
def _lcg_table(device: str, N: int) -> torch.Tensor:
    """The noise-filling generator's closed form, mult [N + 1] ++ add [N + 1]
    (ops/quant.py:lcg_tables), as int32 on `device` (csrc/spec_decode.cuh)."""
    from .ops.quant import lcg_tables
    return torch.as_tensor(np.concatenate(lcg_tables(N + 1)).astype(np.int32), device=device)


def spec_decode(cfg, x, gain, bfi, rframe, spec_inv_idx, bw_idx, fac_ns_idx, residual_present,
                res_bits, n_res, nf_seed, zero_frame, q_old_res, q_old_d, prev_gg, prev_bw_idx,
                prev_fac_ns, nb_lost):
    """Launch `spec_decode` (csrc/spec_decode.cu); see
    ops/quant.py:spectrum_decode_plain. Returns (x, q_old_res, prev_gg,
    prev_bw_idx, prev_fac_ns, nb_lost)."""
    res_width, width, start = _spectral_geometry(cfg, "spec_decode")
    _check(x, "x", torch.float32, 2)
    B, N = x.shape
    for name, t in (("q_old_res", q_old_res), ("q_old_d", q_old_d)):
        _rows(t, name, (B, N))
    # a frame carries at most min(max residual bits, its own bits): fewer
    # than max_res below 50 bytes (the EP4 core at 64 kbps has 42)
    res_width = res_bits.shape[1] if 0 < res_bits.shape[1] <= res_width else res_width
    _rows(res_bits, "res_bits", (B, res_width), torch.int32)
    ints = dict(bfi=bfi, rframe=rframe, spec_inv_idx=spec_inv_idx, bw_idx=bw_idx,
                fac_ns_idx=fac_ns_idx, residual_present=residual_present, n_res=n_res,
                nf_seed=nf_seed, zero_frame=zero_frame, prev_bw_idx=prev_bw_idx, nb_lost=nb_lost)
    floats = dict(gain=gain, prev_gg=prev_gg, prev_fac_ns=prev_fac_ns)
    _check_vectors(B, torch.int32, **ints)
    _check_vectors(B, torch.float32, **floats)
    dev = x.device
    ints = torch.stack(list(ints.values()))          # the order of spec_decode.cu's enum
    floats = torch.stack(list(floats.values()))
    x_out, q_out = torch.empty_like(x), torch.empty_like(x)
    prev_gg_out, fac_out = (torch.empty((B,), dtype=torch.float32, device=dev) for _ in range(2))
    bw_out, nb_out = (torch.empty((B,), dtype=torch.int32, device=dev) for _ in range(2))
    _run("spec_decode", library().acx_spec_decode(
        x.data_ptr(), ints.data_ptr(), floats.data_ptr(), res_bits.data_ptr(),
        q_old_res.data_ptr(), q_old_d.data_ptr(), _bw_bins(str(dev), cfg.frame_dms).data_ptr(),
        _lcg_table(str(dev), N).data_ptr(), x_out.data_ptr(), q_out.data_ptr(),
        prev_gg_out.data_ptr(), bw_out.data_ptr(),
        fac_out.data_ptr(), nb_out.data_ptr(), B, N, width, start, res_width, _stream()))
    return x_out, q_out, prev_gg_out, bw_out, fac_out, nb_out


@functools.cache
def fec_tables(device: str) -> torch.Tensor:
    """The channel coder's tables as one int32 buffer on `device`, in the
    layout of csrc/fec.cuh: GF(16) product and inverse, the powers of g, the
    syndrome points, the signalling polynomials and their syndromes, the
    risk table and the RS parity bases of hd 3, 5 and 7 (13 x 6 each)."""
    from .ops import fec as F
    bases = []
    for hd in (3, 5, 7):
        b = np.zeros((13, 6), np.int32)
        basis = F._rs_basis(hd, 13)
        b[:, : basis.shape[1]] = basis
        bases.append(b.ravel())
    words = np.concatenate([
        F._MUL.ravel(), F._INV, F.G_POW, F._SYND_POW.ravel(), F._SIG_POLYS.ravel(),
        F._SIG_SYNDR.ravel(), F._RISK_M.ravel(), F._RISK_E.ravel(), F._BITCNT] + bases)
    if words.size != 743:
        raise RuntimeError(f"FEC tables: {words.size} words, the kernels expect 743")
    return torch.as_tensor(words.astype(np.int32), device=device)


def _fec_slot(slot_bytes: int):
    from .ops import fec as F
    if not F.FEC_SLOT_BYTES_MIN <= slot_bytes <= F.FEC_SLOT_BYTES_MAX:
        raise ValueError(f"slot of {slot_bytes} bytes outside [{F.FEC_SLOT_BYTES_MIN}, "
                         f"{F.FEC_SLOT_BYTES_MAX}]")


def fec_encode(data, epmr, slot_bytes: int, mode: int, ccc_flag: int):
    """Launch `fec_encode` (csrc/fec_encode.cu); see
    ops/fec.py:fec_encode_plain. Returns [B, slot_bytes] int32."""
    from .ops.fec import fec_get_data_size
    _fec_slot(slot_bytes)
    if mode not in (1, 2, 3, 4):
        raise ValueError(f"fec_encode: EP mode {mode} not in 1..4")
    data = data.to(torch.int32).contiguous()
    _check(data, "data", torch.int32, 2)
    B, D = data.shape
    if D != fec_get_data_size(mode, ccc_flag, slot_bytes):
        raise ValueError(f"fec_encode: {D} payload bytes, the slot of {slot_bytes} bytes "
                         f"at EP{mode} takes {fec_get_data_size(mode, ccc_flag, slot_bytes)}")
    epmr = epmr.to(torch.int32).contiguous()
    _check_vectors(B, torch.int32, epmr=epmr)
    out = torch.empty((B, slot_bytes), dtype=torch.int32, device=data.device)
    _run("fec_encode", library().acx_fec_encode(
        data.data_ptr(), epmr.data_ptr(), fec_tables(str(data.device)).data_ptr(),
        out.data_ptr(), B, D, slot_bytes, mode, int(ccc_flag), _stream()))
    return out


def fec_decode(frames, slot_bytes: int, ccc_flag: int, bfi_in=None):
    """Launch `fec_decode` (csrc/fec_decode.cu); returns the dict of
    ops/fec.py:fec_decode_plain."""
    _fec_slot(slot_bytes)
    frames = frames.to(torch.int32).contiguous()
    _rows(frames, "frames", (frames.shape[0], slot_bytes), torch.int32)
    B, dev = frames.shape[0], frames.device
    if bfi_in is not None:
        bfi_in = bfi_in.to(torch.int32).contiguous()
        _check_vectors(B, torch.int32, bfi_in=bfi_in)
    data = torch.empty((B, slot_bytes), dtype=torch.int32, device=dev)
    out = torch.empty((9, B), dtype=torch.int32, device=dev)
    _run("fec_decode", library().acx_fec_decode(
        frames.data_ptr(), None if bfi_in is None else bfi_in.data_ptr(),
        fec_tables(str(dev)).data_ptr(), data.data_ptr(), out.data_ptr(), B, slot_bytes,
        int(ccc_flag), _stream()))
    names = ("data_bytes", "bfi", "epmr", "error_report", "mode", "n_pccw", "n_pc",
             "be_bp_left", "be_bp_right")
    return dict(data=data, **dict(zip(names, out)))


@functools.cache
def tdc_tables(cfg, device: str) -> tuple[torch.Tensor, torch.Tensor, tuple]:
    """The `plc_tdc` kernel's tables on `device` (float32 and int32, in the
    layout of csrc/plc_tdc.cuh:tdc_tables) and its geometry arguments."""
    from .ops import plc_adv as A, numerics as nm
    lt = A.lpc_tables(cfg)
    fs4 = min(cfg.fs_idx, 4)
    nbands = lt["pre"].shape[0]
    order = A.lpc_order(cfg)
    cosm = np.zeros((nbands, 17), np.float32)
    cosm[:, : order + 1] = lt["cos"]
    lag = np.zeros(16, np.float32)
    lag[:order] = lt["lag"]
    harm = "TDC_high_16_harm" if cfg.fs_idx <= 1 else "TDC_high_32_harm"
    hp = "TDC_high_16" if cfg.fs_idx <= 1 else "TDC_high_32"
    floats = np.concatenate([
        np.asarray(T.t("plc_warp_dee_emphasis")[fs4], np.float32),
        A._centroid_weights(cfg).ravel(), lt["width_inv"], lt["pre"], cosm.ravel(), lag,
        np.asarray(T.t(harm), np.float32), np.asarray(T.t(hp), np.float32),
        nm._x86_rsqrt()]).astype(np.float32)
    length = 2 * cfg.frame_length - cfg.la_zeroes
    nr = length + A.L_FIR_HP - 1
    ints = np.concatenate([lt["off"], A.lcg_pows(nr).ravel()]).astype(np.int32)
    fac = [1.0 / 6, 2.0 / 6, 3.0 / 6, 4.0 / 6, 1.0][fs4]
    geom = (A.pcm_hist_len(cfg), A.max_pitch(cfg), cfg.frame_length, length, cfg.yLen, order,
            nbands, int(T.t("plc_rect_len")[cfg.fs_idx]), 40 * (cfg.fs_idx + 1), cfg.frame_dms,
            nm.f32(float(T.t("plc_preemph_fac")[fs4])), nm.f32(A.ATTEN[cfg.frame_dms]), nm.f32(fac))
    return (torch.as_tensor(floats, device=device), torch.as_tensor(ints, device=device), geom)


def plc_tdc_pack(lost, nb_cur, pitch_int, pitch_fr, meth, seed, fract, harmonic_len, stab_fac,
                 gain_c, alpha):
    """The per-stream scalars of `plc_tdc` as int32 [8, B] and float32 [3, B]."""
    ints = torch.stack([t.to(torch.int32) for t in (lost, nb_cur, pitch_int, pitch_fr, meth, seed,
                                                    fract, harmonic_len)]).contiguous()
    floats = torch.stack([t.to(torch.float32) for t in (stab_fac, gain_c, alpha)]).contiguous()
    return ints, floats


def plc_tdc(cfg, lost, nb_cur, x_old_tot, scf_q, q_d_prev, pitch_int, pitch_fr, stab_fac, meth, a,
            seed, gain_c, alpha, fract, harmonic, harmonic_len, synth_hist):
    """Launch `plc_tdc` (csrc/plc_tdc.cu); returns the dict of
    ops/plc_adv.py:plc_tdc_plain."""
    if cfg.frame_dms != 100 or cfg.hrmode:
        raise ValueError("plc_tdc: the kernel takes 10 ms frames (other frame sizes are "
                         "not ported)")
    ftab, itab, geom = tdc_tables(cfg, str(x_old_tot.device))
    L, MP, fl, length, N = geom[:5]
    B = x_old_tot.shape[0]
    rows = dict(x_old_tot=(x_old_tot, L), scf_q=(scf_q, 16), q_d_prev=(q_d_prev, N), a=(a, 17),
                harmonic=(harmonic, MP), synth_hist=(synth_hist, 16))
    for name, (t, width) in rows.items():
        _rows(t, name, (B, width))
    ints, floats = plc_tdc_pack(lost, nb_cur, pitch_int, pitch_fr, meth, seed, fract, harmonic_len,
                                stab_fac, gain_c, alpha)
    dev = x_old_tot.device
    a_out, harm_out, hist_out = torch.empty_like(a), torch.empty_like(harmonic), torch.empty_like(synth_hist)
    synth = torch.empty((B, length), dtype=torch.float32, device=dev)
    iout = torch.empty((4, B), dtype=torch.int32, device=dev)
    fout = torch.empty((3, B), dtype=torch.float32, device=dev)
    _run("plc_tdc", library().acx_plc_tdc(
        x_old_tot.data_ptr(), scf_q.data_ptr(), q_d_prev.data_ptr(), a.data_ptr(),
        harmonic.data_ptr(), synth_hist.data_ptr(), ints.data_ptr(), floats.data_ptr(),
        ftab.data_ptr(), itab.data_ptr(), a_out.data_ptr(), synth.data_ptr(), harm_out.data_ptr(),
        hist_out.data_ptr(), iout.data_ptr(), fout.data_ptr(), B, *geom, _stream()))
    return dict(meth=iout[0], nc=fout[0], a=a_out, synth=synth, seed=iout[1], gain_c=fout[1],
                alpha=fout[2], fract=iout[2], harmonic_buf=harm_out, harmonic_len=iout[3],
                synth_hist=hist_out)


def plc_damp_scramble(cfg, x, q_d_prev, ns_lane, lost, is_pc, nb_cur, pc_nb_lost, stab_fac,
                      pitch_int, pc_pitch, cum_fflc, cum_slow, cum_fast, ns_seed, pc_seed,
                      spec_inv_idx):
    """Launch `plc_damp_scramble` (csrc/plc_damp_scramble.cu); returns the
    tuple of ops/plc_adv.py:damp_scramble_plain."""
    from .ops.plc_adv import lcg_pows
    if cfg.frame_dms != 100:
        raise ValueError("plc_damp_scramble: the kernel takes 10 ms frames (other frame sizes "
                         "are not ported)")
    _check(x, "x", torch.float32, 2)
    B, N = x.shape
    _rows(q_d_prev, "q_d_prev", (B, N))
    ints = torch.stack([t.to(torch.int32) for t in (
        ns_lane, lost, is_pc, nb_cur, pc_nb_lost, pitch_int, pc_pitch, ns_seed, pc_seed,
        spec_inv_idx)]).contiguous()
    floats = torch.stack([t.to(torch.float32) for t in (stab_fac, cum_fflc, cum_slow,
                                                        cum_fast)]).contiguous()
    dev = x.device
    pows = nm.table(lcg_pows, N, device=dev, dtype=torch.int32)
    spec = torch.empty_like(x)
    fout = torch.empty((3, B), dtype=torch.float32, device=dev)
    iout = torch.empty((2, B), dtype=torch.int32, device=dev)
    _run("plc_damp_scramble", library().acx_plc_damp_scramble(
        x.data_ptr(), q_d_prev.data_ptr(), ints.data_ptr(), floats.data_ptr(), pows.data_ptr(),
        spec.data_ptr(), fout.data_ptr(), iout.data_ptr(), B, N, cfg.frame_dms, _stream()))
    return spec, fout[0], fout[1], fout[2], iout[0], iout[1]


def _plc_lcg(N: int):
    """The standard concealment's generator in closed form, mult [N + 1] ++
    add [N + 1] (ops/plc.py:_lcg_tables), for csrc/plc_main.cuh."""
    from .ops.plc import _lcg_tables
    return np.concatenate(_lcg_tables(N + 1))


def plc_main(cfg, spec, q_d_prev, bfi, nb_lost, cum_alpha, seed):
    """Launch `plc_main` (csrc/plc_main.cu); returns the tuple of
    ops/plc.py:plc_main_plain (spec, q_d_prev, nb_lost, cum_alpha, seed)."""
    _check(spec, "spec", torch.float32, 2)
    B, N = spec.shape
    _rows(q_d_prev, "q_d_prev", (B, N))
    bfi, nb_lost, seed = (t.to(torch.int32).contiguous() for t in (bfi, nb_lost, seed))
    cum_alpha = cum_alpha.to(torch.float32).contiguous()
    _check_vectors(B, torch.int32, bfi=bfi, nb_lost=nb_lost, seed=seed)
    _check_vectors(B, torch.float32, cum_alpha=cum_alpha)
    dev = spec.device
    lcg = nm.table(_plc_lcg, N, device=dev, dtype=torch.int32)
    spec_out, q_out = torch.empty_like(spec), torch.empty_like(spec)
    nb_out, seed_out = (torch.empty((B,), dtype=torch.int32, device=dev) for _ in range(2))
    cum_out = torch.empty((B,), dtype=torch.float32, device=dev)
    _run("plc_main", library().acx_plc_main(
        spec.data_ptr(), q_d_prev.data_ptr(), bfi.data_ptr(), nb_lost.data_ptr(),
        cum_alpha.data_ptr(), seed.data_ptr(), lcg.data_ptr(), spec_out.data_ptr(),
        q_out.data_ptr(), nb_out.data_ptr(), cum_out.data_ptr(), seed_out.data_ptr(), B, N,
        _stream()))
    return spec_out, q_out, nb_out, cum_out, seed_out


def _phecu_geom(cfg):
    from .ops import plc_phecu as H
    if cfg.frame_dms != 100 or cfg.fs_idx != 4:
        raise ValueError("phecu: the kernels take the 48 kHz, 10 ms Phase ECU (other rates "
                         "are not ported)")
    return H.search_bins(cfg), H.nbins(cfg), H.n_lgw(cfg), H


def phecu_spec_ana(cfg, Xr, Xi, Xor, Xoi, norm_corr, active):
    """Launch `phecu_spec_ana` (csrc/phecu_spec_ana.cu); returns the tuple
    of ops/plc_phecu.py:phecu_spec_ana_plain."""
    ns, _, lgw, H = _phecu_geom(cfg)
    _check(Xr, "Xr", torch.float32, 2)
    B = Xr.shape[0]
    for name, t in (("Xr", Xr), ("Xi", Xi), ("Xor", Xor), ("Xoi", Xoi)):
        _rows(t, name, (B, ns))
    nc = norm_corr.to(torch.float32).contiguous()
    act = active.to(torch.int32).contiguous()
    _check_vectors(B, torch.float32, norm_corr=nc)
    dev = Xr.device
    f0 = torch.empty((B, ns), dtype=torch.float32, device=dev)
    npl = torch.empty((B,), dtype=torch.int32, device=dev)
    e = torch.empty((2, B, H.MAX_LGW), dtype=torch.float32, device=dev)
    _run("phecu_spec_ana", library().acx_phecu_spec_ana(
        Xr.data_ptr(), Xi.data_ptr(), Xor.data_ptr(), Xoi.data_ptr(), nc.data_ptr(),
        act.data_ptr(), f0.data_ptr(), npl.data_ptr(), e.data_ptr(), B, ns, lgw, _stream()))
    return f0, npl, e[0], e[1]


def phecu_subst(cfg, Xr, Xi, f0est, num_plocs, nb_cur, e_oold, e_old, mag_chg_1st, beta_mute,
                xavg, is_trans, active):
    """Launch `phecu_subst` (csrc/phecu_subst.cu); returns the tuple of
    ops/plc_phecu.py:phecu_subst_plain."""
    ns, nsf, lgw, H = _phecu_geom(cfg)
    _check(Xr, "Xr", torch.float32, 2)
    B = Xr.shape[0]
    _rows(Xi, "Xi", (B, nsf))
    _rows(Xr, "Xr", (B, nsf))
    f0 = f0est.to(torch.float32).contiguous()
    _rows(f0, "f0est", (B, ns))
    ints = torch.stack([t.to(torch.int32) for t in (num_plocs, nb_cur, is_trans,
                                                    active)]).contiguous()
    groups = torch.stack([t.to(torch.float32) for t in (e_oold, e_old, mag_chg_1st,
                                                        xavg)]).contiguous()
    if tuple(groups.shape) != (4, B, H.MAX_LGW):
        raise ValueError(f"phecu_subst: expected [{B}, {H.MAX_LGW}] group rows")
    bm = beta_mute.to(torch.float32).contiguous()
    dev = Xr.device
    tab = nm.table(H.lcg_tables, ns, device=dev, dtype=torch.int32)
    outr, outi = torch.empty_like(Xr), torch.empty_like(Xi)
    _run("phecu_subst", library().acx_phecu_subst(
        Xr.data_ptr(), Xi.data_ptr(), f0.data_ptr(), ints.data_ptr(), groups.data_ptr(),
        bm.data_ptr(), tab.data_ptr(), outr.data_ptr(), outi.data_ptr(), B, ns, nsf, lgw,
        cfg.frame_length, H.t_adv(cfg), H.lprot(cfg), _stream()))
    return outr, outi


# ---- the bit-exact fixed-point decoder (fixed_decoder_dev.py) ----

FX_SNS_TABLE_WORDS = 787       # csrc/fx_sns_dec.cuh:kFxSnsTableWords
FX_DCT4_TABLE_WORDS = 1862     # csrc/fx_dct4.cuh:kFxDctTableWords
FX_DCT4_N = 480                # csrc/fx_dct4.cuh:kDctN


def _i64_table(*names) -> np.ndarray:
    return np.concatenate([np.asarray(T.t(n)).ravel().astype(np.int64) for n in names])


def fx_sns_table_pack() -> np.ndarray:
    """The SNS decode's tables in the layout of csrc/fx_sns_dec.cuh."""
    return _i64_table("fx_st1SCF0_7_base5_32x8_Q14", "fx_st1SCF8_15_base5_32x8_Q14",
                      "fx_sns_vq_reg_adj_gains", "fx_sns_vq_reg_lf_adj_gains",
                      "fx_sns_vq_near_adj_gains", "fx_sns_vq_far_adj_gains", "fx_isqrt_Q16tab",
                      "fx_ISqrtTable", "fx_ISqrtDiffTable", "fx_InvLog2_16_table1",
                      "fx_InvLog2_16_table2")


def fx_spec_table_pack(yLen: int, fs_idx: int, frame_dms: int, hrmode: bool) -> np.ndarray:
    """The spectral chain's tables in the layout of csrc/fx_spec_decode.cuh:
    the bandwidth cutoffs, the TNS quantizer points, InvLog2's three tables,
    then the LCG's closed form for r = 0..yLen and the band of each bin."""
    from .ops.fixed_dev import band_of_bin
    from .ops.quant import lcg_tables
    ap, cs = lcg_tables(yLen + 1)
    bmap = band_of_bin(T.bands_offset(fs_idx, frame_dms, hrmode), yLen)
    return np.concatenate([_i64_table("BW_cutoff_bin_all", "fx_tnsQuantPts", "fx_exp2x_tab_long",
                                      "fx_exp2w_tab_long", "fx_exp2_tab_long"), ap, cs, bmap])


def fx_dct4_table_pack() -> np.ndarray:
    """The DCT-IV's tables in the layout of csrc/fx_dct4.cuh."""
    return _i64_table("fx_SineWindow480", "fx_SineTable480", "fx_RotVector_480")


def fx_ola_table_pack(N: int, fs_idx: int) -> np.ndarray:
    """The window, then the rate's interpolation rows [4][12] and tilt rows
    [4][11] (csrc/fx_ola_ltpf.cuh:OlaGeom)."""
    from .ops.fixed_imdct import window_table
    return np.concatenate([np.asarray(window_table(N), np.int64).ravel(),
                           np.asarray(T.t("fx_inter_filter")[fs_idx], np.int64).ravel(),
                           np.asarray(T.t("fx_tilt_filter")[fs_idx], np.int64).ravel()])


def _lanes(L: int, name: str):
    if L == 0:
        raise ValueError(f"{name}: no frames")


def fx_sns_dec(scf_idx, n_bands: int):
    """Launch `fx_sns_dec` (csrc/fx_sns_dec.cu); see
    ops/fixed_dev.py:sns_decode_plain. scf_idx [L, 7] int32 -> (scf, scf_e)
    [L, n_bands] int64."""
    _check(scf_idx, "scf_idx", torch.int32, 2)
    L = scf_idx.shape[0]
    _lanes(L, "fx_sns_dec")
    if scf_idx.shape[1] != 7 or not 0 < n_bands <= 64:
        raise ValueError(f"fx_sns_dec: expected [L, 7] indices and 1..64 bands, got "
                         f"{tuple(scf_idx.shape)} and {n_bands}")
    dev = scf_idx.device
    scf = torch.empty((L, n_bands), dtype=torch.int64, device=dev)
    scf_e = torch.empty_like(scf)
    tab = nm.table(fx_sns_table_pack, device=dev, dtype=torch.int64)
    _run("fx_sns_dec", library().acx_fx_sns_dec(scf_idx.data_ptr(), tab.data_ptr(),
                                                 scf.data_ptr(), scf_e.data_ptr(), L, n_bands,
                                                 _stream()))
    return scf, scf_e


def fx_spec_decode(cfg, x, res_bits, n_res, nf_seed, zero_frame, fac_ns_idx, bw_idx, gg_idx,
                   tns_idx, tns_order, scf, scf_e):
    """Launch `fx_spec_decode` (csrc/fx_spec_decode.cu); see
    ops/fixed_dev.py:spectrum_decode_plain. Returns (shaped [L, N], x_e [L])
    int64."""
    if cfg.hrmode:
        raise ValueError("fx_spec_decode: HR mode is not ported")
    _check(x, "x", torch.int32, 2)
    L, yLen = x.shape
    _lanes(L, "fx_spec_decode")
    if yLen != cfg.yLen:
        raise ValueError(f"fx_spec_decode: expected [L, {cfg.yLen}] spectra, got {tuple(x.shape)}")
    _check(res_bits, "res_bits", torch.int32, 2)
    R = res_bits.shape[1]
    if res_bits.shape[0] != L:
        raise ValueError("fx_spec_decode: residual bits of another batch")
    tidx = tns_idx.reshape(L, 16)
    _rows(tidx, "tns_idx", (L, 16), torch.int32)
    _rows(tns_order, "tns_order", (L, 2), torch.int32)
    nb = cfg.bands_number
    _rows(scf, "scf", (L, nb), torch.int64)
    _rows(scf_e, "scf_e", (L, nb), torch.int64)
    dev = x.device
    side = torch.stack([_i32(v, L, dev) for v in (n_res, nf_seed, zero_frame, fac_ns_idx, bw_idx,
                                                  gg_idx)]
                       + [tns_order[:, 0], tns_order[:, 1]], dim=1).contiguous()
    tab = nm.table(fx_spec_table_pack, yLen, cfg.fs_idx, cfg.frame_dms, cfg.hrmode, device=dev,
                   dtype=torch.int64)
    N = cfg.frame_length
    out = torch.empty((L, N), dtype=torch.int64, device=dev)
    x_e = torch.empty((L,), dtype=torch.int64, device=dev)
    _run("fx_spec_decode", library().acx_fx_spec_decode(
        x.data_ptr(), res_bits.data_ptr(), side.data_ptr(), tidx.data_ptr(), scf.data_ptr(),
        scf_e.data_ptr(), tab.data_ptr(), out.data_ptr(), x_e.data_ptr(), L, yLen, N, nb,
        cfg.frame_dms, cfg.quantizedGainOff, R, _stream()))
    return out, x_e


def fx_dct4(y, y_e, N: int, frame_dms: int = 100):
    """Launch `fx_dct4` (csrc/fx_dct4.cu); see
    ops/fixed_dev.py:batch_dct4_plain. y [L, 480] int64, y_e [L] int64 ->
    (ytda [L, 480], y_e, y_s int64, zero bool)."""
    if N != FX_DCT4_N or frame_dms != 100:
        raise ValueError(f"fx_dct4: the kernel takes the 48 kHz 10 ms frame (N = {FX_DCT4_N}); "
                         f"N = {N} at {frame_dms / 10:g} ms is not ported")
    _check(y, "y", torch.int64, 2)
    L = y.shape[0]
    _lanes(L, "fx_dct4")
    _rows(y, "y", (L, N), torch.int64)
    _check_vectors(L, torch.int64, y_e=y_e)
    dev = y.device
    tab = nm.table(fx_dct4_table_pack, device=dev, dtype=torch.int64)
    ytda = torch.empty_like(y)
    ye, ys = (torch.empty((L,), dtype=torch.int64, device=dev) for _ in range(2))
    zero = torch.empty((L,), dtype=torch.bool, device=dev)
    _run("fx_dct4", library().acx_fx_dct4(y.data_ptr(), y_e.data_ptr(), tab.data_ptr(),
                                          ytda.data_ptr(), ye.data_ptr(), ys.data_ptr(),
                                          zero.data_ptr(), L, _stream()))
    return ytda, ye, ys, zero


FX_STATE_KEYS = ("mem", "mem_e", "old_x", "old_y", "old_e", "pitch_int", "pitch_fr", "gain",
                 "mem_active", "old_sfi")


def fx_ola_geometry(cfg, sfi: int) -> list[int]:
    """csrc/fx_ola_ltpf.cuh:OlaGeom of a configuration."""
    from .ops.fixed_imdct import window_table
    from .ops.fixed_ltpf import _FADE_STEP, mem_lens
    from .ops.fixed_ltpf_dev import filter_geometry
    N = cfg.frame_length
    wLen = len(window_table(N))
    x_len, y_len = mem_lens(cfg.fs)
    f = filter_geometry(cfg.fs_idx)
    gain_val = int(T.t("fx_gain_scale_fac")[sfi]) if sfi >= 0 else 0
    return [N, wLen, x_len, y_len, f["ilen"], f["tlen"], f["shift"], f["N4"], f["pitch_scale"],
            _FADE_STEP[f["N4"]], sfi, gain_val, wLen, wLen + 4 * 12]


def fx_ola_ltpf(cfg, st: dict, ytda, y_e, y_s, zero, ltpf_param, sfi: int):
    """Launch `fx_ola_ltpf` (csrc/fx_ola_ltpf.cu) on one frame; see
    ops/fixed_ltpf_dev.py:ola_ltpf_plain. Updates the state dict st in
    place; returns PCM [B, N] int16."""
    geom = fx_ola_geometry(cfg, sfi)
    N, wLen, x_len, y_len = geom[:4]
    _check(ytda, "ytda", torch.int64, 2)
    B = ytda.shape[0]
    _lanes(B, "fx_ola_ltpf")
    _rows(ytda, "ytda", (B, N), torch.int64)
    _check_vectors(B, torch.int64, y_e=y_e, y_s=y_s)
    _check_vectors(B, torch.bool, zero=zero)
    _rows(ltpf_param, "ltpf_param", (B, 3), torch.int32)
    widths = {"mem": wLen - N, "old_x": x_len, "old_y": y_len}
    for k in FX_STATE_KEYS:
        if k in widths:
            _rows(st[k], k, (B, widths[k]), torch.int64)
        else:
            _check_vectors(B, torch.int64, **{k: st[k]})
    dev = ytda.device
    tab = nm.table(fx_ola_table_pack, N, cfg.fs_idx, device=dev, dtype=torch.int64)
    pcm = torch.empty((B, N), dtype=torch.int16, device=dev)
    g = (ctypes.c_int * len(geom))(*geom)
    _run("fx_ola_ltpf", library().acx_fx_ola_ltpf(
        ytda.data_ptr(), y_e.data_ptr(), y_s.data_ptr(), zero.data_ptr(), ltpf_param.data_ptr(),
        tab.data_ptr(), *(st[k].data_ptr() for k in FX_STATE_KEYS), pcm.data_ptr(), B,
        ctypes.cast(g, ctypes.c_void_p), _stream()))
    return pcm
