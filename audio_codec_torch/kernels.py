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

_PKG = Path(__file__).resolve().parent
SOURCES = tuple(sorted((_PKG / "csrc").glob("*.cu")))
BUILD_DIR = _PKG.parent / "build" / "audio_codec_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC", "-Xptxas", "-v")
KERNELS = ("ari_encode", "ari_decode", "bit_estimate", "ltpf_postfilter")

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
    P, I = ctypes.c_void_p, ctypes.c_int
    sigs = {
        "acx_bit_estimate": [P] * 5 + [I] * 5 + [P],
        "acx_ari_encode": [P] * 8 + [I] * 8 + [P],
        "acx_ari_decode": [P] * 9 + [I] * 11 + [P],
        "acx_ltpf_postfilter": [P] * 11 + [I] * 8 + [P],
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
    return torch.as_tensor(v, dtype=torch.int32, device=device).expand(B).contiguous()


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


def ari_decode(cfg, buf, side):
    """Launch `ari_decode` (csrc/ari_decode.cu); returns the dict of
    ops/ari.py:decode_plain."""
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
    total_bits = cfg.targetBytes * 8
    max_res = min(residual_max_bits(cfg), total_bits)
    e = lambda *s, dt=torch.int32: torch.empty((L, *s), dtype=dt, device=dev)
    x, tns_order, tns_idx, res = e(N), e(2), e(2, 8), e(max_res)
    levs = e(N // 2, dt=torch.uint8)
    out = torch.empty((7, L), dtype=torch.int32, device=dev)
    _run("ari_decode", library().acx_ari_decode(
        buf.data_ptr(), side_in.data_ptr(), _decoder_tables(str(dev)).data_ptr(),
        x.data_ptr(), tns_order.data_ptr(), tns_idx.data_ptr(), res.data_ptr(),
        levs.data_ptr(), out.data_ptr(), L, nbytes, N, 22 if cfg.hrmode else 14,
        int(cfg.hrmode), 8 if cfg.frame_dms == 100 else 4,
        1 if cfg.enable_lpc_weighting else 0,
        cfg.rateFlag if cfg.fs_idx != 5 else 0, total_bits, max_res,
        20 if cfg.hrmode else 1, _stream()))
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
