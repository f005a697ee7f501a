#!/usr/bin/env python3
"""Times the range coders and the rate-path kernels of audio_codec_torch on a
CUDA card: each kernel (bit_estimate, ari_encode, gain_bisection,
ari_decode) and its stage (ops/quant.py:bit_estimate, ops/ari.py:encode,
ops/quant.py:estimate_global_gain, and the decoder's entropy phase
models/decoder.py:decode_entropy) on the inputs the flagship path gives
them. Every line printed carries the card's name and power limit.

The inputs: chip_smoke.make_pcm's material (a third speech, a third music, a
third noise) at 48 kHz / 64 kbps, B streams, encoded for T frames by the
checkout's own encode_block; the arguments of the stages at the last frame
are recorded (bit_estimate twice a frame: modes -1 and 0), and those of the
kernel launches inside them; the T frames are then decoded by decode_block,
whose entropy phase (decode_entropy) covers all T * B frames at once: the
recorded call. ari_decode is timed there with the side information read
from rows of the plain parse's fields (the read mode, in every checkout),
and on tests/torch_kernel_cases.py:pc_decode_rows at EP3 tiled to B rows,
with the partial-concealment block (the decoder's hooks, and the encoder's
simulation). Each is timed as median loop ms (5 loops of 20 calls) and graph
ms (20 calls replayed from a CUDA graph, the best of 3), each kernel checked
against its plain version bit for bit.

The entropy phase (`entropy ...` in the JSON line), in either design: the
block's decode_entropy call (graph and loop ms); its kernels: the parse
(side_info_parse, a checkout before the fusion) and the range decoder read
mode, or the one parsed launch (ari_decode_frames), each as the wrapper
and as the C entry point alone (raw, on the arguments as the wrapper hands
them over); and on the stream path, the host ms of one decode_entropy call
on B frames (its enqueue, the median of 50 calls after a synchronise, and
its loop ms) at EP0 (the block's last frame) and at EP3 (pc_decode_rows
with their channel flags), and of the encoder's PC simulation
(engine.b_left_step) on EP3's logical payloads.

  (default)     this checkout, one JSON line.
  --other DIR   the same for a checkout of another commit (for example the
                parent unpacked with `git archive` into a directory that
                .gitignore lists), in turns with this one, each in a process
                of its own: other, this, this, other.
  --step-bench  the dependent steps alone, one chain a thread, at one warp
                and at 8 warps on each of 132 blocks: ns a symbol step of the
                range coder (csrc/ari_encode.cuh:enc_symbol with its
                renormalisations, on a cycle of the spectrum table's
                symbols; its byte stores go to one clipped byte of shared
                memory) and ns a tuple step of bit_estimate (be_tuple_bits
                and the context update, the tables in shared memory). K10's
                lane 0 runs one symbol step a coded symbol, so the symbol
                step times the symbols of a stream are its floor. And ns a
                symbol step of the range decoder (csrc/ari_decode.cuh:
                dec_symbol with its renormalisations and the tuple context,
                one chain a thread over a frame of seeded bytes; the time of
                300 rounds less that of 100, so that the staging cancels):
                the inverse table, the count and the binary search (the
                count built with DECODE_BINARY's substitution), the tables
                through L1 and in shared memory, and the step's parts
                alone (a shared load; the lookup, inverse and row loads; the
                quotient).
  --scaling     the three kernels at 4, 32, 512 and 2048 streams of the
                recorded flagship rows (tiled), and the range coders on
                all-busy rows (every tuple nonzero with an escape level,
                lastnz = N: bit_estimate at 64 kbps, ari_encode at 160 kbps,
                whose frame holds them): graph ms, and ari_encode's lane-0
                streams.
  --gain-variants  gain_bisection's warp designs built side by side
                (GAIN_VARIANTS): the kept one, two rounds of one chain a lane
                (the 31 offsets of halvings 1-5, then the 7 of halvings 6-8),
                each step's values computed and then selected, the block loop
                unrolled by 4; one round of all 255 offsets of the decision
                tree, 8 chains a lane interleaved; the two rounds with the
                first warp design's step (its conditions compiled to
                branches, which diverge), rolled and unrolled by 8; the kept
                step rolled; and the row staged with one ballot and no chain
                (the floor of the launch, the staging and the write); each
                bisection checked against the plain version and timed (graph
                ms, two rounds) at 4, 32, 512 and 2048 streams of the
                recorded flagship rows.
  --tables      both kernels with their tables read from global memory
                through L1 (the kept sources) and staged in shared memory
                once a block (TABLE_VARIANTS, text substitutions), built side
                by side, on the recorded launches: graph ms, two rounds.

  --decode-variants  ari_decode's designs, each built from this checkout's
                csrc/ari_decode.cu and ari_decode.cuh with text
                substitutions (DECODE_VARIANTS), side by side: the kept one
                (a thread a frame, the spectral symbol from the inverse
                table, 4-warp blocks sharing every table in shared memory),
                2-warp and one-warp blocks, the tables through L1, x as
                int32, the count of the 17 entries on every row, a binary
                search, groups of 4 and 8 lanes a frame splitting the count;
                and the kept one with one phase removed (DECODE_CUTS: the
                side bits in branches, the rows' write-out, the TNS and
                tuple loops); on the recorded block launch at T * B frames,
                and its first 2048 and 4 frames: graph ms, two rounds, each
                checked against the plain version.
  --decode-phases DIR  the first design of ari_decode (a thread a frame,
                blocks of 32 threads, the tables staged by each block, the
                rows in device memory) of the checkout DIR with
                one phase removed at a time (DECODE_PHASES: the tables'
                staging, the rows' zero fills, the nonzero count's and the
                seed's passes over x, the tuple loop's stores, the decode
                loops, everything but the staging and the frame copy), built
                from DIR's sources with text substitutions, on the recorded
                block launch: graph ms, two rounds, with the outputs that
                differ from the plain version.
  --entropy-phases DIR  the entropy phase's kernel of the checkout DIR (its
                ari_decode.cu) as it is and with a phase removed
                (Entropy.PHASES: the nine side reads replaced by constants),
                and with --entropy-variants this checkout's with its other
                choices (Entropy.VARIANTS: the parse from the global row, not
                the staged one; no parse), built with text substitutions:
                the C entry point's graph ms on the block and on EP3's rows,
                two rounds, each checked against the plain versions; and the
                builds' registers and shared memory. Run DIR's in a process
                of its own (a process imports one checkout's package).
  --clocks      this checkout's parsed mode built with clock64() stamps
                (Entropy.CLOCKS), the parse from the staged row and from the
                global row: cycles of the parse, the decode, the side rows'
                and the decoder rows' write-out, median and 90th percentile
                over the warps.

The entropy modes run through tools/torch_subst_damp_times.py's drivers
(builds, clocks), given the slice `Entropy` below.

    python3 tools/torch_coder_times.py [--streams 2048] [--frames 8] [--other DIR]
    python3 tools/torch_coder_times.py --step-bench --scaling --tables --gain-variants
    python3 tools/torch_coder_times.py --decode-variants --decode-phases DIR
    python3 tools/torch_coder_times.py --entropy-phases DIR
    python3 tools/torch_coder_times.py --entropy-variants --clocks
"""
from __future__ import annotations

import argparse
import ctypes
import json
import shutil
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT / "tools"))
from torch_dct4_times import NVCC_FLAGS, card, graph_ms, loop_ms, nvcc  # noqa: E402
from torch_ltpf_times import make_pcm, times  # noqa: E402
from torch_tdc_fxspec_times import CLOCK_PRELUDE  # noqa: E402
from torch_tns_times import stage_times  # noqa: E402

CSRC = ROOT / "audio_codec_torch" / "csrc"
OUT = ROOT / "build" / "coder_times"

STEP_BENCH = r"""
#include "ari_encode.cuh"
// V 0: the range coder's symbol step, one chain a thread over 16 symbols of
// the spectrum table's row 0, the same in every lane (a frame of 64 bytes a
// thread in shared memory, every store clipped to its last byte once the
// pointer passes it);
// V 1: bit_estimate's tuple step, the context carried from tuple to tuple.
template <int V>
__global__ void bench(const int32_t* tabs, const int32_t* bits_g, int32_t* out, int iters) {
  __shared__ int32_t lookup[4096];
  __shared__ int32_t bits_tab[64 * 17];
  __shared__ uint8_t frames[8 * 32 * 64];
  for (int i = threadIdx.x; i < 4096; i += blockDim.x) lookup[i] = tabs[i];
  for (int i = threadIdx.x; i < 64 * 17; i += blockDim.x) bits_tab[i] = bits_g[i];
  __syncthreads();
  const int32_t* row = tabs + 4096;   // cumfreq row 0
  int acc = 0;
  if (V == 0) {
    acx::Enc e;
    e.buf = frames + threadIdx.x * 64;
    e.nbytes = 64;
    e.bp = 0;
    e.low = 0;
    e.range = acx::MASK24;
    e.cache = -1;
    e.carry = 0;
    e.cc = 0;
    int cum[16], freq[16];
#pragma unroll
    for (int s = 0; s < 16; ++s) {
      const int j = (s * 5) & 15;   // every lane the same symbols: no divergence
      cum[s] = row[j];
      freq[s] = (row[j + 1] - row[j]) | 1;
    }
    for (int it = 0; it < iters; ++it) {
#pragma unroll
      for (int s = 0; s < 16; ++s) acx::enc_symbol(e, freq[s], cum[s]);
    }
    acc = e.low + e.range + e.bp;
  } else {
    acx::BeTuple q[16];
#pragma unroll
    for (int s = 0; s < 16; ++s) {
      const int a = (s * 7) % 13, b = (s * 3) % 9;   // the same in every lane
      q[s].a = a;
      q[s].b = b;
      q[s].nlev = acx::escape_count(a, b);
      q[s].nl = q[s].nlev;
      q[s].aa = a >> q[s].nlev;
      q[s].bb = b >> q[s].nlev;
      q[s].tn = acx::tuple_tn(q[s].nlev, q[s].aa, q[s].bb);
    }
    int c = 0;
    for (int it = 0; it < iters; ++it) {
#pragma unroll
      for (int s = 0; s < 16; ++s) {
        int lsb;
        acc += acx::be_tuple_bits(q[s], c + (s > 8 ? 256 : 0), 0, lookup, bits_tab, lsb);
        c = (c & 15) * 16 + q[s].tn + (acc & 1);
      }
    }
  }
  out[blockIdx.x * blockDim.x + threadIdx.x] = acc;
}
extern "C" int run(int v, const void* tabs, const void* bits, void* out, int iters, int blocks,
                   int threads, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int32_t* T = static_cast<const int32_t*>(tabs);
  const int32_t* Bt = static_cast<const int32_t*>(bits);
  int32_t* O = static_cast<int32_t*>(out);
  if (v == 0) bench<0><<<blocks, threads, 0, st>>>(T, Bt, O, iters);
  if (v == 1) bench<1><<<blocks, threads, 0, st>>>(T, Bt, O, iters);
  return static_cast<int>(cudaGetLastError());
}
"""
STEPS = ("range coder symbol step (enc_symbol)", "bit_estimate tuple step (be_tuple_bits)")


def build_bench(d: Path, source: str) -> ctypes.CDLL:
    shutil.rmtree(d, ignore_errors=True)
    d.mkdir(parents=True)
    (d / "bench.cu").write_text(source)
    r = subprocess.run([nvcc(), *NVCC_FLAGS, f"-I{CSRC}", "-o", str(d / "bench.so"),
                        str(d / "bench.cu")], capture_output=True, text=True)
    if r.returncode:
        raise SystemExit(f"nvcc failed:\n{r.stdout}{r.stderr}")
    return ctypes.CDLL(str(d / "bench.so"))


def step_bench() -> None:
    import torch
    sys.path.insert(0, str(ROOT))
    from audio_codec_torch import kernels as K
    lib = build_bench(OUT / "step_bench", STEP_BENCH)
    lib.run.argtypes = [ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    tabs = K._coder_tables("cuda")
    bits = K._bits_tables("cuda")[1]
    out = torch.empty(132 * 256, dtype=torch.int32, device="cuda")
    iters = 500
    for warps in (1, 8):
        for v, name in enumerate(STEPS):
            st = torch.cuda.current_stream().cuda_stream
            ms = min(loop_ms(lambda: lib.run(v, tabs.data_ptr(), bits.data_ptr(), out.data_ptr(),
                                             iters, 132, 32 * warps, st), 3) for _ in range(3))
            steps = 16 * iters
            print(f"[step] {card()} | {name}, {warps} warp(s) an SM: {ms * 1e6 / steps:.3f} ns a "
                  f"dependent step", flush=True)


def record_launches(B: int, T: int):
    """The flagship's T-frame encode of B streams: (cfg, its stage calls,
    its kernel launches, the stage and kernel functions), the calls as
    {name: [(args, kwargs), ...]}."""
    import torch
    import audio_codec_torch as P
    from audio_codec_torch import kernels as K
    from audio_codec_torch.models import decoder
    from audio_codec_torch.ops import ari, bits, quant
    cfg = P.Config(fs_in=48000, bitrate=64000)
    pcm = torch.from_numpy(make_pcm(T, B, 480)).cuda()
    stages = {"quant.bit_estimate": [], "ari.encode": [], "quant.estimate_global_gain": [],
              "decoder.decode_entropy": []}
    kernels = {"bit_estimate": [], "ari_encode": [], "gain_bisection": []}
    mods = {"quant.bit_estimate": (quant, "bit_estimate"), "ari.encode": (ari, "encode"),
            "quant.estimate_global_gain": (quant, "estimate_global_gain"),
            "decoder.decode_entropy": (decoder, "decode_entropy"),
            "bit_estimate": (K, "bit_estimate"), "ari_encode": (K, "ari_encode"),
            "gain_bisection": (K, "gain_bisection")}
    saved = {n: getattr(m, a) for n, (m, a) in mods.items()}

    def recorder(store, fn):
        def rec(*a, **kw):
            store.append((a, kw))
            return fn(*a, **kw)
        return rec
    for n, (m, a) in mods.items():
        setattr(m, a, recorder((stages | kernels)[n], saved[n]))
    try:
        _, frames = P.encode_block(cfg, P.enc_state_init(cfg, B), pcm)
        P.decode_block(cfg, P.dec_state_init(cfg, B), frames)
    finally:
        for n, (m, a) in mods.items():
            setattr(m, a, saved[n])
    # the block's read-mode launch: its frames with the plain parse's fields
    buf = stages["decoder.decode_entropy"][-1][0][1].to(torch.int32).contiguous()
    kernels["ari_decode"] = [((cfg, buf, bits.parse_side_info_plain(cfg, buf)), {})]
    saved["ari_decode"] = K.ari_decode
    torch.cuda.synchronize()
    return cfg, stages, kernels, saved


def pc_launches(B: int):
    """ari_decode's arguments on tests/torch_kernel_cases.py:pc_decode_rows
    at EP3 tiled to B rows (the frames carry a partial-concealment block,
    half of them bfi 2 with a corrupt range), in the decoder's mode and in
    the encoder's simulation: [(tag, args, kwargs)]."""
    import numpy as np
    import torch
    import audio_codec_torch as P
    from audio_codec_torch.ops import bits
    from tests.torch_kernel_cases import pc_decode_rows
    cfg = P.Config(fs_in=48000, bitrate=64000, epmode=3)
    a = pc_decode_rows(3)
    pick = np.resize(np.arange(a["frames"].shape[0]), B)
    t = {k: torch.from_numpy(np.ascontiguousarray(v[pick])).cuda() for k, v in a.items()}
    side = bits.parse_side_info(cfg, t["frames"])
    args = (cfg, t["frames"], side, t["bfi_in"], t["be_l"], t["be_r"])
    return [("ari_decode PC EP3", args, {}), ("ari_decode PC sim EP3", args, {"pc_enc_sim": True})]


def measure(root: Path, B: int, T: int) -> dict:
    """The times of the checkout at root, in this process."""
    import torch
    sys.path.insert(0, str(root))
    from audio_codec_torch import kernels as K
    from audio_codec_torch.ops import ari, quant
    from tests.torch_kernel_cases import count_differing

    K.library()
    cfg, stages, kernels, fns = record_launches(B, T)
    out = {"root": str(root), "card": card(), "streams": B, "frames": T}
    plain = {"bit_estimate": quant.bit_estimate_plain, "ari_encode": ari.encode_plain,
             "gain_bisection": quant.gain_bisection_plain}
    # the last frame: bit_estimate in modes -1 and cfg.modeFlag, one
    # ari_encode, one gain_bisection
    for tag, stage, kernel, back in (("bit_estimate mode -1", "quant.bit_estimate",
                                      "bit_estimate", 2),
                                     (f"bit_estimate mode {cfg.modeFlag}",
                                      "quant.bit_estimate", "bit_estimate", 1),
                                     ("ari_encode", "ari.encode", "ari_encode", 1),
                                     ("gain_bisection", "quant.estimate_global_gain",
                                      "gain_bisection", 1)):
        (sargs, skw), (kargs, kkw) = stages[stage][-back], kernels[kernel][-back]
        lane0 = None
        if hasattr(K, "reset_ari_encode_lane0_streams") and kernel == "ari_encode":
            K.reset_ari_encode_lane0_streams("cuda")
        got, ref = fns[kernel](*kargs, **kkw), plain[kernel](*kargs, **kkw)
        torch.cuda.synchronize()
        if hasattr(K, "ari_encode_lane0_streams") and kernel == "ari_encode":
            lane0 = K.ari_encode_lane0_streams("cuda")
        out[tag] = {"differ": count_differing(got, ref), "lane0_streams": lane0,
                    "kernel": times(lambda: fns[kernel](*kargs, **kkw)),
                    "stage": stage_times(lambda: fns[stage](*sargs, **skw))}
    # the decoder: the block's T * B frames in the read mode, and the PC rows
    kargs, kkw = kernels["ari_decode"][-1]
    got, ref = fns["ari_decode"](*kargs, **kkw), ari.decode_plain(*kargs, **kkw)
    torch.cuda.synchronize()
    out[f"ari_decode {kargs[1].shape[0]} frames"] = {
        "differ": count_differing(got, ref),
        "kernel": times(lambda: fns["ari_decode"](*kargs, **kkw))}
    out.update(entropy_times(root, stages["decoder.decode_entropy"][-1], fns, B))
    for tag, args, kw in pc_launches(B):
        got, ref = fns["ari_decode"](*args, **kw), ari.decode_plain(*args, **kw)
        torch.cuda.synchronize()
        out[tag] = {"differ": count_differing(got, ref),
                    "kernel": times(lambda: fns["ari_decode"](*args, **kw))}
    return out


def host_ms(fn, n: int = 50) -> float:
    """The host's ms to enqueue one call (the median of n, each after a
    synchronise): what a stream-path caller waits before its next call."""
    import torch
    fn()
    ts = []
    for _ in range(n):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        ts.append((time.perf_counter() - t0) * 1e3)
    torch.cuda.synchronize()
    return statistics.median(ts)


def fused(K) -> bool:
    """Whether the imported checkout parses the side information inside the
    range decoder's launch (ari_decode_frames)."""
    return hasattr(K, "ari_decode_frames")


def stream_entropy_args(cfg, frames_last, B: int):
    """decode_entropy's arguments on the stream path, B frames: at EP0 the
    block's last frame (bfi 0, no corrupt range, as StreamDecoder passes
    them), at EP3 pc_decode_rows tiled to B with their channel flags; and
    the encoder's PC simulation's (cfg, EP3's logical payloads)."""
    import numpy as np
    import torch
    import audio_codec_torch as P
    from tests.torch_kernel_cases import core_frames, pc_decode_rows
    dev = frames_last.device
    none = torch.full((B,), -1, dtype=torch.int32, device=dev)
    ep0 = (cfg, frames_last.to(torch.int32).contiguous(),
           torch.zeros((B,), dtype=torch.int32, device=dev), none, none)
    cfg3 = P.Config(fs_in=48000, bitrate=64000, epmode=3)
    a = pc_decode_rows(3)
    pick = np.resize(np.arange(a["frames"].shape[0]), B)
    g = lambda v: torch.from_numpy(np.ascontiguousarray(v[pick])).to(dev)
    ep3 = (cfg3, g(a["frames"]), g(a["bfi_in"]), g(a["be_l"]), g(a["be_r"]))
    logical = core_frames(3)
    sim = (cfg3, torch.from_numpy(np.ascontiguousarray(
        logical[np.resize(np.arange(logical.shape[0]), B)].astype(np.int32))).to(dev))
    return {"EP0": ep0, "EP3": ep3}, sim


def entropy_times(root: Path, call, fns, B: int) -> dict:
    """The entropy phase of the imported checkout (see the module's
    docstring): the block's decode_entropy call `call` (its args and
    kwargs) and its kernels, and the stream path's calls."""
    import torch
    from audio_codec_torch import engine, kernels as K
    from audio_codec_torch.ops import bits
    from tests.torch_kernel_cases import count_differing
    cfg, frames, bfi = call[0][:3]
    phase = fns["decoder.decode_entropy"]
    buf = frames.to(torch.int32).contiguous()
    block = {"frames": int(buf.shape[0]), "phase": times(lambda: phase(cfg, frames, bfi))}
    if fused(K):
        run = lambda: K.ari_decode_frames(cfg, buf)
        block["ari_decode_frames"] = times(run)
    else:
        run = lambda: K.side_info_parse(cfg, buf)
        block["side_info_parse"] = times(run)
        block["side_info_parse + ari_decode"] = times(
            lambda: K.ari_decode(cfg, buf, K.side_info_parse(cfg, buf)))
    got = run()
    side = got[0] if fused(K) else got
    block["side_differ"] = count_differing(side, bits.parse_side_info_plain(cfg, buf))
    raw, _ = Entropy.raw_call("ari_decode", K.library(), (cfg, buf, None, None, None, False),
                              root / "audio_codec_torch" / "csrc")
    block["raw_graph_ms"] = min(graph_ms(raw) for _ in range(3))
    out = {"entropy block": block}
    stream, sim = stream_entropy_args(cfg, frames[-B:], B)
    for tag, args in (*stream.items(), ("EP3 b_left_step", None)):
        fn = (lambda: phase(*args)) if args is not None else (lambda: engine.b_left_step(*sim))
        out[f"entropy stream {tag}"] = {
            "host_ms": host_ms(fn), "loop_ms": statistics.median(loop_ms(fn) for _ in range(5))}
    return out


class Entropy:
    """The entropy phase's slice for tools/torch_subst_damp_times.py's
    drivers: one kernel, ari_decode.cu (its read mode in a checkout before
    the fusion, the parsed mode after), on the block's frames and on EP3's
    rows with their channel flags."""
    OUT = OUT / "entropy"
    MAIN = {"ari_decode": "ari_decode.cu", "ari_decode, global row": "ari_decode.cu"}
    CASES = {"ari_decode": ("block", "ep3"), "ari_decode, global row": ("block",)}
    # a checkout before the fusion: the nine side reads as constants (the
    # frame decoded to the end of its bytes: lastnz N, its side bits from
    # the last byte, no TNS), the cost of reading them
    PHASES = {
        "as it is": (),
        "the nine side reads as constants": (
            ("ari_decode.cuh", "    for (int j = 0; j < 9; ++j) sd[j] = io.side[j * L + s];",
             "    const int32_t k9[9] = {N, 0, 1, 0, 0, nbytes - 1, 1, 0, 0};\n"
             "    for (int j = 0; j < 9; ++j) sd[j] = k9[j];"),),
    }
    _PARSE = "      sd = dec_parse_side(fbuf + q * nbytes, io, s, kept[q]);"
    VARIANTS = {
        "kept: the parse from the warp's staged row": (),
        "the parse from the global row (12 loads through L1)": (
            ("ari_decode.cuh", _PARSE,
             "      sd = dec_parse_side(io.frames + static_cast<size_t>(s) * nbytes, io, s, "
             "kept[q]);"),),
        "phase cut: no parse (constant side fields, the side dict unwritten)": (
            ("ari_decode.cuh", _PARSE,
             "      sd = {N, 0, 1, {0, 0}, nbytes - 1, 1, 0, 0};"),),
    }
    _CLK = (
        ("ari_decode.cuh", '#include "warp.cuh"\n', '#include "warp.cuh"\n' + CLOCK_PRELUDE),
        ("ari_decode.cuh", "  typename W::template Lanes<SideRow> kept;\n",
         "  ACX_CLK(0);\n  typename W::template Lanes<SideRow> kept;\n"),
        ("ari_decode.cuh", "    int bfi_in = 0, be_l = -1, be_r = -1;\n",
         "    ACX_CLK(1);\n    int bfi_in = 0, be_l = -1, be_r = -1;\n"),
        ("ari_decode.cuh", "  w.sync();\n  if constexpr (kParse) dec_side_rows_out(",
         "  w.sync();\n  ACX_CLK(2);\n  if constexpr (kParse) dec_side_rows_out("),
        ("ari_decode.cuh", "  // the rows out: x and res a frame at a time",
         "  ACX_CLK(3);\n  // the rows out: x and res a frame at a time"),
        ("ari_decode.cuh", "      io.tns_idx[static_cast<size_t>(s0) * 16 + i] = rows.tns[(2 + (i & 15)) * S + (i >> 4)];\n  });\n",
         "      io.tns_idx[static_cast<size_t>(s0) * 16 + i] = rows.tns[(2 + (i & 15)) * S + (i >> 4)];\n  });\n  ACX_CLK(4);\n"),
    )
    CLOCKS = {"ari_decode": _CLK,
              "ari_decode, global row": _CLK + VARIANTS[
                  "the parse from the global row (12 loads through L1)"]}
    _PHASES = ((0, 1, "the parse (lane 0)"), (1, 2, "the decode (the warp)"),
               (2, 3, "the side rows out"), (3, 4, "the decoder's rows out"), (0, 4, "the warp"))
    CLOCK_PHASES = {"ari_decode": _PHASES, "ari_decode, global row": _PHASES}
    _recorded: dict = {}

    @staticmethod
    def record(root: Path, B: int) -> dict:
        """The recorded block's parse_and_decode arguments (cfg, frames,
        bfi_in, be_l, be_r, pc_enc_sim) and EP3's, made once a process with
        the checkout at root."""
        if B not in Entropy._recorded:
            import torch
            sys.path.insert(0, str(root))
            cfg, stages, _, _ = record_launches(B, 8)
            frames = stages["decoder.decode_entropy"][-1][0][1]
            _, ep3 = stream_entropy_args(cfg, frames[-B:], B)[0].values()
            block = (cfg, frames.to(torch.int32).contiguous(), None, None, None, False)
            Entropy._recorded[B] = {n: {"block": block, "ep3": (*ep3, False)}
                                    for n in Entropy.CASES}
        return Entropy._recorded[B]

    @staticmethod
    def raw_call(name: str, lib, args, csrc: Path):
        """A call of the C entry point of lib (built from csrc) on args as
        that checkout's wrapper hands them over: the parsed mode where csrc
        has it, else the read mode on rows of the plain parse's fields, made
        outside the call. (run, (outputs, args))."""
        import torch
        from audio_codec_torch import kernels as K
        from audio_codec_torch.ops import ari, bits
        cfg, buf, bfi_in, be_l, be_r, sim = args
        pc = ari.pc_params(cfg, sim)
        pc_mode = 0 if pc is None else 2 if sim else 1
        L, nbytes = buf.shape
        dev = buf.device
        from audio_codec_torch.ops.quant import residual_max_bits
        total = cfg.targetBytes * 8
        max_res = min(residual_max_bits(cfg), total)
        e = lambda *s: torch.empty((L, *s), dtype=torch.int32, device=dev)
        outs = (e(cfg.yLen), e(2), e(2, 8), e(max_res), torch.empty((7, L), dtype=torch.int32,
                                                                   device=dev))
        # kernels.py's arguments in either checkout (csrc/ari_decode.cu)
        ints = (L, nbytes, cfg.yLen, 22 if cfg.hrmode else 14, int(cfg.hrmode),
                8 if cfg.frame_dms == 100 else 4, 1 if cfg.enable_lpc_weighting else 0,
                cfg.rateFlag if cfg.fs_idx != 5 else 0, total, max_res,
                20 if cfg.hrmode else 1, pc_mode, 0 if pc is None else pc["pc_bytes"],
                cfg.targetBytes)
        tabs = K._decoder_tables(str(dev))
        P_, I_ = ctypes.c_void_p, ctypes.c_int
        st = lambda: torch.cuda.current_stream().cuda_stream
        ptrs = [t.data_ptr() for t in outs]
        if "acx_ari_decode_frames" in (csrc / "ari_decode.cu").read_text():
            fn = lib.acx_ari_decode_frames
            fn.argtypes = [P_] * 10 + [I_] * 19 + [P_]
            words = torch.empty(21 * L, dtype=torch.int32, device=dev)
            flags = (bfi_in, be_l, be_r) if pc_mode else (None, None, None)
            vecs, meta = K._stream_vecs(L, dict(zip("abc", flags)), {})
            one_tns = 1 if cfg.frame_dms == 25 else 0
            return (lambda: fn(buf.data_ptr(), words.data_ptr(), vecs, meta, tabs.data_ptr(),
                               *ptrs, *ints, cfg.targetBytes - 1, cfg.BW_cutoff_bits,
                               cfg.lastnz_bits, cfg.fs_idx, one_tns, st())), ((words, outs), args)
        fn = lib.acx_ari_decode
        fn.argtypes = [P_] * 9 + [I_] * 14 + [P_]
        side = bits.parse_side_info_plain(cfg, buf)
        i32 = lambda v: v.to(torch.int32)
        side_in = torch.stack([i32(side[k]) for k in ("lastnz", "lsb_mode", "num_tns")]
                              + [i32(side["tns_on"][:, 0]), i32(side["tns_on"][:, 1])]
                              + [i32(side[k]) for k in ("bp_side", "mask_side", "gg_idx",
                                                        "fac_ns_idx")]).contiguous()
        pc_in = None
        if pc_mode:
            pc_in = torch.stack([v if v is not None else torch.full((L,), d, dtype=torch.int32,
                                                                    device=dev)
                                 for v, d in zip((bfi_in, be_l, be_r), (0, -1, -1))]).contiguous()
        return (lambda: fn(buf.data_ptr(), side_in.data_ptr(),
                           None if pc_in is None else pc_in.data_ptr(), tabs.data_ptr(), *ptrs,
                           *ints, st())), ((None, outs), args)

    @staticmethod
    def differing(name: str, got, args) -> int:
        """Values of a raw call's outputs (the side words where the call
        made them, the decoder's rows) that differ from the plain parse and
        decode."""
        import torch
        from audio_codec_torch.ops import ari, bits
        from tests.torch_kernel_cases import count_differing
        words, (x, tns_order, tns_idx, res, out) = got
        cfg, buf, bfi_in, be_l, be_r, sim = args
        side = bits.parse_side_info_plain(cfg, buf)
        dec = ari.decode_plain(cfg, buf, side, bfi_in, be_l, be_r, pc_enc_sim=sim)
        torch.cuda.synchronize()
        got_dec = dict(x=x, tns_order=tns_order, tns_idx=tns_idx, res_bits=res,
                       **dict(zip(DEC_NAMES, out)))
        bad = count_differing(got_dec, {k: dec[k] for k in got_dec})
        if words is not None:
            L = buf.shape[0]
            names = ("bfi", "bw_idx", "lastnz", "lsb_mode", "gg_idx", "num_tns", "fac_ns_idx",
                     "bp_side", "mask_side")
            got_side = dict(zip(names, words[:9 * L].view(9, L)))
            got_side.update(tns_on=words[9 * L: 11 * L].view(L, 2),
                            scf_idx=words[11 * L: 18 * L].view(L, 7),
                            ltpf_param=words[18 * L:].view(L, 3))
            bad += count_differing(got_side, side)
        return bad

    @staticmethod
    def branches(name: str, args) -> dict:
        return {"frames": int(args[1].shape[0])}

    @staticmethod
    def clock_warps(name: str, args) -> int:
        """The warps a launch runs: a frame a lane, blocks of 4 warps."""
        return -(-args[1].shape[0] // 128) * 4


def entropy_builds(root: Path, B: int, jobs) -> None:
    """Each (tag, label, csrc, substitutions) built and timed raw on the
    block and on EP3's rows against the plain versions, two rounds
    (tools/torch_subst_damp_times.py:builds)."""
    import torch_subst_damp_times as SD
    SD.builds(root, [(tag, "ari_decode", label, csrc, subs) for tag, label, csrc, subs in jobs],
              B, Entropy)


def busy_rows(cfg, B: int, seed: int = 0):
    """[B, N] int32 rows on the card whose every tuple is nonzero with one
    escape level (magnitudes 4-7 beside 0-3)."""
    import numpy as np
    import torch
    rng = np.random.default_rng(seed)
    x = rng.integers(0, 4, (B, cfg.yLen))
    x[:, 0::2] = rng.integers(4, 8, (B, cfg.yLen // 2))
    x *= np.where(rng.random(x.shape) < 0.5, -1, 1)
    return torch.from_numpy(x.astype(np.int32)).cuda()


def scaling(B: int, T: int) -> None:
    import torch
    sys.path.insert(0, str(ROOT))
    import audio_codec_torch as P
    from audio_codec_torch import kernels as K
    from audio_codec_torch.ops import bits
    K.library()
    cfg, _, kernels, _ = record_launches(B, T)
    be, ae = kernels["bit_estimate"][-1][0], kernels["ari_encode"][-1][0]
    gb = kernels["gain_bisection"][-1][0]

    def tile(a, n):
        if not isinstance(a, torch.Tensor) or a.dim() == 0:
            return a
        idx = torch.arange(n, device=a.device) % a.shape[0]
        return a[idx].contiguous()
    for n in (4, 32, 512, 2048):
        a = tuple(tile(v, n) for v in be)
        ms = min(graph_ms(lambda: K.bit_estimate(*a)) for _ in range(3))
        print(f"[scaling] {card()} | bit_estimate: {n} streams of the flagship rows: graph "
              f"{ms:.5f} ms", flush=True)
        a = tuple(tile(v, n) for v in ae)
        K.reset_ari_encode_lane0_streams("cuda")
        K.ari_encode(*a)
        lane0 = K.ari_encode_lane0_streams("cuda")
        ms = min(graph_ms(lambda: K.ari_encode(*a)) for _ in range(3))
        print(f"[scaling] {card()} | ari_encode: {n} streams of the flagship rows: graph "
              f"{ms:.5f} ms, lane-0 streams {lane0}", flush=True)
        a = tuple(tile(v, n) for v in gb)
        ms = min(graph_ms(lambda: K.gain_bisection(*a)) for _ in range(3))
        print(f"[scaling] {card()} | gain_bisection: {n} streams of the flagship rows (M = "
              f"{gb[0].shape[1]}): graph {ms:.5f} ms", flush=True)
    # all-busy rows
    cfg160 = P.Config(fs_in=48000, bitrate=160000)
    for n in (4, 32, 512, 2048):
        x = busy_rows(cfg, n)
        tgt = torch.full((n,), 10 ** 6, dtype=torch.int32, device="cuda")
        ms = min(graph_ms(lambda: K.bit_estimate(cfg, x, tgt, 0)) for _ in range(3))
        print(f"[scaling] {card()} | bit_estimate: {n} all-busy streams (200 tuples with "
              f"escapes): graph {ms:.5f} ms", flush=True)
        x = busy_rows(cfg160, n, seed=1)
        z = lambda v: torch.full((n,), v, dtype=torch.int32, device="cuda")
        buf, bp, mask = bits.pack_side_info(
            cfg160, z(4), z(cfg160.yLen), z(0), z(170), z(1),
            torch.zeros((n, 2), dtype=torch.int32, device="cuda"),
            torch.zeros((n, 3), dtype=torch.int32, device="cuda"),
            torch.zeros((n, 7), dtype=torch.int32, device="cuda"), z(3))
        args = (cfg160, buf, bp, mask, x, torch.zeros((n, 2), dtype=torch.int32, device="cuda"),
                torch.zeros((n, 2, 8), dtype=torch.int32, device="cuda"), z(1), z(cfg160.yLen),
                z(0), torch.zeros((n, cfg160.yLen), dtype=torch.int32, device="cuda"), z(0))
        K.reset_ari_encode_lane0_streams("cuda")
        K.ari_encode(*args)
        lane0 = K.ari_encode_lane0_streams("cuda")
        ms = min(graph_ms(lambda: K.ari_encode(*args)) for _ in range(3))
        print(f"[scaling] {card()} | ari_encode at 160 kbps: {n} all-busy streams (200 tuples "
              f"with escapes): graph {ms:.5f} ms, lane-0 streams {lane0}", flush=True)
    args = kernels["ari_decode"][-1][0]
    for n in (32, 128, 2048, args[1].shape[0]):
        a = decode_slice(args, n)
        ms = min(graph_ms(lambda: K.ari_decode(*a)) for _ in range(3))
        print(f"[scaling] {card()} | ari_decode: {n} frames of the block launch: graph "
              f"{ms:.5f} ms", flush=True)


# the kept sources read their tables from global memory through L1; these
# substitutions stage them in shared memory once a block instead
TABLE_VARIANTS = {
    "bit_estimate.cu": (
        ("  extern __shared__ int32_t rows[];\n",
         "  extern __shared__ int32_t smem[];\n"
         "  acx_load_shared(smem, lookup, 4096);\n"
         "  acx_load_shared(smem + 4096, bits_tab, 64 * 17);\n"
         "  __syncthreads();\n"
         "  lookup = smem;\n"
         "  bits_tab = smem + 4096;\n"
         "  int32_t* rows = smem + 4096 + 64 * 17;\n"),
        ("const size_t smem = static_cast<size_t>(kBitEstWarps) * N * sizeof(int32_t);",
         "const size_t smem = (4096 + 64 * 17 + static_cast<size_t>(kBitEstWarps) * N) * "
         "sizeof(int32_t);")),
    "ari_encode.cu": (
        ("  const int32_t* tab = tabs;\n  int32_t* warps = smem;\n",
         "  acx_load_shared(smem, tabs, 5410);\n  __syncthreads();\n"
         "  const int32_t* tab = smem;\n  int32_t* warps = smem + 5410;\n"),
        ("const size_t smem = static_cast<size_t>(kAriEncWarps) * ari_warp_words(N, nbytes) *",
         "const size_t smem = (5410 + static_cast<size_t>(kAriEncWarps) * "
         "ari_warp_words(N, nbytes)) *")),
}


def build_variant(name: str, source: str, subs) -> ctypes.CDLL:
    """A library of csrc/<source> alone with the text substitutions subs."""
    d = OUT / "tables" / name
    shutil.rmtree(d, ignore_errors=True)
    d.mkdir(parents=True)
    for f in ("acodec.cuh", "warp.cuh", "bit_estimate.cuh", "ari_encode.cuh"):
        shutil.copy(CSRC / f, d / f)
    text = (CSRC / source).read_text()
    for old, new in subs:
        if old not in text:
            raise SystemExit(f"{name}: {old!r} is not in {source}")
        text = text.replace(old, new)
    (d / source).write_text(text)
    r = subprocess.run([nvcc(), *NVCC_FLAGS, "-o", str(d / "lib.so"), str(d / source)],
                       capture_output=True, text=True)
    if r.returncode:
        raise SystemExit(f"nvcc failed on {name}:\n{r.stdout}{r.stderr}")
    return ctypes.CDLL(str(d / "lib.so"))


def tables(B: int, T: int) -> None:
    """Both kernels with their tables read through L1 (the kept sources) and
    staged in shared memory once a block, built side by side and run on the
    recorded launches."""
    import torch
    sys.path.insert(0, str(ROOT))
    from audio_codec_torch import kernels as K
    from audio_codec_torch.ops import ari, quant
    K.library()
    cfg, _, kernels, _ = record_launches(B, T)
    P_, I_ = ctypes.c_void_p, ctypes.c_int
    libs = {}
    for source, subs in TABLE_VARIANTS.items():
        for where, sub in (("L1", ()), ("shared", subs)):
            lib = build_variant(f"{source[:-3]}_{where}", source, sub)
            if source == "bit_estimate.cu":
                lib.acx_bit_estimate.argtypes = [P_] * 5 + [I_] * 5 + [P_]
            else:
                lib.acx_ari_encode.argtypes = [P_] * 14 + [I_] * 8 + [P_]
            libs[(source, where)] = lib
    lookup, bits_tab = K._bits_tables("cuda")
    tabs = K._coder_tables("cuda")
    counter = torch.zeros(1, dtype=torch.int32, device="cuda")
    st = lambda: torch.cuda.current_stream().cuda_stream
    calls = []
    for args, _ in kernels["bit_estimate"][-2:]:
        _, xq, target, mode = args
        n, N = xq.shape
        tgt = target.to(torch.int32).expand(n).contiguous()
        o = torch.empty((5, n), dtype=torch.int32, device="cuda")
        ref = quant.bit_estimate_plain(*args)
        ref = torch.stack([ref[k] for k in ("nbits", "nbits2", "lastnz", "lastnz2", "lsbMode")])
        calls.append(("bit_estimate.cu", f"mode {mode}", o, ref,
                      lambda lib, xq=xq, tgt=tgt, o=o, n=n, N=N, mode=mode: lib.acx_bit_estimate(
                          xq.data_ptr(), tgt.data_ptr(), o.data_ptr(), lookup.data_ptr(),
                          bits_tab.data_ptr(), n, N, mode, cfg.rateFlag, 14, st())))
    args = kernels["ari_encode"][-1][0]
    c, buf, bp, mask, xq, order, idx, num_tns, lastnz, lsb, res, n_res = args
    buf, order, idx, res = (t.to(torch.int32).contiguous() for t in (buf, order, idx, res))
    n, N = xq.shape
    side = [K._i32(v, n, xq.device) for v in (bp, mask, num_tns, lastnz, lsb, n_res)]
    o = torch.empty_like(buf)
    calls.append(("ari_encode.cu", "", o, ari.encode_plain(*args),
                  lambda lib: lib.acx_ari_encode(
                      buf.data_ptr(), o.data_ptr(), xq.data_ptr(), *(v.data_ptr() for v in side),
                      order.data_ptr(), idx.data_ptr(), res.data_ptr(), tabs.data_ptr(),
                      counter.data_ptr(), n, N, buf.shape[1], res.shape[1], 14, c.rateFlag,
                      1 if c.enable_lpc_weighting else 0, c.targetBitsAri, st())))
    for rnd in range(2):
        for source, what, o, ref, call in calls:
            for where in ("L1", "shared"):
                lib = libs[(source, where)]
                rc = call(lib)
                torch.cuda.synchronize()
                differ = int((o != ref).sum())
                ms = min(graph_ms(lambda: call(lib)) for _ in range(3))
                print(f"[tables] {card()} | round {rnd} {source[:-3]} {what} tables {where}: rc "
                      f"{rc}, {differ} values differ from the plain version, graph {ms:.5f} ms",
                      flush=True)


# gain_bisection's warp designs: V 0 the kept one
# (gain_bisection.cuh:gain_bisection_warp: two rounds of one chain a lane,
# every value of a step computed and then selected, the block loop unrolled
# by 4), V 1 one round of every node of the decision tree, 8 chains a lane,
# V 2-3 the two rounds with the first warp design's step, V 4 the kept step
# not unrolled, V 5 the floor (the row staged, one ballot, no chain)
GAIN_VARIANTS = r"""
#include "gain_bisection.cuh"
using namespace acx;

// all 255 nodes at once: node ln + 1 + 32 c on lane ln (c = 0..7; lane 31's
// last chain repeats node 255, and the walk never reads its bit), one
// ballot a chain, an 8-level walk
__device__ int gain_bisection_all(int lane, const float* en, int M, float target, int offset0) {
  int offs[8];
  bool pass[8];
#pragma unroll
  for (int c = 0; c < 8; ++c) offs[c] = gain_node_test(offset0, 8, imin(lane + 1 + 32 * c, 255));
  gain_tests<8>(en, M, target, offs, pass);
  unsigned mask[8];
#pragma unroll
  for (int c = 0; c < 8; ++c) mask[c] = __ballot_sync(0xFFFFFFFFu, pass[c]);
  int h = 1;
  for (int k = 0; k < 8; ++k) {
    const int i = h - 1;
    unsigned word = 0u;
#pragma unroll
    for (int c = 0; c < 8; ++c) word = c == (i >> 5) ? mask[c] : word;
    h = 2 * h + static_cast<int>((word >> (i & 31)) & 1u);
  }
  return gain_node_offset(offset0, 8, h);
}

// the first warp design's step (its conditions as nvcc compiled them: a
// branch each), the block loop unrolled U times
template <int U>
__device__ bool gain_test_branches(const float* en, int M, float target, int offset) {
  const float offs_f = static_cast<float>(offset);
  float ener = 0.0f;
  bool iszero = true;
#pragma unroll (U)
  for (int j = M - 1; j >= 0; --j) {
    const float t = rsub(en[j], offs_f);
    const bool low = t < kGainLow;
    const float add = low ? ((!iszero) ? kGainGap : 0.0f)
                          : (t >= kGainHigh ? rsub(rmul(2.0f, t), kGainHigh) : t);
    ener = radd(ener, add);
    iszero = iszero && low;
  }
  return ener > target && !iszero;
}

// the kept step, the block loop not unrolled
__device__ bool gain_test_rolled(const float* en, int M, float target, int offset) {
  const float offs_f = static_cast<float>(offset);
  float ener = 0.0f;
  unsigned iszero = 1u;
#pragma unroll 1
  for (int j = M - 1; j >= 0; --j) {
    const float t = rsub(en[j], offs_f);
    const float high = rsub(rmul(2.0f, t), kGainHigh);
    const unsigned low = t < kGainLow ? 1u : 0u;
    const float above = t >= kGainHigh ? high : t;
    const float gap = iszero != 0u ? 0.0f : kGainGap;
    ener = radd(ener, low != 0u ? gap : above);
    iszero &= low;
  }
  return ener > target && iszero == 0u;
}

// the kept two rounds over another step (S 1: the first design's, unrolled
// U times; S 2: the kept step not unrolled)
template <int S, int U>
__device__ int gain_bisection_step(int lane, const float* en, int M, float target, int offset0) {
  auto test = [&](int offset) {
    return S == 1 ? gain_test_branches<U>(en, M, target, offset)
                  : gain_test_rolled(en, M, target, offset);
  };
  const bool pa = lane < 31 && test(gain_node_test(offset0, 8, lane + 1));
  const int o5 = gain_node_offset(offset0, 8, gain_walk(__ballot_sync(0xFFFFFFFFu, pa), 1, 5));
  const bool pb = lane < 7 && test(gain_node_test(o5, 3, lane + 1));
  return gain_node_offset(o5, 3, gain_walk(__ballot_sync(0xFFFFFFFFu, pb), 1, 3));
}

template <int V>
__global__ void __launch_bounds__(256) kernel(const float* en, const float* target, int* out,
                                              int B, int M, int offset0) {
  extern __shared__ float rows[];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int s = blockIdx.x * 8 + warp;
  if (s >= B) return;
  float* row = rows + static_cast<size_t>(warp) * M;
  for (int i = lane; i < M; i += 32) row[i] = en[static_cast<size_t>(s) * M + i];
  __syncwarp();
  int o = 0;
  if (V == 0) o = gain_bisection_warp(CoderCardWarp{lane}, row, M, target[s], offset0);
  if (V == 1) o = gain_bisection_all(lane, row, M, target[s], offset0);
  if (V == 2) o = gain_bisection_step<1, 1>(lane, row, M, target[s], offset0);
  if (V == 3) o = gain_bisection_step<1, 8>(lane, row, M, target[s], offset0);
  if (V == 4) o = gain_bisection_step<2, 1>(lane, row, M, target[s], offset0);
  if (V == 5) o = __ballot_sync(0xFFFFFFFFu, row[lane % M] > target[s]);   // no chain: the floor
  if (lane == 0) out[s] = o;
}
extern "C" int run(int v, const void* en, const void* target, void* out, int B, int M,
                   int offset0, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const size_t smem = 8 * static_cast<size_t>(M) * sizeof(float);
  const int blocks = (B + 7) / 8;
  const float* E = static_cast<const float*>(en);
  const float* T = static_cast<const float*>(target);
  int* O = static_cast<int*>(out);
  if (v == 0) kernel<0><<<blocks, 256, smem, st>>>(E, T, O, B, M, offset0);
  if (v == 1) kernel<1><<<blocks, 256, smem, st>>>(E, T, O, B, M, offset0);
  if (v == 2) kernel<2><<<blocks, 256, smem, st>>>(E, T, O, B, M, offset0);
  if (v == 3) kernel<3><<<blocks, 256, smem, st>>>(E, T, O, B, M, offset0);
  if (v == 4) kernel<4><<<blocks, 256, smem, st>>>(E, T, O, B, M, offset0);
  if (v == 5) kernel<5><<<blocks, 256, smem, st>>>(E, T, O, B, M, offset0);
  return static_cast<int>(cudaGetLastError());
}
"""
GAIN_DESIGNS = ("kept: two rounds (31 + 7 nodes, one chain a lane), steps selected, unrolled by 4",
                "one round (255 nodes, 8 chains a lane)",
                "two rounds, the first design's step (a branch a condition)",
                "two rounds, the first design's step, unrolled by 8",
                "two rounds, the kept step not unrolled",
                "the row staged and one ballot, no chain (the floor; not a bisection)")


def gain_variants(B: int, T: int) -> None:
    import torch
    sys.path.insert(0, str(ROOT))
    from audio_codec_torch.ops import quant
    lib = build_bench(OUT / "gain_variants", GAIN_VARIANTS)
    lib.run.argtypes = [ctypes.c_int] + [ctypes.c_void_p] * 3 + [ctypes.c_int] * 3 + \
        [ctypes.c_void_p]
    _, _, kernels, _ = record_launches(B, T)
    en, target, offset0 = kernels["gain_bisection"][-1][0]
    st = lambda: torch.cuda.current_stream().cuda_stream
    for rnd in range(2):
        for n in (4, 32, 512, 2048):
            idx = torch.arange(n, device="cuda") % en.shape[0]
            e, tg = en[idx].contiguous(), target[idx].contiguous()
            ref = quant.gain_bisection_plain(e, tg, offset0)
            out = torch.empty(n, dtype=torch.int32, device="cuda")
            for v, name in enumerate(GAIN_DESIGNS):
                call = lambda: lib.run(v, e.data_ptr(), tg.data_ptr(), out.data_ptr(), n,
                                       e.shape[1], offset0, st())
                rc = call()
                torch.cuda.synchronize()
                differ = None if v == 5 else int((out != ref).sum())
                ms = min(graph_ms(call) for _ in range(3))
                print(f"[gain variants] {card()} | round {rnd}, {n} streams, {name}: rc {rc}, "
                      f"{differ} offsets differ from the plain version, graph {ms:.5f} ms",
                      flush=True)


def decode_slice(args, n: int):
    """ari_decode's (cfg, buf, side) for the first n frames of a launch,
    tiled where n is larger."""
    import torch
    cfg, buf, side = args[:3]
    idx = torch.arange(n, device=buf.device) % buf.shape[0]
    return (cfg, buf[idx].contiguous(),
            {k: v[idx].contiguous() if isinstance(v, torch.Tensor) and v.dim() else v
             for k, v in side.items()})


def decode_c_args(args):
    """The C arguments of an ari_decode launch without a PC block, as the
    wrapper builds them: (inputs, outputs, ints after L and nbytes)."""
    import torch
    from audio_codec_torch import kernels as K
    from audio_codec_torch.ops.quant import residual_max_bits
    cfg, buf, side = args[:3]
    L, nbytes = buf.shape
    dev = buf.device
    side_in = torch.stack([K._i32(side[k], L, dev) for k in ("lastnz", "lsb_mode", "num_tns")]
                          + [K._i32(side["tns_on"][:, 0], L, dev),
                             K._i32(side["tns_on"][:, 1], L, dev)]
                          + [K._i32(side[k], L, dev) for k in ("bp_side", "mask_side", "gg_idx",
                                                               "fac_ns_idx")]).contiguous()
    total_bits = cfg.targetBytes * 8
    max_res = min(residual_max_bits(cfg), total_bits)
    e = lambda *s, dt=torch.int32: torch.empty((L, *s), dtype=dt, device=dev)
    outs = dict(x=e(cfg.yLen), tns_order=e(2), tns_idx=e(2, 8), res_bits=e(max_res),
                levs=e(cfg.yLen // 2, dt=torch.uint8), out=torch.empty((7, L), dtype=torch.int32,
                                                                       device=dev))
    ints = (cfg.yLen, 22 if cfg.hrmode else 14, int(cfg.hrmode), 8 if cfg.frame_dms == 100 else 4,
            1 if cfg.enable_lpc_weighting else 0, cfg.rateFlag if cfg.fs_idx != 5 else 0,
            total_bits, max_res, 20 if cfg.hrmode else 1)
    return (buf.to(torch.int32).contiguous(), side_in, K._decoder_tables(str(dev))), outs, ints


DEC_NAMES = ("nf_seed", "zero_frame", "n_res", "residual_present", "bfi", "spec_inv_idx",
             "b_left")


def decode_differing(outs: dict, ref: dict) -> dict:
    """The outputs that differ from the plain version's, with their counts."""
    got = {k: outs[k] for k in ("x", "tns_order", "tns_idx", "res_bits")}
    got.update(zip(DEC_NAMES, outs["out"]))
    bad = {k: int((got[k] != ref[k]).sum()) for k in got}
    return {k: v for k, v in bad.items() if v}


DEC_STEP_BENCH = r"""
#include "ari_decode.cuh"
// one chain a thread: a tuple's first symbol (the lookup, the search, the
// renormalisation) and the context, 16 a round, over a frame of 64 seeded
// bytes a thread (the pointer wraps). V 0: the inverse table, 1: the count
// (a binary search where the library is built with DECODE_BINARY); V | 4:
// the tables (and the inverse) in shared memory.
template <int V>
__global__ void bench(const int32_t* tabs, const uint8_t* bytes, int32_t* out, int iters) {
  extern __shared__ int4 smem4[];
  int32_t* t = reinterpret_cast<int32_t*>(smem4);
  uint8_t* frames = reinterpret_cast<uint8_t*>(t + 5412 + 16384);
  if (V & 4) {
    for (int i = threadIdx.x; i < 5412 + 16384; i += blockDim.x) t[i] = tabs[i];
  }
  for (int i = threadIdx.x; i < 256 * 64; i += blockDim.x) frames[i] = bytes[i];
  __syncthreads();
  const int32_t* tab = (V & 4) ? t : tabs;
  const uint8_t* inv = reinterpret_cast<const uint8_t*>(tab + 5412);
  constexpr bool kInv = (V & 3) == 0;
  acx::Dec d;
  d.buf = frames + threadIdx.x * 64;
  d.nbytes = 64;
  d.bp = 3;
  d.low = ((d.buf[0] << 16) + (d.buf[1] << 8) + d.buf[2]) >> 1;
  d.range = acx::MASK24;
  d.ber = 0;
  d.nb = d.buf[3];
  int c = 0;
  bool stop;
  if (V >= 12) {   // the step's parts alone, tables in shared memory
    const uint8_t* sinv = reinterpret_cast<const uint8_t*>(t + 5412);
    int low = d.low, tmp = 1 + (threadIdx.x & 255);
    for (int it = 0; it < iters; ++it) {
#pragma unroll
      for (int s = 0; s < 16; ++s) {
        if (V == 12) c = t[c & 4095];                           // one shared load
        if (V == 13) {                                         // lookup, inverse, row
          const int pki = t[c & 4095];
          const int cnt = sinv[pki * acx::kDecInvQ + (c & 1023)];
          c += t[4096 + pki * 18 + cnt];
        }
        if (V == 14) {                                         // the quotient
          const int q = acx::dec_quotient(low, tmp);
          low = (low + q + s) & 0xFFFFF;
          c += q;
        }
      }
    }
    out[blockIdx.x * blockDim.x + threadIdx.x] = c + low;
    return;
  }
  for (int it = 0; it < iters; ++it) {
#pragma unroll
    for (int s = 0; s < 16; ++s) {
      const int pki = tab[(c + (s > 8 ? 256 : 0)) & 4095];
      const int sym = acx::dec_symbol<acx::kPcNone, 17, kInv>(
          d, tab + 4096 + pki * 18, inv + pki * acx::kDecInvQ, 0, &stop);
      c = (c & 15) * 16 + 1 + (sym & 7);
      d.bp &= 63;
    }
  }
  out[blockIdx.x * blockDim.x + threadIdx.x] = c + d.low + d.ber;
}
template <int V>
static int launch(const int32_t* T, const uint8_t* Bt, int32_t* O, int iters, int blocks,
                  int threads, cudaStream_t st) {
  const int smem = (5412 + 16384) * 4 + 256 * 64;
  const cudaError_t e = cudaFuncSetAttribute(bench<V>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                             smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  bench<V><<<blocks, threads, smem, st>>>(T, Bt, O, iters);
  return static_cast<int>(cudaGetLastError());
}
extern "C" int run(int v, const void* tabs, const void* bytes, void* out, int iters, int blocks,
                   int threads, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int32_t* T = static_cast<const int32_t*>(tabs);
  const uint8_t* Bt = static_cast<const uint8_t*>(bytes);
  int32_t* O = static_cast<int32_t*>(out);
  switch (v) {
    case 0: return launch<0>(T, Bt, O, iters, blocks, threads, st);
    case 1: return launch<1>(T, Bt, O, iters, blocks, threads, st);
    case 4: return launch<4>(T, Bt, O, iters, blocks, threads, st);
    case 5: return launch<5>(T, Bt, O, iters, blocks, threads, st);
    case 8: return launch<12>(T, Bt, O, iters, blocks, threads, st);
    case 9: return launch<13>(T, Bt, O, iters, blocks, threads, st);
    case 10: return launch<14>(T, Bt, O, iters, blocks, threads, st);
  }
  return -1;
}
"""
# (library: 0 this checkout's headers, 1 with DECODE_BINARY; V; name)
DEC_STEPS = ((0, 0, "the inverse table, tables through L1"),
             (0, 1, "the count, tables through L1"),
             (1, 1, "the binary search, tables through L1"),
             (0, 4, "the inverse table, tables in shared memory (kept)"),
             (0, 5, "the count, tables in shared memory"),
             (1, 5, "the binary search, tables in shared memory"),
             (0, 8, "part: one shared load"),
             (0, 9, "part: the lookup, inverse and row loads"),
             (0, 10, "part: the quotient (dec_quotient)"))


def decode_step_bench() -> None:
    import numpy as np
    import torch
    sys.path.insert(0, str(ROOT))
    from audio_codec_torch import kernels as K
    libs = build_all([(OUT / f"dec_step_bench{i}", CSRC, DECODE_FILES, subs, DEC_STEP_BENCH)
                      for i, subs in enumerate(((), DECODE_BINARY))])
    for lib in libs:
        lib.run.argtypes = [ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                            ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    tabs = K._decoder_tables("cuda")
    rng = np.random.default_rng(0)
    bytes_ = torch.from_numpy(rng.integers(0, 256, 256 * 64).astype(np.uint8)).cuda()
    out = torch.empty(132 * 256, dtype=torch.int32, device="cuda")
    st = lambda: torch.cuda.current_stream().cuda_stream
    for warps in (1, 4):
        for i, v, name in DEC_STEPS:
            # the difference of 300 and 100 rounds: the staging cancels
            ms = [min(graph_ms(lambda: libs[i].run(v, tabs.data_ptr(), bytes_.data_ptr(),
                                                   out.data_ptr(), iters, 132, 32 * warps, st()))
                      for _ in range(3)) for iters in (100, 300)]
            print(f"[step] {card()} | range decoder symbol step (dec_symbol), {name}, {warps} "
                  f"warp(s) an SM: {(ms[1] - ms[0]) * 1e6 / (16 * 200):.3f} ns a dependent step",
                  flush=True)


DECODE_FILES = ("acodec.cuh", "warp.cuh", "ari_decode.cuh", "ari_decode.cu")
# The designs the kept one was compared with, as text substitutions (file,
# old, new) of this checkout's csrc/ari_decode.cu and ari_decode.cuh. Every
# build keeps only the launch without a PC block, which is what is timed.
_NONE_ONLY = ("ari_decode.cu",
              "  if (pc_mode == kPcDecode) err = ari_decode_mode<kPcDecode, kParse>(io, tabs, g, st);\n"
              "  else if (pc_mode == kPcEncSim) err = ari_decode_mode<kPcEncSim, kParse>(io, tabs, g, st);\n"
              "  else err", "  err")
_COUNT = (("ari_decode.cuh", "const int sym = dec_symbol<kPc, 17, true>(",
           "const int sym = dec_symbol<kPc, 17, false>("),)
_COUNT_LINE = "  for (int j = 0; j < kSym; ++j) cnt += tmp * row[j] <= low ? 1 : 0;\n"
DECODE_BINARY = (("ari_decode.cuh", _COUNT_LINE,
                  "  for (int step = 16; step > 0; step >>= 1) {\n"
                  "    const int j = cnt + step - 1;\n"
                  "    if (j < kSym && tmp * row[j] <= low) cnt += step;\n"
                  "  }\n"),)


def _groups(G: int):
    """G lanes a frame: each lane of a group holds the frame's whole state,
    and the group splits the count, lane g testing j = g mod G."""
    return (("ari_decode.cuh", "#pragma once\n", f"#pragma once\n#define DEC_G {G}\n"),
            ("ari_decode.cuh", _COUNT_LINE,
             "#ifdef __CUDA_ARCH__\n"
             "  const int gl = threadIdx.x % 32 % DEC_G;\n"
             "  for (int j = gl; j < kSym; j += DEC_G) cnt += tmp * row[j] <= low ? 1 : 0;\n"
             "  cnt = __reduce_add_sync(((1u << DEC_G) - 1u) << (threadIdx.x % 32 / DEC_G * DEC_G),"
             " cnt);\n"
             "#endif\n"),
            ("ari_decode.cuh", "  w.lanes([&](int q) {\n    if (q >= nf) return;",
             "  w.lanes([&](int q) {\n    q /= DEC_G;\n    if (q >= nf) return;"),
            ("ari_decode.cu", "constexpr int kDecFrames = 32;",
             "constexpr int kDecFrames = 32 / DEC_G;"))


def _warps(n: int):
    return (("ari_decode.cu", "constexpr int kDecWarps = 4;", f"constexpr int kDecWarps = {n};"),)


_STAGE_ALL = "constexpr int kDecStageWords = kDecInvWord + kDecInvWords;"
_L1 = (("ari_decode.cu", _STAGE_ALL, "constexpr int kDecStageWords = 0;"),
       ("ari_decode.cu", "  const int32_t* t = p;", "  const int32_t* t = tabs;"))
_TABLES_ONLY = (("ari_decode.cu", _STAGE_ALL, "constexpr int kDecStageWords = kDecInvWord;"),
                ("ari_decode.cu", "tb.inv = reinterpret_cast<const uint8_t*>(t + kDecInvWord);",
                 "tb.inv = reinterpret_cast<const uint8_t*>(tabs + kDecInvWord);"))
_X32 = (("ari_decode.cu", "  if (g.hrmode) return ari_decode_launch<kPc, kParse, int32_t>",
         "  if (true) return ari_decode_launch<kPc, kParse, int32_t>"),)
DECODE_VARIANTS = {
    "kept: a thread a frame, the inverse table, 4-warp blocks sharing it and the tables in "
    "shared memory, x as int16": (),
    "the same, 2-warp blocks": _warps(2),
    "the inverse table and the tables through L1, one-warp blocks": _L1 + _warps(1),
    "the inverse table, x as int32 (2-warp blocks: 4 do not fit)": _X32,
    "the count of 17 products, 4-warp blocks sharing the tables in shared memory":
        _COUNT + _TABLES_ONLY,
    "the count, one-warp blocks, tables through L1 (the first redesign)":
        _COUNT + _L1 + _warps(1),
    "the binary search, 4-warp blocks sharing the tables": _COUNT + DECODE_BINARY + _TABLES_ONLY,
    "groups of 4 lanes a frame splitting the count, 4-warp blocks":
        _COUNT + _groups(4) + _TABLES_ONLY,
    "groups of 8 lanes a frame splitting the count, 4-warp blocks":
        _COUNT + _groups(8) + _TABLES_ONLY,
}
# the kept design with one phase removed (text substitutions of ari_decode.cuh)
DECODE_CUTS = {
    "kept, the side bits read in branches (as with a PC block)": (
        ("      if constexpr (kPc == kPcNone) {\n        // no hook can stop a read",
         "      if constexpr (kPc < 0) {\n        // no hook can stop a read"),
        ("    if constexpr (kPc == kPcNone) {\n      if (dec_side_bit_where(d, ak > 0",
         "    if constexpr (kPc < 0) {\n      if (dec_side_bit_where(d, ak > 0")),
    "kept, no write-out of x and the residual bits": (
        ("  for (int q = 0; q < nf; ++q) {\n    const size_t s = static_cast<size_t>(s0 + q);",
         "  for (int q = 0; q < 0; ++q) {\n    const size_t s = static_cast<size_t>(s0 + q);"),),
    "kept, no TNS and tuple loops (the staging, the write-out of zeros, the scalars)": (
        ("  for (int f = 0; f < 2; ++f) {\n    if (!(f < num_tns",
         "  for (int f = 0; f < 0; ++f) {\n    if (!(f < num_tns"),
        ("  for (int k = 0; k < N / 2; ++k) {\n    if (!(2 * k < lastnz && bfi == 0)) break;",
         "  for (int k = 0; k < 0; ++k) {\n    if (!(2 * k < lastnz && bfi == 0)) break;")),
}

# the first design (ari_decode.cu as first written, a thread a frame in blocks of 32
# threads) with one phase removed: substitutions of (file, old, new)
_ZERO = ("ari_decode.cuh", "  for (int i = 0; i < N; ++i) x[i] = 0;\n"
         "  for (int i = 0; i < N / 2; ++i) levs[i] = 0;\n", "")
_ZERO_RES = ("ari_decode.cuh", "  for (int i = 0; i < g.max_res; ++i) res[i] = 0;\n", "")
_NZ_DECL = ("ari_decode.cuh", "  int c = 0;\n  bool trig;", "  int c = 0, nz_in = 0;\n  bool trig;")
_NZ_COUNT = ("ari_decode.cuh", "    const int lev1 = imin(lev_eff, 3);",
             "    nz_in += (ak != 0 ? 1 : 0) + (bk != 0 ? 1 : 0);\n"
             "    const int lev1 = imin(lev_eff, 3);")
_NZ_PASS = ("ari_decode.cuh",
            "  int nz = 0;\n  for (int i = 0; i < N; ++i) nz += x[i] != 0 ? 1 : 0;",
            "  int nz = nz_in;")
_SEED = ("ari_decode.cuh", "  for (int i = 0; i < spec_inv; ++i)\n"
         "    seed += static_cast<unsigned>(iabs(x[i])) * static_cast<unsigned>(i);\n", "")
_STORES = ("ari_decode.cuh", "    x[2 * k] = ak;\n    x[2 * k + 1] = bk;\n"
           "    levs[k] = static_cast<uint8_t>(lev_eff);\n", "")
_TABLES = (("ari_decode.cu", "  acx_load_shared(smem, tabs, kDecTabWords);\n", ""),
           ("ari_decode.cu", "  tb.lookup = smem;\n  tb.cumf = smem + 4096;",
            "  tb.lookup = tabs;\n  tb.cumf = tabs + 4096;"))
_NO_DECODE = (("ari_decode.cuh", "  for (int f = 0; f < 2; ++f) {\n    if (!(f < num_tns",
               "  for (int f = 0; f < 0; ++f) {\n    if (!(f < num_tns"),
              ("ari_decode.cuh", "  for (int k = 0; k < N / 2; ++k) {\n"
               "    if (!(2 * k < lastnz && bfi == 0)) break;",
               "  for (int k = 0; k < 0; ++k) {\n    if (!(2 * k < lastnz && bfi == 0)) break;"))
_COPY_ONLY = (("ari_decode.cu", "  int32_t sd[9];",
               "  {\n    int cs = 0;\n    for (int i = 0; i < nbytes; ++i) cs += buf[i];\n"
               "    out[s] = cs;\n    return;\n  }\n  int32_t sd[9];"),)
_NZ = (_NZ_DECL, _NZ_COUNT, _NZ_PASS)
DECODE_PHASES = {
    "first design as it is": (),
    "tables through L1 (no staging a block)": _TABLES,
    "no zero fills of x, levs, res (the buffers hold the last launch's rows)": (_ZERO, _ZERO_RES),
    "the nonzero count in the tuple loop (no pass over x)": _NZ,
    "no seed pass over x (nf_seed differs)": (_SEED,),
    "no row traffic but the zero fills (nonzero count in the loop, no seed pass, no "
    "tuple stores)": _NZ + (_SEED, _STORES),
    "no row traffic (also no zero fills)": _NZ + (_SEED, _STORES, _ZERO, _ZERO_RES),
    "no row traffic, tables through L1 (the chain, the staging of the frame)":
        _NZ + (_SEED, _STORES, _ZERO, _ZERO_RES) + _TABLES,
    "no TNS and tuple loops (the staging, zero fills, passes, residual, scalars)": _NO_DECODE,
    "the tables' staging and the frame copy alone": _COPY_ONLY,
    "the frame copy alone (tables through L1)": _COPY_ONLY + _TABLES,
}


def build_decode(d: Path, csrc: Path, files, subs, bench: str | None = None) -> ctypes.CDLL:
    """nvcc builds csrc's `files` (with subs applied: (file, old, new)) in d,
    ari_decode.cu itself or, with `bench`, a source that includes it."""
    shutil.rmtree(d, ignore_errors=True)
    d.mkdir(parents=True)
    text = {f: (csrc / f).read_text() for f in files}
    for f, old, new in subs:
        if old not in text[f]:
            raise SystemExit(f"{d.name}: {old!r} is not in {csrc / f}")
        text[f] = text[f].replace(old, new)
    for f, t in text.items():
        (d / f).write_text(t)
    main = "ari_decode.cu"
    if bench is not None:
        (d / "bench.cu").write_text(bench)
        main = "bench.cu"
    r = subprocess.run([nvcc(), *NVCC_FLAGS, "-o", str(d / "lib.so"), str(d / main)],
                       capture_output=True, text=True)
    if r.returncode:
        raise SystemExit(f"nvcc failed on {d.name}:\n{r.stdout}{r.stderr}")
    return ctypes.CDLL(str(d / "lib.so"))


def decode_runs(B: int, T: int, runs, tag: str, sizes) -> None:
    """Each (name, call) of runs on the first n frames of the recorded block
    launch for n in sizes: call(inputs, outputs, ints, L, nbytes, stream)
    launches; two rounds of graph ms, the outputs checked against the plain
    version."""
    import torch
    sys.path.insert(0, str(ROOT))
    from audio_codec_torch import kernels as K
    from audio_codec_torch.ops import ari
    K.library()
    _, _, kernels, _ = record_launches(B, T)
    block = kernels["ari_decode"][-1][0]
    st = lambda: torch.cuda.current_stream().cuda_stream
    cases = []
    for n in sizes:
        n = block[1].shape[0] if n is None else n
        a = decode_slice(block, n)
        ins, outs, ints = decode_c_args(a)
        ref = {k: v for k, v in ari.decode_plain(*a).items()}
        cases.append((n, ins, outs, ints, ref))
    for rnd in range(2):
        for n, ins, outs, ints, ref in cases:
            L, nbytes = ins[0].shape
            for name, call in runs:
                for t in outs.values():
                    t.fill_(-1)
                rc = call(ins, outs, ints, L, nbytes, st())
                torch.cuda.synchronize()
                bad = decode_differing(outs, ref)
                ms = min(graph_ms(lambda: call(ins, outs, ints, L, nbytes, st())) for _ in range(3))
                print(f"[{tag}] {card()} | round {rnd}, {n} frames, {name}: rc {rc}, differing "
                      f"outputs {bad or 'none'}, graph {ms:.5f} ms", flush=True)


def build_all(jobs) -> list[ctypes.CDLL]:
    """build_decode over each job's arguments, all at once."""
    from concurrent.futures import ThreadPoolExecutor
    with ThreadPoolExecutor(max_workers=8) as ex:
        return list(ex.map(lambda a: build_decode(*a), jobs))


def decode_variants(B: int, T: int) -> None:
    P_, I_ = ctypes.c_void_p, ctypes.c_int
    designs = {**DECODE_VARIANTS,
               **{name: tuple(("ari_decode.cuh", o, n) for o, n in subs)
                  for name, subs in DECODE_CUTS.items()}}
    libs = build_all([(OUT / f"decode_variant{i}", CSRC, DECODE_FILES, (_NONE_ONLY, *subs))
                      for i, subs in enumerate(designs.values())])
    runs = []
    for name, lib in zip(designs, libs):
        lib.acx_ari_decode.argtypes = [P_] * 9 + [I_] * 14 + [P_]
        runs.append((name, lambda ins, o, ints, L, nb, st, lib=lib: lib.acx_ari_decode(
            ins[0].data_ptr(), ins[1].data_ptr(), None, ins[2].data_ptr(), o["x"].data_ptr(),
            o["tns_order"].data_ptr(), o["tns_idx"].data_ptr(), o["res_bits"].data_ptr(),
            o["out"].data_ptr(), L, nb, *ints, 0, 0, 0, st)))
    decode_runs(B, T, runs, "decode variants", (None, 2048, 4))


def decode_phases(B: int, T: int, other: Path) -> None:
    P_, I_ = ctypes.c_void_p, ctypes.c_int
    csrc = other.resolve() / "audio_codec_torch" / "csrc"
    runs = []
    libs = build_all([(OUT / f"decode_phase{i}", csrc, ("acodec.cuh", "ari_decode.cuh",
                                                         "ari_decode.cu"), subs)
                      for i, subs in enumerate(DECODE_PHASES.values())])
    for name, lib in zip(DECODE_PHASES, libs):
        lib.acx_ari_decode.argtypes = [P_] * 10 + [I_] * 14 + [P_]
        runs.append((name, lambda ins, o, ints, L, nb, st, lib=lib: lib.acx_ari_decode(
            ins[0].data_ptr(), ins[1].data_ptr(), None, ins[2].data_ptr(), o["x"].data_ptr(),
            o["tns_order"].data_ptr(), o["tns_idx"].data_ptr(), o["res_bits"].data_ptr(),
            o["levs"].data_ptr(), o["out"].data_ptr(), L, nb, *ints, 0, 0, 0, st)))
    decode_runs(B, T, runs, "decode phases", (None, 32))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--streams", type=int, default=2048)
    ap.add_argument("--frames", type=int, default=8)
    ap.add_argument("--other", type=Path, default=None)
    ap.add_argument("--step-bench", action="store_true")
    ap.add_argument("--scaling", action="store_true")
    ap.add_argument("--tables", action="store_true")
    ap.add_argument("--gain-variants", action="store_true")
    ap.add_argument("--decode-variants", action="store_true")
    ap.add_argument("--decode-phases", type=Path, default=None)
    ap.add_argument("--entropy-phases", type=Path, default=None)
    ap.add_argument("--entropy-variants", action="store_true")
    ap.add_argument("--clocks", action="store_true")
    ap.add_argument("--root", type=Path, default=None, help=argparse.SUPPRESS)
    opt = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("torch_coder_times: no CUDA device")
    if opt.entropy_phases:
        other = opt.entropy_phases.resolve()
        csrc = other / "audio_codec_torch" / "csrc"
        entropy_builds(other, opt.streams, [(f"first_{i}", label, csrc, subs) for i, (label, subs)
                                            in enumerate(Entropy.PHASES.items())])
        return 0
    if opt.entropy_variants or opt.clocks:
        import torch_subst_damp_times as SD
        if opt.entropy_variants:
            entropy_builds(ROOT, opt.streams, [(f"kept_{i}", label, CSRC, subs) for i, (label, subs)
                                               in enumerate(Entropy.VARIANTS.items())])
        if opt.clocks:
            SD.clocks(opt.streams, Entropy)
        return 0
    if (opt.step_bench or opt.scaling or opt.tables or opt.gain_variants
            or opt.decode_variants or opt.decode_phases):
        if opt.step_bench:
            step_bench()
            decode_step_bench()
        if opt.scaling:
            scaling(opt.streams, opt.frames)
        if opt.tables:
            tables(opt.streams, opt.frames)
        if opt.gain_variants:
            gain_variants(opt.streams, opt.frames)
        if opt.decode_variants:
            decode_variants(opt.streams, opt.frames)
        if opt.decode_phases:
            decode_phases(opt.streams, opt.frames, opt.decode_phases)
        return 0
    if opt.root is not None or opt.other is None:
        print(json.dumps(measure((opt.root or ROOT).resolve(), opt.streams, opt.frames)),
              flush=True)
        return 0
    rc = 0
    for root in (opt.other, ROOT, ROOT, opt.other):
        r = subprocess.run([sys.executable, __file__, "--streams", str(opt.streams), "--frames",
                            str(opt.frames), "--root", str(root.resolve())])
        rc = rc or r.returncode
    return rc


if __name__ == "__main__":
    sys.exit(main())
