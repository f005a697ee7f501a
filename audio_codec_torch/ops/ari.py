"""Batched 24-bit range coder (arithmetic codec) for the spectrum and the
TNS data: processAriEncoder_fl / processAriDecoder_fl (ari_codec.c).

`encode` and `decode` launch the CUDA kernels `ari_encode` and `ari_decode`
(csrc/ari_encode.cu, csrc/ari_decode.cu) for tensors on the card and run
the plain versions below for tensors on the CPU; `parse_and_decode`, the
decoder's entropy phase, parses each frame's side information in the same
launch of `ari_decode`. The plain versions are
the counterparts of `audio_codec_tpu/ops/ari.py:encode` and `:decode`:
every stream is one lane of [B]-vectorized coder state and the symbol
sequence is a loop over 2-tuples. Two differences in form, none in output:
the pending carry run of ac_shift_fl (ari_codec.c:593-609) is written
directly, as the C does, and the loops stop at the last level and tuple
that any lane needs. The decoder follows the reference's partial-concealment
hooks for frames that carry a PC block (`cfg.n_pc > 0`, EP3/EP4 in slots of
80 bytes or more).
"""
from __future__ import annotations

import torch

from .. import kernels
from .. import tables as T
from ..config import Config
from . import numerics as nm
from .quant import msb, residual_max_bits

I32 = torch.int32
I64 = torch.int64
MASK24 = (1 << 24) - 1


def _tab(name: str, device) -> torch.Tensor:
    """A range-coder table as int64 on `device`."""
    return nm.table(T.t, name, device=device, dtype=I64)


# ---------------------------------------------------------------------------
# encoder (plain version of the ari_encode kernel)
# ---------------------------------------------------------------------------

class _Enc:
    """[B]-vectorized encoder state (ac_enc_init_fl), int64 registers."""

    def __init__(self, buf, bp_side, mask_side):
        B, self.nbytes = buf.shape
        dev = buf.device
        full = lambda v: torch.full((B,), v, dtype=I64, device=dev)
        self.rows = torch.arange(B, device=dev)
        self.cols = torch.arange(self.nbytes, device=dev)[None, :]
        self.buf = buf.to(I64).clone()
        self.bp, self.low, self.range = full(0), full(0), full(MASK24)
        self.cache, self.carry, self.cc = full(-1), full(0), full(0)
        self.bp_side = bp_side.to(I64)
        self.mask_side = mask_side.to(I64)

    def _at(self, p):
        return p.clamp(0, self.nbytes - 1)

    def _put(self, p, val, do):
        at = self._at(p)
        cur = self.buf[self.rows, at]
        self.buf[self.rows, at] = torch.where(do, val, cur)

    def _run(self, start, count, val, do):
        """Write `count` bytes of `val` from `start` (ac_shift_fl's loop)."""
        lo = self._at(start)[:, None]
        hit = do[:, None] & (self.cols >= lo) & (self.cols < (start + count)[:, None])
        self.buf = torch.where(hit, val[:, None], self.buf)

    def shift(self, active):
        """ac_shift_fl (ari_codec.c:585-611) on the `active` lanes."""
        emit = active & ((self.low < 0xFF0000) | (self.carry == 1))
        do_cache = emit & (self.cache >= 0)
        self._put(self.bp, (self.cache + self.carry) & 255, do_cache)
        self.bp = self.bp + do_cache
        self._run(self.bp, self.cc, (self.carry + 255) & 255, emit & (self.cc > 0))
        self.bp = self.bp + torch.where(emit, self.cc, 0)
        self.cache = torch.where(emit, self.low >> 16, self.cache)
        self.carry = torch.where(emit, 0, self.carry)
        self.cc = torch.where(emit, 0, torch.where(active, self.cc + 1, self.cc))
        self.low = torch.where(active, (self.low << 8) & MASK24, self.low)

    def encode(self, sym_freq, cum_freq, active):
        """ac_encode_fl (ari_codec.c:565-583)."""
        r = self.range >> 10
        low = self.low + torch.where(active, r * cum_freq, 0)
        self.carry = torch.where(active & ((low >> 24) == 1), 1, self.carry)
        self.low = low & MASK24
        self.range = torch.where(active, r * sym_freq, self.range)
        for _ in range(2):
            need = active & (self.range < (1 << 16))
            self.range = torch.where(need, self.range << 8, self.range)
            self.shift(need)

    def write_side(self, bit, active):
        """write_bit_backward_fl on the `active` lanes."""
        m = self.mask_side
        new = torch.where(bit == 0, self.buf[self.rows, self._at(self.bp_side)] & (255 - m),
                          self.buf[self.rows, self._at(self.bp_side)] | m)
        self._put(self.bp_side, new, active)
        self.bp_side = self.bp_side - (active & (m == 128)).to(I64)
        self.mask_side = torch.where(active, torch.where(m == 128, 1, m * 2), m)

    def nbits(self):
        """Bits consumed by the range coder so far (ari_codec.c:812-824)."""
        nb = (self.bp + 1) * 8 + 25 - msb(self.range.clamp(min=1))
        return nb + torch.where(self.cache >= 0, 8, 0) + self.cc * 8

    def finalize(self):
        """ac_finalize_fl (ari_codec.c:641-697)."""
        bits = 24 - msb(self.range.clamp(min=1)).to(I64)
        mask = MASK24 >> bits
        val = self.low + mask
        over1 = val >> 24
        val = val & MASK24
        high = self.low + self.range
        over2 = high >> 24
        high = high & MASK24
        val = val & (MASK24 - mask)
        same = over1 == over2
        tight = same & (val + mask >= high)
        bits = torch.where(tight, bits + 1, bits)
        mask2 = torch.where(tight, mask >> 1, mask)
        val = torch.where(tight, ((self.low + mask2) & MASK24) & (MASK24 - mask2), val)
        self.carry = torch.where(same & (val < self.low), 1, self.carry)
        self.low = val

        n_shift = torch.where(bits > 8, torch.div(bits + 7, 8, rounding_mode="floor"), 1)
        for i in range(3):
            self.shift(i < n_shift)
        b = torch.where(bits > 8, bits - 8 * n_shift, bits)
        b = torch.where(b < 0, b + 8, b)

        has_cc = self.cc > 0
        self._put(self.bp, self.cache & 255, has_cc)
        self.bp = self.bp + has_cc
        run = (self.cc - 1).clamp(min=0)
        self._run(self.bp, run, torch.full_like(run, 255), has_cc & (run > 0))
        self.bp = self.bp + torch.where(has_cc, run, 0)

        wval = torch.where(has_cc, torch.where(b >= 8, 255 << (b.clamp(min=8) - 8), 0),
                           self.cache)
        out = self.buf[self.rows, self._at(self.bp)]
        m = 128
        for k in range(8):
            bit = wval & m
            out = torch.where(k < b, torch.where(bit == 0, out & (255 - m), out | m), out)
            m >>= 1
        self.buf[self.rows, self._at(self.bp)] = out


def tuple_context(cfg: Config, xq, lastnz_wire):
    """Per-tuple (t, nlev, sym) of the context model (quantize_spec.c:86-168)
    for the truncated spectrum: dict of [B, N/2] int64 tensors."""
    B, N = xq.shape
    a_all = torch.abs(xq[:, 0::2]).to(I64)
    b_all = torch.abs(xq[:, 1::2]).to(I64)
    m = torch.maximum(a_all, b_all)
    nlev = torch.where(m >= 4, (msb(m.clamp(min=1)) - 1).clamp(min=0), 0).to(I64)
    aa = a_all >> nlev
    bb = b_all >> nlev
    levm1 = nlev.clamp(max=3) - 1
    t_next = torch.where(levm1 <= 0, 1 + (aa + bb) * (levm1 + 2), 13 + levm1)
    c = torch.zeros((B,), dtype=I64, device=xq.device)
    ts = []
    for k in range(N // 2):
        ts.append(c + cfg.rateFlag + (256 if k > N // 4 else 0))
        c = torch.where(2 * k < lastnz_wire, (c & 15) * 16 + t_next[:, k], c)
    return dict(t=torch.stack(ts, dim=1), nlev=nlev, sym=aa + 4 * bb)


def encode_plain(cfg: Config, buf, bp_side, mask_side, xq, tns_order, tns_idx,
                 num_tns_filters, lastnz_wire, lsb_mode, res_bits, n_res):
    """Plain version of the `ari_encode` kernel (processAriEncoder_fl,
    ari_codec.c:726-866). Returns the finished byte buffer [B, nbytes] int32."""
    B, N = xq.shape
    dev = xq.device
    st = _Enc(buf, bp_side, mask_side)
    max_lev = 21 if cfg.hrmode else 14
    lastnz_wire = lastnz_wire.to(I64)
    lsb_mode = lsb_mode.to(I64)

    tns_freq_cf = _tab("tns_freq_cf", dev)      # [2, 9]
    tns_cf = _tab("tns_cf", dev)                # [8, 18]
    lpcw = 1 if cfg.enable_lpc_weighting else 0
    for f in range(2):
        order = tns_order[:, f].to(I64)
        act_f = (f < num_tns_filters) & (order > 0)
        o = order.clamp(1, 8)
        cf = tns_freq_cf[lpcw, o - 1]
        st.encode(tns_freq_cf[lpcw, o] - cf, cf, act_f)
        for j in range(8):
            idx = tns_idx[:, f, j].to(I64)
            cf = tns_cf[j, idx.clamp(0, 17)]
            st.encode(tns_cf[j, (idx + 1).clamp(0, 17)] - cf, cf, act_f & (j < order))

    ctx = tuple_context(cfg, xq, lastnz_wire)
    lookup = _tab("ari_spec_lookup_fl", dev)
    cumf = _tab("ari_spec_cumfreq_fl", dev)     # [64, 18]
    a_all = torch.abs(xq[:, 0::2]).to(I64)
    b_all = torch.abs(xq[:, 1::2]).to(I64)
    neg_a = (xq[:, 0::2] < 0).to(I64)
    neg_b = (xq[:, 1::2] < 0).to(I64)
    lsb_store = torch.zeros((B, N), dtype=I64, device=dev)
    lsb_count = torch.zeros((B,), dtype=I64, device=dev)
    rows = torch.arange(B, device=dev)
    save = lsb_mode == 1

    def push(val, do):
        nonlocal lsb_store, lsb_count
        at = lsb_count.clamp(0, N - 1)
        lsb_store[rows, at] = torch.where(do, val, lsb_store[rows, at])
        lsb_count = lsb_count + do

    n_tup = min(N // 2, int((lastnz_wire.max() + 1) // 2)) if B else 0
    for k in range(n_tup):
        in_range = (2 * k) < lastnz_wire
        a, b = a_all[:, k], b_all[:, k]
        t, nlev, sym = ctx["t"][:, k], ctx["nlev"][:, k], ctx["sym"][:, k]
        lsb1 = torch.zeros_like(a)
        lsb2 = torch.zeros_like(a)
        n_lev = min(max_lev, int(torch.where(in_range, nlev, 0).max()))
        for lev in range(n_lev):
            act = in_range & (lev < nlev)
            pki = lookup[(t + min(lev, 3) * 1024).clamp(0, 4095)]
            cf = cumf[pki, 16]
            st.encode(cumf[pki, 17] - cf, cf, act)
            bit1 = (a >> lev) & 1
            bit2 = (b >> lev) & 1
            if lev == 0:
                lsb1 = torch.where(act, bit1, lsb1)
                lsb2 = torch.where(act, bit2, lsb2)
                wr = act & ~save
            else:
                wr = act
            st.write_side(bit1, wr)
            st.write_side(bit2, wr)
        pki = lookup[(t + nlev.clamp(max=3) * 1024).clamp(0, 4095)]
        s = sym.clamp(0, 16)
        cf = cumf[pki, s]
        st.encode(cumf[pki, s + 1] - cf, cf, in_range)

        collect = in_range & save & (nlev > 0)
        a1, b1 = a >> 1, b >> 1
        push(lsb1, collect)
        push(neg_a[:, k], collect & (a1 == 0) & (a != 0))
        push(lsb2, collect)
        push(neg_b[:, k], collect & (b1 == 0) & (b != 0))
        shifted = save & (nlev > 0)
        st.write_side(neg_a[:, k], in_range & (torch.where(shifted, a1, a) != 0))
        st.write_side(neg_b[:, k], in_range & (torch.where(shifted, b1, b) != 0))

    # residual / LSB bits (ari_codec.c:826-860)
    total_bits = cfg.targetBitsAri
    log2_mask = msb(st.mask_side.clamp(min=1))
    nbits_side = total_bits - (8 * (st.bp_side + 1) + 8 - log2_mask)
    nbits_res = (total_bits - (nbits_side + st.nbits())).clamp(min=0)
    n_fill = torch.where(lsb_mode == 0, torch.minimum(nbits_res, n_res.to(I64)),
                         torch.minimum(nbits_res, lsb_count))
    width = max(res_bits.shape[1], N)
    res_p = torch.nn.functional.pad(res_bits.to(I64), (0, width - res_bits.shape[1]))
    lsb_p = torch.nn.functional.pad(lsb_store, (0, width - N))
    fill_bits = torch.where((lsb_mode == 0)[:, None], res_p, lsb_p)
    n_fill_max = min(width, total_bits, int(n_fill.max()) if B else 0)
    for k in range(n_fill_max):
        st.write_side(fill_bits[:, k], k < n_fill)
    st.finalize()
    return st.buf.to(I32)


def encode(cfg: Config, buf, bp_side, mask_side, xq, tns_order, tns_idx,
           num_tns_filters, lastnz_wire, lsb_mode, res_bits, n_res):
    """Arithmetic encoder body + residual fill + finalize. buf: [B, nbytes]
    int32 with the side info packed; returns the finished buffer (int32)."""
    args = (cfg, buf, bp_side, mask_side, xq, tns_order, tns_idx,
            num_tns_filters, lastnz_wire, lsb_mode, res_bits, n_res)
    if xq.device.type == "cpu":
        return encode_plain(*args)
    return kernels.ari_encode(*args)


# ---------------------------------------------------------------------------
# decoder (plain version of the ari_decode kernel)
# ---------------------------------------------------------------------------

class _Dec:
    """[B]-vectorized decoder state (ac_dec_init_fl), int64 registers, with
    the partial-concealment pointer state (Pc_State_fx, ari_codec.c:18-33)
    when the frame carries a PC block: `pc` is None or dict(pc_bytes,
    numbytes, L_spec, enc)."""

    def __init__(self, buf, bp_side, mask_side, pc=None, be_l=None, be_r=None, bfi2=None):
        B, self.nbytes = buf.shape
        dev = buf.device
        full = lambda v: torch.full((B,), v, dtype=I64, device=dev)
        self.rows = torch.arange(B, device=dev)
        self.buf = buf.to(I64)
        self.pc = pc
        self.range = full(MASK24)
        self.ber = full(0)
        self.bp_side = bp_side.to(I64)
        self.mask_side = mask_side.to(I64)
        self.b_left = full(0)
        self.inv_bin = full(0)   # read only with a PC block
        self.stop = torch.zeros((B,), dtype=torch.bool, device=dev)
        if pc is None:
            low = full(0)
            for i in range(3):
                low = (low << 8) + self.buf[:, i]
            self.low, self.bp = low, full(3)
            return
        # with a PC block the forward pointer starts past it (ari_codec.c:490-495);
        # the encoder's simulation reads the logical stream from 0
        self.pcb = pc["pc_bytes"]
        self.bp, self.low = full(0 if pc["enc"] else self.pcb), full(0)
        self.b_left, self.b_right = full(pc["numbytes"] + 1), full(-1)
        self.c_bp = torch.zeros((B,), dtype=torch.bool, device=dev)
        self.c_bp_side = self.c_bp.clone()
        self.inv_bin = full(pc["L_spec"] + 1)
        self.be_l = full(-1) if be_l is None else be_l.to(I64) >> 3
        self.be_r = full(-1) if be_r is None else be_r.to(I64) >> 3
        self.bfi2 = self.c_bp.clone() if bfi2 is None else bfi2
        for _ in range(3):
            self.stop = self.stop | self.pc_check(0, ~self.stop, from_left=True)
            ok = ~self.stop
            self.low = torch.where(ok, (self.low << 8) + self.byte(self.bp), self.low)
            self.bp = self.bp + ok

    def byte(self, p):
        return self.buf[self.rows, p.clamp(0, self.nbytes - 1)]

    def pc_check(self, cur_bin, active, from_left: bool):
        """check_pc_bytes (ari_codec.c:1824-1921) before a forward byte read
        (from_left) or a fresh backward byte. Returns the lanes that must not
        read: in the encoder's simulation those whose pointers converged, in
        the decoder those entering the corrupt byte range of a bfi 2 frame."""
        pcb, enc = self.pcb, self.pc["enc"]
        fresh = self.mask_side == 1
        act = active if from_left else active & fresh
        bp_local = self.bp if from_left else self.bp - 1
        bp_side_local = self.bp_side + fresh if from_left else self.bp_side
        conv = act & (self.b_right < 0) & (bp_side_local + (-1 if enc else pcb - 1) - bp_local
                                           == pcb)
        self.b_left = torch.where(conv, bp_local + 1, self.b_left)
        self.b_right = torch.where(conv, bp_side_local - 1, self.b_right)
        if enc:
            return conv
        have = act & (self.b_right >= 0)
        if from_left:
            jump = have & (self.bp == self.b_left)
            self.bp = torch.where(jump, 0, self.bp)
            self.c_bp = self.c_bp | jump
        else:
            jump = have & (bp_side_local == self.b_right)
            self.bp_side = torch.where(jump, pcb - 1, self.bp_side)
            self.c_bp_side = self.c_bp_side | jump
        in2 = act & self.bfi2
        trig = in2 & ((self.c_bp & (self.bp >= self.be_l))
                      | (self.c_bp_side & (self.bp_side <= self.be_r)))
        soft = in2 & ~trig & (self.c_bp | (self.c_bp_side & (self.bp_side <= pcb - 1)))
        self.inv_bin = torch.where(trig, cur_bin, torch.where(
            soft, torch.clamp(self.inv_bin, max=cur_bin), self.inv_bin))
        return trig

    def decode(self, cum_freq_rows, num_sym: int, active, cur_bin=0):
        """ac_decode_fl (ari_codec.c:115-146) with the PC hook before each
        renormalisation byte (ac_dec_update_fx, ari_codec.c:1782-1802).
        cum_freq_rows: [B, num_sym+1]. Returns (symbol, stopped lanes)."""
        tmp = self.range >> 10
        self.ber = torch.where(active & (self.low >= (tmp << 10)), 1, self.ber)
        below = tmp[:, None] * cum_freq_rows[:, :num_sym] <= self.low[:, None]
        val = (below.sum(dim=1) - 1).clamp(0, num_sym - 1)
        cf = torch.gather(cum_freq_rows, 1, val[:, None])[:, 0]
        sf = torch.gather(cum_freq_rows, 1, val[:, None] + 1)[:, 0] - cf
        low = torch.where(active, self.low - tmp * cf, self.low)
        rng = torch.where(active, tmp * sf, self.range)
        stop = torch.zeros_like(active)
        for _ in range(2):
            need = active & (rng < (1 << 16)) & ~stop
            if self.pc is not None:
                trig = self.pc_check(cur_bin, need, from_left=True)
                stop = stop | trig
                need = need & ~trig
            low = torch.where(need, ((low << 8) & MASK24) + self.byte(self.bp), low)
            self.bp = self.bp + need
            rng = torch.where(need, rng << 8, rng)
        self.low, self.range = low, rng
        return val, stop

    def read_side(self, act, cur_bin=0):
        """One backward bit read with the PC hook. Returns (bit, the lanes
        that read, the lanes the hook stopped)."""
        trig = torch.zeros_like(act)
        if self.pc is not None:
            trig = self.pc_check(cur_bin, act, from_left=False)
            act = act & ~trig
        bit = ((self.byte(self.bp_side) & self.mask_side) != 0).to(I64)
        m = self.mask_side
        self.bp_side = torch.where(act & (m == 128), self.bp_side - 1, self.bp_side)
        self.mask_side = torch.where(act, torch.where(m == 128, 1, m * 2), m)
        return bit, act, trig


DECODE_FIELDS = ("x", "tns_order", "tns_idx", "nf_seed", "zero_frame", "res_bits",
                 "n_res", "residual_present", "bfi", "spec_inv_idx", "b_left")


def pc_params(cfg: Config, pc_enc_sim: bool = False):
    """The partial-concealment block of a frame (None without one)."""
    if cfg.n_pc == 0 and not pc_enc_sim:
        return None
    if cfg.n_pc == 0:
        raise ValueError("pc_enc_sim needs a configuration with a PC block (n_pc > 0)")
    return dict(pc_bytes=(cfg.n_pc + 1) >> 1, numbytes=cfg.targetBytes, L_spec=cfg.yLen,
                enc=pc_enc_sim)


def decode_plain(cfg: Config, buf, side, bfi_in=None, be_bp_left=None, be_bp_right=None,
                 pc_enc_sim: bool = False):
    """Plain version of the `ari_decode` kernel: processAriDecoder_fl
    (ari_codec.c) with the partial-concealment hooks of a frame that carries
    a PC block (cfg.n_pc > 0): both pointers jump into the relocated block at
    their convergence point, a bfi_in 2 frame stops where it enters the
    corrupt bytes [be_bp_left, be_bp_right] (bits) and becomes bfi 2 with
    spec_inv_idx, and pc_enc_sim runs the encoder's simulation that finds
    b_left, the convergence byte (enc_lc3.c:245-259).

    buf: [L, nbytes] int32; side: dict from bits.parse_side_info. Returns the
    dict of `audio_codec_tpu.ops.ari.decode` (DECODE_FIELDS), int32."""
    L, nbytes = buf.shape
    dev = buf.device
    N = cfg.yLen
    lastnz = side["lastnz"].to(I64)
    lsb_mode = side["lsb_mode"].to(I64)
    pc = pc_params(cfg, pc_enc_sim)
    dec_pc = pc is not None and not pc_enc_sim
    bfi2 = None if bfi_in is None else (bfi_in == 2)
    st = _Dec(buf, side["bp_side"], side["mask_side"], pc, be_bp_left, be_bp_right, bfi2)
    bfi = st.stop.to(I64)
    max_lev = 22 if cfg.hrmode else 14
    z = lambda *s: torch.zeros((L, *s), dtype=I64, device=dev)

    def side_read(act, cur_bin, bfi):
        bit, act, trig = st.read_side(act, cur_bin)
        return bit, act, torch.where(trig, 1, bfi)

    tns_max = 8 if cfg.frame_dms == 100 else 4
    order_cf = _tab("ari_tns_order_cf", dev)     # [2, 9]
    coef_cf = _tab("ari_tns_freq_cf", dev)       # [8, 18]
    lpcw = 1 if cfg.enable_lpc_weighting else 0
    tns_order = z(2)
    tns_idx = z(2, 8)
    for f in range(2):
        act_f = (f < side["num_tns"]) & (side["tns_on"][:, f] > 0) & (bfi == 0)
        val, stp = st.decode(order_cf[lpcw][None, :].expand(L, 9), 8, act_f)
        bfi = torch.where(stp, 1, bfi)
        order = val + 1
        bfi = torch.where(act_f & (order > tns_max), 1, bfi)
        tns_order[:, f] = torch.where(act_f, order, 0)
        for k in range(8):
            act_k = act_f & (k < order) & (bfi == 0)
            bfi = bfi | (act_k & (st.bp_side < st.bp)).to(I64)
            v, stp = st.decode(coef_cf[k][None, :].expand(L, 18), 17, act_k)
            bfi = torch.where(stp, 1, bfi)
            tns_idx[:, f, k] = torch.where(act_k, v, 0)
    bfi = bfi | st.ber

    lookup = _tab("ari_spec_lookup_fl", dev)
    cumf = _tab("ari_spec_cumfreq_fl", dev)
    rate_flag = cfg.rateFlag if cfg.fs_idx != 5 else 0
    c = z()
    aks, bks, levs = z(N // 2), z(N // 2), z(N // 2)
    n_tup = min(N // 2, int((lastnz.max() + 1) // 2)) if L else 0
    for k in range(n_tup):
        in_range = ((2 * k) < lastnz) & (bfi == 0)
        t = c + rate_flag + (256 if k > N // 4 else 0)
        ak, bk, lev_fin, sym_fin = z(), z(), z(), z()
        done = torch.zeros((L,), dtype=torch.bool, device=dev)
        for lev in range(max_lev):
            act = in_range & ~done & (bfi == 0)
            if not bool(act.any()):
                break
            pki = lookup[(t + min(lev, 3) * 1024).clamp(0, 4095)]
            sym, stp = st.decode(cumf[pki], 17, act, 2 * k)
            bfi = torch.where(stp, 1, bfi)
            act = act & (bfi == 0)
            is_esc = sym >= 16
            rd = act & is_esc & ((lsb_mode == 0) | (lev > 0))
            bit1, rd, bfi = side_read(rd, 2 * k, bfi)
            ak = torch.where(rd, ak + (bit1 << lev), ak)
            bit2, rd, bfi = side_read(rd, 2 * k, bfi)
            bk = torch.where(rd, bk + (bit2 << lev), bk)
            hit = act & ~is_esc
            lev_fin = torch.where(hit, lev, lev_fin)
            sym_fin = torch.where(hit, sym, sym_fin)
            done = done | hit
            lev_fin = torch.where(act & is_esc, lev + 1, lev_fin)
        if not cfg.hrmode:
            bfi = torch.where(in_range & ~done & (lev_fin - 1 == 13), 1, bfi)
            lev_eff = lev_fin.clamp(max=13)
        else:
            lev_eff = lev_fin
        a_fin = sym_fin & 3
        b_fin = sym_fin >> 2
        ak = ak + torch.where(in_range, a_fin << lev_eff, 0)
        bk = bk + torch.where(in_range, b_fin << lev_eff, 0)
        bit, rd, bfi = side_read(in_range & (ak > 0) & (bfi == 0), 2 * k, bfi)
        ak = torch.where(rd & (bit == 1), -ak, ak)
        bit, rd, bfi = side_read(in_range & (bk > 0) & (bfi == 0), 2 * k + 1, bfi)
        bk = torch.where(rd & (bit == 1), -bk, bk)
        aks[:, k] = torch.where(in_range, ak, 0)
        bks[:, k] = torch.where(in_range, bk, 0)
        levs[:, k] = torch.where(in_range, lev_eff, 0)
        lev1 = lev_eff.clamp(max=3)
        t_next = torch.where(lev1 <= 1, 1 + (a_fin + b_fin) * (lev1 + 1), 12 + lev1)
        c = torch.where(in_range, (c & 15) * 16 + t_next, c)
        # with a PC block the pointers are compared only while both are on
        # the same side of it (ari_codec.c:750)
        crossed = (st.bp - st.bp_side) > 3
        if pc is not None:
            crossed = crossed & (st.c_bp == st.c_bp_side)
        bfi = torch.where(in_range & crossed, 1, bfi)
        bfi = bfi | st.ber
    x = torch.stack([aks, bks], dim=-1).reshape(L, -1)
    if N % 2:
        x = torch.nn.functional.pad(x, (0, 1))

    # residual bits (ari_codec.c:965-1000; with a PC block the consumed bits
    # count the block once, ari_codec.c:965-981, but not in the encoder's
    # simulation, which reads the logical stream)
    total_bits = cfg.targetBytes * 8
    log2_mask = msb(st.mask_side.clamp(min=1))
    msb_r = msb(st.range.clamp(min=1))
    if dec_pc:
        consumed = torch.where(st.c_bp, st.bp + st.b_left - st.pcb, st.bp - st.pcb)
        nbits_ari = (consumed + 1 - 3) * 8 + 25 - msb_r
        nbits_side = total_bits - 16 + log2_mask - 8 * torch.where(
            st.c_bp_side, st.b_left - st.pcb + st.bp_side, st.bp_side)
    else:
        nbits_side = total_bits - (8 * (st.bp_side + 1) + 8 - log2_mask)
        nbits_ari = (st.bp + 1 - 3) * 8 + 25 - msb_r
    nbits_residual = total_bits - (nbits_side + nbits_ari)
    bfi = torch.where((bfi == 0) & (nbits_residual < 0), 1, bfi)
    nbits_residual = nbits_residual.clamp(min=0)

    nz_count = (x != 0).sum(dim=1) * (20 if cfg.hrmode else 1)
    n_res0 = torch.minimum(nbits_residual, nz_count)
    max_res = min(residual_max_bits(cfg), total_bits)
    res_bits = z(max_res)
    # a residual-phase read that enters the corrupt bytes ends the residual
    # (ber_detect_res): res_dead
    res_dead = torch.zeros((L,), dtype=torch.bool, device=dev)
    read_res = (lsb_mode == 0) & (bfi == 0)
    n_read = int(torch.where(read_res, n_res0, 0).max()) if L else 0
    for k in range(min(max_res, n_read)):
        bit, act, trig = st.read_side(read_res & (k < n_res0) & ~res_dead, st.inv_bin)
        res_dead = res_dead | trig
        res_bits[:, k] = torch.where(act, bit, 0)

    # lsb_mode == 1: LSB refinement (ari_codec.c:476-556)
    do_lsb = (lsb_mode == 1) & (bfi == 0)
    if bool(do_lsb.any()):
        budget = nbits_residual.clone()
        for k in range(N // 2):
            has = do_lsb & (levs[:, k] > 0) & ((2 * k) < lastnz)
            for j in (2 * k, 2 * k + 1):
                xv = x[:, j]
                bit, act, trig = st.read_side(has & (budget > 0) & ~res_dead, st.inv_bin)
                res_dead = res_dead | trig
                budget = budget - act.to(I64)
                upd = torch.where(xv > 0, xv + 1, torch.where(xv < 0, xv - 1, xv))
                xv2 = torch.where(act & (bit == 1) & (xv != 0), upd, xv)
                bit2, act2, trig = st.read_side(
                    act & (bit == 1) & (xv == 0) & (budget > 0) & ~res_dead, st.inv_bin)
                res_dead = res_dead | trig
                budget = budget - act2.to(I64)
                x[:, j] = torch.where(act2, torch.where(bit2 == 0, 1, -1), xv2)

    n_res = torch.where(lsb_mode == 0, n_res0, 0)
    spec_inv_idx = torch.full((L,), N, dtype=I64, device=dev)
    if dec_pc:
        # ber_detect: an abort with a valid inv_bin is a partial loss
        # (bfi 2 with spec_inv_idx, ari_codec.c:1164-1187)
        to2 = (bfi == 1) & (st.inv_bin > 0) & (st.inv_bin <= N)
        spec_inv_idx = torch.where(to2, st.inv_bin, spec_inv_idx)
        bfi = torch.where(to2, 2, bfi)
    kidx = torch.arange(N, dtype=I64, device=dev)[None, :]
    nf_seed = torch.sum(torch.where(kidx < spec_inv_idx[:, None], torch.abs(x) * kidx, 0),
                        dim=1) & 65535
    nf_seed = torch.where(nf_seed >= 32768, nf_seed - 65536, nf_seed)
    zero_frame = ((lastnz == 2) & (x[:, 0] == 0) & (x[:, 1] == 0)
                  & (side["gg_idx"] == 0) & (side["fac_ns_idx"] == 7))
    bfi = torch.where((bfi == 0) & (st.ber > 0), 1, bfi)
    if dec_pc:
        dead2 = (bfi == 2) | res_dead
        zero_frame = zero_frame & ~dead2
        n_res = torch.where(dead2, 0, n_res)
    b_left = st.b_left
    if pc_enc_sim:
        # the never-converged fallback (ari_codec.c:1135-1143)
        b_left = torch.where(st.b_left > cfg.targetBytes, st.bp_side - st.pcb, st.b_left)
    out = dict(x=x, tns_order=tns_order, tns_idx=tns_idx, nf_seed=nf_seed,
               zero_frame=zero_frame, res_bits=res_bits, n_res=n_res,
               residual_present=lsb_mode == 0, bfi=bfi, spec_inv_idx=spec_inv_idx,
               b_left=b_left)
    return {k: v.to(I32) for k, v in out.items()}


def decode(cfg: Config, buf, side, bfi_in=None, be_bp_left=None,
           be_bp_right=None, pc_enc_sim: bool = False):
    """processAriDecoder: spectrum, TNS coefficients and residual bits, with
    the partial-concealment hooks where the frame carries a PC block
    (cfg.n_pc > 0): bfi_in (0/1/2) and the corrupt bit range [be_bp_left,
    be_bp_right] of a bfi 2 frame enter the decode there, and pc_enc_sim
    returns the encoder's convergence byte b_left. See decode_plain."""
    if buf.device.type == "cpu":
        return decode_plain(cfg, buf, side, bfi_in, be_bp_left, be_bp_right, pc_enc_sim)
    return kernels.ari_decode(cfg, buf, side, bfi_in, be_bp_left, be_bp_right, pc_enc_sim)


def parse_and_decode_plain(cfg: Config, buf, bfi_in=None, be_bp_left=None, be_bp_right=None,
                           pc_enc_sim: bool = False):
    """Plain version of the `ari_decode` kernel's parsed mode: the frames'
    side information (bits.parse_side_info_plain), then decode_plain on it.
    Returns (side, dec)."""
    from .bits import parse_side_info_plain
    side = parse_side_info_plain(cfg, buf)
    return side, decode_plain(cfg, buf, side, bfi_in, be_bp_left, be_bp_right, pc_enc_sim)


def parse_and_decode(cfg: Config, buf, bfi_in=None, be_bp_left=None, be_bp_right=None,
                     pc_enc_sim: bool = False):
    """The decoder's entropy phase over frames [L, nbytes]: each frame's side
    information (processDecoderEntropy), then its range decode (decode) on
    it, as `audio_codec_tpu`'s bits.parse_side_info followed by ari.decode.
    One launch of the `ari_decode` kernel, parsed mode, for a tensor on a card
    (kernels.ari_decode_frames; the PC inputs as the caller holds them),
    parse_and_decode_plain on the CPU. Returns (side, dec)."""
    if buf.device.type == "cpu":
        return parse_and_decode_plain(cfg, buf, bfi_in, be_bp_left, be_bp_right, pc_enc_sim)
    return kernels.ari_decode_frames(cfg, buf, bfi_in, be_bp_left, be_bp_right, pc_enc_sim)
