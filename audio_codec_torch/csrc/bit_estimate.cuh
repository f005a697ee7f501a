// The context-model bit count of a quantized spectrum (bit_estimate.cu, K8),
// a warp a stream.
//
// The plain version is ops/quant.py:bit_estimate_plain (processQuantizeSpec_fl,
// quantize_spec.c:78-168): a loop over the 2-tuples k = 0 .. n_act-1 that
// carries a context c, c <- (c & 15) * 16 + tn[k], where tn[k] depends on
// tuple k alone (its escape count nlev and its two magnitudes aa, bb).
//
// The context is a window, not a chain. As (16 x + y) & 15 = y & 15 for every
// integer x, the context at tuple k >= 2 is
//     c[k] = 16 (tn[k-2] & 15) + tn[k-1],
// with c[0] = 0 and c[1] = tn[0] (tuple_context with tn[-1] = tn[-2] = 0;
// the tuples before k lie inside n_act where k does). So a tuple's lookups and
// bit count depend on the tuple and its two predecessors only. The count is
// the sum of the tuples' counts; a sum of int32 values modulo 2^32 does not
// depend on the order of its terms, so a warp scan gives every running count
// of the sequential loop, wrapping included (the sums are kept unsigned).
//
// The warp: lane l owns the contiguous run of R = ceil(N/64) tuples from
// l * R (7 at N = 400). It computes its tuples' tn, takes the two tn before
// its run from the lanes before it (a shuffle), and walks its run with the
// sequential recurrence from there. lastnz is a warp maximum of each lane's
// last nonzero tuple k >= 1. lastnz2 (mode >= 0) is the LAST tuple k < n_act
// that is nonzero and whose running count is at most target * 2048 (the
// sequential loop overwrites it at every such tuple): each lane's last such
// tuple, then a warp maximum; nbits2 is its running count, shuffled from the
// lane that owns it.
//
// The steps are templates over the warp that runs them (warp.cuh): on the card
// CoderCardWarp (a thread a lane, a Lanes<T> a register, the collectives
// __shfl_up_sync, __shfl_sync and __reduce_max_sync), on the host
// CoderHostWarp (one thread running the 32 lanes of each step in turn, a
// Lanes<T> an array of 32, every collective reading all lanes before it
// writes any), which is how tests/test_torch_coder_rehearsal.py compiles
// them with g++ and holds them to the plain version.
#pragma once

#include "acodec.cuh"
#include "warp.cuh"

namespace acx {

constexpr int kBitEstMaxRun = 16;   // tuples a lane: N <= 32 * 2 * 16 = 1024

// Inclusive warp sum of x (Hillis-Steele, 5 shuffles), modulo 2^32.
template <class W>
ACX_HD typename W::template Lanes<unsigned> warp_scan_incl(const W& w,
                                                           typename W::template Lanes<unsigned> x) {
  for (int d = 1; d < kCoderLanes; d *= 2) {
    const auto y = w.shfl_up(x, d);
    w.lanes([&](int l) {
      if (l >= d) x[l] += y[l];
    });
  }
  return x;
}

// the context of a tuple from the tn of the two tuples before it
ACX_HD int tuple_context(int tn_prev2, int tn_prev1) { return (tn_prev2 & 15) * 16 + tn_prev1; }

// tn (quantize_spec.c:160-166) from the escape count and the magnitudes
// after the escapes
ACX_HD int tuple_tn(int nlev, int aa, int bb) {
  const int levm1 = imin(nlev, 3) - 1;
  return levm1 <= 0 ? 1 + (aa + bb) * (levm1 + 2) : 13 + levm1;
}

ACX_HD int escape_count(int a, int b) {
  const int m = imax(a, b);
  return m >= 4 ? imax(msb32(m) - 1, 0) : 0;
}

// a lane's tuple bits, indexed only by unrolled loops
struct BeRun {
  unsigned nb[kBitEstMaxRun];
};

// A tuple of bit_estimate: magnitudes, escape levels (nlev; nl of them coded),
// the magnitudes after them, and its tn.
struct BeTuple {
  int a, b, nlev, nl, aa, bb, tn;
};

ACX_HD BeTuple be_tuple(const int32_t* xq, int k, int max_lev) {
  BeTuple q;
  q.a = iabs(xq[2 * k]);
  q.b = iabs(xq[2 * k + 1]);
  q.nlev = escape_count(q.a, q.b);
  q.nl = imin(q.nlev, max_lev);
  q.aa = q.a >> q.nl;
  q.bb = q.b >> q.nl;
  q.tn = tuple_tn(q.nlev, q.aa, q.bb);
  return q;
}

// The bits (in 1/2048) of tuple q at context offset t (c + rateFlag + the
// upper half's 256), and its LSB bits in lsb (quantize_spec.c:100-158). The
// escape levels from 3 on share the level-3 row.
ACX_HD int be_tuple_bits(const BeTuple& q, int t, int mode, const int32_t* lookup,
                         const int32_t* bits_tab, int& lsb) {
  unsigned nb = mode <= 0 ? static_cast<unsigned>((imin(q.a, 1) + imin(q.b, 1)) * 2048) : 0u;
  lsb = 0;
  for (int lev = 0; lev < q.nl && lev < 3; ++lev) {
    nb += bits_tab[lookup[iclamp(t + lev * 1024, 0, 4095)] * 17 + 16];
    if (lev == 0 && mode > 0) lsb += 2;
    else nb += 2 * 2048;
  }
  if (q.nl > 3) {
    const unsigned esc = bits_tab[lookup[iclamp(t + 3 * 1024, 0, 4095)] * 17 + 16];
    nb += static_cast<unsigned>(q.nl - 3) * (esc + 2 * 2048);
  }
  nb += bits_tab[lookup[iclamp(t + imin(q.nlev, 3) * 1024, 0, 4095)] * 17 +
                 iclamp(q.aa + 4 * q.bb, 0, 16)];
  const int a1 = q.nlev > 0 ? q.a >> 1 : q.a;
  const int b1 = q.nlev > 0 ? q.b >> 1 : q.b;
  if (q.nlev > 0 && a1 == 0 && q.a != 0) lsb += 1;
  if (q.nlev > 0 && b1 == 0 && q.b != 0) lsb += 1;
  if (mode > 0) nb += static_cast<unsigned>((imin(a1, 1) + imin(b1, 1)) * 2048);
  return static_cast<int>(nb);
}

// One stream on a warp. xq: its N coefficients (N <= 1024); out[j * stride]
// the j-th output (nbits, nbits2, lastnz, lastnz2, lsbMode), written by lane 0.
template <class W>
ACX_HD void bit_estimate_warp(const W& w, const int32_t* xq, int N, int target, int mode,
                              int rate_flag, int max_lev, const int32_t* lookup,
                              const int32_t* bits_tab, int32_t* out, int stride) {
  using IL = typename W::template Lanes<int>;
  using UL = typename W::template Lanes<unsigned>;
  const int NT = N / 2;
  const int R = (NT + kCoderLanes - 1) / kCoderLanes;

  // tn of each lane's last two tuples, and its last nonzero tuple k >= 1
  IL tn1, tn2, last_nz;
  w.lanes([&](int l) {
    const int k0 = l * R, k1 = imin(k0 + R, NT);
    int t1 = 0, t2 = 0, lnz = 0;
    for (int k = k0; k < k1; ++k) {
      const BeTuple q = be_tuple(xq, k, max_lev);
      t2 = t1;
      t1 = q.tn;
      if (k >= 1 && (q.a != 0 || q.b != 0)) lnz = k;
    }
    tn1[l] = t1;
    tn2[l] = t2;
    last_nz[l] = lnz;
  });
  const int last_tup = w.reduce_max(last_nz);
  const int lastnz = 2 * last_tup + 1;
  const int n_act = last_tup + 1;
  // tn[k0 - 1] and tn[k0 - 2]: the lane before holds both where R >= 2
  const IL p1 = w.shfl_up(tn1, 1);
  const IL p2 = R >= 2 ? w.shfl_up(tn2, 1) : w.shfl_up(tn1, 2);

  // each tuple's bits; the lane's sums
  UL sum, lsb_sum;
  IL nz_mask;
  typename W::template Lanes<BeRun> nbv;
  w.lanes([&](int l) {
    const int k0 = l * R;
    int c = tuple_context(l >= 2 || (l == 1 && R >= 2) ? p2[l] : 0, l >= 1 ? p1[l] : 0);
    unsigned s = 0u, ls = 0u;
    int nzm = 0;
#pragma unroll
    for (int i = 0; i < kBitEstMaxRun; ++i) {
      const int k = k0 + i;
      nbv[l].nb[i] = 0u;
      if (i < R && k < n_act) {
        const BeTuple q = be_tuple(xq, k, max_lev);
        const int t = c + rate_flag + (k > N / 4 ? 256 : 0);
        int lsb;
        nbv[l].nb[i] = static_cast<unsigned>(be_tuple_bits(q, t, mode, lookup, bits_tab, lsb));
        s += nbv[l].nb[i];
        ls += static_cast<unsigned>(lsb);
        if (q.a != 0 || q.b != 0) nzm |= 1 << i;
        c = (c & 15) * 16 + q.tn;
      }
    }
    sum[l] = s;
    lsb_sum[l] = ls;
    nz_mask[l] = nzm;
  });
  // the running count at every tuple: the lanes before, then the lane's own
  const UL upto = warp_scan_incl(w, sum);
  const int nbits = static_cast<int>(w.shfl(upto, kCoderLanes - 1));
  const int nbits_lsb = static_cast<int>(w.reduce_add(lsb_sum));

  int lastnz2 = 2, nbits2 = 0;
  if (mode >= 0) {
    const int limit = target * 2048;
    IL hit;
    UL run_at;
    w.lanes([&](int l) {
      unsigned run = upto[l] - sum[l];
      int last = -1;
      unsigned at = 0u;
#pragma unroll
      for (int i = 0; i < kBitEstMaxRun; ++i) {
        run += nbv[l].nb[i];
        if (((nz_mask[l] >> i) & 1) != 0 && static_cast<int>(run) <= limit) {
          last = l * R + i;
          at = run;
        }
      }
      hit[l] = last;
      run_at[l] = at;
    });
    const int k2 = w.reduce_max(hit);
    if (k2 >= 0) {
      lastnz2 = 2 * k2 + 2;
      nbits2 = static_cast<int>(w.shfl(run_at, k2 / R));
    }
  }

  w.leader([&]() {
    int nbits_f = (nbits + 2047) / 2048;
    int nbits2_f;
    int lnz2 = lastnz2;
    if (mode >= 0) {
      nbits2_f = (nbits2 + 2047) / 2048;
    } else {
      nbits2_f = nbits_f;
      lnz2 = lastnz + 1;
    }
    if (mode > 0) {
      nbits_f += nbits_lsb;
      nbits2_f += nbits_lsb;
    }
    out[0] = nbits_f;
    out[stride] = nbits2_f;
    out[2 * stride] = lastnz;
    out[3 * stride] = lnz2;
    out[4 * stride] = (mode > 0 && nbits_f > target) ? 1 : 0;
  });
}

}  // namespace acx
