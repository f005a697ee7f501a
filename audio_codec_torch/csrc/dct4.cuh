// The DCT-IV of the low-delay MDCT and IMDCT (mdct.c:72-126, imdct.c:14-59)
// as a product of the stream rows by the N x N matrix, with the MDCT's window
// and fold as its prologue and the IMDCT's unfold, window and overlap-add as
// its epilogue. mdct.cu and imdct.cu launch it.
//
// The MDCT's float order is the one ops/transforms.py:_dct4_card states for a
// tensor on the card: each output is a sum over k in blocks of kDctTK = 32
// (the last block ragged), each block one k-ascending chain of separately
// rounded products and sums from its first product, and the blocks' sums
// added in order. The window and fold products are rounded one by one too
// (rmul, radd), as the plain version's PyTorch ops on the card round them.
// The IMDCT takes the CPU's order instead (xla_dct4_out, imdct.cu). So the
// kernels equal the plain versions bit for bit.
#pragma once

#include "acodec.cuh"

namespace acx {

constexpr int kDctTK = 32;     // k-depth of a block of the sum (and of a shared-memory tile)
constexpr int kDctMaxN = 480;  // the largest frame at 10 ms without HR mode

// out[n] = sum_k a[k] * Mt[k * N + n] in the blocked order above.
ACX_HD float dct4_out(const float* a, const float* Mt, int N, int n) {
  float acc = 0.0f;
  for (int k0 = 0; k0 < N; k0 += kDctTK) {
    const int k1 = imin(k0 + kDctTK, N);
    float part = rmul(a[k0], Mt[k0 * N + n]);
    for (int k = k0 + 1; k < k1; ++k) part = radd(part, rmul(a[k], Mt[k * N + n]));
    acc = k0 == 0 ? part : radd(acc, part);
  }
  return acc;
}

// The IMDCT's product in XLA:CPU's order (numerics.xla_dot, which the
// IMDCT's plain version takes on every device): k-blocks of
// imdct_chain_len(N) terms, each one chain of xfma from zero, the blocks'
// sums added in order.
ACX_HD int imdct_chain_len(int N) { return N == 480 ? 68 : N; }

ACX_HD float xla_dct4_out(const float* a, const float* Mt, int N, int n) {
  const int blk = imdct_chain_len(N);
  float acc = 0.0f, part = 0.0f;
  for (int k = 0; k < N; ++k) {
    if (k > 0 && k % blk == 0) {
      acc = k == blk ? part : radd(acc, part);
      part = 0.0f;
    }
    part = xfma(a[k], Mt[k * N + n], part);
  }
  return N <= blk ? part : radd(acc, part);
}

// The IMDCT's product of a single row (numerics.xla_gemv): eight interleaved
// xfma chains from zero (chain k % 8), combined pairwise.
ACX_HD float xla_dct4_out_row(const float* a, const float* Mt, int N, int n) {
  float acc[8] = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
  for (int k0 = 0; k0 < N; k0 += 8) {
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      if (k0 + j < N) acc[j] = xfma(a[k0 + j], Mt[(k0 + j) * N + n], acc[j]);
    }
  }
  return radd(radd(radd(acc[0], acc[1]), radd(acc[2], acc[3])),
              radd(radd(acc[4], acc[5]), radd(acc[6], acc[7])));
}

// The MDCT's input buffer [mem (N - la), x (N), zeros (la)] at j.
ACX_HD float mdct_buf(const float* x, const float* mem, int N, int la, int j) {
  return j < N - la ? mem[j] : (j < 2 * N - la ? x[j - (N - la)] : 0.0f);
}

// Element k of the windowed and folded MDCT input (mdct.c:115-119): for
// k < N/2, -w[3h+k] - w[3h-1-k]; above, w[k-h] - w[2h-1-(k-h)], with
// w[j] = buf[j] * win[j] (h = N/2).
ACX_HD float mdct_fold(const float* x, const float* mem, const float* win, int N, int la,
                       int k) {
  const int h = N / 2;
  if (k < h) {
    const int j1 = 3 * h + k, j2 = 3 * h - 1 - k;
    return radd(rmul(-mdct_buf(x, mem, N, la, j1), win[j1]),
                -rmul(mdct_buf(x, mem, N, la, j2), win[j2]));
  }
  const int i = k - h;
  const int j1 = i, j2 = 2 * h - 1 - i;
  return radd(rmul(mdct_buf(x, mem, N, la, j1), win[j1]),
              -rmul(mdct_buf(x, mem, N, la, j2), win[j2]));
}

// The IMDCT's output at position j of the 2N-sample unfolded frame x_ov, whose
// value is v: x_ov[la:N] * win + mem goes to out[0:N-la], x_ov[N:N+la] * win
// to out[N-la:N], x_ov[N+la:] * win to new_mem; x_ov[:la] is dropped. win is
// the reversed window. The overlap-add is one fused multiply-add in the
// CPU's contraction (xfma), as the plain version's numerics.xla_fma.
ACX_HD void imdct_place(float v, int j, int N, int la, const float* win, const float* mem,
                        float* out, float* new_mem) {
  if (j < la) return;
  if (j < N) {
    out[j - la] = xfma(v, win[j], mem[j - la]);
  } else if (j < N + la) {
    out[j - la] = rmul(v, win[j]);
  } else {
    new_mem[j - N - la] = rmul(v, win[j]);
  }
}

// The TDA unfold (imdct.c:31-46): x_ov = [t[h:], -rev(t[h:]), -rev(t[:h]),
// -t[:h]]; each DCT-IV output t[c] lands at two positions.
ACX_HD void imdct_scatter(float t, int c, int N, int la, const float* win, const float* mem,
                          float* out, float* new_mem) {
  const int h = N / 2;
  if (c >= h) {
    imdct_place(t, c - h, N, la, win, mem, out, new_mem);
    imdct_place(-t, h + (N - 1 - c), N, la, win, mem, out, new_mem);
  } else {
    imdct_place(-t, N + (h - 1 - c), N, la, win, mem, out, new_mem);
    imdct_place(-t, N + h + c, N, la, win, mem, out, new_mem);
  }
}

}  // namespace acx

#ifdef __CUDACC__
// A tiled SIMT product: a block of kDctThreads threads computes a kDctBM x
// kDctBN tile of outputs, each thread 4 x 4 of them, staging kDctTK-deep
// tiles of the rows (through load_a, the prologue) and of the matrix in shared
// memory; store(row, n, value) is the epilogue.
constexpr int kDctBM = 64;
constexpr int kDctBN = 64;
constexpr int kDctThreads = 256;

template <class LoadA, class Store>
__device__ __forceinline__ void dct4_tiles(const LoadA& load_a, const Store& store,
                                           const float* __restrict__ Mt, int B, int N) {
  using namespace acx;
  __shared__ float As[kDctTK][kDctBM + 1];
  __shared__ float Bs[kDctTK][kDctBN];
  const int row0 = blockIdx.y * kDctBM, col0 = blockIdx.x * kDctBN;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  float acc[4][4], part[4][4];
  for (int k0 = 0; k0 < N; k0 += kDctTK) {
    const int kn = imin(kDctTK, N - k0);
    for (int i = threadIdx.x; i < kDctBM * kDctTK; i += kDctThreads) {
      const int m = i / kDctTK, kk = i % kDctTK;
      As[kk][m] = (row0 + m < B && kk < kn) ? load_a(row0 + m, k0 + kk) : 0.0f;
    }
    for (int i = threadIdx.x; i < kDctTK * kDctBN; i += kDctThreads) {
      const int kk = i / kDctBN, c = i % kDctBN;
      Bs[kk][c] = (kk < kn && col0 + c < N) ? Mt[(k0 + kk) * N + col0 + c] : 0.0f;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kDctTK; ++kk) {
      if (kk < kn) {
        float a[4], b[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) a[i] = As[kk][ty + 16 * i];
#pragma unroll
        for (int j = 0; j < 4; ++j) b[j] = Bs[kk][tx + 16 * j];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const float p = rmul(a[i], b[j]);
            part[i][j] = kk == 0 ? p : radd(part[i][j], p);
          }
        }
      }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = k0 == 0 ? part[i][j] : radd(acc[i][j], part[i][j]);
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int r = row0 + ty + 16 * i, n = col0 + tx + 16 * j;
      if (r < B && n < N) store(r, n, acc[i][j]);
    }
  }
}

inline dim3 dct4_grid(int B, int N) {
  return dim3((N + kDctBN - 1) / kDctBN, (B + kDctBM - 1) / kDctBM);
}
#endif
