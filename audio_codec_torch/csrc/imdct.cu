// imdct: the decoder's inverse MDCT, the DCT-IV with the TDA unfold, window
// and overlap-add fused as its epilogue.
//
// Replaces audio_codec_tpu/ops/transforms.py:imdct (transforms.py:96: the
// [B, N] x [N, N] product at :107, the unfold :109-111, window and
// overlap-add :112-117; imdct.c:14-59). In the port's tensor code these were
// torch.matmul and about ten ops of cat, flip, window and add.
//
// Bound on an H100: 2 * B * N * N operations (0.0141 ms at B = 2048, N = 480,
// 67 TFLOP/s) against about 13.7 MB of bytes (0.0041 ms): the operations
// bound it.
// Design: the float order is the CPU's (numerics.xla_dot, which the plain
// version takes on every device): each output is a sum of k-blocks of
// imdct_chain_len(N) terms (68 at N = 480, else one block), each block one
// chain of xfma (a double product and add, rounded to float) from zero, the
// blocks' sums added in order. A block of 256 threads computes 64 rows x 64
// columns, each thread 4 x 4 outputs, with the spectrum rows and the matrix
// staged in shared memory 68 rows of k at a time, so a chain block starts at
// a stage; a single stream takes the order of a matrix-vector product
// (numerics.xla_gemv, imdct_row_kernel). Each output t[c] goes straight to its
// two places in the unfolded frame, is windowed there and, in the overlap
// range, added to the memory (dct4.cuh:imdct_scatter), so the unfolded frame
// never reaches device memory.
#include "dct4.cuh"

using namespace acx;

#ifdef __CUDACC__
constexpr int kImdctTK = 68;   // k rows staged at a time: the N = 480 chain block
constexpr int kImdctBM = 64;
constexpr int kImdctBN = 64;
constexpr int kImdctThreads = 256;

__global__ void __launch_bounds__(kImdctThreads)
    imdct_kernel(const float* __restrict__ y, const float* __restrict__ mem,
                 const float* __restrict__ win, const float* __restrict__ Mt,
                 float* __restrict__ out, float* __restrict__ new_mem, int B, int N, int la) {
  __shared__ float As[kImdctTK][kImdctBM + 1];
  __shared__ float Bs[kImdctTK][kImdctBN];
  const int row0 = blockIdx.y * kImdctBM, col0 = blockIdx.x * kImdctBN;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const int blk = imdct_chain_len(N);
  float acc[4][4], part[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = part[i][j] = 0.0f;
  }
  for (int k0 = 0; k0 < N; k0 += kImdctTK) {
    const int kn = imin(kImdctTK, N - k0);
    if (k0 > 0 && k0 % blk == 0) {   // a chain block ends: add its sum in order
#pragma unroll
      for (int i = 0; i < 4; ++i) {
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          acc[i][j] = k0 == blk ? part[i][j] : radd(acc[i][j], part[i][j]);
          part[i][j] = 0.0f;
        }
      }
    }
    for (int i = threadIdx.x; i < kImdctBM * kImdctTK; i += kImdctThreads) {
      const int m = i / kImdctTK, kk = i % kImdctTK;
      As[kk][m] = (row0 + m < B && kk < kn) ? y[static_cast<size_t>(row0 + m) * N + k0 + kk]
                                            : 0.0f;
    }
    for (int i = threadIdx.x; i < kImdctTK * kImdctBN; i += kImdctThreads) {
      const int kk = i / kImdctBN, c = i % kImdctBN;
      Bs[kk][c] = (kk < kn && col0 + c < N) ? Mt[(k0 + kk) * N + col0 + c] : 0.0f;
    }
    __syncthreads();
#pragma unroll 4
    for (int kk = 0; kk < kn; ++kk) {
      double a[4], b[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = static_cast<double>(As[kk][ty + 16 * i]);
#pragma unroll
      for (int j = 0; j < 4; ++j) b[j] = static_cast<double>(Bs[kk][tx + 16 * j]);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          // xfma(a, b, part): the product exact in double, one double add, rounded once
          part[i][j] = __double2float_rn(
              __dadd_rn(__dmul_rn(a[i], b[j]), static_cast<double>(part[i][j])));
        }
      }
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int r = row0 + ty + 16 * i, c = col0 + tx + 16 * j;
      if (r < B && c < N) {
        const float t = N <= blk ? part[i][j] : radd(acc[i][j], part[i][j]);
        const size_t row = static_cast<size_t>(r);
        imdct_scatter(t, c, N, la, win, mem + row * (N - la), out + row * N,
                      new_mem + row * (N - la));
      }
    }
  }
}

// One stream (B = 1): the product of a single row in its own order
// (xla_dct4_out_row), a thread an output.
constexpr int kImdctRowThreads = 128;

__global__ void __launch_bounds__(kImdctRowThreads)
    imdct_row_kernel(const float* __restrict__ y, const float* __restrict__ mem,
                     const float* __restrict__ win, const float* __restrict__ Mt,
                     float* __restrict__ out, float* __restrict__ new_mem, int N, int la) {
  const int c = blockIdx.x * kImdctRowThreads + threadIdx.x;
  if (c < N) imdct_scatter(xla_dct4_out_row(y, Mt, N, c), c, N, la, win, mem, out, new_mem);
}

extern "C" int acx_imdct(const void* y, const void* mem, const void* win, const void* Mt,
                         void* out, void* new_mem, int B, int N, int la, void* stream) {
  const int blk = imdct_chain_len(N);
  if (N > kDctMaxN || (blk != kImdctTK && blk < N)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (B == 0) return static_cast<int>(cudaSuccess);
  if (B == 1) {
    imdct_row_kernel<<<(N + kImdctRowThreads - 1) / kImdctRowThreads, kImdctRowThreads, 0,
                       static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(y), static_cast<const float*>(mem),
        static_cast<const float*>(win), static_cast<const float*>(Mt), static_cast<float*>(out),
        static_cast<float*>(new_mem), N, la);
    return static_cast<int>(cudaGetLastError());
  }
  const dim3 grid((N + kImdctBN - 1) / kImdctBN, (B + kImdctBM - 1) / kImdctBM);
  imdct_kernel<<<grid, kImdctThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(y), static_cast<const float*>(mem),
      static_cast<const float*>(win), static_cast<const float*>(Mt), static_cast<float*>(out),
      static_cast<float*>(new_mem), B, N, la);
  return static_cast<int>(cudaGetLastError());
}
#endif
