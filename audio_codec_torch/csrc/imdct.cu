// imdct: the decoder's inverse MDCT, the DCT-IV with the TDA unfold, window
// and overlap-add fused as its epilogue.
//
// Replaces audio_codec_tpu/ops/transforms.py:imdct (transforms.py:96: the
// [B, N] x [N, N] product at :107, the unfold :109-111, window and
// overlap-add :112-117; imdct.c:14-59). In the port's tensor code these were
// torch.matmul and about ten ops of cat, flip, window and add.
//
// The float order is the CPU's (numerics.xla_dot, which the plain version
// takes on every device): each output a sum of k-blocks of
// imdct_chain_len(N) terms (68 at N = 480, else one block), each block one
// chain of xfma (the product exact in double, one double add, rounded to
// float) from zero, the blocks' sums added in order; a single stream takes
// the order of a matrix-vector product (numerics.xla_gemv, eight
// interleaved chains, imdct_row_kernel). Every step rounds to float before
// the next add, so the tensor cores, which add in wider precision, cannot
// compute it.
//
// Bound on an H100 at B = 2048, N = 480: the table's bound is 2 * B * N * N
// operations at 67 TFLOP/s, 0.0141 ms (the bytes, about 13.7 MB, take
// 0.0041 ms). This order needs B * N * N = 472 M chain steps, and each is
// done here as three double operations (one fused multiply-add and the
// two adds of the rounding, dct4.cuh:round_float_in_range) and an integer
// add; at 64 double operations a clock an SM, 132 SMs and 1.98 GHz that is
// 0.085 ms. The step's dependent latency holds the step alone at about
// 4.0 T steps a second on an H100 (tools/torch_dct4_times.py
// --step-bench), 0.118 ms for these steps: the design's floor.
// Design: the chain value stays in a double register that always holds a
// float value, so a step converts nothing (the first version converted
// float to double and back on every step, 2.5 conversions a step at 16 a
// clock an SM: 0.36 ms). The spectrum rows are converted once, as they are
// staged; the matrix is a device-cached float64 copy, resident in L2, copied
// into shared memory with cp.async. A block of 960 threads computes 64 rows
// x 120 columns (4 x 32 = 128 blocks at B = 2048, one wave on 132 SMs),
// each thread 2 x 4 outputs (rows ty + 32 i, columns tx + 30 j, so that a
// warp's loads of a stage row are broadcasts or consecutive doubles): 30
// warps an SM hide the double operations' latency better than 15 warps of
// 4 x 4 (measured on an NVIDIA H100 80GB HBM3). Stages
// of 34 k-rows, double-buffered in dynamic shared memory (98 KB), so a
// chain block of 68 starts at a stage. The rounding needs no range test
// while every spectrum value of a chain lies in the range of
// dct4.cuh:imdct_fast_input (the proof is there): the staging notes each
// row's values out of it, and a thread whose rows hold one takes the
// tested step (xfma_d) for the rest of that chain. Each
// output t[c] goes straight to its two places in the unfolded frame, is
// windowed there and, in the overlap range, added to the memory
// (dct4.cuh:imdct_scatter), so the unfolded frame never reaches device
// memory.
#include "dct4.cuh"

using namespace acx;

#ifdef __CUDACC__
constexpr int kImdctTK = 34;    // k rows a stage: half the N = 480 chain block
constexpr int kImdctBM = 64;
constexpr int kImdctBN = 120;
constexpr int kImdctAS = kImdctBM + 1;   // stride of a staged spectrum row: stores 2-way, not 32-way
constexpr int kImdctRM = 2;     // rows a thread, kImdctTY apart
constexpr int kImdctRN = 4;     // columns a thread, kImdctTX apart
constexpr int kImdctTY = kImdctBM / kImdctRM;
constexpr int kImdctTX = kImdctBN / kImdctRN;
constexpr int kImdctThreads = kImdctTY * kImdctTX;
constexpr int kImdctStageDoubles = kImdctTK * (kImdctAS + kImdctBN);
constexpr size_t kImdctSmem = 2 * kImdctStageDoubles * sizeof(double);
constexpr int kImdctALoads = (kImdctTK * kImdctBM + kImdctThreads - 1) / kImdctThreads;

__global__ void __launch_bounds__(kImdctThreads, 1)
    imdct_kernel(const float* __restrict__ y, const float* __restrict__ mem,
                 const float* __restrict__ win, const double* __restrict__ Mt,
                 float* __restrict__ out, float* __restrict__ new_mem, int B, int N, int la) {
  extern __shared__ double smem[];
  // slow[s % 3][m]: row m has a value outside dct4.cuh:imdct_fast_input in
  // stage s. Three rings, so that a ring is cleared a stage before it is
  // written and read a stage after.
  __shared__ int slow[3][kImdctBM];
  const int row0 = blockIdx.y * kImdctBM, col0 = blockIdx.x * kImdctBN;
  const int tx = threadIdx.x % kImdctTX, ty = threadIdx.x / kImdctTX;
  const int blk = imdct_chain_len(N);
  const int stages = (N + kImdctTK - 1) / kImdctTK;

  // the spectrum rows of stage s, as floats in registers (coalesced along k)
  float a_next[kImdctALoads];
  auto load_a = [&](int s) {
    const int k0 = s * kImdctTK;
#pragma unroll
    for (int l = 0; l < kImdctALoads; ++l) {
      const int i = threadIdx.x + l * kImdctThreads;
      const int m = i / kImdctTK, kk = i % kImdctTK;
      a_next[l] = (i < kImdctTK * kImdctBM && row0 + m < B && k0 + kk < N)
                      ? y[static_cast<size_t>(row0 + m) * N + k0 + kk]
                      : 0.0f;
    }
  };
  // ... converted once into As[kk][m] of the stage's buffer, each row's
  // range noted
  auto store_a = [&](int s) {
    double* As = smem + (s & 1) * kImdctStageDoubles;
#pragma unroll
    for (int l = 0; l < kImdctALoads; ++l) {
      const int i = threadIdx.x + l * kImdctThreads;
      if (i < kImdctTK * kImdctBM) {
        As[(i % kImdctTK) * kImdctAS + i / kImdctTK] = a_next[l];
        if (!imdct_fast_input(a_next[l])) slow[s % 3][i / kImdctTK] = 1;
      }
    }
  };
  // the matrix rows of stage s into Bs[kk][c], 16 bytes a copy
  auto copy_b = [&](int s) {
    const int k0 = s * kImdctTK;
    double* Bs = smem + (s & 1) * kImdctStageDoubles + kImdctTK * kImdctAS;
    for (int i = threadIdx.x; i < kImdctTK * kImdctBN / 2; i += kImdctThreads) {
      const int kk = i / (kImdctBN / 2), c = 2 * (i % (kImdctBN / 2));
      const bool valid = k0 + kk < N && col0 + c < N;
      acx_cp_async16(Bs + kk * kImdctBN + c,
                     valid ? Mt + static_cast<size_t>(k0 + kk) * N + col0 + c : Mt, valid);
    }
    acx_cp_async_commit();
  };

  float acc[kImdctRM][kImdctRN];
  double part[kImdctRM][kImdctRN];
#pragma unroll
  for (int i = 0; i < kImdctRM; ++i) {
#pragma unroll
    for (int j = 0; j < kImdctRN; ++j) {
      acc[i][j] = 0.0f;
      part[i][j] = 0.0;
    }
  }
  for (int i = threadIdx.x; i < 3 * kImdctBM; i += kImdctThreads) slow[i / kImdctBM][i % kImdctBM] = 0;
  __syncthreads();
  copy_b(0);
  load_a(0);
  store_a(0);
  acx_cp_async_wait_all();
  __syncthreads();
  bool chain_slow = false;   // a chain of this thread's tile met a value outside the fast range
  for (int s = 0; s < stages; ++s) {
    const int k0 = s * kImdctTK, kn = imin(kImdctTK, N - k0);
    if (s + 1 < stages) {
      copy_b(s + 1);
      load_a(s + 1);
    }
    if (threadIdx.x < kImdctBM) slow[(s + 2) % 3][threadIdx.x] = 0;
    if (k0 > 0 && k0 % blk == 0) {   // a chain block ends: add its sum in order
#pragma unroll
      for (int i = 0; i < kImdctRM; ++i) {
#pragma unroll
        for (int j = 0; j < kImdctRN; ++j) {
          const float p = static_cast<float>(part[i][j]);
          acc[i][j] = k0 == blk ? p : radd(acc[i][j], p);
          part[i][j] = 0.0;
        }
      }
      chain_slow = false;
    }
#pragma unroll
    for (int i = 0; i < kImdctRM; ++i) chain_slow = chain_slow || slow[s % 3][ty + kImdctTY * i] != 0;
    const double* As = smem + (s & 1) * kImdctStageDoubles;
    const double* Bs = As + kImdctTK * kImdctAS;
    if (!chain_slow) {
      // every sum is in round_float_in_range's domain (dct4.cuh): no test
      double a[kImdctRM], b[kImdctRN];
      auto load = [&](int kk) {
#pragma unroll
        for (int i = 0; i < kImdctRM; ++i) a[i] = As[kk * kImdctAS + ty + kImdctTY * i];
#pragma unroll
        for (int j = 0; j < kImdctRN; ++j) b[j] = Bs[kk * kImdctBN + tx + kImdctTX * j];
      };
      // rfma_f64 then round_float_in_range, written a phase at a time over the
      // tile, so that each M has its own registers and the tile's chains
      // interleave (one M register pair for all serialises them)
      auto sum = [&]() {
        double m[kImdctRM][kImdctRN];
#pragma unroll
        for (int i = 0; i < kImdctRM; ++i) {
#pragma unroll
          for (int j = 0; j < kImdctRN; ++j) part[i][j] = rfma_f64(a[i], b[j], part[i][j]);
        }
#pragma unroll
        for (int i = 0; i < kImdctRM; ++i) {
#pragma unroll
          for (int j = 0; j < kImdctRN; ++j) m[i][j] = from_hi_word(hi_word(part[i][j]) + kRoundM);
        }
#pragma unroll
        for (int i = 0; i < kImdctRM; ++i) {
#pragma unroll
          for (int j = 0; j < kImdctRN; ++j) part[i][j] = radd_f64(part[i][j], m[i][j]);
        }
#pragma unroll
        for (int i = 0; i < kImdctRM; ++i) {
#pragma unroll
          for (int j = 0; j < kImdctRN; ++j) part[i][j] = radd_f64(part[i][j], -m[i][j]);
        }
      };
      if (kn == kImdctTK) {
        // a whole stage, unrolled, so the next row's loads are issued early
#pragma unroll
        for (int kk = 0; kk < kImdctTK; ++kk) {
          load(kk);
          sum();
        }
      } else {
        for (int kk = 0; kk < kn; ++kk) {
          load(kk);
          sum();
        }
      }
    } else {
      // zeros, subnormal or huge values: each step tests its range
      for (int kk = 0; kk < kn; ++kk) {
        double a[kImdctRM], b[kImdctRN];
#pragma unroll
        for (int i = 0; i < kImdctRM; ++i) a[i] = As[kk * kImdctAS + ty + kImdctTY * i];
#pragma unroll
        for (int j = 0; j < kImdctRN; ++j) b[j] = Bs[kk * kImdctBN + tx + kImdctTX * j];
#pragma unroll
        for (int i = 0; i < kImdctRM; ++i) {
#pragma unroll
          for (int j = 0; j < kImdctRN; ++j) part[i][j] = xfma_d(a[i], b[j], part[i][j]);
        }
      }
    }
    if (s + 1 < stages) {
      store_a(s + 1);
      acx_cp_async_wait_all();
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < kImdctRM; ++i) {
#pragma unroll
    for (int j = 0; j < kImdctRN; ++j) {
      const int r = row0 + ty + kImdctTY * i, c = col0 + tx + kImdctTX * j;
      if (r < B && c < N) {
        const float p = static_cast<float>(part[i][j]);
        const float t = N <= blk ? p : radd(acc[i][j], p);
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

static bool imdct_smem_set = false;

// Mt is the float32 matrix, Mt64 the same values as doubles.
extern "C" int acx_imdct(const void* y, const void* mem, const void* win, const void* Mt,
                         const void* Mt64, void* out, void* new_mem, int B, int N, int la,
                         void* stream) {
  const int blk = imdct_chain_len(N);
  if (N > kDctMaxN || N % 2 || (blk % kImdctTK != 0 && blk < N)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (B == 0) return static_cast<int>(cudaSuccess);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (B == 1) {
    imdct_row_kernel<<<(N + kImdctRowThreads - 1) / kImdctRowThreads, kImdctRowThreads, 0, st>>>(
        static_cast<const float*>(y), static_cast<const float*>(mem),
        static_cast<const float*>(win), static_cast<const float*>(Mt), static_cast<float*>(out),
        static_cast<float*>(new_mem), N, la);
    return static_cast<int>(cudaGetLastError());
  }
  const cudaError_t rc = acx_dynamic_smem(imdct_kernel, kImdctSmem, &imdct_smem_set);
  if (rc != cudaSuccess) return static_cast<int>(rc);
  const dim3 grid((N + kImdctBN - 1) / kImdctBN, (B + kImdctBM - 1) / kImdctBM);
  imdct_kernel<<<grid, kImdctThreads, kImdctSmem, st>>>(
      static_cast<const float*>(y), static_cast<const float*>(mem),
      static_cast<const float*>(win), static_cast<const double*>(Mt64), static_cast<float*>(out),
      static_cast<float*>(new_mem), B, N, la);
  return static_cast<int>(cudaGetLastError());
}
#endif
