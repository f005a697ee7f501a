// mdct: the encoder's low-delay MDCT, window and fold fused into the DCT-IV;
// mdct_compensated: the same transform in the CPU's compensated order, the
// forward transform of the concealment's TDAC (ops/plc_adv.py:tdac).
//
// Replaces audio_codec_tpu/ops/transforms.py:mdct (transforms.py:69; the
// window and fold at :84-89 and the [B, N] x [N, N] product of _dct4_apply at
// :24; mdct.c:72-126). In the port's tensor code the fold was a chain of
// cat, pad, flip and windowed products around torch.matmul.
//
// Orders (dct4.cuh): mdct keeps the card's blocked order of
// ops/transforms.py:_dct4_card (k-blocks of 32, each a chain of separately
// rounded products and sums); mdct_compensated computes
// _dct4_compensated, the CPU branch's Dekker products and Neumaier sums, on
// every device, so the TDAC's memory on the card equals the CPU's. Both
// round every product before its add, which the tensor cores (products
// summed in wider precision) cannot reproduce.
//
// Bound on an H100 at B = 2048, N = 480: the table's bound is 2 * B * N * N
// operations at 67 TFLOP/s, 0.0141 ms (the bytes, about 13.7 MB, take
// 0.0041 ms). The blocked order forbids fused multiply-adds, so its 472 M
// steps are 944 M float instructions: at 128 lanes a clock an SM, 132 SMs
// and 1.98 GHz the issue bound is 0.028 ms, the design's floor. The
// compensated order's 472 M terms take two conversions each (16 a clock an
// SM: 0.23 ms), a double multiply-add (64 a clock: 0.03 ms) and 16 float
// operations (0.23 ms); at four instructions issued a clock an SM its
// 20 instructions a term take 0.28 ms, the design's floor.
// Design: a prologue (mdct_fold_kernel) windows and folds each row once into
// a k-major scratch [N][B rounded up to 64] and copies x[:, la:] into
// new_mem; in the compensated order it also tests each row's values of each
// k-block of 32 against compensated_fast_input's range (dct4.cuh) and
// writes a flag a row and block. The product (mdct_product_kernel) gives a
// block 64 rows x 120 columns (4 x 32 = 128 blocks at B = 2048, one wave on
// 132 SMs) and each of its 240 threads 8 x 4 outputs, read as 16-byte
// vectors from shared memory (three loads for 32 products); stages of 32
// k-rows, the card order's blocks, are copied with cp.async into
// double-buffered dynamic shared memory, the next stage in flight while this
// one is summed. The compensated order runs the same tiles with its own
// step: where every row of the block is in range in the stage (one block-wide
// vote on the prologue's flags), compensated_step_fast, whose Dekker term and
// Neumaier tail are each one fused multiply-add and whose one remaining xfma
// takes a and b converted to double once a k-row: two float/double
// conversions a term, where the split step took about thirteen; elsewhere
// compensated_step with the Veltkamp halves made on the fly (the same float
// operations as the plain version's split). The fast k-loop is not unrolled:
// unrolled by 4 or 8 it ran 6 % slower (tools/torch_dct4_variants.json), and
// 4 x 4 a thread 8 % slower than 8 x 4. It runs twice a frame at plc_mode 1
// (the TD-PLC's and the Phase ECU's TDAC).
#include "dct4.cuh"

using namespace acx;

#ifdef __CUDACC__
constexpr int kFoldTile = 32;
constexpr int kFoldThreads = 256;
constexpr int kMdctBM = 64;
constexpr int kMdctBN = 120;
constexpr int kMdctTM = 8;    // rows a thread (a multiple of 4: 16-byte loads)
constexpr int kMdctTN = 4;    // columns a thread
constexpr int kMdctThreads = (kMdctBM / kMdctTM) * (kMdctBN / kMdctTN);
constexpr int kMdctStagePlane = kDctTK * (kMdctBM + kMdctBN);   // floats of a stage
constexpr int kCompUnroll = 1;   // k-rows of the compensated fast step unrolled

template <bool kCompensated>
__global__ void __launch_bounds__(kFoldThreads)
    mdct_fold_kernel(const float* __restrict__ x, const float* __restrict__ mem,
                     const float* __restrict__ win, float* __restrict__ fold,
                     int32_t* __restrict__ fast, float* __restrict__ new_mem, int B, int Bp, int N,
                     int la) {
  __shared__ float tile[kFoldTile][kFoldTile + 1];
  __shared__ int32_t in_range[kFoldTile];
  const int k0 = blockIdx.x * kFoldTile, r0 = blockIdx.y * kFoldTile;
  const int tx = threadIdx.x % kFoldTile, ty = threadIdx.x / kFoldTile;
  if (kCompensated && threadIdx.x < kFoldTile) in_range[threadIdx.x] = 1;
  __syncthreads();
  for (int rr = ty; rr < kFoldTile; rr += kFoldThreads / kFoldTile) {
    const int r = r0 + rr, k = k0 + tx;
    float v = 0.0f;
    if (r < B && k < N) {
      const size_t row = static_cast<size_t>(r);
      v = mdct_fold(x + row * N, mem + row * (N - la), win, N, la, k, kCompensated);
    }
    tile[rr][tx] = v;
    if (kCompensated && !compensated_fast_input(v)) in_range[rr] = 0;
  }
  __syncthreads();
  for (int kk = ty; kk < kFoldTile; kk += kFoldThreads / kFoldTile) {
    const int k = k0 + kk;
    if (k < N) fold[static_cast<size_t>(k) * Bp + r0 + tx] = tile[tx][kk];
  }
  if (kCompensated && threadIdx.x < kFoldTile) {
    fast[static_cast<size_t>(blockIdx.x) * Bp + r0 + threadIdx.x] = in_range[threadIdx.x];
  }
  // new_mem = x[:, la:], the same 32 x 32 tile of it
  const int m = N - la;
  for (int i = threadIdx.x; i < kFoldTile * kFoldTile; i += kFoldThreads) {
    const int r = r0 + i / kFoldTile, c = k0 + i % kFoldTile;
    if (r < B && c < m) new_mem[static_cast<size_t>(r) * m + c] = x[static_cast<size_t>(r) * N + la + c];
  }
}

template <bool kCompensated>
__global__ void __launch_bounds__(kMdctThreads)
    mdct_product_kernel(const float* __restrict__ fold, const int32_t* __restrict__ fast,
                        const float* __restrict__ Mt, float* __restrict__ d, int B, int Bp, int N) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int row0 = blockIdx.y * kMdctBM, col0 = blockIdx.x * kMdctBN;
  const int tx = threadIdx.x % (kMdctBN / kMdctTN), ty = threadIdx.x / (kMdctBN / kMdctTN);
  const int stages = (N + kDctTK - 1) / kDctTK;
  // stage s: As [kDctTK][kMdctBM] then Bs [kDctTK][kMdctBN]
  auto stage_as = [&](int s) { return smem + (s & 1) * kMdctStagePlane; };
  auto copy_stage = [&](int s) {
    const int k0 = s * kDctTK;
    float* As = stage_as(s);
    float* Bs = As + kDctTK * kMdctBM;
    for (int i = threadIdx.x; i < kDctTK * kMdctBM / 4; i += kMdctThreads) {
      const int kk = i / (kMdctBM / 4), m = 4 * (i % (kMdctBM / 4));
      const bool valid = k0 + kk < N;
      acx_cp_async16(As + kk * kMdctBM + m,
                     valid ? fold + static_cast<size_t>(k0 + kk) * Bp + row0 + m : fold, valid);
    }
    for (int i = threadIdx.x; i < kDctTK * kMdctBN / 4; i += kMdctThreads) {
      const int kk = i / (kMdctBN / 4), c = 4 * (i % (kMdctBN / 4));
      const bool valid = k0 + kk < N && col0 + c < N;
      acx_cp_async16(Bs + kk * kMdctBN + c,
                     valid ? Mt + static_cast<size_t>(k0 + kk) * N + col0 + c : Mt, valid);
    }
    acx_cp_async_commit();
  };

  // card order: acc (the blocks' sum) and part (this block's chain);
  // compensated: acc is the sum s, part its compensation
  float acc[kMdctTM][kMdctTN], part[kMdctTM][kMdctTN];
#pragma unroll
  for (int i = 0; i < kMdctTM; ++i) {
#pragma unroll
    for (int j = 0; j < kMdctTN; ++j) acc[i][j] = part[i][j] = 0.0f;
  }
  copy_stage(0);
  acx_cp_async_wait_all();
  __syncthreads();
  for (int s = 0; s < stages; ++s) {
    const int kn = imin(kDctTK, N - s * kDctTK);
    // compensated: every row of the block in range in this stage
    const bool in_range = kCompensated &&
        __syncthreads_and(threadIdx.x >= kMdctBM ||
                          fast[static_cast<size_t>(s) * Bp + row0 + threadIdx.x]);
    if (s + 1 < stages) copy_stage(s + 1);
    const float* As = stage_as(s);
    const float* Bs = As + kDctTK * kMdctBM;
    // one k-row of the stage: its 16-byte loads, then the tile's terms
    auto load = [&](int kk, float (&a)[kMdctTM], float (&b)[kMdctTN]) {
#pragma unroll
      for (int q = 0; q < kMdctTM; q += 4) {
        const float4 v = *reinterpret_cast<const float4*>(As + kk * kMdctBM + kMdctTM * ty + q);
        a[q] = v.x, a[q + 1] = v.y, a[q + 2] = v.z, a[q + 3] = v.w;
      }
#pragma unroll
      for (int q = 0; q < kMdctTN; q += 4) {
        const float4 v = *reinterpret_cast<const float4*>(Bs + kk * kMdctBN + kMdctTN * tx + q);
        b[q] = v.x, b[q + 1] = v.y, b[q + 2] = v.z, b[q + 3] = v.w;
      }
    };
    if constexpr (kCompensated) {
      if (in_range) {
#pragma unroll (kCompUnroll)
        for (int kk = 0; kk < kn; ++kk) {
          float a[kMdctTM], b[kMdctTN];
          double ad[kMdctTM], bd[kMdctTN];
          load(kk, a, b);
#pragma unroll
          for (int i = 0; i < kMdctTM; ++i) ad[i] = static_cast<double>(a[i]);
#pragma unroll
          for (int j = 0; j < kMdctTN; ++j) bd[j] = static_cast<double>(b[j]);
#pragma unroll
          for (int i = 0; i < kMdctTM; ++i) {
#pragma unroll
            for (int j = 0; j < kMdctTN; ++j) {
              compensated_step_fast(a[i], b[j], ad[i], bd[j], acc[i][j], part[i][j]);
            }
          }
        }
      } else {
#pragma unroll 1
        for (int kk = 0; kk < kn; ++kk) {
          float a[kMdctTM], b[kMdctTN], ah[kMdctTM], al[kMdctTM], bh[kMdctTN], bl[kMdctTN];
          load(kk, a, b);
#pragma unroll
          for (int i = 0; i < kMdctTM; ++i) veltkamp(a[i], ah[i], al[i]);
#pragma unroll
          for (int j = 0; j < kMdctTN; ++j) veltkamp(b[j], bh[j], bl[j]);
#pragma unroll
          for (int i = 0; i < kMdctTM; ++i) {
#pragma unroll
            for (int j = 0; j < kMdctTN; ++j) {
              compensated_step(a[i], ah[i], al[i], b[j], bh[j], bl[j], acc[i][j], part[i][j]);
            }
          }
        }
      }
    } else {
      auto step = [&](int kk) {
        float a[kMdctTM], b[kMdctTN];
        load(kk, a, b);
#pragma unroll
        for (int i = 0; i < kMdctTM; ++i) {
#pragma unroll
          for (int j = 0; j < kMdctTN; ++j) {
            const float prod = rmul(a[i], b[j]);
            part[i][j] = kk == 0 ? prod : radd(part[i][j], prod);
          }
        }
      };
      if (kn == kDctTK) {
        // a whole stage: unrolled without tests, so the next row's loads are
        // issued while this row is summed
#pragma unroll
        for (int kk = 0; kk < kDctTK; ++kk) step(kk);
      } else {
#pragma unroll 1
        for (int kk = 0; kk < kn; ++kk) step(kk);
      }
      // the block of 32 ends: add its sum in order
#pragma unroll
      for (int i = 0; i < kMdctTM; ++i) {
#pragma unroll
        for (int j = 0; j < kMdctTN; ++j) acc[i][j] = s == 0 ? part[i][j] : radd(acc[i][j], part[i][j]);
      }
    }
    if (s + 1 < stages) acx_cp_async_wait_all();
    __syncthreads();
  }
  const int c = col0 + kMdctTN * tx;
  if (c >= N) return;
#pragma unroll
  for (int i = 0; i < kMdctTM; ++i) {
    const int r = row0 + kMdctTM * ty + i;
    if (r < B) {
      float v[kMdctTN];
#pragma unroll
      for (int j = 0; j < kMdctTN; ++j) v[j] = kCompensated ? radd(acc[i][j], part[i][j]) : acc[i][j];
#pragma unroll
      for (int q = 0; q < kMdctTN; q += 4) {
        *reinterpret_cast<float4*>(d + static_cast<size_t>(r) * N + c + q) =
            make_float4(v[q], v[q + 1], v[q + 2], v[q + 3]);
      }
    }
  }
}

template <bool kCompensated>
static int launch_mdct(const void* x, const void* mem, const void* win, const void* Mt,
                       void* fold, void* fast, void* d, void* new_mem, int B, int Bp, int N,
                       int la, void* stream) {
  static bool smem_set = false;
  if (N > kDctMaxN || N % 4 || Bp % kMdctBM || Bp < B) return static_cast<int>(cudaErrorInvalidValue);
  if (B == 0) return static_cast<int>(cudaSuccess);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const size_t smem = 2 * kMdctStagePlane * sizeof(float);
  const cudaError_t rc = acx_dynamic_smem(mdct_product_kernel<kCompensated>, smem, &smem_set);
  if (rc != cudaSuccess) return static_cast<int>(rc);
  mdct_fold_kernel<kCompensated>
      <<<dim3((N + kFoldTile - 1) / kFoldTile, Bp / kFoldTile), kFoldThreads, 0, st>>>(
          static_cast<const float*>(x), static_cast<const float*>(mem),
          static_cast<const float*>(win), static_cast<float*>(fold), static_cast<int32_t*>(fast),
          static_cast<float*>(new_mem), B, Bp, N, la);
  const cudaError_t fold_rc = cudaGetLastError();
  if (fold_rc != cudaSuccess) return static_cast<int>(fold_rc);
  mdct_product_kernel<kCompensated>
      <<<dim3((N + kMdctBN - 1) / kMdctBN, Bp / kMdctBM), kMdctThreads, smem, st>>>(
          static_cast<const float*>(fold), static_cast<const int32_t*>(fast),
          static_cast<const float*>(Mt), static_cast<float*>(d), B, Bp, N);
  return static_cast<int>(cudaGetLastError());
}

// fold is scratch of [N][Bp] floats (Bp: B rounded up to 64), Mt the [N, N]
// matrix.
extern "C" int acx_mdct(const void* x, const void* mem, const void* win, const void* Mt,
                        void* fold, void* d, void* new_mem, int B, int Bp, int N, int la,
                        void* stream) {
  return launch_mdct<false>(x, mem, win, Mt, fold, nullptr, d, new_mem, B, Bp, N, la, stream);
}

// fold as for acx_mdct; fast: [ceil(N / 32)][Bp] int32, set to 1 where a
// row's values of that k-block of 32 are in compensated_fast_input's range.
extern "C" int acx_mdct_compensated(const void* x, const void* mem, const void* win,
                                    const void* Mt, void* fold, void* fast, void* d,
                                    void* new_mem, int B, int Bp, int N, int la, void* stream) {
  return launch_mdct<true>(x, mem, win, Mt, fold, fast, d, new_mem, B, Bp, N, la, stream);
}
#endif
