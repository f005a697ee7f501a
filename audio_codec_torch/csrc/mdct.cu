// mdct: the encoder's low-delay MDCT, window and fold fused into the DCT-IV.
//
// Replaces audio_codec_tpu/ops/transforms.py:mdct (transforms.py:69; the
// window and fold at :84-89 and the [B, N] x [N, N] product of _dct4_apply at
// :24; mdct.c:72-126). In the port's tensor code the fold was a chain of
// cat, pad, flip and windowed products around torch.matmul.
//
// Bound on an H100: 2 * B * N * N float operations, 0.944 GFLOP at B = 2048,
// N = 480: 0.0141 ms at 67 TFLOP/s; the bytes (x, mem, d, new_mem and the
// matrix) are about 13.7 MB, 0.0041 ms at 3.35 TB/s. The operations bound it,
// and the kernel does each product and sum as its own instruction (no fused
// multiply-add), twice the count the peak assumes.
// Design: the tiled SIMT product of dct4.cuh; the prologue computes each
// folded input from x, mem and the window as the row tile is staged, so the
// folded rows never reach device memory. The blocks of the first column tile
// also copy x[:, la:] into new_mem. A later PR moves the product to the
// tensor cores (3xTF32 on wgmma), which the bit-for-bit order here rules out.
#include "dct4.cuh"

using namespace acx;

#ifdef __CUDACC__
struct MdctFold {
  const float* x;
  const float* mem;
  const float* win;
  int N, la;
  __device__ float operator()(int r, int k) const {
    const size_t row = static_cast<size_t>(r);
    return mdct_fold(x + row * N, mem + row * (N - la), win, N, la, k);
  }
};

struct StoreRow {
  float* d;
  int N;
  __device__ void operator()(int r, int n, float v) const { d[static_cast<size_t>(r) * N + n] = v; }
};

__global__ void __launch_bounds__(kDctThreads)
    mdct_kernel(const float* __restrict__ x, const float* __restrict__ mem,
                const float* __restrict__ win, const float* __restrict__ Mt,
                float* __restrict__ d, float* __restrict__ new_mem, int B, int N, int la) {
  dct4_tiles(MdctFold{x, mem, win, N, la}, StoreRow{d, N}, Mt, B, N);
  if (blockIdx.x == 0) {
    const int row0 = blockIdx.y * kDctBM, rows = imin(kDctBM, B - row0), m = N - la;
    for (int i = threadIdx.x; i < rows * m; i += kDctThreads) {
      const size_t r = static_cast<size_t>(row0 + i / m);
      new_mem[r * m + i % m] = x[r * N + la + i % m];
    }
  }
}

extern "C" int acx_mdct(const void* x, const void* mem, const void* win, const void* Mt, void* d,
                        void* new_mem, int B, int N, int la, void* stream) {
  mdct_kernel<<<dct4_grid(B, N), kDctThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<const float*>(mem),
      static_cast<const float*>(win), static_cast<const float*>(Mt), static_cast<float*>(d),
      static_cast<float*>(new_mem), B, N, la);
  return static_cast<int>(cudaGetLastError());
}
#endif
