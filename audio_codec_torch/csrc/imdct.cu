// imdct: the decoder's inverse MDCT, the DCT-IV with the TDA unfold, window
// and overlap-add fused as its epilogue.
//
// Replaces audio_codec_tpu/ops/transforms.py:imdct (transforms.py:96: the
// [B, N] x [N, N] product at :107, the unfold :109-111, window and
// overlap-add :112-117; imdct.c:14-59). In the port's tensor code these were
// torch.matmul and about ten ops of cat, flip, window and add.
//
// Bound on an H100: as mdct.cu, 2 * B * N * N float operations (0.0141 ms at
// B = 2048, N = 480, 67 TFLOP/s) against about 13.7 MB of bytes (0.0041 ms):
// the operations bound it.
// Design: the tiled SIMT product of dct4.cuh, the spectrum rows staged as they
// are; each output t[c] of the product goes straight to its two places in the
// unfolded frame, is windowed there and, in the overlap range, added to the
// memory, so the unfolded frame never reaches device memory.
#include "dct4.cuh"

using namespace acx;

#ifdef __CUDACC__
struct LoadRow {
  const float* y;
  int N;
  __device__ float operator()(int r, int k) const { return y[static_cast<size_t>(r) * N + k]; }
};

struct Unfold {
  const float* win;
  const float* mem;
  float* out;
  float* new_mem;
  int N, la;
  __device__ void operator()(int r, int c, float t) const {
    const size_t row = static_cast<size_t>(r);
    imdct_scatter(t, c, N, la, win, mem + row * (N - la), out + row * N,
                  new_mem + row * (N - la));
  }
};

__global__ void __launch_bounds__(kDctThreads)
    imdct_kernel(const float* __restrict__ y, const float* __restrict__ mem,
                 const float* __restrict__ win, const float* __restrict__ Mt,
                 float* __restrict__ out, float* __restrict__ new_mem, int B, int N, int la) {
  dct4_tiles(LoadRow{y, N}, Unfold{win, mem, out, new_mem, N, la}, Mt, B, N);
}

extern "C" int acx_imdct(const void* y, const void* mem, const void* win, const void* Mt,
                         void* out, void* new_mem, int B, int N, int la, void* stream) {
  imdct_kernel<<<dct4_grid(B, N), kDctThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(y), static_cast<const float*>(mem),
      static_cast<const float*>(win), static_cast<const float*>(Mt), static_cast<float*>(out),
      static_cast<float*>(new_mem), B, N, la);
  return static_cast<int>(cudaGetLastError());
}
#endif
