// tns_filter_analysis: the encoder's TNS filter analysis, one or two filters
// per stream, up to the coefficients the lattice takes.
//
// Replaces the tensor code of audio_codec_tpu/ops/tns.py:tns_encode (tns.py:81;
// analyze_filter at :113-173, with _levinson at :44 and _poly2rc at :63;
// tns_coder.c:157-329): masked sums over [B, N] rows per subdivision and lag,
// and the order-8 recursions as about a hundred [B]-wide ops each, for two
// filters. The lattice after it is the tns_analysis_lattice kernel.
//
// Bound on an H100: reads the spectrum rows (B x 480 x 4 bytes, bins above
// the bandwidth included) and the bandwidth index, writes 2 orders, 16
// indices, 16 coefficients and 2 counts a stream: about 4.3 MB at B = 2048,
// 0.0013 ms at 3.35 TB/s. Per stream the work is a chain: about 400 bins x 9
// lags of multiply-adds per filter, then two recursions of about 100
// dependent operations.
// Design: one thread per stream; a block stages its streams' rows in shared
// memory with coalesced loads, and each thread sums only its filters'
// subdivisions, each lag one chain in a register, bins ascending, then runs
// the recursions in registers (tns_analysis.cuh). It computes the weighting
// and the quantizer only for a filter whose gain turns TNS on: the outputs of
// a filter that is off are masked.
#include "tns_analysis.cuh"

using namespace acx;

#ifdef __CUDACC__
constexpr int kTnsAnaThreads = 32;

template <int ORDER, int NSUB>
__global__ void tns_filter_analysis_kernel(const float* __restrict__ x,
                                           const int32_t* __restrict__ bw_idx,
                                           const int32_t* __restrict__ tables, TnsGeom g,
                                           int32_t* __restrict__ order,
                                           int32_t* __restrict__ rc_idx,
                                           float* __restrict__ rc_q,
                                           int32_t* __restrict__ numfilters,
                                           int32_t* __restrict__ bits, int B) {
  extern __shared__ float tile[];
  __shared__ int32_t tab[kTnsTableWords];
  acx_load_shared(tab, tables, kTnsTableWords);
  const int row0 = blockIdx.x * blockDim.x;
  const int rows = imin(static_cast<int>(blockDim.x), B - row0);
  acx_load_rows(tile, x, row0, rows, g.N);
  __syncthreads();
  const int t = threadIdx.x;
  if (t >= rows) return;
  const int s = row0 + t;
  int o[2], idx[2 * kTnsLags], nf, nb;
  float q[2 * kTnsLags];
  tns_filter_analysis_lane<ORDER, NSUB>(tile + t * ACX_ROW_STRIDE(g.N), bw_idx[s], tab, g, o, idx,
                                        q, &nf, &nb);
  order[2 * s] = o[0];
  order[2 * s + 1] = o[1];
#pragma unroll
  for (int k = 0; k < 2 * kTnsLags; ++k) {
    rc_idx[2 * kTnsLags * s + k] = idx[k];
    rc_q[2 * kTnsLags * s + k] = q[k];
  }
  numfilters[s] = nf;
  bits[s] = nb;
}

template <int ORDER, int NSUB>
static int launch(const void* x, const void* bw_idx, const void* tables, const TnsGeom& g,
                  void* order, void* rc_idx, void* rc_q, void* numfilters, void* bits, int B,
                  cudaStream_t stream) {
  auto kernel = tns_filter_analysis_kernel<ORDER, NSUB>;
  size_t smem = 0;
  const cudaError_t err = acx_row_tiles_smem(kernel, kTnsAnaThreads, g.N, &smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int blocks = (B + kTnsAnaThreads - 1) / kTnsAnaThreads;
  kernel<<<blocks, kTnsAnaThreads, smem, stream>>>(
      static_cast<const float*>(x), static_cast<const int32_t*>(bw_idx),
      static_cast<const int32_t*>(tables), g, static_cast<int32_t*>(order),
      static_cast<int32_t*>(rc_idx), static_cast<float*>(rc_q), static_cast<int32_t*>(numfilters),
      static_cast<int32_t*>(bits), B);
  return static_cast<int>(cudaGetLastError());
}

// max_order 8 with 3 subdivisions (10 ms frames) or 4 with 2 (shorter frames)
extern "C" int acx_tns_filter_analysis(const void* x, const void* bw_idx, const void* tables,
                                       void* order, void* rc_idx, void* rc_q, void* numfilters,
                                       void* bits, int B, int N, int startfreq0, int nf_max,
                                       int max_order, float max_pg, float inv_nsub,
                                       float c_alpha, float inv_span, void* stream) {
  const TnsGeom g = {N, startfreq0, nf_max, max_pg, inv_nsub, c_alpha, inv_span};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (max_order == 8) return launch<8, 3>(x, bw_idx, tables, g, order, rc_idx, rc_q, numfilters, bits, B, s);
  if (max_order == 4) return launch<4, 2>(x, bw_idx, tables, g, order, rc_idx, rc_q, numfilters, bits, B, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
#endif
