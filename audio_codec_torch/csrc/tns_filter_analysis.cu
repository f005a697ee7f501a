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
// Design: a warp a stream (tns_analysis.cuh:tns_filter_analysis_warp). Each
// (subdivision, lag) chain of a filter is independent, so a lane runs one of
// them for filter 0 and, interleaved, the same one for filter 1: at most
// about 130 dependent multiply-adds a lane; the lane then divides its two
// sums by their subdivision's energy. Shuffles gather the quotients onto
// lanes 0 and 1, which sum them and run the two filters' recursions side by
// side. (The 54 divisions on lanes 0 and 1 instead measured 0.0159 against
// 0.0110 ms at 2048 streams on an H100: tools/torch_tns_times.py
// --analysis-variants.) Eight streams a block (256 blocks at 2048 streams,
// all resident in one wave); each warp stages its row in shared memory with
// coalesced loads, only the bins below its bandwidth's cutoff, and the
// tables once a block. A filter's weighting and quantizer run only where its
// gain turns TNS on: the outputs of a filter that is off are masked.
#include "tns_analysis.cuh"

using namespace acx;

#ifdef __CUDACC__
constexpr int kTnsAnaWarps = 8;   // streams a block

template <int ORDER, int NSUB>
__global__ void __launch_bounds__(kTnsAnaWarps * 32)
    tns_filter_analysis_kernel(const float* __restrict__ x, const int32_t* __restrict__ bw_idx,
                               const int32_t* __restrict__ tables, TnsGeom g,
                               int32_t* __restrict__ order, int32_t* __restrict__ rc_idx,
                               float* __restrict__ rc_q, int32_t* __restrict__ numfilters,
                               int32_t* __restrict__ bits, int B) {
  extern __shared__ float rows[];
  __shared__ int32_t tab[kTnsTableWords];
  acx_load_shared(tab, tables, kTnsTableWords);
  __syncthreads();
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int s = blockIdx.x * kTnsAnaWarps + warp;
  if (s >= B) return;   // the whole warp leaves together
  float* row = rows + static_cast<size_t>(warp) * g.N;
  const float* src = x + static_cast<size_t>(s) * g.N;
  const int bw = bw_idx[s];
  const int n = tns_row_bins(bw, tab, g);
  for (int i = lane; i < n; i += 32) row[i] = src[i];
  __syncwarp();
  tns_filter_analysis_warp<ORDER, NSUB>(CoderCardWarp{lane}, row, bw, tab, g, order + 2 * s,
                                        rc_idx + 2 * kTnsLags * s, rc_q + 2 * kTnsLags * s,
                                        numfilters + s, bits + s, nullptr);
}

template <int ORDER, int NSUB>
static int launch(const void* x, const void* bw_idx, const void* tables, const TnsGeom& g,
                  void* order, void* rc_idx, void* rc_q, void* numfilters, void* bits, int B,
                  cudaStream_t stream) {
  if (B == 0) return static_cast<int>(cudaSuccess);
  const size_t smem = static_cast<size_t>(kTnsAnaWarps) * g.N * sizeof(float);
  if (smem > 48 * 1024) return static_cast<int>(cudaErrorInvalidValue);
  const int blocks = (B + kTnsAnaWarps - 1) / kTnsAnaWarps;
  tns_filter_analysis_kernel<ORDER, NSUB><<<blocks, kTnsAnaWarps * 32, smem, stream>>>(
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
