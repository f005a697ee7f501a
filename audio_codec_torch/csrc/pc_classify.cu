// pc_classify: the decoder's partial-concealment classifier with its peak
// detector.
//
// Replaces audio_codec_tpu/ops/pc.py:pc_classify (pc.py:114) with
// _peak_detector (pc.py:46, the hysteresis scan at :109). The port's tensor
// code ran the detector on every stream of every frame, and its hysteresis
// loop read the candidate columns back to the host (a device-to-host
// synchronisation on every decoded frame).
//
// Bound on an H100: on clean frames it reads the five [B] vectors (bfi,
// spec_inv_idx, stab_fac, pitch_present) and writes bfi': 40 KB at B = 2048,
// 0.000012 ms at 3.35 TB/s. A stream whose frame is partially corrupt (bfi 2)
// in the low region reads one of its two [400] rows: the peak detector is a
// chain of 400 multiply-adds and a scan over 395 candidates.
// Design: one thread per stream, branching per stream: it returns bfi unless
// bfi == 2 and the region is low, and then runs the peak detector or the two
// energy sums, as pitch_present says (pc_classify.cuh). Nothing goes back to
// the host.
#include "pc_classify.cuh"

using namespace acx;

#ifdef __CUDACC__
constexpr int kPcThreads = 128;

__global__ void pc_classify_kernel(const int32_t* __restrict__ bfi,
                                   const int32_t* __restrict__ spec_inv_idx,
                                   const float* __restrict__ stab_fac,
                                   const int32_t* __restrict__ pitch_present,
                                   const float* __restrict__ q_old_d,
                                   const float* __restrict__ q_old_res,
                                   int32_t* __restrict__ out, int B, int N, int frame_dms,
                                   float inv_n) {
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= B) return;
  const size_t row = static_cast<size_t>(b) * N;
  out[b] = pc_classify_lane(bfi[b], spec_inv_idx[b], stab_fac[b], pitch_present[b],
                            q_old_d + row, q_old_res + row, N, frame_dms, inv_n);
}

extern "C" int acx_pc_classify(const void* bfi, const void* spec_inv_idx, const void* stab_fac,
                               const void* pitch_present, const void* q_old_d,
                               const void* q_old_res, void* out, int B, int N, int frame_dms,
                               float inv_n, void* stream) {
  const int blocks = (B + kPcThreads - 1) / kPcThreads;
  pc_classify_kernel<<<blocks, kPcThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(bfi), static_cast<const int32_t*>(spec_inv_idx),
      static_cast<const float*>(stab_fac), static_cast<const int32_t*>(pitch_present),
      static_cast<const float*>(q_old_d), static_cast<const float*>(q_old_res),
      static_cast<int32_t*>(out), B, N, frame_dms, inv_n);
  return static_cast<int>(cudaGetLastError());
}
#endif
