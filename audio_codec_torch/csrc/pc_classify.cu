// pc_classify: the decoder's partial-concealment classifier with its peak
// detector, and the concealment's stability factor fused into it (K15).
//
// Replaces audio_codec_tpu/ops/pc.py:compute_stab_fac (pc.py:27) and
// pc_classify (pc.py:114) with _peak_detector (pc.py:46, the hysteresis scan
// at :109). The port ran the stability factor as about fifteen torch
// launches a frame, cast and copied the classifier's vectors on every frame,
// and ran the detector a thread a stream.
//
// Bound on an H100: on clean frames it reads the five [B] vectors and writes
// bfi' and the stability factor: 40 KB at B = 2048, 0.000012 ms at 3.35
// TB/s; a frame lost after a good one or partially corrupt (bfi 2) also
// reads two [16] scale-factor rows, and a stable bfi 2 frame in the low
// region one [400] row.
// Design: a stream a lane, one warp a block (pc_classify.cuh:
// pc_classify_warp): the clean frames end after their vectors; the streams
// that need a row are found by a ballot and taken kPcGroup at a time, their
// rows staged by cp.async, their energy chains a lane each at once, the
// detector on the whole warp a stream at a time. The per-stream vectors come
// as the decoder holds them (plc.cuh:StreamVec): no cast, copy or stack.
#include "pc_classify.cuh"

using namespace acx;

__global__ void __launch_bounds__(32) pc_classify_kernel(PcArgs p) {
  __shared__ __align__(16) float stage[kPcGroup * kPcStride];
  pc_classify_warp(CoderCardWarp{static_cast<int>(threadIdx.x)}, p, blockIdx.x * 32, stage);
}

// vecs, meta: the five per-stream vectors (kPcBfi .. kPcPrevPrev) and their
// (stride, element type) pairs (kernels.py:_stream_vecs)
extern "C" int acx_pc_classify(const void* const* vecs, const int* meta, const void* q_old_d,
                               const void* q_old_res, const void* scf_q, const void* old_scf,
                               const void* old_old_scf, void* bfi_out, void* stab_out, int B,
                               int N, int frame_dms, float inv_n, void* stream) {
  PcArgs p{};
  for (int k = 0; k < kPcVecs; ++k) p.vec[k] = {vecs[k], meta[2 * k], meta[2 * k + 1]};
  p.q_old_d = static_cast<const float*>(q_old_d);
  p.q_old_res = static_cast<const float*>(q_old_res);
  p.scf_q = static_cast<const float*>(scf_q);
  p.old_scf = static_cast<const float*>(old_scf);
  p.old_old_scf = static_cast<const float*>(old_old_scf);
  p.B = B;
  p.N = N;
  p.frame_dms = frame_dms;
  p.inv_n = inv_n;
  p.bfi_out = static_cast<int32_t*>(bfi_out);
  p.stab_out = static_cast<float*>(stab_out);
  pc_classify_kernel<<<(B + 31) / 32, 32, 0, static_cast<cudaStream_t>(stream)>>>(p);
  return static_cast<int>(cudaGetLastError());
}
