// ltpf_encode: the encoder's LTPF pitch refinement and activation decision.
//
// Replaces audio_codec_tpu/ops/analysis.py:ltpf_encode (analysis.py:163,
// with _ltpf_interp_matrix at :146): a [B, 205, 128] gather and two products
// over all 205 lags, of which only the 17 around the open-loop pitch are
// read, then about 80 [B]-wide ops for the searches, the interpolated
// normalised correlation and the activation rules.
//
// Bound on an H100: reads the frame (129 samples), the 232-sample memory and
// six scalars, writes the memory again and ten scalars: about 2.9 KB a
// stream, 6.0 MB at B = 2048, 0.0018 ms at 3.35 TB/s. The work is 17 lags x
// 128 samples x 2 multiply-adds, the energy, <= 7 x 17 interpolation taps and
// 128 x 3 normcorr products a stream, about 11 M operations at B = 2048.
// Design: one warp per stream, the row (memory and frame) in shared memory.
// Lane i < 17 sums window entry i (the correlation and energy chains over the
// 128 samples, in the plain version's order, ltpf_encode.cuh); lane 0 runs
// the searches on the 17 values; the lanes filter the samples of the
// normcorr in parallel, and lanes 0-2 each run one of its three chains, which
// the plain version's order keeps sequential; lane 0 decides.
#include "ltpf_encode.cuh"

using namespace acx;

#ifdef __CUDACC__
constexpr int kLtpfWarps = 4;

__global__ void ltpf_encode_kernel(const float* __restrict__ s12k8,
                                   const int32_t* __restrict__ pitch_ol,
                                   const float* __restrict__ nc_ol,
                                   const float* __restrict__ mem_in,
                                   const float* __restrict__ mem_nc,
                                   const float* __restrict__ mem_mem_nc,
                                   const int32_t* __restrict__ mem_on,
                                   const float* __restrict__ mem_pitch,
                                   const float* __restrict__ tables, int32_t* __restrict__ param,
                                   int32_t* __restrict__ bits, float* __restrict__ new_mem_in,
                                   float* __restrict__ nc_out, float* __restrict__ mem_mem_out,
                                   int32_t* __restrict__ on_out, float* __restrict__ pitch_out,
                                   int B, LtpfGeom g) {
  __shared__ float tab[kLtpfTableWords];
  __shared__ float rows[kLtpfWarps][kLtpfMaxRow];
  __shared__ float cors[kLtpfWarps][kLtpfWin];
  __shared__ float cfs[kLtpfWarps][kLtpfMaxAcf];
  __shared__ float pfs[kLtpfWarps][kLtpfMaxAcf];
  __shared__ float sums[kLtpfWarps][3];
  __shared__ LtpfPitch pitches[kLtpfWarps];
  for (int i = threadIdx.x; i < kLtpfTableWords; i += blockDim.x) tab[i] = tables[i];
  __syncthreads();
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int b = blockIdx.x * kLtpfWarps + warp;
  if (b >= B) return;   // the whole warp leaves together
  float* buf = rows[warp];
  const float* mi = mem_in + static_cast<size_t>(b) * g.mem_len;
  const float* s = s12k8 + static_cast<size_t>(b) * g.xlen;
  for (int i = lane; i < g.mem_len; i += 32) buf[i] = mi[i];
  for (int i = lane; i < g.xlen; i += 32) buf[g.mem_len + i] = s[i];
  __syncwarp();
  for (int i = lane; i < g.mem_len; i += 32) {
    new_mem_in[static_cast<size_t>(b) * g.mem_len + i] = buf[g.N + i];
  }
  const int pol = pitch_ol[b];
  if (lane < kLtpfWin) {
    cors[warp][lane] = ltpf_window_nc(buf, g, pol, lane, ltpf_energy(buf, g));
  }
  __syncwarp();
  if (lane == 0) pitches[warp] = ltpf_pitch_search(cors[warp], pol, tab);
  __syncwarp();
  const LtpfPitch p = pitches[warp];
  for (int j = lane; j < g.acflen; j += 32) {
    ltpf_filtered(buf, g, tab + kLtpfInterTaps, p, j, &cfs[warp][j], &pfs[warp][j]);
  }
  __syncwarp();
  if (lane == 0) sums[warp][0] = ltpf_chain(cfs[warp], pfs[warp], g.acflen);
  if (lane == 1) sums[warp][1] = ltpf_chain(cfs[warp], cfs[warp], g.acflen);
  if (lane == 2) sums[warp][2] = ltpf_chain(pfs[warp], pfs[warp], g.acflen);
  __syncwarp();
  if (lane == 0) {
    const LtpfOut o = ltpf_decide(sums[warp][0], sums[warp][1], sums[warp][2], p, nc_ol[b],
                                  mem_nc[b], mem_mem_nc[b], mem_on[b], mem_pitch[b], g);
    param[3 * static_cast<size_t>(b)] = o.param[0];
    param[3 * static_cast<size_t>(b) + 1] = o.param[1];
    param[3 * static_cast<size_t>(b) + 2] = o.param[2];
    bits[b] = o.bits;
    nc_out[b] = o.nc;
    mem_mem_out[b] = o.mem_mem_nc;
    on_out[b] = o.on;
    pitch_out[b] = o.pitch;
  }
}

extern "C" int acx_ltpf_encode(const void* s12k8, const void* pitch_ol, const void* nc_ol,
                               const void* mem_in, const void* mem_nc, const void* mem_mem_nc,
                               const void* mem_on, const void* mem_pitch, const void* tables,
                               void* param, void* bits, void* new_mem_in, void* nc_out,
                               void* mem_mem_out, void* on_out, void* pitch_out, int B, int xlen,
                               int N, int mem_len, int acflen, int xbase, int frame_dms,
                               int enable, void* stream) {
  const LtpfGeom g = {xlen, N, mem_len, acflen, xbase, frame_dms, enable};
  if (ltpf_row_len(g) > kLtpfMaxRow || acflen > kLtpfMaxAcf || acflen < 1 ||
      xbase - kLtpfLag0 - (kLtpfLags - 1) < 0 || xbase + acflen >= ltpf_row_len(g) ||
      N + mem_len > ltpf_row_len(g)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int blocks = (B + kLtpfWarps - 1) / kLtpfWarps;
  ltpf_encode_kernel<<<blocks, 32 * kLtpfWarps, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(s12k8), static_cast<const int32_t*>(pitch_ol),
      static_cast<const float*>(nc_ol), static_cast<const float*>(mem_in),
      static_cast<const float*>(mem_nc), static_cast<const float*>(mem_mem_nc),
      static_cast<const int32_t*>(mem_on), static_cast<const float*>(mem_pitch),
      static_cast<const float*>(tables), static_cast<int32_t*>(param),
      static_cast<int32_t*>(bits), static_cast<float*>(new_mem_in), static_cast<float*>(nc_out),
      static_cast<float*>(mem_mem_out), static_cast<int32_t*>(on_out),
      static_cast<float*>(pitch_out), B, g);
  return static_cast<int>(cudaGetLastError());
}
#endif
