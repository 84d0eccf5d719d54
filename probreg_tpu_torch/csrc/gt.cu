// Tile-culled exact Gauss transform for Hopper (sm_90a), bound with ctypes.
//
// Replaces probreg_tpu/ops/estep_pallas.py:_gt_kernel (behind
// gauss_transform_culled):
//
//   out[i, c] = sum_j exp(-|q_i - p_j|^2 * inv_h2) * w[j, c]
//
// for up to 8 channels and 2 <= D <= 8 (padded here to DP = 4 or 8 and
// CP = 4 or 8 with zeros, which change no distance and no sum). FilterReg's
// E-step moments are this shape: queries are the transformed source, points
// the target, channels [1, x, |x|^2, normals].
//
// There is no normalizer, so one pass suffices and nothing crosses blocks:
// block i owns query tile i (256 rows, one per thread, its <= 8 sums in
// registers) and walks that tile's compacted list of active point tiles,
// staging 256 points and their weights at a time in shared memory; each
// stage is summed apart and then added to the row's totals. No float
// atomics: the result is bitwise the same from run to run. A query tile
// whose list is empty writes exact zeros.
//
// Bound: operations. Per pair the kernel does the Gaussian (D differences
// and FMAs, a scale and expf) and C FMAs; its device-memory traffic is
// reading the clouds once per active tile pair from L2 and writing N x C
// floats. Shared-memory reads are broadcasts (every thread of a block reads
// the same point), vectorised as float4.
//
// d2 is taken from differences of clouds centred on their shared centroid
// (the wrapper centres), IEEE f32, expf, no fast-math.

#include <cuda_runtime.h>

namespace {

constexpr int kRows = 256;   // query rows per block (ops/gt_cuda.py _ROWS)
constexpr int kStage = 256;  // points staged in shared memory at a time

template <int DP, int CP>
__global__ void __launch_bounds__(kRows)
gt_kernel(const float* __restrict__ qs, int nq,     // (nq, DP)
          const float* __restrict__ ps,             // (m, DP)
          const float* __restrict__ w, int m,       // (m, CP)
          const int* __restrict__ act_idx,          // (n_q_tiles, n_p_tiles)
          const int* __restrict__ act_cnt,          // (n_q_tiles,)
          int tile, int n_p_tiles, float inv_h2,
          float* __restrict__ out) {                // (nq, CP)
  constexpr int D4 = DP / 4, C4 = CP / 4;
  __shared__ float4 sp[kStage * D4];
  __shared__ float4 sw[kStage * C4];

  const int qt = blockIdx.x, tid = threadIdx.x;
  const int row = qt * kRows + tid;
  const bool ok = row < nq;
  float q[DP];
#pragma unroll
  for (int d = 0; d < DP; ++d) q[d] = ok ? qs[(size_t)row * DP + d] : 0.0f;
  float acc[CP];
#pragma unroll
  for (int c = 0; c < CP; ++c) acc[c] = 0.0f;

  const int cnt = act_cnt[qt];
  const int* list = act_idx + (size_t)qt * n_p_tiles;
  for (int a = 0; a < cnt; ++a) {
    const int p0 = list[a] * tile;
    const int p1 = min(p0 + tile, m);
    for (int s0 = p0; s0 < p1; s0 += kStage) {
      const int ns = min(kStage, p1 - s0);
      __syncthreads();  // the previous stage is consumed
      if (tid < ns) {
        const float4* pv =
            reinterpret_cast<const float4*>(ps + (size_t)(s0 + tid) * DP);
        const float4* wv =
            reinterpret_cast<const float4*>(w + (size_t)(s0 + tid) * CP);
#pragma unroll
        for (int k = 0; k < D4; ++k) sp[tid * D4 + k] = pv[k];
#pragma unroll
        for (int k = 0; k < C4; ++k) sw[tid * C4 + k] = wv[k];
      }
      __syncthreads();
      // The stage's sum first, then into the row's total: a row adds up
      // to 150k terms, and one running f32 sum loses ~sqrt(N) eps of it.
      float part[CP];
#pragma unroll
      for (int c = 0; c < CP; ++c) part[c] = 0.0f;
      for (int j = 0; j < ns; ++j) {
        float d2 = 0.0f;
#pragma unroll
        for (int k = 0; k < D4; ++k) {
          const float4 p = sp[j * D4 + k];
          const float dx = q[4 * k] - p.x, dy = q[4 * k + 1] - p.y;
          const float dz = q[4 * k + 2] - p.z, dw = q[4 * k + 3] - p.w;
          d2 = fmaf(dx, dx, d2);
          d2 = fmaf(dy, dy, d2);
          d2 = fmaf(dz, dz, d2);
          d2 = fmaf(dw, dw, d2);
        }
        const float g = expf(-d2 * inv_h2);
#pragma unroll
        for (int k = 0; k < C4; ++k) {
          const float4 wk = sw[j * C4 + k];
          part[4 * k] = fmaf(g, wk.x, part[4 * k]);
          part[4 * k + 1] = fmaf(g, wk.y, part[4 * k + 1]);
          part[4 * k + 2] = fmaf(g, wk.z, part[4 * k + 2]);
          part[4 * k + 3] = fmaf(g, wk.w, part[4 * k + 3]);
        }
      }
#pragma unroll
      for (int c = 0; c < CP; ++c) acc[c] += part[c];
    }
  }
  if (ok) {
#pragma unroll
    for (int c = 0; c < CP; ++c) out[(size_t)row * CP + c] = acc[c];
  }
}

template <int DP, int CP>
cudaError_t launch(const float* qs, int nq, const float* ps, const float* w,
                   int m, const int* act_idx, const int* act_cnt, int tile,
                   float inv_h2, float* out, cudaStream_t stream) {
  const int n_q_tiles = (nq + kRows - 1) / kRows;
  const int n_p_tiles = (m + tile - 1) / tile;
  gt_kernel<DP, CP><<<n_q_tiles, kRows, 0, stream>>>(
      qs, nq, ps, w, m, act_idx, act_cnt, tile, n_p_tiles, inv_h2, out);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// qs (nq, dp), ps (m, dp), w (m, cp) f32 row-major with dp, cp in {4, 8};
// act_idx (ceil(nq / 256), ceil(m / tile)) int32, row i listing query tile
// i's active point tiles first; act_cnt their counts; out (nq, cp).
int probreg_gauss_transform(const void* qs, int nq, const void* ps,
                            const void* w, int m, int dp, int cp,
                            const void* act_idx, const void* act_cnt,
                            int tile, float inv_h2, void* out, void* stream) {
  if (nq <= 0 || m <= 0 || tile <= 0) return (int)cudaErrorInvalidValue;
  auto s = (cudaStream_t)stream;
  auto q = (const float*)qs;
  auto p = (const float*)ps;
  auto wt = (const float*)w;
  auto idx = (const int*)act_idx;
  auto cnt = (const int*)act_cnt;
  auto o = (float*)out;
  cudaError_t err;
  if (dp == 4 && cp == 4)
    err = launch<4, 4>(q, nq, p, wt, m, idx, cnt, tile, inv_h2, o, s);
  else if (dp == 4 && cp == 8)
    err = launch<4, 8>(q, nq, p, wt, m, idx, cnt, tile, inv_h2, o, s);
  else if (dp == 8 && cp == 4)
    err = launch<8, 4>(q, nq, p, wt, m, idx, cnt, tile, inv_h2, o, s);
  else if (dp == 8 && cp == 8)
    err = launch<8, 8>(q, nq, p, wt, m, idx, cnt, tile, inv_h2, o, s);
  else
    err = cudaErrorInvalidValue;
  return (int)err;
}

}  // extern "C"
