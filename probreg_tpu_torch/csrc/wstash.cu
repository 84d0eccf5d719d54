// Row-weighted tile-culled BCPD E-step for Hopper (sm_90a), bound to Python
// with ctypes.
//
// Replaces probreg_tpu/ops/estep_pallas.py:_wstash_den_kernel (pass A) and
// :_wstash_moment_kernel (pass B), driven by bcpd_estep_culled. BCPD's
// posterior is p_ij = exp(rowlog_i - d2_ij / 2s2) / den_j with
// den_j = w/N + sum_i exp(rowlog_i - d2_ij / 2s2) (den == 0 -> eps): the CPD
// E-step of csrc/estep.cu (K3) with a per-source-row offset in the
// exponent. On Morton-sorted clouds; only the ACTIVE tile pairs are
// visited (compacted lists). A tile pair is culled when max_i rowlog_i -
// lb2 / 2s2 < -104 (the global row maximum, clamped at -104, and the tiles'
// box-gap bound lb2), so every exp in it underflows f32 to exactly 0 and
// culling changes no moment.
//
// Points arrive packed as float4 (x, y, z, |p|^2), d2 = max(|y|^2 + |x|^2 -
// 2 y.x, 0) as the reference computes it, IEEE f32 (expf, no fast-math).
//
// The TPU kernels form each pair's exp once and stash it between the
// passes. Here, as in K3, the stash (4 B per active pair written and read
// again, far beyond the 50 MB L2 at 10^5 points) cost more than the exp, so
// both passes form g with wgauss() and each pass is one launch for the
// whole E-step. Both are bound by the instruction rate of the FP32 pipe.
//
// Pass A: grid (column chunks of 256, target stripes). A thread holds two
// columns; the block walks the stripe's active source tiles in order and
// each tile's 256-row stages in order, sums each stage's g into a fresh
// partial and adds the partials to the column's normalizer from 0 (the
// order of the per-stripe kernel's stage partials), then forms inv_den and
// nu_d = den_raw / den.
//
// Pass B: grid (blocks of 64 rows, source tiles). The block walks its
// tile's active stripes in ascending order, a warp four source rows at a
// time, each lane four adjacent columns per step. p = g * inv_den; the
// row's moments of the caller's channel matrix V (C <= 8, N), its minimum
// d2 over active pairs and its sum of p * d2 (the residual-form sigma2
// numerator e1). Each stripe's lane partials are reduced across the warp
// and added to the row's totals in stripe order from 0 (inf for the
// minimum): no atomics, and the results are the same from run to run.
// Each column's data comes from shared memory once per four rows (one row
// per warp took 3.8x the bound on an H100: shared-memory loads and
// instruction throughput).

#include <cuda_runtime.h>

namespace {

__device__ __forceinline__ float sqd(float4 y, float4 x) {
  const float xy = y.x * x.x + y.y * x.y + y.z * x.z;
  return fmaxf(y.w + x.w - 2.0f * xy, 0.0f);
}

__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float warp_min(float v) {
  for (int o = 16; o > 0; o >>= 1)
    v = fminf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

constexpr int kDenThreads = 256;   // columns per pass-A block
constexpr int kColsPerThread = 2;  // columns t and t + 128 of the chunk
constexpr int kPairThreads = kDenThreads / kColsPerThread;
constexpr int kStage = 256;        // source rows per partial sum

// One pair's Gaussian with its row weight, exp(rowlog - d2 * inv2s2), the
// FMA spelled out so that both passes form the same g bit for bit.
__device__ __forceinline__ float wgauss(float rowlog, float d2,
                                        float inv2s2) {
  return expf(__fmaf_rn(-d2, inv2s2, rowlog));
}

__global__ void __launch_bounds__(kPairThreads)
wstash_den_kernel(const float4* __restrict__ ys,
                  const float* __restrict__ rowlog, int m, int tile_m,
                  int n_i, const float4* __restrict__ xs, int n, int tile_n,
                  const int* __restrict__ act_idx,   // (n_j, n_i)
                  const int* __restrict__ act_cnt,   // (n_j)
                  const float* __restrict__ scal,    // inv2s2, w / n, eps
                  float* __restrict__ inv_den,       // (n)
                  float* __restrict__ nud) {         // (n)
  __shared__ float4 ysh[kStage];
  __shared__ float rsh[kStage];
  const int stripe = blockIdx.y;
  const int c0 = stripe * tile_n;
  const int ncols = min(tile_n, n - c0);
  if ((int)blockIdx.x * kDenThreads >= ncols) return;
  int col[kColsPerThread];
  bool ok[kColsPerThread];
  float4 xv[kColsPerThread];
  float den[kColsPerThread];
#pragma unroll
  for (int k = 0; k < kColsPerThread; ++k) {
    col[k] = blockIdx.x * kDenThreads + k * kPairThreads + threadIdx.x;
    ok[k] = col[k] < ncols;
    xv[k] = ok[k] ? xs[c0 + col[k]] : make_float4(0.f, 0.f, 0.f, 0.f);
    den[k] = 0.0f;
  }
  const float inv2s2 = scal[0];
  const int cnt = act_cnt[stripe];
  const int* idx = act_idx + (size_t)stripe * n_i;
  for (int t = 0; t < cnt; ++t) {
    const int t0 = idx[t] * tile_m;
    const int t1 = min(t0 + tile_m, m);
    for (int r0 = t0; r0 < t1; r0 += kStage) {
      const int nr = min(kStage, t1 - r0);
      __syncthreads();
      for (int r = threadIdx.x; r < nr; r += kPairThreads) {
        ysh[r] = ys[r0 + r];
        rsh[r] = rowlog[r0 + r];
      }
      __syncthreads();
      float s[kColsPerThread] = {};
#pragma unroll 4
      for (int r = 0; r < nr; ++r) {
        const float4 y = ysh[r];
        const float rl = rsh[r];
#pragma unroll
        for (int k = 0; k < kColsPerThread; ++k)
          s[k] = __fadd_rn(s[k], wgauss(rl, sqd(y, xv[k]), inv2s2));
      }
#pragma unroll
      for (int k = 0; k < kColsPerThread; ++k)
        den[k] = __fadd_rn(den[k], s[k]);
    }
  }
#pragma unroll
  for (int k = 0; k < kColsPerThread; ++k) {
    if (!ok[k]) continue;
    float d = den[k] + scal[1];
    if (d == 0.0f) d = scal[2];
    inv_den[c0 + col[k]] = 1.0f / d;
    nud[c0 + col[k]] = den[k] / d;
  }
}

constexpr int kMomThreads = 256;
constexpr int kMomWarps = kMomThreads / 32;
constexpr int kRowsPerWarp = 4;  // rows a warp walks together
constexpr int kGroups = 2;       // row groups a warp takes in turn
constexpr int kMomRows = kMomWarps * kRowsPerWarp * kGroups;  // 64
constexpr int kMaxC = 8;         // channels of V
static_assert(kRowsPerWarp * kGroups <= 32, "a lane keeps each row's total");

// C, the number of channels, is a template parameter so that the channel
// loop is unrolled without predicates. A warp walks kRowsPerWarp rows at
// once, each lane four adjacent columns per step, so each column's point,
// 1/den and channels come from shared memory once for all the warp's rows
// (register blocking). The shared rows of 1/den and of the channels have a
// stride of the stripe's width rounded up to 4, so every float4 is
// aligned; the last (at most 3) columns of a ragged stripe take a scalar
// tail. Lane g * kRowsPerWarp + q keeps the totals of row q of group g.
template <int C>
__global__ void __launch_bounds__(kMomThreads)
wstash_moment_kernel(const float4* __restrict__ ys,
                     const float* __restrict__ rowlog, int m, int tile_m,
                     const float4* __restrict__ xs,
                     const float* __restrict__ vt,   // (C, n)
                     int n, int tile_n, int n_j,
                     const int* __restrict__ act_idx,   // (n_i, n_j)
                     const int* __restrict__ act_cnt,   // (n_i)
                     const float* __restrict__ scal,
                     const float* __restrict__ inv_den,  // (n)
                     float* __restrict__ mom,    // (m, kMaxC)
                     float* __restrict__ dmin,   // (m)
                     float* __restrict__ e1r) {  // (m)
  extern __shared__ float4 sm[];
  const int nc4 = (tile_n + 3) & ~3;                 // padded row stride
  float4* xw = sm;                                   // (nc4)
  float* iw = reinterpret_cast<float*>(xw + nc4);    // (nc4)
  float* vw = iw + nc4;                              // (C, nc4)
  const int tile = blockIdx.y;
  const int re = min((tile + 1) * tile_m, m);
  const int rb = tile * tile_m + blockIdx.x * kMomRows;
  if (rb >= re) return;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const float inv2s2 = scal[0];
  float tot[C], tot_e = 0.0f, tot_dm = __int_as_float(0x7f800000);  // +inf
#pragma unroll
  for (int k = 0; k < C; ++k) tot[k] = 0.0f;
  const int cnt = act_cnt[tile];
  const int* idx = act_idx + (size_t)tile * n_j;
  for (int s = 0; s < cnt; ++s) {
    const int c0 = idx[s] * tile_n;
    const int ncols = min(tile_n, n - c0);
    __syncthreads();
    for (int c = threadIdx.x; c < ncols; c += kMomThreads) {
      xw[c] = xs[c0 + c];
      iw[c] = inv_den[c0 + c];
#pragma unroll
      for (int k = 0; k < C; ++k) vw[k * nc4 + c] = vt[(size_t)k * n + c0 + c];
    }
    __syncthreads();
    const int n4 = ncols & ~3;  // columns in whole groups of four
#pragma unroll 1
    for (int g = 0; g < kGroups; ++g) {
      const int r0 = rb + (g * kMomWarps + warp) * kRowsPerWarp;
      float4 y[kRowsPerWarp];
      float rl[kRowsPerWarp], a[kRowsPerWarp][C], e[kRowsPerWarp],
          dm[kRowsPerWarp];
#pragma unroll
      for (int q = 0; q < kRowsPerWarp; ++q) {
        // Rows past the end re-read a valid row and are never written.
        const int r = min(r0 + q, re - 1);
        y[q] = ys[r];
        rl[q] = rowlog[r];
        e[q] = 0.0f;
        dm[q] = __int_as_float(0x7f800000);
#pragma unroll
        for (int k = 0; k < C; ++k) a[q][k] = 0.0f;
      }
      for (int c = lane * 4; c < n4; c += 128) {
        const float4 iv = *reinterpret_cast<const float4*>(iw + c);
        float4 v[C];
#pragma unroll
        for (int k = 0; k < C; ++k)
          v[k] = *reinterpret_cast<const float4*>(vw + k * nc4 + c);
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const float4 x = xw[c + j];
          const float ivj = j == 0 ? iv.x : j == 1 ? iv.y : j == 2 ? iv.z : iv.w;
#pragma unroll
          for (int q = 0; q < kRowsPerWarp; ++q) {
            const float d2 = sqd(y[q], x);
            const float p = wgauss(rl[q], d2, inv2s2) * ivj;
            dm[q] = fminf(dm[q], d2);
            e[q] = __fmaf_rn(p, d2, e[q]);
#pragma unroll
            for (int k = 0; k < C; ++k) {
              const float vk = j == 0 ? v[k].x : j == 1 ? v[k].y
                             : j == 2 ? v[k].z : v[k].w;
              a[q][k] = __fmaf_rn(p, vk, a[q][k]);
            }
          }
        }
      }
      for (int c = n4 + lane; c < ncols; c += 32) {  // the ragged tail
        const float4 x = xw[c];
        const float ivc = iw[c];
#pragma unroll
        for (int q = 0; q < kRowsPerWarp; ++q) {
          const float d2 = sqd(y[q], x);
          const float p = wgauss(rl[q], d2, inv2s2) * ivc;
          dm[q] = fminf(dm[q], d2);
          e[q] = __fmaf_rn(p, d2, e[q]);
#pragma unroll
          for (int k = 0; k < C; ++k)
            a[q][k] = __fmaf_rn(p, vw[k * nc4 + c], a[q][k]);
        }
      }
#pragma unroll
      for (int q = 0; q < kRowsPerWarp; ++q) {
        const bool mine = lane == g * kRowsPerWarp + q;
#pragma unroll
        for (int k = 0; k < C; ++k) {
          const float v = warp_sum(a[q][k]);
          if (mine) tot[k] += v;
        }
        const float ev = warp_sum(e[q]), dv = warp_min(dm[q]);
        if (mine) {
          tot_e += ev;
          tot_dm = fminf(tot_dm, dv);
        }
      }
    }
  }
  if (lane < kRowsPerWarp * kGroups) {
    const int g = lane / kRowsPerWarp, q = lane % kRowsPerWarp;
    const int r = rb + (g * kMomWarps + warp) * kRowsPerWarp + q;
    if (r < re) {
      float* mo = mom + (size_t)r * kMaxC;
#pragma unroll
      for (int k = 0; k < C; ++k) mo[k] = tot[k];
      dmin[r] = tot_dm;
      e1r[r] = tot_e;
    }
  }
}

template <int C>
int launch_moment(const void* ys, const void* rowlog, int m, int tile_m,
                  int n_i, const void* xs, const void* vt, int n, int tile_n,
                  int n_j, const void* act_idx, const void* act_cnt,
                  const void* scal, const void* inv_den, void* mom,
                  void* dmin, void* e1r, void* stream) {
  const int smem = ((tile_n + 3) & ~3) * (16 + 4 + 4 * C);
  cudaError_t err = cudaFuncSetAttribute(
      wstash_moment_kernel<C>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((tile_m + kMomRows - 1) / kMomRows, n_i);
  wstash_moment_kernel<C><<<grid, kMomThreads, smem, (cudaStream_t)stream>>>(
      (const float4*)ys, (const float*)rowlog, m, tile_m, (const float4*)xs,
      (const float*)vt, n, tile_n, n_j, (const int*)act_idx,
      (const int*)act_cnt, (const float*)scal, (const float*)inv_den,
      (float*)mom, (float*)dmin, (float*)e1r);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

int probreg_wstash_den(const void* ys, const void* rowlog, int m, int tile_m,
                       int n_i, const void* xs, int n, int tile_n, int n_j,
                       const void* act_idx, const void* act_cnt,
                       const void* scal, void* inv_den, void* nud,
                       void* stream) {
  const dim3 grid((tile_n + kDenThreads - 1) / kDenThreads, n_j);
  wstash_den_kernel<<<grid, kPairThreads, 0, (cudaStream_t)stream>>>(
      (const float4*)ys, (const float*)rowlog, m, tile_m, n_i,
      (const float4*)xs, n, tile_n, (const int*)act_idx, (const int*)act_cnt,
      (const float*)scal, (float*)inv_den, (float*)nud);
  return (int)cudaGetLastError();
}

int probreg_wstash_moment(const void* ys, const void* rowlog, int m,
                          int tile_m, int n_i, const void* xs, const void* vt,
                          int c_cnt, int n, int tile_n, int n_j,
                          const void* act_idx, const void* act_cnt,
                          const void* scal, const void* inv_den, void* mom,
                          void* dmin, void* e1r, void* stream) {
#define PROBREG_MOMENT(C)                                                   \
  case C:                                                                   \
    return launch_moment<C>(ys, rowlog, m, tile_m, n_i, xs, vt, n, tile_n,  \
                            n_j, act_idx, act_cnt, scal, inv_den, mom,      \
                            dmin, e1r, stream);
  switch (c_cnt) {
    PROBREG_MOMENT(1) PROBREG_MOMENT(2) PROBREG_MOMENT(3) PROBREG_MOMENT(4)
    PROBREG_MOMENT(5) PROBREG_MOMENT(6) PROBREG_MOMENT(7) PROBREG_MOMENT(8)
    default:
      return (int)cudaErrorInvalidValue;
  }
#undef PROBREG_MOMENT
}

}  // extern "C"
