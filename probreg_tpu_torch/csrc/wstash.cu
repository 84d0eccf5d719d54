// Row-weighted tile-culled BCPD E-step for Hopper (sm_90a), bound to Python
// with ctypes.
//
// Replaces probreg_tpu/ops/estep_pallas.py:_wstash_den_kernel (pass A) and
// :_wstash_moment_kernel (pass B), driven by bcpd_estep_culled. BCPD's
// posterior is p_ij = exp(rowlog_i - d2_ij / 2s2) / den_j with
// den_j = w/N + sum_i exp(rowlog_i - d2_ij / 2s2) (den == 0 -> eps): the CPD
// stash E-step of csrc/estep.cu (K3) with a per-source-row offset in the
// exponent. One target stripe of tile_n columns per launch of each pass, on
// Morton-sorted clouds; only the ACTIVE source tiles of the stripe are
// visited (compacted list act_idx[0..cnt)). A tile pair is culled when
// max_i rowlog_i - lb2 / 2s2 < -104 (the global row maximum, clamped at
// -104, and the tiles' box-gap bound lb2), so every exp in it underflows f32
// to exactly 0 and culling changes no moment.
//
// Points arrive packed as float4 (x, y, z, |p|^2), d2 = max(|y|^2 + |x|^2 -
// 2 y.x, 0) as the reference computes it, IEEE f32 (expf, no fast-math).
//
// Pass A: one thread per column, one block per 256-row stage of an active
// tile. Each pair's exp is computed once, written to the stash and summed;
// every stage's column sum is a separate partial, and the last block of a
// column chunk (atomic ticket) adds the partials in stage order and forms
// inv_den and nu_d = den_raw / den. Bound: the stash write, 4 B per active
// pair, far beyond the 50 MB L2 at 10^5 points.
//
// Pass B: a warp per four source rows, each lane four adjacent columns per
// step (coalesced float4 stash reads). p = g * inv_den; the row's moments of the
// caller's channel matrix V (C <= 8, N), and, with d2 recomputed from the
// points (no exp), the row's minimum d2 over active pairs and its sum of
// p * d2 (the residual-form sigma2 numerator e1). Each row is written by one
// lane per launch and stripes accumulate in launch order: no atomics, so the
// results are the same from run to run. Bound: the stash read, 4 B per
// active pair; each column's data comes from shared memory once per four
// rows (one row per warp took 3.8x the bound on an H100: shared-memory
// loads and instruction throughput, 40 B and ~25 instructions per pair).

#include <cuda_runtime.h>

namespace {

constexpr float kEpsF32 = 1.1920928955078125e-07f;  // np.finfo(f32).eps

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

// True in every thread of the block that finishes last among `expected`
// blocks sharing `ticket` (threadfence-reduction pattern; the last block
// reads the others' partials back with __ldcg).
__device__ bool last_block(unsigned int* ticket, unsigned int expected) {
  __shared__ bool is_last;
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0)
    is_last = atomicAdd(ticket, 1u) == expected - 1u;
  __syncthreads();
  if (is_last) __threadfence();
  return is_last;
}

constexpr int kDenThreads = 256;  // columns per block
constexpr int kStage = 256;       // source rows per block (one stage)

__global__ void __launch_bounds__(kDenThreads)
wstash_den_kernel(const float4* __restrict__ ys,
                  const float* __restrict__ rowlog, int m, int tile_m,
                  int stages,   // stages per tile: ceil(tile_m / kStage)
                  const float4* __restrict__ xs, int ncols, int tile_n,
                  const int* __restrict__ act_idx,
                  const int* __restrict__ act_cnt,
                  const float* __restrict__ scal,  // inv2s2, w / n, eps
                  float* __restrict__ stash,     // (n_i * tile_m, tile_n)
                  float* __restrict__ part,      // (n_i * stages, tile_n)
                  unsigned int* __restrict__ tickets,  // (gridDim.x), zero
                  float* __restrict__ inv_den,   // (tile_n)
                  float* __restrict__ nud) {     // (ncols), this stripe
  __shared__ float4 ysh[kStage];
  __shared__ float rsh[kStage];
  const int cnt = *act_cnt;
  const int slot = blockIdx.y / stages, stage = blockIdx.y % stages;
  // An all-culled stripe still needs its nu_d = 0: block 0 finalizes.
  const int expected = cnt > 0 ? cnt * stages : 1;
  if ((int)blockIdx.y >= expected) return;
  const int col = blockIdx.x * kDenThreads + threadIdx.x;
  const bool ok = col < ncols;
  const float4 xv = ok ? xs[col] : make_float4(0.f, 0.f, 0.f, 0.f);

  if (slot < cnt) {
    const float inv2s2 = scal[0];
    const int t0 = act_idx[slot] * tile_m;
    const int r0 = t0 + stage * kStage;
    const int nr = max(min(min(r0 + kStage, t0 + tile_m), m) - r0, 0);
    if (threadIdx.x < nr) {
      ysh[threadIdx.x] = ys[r0 + threadIdx.x];
      rsh[threadIdx.x] = rowlog[r0 + threadIdx.x];
    }
    __syncthreads();
    if (ok) {
      float* out = stash + (size_t)r0 * tile_n + col;
      float s = 0.0f;
      for (int r = 0; r < nr; ++r) {
        const float g = expf(rsh[r] - sqd(ysh[r], xv) * inv2s2);
        out[(size_t)r * tile_n] = g;
        s += g;
      }
      part[(size_t)blockIdx.y * tile_n + col] = s;
    }
  }

  if (!last_block(&tickets[blockIdx.x], expected)) return;
  if (ok) {
    float den_raw = 0.0f;
    for (int k = 0; k < cnt * stages; ++k)
      den_raw += __ldcg(&part[(size_t)k * tile_n + col]);
    float den = den_raw + scal[1];
    if (den == 0.0f) den = scal[2];
    inv_den[col] = 1.0f / den;
    nud[col] = den_raw / den;
  }
  if (threadIdx.x == 0) tickets[blockIdx.x] = 0u;  // ready for the next stripe
}

constexpr int kMomThreads = 256;
constexpr int kMomWarps = kMomThreads / 32;
constexpr int kMomRows = 64;     // rows per block
constexpr int kRowsPerWarp = 4;  // rows a warp walks together
constexpr int kMaxC = 8;         // channels of V

// C, the number of channels, is a template parameter so that the channel
// loop is unrolled without predicates. A warp walks kRowsPerWarp rows at
// once, each lane four adjacent columns per step: the stash is read as
// float4 (512 B per warp and row in flight instead of 128 B), and each
// column's point, 1/den and channels come from shared memory once for all
// the warp's rows (register blocking). The shared rows of 1/den and of the
// channels have a stride of ncols rounded up to 4, so every float4 is
// aligned; the last (at most 3) columns of a ragged stripe take a scalar
// tail.
template <int C>
__global__ void __launch_bounds__(kMomThreads)
wstash_moment_kernel(const float4* __restrict__ ys,
                     const float4* __restrict__ xs,  // this stripe
                     const float* __restrict__ vt,   // (C, n_total), stripe
                     int n_total, int ncols, int tile_n, int m, int tile_m,
                     const int* __restrict__ act_idx,
                     const int* __restrict__ act_cnt,
                     const float* __restrict__ stash,
                     const float* __restrict__ inv_den,
                     float* __restrict__ mom,    // (m, kMaxC) accumulators
                     float* __restrict__ dmin,   // (m) running minima
                     float* __restrict__ e1r) {  // (m) running p * d2 sums
  extern __shared__ float4 sm[];
  const int nc4 = (ncols + 3) & ~3;                  // padded row stride
  float4* xw = sm;                                   // (nc4)
  float* iw = reinterpret_cast<float*>(xw + nc4);    // (nc4)
  float* vw = iw + nc4;                              // (C, nc4)
  const int slot = blockIdx.y;
  if (slot >= *act_cnt) return;
  const int t0 = act_idx[slot] * tile_m;
  const int rb = t0 + blockIdx.x * kMomRows;
  const int re = min(min(rb + kMomRows, t0 + tile_m), m);
  if (rb >= re) return;
  for (int c = threadIdx.x; c < ncols; c += kMomThreads) {
    xw[c] = xs[c];
    iw[c] = inv_den[c];
#pragma unroll
    for (int k = 0; k < C; ++k) vw[k * nc4 + c] = vt[(size_t)k * n_total + c];
  }
  __syncthreads();
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int n4 = ncols & ~3;  // columns in whole groups of four
  for (int r0 = rb + warp * kRowsPerWarp; r0 < re;
       r0 += kMomWarps * kRowsPerWarp) {
    float4 y[kRowsPerWarp];
    const float* row[kRowsPerWarp];
    float a[kRowsPerWarp][C], e[kRowsPerWarp], dm[kRowsPerWarp];
#pragma unroll
    for (int q = 0; q < kRowsPerWarp; ++q) {
      // Rows past the end re-read row r0 and are never written back.
      const int r = r0 + q < re ? r0 + q : r0;
      y[q] = ys[r];
      row[q] = stash + (size_t)r * tile_n;
      e[q] = 0.0f;
      dm[q] = __int_as_float(0x7f800000);  // +inf
#pragma unroll
      for (int k = 0; k < C; ++k) a[q][k] = 0.0f;
    }
    for (int c = lane * 4; c < n4; c += 128) {
      float4 g[kRowsPerWarp];
#pragma unroll
      for (int q = 0; q < kRowsPerWarp; ++q)
        g[q] = *reinterpret_cast<const float4*>(row[q] + c);
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
          const float gj = j == 0 ? g[q].x : j == 1 ? g[q].y
                         : j == 2 ? g[q].z : g[q].w;
          const float d2 = sqd(y[q], x);
          const float p = gj * ivj;
          dm[q] = fminf(dm[q], d2);
          e[q] += p * d2;
#pragma unroll
          for (int k = 0; k < C; ++k) {
            const float vk = j == 0 ? v[k].x : j == 1 ? v[k].y
                           : j == 2 ? v[k].z : v[k].w;
            a[q][k] += p * vk;
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
        const float p = row[q][c] * ivc;
        dm[q] = fminf(dm[q], d2);
        e[q] += p * d2;
#pragma unroll
        for (int k = 0; k < C; ++k) a[q][k] += p * vw[k * nc4 + c];
      }
    }
#pragma unroll
    for (int q = 0; q < kRowsPerWarp; ++q) {
#pragma unroll
      for (int k = 0; k < C; ++k) a[q][k] = warp_sum(a[q][k]);
      e[q] = warp_sum(e[q]);
      dm[q] = warp_min(dm[q]);
      const int r = r0 + q;
      if (lane == 0 && r < re) {
        float* mo = mom + (size_t)r * kMaxC;
#pragma unroll
        for (int k = 0; k < C; ++k) mo[k] += a[q][k];
        dmin[r] = fminf(dmin[r], dm[q]);
        e1r[r] += e[q];
      }
    }
  }
}

template <int C>
int launch_moment(const void* ys, const void* xs, const void* vt,
                  int n_total, int ncols, int tile_n, int m, int tile_m,
                  int n_i, const void* act_idx, const void* act_cnt,
                  const void* stash, const void* inv_den, void* mom,
                  void* dmin, void* e1r, void* stream) {
  const int smem = ((ncols + 3) & ~3) * (16 + 4 + 4 * C);
  cudaError_t err = cudaFuncSetAttribute(
      wstash_moment_kernel<C>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((tile_m + kMomRows - 1) / kMomRows, n_i);
  wstash_moment_kernel<C><<<grid, kMomThreads, smem, (cudaStream_t)stream>>>(
      (const float4*)ys, (const float4*)xs, (const float*)vt, n_total, ncols,
      tile_n, m, tile_m, (const int*)act_idx, (const int*)act_cnt,
      (const float*)stash, (const float*)inv_den, (float*)mom, (float*)dmin,
      (float*)e1r);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

int probreg_wstash_den(const void* ys, const void* rowlog, int m, int tile_m,
                       int n_i, const void* xs, int ncols, int tile_n,
                       const void* act_idx, const void* act_cnt,
                       const void* scal, void* stash, void* part,
                       void* tickets, void* inv_den, void* nud,
                       void* stream) {
  const int stages = (tile_m + kStage - 1) / kStage;
  const dim3 grid((tile_n + kDenThreads - 1) / kDenThreads, n_i * stages);
  wstash_den_kernel<<<grid, kDenThreads, 0, (cudaStream_t)stream>>>(
      (const float4*)ys, (const float*)rowlog, m, tile_m, stages,
      (const float4*)xs, ncols, tile_n, (const int*)act_idx,
      (const int*)act_cnt, (const float*)scal, (float*)stash, (float*)part,
      (unsigned int*)tickets, (float*)inv_den, (float*)nud);
  return (int)cudaGetLastError();
}

int probreg_wstash_moment(const void* ys, const void* xs, const void* vt,
                          int n_total, int c_cnt, int ncols, int tile_n,
                          int m, int tile_m, int n_i, const void* act_idx,
                          const void* act_cnt, const void* stash,
                          const void* inv_den, void* mom, void* dmin,
                          void* e1r, void* stream) {
#define PROBREG_MOMENT(C)                                                   \
  case C:                                                                   \
    return launch_moment<C>(ys, xs, vt, n_total, ncols, tile_n, m, tile_m,  \
                            n_i, act_idx, act_cnt, stash, inv_den, mom,     \
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
