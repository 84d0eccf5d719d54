// CPD E-step kernels for Hopper (sm_90a), bound to Python with ctypes.
//
// The two-pass kernels take points packed as float4 (x, y, z, |p|^2), one
// 16-byte load per point; clouds of dimension < 3 carry zeros in the unused
// coordinates. K2 reads the (., D) clouds as they are and forms |p|^2
// itself. Every exact kernel computes the Gaussian of a pair as the
// reference's _dist_tile: d2 = max(|y|^2 + |x|^2 - 2 y.x, 0), g =
// expf(-d2 * inv2s2), in IEEE f32 (FMAs, expf, IEEE division; no
// fast-math: FTZ or the approximate exp would change results near the 104
// cull bound). K3's fast passes (below) take exp2f on a pre-scaled
// argument, still without FTZ.
//
// Scalars come from the device (scal = [0.5 / sigma2, outlier c]; K2 forms
// them from sigma2 itself) so an EM iteration needs no host round trip.
// Each entry point launches on the caller's stream, allocates nothing and
// returns cudaGetLastError().
//
// Reductions across blocks never use float atomics: blocks write partial
// sums, and a second pass, or the last block to finish (an atomic ticket),
// adds them up in a fixed order. So the results are deterministic from run
// to run.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "bf16_mma.cuh"

namespace {

constexpr float kEpsF32 = 1.1920928955078125e-07f;  // np.finfo(f32).eps

// The Gaussian of one pair with every rounding spelled out, so that each
// kernel that calls it forms the same bits whatever the compiler does
// around it: the dot as y.y x.y rounded, then y.x x.x and y.z x.z fused
// into it (the contraction nvcc gives the plain sum y.x x.x + y.y x.y +
// y.z x.z, so the bits are the plain expression's), and |y|^2 + |x|^2 -
// 2 y.x with the doubling fused: 2 y.x is exact in f32, so fma(-2, y.x,
// |y|^2 + |x|^2) rounds once, to the value that subtracting the doubled
// dot gives, in one instruction fewer.
__device__ __forceinline__ float gauss(float4 y, float4 x, float inv2s2) {
  const float xy =
      __fmaf_rn(y.z, x.z, __fmaf_rn(y.x, x.x, __fmul_rn(y.y, x.y)));
  const float d2 = fmaxf(__fmaf_rn(-2.0f, xy, __fadd_rn(y.w, x.w)), 0.0f);
  return expf(__fmul_rn(-d2, inv2s2));
}

// The sums that the E-step kernels share are spelled out with the
// round-to-nearest intrinsics, which the compiler never contracts: a
// column's s + g stays an add, a row's moments are p1 + p, px + p * x (one
// FMA per channel), and K12's folded moments p1 + g * inv_den, px + g * (x
// * inv_den) (one FMA per channel), whatever else the kernel computes around
// them. So the kernels that share an association give the same bits.
__device__ __forceinline__ void add_moments(float p, float4 x, float4& a) {
  a.w = __fadd_rn(a.w, p);
  a.x = __fmaf_rn(p, x.x, a.x);
  a.y = __fmaf_rn(p, x.y, a.y);
  a.z = __fmaf_rn(p, x.z, a.z);
}

// K12's moments of one pair with the normalizer folded into the channels:
// f = (x * inv_den, inv_den), p1 += g * inv_den, px += g * (x * inv_den).
__device__ __forceinline__ void add_folded(float g, float4 f, float4& a) {
  a.w = __fmaf_rn(g, f.w, a.w);
  a.x = __fmaf_rn(g, f.x, a.x);
  a.y = __fmaf_rn(g, f.y, a.y);
  a.z = __fmaf_rn(g, f.z, a.z);
}

__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float4 warp_sum4(float4 v) {
  return make_float4(warp_sum(v.x), warp_sum(v.y), warp_sum(v.z),
                     warp_sum(v.w));
}

// Sum of one value per thread over a block of kThreads, in a fixed order.
template <int kThreads>
__device__ float block_sum(float v) {
  __shared__ float warps[kThreads / 32];
  v = warp_sum(v);
  if ((threadIdx.x & 31) == 0) warps[threadIdx.x >> 5] = v;
  __syncthreads();
  float s = 0.0f;
  if (threadIdx.x == 0)
    for (int w = 0; w < kThreads / 32; ++w) s += warps[w];
  return s;  // valid in thread 0
}

// True in every thread of the block that finishes last among `expected`
// blocks sharing `ticket`. The block's global writes before the call are
// visible to that block: the block barrier orders them before thread 0's
// fence and ticket, as in cooperative groups' grid barrier. The last block
// reads them back with __ldcg, which bypasses the non-coherent L1.
__device__ bool last_block(unsigned int* ticket, unsigned int expected) {
  __shared__ bool is_last;
  __syncthreads();
  if (threadIdx.x == 0) {
    __threadfence();
    is_last = atomicAdd(ticket, 1u) == expected - 1u;
    if (is_last) __threadfence();
  }
  __syncthreads();
  return is_last;
}

// Counts the block in at `counter` once its global writes before the call
// are visible (the pattern of last_block, without the answer).
__device__ __forceinline__ void arrive(unsigned int* counter) {
  __syncthreads();
  if (threadIdx.x == 0) {
    __threadfence();
    atomicAdd(counter, 1u);
  }
}

// Waits until `count` blocks have arrived at `counter`; their writes are
// then visible to the whole block (read them with __ldcg). Only a launch
// whose blocks are all resident (cooperative), or whose arrivals precede it
// (an earlier launch), may wait.
__device__ __forceinline__ void wait_for(unsigned int* counter,
                                         unsigned int count) {
  if (threadIdx.x == 0) {
    while (atomicOr(counter, 0u) < count) {
    }
    __threadfence();
  }
  __syncthreads();
}

// ---------------------------------------------------------------------------
// K2: the whole small E-step (M * N <= 2^20, D <= 3) in one cooperative
// launch.
//
// Replaces probreg_tpu/ops/estep_pallas.py:_small_kernel (estep_small). The
// TPU kernel keeps the (M, N) posterior in VMEM. Here M * N <= 2^20 pairs
// cost ~2e6 exps, a few microseconds of the FP32 pipe (bound: operations):
// what costs time is latency, so the design spreads the pairs over every
// SM and keeps the chain of dependent steps short. The pairs are cut into
// tiles of R sources x C targets (powers of two from 16 to 256, R C =
// 4,096 pairs: 16 per thread of a 256-thread block in each phase; C / R
// near sqrt(N / M), estep_cuda.small_plan), as many tiles as M * N needs
// whatever the shape; blocks walk the tiles grid-stride, each block every
// phase-A tile of its share before its phase-B tiles.
//
// Phase A, per tile: thread (k, j) holds target j and sums the Gaussians
// of rows k, k + K, ... (K = 256 / C, four in flight) in row order; the K
// sums go to den_part[row chunk][column] in k order, and the tile counts
// in at its column group.
// Phase B, per tile: once all nr row chunks of its column group have
// counted in, the tile forms the group's den_raw from their partials
// (thread (k, j): chunks k, k + K, ... in order, eight loads in flight,
// then the K sums in k order; every tile of the group forms the same
// bits), inv_den = 1 / ((den_raw == 0 ? eps : den_raw) + c) and, in the
// tiles of row chunk 0, pt1 = den_raw inv_den and the group's xx
// (block_sum of pt1 |x|^2), as K3's den_finish_col. Then thread (q, i)
// holds source i and sums p = g inv_den (K3's normalisation: an IEEE
// division per pair was phase B's dearest step) and p x over columns q,
// q + Q, ... (Q = 256 / R, four in flight) in column order; the Q sums go
// to part[column group][row] in q order. The last tile of a row chunk to
// finish (an atomic ticket) finalizes its rows (thread q: groups q, q + Q,
// ... in order, eight loads in flight, then the Q sums in q order) into
// p1 and px, and the chunk's n_p (block_sum); the last chunk sums n_p and
// xx over chunks and groups (thread t: t, t + 256, ... in order, then one
// block sum of both).
//
// A phase-B tile waits only for its own column group, so no grid barrier
// is needed; the cooperative launch guarantees that every block is
// resident while some wait (the blocks never exceed
// probreg_estep_small_capacity). Every sum's association is fixed by (M,
// N) through the tiles, never by the grid: any block count gives the same
// bits. No float atomics; the counters are back at 0 when the launch ends.
// The scalars come from sigma2 (a device scalar or a host
// value) inside the kernel, as _scalars forms them: inv2s2 = 0.5 / sigma2,
// c = (2 pi sigma2)^(D / 2) w / (1 - w) M / N. The clouds are read as (M,
// D) and (N, D) f32; |p|^2 is formed here.
// ---------------------------------------------------------------------------
constexpr int kSmallThreads = 256;
constexpr int kSmallTilePairs = 16 * kSmallThreads;

struct SmallArgs {
  const float* ys;        // (m, D)
  const float* xs;        // (n, D)
  const float* sigma2;    // device f32 scalar, or null: sigma2_val
  float sigma2_val, w, one_minus_w;
  int m, n, rows, cols, nr, nc, log_rows, log_cols;
  float* den_part;        // (nr, n) scratch
  float* xx_part;         // (nc)
  float4* part;           // (nc, m): px in xyz, p1 in w
  float* np_part;         // (nr)
  unsigned int* tickets;  // 1 + nc + nr, 0 at rest: all, per group, per chunk
  float* pt1;             // (n)
  float* p1;              // (m)
  float* px;              // (m, D)
  float* stats;           // [n_p, xx]
};

struct SmallShared {
  float4 y[kSmallThreads];     // phase A: the tile's rows
  float4 x[kSmallThreads];     // phase B: the tile's columns
  float inv[kSmallThreads];    // phase B: their inv_den
  float red[kSmallThreads];    // the K sums of each column
  float4 red4[kSmallThreads];  // phase B: the Q sums of each row
};

// Point i of a (., D) cloud as (x, y, z, |p|^2), zeros past D.
template <int D>
__device__ __forceinline__ float4 small_point(const float* __restrict__ p,
                                              int i) {
  float4 v = make_float4(p[(size_t)i * D], 0.f, 0.f, 0.f);
  if (D > 1) v.y = p[(size_t)i * D + 1];
  if (D > 2) v.z = p[(size_t)i * D + 2];
  float s = __fmul_rn(v.x, v.x);
  if (D > 1) s = __fmaf_rn(v.y, v.y, s);
  if (D > 2) s = __fmaf_rn(v.z, v.z, s);
  v.w = s;
  return v;
}

// The Gaussian of a pair with every rounding spelled out, so both phases
// form the same g.
template <int D>
__device__ __forceinline__ float small_gauss(float4 y, float4 x,
                                             float inv2s2) {
  float xy = __fmul_rn(y.x, x.x);
  if (D > 1) xy = __fmaf_rn(y.y, x.y, xy);
  if (D > 2) xy = __fmaf_rn(y.z, x.z, xy);
  const float d2 = fmaxf(__fmaf_rn(-2.0f, xy, __fadd_rn(y.w, x.w)), 0.0f);
  return expf(__fmul_rn(-d2, inv2s2));
}

__device__ __forceinline__ void add4(float4& a, float4 v) {
  a.x = __fadd_rn(a.x, v.x);
  a.y = __fadd_rn(a.y, v.y);
  a.z = __fadd_rn(a.z, v.z);
  a.w = __fadd_rn(a.w, v.w);
}

__device__ __forceinline__ void add_to(float& a, float v) {
  a = __fadd_rn(a, v);
}
__device__ __forceinline__ void add_to(float4& a, float4 v) { add4(a, v); }

// 0 + v[first] + v[first + step] + ... (indices < count, each times
// stride) in index order, eight L2 loads in flight.
template <typename T>
__device__ __forceinline__ T ordered_sum(const T* __restrict__ v,
                                         size_t stride, int first, int step,
                                         int count) {
  T a{};
  int q = first;
  for (; q + 7 * step < count; q += 8 * step) {
    T b[8];
#pragma unroll
    for (int u = 0; u < 8; ++u)
      b[u] = __ldcg(v + (size_t)(q + u * step) * stride);
#pragma unroll
    for (int u = 0; u < 8; ++u) add_to(a, b[u]);
  }
  for (; q < count; q += step) add_to(a, __ldcg(v + (size_t)q * stride));
  return a;
}

template <int D>
__device__ void small_scalars(const SmallArgs& a, float& inv2s2, float& c) {
  const float s = a.sigma2 ? *a.sigma2 : a.sigma2_val;
  inv2s2 = __fdiv_rn(0.5f, s);
  const float base = __fmul_rn(6.2831855f, s);  // f32(2 pi) sigma2
  float k = D == 1 ? __fsqrt_rn(base) : D == 2 ? base : powf(base, 1.5f);
  k = __fdiv_rn(__fmul_rn(k, a.w), a.one_minus_w);
  c = __fdiv_rn(__fmul_rn(k, (float)a.m), (float)a.n);
}

// Sum of one value per thread over the block in block_sum's order, valid
// in thread 0; callable again right after.
__device__ __forceinline__ float small_block_sum(float v) {
  const float s = block_sum<kSmallThreads>(v);
  __syncthreads();
  return s;
}

// Two such sums at once (one barrier), valid in thread 0.
__device__ __forceinline__ float2 small_block_sum2(float u, float v) {
  __shared__ float2 warps[kSmallThreads / 32];
  u = warp_sum(u);
  v = warp_sum(v);
  if ((threadIdx.x & 31) == 0) warps[threadIdx.x >> 5] = make_float2(u, v);
  __syncthreads();
  float2 s = make_float2(0.0f, 0.0f);
  if (threadIdx.x == 0)
    for (int w = 0; w < kSmallThreads / 32; ++w) {
      s.x += warps[w].x;
      s.y += warps[w].y;
    }
  return s;
}

template <int D>
__device__ void small_den_tile(const SmallArgs& a, int tile, float inv2s2,
                               SmallShared& sh) {
  const int t = threadIdx.x;
  const int rc = tile / a.nc, cg = tile - rc * a.nc;
  const int r0 = rc * a.rows, c0 = cg * a.cols;
  const int nrows = min(a.rows, a.m - r0), ncols = min(a.cols, a.n - c0);
  const int j = t & (a.cols - 1), k = t >> a.log_cols;
  const int kk = kSmallThreads >> a.log_cols;  // K
  const float4 x = j < ncols ? small_point<D>(a.xs, c0 + j)
                             : make_float4(0.f, 0.f, 0.f, 0.f);
  __syncthreads();  // the block's previous tile is done with sh
  for (int i = t; i < nrows; i += kSmallThreads)
    sh.y[i] = small_point<D>(a.ys, r0 + i);
  __syncthreads();
  float s = 0.0f;
  if (j < ncols) {
    int i = k;
    for (; i + 3 * kk < nrows; i += 4 * kk) {
      const float g0 = small_gauss<D>(sh.y[i], x, inv2s2);
      const float g1 = small_gauss<D>(sh.y[i + kk], x, inv2s2);
      const float g2 = small_gauss<D>(sh.y[i + 2 * kk], x, inv2s2);
      const float g3 = small_gauss<D>(sh.y[i + 3 * kk], x, inv2s2);
      s = __fadd_rn(__fadd_rn(__fadd_rn(__fadd_rn(s, g0), g1), g2), g3);
    }
    for (; i < nrows; i += kk) s = __fadd_rn(s, small_gauss<D>(sh.y[i], x,
                                                                inv2s2));
  }
  sh.red[t] = s;
  __syncthreads();
  if (t < ncols) {
    float d = sh.red[t];
    for (int q = 1; q < kk; ++q) d = __fadd_rn(d, sh.red[q * a.cols + t]);
    a.den_part[(size_t)rc * a.n + c0 + t] = d;
  }
  arrive(a.tickets + 1 + cg);
}

template <int D>
__device__ void small_moment_tile(const SmallArgs& a, int tile,
                                  float inv2s2, float c, SmallShared& sh) {
  const int t = threadIdx.x;
  const int rc = tile / a.nc, cg = tile - rc * a.nc;
  const int r0 = rc * a.rows, c0 = cg * a.cols;
  const int nrows = min(a.rows, a.m - r0), ncols = min(a.cols, a.n - c0);
  const int i = t & (a.rows - 1), q = t >> a.log_rows;
  const int qq = kSmallThreads >> a.log_rows;  // Q
  const int j = t & (a.cols - 1), k = t >> a.log_cols;
  const int kk = kSmallThreads >> a.log_cols;  // K
  const float4 y = i < nrows ? small_point<D>(a.ys, r0 + i)
                             : make_float4(0.f, 0.f, 0.f, 0.f);
  const float4 x = j < ncols ? small_point<D>(a.xs, c0 + j)
                             : make_float4(0.f, 0.f, 0.f, 0.f);
  // The column group's normalizers once its phase A is done, summed as
  // phase A's layout sums a tile (thread k: chunks k, k + K, ... in order,
  // then the K sums in k order): every tile of the group forms the same
  // den_raw; the tiles of row chunk 0 write pt1 and the group's xx.
  wait_for(a.tickets + 1 + cg, a.nr);
  sh.red[t] = j < ncols ? ordered_sum(a.den_part + c0 + j, a.n, k, kk, a.nr)
                        : 0.0f;
  __syncthreads();
  float xxv = 0.0f;
  if (t < ncols) {  // k == 0: x is column t's
    float den_raw = sh.red[t];
    for (int u = 1; u < kk; ++u)
      den_raw = __fadd_rn(den_raw, sh.red[u * a.cols + t]);
    const float inv = __fdiv_rn(
        1.0f, __fadd_rn(den_raw == 0.0f ? kEpsF32 : den_raw, c));
    sh.x[t] = x;
    sh.inv[t] = inv;
    if (rc == 0) {
      const float p = __fmul_rn(den_raw, inv);
      a.pt1[c0 + t] = p;
      xxv = __fmul_rn(p, x.w);
    }
  }
  if (rc == 0) {
    const float xx = small_block_sum(xxv);
    if (t == 0) a.xx_part[cg] = xx;
  }
  __syncthreads();
  float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
  if (i < nrows) {
    int u = q;  // columns q, q + Q, ...
    for (; u + 3 * qq < ncols; u += 4 * qq) {
      const float g0 = small_gauss<D>(y, sh.x[u], inv2s2);
      const float g1 = small_gauss<D>(y, sh.x[u + qq], inv2s2);
      const float g2 = small_gauss<D>(y, sh.x[u + 2 * qq], inv2s2);
      const float g3 = small_gauss<D>(y, sh.x[u + 3 * qq], inv2s2);
      add_moments(__fmul_rn(g0, sh.inv[u]), sh.x[u], acc);
      add_moments(__fmul_rn(g1, sh.inv[u + qq]), sh.x[u + qq], acc);
      add_moments(__fmul_rn(g2, sh.inv[u + 2 * qq]), sh.x[u + 2 * qq], acc);
      add_moments(__fmul_rn(g3, sh.inv[u + 3 * qq]), sh.x[u + 3 * qq], acc);
    }
    for (; u < ncols; u += qq)
      add_moments(__fmul_rn(small_gauss<D>(y, sh.x[u], inv2s2), sh.inv[u]),
                  sh.x[u], acc);
  }
  sh.red4[t] = acc;
  __syncthreads();
  if (t < nrows) {
    float4 v = sh.red4[t];
    for (int u = 1; u < qq; ++u) add4(v, sh.red4[u * a.rows + t]);
    a.part[(size_t)cg * a.m + r0 + t] = v;
  }
  unsigned int* ticket = a.tickets + 1 + a.nc + rc;
  if (!last_block(ticket, a.nc)) return;
  // The row chunk's finalisation, by the last of its column groups.
  acc = i < nrows ? ordered_sum(a.part + r0 + i, a.m, q, qq, a.nc)
                  : make_float4(0.f, 0.f, 0.f, 0.f);
  __syncthreads();
  sh.red4[t] = acc;
  __syncthreads();
  float p1v = 0.0f;
  if (t < nrows) {
    float4 v = sh.red4[t];
    for (int u = 1; u < qq; ++u) add4(v, sh.red4[u * a.rows + t]);
    const size_t r = (size_t)(r0 + t);
    a.p1[r] = v.w;
    a.px[r * D] = v.x;
    if (D > 1) a.px[r * D + 1] = v.y;
    if (D > 2) a.px[r * D + 2] = v.z;
    p1v = v.w;
  }
  const float np = small_block_sum(p1v);
  if (t == 0) {
    a.np_part[rc] = np;
    *ticket = 0u;
  }
  if (!last_block(a.tickets, a.nr)) return;
  // n_p and xx, by the last row chunk.
  const float2 tot =
      small_block_sum2(ordered_sum(a.np_part, 1, t, kSmallThreads, a.nr),
                       ordered_sum(a.xx_part, 1, t, kSmallThreads, a.nc));
  if (t == 0) {
    a.stats[0] = tot.x;
    a.stats[1] = tot.y;
    *a.tickets = 0u;
  }
  // Every tile is past its wait: phase A's counters go back to 0.
  for (int g = t; g < a.nc; g += kSmallThreads) a.tickets[1 + g] = 0u;
}

template <int D>
__global__ void __launch_bounds__(kSmallThreads)
small_kernel(const SmallArgs a) {
  __shared__ SmallShared sh;
  float inv2s2, c;
  small_scalars<D>(a, inv2s2, c);
  const int tiles = a.nr * a.nc;
  for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x)
    small_den_tile<D>(a, tile, inv2s2, sh);
  for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x)
    small_moment_tile<D>(a, tile, inv2s2, c, sh);
}

template <int D>
int launch_small(const SmallArgs& a, int blocks, cudaStream_t s) {
  void* args[] = {(void*)&a};
  // A refused launch (too many blocks to be resident) also sets the
  // runtime's last error: read it here so that it is not reported again
  // by the next launch.
  const cudaError_t err = cudaLaunchCooperativeKernel(
      (const void*)small_kernel<D>, dim3(blocks), dim3(kSmallThreads),
      args, 0, s);
  const cudaError_t last = cudaGetLastError();
  return (int)(err != cudaSuccess ? err : last);
}

template <int D>
int small_capacity(int* out) {
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, small_kernel<D>, kSmallThreads, 0);
  *out = sms * per_sm;
  return (int)err;
}

// The floor of a launch through this library: a kernel that does nothing.
__global__ void empty_kernel(int) {}

// ---------------------------------------------------------------------------
// Pass A's finalisation, shared by K3 and K12 (inside their pass A) and K11
// (after the caller's reduction): a column's raw normalizer, its per-tile
// partial sums added in tile order, becomes inv_den, pt1 and the column's
// share of xx, and a chunk of 256 columns sums its shares in block_sum<256>'s
// order. So every route gives K3's pt1, inv_den and xx on the same sums.
// ---------------------------------------------------------------------------
constexpr int kDenThreads = 256;

// One column's finalisation: inv_den = 1 / ((den_raw == 0 ? eps : den_raw)
// + c), pt1 = den_raw * inv_den. Returns the column's share of xx,
// pt1 |x|^2.
__device__ __forceinline__ float den_finish_col(float den_raw, float4 xv,
                                                float c, int col,
                                                float* __restrict__ inv_den,
                                                float* __restrict__ pt1) {
  const float inv = 1.0f / ((den_raw == 0.0f ? kEpsF32 : den_raw) + c);
  const float p = den_raw * inv;
  inv_den[col] = inv;
  pt1[col] = p;
  return __fmul_rn(p, xv.w);
}

// The normalizer's finalisation for one chunk of 256 columns, one per
// thread of the block: den_finish_col, and the chunk's xx (block_sum) in
// xx_part[cx].
__device__ void den_finish_chunk(float den_raw, bool ok, float4 xv, float c,
                                 int col, float* __restrict__ inv_den,
                                 float* __restrict__ pt1,
                                 float* __restrict__ xx_part, int cx) {
  const float xxv = ok ? den_finish_col(den_raw, xv, c, col, inv_den, pt1)
                       : 0.0f;
  const float xx = block_sum<kDenThreads>(xxv);
  if (threadIdx.x == 0) xx_part[cx] = xx;
}

// ---------------------------------------------------------------------------
// K3 and K4: the CPD E-steps that keep no stash, two launches each.
//
// K3 replaces probreg_tpu/ops/estep_pallas.py:_stash_den_kernel (pass A)
// and :_stash_moment_kernel (pass B); K4 replaces :_den_kernel and
// :_moment_kernel. The TPU stash kernels form each active pair's exp once
// and stash it between the passes, because an exp is dear there. On this
// card an exp is one MUFU instruction among ~16 of the Gaussian, and the
// stash is 4 B per active pair written and read again, far beyond the
// 50 MB L2 at 150k points (53.7 ms of HBM traffic per dense 150k E-step).
// So both passes form the Gaussian with gauss(), nothing per pair goes to
// device memory, and each pass is one launch for the whole E-step: pass A
// (den_pass_kernel) walks each target stripe's active source tiles, pass B
// (moment_pass_kernel) each source tile's active stripes (the mask
// compacted along the other axis). Culled tiles are never visited, so they
// add exact zeros. What bounds both passes is the instruction rate of the
// FP32 pipe (~17 and ~21 instructions per active pair).
//
// The two kernels differ only in how they associate their sums, the
// template parameter kTileSums, which each takes from its TPU counterpart:
// * K3 (kTileSums = true) keeps the stash kernels' order. Pass A sums each
//   active tile's rows into a fresh partial (in row order) and adds the
//   partials to the column's normalizer in slot (= tile) order from 0.
//   Pass B keeps the stash read's per-row order: lane l takes columns l,
//   l + 32, ... of a stripe, the lanes' partials are added by warp_sum,
//   and the stripe sums go to the row's total in ascending stripe order
//   from 0, with p = g * inv_den. K11 and K12 (below) are built from these
//   two passes, so they share K3's sums.
// * K4 (kTileSums = false) keeps one running sum per column over every
//   active tile (pass A) and per row over every column of every active
//   stripe in order (pass B), as the reference's two-pass kernels do.
//
// Both finish pass A with den_finish_col and the chunk's xx in
// block_sum<256>'s order. Register blocking: a pass-A thread holds
// kColsPerThread columns (t and t + 128 of its 256-column chunk), so each
// source point read from shared memory serves both; a pass-B thread holds
// kRows rows (K3: the warp's kRowsPerWarp rows, K4: kRowsPerThread rows of
// its own), so each column's point and inv_den come from shared memory
// once per group of rows. K4 keeps one row a thread (586 blocks of 256
// rows in a dense 150k E-step): with 2 or 4 rows a thread, and half or a
// quarter of the blocks, its pass B ran slower on an H100.
// ---------------------------------------------------------------------------
constexpr int kColsPerThread = 2;
constexpr int kPairThreads = kDenThreads / kColsPerThread;  // 128

// Pass A: grid (column chunks of 256, n_j stripes), kPairThreads threads.
// The block of chunk cx of stripe j walks the stripe's active source tiles
// (act_idx[j][0..cnt)) and writes inv_den and pt1 of its columns and the
// chunk's xx to xx_part[j][cx]; with kRaw (K11) it stops at the raw column
// sums and writes den_raw of its columns instead. kDump (tests only): every
// g the pass forms also goes to g_dump (m, n).
template <bool kTileSums, bool kRaw = false, bool kDump = false>
__global__ void __launch_bounds__(kPairThreads)
den_pass_kernel(const float4* __restrict__ ys, int m, int tile_m, int n_i,
                const float4* __restrict__ xs, int n, int tile_n,
                const int* __restrict__ act_idx,   // (n_j, n_i)
                const int* __restrict__ act_cnt,   // (n_j)
                const float* __restrict__ scal,
                const int* __restrict__ skip,      // null, or the fast flag
                float* __restrict__ inv_den,       // (n)
                float* __restrict__ pt1,           // (n)
                float* __restrict__ xx_part,       // (gridDim.y, gridDim.x)
                float* __restrict__ den_raw,       // kRaw: (n)
                float* __restrict__ g_dump) {      // kDump: (m, n)
  if (skip != nullptr && *skip != 0) return;  // the fast branch runs
  __shared__ float4 ysh[kDenThreads];
  __shared__ float warps[kDenThreads / 32];
  const int stripe = blockIdx.y, cx = blockIdx.x;
  const int c0 = stripe * tile_n;
  const int ncols = min(tile_n, n - c0);
  const size_t xx_at = (size_t)stripe * gridDim.x + cx;
  if (cx * kDenThreads >= ncols) {  // a chunk past a ragged stripe's end
    if (!kRaw && threadIdx.x == 0) xx_part[xx_at] = 0.0f;
    return;
  }
  int col[kColsPerThread];
  bool ok[kColsPerThread];
  float4 xv[kColsPerThread];
  float den[kColsPerThread];
#pragma unroll
  for (int k = 0; k < kColsPerThread; ++k) {
    col[k] = cx * kDenThreads + k * kPairThreads + threadIdx.x;
    ok[k] = col[k] < ncols;
    xv[k] = ok[k] ? xs[c0 + col[k]] : make_float4(0.f, 0.f, 0.f, 0.f);
    den[k] = 0.0f;
  }
  const float inv2s2 = scal[0];
  const int cnt = act_cnt[stripe];
  const int* idx = act_idx + (size_t)stripe * n_i;
  for (int t = 0; t < cnt; ++t) {
    const int r0 = idx[t] * tile_m;
    const int r1 = min(r0 + tile_m, m);
    float s[kColsPerThread] = {};  // K3: this tile's partials
    for (int rc = r0; rc < r1; rc += kDenThreads) {
      const int nr = min(kDenThreads, r1 - rc);
      __syncthreads();
      for (int r = threadIdx.x; r < nr; r += kPairThreads) ysh[r] = ys[rc + r];
      __syncthreads();
#pragma unroll 8
      for (int r = 0; r < nr; ++r) {
        const float4 y = ysh[r];
#pragma unroll
        for (int k = 0; k < kColsPerThread; ++k) {
          const float g = gauss(y, xv[k], inv2s2);
          if (kTileSums)
            s[k] = __fadd_rn(s[k], g);
          else
            den[k] = __fadd_rn(den[k], g);
          if (kDump && ok[k]) g_dump[(size_t)(rc + r) * n + c0 + col[k]] = g;
        }
      }
    }
    if (kTileSums) {
#pragma unroll
      for (int k = 0; k < kColsPerThread; ++k)
        den[k] = __fadd_rn(den[k], s[k]);
    }
  }
  if (kRaw) {  // K11: finalized after the caller's reduction
#pragma unroll
    for (int k = 0; k < kColsPerThread; ++k)
      if (ok[k]) den_raw[c0 + col[k]] = den[k];
    return;
  }
  // den_finish_chunk for two columns a thread: column k of warp w is
  // column w + 4 k's share in block_sum<256>.
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
#pragma unroll
  for (int k = 0; k < kColsPerThread; ++k) {
    const float xxv = ok[k] ? den_finish_col(den[k], xv[k], scal[1],
                                             c0 + col[k], inv_den, pt1)
                            : 0.0f;
    const float v = warp_sum(xxv);
    if (lane == 0) warps[k * (kPairThreads / 32) + warp] = v;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    float xx = 0.0f;
    for (int w = 0; w < kDenThreads / 32; ++w) xx += warps[w];
    xx_part[xx_at] = xx;
  }
}

constexpr int kRowThreads = 256;
constexpr int kRowsPerWarp = 8;    // K3: rows a warp walks together
constexpr int kRowsPerThread = 1;  // K4: rows a thread owns
constexpr int kColStage = 256;     // stripe columns in shared memory at once
static_assert(kColStage % 32 == 0, "lane l keeps columns l + 32 i");

// Rows of one pass-B block.
template <bool kTileSums>
__host__ __device__ constexpr int moment_block_rows() {
  return kTileSums ? kRowThreads / 32 * kRowsPerWarp
                   : kRowThreads * kRowsPerThread;
}

// Pass B: grid (row blocks, n_i source tiles), kRowThreads threads. The
// block of rows [rb, rb + moment_block_rows) of tile i walks the tile's
// active target stripes (act_idx[i][0..cnt), ascending) and writes p1 and
// px of its rows (zeros where no stripe is active). kFold (K12): every
// stripe but the last (n_j - 1) folds the normalizer into the channels
// (add_folded); the last keeps p = g * inv_den (add_moments). The bf16
// stash's pass B is moment_bf16_kernel (below).
template <bool kTileSums, bool kFold = false>
__global__ void __launch_bounds__(kRowThreads)
moment_pass_kernel(const float4* __restrict__ ys, int m, int tile_m,
                   const float4* __restrict__ xs, int n, int tile_n, int n_j,
                   const int* __restrict__ act_idx,   // (n_i, n_j)
                   const int* __restrict__ act_cnt,   // (n_i)
                   const float* __restrict__ scal,
                   const int* __restrict__ skip,      // null, or the fast flag
                   const float* __restrict__ inv_den, // (n)
                   float4* __restrict__ p1px) {  // (m): px in xyz, p1 in w
  if (skip != nullptr && *skip != 0) return;  // the fast branch runs
  // K3: every lane of a warp holds the warp's rows and the lanes stride
  // the columns; K4: a thread holds its own rows and walks every column.
  constexpr int kRows = kTileSums ? kRowsPerWarp : kRowsPerThread;
  constexpr int kStride = kTileSums ? 32 : 1;
  __shared__ float4 xw[kColStage];  // x, y, z, |x|^2
  __shared__ float iw[kColStage];   // inv_den
  __shared__ float4 fw[kFold ? kColStage : 1];  // x * inv_den, inv_den
  const int tile = blockIdx.y;
  const int t1 = min((tile + 1) * tile_m, m);
  const int rb = tile * tile_m + blockIdx.x * moment_block_rows<kTileSums>();
  if (rb >= t1) return;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int r0 = rb + (kTileSums ? warp : (int)threadIdx.x) * kRows;
  const int first = kTileSums ? lane : 0;
  float4 y[kRows];
  float4 a[kRows];  // K3: the current stripe's sums; K4: the row's totals
#pragma unroll
  for (int q = 0; q < kRows; ++q) {  // rows past the end: never written
    y[q] = ys[min(r0 + q, t1 - 1)];
    a[q] = make_float4(0.f, 0.f, 0.f, 0.f);
  }
  // K3: lane q keeps row q's total.
  float4 tot = make_float4(0.f, 0.f, 0.f, 0.f);
  const float inv2s2 = scal[0];
  const int cnt = act_cnt[tile];
  const int* idx = act_idx + (size_t)tile * n_j;
  for (int k = 0; k < cnt; ++k) {
    const int c0 = idx[k] * tile_n;
    const int c1 = min(c0 + tile_n, n);
    const bool fold = kFold && idx[k] != n_j - 1;
    for (int cc = c0; cc < c1; cc += kColStage) {
      const int nc = min(kColStage, c1 - cc);
      __syncthreads();
      if (threadIdx.x < nc) {
        const float4 x = xs[cc + threadIdx.x];
        const float inv = inv_den[cc + threadIdx.x];
        xw[threadIdx.x] = x;
        iw[threadIdx.x] = inv;
        if (kFold)
          fw[threadIdx.x] = make_float4(__fmul_rn(x.x, inv),
                                        __fmul_rn(x.y, inv),
                                        __fmul_rn(x.z, inv), inv);
      }
      __syncthreads();
      if (fold) {
        for (int c = first; c < nc; c += kStride) {
          const float4 x = xw[c], f = fw[c];
#pragma unroll
          for (int q = 0; q < kRows; ++q) {
            const float g = gauss(y[q], x, inv2s2);
            add_folded(g, f, a[q]);
          }
        }
      } else {
        for (int c = first; c < nc; c += kStride) {
          const float4 x = xw[c];
          const float inv = iw[c];
#pragma unroll
          for (int q = 0; q < kRows; ++q) {
            const float g = gauss(y[q], x, inv2s2);
            add_moments(__fmul_rn(g, inv), x, a[q]);
          }
        }
      }
    }
    if (kTileSums) {
#pragma unroll
      for (int q = 0; q < kRows; ++q) {
        const float4 v = warp_sum4(a[q]);
        if (lane == q) {
          tot.x += v.x; tot.y += v.y; tot.z += v.z; tot.w += v.w;
        }
        a[q] = make_float4(0.f, 0.f, 0.f, 0.f);
      }
    }
  }
  if (kTileSums) {
    if (lane < kRows && r0 + lane < t1) p1px[r0 + lane] = tot;
  } else {
#pragma unroll
    for (int q = 0; q < kRows; ++q)
      if (r0 + q < t1) p1px[r0 + q] = a[q];
  }
}

// ---------------------------------------------------------------------------
// K11: the culled E-step on one source shard of a 2-D (m, n) mesh, three
// launches and one normalizer reduction per E-step, no stash.
//
// Replaces probreg_tpu/ops/estep_pallas.py:_stash_den_raw_kernel, with
// :_stash_moment_kernel as its pass B. A target column's normalizer sums
// over every source shard, so pass A stops before the finalisation:
// den_pass_kernel<true, true> walks every stripe's active source tiles as
// K3's pass A does and writes the raw column sums of the whole target shard.
// The caller all-reduces them over the m-axis once (torch.distributed);
// stash_finish_kernel forms inv_den, pt1 and xx from the sums of every
// column, in K3's pass-A chunk layout; K3's pass B forms each active pair's
// Gaussian again. The reference scans the stripes and psums each stripe's
// sums because its stash of one stripe must fit VMEM; a column sums the
// same operands either way. At one m-shard the route is K3 with pass A cut
// in two, so pt1, inv_den, xx, p1 and px equal K3's bit for bit. Bound: the
// FP32 pipe, as K3's passes.
// ---------------------------------------------------------------------------

// Grid (column chunks of 256, n_j stripes), kDenThreads threads: chunk cx
// of stripe j finalizes its columns from den_raw and writes xx_part[j][cx].
__global__ void __launch_bounds__(kDenThreads)
stash_finish_kernel(const float4* __restrict__ xs, int n, int tile_n,
                    const float* __restrict__ scal,
                    const float* __restrict__ den_raw,  // (n)
                    float* __restrict__ inv_den,        // (n)
                    float* __restrict__ pt1,            // (n)
                    float* __restrict__ xx_part) {  // (gridDim.y, gridDim.x)
  const int c0 = blockIdx.y * tile_n;
  const int col = blockIdx.x * kDenThreads + threadIdx.x;
  const bool ok = col < min(tile_n, n - c0);
  const float4 xv = ok ? xs[c0 + col] : make_float4(0.f, 0.f, 0.f, 0.f);
  den_finish_chunk(ok ? den_raw[c0 + col] : 0.0f, ok, xv, scal[1], c0 + col,
                   inv_den, pt1, xx_part + (size_t)blockIdx.y * gridDim.x,
                   blockIdx.x);
}

// ---------------------------------------------------------------------------
// K12: the pipelined culled E-step (use_merged_stash), two launches, no
// stash.
//
// Replaces probreg_tpu/ops/estep_pallas.py:_stash_merged_kernel. The TPU
// kernel stashes each stripe's exps and, in the grid step of stripe j, runs
// pass B of stripe j - 1 with the normalizer folded into the channels (p1
// += g * inv_den, px += g * (x * inv_den)); an epilogue closes the last
// stripe in the stash kernels' association (p = g * inv_den). The pipeline
// hides the moment half under the exp half on the TPU; on this card the
// stash (4 B per active pair written and read back) costs more than forming
// the Gaussian again. So pass A is K3's (the same inv_den, pt1 and xx), and
// pass B is moment_pass_kernel<true, true>: it forms each active pair's
// Gaussian with gauss(), folds the normalizer for every stripe but the last
// and adds a row's stripes in stripe order, as the stash read did. With a
// bf16 stash its pass B is K3's, moment_bf16_kernel (below).
// ---------------------------------------------------------------------------

// ---------------------------------------------------------------------------
// K3's fast branch (config.estep_fast_start): two launches, no stash.
//
// Replaces the DEFAULT-precision instantiation of
// probreg_tpu/ops/estep_pallas.py:_stash_den_kernel (pass A) and
// :_stash_moment_kernel (pass B) that the reference's estep_auto runs, with
// a bf16 stash, where its start-temperature bound allows (estep_cuda.
// fast_gate): there the cross term y.x is one bf16 pass of the TPU's matrix
// unit. Here it is one mma.sync.m16n8k8 (bf16 operands, f32 accumulator) per
// 16 sources x 8 targets: the coordinates are rounded to bf16 to nearest
// and zero-padded from D <= 3 to k = 8. |y|^2 and |x|^2 stay f32 from the
// unrounded points (the packed w), pre-scaled: -|x|^2 / 2 is the mma's
// addend and |y|^2 k a row's, so fast_gauss forms exp2f(max(d2, 0) k) with
// one FMA and one min before the exp; the culled tiles are K3's; pass A
// sums each column per active tile and adds the tiles in tile order, then
// den_finish_col; den stays f32 (summed before any rounding, as the
// reference sums it before its cast).
//
// Pass B reads the reference's bf16 stash: p = bf16(g) inv_den, px = x . p.
// Written as sum_n bf16(g)_mn v_n with v_n = inv_den_n (x_n, y_n, z_n, 1),
// it is a product on the tensor cores: estep_cuda.moment_operand splits
// each f32 v_n into three bf16 pieces (hi, mid, lo: their sum is v_n to
// ~2^-24), laid out in the B-fragment order of mma.sync.m16n8k16. g is
// exactly bf16, so each product with a piece is exact in the f32
// accumulator. The C fragments of two adjacent m16n8 cross-term tiles,
// each Gaussian packed to bf16 (the reference's cast), are the A fragment
// of m16n8k16 as they stand (FlashAttention-2's register reuse): per 16
// sources x 16 targets, two mma.sync m16n8k8 form the cross terms and two
// m16n8k16 the moments (B columns: channel c's hi and mid in 2c and 2c + 1
// of the first, its lo in 2c of the second), so lane tig ends with channel
// tig of its rows. Each stripe's sums (hi + (mid + lo)) go into the row's
// total in stripe order, K3's association at the stripe level.
//
// Same g in both passes: both put the sources in the A operand (rows) and
// the targets in B (columns), in 16-row groups from a source tile's start
// and 8-column groups from a stripe's start, so each pair takes the same
// fragment slot of the same instruction in either pass, and both call
// fast_gauss on it with the same k.
//
// Bound: the MUFU, 16 ex2 a clock an SM, one a pair. A pair's other work
// issues faster: the FMA and the min, exp2f's subnormal scaling (a compare
// and two predicated multiplies), and pass A's column sum or pass B's half
// a bf16 pack, ~6 of the 128 FP32-pipe lanes' slots against the MUFU's 8.
// The launch takes a device flag and returns at once where it is 0 (K3's
// exact kernels, launched beside it, return where it is 1).
// ---------------------------------------------------------------------------

// A point's bf16 coordinates for k slots 0-1 (x, y) and 2-3 (z, 0); slots
// 4-7 are zero.
__device__ __forceinline__ uint2 bf16_coords(float4 p) {
  return make_uint2(pack_bf16(p.x, p.y), pack_bf16(p.z, 0.0f));
}

// The operand register of lane tig: k slots 2 tig and 2 tig + 1.
__device__ __forceinline__ uint32_t frag_k(uint2 v, int tig) {
  return tig == 0 ? v.x : (tig == 1 ? v.y : 0u);
}

constexpr int kFastDenWarps = 8;   // pass A's block
constexpr int kFastDenThreads = 32 * kFastDenWarps;
constexpr int kFastWarpCols = kDenThreads / kFastDenWarps;  // 32
constexpr int kFastColTiles = kFastWarpCols / 8;            // 4
constexpr int kFastDenGroups = 4;  // 16-row groups in flight a warp

// Pass A: K3's grid (column chunks of 256, n_j stripes), kFastDenThreads
// threads; warp w holds columns [32 w, 32 w + 32) of the chunk as 4 column
// tiles and walks the stripe's active source tiles 256 rows at a time, 64
// at a time through the tensor cores (four 16-row groups in flight: as
// many independent exp chains as the card measured fastest). A lane sums
// its two rows of each group for its two columns of each column tile, the
// groups in row order; at a tile's end the 8 lanes of a column add their
// sums (a butterfly: the same bits in each) and the tile's sum goes into
// the column's den. Rows past a tile's end are staged with |y|^2 k = -inf:
// their Gaussian is exactly 0, so every pair adds without a select.
// kDump (tests only): every g the pass forms also goes to g_dump (m, n).
template <bool kDump>
__global__ void __launch_bounds__(kFastDenThreads)
den_fast_kernel(const float4* __restrict__ ys, int m, int tile_m, int n_i,
                const float4* __restrict__ xs, int n, int tile_n,
                const int* __restrict__ act_idx,   // (n_j, n_i)
                const int* __restrict__ act_cnt,   // (n_j)
                const float* __restrict__ scal,
                const int* __restrict__ run,       // the fast flag
                float* __restrict__ inv_den,       // (n)
                float* __restrict__ pt1,           // (n)
                float* __restrict__ xx_part,       // (gridDim.y, gridDim.x)
                float* __restrict__ g_dump) {
  if (*run == 0) return;  // the exact branch runs
  __shared__ uint2 yb[kDenThreads];   // staged rows' bf16 coordinates
  __shared__ float y2s[kDenThreads];  // and their |y|^2 k
  __shared__ float warps[kFastDenWarps];
  const int stripe = blockIdx.y, cx = blockIdx.x;
  const int c0 = stripe * tile_n;
  const int ncols = min(tile_n, n - c0);
  const size_t xx_at = (size_t)stripe * gridDim.x + cx;
  if (cx * kDenThreads >= ncols) {  // a chunk past a ragged stripe's end
    if (threadIdx.x == 0) xx_part[xx_at] = 0.0f;
    return;
  }
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int gid = lane >> 2, tig = lane & 3;
  const int wc = cx * kDenThreads + warp * kFastWarpCols;
  const float4 zero = make_float4(0.f, 0.f, 0.f, 0.f);
  uint32_t bf[kFastColTiles];
  float x2c[kFastColTiles][2], den[kFastColTiles][2];
  float4 xc[kFastColTiles];  // the mma's addend: -|x|^2 / 2 at both rows
#pragma unroll
  for (int q = 0; q < kFastColTiles; ++q) {
    const int cb = wc + 8 * q + gid;
    bf[q] = frag_k(bf16_coords(cb < ncols ? xs[c0 + cb] : zero), tig);
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int cc = wc + 8 * q + 2 * tig + e;
      x2c[q][e] = cc < ncols ? xs[c0 + cc].w : 0.0f;
      den[q][e] = 0.0f;
    }
    const float l = fast_col(x2c[q][0]), h = fast_col(x2c[q][1]);
    xc[q] = make_float4(l, h, l, h);
  }
  const float k = fast_scale(scal[0]);
  const int cnt = act_cnt[stripe];
  const int* idx = act_idx + (size_t)stripe * n_i;
  for (int t = 0; t < cnt; ++t) {
    const int r0 = idx[t] * tile_m;
    const int r1 = min(r0 + tile_m, m);
    float s[kFastColTiles][2] = {};  // this tile's sums
    for (int rc = r0; rc < r1; rc += kDenThreads) {
      const int nr = min(kDenThreads, r1 - rc);
      __syncthreads();
      for (int r = threadIdx.x; r < kDenThreads; r += kFastDenThreads) {
        const bool ok = r < nr;
        const float4 y = ok ? ys[rc + r] : zero;
        yb[r] = bf16_coords(y);
        y2s[r] = ok ? fast_row(y.w, k) : -__int_as_float(0x7f800000);
      }
      __syncthreads();
      for (int g0 = 0; g0 < nr; g0 += 16 * kFastDenGroups) {
        uint32_t a0[kFastDenGroups], a1[kFastDenGroups];
        float y2a[kFastDenGroups], y2b[kFastDenGroups];
#pragma unroll
        for (int j = 0; j < kFastDenGroups; ++j) {
          const int ra = g0 + 16 * j + gid, rb = ra + 8;
          a0[j] = frag_k(yb[ra], tig);
          a1[j] = frag_k(yb[rb], tig);
          y2a[j] = y2s[ra];
          y2b[j] = y2s[rb];
        }
#pragma unroll
        for (int q = 0; q < kFastColTiles; ++q)
#pragma unroll
          for (int j = 0; j < kFastDenGroups; ++j) {
            float d[4];
            mma_bf16(d, a0[j], a1[j], bf[q], xc[q]);
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              const float ga = fast_gauss(d[e], y2a[j], k);
              const float gb = fast_gauss(d[2 + e], y2b[j], k);
              s[q][e] = __fadd_rn(__fadd_rn(s[q][e], ga), gb);
              const int cc = wc + 8 * q + 2 * tig + e;
              const int ra = g0 + 16 * j + gid, rb = ra + 8;
              if (kDump && cc < ncols) {
                if (ra < nr) g_dump[(size_t)(rc + ra) * n + c0 + cc] = ga;
                if (rb < nr) g_dump[(size_t)(rc + rb) * n + c0 + cc] = gb;
              }
            }
          }
      }
    }
#pragma unroll
    for (int q = 0; q < kFastColTiles; ++q)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        float v = s[q][e];
        v = __fadd_rn(v, __shfl_xor_sync(0xffffffffu, v, 4));
        v = __fadd_rn(v, __shfl_xor_sync(0xffffffffu, v, 8));
        v = __fadd_rn(v, __shfl_xor_sync(0xffffffffu, v, 16));
        den[q][e] = __fadd_rn(den[q][e], v);
      }
  }
  // The lanes of gid 0 finalize their columns; the chunk's xx is the sum of
  // each such lane's shares (column tiles in order), over the warp, then
  // over the warps in order.
  float xxv = 0.0f;
  if (gid == 0) {
#pragma unroll
    for (int q = 0; q < kFastColTiles; ++q)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int cc = wc + 8 * q + 2 * tig + e;
        if (cc < ncols)
          xxv = __fadd_rn(xxv, den_finish_col(
                                   den[q][e],
                                   make_float4(0.f, 0.f, 0.f, x2c[q][e]),
                                   scal[1], c0 + cc, inv_den, pt1));
      }
  }
  const float v = warp_sum(xxv);
  if (lane == 0) warps[warp] = v;
  __syncthreads();
  if (threadIdx.x == 0) {
    float xx = 0.0f;
    for (int w = 0; w < kFastDenWarps; ++w) xx += warps[w];
    xx_part[xx_at] = xx;
  }
}

constexpr int kFastRowWarps = 4;   // pass B's block
constexpr int kFastRowThreads = 32 * kFastRowWarps;
constexpr int kFastRowGroups = 4;  // 16-row groups a warp holds
constexpr int kFastBlockRows = 16 * kFastRowWarps * kFastRowGroups;  // 256
constexpr int kFastStageGroups = kColStage / 16;  // operand groups a stage

// Pass B: grid (row blocks of 256, n_i source tiles), kFastRowThreads
// threads; warp w holds rows [64 w, 64 w + 64) of the block as four 16-row
// groups (a lane rows gid and gid + 8 of each; as many independent exp
// chains as the card measured fastest) and walks the tile's active
// stripes, 256 columns staged at a time, 16 at a time: per group two
// m16n8k8 cross terms, the 8 Gaussians of the lane packed to bf16 as the
// A fragment, and two m16n8k16 against the staged moment operand. Columns
// past a stripe's end carry a zero operand (the Gaussian of a zero-staged
// point is finite), so they add nothing. Rows past the tile are any valid
// point and are never written.
// kDump (tests only): every g the pass forms, before its rounding, also
// goes to g_dump (m, n).
template <bool kDump>
__global__ void __launch_bounds__(kFastRowThreads)
moment_fast_kernel(const float4* __restrict__ ys, int m, int tile_m,
                   const float4* __restrict__ xs, int n, int tile_n, int n_j,
                   const int* __restrict__ act_idx,   // (n_i, n_j)
                   const int* __restrict__ act_cnt,   // (n_i)
                   const float* __restrict__ scal,
                   const int* __restrict__ run,       // the fast flag
                   const uint4* __restrict__ mop,     // moment_operand
                   float* __restrict__ p1px,  // (m, 4): px in 0-2, p1 in 3
                   float* __restrict__ g_dump) {
  if (*run == 0) return;  // the exact branch runs
  __shared__ uint2 xb[kColStage];    // staged columns' bf16 coordinates
  // their -|x|^2 / 2 as mma_bf16's addend: [8-column group][tig]
  __shared__ float4 xcs[kColStage / 8][4];
  __shared__ uint4 ms[kFastStageGroups * 32];  // their moment operand
  const int tile = blockIdx.y;
  const int t1 = min((tile + 1) * tile_m, m);
  const int rb = tile * tile_m + blockIdx.x * kFastBlockRows;
  if (rb >= t1) return;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int gid = lane >> 2, tig = lane & 3;
  const int gps = (tile_n + 15) / 16;  // operand groups a stripe
  const float4 zero = make_float4(0.f, 0.f, 0.f, 0.f);
  int row[kFastRowGroups][2];
  uint32_t a[kFastRowGroups][2];
  float y2k[kFastRowGroups][2];
  const float k = fast_scale(scal[0]);
  float acc[kFastRowGroups][2][4];  // [group][mma][fragment]
  float tot[kFastRowGroups][2];     // channel tig of rows gid, gid + 8
#pragma unroll
  for (int h = 0; h < kFastRowGroups; ++h)
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      row[h][r] = rb + warp * 16 * kFastRowGroups + 16 * h + gid + 8 * r;
      const float4 y = ys[min(row[h][r], t1 - 1)];
      a[h][r] = frag_k(bf16_coords(y), tig);
      y2k[h][r] = fast_row(y.w, k);
      tot[h][r] = 0.0f;
    }
  const int cnt = act_cnt[tile];
  const int* idx = act_idx + (size_t)tile * n_j;
  for (int s = 0; s < cnt; ++s) {
    const int j = idx[s];
    const int c0 = j * tile_n;
    const int c1 = min(c0 + tile_n, n);
#pragma unroll
    for (int h = 0; h < kFastRowGroups; ++h)
#pragma unroll
      for (int q = 0; q < 2; ++q)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[h][q][e] = 0.0f;
    for (int cc = c0; cc < c1; cc += kColStage) {
      const int nc = min(kColStage, c1 - cc);
      const int ng = (nc + 15) / 16;
      const uint4* src = mop + ((size_t)j * gps + (cc - c0) / 16) * 32;
      __syncthreads();
      for (int t = threadIdx.x; t < kColStage; t += kFastRowThreads) {
        const float4 x = t < nc ? xs[cc + t] : zero;
        xb[t] = bf16_coords(x);
        float* c = &xcs[t >> 3][(t >> 1) & 3].x + (t & 1);
        c[0] = c[2] = fast_col(x.w);
      }
      for (int t = threadIdx.x; t < ng * 32; t += kFastRowThreads)
        ms[t] = src[t];
      __syncthreads();
      for (int g = 0; g < ng; ++g) {
        const int c16 = 16 * g;
        const uint32_t b0 = frag_k(xb[c16 + gid], tig);
        const uint32_t b1 = frag_k(xb[c16 + 8 + gid], tig);
        const float4 xl = xcs[2 * g][tig], xh = xcs[2 * g + 1][tig];
        const uint4 o = ms[g * 32 + lane];
#pragma unroll
        for (int h = 0; h < kFastRowGroups; ++h) {
          float d0[4], d1[4];
          mma_bf16(d0, a[h][0], a[h][1], b0, xl);
          mma_bf16(d1, a[h][0], a[h][1], b1, xh);
          // gv[4 t + 2 r + e]: column tile t, row gid + 8 r, column 2 tig + e.
          float gv[8];
#pragma unroll
          for (int r = 0; r < 2; ++r)
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              gv[2 * r + e] = fast_gauss(d0[2 * r + e], y2k[h][r], k);
              gv[4 + 2 * r + e] = fast_gauss(d1[2 * r + e], y2k[h][r], k);
            }
          const uint32_t p0 = pack_bf16(gv[0], gv[1]);
          const uint32_t p1 = pack_bf16(gv[2], gv[3]);
          const uint32_t p2 = pack_bf16(gv[4], gv[5]);
          const uint32_t p3 = pack_bf16(gv[6], gv[7]);
          mma_bf16_k16(acc[h][0], p0, p1, p2, p3, o.x, o.y);
          mma_bf16_k16(acc[h][1], p0, p1, p2, p3, o.z, o.w);
          if (kDump) {
#pragma unroll
            for (int e = 0; e < 8; ++e) {
              const int c = c16 + 8 * (e >> 2) + 2 * tig + (e & 1);
              const int rr = row[h][(e >> 1) & 1];
              if (c < nc && rr < t1) g_dump[(size_t)rr * n + cc + c] = gv[e];
            }
          }
        }
      }
    }
    // Channel tig of each row: hi (column 2 tig of the first product) +
    // (mid (2 tig + 1) + lo (2 tig of the second)).
#pragma unroll
    for (int h = 0; h < kFastRowGroups; ++h)
#pragma unroll
      for (int r = 0; r < 2; ++r)
        tot[h][r] = __fadd_rn(
            tot[h][r],
            __fadd_rn(acc[h][0][2 * r],
                      __fadd_rn(acc[h][0][2 * r + 1], acc[h][1][2 * r])));
  }
#pragma unroll
  for (int h = 0; h < kFastRowGroups; ++h)
#pragma unroll
    for (int r = 0; r < 2; ++r)
      if (row[h][r] < t1) p1px[(size_t)row[h][r] * 4 + tig] = tot[h][r];
}

// ---------------------------------------------------------------------------
// K3's and K12's pass B reading a bf16 stash (config.stash_dtype =
// bfloat16): one kernel for both routes.
//
// Replaces probreg_tpu/ops/estep_pallas.py:_stash_moment_kernel reading a
// bf16 stash (p = bf16(g) inv_den, then px = x . p) and the pass B of
// :_stash_merged_kernel with a bf16 stash (chan = (x inv_den, inv_den),
// then chan . bf16(g)). Both compute sum_n bf16(g_mn) v_n with v_n =
// inv_den_n (x_n, y_n, z_n, 1); they differ only in f32 rounding order,
// which the tensor cores change anyway, so both routes launch this kernel
// on the same operand and give the same bits.
//
// g is the exact f32 Gaussian of pass A (den_pass_kernel<true>): the same
// gauss(), on the same packed points, so the stash's bf16(g) is bf16 of
// pass A's own g (a card test holds the two passes' g bit for bit). No
// cross term goes to the tensor cores. Lane 4 gid + tig forms the 8
// Gaussians of rows gid and gid + 8 of a 16-row group at columns 2 tig,
// 2 tig + 1, 2 tig + 8 and 2 tig + 9 of a 16-column group: the k slots of
// the A fragment of mma.sync.m16n8k16 (mma_bf16_k16). Packed to bf16 to
// nearest even (pack_bf16: cvt.rn.bf16x2.f32, subnormals kept, the bits of
// __float2bfloat16_rn), they are the A operand as they stand. Two
// m16n8k16 against the staged moment_operand (moment_fast_kernel's
// layout: inv_den (x, 1) as three bf16 pieces, exact products with a bf16
// g in the f32 accumulator) give each channel's hi, mid and lo; a stripe's
// hi + (mid + lo) goes into the row's total in stripe order, as in
// moment_fast_kernel. Columns past a stripe's end are staged as zero
// points and carry the operand's zero padding, so they add nothing; rows
// past the tile are any valid point and are never written; culled tiles
// are never visited and add exact zeros.
//
// Bound: the FP32 pipe. The exact Gaussian is 15 issue slots a pair (the
// dot 3, d2 and its clamp 3, the scale 1, expf's range reduction around
// its one MUFU.EX2 8), its bf16 pack half a slot; the 24 bf16 operations
// of the moments go to the tensor cores, and a lane's four column loads
// and one operand load (shared memory, broadcast across the 8 lanes of a
// tig) serve all its row groups. Blocks of 4 warps x 4 row groups (256
// rows) were the fastest shape on the card at 131,072^2 dense; every
// shape gives the same bits. Blocks take the source tiles heaviest first
// (order: the tiles by active stripe count, descending): in a culled
// E-step a tile's work varies ~3x, and a heavy tile started last runs on
// alone at the end.
// kDump (tests only): every g the pass forms, before its rounding, also
// goes to g_dump (m, n).
constexpr int kB16Warps = 4;   // pass B's block
constexpr int kB16Groups = 4;  // 16-row groups a warp holds

template <bool kDump, int kWarps = kB16Warps, int kGroups = kB16Groups>
__global__ void __launch_bounds__(32 * kWarps)
moment_bf16_kernel(const float4* __restrict__ ys, int m, int tile_m,
                   const float4* __restrict__ xs, int n, int tile_n, int n_j,
                   const int* __restrict__ act_idx,   // (n_i, n_j)
                   const int* __restrict__ act_cnt,   // (n_i)
                   const int* __restrict__ order,     // (n_i)
                   const float* __restrict__ scal,
                   const uint4* __restrict__ mop,     // moment_operand
                   float* __restrict__ p1px,  // (m, 4): px in 0-2, p1 in 3
                   float* __restrict__ g_dump) {
  constexpr int kThreads = 32 * kWarps;
  constexpr int kBlockRows = 16 * kWarps * kGroups;
  __shared__ float4 xw[kColStage];             // x, y, z, |x|^2
  __shared__ uint4 ms[kFastStageGroups * 32];  // their moment operand
  const int tile = order[blockIdx.y];
  const int t1 = min((tile + 1) * tile_m, m);
  const int rb = tile * tile_m + blockIdx.x * kBlockRows;
  if (rb >= t1) return;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int gid = lane >> 2, tig = lane & 3;
  const int gps = (tile_n + 15) / 16;  // operand groups a stripe
  const float4 zero = make_float4(0.f, 0.f, 0.f, 0.f);
  const float inv2s2 = scal[0];
  int row[kGroups][2];
  float4 y[kGroups][2];
  float acc[kGroups][2][4];  // [group][mma][fragment]
  float tot[kGroups][2];     // channel tig of rows gid, gid + 8
#pragma unroll
  for (int h = 0; h < kGroups; ++h)
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      row[h][r] = rb + warp * 16 * kGroups + 16 * h + gid + 8 * r;
      y[h][r] = ys[min(row[h][r], t1 - 1)];
      tot[h][r] = 0.0f;
    }
  const int cnt = act_cnt[tile];
  const int* idx = act_idx + (size_t)tile * n_j;
  for (int s = 0; s < cnt; ++s) {
    const int j = idx[s];
    const int c0 = j * tile_n;
    const int c1 = min(c0 + tile_n, n);
#pragma unroll
    for (int h = 0; h < kGroups; ++h)
#pragma unroll
      for (int q = 0; q < 2; ++q)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[h][q][e] = 0.0f;
    for (int cc = c0; cc < c1; cc += kColStage) {
      const int nc = min(kColStage, c1 - cc);
      const int ng = (nc + 15) / 16;
      const uint4* src = mop + ((size_t)j * gps + (cc - c0) / 16) * 32;
      __syncthreads();
      for (int t = threadIdx.x; t < 16 * ng; t += kThreads)
        xw[t] = t < nc ? xs[cc + t] : zero;
      for (int t = threadIdx.x; t < ng * 32; t += kThreads) ms[t] = src[t];
      __syncthreads();
      for (int g = 0; g < ng; ++g) {
        // xc[2 t + e]: column 16 g + 8 t + 2 tig + e of the stage.
        const int c = 16 * g + 2 * tig;
        const float4 xc[4] = {xw[c], xw[c + 1], xw[c + 8], xw[c + 9]};
        const uint4 o = ms[g * 32 + lane];
#pragma unroll
        for (int h = 0; h < kGroups; ++h) {
          // gv[4 t + 2 r + e]: column 8 t + 2 tig + e, row gid + 8 r.
          float gv[8];
#pragma unroll
          for (int t = 0; t < 2; ++t)
#pragma unroll
            for (int r = 0; r < 2; ++r)
#pragma unroll
              for (int e = 0; e < 2; ++e)
                gv[4 * t + 2 * r + e] = gauss(y[h][r], xc[2 * t + e], inv2s2);
          const uint32_t p0 = pack_bf16(gv[0], gv[1]);
          const uint32_t p1 = pack_bf16(gv[2], gv[3]);
          const uint32_t p2 = pack_bf16(gv[4], gv[5]);
          const uint32_t p3 = pack_bf16(gv[6], gv[7]);
          mma_bf16_k16(acc[h][0], p0, p1, p2, p3, o.x, o.y);
          mma_bf16_k16(acc[h][1], p0, p1, p2, p3, o.z, o.w);
          if (kDump) {
#pragma unroll
            for (int e = 0; e < 8; ++e) {
              const int cl = c + 8 * (e >> 2) + (e & 1);
              const int rr = row[h][(e >> 1) & 1];
              if (cl < nc && rr < t1) g_dump[(size_t)rr * n + cc + cl] = gv[e];
            }
          }
        }
      }
    }
    // Channel tig of each row: hi (column 2 tig of the first product) +
    // (mid (2 tig + 1) + lo (2 tig of the second)).
#pragma unroll
    for (int h = 0; h < kGroups; ++h)
#pragma unroll
      for (int r = 0; r < 2; ++r)
        tot[h][r] = __fadd_rn(
            tot[h][r],
            __fadd_rn(acc[h][0][2 * r],
                      __fadd_rn(acc[h][0][2 * r + 1], acc[h][1][2 * r])));
  }
#pragma unroll
  for (int h = 0; h < kGroups; ++h)
#pragma unroll
    for (int r = 0; r < 2; ++r)
      if (row[h][r] < t1) p1px[(size_t)row[h][r] * 4 + tig] = tot[h][r];
}

template <int kWarps = kB16Warps, int kGroups = kB16Groups>
int launch_moment_bf16(const void* ys, int m, int tile_m, int n_i,
                       const void* xs, int n, int tile_n, int n_j,
                       const void* act_idx, const void* act_cnt,
                       const void* order, const void* scal, const void* mop,
                       void* p1px, void* g_dump, void* stream) {
  if (order == nullptr) return (int)cudaErrorInvalidValue;
  constexpr int rows = 16 * kWarps * kGroups;
  const dim3 grid((tile_m + rows - 1) / rows, n_i);
  const auto s = (cudaStream_t)stream;
  if (g_dump == nullptr)
    moment_bf16_kernel<false, kWarps, kGroups><<<grid, 32 * kWarps, 0, s>>>(
        (const float4*)ys, m, tile_m, (const float4*)xs, n, tile_n, n_j,
        (const int*)act_idx, (const int*)act_cnt, (const int*)order,
        (const float*)scal, (const uint4*)mop, (float*)p1px, nullptr);
  else
    moment_bf16_kernel<true, kWarps, kGroups><<<grid, 32 * kWarps, 0, s>>>(
        (const float4*)ys, m, tile_m, (const float4*)xs, n, tile_n, n_j,
        (const int*)act_idx, (const int*)act_cnt, (const int*)order,
        (const float*)scal, (const uint4*)mop, (float*)p1px,
        (float*)g_dump);
  return (int)cudaGetLastError();
}

// Tests only: pack_bf16 of (g[2 i], g[2 i + 1]) into packed[i], and each
// g by __float2bfloat16_rn (the conversion of a bf16 stash) into
// rounded[i], so a test can hold the pass's packing to it bit for bit.
__global__ void pack_check_kernel(const float* __restrict__ g, int pairs,
                                  uint32_t* __restrict__ packed,
                                  __nv_bfloat16* __restrict__ rounded) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= pairs) return;
  packed[i] = pack_bf16(g[2 * i], g[2 * i + 1]);
  rounded[2 * i] = __float2bfloat16_rn(g[2 * i]);
  rounded[2 * i + 1] = __float2bfloat16_rn(g[2 * i + 1]);
}

template <bool kTileSums, bool kRaw = false, bool kDump = false>
int launch_den_pass(const void* ys, int m, int tile_m, int n_i,
                    const void* xs, int n, int tile_n, int n_j,
                    const void* act_idx, const void* act_cnt,
                    const void* scal, const void* skip, void* inv_den,
                    void* pt1, void* xx_part, void* den_raw, void* stream,
                    void* g_dump = nullptr) {
  const dim3 grid((tile_n + kDenThreads - 1) / kDenThreads, n_j);
  den_pass_kernel<kTileSums, kRaw, kDump><<<grid, kPairThreads, 0,
                                            (cudaStream_t)stream>>>(
      (const float4*)ys, m, tile_m, n_i, (const float4*)xs, n, tile_n,
      (const int*)act_idx, (const int*)act_cnt, (const float*)scal,
      (const int*)skip, (float*)inv_den, (float*)pt1, (float*)xx_part,
      (float*)den_raw, (float*)g_dump);
  return (int)cudaGetLastError();
}

template <bool kTileSums, bool kFold = false>
int launch_moment_pass(const void* ys, int m, int tile_m, int n_i,
                       const void* xs, int n, int tile_n, int n_j,
                       const void* act_idx, const void* act_cnt,
                       const void* scal, const void* skip,
                       const void* inv_den, void* p1px, void* stream) {
  constexpr int rows = moment_block_rows<kTileSums>();
  const dim3 grid((tile_m + rows - 1) / rows, n_i);
  moment_pass_kernel<kTileSums, kFold><<<grid, kRowThreads, 0,
                                         (cudaStream_t)stream>>>(
      (const float4*)ys, m, tile_m, (const float4*)xs, n, tile_n, n_j,
      (const int*)act_idx, (const int*)act_cnt, (const float*)scal,
      (const int*)skip, (const float*)inv_den, (float4*)p1px);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// K2. ys (m, dim), xs (n, dim) f32; sigma2 a device f32 scalar or null
// (then sigma2_val); tiles of rows x cols (powers of two from 16 to 256,
// rows * cols = 4,096); blocks walk them (cooperative launch: at most
// probreg_estep_small_capacity). work: 4 (nc m) + nr n + nc + nr floats;
// tickets: 1 + nc + nr, zero, left zero. Outputs pt1 (n), p1 (m), px (m,
// dim), stats [n_p, xx].
int probreg_estep_small(const void* ys, int m, const void* xs, int n,
                        int dim, const void* sigma2, float sigma2_val,
                        float w, float one_minus_w, int rows, int cols,
                        int blocks, void* work,
                        void* tickets, void* pt1, void* p1, void* px,
                        void* stats, void* stream) {
  const bool pow2 = rows > 0 && cols > 0 && (rows & (rows - 1)) == 0 &&
                    (cols & (cols - 1)) == 0;
  if (!pow2 || rows * cols != kSmallTilePairs || rows > kSmallThreads ||
      cols > kSmallThreads || m <= 0 || n <= 0 || blocks <= 0 || dim < 1 ||
      dim > 3)
    return (int)cudaErrorInvalidValue;
  SmallArgs a;
  a.ys = (const float*)ys;
  a.xs = (const float*)xs;
  a.sigma2 = (const float*)sigma2;
  a.sigma2_val = sigma2_val;
  a.w = w;
  a.one_minus_w = one_minus_w;
  a.m = m;
  a.n = n;
  a.rows = rows;
  a.cols = cols;
  a.nr = (m + rows - 1) / rows;
  a.nc = (n + cols - 1) / cols;
  a.log_rows = __builtin_ctz(rows);
  a.log_cols = __builtin_ctz(cols);
  a.part = (float4*)work;
  a.den_part = (float*)(a.part + (size_t)a.nc * m);
  a.xx_part = a.den_part + (size_t)a.nr * n;
  a.np_part = a.xx_part + a.nc;
  a.tickets = (unsigned int*)tickets;
  a.pt1 = (float*)pt1;
  a.p1 = (float*)p1;
  a.px = (float*)px;
  a.stats = (float*)stats;
  const auto s = (cudaStream_t)stream;
  switch (dim) {
    case 1: return launch_small<1>(a, blocks, s);
    case 2: return launch_small<2>(a, blocks, s);
    default: return launch_small<3>(a, blocks, s);
  }
}

// The blocks of K2's cooperative kernel for dimension dim that can be
// resident at once on the current device.
int probreg_estep_small_capacity(int dim, void* out) {
  switch (dim) {
    case 1: return small_capacity<1>((int*)out);
    case 2: return small_capacity<2>((int*)out);
    default: return small_capacity<3>((int*)out);
  }
}

// One launch of a kernel that does nothing, plain or cooperative.
int probreg_empty_launch(int cooperative, void* stream) {
  const auto s = (cudaStream_t)stream;
  if (cooperative) {
    int zero = 0;
    void* args[] = {(void*)&zero};
    const cudaError_t err = cudaLaunchCooperativeKernel(
        (const void*)empty_kernel, dim3(1), dim3(32), args, 0, s);
    const cudaError_t last = cudaGetLastError();
    return (int)(err != cudaSuccess ? err : last);
  } else {
    empty_kernel<<<1, 32, 0, s>>>(0);
  }
  return (int)cudaGetLastError();
}

int probreg_stash_den(const void* ys, int m, int tile_m, int n_i,
                      const void* xs, int n, int tile_n, int n_j,
                      const void* act_idx, const void* act_cnt,
                      const void* scal, void* inv_den, void* pt1,
                      void* xx_part, void* stream) {
  return launch_den_pass<true>(ys, m, tile_m, n_i, xs, n, tile_n, n_j,
                               act_idx, act_cnt, scal, nullptr, inv_den, pt1,
                               xx_part, nullptr, stream);
}

int probreg_stash_rows(const void* ys, int m, int tile_m, int n_i,
                       const void* xs, int n, int tile_n, int n_j,
                       const void* act_idx, const void* act_cnt,
                       const void* scal, const void* inv_den, void* p1px,
                       void* stream) {
  return launch_moment_pass<true>(ys, m, tile_m, n_i, xs, n, tile_n, n_j,
                                  act_idx, act_cnt, scal, nullptr, inv_den,
                                  p1px, stream);
}

int probreg_stash_den_raw(const void* ys, int m, int tile_m, int n_i,
                          const void* xs, int n, int tile_n, int n_j,
                          const void* act_idx, const void* act_cnt,
                          const void* scal, void* den_raw, void* stream) {
  return launch_den_pass<true, true>(ys, m, tile_m, n_i, xs, n, tile_n, n_j,
                                     act_idx, act_cnt, scal, nullptr,
                                     nullptr, nullptr, nullptr, den_raw,
                                     stream);
}

int probreg_stash_finish(const void* xs, int n, int tile_n, int n_j,
                         const void* scal, const void* den_raw, void* inv_den,
                         void* pt1, void* xx_part, void* stream) {
  const dim3 grid((tile_n + kDenThreads - 1) / kDenThreads, n_j);
  stash_finish_kernel<<<grid, kDenThreads, 0, (cudaStream_t)stream>>>(
      (const float4*)xs, n, tile_n, (const float*)scal, (const float*)den_raw,
      (float*)inv_den, (float*)pt1, (float*)xx_part);
  return (int)cudaGetLastError();
}

int probreg_stash_merged(const void* ys, int m, int tile_m, int n_i,
                         const void* xs, int n, int tile_n, int n_j,
                         const void* act_idx, const void* act_cnt,
                         const void* scal, const void* inv_den, void* p1px,
                         void* stream) {
  return launch_moment_pass<true, true>(ys, m, tile_m, n_i, xs, n, tile_n,
                                        n_j, act_idx, act_cnt, scal, nullptr,
                                        inv_den, p1px, stream);
}

int probreg_fused_den(const void* ys, int m, int tile_m, int n_i,
                      const void* xs, int n, int tile_n, int n_j,
                      const void* act_idx, const void* act_cnt,
                      const void* scal, void* inv_den, void* pt1,
                      void* xx_part, void* stream) {
  return launch_den_pass<false>(ys, m, tile_m, n_i, xs, n, tile_n, n_j,
                                act_idx, act_cnt, scal, nullptr, inv_den, pt1,
                                xx_part, nullptr, stream);
}

int probreg_fused_moment(const void* ys, int m, int tile_m, int n_i,
                         const void* xs, int n, int tile_n, int n_j,
                         const void* act_idx, const void* act_cnt,
                         const void* scal, const void* inv_den, void* p1px,
                         void* stream) {
  return launch_moment_pass<false>(ys, m, tile_m, n_i, xs, n, tile_n, n_j,
                                   act_idx, act_cnt, scal, nullptr, inv_den,
                                   p1px, stream);
}

// K3's exact passes for the gated route: they return at once where *gate
// is 1 (the fast passes below run).
int probreg_stash_den_gated(const void* ys, int m, int tile_m, int n_i,
                            const void* xs, int n, int tile_n, int n_j,
                            const void* act_idx, const void* act_cnt,
                            const void* scal, const void* gate,
                            void* inv_den, void* pt1, void* xx_part,
                            void* stream) {
  return launch_den_pass<true>(ys, m, tile_m, n_i, xs, n, tile_n, n_j,
                               act_idx, act_cnt, scal, gate, inv_den, pt1,
                               xx_part, nullptr, stream);
}

int probreg_stash_rows_gated(const void* ys, int m, int tile_m, int n_i,
                             const void* xs, int n, int tile_n, int n_j,
                             const void* act_idx, const void* act_cnt,
                             const void* scal, const void* gate,
                             const void* inv_den, void* p1px, void* stream) {
  return launch_moment_pass<true>(ys, m, tile_m, n_i, xs, n, tile_n, n_j,
                                  act_idx, act_cnt, scal, gate, inv_den,
                                  p1px, stream);
}

// K3's fast passes: they run only where *gate is 1. g_dump: null, or an
// (m, n) buffer that takes every g the pass forms (tests only).
int probreg_stash_den_fast(const void* ys, int m, int tile_m, int n_i,
                           const void* xs, int n, int tile_n, int n_j,
                           const void* act_idx, const void* act_cnt,
                           const void* scal, const void* gate, void* inv_den,
                           void* pt1, void* xx_part, void* g_dump,
                           void* stream) {
  if (gate == nullptr) return (int)cudaErrorInvalidValue;
  const dim3 grid((tile_n + kDenThreads - 1) / kDenThreads, n_j);
  const auto s = (cudaStream_t)stream;
  if (g_dump == nullptr)
    den_fast_kernel<false><<<grid, kFastDenThreads, 0, s>>>(
        (const float4*)ys, m, tile_m, n_i, (const float4*)xs, n, tile_n,
        (const int*)act_idx, (const int*)act_cnt, (const float*)scal,
        (const int*)gate, (float*)inv_den, (float*)pt1, (float*)xx_part,
        nullptr);
  else
    den_fast_kernel<true><<<grid, kFastDenThreads, 0, s>>>(
        (const float4*)ys, m, tile_m, n_i, (const float4*)xs, n, tile_n,
        (const int*)act_idx, (const int*)act_cnt, (const float*)scal,
        (const int*)gate, (float*)inv_den, (float*)pt1, (float*)xx_part,
        (float*)g_dump);
  return (int)cudaGetLastError();
}

int probreg_stash_rows_fast(const void* ys, int m, int tile_m, int n_i,
                            const void* xs, int n, int tile_n, int n_j,
                            const void* act_idx, const void* act_cnt,
                            const void* scal, const void* gate,
                            const void* mop, void* p1px, void* g_dump,
                            void* stream) {
  if (gate == nullptr) return (int)cudaErrorInvalidValue;
  const dim3 grid((tile_m + kFastBlockRows - 1) / kFastBlockRows, n_i);
  const auto s = (cudaStream_t)stream;
  if (g_dump == nullptr)
    moment_fast_kernel<false><<<grid, kFastRowThreads, 0, s>>>(
        (const float4*)ys, m, tile_m, (const float4*)xs, n, tile_n, n_j,
        (const int*)act_idx, (const int*)act_cnt, (const float*)scal,
        (const int*)gate, (const uint4*)mop, (float*)p1px, nullptr);
  else
    moment_fast_kernel<true><<<grid, kFastRowThreads, 0, s>>>(
        (const float4*)ys, m, tile_m, (const float4*)xs, n, tile_n, n_j,
        (const int*)act_idx, (const int*)act_cnt, (const float*)scal,
        (const int*)gate, (const uint4*)mop, (float*)p1px, (float*)g_dump);
  return (int)cudaGetLastError();
}

// K3's and K12's pass B reading a bf16 stash (config.stash_dtype): both
// launch moment_bf16_kernel against mop, moment_operand of inv_den after
// pass A, the source tiles in ``order`` (n_i). g_dump: null, or an (m, n)
// buffer that takes every g the pass forms, before its rounding (tests
// only).
int probreg_stash_rows_bf16(const void* ys, int m, int tile_m, int n_i,
                            const void* xs, int n, int tile_n, int n_j,
                            const void* act_idx, const void* act_cnt,
                            const void* scal, const void* order,
                            const void* mop, void* p1px, void* g_dump,
                            void* stream) {
  return launch_moment_bf16(ys, m, tile_m, n_i, xs, n, tile_n, n_j, act_idx,
                            act_cnt, order, scal, mop, p1px, g_dump, stream);
}

int probreg_stash_merged_bf16(const void* ys, int m, int tile_m, int n_i,
                              const void* xs, int n, int tile_n, int n_j,
                              const void* act_idx, const void* act_cnt,
                              const void* scal, const void* order,
                              const void* mop, void* p1px, void* g_dump,
                              void* stream) {
  return launch_moment_bf16(ys, m, tile_m, n_i, xs, n, tile_n, n_j, act_idx,
                            act_cnt, order, scal, mop, p1px, g_dump, stream);
}

// Tests only: K3's pass A (probreg_stash_den) with every g it forms also
// written to g_dump (m, n).
int probreg_stash_den_dump(const void* ys, int m, int tile_m, int n_i,
                           const void* xs, int n, int tile_n, int n_j,
                           const void* act_idx, const void* act_cnt,
                           const void* scal, void* inv_den, void* pt1,
                           void* xx_part, void* g_dump, void* stream) {
  if (g_dump == nullptr) return (int)cudaErrorInvalidValue;
  return launch_den_pass<true, false, true>(
      ys, m, tile_m, n_i, xs, n, tile_n, n_j, act_idx, act_cnt, scal,
      nullptr, inv_den, pt1, xx_part, nullptr, stream, g_dump);
}

// Tests only: pack_check_kernel over the 2 * pairs f32 values of g.
int probreg_pack_bf16_check(const void* g, int pairs, void* packed,
                            void* rounded, void* stream) {
  if (pairs <= 0) return (int)cudaErrorInvalidValue;
  pack_check_kernel<<<(pairs + 255) / 256, 256, 0, (cudaStream_t)stream>>>(
      (const float*)g, pairs, (uint32_t*)packed, (__nv_bfloat16*)rounded);
  return (int)cudaGetLastError();
}

}  // extern "C"
