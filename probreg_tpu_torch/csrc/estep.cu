// CPD E-step kernels for Hopper (sm_90a), bound to Python with ctypes.
//
// Points arrive packed as float4 (x, y, z, |p|^2), one 16-byte load per
// point; clouds of dimension < 3 carry zeros in the unused coordinates.
// Every kernel computes the Gaussian of a pair exactly as the reference's
// _dist_tile: d2 = max(|y|^2 + |x|^2 - 2 y.x, 0), g = expf(-d2 * inv2s2),
// in IEEE f32 (FMAs, expf, IEEE division; no fast-math: FTZ or the
// approximate exp would change results near the 104 cull bound).
//
// Scalars come from the device (scal = [0.5 / sigma2, outlier c]) so an EM
// iteration needs no host round trip. Each entry point launches on the
// caller's stream, allocates nothing and returns cudaGetLastError().
//
// Reductions across blocks never use float atomics: blocks write partial
// sums, and the last block to finish (an atomic ticket) adds them up in a
// fixed order. So the results are deterministic from run to run.

#include <cuda_runtime.h>

namespace {

constexpr float kEpsF32 = 1.1920928955078125e-07f;  // np.finfo(f32).eps

__device__ __forceinline__ float gauss(float4 y, float4 x, float inv2s2) {
  float xy = y.x * x.x + y.y * x.y + y.z * x.z;
  float d2 = fmaxf(y.w + x.w - 2.0f * xy, 0.0f);
  return expf(-d2 * inv2s2);
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
// blocks sharing `ticket`. The caller's global writes before the call are
// visible to that block (threadfence-reduction pattern); it reads them
// back with __ldcg, which bypasses the non-coherent L1.
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

// ---------------------------------------------------------------------------
// K2: the whole small E-step in one launch.
//
// Replaces probreg_tpu/ops/estep_pallas.py:_small_kernel (estep_small). The
// TPU kernel keeps the (M, N) posterior in VMEM; here M * N <= 2^20 pairs
// and the cost is launch latency plus ~1e6 exps, far below any bound of the
// card. Each block owns 32 target columns and loops over all M sources, so
// a column's normalizer is complete inside the block (8 warps x 32 lanes,
// partials summed in warp order). A second sweep recomputes the exps (twice
// the exps of the TPU kernel, cheaper than a (M, 32) buffer per block) and
// writes per-row partials of p1/px; the last block sums them over blocks in
// block order. pt1 = den_raw / den and p = g / den use divisions as the
// reference kernel does.
// ---------------------------------------------------------------------------
constexpr int kSmallCols = 32;
constexpr int kSmallThreads = 256;

__global__ void __launch_bounds__(kSmallThreads)
small_kernel(const float4* __restrict__ ys, int m,
             const float4* __restrict__ xs, int n,
             const float* __restrict__ scal,
             float* __restrict__ pt1,        // (n)
             float4* __restrict__ part,      // (gridDim.x, m) row partials
             float* __restrict__ xx_part,    // (gridDim.x)
             unsigned int* __restrict__ ticket,
             float4* __restrict__ p1px,      // (m): px in xyz, p1 in w
             float* __restrict__ xx) {
  __shared__ float den_w[kSmallThreads / 32][kSmallCols];
  __shared__ float den_sh[kSmallCols];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int nwarps = kSmallThreads / 32;
  const int col = blockIdx.x * kSmallCols + lane;
  const bool ok = col < n;
  const float4 xv = ok ? xs[col] : make_float4(0.f, 0.f, 0.f, 0.f);
  const float inv2s2 = scal[0], c = scal[1];

  float s = 0.0f;
  if (ok)
    for (int r = warp; r < m; r += nwarps) s += gauss(ys[r], xv, inv2s2);
  den_w[warp][lane] = s;
  __syncthreads();
  if (warp == 0) {
    float den_raw = 0.0f;
    for (int w = 0; w < nwarps; ++w) den_raw += den_w[w][lane];
    const float den = (den_raw == 0.0f ? kEpsF32 : den_raw) + c;
    const float p = den_raw / den;
    den_sh[lane] = den;
    if (ok) pt1[col] = p;
    const float xxv = warp_sum(ok ? p * xv.w : 0.0f);
    if (lane == 0) xx_part[blockIdx.x] = xxv;
  }
  __syncthreads();

  const float den = den_sh[lane];
  for (int r = warp; r < m; r += nwarps) {
    const float p = ok ? gauss(ys[r], xv, inv2s2) / den : 0.0f;
    const float a0 = warp_sum(p * xv.x), a1 = warp_sum(p * xv.y);
    const float a2 = warp_sum(p * xv.z), a3 = warp_sum(p);
    if (lane == 0)
      part[(size_t)blockIdx.x * m + r] = make_float4(a0, a1, a2, a3);
  }

  if (!last_block(ticket, gridDim.x)) return;
  for (int r = threadIdx.x; r < m; r += kSmallThreads) {
    float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int b = 0; b < (int)gridDim.x; ++b) {
      const float4 v = __ldcg(&part[(size_t)b * m + r]);
      acc.x += v.x; acc.y += v.y; acc.z += v.z; acc.w += v.w;
    }
    p1px[r] = acc;
  }
  if (threadIdx.x == 0) {
    float t = 0.0f;
    for (int b = 0; b < (int)gridDim.x; ++b) t += __ldcg(&xx_part[b]);
    *xx = t;
    *ticket = 0u;  // ready for another launch on the same buffers
  }
}

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
// sums and writes den_raw of its columns instead.
template <bool kTileSums, bool kRaw = false>
__global__ void __launch_bounds__(kPairThreads)
den_pass_kernel(const float4* __restrict__ ys, int m, int tile_m, int n_i,
                const float4* __restrict__ xs, int n, int tile_n,
                const int* __restrict__ act_idx,   // (n_j, n_i)
                const int* __restrict__ act_cnt,   // (n_j)
                const float* __restrict__ scal,
                float* __restrict__ inv_den,       // (n)
                float* __restrict__ pt1,           // (n)
                float* __restrict__ xx_part,       // (gridDim.y, gridDim.x)
                float* __restrict__ den_raw) {     // kRaw: (n)
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
// (add_folded); the last keeps p = g * inv_den (add_moments).
template <bool kTileSums, bool kFold = false>
__global__ void __launch_bounds__(kRowThreads)
moment_pass_kernel(const float4* __restrict__ ys, int m, int tile_m,
                   const float4* __restrict__ xs, int n, int tile_n, int n_j,
                   const int* __restrict__ act_idx,   // (n_i, n_j)
                   const int* __restrict__ act_cnt,   // (n_i)
                   const float* __restrict__ scal,
                   const float* __restrict__ inv_den, // (n)
                   float4* __restrict__ p1px) {  // (m): px in xyz, p1 in w
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
          for (int q = 0; q < kRows; ++q)
            add_folded(gauss(y[q], x, inv2s2), f, a[q]);
        }
      } else {
        for (int c = first; c < nc; c += kStride) {
          const float4 x = xw[c];
          const float inv = iw[c];
#pragma unroll
          for (int q = 0; q < kRows; ++q)
            add_moments(__fmul_rn(gauss(y[q], x, inv2s2), inv), x, a[q]);
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
// and adds a row's stripes in stripe order, as the stash read did.
// ---------------------------------------------------------------------------

template <bool kTileSums, bool kRaw = false>
int launch_den_pass(const void* ys, int m, int tile_m, int n_i,
                    const void* xs, int n, int tile_n, int n_j,
                    const void* act_idx, const void* act_cnt,
                    const void* scal, void* inv_den, void* pt1,
                    void* xx_part, void* den_raw, void* stream) {
  const dim3 grid((tile_n + kDenThreads - 1) / kDenThreads, n_j);
  den_pass_kernel<kTileSums, kRaw><<<grid, kPairThreads, 0,
                                     (cudaStream_t)stream>>>(
      (const float4*)ys, m, tile_m, n_i, (const float4*)xs, n, tile_n,
      (const int*)act_idx, (const int*)act_cnt, (const float*)scal,
      (float*)inv_den, (float*)pt1, (float*)xx_part, (float*)den_raw);
  return (int)cudaGetLastError();
}

template <bool kTileSums, bool kFold = false>
int launch_moment_pass(const void* ys, int m, int tile_m, int n_i,
                       const void* xs, int n, int tile_n, int n_j,
                       const void* act_idx, const void* act_cnt,
                       const void* scal, const void* inv_den, void* p1px,
                       void* stream) {
  constexpr int rows = moment_block_rows<kTileSums>();
  const dim3 grid((tile_m + rows - 1) / rows, n_i);
  moment_pass_kernel<kTileSums, kFold><<<grid, kRowThreads, 0,
                                         (cudaStream_t)stream>>>(
      (const float4*)ys, m, tile_m, (const float4*)xs, n, tile_n, n_j,
      (const int*)act_idx, (const int*)act_cnt, (const float*)scal,
      (const float*)inv_den, (float4*)p1px);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

int probreg_estep_small(const void* ys, int m, const void* xs, int n,
                        const void* scal, void* pt1, void* part,
                        void* xx_part, void* ticket, void* p1px, void* xx,
                        void* stream) {
  const int blocks = (n + kSmallCols - 1) / kSmallCols;
  small_kernel<<<blocks, kSmallThreads, 0, (cudaStream_t)stream>>>(
      (const float4*)ys, m, (const float4*)xs, n, (const float*)scal,
      (float*)pt1, (float4*)part, (float*)xx_part, (unsigned int*)ticket,
      (float4*)p1px, (float*)xx);
  return (int)cudaGetLastError();
}

int probreg_stash_den(const void* ys, int m, int tile_m, int n_i,
                      const void* xs, int n, int tile_n, int n_j,
                      const void* act_idx, const void* act_cnt,
                      const void* scal, void* inv_den, void* pt1,
                      void* xx_part, void* stream) {
  return launch_den_pass<true>(ys, m, tile_m, n_i, xs, n, tile_n, n_j,
                               act_idx, act_cnt, scal, inv_den, pt1, xx_part,
                               nullptr, stream);
}

int probreg_stash_rows(const void* ys, int m, int tile_m, int n_i,
                       const void* xs, int n, int tile_n, int n_j,
                       const void* act_idx, const void* act_cnt,
                       const void* scal, const void* inv_den, void* p1px,
                       void* stream) {
  return launch_moment_pass<true>(ys, m, tile_m, n_i, xs, n, tile_n, n_j,
                                  act_idx, act_cnt, scal, inv_den, p1px,
                                  stream);
}

int probreg_stash_den_raw(const void* ys, int m, int tile_m, int n_i,
                          const void* xs, int n, int tile_n, int n_j,
                          const void* act_idx, const void* act_cnt,
                          const void* scal, void* den_raw, void* stream) {
  return launch_den_pass<true, true>(ys, m, tile_m, n_i, xs, n, tile_n, n_j,
                                     act_idx, act_cnt, scal, nullptr,
                                     nullptr, nullptr, den_raw, stream);
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
                                        n_j, act_idx, act_cnt, scal, inv_den,
                                        p1px, stream);
}

int probreg_fused_den(const void* ys, int m, int tile_m, int n_i,
                      const void* xs, int n, int tile_n, int n_j,
                      const void* act_idx, const void* act_cnt,
                      const void* scal, void* inv_den, void* pt1,
                      void* xx_part, void* stream) {
  return launch_den_pass<false>(ys, m, tile_m, n_i, xs, n, tile_n, n_j,
                                act_idx, act_cnt, scal, inv_den, pt1, xx_part,
                                nullptr, stream);
}

int probreg_fused_moment(const void* ys, int m, int tile_m, int n_i,
                         const void* xs, int n, int tile_n, int n_j,
                         const void* act_idx, const void* act_cnt,
                         const void* scal, const void* inv_den, void* p1px,
                         void* stream) {
  return launch_moment_pass<false>(ys, m, tile_m, n_i, xs, n, tile_n, n_j,
                                   act_idx, act_cnt, scal, inv_den, p1px,
                                   stream);
}

}  // extern "C"
