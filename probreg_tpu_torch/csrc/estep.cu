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

__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
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
// K3a: pass A of the stash E-step, one target stripe per launch.
//
// Replaces probreg_tpu/ops/estep_pallas.py:_stash_den_kernel. For each
// ACTIVE source tile of the stripe (compacted list act_idx[0..cnt)), g is
// computed once per pair, written to the stash (rows of the tile, tile_n
// columns, row-major so a warp writes 128 contiguous bytes) and summed per
// column. Grid: (column chunks of 256, n_i slots); slots >= cnt exit.
// Per-slot column sums go to `part`; the last block of a column chunk adds
// them in slot (= tile) order and forms inv_den, pt1 and the chunk's xx.
//
// Bound on this card: at full density the stash write (4 B per pair, far
// beyond the 50 MB L2 at 150k points) takes longer than the exps, so the
// kernel is bound by memory bandwidth; culled tiles cost neither.
//
// Pass A is three device functions that K3a, the pipelined kernel K12 and
// the sharded pass K11 share: stash_exp_block (the exps, the stash and the
// per-slot column sums), den_raw_sum (the slot-order sum) and
// den_finish_chunk (inv_den, pt1 and xx from the raw sums). So all three
// give the same pt1, inv_den and xx bit for bit on the same raw sums.
// ---------------------------------------------------------------------------
constexpr int kDenThreads = 256;

// The exps of one block: column chunk `cx` (256 columns, this thread's
// column xv, valid when ok) against the tile in slot `slot` of the
// stripe's active-tile list. Writes the tile's stash rows and the block's
// column sums to part[slot].
__device__ void stash_exp_block(const float4* __restrict__ ys, int m,
                                int tile_m, float4 xv, bool ok, int col,
                                int tile_n, const int* __restrict__ act_idx,
                                float inv2s2, float* __restrict__ stash,
                                float* __restrict__ part, int slot) {
  __shared__ float4 ysh[kDenThreads];
  const int r0 = act_idx[slot] * tile_m;
  const int r1 = min(r0 + tile_m, m);
  float s = 0.0f;
  for (int rc = r0; rc < r1; rc += kDenThreads) {
    const int nr = min(kDenThreads, r1 - rc);
    __syncthreads();
    if (threadIdx.x < nr) ysh[threadIdx.x] = ys[rc + threadIdx.x];
    __syncthreads();
    if (ok) {
      float* out = stash + (size_t)rc * tile_n + col;
      for (int r = 0; r < nr; ++r) {
        const float g = gauss(ysh[r], xv, inv2s2);
        out[(size_t)r * tile_n] = g;
        s += g;
      }
    }
  }
  if (ok) part[(size_t)slot * tile_n + col] = s;
}

// A column's raw normalizer: its per-slot sums added in slot order. Read
// by the last block of the chunk (see last_block).
__device__ __forceinline__ float den_raw_sum(const float* part, int cnt,
                                             int tile_n, int col) {
  float den_raw = 0.0f;
  for (int k = 0; k < cnt; ++k) den_raw += __ldcg(&part[(size_t)k * tile_n + col]);
  return den_raw;
}

// The normalizer's finalisation for one chunk of 256 columns, every thread
// of the block taking part: inv_den = 1 / ((den_raw == 0 ? eps : den_raw)
// + c), pt1 = den_raw * inv_den, and the chunk's xx = sum pt1 |x|^2 in
// xx_part[cx].
__device__ void den_finish_chunk(float den_raw, bool ok, float4 xv, float c,
                                 int col, float* __restrict__ inv_den,
                                 float* __restrict__ pt1,
                                 float* __restrict__ xx_part, int cx) {
  float xxv = 0.0f;
  if (ok) {
    const float inv = 1.0f / ((den_raw == 0.0f ? kEpsF32 : den_raw) + c);
    const float p = den_raw * inv;
    inv_den[col] = inv;
    pt1[col] = p;
    xxv = p * xv.w;
  }
  const float xx = block_sum<kDenThreads>(xxv);
  if (threadIdx.x == 0) xx_part[cx] = xx;
}

// Pass A for one block: column chunk `cx` (256 columns) of the stripe
// against slot `slot` of its active-tile list (cnt entries).
__device__ void stash_den_block(const float4* __restrict__ ys, int m,
                                int tile_m, const float4* __restrict__ xs,
                                int ncols, int tile_n,
                                const int* __restrict__ act_idx, int cnt,
                                const float* __restrict__ scal,
                                float* __restrict__ stash,
                                float* __restrict__ part,
                                unsigned int* __restrict__ tickets,
                                float* __restrict__ inv_den,
                                float* __restrict__ pt1,
                                float* __restrict__ xx_part, int cx,
                                int slot) {
  // An all-culled stripe still needs its pt1 = 0: slot 0 then finalizes.
  const int expected = cnt > 0 ? cnt : 1;
  if (slot >= expected) return;
  const int col = cx * kDenThreads + threadIdx.x;
  const bool ok = col < ncols;
  const float4 xv = ok ? xs[col] : make_float4(0.f, 0.f, 0.f, 0.f);
  if (slot < cnt)
    stash_exp_block(ys, m, tile_m, xv, ok, col, tile_n, act_idx, scal[0],
                    stash, part, slot);
  if (!last_block(&tickets[cx], expected)) return;
  const float den_raw = ok ? den_raw_sum(part, cnt, tile_n, col) : 0.0f;
  den_finish_chunk(den_raw, ok, xv, scal[1], col, inv_den, pt1, xx_part, cx);
  if (threadIdx.x == 0) tickets[cx] = 0u;  // ready for the next stripe
}

__global__ void __launch_bounds__(kDenThreads)
stash_den_kernel(const float4* __restrict__ ys, int m, int tile_m,
                 const float4* __restrict__ xs, int ncols, int tile_n,
                 const int* __restrict__ act_idx,
                 const int* __restrict__ act_cnt,
                 const float* __restrict__ scal,
                 float* __restrict__ stash,     // (n_i * tile_m, tile_n)
                 float* __restrict__ part,      // (n_i, tile_n)
                 unsigned int* __restrict__ tickets,  // (gridDim.x), zero
                 float* __restrict__ inv_den,   // (tile_n)
                 float* __restrict__ pt1,       // (ncols), this stripe
                 float* __restrict__ xx_part) { // (gridDim.x), this stripe
  stash_den_block(ys, m, tile_m, xs, ncols, tile_n, act_idx, *act_cnt, scal,
                  stash, part, tickets, inv_den, pt1, xx_part, blockIdx.x,
                  blockIdx.y);
}

// ---------------------------------------------------------------------------
// K11: pass A of the stash E-step on one source shard, raw sums only.
//
// Replaces probreg_tpu/ops/estep_pallas.py:_stash_den_raw_kernel. On a 2-D
// (m, n) mesh a target column's normalizer sums over every source shard, so
// pass A stops before the finalisation: the same exps, stash and slot-order
// column sums as K3a (stash_exp_block, den_raw_sum), and the last block of
// a chunk writes den_raw. The caller all-reduces den_raw over the m-axis
// (torch.distributed), then stash_finish_kernel runs K3a's finalisation
// (den_finish_chunk) on the sums, and K3b reads the stash back. So at one
// m-shard, K11 + finish + K3b give K3's pt1, inv_den, xx, p1 and px bit for
// bit. Bound as K3a: the stash write at full density.
// ---------------------------------------------------------------------------
__global__ void __launch_bounds__(kDenThreads)
stash_den_raw_kernel(const float4* __restrict__ ys, int m, int tile_m,
                     const float4* __restrict__ xs, int ncols, int tile_n,
                     const int* __restrict__ act_idx,
                     const int* __restrict__ act_cnt,
                     const float* __restrict__ scal,
                     float* __restrict__ stash,     // (n_i * tile_m, tile_n)
                     float* __restrict__ part,      // (n_i, tile_n)
                     unsigned int* __restrict__ tickets,  // (gridDim.x)
                     float* __restrict__ den_raw) { // (ncols)
  const int cnt = *act_cnt, cx = blockIdx.x, slot = blockIdx.y;
  // An all-culled stripe still needs its den_raw = 0: slot 0 writes it.
  const int expected = cnt > 0 ? cnt : 1;
  if (slot >= expected) return;
  const int col = cx * kDenThreads + threadIdx.x;
  const bool ok = col < ncols;
  const float4 xv = ok ? xs[col] : make_float4(0.f, 0.f, 0.f, 0.f);
  if (slot < cnt)
    stash_exp_block(ys, m, tile_m, xv, ok, col, tile_n, act_idx, scal[0],
                    stash, part, slot);
  if (!last_block(&tickets[cx], expected)) return;
  if (ok) den_raw[col] = den_raw_sum(part, cnt, tile_n, col);
  if (threadIdx.x == 0) tickets[cx] = 0u;
}

// K11's finalisation of one stripe from its all-reduced raw sums: one block
// per chunk of 256 columns, K3a's own tail (den_finish_chunk).
__global__ void __launch_bounds__(kDenThreads)
stash_finish_kernel(const float4* __restrict__ xs, int ncols,
                    const float* __restrict__ scal,
                    const float* __restrict__ den_raw,  // (ncols)
                    float* __restrict__ inv_den,        // (tile_n)
                    float* __restrict__ pt1,            // (ncols)
                    float* __restrict__ xx_part) {      // (gridDim.x)
  const int col = blockIdx.x * kDenThreads + threadIdx.x;
  const bool ok = col < ncols;
  const float4 xv = ok ? xs[col] : make_float4(0.f, 0.f, 0.f, 0.f);
  den_finish_chunk(ok ? den_raw[col] : 0.0f, ok, xv, scal[1], col, inv_den,
                   pt1, xx_part, blockIdx.x);
}

// ---------------------------------------------------------------------------
// K3b: pass B of the stash E-step, one target stripe per launch.
//
// Replaces probreg_tpu/ops/estep_pallas.py:_stash_moment_kernel. Reads the
// stash of each active tile (no exp), p = g * inv_den, and adds the row sums
// p1 and px = sum_j p x_j into the (M) accumulators. A warp owns a row and
// its lanes stride the stripe's columns (coalesced stash reads), so each
// row is written by one lane per launch: no atomics, and stripes accumulate
// in launch order. Culled tiles add nothing, so their rows keep exactly the
// sum of the other stripes. Bound: the stash read, 4 B per active pair.
// ---------------------------------------------------------------------------
constexpr int kMomThreads = 256;
constexpr int kMomRows = 64;  // rows per block

// Pass B for one block: rows [rblk * 64, +64) of the tile in slot `slot`
// of the stripe's active-tile list (cnt entries). xw: (ncols) float4 of
// shared memory. kFolded (K12) folds inv_den into the channels,
// p1 += g * inv_den and px += g * (x * inv_den), as the reference's
// pipelined kernel does; otherwise p = g * inv_den, p1 += p, px += p * x.
template <bool kFolded>
__device__ void stash_moment_block(const float4* __restrict__ xs, int ncols,
                                   int tile_n, int m, int tile_m,
                                   const int* __restrict__ act_idx, int cnt,
                                   const float* __restrict__ stash,
                                   const float* __restrict__ inv_den,
                                   float4* __restrict__ p1px, float4* xw,
                                   int rblk, int slot) {
  if (slot >= cnt) return;
  const int t0 = act_idx[slot] * tile_m;
  const int rb = t0 + rblk * kMomRows;
  const int re = min(min(rb + kMomRows, t0 + tile_m), m);
  if (rb >= re) return;
  for (int c = threadIdx.x; c < ncols; c += kMomThreads) {
    float4 x = xs[c];
    const float inv = inv_den[c];
    if (kFolded) {
      x.x *= inv;
      x.y *= inv;
      x.z *= inv;
    }
    x.w = inv;
    xw[c] = x;
  }
  __syncthreads();
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  for (int r = rb + warp; r < re; r += kMomThreads / 32) {
    const float* row = stash + (size_t)r * tile_n;
    float a0 = 0.f, a1 = 0.f, a2 = 0.f, a3 = 0.f;
    for (int c = lane; c < ncols; c += 32) {
      const float4 x = xw[c];
      if (kFolded) {
        const float g = row[c];
        a3 += g * x.w;
        a0 += g * x.x;
        a1 += g * x.y;
        a2 += g * x.z;
      } else {
        const float p = row[c] * x.w;
        a3 += p;
        a0 += p * x.x;
        a1 += p * x.y;
        a2 += p * x.z;
      }
    }
    a0 = warp_sum(a0); a1 = warp_sum(a1); a2 = warp_sum(a2); a3 = warp_sum(a3);
    if (lane == 0) {
      float4 acc = p1px[r];
      acc.x += a0; acc.y += a1; acc.z += a2; acc.w += a3;
      p1px[r] = acc;
    }
  }
}

__global__ void __launch_bounds__(kMomThreads)
stash_moment_kernel(const float4* __restrict__ xs, int ncols, int tile_n,
                    int m, int tile_m,
                    const int* __restrict__ act_idx,
                    const int* __restrict__ act_cnt,
                    const float* __restrict__ stash,
                    const float* __restrict__ inv_den,
                    float4* __restrict__ p1px) {  // (m) accumulators
  extern __shared__ float4 xw[];  // (ncols): x, y, z, inv_den
  stash_moment_block<false>(xs, ncols, tile_n, m, tile_m, act_idx, *act_cnt,
                            stash, inv_den, p1px, xw, blockIdx.x,
                            blockIdx.y);
}

// ---------------------------------------------------------------------------
// K12: the pipelined stash E-step, one launch per target stripe.
//
// Replaces probreg_tpu/ops/estep_pallas.py:_stash_merged_kernel. Launch j
// runs pass A of stripe j (stash_den_block, K3a's code: the exp once per
// active pair into stash buffer j % 2, the column sums, inv_den, pt1, xx)
// and pass B of stripe j - 1 (stash_moment_block with the normalizer folded
// into the channels, from buffer (j - 1) % 2). The blocks take their role
// from blockIdx: for each slot of the compacted lists, n_cx pass-A blocks
// (256 columns each) and then n_rb pass-B blocks (64 rows each), so the
// active slots, which come first, are scheduled first. The two halves touch
// disjoint buffers; the previous launch's writes are visible by stream
// order. After the last stripe one K3b launch closes it (as the reference's
// epilogue does), so an E-step makes n_j + 1 launches where K3 makes 2 n_j.
//
// What bounds it on this card: the function needs only its operations, 12
// + 8 per active pair (~6.7 ms per dense 150k E-step on an H100; its inputs
// and outputs are a few MB), but this design moves the stash, 4 B per
// active pair written by pass A and 4 B read by pass B, ~53.7 ms of HBM
// traffic at that size. So the stash, not the exps, sets its time, as for
// K3; the two-pass K4, which forms the Gaussian twice and keeps no stash,
// computes the same moments faster. On the TPU the fusion hid the moment
// half under the exp half; here both halves' blocks share the SMs within
// one launch, so one half's memory stalls can be covered by the other's
// arithmetic, and the launch count halves. Cross-block sums are K3a's
// last-block ticket (no float atomics): results are deterministic.
// ---------------------------------------------------------------------------
static_assert(kDenThreads == kMomThreads, "K12 blocks take both roles");

__global__ void __launch_bounds__(kDenThreads)
stash_merged_kernel(const float4* __restrict__ ys, int m, int tile_m,
                    const float4* __restrict__ xs, int ncols, int tile_n,
                    const int* __restrict__ act_idx,
                    const int* __restrict__ act_cnt,
                    const float* __restrict__ scal,
                    float* __restrict__ stash,
                    float* __restrict__ part,
                    unsigned int* __restrict__ tickets,
                    float* __restrict__ inv_den,
                    float* __restrict__ pt1,
                    float* __restrict__ xx_part,
                    const float4* __restrict__ pxs, int pncols,
                    const int* __restrict__ pact_idx,
                    const int* __restrict__ pact_cnt,  // 0 on stripe 0
                    const float* __restrict__ pstash,
                    const float* __restrict__ pinv_den,
                    float4* __restrict__ p1px, int n_cx, int n_rb) {
  extern __shared__ float4 xw[];  // pass B: (pncols)
  const int per_slot = n_cx + n_rb;
  const int slot = blockIdx.x / per_slot;
  const int role = blockIdx.x - slot * per_slot;
  if (role < n_cx)
    stash_den_block(ys, m, tile_m, xs, ncols, tile_n, act_idx, *act_cnt,
                    scal, stash, part, tickets, inv_den, pt1, xx_part, role,
                    slot);
  else
    stash_moment_block<true>(pxs, pncols, tile_n, m, tile_m, pact_idx,
                             *pact_cnt, pstash, pinv_den, p1px, xw,
                             role - n_cx, slot);
}

// ---------------------------------------------------------------------------
// K4a: pass A of the two-pass E-step, every target stripe in one launch.
//
// Replaces probreg_tpu/ops/estep_pallas.py:_den_kernel. A block owns 256
// columns of one stripe and walks that stripe's ACTIVE source tiles in
// ascending order (act_idx[stripe][0..cnt)), so a column's normalizer is
// complete inside the block: no partials, no ticket. It writes inv_den, pt1
// and the block's share of xx; the shares are added up in block order by
// the caller. Culled tiles are never visited, so they add exact zeros.
//
// Nothing per pair goes to device memory: the kernel is bound by operations
// (one Gaussian per active pair), where K3a is bound by its 4 B-per-pair
// stash write.
// ---------------------------------------------------------------------------
constexpr int kFusedThreads = 256;

__global__ void __launch_bounds__(kFusedThreads)
fused_den_kernel(const float4* __restrict__ ys, int m, int tile_m, int n_i,
                 const float4* __restrict__ xs, int n, int tile_n,
                 const int* __restrict__ act_idx,   // (n_j, n_i)
                 const int* __restrict__ act_cnt,   // (n_j)
                 const float* __restrict__ scal,
                 float* __restrict__ inv_den,       // (n)
                 float* __restrict__ pt1,           // (n)
                 float* __restrict__ xx_part) {     // (gridDim.y, gridDim.x)
  __shared__ float4 ysh[kFusedThreads];
  const int stripe = blockIdx.y;
  const int c0 = stripe * tile_n;
  const int col = c0 + blockIdx.x * kFusedThreads + threadIdx.x;
  const bool ok = col < min(c0 + tile_n, n);
  const float4 xv = ok ? xs[col] : make_float4(0.f, 0.f, 0.f, 0.f);
  const float inv2s2 = scal[0];
  const int cnt = act_cnt[stripe];
  const int* idx = act_idx + (size_t)stripe * n_i;
  float s = 0.0f;
  for (int k = 0; k < cnt; ++k) {
    const int r0 = idx[k] * tile_m;
    const int r1 = min(r0 + tile_m, m);
    for (int rc = r0; rc < r1; rc += kFusedThreads) {
      const int nr = min(kFusedThreads, r1 - rc);
      __syncthreads();
      if (threadIdx.x < nr) ysh[threadIdx.x] = ys[rc + threadIdx.x];
      __syncthreads();
      if (ok)
        for (int r = 0; r < nr; ++r) s += gauss(ysh[r], xv, inv2s2);
    }
  }
  float xxv = 0.0f;
  if (ok) {
    const float inv = 1.0f / ((s == 0.0f ? kEpsF32 : s) + scal[1]);
    const float p = s * inv;
    inv_den[col] = inv;
    pt1[col] = p;
    xxv = p * xv.w;
  }
  const float xx = block_sum<kFusedThreads>(xxv);
  if (threadIdx.x == 0) xx_part[blockIdx.y * gridDim.x + blockIdx.x] = xx;
}

// ---------------------------------------------------------------------------
// K4b: pass B of the two-pass E-step, every source tile in one launch.
//
// Replaces probreg_tpu/ops/estep_pallas.py:_moment_kernel. A block owns 256
// rows of one source tile and walks that tile's ACTIVE target stripes in
// ascending order (the compaction along the other axis). The Gaussian is
// computed again (no stash), multiplied by inv_den and summed into the
// thread's own row: p1 and px need no cross-thread sum and no atomics, and
// a row of a tile with no active stripe gets exact zeros. Bound: operations
// (one Gaussian and the four moment FMAs per active pair).
// ---------------------------------------------------------------------------
__global__ void __launch_bounds__(kFusedThreads)
fused_moment_kernel(const float4* __restrict__ ys, int m, int tile_m,
                    const float4* __restrict__ xs, int n, int tile_n,
                    int n_j,
                    const int* __restrict__ act_idx,   // (n_i, n_j)
                    const int* __restrict__ act_cnt,   // (n_i)
                    const float* __restrict__ scal,
                    const float* __restrict__ inv_den,
                    float4* __restrict__ p1px) {       // (m)
  __shared__ float4 xw[kFusedThreads];  // x, y, z, |x|^2
  __shared__ float iw[kFusedThreads];   // inv_den
  const int tile = blockIdx.y;
  const int r0 = tile * tile_m;
  const int row = r0 + blockIdx.x * kFusedThreads + threadIdx.x;
  const bool ok = row < min(r0 + tile_m, m);
  const float4 yv = ok ? ys[row] : make_float4(0.f, 0.f, 0.f, 0.f);
  const float inv2s2 = scal[0];
  const int cnt = act_cnt[tile];
  const int* idx = act_idx + (size_t)tile * n_j;
  float a0 = 0.f, a1 = 0.f, a2 = 0.f, a3 = 0.f;
  for (int k = 0; k < cnt; ++k) {
    const int c0 = idx[k] * tile_n;
    const int c1 = min(c0 + tile_n, n);
    for (int cc = c0; cc < c1; cc += kFusedThreads) {
      const int nc = min(kFusedThreads, c1 - cc);
      __syncthreads();
      if (threadIdx.x < nc) {
        xw[threadIdx.x] = xs[cc + threadIdx.x];
        iw[threadIdx.x] = inv_den[cc + threadIdx.x];
      }
      __syncthreads();
      if (ok)
        for (int c = 0; c < nc; ++c) {
          const float4 x = xw[c];
          const float p = gauss(yv, x, inv2s2) * iw[c];
          a3 += p;
          a0 += p * x.x;
          a1 += p * x.y;
          a2 += p * x.z;
        }
    }
  }
  if (ok) p1px[row] = make_float4(a0, a1, a2, a3);
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
                      const void* xs, int ncols, int tile_n,
                      const void* act_idx, const void* act_cnt,
                      const void* scal, void* stash, void* part,
                      void* tickets, void* inv_den, void* pt1, void* xx_part,
                      void* stream) {
  const dim3 grid((tile_n + kDenThreads - 1) / kDenThreads, n_i);
  stash_den_kernel<<<grid, kDenThreads, 0, (cudaStream_t)stream>>>(
      (const float4*)ys, m, tile_m, (const float4*)xs, ncols, tile_n,
      (const int*)act_idx, (const int*)act_cnt, (const float*)scal,
      (float*)stash, (float*)part, (unsigned int*)tickets, (float*)inv_den,
      (float*)pt1, (float*)xx_part);
  return (int)cudaGetLastError();
}

int probreg_stash_den_raw(const void* ys, int m, int tile_m, int n_i,
                          const void* xs, int ncols, int tile_n,
                          const void* act_idx, const void* act_cnt,
                          const void* scal, void* stash, void* part,
                          void* tickets, void* den_raw, void* stream) {
  const dim3 grid((tile_n + kDenThreads - 1) / kDenThreads, n_i);
  stash_den_raw_kernel<<<grid, kDenThreads, 0, (cudaStream_t)stream>>>(
      (const float4*)ys, m, tile_m, (const float4*)xs, ncols, tile_n,
      (const int*)act_idx, (const int*)act_cnt, (const float*)scal,
      (float*)stash, (float*)part, (unsigned int*)tickets, (float*)den_raw);
  return (int)cudaGetLastError();
}

int probreg_stash_finish(const void* xs, int ncols, int tile_n,
                         const void* scal, const void* den_raw, void* inv_den,
                         void* pt1, void* xx_part, void* stream) {
  const int blocks = (tile_n + kDenThreads - 1) / kDenThreads;
  stash_finish_kernel<<<blocks, kDenThreads, 0, (cudaStream_t)stream>>>(
      (const float4*)xs, ncols, (const float*)scal, (const float*)den_raw,
      (float*)inv_den, (float*)pt1, (float*)xx_part);
  return (int)cudaGetLastError();
}

int probreg_stash_moment(const void* xs, int ncols, int tile_n, int m,
                         int tile_m, int n_i, const void* act_idx,
                         const void* act_cnt, const void* stash,
                         const void* inv_den, void* p1px, void* stream) {
  const dim3 grid((tile_m + kMomRows - 1) / kMomRows, n_i);
  const size_t smem = (size_t)ncols * sizeof(float4);
  stash_moment_kernel<<<grid, kMomThreads, smem, (cudaStream_t)stream>>>(
      (const float4*)xs, ncols, tile_n, m, tile_m, (const int*)act_idx,
      (const int*)act_cnt, (const float*)stash, (const float*)inv_den,
      (float4*)p1px);
  return (int)cudaGetLastError();
}

int probreg_stash_merged(const void* ys, int m, int tile_m, int n_i,
                         const void* xs, int ncols, int tile_n,
                         const void* act_idx, const void* act_cnt,
                         const void* scal, void* stash, void* part,
                         void* tickets, void* inv_den, void* pt1,
                         void* xx_part, const void* pxs, int pncols,
                         const void* pact_idx, const void* pact_cnt,
                         const void* pstash, const void* pinv_den,
                         void* p1px, void* stream) {
  const int n_cx = (tile_n + kDenThreads - 1) / kDenThreads;
  const int n_rb = (tile_m + kMomRows - 1) / kMomRows;
  const size_t smem = (size_t)pncols * sizeof(float4);
  stash_merged_kernel<<<n_i * (n_cx + n_rb), kDenThreads, smem,
                        (cudaStream_t)stream>>>(
      (const float4*)ys, m, tile_m, (const float4*)xs, ncols, tile_n,
      (const int*)act_idx, (const int*)act_cnt, (const float*)scal,
      (float*)stash, (float*)part, (unsigned int*)tickets, (float*)inv_den,
      (float*)pt1, (float*)xx_part, (const float4*)pxs, pncols,
      (const int*)pact_idx, (const int*)pact_cnt, (const float*)pstash,
      (const float*)pinv_den, (float4*)p1px, n_cx, n_rb);
  return (int)cudaGetLastError();
}

int probreg_fused_den(const void* ys, int m, int tile_m, int n_i,
                      const void* xs, int n, int tile_n, int n_j,
                      const void* act_idx, const void* act_cnt,
                      const void* scal, void* inv_den, void* pt1,
                      void* xx_part, void* stream) {
  const dim3 grid((tile_n + kFusedThreads - 1) / kFusedThreads, n_j);
  fused_den_kernel<<<grid, kFusedThreads, 0, (cudaStream_t)stream>>>(
      (const float4*)ys, m, tile_m, n_i, (const float4*)xs, n, tile_n,
      (const int*)act_idx, (const int*)act_cnt, (const float*)scal,
      (float*)inv_den, (float*)pt1, (float*)xx_part);
  return (int)cudaGetLastError();
}

int probreg_fused_moment(const void* ys, int m, int tile_m, int n_i,
                         const void* xs, int n, int tile_n, int n_j,
                         const void* act_idx, const void* act_cnt,
                         const void* scal, const void* inv_den, void* p1px,
                         void* stream) {
  const dim3 grid((tile_m + kFusedThreads - 1) / kFusedThreads, n_i);
  fused_moment_kernel<<<grid, kFusedThreads, 0, (cudaStream_t)stream>>>(
      (const float4*)ys, m, tile_m, (const float4*)xs, n, tile_n, n_j,
      (const int*)act_idx, (const int*)act_cnt, (const float*)scal,
      (const float*)inv_den, (float4*)p1px);
  return (int)cudaGetLastError();
}

}  // extern "C"
