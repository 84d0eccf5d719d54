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
// column's s + g stays an add whether g is also stored (K11, K12) or not
// (K3), and a row's moments are p1 + p, px + p * x (one FMA per channel)
// whether p comes from a stash (per-stripe pass B) or from gauss() (K3). So
// the kernels that share these give the same bits.
__device__ __forceinline__ void add_moments(float p, float4 x, float4& a) {
  a.w = __fadd_rn(a.w, p);
  a.x = __fmaf_rn(p, x.x, a.x);
  a.y = __fmaf_rn(p, x.y, a.y);
  a.z = __fmaf_rn(p, x.z, a.z);
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
// Pass A of the per-stripe stash E-step, one target stripe per launch: the
// pass A of K11 (the sharded pass) and of the pipelined kernel K12.
//
// For each ACTIVE source tile of the stripe (compacted list act_idx[0..cnt)),
// g is computed once per pair, written to the stash (rows of the tile,
// tile_n columns, row-major so a warp writes 128 contiguous bytes) and
// summed per column. Grid: (column chunks of 256, n_i slots); slots >= cnt
// exit. Per-slot column sums go to `part`; the last block of a column chunk
// adds them in slot (= tile) order and forms inv_den, pt1 and the chunk's
// xx.
//
// Bound on this card: at full density the stash write (4 B per pair, far
// beyond the 50 MB L2 at 150k points) takes longer than the exps; culled
// tiles cost neither. The default route (K3, below) keeps no stash.
//
// The pieces are device functions: stash_exp_block (the exps, the stash
// and the per-slot column sums), den_raw_sum (the slot-order sum) and
// den_finish_col / den_finish_chunk (inv_den, pt1 and xx from the raw
// sums). K3's pass A forms the same per-tile sums in the same order and
// finishes with den_finish_col, so K3, K11 and K12 give the same pt1,
// inv_den and xx bit for bit.
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
        s = __fadd_rn(s, g);
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

// ---------------------------------------------------------------------------
// K11: pass A of the stash E-step on one source shard, raw sums only.
//
// Replaces probreg_tpu/ops/estep_pallas.py:_stash_den_raw_kernel. On a 2-D
// (m, n) mesh a target column's normalizer sums over every source shard, so
// pass A stops before the finalisation: the exps, the stash and the
// slot-order column sums (stash_exp_block, den_raw_sum), and the last block
// of a chunk writes den_raw. The caller all-reduces den_raw over the m-axis
// (torch.distributed), then stash_finish_kernel runs the finalisation
// (den_finish_chunk) on the sums, and the per-stripe pass B
// (stash_moment_kernel) reads the stash back. So at one m-shard, K11 +
// finish + pass B give K3's pt1, inv_den, xx, p1 and px bit for bit. Bound:
// the stash write at full density.
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
// per chunk of 256 columns (den_finish_chunk).
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
// Pass B of the per-stripe stash E-step, one target stripe per launch: the
// pass B of K11 and the epilogue of K12.
//
// Replaces probreg_tpu/ops/estep_pallas.py:_stash_moment_kernel on those
// routes. Reads the stash of each active tile (no exp), p = g * inv_den,
// and adds the row sums p1 and px = sum_j p x_j into the (M) accumulators.
// A warp owns a row and its lanes stride the stripe's columns (coalesced
// stash reads), so each row is written by one lane per launch: no atomics,
// and stripes accumulate in launch order. Culled tiles add nothing, so
// their rows keep exactly the sum of the other stripes. Bound: the stash
// read, 4 B per active pair. K3's pass B keeps this per-row order with the
// Gaussian formed again (moment_pass_kernel<true>).
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
    float4 a = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int c = lane; c < ncols; c += 32) {
      const float4 x = xw[c];
      if (kFolded) {
        const float g = row[c];
        a.w += g * x.w;
        a.x += g * x.x;
        a.y += g * x.y;
        a.z += g * x.z;
      } else {
        add_moments(__fmul_rn(row[c], x.w), x, a);
      }
    }
    a = warp_sum4(a);
    if (lane == 0) {
      float4 acc = p1px[r];
      acc.x += a.x; acc.y += a.y; acc.z += a.z; acc.w += a.w;
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
// runs pass A of stripe j (stash_den_block: the exp once per active pair
// into stash buffer j % 2, the column sums, inv_den, pt1, xx)
// and pass B of stripe j - 1 (stash_moment_block with the normalizer folded
// into the channels, from buffer (j - 1) % 2). The blocks take their role
// from blockIdx: for each slot of the compacted lists, n_cx pass-A blocks
// (256 columns each) and then n_rb pass-B blocks (64 rows each), so the
// active slots, which come first, are scheduled first. The two halves touch
// disjoint buffers; the previous launch's writes are visible by stream
// order. After the last stripe one launch of the per-stripe pass B
// (stash_moment_kernel) closes it, as the reference's epilogue does, so an
// E-step makes n_j + 1 launches (K3: 2).
//
// What bounds it on this card: the function needs only its operations, 12
// + 8 per active pair (~6.7 ms per dense 150k E-step on an H100; its inputs
// and outputs are a few MB), but this design moves the stash, 4 B per
// active pair written by pass A and 4 B read by pass B, ~53.7 ms of HBM
// traffic at that size. So the stash, not the exps, sets its time; K3 and
// the two-pass K4, which form the Gaussian twice and keep no stash,
// compute the same moments faster. On the TPU the fusion hid the moment
// half under the exp half; here both halves' blocks share the SMs within
// one launch, so one half's memory stalls can be covered by the other's
// arithmetic. Cross-block sums take the last-block ticket (no float
// atomics): results are deterministic.
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
//   partials to the column's normalizer in slot (= tile) order from 0,
//   which is den_raw_sum's sum of stash_exp_block's partials. Pass B keeps
//   the per-stripe pass B's per-row order: lane l takes columns l, l + 32,
//   ... of a stripe, the lanes' partials are added by warp_sum, and the
//   stripe sums go to the row's total in ascending stripe order from 0,
//   with p = g * inv_den and g bit for bit the g that stash_exp_block
//   stores. So K3's inv_den, pt1, xx_part, p1 and px equal K11's and K12's
//   on the same tiles.
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
// chunk's xx to xx_part[j][cx].
template <bool kTileSums>
__global__ void __launch_bounds__(kPairThreads)
den_pass_kernel(const float4* __restrict__ ys, int m, int tile_m, int n_i,
                const float4* __restrict__ xs, int n, int tile_n,
                const int* __restrict__ act_idx,   // (n_j, n_i)
                const int* __restrict__ act_cnt,   // (n_j)
                const float* __restrict__ scal,
                float* __restrict__ inv_den,       // (n)
                float* __restrict__ pt1,           // (n)
                float* __restrict__ xx_part) {     // (gridDim.y, gridDim.x)
  __shared__ float4 ysh[kDenThreads];
  __shared__ float warps[kDenThreads / 32];
  const int stripe = blockIdx.y, cx = blockIdx.x;
  const int c0 = stripe * tile_n;
  const int ncols = min(tile_n, n - c0);
  float* xx_out = xx_part + (size_t)stripe * gridDim.x + cx;
  if (cx * kDenThreads >= ncols) {  // a chunk past a ragged stripe's end
    if (threadIdx.x == 0) *xx_out = 0.0f;
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
    *xx_out = xx;
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
// px of its rows (zeros where no stripe is active).
template <bool kTileSums>
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
    for (int cc = c0; cc < c1; cc += kColStage) {
      const int nc = min(kColStage, c1 - cc);
      __syncthreads();
      if (threadIdx.x < nc) {
        xw[threadIdx.x] = xs[cc + threadIdx.x];
        iw[threadIdx.x] = inv_den[cc + threadIdx.x];
      }
      __syncthreads();
      for (int c = first; c < nc; c += kStride) {
        const float4 x = xw[c];
        const float inv = iw[c];
#pragma unroll
        for (int q = 0; q < kRows; ++q)
          add_moments(__fmul_rn(gauss(y[q], x, inv2s2), inv), x, a[q]);
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

template <bool kTileSums>
int launch_den_pass(const void* ys, int m, int tile_m, int n_i,
                    const void* xs, int n, int tile_n, int n_j,
                    const void* act_idx, const void* act_cnt,
                    const void* scal, void* inv_den, void* pt1,
                    void* xx_part, void* stream) {
  const dim3 grid((tile_n + kDenThreads - 1) / kDenThreads, n_j);
  den_pass_kernel<kTileSums><<<grid, kPairThreads, 0, (cudaStream_t)stream>>>(
      (const float4*)ys, m, tile_m, n_i, (const float4*)xs, n, tile_n,
      (const int*)act_idx, (const int*)act_cnt, (const float*)scal,
      (float*)inv_den, (float*)pt1, (float*)xx_part);
  return (int)cudaGetLastError();
}

template <bool kTileSums>
int launch_moment_pass(const void* ys, int m, int tile_m, int n_i,
                       const void* xs, int n, int tile_n, int n_j,
                       const void* act_idx, const void* act_cnt,
                       const void* scal, const void* inv_den, void* p1px,
                       void* stream) {
  constexpr int rows = moment_block_rows<kTileSums>();
  const dim3 grid((tile_m + rows - 1) / rows, n_i);
  moment_pass_kernel<kTileSums><<<grid, kRowThreads, 0,
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
                               stream);
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
  return launch_den_pass<false>(ys, m, tile_m, n_i, xs, n, tile_n, n_j,
                                act_idx, act_cnt, scal, inv_den, pt1, xx_part,
                                stream);
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
