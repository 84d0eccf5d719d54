// GMMTree's build and registration kernels for Hopper (sm_90a), bound to
// Python with ctypes.
//
// level_em_kernel (K9) replaces probreg_tpu/ops/gmmtree_pallas.py:
// _level_em_kernel (level_em): one launch runs one tree level's whole build
// EM, the stop test included, for every pair of a batch, on G thread blocks
// per pair (the wrapper picks G: 1 when the batch fills the card, else up
// to one block per chunk of a large pair). gmmtree_reg_kernel (K10)
// replaces _reg_kernel (run_gmmtree_reg_fused): one launch runs whole
// registrations, each pair stopping at its own iteration, on G thread
// blocks per pair picked the same way.
//
// The TPU kernels form the (nodes x points) log-density grid with one MXU
// product over 10 moment features and the moments with the transposed
// product, because the MXU makes both cheap and VMEM holds the grids. A
// point only ever looks at the 8 children of one parent, so here a point
// evaluates those 8 Gaussians from coordinate differences and nothing of
// size nodes x points exists. Node tables stay in shared memory; points
// stream from device memory (a 150k cloud is 1.8 MB, inside the 50 MB L2),
// so the kernels' limits are the node count, not the cloud size. Both are
// bound by operations (the Gaussians, ~25 instructions each).
//
// K9, per iteration of one level of K = 8P nodes, on the pair's centred
// valid points sorted by parent (the wrapper sorts; seg[p] .. seg[p+1] are
// parent p's points, seg[P] the valid count n). Each parent's points are
// cut into chunks of kChunk from the segment's start; the pair's G blocks
// take chunks c = r, r + G, ... (in parent order):
//   E-step of a chunk: 8 adjacent lanes take one point, lane j its child
//   8p + j: u_j = pi_j (norm_j exp(-d^T inv_j d / 2)), d = x - mu_j;
//   den = the sum over the 8 lanes; gamma_j = u_j / den where den > 1e-15,
//   else 0; the hard child is the first maximum; each lane sums gamma_j
//   [1, x, x x^T] (10 moments). The lanes of one child are summed by
//   shuffles, then the warps in order: the chunk's 80 partials go to a
//   scratch buffer.
//   Barrier. Every block sums each node's partials over its parent's
//   chunks in chunk order and updates all K nodes at once (children of
//   different parents are disjoint): a node with m0 >= lambda_d gets
//   pi = m0 / n, mu = m1 / m0, cov = m2 / m0 - mu mu^T; others pi 0, mu 0,
//   cov I. inv and det are closed-form adjugates; det < 1e-15 gives norm 0.
//   The stop test: the points are cut into ranges of kChunk (in sorted
//   order, ignoring parents); each range's sum of log(max(sum over ALL K
//   nodes of u, 1e-15)) with the updated parameters is one block-wide
//   fixed-order sum, written to the scratch buffer.
//   Barrier. Every block sums the ranges into q (lane-strided, then a
//   fixed shuffle tree); go on while it < maxiter and (it == 0 or
//   |q - q_prev| >= lambda_s), q starting at 0 and q_prev at inf.
// Every block of a pair thus holds the same node table and takes the same
// stop decision, and the result is the same bits for any G and any batch.
// G > 1 is a cooperative launch (every block resident) and the barriers
// are grid-wide: a pair that has stopped skips the work and waits at the
// barriers until every pair of the batch has stopped. G = 1 is a plain
// launch whose barriers are the block's own.
//
// K10, per iteration, on the targets centred on the shared centroid of
// targets and node means (the wrapper centres and builds the node table).
// The pair's valid targets are cut into chunks of kChunk in their stored
// order; the pair's G blocks take chunks c = r, r + G, ...:
//   x = R y + t, one point a thread; descend max_level levels from the
//   root's 8 children: u as above with the exponent clamped at 0 (as the
//   twin gmmtree._run_registration does), gamma normalised over the 8,
//   the first maximum; stop at a node whose complexity <= lambda_c;
//   m0[node] += gmax, m1[node] += gmax x: each warp stages its 32 points
//   and 4 lanes add them in lane order into the warp's own node buffer,
//   then the 32 buffers are added in warp order: the chunk's T x 4
//   partials go to a scratch buffer (two, by the iteration's parity, so
//   that the next iteration's writes cannot meet a slow block's reads).
//   One barrier. Every block sums each node's partials over the chunks in
//   chunk order, then runs the rest of the iteration on the same totals:
//   per node and eigendirection j with m0 >= f32 eps, s = m1 / m0, v_j the
//   eigenvector scaled by sqrt(m0 / lambda_j): the row [s x v_j, v_j] and
//   b = v_j . (mu - s); A^T A + 1e-8 I and A^T b summed in a fixed order
//   and solved in double (solve6); q = sum (A x - b)^2; the pose composed
//   with the exact Rodrigues rotation (se3_op.twist_mul: the increment
//   rotates the old translation); go on while it < maxiter and (it == 0 or
//   |q - q_prev| >= tol), both starting at inf.
// As in K9, every block of a pair holds the same pose and takes the same
// stop decision, so the result is the same bits for any G and any batch;
// G > 1 is a cooperative launch with one grid-wide barrier per iteration
// (a stopped pair keeps meeting it until the batch has stopped, read from
// a flag per pair), G = 1 a plain launch whose barrier is the block's own.
// K10 does ~520 operations per point and iteration against K9's ~2,200;
// on one block (one SM of an H100 SXM at 700 W) a 150k pair's 20
// iterations took 42.5 ms.
// IEEE f32 (expf, no fast-math), fixed-order sums: a result is the same
// from run to run.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <math.h>

#include "em_common.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 1024;
constexpr int kWarps = kThreads / 32;
constexpr float kEps = 1.0e-15f;
constexpr float kTwoPi15 = 15.749609945653303f;  // (2 pi)^1.5
constexpr int kTerms = 12;   // [mu (3), inv (6), pi, norm, 0]
constexpr int kTable = 24;   // K10's node table, see gmmtree_cuda.reg_tables
// Points per chunk of K9 and K10 (gmmtree_cuda.CHUNK); K10 gives each
// thread one point of a chunk.
constexpr int kChunk = 1024;
static_assert(kChunk == kThreads, "K10 takes one point a thread");
constexpr int kPartWidth = 80;   // a chunk's moments: 8 children x 10

// -d^T inv d / 2, inv packed as [00, 01, 02, 11, 12, 22].
__device__ __forceinline__ float exponent(float d0, float d1, float d2,
                                          const float* inv) {
  return -0.5f * (d0 * (inv[0] * d0 + inv[1] * d1 + inv[2] * d2)
                  + d1 * (inv[1] * d0 + inv[3] * d1 + inv[4] * d2)
                  + d2 * (inv[2] * d0 + inv[4] * d1 + inv[5] * d2));
}

// E-step terms of a node from its parameters s = [pi, mu (3), cov (6)].
__device__ void node_terms(const float* s, float* e) {
  const float c00 = s[4], c01 = s[5], c02 = s[6];
  const float c11 = s[7], c12 = s[8], c22 = s[9];
  const float adj00 = c11 * c22 - c12 * c12;
  const float adj01 = -(c01 * c22 - c02 * c12);
  const float adj02 = c01 * c12 - c02 * c11;
  const float adj11 = c00 * c22 - c02 * c02;
  const float adj12 = -(c00 * c12 - c01 * c02);
  const float adj22 = c00 * c11 - c01 * c01;
  const float det = c00 * adj00 + c01 * adj01 + c02 * adj02;
  const bool valid = det >= kEps;
  const float inv_det = 1.0f / (valid ? det : 1.0f);
  e[0] = s[1]; e[1] = s[2]; e[2] = s[3];
  e[3] = valid ? adj00 * inv_det : 1.0f;
  e[4] = valid ? adj01 * inv_det : 0.0f;
  e[5] = valid ? adj02 * inv_det : 0.0f;
  e[6] = valid ? adj11 * inv_det : 1.0f;
  e[7] = valid ? adj12 * inv_det : 0.0f;
  e[8] = valid ? adj22 * inv_det : 1.0f;
  e[9] = s[0];
  e[10] = valid ? 1.0f / (sqrtf(fmaxf(det, kEps)) * kTwoPi15) : 0.0f;
  e[11] = 0.0f;
}

// pi (norm exp(-d^T inv d / 2)) of the node terms e at x.
__device__ __forceinline__ float weighted_pdf(const float* e, float x0,
                                              float x1, float x2) {
  return e[9] * (e[10] * expf(exponent(x0 - e[0], x1 - e[1], x2 - e[2],
                                       e + 3)));
}

// The M-step of one node from its 10 moments m into its parameters s.
__device__ void level_mstep(const float* m, float n_eff, float lambda_d,
                            float* s) {
  const float m0 = m[0];
  const bool keep = m0 >= lambda_d;
  const float m0s = fmaxf(m0, kEps);
  const float a = keep ? m[1] / m0s : 0.0f;
  const float b = keep ? m[2] / m0s : 0.0f;
  const float c = keep ? m[3] / m0s : 0.0f;
  s[0] = keep ? m0 / n_eff : 0.0f;
  s[1] = a; s[2] = b; s[3] = c;
  s[4] = keep ? m[4] / m0s - a * a : 1.0f;
  s[5] = keep ? m[5] / m0s - a * b : 0.0f;
  s[6] = keep ? m[6] / m0s - a * c : 0.0f;
  s[7] = keep ? m[7] / m0s - b * b : 1.0f;
  s[8] = keep ? m[8] / m0s - b * c : 0.0f;
  s[9] = keep ? m[9] / m0s - c * c : 1.0f;
}

struct LevelState {
  float q, q_prev;
  int it;
};

struct LevelArgs {
  const float* pts;   // (B, n_cap, 3), sorted by parent
  int n_cap;
  const int* seg;     // (B, P + 1)
  int k_nodes;        // K = 8 P
  const float* state0;  // (B, K, 10)
  float lambda_s, lambda_d;
  int maxiter;
  int per_pair;       // G
  int c_cap, l_cap;   // chunks and point ranges a pair may have
  float* part;        // (B, c_cap, kPartWidth) chunk moments
  float* llpart;      // (B, l_cap) range log-likelihoods
  int* flags;         // (B,) whether a pair goes on (G > 1)
  float* state_out;   // (B, K, 10)
  int* child;         // (B, n_cap), sorted order
  float* diag;        // (B, 2) [q, n_iter]
};

// Shared memory of one K9 block: parameters, E-step terms and moment
// totals of K nodes, and the pair's seg and each parent's first chunk.
int level_smem(int k_nodes) {
  return 4 * (10 + kTerms + 10) * k_nodes + 8 * (k_nodes / 8 + 1);
}

template <bool kGrid>
__device__ __forceinline__ void pair_barrier() {
  if constexpr (kGrid) cg::this_grid().sync();
  else __syncthreads();
}

// Two blocks a SM (32 registers a thread): a batch of 256 small pairs
// runs in one wave, and a cooperative launch takes 264 blocks.
template <bool kGrid>
__global__ void __launch_bounds__(kThreads, 2)
level_em_kernel(const LevelArgs a) {
  extern __shared__ float smem[];
  const int k_nodes = a.k_nodes, n_par = k_nodes / 8;
  float* raw = smem;                        // K x 10 parameters
  float* terms = raw + 10 * k_nodes;        // K x kTerms
  float* mom = terms + kTerms * k_nodes;    // K x 10 moment totals
  int* sseg = reinterpret_cast<int*>(mom + 10 * k_nodes);  // P + 1
  int* chunk0 = sseg + n_par + 1;   // P + 1: each parent's first chunk
  __shared__ float red[kWarps * 80];
  __shared__ float red1[kWarps];
  __shared__ float total[1];
  __shared__ LevelState st;
  __shared__ int any_go;

  const int per = a.per_pair;
  const int b = blockIdx.x / per, r = blockIdx.x % per;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const float* pts = a.pts + (size_t)b * a.n_cap * 3;
  float* part = a.part + (size_t)b * a.c_cap * kPartWidth;
  float* llpart = a.llpart + (size_t)b * a.l_cap;
  int* child = a.child + (size_t)b * a.n_cap;
  for (int p = tid; p <= n_par; p += kThreads)
    sseg[p] = a.seg[(size_t)b * (n_par + 1) + p];
  for (int i = tid; i < 10 * k_nodes; i += kThreads)
    raw[i] = a.state0[(size_t)b * k_nodes * 10 + i];
  __syncthreads();
  const int n = sseg[n_par];
  const int n_ranges = (n + kChunk - 1) / kChunk;
  const float n_eff = (float)n;
  for (int k = tid; k < k_nodes; k += kThreads)
    node_terms(raw + 10 * k, terms + kTerms * k);
  if (tid == 0) {
    int c = 0;   // each parent's first chunk
    for (int p = 0; p < n_par; ++p) {
      chunk0[p] = c;
      c += (sseg[p + 1] - sseg[p] + kChunk - 1) / kChunk;
    }
    chunk0[n_par] = c;
    st.q = 0.0f;
    st.q_prev = INFINITY;
    st.it = 0;
  }
  __syncthreads();
  const int n_chunks = chunk0[n_par];

  const int grp = tid >> 3, j = tid & 7;   // 128 points of 8 lanes a pass
  while (true) {
    // A NaN q stops the loop.
    const bool go = st.it < a.maxiter
                    && (st.it == 0 || fabsf(st.q - st.q_prev) >= a.lambda_s);
    // E-step and moments of this block's chunks (none once stopped).
    for (int c = go ? r : n_chunks; c < n_chunks; c += per) {
      int p = 0;   // the chunk's parent: chunk0[p] <= c < chunk0[p + 1]
      while (chunk0[p + 1] <= c) ++p;
      const int s0 = sseg[p] + (c - chunk0[p]) * kChunk;
      const int s1 = min(s0 + kChunk, sseg[p + 1]);
      const float* e = terms + kTerms * (8 * p + j);
      float acc[10];
#pragma unroll
      for (int m = 0; m < 10; ++m) acc[m] = 0.0f;
      for (int i0 = s0; i0 < s1; i0 += kThreads / 8) {
        const int i = i0 + grp;
        const bool ok = i < s1;
        float x0 = 0.0f, x1 = 0.0f, x2 = 0.0f, u = 0.0f;
        if (ok) {
          x0 = pts[3 * i]; x1 = pts[3 * i + 1]; x2 = pts[3 * i + 2];
          u = weighted_pdf(e, x0, x1, x2);
        }
        float den = u;   // the same value in all 8 lanes (commutative)
        den += __shfl_xor_sync(0xffffffffu, den, 1);
        den += __shfl_xor_sync(0xffffffffu, den, 2);
        den += __shfl_xor_sync(0xffffffffu, den, 4);
        const float g = den > kEps ? u / den : 0.0f;
        // The first maximum of the 8 (jnp.argmax's tie rule).
        float bv = g;
        int bj = j;
        for (int o = 1; o < 8; o <<= 1) {
          const float ov = __shfl_xor_sync(0xffffffffu, bv, o);
          const int oj = __shfl_xor_sync(0xffffffffu, bj, o);
          if (ov > bv || (ov == bv && oj < bj)) { bv = ov; bj = oj; }
        }
        if (ok) {
          if (j == 0) child[i] = 8 * p + bj;
          acc[0] += g;
          acc[1] += g * x0; acc[2] += g * x1; acc[3] += g * x2;
          acc[4] += g * (x0 * x0); acc[5] += g * (x0 * x1);
          acc[6] += g * (x0 * x2); acc[7] += g * (x1 * x1);
          acc[8] += g * (x1 * x2); acc[9] += g * (x2 * x2);
        }
      }
      // Lanes j, j + 8, j + 16, j + 24 hold child j: shuffles, then warps
      // in order.
#pragma unroll
      for (int m = 0; m < 10; ++m) {
        acc[m] += __shfl_xor_sync(0xffffffffu, acc[m], 8);
        acc[m] += __shfl_xor_sync(0xffffffffu, acc[m], 16);
      }
      if (lane < 8) {
#pragma unroll
        for (int m = 0; m < 10; ++m) red[warp * 80 + lane * 10 + m] = acc[m];
      }
      __syncthreads();
      if (tid < kPartWidth) {
        float sum = 0.0f;
        for (int w = 0; w < kWarps; ++w) sum += red[w * 80 + tid];
        part[(size_t)c * kPartWidth + tid] = sum;
      }
      __syncthreads();   // red is free for the next chunk
    }
    if constexpr (kGrid) {
      if (r == 0 && tid == 0) a.flags[b] = go;
      pair_barrier<kGrid>();
      if (tid == 0) {
        int any = 0;
        for (int q = 0; q < (int)gridDim.x / per; ++q)
          any |= __ldcg(a.flags + q);
        any_go = any;
      }
      __syncthreads();
      if (!any_go) break;
    } else {
      pair_barrier<kGrid>();
      if (!go) break;
    }
    if (go) {
      // Node totals, each over its parent's chunks in chunk order.
      for (int idx = tid; idx < 10 * k_nodes; idx += kThreads) {
        const int node = idx / 10, p = node >> 3;
        const int col = (node & 7) * 10 + (idx - 10 * node);
        float sum = 0.0f;
        for (int c = chunk0[p]; c < chunk0[p + 1]; ++c)
          sum += __ldcg(part + (size_t)c * kPartWidth + col);
        mom[idx] = sum;
      }
      __syncthreads();
      for (int k = tid; k < k_nodes; k += kThreads) {
        level_mstep(mom + 10 * k, n_eff, a.lambda_d, raw + 10 * k);
        node_terms(raw + 10 * k, terms + kTerms * k);
      }
      __syncthreads();
      // The stop test's log-likelihood over all K nodes, updated, one
      // point range at a time.
      for (int c = r; c < n_ranges; c += per) {
        const int i = c * kChunk + tid;
        float ll[1] = {0.0f};
        if (i < n) {
          const float x0 = pts[3 * i], x1 = pts[3 * i + 1];
          const float x2 = pts[3 * i + 2];
          float su = 0.0f;
          for (int k = 0; k < k_nodes; ++k)
            su += weighted_pdf(terms + kTerms * k, x0, x1, x2);
          ll[0] = logf(fmaxf(su, kEps));
        }
        block_reduce<1, kThreads>(ll, red1, total);
        if (tid == 0) llpart[c] = total[0];
      }
    }
    pair_barrier<kGrid>();
    if (go && warp == 0) {
      float q = 0.0f;
      for (int c = lane; c < n_ranges; c += 32) q += __ldcg(llpart + c);
      q = group_sum(q, 32);
      if (lane == 0) {
        st.q_prev = st.q;
        st.q = q;
        st.it += 1;
      }
    }
    __syncthreads();
  }

  if (r == 0) {
    for (int i = tid; i < 10 * k_nodes; i += kThreads)
      a.state_out[(size_t)b * k_nodes * 10 + i] = raw[i];
    if (tid == 0) {
      a.diag[2 * b] = st.q;
      a.diag[2 * b + 1] = (float)st.it;
    }
  }
}

struct RegState {
  float rot[9], t[3];
  double x[6];
  float q, q_prev;
  int it;
};

// One twist row [s x v_j, v_j, b_j] of node k (table e, moments m).
__device__ void twist_row(const float* e, const float* m, int j, float* r) {
  const float m0 = m[0];
  if (!(m0 >= kEpsF32)) {
    for (int c = 0; c < 7; ++c) r[c] = 0.0f;
    return;
  }
  const float m0s = fmaxf(m0, kEpsF32);
  const float s0 = m[1] / m0s, s1 = m[2] / m0s, s2 = m[3] / m0s;
  const float scale = sqrtf(m0s / fmaxf(e[21 + j], kEpsF32));
  const float v0 = e[12 + j] * scale;
  const float v1 = e[15 + j] * scale;
  const float v2 = e[18 + j] * scale;
  r[0] = s1 * v2 - s2 * v1;
  r[1] = s2 * v0 - s0 * v2;
  r[2] = s0 * v1 - s1 * v0;
  r[3] = v0; r[4] = v1; r[5] = v2;
  r[6] = v0 * (e[0] - s0) + v1 * (e[1] - s1) + v2 * (e[2] - s2);
}

// The pose after the twist st.x (se3_op.twist_mul), in double.
__device__ void compose(RegState& st) {
  const double* x = st.x;
  const double twd2 = x[0] * x[0] + x[1] * x[1] + x[2] * x[2];
  double dr[3][3] = {{1.0, 0.0, 0.0}, {0.0, 1.0, 0.0}, {0.0, 0.0, 1.0}};
  if (twd2 >= 1e-12) {
    const double twd = sqrt(twd2);
    const double nx = x[0] / twd, ny = x[1] / twd, nz = x[2] / twd;
    const double c = cos(twd), sn = sin(twd), v = 1.0 - c;
    dr[0][0] = c + v * nx * nx;
    dr[0][1] = v * nx * ny - sn * nz;
    dr[0][2] = v * nx * nz + sn * ny;
    dr[1][0] = v * ny * nx + sn * nz;
    dr[1][1] = c + v * ny * ny;
    dr[1][2] = v * ny * nz - sn * nx;
    dr[2][0] = v * nz * nx - sn * ny;
    dr[2][1] = v * nz * ny + sn * nx;
    dr[2][2] = c + v * nz * nz;
  }
  float rot[9], t[3];
  for (int i = 0; i < 3; ++i) {
    double ti = x[3 + i];
    for (int k = 0; k < 3; ++k) ti += dr[i][k] * (double)st.t[k];
    t[i] = (float)ti;
    for (int j = 0; j < 3; ++j) {
      double r = 0.0;
      for (int k = 0; k < 3; ++k) r += dr[i][k] * (double)st.rot[3 * k + j];
      rot[3 * i + j] = (float)r;
    }
  }
  for (int k = 0; k < 9; ++k) st.rot[k] = rot[k];
  for (int k = 0; k < 3; ++k) st.t[k] = t[k];
}

struct RegArgs {
  const float* ys;      // (B, n_cap, 3) centred targets, valid first
  int n_cap;
  const int* counts;    // (B,) valid targets
  const float* table;   // (B, T, kTable)
  int t_nodes;
  const float* init;    // (B, 12) [rot, t]
  int max_level, maxiter;
  float tol, lambda_c;
  int per_pair;         // G
  int c_cap;            // chunks a pair may have
  float* part;          // (2, B, c_cap, T, 4) chunk moments, by parity
  int* flags;           // (2, B) whether a pair goes on (G > 1), by parity
  float* out;           // (B, 16)
};

// K10's node table in shared memory: node k's kTable floats start at
// kTable k + k / 8, so the 8 children of different parents, which the
// lanes of a warp read at once in the descent's second level, start in
// different banks (kTable k alone puts every parent's group in one bank).
__device__ __forceinline__ int tab_at(int node) {
  return kTable * node + (node >> 3);
}

__host__ __device__ int tab_floats(int t_nodes) {
  return kTable * t_nodes + t_nodes / 8 + 1;
}

// Shared memory of one K10 block: the node table, one [m0, m1] buffer per
// warp, the node totals and three twist rows of 7 per node.
int reg_smem(int t_nodes) {
  return 4 * (tab_floats(t_nodes) + (kWarps * 4 + 4 + 3 * 7) * t_nodes);
}

template <bool kGrid>
__global__ void __launch_bounds__(kThreads)
gmmtree_reg_kernel(const RegArgs a) {
  extern __shared__ float smem[];
  const int t_nodes = a.t_nodes, width = 4 * t_nodes;
  float* tab = smem;                          // T x kTable, see tab_at
  float* wbuf = tab + tab_floats(t_nodes);    // kWarps x T x [m0, m1]
  float* mom = wbuf + kWarps * width;         // T x [m0, m1]
  float* rows = mom + width;                  // 3 T x 7
  __shared__ int stage_node[kWarps][32];
  __shared__ float stage_val[kWarps][32][4];
  __shared__ float red[kWarps * 27];
  __shared__ float sums[27];
  __shared__ RegState st;
  __shared__ int any_go;

  const int per = a.per_pair, batch = gridDim.x / per;
  const int b = blockIdx.x / per, r = blockIdx.x % per;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int n = a.counts[b];
  const int n_chunks = (n + kChunk - 1) / kChunk;
  const float* ys = a.ys + (size_t)b * a.n_cap * 3;
  const float* table = a.table + (size_t)b * t_nodes * kTable;
  for (int i = tid; i < kTable * t_nodes; i += kThreads)
    tab[i + i / kTable / 8] = table[i];
  if (tid == 0) {
    for (int k = 0; k < 9; ++k) st.rot[k] = a.init[12 * b + k];
    for (int k = 0; k < 3; ++k) st.t[k] = a.init[12 * b + 9 + k];
    st.q = st.q_prev = INFINITY;
    st.it = 0;
  }
  __syncthreads();
  float* mybuf = wbuf + warp * width;

  for (int parity = 0;; parity ^= 1) {
    // A NaN q stops the loop.
    const bool go = st.it < a.maxiter
                    && (st.it == 0 || fabsf(st.q - st.q_prev) >= a.tol);
    float* part = a.part
                  + ((size_t)parity * batch + b) * a.c_cap * width;
    float r9[9], t3[3];
#pragma unroll
    for (int k = 0; k < 9; ++k) r9[k] = st.rot[k];
#pragma unroll
    for (int k = 0; k < 3; ++k) t3[k] = st.t[k];
    // Descent and moments of this block's chunks (none once stopped).
    for (int c = go ? r : n_chunks; c < n_chunks; c += per) {
      for (int k = lane; k < width; k += 32) mybuf[k] = 0.0f;
      const int i = c * kChunk + tid;
      int node = 0;
      float gm = 0.0f, x0 = 0.0f, x1 = 0.0f, x2 = 0.0f;
      if (i < n) {
        const float y0 = ys[3 * i], y1 = ys[3 * i + 1], y2 = ys[3 * i + 2];
        x0 = r9[0] * y0 + r9[1] * y1 + r9[2] * y2 + t3[0];
        x1 = r9[3] * y0 + r9[4] * y1 + r9[5] * y2 + t3[1];
        x2 = r9[6] * y0 + r9[7] * y1 + r9[8] * y2 + t3[2];
        int parent = -1;
        for (int l = 0; l < a.max_level; ++l) {
          const int c0 = 8 * (parent + 1);
          float u[8], den = 0.0f;
#pragma unroll
          for (int jj = 0; jj < 8; ++jj) {
            const float* e = tab + tab_at(c0 + jj);
            const float ep = fminf(
                exponent(x0 - e[0], x1 - e[1], x2 - e[2], e + 3), 0.0f);
            u[jj] = e[9] * (e[10] * expf(ep));
            den += u[jj];
          }
          int best = 0;
          float bg = -1.0f;
#pragma unroll
          for (int jj = 0; jj < 8; ++jj) {
            const float g = den > kEps ? u[jj] / den : 0.0f;
            if (g > bg) { bg = g; best = jj; }   // strict: the first max
          }
          node = c0 + best;
          gm = bg;
          if (tab[tab_at(node) + 11] <= a.lambda_c) break;
          parent = node;
        }
      }
      stage_node[warp][lane] = node;
      stage_val[warp][lane][0] = gm;
      stage_val[warp][lane][1] = gm * x0;
      stage_val[warp][lane][2] = gm * x1;
      stage_val[warp][lane][3] = gm * x2;
      __syncwarp();
      if (lane < 4)
        for (int l = 0; l < 32; ++l)
          mybuf[4 * stage_node[warp][l] + lane] += stage_val[warp][l][lane];
      __syncthreads();
      // The chunk's moments: the warps' buffers in warp order.
      for (int k = tid; k < width; k += kThreads) {
        float s = 0.0f;
        for (int w = 0; w < kWarps; ++w) s += wbuf[w * width + k];
        part[(size_t)c * width + k] = s;
      }
      __syncthreads();   // wbuf is free for the next chunk
    }
    if constexpr (kGrid) {
      int* flags = a.flags + parity * batch;
      if (r == 0 && tid == 0) flags[b] = go;
      pair_barrier<kGrid>();
      if (tid == 0) {
        int any = 0;
        for (int q = 0; q < batch; ++q) any |= __ldcg(flags + q);
        any_go = any;
      }
      __syncthreads();
      if (!any_go) break;
    } else {
      pair_barrier<kGrid>();
      if (!go) break;
    }
    if (go) {
      // Node totals over the pair's chunks in chunk order.
      for (int k = tid; k < width; k += kThreads) {
        float s = 0.0f;
        for (int c = 0; c < n_chunks; ++c)
          s += __ldcg(part + (size_t)c * width + k);
        mom[k] = s;
      }
      __syncthreads();
      for (int rr = tid; rr < 3 * t_nodes; rr += kThreads)
        twist_row(tab + tab_at(rr / 3), mom + 4 * (rr / 3), rr % 3,
                  rows + 7 * rr);
      __syncthreads();
      // A^T A (upper triangle, row by row) and A^T b.
      float v[27];
#pragma unroll
      for (int k = 0; k < 27; ++k) v[k] = 0.0f;
      for (int rr = tid; rr < 3 * t_nodes; rr += kThreads) {
        const float* ar = rows + 7 * rr;
        int k = 0;
        for (int p = 0; p < 6; ++p)
          for (int q = p; q < 6; ++q) v[k++] += ar[p] * ar[q];
        for (int p = 0; p < 6; ++p) v[21 + p] += ar[p] * ar[6];
      }
      block_reduce<27, kThreads>(v, red, sums);
      if (tid == 0) {
        double am[6][6], rhs[6];
        int k = 0;
        for (int p = 0; p < 6; ++p)
          for (int q = p; q < 6; ++q) am[p][q] = am[q][p] = (double)sums[k++];
        for (int p = 0; p < 6; ++p) {
          am[p][p] += 1e-8;
          rhs[p] = (double)sums[21 + p];
        }
        solve6(am, rhs, st.x);
      }
      __syncthreads();
      float res[1] = {0.0f};
      {
        float xf[6];
#pragma unroll
        for (int p = 0; p < 6; ++p) xf[p] = (float)st.x[p];
        for (int rr = tid; rr < 3 * t_nodes; rr += kThreads) {
          const float* ar = rows + 7 * rr;
          const float e = ar[0] * xf[0] + ar[1] * xf[1] + ar[2] * xf[2]
                          + ar[3] * xf[3] + ar[4] * xf[4] + ar[5] * xf[5]
                          - ar[6];
          res[0] += e * e;
        }
      }
      block_reduce<1, kThreads>(res, red, sums);
      if (tid == 0) {
        compose(st);
        st.q_prev = st.q;
        st.q = sums[0];
        st.it += 1;
      }
    }
    __syncthreads();
  }

  if (r == 0 && tid == 0) {
    float* o = a.out + (size_t)b * 16;
    for (int k = 0; k < 9; ++k) o[k] = st.rot[k];
    for (int k = 0; k < 3; ++k) o[9 + k] = st.t[k];
    o[12] = st.q;
    o[13] = (float)st.it;
    o[14] = 0.0f;
    o[15] = 0.0f;
  }
}

}  // namespace

extern "C" {

// The blocks of K9 that can be resident at once on the current device
// (every SM, as many as fit): a cooperative launch takes at most this many.
int probreg_gmmtree_level_capacity(int k_nodes, void* out) {
  const int smem = level_smem(k_nodes);
  cudaError_t err = cudaFuncSetAttribute(
      level_em_kernel<true>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  int dev = 0, sms = 0, per_sm = 0;
  if (err == cudaSuccess) err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, level_em_kernel<true>, kThreads, smem);
  *(int*)out = sms * per_sm;
  return (int)err;
}

// pts (B, n_cap, 3) sorted by parent, seg (B, P + 1) int32, state0 /
// state_out (B, K, 10), scratch part (B, c_cap, 80), llpart (B, l_cap),
// flags (B,) int32; per_pair blocks per pair.
int probreg_gmmtree_level_em(const void* pts, int n_cap, const void* seg,
                             int k_nodes, const void* state0, int batch,
                             int per_pair, int c_cap, int l_cap,
                             float lambda_s, float lambda_d, int maxiter,
                             void* part, void* llpart, void* flags,
                             void* state_out, void* child, void* diag,
                             void* stream) {
  if (batch <= 0 || per_pair <= 0) return (int)cudaErrorInvalidValue;
  const LevelArgs a{(const float*)pts, n_cap, (const int*)seg, k_nodes,
                    (const float*)state0, lambda_s, lambda_d, maxiter,
                    per_pair, c_cap, l_cap, (float*)part, (float*)llpart,
                    (int*)flags, (float*)state_out, (int*)child,
                    (float*)diag};
  const int smem = level_smem(k_nodes);
  const auto s = (cudaStream_t)stream;
  if (per_pair == 1) {
    cudaError_t err = cudaFuncSetAttribute(
        level_em_kernel<false>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        smem);
    if (err != cudaSuccess) return (int)err;
    level_em_kernel<false><<<batch, kThreads, smem, s>>>(a);
    return (int)cudaGetLastError();
  }
  cudaError_t err = cudaFuncSetAttribute(
      level_em_kernel<true>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (err != cudaSuccess) return (int)err;
  void* args[] = {(void*)&a};
  err = cudaLaunchCooperativeKernel((const void*)level_em_kernel<true>,
                                    dim3(batch * per_pair), dim3(kThreads),
                                    args, smem, s);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

// The blocks of K10 that can be resident at once on the current device
// for a tree of t_nodes nodes: a cooperative launch takes at most this many.
int probreg_gmmtree_reg_capacity(int t_nodes, void* out) {
  const int smem = reg_smem(t_nodes);
  cudaError_t err = cudaFuncSetAttribute(
      gmmtree_reg_kernel<true>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  int dev = 0, sms = 0, per_sm = 0;
  if (err == cudaSuccess) err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, gmmtree_reg_kernel<true>, kThreads, smem);
  *(int*)out = sms * per_sm;
  return (int)err;
}

// ys (B, n_cap, 3), counts (B,) int32, table (B, T, 24), init (B, 12), out
// (B, 16); scratch part (2, B, c_cap, T, 4), flags (2, B) int32; per_pair
// blocks per pair.
int probreg_gmmtree_reg(const void* ys, int n_cap, const void* counts,
                        const void* table, int t_nodes, const void* init,
                        int batch, int per_pair, int c_cap, int max_level,
                        int maxiter, float tol, float lambda_c, void* part,
                        void* flags, void* out, void* stream) {
  if (batch <= 0 || per_pair <= 0) return (int)cudaErrorInvalidValue;
  const RegArgs a{(const float*)ys, n_cap, (const int*)counts,
                  (const float*)table, t_nodes, (const float*)init,
                  max_level, maxiter, tol, lambda_c, per_pair, c_cap,
                  (float*)part, (int*)flags, (float*)out};
  const int smem = reg_smem(t_nodes);
  const auto s = (cudaStream_t)stream;
  if (per_pair == 1) {
    cudaError_t err = cudaFuncSetAttribute(
        gmmtree_reg_kernel<false>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return (int)err;
    gmmtree_reg_kernel<false><<<batch, kThreads, smem, s>>>(a);
    return (int)cudaGetLastError();
  }
  cudaError_t err = cudaFuncSetAttribute(
      gmmtree_reg_kernel<true>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (err != cudaSuccess) return (int)err;
  void* args[] = {(void*)&a};
  err = cudaLaunchCooperativeKernel((const void*)gmmtree_reg_kernel<true>,
                                    dim3(batch * per_pair), dim3(kThreads),
                                    args, smem, s);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

}  // extern "C"
