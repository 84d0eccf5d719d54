// Whole-EM rigid / affine CPD for Hopper (sm_90a), bound to Python with ctypes.
//
// Replaces probreg_tpu/ops/em_pallas.py:_em_kernel (run_em_rigid_fused,
// run_em_affine_fused, run_em_cpd_fused_batch): one launch runs a whole
// registration, E-steps, M-steps and the convergence test included, with no
// host read between launch and result. A pair runs on kThreads = 1,024
// threads: one block (G = 1) or a thread-block cluster of G = 2, 4 or 8
// blocks of kThreads / G threads on G SMs, which the wrapper picks when the
// batch leaves SMs idle (em_cuda.cluster_size). The grid is the batch;
// every pair keeps its own convergence state, so the pairs of a ragged
// batch stop at their own iterations. When a ragged batch's blocks
// outnumber the SMs, the wrapper hands a work order, the largest m n
// first, so the long pairs start in the first wave and the short ones
// fill the gaps; cluster (or block) c then registers pair order[c] and
// writes its row. A thread has at most 64 registers at G = 1 (one block
// an SM), 128 at G = 2 and 255 at G = 4 and 8.
//
// What the TPU kernel keeps in VMEM, the (M, N) posterior, does not fit the
// 227 KB of shared memory of an SM (4 MB at 1024 x 1024), so it is never
// stored: pass A gives a thread (or a group of 2..32 adjacent lanes, when
// there are fewer columns than threads) one target column and a loop over
// the transformed sources in shared memory, which completes the column's
// normalizer with no cross-block sum; pass B gives a thread group one source
// row and a loop over the targets, recomputes the Gaussian and multiplies by
// 1/den from shared memory. Both clouds, the transformed source and 1/den
// stay in shared memory for the whole run: 32 B per source point and 20 B
// per target point. The kernel is bound by operations (two Gaussians and
// the moment FMAs per pair and iteration); its only device-memory traffic
// is reading the clouds once and writing 16 floats.
//
// d2 is (y - x).(y - x) in f32 FMAs on clouds centred on their shared
// centroid (computed here, as cpd._run_em_t does; t converts back at the
// end). A pair may start from its own pose (``init``: the multistart
// searches run S starts of B pairs as one launch of B S pairs): the raw-frame
// start converts to the centred frame as _run_em_t's does, and sigma2_0 is
// still the closed form of the un-moved clouds unless the row gives one. IEEE f32, expf, no fast-math. All sums are fixed-order trees
// (shuffles, then warps in order): no atomics, so a result is the same from
// run to run, and the same for every G and any work order: the cluster's
// blocks run the one-block kernel's threads with its splits and its sums'
// trees (see em_kernel).
//
// The rigid M-step is Horn's quaternion method like the TPU kernel, but the
// dominant eigenvector of the 4 x 4 matrix comes from cyclic Jacobi sweeps
// in one thread, in double: it converges for every symmetric matrix, needs
// no cancellation guard, and returns a unit vector of an orthonormal basis
// even when the top eigenvalues tie (a planar or collinear cloud), so the
// rotation is always proper (det = +1). The affine M-step is
// B = a inv(yp1y) with a 3 x 3 cofactor inverse, also in double.

#include <cuda_runtime.h>

#include "em_common.cuh"

namespace {

constexpr int kThreads = 1024;
constexpr int kRed = 18;  // widest block reduction (the M-step sums)

struct State {
  float lin[9], t[3], cen[3];
  float sigma2, q, q_prev, wratio;
  float inv2s2, c;            // of the E-step about to run
  float mu_x[3], mu_y[3], n_p, xx;
  int it, go;
};

__device__ __forceinline__ float gauss(float4 y, float4 x, float inv2s2) {
  const float dx = y.x - x.x, dy = y.y - x.y, dz = y.z - x.z;
  return expf(-(dx * dx + dy * dy + dz * dz) * inv2s2);
}

// The M-step of one iteration, in one thread, from the block's sums:
// s[0..9) = a = sum_i px_i (y_i - mu_y)^T, s[9..12) = sum_i p1_i (y_i - mu_y),
// s[12..18) = yp1y (xx, xy, xz, yy, yz, zz). Updates st for the next E-step.
__device__ void mstep(State& st, const float* s, int maxiter, float tol,
                      int update_scale, int affine) {
  const double n_p = st.n_p;
  double a[3][3];
  for (int i = 0; i < 3; ++i)
    for (int j = 0; j < 3; ++j)
      a[i][j] = (double)s[3 * i + j] - (double)st.mu_x[i] * (double)s[9 + j];
  double mx2 = 0.0;
  for (int i = 0; i < 3; ++i) mx2 += (double)st.mu_x[i] * (double)st.mu_x[i];
  const double tr_xp1x = (double)st.xx - n_p * mx2;
  const double yy[3][3] = {{s[12], s[13], s[14]},
                           {s[13], s[15], s[16]},
                           {s[14], s[16], s[17]}};
  double lin[3][3], resid, qnum;
  if (affine) {
    double cof[3][3];  // cofactors of the symmetric yp1y (symmetric too)
    cof[0][0] = yy[1][1] * yy[2][2] - yy[1][2] * yy[2][1];
    cof[0][1] = yy[1][2] * yy[2][0] - yy[1][0] * yy[2][2];
    cof[0][2] = yy[1][0] * yy[2][1] - yy[1][1] * yy[2][0];
    cof[1][1] = yy[0][0] * yy[2][2] - yy[0][2] * yy[2][0];
    cof[1][2] = yy[0][1] * yy[2][0] - yy[0][0] * yy[2][1];
    cof[2][2] = yy[0][0] * yy[1][1] - yy[0][1] * yy[1][0];
    cof[1][0] = cof[0][1]; cof[2][0] = cof[0][2]; cof[2][1] = cof[1][2];
    double det = yy[0][0] * cof[0][0] + yy[0][1] * cof[0][1]
                 + yy[0][2] * cof[0][2];
    if (fabs(det) < 1e-30) det = 1e-30;
    double tr_ab = 0.0;
    for (int i = 0; i < 3; ++i)
      for (int j = 0; j < 3; ++j) {
        double b = 0.0;
        for (int k = 0; k < 3; ++k) b += a[i][k] * cof[k][j];
        lin[i][j] = b / det;
        tr_ab += a[i][j] * lin[i][j];
      }
    resid = qnum = tr_xp1x - tr_ab;
  } else {
    double rot[3][3];
    horn_rotation(a, rot);
    double tr_atr = 0.0;
    for (int i = 0; i < 3; ++i)
      for (int j = 0; j < 3; ++j) tr_atr += a[i][j] * rot[i][j];
    const double tr_yp1y = yy[0][0] + yy[1][1] + yy[2][2];
    const double scale = update_scale ? tr_atr / tr_yp1y : 1.0;
    for (int i = 0; i < 3; ++i)
      for (int j = 0; j < 3; ++j) lin[i][j] = scale * rot[i][j];
    resid = update_scale ? tr_xp1x - scale * tr_atr
                         : tr_xp1x - 2.0 * scale * tr_atr + tr_yp1y;
    // Equals resid up to rounding when the scale is updated; formed
    // separately as the reference does.
    qnum = tr_xp1x - 2.0 * scale * tr_atr + scale * scale * tr_yp1y;
  }
  double sigma2 = resid / (n_p * 3.0);
  sigma2 = sigma2 > (double)kEpsF32 ? sigma2 : (double)kEpsF32;
  st.q_prev = st.q;
  st.q = (float)(qnum / (2.0 * sigma2) + 3.0 * n_p * 0.5 * log(sigma2));
  st.sigma2 = (float)sigma2;
  for (int i = 0; i < 3; ++i) {
    double t = st.mu_x[i];
    for (int j = 0; j < 3; ++j) {
      st.lin[3 * i + j] = (float)lin[i][j];
      t -= lin[i][j] * (double)st.mu_y[j];
    }
    st.t[i] = (float)t;
  }
  st.it += 1;
  // Go on while |q - q_prev| >= tol; a NaN q stops the loop.
  st.go = st.it < maxiter && fabsf(st.q - st.q_prev) >= tol;
  const double s2 = st.sigma2;
  st.inv2s2 = (float)(0.5 / s2);
  st.c = (float)((double)st.wratio * pow(2.0 * 3.14159265358979323846 * s2,
                                         1.5));
}

// One pair on G blocks of kThreads / G threads (a thread-block cluster when
// G > 1). Block r of the cluster runs the virtual threads vt = r kThreads /
// G + tid of the one-block kernel (G = 1), each walking the same columns,
// rows and points with the same splits, and the sums keep that kernel's
// trees (pair_reduce, em_common.cuh): the result is the same bits for
// every G. Each block holds both whole clouds; the transformed source is
// formed by every block, 1/den and (px, p1) by their owner and read by the
// others.
// ``order`` (may be null): cluster (or block) c registers pair order[c].
template <int G>
__global__ void __launch_bounds__(kThreads / G)
em_kernel(const float* __restrict__ src, int m_cap,   // (B, m_cap, 3)
          const float* __restrict__ tgt, int n_cap,   // (B, n_cap, 3)
          const int* __restrict__ counts,  // (B, 2) valid points, or null
          const int* __restrict__ order,   // (B,) work order, or null
          const float* __restrict__ init,  // (B, 14) start rows, or null
          float w, int maxiter, float tol, int update_scale, int affine,
          float* __restrict__ out) {       // (B, 16)
  constexpr int kBlock = kThreads / G;
  extern __shared__ float4 pts[];
  float4* ys = pts;                // centred source
  float4* ts = ys + m_cap;         // transformed source, then (px, p1)
  float4* xs = ts + m_cap;         // centred target, |x|^2 in w
  float* inv_den = reinterpret_cast<float*>(xs + n_cap);
  __shared__ float red[2][kBlock / 32 * kRed];   // see pair_reduce
  __shared__ float sums[kRed];
  __shared__ State st;

  const int tid = threadIdx.x;
  const int b = order ? order[blockIdx.x / G] : blockIdx.x / G;
  const int r = cluster_rank<G>();
  const int vt = r * kBlock + tid;   // the thread of the one-block kernel
  const int m = counts ? counts[2 * b] : m_cap;
  const int n = counts ? counts[2 * b + 1] : n_cap;
  src += (size_t)b * m_cap * 3;
  tgt += (size_t)b * n_cap * 3;

  // Load, then centre on the shared centroid of the valid points.
  for (int i = tid; i < m; i += kBlock)
    ys[i] = make_float4(src[3 * i], src[3 * i + 1], src[3 * i + 2], 0.0f);
  for (int j = tid; j < n; j += kBlock)
    xs[j] = make_float4(tgt[3 * j], tgt[3 * j + 1], tgt[3 * j + 2], 0.0f);
  __syncthreads();
  float v[kRed];
#pragma unroll
  for (int k = 0; k < kRed; ++k) v[k] = 0.0f;
  for (int i = vt; i < m; i += kThreads) {
    const float4 p = ys[i];
    v[0] += p.x; v[1] += p.y; v[2] += p.z;
  }
  for (int j = vt; j < n; j += kThreads) {
    const float4 p = xs[j];
    v[3] += p.x; v[4] += p.y; v[5] += p.z;
  }
  pair_reduce<kRed, kThreads, G>(v, red[0], sums);
  const float inv_mn = 1.0f / (float)(m + n);
  const float cx = (sums[0] + sums[3]) * inv_mn;
  const float cy = (sums[1] + sums[4]) * inv_mn;
  const float cz = (sums[2] + sums[5]) * inv_mn;
  for (int i = tid; i < m; i += kBlock) {
    float4 p = ys[i];
    p.x -= cx; p.y -= cy; p.z -= cz;
    ys[i] = p;
  }
  for (int j = tid; j < n; j += kBlock) {
    float4 p = xs[j];
    p.x -= cx; p.y -= cy; p.z -= cz;
    p.w = p.x * p.x + p.y * p.y + p.z * p.z;
    xs[j] = p;
  }
  __syncthreads();
#pragma unroll
  for (int k = 0; k < kRed; ++k) v[k] = 0.0f;
  for (int i = vt; i < m; i += kThreads) {
    const float4 p = ys[i];
    v[0] += p.x; v[1] += p.y; v[2] += p.z;
    v[6] += p.x * p.x + p.y * p.y + p.z * p.z;
  }
  for (int j = vt; j < n; j += kThreads) {
    const float4 p = xs[j];
    v[3] += p.x; v[4] += p.y; v[5] += p.z;
    v[7] += p.w;
  }
  pair_reduce<kRed, kThreads, G>(v, red[1], sums);
  if (tid == 0) {
    // sigma2_0 = mean pairwise squared distance / 3, in closed form, and q0.
    const float fm = (float)m, fn = (float)n;
    const float dot = sums[0] * sums[3] + sums[1] * sums[4]
                      + sums[2] * sums[5];
    float sigma2 = (fn * sums[6] + fm * sums[7] - 2.0f * dot)
                   / (fm * 3.0f * fn);
    if (init) {
      // Row [lin0 (9), t0 (3), scale0, sigma2_0]. Raw frame -> centred
      // frame: lin = scale0 lin0, t_c = t0 + lin cen - cen (exact for the
      // identity); sigma2_0 <= 0 keeps the closed form above.
      const float* p = init + (size_t)b * 14;
      for (int k = 0; k < 9; ++k) st.lin[k] = p[12] * p[k];
      const float c3[3] = {cx, cy, cz};
      for (int i = 0; i < 3; ++i)
        st.t[i] = p[9 + i] + (st.lin[3 * i] * cx + st.lin[3 * i + 1] * cy
                              + st.lin[3 * i + 2] * cz) - c3[i];
      if (p[13] > 0.0f) sigma2 = p[13];
    } else {
      for (int k = 0; k < 9; ++k) st.lin[k] = (k % 4 == 0) ? 1.0f : 0.0f;
      st.t[0] = st.t[1] = st.t[2] = 0.0f;
    }
    st.cen[0] = cx; st.cen[1] = cy; st.cen[2] = cz;
    st.sigma2 = sigma2;
    st.q = 1.0f + fn * 1.5f * logf(sigma2);
    st.q_prev = 3.4e38f;
    st.wratio = w > 0.0f ? w / (1.0f - w) * fm / fn : 0.0f;
    st.inv2s2 = 0.5f / sigma2;
    st.c = (float)((double)st.wratio
                   * pow(2.0 * 3.14159265358979323846 * (double)sigma2, 1.5));
    st.it = 0;
    st.go = maxiter > 0;
  }
  __syncthreads();

  const int split_a = pick_split<kThreads>(n);
  const int split_b = pick_split<kThreads>(m);
  const int nslots_a = kThreads / split_a, nslots_b = kThreads / split_b;
  while (st.go) {
    const float inv2s2 = st.inv2s2, c = st.c;
    {
      float l[9], t[3];
#pragma unroll
      for (int k = 0; k < 9; ++k) l[k] = st.lin[k];
#pragma unroll
      for (int k = 0; k < 3; ++k) t[k] = st.t[k];
      for (int i = tid; i < m; i += kBlock) {
        const float4 y = ys[i];
        ts[i] = make_float4(l[0] * y.x + l[1] * y.y + l[2] * y.z + t[0],
                            l[3] * y.x + l[4] * y.y + l[5] * y.z + t[1],
                            l[6] * y.x + l[7] * y.y + l[8] * y.z + t[2],
                            0.0f);
      }
    }
    __syncthreads();

    // Pass A: column normalizers, complete inside the pair.
    float xx = 0.0f;
    {
      const int sub = vt & (split_a - 1), slot = vt / split_a;
      for (int j0 = 0; j0 < n; j0 += nslots_a) {
        const int j = j0 + slot;
        const bool ok = j < n;
        const float4 x = ok ? xs[j] : make_float4(0.f, 0.f, 0.f, 0.f);
        float s = 0.0f;
        if (ok) {
          // Four Gaussians in flight, added in the loop's order.
          int i = sub;
          for (; i + 3 * split_a < m; i += 4 * split_a) {
            const float g0 = gauss(ts[i], x, inv2s2);
            const float g1 = gauss(ts[i + split_a], x, inv2s2);
            const float g2 = gauss(ts[i + 2 * split_a], x, inv2s2);
            const float g3 = gauss(ts[i + 3 * split_a], x, inv2s2);
            s += g0; s += g1; s += g2; s += g3;
          }
          for (; i < m; i += split_a) s += gauss(ts[i], x, inv2s2);
        }
        s = group_sum(s, split_a);
        if (ok && sub == 0) {
          const float inv = 1.0f / ((s == 0.0f ? kEpsF32 : s) + c);
          inv_den[j] = inv;
          xx += s * inv * x.w;  // pt1_j |x_j|^2
        }
      }
    }
    if constexpr (G > 1) {
      // Column j belongs to virtual thread (j mod nslots_a) split_a.
      pair_sync<G>();
      for (int j = tid; j < n; j += kBlock) {
        const int owner = (j % nslots_a) * split_a / kBlock;
        if (owner != r) inv_den[j] = owner_read<G>(inv_den, owner, j);
      }
    }
    __syncthreads();

    // Pass B: row moments with the Gaussian recomputed.
#pragma unroll
    for (int k = 0; k < kRed; ++k) v[k] = 0.0f;
    {
      const int sub = vt & (split_b - 1), slot = vt / split_b;
      for (int i0 = 0; i0 < m; i0 += nslots_b) {
        const int i = i0 + slot;
        const bool ok = i < m;
        const float4 y = ok ? ts[i] : make_float4(0.f, 0.f, 0.f, 0.f);
        float a0 = 0.f, a1 = 0.f, a2 = 0.f, a3 = 0.f;
        if (ok) {
          // Four Gaussians in flight, added in the loop's order.
          int j = sub;
          for (; j + 3 * split_b < n; j += 4 * split_b) {
            const float4 x0 = xs[j], x1 = xs[j + split_b];
            const float4 x2 = xs[j + 2 * split_b], x3 = xs[j + 3 * split_b];
            const float p0 = gauss(y, x0, inv2s2) * inv_den[j];
            const float p1 = gauss(y, x1, inv2s2) * inv_den[j + split_b];
            const float p2 = gauss(y, x2, inv2s2) * inv_den[j + 2 * split_b];
            const float p3 = gauss(y, x3, inv2s2) * inv_den[j + 3 * split_b];
            a3 += p0; a0 += p0 * x0.x; a1 += p0 * x0.y; a2 += p0 * x0.z;
            a3 += p1; a0 += p1 * x1.x; a1 += p1 * x1.y; a2 += p1 * x1.z;
            a3 += p2; a0 += p2 * x2.x; a1 += p2 * x2.y; a2 += p2 * x2.z;
            a3 += p3; a0 += p3 * x3.x; a1 += p3 * x3.y; a2 += p3 * x3.z;
          }
          for (; j < n; j += split_b) {
            const float4 x = xs[j];
            const float p = gauss(y, x, inv2s2) * inv_den[j];
            a3 += p;
            a0 += p * x.x;
            a1 += p * x.y;
            a2 += p * x.z;
          }
        }
        a0 = group_sum(a0, split_b); a1 = group_sum(a1, split_b);
        a2 = group_sum(a2, split_b); a3 = group_sum(a3, split_b);
        if (ok && sub == 0) {
          ts[i] = make_float4(a0, a1, a2, a3);  // (px_i, p1_i)
          const float4 yr = ys[i];
          v[0] += a3;
          v[1] += a0; v[2] += a1; v[3] += a2;
          v[4] += a3 * yr.x; v[5] += a3 * yr.y; v[6] += a3 * yr.z;
        }
      }
    }
    v[7] = xx;
    pair_reduce<kRed, kThreads, G>(v, red[0], sums);
    if (tid == 0) {
      const float n_p = sums[0];
      st.n_p = n_p;
      st.xx = sums[7];
      for (int k = 0; k < 3; ++k) {
        st.mu_x[k] = sums[1 + k] / n_p;
        st.mu_y[k] = sums[4 + k] / n_p;
      }
    }
    __syncthreads();

    // M-step sums about the weighted source mean. Row i's (px, p1) lies
    // with virtual thread (i mod nslots_b) split_b of pass B.
    {
      const float my0 = st.mu_y[0], my1 = st.mu_y[1], my2 = st.mu_y[2];
#pragma unroll
      for (int k = 0; k < kRed; ++k) v[k] = 0.0f;
      for (int i = vt; i < m; i += kThreads) {
        const float4 pp =
            owner_read<G>(ts, (i % nslots_b) * split_b / kBlock, i);
        const float4 yr = ys[i];
        const float h0 = yr.x - my0, h1 = yr.y - my1, h2 = yr.z - my2;
        v[0] += pp.x * h0; v[1] += pp.x * h1; v[2] += pp.x * h2;
        v[3] += pp.y * h0; v[4] += pp.y * h1; v[5] += pp.y * h2;
        v[6] += pp.z * h0; v[7] += pp.z * h1; v[8] += pp.z * h2;
        const float w0 = pp.w * h0, w1 = pp.w * h1, w2 = pp.w * h2;
        v[9] += w0; v[10] += w1; v[11] += w2;
        v[12] += w0 * h0; v[13] += w0 * h1; v[14] += w0 * h2;
        v[15] += w1 * h1; v[16] += w1 * h2; v[17] += w2 * h2;
      }
    }
    pair_reduce<kRed, kThreads, G>(v, red[1], sums);
    if (tid == 0) mstep(st, sums, maxiter, tol, update_scale, affine);
    __syncthreads();
  }
  // No block leaves while another may still read its shared memory.
  if constexpr (G > 1) pair_sync<G>();

  if (r == 0 && tid == 0) {
    float* o = out + (size_t)b * 16;
    for (int k = 0; k < 9; ++k) o[k] = st.lin[k];
    // Centred frame -> raw frame: t = t_c + cen - lin cen.
    for (int i = 0; i < 3; ++i)
      o[9 + i] = st.t[i] + st.cen[i]
                 - (st.lin[3 * i] * st.cen[0] + st.lin[3 * i + 1] * st.cen[1]
                    + st.lin[3 * i + 2] * st.cen[2]);
    o[12] = st.sigma2;
    o[13] = st.q;
    o[14] = (float)st.it;
    o[15] = 0.0f;
  }
}

}  // namespace

extern "C" {

// Shared memory of one block for clouds of m_cap and n_cap points.
int probreg_em_smem_bytes(int m_cap, int n_cap) {
  return 32 * m_cap + 20 * n_cap;
}

// One launch of whole-EM CPD for a batch: cluster blocks per pair (1, 2,
// 4 or 8), order (B,) int32 or null, init (B, 14) f32 rows [lin0 (9), t0
// (3, raw frame), scale0, sigma2_0 (<= 0: the closed form)] or null (the
// identity and the closed form).
int probreg_em_cpd(const void* src, int m_cap, const void* tgt, int n_cap,
                   const void* counts, const void* order, int batch,
                   int cluster, float w, int maxiter, float tol,
                   int update_scale, int affine, const void* init, void* out,
                   void* stream) {
  if (batch <= 0) return (int)cudaErrorInvalidValue;
  const int smem = probreg_em_smem_bytes(m_cap, n_cap);
  decltype(&em_kernel<1>) kernel = nullptr;
  switch (cluster) {
    case 1: kernel = em_kernel<1>; break;
    case 2: kernel = em_kernel<2>; break;
    case 4: kernel = em_kernel<4>; break;
    case 8: kernel = em_kernel<8>; break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)launch_pairs(kernel, batch, cluster, kThreads, smem,
                           (cudaStream_t)stream, (const float*)src, m_cap,
                           (const float*)tgt, n_cap, (const int*)counts,
                           (const int*)order, (const float*)init, w,
                           maxiter, tol, update_scale, affine, (float*)out);
}

}  // extern "C"
