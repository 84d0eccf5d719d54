// Whole-EM rigid FilterReg for Hopper (sm_90a), bound to Python with ctypes.
//
// Replaces probreg_tpu/ops/em_pallas.py:_frg_kernel (run_em_filterreg_fused,
// run_em_filterreg_fused_batch): one launch runs a whole registration, the
// convergence test included, with no host read between launch and result.
// A pair runs on kThreads = 1,024 threads: one block (G = 1) or a
// thread-block cluster of G = 2, 4 or 8 blocks of kThreads / G threads on
// G SMs, which the wrapper picks when the batch leaves SMs idle
// (em_cuda.launch_plan). Every pair keeps its own state, so the pairs of a
// ragged batch stop at their own iterations; when a ragged batch's blocks
// outnumber the SMs the wrapper hands a work order, the largest m n first,
// and cluster (or block) c registers pair order[c] and writes its row. A
// thread has at most 64 registers at G = 1 (one block an SM), 128 at G = 2
// and 255 at G = 4 and 8.
//
// FilterReg's E-step moments are ROW sums of the unnormalized Gaussian
// (no column normalizer), so one pass over the pair per iteration
// suffices: a thread, or a group of 2..32 adjacent lanes when there are
// fewer rows than threads, takes one source row, transforms it, and loops
// over the targets in shared memory with four Gaussians in flight:
//   m0 = sum_j g_ij, m1 = sum_j g_ij x_j, nx = sum_j g_ij n_j (pt2pl),
//   e2 = sum_j g_ij |t_i - x_j|^2 (sigma2 update; the reference forms it
//        from the moments as m0 |t|^2 - 2 t.m1 + m2, the same sum),
// with g_ij = exp(-|t_i - x_j|^2 / (2 sigma2)). Shared memory holds the
// centred source and its moments (48 B per source point) and the centred
// target (16 B), plus the normals for pt2pl (16 B); nothing else of the
// pair; each block of a cluster holds the whole pair, and the moments of a
// row live with the block of the thread that formed them. The kernel is
// bound by operations (the Gaussian and the moment FMAs per pair and
// iteration); its device-memory traffic is reading the clouds once and
// writing 16 floats.
//
// M-step (reference filterreg.py:78-228, em_pallas.py:859-967), from
// fixed-order block sums of per-row terms, solved in one thread in double:
// * pt2pt: weighted Kabsch by Horn's quaternion method with a = hh^T (the
//   shared Jacobi eigen-solve of csrc/em_common.cuh);
// * pt2pl: one Gauss-Newton twist step. The 6 x 6 normal equations get the
//   reference kernel's relative ridge 1e-7 (tr A + tr C) + eps^2 and are
//   solved by elimination with partial pivoting (the same solution as the
//   reference's Schur form); the step is capped at 0.5 rad of rotation and
//   applied by the exact Rodrigues formula, identity below an angle^2 of
//   1e-12.
// A pair whose weights are all zero keeps its transform. sigma2 is updated
// (update_sigma2) or decayed, then floored at min_sigma2. The loop runs at
// least once and goes on while |q - q_prev| >= tol, as the reference's.
//
// Like the twin _run_em_rigid (and unlike the reference's fused kernel)
// the pair is centred on its shared centroid here and d2 is taken from
// differences. A pair may start from its own pose (``init``, as K7 takes
// it; the multistart searches run S starts of B pairs as one launch): the
// raw-frame start converts to the centred frame as _run_em_rigid's does,
// after sigma2_0, which stays that of the un-moved clouds. The automatic sigma2_0 is computed here from the valid
// points (pt2pt: the closed-form mean squared distance / 3; pt2pl: the
// mean squared nearest-neighbour spacing of the target), so a masked pair
// is bitwise the same registration as the pair without its padding. IEEE
// f32, expf, no fast-math, no atomics. All sums are fixed-order trees, and
// the blocks of a cluster run the one-block kernel's threads with its
// splits and its sums' trees (see frg_kernel), so a result is the same
// bits for every G and any work order.

#include <cuda_runtime.h>

#include "em_common.cuh"

namespace {

constexpr int kThreads = 1024;
constexpr int kRed = 31;  // widest block reduction (the pt2pl M-step sums)
constexpr double kPi = 3.14159265358979323846;

struct State {
  float rot[9], t[3], cen[3];
  float sigma2, q, wratio;
  float mc[3], tc[3];  // pt2pt centroids of the iteration
  int it, go;
};

struct Params {
  float w, tol, sigma2_decay, min_sigma2, sigma2_0;
  int maxiter, update_sigma2, auto_sigma2;
};

__device__ __forceinline__ float3 apply(const State& st, float4 y) {
  const float* r = st.rot;
  return make_float3(r[0] * y.x + r[1] * y.y + r[2] * y.z + st.t[0],
                     r[3] * y.x + r[4] * y.y + r[5] * y.z + st.t[1],
                     r[6] * y.x + r[7] * y.y + r[8] * y.z + st.t[2]);
}

// One point-to-plane twist step from the block sums s[1..28) (the upper
// triangle of sum_i w J J^T row by row, then sum_i w r J): (dr, dt).
__device__ void pt2pl_step(const float* s, double dr[3][3], double dt[3]) {
  double a[6][6], b[6], x[6];
  int k = 1;
  for (int i = 0; i < 6; ++i)
    for (int j = i; j < 6; ++j) a[i][j] = a[j][i] = (double)s[k++];
  for (int i = 0; i < 6; ++i) b[i] = (double)s[k++];
  const double eps = (double)kEpsF32;
  const double lam = 1e-7 * (a[0][0] + a[1][1] + a[2][2] + a[3][3]
                             + a[4][4] + a[5][5]) + eps * eps;
  for (int i = 0; i < 6; ++i) a[i][i] += lam;
  solve6(a, b, x);
  const double wn2 = x[0] * x[0] + x[1] * x[1] + x[2] * x[2];
  const double fac = fmin(1.0, 0.5 / sqrt(fmax(wn2, 1e-24)));
  for (int i = 0; i < 6; ++i) x[i] *= fac;
  const double twd2 = x[0] * x[0] + x[1] * x[1] + x[2] * x[2];
  for (int i = 0; i < 3; ++i) {
    for (int j = 0; j < 3; ++j) dr[i][j] = (i == j) ? 1.0 : 0.0;
    dt[i] = x[3 + i];
  }
  if (twd2 < 1e-12) return;
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

// One pair on G blocks of kThreads / G threads (a thread-block cluster when
// G > 1). Block r runs the virtual threads vt = r kThreads / G + tid of the
// one-block kernel (G = 1), each walking the same rows and points with the
// same split, and the sums keep that kernel's trees (pair_reduce): the
// result is the same bits for every G. Each block holds both whole clouds
// and runs the M-step on the same sums in its own thread 0; a row's
// moments are written by the block of the virtual thread that formed them
// and read there by the others. ``order`` (may be null): cluster (or
// block) c registers pair order[c].
template <bool PT2PL, bool E2, int G>
__global__ void __launch_bounds__(kThreads / G)
frg_kernel(const float* __restrict__ src, int m_cap,  // (B, m_cap, 3)
           const float* __restrict__ tgt, int n_cap,  // (B, n_cap, 3)
           const float* __restrict__ nrm,   // (B, n_cap, 3) for pt2pl
           const int* __restrict__ counts,  // (B, 2) valid points, or null
           const int* __restrict__ order,   // (B,) work order, or null
           const float* __restrict__ init,  // (B, 12) [rot0, t0], or null
           Params prm, float* __restrict__ out) {      // (B, 16)
  constexpr int kBlock = kThreads / G;
  extern __shared__ float4 smem[];
  float4* ys = smem;                 // centred source
  float4* mom_a = ys + m_cap;        // (m1, m0) per source row
  float4* mom_b = mom_a + m_cap;     // (nx, e2) per source row
  float4* xs = mom_b + m_cap;        // centred target
  float4* ns = xs + n_cap;           // target normals (pt2pl)
  __shared__ float red[2][kBlock / 32 * kRed];   // see pair_reduce
  __shared__ float sums[kRed];
  __shared__ State st;

  const int tid = threadIdx.x;
  const int b = order ? order[blockIdx.x / G] : blockIdx.x / G;
  const int rank = cluster_rank<G>();
  const int vt = rank * kBlock + tid;  // the thread of the one-block kernel
  const int m = counts ? counts[2 * b] : m_cap;
  const int n = counts ? counts[2 * b + 1] : n_cap;
  src += (size_t)b * m_cap * 3;
  tgt += (size_t)b * n_cap * 3;
  int rb = 0;  // the red buffer of the next pair_reduce

  // Load, then centre on the shared centroid of the valid points.
  for (int i = tid; i < m; i += kBlock)
    ys[i] = make_float4(src[3 * i], src[3 * i + 1], src[3 * i + 2], 0.0f);
  for (int j = tid; j < n; j += kBlock) {
    xs[j] = make_float4(tgt[3 * j], tgt[3 * j + 1], tgt[3 * j + 2], 0.0f);
    if (PT2PL) {
      const float* q = nrm + ((size_t)b * n_cap + j) * 3;
      ns[j] = make_float4(q[0], q[1], q[2], 0.0f);
    }
  }
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
  pair_reduce<kRed, kThreads, G>(v, red[rb], sums);
  rb ^= 1;
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
    xs[j] = p;
  }
  __syncthreads();  // every point centred before the sums and spacing read
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
    v[7] += p.x * p.x + p.y * p.y + p.z * p.z;
  }
  if (PT2PL && prm.auto_sigma2) {
    // Mean squared nearest-neighbour spacing of the target, exact matches
    // (the point itself) excluded; a point with no other counts 0.
    for (int j = vt; j < n; j += kThreads) {
      const float4 x = xs[j];
      float best = __int_as_float(0x7f800000);  // +inf
      for (int k = 0; k < n; ++k) {
        const float4 y = xs[k];
        const float dx = x.x - y.x, dy = x.y - y.y, dz = x.z - y.z;
        const float d2 = dx * dx + dy * dy + dz * dz;
        if (d2 > 1e-12f && d2 < best) best = d2;
      }
      if (best < __int_as_float(0x7f800000)) v[8] += best;
    }
  }
  pair_reduce<kRed, kThreads, G>(v, red[rb], sums);
  rb ^= 1;
  if (tid == 0) {
    const float fm = (float)m, fn = (float)n;
    float sigma2 = prm.sigma2_0;
    if (prm.auto_sigma2) {
      if (PT2PL) {
        sigma2 = fmaxf(sums[8] / fn, prm.min_sigma2 * 0.01f);
      } else {
        const float dot = sums[0] * sums[3] + sums[1] * sums[4]
                          + sums[2] * sums[5];
        sigma2 = fmaxf((fn * sums[6] + fm * sums[7] - 2.0f * dot)
                       / (fm * 3.0f * fn), prm.min_sigma2);
      }
    }
    if (init) {
      // Raw frame -> centred frame: t_c = t0 + rot0 cen - cen (exact for
      // the identity).
      const float* r0 = init + (size_t)b * 12;
      const float c3[3] = {cx, cy, cz};
      for (int k = 0; k < 9; ++k) st.rot[k] = r0[k];
      for (int i = 0; i < 3; ++i)
        st.t[i] = r0[9 + i] + (r0[3 * i] * cx + r0[3 * i + 1] * cy
                               + r0[3 * i + 2] * cz) - c3[i];
    } else {
      for (int k = 0; k < 9; ++k) st.rot[k] = (k % 4 == 0) ? 1.0f : 0.0f;
      st.t[0] = st.t[1] = st.t[2] = 0.0f;
    }
    st.cen[0] = cx; st.cen[1] = cy; st.cen[2] = cz;
    st.sigma2 = sigma2;
    st.q = 1e30f;
    st.wratio = prm.w > 0.0f ? prm.w / (1.0f - prm.w) * fn / fm : 0.0f;
    st.it = 0;
    st.go = prm.maxiter > 0;
  }
  __syncthreads();

  const int split = pick_split<kThreads>(m);
  const int sub = vt & (split - 1), slot = vt / split;
  const int nslots = kThreads / split;
  while (st.go) {
    const float sigma2 = st.sigma2;
    const float inv2s2 = 0.5f / sigma2;
    const float c = (float)((double)st.wratio
                            * pow(2.0 * kPi * (double)sigma2, 1.5));

    // E-step: the moments of each source row.
    for (int i0 = 0; i0 < m; i0 += nslots) {
      const int i = i0 + slot;
      const bool ok = i < m;
      const float3 y = apply(st, ok ? ys[i] : make_float4(0.f, 0.f, 0.f, 0.f));
      float m0 = 0.f, m1x = 0.f, m1y = 0.f, m1z = 0.f;
      float nxx = 0.f, nxy = 0.f, nxz = 0.f, e2 = 0.f;
      if (ok) {
        // Four Gaussians in flight, added in the loop's order.
        int j = sub;
        for (; j + 3 * split < n; j += 4 * split) {
          float4 x[4];
          float d2[4], g[4];
#pragma unroll
          for (int u = 0; u < 4; ++u) {
            x[u] = xs[j + u * split];
            const float dx = y.x - x[u].x, dy = y.y - x[u].y,
                        dz = y.z - x[u].z;
            d2[u] = dx * dx + dy * dy + dz * dz;
            g[u] = expf(-d2[u] * inv2s2);
          }
#pragma unroll
          for (int u = 0; u < 4; ++u) {
            m0 += g[u];
            m1x += g[u] * x[u].x; m1y += g[u] * x[u].y; m1z += g[u] * x[u].z;
            if (E2) e2 += g[u] * d2[u];
            if (PT2PL) {
              const float4 nv = ns[j + u * split];
              nxx += g[u] * nv.x; nxy += g[u] * nv.y; nxz += g[u] * nv.z;
            }
          }
        }
        for (; j < n; j += split) {
          const float4 x = xs[j];
          const float dx = y.x - x.x, dy = y.y - x.y, dz = y.z - x.z;
          const float d2 = dx * dx + dy * dy + dz * dz;
          const float g = expf(-d2 * inv2s2);
          m0 += g;
          m1x += g * x.x; m1y += g * x.y; m1z += g * x.z;
          if (E2) e2 += g * d2;
          if (PT2PL) {
            const float4 nv = ns[j];
            nxx += g * nv.x; nxy += g * nv.y; nxz += g * nv.z;
          }
        }
      }
      m0 = group_sum(m0, split);
      m1x = group_sum(m1x, split); m1y = group_sum(m1y, split);
      m1z = group_sum(m1z, split);
      if (E2) e2 = group_sum(e2, split);
      if (PT2PL) {
        nxx = group_sum(nxx, split); nxy = group_sum(nxy, split);
        nxz = group_sum(nxz, split);
      }
      if (ok && sub == 0) {
        mom_a[i] = make_float4(m1x, m1y, m1z, m0);
        mom_b[i] = make_float4(nxx, nxy, nxz, e2);
      }
    }
    pair_sync<G>();  // every row's moments written before any block reads

    // M-step sums over the rows: [total weight, objective sums, q, the two
    // sigma2-update sums]. Row i's moments lie with virtual thread
    // (i mod nslots) split of the E-step.
#pragma unroll
    for (int k = 0; k < kRed; ++k) v[k] = 0.0f;
    for (int i = vt; i < m; i += kThreads) {
      const int owner = (i % nslots) * split / kBlock;
      const float3 y = apply(st, ys[i]);
      const float4 ma = owner_read<G>(mom_a, owner, i);
      const float4 mb = owner_read<G>(mom_b, owner, i);
      const float m0 = ma.w;
      const float mask = m0 > 0.0f ? 1.0f : 0.0f;
      const float inv_m0 = 1.0f / fmaxf(m0, kEpsF32);
      const float tx = ma.x * inv_m0, ty = ma.y * inv_m0, tz = ma.z * inv_m0;
      const float den = fmaxf(m0 + c, kEpsF32);
      const float m0m0 = m0 / den;
      const float wt = mask * sqrtf(m0m0 / sigma2);
      v[0] += wt;
      if (E2) {
        v[29] += mask * mb.w / den;
        v[30] += mask * m0m0;
      }
      if (PT2PL) {
        const float nx = mb.x * inv_m0, ny = mb.y * inv_m0, nz = mb.z * inv_m0;
        const float r = nx * (tx - y.x) + ny * (ty - y.y) + nz * (tz - y.z);
        const float jac[6] = {y.y * nz - y.z * ny, y.z * nx - y.x * nz,
                              y.x * ny - y.y * nx, nx, ny, nz};
        int k = 1;
#pragma unroll
        for (int a = 0; a < 6; ++a)
#pragma unroll
          for (int bb = a; bb < 6; ++bb) v[k++] += wt * jac[a] * jac[bb];
#pragma unroll
        for (int a = 0; a < 6; ++a) v[22 + a] += wt * r * jac[a];
        v[28] += (wt * r) * (wt * r);
      } else {
        v[1] += wt * y.x; v[2] += wt * y.y; v[3] += wt * y.z;
        v[4] += wt * tx; v[5] += wt * ty; v[6] += wt * tz;
        const float ex = y.x - tx, ey = y.y - ty, ez = y.z - tz;
        v[28] += wt * sqrtf(ex * ex + ey * ey + ez * ez);
      }
    }
    pair_reduce<kRed, kThreads, G>(v, red[rb], sums);
    rb ^= 1;
    const float total = sums[0];
    if (!PT2PL) {
      // Weighted Kabsch: the cross-covariance about the weighted centroids.
      const float safe = total == 0.0f ? 1.0f : total;
      const float mcx = sums[1] / safe, mcy = sums[2] / safe,
                  mcz = sums[3] / safe;
      const float tcx = sums[4] / safe, tcy = sums[5] / safe,
                  tcz = sums[6] / safe;
      float h[9];
#pragma unroll
      for (int k = 0; k < 9; ++k) h[k] = 0.0f;
      for (int i = vt; i < m; i += kThreads) {
        const int owner = (i % nslots) * split / kBlock;
        const float3 y = apply(st, ys[i]);
        const float4 ma = owner_read<G>(mom_a, owner, i);
        const float m0 = ma.w;
        const float mask = m0 > 0.0f ? 1.0f : 0.0f;
        const float inv_m0 = 1.0f / fmaxf(m0, kEpsF32);
        const float w2 = mask * (m0 / fmaxf(m0 + c, kEpsF32)) / sigma2;
        const float ax = w2 * (y.x - mcx), ay = w2 * (y.y - mcy),
                    az = w2 * (y.z - mcz);
        const float bx = mask * (ma.x * inv_m0 - tcx),
                    by = mask * (ma.y * inv_m0 - tcy),
                    bz = mask * (ma.z * inv_m0 - tcz);
        h[0] += ax * bx; h[1] += ax * by; h[2] += ax * bz;
        h[3] += ay * bx; h[4] += ay * by; h[5] += ay * bz;
        h[6] += az * bx; h[7] += az * by; h[8] += az * bz;
      }
      if (tid == 0) {
        st.mc[0] = mcx; st.mc[1] = mcy; st.mc[2] = mcz;
        st.tc[0] = tcx; st.tc[1] = tcy; st.tc[2] = tcz;
      }
      pair_reduce<9, kThreads, G>(h, red[rb], sums + 9);
      rb ^= 1;
    }
    if (tid == 0) {
      double dr[3][3], dt[3];
      if (PT2PL) {
        pt2pl_step(sums, dr, dt);
      } else {
        double a[3][3];  // hh^T: Horn maximizes tr(a^T R) = tr(R hh)
        for (int i = 0; i < 3; ++i)
          for (int j = 0; j < 3; ++j) a[i][j] = (double)sums[9 + 3 * j + i];
        horn_rotation(a, dr);
        for (int i = 0; i < 3; ++i)
          dt[i] = (double)st.tc[i] - (dr[i][0] * st.mc[0]
                                      + dr[i][1] * st.mc[1]
                                      + dr[i][2] * st.mc[2]);
      }
      if (total == 0.0f) {  // no weight anywhere: keep the transform
        for (int i = 0; i < 3; ++i) {
          for (int j = 0; j < 3; ++j) dr[i][j] = (i == j) ? 1.0 : 0.0;
          dt[i] = 0.0;
        }
      }
      float rot[9], t[3];
      for (int i = 0; i < 3; ++i) {
        double tt = dt[i];
        for (int j = 0; j < 3; ++j) {
          double r = 0.0;
          for (int k = 0; k < 3; ++k)
            r += dr[i][k] * (double)st.rot[3 * k + j];
          rot[3 * i + j] = (float)r;
          tt += dr[i][j] * (double)st.t[j];
        }
        t[i] = (float)tt;
      }
      for (int k = 0; k < 9; ++k) st.rot[k] = rot[k];
      for (int k = 0; k < 3; ++k) st.t[k] = t[k];
      float s2 = E2 ? sums[29] / (3.0f * fmaxf(sums[30], kEpsF32))
                    : sigma2 * prm.sigma2_decay;
      st.sigma2 = fmaxf(s2, prm.min_sigma2);
      const float q_prev = st.q;
      st.q = sums[28];
      st.it += 1;
      // Go on while |q - q_prev| >= tol; a NaN q stops the loop.
      st.go = st.it < prm.maxiter && fabsf(st.q - q_prev) >= prm.tol;
    }
    __syncthreads();
  }
  // No block leaves while another may still read its shared memory.
  if constexpr (G > 1) pair_sync<G>();

  if (rank == 0 && tid == 0) {
    float* o = out + (size_t)b * 16;
    for (int k = 0; k < 9; ++k) o[k] = st.rot[k];
    // Centred frame -> raw frame: t = t_c + cen - R cen.
    for (int i = 0; i < 3; ++i)
      o[9 + i] = st.t[i] + st.cen[i]
                 - (st.rot[3 * i] * st.cen[0] + st.rot[3 * i + 1] * st.cen[1]
                    + st.rot[3 * i + 2] * st.cen[2]);
    o[12] = st.sigma2;
    o[13] = st.q;
    o[14] = (float)st.it;
    o[15] = 0.0f;
  }
}

// The kernel for the objective, the sigma2 update and the blocks per pair.
template <bool PT2PL, bool E2>
auto pick_kernel(int cluster) -> decltype(&frg_kernel<PT2PL, E2, 1>) {
  switch (cluster) {
    case 1: return frg_kernel<PT2PL, E2, 1>;
    case 2: return frg_kernel<PT2PL, E2, 2>;
    case 4: return frg_kernel<PT2PL, E2, 4>;
    case 8: return frg_kernel<PT2PL, E2, 8>;
    default: return nullptr;
  }
}

}  // namespace

extern "C" {

// src (B, m_cap, 3), tgt (B, n_cap, 3), nrm (B, n_cap, 3) or null (pt2pt)
// f32; counts (B, 2) int32 valid points (at the front) or null; order (B,)
// int32 work order or null; cluster blocks per pair (1, 2, 4 or 8); init
// (B, 12) f32 [rot0 (9), t0 (3)] raw-frame starts or null (the identity);
// out (B, 16): [rot (9), t (3), sigma2, q, n_iter, 0]. sigma2_0 is used
// when auto_sigma2 is 0.
int probreg_em_frg(const void* src, int m_cap, const void* tgt, int n_cap,
                   const void* nrm, const void* counts, const void* order,
                   int batch, int cluster, float w, int maxiter, float tol,
                   int update_sigma2, float sigma2_decay, float min_sigma2,
                   int auto_sigma2, float sigma2_0, int pt2pl,
                   const void* init, void* out, void* stream) {
  if (batch <= 0 || (pt2pl && nrm == nullptr))
    return (int)cudaErrorInvalidValue;
  const Params prm{w, tol, sigma2_decay, min_sigma2, sigma2_0, maxiter,
                   update_sigma2, auto_sigma2};
  const auto kernel =
      pt2pl ? (update_sigma2 ? pick_kernel<true, true>(cluster)
                             : pick_kernel<true, false>(cluster))
            : (update_sigma2 ? pick_kernel<false, true>(cluster)
                             : pick_kernel<false, false>(cluster));
  if (kernel == nullptr) return (int)cudaErrorInvalidValue;
  const int smem = 48 * m_cap + (pt2pl ? 32 : 16) * n_cap;
  return (int)launch_pairs(kernel, batch, cluster, kThreads, smem,
                           (cudaStream_t)stream, (const float*)src, m_cap,
                           (const float*)tgt, n_cap, (const float*)nrm,
                           (const int*)counts, (const int*)order,
                           (const float*)init, prm, (float*)out);
}

}  // extern "C"
