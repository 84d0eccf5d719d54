// Whole point-to-point ICP for Hopper (sm_90a), bound to Python with ctypes.
//
// Replaces probreg_tpu/ops/em_pallas.py:_icp_kernel (run_icp_fused,
// run_icp_fused_batch): one launch runs a whole ICP registration, the
// nearest-neighbour matching, the rigid solve and the stop test of every
// iteration, with no host read between launch and result. A pair runs on
// kThreads = 1,024 threads: one block (G = 1) or a thread-block cluster of
// G = 2, 4 or 8 blocks of kThreads / G threads on G SMs, which the wrapper
// picks when the batch leaves SMs idle (em_cuda.launch_plan). Every pair
// keeps its own stop state, so the pairs of a ragged batch stop at their
// own iterations; when a ragged batch's blocks outnumber the SMs the
// wrapper hands a work order, the largest m n first, and cluster (or
// block) c registers pair order[c] and writes its row. A thread has at
// most 64 registers at G = 1, 128 at G = 2 and 255 at G = 4 and 8.
//
// The TPU kernel forms the (M, N) distance matrix with one matmul and the
// hard correspondences as a one-hot matrix, because the MXU makes both
// cheap. Neither fits or pays here: a thread (or a group of 2..32 adjacent
// lanes, when there are fewer rows than threads) owns one source row,
// transforms it and scans the targets in shared memory for the nearest one,
// four distances in flight compared in the loop's order, d2 from
// coordinate differences in f32 FMAs, keeping the first index on
// ties (the reference's twin icp._run_icp takes argmin; its kernel averages
// exactly tied targets instead). The matched target goes straight into the
// Kabsch sums, so no per-row state is kept. Both centred clouds stay in
// shared memory for the whole run, 16 B per point, in every block of a
// cluster; device memory is read once and 16 floats are written.
//
// Bound on this card: operations, about 9 instructions per pair and
// iteration (a broadcast 16 B shared load, 3 differences, 3 FMAs, a
// compare and two selects) on the G SMs that run the pair, plus the
// serial part of each iteration: one reduction of 13 sums and the Horn
// solve by Jacobi sweeps in double in one thread of every block
// (em_common.cuh).
//
// Per iteration, from the clouds centred on the shared centroid of the
// valid points (y the source, x the target):
//   n_p = max(m, 1), mu_y = sum y / n_p (fixed), yh = y - mu_y;
//   x_i = the nearest target to R y_i + t, dmin_i its squared distance;
//   mu_x = sum x_i / n_p, a = sum x_i yh_i^T - mu_x (sum yh)^T;
//   R = Horn(a) (scale 1), t = mu_x - R mu_y;
//   rmse = sqrt(sum dmin / n_p), taken at the incoming transform.
// Go on while it < maxiter and (it < 2 or |rmse_prev - rmse| >= tol)
// (em_pallas.py:645-649). All sums are fixed-order trees (shuffles, then
// warps in order): no atomics, so a result is the same from run to run,
// and the same for every G and any work order: the cluster's blocks run
// the one-block kernel's threads with its split and its sums' trees (see
// icp_kernel).

#include <cuda_runtime.h>

#include "em_common.cuh"

namespace {

constexpr int kThreads = 1024;
constexpr int kRed = 13;  // sum x (3), sum x yh^T (9), sum dmin (1)

struct State {
  float rot[9], t[3], cen[3], mu_y[3], sy[3];
  float n_p, rmse, rmse_prev;
  int it, go;
};

// The rigid solve of one iteration, in one thread, from the pair's sums.
__device__ void solve(State& st, const float* s, int maxiter, float tol) {
  const float n_p = st.n_p;
  float mu_x[3];
  for (int i = 0; i < 3; ++i) mu_x[i] = s[i] / n_p;
  double a[3][3];
  for (int i = 0; i < 3; ++i)
    for (int j = 0; j < 3; ++j)
      a[i][j] = (double)s[3 + 3 * i + j] - (double)mu_x[i] * (double)st.sy[j];
  double rot[3][3];
  horn_rotation(a, rot);
  for (int i = 0; i < 3; ++i) {
    double t = mu_x[i];
    for (int j = 0; j < 3; ++j) {
      st.rot[3 * i + j] = (float)rot[i][j];
      t -= rot[i][j] * (double)st.mu_y[j];
    }
    st.t[i] = (float)t;
  }
  st.rmse_prev = st.rmse;
  st.rmse = sqrtf(s[12] / n_p);
  st.it += 1;
  // A NaN rmse stops the loop.
  st.go = st.it < maxiter
          && (st.it < 2 || fabsf(st.rmse_prev - st.rmse) >= tol);
}

// One pair on G blocks of kThreads / G threads (a thread-block cluster when
// G > 1). Block r runs the virtual threads vt = r kThreads / G + tid of the
// one-block kernel (G = 1), each walking the same rows and points with the
// same split, and the sums keep that kernel's trees (pair_reduce): the
// result is the same bits for every G. Each block holds both whole clouds
// and solves on the same sums in its own thread 0. ``order`` (may be
// null): cluster (or block) c registers pair order[c].
template <int G>
__global__ void __launch_bounds__(kThreads / G)
icp_kernel(const float* __restrict__ src, int m_cap,   // (B, m_cap, 3)
           const float* __restrict__ tgt, int n_cap,   // (B, n_cap, 3)
           const int* __restrict__ counts,  // (B, 2) valid points, or null
           const int* __restrict__ order,   // (B,) work order, or null
           const float* __restrict__ init,  // (B, 12) [rot0, t0], or null
           int maxiter, float tol,
           float* __restrict__ out) {       // (B, 16)
  constexpr int kBlock = kThreads / G;
  extern __shared__ float4 pts[];
  float4* ys = pts;           // centred source
  float4* xs = ys + m_cap;    // centred target
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

  // Load, centre on the shared centroid of the valid points, then the
  // fixed source mean and sum of yh.
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
  pair_reduce<kRed, kThreads, G>(v, red[rb], sums);
  rb ^= 1;
  const float mn = (float)(m + n > 0 ? m + n : 1);
  const float cx = (sums[0] + sums[3]) / mn;
  const float cy = (sums[1] + sums[4]) / mn;
  const float cz = (sums[2] + sums[5]) / mn;
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
  __syncthreads();
#pragma unroll
  for (int k = 0; k < kRed; ++k) v[k] = 0.0f;
  for (int i = vt; i < m; i += kThreads) {
    const float4 p = ys[i];
    v[0] += p.x; v[1] += p.y; v[2] += p.z;
  }
  pair_reduce<kRed, kThreads, G>(v, red[rb], sums);
  rb ^= 1;
  const float n_p = (float)(m > 1 ? m : 1);
  const float my0 = sums[0] / n_p, my1 = sums[1] / n_p, my2 = sums[2] / n_p;
#pragma unroll
  for (int k = 0; k < kRed; ++k) v[k] = 0.0f;
  for (int i = vt; i < m; i += kThreads) {
    const float4 p = ys[i];
    v[0] += p.x - my0; v[1] += p.y - my1; v[2] += p.z - my2;
  }
  pair_reduce<kRed, kThreads, G>(v, red[rb], sums);
  rb ^= 1;
  if (tid == 0) {
    st.cen[0] = cx; st.cen[1] = cy; st.cen[2] = cz;
    st.mu_y[0] = my0; st.mu_y[1] = my1; st.mu_y[2] = my2;
    st.sy[0] = sums[0]; st.sy[1] = sums[1]; st.sy[2] = sums[2];
    st.n_p = n_p;
    if (init) {
      // Raw frame -> centred frame: t_c = t0 + rot0 cen - cen.
      const float* r0 = init + (size_t)b * 12;
      for (int k = 0; k < 9; ++k) st.rot[k] = r0[k];
      for (int i = 0; i < 3; ++i)
        st.t[i] = r0[9 + i] + (r0[3 * i] * cx + r0[3 * i + 1] * cy
                               + r0[3 * i + 2] * cz) - st.cen[i];
    } else {
      for (int k = 0; k < 9; ++k) st.rot[k] = (k % 4 == 0) ? 1.0f : 0.0f;
      st.t[0] = st.t[1] = st.t[2] = 0.0f;
    }
    st.rmse = st.rmse_prev = 3.4e38f;
    st.it = 0;
    st.go = maxiter > 0 && m > 0 && n > 0;
  }
  __syncthreads();

  const int split = pick_split<kThreads>(m);
  const int sub = vt & (split - 1), slot = vt / split;
  const int nslots = kThreads / split;
  while (st.go) {
    float r[9], t[3];
#pragma unroll
    for (int k = 0; k < 9; ++k) r[k] = st.rot[k];
#pragma unroll
    for (int k = 0; k < 3; ++k) t[k] = st.t[k];
#pragma unroll
    for (int k = 0; k < kRed; ++k) v[k] = 0.0f;
    for (int i0 = 0; i0 < m; i0 += nslots) {
      const int i = i0 + slot;
      const bool ok = i < m;
      const float4 y = ok ? ys[i] : make_float4(0.f, 0.f, 0.f, 0.f);
      const float tx = r[0] * y.x + r[1] * y.y + r[2] * y.z + t[0];
      const float ty = r[3] * y.x + r[4] * y.y + r[5] * y.z + t[1];
      const float tz = r[6] * y.x + r[7] * y.y + r[8] * y.z + t[2];
      float best = 3.4e38f;
      int bj = 0x7fffffff;
      if (ok) {
        // Four distances in flight, compared in the loop's order.
        int j = sub;
        for (; j + 3 * split < n; j += 4 * split) {
          float d[4];
#pragma unroll
          for (int u = 0; u < 4; ++u) {
            const float4 x = xs[j + u * split];
            const float dx = tx - x.x, dy = ty - x.y, dz = tz - x.z;
            d[u] = dx * dx + dy * dy + dz * dz;
          }
#pragma unroll
          for (int u = 0; u < 4; ++u)  // strict: the first index
            if (d[u] < best) { best = d[u]; bj = j + u * split; }
        }
        for (; j < n; j += split) {
          const float4 x = xs[j];
          const float dx = tx - x.x, dy = ty - x.y, dz = tz - x.z;
          const float d = dx * dx + dy * dy + dz * dz;
          if (d < best) { best = d; bj = j; }  // strict: the first index
        }
      }
      // The group's nearest target; equal distances keep the lower index.
      for (int o = split >> 1; o > 0; o >>= 1) {
        const float ob = __shfl_xor_sync(0xffffffffu, best, o);
        const int oj = __shfl_xor_sync(0xffffffffu, bj, o);
        if (ob < best || (ob == best && oj < bj)) { best = ob; bj = oj; }
      }
      if (ok && sub == 0) {
        const float4 x = xs[bj];
        const float h0 = y.x - my0, h1 = y.y - my1, h2 = y.z - my2;
        v[0] += x.x; v[1] += x.y; v[2] += x.z;
        v[3] += x.x * h0; v[4] += x.x * h1; v[5] += x.x * h2;
        v[6] += x.y * h0; v[7] += x.y * h1; v[8] += x.y * h2;
        v[9] += x.z * h0; v[10] += x.z * h1; v[11] += x.z * h2;
        v[12] += best;
      }
    }
    pair_reduce<kRed, kThreads, G>(v, red[rb], sums);
    rb ^= 1;
    if (tid == 0) solve(st, sums, maxiter, tol);
    __syncthreads();
  }
  // No block leaves while another may still read its shared memory.
  if constexpr (G > 1) pair_sync<G>();

  if (rank == 0 && tid == 0) {
    float* o = out + (size_t)b * 16;
    for (int k = 0; k < 9; ++k) o[k] = st.rot[k];
    // Centred frame -> raw frame: t = t_c + cen - rot cen.
    for (int i = 0; i < 3; ++i)
      o[9 + i] = st.t[i] + st.cen[i]
                 - (st.rot[3 * i] * st.cen[0] + st.rot[3 * i + 1] * st.cen[1]
                    + st.rot[3 * i + 2] * st.cen[2]);
    o[12] = st.rmse;
    o[13] = (float)st.it;
    o[14] = 0.0f;
    o[15] = 0.0f;
  }
}

}  // namespace

extern "C" {

// Shared memory of one block for clouds of m_cap and n_cap points.
int probreg_icp_smem_bytes(int m_cap, int n_cap) {
  return 16 * (m_cap + n_cap);
}

// src (B, m_cap, 3), tgt (B, n_cap, 3) f32; counts (B, 2) int32 valid
// points (at the front) or null; order (B,) int32 work order or null; init
// (B, 12) [rot0, t0] or null; cluster blocks per pair (1, 2, 4 or 8); out
// (B, 16): [rot (9), t (3), rmse, n_iter, 0, 0].
int probreg_icp(const void* src, int m_cap, const void* tgt, int n_cap,
                const void* counts, const void* order, const void* init,
                int batch, int cluster, int maxiter, float tol, void* out,
                void* stream) {
  if (batch <= 0) return (int)cudaErrorInvalidValue;
  decltype(&icp_kernel<1>) kernel = nullptr;
  switch (cluster) {
    case 1: kernel = icp_kernel<1>; break;
    case 2: kernel = icp_kernel<2>; break;
    case 4: kernel = icp_kernel<4>; break;
    case 8: kernel = icp_kernel<8>; break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)launch_pairs(kernel, batch, cluster, kThreads,
                           probreg_icp_smem_bytes(m_cap, n_cap),
                           (cudaStream_t)stream, (const float*)src, m_cap,
                           (const float*)tgt, n_cap, (const int*)counts,
                           (const int*)order, (const float*)init, maxiter,
                           tol, (float*)out);
}

}  // extern "C"
