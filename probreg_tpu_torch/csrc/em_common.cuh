// Device helpers shared by the whole-loop kernels (em.cu: CPD, frg.cu:
// FilterReg, icp.cu: ICP, gmmtree.cu: GMMTree): fixed-order block and
// cluster reductions, the lane-group split, Horn's rotation solve by Jacobi
// sweeps in double, a 6 x 6 solve in double, and the launch of a batch of
// pairs on blocks or thread-block clusters.
#pragma once

#include <cooperative_groups.h>
#include <cuda_runtime.h>

namespace {

constexpr float kEpsF32 = 1.1920928955078125e-07f;  // np.finfo(f32).eps

// Sum over the `width` adjacent lanes of a group (width a power of two <= 32).
__device__ __forceinline__ float group_sum(float v, int width) {
  for (int o = width >> 1; o > 0; o >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// Block-wide sums of K values per thread, in a fixed order (shuffles, then
// the warps in order); the totals land in out[0..K) and are visible to every
// thread on return. red holds (THREADS / 32) * K floats.
template <int K, int THREADS>
__device__ void block_reduce(float (&v)[K], float* red, float* out) {
  constexpr int kWarps = THREADS / 32;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
#pragma unroll
  for (int k = 0; k < K; ++k) v[k] = group_sum(v[k], 32);
  if (lane == 0) {
#pragma unroll
    for (int k = 0; k < K; ++k) red[warp * K + k] = v[k];
  }
  __syncthreads();
  if (threadIdx.x < K) {
    float s = 0.0f;
    for (int w = 0; w < kWarps; ++w) s += red[w * K + threadIdx.x];
    out[threadIdx.x] = s;
  }
  __syncthreads();
}

// Sums of K values per thread over a pair's THREADS virtual threads, in
// block_reduce's fixed order for a THREADS-wide block: each warp's shuffle
// tree, then the THREADS / 32 warps' partials in warp order. The pair runs
// on G blocks of THREADS / G threads (block r holding virtual threads
// r THREADS / G + tid); when G > 1 they form a thread-block cluster and the
// partials of the other blocks' warps are read through distributed shared
// memory, so every block gets the same totals. The cluster barrier comes
// before the reads only: callers alternate two ``red`` buffers, so a buffer
// is written again only after the next cluster barrier, which every reader
// of its last sum has passed. red holds (THREADS / G / 32) * K floats.
template <int K, int THREADS, int G>
__device__ void pair_reduce(float (&v)[K], float* red, float* out) {
  if constexpr (G == 1) {
    block_reduce<K, THREADS>(v, red, out);
  } else {
    constexpr int kWarps = THREADS / 32, kLocalWarps = THREADS / G / 32;
    cooperative_groups::cluster_group cluster =
        cooperative_groups::this_cluster();
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
#pragma unroll
    for (int k = 0; k < K; ++k) v[k] = group_sum(v[k], 32);
    if (lane == 0) {
#pragma unroll
      for (int k = 0; k < K; ++k) red[warp * K + k] = v[k];
    }
    cluster.sync();
    if (threadIdx.x < K) {
      float s = 0.0f;
#pragma unroll
      for (int w = 0; w < kWarps; ++w) {
        const float* rw = cluster.map_shared_rank(red, w / kLocalWarps);
        s += rw[(w % kLocalWarps) * K + threadIdx.x];
      }
      out[threadIdx.x] = s;
    }
    __syncthreads();
  }
}

// The rank of this block in its cluster of G blocks (0 when G == 1).
template <int G>
__device__ __forceinline__ int cluster_rank() {
  if constexpr (G == 1) return 0;
  else return (int)cooperative_groups::this_cluster().block_rank();
}

// A barrier of the pair: the block's when G == 1, else the cluster's.
template <int G>
__device__ __forceinline__ void pair_sync() {
  if constexpr (G == 1) __syncthreads();
  else cooperative_groups::this_cluster().sync();
}

// Element i of a shared array as held by block ``owner`` of the pair's
// cluster (this block's own when G == 1).
template <int G, typename T>
__device__ __forceinline__ T owner_read(T* a, int owner, int i) {
  if constexpr (G == 1) return a[i];
  else return cooperative_groups::this_cluster().map_shared_rank(a, owner)[i];
}

// Lanes that share one item (a column or a row): the largest power of two
// <= 32 that still gives every item its own group of a THREADS-wide block.
template <int THREADS>
__device__ __forceinline__ int pick_split(int items) {
  int s = 1;
  while (s < 32 && 2 * s * items <= THREADS) s *= 2;
  return s;
}

// Eigenvectors of a symmetric 4 x 4 by cyclic Jacobi; returns in q the unit
// eigenvector of the largest eigenvalue. Converges for every symmetric
// matrix and returns a unit vector even when the top eigenvalues tie.
// The loops over indices are unrolled, so a and v stay in registers (the
// arithmetic and its order are those of the rolled loops).
__device__ void dominant_eigvec4(double a[4][4], double q[4]) {
  double v[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) v[i][j] = (i == j) ? 1.0 : 0.0;
  for (int sweep = 0; sweep < 16; ++sweep) {
    double off = 0.0, diag = 0.0;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      diag += a[i][i] * a[i][i];
#pragma unroll
      for (int j = i + 1; j < 4; ++j) off += a[i][j] * a[i][j];
    }
    if (off <= 1e-32 * diag) break;
#pragma unroll
    for (int p = 0; p < 3; ++p) {
#pragma unroll
      for (int r = p + 1; r < 4; ++r) {
        const double apr = a[p][r];
        if (apr == 0.0) continue;
        const double theta = (a[r][r] - a[p][p]) / (2.0 * apr);
        const double tt = (theta >= 0.0 ? 1.0 : -1.0) /
                          (fabs(theta) + sqrt(theta * theta + 1.0));
        const double c = 1.0 / sqrt(tt * tt + 1.0), s = tt * c;
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          const double akp = a[k][p], akr = a[k][r];
          a[k][p] = c * akp - s * akr;
          a[k][r] = s * akp + c * akr;
        }
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          const double apk = a[p][k], ark = a[r][k];
          a[p][k] = c * apk - s * ark;
          a[r][k] = s * apk + c * ark;
        }
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          const double vkp = v[k][p], vkr = v[k][r];
          v[k][p] = c * vkp - s * vkr;
          v[k][r] = s * vkp + c * vkr;
        }
      }
    }
  }
  // The first largest diagonal entry and its column, by selects.
  int best = 0;
  double top = a[0][0];
#pragma unroll
  for (int i = 1; i < 4; ++i)
    if (a[i][i] > top) { top = a[i][i]; best = i; }
  double col[4];
#pragma unroll
  for (int k = 0; k < 4; ++k)
    col[k] = best == 0 ? v[k][0] : best == 1 ? v[k][1]
             : best == 2 ? v[k][2] : v[k][3];
  double nrm = 0.0;
#pragma unroll
  for (int k = 0; k < 4; ++k) nrm += col[k] * col[k];
  nrm = sqrt(nrm > 1e-300 ? nrm : 1e-300);
#pragma unroll
  for (int k = 0; k < 4; ++k) q[k] = col[k] / nrm;
}

// Horn's quaternion method: the proper rotation maximizing tr(a^T R) for a
// (target x source) cross-covariance a, i.e. S = a^T (source x target).
__device__ void horn_rotation(double a[3][3], double rot[3][3]) {
  const double sxx = a[0][0], sxy = a[1][0], sxz = a[2][0];
  const double syx = a[0][1], syy = a[1][1], syz = a[2][1];
  const double szx = a[0][2], szy = a[1][2], szz = a[2][2];
  double k4[4][4] = {
      {sxx + syy + szz, syz - szy, szx - sxz, sxy - syx},
      {syz - szy, sxx - syy - szz, sxy + syx, szx + sxz},
      {szx - sxz, sxy + syx, -sxx + syy - szz, syz + szy},
      {sxy - syx, szx + sxz, syz + szy, -sxx - syy + szz}};
  double q[4];
  dominant_eigvec4(k4, q);
  const double qw = q[0], qx = q[1], qy = q[2], qz = q[3];
  rot[0][0] = qw * qw + qx * qx - qy * qy - qz * qz;
  rot[0][1] = 2.0 * (qx * qy - qw * qz);
  rot[0][2] = 2.0 * (qx * qz + qw * qy);
  rot[1][0] = 2.0 * (qx * qy + qw * qz);
  rot[1][1] = qw * qw - qx * qx + qy * qy - qz * qz;
  rot[1][2] = 2.0 * (qy * qz - qw * qx);
  rot[2][0] = 2.0 * (qx * qz - qw * qy);
  rot[2][1] = 2.0 * (qy * qz + qw * qx);
  rot[2][2] = qw * qw - qx * qx - qy * qy + qz * qz;
}

// Solves the 6 x 6 system a x = b in place by elimination with partial
// pivoting; a zero pivot leaves that component 0.
__device__ void solve6(double a[6][6], double b[6], double x[6]) {
  for (int k = 0; k < 6; ++k) {
    int p = k;
    for (int i = k + 1; i < 6; ++i)
      if (fabs(a[i][k]) > fabs(a[p][k])) p = i;
    if (p != k) {
      for (int j = 0; j < 6; ++j) {
        const double tmp = a[k][j]; a[k][j] = a[p][j]; a[p][j] = tmp;
      }
      const double tb = b[k]; b[k] = b[p]; b[p] = tb;
    }
    if (a[k][k] == 0.0) continue;
    for (int i = k + 1; i < 6; ++i) {
      const double f = a[i][k] / a[k][k];
      for (int j = k; j < 6; ++j) a[i][j] -= f * a[k][j];
      b[i] -= f * b[k];
    }
  }
  for (int k = 5; k >= 0; --k) {
    double s = b[k];
    for (int j = k + 1; j < 6; ++j) s -= a[k][j] * x[j];
    x[k] = a[k][k] == 0.0 ? 0.0 : s / a[k][k];
  }
}

// Launches ``kernel`` for a batch of pairs, each on g blocks of threads / g
// threads: a thread-block cluster of g blocks when g > 1, one block when
// g == 1. smem bytes of dynamic shared memory a block. Returns the launch's
// error, or the last error after it.
template <typename... Params, typename... Args>
cudaError_t launch_pairs(void (*kernel)(Params...), int batch, int g,
                         int threads, int smem, cudaStream_t stream,
                         Args... args) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(batch * g);
  cfg.blockDim = dim3(threads / g);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = g;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = g > 1 ? 1 : 0;
  err = cudaLaunchKernelEx(&cfg, kernel, args...);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

}  // namespace
