// Tile-culled exact Gauss transform for Hopper (sm_90a), bound with ctypes.
//
// Replaces probreg_tpu/ops/estep_pallas.py:_gt_kernel (behind
// gauss_transform_culled):
//
//   out[i, c] = sum_j exp(-|q_i - p_j|^2 * inv_h2) * w[j, c]
//
// for 1 <= C <= 8 channels and D in {2, 3, 4, 8} (the wrapper pads
// 5 <= D <= 7 to 8 with zeros, which change no distance). FilterReg's
// E-step moments are this shape: queries are the transformed source, points
// the target, channels [1, x] or [1, x, |x|^2] or [1, x, |x|^2, normals].
//
// There is no normalizer, so one pass suffices and no row's sum crosses
// blocks. The culling unit stays the 256-row query tile: a tile's
// compacted list of active point tiles is walked by the two blocks that
// share the tile, each owning 128 of its rows. A block stages the points
// and weights of kSlots stages (256 points each, in the tile list's order)
// at a time in shared memory; slot t's threads sum stage k0 + t for the
// block's rows, kRowsPerThread rows a thread (rows tid, tid + T, ...), so
// every staged point is read once for all of a thread's rows. Slot 0 then
// adds the stages' sums to the rows' totals in stage order. No float
// atomics: the result is bitwise the same from run to run.
//
// Bits: each row's sums follow one fixed association, whatever the rows
// a thread, the slots or the padding: d2 = fmaf(dx, dx, 0), then dy, dz (a
// zero-padded coordinate adds fmaf(0, 0, d2) = d2 exactly), g = expf(-d2 *
// inv_h2), each stage's partial with FMAs in j order, then the partials
// into the total in stage order (stages start at each active tile and at
// every 256 points of it). A padded channel only adds a column.
//
// Bound: operations. Per pair the kernel does the Gaussian (D differences
// and FMAs, a scale, expf: ~8 instructions, one MUFU.EX2) and C FMAs; the
// shared-memory loads of a point and its weights (broadcasts, vectorised)
// are shared by a thread's rows. Its device-memory traffic is reading the
// clouds once per active tile pair from L2 and writing N x C floats.
// 128-row blocks put ~9 blocks on each of the 132 SMs at 150k rows, all
// resident at once, so the SMs are loaded within one block of each other;
// the slots keep the warps per SM near the one-row-a-thread kernel's while
// each thread carries several rows.
//
// d2 is taken from differences of clouds centred on their shared centroid
// (the wrapper centres), IEEE f32, expf, no fast-math.

#include <cuda_runtime.h>

namespace {

constexpr int kTile = 256;         // query rows per culling tile (_ROWS)
constexpr int kBlockRows = 128;    // query rows per block (BLOCK_ROWS)
constexpr int kRowsPerThread = 2;  // ROWS_PER_THREAD
constexpr int kSlots = 2;          // stages a block sums at once (SLOTS)
constexpr int kRowThreads = kBlockRows / kRowsPerThread;
constexpr int kThreads = kRowThreads * kSlots;
constexpr int kStage = 256;        // points of one stage
static_assert(kTile % kBlockRows == 0, "a block lies inside one tile");

// Floats staged per point and per weight row: D = 3 and C = 3 rounded up
// to 4, 5 <= C <= 7 to 8, so each is one vector load.
__host__ __device__ constexpr int staged(int k) {
  return k == 3 ? 4 : (k > 4 ? 8 : k);
}

// v[0..N) from shared memory at s (aligned to N floats), as vector loads.
template <int N>
__device__ __forceinline__ void lds(const float* s, float (&v)[N]) {
  if constexpr (N % 4 == 0) {
#pragma unroll
    for (int k = 0; k < N / 4; ++k) {
      const float4 t = reinterpret_cast<const float4*>(s)[k];
      v[4 * k] = t.x; v[4 * k + 1] = t.y;
      v[4 * k + 2] = t.z; v[4 * k + 3] = t.w;
    }
  } else if constexpr (N == 2) {
    const float2 t = *reinterpret_cast<const float2*>(s);
    v[0] = t.x; v[1] = t.y;
  } else {
    v[0] = s[0];
  }
}

// Copies n rows of width K (row-major, contiguous) into rows of width KS.
template <int K, int KS>
__device__ __forceinline__ void stage(const float* __restrict__ g, int n,
                                      float* s) {
  for (int e = threadIdx.x; e < n * K; e += kThreads) {
    const int i = e / K;
    s[i * KS + (e - i * K)] = g[e];
  }
}

template <int D, int C>
__global__ void __launch_bounds__(kThreads)
gt_kernel(const float* __restrict__ qs, int nq,     // (nq, D)
          const float* __restrict__ ps,             // (m, D)
          const float* __restrict__ w, int m,       // (m, C)
          const int* __restrict__ act_idx,          // (n_q_tiles, n_p_tiles)
          const int* __restrict__ act_cnt,          // (n_q_tiles,)
          int tile, int n_p_tiles, float inv_h2,
          float* __restrict__ out) {                // (nq, C)
  constexpr int R = kRowsPerThread, S = kSlots, T = kRowThreads;
  constexpr int DS = staged(D), CS = staged(C);
  __shared__ __align__(16) float sp[S][kStage * DS];
  __shared__ __align__(16) float sw[S][kStage * CS];
  __shared__ float later[S > 1 ? S - 1 : 1][R][C][T];  // slots 1.. sums

  const int qt = blockIdx.x / (kTile / kBlockRows), tid = threadIdx.x;
  const int slot = tid / T, lt = tid - slot * T;
  const int row0 = blockIdx.x * kBlockRows + lt;
  float q[R][D];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int row = row0 + r * T;
#pragma unroll
    for (int d = 0; d < D; ++d)
      q[r][d] = row < nq ? qs[(size_t)row * D + d] : 0.0f;
  }
  float acc[R][C];
#pragma unroll
  for (int r = 0; r < R; ++r)
#pragma unroll
    for (int c = 0; c < C; ++c) acc[r][c] = 0.0f;

  // The tile's stages in order: each active point tile from its start,
  // 256 points at a time (empty past the end of a short last tile).
  const int cnt = act_cnt[qt];
  const int* list = act_idx + (size_t)qt * n_p_tiles;
  const int per_tile = (tile + kStage - 1) / kStage;
  const int n_stages = cnt * per_tile;
  for (int k0 = 0; k0 < n_stages; k0 += S) {
    int ns[S];
    __syncthreads();  // the previous stages and sums are consumed
#pragma unroll
    for (int t = 0; t < S; ++t) {
      const int k = k0 + t;
      int s0 = 0;
      ns[t] = 0;
      if (k < n_stages) {
        const int a = k / per_tile;
        const int p0 = list[a] * tile;
        s0 = p0 + (k - a * per_tile) * kStage;
        ns[t] = max(0, min(kStage, min(p0 + tile, m) - s0));
      }
      stage<D, DS>(ps + (size_t)s0 * D, ns[t], sp[t]);
      stage<C, CS>(w + (size_t)s0 * C, ns[t], sw[t]);
    }
    __syncthreads();
    // Each slot sums one stage (j ascending) for its rows; slot 0 then adds
    // the stages to the rows' totals in order: a row adds up to 150k
    // terms, and one running f32 sum loses ~sqrt(N) eps of it.
    float part[R][C];
#pragma unroll
    for (int r = 0; r < R; ++r)
#pragma unroll
      for (int c = 0; c < C; ++c) part[r][c] = 0.0f;
    const float* pj = sp[slot];
    const float* wjp = sw[slot];
    int mine = ns[0];
#pragma unroll
    for (int t = 1; t < S; ++t) mine = slot == t ? ns[t] : mine;
#pragma unroll 8
    for (int j = 0; j < mine; ++j, pj += DS, wjp += CS) {
      float p[DS], wj[CS];
      lds<DS>(pj, p);
      lds<CS>(wjp, wj);
#pragma unroll
      for (int r = 0; r < R; ++r) {
        float d2 = 0.0f;
#pragma unroll
        for (int d = 0; d < D; ++d) {
          const float dd = q[r][d] - p[d];
          d2 = fmaf(dd, dd, d2);
        }
        const float g = expf(-d2 * inv_h2);
#pragma unroll
        for (int c = 0; c < C; ++c)
          part[r][c] = fmaf(g, wj[c], part[r][c]);
      }
    }
    if constexpr (S > 1) {
      if (slot > 0) {
#pragma unroll
        for (int r = 0; r < R; ++r)
#pragma unroll
          for (int c = 0; c < C; ++c) later[slot - 1][r][c][lt] = part[r][c];
      }
      __syncthreads();
    }
    if (slot == 0) {
      if (ns[0] > 0) {
#pragma unroll
        for (int r = 0; r < R; ++r)
#pragma unroll
          for (int c = 0; c < C; ++c) acc[r][c] += part[r][c];
      }
#pragma unroll
      for (int t = 1; t < S; ++t) {
        if (ns[t] > 0) {
#pragma unroll
          for (int r = 0; r < R; ++r)
#pragma unroll
            for (int c = 0; c < C; ++c) acc[r][c] += later[t - 1][r][c][lt];
        }
      }
    }
  }
  if (slot == 0) {
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const int row = row0 + r * T;
      if (row < nq) {
#pragma unroll
        for (int c = 0; c < C; ++c) out[(size_t)row * C + c] = acc[r][c];
      }
    }
  }
}

struct Args {
  const float *qs, *ps, *w;
  int nq, m;
  const int *act_idx, *act_cnt;
  int tile;
  float inv_h2;
  float* out;
  cudaStream_t stream;
};

template <int D, int C>
cudaError_t launch(const Args& a) {
  const int blocks = (a.nq + kBlockRows - 1) / kBlockRows;
  const int n_p_tiles = (a.m + a.tile - 1) / a.tile;
  gt_kernel<D, C><<<blocks, kThreads, 0, a.stream>>>(
      a.qs, a.nq, a.ps, a.w, a.m, a.act_idx, a.act_cnt, a.tile, n_p_tiles,
      a.inv_h2, a.out);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_c(const Args& a, int c) {
  switch (c) {
    case 1: return launch<D, 1>(a);
    case 2: return launch<D, 2>(a);
    case 3: return launch<D, 3>(a);
    case 4: return launch<D, 4>(a);
    case 5: return launch<D, 5>(a);
    case 6: return launch<D, 6>(a);
    case 7: return launch<D, 7>(a);
    case 8: return launch<D, 8>(a);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// qs (nq, d), ps (m, d), w (m, c) f32 row-major with d in {2, 3, 4, 8} and
// 1 <= c <= 8; act_idx (ceil(nq / 256), ceil(m / tile)) int32, row i
// listing query tile i's active point tiles first; act_cnt their counts;
// out (nq, c).
int probreg_gauss_transform(const void* qs, int nq, const void* ps,
                            const void* w, int m, int d, int c,
                            const void* act_idx, const void* act_cnt,
                            int tile, float inv_h2, void* out, void* stream) {
  if (nq <= 0 || m <= 0 || tile <= 0) return (int)cudaErrorInvalidValue;
  const Args a{(const float*)qs, (const float*)ps, (const float*)w, nq, m,
               (const int*)act_idx, (const int*)act_cnt, tile, inv_h2,
               (float*)out, (cudaStream_t)stream};
  switch (d) {
    case 2: return (int)launch_c<2>(a, c);
    case 3: return (int)launch_c<3>(a, c);
    case 4: return (int)launch_c<4>(a, c);
    case 8: return (int)launch_c<8>(a, c);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // extern "C"
