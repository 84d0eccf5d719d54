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
//
// The fast branch (gt_fast_kernel, below) is the DEFAULT-precision
// instantiation of _gt_kernel that the reference's gauss_transform_culled
// runs under its start-temperature bound. Both kernels take a device flag
// and return at once unless it picks their branch, so the wrapper launches
// both and no call reads the flag on the host.

#include <cuda_runtime.h>

#include <type_traits>

#include "bf16_mma.cuh"

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

// Copies n rows of width K (row-major, contiguous) into rows of width KS,
// kBy threads at a time.
template <int K, int KS, int kBy = kThreads>
__device__ __forceinline__ void stage(const float* __restrict__ g, int n,
                                      float* s) {
  for (int e = threadIdx.x; e < n * K; e += kBy) {
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
          const int* __restrict__ skip,             // null, or the fast flag
          float* __restrict__ out) {                // (nq, C)
  if (skip != nullptr && *skip != 0) return;  // the fast branch runs
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

// ---------------------------------------------------------------------------
// K6's fast branch: replaces _gt_kernel at Precision.DEFAULT (one bf16 pass
// of the TPU's matrix unit for q.p; the weights' product stays HIGHEST),
// which the reference's gauss_transform_culled takes where its bound allows
// (estep_cuda.fast_gate on the centred clouds and 1/h^2).
//
// The Gaussian: q.p is one mma.sync.m16n8k8 (bf16 operands rounded to
// nearest, f32 accumulator) per 16 query rows x 8 points, the coordinates
// zero-padded to k = 8 (D <= 8), with -|p|^2 / 2 as the addend; d2 takes the
// expanded form of _gt_kernel's _dist_tile, max(|q|^2 + |p|^2 - 2 q.p, 0),
// with |q|^2 and |p|^2 in f32 from the unrounded centred points (the
// wrapper's q2 and p2), by bf16_mma.cuh's fast_gauss (|q|^2 k a row's, k =
// -inv_h2 log2(e), exp2f), as K3's fast passes form it.
//
// The weights' sums on the tensor cores: the C fragments of a lane's two
// m16n8k8 cross terms side by side are the A fragment of m16n8k16 (rows gid
// and gid + 8, points 2 tig, 2 tig + 1, 2 tig + 8, 2 tig + 9 of a 16-point
// group), so the lane's 8 Gaussians are the A operand with no shuffle. The
// reference's product is f32, so g goes in as two bf16 pieces, hi = bf16(g)
// and lo = bf16(g - hi) (the difference exact in f32), and each weight as
// three, hi = bf16(w), mid = bf16(w - hi), lo = bf16(w - hi - mid) (the
// split of estep_cuda.moment_pieces, gt_cuda.weight_pieces), formed while
// the block stages a stage's weights: a product of two pieces is exact in
// the f32 accumulator. Per 4 channels two B fragments in moment_operand's
// layout, one with channel c's hi and mid at columns 2c and 2c + 1, one with
// its lo at 2c; A_hi runs against both and A_lo against the first, so the
// sum drops only g_lo w_lo (< 2^-26 of g w) and the pieces' remainders
// (~2^-17 of g w together). Lane tig holds channel tig of each 4 for rows
// gid and gid + 8: a stage's channel total is hi + (mid + lo), added into
// the row's total once per stage in stage order (the exact kernel's stages:
// each active tile from its start, 256 points at a time), and no lane
// shares a channel, so no butterfly.
//
// Layout: a block of kWarps warps x kGroups 16-row groups holds 16 kWarps
// kGroups rows of a 256-row culling tile and walks the tile's active point
// tiles a stage at a time. A thread stages a point: its bf16 coordinates in
// the m16n8k8 B order (one 32-bit shared load a lane), -|p|^2 / 2 as the
// addend (one float4), and its weights split once into their slots of the
// B fragments (one uint4 a lane per 4 channels); every staged fragment
// serves all of a warp's row groups. Points past a stage's end are staged
// as zero points with zero weight pieces: their Gaussian is finite, so they
// add nothing. Rows past nq are zero points never written. Where no
// argument of a stage can reach -126 (a bound from the block's largest
// |q|^2 and the stage's largest |p|^2; at the start temperature, every
// stage), the stage's exps skip exp2f's subnormal scaling: the same bits.
// Every shape gives the same bits; on an H100, 4 warps x 2 groups with 8
// blocks an SM was the fastest at 150k rows and within 4 % of the fastest
// at 131,072 (chip_smoke.py --gt-fast-shapes).
//
// Bound: the MUFU, one ex2 a pair (16 a clock an SM). A pair's other work
// issues ~6.3 instructions (the FMA and the min of the Gaussian, the split:
// two packs, an unpack, a subtraction, and a share of the mma issue and the
// fragment loads); the tensor cores take 2 D + 10 C bf16 operations a pair.
//
// kDump (tests only): every g the kernel forms, before its split, also goes
// to g_dump (nq, m).
// ---------------------------------------------------------------------------
constexpr int kFastWarps = 4;    // warps a block
constexpr int kFastGroups = 2;   // 16-row groups a warp holds
// Blocks an SM that the registers must allow (__launch_bounds__), for one
// quad of channels: 8 (64 registers; ptxas spills 16 bytes, in the
// staging) fill one wave at 131,072 rows (1,024 blocks, 1,056 resident).
// Two quads keep their registers (no bound: 8 would spill 312 bytes).
constexpr int kFastBlocks = 8;

// A weight's three bf16 pieces: hi = bf16(w), mid = bf16(w - hi), lo =
// bf16(w - hi - mid), each rounded to nearest even and each difference
// exact in f32 (gt_cuda.weight_pieces on tensors).
__device__ __forceinline__ void weight_split(float w,
                                             __nv_bfloat16 (&v)[3]) {
  v[0] = __float2bfloat16_rn(w);
  const float rest = __fsub_rn(w, __bfloat162float(v[0]));
  v[1] = __float2bfloat16_rn(rest);
  v[2] = __float2bfloat16_rn(__fsub_rn(rest, __bfloat162float(v[1])));
}

// The lo pieces of a packed pair of Gaussians: hi (pack_bf16(g0, g1)) back
// to f32 exactly, g - hi exact in f32, packed to bf16 to nearest.
__device__ __forceinline__ uint32_t split_lo(uint32_t hi, float g0,
                                             float g1) {
  return pack_bf16(__fsub_rn(g0, __uint_as_float(hi << 16)),
                   __fsub_rn(g1, __uint_as_float(hi & 0xffff0000u)));
}

// fast_gauss(dc, y2k, k) with its bits, from k2 = -2 k. exp2f(x) is the
// MUFU's ex2 of x for x >= -126 and, below, scales x and the result around
// it (the result is subnormal): a compare and two predicated multiplies a
// pair. kScaled = false leaves them out (ex2.approx.ftz, the MUFU's ex2 as
// it stands) and is taken only where every argument is >= -126, so both
// give the same bits.
template <bool kScaled>
__device__ __forceinline__ float gauss_of(float dc, float y2k, float k2) {
  const float t = fminf(__fmaf_rn(k2, dc, y2k), 0.0f);  // k2 = -2 k
  if constexpr (kScaled) {
    return exp2f(t);
  } else {
    float y;
    asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(t));
    return y;
  }
}

// A bound on |exp2 argument| / |k| of every pair of rows with |q|^2 <= q2
// and points with |p|^2 <= p2: |q|^2 + |p|^2 - 2 q.p <= (|q| + |p|)^2, the
// bf16 cross term off by < 1 % of 2 |q| |p| (the gate's bound is far
// tighter), f32 roundings below that; kept under 120 < 126 with the margin.
__device__ __forceinline__ bool unscaled_ok(float q2, float p2, float k) {
  const float r = sqrtf(q2) + sqrtf(p2);
  return -k * r * r * 1.02f <= 120.0f;
}

template <int kQuads, bool kDump, int kWarps = kFastWarps,
          int kGroups = kFastGroups, int kBlocks = kQuads == 1 ? kFastBlocks
                                                                : 1>
__global__ void __launch_bounds__(32 * kWarps, kBlocks)
gt_fast_kernel(const float* __restrict__ qs,               // (nq, d)
               const float* __restrict__ q2, int nq,       // (nq)
               const float* __restrict__ ps,               // (m, d)
               const float* __restrict__ p2,               // (m)
               const float* __restrict__ w, int m, int d,  // (m, c)
               int c,
               const int* __restrict__ act_idx,
               const int* __restrict__ act_cnt,
               int tile, int n_p_tiles, float inv_h2,
               const int* __restrict__ run,                // the fast flag
               float* __restrict__ out,                    // (nq, c)
               float* __restrict__ g_dump) {               // kDump: (nq, m)
  if (*run == 0) return;  // the exact branch runs
  constexpr int kThreads = 32 * kWarps;
  constexpr int kRows = 16 * kWarps * kGroups;
  static_assert(kTile % kRows == 0, "a block lies inside one tile");
  // The points' bf16 coordinate pairs, [point][k pair]: lane 4 gid + tig of
  // 8-point group t reads its B fragment at 32 t + lane.
  __shared__ __align__(16) uint32_t sb[kStage * 4];
  // Their -|p|^2 / 2 as mma_bf16's addend: [8-point group][tig].
  __shared__ float4 spc[kStage / 8][4];
  // The weights' pieces as m16n8k16 B fragments: [16-point group][quad]
  // [lane] = (first b0, first b1, second b0, second b1).
  __shared__ uint4 sw[kStage / 16 * kQuads * 32];
  // The largest |q|^2 of the block's rows, and of |p|^2 of each stage's
  // points by stage parity (f32 bits: non-negative floats order as ints).
  __shared__ unsigned int q2max, p2max[2];
  const int qt = blockIdx.x / (kTile / kRows);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int gid = lane >> 2, tig = lane & 3;
  const float k = fast_scale(inv_h2), k2 = -2.0f * k;
  // This lane's fragments in the staged arrays.
  const uint32_t* sbl = sb + lane;
  const float4* spl = &spc[0][tig];
  const uint4* swl = sw + lane;
  int row[kGroups][2];
  uint32_t a[kGroups][2];
  float y2k[kGroups][2];
  float acc[kGroups][kQuads][2][4];  // [group][quad][fragment]
  float tot[kGroups][kQuads][2];     // channel 4 quad + tig, rows gid, + 8
#pragma unroll
  for (int h = 0; h < kGroups; ++h)
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      row[h][r] = blockIdx.x * kRows + (warp * kGroups + h) * 16 + gid + 8 * r;
      float lo = 0.0f, hi = 0.0f;
      y2k[h][r] = 0.0f;
      if (row[h][r] < nq) {
        const float* q = qs + (size_t)row[h][r] * d;
        if (2 * tig < d) lo = q[2 * tig];
        if (2 * tig + 1 < d) hi = q[2 * tig + 1];
        y2k[h][r] = fast_row(q2[row[h][r]], k);
      }
      a[h][r] = pack_bf16(lo, hi);
#pragma unroll
      for (int q = 0; q < kQuads; ++q) tot[h][q][r] = 0.0f;
    }
  if (threadIdx.x == 0) q2max = p2max[0] = p2max[1] = 0u;
  __syncthreads();
  {
    float mine = 0.0f;
#pragma unroll
    for (int h = 0; h < kGroups; ++h)
#pragma unroll
      for (int r = 0; r < 2; ++r)
        if (row[h][r] < nq) mine = fmaxf(mine, q2[row[h][r]]);
    atomicMax(&q2max, __float_as_uint(mine));
  }

  const int cnt = act_cnt[qt];
  const int* list = act_idx + (size_t)qt * n_p_tiles;
  const int per_tile = (tile + kStage - 1) / kStage;
  const int n_stages = cnt * per_tile;
  for (int s = 0; s < n_stages; ++s) {
    const int at = s / per_tile;
    const int p0 = list[at] * tile;
    const int s0 = p0 + (s - at * per_tile) * kStage;
    const int ns = min(kStage, min(p0 + tile, m) - s0);
    if (ns <= 0) continue;  // past the end of a short last tile
    const int ng = (ns + 15) / 16;
    __syncthreads();  // the previous stage is consumed
    if (threadIdx.x == 0) p2max[(s + 1) & 1] = 0u;  // read two stages back
    // A thread a point: its bf16 coordinates, -|p|^2 / 2, and its weights'
    // pieces at their fragment slots. Point j is k slot 2 t + e + 8 half of
    // 16-point group j / 16; channel 4 quad + c4's hi and lo go to lane
    // 4 (2 c4) + t (first and second fragment), its mid and a zero to lane
    // 4 (2 c4 + 1) + t. Points past ns are zero points with zero pieces.
    float pmax = 0.0f;
    for (int j = threadIdx.x; j < 16 * ng; j += kThreads) {
      const bool live = j < ns;
      const float* pp = ps + (size_t)(s0 + j) * d;
      float v[8];
#pragma unroll
      for (int u = 0; u < 8; ++u) v[u] = live && u < d ? pp[u] : 0.0f;
      reinterpret_cast<uint4*>(sb)[j] =
          make_uint4(pack_bf16(v[0], v[1]), pack_bf16(v[2], v[3]),
                     pack_bf16(v[4], v[5]), pack_bf16(v[6], v[7]));
      const float pj = live ? p2[s0 + j] : 0.0f;
      pmax = fmaxf(pmax, pj);
      float* pc = &spc[j >> 3][(j >> 1) & 3].x + (j & 1);
      pc[0] = pc[2] = fast_col(pj);
      const int slot = 2 * ((j >> 3) & 1) + (j & 1);  // bf16 in b0, b1
      __nv_bfloat16* f = reinterpret_cast<__nv_bfloat16*>(
          sw + (j >> 4) * kQuads * 32 + ((j & 7) >> 1));
      const float* wp = w + (size_t)(s0 + j) * c;
#pragma unroll
      for (int ch = 0; ch < 4 * kQuads; ++ch) {
        __nv_bfloat16 pc3[3];
        weight_split(live && ch < c ? wp[ch] : 0.0f, pc3);
        __nv_bfloat16* even = f + 8 * (32 * (ch >> 2) + 8 * (ch & 3));
        __nv_bfloat16* odd = even + 8 * 4;
        even[slot] = pc3[0];
        even[4 + slot] = pc3[2];
        odd[slot] = pc3[1];
        odd[4 + slot] = __float2bfloat16_rn(0.0f);
      }
    }
    atomicMax(&p2max[s & 1], __float_as_uint(pmax));
    __syncthreads();
#pragma unroll
    for (int h = 0; h < kGroups; ++h)
#pragma unroll
      for (int q = 0; q < kQuads; ++q)
#pragma unroll
        for (int f = 0; f < 2; ++f)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[h][q][f][e] = 0.0f;
    // Block-uniform: the stage's Gaussians skip exp2f's subnormal scaling
    // where no argument can reach -126 (at the start temperature, always).
    const bool scaled = !unscaled_ok(__uint_as_float(q2max),
                                     __uint_as_float(p2max[s & 1]), k);
    auto sums = [&](auto scaled_t) {
      constexpr bool kScaled = decltype(scaled_t)::value;
#pragma unroll 2
      for (int g = 0; g < ng; ++g) {
        const uint32_t b0 = sbl[64 * g], b1 = sbl[64 * g + 32];
        const float4 xl = spl[8 * g], xh = spl[8 * g + 4];
        uint4 o[kQuads];
#pragma unroll
        for (int q = 0; q < kQuads; ++q) o[q] = swl[(g * kQuads + q) * 32];
#pragma unroll
        for (int h = 0; h < kGroups; ++h) {
          float d0[4], d1[4];
          mma_bf16(d0, a[h][0], a[h][1], b0, xl);
          mma_bf16(d1, a[h][0], a[h][1], b1, xh);
          // gv[4 t + 2 r + e]: point 8 t + 2 tig + e, row gid + 8 r.
          float gv[8];
#pragma unroll
          for (int r = 0; r < 2; ++r)
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              gv[2 * r + e] =
                  gauss_of<kScaled>(d0[2 * r + e], y2k[h][r], k2);
              gv[4 + 2 * r + e] =
                  gauss_of<kScaled>(d1[2 * r + e], y2k[h][r], k2);
            }
          uint32_t hi[4], lo[4];
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            hi[i] = pack_bf16(gv[2 * i], gv[2 * i + 1]);
            lo[i] = split_lo(hi[i], gv[2 * i], gv[2 * i + 1]);
          }
#pragma unroll
          for (int q = 0; q < kQuads; ++q) {
            mma_bf16_k16(acc[h][q][0], hi[0], hi[1], hi[2], hi[3], o[q].x,
                         o[q].y);
            mma_bf16_k16(acc[h][q][1], hi[0], hi[1], hi[2], hi[3], o[q].z,
                         o[q].w);
            mma_bf16_k16(acc[h][q][0], lo[0], lo[1], lo[2], lo[3], o[q].x,
                         o[q].y);
          }
          if (kDump) {
#pragma unroll
            for (int e = 0; e < 8; ++e) {
              const int j = 16 * g + 8 * (e >> 2) + 2 * tig + (e & 1);
              const int rr = row[h][(e >> 1) & 1];
              if (j < ns && rr < nq)
                g_dump[(size_t)rr * m + s0 + j] = gv[e];
            }
          }
        }
      }
    };
    if (scaled)
      sums(std::true_type{});
    else
      sums(std::false_type{});
    // Channel 4 quad + tig of each row: hi (column 2 tig of the first
    // product) + (mid (2 tig + 1) + lo (2 tig of the second)).
#pragma unroll
    for (int h = 0; h < kGroups; ++h)
#pragma unroll
      for (int q = 0; q < kQuads; ++q)
#pragma unroll
        for (int r = 0; r < 2; ++r)
          tot[h][q][r] = __fadd_rn(
              tot[h][q][r],
              __fadd_rn(acc[h][q][0][2 * r],
                        __fadd_rn(acc[h][q][0][2 * r + 1],
                                  acc[h][q][1][2 * r])));
  }
#pragma unroll
  for (int h = 0; h < kGroups; ++h)
#pragma unroll
    for (int q = 0; q < kQuads; ++q)
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int ch = 4 * q + tig;
        if (row[h][r] < nq && ch < c)
          out[(size_t)row[h][r] * c + ch] = tot[h][q][r];
      }
}

struct Args {
  const float *qs, *ps, *w;
  int nq, m;
  const int *act_idx, *act_cnt;
  int tile;
  float inv_h2;
  const int* gate;         // null, or the fast flag
  float* out;
  cudaStream_t stream;
  const float *q2, *p2;    // the fast kernel's squared norms
  int d;                   // the fast kernel's width
  int c;                   // the fast kernel's channels
  float* g_dump;           // the fast kernel's dump (tests only), or null
};

template <int D, int C>
cudaError_t launch(const Args& a) {
  const int blocks = (a.nq + kBlockRows - 1) / kBlockRows;
  const int n_p_tiles = (a.m + a.tile - 1) / a.tile;
  gt_kernel<D, C><<<blocks, kThreads, 0, a.stream>>>(
      a.qs, a.nq, a.ps, a.w, a.m, a.act_idx, a.act_cnt, a.tile, n_p_tiles,
      a.inv_h2, a.gate, a.out);
  return cudaGetLastError();
}

template <int kQuads, bool kDump, int kWarps = kFastWarps,
          int kGroups = kFastGroups, int kBlocks = kQuads == 1 ? kFastBlocks
                                                                : 1>
cudaError_t launch_fast(const Args& a) {
  constexpr int rows = 16 * kWarps * kGroups;
  const int blocks = (a.nq + kTile - 1) / kTile * (kTile / rows);
  const int n_p_tiles = (a.m + a.tile - 1) / a.tile;
  gt_fast_kernel<kQuads, kDump, kWarps, kGroups, kBlocks>
      <<<blocks, 32 * kWarps, 0, a.stream>>>(
          a.qs, a.q2, a.nq, a.ps, a.p2, a.w, a.m, a.d, a.c, a.act_idx,
          a.act_cnt, a.tile, n_p_tiles, a.inv_h2, a.gate, a.out, a.g_dump);
  return cudaGetLastError();
}

// The fast kernel for 1 <= c <= 4 (one quad of channels) or 5 <= c <= 8.
cudaError_t launch_fast_c(const Args& a) {
  if (a.c < 1 || a.c > 8) return cudaErrorInvalidValue;
  if (a.g_dump != nullptr)
    return a.c <= 4 ? launch_fast<1, true>(a) : launch_fast<2, true>(a);
  return a.c <= 4 ? launch_fast<1, false>(a) : launch_fast<2, false>(a);
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

Args fast_args(const void* qs, const void* q2, int nq, const void* ps,
               const void* p2, const void* w, int m, int d, int c,
               const void* act_idx, const void* act_cnt, int tile,
               float inv_h2, const void* gate, void* out, void* g_dump,
               void* stream) {
  return Args{(const float*)qs, (const float*)ps, (const float*)w, nq, m,
              (const int*)act_idx, (const int*)act_cnt, tile, inv_h2,
              (const int*)gate, (float*)out, (cudaStream_t)stream,
              (const float*)q2, (const float*)p2, d, c, (float*)g_dump};
}

bool fast_ok(int nq, int m, int d, int tile, const void* gate) {
  return nq > 0 && m > 0 && tile > 0 && d >= 1 && d <= 8 && gate != nullptr;
}

}  // namespace

extern "C" {

// qs (nq, d), ps (m, d), w (m, c) f32 row-major with d in {2, 3, 4, 8} and
// 1 <= c <= 8; act_idx (ceil(nq / 256), ceil(m / tile)) int32, row i
// listing query tile i's active point tiles first; act_cnt their counts;
// gate null, or the fast flag (the kernel returns at once where it is 1);
// out (nq, c).
int probreg_gauss_transform(const void* qs, int nq, const void* ps,
                            const void* w, int m, int d, int c,
                            const void* act_idx, const void* act_cnt,
                            int tile, float inv_h2, const void* gate,
                            void* out, void* stream) {
  if (nq <= 0 || m <= 0 || tile <= 0) return (int)cudaErrorInvalidValue;
  const Args a{(const float*)qs, (const float*)ps, (const float*)w, nq, m,
               (const int*)act_idx, (const int*)act_cnt, tile, inv_h2,
               (const int*)gate, (float*)out, (cudaStream_t)stream,
               nullptr, nullptr, d, c, nullptr};
  switch (d) {
    case 2: return (int)launch_c<2>(a, c);
    case 3: return (int)launch_c<3>(a, c);
    case 4: return (int)launch_c<4>(a, c);
    case 8: return (int)launch_c<8>(a, c);
    default: return (int)cudaErrorInvalidValue;
  }
}

// The fast branch: as probreg_gauss_transform, with q2 (nq) and p2 (m) the
// squared norms of qs and ps, 1 <= d <= 8, and gate the fast flag (the
// kernel runs only where it is 1).
int probreg_gauss_transform_fast(const void* qs, const void* q2, int nq,
                                 const void* ps, const void* p2,
                                 const void* w, int m, int d, int c,
                                 const void* act_idx, const void* act_cnt,
                                 int tile, float inv_h2, const void* gate,
                                 void* out, void* stream) {
  if (!fast_ok(nq, m, d, tile, gate)) return (int)cudaErrorInvalidValue;
  return (int)launch_fast_c(fast_args(qs, q2, nq, ps, p2, w, m, d, c,
                                      act_idx, act_cnt, tile, inv_h2, gate,
                                      out, nullptr, stream));
}

// Tests only: probreg_gauss_transform_fast with every g the kernel forms,
// before its split, also written to g_dump (nq, m) f32.
int probreg_gauss_transform_fast_dump(const void* qs, const void* q2, int nq,
                                      const void* ps, const void* p2,
                                      const void* w, int m, int d, int c,
                                      const void* act_idx,
                                      const void* act_cnt, int tile,
                                      float inv_h2, const void* gate,
                                      void* out, void* g_dump, void* stream) {
  if (!fast_ok(nq, m, d, tile, gate) || g_dump == nullptr)
    return (int)cudaErrorInvalidValue;
  return (int)launch_fast_c(fast_args(qs, q2, nq, ps, p2, w, m, d, c,
                                      act_idx, act_cnt, tile, inv_h2, gate,
                                      out, g_dump, stream));
}

}  // extern "C"
