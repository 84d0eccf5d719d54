// Device helpers of the start-temperature fast branch, shared by K3's fast
// passes (estep.cu) and K6's fast kernel (gt.cu): the cross term of a
// 16 x 8 tile on the tensor cores from bf16 operands, the Gaussian of a
// pair from it with every rounding spelled out, so each kernel's passes form
// the same bits, and K3's pass-B product of 16 Gaussians with 16 targets'
// moment operands.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

// A bf16 pair, each rounded to nearest, packed as one operand register: lo
// in the low half (the lower k).
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// d (16 x 8, f32) = a (16 x 8, bf16, rows) * b (8 x 8, bf16, columns) + c:
// mma.sync m16n8k8. Lane 4 gid + tig holds A rows gid and gid + 8 at k 2 tig
// and 2 tig + 1 (a0, a1), B column gid at the same k (b0), and C and D at
// rows gid and gid + 8, columns 2 tig and 2 tig + 1 (c.x, c.y, c.z, c.w;
// d[0..1], d[2..3]). The callers keep c whole (a float4 in registers or
// one shared-memory load), so it needs no register moves.
__device__ __forceinline__ void mma_bf16(float (&d)[4], uint32_t a0,
                                         uint32_t a1, uint32_t b0, float4 c) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5}, {%6}, {%7, %8, %9, %10};\n"
      : "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3])
      : "r"(a0), "r"(a1), "r"(b0), "f"(c.x), "f"(c.y), "f"(c.z), "f"(c.w));
}

// d (16 x 8, f32) += a (16 x 16, bf16, rows) * b (16 x 8, bf16, columns):
// mma.sync m16n8k16. Lane 4 gid + tig holds A rows gid (a0) and gid + 8
// (a1) at k 2 tig and 2 tig + 1, the same rows at k 2 tig + 8 and 2 tig + 9
// (a2, a3), B column gid at k 2 tig, 2 tig + 1 (b0) and 2 tig + 8, 2 tig + 9
// (b1); d as in mma_bf16. So the C fragments of two m16n8 tiles side by
// side, packed pairwise to bf16, are this A fragment as they stand (k 0-7
// the first tile's columns, 8-15 the second's).
__device__ __forceinline__ void mma_bf16_k16(float (&d)[4], uint32_t a0,
                                             uint32_t a1, uint32_t a2,
                                             uint32_t a3, uint32_t b0,
                                             uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

// The Gaussian's scale: k = -inv log2(e) in f32, formed once per launch
// from inv = 1 / (2 sigma2) or 1 / h^2. Held at or below -FLT_MIN so that a
// padded row (|y|^2 = +inf) still gives exactly 0 where inv is 0 (every
// other pair's exp2 is then 1 either way).
__device__ __forceinline__ float fast_scale(float inv) {
  return fminf(__fmul_rn(-inv, 1.44269504088896341f), -1.17549435e-38f);
}

// The pre-scaled operands of fast_gauss: a column's tensor-core addend
// -|x|^2 / 2 (exact; in mma_bf16's c at both rows), and a row's |y|^2 k.
__device__ __forceinline__ float fast_col(float x2) {
  return __fmul_rn(-0.5f, x2);
}
__device__ __forceinline__ float fast_row(float y2, float k) {
  return __fmul_rn(y2, k);
}

// exp(-max(|y|^2 + |x|^2 - 2 y.x, 0) inv) as exp2f(max(d2, 0) k), d2 k =
// (-2 k) dc + |y|^2 k: dc = y.x - |x|^2 / 2 from the tensor cores (bf16
// coordinates, f32 accumulator, fast_col as the addend), y2k = fast_row,
// k = fast_scale(inv). The clamp at d2 >= 0 is min(., 0) since k < 0: one
// FMA and one min a pair before the exp. Built without fast-math, exp2f is
// the MUFU's ex2 with subnormal results kept (within 2 ulp): a Gaussian
// that expf gives as a subnormal stays non-zero, so the culling bound and
// the eps route of a zero normalizer mean what they do in the exact
// kernels. A padded row (|y|^2 = +inf, y2k = -inf) gives exactly 0.
__device__ __forceinline__ float fast_gauss(float dc, float y2k, float k) {
  return exp2f(fminf(__fmaf_rn(-2.0f * k, dc, y2k), 0.0f));
}

}  // namespace
