// Device helpers of the start-temperature fast branch, shared by K3's fast
// passes (estep.cu) and K6's fast kernel (gt.cu): the cross term of a
// 16 x 8 tile on the tensor cores from bf16 operands, and the Gaussian of a
// pair from it with every rounding spelled out, so each kernel's passes form
// the same bits.
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

// d (16 x 8, f32) = a (16 x 8, bf16, rows) * b (8 x 8, bf16, columns):
// mma.sync m16n8k8. Lane 4 gid + tig holds A rows gid and gid + 8 at k 2 tig
// and 2 tig + 1 (a0, a1), B column gid at the same k (b0), and gets rows gid
// and gid + 8 at columns 2 tig and 2 tig + 1 (d[0..1], d[2..3]).
__device__ __forceinline__ void mma_bf16(float (&d)[4], uint32_t a0,
                                         uint32_t a1, uint32_t b0) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5}, {%6}, {%7, %8, %9, %10};\n"
      : "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3])
      : "r"(a0), "r"(a1), "r"(b0), "f"(0.0f), "f"(0.0f), "f"(0.0f),
        "f"(0.0f));
}

// exp(-max(|y|^2 + |x|^2 - 2 xy, 0) * inv) from the tensor-core cross term
// xy and the f32 squared norms of the unrounded points.
__device__ __forceinline__ float fast_gauss(float xy, float y2, float x2,
                                            float inv) {
  const float d2 = fmaxf(__fmaf_rn(-2.0f, xy, __fadd_rn(y2, x2)), 0.0f);
  return expf(__fmul_rn(-d2, inv));
}

}  // namespace
