"""CPD expectation step: moments and the dispatcher.

Counterpart of probreg_tpu/ops/estep.py. The (M, N) posterior is never a
result, only its moments (reference cpd.py:71-88):

  den_j = sum_i exp(-|y_i - x_j|^2 / 2s2)      (complete per column)
  pt1_j = den_j / (den_j + c)
  p1_i  = sum_j exp(.) / (den_j + c)
  px_i  = sum_j exp(.) / (den_j + c) * x_j
  xx    = sum_j pt1_j |x_j|^2

The dispatcher picks a branch from sizes and flags alone; the device then
decides only whether a branch runs its CUDA kernel or its plain version
(ops/estep_cuda.py). So the CPU tests drive the same branches as the card.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional

import torch

from ..config import config
from .pairwise import mm_operand


class EstepMoments(NamedTuple):
    """Moment form of the CPD E-step result.

    pt1: (N,) target posterior mass; p1: (M,) source posterior mass;
    px: (M, D) weighted target sums; n_p: scalar total mass;
    xx: scalar sum_j pt1_j |x_j|^2.
    """

    pt1: torch.Tensor
    p1: torch.Tensor
    px: torch.Tensor
    n_p: torch.Tensor
    xx: torch.Tensor


def outlier_constant(sigma2, w: float, m: int, n: int, dim: int):
    """CPD uniform-distribution constant (reference cpd.py:78-79)."""
    c = (2.0 * math.pi * sigma2) ** (dim * 0.5)
    return c * w / (1.0 - w) * m / n


# Pad value for target blocks: |pad|^2 overwhelms any real exponent, so the
# Gaussian of a padded column underflows to exactly 0.
_PAD_BIG = 1e15


def _block_moments(t_source, x_blk, sigma2, c, eps):
    """Moments of one (M x B) block of the posterior.

    Same arithmetic as the reference: operands pre-scaled by
    1/sqrt(2 sigma2), the normalizer applied as a reciprocal multiply, p1
    from the px product through an appended ones column, the operands of
    both products in ``config.matmul_dtype`` (pairwise.mm_operand).
    """
    inv_s = torch.rsqrt(2.0 * sigma2)
    ys = t_source * inv_s
    xs = x_blk * inv_s
    y2 = (ys * ys).sum(-1)[:, None]
    x2 = (xs * xs).sum(-1)[None, :]
    yx = mm_operand(ys) @ mm_operand(xs).T
    g = torch.exp(torch.clamp(yx + yx - y2 - x2, max=0.0))
    den_raw = g.sum(0)
    inv_den = 1.0 / (torch.where(den_raw == 0.0, eps, den_raw) + c)
    pt1 = den_raw * inv_den
    pmat = g * inv_den[None, :]
    xb_ext = torch.cat([x_blk, torch.ones_like(x_blk[:, :1])], dim=1)
    pxp = mm_operand(pmat) @ mm_operand(xb_ext)
    x2r = (x_blk * x_blk).sum(1)
    # Pad filter on the squared norm (pad rows sit at |x|^2 ~ D * 1e30).
    xx = (pt1 * torch.where(x2r < 0.5 * _PAD_BIG ** 2, x2r, 0.0)).sum()
    return pt1, pxp[:, -1], pxp[:, :-1], xx


def estep_xla(t_source: torch.Tensor, target: torch.Tensor, sigma2,
              w: float = 0.0, block: Optional[int] = None) -> EstepMoments:
    """Streaming plain E-step over target blocks; peak memory O(M * block).

    Torch twin of the reference's ``estep_xla`` (the name is kept so the
    counterpart is easy to find). One pass suffices: every column of the
    posterior lives inside one target block.
    """
    m, dim = t_source.shape
    n = target.shape[0]
    sigma2 = torch.as_tensor(sigma2, dtype=t_source.dtype,
                             device=t_source.device)
    eps = torch.finfo(torch.float32).eps
    c = outlier_constant(sigma2, w, m, n, dim)
    if block is None:
        # Cap the live (M, block) Gaussian block at ~1 GB f32.
        mem_cap = max(128, ((1 << 28) // max(m, 1)) // 128 * 128)
        block = max(min(config.estep_chunk, n, mem_cap), 1)
    p1 = torch.zeros(m, dtype=t_source.dtype, device=t_source.device)
    px = torch.zeros_like(t_source)
    xx = torch.zeros((), dtype=t_source.dtype, device=t_source.device)
    pt1 = []
    for s in range(0, n, block):
        x_blk = target[s:s + block]
        if x_blk.shape[0] < block and n > block:
            pad = torch.full((block - x_blk.shape[0], dim), _PAD_BIG,
                             dtype=target.dtype, device=target.device)
            x_blk = torch.cat([x_blk, pad])
        pt1_b, p1_b, px_b, xx_b = _block_moments(t_source, x_blk, sigma2,
                                                 c, eps)
        p1, px, xx = p1 + p1_b, px + px_b, xx + xx_b
        pt1.append(pt1_b)
    pt1 = torch.cat(pt1)[:n]
    return EstepMoments(pt1, p1, px, p1.sum(), xx)


def estep(t_source: torch.Tensor, target: torch.Tensor, sigma2,
          w: float = 0.0, use_pallas: Optional[bool] = None,
          assume_sorted: bool = False) -> EstepMoments:
    """Dispatch by size: the one-launch kernel for small problems, the
    Morton-sorted tile-culled stash kernels for large ones (only tiles
    whose exps provably underflow are skipped; at the start temperature
    the reference's gate may pick the bf16 cross term,
    ``estep_cuda.estep_auto``), the streaming plain E-step otherwise (and
    for D > 3, which the kernels do not take).

    ``use_pallas`` keeps the reference's name and order of tests: None
    picks as above, and then the two-pass kernels (estep_fused) only where
    ``config.use_pallas`` is set and M * N >= ``config.pallas_min_pairs``;
    True asks for the two-pass kernels; False for no hand-written kernel at
    all (the streaming plain E-step).
    """
    from . import estep_cuda

    m, n = t_source.shape[0], target.shape[0]
    kernel_dim = t_source.shape[1] <= 3
    if use_pallas is None and kernel_dim \
            and m * n <= config.small_estep_max_pairs:
        return estep_cuda.estep_small(t_source, target, sigma2, w)
    # Pre-sorted callers (the cpd sorted steps) take the culled path from
    # culled_estep_min_pairs; unsorted ones only from 2^28, since they pay a
    # Morton sort on every call.
    min_pairs = (config.culled_estep_min_pairs if assume_sorted
                 else max(config.culled_estep_min_pairs, 1 << 28))
    if use_pallas is None and kernel_dim and config.use_culled_estep \
            and m * n >= min_pairs:
        return estep_cuda.estep_auto(t_source, target, sigma2, w,
                                     assume_sorted=assume_sorted)
    if use_pallas is None:
        use_pallas = config.use_pallas and m * n >= config.pallas_min_pairs
    if use_pallas and kernel_dim:
        return estep_cuda.estep_fused(t_source, target, sigma2, w)
    return estep_xla(t_source, target, sigma2, w)
