"""Exact Gauss transform and FilterReg's E-step moments (counterpart of
probreg_tpu/ops/gausstransform.py).

    out[i, c] = sum_j exp(-|target_i - source_j|^2 / h^2) * weights[j, c]

Large problems go to the tile-culled kernel (ops/gt_cuda.py) under the
reference's gate, less its backend test: ``config.use_culled_estep``, at
most 8 channels, 2 <= D <= 8, and M * N >= ``config.culled_estep_min_pairs``
for callers whose clouds are already Morton-sorted (``assume_sorted``), or
>= max(that, 2^28) for the others, which pay a sort on every call; there
the reference's start-temperature gate picks between the exact kernel and
its bf16 cross term (``gt_cuda.gauss_transform_culled``, ``fast_start``).
The kernel's wrapper runs the kernel for CUDA tensors and its plain
version for CPU tensors. Everything else is the dense transform streamed
over source blocks, in plain tensors.
"""

from __future__ import annotations

from typing import Optional

import torch

from ..config import config
from . import gt_cuda
from .pairwise import sqdist


def _culled_ok(m: int, n: int, dim: int, c: int, assume_sorted: bool) -> bool:
    min_pairs = (config.culled_estep_min_pairs if assume_sorted
                 else max(config.culled_estep_min_pairs, 1 << 28))
    return (config.use_culled_estep and c <= gt_cuda.MAX_CHANNELS
            and 2 <= dim <= 8 and m * n >= min_pairs)


def gauss_transform(source: torch.Tensor, target: torch.Tensor,
                    weights: torch.Tensor, h, block: Optional[int] = None,
                    assume_sorted: bool = False,
                    fast_start: Optional[bool] = None) -> torch.Tensor:
    """Gauss transform: ``weights`` (M,) or (M, C), h the bandwidth
    (exp(-d^2 / h^2), the reference's convention). Returns (len(target),
    C), or (len(target),) for 1-D weights. ``fast_start``: the culled
    kernel's start-temperature gate (gt_cuda.gauss_transform_culled;
    default ``config.estep_fast_start``, False for the exact branch)."""
    squeeze = weights.dim() == 1
    if squeeze:
        weights = weights[:, None]
    m, dim = source.shape
    n = target.shape[0]
    if _culled_ok(m, n, dim, weights.shape[1], assume_sorted):
        out = gt_cuda.gauss_transform_culled(source, target, weights, h,
                                             sort=not assume_sorted,
                                             fast_start=fast_start)
        return out[:, 0] if squeeze else out
    h2 = torch.as_tensor(h, dtype=source.dtype, device=source.device) ** 2
    if block is None:
        block = max(min(config.estep_chunk, m,
                        max(128, ((1 << 28) // max(n, 1)) // 128 * 128)), 1)
    out = target.new_zeros((n, weights.shape[1]))
    for s0 in range(0, m, block):
        k = torch.exp(-sqdist(target, source[s0:s0 + block]) / h2)
        out = out + k @ weights[s0:s0 + block]
    return out[:, 0] if squeeze else out


def moment_channels(y: torch.Tensor, normals: Optional[torch.Tensor],
                    need_m2: bool) -> torch.Tensor:
    """(N, C) channels [1, y, |y|^2 (need_m2), normals] whose Gauss
    transform (or lattice filter) gives FilterReg's moments."""
    chans = [torch.ones_like(y[:, :1]), y]
    if need_m2:
        chans.append((y * y).sum(1, keepdim=True))
    if normals is not None:
        chans.append(normals.to(y))
    return torch.cat(chans, dim=1)


def split_moments(out: torch.Tensor, dim: int, need_m2: bool,
                  need_nx: bool):
    """(m0 (M,), m1 (M, D), m2 (M,) or None, nx (M, D) or None) from the
    (M, C) sums of :func:`moment_channels`."""
    col = 1 + dim
    m2 = None
    if need_m2:
        m2 = out[:, col]
        col += 1
    nx = out[:, col:col + dim] if need_nx else None
    return out[:, 0], out[:, 1:1 + dim], m2, nx


def filterreg_moments(f_source: torch.Tensor, f_target: torch.Tensor,
                      y: torch.Tensor, normals: Optional[torch.Tensor],
                      need_m2: bool = False, block: Optional[int] = None,
                      assume_sorted: bool = False):
    """Exact FilterReg E-step moments in one Gauss transform.

    K_ij = exp(-|fx_i - fy_j|^2 / 2) over sigma-scaled features (the
    reference computes these through a permutohedral lattice); the channels
    are [1, y, |y|^2 (need_m2), normals]. The FilterReg target is the
    transform's ``source`` and the transformed source its ``target``, so
    the moments come out per source point. Returns (m0 (M,), m1 (M, D),
    m2 (M,) or None, nx (M, D) or None).
    """
    out = gauss_transform(f_target, f_source,
                          moment_channels(y, normals, need_m2), 2.0 ** 0.5,
                          block=block, assume_sorted=assume_sorted)
    return split_moments(out, y.shape[1], need_m2, normals is not None)
