"""Pairwise squared distances (counterpart of probreg_tpu/ops/pairwise.py).

Distances use the expanded form |x|^2 + |y|^2 - 2 x.y after centring on the
joint mean: the expanded form loses ~|x|^2 * eps to f32 cancellation, and
squared distances are translation invariant, so centring restores O(1)
accuracy at O(M + N) cost. Matmuls run in full f32 (TF32 is off, see the
package __init__). The nearest-neighbour search takes differences instead
(``sqdist_diff``), so a point is exactly 0 from itself.
"""

from __future__ import annotations

import torch


def _center(x: torch.Tensor, y: torch.Tensor):
    cen = (x.sum(0) + y.sum(0)) / (x.shape[0] + y.shape[0])
    return x - cen, y - cen


def sqdist(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """(M, N) squared euclidean distances of (M, D) and (N, D), clamped at 0."""
    x, y = _center(x, y)
    x2 = (x * x).sum(-1)[:, None]
    y2 = (y * y).sum(-1)[None, :]
    return torch.clamp(x2 + y2 - 2.0 * (x @ y.T), min=0.0)


def rbf_kernel(x: torch.Tensor, y: torch.Tensor, beta: float) -> torch.Tensor:
    """exp(-d^2 / (2 beta)) Gram matrix (reference pairwise.py:63; beta
    enters linearly, it is the variance)."""
    return torch.exp(-sqdist(x, y) / (2.0 * beta))


def inverse_multiquadric_kernel(x: torch.Tensor, y: torch.Tensor,
                                c: float = 1.0) -> torch.Tensor:
    """1 / sqrt(d^2 + c) Gram matrix (reference pairwise.py:86), BCPD's G."""
    return 1.0 / torch.sqrt(sqdist(x, y) + c)


def sqdist_diff(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """(M, N) squared distances summed from coordinate differences: slower
    than ``sqdist`` but exact to rounding at any offset, and exactly 0 for
    identical points (which the expanded form need not give)."""
    return sum((x[:, None, d] - y[None, :, d]) ** 2 for d in range(x.shape[1]))


def sqdist_sum(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """sum_ij |x_i - y_j|^2 in closed form, O(M + N).

    N * sum|x|^2 + M * sum|y|^2 - 2 (sum x).(sum y), on centred clouds.
    """
    m, n = x.shape[0], y.shape[0]
    x, y = _center(x, y)
    return n * (x * x).sum() + m * (y * y).sum() - 2.0 * (x.sum(0) @ y.sum(0))


def nearest_sqdist(source: torch.Tensor, target: torch.Tensor,
                   block: int = 4096, exclude_zero: bool = False,
                   src_block: int = 4096,
                   target_valid: torch.Tensor = None) -> torch.Tensor:
    """(M,) squared distance from each source point to its nearest target
    point (reference pairwise.py:122).

    Both axes are chunked, so the live distance buffer is (src_block,
    block) whatever the cloud sizes. Distances come from differences
    (``sqdist_diff``): ``exclude_zero`` skips exact matches (d2 <= 1e-12:
    the point itself), for point-spacing estimates, and the expanded form
    may leave a point ~1e-7 from itself.
    ``target_valid``: optional (N,) 0/1 mask; invalid targets are never a
    nearest neighbour (ragged-batch padding). A source point with no
    candidate gets inf.
    """
    m, n = source.shape[0], target.shape[0]
    best = source.new_full((m,), float("inf"))
    for s0 in range(0, m, src_block):
        chunk = source[s0:s0 + src_block]
        row = best[s0:s0 + src_block]
        for t0 in range(0, n, block):
            d2 = sqdist_diff(chunk, target[t0:t0 + block])
            if target_valid is not None:
                valid = target_valid[t0:t0 + block] > 0
                d2 = torch.where(valid[None, :], d2, float("inf"))
            if exclude_zero:
                d2 = torch.where(d2 <= 1e-12, float("inf"), d2)
            row = torch.minimum(row, d2.amin(1))
        best[s0:s0 + src_block] = row
    return best


def point_spacing_sq(points: torch.Tensor) -> torch.Tensor:
    """Mean squared nearest-neighbour spacing of a cloud, the point itself
    excluded (reference pairwise.py:178)."""
    d2 = nearest_sqdist(points, points, exclude_zero=True)
    return torch.where(torch.isfinite(d2), d2, 0.0).mean()
