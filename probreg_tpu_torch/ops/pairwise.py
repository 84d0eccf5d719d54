"""Pairwise squared distances (counterpart of probreg_tpu/ops/pairwise.py).

Distances use the expanded form |x|^2 + |y|^2 - 2 x.y after centring on the
joint mean: the expanded form loses ~|x|^2 * eps to f32 cancellation, and
squared distances are translation invariant, so centring restores O(1)
accuracy at O(M + N) cost. Matmuls run in full f32 (TF32 is off, see the
package __init__).
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


def sqdist_sum(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """sum_ij |x_i - y_j|^2 in closed form, O(M + N).

    N * sum|x|^2 + M * sum|y|^2 - 2 (sum x).(sum y), on centred clouds.
    """
    m, n = x.shape[0], y.shape[0]
    x, y = _center(x, y)
    return n * (x * x).sum() + m * (y * y).sum() - 2.0 * (x.sum(0) @ y.sum(0))
