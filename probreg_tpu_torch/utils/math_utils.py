"""Math utilities (counterpart of probreg_tpu/utils/math_utils.py)."""

from __future__ import annotations

import numpy as np
import torch

from ..ops import pairwise


class Normalizer:
    """Shift and scale normalizer (reference math_utils.py:17): ``fit``
    takes the centroid of every given cloud together and the largest
    distance from it as the scale (floored at 1e-12)."""

    def __init__(self, scale: float = 1.0, centroid=0.0):
        self._scale = scale
        self._centroid = centroid

    @classmethod
    def fit(cls, *clouds) -> "Normalizer":
        """Estimate the centroid and scale from one or more clouds."""
        allpts = torch.cat([torch.as_tensor(c) for c in clouds], dim=0)
        centroid = allpts.mean(0)
        scale = torch.clamp(
            torch.linalg.norm(allpts - centroid, dim=1).max(), min=1e-12)
        return cls(scale, centroid)

    def _like(self, x):
        x = torch.as_tensor(x)
        return x, *(torch.as_tensor(v, dtype=x.dtype, device=x.device)
                    for v in (self._centroid, self._scale))

    def normalize(self, x) -> torch.Tensor:
        x, centroid, scale = self._like(x)
        return (x - centroid) / scale

    def denormalize(self, x) -> torch.Tensor:
        x, centroid, scale = self._like(x)
        return x * scale + centroid


def squared_kernel_sum_np(x, y) -> float:
    """Host-side :func:`squared_kernel_sum` in float64 numpy (reference
    math_utils.py:51), centred on the joint centroid."""
    x = np.asarray(x, np.float64)
    y = np.asarray(y, np.float64)
    m, d = x.shape
    n = y.shape[0]
    cen = (x.sum(0) + y.sum(0)) / (m + n)
    xh, yh = x - cen, y - cen
    return float(((xh ** 2).sum() * n + (yh ** 2).sum() * m
                  - 2.0 * float(xh.sum(0) @ yh.sum(0))) / (m * d * n))


def compute_rmse(source: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """Mean nearest-neighbour distance from source to target (reference
    math_utils.py:86): the chunked search of ``pairwise.nearest_sqdist``,
    which takes differences."""
    return torch.sqrt(pairwise.nearest_sqdist(source, target)).mean()


def rbf_kernel(x, y, beta: float) -> torch.Tensor:
    return pairwise.rbf_kernel(x, y, beta)


def tps_kernel(x, y) -> torch.Tensor:
    """The thin-plate-spline kernel of the points' dimension (reference
    math_utils.py:100): ``tps_kernel_2d`` or ``tps_kernel_3d``."""
    if x.shape[1] != y.shape[1]:
        raise ValueError("x and y must have same dimensions.")
    if x.shape[1] == 2:
        return pairwise.tps_kernel_2d(x, y)
    if x.shape[1] == 3:
        return pairwise.tps_kernel_3d(x, y)
    raise ValueError("Invalid dimension of x: %d." % x.shape[1])


def inverse_multiquadric_kernel(x, y, c: float = 1.0) -> torch.Tensor:
    return pairwise.inverse_multiquadric_kernel(x, y, c)


def squared_kernel_sum(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Mean pairwise squared distance / D: the CPD sigma2 initializer.

    Reference math_utils.py:28-29 (sum / (M * D * N)), in closed form.
    """
    return pairwise.sqdist_sum(x, y) / float(x.shape[0] * x.shape[1]
                                             * y.shape[0])


def masked_squared_kernel_sum_t(ys_t, xs_t, smask, tmask) -> torch.Tensor:
    """squared_kernel_sum over masked (D, M) / (D, N) clouds, in closed form.

    Ragged-batch padding: the sums run over valid points only and the
    normalizer uses the true counts, which is squared_kernel_sum of the
    pair without its padding (reference math_utils.py:69-83).
    """
    dim = ys_t.shape[0]
    m, n = smask.sum(), tmask.sum()
    s2 = ((ys_t * ys_t).sum(0) * smask).sum()
    t2 = ((xs_t * xs_t).sum(0) * tmask).sum()
    return (s2 * n + t2 * m - 2.0 * (ys_t @ smask) @ (xs_t @ tmask)) \
        / (m * dim * n)
