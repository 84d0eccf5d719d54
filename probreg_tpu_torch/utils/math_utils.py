"""Math utilities (counterpart of probreg_tpu/utils/math_utils.py)."""

from __future__ import annotations

import torch

from ..ops import pairwise


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
