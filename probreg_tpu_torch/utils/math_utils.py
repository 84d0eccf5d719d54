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
