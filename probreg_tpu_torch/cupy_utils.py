"""Stand-in for the reference's ``probreg.cupy_utils`` (counterpart of
probreg_tpu/cupy_utils.py): the same three functions on tensors, through
``ops/pairwise``, so code written against that module keeps working.
Inputs may be tensors (their device is kept) or arrays (the CPU)."""

from __future__ import annotations

import torch

from .ops import pairwise
from .utils import math_utils as _mu


def _t(x):
    return torch.as_tensor(x)


def squard_norm_outer_kernel(x, y):  # [sic]: the reference's name
    """Pairwise squared distances |x_i - y_j|^2 (any dimension)."""
    return pairwise.sqdist(_t(x), _t(y))


def squared_kernel_sum(x, y):
    """Mean pairwise squared distance / D."""
    return _mu.squared_kernel_sum(_t(x), _t(y))


def rbf_kernel(x, y, beta):
    """RBF Gram matrix exp(-|x - y|^2 / (2 beta))."""
    return pairwise.rbf_kernel(_t(x), _t(y), beta)
