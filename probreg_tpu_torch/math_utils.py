"""Top-level alias of :mod:`probreg_tpu_torch.utils.math_utils` (reference
math_utils.py)."""

from .utils.math_utils import (  # noqa: F401
    Normalizer,
    compute_rmse,
    inverse_multiquadric_kernel,
    rbf_kernel,
    squared_kernel_sum,
    tps_kernel,
)
