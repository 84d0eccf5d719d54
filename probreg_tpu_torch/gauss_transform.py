"""Gauss transform facade (counterpart of probreg_tpu/gauss_transform.py).

``Direct`` and ``GaussTransform`` keep the reference's constructor
signature (h, eps, sw_h). The exact transform (ops/gausstransform.py) is
the default method; ``method="ifgt"`` takes the eps-approximate Improved
Fast Gauss Transform (ops/ifgt.py), to which ``eps`` goes; ``sw_h`` is
accepted and unused. Results are tensors on the port's device.
"""

from __future__ import annotations

from typing import Optional

import torch

from .ops import gausstransform as gto
from .utils import interop


class Direct:
    """Exact Gauss transform with a fixed source (reference
    gauss_transform.py:28-34)."""

    def __init__(self, source, h, device=None):
        self._source = interop.as_points(source, device=device)
        self._h = float(h)

    def compute(self, target, weights) -> torch.Tensor:
        dev = self._source.device
        return gto.gauss_transform(self._source,
                                   interop.as_points(target, device=dev),
                                   interop.as_points(weights, device=dev),
                                   self._h)


class GaussTransform:
    """Gauss transform with a fixed source (reference
    gauss_transform.py:27-60).

    Args:
        source: Source points.
        h: Bandwidth: exp(-d^2 / h^2).
        eps: IFGT target error (method='ifgt' only).
        sw_h: Accepted for the reference's signature; unused.
        method: 'exact' (default) or 'ifgt' (:class:`ops.ifgt.Ifgt`).
        device: Device to run on (default ``config.device``).
    """

    def __init__(self, source, h: float, eps: float = 1.0e-4,
                 sw_h: float = 0.01, method: str = "exact", device=None):
        del sw_h
        if method == "ifgt":
            from .ops.ifgt import Ifgt

            self._impl = Ifgt(source, h, eps, device=device)
        elif method == "exact":
            self._impl = Direct(source, h, device=device)
        else:
            raise ValueError(f"unknown method {method!r}")

    def compute(self, target,
                weights: Optional[object] = None) -> torch.Tensor:
        """(N,) for 1-D weights (default: ones); (C, N) for (C, M) weights,
        one transform per row as the reference's loop gives them."""
        impl = self._impl
        dev = impl._source.device
        if weights is None:
            weights = torch.ones(impl._source.shape[0], device=dev)
        weights = interop.as_points(weights, device=dev)
        if weights.dim() == 1:
            return impl.compute(target, weights)
        if weights.dim() == 2:
            if isinstance(impl, Direct):
                return impl.compute(target, weights.T).T
            return torch.stack([impl.compute(target, w) for w in weights])
        raise ValueError("weights.ndim must be 1 or 2.")
