"""Morton (Z-order) sorting for the tile-culled E-step.

Counterpart of probreg_tpu/ops/spatial.py. Tile culling only pays when a
tile of consecutive points is spatially compact; Z-order makes it so. The
codes are computed in int32 exactly as the reference does, and the sort is
stable like ``jnp.argsort``, so the permutation equals the reference's.
"""

from __future__ import annotations

import torch


def _spread3(x: torch.Tensor) -> torch.Tensor:
    """Spread 10 bits to every 3rd bit (standard Morton magic numbers)."""
    x = (x | (x << 16)) & 0x030000FF
    x = (x | (x << 8)) & 0x0300F00F
    x = (x | (x << 4)) & 0x030C30C3
    x = (x | (x << 2)) & 0x09249249
    return x


def _spread2(x: torch.Tensor) -> torch.Tensor:
    """Spread 15 bits to every 2nd bit."""
    x = (x | (x << 8)) & 0x00FF00FF
    x = (x | (x << 4)) & 0x0F0F0F0F
    x = (x | (x << 2)) & 0x33333333
    x = (x | (x << 1)) & 0x55555555
    return x


def morton_code(points: torch.Tensor) -> torch.Tensor:
    """(N, D) points -> (N,) int32 Morton codes (D >= 2; 3-D uses 10 bits
    per axis over the first three axes, 2-D 15 bits)."""
    dim = points.shape[1]
    lo = points.amin(0)
    hi = points.amax(0)
    span = torch.clamp(hi - lo, min=torch.finfo(points.dtype).tiny)
    bits = 10 if dim >= 3 else 15
    scale = float(2 ** bits - 1)
    q = torch.clamp((points - lo) / span * scale, 0.0, scale).to(torch.int32)
    if dim == 2:
        return _spread2(q[:, 0]) | (_spread2(q[:, 1]) << 1)
    return (_spread3(q[:, 0]) | (_spread3(q[:, 1]) << 1)
            | (_spread3(q[:, 2]) << 2))


def morton_order(points: torch.Tensor) -> torch.Tensor:
    """Permutation that sorts points into Z-order (stable on ties)."""
    return torch.argsort(morton_code(points), stable=True)


def morton_order_np(points) -> "np.ndarray":
    """Host Z-order permutation of (N, D) points (numpy in, numpy out),
    for the entry points that sort whole clouds once before sharding them
    (parallel/). The reference's permutation: float32 2-D and 3-D clouds
    from the native loader's radix sort (``_io_native.morton_order``, the
    same codes and order), every other cloud from morton_order on the CPU
    in its own dtype (the reference quantizes a float64 cloud in
    float64)."""
    import numpy as np

    from .. import _io_native

    pts = np.asarray(points)
    if pts.dtype == np.float32 and pts.ndim == 2 \
            and pts.shape[1] in (2, 3) and pts.shape[0] > 0:
        return _io_native.morton_order(pts)
    return morton_order(torch.as_tensor(pts)).numpy()
