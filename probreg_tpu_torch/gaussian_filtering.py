"""Permutohedral filtering facade (counterpart of
probreg_tpu/gaussian_filtering.py): the lattice of ``ops/permutohedral``
behind the reference's ``Permutohedral`` class. Arrays are row-major
(N, d), and results are tensors on the lattice's device."""

from __future__ import annotations

import torch

from .ops import permutohedral as ph


class Permutohedral:
    """The lattice of (N, d) feature positions ``p`` (a tensor keeps its
    device; anything else goes to the CPU).

    Args:
        p: (N, d) feature positions.
        with_blur: apply the lattice's blur stage (the reference's default).
    """

    def __init__(self, p, with_blur: bool = True):
        self._with_blur = with_blur
        self._lattice = ph.build(torch.as_tensor(p), with_blur)

    def get_lattice_size(self) -> int:
        return self._lattice.size

    def filter(self, v, start: int = 0) -> torch.Tensor:
        """Filter (N,) or (N, C) values; rows before ``start`` are sliced
        but not splatted."""
        v = torch.as_tensor(v).to(device=self._lattice.offsets.device)
        squeeze = v.dim() == 1
        out = ph.filter(self._lattice, v[:, None] if squeeze else v,
                        start=int(start), with_blur=self._with_blur)
        return out[:, 0] if squeeze else out
