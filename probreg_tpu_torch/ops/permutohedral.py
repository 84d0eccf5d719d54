"""Permutohedral-lattice Gaussian filtering (counterpart of
probreg_tpu/ops/permutohedral.py).

Approximate high-dimensional Gaussian filtering (Adams et al. 2010)

    out_i ~= sum_j w_j exp(-|f_i - f_j|^2 / 2)

by splatting values onto the vertices of the permutohedral simplex that
encloses each feature, blurring along the d + 1 lattice axes with a
[0.5, 1, 0.5] kernel, and slicing back with the barycentric weights.

The vertices are deduplicated by sorting: ``torch.unique(dim=0)`` sorts
the N (d + 1) splat keys lexicographically, column 0 most significant,
and numbers the distinct ones in that order, which is the reference's
``_lex_sort`` order, so vertex ids, offsets and blur neighbours are the
reference's. The table is sized exactly (``size`` rows), where the
reference pads it to its N (d + 1) capacity for jit; the reference's
``n1`` / ``n2`` agree with these over their first ``size`` columns. The
blur neighbours are found by a vectorised lexicographic binary search over
the sorted keys, on the int32 coordinates themselves (no packing into one
integer, which large features / sigma would overflow).

The rounding of the simplex copies the reference's expressions
(``up - elevated < elevated - down``, the truncating cast of the rank
sum): round-half-to-even would move ties to other vertices. The splat is
an ``index_add_``, whose float atomics on CUDA add in no fixed order, so
a card's filter agrees with the CPU's to rounding, not in bits.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional

import numpy as np
import torch


def _elevation_matrix(d: int, with_blur: bool) -> np.ndarray:
    """(d + 1, d) matrix E with elevated = E f (reference
    permutohedral.py:40)."""
    inv_std_dev = (np.sqrt(2.0 / 3.0) if with_blur
                   else np.sqrt(1.0 / 6.0)) * (d + 1)
    scale = inv_std_dev / np.sqrt((np.arange(d) + 1.0) * (np.arange(d) + 2.0))
    e = np.zeros((d + 1, d), np.float32)
    for j in range(1, d + 1):
        e[j, j:] = scale[j:]
        e[j, j - 1] = -j * scale[j - 1]
    e[0, :] = scale
    return e


def _canonical(d: int) -> np.ndarray:
    """(d + 1, d + 1) canonical simplex offsets."""
    c = np.zeros((d + 1, d + 1), np.int64)
    for r in range(d + 1):
        c[r, :d + 1 - r] = r
        c[r, d + 1 - r:] = r - (d + 1)
    return c


def _lex_lt(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Row-wise lexicographic a < b of integer (..., d) tensors, column 0
    most significant."""
    lt = torch.zeros(a.shape[:-1], dtype=torch.bool, device=a.device)
    for k in range(a.shape[-1] - 1, -1, -1):
        lt = (a[..., k] < b[..., k]) | ((a[..., k] == b[..., k]) & lt)
    return lt


def _lex_search(sorted_keys: torch.Tensor, queries: torch.Tensor):
    """For each query row the index i with sorted_keys[i] == query, else -1
    (reference permutohedral.py:77): a binary search of all queries at
    once, ceil(log2 L) + 1 halvings."""
    lnum = sorted_keys.shape[0]
    steps = max(1, int(math.ceil(math.log2(max(lnum, 2)))) + 1)
    lo = torch.zeros(queries.shape[0], dtype=torch.int64,
                     device=queries.device)
    hi = torch.full_like(lo, lnum)
    for _ in range(steps):
        mid = (lo + hi) // 2
        go_right = _lex_lt(sorted_keys[mid.clamp(0, lnum - 1)], queries)
        lo = torch.where(go_right, mid + 1, lo)
        hi = torch.where(go_right, hi, mid)
    found = sorted_keys[lo.clamp(0, lnum - 1)]
    ok = (found == queries).all(-1) & (lo < lnum)
    return torch.where(ok, lo, -1)


class Lattice(NamedTuple):
    """A built lattice of ``size`` vertices over N points in d dimensions."""

    offsets: torch.Tensor      # (N, d + 1) int64 vertex id per point
    barycentric: torch.Tensor  # (N, d + 1) float32 splat / slice weights
    n1: torch.Tensor           # (d + 1, size) int64 blur neighbour, -1 none
    n2: torch.Tensor           # (d + 1, size) int64
    size: int                  # number of lattice vertices

    @property
    def d(self) -> int:
        return self.offsets.shape[1] - 1


def build(features: torch.Tensor, with_blur: bool = True,
          max_size: Optional[int] = None) -> Optional[Lattice]:
    """Build the lattice of (N, d) features (reference
    permutohedral.py:112). ``size`` is a host integer: sizing the table
    exactly is one device synchronisation (the unique count).
    ``max_size``: return None when the lattice has more vertices, before
    its blur neighbours are searched (FilterReg's blur switch)."""
    features = torch.as_tensor(features).to(torch.float32)
    dev = features.device
    n, d = features.shape
    elev_m = torch.from_numpy(_elevation_matrix(d, with_blur)).to(dev)
    canon = torch.from_numpy(_canonical(d)).to(dev)

    elevated = features @ elev_m.T                           # (N, d + 1)
    v = elevated / (d + 1)
    up = torch.ceil(v) * (d + 1)
    down = torch.floor(v) * (d + 1)
    rem0 = torch.where(up - elevated < elevated - down, up, down)
    sums = (rem0.sum(1) / (d + 1)).to(torch.int32).to(torch.int64)

    # rank[i] = #{j > i: di_j > di_i} + #{j < i: di_j >= di_i}
    di = elevated - rem0
    gt = di[:, None, :] > di[:, :, None]
    ge = di[:, None, :] >= di[:, :, None]
    iu = torch.triu(torch.ones(d + 1, d + 1, dtype=torch.bool, device=dev), 1)
    il = torch.tril(torch.ones(d + 1, d + 1, dtype=torch.bool, device=dev),
                    -1)
    rank = (gt & iu).sum(2) + (ge & il).sum(2) + sums[:, None]
    rem0 = torch.where(rank < 0, rem0 + (d + 1),
                       torch.where(rank > d, rem0 - (d + 1), rem0))
    rank = torch.where(rank < 0, rank + (d + 1),
                       torch.where(rank > d, rank - (d + 1), rank))

    # Barycentric coordinates: +t into slot d - rank, -t into the next.
    t = (elevated - rem0) / (d + 1)
    slots = d - rank
    onehot = (torch.nn.functional.one_hot(slots, d + 2)
              - torch.nn.functional.one_hot(slots + 1, d + 2)).to(t.dtype)
    bary = torch.einsum("nk,nks->ns", t, onehot)
    barycentric = torch.cat([bary[:, :1] + (1.0 + bary[:, d + 1:]),
                             bary[:, 1:d + 1]], 1)

    # Keys: the first d coordinates of each simplex vertex.
    keys = (rem0[:, None, :d].to(torch.int64)
            + canon[:, rank[:, :d]].permute(1, 0, 2)).to(torch.int32)
    uniq, inverse = torch.unique(keys.reshape(n * (d + 1), d), dim=0,
                                 sorted=True, return_inverse=True)
    size = int(uniq.shape[0])
    if max_size is not None and size > max_size:
        return None
    offsets = inverse.reshape(n, d + 1)

    if with_blur:
        n1s, n2s = [], []
        for j in range(d + 1):
            nk1, nk2 = uniq - 1, uniq + 1
            if j < d:  # j == d: the implicit last coordinate
                nk1[:, j] = uniq[:, j] + d
                nk2[:, j] = uniq[:, j] - d
            n1s.append(_lex_search(uniq, nk1))
            n2s.append(_lex_search(uniq, nk2))
        n1, n2 = torch.stack(n1s), torch.stack(n2s)
    else:
        n1 = n2 = torch.full((d + 1, size), -1, dtype=torch.int64,
                             device=dev)
    return Lattice(offsets, barycentric, n1, n2, size)


def filter(lattice: Lattice, values: torch.Tensor, start: int = 0,
           reverse: bool = False, with_blur: bool = True) -> torch.Tensor:
    """Filter (N, C) values through the lattice (reference
    permutohedral.py:194). Rows before ``start`` are left out of the splat
    but still sliced: FilterReg's source / target split."""
    values = torch.as_tensor(values).to(torch.float32)
    c = values.shape[1]
    d = lattice.d
    if start:
        values = torch.cat([values.new_zeros((start, c)), values[start:]])
    w = lattice.barycentric.reshape(-1, 1) * values.repeat_interleave(
        d + 1, dim=0)
    lat = values.new_zeros((lattice.size, c)).index_add_(
        0, lattice.offsets.reshape(-1), w)
    if with_blur:
        for j in (range(d, -1, -1) if reverse else range(d + 1)):
            i1, i2 = lattice.n1[j], lattice.n2[j]
            v1 = torch.where((i1 >= 0)[:, None], lat[i1.clamp(min=0)], 0.0)
            v2 = torch.where((i2 >= 0)[:, None], lat[i2.clamp(min=0)], 0.0)
            lat = lat + 0.5 * (v1 + v2)
    alpha = 1.0 / (1.0 + 2.0 ** (-d))
    return alpha * torch.einsum("nk,nkc->nc", lattice.barycentric,
                                lat[lattice.offsets])
