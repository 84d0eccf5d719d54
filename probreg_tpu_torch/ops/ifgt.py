"""Improved Fast Gauss Transform (counterpart of probreg_tpu/ops/ifgt.py).

An eps-approximate Gauss transform

    G(y_i) = sum_j w_j exp(-|y_i - x_j|^2 / h^2)

by multivariate Taylor expansions about k-center cluster centres (the
reference's C++ ifgt.cc and kcenter_clustering.cc): each cluster's
coefficients are one monomial-feature matrix summed by cluster label, and
each target sums the expansions of the clusters within the cutoff radius
of it. The graded monomials are an exponent matrix E, monomials(d) =
prod_i d_i^E[k, i] with the constants 2^|a| / a!, fixed on the host.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

from .. import config as _config
from . import pairwise


def nchoosek(n: int, k: int) -> int:
    return math.comb(n, k)


def multi_indices(dims: int, p: int) -> np.ndarray:
    """All multi-indices of total degree < p, graded, shape
    (nchoosek(p - 1 + d, d), d) (reference ifgt.py:44)."""
    levels = [[tuple([0] * dims)]]
    for _ in range(1, p):
        new = set()
        for a in levels[-1]:
            for i in range(dims):
                b = list(a)
                b[i] += 1
                new.add(tuple(b))
        levels.append(sorted(new))
    out = np.array([a for lvl in levels for a in lvl], np.int64)
    if out.shape[0] != nchoosek(p - 1 + dims, dims):
        raise AssertionError("multi_indices count")
    return out


def choose_truncation_number(dims: int, h: float, r: float, eps: float,
                             rx: float, p_limit: int = 200) -> int:
    """ifgt.cc:25-41, in the log domain (reference ifgt.py:60)."""
    h2 = h * h
    rx2 = rx * rx
    error = np.inf
    log_temp = 0.0
    p = 0
    while error > eps and p <= p_limit:
        p += 1
        b = min(rx + np.sqrt(rx2 + 2.0 * p * h2) * 0.5, rx + r)
        c = rx - b
        log_temp += np.log(max(2.0 * rx * b / h2 / p, 1e-300))
        error = np.exp(min(log_temp - (c * c) / h2, 700.0))
    return p


def choose_parameters(dims: int, h: float, eps: float, max_range: float,
                      num_max_clusters: int, p_limit: int = 200):
    """ifgt.cc:43-62: (num_clusters, cutoff_radius r, p_max) (reference
    ifgt.py:78)."""
    r = min(max_range * np.sqrt(dims), h * np.sqrt(np.log(1.0 / eps)))
    complexity_min = np.inf
    num_clusters = 0
    p_max = p_limit
    for i in range(num_max_clusters):
        rx = max_range * (i + 1.0) ** (-1.0 / dims)
        n = min(i + 1.0, (r / rx) ** dims)
        p = choose_truncation_number(dims, h, r, eps, rx, p_limit)
        complexity = i + 1 + np.log(i + 1.0) \
            + (n + 1) * nchoosek(p - 1 + dims, dims)
        if complexity < complexity_min:
            complexity_min = complexity
            num_clusters = i + 1
            p_max = p
    return num_clusters, float(r), int(p_max)


class ClusteringResult(NamedTuple):
    """kcenter_clustering.h:8-13."""

    max_cluster_radius: float
    labels: torch.Tensor       # (N,) int64
    centers: torch.Tensor      # (K, D)
    radii: torch.Tensor        # (K,)


def _segment_sum(x: torch.Tensor, labels: torch.Tensor, k: int):
    out = x.new_zeros((k,) + tuple(x.shape[1:]))
    return out.index_add_(0, labels, x)


def _kcenter(data, k, eps=1e-4, max_iter=100):
    """Lloyd iterations from the deterministic spread init (every n/k-th
    point), stopped when the summed squared distance moves by less than
    ``eps`` (kcenter_clustering.cc:23), at most ``max_iter`` (reference
    ifgt.py:108). The loop's end test reads the host once per iteration.
    Labels take the first centre on ties; radii are each cluster's
    largest distance (0 for an empty one)."""
    n = data.shape[0]
    idx0 = (torch.arange(k, device=data.device) * n) // k
    centers = data[idx0]
    err = err_prev = math.inf
    i = 0
    while i < max_iter and (i < 2 or abs(err - err_prev) >= eps):
        d2 = pairwise.sqdist(data, centers)
        dmin, labels = d2.min(1)
        err_prev, err = err, float(dmin.sum())
        sums = _segment_sum(data, labels, k)
        cnt = _segment_sum(torch.ones_like(data[:, 0]), labels, k)
        centers = sums / torch.clamp(cnt, min=1.0)[:, None]
        i += 1
    d2 = pairwise.sqdist(data, centers)
    dmin, labels = d2.min(1)
    dist = torch.sqrt(dmin)
    radii = dist.new_full((k,), -math.inf).scatter_reduce(
        0, labels, dist, reduce="amax")
    radii = torch.where(torch.isfinite(radii), radii, 0.0)
    return labels, centers, radii


def kcenter_clustering(data, num_clusters: int, eps: float = 1e-4,
                       max_iter: int = 100, device=None) -> ClusteringResult:
    """K-center clustering (kcenter_clustering.cc:6-29, reference
    ifgt.py:155)."""
    from ..utils import interop

    labels, centers, radii = _kcenter(
        interop.as_points(data, device=device), int(num_clusters),
        eps=float(eps), max_iter=max_iter)
    return ClusteringResult(float(radii.max()), labels, centers, radii)


def _monomials(d_scaled: torch.Tensor, expo: torch.Tensor) -> torch.Tensor:
    """(P, n_mono) monomials prod_i d_i^E[k, i] of d_scaled (P, dims).
    The powers are the running product 1, d, d d, ..., one multiplication
    a degree: torch.cumprod's scan kernel took two thirds of an IFGT
    evaluation at 150,000 points on an H100."""
    pows = [torch.ones_like(d_scaled)]
    for _ in range(int(expo.max())):
        pows.append(pows[-1] * d_scaled)
    pows = torch.stack(pows, -1)
    out = d_scaled.new_ones((d_scaled.shape[0], expo.shape[0]))
    for i in range(expo.shape[1]):
        out = out * pows[:, i, :][:, expo[:, i]]
    return out


class Ifgt:
    """eps-approximate Gauss transform with a fixed source (reference
    ifgt.py:175; the C++ Ifgt class).

    Args:
        source: (N, D) source points.
        h: Gaussian bandwidth (exp(-d^2 / h^2)).
        eps: Target error: absolute error <= eps * sum|w| for eps >= 1e-4
            and h down to ~0.05 x the cloud's range (the reference's
            characterized envelope).
        max_clusters, p_limit: Caps on the cluster count and the
            truncation order.
        device: Device to run on (default ``config.device``).

    The cloud is centred on the host (the expanded-form distances lose
    ~|x|^2 eps in f32 far from the origin); targets get the same shift.
    The cluster count aims at a cluster radius ~h, K ~ (range / h)^D, so
    that the Taylor argument stays O(1) and p <= p_limit suffices.
    """

    def __init__(self, source, h: float, eps: float = 1.0e-4,
                 max_clusters: int = 2048, p_limit: int = 10, device=None):
        from ..utils import interop

        self.device = _config.resolve_device(device)
        src_np = interop.as_points(source, device="cpu").numpy()
        self._centroid = src_np.mean(axis=0)
        src_np = src_np - self._centroid
        self._source = torch.as_tensor(src_np, device=self.device)
        self._h = float(h)
        n, dims = src_np.shape
        max_range = max(float((src_np.max(0) - src_np.min(0)).max()), 1e-6)
        self._cutoff = min(max_range * np.sqrt(dims),
                           self._h * np.sqrt(np.log(1.0 / eps)))
        num_clusters = int(np.clip((max_range / self._h) ** dims,
                                   1, min(max_clusters, max(n // 2, 1))))
        self._cluster = kcenter_clustering(self._source, num_clusters, eps,
                                           device=self.device)
        self._p = choose_truncation_number(
            dims, self._h, self._cutoff, eps,
            self._cluster.max_cluster_radius, p_limit)
        expo_np = multi_indices(dims, self._p)
        const = (2.0 ** expo_np.sum(1)) / np.array(
            [np.prod([math.factorial(int(a)) for a in row])
             for row in expo_np])
        self._expo = torch.as_tensor(expo_np, device=self.device)
        self._const = torch.as_tensor(const.astype(np.float32),
                                      device=self.device)
        self._ry2 = (self._cutoff + self._cluster.radii) ** 2
        self._cen_t = torch.as_tensor(self._centroid, device=self.device)

    def compute(self, target, weights) -> torch.Tensor:
        from ..utils import interop

        tgt = interop.as_points(target, device=self.device)
        w = interop.as_points(weights, device=self.device)
        return _ifgt_compute(self._source, tgt - self._cen_t, w, self._h,
                             self._cluster.labels, self._cluster.centers,
                             self._ry2, self._expo, self._const)


def _ifgt_compute(source, target, weights, h, labels, centers, ry2, expo,
                  const, chunk: int = 8192):
    """The transform of ``target`` by the expansions of ``source``
    (ifgt.cc:121-148, reference ifgt.py:242)."""
    h2 = h * h
    k = centers.shape[0]
    n, dims = source.shape
    # Pad with a REAL point of weight 0, never the origin: a zero row far
    # from its cluster's centre overflows dx^p to inf, and 0 * inf = NaN
    # would poison that cluster's coefficients.
    pad = (-n) % chunk
    src_p = torch.cat([source, source[:1].expand(pad, dims)])
    lab_p = torch.cat([labels, labels[:1].expand(pad)])
    wgt_p = torch.cat([weights, weights.new_zeros(pad)])
    cmat = source.new_zeros((k, expo.shape[0]))
    for c0 in range(0, src_p.shape[0], chunk):
        s_blk = src_p[c0:c0 + chunk]
        l_blk = lab_p[c0:c0 + chunk]
        diff = s_blk - centers[l_blk]
        mon = _monomials(diff / h, expo)
        f = wgt_p[c0:c0 + chunk] * torch.exp(-(diff * diff).sum(1) / h2)
        cmat = cmat + _segment_sum(f[:, None] * mon, l_blk, k)
    cmat = cmat * const[None, :]

    out = target.new_zeros(target.shape[0])
    for j in range(k):
        dy = target - centers[j]
        dist2 = (dy * dy).sum(1)
        g = torch.exp(-dist2 / h2) * (_monomials(dy / h, expo) @ cmat[j])
        out = out + torch.where(dist2 <= ry2[j], g, 0.0)
    return out
