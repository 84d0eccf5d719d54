"""Fast Point Feature Histograms, 33-D (counterpart of
probreg_tpu/ops/fpfh.py; Rusu et al., ICRA 2009):

1. normals by PCA over radius-limited k-nearest neighbourhoods (the
   closed-form 3 x 3 eigensolver of ``ops/sym3``),
2. per-pair Darboux-frame angles (alpha, phi, theta),
3. 3 x 11-bin SPFH histograms,
4. FPFH_i = SPFH_i + the 1 / distance-weighted SPFH_j of the neighbours,
   renormalised per 11-bin block to sum 100.

Neighbourhoods are exact: ``torch.topk`` over squared distances, taken
over blocks of query rows so that no more than ``_KNN_PAIRS`` distances
are held at once (the reference forms the whole N x N matrix). The
neighbour sets equal the reference's ``lax.top_k`` sets except where two
candidates tie at the k-th distance. The histogram bins are discontinuous:
an angle within rounding of a bin edge moves one vote between the two
packages.
"""

from __future__ import annotations

import math

import torch

from . import sym3 as _sym3
from .pairwise import sqdist

_NBINS = 11
# Distances held at once by the neighbour search: 2^26 float32 (256 MiB).
_KNN_PAIRS = 1 << 26


def _knn(points, k, radius):
    """(idx (N, k), valid (N, k), dist (N, k)): the k nearest neighbours
    of each point, itself excluded, valid within ``radius`` (reference
    fpfh.py:30)."""
    n = points.shape[0]
    k = min(k, n - 1)
    block = max(1, _KNN_PAIRS // max(n, 1))
    negs, idxs = [], []
    for s in range(0, n, block):
        d2 = sqdist(points[s:s + block], points)
        rows = torch.arange(s, min(s + block, n), device=points.device)
        d2[rows - s, rows] += 1e30                  # exclude self
        neg, idx = torch.topk(-d2, k, dim=1)
        negs.append(neg)
        idxs.append(idx)
    dist2 = -torch.cat(negs)
    return (torch.cat(idxs), dist2 <= radius * radius,
            torch.sqrt(torch.clamp(dist2, min=1e-20)))


def _normals(points, idx, valid):
    """PCA normals over the masked neighbourhoods with the point itself in
    the mean and the scatter, oriented away from the centroid (reference
    fpfh.py:42)."""
    nbrs = points[idx]                                   # (N, k, 3)
    w = valid[..., None].to(points.dtype)
    cnt = w.sum(1) + 1.0
    ctr = ((nbrs * w).sum(1) + points) / cnt
    diff = (nbrs - ctr[:, None, :]) * w
    self_diff = points - ctr
    cov = (torch.einsum("nki,nkj->nij", diff, diff)
           + self_diff[:, :, None] * self_diff[:, None, :])
    normals = _sym3.eigh3(cov)[1][:, :, 0]
    out = points - points.mean(0)
    sign = torch.sign((normals * out).sum(1, keepdim=True))
    return normals * torch.where(sign == 0, 1.0, sign)


def _pair_angles(p, n_p, q, n_q):
    """Darboux-frame angles of point pairs, with PCL's source / target swap
    (reference fpfh.py:69)."""
    d = q - p
    dist = torch.linalg.norm(d, dim=-1, keepdim=True)
    dn = d / torch.clamp(dist, min=1e-12)
    dot_p = (n_p * dn).sum(-1, keepdim=True)
    dot_q = (n_q * dn).sum(-1, keepdim=True)
    swap = dot_p.abs() < dot_q.abs()
    u = torch.where(swap, n_q, n_p)
    nt = torch.where(swap, n_p, n_q)
    dn = torch.where(swap, -dn, dn)
    v = torch.linalg.cross(dn, u, dim=-1)
    v = v / torch.clamp(torch.linalg.norm(v, dim=-1, keepdim=True),
                        min=1e-12)
    w = torch.linalg.cross(u, v, dim=-1)
    f1 = (v * nt).sum(-1)
    f2 = (u * dn).sum(-1)
    f3 = torch.atan2((w * nt).sum(-1), (u * nt).sum(-1))
    return f1, f2, f3


def _votes(b, vmask):
    return (torch.nn.functional.one_hot(b, _NBINS).to(vmask.dtype)
            * vmask[..., None]).sum(1)


def _spfh(points, normals, idx, valid):
    """(N, 33) simplified histograms, each valid neighbour one vote in each
    block (reference fpfh.py:95)."""
    f1, f2, f3 = _pair_angles(points[:, None, :], normals[:, None, :],
                              points[idx], normals[idx])
    b1 = torch.clamp(((f1 + 1.0) * 0.5 * _NBINS).to(torch.int64), 0,
                     _NBINS - 1)
    b2 = torch.clamp(((f2 + 1.0) * 0.5 * _NBINS).to(torch.int64), 0,
                     _NBINS - 1)
    b3 = torch.clamp(((f3 + math.pi) / (2.0 * math.pi) * _NBINS).to(
        torch.int64), 0, _NBINS - 1)
    vmask = valid.to(points.dtype)
    cnt = torch.clamp(vmask.sum(1, keepdim=True), min=1.0)
    return torch.cat([_votes(b1, vmask), _votes(b2, vmask),
                      _votes(b3, vmask)], 1) * (100.0 / cnt)


def fpfh(points, radius_normal: float = 0.1, radius_feature: float = 0.5,
         max_nn_normal: int = 30, max_nn_feature: int = 100, normals=None):
    """(N, 33) FPFH descriptors of an (N, 3) cloud (reference fpfh.py:138).
    ``normals``: optional (N, 3) unit normals; else estimated as
    :func:`estimate_normals` does."""
    points = torch.as_tensor(points).to(torch.float32)
    if normals is None:
        idx_n, valid_n, _ = _knn(points, int(max_nn_normal), radius_normal)
        normals = _normals(points, idx_n, valid_n)
    normals = torch.as_tensor(normals).to(points)
    idx, valid, dist = _knn(points, int(max_nn_feature), radius_feature)
    # Coincident neighbours are skipped, as Open3D does: their pair
    # features are undefined and their 1 / dist weight unbounded.
    valid = valid & (dist > 1e-6)
    spfh = _spfh(points, normals, idx, valid)
    wgt = valid.to(points.dtype) / torch.clamp(dist, min=1e-12)
    blocks = torch.einsum("nk,nkb->nb", wgt, spfh[idx]).reshape(-1, 3,
                                                                 _NBINS)
    bsum = blocks.sum(2, keepdim=True)
    blocks = torch.where(bsum > 0.0,
                         blocks * (100.0 / torch.clamp(bsum, min=1e-30)),
                         0.0)
    return spfh + blocks.reshape(-1, 3 * _NBINS)


def estimate_normals(points, radius: float = 0.1, max_nn: int = 30):
    """Normals from radius-limited kNN PCA, the smallest eigenvector, signed
    away from the centroid (reference fpfh.py:161)."""
    points = torch.as_tensor(points).to(torch.float32)
    idx, valid, _ = _knn(points, int(max_nn), radius)
    return _normals(points, idx, valid)
