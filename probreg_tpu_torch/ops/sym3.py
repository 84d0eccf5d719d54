"""Closed-form symmetric 3x3 eigendecomposition, batched (counterpart of
probreg_tpu/ops/sym3.py).

Eigenvalues by the trigonometric (Cardano) form; eigenvectors from cross
products and a projected 2x2 solve (the robust ordering of Eberly, "A
Robust Eigensolver for 3x3 Symmetric Matrices"): a handful of elementwise
operations per matrix and no iteration, on any device.

Conventions of ``torch.linalg.eigh``: eigenvalues ASCENDING, the j-th
eigenvector in column ``[..., :, j]``. Eigenvector signs and the basis
inside a repeated eigenvalue are arbitrary, as with any eigensolver; the
GMMTree M-step uses them only as an orthonormal weighting basis and is
invariant to both.
"""

from __future__ import annotations

import torch

_TINY = 1e-30
_TWO_PI_3 = 2.0943951023931953


def eigvalsh3(a: torch.Tensor) -> torch.Tensor:
    """Ascending eigenvalues of a batch of symmetric 3x3 matrices."""
    a00, a11, a22 = a[..., 0, 0], a[..., 1, 1], a[..., 2, 2]
    a01 = 0.5 * (a[..., 0, 1] + a[..., 1, 0])
    a02 = 0.5 * (a[..., 0, 2] + a[..., 2, 0])
    a12 = 0.5 * (a[..., 1, 2] + a[..., 2, 1])

    q = (a00 + a11 + a22) / 3.0
    d0, d1, d2 = a00 - q, a11 - q, a22 - q
    p2 = (d0 * d0 + d1 * d1 + d2 * d2
          + 2.0 * (a01 * a01 + a02 * a02 + a12 * a12))
    p = torch.sqrt(torch.clamp(p2 / 6.0, min=0.0))
    ps = torch.where(p > _TINY, p, torch.ones_like(p))
    # det(B) / 2 with B = (A - q I) / p.
    b00, b11, b22 = d0 / ps, d1 / ps, d2 / ps
    b01, b02, b12 = a01 / ps, a02 / ps, a12 / ps
    detb = (b00 * (b11 * b22 - b12 * b12)
            - b01 * (b01 * b22 - b12 * b02)
            + b02 * (b01 * b12 - b11 * b02))
    r = torch.clamp(0.5 * detb, -1.0, 1.0)
    phi = torch.arccos(r) / 3.0
    lam_hi = q + 2.0 * p * torch.cos(phi)
    lam_lo = q + 2.0 * p * torch.cos(phi + _TWO_PI_3)
    lam_mid = 3.0 * q - lam_hi - lam_lo
    iso = p <= _TINY
    lam_hi = torch.where(iso, q, lam_hi)
    lam_mid = torch.where(iso, q, lam_mid)
    lam_lo = torch.where(iso, q, lam_lo)
    return torch.stack([lam_lo, lam_mid, lam_hi], dim=-1)


def _cross(u, v):
    return torch.stack([
        u[..., 1] * v[..., 2] - u[..., 2] * v[..., 1],
        u[..., 2] * v[..., 0] - u[..., 0] * v[..., 2],
        u[..., 0] * v[..., 1] - u[..., 1] * v[..., 0],
    ], dim=-1)


def _normalize(v, fallback):
    n2 = (v * v).sum(-1, keepdim=True)
    ok = n2 > _TINY
    return torch.where(ok, v / torch.sqrt(torch.where(ok, n2,
                                                      torch.ones_like(n2))),
                       fallback)


def _unit(like, axis):
    e = torch.zeros_like(like)
    e[..., axis] = 1.0
    return e


def eigh3(a: torch.Tensor):
    """(eigenvalues ascending, eigenvectors in columns) of symmetric 3x3
    matrices, batched over the leading dimensions."""
    w = eigvalsh3(a)
    lam2 = w[..., 2]

    # v2 (largest eigenvalue): the largest cross product of two rows of
    # A - lam2 I.
    rows = a - lam2[..., None, None] * torch.eye(3, dtype=a.dtype,
                                                 device=a.device)
    r0, r1, r2 = rows[..., 0, :], rows[..., 1, :], rows[..., 2, :]
    c01, c12, c20 = _cross(r0, r1), _cross(r1, r2), _cross(r2, r0)
    n01 = (c01 * c01).sum(-1)
    n12 = (c12 * c12).sum(-1)
    n20 = (c20 * c20).sum(-1)
    best12 = n12 >= torch.maximum(n01, n20)
    best20 = ~best12 & (n20 >= n01)
    v2 = torch.where(best12[..., None], c12,
                     torch.where(best20[..., None], c20, c01))
    ex = _unit(v2, 0)
    v2 = _normalize(v2, ex)

    # Orthonormal complement (u, t) of v2 (branch on the largest |comp|).
    pick_x = v2[..., 0].abs() >= v2[..., 2].abs()
    helper = torch.where(pick_x[..., None], _unit(v2, 2), ex)
    u = _normalize(_cross(v2, helper), ex)
    t = _cross(v2, u)

    # Projected 2x2 eigenproblem for the smallest eigenvalue lam0.
    lam0 = w[..., 0]
    au = (a * u[..., None, :]).sum(-1)
    at = (a * t[..., None, :]).sum(-1)
    m00 = (u * au).sum(-1) - lam0
    m01 = (u * at).sum(-1)
    m11 = (t * at).sum(-1) - lam0
    # (M - lam0 I) c = 0: take the larger row for stability.
    row0 = m00.abs() >= m11.abs()
    cu = torch.where(row0, -m01, m11)
    ct = torch.where(row0, m00, -m01)
    degen = cu * cu + ct * ct <= _TINY                     # M ~ lam0 I
    cu = torch.where(degen, torch.ones_like(cu), cu)
    ct = torch.where(degen, torch.zeros_like(ct), ct)
    v0 = _normalize(cu[..., None] * u + ct[..., None] * t, u)
    v1 = _cross(v2, v0)

    vecs = torch.stack([v0, v1, v2], dim=-1)               # columns = vecs
    # Rayleigh-quotient refinement: the trigonometric eigenvalues carry
    # ~1e-4-relative error near multiple roots (acos conditioning); v^T A v
    # is quadratically accurate in the vector error.
    av = a @ vecs
    w = (vecs * av).sum(-2)
    return w, vecs
