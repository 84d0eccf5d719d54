"""Low-rank (Nystrom) kernel factorizations and Woodbury solves.

Counterpart of probreg_tpu/ops/lowrank.py. A smooth Gram matrix (RBF,
inverse multiquadric) is factored once as G ~= U diag(lam) U^T with U
orthonormal (M x K); every per-iteration solve then collapses to a K x K
system through the Woodbury identity

    (c I + diag(d) U L U^T)^-1 r
        = (r - diag(d) U (c I_K + L U^T diag(d) U)^-1 L U^T r) / c,

so BCPD's Sigma update needs O(M K) memory and work instead of two M x M
inverses (reference bcpd.py:114,130-131). Plain tensor code: the skinny
products go to ``torch.matmul``, the small factorizations to
``torch.linalg``.

Landmarks are a deterministic uniform stride over the points, as in the
reference, so both packages pick the same landmarks.
"""

from __future__ import annotations

import math

import torch

from . import pairwise

_EPS = 1e-7


def nystrom_eig(points: torch.Tensor, kernel_fn, rank: int,
                oversample: float = 2.0):
    """Rank-``rank`` eigenfactorization G ~= U diag(lam) U^T of a Gram
    matrix (reference lowrank.py:39).

    ``kernel_fn(a, b) -> (len(a), len(b))`` must be a PSD kernel map.
    Returns ``(u, lam)``: ``u`` (M, rank) orthonormal and ``lam`` (rank,)
    nonnegative, descending. ``ceil(oversample * rank)`` landmarks are used
    and the SVD truncated back to ``rank``. The M x M matrix is never formed.
    """
    m = points.shape[0]
    rank = min(int(rank), m)
    ell = min(int(math.ceil(rank * oversample)), m)
    idx = torch.round(torch.linspace(0.0, m - 1.0, ell,
                                     dtype=torch.float64)).long()
    landmarks = points[idx.to(points.device)]
    kmk = kernel_fn(points, landmarks)                     # (M, L)
    kkk = kernel_fn(landmarks, landmarks)                  # (L, L)
    e, v = torch.linalg.eigh(kkk)
    # Floor tiny or negative eigenvalues (duplicate landmarks, flat
    # kernels): those directions get a negligible weight in phi, not an
    # exploding one (reference lowrank.py:79-83).
    e = torch.maximum(e, _EPS * e.max())
    phi = kmk @ (v / torch.sqrt(e)[None, :])               # G ~= phi phi^T
    u, s, _ = torch.linalg.svd(phi, full_matrices=False)
    return u[:, :rank], (s * s)[:rank]


def lowrank_rbf(points: torch.Tensor, beta: float, rank: int):
    """Low-rank factors of the RBF Gram matrix exp(-|x-y|^2 / (2 beta))."""
    return nystrom_eig(
        points, lambda a, b: pairwise.rbf_kernel(a, b, beta), rank)


def lowrank_imq(points: torch.Tensor, c: float, rank: int):
    """Low-rank factors of the inverse-multiquadric Gram matrix (BCPD's G)."""
    return nystrom_eig(
        points, lambda a, b: pairwise.inverse_multiquadric_kernel(a, b, c),
        rank)


def woodbury_coeffs(u, lam, d, c, rhs):
    """Spectral coefficients zc = diag(lam) U^T X of the solution X of
    (c I + diag(d) U diag(lam) U^T) X = rhs (reference lowrank.py:108).

    With Z = U^T X the system is (c I + C diag(lam)) Z = U^T rhs,
    C = U^T diag(d) U, and G X = U zc; X itself, whose back-substitution
    cancels catastrophically for large ``d``, is never formed."""
    k = lam.shape[0]
    udu = (u * d[:, None]).T @ u                           # (K, K)
    mk = c * torch.eye(k, dtype=u.dtype, device=u.device) + udu * lam[None, :]
    z = torch.linalg.solve(mk, u.T @ rhs)                  # (K, D)
    return lam[:, None] * z


def woodbury_solve(u, lam, d, c, rhs):
    """Solve (c I + diag(d) U diag(lam) U^T) X = rhs for (M, D) ``rhs``;
    only a K x K system is solved. Prefer :func:`woodbury_coeffs` when only
    G X is needed."""
    zc = woodbury_coeffs(u, lam, d, c, rhs)
    return (rhs - d[:, None] * (u @ zc)) / c


def regularized_sigma(u, lam, nu, c, lmd):
    """Low-rank core of Sigma = (lmd I + c G diag(nu))^-1 G for BCPD
    (reference lowrank.py:138).

    With G ~= U L U^T, Sigma ~= (1/lmd) U S U^T, S = L - c M^-1 L C L,
    C = U^T diag(nu) U, M = lmd I + c L C. Returns the symmetrized (K, K)
    core S and diag(Sigma) (M,), all the VI update consumes."""
    k = lam.shape[0]
    cmat = (u * nu[:, None]).T @ u                         # (K, K)
    mk = lmd * torch.eye(k, dtype=u.dtype, device=u.device) \
        + c * lam[:, None] * cmat
    s_core = torch.diag(lam) - c * torch.linalg.solve(
        mk, lam[:, None] * cmat * lam[None, :])
    s_core = 0.5 * (s_core + s_core.T)
    sigma_diag = ((u @ s_core) * u).sum(1) / lmd
    return s_core, sigma_diag
