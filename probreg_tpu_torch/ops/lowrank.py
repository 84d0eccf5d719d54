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


def _sqdist(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Squared distances of one cloud pair (M, D), (N, D) or of a batch of
    pairs (B, M, D), (B, N, D), each pair centred on its own joint mean."""
    return pairwise.sqdist(a, b) if a.dim() == 2 else \
        pairwise.sqdist_batch(a, b)


def landmark_indices(m_valid: torch.Tensor, ell: int,
                     masked: bool = True) -> torch.Tensor:
    """(..., ell) landmark rows over the first ``m_valid`` (...,) points of
    each cloud: the reference's jitted stride in float32, rounded half to
    even (reference lowrank.py:66, :74-75). jnp.linspace's steps are
    i / (ell - 1), which XLA computes as i * (1 / (ell - 1)), the last step
    exactly 1. The ragged stride (``masked``) multiplies each step by the
    traced count m_valid - 1 (floored at 0); the unmasked one,
    linspace(0, m - 1, ell), has constant factors, which XLA folds into one
    before it multiplies i: i * ((m - 1) * (1 / (ell - 1))). Both packages
    pick the same rows only if they round the same products."""
    dev = m_valid.device
    i = torch.arange(ell, dtype=torch.float32, device=dev)
    inv = torch.tensor(1.0, dtype=torch.float32, device=dev) \
        / float(max(ell - 1, 1))
    span = torch.clamp(m_valid.to(torch.float32) - 1.0, min=0.0)[..., None]
    pos = (i * inv) * span if masked else i * (span * inv)
    if ell > 1:
        pos = torch.cat([pos[..., :-1], span], dim=-1)
    return torch.round(pos).long()


def nystrom_eig(points: torch.Tensor, kernel_fn, rank: int,
                oversample: float = 2.0, valid=None, max_landmarks=None):
    """Rank-``rank`` eigenfactorization G ~= U diag(lam) U^T of a Gram
    matrix (reference lowrank.py:39), of one cloud (M, D) or of each cloud
    of a batch (B, M, D).

    ``kernel_fn(a, b) -> (..., len(a), len(b))`` must be a PSD kernel map.
    Returns ``(u, lam)``: ``u`` (..., M, rank) orthonormal and ``lam``
    (..., rank) nonnegative, descending. ``ceil(oversample * rank)``
    landmarks are used and the SVD truncated back to ``rank``. The M x M
    matrix is never formed.

    Ragged padding: ``valid`` (..., M) 0/1 marks each cloud's true points,
    which come first (``utils.interop.pad_ragged``); the landmarks stride
    over them only, and the padded rows of phi are zeroed before the SVD,
    so ``u`` is exactly zero there. ``max_landmarks`` caps the landmark
    count (a ragged batch passes its smallest true count: a stride over
    fewer points than landmarks would repeat rows).
    """
    m = points.shape[-2]
    rank = min(int(rank), m)
    ell = min(int(math.ceil(rank * oversample)), m)
    if max_landmarks is not None:
        ell = min(ell, int(max_landmarks))
    m_valid = valid.sum(-1) if valid is not None else torch.full(
        points.shape[:-2], float(m), device=points.device)
    idx = landmark_indices(m_valid, ell, masked=valid is not None)
    landmarks = torch.take_along_dim(points, idx[..., None], dim=-2)
    kmk = kernel_fn(points, landmarks)                     # (..., M, L)
    kkk = kernel_fn(landmarks, landmarks)                  # (..., L, L)
    e, v = torch.linalg.eigh(kkk)
    # Floor tiny or negative eigenvalues (duplicate landmarks, flat
    # kernels): those directions get a negligible weight in phi, not an
    # exploding one (reference lowrank.py:79-83).
    e = torch.maximum(e, _EPS * e.amax(-1, keepdim=True))
    phi = kmk @ (v / torch.sqrt(e)[..., None, :])         # G ~= phi phi^T
    if valid is not None:
        phi = phi * valid[..., None]
    u, s, _ = torch.linalg.svd(phi, full_matrices=False)
    return u[..., :rank], (s * s)[..., :rank]


def lowrank_rbf(points: torch.Tensor, beta: float, rank: int):
    """Low-rank factors of the RBF Gram matrix exp(-|x-y|^2 / (2 beta))."""
    return nystrom_eig(
        points, lambda a, b: torch.exp(-_sqdist(a, b) / (2.0 * beta)), rank)


def lowrank_imq(points: torch.Tensor, c: float, rank: int, valid=None,
                max_landmarks=None):
    """Low-rank factors of the inverse-multiquadric Gram matrix (BCPD's G),
    of one cloud or of each cloud of a batch (see :func:`nystrom_eig`)."""
    return nystrom_eig(
        points, lambda a, b: 1.0 / torch.sqrt(_sqdist(a, b) + c), rank,
        valid=valid, max_landmarks=max_landmarks)


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


# torch's batched CUDA solve of (M, M) systems with M right-hand sides
# beat solving them one at a time at 16 x 734 (2.1x), 16 x 1,468 (1.4x)
# and 40 x 734 (3.8x), and lost at 4 x 2,000 (2.1x slower; chip_smoke.py
# log_solve_shapes, NVIDIA H100 80GB HBM3 at 700 W). Above this many rows
# the systems go one at a time.
BATCHED_SOLVE_MAX_ROWS = 1600


def solve(a: torch.Tensor, b: torch.Tensor, rows=None) -> torch.Tensor:
    """X with a X = b over broadcast leading axes, without the check for a
    singular matrix: on a CUDA device that check waits for the card, and
    jnp.linalg.solve returns what the factorization gives. The systems go
    one at a time on the CPU, where torch's batched LU (MKL, several
    threads) has stopped on well-conditioned batches of 184 x 184 systems
    with "Parameter 6 was incorrect on entry to SLASWP", and on a CUDA
    device above BATCHED_SOLVE_MAX_ROWS rows. ``rows``: optional host
    flags over the flattened leading axes; a system one at a time whose
    flag is False is not solved, its ``b`` is returned (the caller
    discards it)."""
    batched = a.is_cuda and a.shape[-1] <= BATCHED_SOLVE_MAX_ROWS
    if batched or (a.dim() == 2 and b.dim() == 2):
        return torch.linalg.solve_ex(a, b)[0]
    lead = torch.broadcast_shapes(a.shape[:-2], b.shape[:-2])
    flat_a = a.expand(lead + a.shape[-2:]).reshape((-1,) + a.shape[-2:])
    flat_b = b.expand(lead + b.shape[-2:]).reshape((-1,) + b.shape[-2:])
    rows = [True] * len(flat_a) if rows is None else rows
    return torch.stack([torch.linalg.solve_ex(x, y)[0] if go else y
                        for x, y, go in zip(flat_a, flat_b, rows)]).reshape(
        lead + b.shape[-2:])


def _lead(x, n: int):
    """A tensor ``x`` with ``n`` trailing axes added, to broadcast over the
    trailing axes of batched operands; Python numbers as they are."""
    return x[(...,) + (None,) * n] if isinstance(x, torch.Tensor) else x


def regularized_sigma(u, lam, nu, c, lmd):
    """Low-rank core of Sigma = (lmd I + c G diag(nu))^-1 G for BCPD
    (reference lowrank.py:138), of one cloud or of a batch: ``u`` (..., M,
    K), ``lam`` (..., K), ``nu`` (..., M), ``c`` and ``lmd`` numbers or
    tensors of the leading shape.

    With G ~= U L U^T, Sigma ~= (1/lmd) U S U^T, S = L - c M^-1 L C L,
    C = U^T diag(nu) U, M = lmd I + c L C. Returns the symmetrized (..., K,
    K) core S and diag(Sigma) (..., M), all the VI update consumes.
    """
    k = lam.shape[-1]
    cmat = (u * nu[..., None]).transpose(-1, -2) @ u      # (..., K, K)
    eye = torch.eye(k, dtype=u.dtype, device=u.device)
    mk = _lead(lmd, 2) * eye + _lead(c, 2) * lam[..., :, None] * cmat
    s_core = torch.diag_embed(lam) - _lead(c, 2) * solve(
        mk, lam[..., :, None] * cmat * lam[..., None, :])
    s_core = 0.5 * (s_core + s_core.transpose(-1, -2))
    sigma_diag = ((u @ s_core) * u).sum(-1) / _lead(lmd, 1)
    return s_core, sigma_diag
