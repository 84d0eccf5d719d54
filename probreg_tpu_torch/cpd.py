"""Coherent Point Drift: rigid, affine, nonrigid and constrained nonrigid
(counterpart of probreg_tpu/cpd.py).

``registration_cpd(source, target, "rigid" | "affine")`` splits by size as
the reference does:

* a 3-D pair of up to ``config.fused_em_max_pairs`` pairs M * N with the
  default start: the whole EM in one launch of the whole-EM kernel
  (ops/em_cuda.py);
* up to ``config.transposed_em_max_pairs``: the whole-EM dense loop
  ``_run_em_t``, which holds the (M, N) posterior;
* above it: the streaming loop ``_run_em``. Both clouds are centred on
  their joint centroid and, from ``config.culled_estep_min_pairs`` on,
  Morton-sorted once, so every E-step goes through the tile-culled kernels
  (ops/estep_cuda.py) with no per-iteration sort.

``"nonrigid"`` and ``"nonrigid_constrained"`` (Extended CPD, with
correspondence priors) run the streaming loop ``_run_em`` on centred,
never sorted clouds (their Gram matrix, Nystrom basis and priors are
row-aligned with the caller's source): each iteration is one
``estep_ops.estep`` (one launch of the small E-step kernel K2 for M * N
up to ``config.small_estep_max_pairs`` on the card) and an M x M solve,
or with ``rank=`` a K x K Woodbury solve. ``NonRigidCPD`` with ``rank=``
runs the whole EM in the low-rank loop ``_run_em_nonrigid_lowrank_t``
(plain tensors, its E-step blocked over ``config.estep_chunk`` targets),
as the reference does.

``registration_cpd_batch`` registers B rigid or affine pairs, fixed-size
or ragged, in one launch of the whole-EM kernel where the pairs fit it.

``use_pallas`` keeps the reference's name: None picks the kernels as above,
False runs plain tensors only (no hand-written kernel anywhere on the
path), True pins the streaming E-steps to the two-pass kernels. The
nonrigid steps honour it too, where the reference's ignore it; the two
differ only in summation order.

The plain EM loops are Python loops that read q once per iteration for the
|q - q_prev| < tol test (sigma2 for the nonrigid kinds). Callbacks and
multistart come with a later slice of the port (ROADMAP, Queue 1 item 13).
"""

from __future__ import annotations

import abc
import math
from collections import namedtuple
from functools import partial
from typing import Callable, Dict, List, Optional

import torch

from . import config as _config
from .models import transformation as tf
from .ops import estep as estep_ops
from .ops import lowrank
from .ops.estep import EstepMoments
from .utils import interop
from .utils import math_utils as mu

EstepResult = namedtuple("EstepResult", ["pt1", "p1", "px", "n_p"])
MstepResult = namedtuple("MstepResult", ["transformation", "sigma2", "q"])
MstepResult.__doc__ = """Result of Maximization step.

    Attributes:
        transformation (tf.Transformation): Transformation from source to target.
        sigma2 (float): Variance of Gaussian distribution.
        q (float): Result of likelihood.
"""

_F32_EPS = float(torch.finfo(torch.float32).eps)


def _svd_rotation(a: torch.Tensor) -> torch.Tensor:
    """Nearest rotation to ``a`` from its SVD, with the det-sign fix."""
    u, _, vh = torch.linalg.svd(a)
    c = torch.ones(a.shape[0], dtype=a.dtype, device=a.device)
    c[-1] = torch.linalg.det(u @ vh)
    return (u * c) @ vh


def _rigid_sigma2_q(tr_xp1x, tr_atr, tr_yp1y, n_p, dim, update_scale):
    """Scale, sigma2 and q of the rigid M-step (reference cpd.py:160-192,
    with the CPD-paper -2 tr_atr term in the fixed-scale branch as the JAX
    package uses)."""
    if update_scale:
        scale = tr_atr / tr_yp1y
        sigma2 = (tr_xp1x - scale * tr_atr) / (n_p * dim)
    else:
        scale = torch.ones_like(tr_atr)
        sigma2 = (tr_xp1x - 2.0 * scale * tr_atr + tr_yp1y) / (n_p * dim)
    sigma2 = torch.clamp(sigma2, min=_F32_EPS)
    q = (tr_xp1x - 2.0 * scale * tr_atr + scale ** 2 * tr_yp1y) / (2.0 * sigma2)
    q = q + dim * n_p * 0.5 * torch.log(sigma2)
    return scale, sigma2, q


def rigid_maximization_step(source, mom: EstepMoments,
                            update_scale: bool = True) -> MstepResult:
    """Weighted-mean centring + D x D SVD with det-sign fix (cpd.py:160-192).

    ``tr_xp1x`` uses sum_j pt1_j x_j == colsum(px), so it reduces to
    ``xx - n_p |mu_x|^2``: no pt1 vector is needed.
    """
    p1, px, n_p, xx = mom.p1, mom.px, mom.n_p, mom.xx
    dim = source.shape[1]
    mu_x = px.sum(0) / n_p
    mu_y = source.T @ p1 / n_p
    source_hat = source - mu_y
    a = px.T @ source_hat - torch.outer(mu_x, p1 @ source_hat)
    rot = _svd_rotation(a)
    tr_atr = torch.trace(a.T @ rot)
    tr_yp1y = (p1 * (source_hat * source_hat).sum(1)).sum()
    tr_xp1x = xx - n_p * (mu_x * mu_x).sum()
    scale, sigma2, q = _rigid_sigma2_q(tr_xp1x, tr_atr, tr_yp1y, n_p, dim,
                                       update_scale)
    t = mu_x - scale * rot @ mu_y
    return MstepResult(tf.RigidTransformation(rot, t, scale,
                                              device=source.device),
                       sigma2, q)


def _affine_sigma2_q(tr_xp1x, tr_ab, n_p, dim):
    sigma2 = torch.clamp((tr_xp1x - tr_ab) / (n_p * dim), min=_F32_EPS)
    q = (tr_xp1x - tr_ab) / (2.0 * sigma2) + dim * n_p * 0.5 * torch.log(sigma2)
    return sigma2, q


def affine_maximization_step(source, mom: EstepMoments) -> MstepResult:
    """Linear solve yp1y^T B^T = a^T (reference cpd.py:219-244)."""
    p1, px, n_p, xx = mom.p1, mom.px, mom.n_p, mom.xx
    mu_x = px.sum(0) / n_p
    mu_y = source.T @ p1 / n_p
    source_hat = source - mu_y
    a = px.T @ source_hat - torch.outer(mu_x, p1 @ source_hat)
    yp1y = (source_hat.T * p1) @ source_hat
    b = torch.linalg.solve(yp1y.T, a.T).T
    t = mu_x - b @ mu_y
    tr_xp1x = xx - n_p * (mu_x * mu_x).sum()
    sigma2, q = _affine_sigma2_q(tr_xp1x, torch.trace(a @ b.T), n_p,
                                 source.shape[1])
    return MstepResult(tf.AffineTransformation(b, t, device=source.device),
                       sigma2, q)


def _nonrigid_sigma2(source, mom: EstepMoments, t):
    """sigma2 of a nonrigid M-step from the moved source ``t``, floored at
    f32 eps: on clean 1:1 clouds it anneals to the f32 cancellation scale
    and could come out <= 0."""
    tr_pxt = (mom.px * t).sum()
    tr_tpt = (mom.p1 * (t * t).sum(1)).sum()
    return torch.clamp((mom.xx - 2.0 * tr_pxt + tr_tpt)
                       / (mom.n_p * source.shape[1]), min=_F32_EPS)


def nonrigid_maximization_step(source, mom: EstepMoments, g, lmd,
                               sigma2_p) -> MstepResult:
    """Solve ((p1 . G) + lmd sigma2_p I) W = PX - p1 . Y, an M x M system
    (reference cpd.py:123). q is sigma2."""
    m = source.shape[0]
    lhs = (mom.p1 * g).T + lmd * sigma2_p * torch.eye(
        m, dtype=g.dtype, device=g.device)
    w = torch.linalg.solve(lhs, mom.px - source * mom.p1[:, None])
    sigma2 = _nonrigid_sigma2(source, mom, source + g @ w)
    return MstepResult(tf.NonRigidTransformation(w, g=g,
                                                 device=source.device),
                       sigma2, sigma2)


def nonrigid_lowrank_maximization_step(source, mom: EstepMoments, u, lam,
                                       lmd, sigma2_p, d_extra=None,
                                       rhs_extra=None) -> MstepResult:
    """The nonrigid M-step with G ~= U diag(lam) U^T: one K x K Woodbury
    solve (ops/lowrank.woodbury_coeffs; reference cpd.py:142).
    ``d_extra`` / ``rhs_extra`` carry the constrained model's prior terms:
    d = p1 + d_extra, rhs += rhs_extra. q is sigma2."""
    d = mom.p1 if d_extra is None else mom.p1 + d_extra
    rhs = mom.px - source * mom.p1[:, None]
    if rhs_extra is not None:
        rhs = rhs + rhs_extra
    zc = lowrank.woodbury_coeffs(u, lam, d, lmd * sigma2_p, rhs)
    sigma2 = _nonrigid_sigma2(source, mom, source + u @ zc)
    return MstepResult(tf.LowRankNonRigidTransformation(
        zc, u, lam, device=source.device), sigma2, sigma2)


def constrained_nonrigid_maximization_step(source, mom: EstepMoments, g,
                                           lmd, sigma2_p, alpha, p1_tilde,
                                           px_tilde) -> MstepResult:
    """The nonrigid M-step with correspondence priors of reliability
    ``alpha`` (reference cpd.py:169): an M x M system. q is sigma2."""
    m = source.shape[0]
    s2a = sigma2_p / alpha
    lhs = (mom.p1 * g).T + s2a * (p1_tilde * g).T + lmd * sigma2_p \
        * torch.eye(m, dtype=g.dtype, device=g.device)
    rhs = mom.px - source * mom.p1[:, None] \
        + s2a * (px_tilde - source * p1_tilde[:, None])
    w = torch.linalg.solve(lhs, rhs)
    sigma2 = _nonrigid_sigma2(source, mom, source + g @ w)
    return MstepResult(tf.NonRigidTransformation(w, g=g,
                                                 device=source.device),
                       sigma2, sigma2)


# --------------------------------------------------------------------------
# Whole-EM dense loop in transposed (D, M) layout
# --------------------------------------------------------------------------

def _estep_t(t_src_t, xs_t, xs_ext, x2, sigma2, w, kmask=None, m_eff=None,
             n_eff=None):
    """Dense E-step: (pt1 (N,), p1 (M,), px_t (D, M), n_p, xx).

    ``kmask`` / ``m_eff`` / ``n_eff``: ragged-batch padding. Padded rows
    and columns are zeroed out of the kernel matrix, so they carry no mass
    anywhere downstream, and the outlier constant uses the true counts.
    """
    dim, m = t_src_t.shape
    n = xs_t.shape[1]
    if m_eff is None:
        m_eff, n_eff = m, n
    c = estep_ops.outlier_constant(sigma2, w, m_eff, n_eff, dim)
    y2 = (t_src_t * t_src_t).sum(0)[:, None]                 # (M, 1)
    xy = t_src_t.T @ xs_t                                    # (M, N)
    g = torch.exp(-torch.clamp(y2 + x2 - 2.0 * xy, min=0.0) / (2.0 * sigma2))
    if kmask is not None:
        g = g * kmask
    den_raw = g.sum(0, keepdim=True)                         # (1, N)
    den = torch.where(den_raw == 0.0, _F32_EPS, den_raw) + c
    pt1 = (den_raw / den)[0]
    pxp = xs_ext @ (g / den).T                               # (D + 1, M)
    px_t, p1 = pxp[:dim], pxp[dim]
    return pt1, p1, px_t, p1.sum(), (pt1 * x2[0]).sum()


def _rigid_mstep_t(ys_t, p1, px_t, n_p, xx, update_scale):
    """rigid_maximization_step in (D, M) layout."""
    dim = ys_t.shape[0]
    mu_x = px_t.sum(1) / n_p
    mu_y = ys_t @ p1 / n_p
    src_hat = ys_t - mu_y[:, None]
    a = px_t @ src_hat.T - torch.outer(mu_x, src_hat @ p1)
    rot = _svd_rotation(a)
    tr_atr = torch.trace(a.T @ rot)
    tr_yp1y = (p1 * (src_hat * src_hat).sum(0)).sum()
    tr_xp1x = xx - n_p * (mu_x * mu_x).sum()
    scale, sigma2, q = _rigid_sigma2_q(tr_xp1x, tr_atr, tr_yp1y, n_p, dim,
                                       update_scale)
    t = mu_x - scale * rot @ mu_y
    return rot, t, scale, sigma2, q


def _affine_mstep_t(ys_t, p1, px_t, n_p, xx):
    """affine_maximization_step in (D, M) layout."""
    mu_x = px_t.sum(1) / n_p
    mu_y = ys_t @ p1 / n_p
    src_hat = ys_t - mu_y[:, None]
    a = px_t @ src_hat.T - torch.outer(mu_x, src_hat @ p1)
    yp1y = (src_hat * p1[None, :]) @ src_hat.T
    b = torch.linalg.solve(yp1y.T, a.T).T
    t = mu_x - b @ mu_y
    tr_xp1x = xx - n_p * (mu_x * mu_x).sum()
    sigma2, q = _affine_sigma2_q(tr_xp1x, torch.trace(a @ b.T), n_p,
                                 ys_t.shape[0])
    return b, t, sigma2, q


def _converged(i: int, q: torch.Tensor, q_prev: float, maxiter: int,
               tol: float):
    """Loop test of the reference: at least one iteration, at most maxiter,
    go on while |q - q_prev| >= tol (a NaN q stops the loop, as there).
    Reads q to the host once; returns (done, q as a float)."""
    qv = float(q)
    return not (i < maxiter and (i == 0 or abs(qv - q_prev) >= tol)), qv


def _run_em_t(source, target, init=None, *, kind="rigid", w, maxiter, tol,
              update_scale=True, smask=None, tmask=None, sigma2_init=None):
    """Whole-EM loop in (D, M) layout with the dense posterior (rigid or
    affine).

    ``init``: optional packed (D*D + D + 1,) [lin, t, scale] start in the
    raw frame. ``smask`` / ``tmask``: optional (M,) / (N,) 0/1 validity
    masks (ragged-batch padding): padded points carry no mass and every
    normalizer uses the true counts, which is the registration of the pair
    without its padding. ``sigma2_init``: optional starting variance (else
    the closed-form squared_kernel_sum). Returns (lin, t, scale, sigma2, q)
    with lin = R for "rigid" and B (scale 1) for "affine".
    """
    if kind not in ("rigid", "affine"):
        raise ValueError(f"_run_em_t runs 'rigid' or 'affine', not {kind!r}")
    ys_t, xs_t = source.T, target.T
    dim, m = ys_t.shape
    n = xs_t.shape[1]
    masked = smask is not None
    # Shared-centroid centring: EM is translation invariant and the
    # expanded-form f32 d2 loses ~|x|^2 eps to cancellation.
    if masked:
        m_eff, n_eff = smask.sum(), tmask.sum()
        cen = (ys_t @ smask + xs_t @ tmask) / torch.clamp(m_eff + n_eff,
                                                          min=1.0)
        kmask = smask[:, None] * tmask[None, :]
    else:
        m_eff, n_eff, kmask = None, n, None
        cen = (ys_t.sum(1) + xs_t.sum(1)) / (m + n)
    ys_t = ys_t - cen[:, None]
    xs_t = xs_t - cen[:, None]
    if init is None:
        lin = torch.eye(dim, dtype=source.dtype, device=source.device)
        t = torch.zeros(dim, dtype=source.dtype, device=source.device)
        scale = torch.ones((), dtype=source.dtype, device=source.device)
    else:
        init = torch.as_tensor(init, dtype=source.dtype, device=source.device)
        lin = init[:dim * dim].reshape(dim, dim)
        scale = init[dim * dim + dim]
        # Raw-frame start -> centred frame: x - c = s L (y - c) + (t + s L c - c).
        t = init[dim * dim:dim * dim + dim] + scale * lin @ cen - cen
    if sigma2_init is not None:
        sigma2 = torch.clamp(torch.as_tensor(sigma2_init, dtype=source.dtype,
                                             device=source.device),
                             min=_F32_EPS)
    elif masked:
        sigma2 = mu.masked_squared_kernel_sum_t(ys_t, xs_t, smask, tmask)
    else:
        sy, sx = ys_t.sum(1), xs_t.sum(1)
        sigma2 = (n * (ys_t * ys_t).sum() + m * (xs_t * xs_t).sum()
                  - 2.0 * sy @ sx) / (m * dim * n)
    q = 1.0 + n_eff * dim * 0.5 * torch.log(sigma2)
    x2 = (xs_t * xs_t).sum(0, keepdim=True)                  # (1, N)
    xs_ext = torch.cat([xs_t, torch.ones_like(xs_t[:1])])    # (D + 1, N)
    q_prev, i = math.inf, 0
    while True:
        done, q_prev_next = _converged(i, q, q_prev, maxiter, tol)
        if done:
            break
        t_src = scale * lin @ ys_t + t[:, None]
        _, p1, px_t, n_p, xx = _estep_t(t_src, xs_t, xs_ext, x2, sigma2, w,
                                        kmask, m_eff, n_eff if masked else None)
        if kind == "rigid":
            lin, t, scale, sigma2, q = _rigid_mstep_t(ys_t, p1, px_t, n_p, xx,
                                                      update_scale)
        else:
            lin, t, sigma2, q = _affine_mstep_t(ys_t, p1, px_t, n_p, xx)
        q_prev, i = q_prev_next, i + 1
    # Centred -> raw frame: x = s L y + (t_c + c - s L c).
    t = t + cen - scale * lin @ cen
    return lin, t, scale, sigma2, q


def _stack_runs(runs):
    return tuple(torch.stack(parts) for parts in zip(*runs))


def _run_em_t_batch(sources, targets, *, kind, w, maxiter, tol,
                    update_scale=True):
    """``_run_em_t`` over a (B, M, D) x (B, N, D) batch, pair by pair (each
    pair stops at its own iteration): stacked (lin, t, scale, sigma2, q)."""
    return _stack_runs([
        _run_em_t(s, t, kind=kind, w=w, maxiter=maxiter, tol=tol,
                  update_scale=update_scale)
        for s, t in zip(sources, targets)])


def _run_em_t_ragged_batch(sources, targets, smasks, tmasks, *, kind, w,
                           maxiter, tol, update_scale=True):
    """``_run_em_t`` over a padded batch with (B, M) / (B, N) masks."""
    return _stack_runs([
        _run_em_t(s, t, kind=kind, w=w, maxiter=maxiter, tol=tol,
                  update_scale=update_scale, smask=sm, tmask=tm)
        for s, t, sm, tm in zip(sources, targets, smasks, tmasks)])


def _run_em_nonrigid_lowrank_t(source, target, u, lam, lmd, *, w, maxiter,
                               tol, block=None, zc_init_t=None,
                               sigma2_init=None):
    """Whole-EM low-rank nonrigid loop in (D, M) layout (reference
    cpd.py:396).

    The E-step is dense and plain (the reference's is XLA too), blocked
    over ``block`` target columns (default ``config.estep_chunk``): a
    column's normalizer is complete within its block, so peak memory is
    O(M * block) at any N; the last block is padded with masked columns.
    The M-step is the K x K Woodbury solve. Both clouds are centred on
    their joint centroid (the displacement U zc is translation invariant,
    so nothing converts back). ``zc_init_t`` (D, K) and ``sigma2_init``
    are warm starts. Stops when |sigma2 - sigma2_prev| < tol, at most
    ``maxiter`` iterations, one host read of sigma2 per iteration.
    Returns (zc_t (D, K), sigma2, q = sigma2).
    """
    ys_t, xs_t = source.T, target.T
    dim, m = ys_t.shape
    n = xs_t.shape[1]
    k = lam.shape[0]
    cen = (ys_t.sum(1) + xs_t.sum(1)) / (m + n)
    ys_t = ys_t - cen[:, None]
    xs_t = xs_t - cen[:, None]
    if sigma2_init is not None:
        sigma2 = torch.clamp(torch.as_tensor(sigma2_init, dtype=source.dtype,
                                             device=source.device),
                             min=_F32_EPS)
    else:
        sy, sx = ys_t.sum(1), xs_t.sum(1)
        sigma2 = (n * (ys_t * ys_t).sum() + m * (xs_t * xs_t).sum()
                  - 2.0 * sy @ sx) / (m * dim * n)
    x2 = (xs_t * xs_t).sum(0, keepdim=True)                  # (1, N)
    xs_ext = torch.cat([xs_t, torch.ones_like(x2)])          # (D + 1, N)
    eye_k = torch.eye(k, dtype=source.dtype, device=source.device)
    block = max(min(int(_config.config.estep_chunk if block is None
                        else block), n), 1)
    pad = (-n) % block
    cmask = torch.cat([torch.ones_like(x2), x2.new_zeros((1, pad))], 1)
    xs_p, xe_p, x2_p = (torch.cat([a, a.new_zeros((a.shape[0], pad))], 1)
                        for a in (xs_t, xs_ext, x2))

    def estep_cols(t_src_t, y2, sigma2, c, s0):
        cols = slice(s0, s0 + block)
        mask_b, x2_b = cmask[:, cols], x2_p[:, cols]
        xy = t_src_t.T @ xs_p[:, cols]                       # (M, B)
        g = torch.exp(-torch.clamp(y2 + x2_b - 2.0 * xy, min=0.0)
                      / (2.0 * sigma2)) * mask_b
        den_raw = g.sum(0, keepdim=True)
        den = torch.where(den_raw == 0.0, _F32_EPS, den_raw) + c
        pt1 = mask_b * den_raw / den
        return xe_p[:, cols] @ (g / den).T, (pt1 * x2_b).sum()

    zc_t = (torch.zeros((dim, k), dtype=source.dtype, device=source.device)
            if zc_init_t is None
            else torch.as_tensor(zc_init_t, dtype=source.dtype,
                                 device=source.device))
    q, q_prev, i = math.inf, math.inf, 0
    while True:
        done, q_prev_next = _converged(i, q, q_prev, maxiter, tol)
        if done:
            break
        t_src_t = ys_t + zc_t @ u.T                          # (D, M)
        y2 = (t_src_t * t_src_t).sum(0)[:, None]
        c = estep_ops.outlier_constant(sigma2, w, m, n, dim)
        pxp = ys_t.new_zeros((dim + 1, m))
        xx = ys_t.new_zeros(())
        for s0 in range(0, n + pad, block):
            pxp_b, xx_b = estep_cols(t_src_t, y2, sigma2, c, s0)
            pxp, xx = pxp + pxp_b, xx + xx_b
        px_t, p1 = pxp[:dim], pxp[dim]
        n_p = p1.sum()
        # M-step: the Woodbury coefficients in (D, K) layout.
        rhs_t = px_t - ys_t * p1[None, :]
        mk = lmd * sigma2 * eye_k + ((u * p1[:, None]).T @ u) * lam[None, :]
        zc_t = torch.linalg.solve(mk, (rhs_t @ u).T).T * lam[None, :]
        t_t = ys_t + zc_t @ u.T
        tr_pxt = (px_t * t_t).sum()
        tr_tpt = (p1 * (t_t * t_t).sum(0)).sum()
        sigma2 = torch.clamp((xx - 2.0 * tr_pxt + tr_tpt) / (n_p * dim),
                             min=_F32_EPS)
        q, q_prev, i = sigma2, q_prev_next, i + 1
    return zc_t, sigma2, torch.as_tensor(q, dtype=source.dtype,
                                         device=source.device)


# --------------------------------------------------------------------------
# Streaming EM
# --------------------------------------------------------------------------

def _rigid_step(source, target, transf, sigma2, aux, w, assume_sorted=False,
                use_pallas=None):
    t_source = transf._transform(source)
    mom = estep_ops.estep(t_source, target, sigma2, w, use_pallas=use_pallas,
                          assume_sorted=assume_sorted)
    return rigid_maximization_step(source, mom, aux["update_scale"])


def _affine_step(source, target, transf, sigma2, aux, w, assume_sorted=False,
                 use_pallas=None):
    t_source = transf._transform(source)
    mom = estep_ops.estep(t_source, target, sigma2, w, use_pallas=use_pallas,
                          assume_sorted=assume_sorted)
    return affine_maximization_step(source, mom)


# The nonrigid steps: the previous iteration's sigma2 is the M-step's
# sigma2_p. Their clouds are never sorted (CoherentPointDrift.registration),
# so assume_sorted is always False; it is taken for one step signature.

def _nonrigid_step(source, target, transf, sigma2, aux, w, assume_sorted=False,
                   use_pallas=None):
    mom = estep_ops.estep(transf._transform(source), target, sigma2, w,
                          use_pallas=use_pallas)
    return nonrigid_maximization_step(source, mom, transf.g, aux["lmd"],
                                      sigma2)


def _constrained_step(source, target, transf, sigma2, aux, w,
                      assume_sorted=False, use_pallas=None):
    mom = estep_ops.estep(transf._transform(source), target, sigma2, w,
                          use_pallas=use_pallas)
    return constrained_nonrigid_maximization_step(
        source, mom, transf.g, aux["lmd"], sigma2, aux["alpha"],
        aux["p1_tilde"], aux["px_tilde"])


def _nonrigid_lowrank_step(source, target, transf, sigma2, aux, w,
                           assume_sorted=False, use_pallas=None):
    mom = estep_ops.estep(transf._transform(source), target, sigma2, w,
                          use_pallas=use_pallas)
    return nonrigid_lowrank_maximization_step(
        source, mom, transf.u, transf.lam, aux["lmd"], sigma2)


def _constrained_prior(source, sigma2, alpha, p1_tilde, px_tilde):
    """The constrained model's (d_extra, rhs_extra) of the low-rank
    M-step."""
    s2a = sigma2 / alpha
    return s2a * p1_tilde, s2a * (px_tilde - source * p1_tilde[:, None])


def _constrained_lowrank_step(source, target, transf, sigma2, aux, w,
                              assume_sorted=False, use_pallas=None):
    mom = estep_ops.estep(transf._transform(source), target, sigma2, w,
                          use_pallas=use_pallas)
    d_extra, rhs_extra = _constrained_prior(
        source, sigma2, aux["alpha"], aux["p1_tilde"], aux["px_tilde"])
    return nonrigid_lowrank_maximization_step(
        source, mom, transf.u, transf.lam, aux["lmd"], sigma2,
        d_extra=d_extra, rhs_extra=rhs_extra)


def _run_em(source, target, tf0, sigma2_0, q0, aux, *, step_fn, w, maxiter,
            tol) -> MstepResult:
    """Streaming EM loop (reference cpd.py:110-119): stop when
    |q_i - q_{i-1}| < tol, at most ``maxiter`` E/M pairs, at least one."""
    transf, sigma2, q = tf0, sigma2_0, q0
    q_prev, i = math.inf, 0
    while True:
        done, q_prev_next = _converged(i, q, q_prev, maxiter, tol)
        if done:
            break
        transf, sigma2, q = step_fn(source, target, transf, sigma2, aux, w)
        q_prev, i = q_prev_next, i + 1
    return MstepResult(transf, sigma2, q)


# --------------------------------------------------------------------------
# Object surface (drop-in for the reference classes)
# --------------------------------------------------------------------------

def _fused_em_ok(m: int, n: int, dim: int, use_pallas) -> bool:
    """The reference's size conditions for the one-launch whole-EM kernel
    (cpd.py:958-963), less its backend test: the wrapper itself runs the
    kernel for CUDA tensors and the plain version for CPU ones."""
    from .ops import em_cuda

    return (dim == 3 and _config.config.use_fused_em
            and use_pallas is not False
            and m * n <= _config.config.fused_em_max_pairs
            and em_cuda.fused_dims_ok(m, n))


class CoherentPointDrift(abc.ABC):
    """Abstract CPD: E-step here, M-step in transform-specific subclasses.

    ``use_cuda`` is accepted for drop-in compatibility and ignored: the
    device is ``device`` (default ``config.device``). ``use_pallas``: see
    the module docstring.
    """

    _STEP: Callable = None
    # Whether the M-step reads the moments through row sums only, so that a
    # consistent permutation of both clouds changes nothing: true for rigid
    # and affine. A nonrigid Gram matrix, Nystrom basis or prior vector is
    # row-aligned with the caller's source, so those clouds are never
    # sorted.
    _ORDER_FREE = False

    def __init__(self, source=None, use_cuda: bool = False,
                 use_pallas: Optional[bool] = None,
                 sigma2_init: Optional[float] = None, device=None):
        del use_cuda
        self._device = _config.resolve_device(device)
        self._source = None if source is None else self._as_points(source)
        self._tf_type = None
        self._use_pallas = use_pallas
        self._sigma2_init = sigma2_init

    def _as_points(self, x) -> torch.Tensor:
        return interop.as_points(x, device=self._device)

    def set_source(self, source):
        self._source = self._as_points(source)

    # ------------------------------------------------------------------ API
    def expectation_step(self, t_source, target, sigma2,
                         w: float = 0.0) -> EstepResult:
        """Reference-shaped E-step (cpd.py:71-88) built from the moments."""
        mom = estep_ops.estep(self._as_points(t_source),
                              self._as_points(target), sigma2, float(w),
                              self._use_pallas)
        return EstepResult(mom.pt1, mom.p1, mom.px, mom.n_p)

    def maximization_step(self, target, estep_res,
                          sigma2_p=None) -> MstepResult:
        """M-step from an E-step's result; ``sigma2_p``, the previous
        variance, is the nonrigid regularizer's (rigid and affine ignore
        it)."""
        mom = self._moments_from_estep(estep_res, self._as_points(target))
        if sigma2_p is not None:
            sigma2_p = torch.as_tensor(sigma2_p, dtype=_config.config.dtype,
                                       device=self._device)
        return self._mstep(self._source, mom, sigma2_p)

    @staticmethod
    def _moments_from_estep(estep_res, target) -> EstepMoments:
        pt1, p1, px, n_p = estep_res
        xx = (pt1 * (target * target).sum(1)).sum()
        return EstepMoments(pt1, p1, px, n_p, xx)

    @abc.abstractmethod
    def _initial_tf(self) -> tf.Transformation:
        ...

    @abc.abstractmethod
    def _mstep(self, source, mom: EstepMoments, sigma2_p) -> MstepResult:
        ...

    def _step_aux(self) -> Dict:
        return {}

    def _step_fn(self) -> Callable:
        return type(self)._STEP

    def _initialize(self, target) -> MstepResult:
        dim = self._source.shape[1]
        if self._sigma2_init is not None:
            sigma2 = torch.clamp(torch.as_tensor(
                self._sigma2_init, dtype=_config.config.dtype,
                device=self._device), min=_F32_EPS)
        else:
            sigma2 = mu.squared_kernel_sum(self._source, target)
        q = 1.0 + target.shape[0] * dim * 0.5 * torch.log(sigma2)
        return MstepResult(self._initial_tf(), sigma2, q)

    def registration(self, target, w: float = 0.0, maxiter: int = 50,
                     tol: float = 0.001) -> MstepResult:
        """Run the EM registration."""
        assert self._tf_type is not None, "transformation type is None."
        target = self._as_points(target)
        fast = self._registration_fast(target, w, maxiter, tol)
        if fast is not None:
            return fast
        # Shared-centroid centring for the streaming loop; the rigid and
        # affine initial parameters convert in and the result converts back.
        cen = ((self._source.sum(0) + target.sum(0))
               / (self._source.shape[0] + target.shape[0]))
        target = target - cen
        source = self._source - cen

        def _tf_to(tr, sign):
            # sign=+1: raw -> centred; sign=-1: centred -> raw. A nonrigid
            # displacement field is translation invariant: unchanged.
            if isinstance(tr, tf.RigidTransformation):
                shift = tr.scale * (tr.rot @ cen) - cen
                return tf.RigidTransformation(tr.rot, tr.t + sign * shift,
                                              tr.scale, device=tr.device)
            if isinstance(tr, tf.AffineTransformation):
                shift = tr.b @ cen - cen
                return tf.AffineTransformation(tr.b, tr.t + sign * shift,
                                               device=tr.device)
            return tr

        # use_pallas False: no hand-written kernel anywhere, the small E-step
        # and the sorted culled branch included. True: the two-pass kernels,
        # on sorted clouds so that their tile culling fires. None: the stash
        # kernels from culled_estep_min_pairs on. Only the order-free
        # families are sorted.
        if self._use_pallas is None:
            presort = (_config.config.use_culled_estep
                       and source.shape[0] * target.shape[0]
                       >= _config.config.culled_estep_min_pairs)
        else:
            presort = bool(self._use_pallas)
        presort = presort and self._ORDER_FREE
        if presort:
            # One Morton sort enables tile culling in every E-step with no
            # per-iteration sort. It runs before _initialize so anything
            # derived from the source shares the permutation.
            from .ops.spatial import morton_order

            source = source[morton_order(source)]
            target = target[morton_order(target)]
        step_fn = partial(self._step_fn(), assume_sorted=presort,
                          use_pallas=self._use_pallas)
        orig_source = self._source
        self._source = source
        try:
            res = self._initialize(target)
            aux = self._step_aux()
        finally:
            self._source = orig_source
        out = _run_em(source, target, _tf_to(res.transformation, +1.0),
                      res.sigma2, res.q, aux, step_fn=step_fn, w=float(w),
                      maxiter=int(maxiter), tol=float(tol))
        return out._replace(transformation=_tf_to(out.transformation, -1.0))

    def _registration_fast(self, target, w, maxiter, tol):
        """Whole-EM paths (one kernel launch, or the dense loop); None
        where neither applies."""
        return None

    def _fused_ok(self, target, has_init: bool) -> bool:
        """The one-launch kernel starts from the identity and sigma2_0."""
        return (not has_init and self._sigma2_init is None
                and _fused_em_ok(self._source.shape[0], target.shape[0],
                                 self._source.shape[1], self._use_pallas))


class RigidCPD(CoherentPointDrift):
    """Rigid CPD (reference cpd.py:123-192)."""

    _STEP = staticmethod(_rigid_step)
    _ORDER_FREE = True

    def __init__(self, source=None, update_scale: bool = True,
                 tf_init_params: Optional[Dict] = None,
                 use_cuda: bool = False, use_pallas: Optional[bool] = None,
                 n_starts: int = 1, sigma2_init: Optional[float] = None,
                 device=None):
        super().__init__(source, use_cuda, use_pallas, sigma2_init, device)
        if int(n_starts) > 1:
            raise NotImplementedError(_NOT_PORTED.format("n_starts > 1"))
        self._tf_type = tf.RigidTransformation
        self._update_scale = update_scale
        self._tf_init_params = dict(tf_init_params or {})
        self._tf_init_params.pop("xp", None)

    def _initial_tf(self):
        dim = self._source.shape[1]
        return tf.RigidTransformation(**self._tf_init_params, dim=dim,
                                      device=self._device)

    def _step_aux(self):
        return {"update_scale": bool(self._update_scale)}

    def _mstep(self, source, mom: EstepMoments, sigma2_p) -> MstepResult:
        return rigid_maximization_step(source, mom, self._update_scale)

    def _registration_fast(self, target, w, maxiter, tol):
        m, n = self._source.shape[0], target.shape[0]
        if m * n > _config.config.transposed_em_max_pairs:
            return None  # the dense posterior would not fit: stream
        args = dict(w=float(w), maxiter=int(maxiter), tol=float(tol),
                    update_scale=bool(self._update_scale))
        if self._fused_ok(target, bool(self._tf_init_params)):
            from .ops import em_cuda

            lin, t, scale, sigma2, q = em_cuda.run_em_rigid_fused(
                self._source, target, **args)
        else:
            init = None
            if self._tf_init_params:
                tr0 = self._initial_tf()
                init = torch.cat([tr0.rot.reshape(-1), tr0.t,
                                  tr0.scale.reshape(1)])
            lin, t, scale, sigma2, q = _run_em_t(
                self._source, target, init, kind="rigid", **args,
                sigma2_init=self._sigma2_init)
        return MstepResult(tf.RigidTransformation(lin, t, scale,
                                                  device=self._device),
                           sigma2, q)


class AffineCPD(CoherentPointDrift):
    """Affine CPD (reference cpd.py:195-244)."""

    _STEP = staticmethod(_affine_step)
    _ORDER_FREE = True

    def __init__(self, source=None, tf_init_params: Optional[Dict] = None,
                 use_cuda: bool = False, use_pallas: Optional[bool] = None,
                 sigma2_init: Optional[float] = None, device=None):
        super().__init__(source, use_cuda, use_pallas, sigma2_init, device)
        self._tf_type = tf.AffineTransformation
        self._tf_init_params = dict(tf_init_params or {})
        self._tf_init_params.pop("xp", None)

    def _initial_tf(self):
        dim = self._source.shape[1]
        return tf.AffineTransformation(**self._tf_init_params, dim=dim,
                                       device=self._device)

    def _mstep(self, source, mom: EstepMoments, sigma2_p) -> MstepResult:
        return affine_maximization_step(source, mom)

    def _registration_fast(self, target, w, maxiter, tol):
        m, n = self._source.shape[0], target.shape[0]
        if m * n > _config.config.transposed_em_max_pairs:
            return None  # see RigidCPD._registration_fast
        args = dict(w=float(w), maxiter=int(maxiter), tol=float(tol))
        if self._fused_ok(target, bool(self._tf_init_params)):
            from .ops import em_cuda

            b, t, sigma2, q = em_cuda.run_em_affine_fused(
                self._source, target, **args)
        else:
            init = None
            if self._tf_init_params:
                tr0 = self._initial_tf()
                init = torch.cat([tr0.b.reshape(-1), tr0.t, tr0.t.new_ones(1)])
            b, t, _, sigma2, q = _run_em_t(
                self._source, target, init, kind="affine", **args,
                update_scale=False, sigma2_init=self._sigma2_init)
        return MstepResult(tf.AffineTransformation(b, t, device=self._device),
                           sigma2, q)


class _NonRigidModel(CoherentPointDrift):
    """The motion-coherence model that NonRigidCPD and
    ConstrainedNonRigidCPD share: built from the source when it is set,
    G(Y, Y; beta) as the dense (M, M) Gram matrix, or with ``rank`` as its
    rank-K Nystrom factors (ops/lowrank.py), the weights starting at zero
    or, low-rank only, at ``_v_init`` projected by least squares onto the
    basis."""

    def __init__(self, source, beta, lmd, rank, use_cuda, use_pallas,
                 sigma2_init, device, v_init=None):
        super().__init__(source, use_cuda, use_pallas, sigma2_init, device)
        if v_init is not None and rank is None:
            raise ValueError("v_init requires rank= (low-rank nonrigid)")
        self._tf_type = tf.NonRigidTransformation
        self._beta = beta
        self._lmd = lmd
        self._rank = rank
        self._v_init = None if v_init is None else self._as_points(v_init)
        self._tf_obj: Optional[tf.Transformation] = None
        if self._source is not None:
            self._make_tf_obj()

    def _make_tf_obj(self):
        if self._rank is None:
            self._tf_obj = tf.NonRigidTransformation(
                None, self._source, self._beta, device=self._device)
            return
        u, lam = lowrank.lowrank_rbf(self._source, float(self._beta),
                                     int(self._rank))
        if self._v_init is not None:
            zc0 = torch.linalg.lstsq(u, self._v_init).solution   # (K, D)
        else:
            zc0 = u.new_zeros((u.shape[1], self._source.shape[1]))
        self._tf_obj = tf.LowRankNonRigidTransformation(zc0, u, lam,
                                                        device=self._device)

    def set_source(self, source):
        super().set_source(source)
        self._make_tf_obj()

    def _initial_tf(self):
        return self._tf_obj


class NonRigidCPD(_NonRigidModel):
    """Nonrigid (motion-coherence) CPD (reference cpd.py:1050).

    ``rank``: G(Y, Y; beta) held as its rank-K Nystrom factors and every
    M-step a K x K Woodbury solve, O(M K) memory; the whole EM then runs
    in ``_run_em_nonrigid_lowrank_t``. Without it the dense (M, M) Gram
    matrix and an M x M solve per iteration. ``v_init``: an (M, D)
    starting displacement at the source points (low-rank only).
    ``sigma2_init``: a starting variance.
    """

    _STEP = staticmethod(_nonrigid_step)

    def __init__(self, source=None, beta: float = 2.0, lmd: float = 2.0,
                 use_cuda: bool = False, use_pallas: Optional[bool] = None,
                 rank: Optional[int] = None,
                 sigma2_init: Optional[float] = None, v_init=None,
                 device=None):
        super().__init__(source, beta, lmd, rank, use_cuda, use_pallas,
                         sigma2_init, device, v_init)

    def _step_aux(self):
        return {"lmd": self._lmd}

    def _step_fn(self):
        return _nonrigid_step if self._rank is None else _nonrigid_lowrank_step

    def _mstep(self, source, mom: EstepMoments, sigma2_p) -> MstepResult:
        if self._rank is None:
            return nonrigid_maximization_step(source, mom, self._tf_obj.g,
                                              self._lmd, sigma2_p)
        return nonrigid_lowrank_maximization_step(
            source, mom, self._tf_obj.u, self._tf_obj.lam, self._lmd,
            sigma2_p)

    def _registration_fast(self, target, w, maxiter, tol):
        if self._rank is None:
            return None
        u, lam = self._tf_obj.u, self._tf_obj.lam
        zc_t, sigma2, q = _run_em_nonrigid_lowrank_t(
            self._source, target, u, lam, self._lmd, w=float(w),
            maxiter=int(maxiter), tol=float(tol),
            block=int(_config.config.estep_chunk),
            zc_init_t=None if self._v_init is None else self._tf_obj.zc.T,
            sigma2_init=self._sigma2_init)
        return MstepResult(tf.LowRankNonRigidTransformation(
            zc_t.T, u, lam, device=self._device), sigma2, q)


class ConstrainedNonRigidCPD(_NonRigidModel):
    """Extended CPD: nonrigid CPD with correspondence priors (reference
    cpd.py:1133). ``idx_source[k]`` is known to match ``idx_target[k]``;
    ``alpha`` is the prior's reliability (smaller binds harder). The prior
    moments p1_tilde and px_tilde are scatter-added from the index pairs
    (a repeated index accumulates) in ``_initialize``, from the target it
    is given (the centred one in ``registration``). ``rank``: as in
    :class:`NonRigidCPD`, through the generic loop.
    """

    _STEP = staticmethod(_constrained_step)

    def __init__(self, source=None, beta: float = 2.0, lmd: float = 2.0,
                 alpha: float = 1e-8, use_cuda: bool = False,
                 idx_source=None, idx_target=None,
                 use_pallas: Optional[bool] = None,
                 rank: Optional[int] = None, device=None):
        super().__init__(source, beta, lmd, rank, use_cuda, use_pallas,
                         None, device)
        self.alpha = alpha
        self.idx_source = idx_source
        self.idx_target = idx_target
        self.p1_tilde = None
        self.px_tilde = None

    def _initialize(self, target) -> MstepResult:
        p1_tilde = self._source.new_zeros(self._source.shape[0])
        px_tilde = torch.zeros_like(self._source)
        if self.idx_source is not None and self.idx_target is not None:
            idx_s = torch.as_tensor(self.idx_source, dtype=torch.long,
                                    device=self._device)
            idx_t = torch.as_tensor(self.idx_target, dtype=torch.long,
                                    device=self._device)
            p1_tilde.index_add_(0, idx_s,
                                torch.ones_like(idx_s, dtype=p1_tilde.dtype))
            px_tilde.index_add_(0, idx_s, target[idx_t])
        self.p1_tilde, self.px_tilde = p1_tilde, px_tilde
        return super()._initialize(target)

    def _step_aux(self):
        return {"lmd": self._lmd, "alpha": self.alpha,
                "p1_tilde": self.p1_tilde, "px_tilde": self.px_tilde}

    def _step_fn(self):
        return (_constrained_step if self._rank is None
                else _constrained_lowrank_step)

    def _mstep(self, source, mom: EstepMoments, sigma2_p) -> MstepResult:
        if self._rank is None:
            return constrained_nonrigid_maximization_step(
                source, mom, self._tf_obj.g, self._lmd, sigma2_p,
                self.alpha, self.p1_tilde, self.px_tilde)
        d_extra, rhs_extra = _constrained_prior(
            source, sigma2_p, self.alpha, self.p1_tilde, self.px_tilde)
        return nonrigid_lowrank_maximization_step(
            source, mom, self._tf_obj.u, self._tf_obj.lam, self._lmd,
            sigma2_p, d_extra=d_extra, rhs_extra=rhs_extra)


_NOT_PORTED = ("{} is not ported to probreg_tpu_torch yet (ROADMAP.md, "
               "Queue 1 item 13); use probreg_tpu.cpd")


def registration_cpd_batch(sources, targets, tf_type_name: str = "rigid",
                           w: float = 0.0, maxiter: int = 50,
                           tol: float = 0.001, update_scale: bool = True,
                           n_starts: int = 1,
                           use_pallas: Optional[bool] = None,
                           device=None) -> List[MstepResult]:
    """Register B rigid or affine cloud pairs at once (reference
    cpd.py:1306-1431; the nonrigid kinds raise ``ValueError``, as there).

    ``sources`` (B, M, D) and ``targets`` (B, N, D) are registered together;
    each pair stops at its own convergence. Ragged batches: ``sources`` /
    ``targets`` may be lists of clouds with different point counts. They are
    zero-padded to the batch maximum and registered with masks, which is the
    same as registering each pair without its padding (padded points carry
    no mass; the outlier constant and sigma2_0 use the true counts).

    3-D pairs within ``config.fused_em_max_pairs`` run as ONE launch of the
    whole-EM kernel for the whole batch; others run the dense loop pair by
    pair. Returns a list of ``MstepResult``.
    """
    if tf_type_name not in ("rigid", "affine"):
        raise ValueError("batch registration supports 'rigid' and 'affine'")
    if int(n_starts) > 1:
        raise NotImplementedError(_NOT_PORTED.format("n_starts > 1"))
    from .ops import em_cuda

    dev = _config.resolve_device(device)
    ragged = isinstance(sources, (list, tuple)) \
        or isinstance(targets, (list, tuple))
    if ragged:
        sources, smasks = interop.pad_ragged(list(sources), device=dev)
        targets, tmasks = interop.pad_ragged(list(targets), device=dev)
    else:
        sources = interop.as_points(sources, device=dev)
        targets = interop.as_points(targets, device=dev)
        smasks = tmasks = None
    m, n, dim = sources.shape[1], targets.shape[1], sources.shape[2]
    args = dict(kind=tf_type_name, w=float(w), maxiter=int(maxiter),
                tol=float(tol), update_scale=bool(update_scale))
    if _fused_em_ok(m, n, dim, use_pallas):
        lin, t, sigma2, q, _ = em_cuda.run_em_cpd_fused_batch(
            sources, targets, smasks, tmasks, **args)
        # lin = scale * R for rigid (scale 1 when update_scale is False).
        if tf_type_name == "rigid":
            lin, scale = em_cuda.unpack_rigid(lin)
    elif ragged:
        lin, t, scale, sigma2, q = _run_em_t_ragged_batch(
            sources, targets, smasks, tmasks, **args)
    else:
        lin, t, scale, sigma2, q = _run_em_t_batch(sources, targets, **args)
    out = []
    for b in range(sources.shape[0]):
        if tf_type_name == "rigid":
            transf = tf.RigidTransformation(lin[b], t[b], scale[b], device=dev)
        else:
            transf = tf.AffineTransformation(lin[b], t[b], device=dev)
        out.append(MstepResult(transf, sigma2[b], q[b]))
    return out


def registration_cpd(source, target, tf_type_name: str = "rigid",
                     w: float = 0.0, maxiter: int = 50, tol: float = 0.001,
                     callbacks: Optional[List[Callable]] = None,
                     use_cuda: bool = False, callback_chunk: int = 1,
                     device=None, **kwargs) -> MstepResult:
    """CPD registration: drop-in equivalent of reference cpd.py:407-456.

    Args:
        source: Source point cloud ((M, D) ndarray, tensor or Open3D cloud).
        target: Target point cloud.
        tf_type_name: 'rigid', 'affine', 'nonrigid' or
            'nonrigid_constrained'.
        w: Weight of the uniform (outlier) distribution, 0 <= w < 1.
        maxiter: Maximum EM iterations.
        tol: Convergence tolerance on the likelihood q.
        callbacks: Not ported yet: a non-empty list raises.
        use_cuda: Ignored; see ``device``.
        callback_chunk: Accepted for the reference's signature; it only
            means something with callbacks.
        device: Device to run on (default ``config.device``, "cuda"). A
            missing CUDA device raises instead of running on the CPU.

    Keyword Args:
        As the ``RigidCPD``, ``AffineCPD``, ``NonRigidCPD`` (beta, lmd,
        rank, sigma2_init, v_init) and ``ConstrainedNonRigidCPD`` (beta,
        lmd, alpha, idx_source, idx_target, rank) constructors take them;
        use_pallas for all.

    Returns:
        MstepResult: (transformation, sigma2, q).
    """
    del callback_chunk
    if callbacks:
        raise NotImplementedError(_NOT_PORTED.format("callbacks"))
    if tf_type_name == "rigid":
        cpd = RigidCPD(source, use_cuda=use_cuda, device=device, **kwargs)
    elif tf_type_name == "affine":
        cpd = AffineCPD(source, use_cuda=use_cuda, device=device, **kwargs)
    elif tf_type_name == "nonrigid":
        cpd = NonRigidCPD(source, use_cuda=use_cuda, device=device, **kwargs)
    elif tf_type_name == "nonrigid_constrained":
        cpd = ConstrainedNonRigidCPD(source, use_cuda=use_cuda,
                                     device=device, **kwargs)
    else:
        raise ValueError("Unknown transformation type %s" % tf_type_name)
    return cpd.registration(target, w, maxiter, tol)
