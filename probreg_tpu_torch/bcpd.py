"""Bayesian Coherent Point Drift (variational inference, combined transform).

Counterpart of probreg_tpu/bcpd.py:

* ``bcpd_estep`` / ``combined_mstep``: the reference-shaped dense E-step
  and M-step (reference probreg bcpd.py:53-72, 125-155), kron-free; used by
  the callbacks loop.
* ``_vi_loop``: the one VI loop, over a batch of rows in the transposed
  (..., D, M) layout of the reference's ``_run_bcpd`` as ``jax.vmap`` runs
  it: pairs, or pairs x orientation-grid starts, with optional ragged
  padding masks; each row stops on its own NN-RMSE criterion and keeps its
  state thereafter, and the loop reads one flag tensor on the host per
  iteration for all rows (``READS``). Its E-steps: dense, blocked over
  target columns (``n > config.estep_chunk``), and, for one unmasked row,
  the tile-culled row-weighted stash E-step (``ops/bcpd_cuda.py``; its
  kernels on a CUDA device, its plain version on the CPU). The M-step
  ``_vi_mstep_t`` takes leading batch axes: a batched M x M solve, or the
  batched K x K Woodbury core of the Nystrom factors (``ops/lowrank.py``).
* ``_run_bcpd``: the loop of one pair; ``CombinedBCPD`` with the dense
  IMQ Gram matrix or its rank-K factors, and ``registration_bcpd``; its
  callbacks loop queues ``callback_chunk`` steps between two host reads
  (utils/chunked.py; the callbacks see the same transforms for every K).
* ``n_starts > 1`` (normalized, no callbacks, no warm start): the VI from
  each rotation of the orientation grid applied to the source, a pair's
  Gram matrix or factors shared by its starts (the IMQ kernel is
  rotation-invariant), all starts in one loop, the run of least NN-RMSE
  kept and composed back.
* ``registration_bcpd_batch``: B pairs in one loop, fixed-size or ragged
  (masked E-step, true counts in the normalizers, Nystrom landmarks over
  the valid points), dense or ``rank=``, with ``n_starts``: B x S rows.

The reference's worker-fault guards (``_hw_guard``, the callback-size
refusal) act only on a TPU backend and have no counterpart here.
"""

from __future__ import annotations

import abc
import math
from collections import namedtuple
from typing import Any, Callable, List, Optional

import numpy as np
import torch

from . import config as _config
from .log import log
from .models import transformation as tf
from .ops import bcpd_cuda
from .ops import lowrank as _lowrank
from .ops import pairwise
from .ops.spatial import morton_order
from .utils import chunked
from .utils import interop
from .utils import math_utils as mu

EstepResult = namedtuple("EstepResult", ["nu_d", "nu", "n_p", "px", "x_hat"])
MstepResult = namedtuple(
    "MstepResult", ["transformation", "u_hat", "sigma_mat", "alpha", "sigma2"])
MstepResult.__doc__ = """Result of Maximization step.

    Attributes:
        transformation (tf.Transformation): Transformation from source to target.
        u_hat (torch.Tensor): A parameter used in next Estep.
        sigma_mat (torch.Tensor): A parameter used in next Estep.
        alpha (float or torch.Tensor): A parameter used in next Estep.
        sigma2 (torch.Tensor): Variance of Gaussian distribution.
"""

_EPS = float(np.finfo(np.float32).eps)
# Host reads of the VI loop and of the runners: one per iteration for all
# the loop's rows (its stop test), and a fixed count per call for the
# results the host needs (ops/bfgs.READS counts its loops' reads alike).
READS = 0


def reset_reads() -> None:
    global READS
    READS = 0


def _fetch(x: torch.Tensor) -> torch.Tensor:
    """``x`` copied to the host: one device-to-host read, counted."""
    global READS
    READS += 1
    return x.cpu()


_lead = _lowrank._lead


def _svd_rotation(s_xu: torch.Tensor) -> torch.Tensor:
    """phi diag(1, .., det(phi psih)) psih from the SVD of s_xu (..., D,
    D)."""
    phi, _, psih = torch.linalg.svd(s_xu, full_matrices=True)
    c = torch.ones(s_xu.shape[:-1], dtype=s_xu.dtype, device=s_xu.device)
    c[..., -1] = torch.linalg.det(phi @ psih)
    return (phi * c[..., None, :]) @ psih


def _trace(a: torch.Tensor) -> torch.Tensor:
    return torch.diagonal(a, dim1=-2, dim2=-1).sum(-1)


def _digamma_alpha(k, nu, k_m, n_p):
    """exp(digamma(k + nu) - digamma(k m + n_p)): the mixing weights."""
    return torch.exp(torch.special.digamma(k + nu)
                     - _lead(torch.special.digamma(k_m + n_p), 1))


def bcpd_estep(t_source, target, scale, alpha, sigma_mat_diag, sigma2,
               w=0.0, with_rmse=False):
    """BCPD E-step moments (reference bcpd.py:82), dense:

    pmat_mj = (1-w) alpha_m exp(-|x_j - y_m|^2 / 2s2) / (2 pi s2)^(D/2)
              * exp(-scale^2 / (2 s2) * Sigma_mm * D)
    den_j   = w / N + sum_m pmat_mj

    ``with_rmse`` also returns the source-to-target NN-RMSE criterion from
    the same d2: ``(EstepResult, rmse)``.
    """
    dim = t_source.shape[1]
    n = target.shape[0]
    d2 = pairwise.sqdist(t_source, target)
    rmse = torch.sqrt(d2.amin(1)).mean() if with_rmse else None
    row = (1.0 - w) * alpha * torch.exp(
        -(scale ** 2) / (2.0 * sigma2) * sigma_mat_diag * dim)
    g = torch.exp(-d2 / (2.0 * sigma2)) / (2.0 * math.pi * sigma2) ** (
        dim * 0.5)
    pmat = g * row[:, None]
    den = w / n + pmat.sum(0)
    den = torch.where(den == 0.0, _EPS, den)
    pmat = pmat / den[None, :]
    nu_d = pmat.sum(0)
    nu = pmat.sum(1)
    px = pmat @ target
    x_hat = px / torch.clamp(nu, min=_EPS)[:, None]
    res = EstepResult(nu_d, nu, torch.clamp(nu.sum(), min=_EPS), px, x_hat)
    return (res, rmse) if with_rmse else res


def combined_mstep(source, target, rot, t, scale, estep_res, gmat, lmd, k,
                   sigma2_p):
    """CombinedBCPD M-step (reference bcpd.py:114), kron-free.

    Sigma = inv(lmd I + s2s2 G diag(nu)) G inverts only the well-conditioned
    shifted matrix (the reference's explicit G^-1 is garbage in f32).
    ``gmat`` may be a ``(u, lam)`` Nystrom factor tuple; then Sigma is never
    formed and the ``sigma_mat`` slot carries diag(Sigma).
    """
    nu_d, nu, n_p, px, x_hat = estep_res
    dim = source.shape[1]
    m = source.shape[0]
    s2s2 = scale ** 2 / (sigma2_p ** 2)
    residual = ((x_hat - t) / scale) @ rot - source
    if isinstance(gmat, (tuple, list)):
        umat, lam = gmat
        s_core, sigma_diag = _lowrank.regularized_sigma(umat, lam, nu, s2s2,
                                                        lmd)
        v_hat = (s2s2 / lmd) * (
            umat @ (s_core @ (umat.T @ (nu[:, None] * residual))))
        sigma_out = sigma_diag
    else:
        shifted = lmd * torch.eye(m, dtype=source.dtype,
                                  device=source.device) \
            + s2s2 * gmat * nu[None, :]
        sigma_mat = torch.linalg.solve(shifted, gmat)
        sigma_mat = 0.5 * (sigma_mat + sigma_mat.T)
        sigma_diag = torch.diagonal(sigma_mat)
        v_hat = s2s2 * (sigma_mat @ (nu[:, None] * residual))
        sigma_out = sigma_mat
    u_hat = source + v_hat
    alpha = _digamma_alpha(k, nu, k * m, n_p)
    x_m = nu @ x_hat / n_p
    sigma2_m = (nu * sigma_diag).sum() / n_p
    u_m = nu @ u_hat / n_p
    u_hm = u_hat - u_m
    s_xu = ((x_hat - x_m) * nu[:, None]).T @ u_hm / n_p
    s_uu = (u_hm * nu[:, None]).T @ u_hm / n_p \
        + sigma2_m * torch.eye(dim, dtype=source.dtype, device=source.device)
    rot_new = _svd_rotation(s_xu)
    scale_new = torch.trace(rot_new @ s_xu) / torch.trace(s_uu)
    t_new = x_m - scale_new * rot_new @ u_m
    # Reference parity (bcpd.py:151): y_hat with the PREVIOUS rigid
    # transform; only scale_new**2 * sigma2_m uses the new scale.
    y_hat = scale * (source + v_hat) @ rot.T + t
    s1 = (nu_d * (target * target).sum(1)).sum()
    s2 = (px * y_hat).sum()
    s3 = (nu * (y_hat * y_hat).sum(1)).sum()
    sigma2 = torch.clamp(
        (s1 - 2.0 * s2 + s3) / (n_p * dim) + scale_new ** 2 * sigma2_m,
        min=_EPS)
    return (tf.CombinedTransformation(rot_new, t_new, scale_new, v_hat,
                                      dim=dim),
            u_hat, sigma_out, alpha, sigma2)


def _vi_mstep_t(ys_t, rot, t, scale, sigma2, gmat, lmd, k, px_t, nu, s1,
                m_eff=None, e1=None, t_src_t=None, v_prev_t=None,
                rows=None):
    """CombinedBCPD M-step in the transposed (D, M) layout from the E-step
    moments (px_t, nu, s1) (reference bcpd.py:210), of one row or of a
    batch of rows: every argument may carry the same leading axes (``ys_t``
    (..., D, M), ``rot`` (..., D, D), ``t`` (..., D), ``scale``, ``sigma2``
    and ``s1`` (...), ``nu`` (..., M)); ``gmat`` the dense (..., M, M) IMQ
    Gram matrix or its (u (..., M, K), lam (..., K)) factors, broadcast
    over rows that share them. ``m_eff``: the true source count feeding
    the Dirichlet normalizer (default M). ``rows``: host flags of the rows
    whose results are kept; the dense solves of the others may be skipped
    (``ops/lowrank.solve``).

    sigma2, two forms:

    * residual form (``e1`` given, with ``t_src_t`` and ``v_prev_t``):
      e1 = sum p |x - y|^2 from the E-step, corrected for the v update the
      reference applies between E-step and sigma2 (delta_m = scale R
      (v_new - v_prev)_m):
      e1 - 2 sum_m (px_m - nu_m y_m) . delta_m + sum_m nu_m |delta_m|^2,
      every term O(residual), no cancellation;
    * expanded form (``e1`` None): the reference's s1 - 2 s2 + s3.

    Both keep the f32 eps floor as a backstop. The M x M and K x K solves
    (``ops/lowrank.solve``) do not check for a singular matrix, so on a
    CUDA device they do not wait for the card."""
    dim, m = ys_t.shape[-2:]
    if m_eff is None:
        m_eff = m
    eye_d = torch.eye(dim, dtype=ys_t.dtype, device=ys_t.device)
    n_p = torch.clamp(nu.sum(-1), min=_EPS)
    x_hat_t = px_t / torch.clamp(nu, min=_EPS)[..., None, :]
    s2s2 = scale ** 2 / (sigma2 ** 2)
    residual_t = rot.transpose(-1, -2) @ (
        (x_hat_t - t[..., :, None]) / _lead(scale, 2)) - ys_t
    weighted_t = residual_t * nu[..., None, :]
    if isinstance(gmat, (tuple, list)):
        umat, lam = gmat
        s_core, sigma_diag_new = _lowrank.regularized_sigma(
            umat, lam, nu, s2s2, lmd)
        v_new_t = _lead(s2s2 / lmd, 2) * (
            ((weighted_t @ umat) @ s_core) @ umat.transpose(-1, -2))
    else:
        shifted = _lead(lmd, 2) * torch.eye(m, dtype=ys_t.dtype,
                                            device=ys_t.device) \
            + _lead(s2s2, 2) * gmat * nu[..., None, :]
        sigma_mat = _lowrank.solve(shifted, gmat, rows)
        sigma_mat = 0.5 * (sigma_mat + sigma_mat.transpose(-1, -2))
        sigma_diag_new = torch.diagonal(sigma_mat, dim1=-2, dim2=-1)
        v_new_t = _lead(s2s2, 2) * (weighted_t @ sigma_mat)
    u_hat_t = ys_t + v_new_t
    alpha_new = _digamma_alpha(k, nu, k * m_eff, n_p)
    x_m = (x_hat_t @ nu[..., :, None])[..., 0] / _lead(n_p, 1)
    sigma2_m = (nu * sigma_diag_new).sum(-1) / n_p
    u_m = (u_hat_t @ nu[..., :, None])[..., 0] / _lead(n_p, 1)
    u_hm = u_hat_t - u_m[..., :, None]
    s_xu = ((x_hat_t - x_m[..., :, None]) * nu[..., None, :]) \
        @ u_hm.transpose(-1, -2)
    s_uu = (u_hm * nu[..., None, :]) @ u_hm.transpose(-1, -2) \
        / _lead(n_p, 2) + _lead(sigma2_m, 2) * eye_d
    s_xu = s_xu / _lead(n_p, 2)
    rot_new = _svd_rotation(s_xu)
    scale_new = _trace(rot_new @ s_xu) / _trace(s_uu)
    t_new = x_m - _lead(scale_new, 1) * (rot_new @ u_m[..., :, None])[..., 0]
    if e1 is not None:
        delta_t = _lead(scale, 2) * (rot @ (v_new_t - v_prev_t))
        r_t = px_t - nu[..., None, :] * t_src_t
        numer = (e1 - 2.0 * (r_t * delta_t).sum((-2, -1))
                 + (nu * (delta_t * delta_t).sum(-2)).sum(-1))
    else:
        y_hat_t = _lead(scale, 2) * (rot @ (ys_t + v_new_t)) \
            + t[..., :, None]
        s2v = (px_t * y_hat_t).sum((-2, -1))
        s3 = (nu * (y_hat_t * y_hat_t).sum(-2)).sum(-1)
        numer = s1 - 2.0 * s2v + s3
    sigma2_new = torch.clamp(numer / (n_p * dim) + scale_new ** 2 * sigma2_m,
                             min=_EPS)
    return (rot_new, t_new, scale_new, v_new_t, sigma_diag_new, alpha_new,
            sigma2_new)


def _estep_cols(t_src_t, y2, row, sigma2, xs_b, v_b, w_over_n, mask_b=None):
    """Moments (..., C, M), per-source-row min d2 (..., M) and e1 = sum p d2
    (...) of one (..., M, B) block of the posterior (reference
    bcpd.py:377), d2 in the expanded form the reference uses; ``mask_b``
    (..., 1, B) zeroes padded targets (a ragged batch)."""
    dim = t_src_t.shape[-2]
    x2b = (xs_b * xs_b).sum(-2, keepdim=True)
    d2 = torch.clamp(y2 + x2b - 2.0 * (t_src_t.transpose(-1, -2) @ xs_b),
                     min=0.0)
    s2 = _lead(sigma2, 2)
    g = torch.exp(-d2 / (2.0 * s2)) / (2.0 * math.pi * s2) ** (dim * 0.5)
    if mask_b is None:
        dmin = d2.amin(-1)
    else:
        dmin = torch.where(mask_b > 0, d2, math.inf).amin(-1)
        g = g * mask_b
    pmat = g * row[..., :, None]
    den = w_over_n + pmat.sum(-2, keepdim=True)
    den = torch.where(den == 0.0, _EPS, den)
    pmat = pmat / den
    return v_b @ pmat.transpose(-1, -2), dmin, (pmat * d2).sum((-2, -1))


def _estep_all(t_src_t, xs_t, v_chan, row, sigma2, w_over_n, block,
               cmask=None):
    """_estep_cols over all targets, in column blocks of ``block``:
    (..., M, block) temporaries."""
    y2 = (t_src_t * t_src_t).sum(-2)[..., :, None]
    mom = minrow = e1 = None
    for c0 in range(0, xs_t.shape[-1], block):
        cols = slice(c0, c0 + block)
        mom_b, dmin, e1_b = _estep_cols(
            t_src_t, y2, row, sigma2, xs_t[..., cols], v_chan[..., cols],
            w_over_n, None if cmask is None else cmask[..., cols])
        if mom is None:
            mom, minrow, e1 = mom_b, dmin, e1_b
        else:
            mom, minrow, e1 = (mom + mom_b, torch.minimum(minrow, dmin),
                               e1 + e1_b)
    return mom, minrow, e1


def _culled_rowlog(row, dim, sigma2):
    """log of BCPD's row weight and normalizer, -1e30 where the weight is 0
    (reference bcpd.py:418-422)."""
    return torch.where(
        row > 0.0,
        torch.log(torch.clamp(row, min=1e-38))
        - dim * 0.5 * torch.log(2.0 * math.pi * sigma2),
        torch.tensor(-1e30, dtype=row.dtype, device=row.device))


def _estep_of(target, w_over_n, block, cmask=None, use_culled=False):
    """The VI E-step against ``target`` (..., N, D): estep(t_src_t, row,
    sigma2) -> (moments (..., D + 2, M) of the channels [x; 1; |x|^2],
    per-source-row min d2 (..., M), e1 = sum p d2 (...)). Dense in column
    blocks of ``block`` (``cmask`` (..., 1, N) zeroes padded columns), or,
    for one row (``use_culled``, clouds Morton-sorted), the tile-culled
    row-weighted E-step (``ops/bcpd_cuda.py``)."""
    dim = target.shape[-1]
    xs_t = target.transpose(-1, -2)
    x2 = (xs_t * xs_t).sum(-2, keepdim=True)
    # Channels [x (D); ones; |x|^2]: the moments give px_t (D, M), nu (M)
    # and sum_j p_ij |x_j|^2, whose total is s1.
    v_chan = torch.cat([xs_t, torch.ones_like(x2), x2], dim=-2)

    def estep(t_src_t, row, sigma2):
        if use_culled:
            _, mom, minrow, e1 = bcpd_cuda.bcpd_estep_culled(
                t_src_t[0].T, target[0], _culled_rowlog(row[0], dim,
                                                        sigma2[0]),
                v_chan[0], w_over_n, sigma2[0])
            return mom[None], minrow[None], e1.reshape(1)
        return _estep_all(t_src_t, xs_t, v_chan, row, sigma2, w_over_n,
                          block, cmask)

    return estep


def _vi_loop(source, target, gmat, lmd, k, sigma2_0, *, w, maxiter, tol,
             block=None, smask=None, tmask=None, use_culled=False,
             init=None, estep=None, agree=None):
    """The VI loop over a batch of rows in transposed (D, M) layout: the
    reference's _run_bcpd (bcpd.py:313) as jax.vmap runs it.

    ``source`` (..., M, D) and ``target`` (..., N, D): one row per leading
    index (pairs, or pairs x starts); every other argument broadcasts over
    the rows, so the S starts of a pair share its target, its masks and
    its Gram matrix or factors without a copy. ``gmat`` is the dense
    (..., M, M) IMQ Gram matrix or its (u (..., M, K), lam (..., K))
    Nystrom factors; ``sigma2_0`` (...) each row's start temperature.
    ``smask`` (..., M) / ``tmask`` (..., N): ragged padding (alpha0 =
    smask / m_eff, padded rows and columns carry no mass, the masked
    NN-RMSE, the Dirichlet normalizer of the true count). The E-step is
    dense, blocked over target columns when N > ``block`` (default
    ``config.estep_chunk``), or, for one row without masks, the tile-culled
    row-weighted E-step (``use_culled``; the caller Morton-sorted both
    clouds). ``init``: optional (rot0, t0, scale0, v0_t, alpha0, sdiag0)
    tensors of the rows' shapes, any of v0_t, alpha0, sdiag0 None.
    ``estep``: an E-step in :func:`_estep_of`'s form in place of the one
    against ``target`` (the sharded runner's, whose sums and minima span
    the mesh); ``agree``: applied to each M-step's new state tuple (the
    sharded runner hands every rank the first rank's).

    A row is live while i < maxiter and (i < 2 or its NN-RMSE criterion
    moved by at least ``tol``); a finished row's state, best state and
    criterion stay as they were. The loop reads one (...) flag tensor per
    iteration from the third on, and ends when no row is live. It keeps
    each row's best state visited; afterwards each row's last iterate is
    scored once at its sigma2_0 with unit row weights, and the better of
    the two is returned.

    Returns ((rot, t, scale, v_t, sigma2), rmse, last): the kept state, its
    NN-RMSE (...), and the raw final iterate (rot, t, scale, v_t, sigma2,
    sigma_diag, alpha, rmse_last), all device tensors.
    """
    m, dim = source.shape[-2:]
    lead = source.shape[:-2]
    dt, dev = source.dtype, source.device
    masked = smask is not None
    if use_culled and (masked or lead != (1,)):
        raise ValueError("the culled E-step runs one row without masks")
    ys_t = source.transpose(-1, -2)
    m_eff = smask.sum(-1) if masked else None
    if estep is None:
        n = target.shape[-2]
        block = int(_config.config.estep_chunk) if block is None \
            else int(block)
        if masked:
            estep = _estep_of(target, _lead(w / tmask.sum(-1), 2),
                              max(min(block, n), 1), tmask[..., None, :])
        else:
            estep = _estep_of(target, w / n, max(min(block, n), 1),
                              use_culled=use_culled)

    def nn_rmse(minrow):
        if masked:
            return torch.where(smask > 0, torch.sqrt(minrow),
                               0.0).sum(-1) / m_eff
        return torch.sqrt(minrow).mean(-1)

    def moved(rot, t, scale, v_t):
        return _lead(scale, 2) * (rot @ (ys_t + v_t)) + t[..., :, None]

    if init is None:
        init = (torch.eye(dim, dtype=dt, device=dev).expand(
            lead + (dim, dim)), torch.zeros(lead + (dim,), dtype=dt,
                                            device=dev),
                torch.ones(lead, dtype=dt, device=dev), None, None, None)
    rot, t, scale, v_t, alpha, sigma_diag = init
    if v_t is None:
        v_t = torch.zeros(lead + (dim, m), dtype=dt, device=dev)
    if alpha is None:
        alpha = (smask / _lead(m_eff, 1) if masked
                 else torch.full((m,), 1.0 / m, dtype=dt, device=dev)
                 ).expand(lead + (m,))
    if sigma_diag is None:
        sigma_diag = torch.ones(lead + (m,), dtype=dt, device=dev)
    sigma2 = torch.as_tensor(sigma2_0, dtype=dt, device=dev).expand(lead)
    inf = torch.full(lead, math.inf, dtype=dt, device=dev)
    state = (rot, t, scale, v_t, sigma_diag, alpha, sigma2)
    best, best_rmse = (rot, t, scale, v_t, sigma2), inf
    rmse, rmse_prev, live, rows, i = inf, inf, None, None, 0
    while i < maxiter:
        if i >= 2:
            go = (rmse - rmse_prev).abs() >= tol
            live = go if live is None else live & go
            flags = _fetch(live)
            if not bool(flags.any()):
                break
            rows = None if bool(flags.all()) else flags.reshape(-1).tolist()
        rot, t, scale, v_t, sigma_diag, alpha, sigma2 = state
        t_src_t = moved(rot, t, scale, v_t)
        row = (1.0 - w) * alpha * torch.exp(
            _lead(-(scale ** 2) / (2.0 * sigma2), 1) * sigma_diag * dim)
        if masked:
            row = row * smask
        mom, minrow, e1 = estep(t_src_t, row, sigma2)
        rmse_t = nn_rmse(minrow)
        new = _vi_mstep_t(
            ys_t, rot, t, scale, sigma2, gmat, lmd, k, mom[..., :dim, :],
            mom[..., dim, :], mom[..., dim + 1, :].sum(-1), m_eff=m_eff,
            e1=e1, t_src_t=t_src_t, v_prev_t=v_t, rows=rows)
        if agree is not None:
            new = agree(new)
        # rmse_t scores the INCOMING state; the VI keeps trading scale
        # against v after convergence, so the last iterate can be worse
        # than one it passed through.
        better = rmse_t < best_rmse
        new_best = tuple(torch.where(_lead(better, x.dim() - better.dim()),
                                     x, b) for x, b in zip(state[:4]
                                                          + (sigma2,), best))
        new_vals = (new, (rmse_t, rmse), new_best,
                    (torch.minimum(rmse_t, best_rmse),))
        old_vals = (state, (rmse, rmse_prev), best, (best_rmse,))
        if rows is not None:
            # Finished rows keep every value they had.
            new_vals = tuple(
                tuple(torch.where(_lead(live, x.dim() - live.dim()), x, o)
                      for x, o in zip(nv, ov))
                for nv, ov in zip(new_vals, old_vals))
        state, (rmse, rmse_prev), best, (best_rmse,) = new_vals
        i += 1
    log.debug("BCPD VI: %d iterations of %d rows", i, math.prod(lead))

    # Score each last iterate once, at its start temperature with unit row
    # weights, and keep the better of (last, best visited).
    rot, t, scale, v_t, sigma_diag, alpha, sigma2 = state
    _, minrow, _ = estep(moved(rot, t, scale, v_t),
                         torch.ones(lead + (m,), dtype=dt, device=dev),
                         torch.as_tensor(sigma2_0, dtype=dt,
                                         device=dev).expand(lead))
    rmse_last = nn_rmse(minrow)
    use_last = rmse_last <= best_rmse
    kept = tuple(torch.where(_lead(use_last, x.dim() - use_last.dim()), x, b)
                 for x, b in zip((rot, t, scale, v_t, sigma2), best))
    last = (rot, t, scale, v_t, sigma2, sigma_diag, alpha, rmse_last)
    return kept, torch.minimum(rmse_last, best_rmse), last


def _run_bcpd(source, target, gmat, lmd, k, sigma2_0, *, w, maxiter, tol,
              block=None, smask=None, tmask=None, use_culled=False,
              init_params=None):
    """The VI loop of one pair (reference bcpd.py:313): ``_vi_loop`` with
    one row. Returns (transformation, sigma_diag, alpha, sigma2, rmse,
    last), ``rmse`` and last's rmse_last host floats.

    ``gmat``: the dense (M, M) IMQ Gram matrix or its ``(u, lam)`` Nystrom
    factors. ``smask`` (M,) / ``tmask`` (N,): padding masks. ``init_params``:
    optional ``(rot0, t0, scale0, v0_t)`` or ``(rot0, t0, scale0, v0_t,
    alpha0, sdiag0)`` warm start in the frame of ``source`` / ``target``
    (``v0_t`` (D, M) or None; alpha0 / sdiag0 may be None). ``last`` is
    the raw final iterate (rot, t, scale, v_t, sigma2, sigma_diag, alpha,
    rmse)."""
    dt, dev = source.dtype, source.device

    def row_of(x):
        if x is None:
            return None
        if isinstance(x, np.ndarray):
            x = np.array(x)  # a writable copy (broadcast views are not)
        return torch.as_tensor(x, dtype=dt).to(dev)[None]

    init = None
    if init_params is not None:
        init = tuple(row_of(x) for x in init_params)
        init = init + (None,) * (6 - len(init))
    gmat = tuple(a[None] for a in gmat) if isinstance(gmat, (tuple, list)) \
        else gmat[None]
    kept, rmse, last = _vi_loop(
        source[None], target[None], gmat, lmd, k,
        torch.as_tensor(sigma2_0, dtype=dt).to(dev).reshape(1), w=w,
        maxiter=maxiter, tol=tol, block=block,
        smask=None if smask is None else smask[None],
        tmask=None if tmask is None else tmask[None], use_culled=use_culled,
        init=init)
    rmse, rmse_last = _fetch(torch.cat([rmse, last[-1]])).tolist()
    rot, t, scale, v_t, sigma2 = (x[0] for x in kept)
    last = tuple(x[0] for x in last[:-1]) + (rmse_last,)
    return (tf.CombinedTransformation(rot, t, scale, v_t.T,
                                      dim=source.shape[1]),
            last[5], last[6], sigma2, rmse, last)


class BayesianCoherentPointDrift(abc.ABC):
    """Abstract BCPD (reference bcpd.py:566)."""

    def __init__(self, source=None, device=None):
        self._device = _config.resolve_device(device)
        self._source = None if source is None else self._as_points(source)
        self._tf_type = None
        self._callbacks: List[Callable] = []

    def _as_points(self, x) -> torch.Tensor:
        return interop.as_points(x, device=self._device)

    def set_source(self, source):
        self._source = self._as_points(source)

    def set_callbacks(self, callbacks):
        self._callbacks.extend(callbacks)

    @abc.abstractmethod
    def _initialize(self, target) -> MstepResult:
        ...

    def expectation_step(self, t_source, target, scale, alpha, sigma_mat,
                         sigma2, w=0.0) -> EstepResult:
        """Reference-shaped E-step (reference probreg bcpd.py:53-72)."""
        sigma_mat = torch.as_tensor(sigma_mat).to(self._device)
        diag = torch.diagonal(sigma_mat) if sigma_mat.dim() == 2 \
            else sigma_mat
        as_t = self._as_scalar
        return bcpd_estep(self._as_points(t_source), self._as_points(target),
                          as_t(scale), as_t(alpha), diag, as_t(sigma2),
                          float(w))

    def _as_scalar(self, x) -> torch.Tensor:
        return torch.as_tensor(x, dtype=_config.config.dtype).to(self._device)

    @abc.abstractmethod
    def maximization_step(self, target, *args, **kwargs) -> MstepResult:
        ...

    def registration(self, target, w: float = 0.0, maxiter: int = 50,
                     tol: float = 0.001, callback_chunk: int = 1,
                     tf_init_params=None, v_init=None, sigma2_init=None,
                     extra_init=None, want_last=False) -> tf.Transformation:
        """Run the VI registration. ``tf_init_params`` ({'rot', 't',
        'scale'}), ``v_init`` ((M, D) displacement field) and
        ``sigma2_init`` warm-start it in the instance's frame."""
        assert self._tf_type is not None, "transformation type is None."
        target = self._as_points(target)
        if not self._callbacks:
            return self._registration_jit(
                target, w, maxiter, tol, tf_init_params=tf_init_params,
                v_init=v_init, sigma2_init=sigma2_init,
                extra_init=extra_init, want_last=want_last)
        if tf_init_params or v_init is not None or sigma2_init is not None \
                or extra_init is not None:
            raise ValueError("warm starts are only supported without "
                             "callbacks")
        return self._registration_loop(target, w, maxiter, tol,
                                       int(callback_chunk))

    @abc.abstractmethod
    def _registration_jit(self, target, w, maxiter, tol,
                          tf_init_params=None, v_init=None,
                          sigma2_init=None, extra_init=None,
                          want_last=False):
        ...

    @abc.abstractmethod
    def _registration_loop(self, target, w, maxiter, tol, chunk=1):
        ...


class CombinedBCPD(BayesianCoherentPointDrift):
    """BCPD with the combined rigid + scale + nonrigid transform (reference
    bcpd.py:655).

    Args:
        source: Source point cloud.
        lmd: Motion-coherence regularization weight.
        k: Dirichlet concentration (large k = uniform mixing weights).
        gamma: Initial sigma2 scaling.
        rank: When set, hold the IMQ Gram matrix as rank-K Nystrom factors
            and run the Sigma update through a K x K Woodbury solve
            (ops/lowrank.py).
        device: Device to run on (default ``config.device``).
    """

    def __init__(self, source=None, lmd=2.0, k=1.0e20, gamma=1.0, rank=None,
                 device=None):
        super().__init__(source, device)
        self._tf_type = tf.CombinedTransformation
        self.lmd = lmd
        self.k = k
        self.gamma = gamma
        self.rank = rank

    def _gram(self):
        if self.rank is None:
            return mu.inverse_multiquadric_kernel(self._source, self._source)
        return tuple(_lowrank.lowrank_imq(self._source, 1.0, int(self.rank)))

    def _initialize(self, target) -> MstepResult:
        m, dim = self._source.shape
        self.gmat = self._gram()
        sigma2 = self.gamma * mu.squared_kernel_sum(self._source, target)
        sigma_mat0 = (torch.eye(m, dtype=self._source.dtype,
                                device=self._device) if self.rank is None
                      else torch.ones((m,), dtype=self._source.dtype,
                                      device=self._device))
        return MstepResult(
            self._tf_type(torch.eye(dim), torch.zeros(dim), dim=dim,
                          device=self._device),
            None, sigma_mat0, 1.0 / m, sigma2)

    def maximization_step(self, target, rigid_trans, estep_res,
                          sigma2_p=None) -> MstepResult:
        out = combined_mstep(
            self._source, self._as_points(target), rigid_trans.rot,
            rigid_trans.t, rigid_trans.scale, estep_res, self.gmat,
            self._as_scalar(self.lmd), self._as_scalar(self.k),
            self._as_scalar(sigma2_p))
        return MstepResult(*out)

    def _use_culled(self, m: int, n: int) -> bool:
        """The reference's branch (bcpd.py:713-725), a CUDA device in place
        of the TPU backend."""
        cfg = _config.config
        return (self._device.type == "cuda" and cfg.use_culled_estep
                and m * n >= cfg.culled_estep_min_pairs
                and self.rank is not None
                and m <= cfg.bcpd_culled_max_points)

    def _registration_jit(self, target, w, maxiter, tol,
                          tf_init_params=None, v_init=None,
                          sigma2_init=None, extra_init=None,
                          want_last=False):
        """The VI loop without callbacks (reference bcpd.py:701; the name
        is the reference's, there is nothing to compile here)."""
        m, dim = self._source.shape
        use_culled = self._use_culled(m, target.shape[0])
        perm_s = None
        orig_source = self._source
        if use_culled:
            # One Morton sort so that tile culling fires; the Nystrom
            # factors are built from the SORTED source, and v rows are
            # unsorted before returning.
            perm_s = morton_order(self._source)
            self._source = self._source[perm_s]
            target = target[morton_order(target)]
        perm_np = None if perm_s is None else perm_s.cpu().numpy()
        p = dict(tf_init_params or {})
        if v_init is None:
            v0 = None
        else:
            v0 = np.asarray(v_init, np.float64)
            if perm_np is not None:
                v0 = v0[perm_np]
            v0 = v0.T                                       # (D, M)
        alpha0, sdiag0 = extra_init if extra_init is not None \
            else (None, None)
        if alpha0 is not None and perm_np is not None:
            alpha0 = np.asarray(alpha0, np.float64)[perm_np]
        if sdiag0 is not None and perm_np is not None:
            sdiag0 = np.asarray(sdiag0, np.float64)[perm_np]
        init_params = (np.asarray(p.get("rot", np.eye(dim)), np.float64),
                       np.asarray(p.get("t", np.zeros(dim)), np.float64),
                       np.float64(p.get("scale", 1.0)), v0, alpha0, sdiag0)
        try:
            self.gmat = self._gram()
            sigma2 = (self.gamma * mu.squared_kernel_sum(self._source, target)
                      if sigma2_init is None
                      else max(float(sigma2_init), _EPS))
            transf, _, _, sigma2_out, rmse, last = _run_bcpd(
                self._source, target, self.gmat, self._as_scalar(self.lmd),
                self._as_scalar(self.k), sigma2, w=float(w),
                maxiter=int(maxiter), tol=float(tol),
                block=int(_config.config.estep_chunk),
                use_culled=bool(use_culled), init_params=init_params)
            self._final_sigma2 = sigma2_out
            self._best_rmse = rmse
        finally:
            self._source = orig_source
            if perm_s is not None:
                # Rebuild the factors for the caller's row order, so later
                # public maximization / expectation calls see consistent
                # rows.
                self.gmat = self._gram()

        def unsort(x):
            return x if perm_s is None else \
                torch.empty_like(x).index_copy_(0, perm_s, x)

        rt = transf.rigid_trans
        transf = tf.CombinedTransformation(rt.rot, rt.t, rt.scale,
                                           unsort(transf.v), dim=dim)
        self._last = None
        if want_last:
            rot_l, t_l, scale_l, v_l_t, s2_l, sdiag_l, alpha_l, rmse_l = last
            self._last = dict(
                rot=rot_l, t=t_l, scale=scale_l, v=unsort(v_l_t.T),
                sigma2=s2_l, alpha=unsort(alpha_l),
                sigma_diag=unsort(sdiag_l), rmse_last=rmse_l, rmse_best=rmse)
        return transf

    def _registration_loop(self, target, w, maxiter, tol, chunk=1):
        """The callbacks loop (reference bcpd.py:838-905): the dense
        reference-shaped E- and M-steps, ``chunk`` of them queued between
        two host reads; the host replays the callbacks after each M-step
        and the NN-RMSE stop test."""
        res0 = self._initialize(target)
        steps = []
        prev = {"rmse": None}

        def chunk_fn(res, k):
            steps.clear()
            for _ in range(k):
                t_source = res.transformation._transform(self._source)
                est = self.expectation_step(
                    t_source, target, res.transformation.rigid_trans.scale,
                    res.alpha, res.sigma_mat, res.sigma2, w)
                res = self.maximization_step(
                    target, res.transformation.rigid_trans, est, res.sigma2)
                steps.append((res.transformation,
                              mu.compute_rmse(t_source, target)))
            return res, chunked.stack_history([(r,) for _, r in steps])

        def handle(i, host, j):
            transf = steps[j][0]
            for c in self._callbacks:
                c(transf)
            tmp_rmse = float(host[0][j])
            log.debug("Iteration: {}, Criteria: {}".format(i, tmp_rmse))
            stop = prev["rmse"] is not None \
                and abs(prev["rmse"] - tmp_rmse) < tol
            prev["rmse"] = tmp_rmse
            return stop, transf

        out = chunked.run_chunked(chunk_fn, res0, maxiter, chunk, handle)
        return out if out is not None else res0.transformation


def _last_state(bc):
    """The final VI iterate as host float64 arrays, or None (callbacks
    loop)."""
    last = getattr(bc, "_last", None)
    if last is None:
        return None
    return {k: (np.asarray(v.detach().cpu(), np.float64)
                if isinstance(v, torch.Tensor) else v)
            for k, v in last.items()}


def _rmse_info(bc):
    """{'best': best-visited NN-RMSE, 'last': the final iterate's NN-RMSE}
    (reference bcpd.py:973), None entries where the path does not track
    them."""
    host = _last_state(bc)
    if host is None:
        return {"best": None, "last": None}
    return {"last": float(host["rmse_last"]), "best": float(host["rmse_best"])}


def _last_state_kwargs(bc, centroid, scale):
    """Raw-frame warm-start kwargs from the final VI iterate (reference
    bcpd.py:986); feeding them back continues the VI trajectory."""
    host = _last_state(bc)
    if host is None:
        return None
    return {
        "tf_init_params": {
            "rot": host["rot"],
            "t": scale * host["t"] + centroid,
            "scale": float(host["scale"]),
        },
        "v_init": scale * host["v"] - centroid,
        "sigma2_init": float(host["sigma2"]) * scale ** 2,
        "_alpha_init": host["alpha"],
        "_sdiag_init": host["sigma_diag"] * scale ** 2,
    }


def _gram_rows(sources, rank, smasks=None, min_m=None):
    """The dense IMQ Gram matrices (..., M, M) of ``sources`` (..., M, D),
    or with ``rank`` their Nystrom factors over each cloud's valid points
    (reference bcpd.py:1139-1143, 1195-1199, 1212-1215)."""
    if rank is None:
        return 1.0 / torch.sqrt(pairwise.sqdist_batch(sources, sources) + 1.0)
    return tuple(_lowrank.lowrank_imq(sources, 1.0, int(rank), valid=smasks,
                                      max_landmarks=min_m))


def _squared_kernel_sums(x, y, smask=None, tmask=None):
    """squared_kernel_sum of each pair (..., M, D), (..., N, D) in closed
    form: unmasked on the pair's joint centre (reference math_utils.py:39),
    masked over the valid points with the true counts (reference
    math_utils.py:69)."""
    dim = x.shape[-1]
    if smask is None:
        m, n = x.shape[-2], y.shape[-2]
        cen = (x.sum(-2) + y.sum(-2)) / (m + n)
        x, y = x - cen[..., None, :], y - cen[..., None, :]
        return (n * (x * x).sum((-2, -1)) + m * (y * y).sum((-2, -1))
                - 2.0 * (x.sum(-2) * y.sum(-2)).sum(-1)) / float(m * dim * n)
    m, n = smask.sum(-1), tmask.sum(-1)
    s2 = ((x * x).sum(-1) * smask).sum(-1)
    t2 = ((y * y).sum(-1) * tmask).sum(-1)
    ssum = (x * smask[..., None]).sum(-2)
    tsum = (y * tmask[..., None]).sum(-2)
    return (s2 * n + t2 * m - 2.0 * (ssum * tsum).sum(-1)) / (m * dim * n)


def _run_bcpd_batch(sources, targets, sigma2_0s, lmd, k, *, w, maxiter, tol,
                    rank, block, smasks=None, tmasks=None, min_m=None):
    """B pairs (B, M, D), (B, N, D) in one VI loop (reference bcpd.py:1191,
    1209): each pair's Gram matrix or factors (with ``smasks``, over its
    valid points, ``min_m`` landmarks at most), its start temperature
    ``sigma2_0s`` (B,). Returns device tensors (rot (B, D, D), t (B, D),
    scale (B,), v (B, M, D))."""
    gmat = _gram_rows(sources, rank, smasks, min_m)
    (rot, t, scale, v_t, _), _, _ = _vi_loop(
        sources, targets, gmat, lmd, k, sigma2_0s, w=w, maxiter=maxiter,
        tol=tol, block=block, smask=smasks, tmask=tmasks)
    return rot, t, scale, v_t.transpose(-1, -2)


def _run_bcpd_multistart_batch(sources, targets, gamma, lmd, k, rots0, *, w,
                               maxiter, tol, rank, block, smasks=None,
                               tmasks=None, min_m=None):
    """B pairs x S starts in one VI loop (reference bcpd.py:1131-1186): the
    VI from each grid rotation ``rots0`` (S, D, D) of each source. The IMQ
    Gram matrix (or its factors) is rotation-invariant, so a pair's starts
    share it; each start's temperature is gamma times the squared-kernel
    sum of its rotated source. Each start is scored by its NN-RMSE (NaN as
    inf), the first of the least wins, and the winner is composed back
    into the source's frame: T(R0 y) = s (R R0) (y + R0^T v) + t.

    Returns device tensors (rot (B, D, D), t (B, D), scale (B,), v (B, M,
    D), the winner's final sigma2 (B,), the winning start (B,), every
    start's score (B, S))."""
    bsz, m, dim = sources.shape
    rots0 = torch.as_tensor(rots0, dtype=sources.dtype).to(sources.device)
    nst = rots0.shape[0]
    gmat = _gram_rows(sources, rank, smasks, min_m)
    gmat = tuple(a[:, None] for a in gmat) if isinstance(gmat, tuple) \
        else gmat[:, None]
    src_r = sources[:, None] @ rots0.transpose(-1, -2)       # (B, S, M, D)
    tgt_r = targets[:, None]
    sm = None if smasks is None else smasks[:, None]
    tm = None if tmasks is None else tmasks[:, None]
    sigma2_0 = gamma * _squared_kernel_sums(src_r, tgt_r, sm, tm)
    (rot, t, scale, v_t, s2), rmse, _ = _vi_loop(
        src_r, tgt_r, gmat, lmd, k, sigma2_0, w=w, maxiter=maxiter, tol=tol,
        block=block, smask=sm, tmask=tm)
    scores = torch.where(torch.isnan(rmse), math.inf, rmse)
    best = torch.argmin(scores, dim=1)
    pick = torch.arange(bsz, device=sources.device), best
    rot0 = rots0[best]
    return (rot[pick] @ rot0, t[pick], scale[pick],
            v_t[pick].transpose(-1, -2) @ rot0, s2[pick], best, scores)


def _run_bcpd_multistart(source, target, gamma, lmd, k, rots0, *, w,
                         maxiter, tol, rank, block, smask=None, tmask=None,
                         min_m=None):
    """The search of one pair (reference bcpd.py:1131): returns (the
    winner's CombinedTransformation, its final sigma2, the winning start,
    every start's score as host floats)."""
    rot, t, scale, v, s2, best, scores = _run_bcpd_multistart_batch(
        source[None], target[None], gamma, lmd, k, rots0, w=w,
        maxiter=maxiter, tol=tol, rank=rank, block=block,
        smasks=None if smask is None else smask[None],
        tmasks=None if tmask is None else tmask[None], min_m=min_m)
    host = _fetch(torch.cat([best.to(scores.dtype), scores[0]])).tolist()
    return (tf.CombinedTransformation(rot[0], t[0], scale[0], v[0],
                                      dim=source.shape[1]),
            s2[0], int(host[0]), host[1:])


def _normalizers(srcs, tgts):
    """Per-pair joint centroid (B, D) and the square root of its
    squared-kernel sum (B,), host float64 (reference bcpd.py:1278-1285)."""
    cents, scales = [], []
    for sr, tg in zip(srcs, tgts):
        m, n, dim = sr.shape[0], tg.shape[0], sr.shape[1]
        cen = (sr.sum(0) + tg.sum(0)) / (m + n)
        sh, th = sr - cen, tg - cen
        skc = ((sh ** 2).sum() * n + (th ** 2).sum() * m
               - 2.0 * float(sh.sum(0) @ th.sum(0))) / (m * dim * n)
        cents.append(cen)
        scales.append(max(float(np.sqrt(skc)), 1e-12))
    return np.stack(cents), np.asarray(scales)


def _denormalized(rot, t, scale, v, cents, scales, sizes=None):
    """CombinedTransformations in raw coordinates from a batch's normalized
    results: y -> s R (y + v_raw) + t_raw with v_raw = sc v - c and
    t_raw = sc t + c; ``sizes`` slices each v back to its pair's source."""
    dev = v.device
    sc = torch.as_tensor(scales, dtype=torch.float64, device=dev)
    cen = torch.as_tensor(cents, dtype=torch.float64, device=dev)
    t_raw = sc[:, None] * t.double() + cen
    v_raw = sc[:, None, None] * v.double() - cen[:, None, :]
    dim = v.shape[-1]
    if sizes is None:
        sizes = [v.shape[1]] * v.shape[0]
    return [tf.CombinedTransformation(rot[i], t_raw[i], scale[i],
                                      v_raw[i, :sizes[i]], dim=dim)
            for i in range(len(sizes))]


def _registration_bcpd_multistart_batch(sources, targets, *, w, maxiter,
                                        tol, n_starts, device, lmd=2.0,
                                        k=1.0e20, gamma=1.0, rank=None):
    """Normalized multistart BCPD of an equal-size batch (reference
    bcpd.py:1311): B pairs x S starts in one VI loop. ``sources`` /
    ``targets``: (B, M, D) / (B, N, D) or lists of equal-size clouds.
    Returns (raw-frame CombinedTransformations, the winners' raw-frame
    sigma2 (B,) and winning starts (B,) as host arrays)."""
    from . import cost_functions as cf

    src = np.stack([np.asarray(interop.as_points(s, device="cpu"),
                               np.float64) for s in sources])
    tgt = np.stack([np.asarray(interop.as_points(t, device="cpu"),
                               np.float64) for t in targets])
    if src.shape[-1] != 3:
        raise ValueError("n_starts > 1 supports 3-D clouds only")
    cents, scales = _normalizers(src, tgt)
    dt = _config.config.dtype

    def dev_t(x):
        return torch.as_tensor(np.asarray(x, np.float64), dtype=dt).to(device)

    rot, t, scale, v, s2, best, _ = _run_bcpd_multistart_batch(
        dev_t((src - cents[:, None]) / scales[:, None, None]),
        dev_t((tgt - cents[:, None]) / scales[:, None, None]), dev_t(gamma),
        dev_t(lmd), dev_t(k),
        cf.RigidCostFunction.initial_multistart_rots(int(n_starts)),
        w=float(w), maxiter=int(maxiter), tol=float(tol), rank=rank,
        block=int(_config.config.estep_chunk))
    host = _fetch(torch.stack([s2.double(), best.double()])).numpy()
    return (_denormalized(rot, t, scale, v, cents, scales),
            host[0] * scales ** 2, host[1].astype(np.int64))


def _registration_bcpd_impl(
    source, target, *, w, maxiter, tol, callbacks, normalize,
    callback_chunk, tf_init_params=None, v_init=None, sigma2_init=None,
    return_last=False, _alpha_init=None, _sdiag_init=None, device=None,
    **kwargs: Any,
):
    """registration_bcpd's body (reference bcpd.py:1021): also returns the
    final raw-frame sigma2 (None on the callbacks loop) and, with
    ``return_last``, the raw-frame final iterate as warm-start kwargs and
    the {'best', 'last'} NN-RMSE."""
    dev = _config.resolve_device(device)
    src = np.asarray(interop.as_points(source, device="cpu"), np.float64)
    tgt = np.asarray(interop.as_points(target, device="cpu"), np.float64)
    n_starts = int(kwargs.pop("n_starts", 1))
    if n_starts > 1:
        if callbacks or not normalize:
            raise ValueError("n_starts > 1 requires the normalized "
                             "no-callback path")
        if tf_init_params or v_init is not None or sigma2_init is not None:
            raise ValueError("n_starts > 1 is incompatible with warm "
                             "starts (the orientation grid replaces them)")
        outs, s2_raws, _ = _registration_bcpd_multistart_batch(
            [src], [tgt], w=w, maxiter=maxiter, tol=tol, n_starts=n_starts,
            device=dev, **kwargs)
        out, s2_raw = outs[0], float(s2_raws[0])
        return (out, s2_raw, None, None) if return_last else (out, s2_raw)
    extra = None if _alpha_init is None and _sdiag_init is None \
        else (_alpha_init, _sdiag_init)
    if not normalize:
        bc = CombinedBCPD(src, device=dev, **kwargs)
        bc.set_callbacks(callbacks)
        res = bc.registration(tgt, w, maxiter, tol,
                              callback_chunk=callback_chunk,
                              tf_init_params=tf_init_params, v_init=v_init,
                              sigma2_init=sigma2_init, extra_init=extra,
                              want_last=return_last)
        s2f = getattr(bc, "_final_sigma2", None)
        s2f = None if s2f is None else float(s2f)
        if not return_last:
            return res, s2f
        return (res, s2f, _last_state_kwargs(bc, np.zeros(src.shape[1]), 1.0),
                _rmse_info(bc))

    centroid = np.concatenate([src, tgt], axis=0).mean(axis=0)
    scale = max(np.sqrt(mu.squared_kernel_sum_np(src, tgt)), 1e-12)
    # Raw -> normalized frame: with y_n = (y - c)/sc the raw transform
    # s R (y + v) + t becomes s R (y_n + v_n) + t_n, v_n = (v + c)/sc,
    # t_n = (t - c)/sc; variances scale by 1/sc^2.
    tf_init_n = None
    if tf_init_params:
        tf_init_n = dict(tf_init_params)
        if "t" in tf_init_n:
            tf_init_n["t"] = (np.asarray(tf_init_n["t"], np.float64)
                              - centroid) / scale
    if v_init is None and tf_init_params:
        # A raw pose with no displacement field means v_raw = 0, which is
        # v_n = centroid / scale in the normalized frame.
        v_init_n = np.broadcast_to(centroid / scale, src.shape)
    elif v_init is None:
        v_init_n = None
    else:
        v_init_n = (np.asarray(v_init, np.float64) + centroid) / scale
    sigma2_init_n = None if sigma2_init is None \
        else float(sigma2_init) / scale ** 2
    extra_n = None
    if extra is not None:
        extra_n = (_alpha_init,
                   None if _sdiag_init is None
                   else np.asarray(_sdiag_init, np.float64) / scale ** 2)
    bc = CombinedBCPD((src - centroid) / scale, device=dev, **kwargs)
    bc.set_callbacks(callbacks)
    res = bc.registration((tgt - centroid) / scale, w, maxiter, tol,
                          callback_chunk=callback_chunk,
                          tf_init_params=tf_init_n, v_init=v_init_n,
                          sigma2_init=sigma2_init_n, extra_init=extra_n,
                          want_last=return_last)
    # Denormalize: y -> s R (y + v_raw) + t_raw with
    # v_raw = scale * v_hat - centroid, t_raw = scale * t_hat + centroid.
    rt = res.rigid_trans
    cen = torch.as_tensor(centroid, dtype=res.v.dtype).to(res.v.device)
    out = tf.CombinedTransformation(rt.rot, scale * rt.t + cen, rt.scale,
                                    scale * res.v - cen, dim=src.shape[1])
    sigma2_raw = getattr(bc, "_final_sigma2", None)
    if sigma2_raw is not None:
        sigma2_raw = float(sigma2_raw) * scale ** 2
    if not return_last:
        return out, sigma2_raw
    return (out, sigma2_raw, _last_state_kwargs(bc, centroid, scale),
            _rmse_info(bc))


def registration_bcpd(
    source,
    target,
    w: float = 0.0,
    maxiter: int = 50,
    tol: float = 0.001,
    callbacks: Optional[List[Callable]] = None,
    normalize: bool = True,
    callback_chunk: int = 1,
    tf_init_params=None,
    v_init=None,
    sigma2_init=None,
    device=None,
    **kwargs: Any,
) -> tf.Transformation:
    """BCPD registration, drop-in for reference probreg bcpd.py:159-185.

    Args:
        source: Source point cloud ((M, D) ndarray, tensor or Open3D cloud).
        target: Target point cloud.
        w: Weight of the uniform outlier distribution.
        maxiter: Maximum VI iterations.
        tol: Tolerance on the nearest-neighbour RMSE criterion.
        callbacks: Called with the current transformation after each
            iteration (in normalized coordinates when ``normalize`` is on).
        normalize: Register in coordinates rescaled so that the initial
            sigma2_0 = squared_kernel_sum is exactly 1, then denormalize
            the result (the reference's default; its hyperparameters are
            only well-behaved near that regime).
        callback_chunk: VI iterations queued between two host reads in
            callback mode; the callbacks still fire every iteration.
        tf_init_params / v_init / sigma2_init: Warm start in RAW
            coordinates: {'rot', 't', 'scale'}, the (M, D) displacement
            field and the starting variance.
        device: Device to run on (default ``config.device``, "cuda"). A
            missing CUDA device raises instead of running on the CPU.

    Keyword Args:
        lmd, k, gamma, rank: as ``CombinedBCPD`` takes them.
        n_starts (int): VI restarts over the orientation grid (3-D,
            normalized, no callbacks, no warm start); the least final
            NN-RMSE wins.

    Returns:
        CombinedTransformation: the estimated transformation.
    """
    transf, _ = _registration_bcpd_impl(
        source, target, w=w, maxiter=maxiter, tol=tol,
        callbacks=list(callbacks or []), normalize=normalize,
        callback_chunk=callback_chunk, tf_init_params=tf_init_params,
        v_init=v_init, sigma2_init=sigma2_init, device=device, **kwargs)
    return transf


def _registration_bcpd_ragged(sources, targets, *, w, maxiter, tol, lmd, k,
                              gamma, rank, normalize, n_starts, device):
    """Ragged-batch BCPD (reference bcpd.py:1365): per-pair normalization
    on the host in float64, the masked VI of all pairs (or pairs x starts)
    in one loop, v sliced back to each pair's source."""
    from . import cost_functions as cf

    srcs = [np.asarray(interop.as_points(s, device="cpu"), np.float64)
            for s in sources]
    tgts = [np.asarray(interop.as_points(t, device="cpu"), np.float64)
            for t in targets]
    dim = srcs[0].shape[1]
    if normalize:
        cents, scales = _normalizers(srcs, tgts)
        # sigma2_0 = gamma * the normalized pair's squared-kernel sum,
        # exactly gamma: that is what the rescale enforces.
        sig0s = np.full(len(srcs), float(gamma))
    else:
        cents, scales = np.zeros((len(srcs), dim)), np.ones(len(srcs))
        sig0s = gamma * np.asarray([mu.squared_kernel_sum_np(sr, tg)
                                    for sr, tg in zip(srcs, tgts)])
    dt = _config.config.dtype
    src_p, smask = interop.pad_ragged(
        [(sr - c) / s for sr, c, s in zip(srcs, cents, scales)], dt, device)
    tgt_p, tmask = interop.pad_ragged(
        [(tg - c) / s for tg, c, s in zip(tgts, cents, scales)], dt, device)
    min_m = min(sr.shape[0] for sr in srcs)
    if rank is not None and int(rank) > min_m:
        raise ValueError(
            "rank=%d exceeds the smallest source cloud (%d points) in the "
            "ragged batch" % (int(rank), min_m))

    def dev_t(x):
        return torch.as_tensor(np.asarray(x, np.float64), dtype=dt).to(device)

    kw = dict(w=float(w), maxiter=int(maxiter), tol=float(tol),
              rank=None if rank is None else int(rank),
              block=int(_config.config.estep_chunk), smasks=smask,
              tmasks=tmask, min_m=None if rank is None else min_m)
    if n_starts > 1:
        rot, t, scale, v, *_ = _run_bcpd_multistart_batch(
            src_p, tgt_p, dev_t(gamma), dev_t(lmd), dev_t(k),
            cf.RigidCostFunction.initial_multistart_rots(int(n_starts), dim),
            **kw)
    else:
        rot, t, scale, v = _run_bcpd_batch(
            src_p, tgt_p, dev_t(sig0s), dev_t(lmd), dev_t(k), **kw)
    return _denormalized(rot, t, scale, v, cents, scales,
                         [sr.shape[0] for sr in srcs])


def registration_bcpd_batch(
    sources,
    targets,
    w: float = 0.0,
    maxiter: int = 50,
    tol: float = 0.001,
    lmd: float = 2.0,
    k: float = 1.0e20,
    gamma: float = 1.0,
    rank=None,
    normalize: bool = True,
    n_starts: int = 1,
    device=None,
) -> List[tf.CombinedTransformation]:
    """Register B cloud pairs with BCPD in one VI loop (reference
    bcpd.py:1225; the reference's registration_bcpd takes one pair).

    Args:
        sources: (B, M, D) or a list of (M_b, D) clouds.
        targets: (B, N, D) or a list of (N_b, D) clouds. Lists of clouds
            of different sizes are a ragged batch: zero-padded, with masks
            under which padded points carry no posterior mass and the
            Dirichlet and outlier normalizers and the Nystrom landmarks use
            the true counts.
        w, maxiter, tol, lmd, k, gamma, rank, normalize: as
            :func:`registration_bcpd` takes them, for every pair; each pair
            is normalized on its own (on the host, in float64).
        n_starts: VI restarts over the orientation grid for every pair
            (normalized only; a fixed batch 3-D only): B x S rows in one
            loop, each pair's least final NN-RMSE wins.
        device: Device to run on (default ``config.device``, "cuda"). A
            missing CUDA device raises instead of running on the CPU.

    All rows run in one loop, one host read per iteration for all of them;
    a row whose criterion has converged keeps its state while the others
    go on.

    Returns:
        A list of B CombinedTransformations; each ``v`` has its source's
        true size.
    """
    dev = _config.resolve_device(device)
    ragged = isinstance(sources, (list, tuple)) \
        or isinstance(targets, (list, tuple))
    if n_starts > 1 and not normalize:
        raise ValueError("n_starts > 1 requires the normalized path")
    if n_starts > 1 and not ragged:
        return _registration_bcpd_multistart_batch(
            sources, targets, w=w, maxiter=maxiter, tol=tol,
            n_starts=n_starts, device=dev, lmd=lmd, k=k, gamma=gamma,
            rank=rank)[0]
    if ragged:
        return _registration_bcpd_ragged(
            list(sources), list(targets), w=w, maxiter=maxiter, tol=tol,
            lmd=lmd, k=k, gamma=gamma, rank=rank, normalize=normalize,
            n_starts=n_starts, device=dev)
    src = np.asarray(interop.as_points(sources, device="cpu"), np.float64)
    tgt = np.asarray(interop.as_points(targets, device="cpu"), np.float64)
    bsz, _, dim = src.shape
    if normalize:
        cents, scales = _normalizers(src, tgt)
    else:
        cents, scales = np.zeros((bsz, dim)), np.ones(bsz)
    dt = _config.config.dtype

    def dev_t(x):
        return torch.as_tensor(np.asarray(x, np.float64), dtype=dt).to(dev)

    src_t = dev_t((src - cents[:, None]) / scales[:, None, None])
    tgt_t = dev_t((tgt - cents[:, None]) / scales[:, None, None])
    rot, t, scale, v = _run_bcpd_batch(
        src_t, tgt_t, dev_t(gamma) * _squared_kernel_sums(src_t, tgt_t),
        dev_t(lmd), dev_t(k), w=float(w), maxiter=int(maxiter),
        tol=float(tol), rank=None if rank is None else int(rank),
        block=int(_config.config.estep_chunk))
    return _denormalized(rot, t, scale, v, cents, scales)
