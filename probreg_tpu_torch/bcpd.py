"""Bayesian Coherent Point Drift (variational inference, combined transform).

Counterpart of probreg_tpu/bcpd.py, the single-pair VI:

* ``bcpd_estep`` / ``combined_mstep``: the reference-shaped dense E-step
  and M-step (reference probreg bcpd.py:53-72, 125-155), kron-free; used by
  the callbacks loop.
* ``_run_bcpd``: the whole VI loop in the transposed (D, M) layout of the
  reference, with its three E-steps: dense, blocked over target columns
  (``n > config.estep_chunk``), and the tile-culled row-weighted stash
  E-step (``ops/bcpd_cuda.py``; its kernels on a CUDA device, its plain
  version on the CPU). The loop reads the NN-RMSE criterion on the host
  once per iteration, keeps the best state visited and scores the last
  iterate once more at the end.
* ``CombinedBCPD`` with the dense IMQ Gram matrix or its rank-K Nystrom
  factors (``ops/lowrank.py``), and ``registration_bcpd``.

Multistart (``n_starts > 1``), chunked callbacks (``callback_chunk > 1``)
and the batch entry point are not ported yet and raise
``NotImplementedError``. The reference's worker-fault guards
(``_hw_guard``, the callback-size refusal) act only on a TPU backend and
have no counterpart here.
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
_NOT_PORTED = ("{} is not ported to probreg_tpu_torch yet (ROADMAP.md, "
               "Queue 1 item 9); use probreg_tpu.bcpd")


def _svd_rotation(s_xu: torch.Tensor) -> torch.Tensor:
    """phi diag(1, .., det(phi psih)) psih from the SVD of s_xu."""
    phi, _, psih = torch.linalg.svd(s_xu, full_matrices=True)
    c = torch.ones(s_xu.shape[0], dtype=s_xu.dtype, device=s_xu.device)
    c[-1] = torch.linalg.det(phi @ psih)
    return (phi * c) @ psih


def _digamma_alpha(k, nu, k_m, n_p):
    """exp(digamma(k + nu) - digamma(k m + n_p)): the mixing weights."""
    return torch.exp(torch.special.digamma(k + nu)
                     - torch.special.digamma(k_m + n_p))


def bcpd_estep(t_source, target, scale, alpha, sigma_mat_diag, sigma2,
               w=0.0) -> EstepResult:
    """BCPD E-step moments (reference bcpd.py:82), dense:

    pmat_mj = (1-w) alpha_m exp(-|x_j - y_m|^2 / 2s2) / (2 pi s2)^(D/2)
              * exp(-scale^2 / (2 s2) * Sigma_mm * D)
    den_j   = w / N + sum_m pmat_mj
    """
    dim = t_source.shape[1]
    n = target.shape[0]
    d2 = pairwise.sqdist(t_source, target)
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
    return EstepResult(nu_d, nu, torch.clamp(nu.sum(), min=_EPS), px, x_hat)


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
                m_eff=None, e1=None, t_src_t=None, v_prev_t=None):
    """CombinedBCPD M-step in the transposed (D, M) layout from the E-step
    moments (px_t, nu, s1) (reference bcpd.py:210). ``gmat`` dense or
    (u, lam). ``m_eff``: the true source count feeding the Dirichlet
    normalizer (default M).

    sigma2, two forms:

    * residual form (``e1`` given, with ``t_src_t`` and ``v_prev_t``):
      e1 = sum p |x - y|^2 from the E-step, corrected for the v update the
      reference applies between E-step and sigma2 (delta_m = scale R
      (v_new - v_prev)_m):
      e1 - 2 sum_m (px_m - nu_m y_m) . delta_m + sum_m nu_m |delta_m|^2,
      every term O(residual), no cancellation;
    * expanded form (``e1`` None): the reference's s1 - 2 s2 + s3.

    Both keep the f32 eps floor as a backstop."""
    dim, m = ys_t.shape
    if m_eff is None:
        m_eff = m
    n_p = torch.clamp(nu.sum(), min=_EPS)
    x_hat_t = px_t / torch.clamp(nu, min=_EPS)[None, :]
    s2s2 = scale ** 2 / (sigma2 ** 2)
    residual_t = rot.T @ ((x_hat_t - t[:, None]) / scale) - ys_t
    if isinstance(gmat, (tuple, list)):
        umat, lam = gmat
        s_core, sigma_diag_new = _lowrank.regularized_sigma(
            umat, lam, nu, s2s2, lmd)
        v_new_t = (s2s2 / lmd) * (
            ((residual_t * nu[None, :]) @ umat) @ s_core) @ umat.T
    else:
        shifted = lmd * torch.eye(m, dtype=ys_t.dtype, device=ys_t.device) \
            + s2s2 * gmat * nu[None, :]
        sigma_mat = torch.linalg.solve(shifted, gmat)
        sigma_mat = 0.5 * (sigma_mat + sigma_mat.T)
        sigma_diag_new = torch.diagonal(sigma_mat)
        v_new_t = s2s2 * ((residual_t * nu[None, :]) @ sigma_mat)
    u_hat_t = ys_t + v_new_t
    alpha_new = _digamma_alpha(k, nu, k * m_eff, n_p)
    x_m = x_hat_t @ nu / n_p
    sigma2_m = (nu * sigma_diag_new).sum() / n_p
    u_m = u_hat_t @ nu / n_p
    u_hm = u_hat_t - u_m[:, None]
    s_xu = ((x_hat_t - x_m[:, None]) * nu[None, :]) @ u_hm.T
    s_uu = (u_hm * nu[None, :]) @ u_hm.T / n_p \
        + sigma2_m * torch.eye(dim, dtype=ys_t.dtype, device=ys_t.device)
    s_xu = s_xu / n_p
    rot_new = _svd_rotation(s_xu)
    scale_new = torch.trace(rot_new @ s_xu) / torch.trace(s_uu)
    t_new = x_m - scale_new * rot_new @ u_m
    if e1 is not None:
        delta_t = scale * (rot @ (v_new_t - v_prev_t))
        r_t = px_t - nu[None, :] * t_src_t
        numer = (e1 - 2.0 * (r_t * delta_t).sum()
                 + (nu * (delta_t * delta_t).sum(0)).sum())
    else:
        y_hat_t = scale * rot @ (ys_t + v_new_t) + t[:, None]
        s2v = (px_t * y_hat_t).sum()
        s3 = (nu * (y_hat_t * y_hat_t).sum(0)).sum()
        numer = s1 - 2.0 * s2v + s3
    sigma2_new = torch.clamp(numer / (n_p * dim) + scale_new ** 2 * sigma2_m,
                             min=_EPS)
    return (rot_new, t_new, scale_new, v_new_t, sigma_diag_new, alpha_new,
            sigma2_new)


def _estep_cols(t_src_t, y2, row, sigma2, xs_b, v_b, w_over_n):
    """Moments (C, M), per-source-row min d2 and e1 = sum p d2 of one (M, B)
    block of the posterior (reference bcpd.py:377), d2 in the expanded form
    the reference uses."""
    dim = t_src_t.shape[0]
    x2b = (xs_b * xs_b).sum(0, keepdim=True)
    d2 = torch.clamp(y2 + x2b - 2.0 * (t_src_t.T @ xs_b), min=0.0)
    dmin = d2.amin(1)
    g = torch.exp(-d2 / (2.0 * sigma2)) / (2.0 * math.pi * sigma2) ** (
        dim * 0.5)
    pmat = g * row[:, None]
    den = w_over_n + pmat.sum(0, keepdim=True)
    den = torch.where(den == 0.0, _EPS, den)
    pmat = pmat / den
    return v_b @ pmat.T, dmin, (pmat * d2).sum()


def _estep_all(t_src_t, xs_t, v_chan, row, sigma2, w_over_n, block):
    """_estep_cols over all targets, in column blocks of ``block``."""
    y2 = (t_src_t * t_src_t).sum(0)[:, None]
    mom = minrow = e1 = None
    for c0 in range(0, xs_t.shape[1], block):
        mom_b, dmin, e1_b = _estep_cols(t_src_t, y2, row, sigma2,
                                        xs_t[:, c0:c0 + block],
                                        v_chan[:, c0:c0 + block], w_over_n)
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


def _run_bcpd(source, target, gmat, lmd, k, sigma2_0, *, w, maxiter, tol,
              block=None, use_culled=False, init_params=None):
    """The whole VI loop in transposed (D, M) layout (reference
    bcpd.py:313): (transformation, sigma_diag, alpha, sigma2, rmse, last).

    ``gmat``: the dense (M, M) IMQ Gram matrix or its ``(u, lam)`` Nystrom
    factors. The E-step is dense, blocked over target columns when
    N > ``block`` (default ``config.estep_chunk``), or the tile-culled
    row-weighted E-step when ``use_culled`` (the caller Morton-sorted both
    clouds). ``init_params``: optional ``(rot0, t0, scale0, v0_t)`` or
    ``(rot0, t0, scale0, v0_t, alpha0, sdiag0)`` warm start in the frame of
    ``source`` / ``target`` (``v0_t`` (D, M) or None; alpha0 / sdiag0 may be
    None).

    The loop stops at ``maxiter`` or, from the third iteration on, when the
    NN-RMSE criterion moves less than ``tol``. It keeps the best state
    visited by that criterion; the last iterate is scored once more after
    the loop and the better of the two is returned. ``last`` is the raw
    final iterate (rot, t, scale, v_t, sigma2, sigma_diag, alpha, rmse).
    """
    m, dim = source.shape
    n = target.shape[0]
    dt, dev = source.dtype, source.device
    ys_t, xs_t = source.T, target.T
    x2 = (xs_t * xs_t).sum(0, keepdim=True)
    # Channels [x (D); ones; |x|^2]: the moments give px_t (D, M), nu (M)
    # and sum_j p_ij |x_j|^2, whose total is s1.
    v_chan = torch.cat([xs_t, torch.ones_like(x2), x2], dim=0)
    block = int(_config.config.estep_chunk) if block is None else int(block)
    block = max(min(block, n), 1)
    w_over_n = w / n

    def estep(t_src_t, row, sigma2):
        if use_culled:
            rowlog = _culled_rowlog(row, dim, sigma2)
            _, mom, minrow, e1 = bcpd_cuda.bcpd_estep_culled(
                t_src_t.T, target, rowlog, v_chan, w_over_n, sigma2)
            return mom, minrow, e1
        return _estep_all(t_src_t, xs_t, v_chan, row, sigma2, w_over_n,
                          block)

    def as_t(x):
        if isinstance(x, np.ndarray):
            x = np.array(x)  # a writable copy (broadcast views are not)
        return torch.as_tensor(x, dtype=dt).to(dev)

    alpha = torch.full((m,), 1.0 / m, dtype=dt, device=dev)
    sigma_diag = torch.ones((m,), dtype=dt, device=dev)
    if init_params is None:
        rot = torch.eye(dim, dtype=dt, device=dev)
        t = torch.zeros(dim, dtype=dt, device=dev)
        scale = torch.ones((), dtype=dt, device=dev)
        v_t = torch.zeros_like(ys_t)
    else:
        rot, t, scale = (as_t(x) for x in init_params[:3])
        v_t = torch.zeros_like(ys_t) if init_params[3] is None \
            else as_t(init_params[3])
        if len(init_params) == 6:
            if init_params[4] is not None:
                alpha = as_t(init_params[4])
            if init_params[5] is not None:
                sigma_diag = as_t(init_params[5])
    sigma2 = as_t(sigma2_0)
    best = (rot, t, scale, v_t, sigma2)
    best_rmse = math.inf
    rmse, rmse_prev, i = math.inf, math.inf, 0
    while i < maxiter and (i < 2 or abs(rmse - rmse_prev) >= tol):
        t_src_t = scale * rot @ (ys_t + v_t) + t[:, None]
        row = (1.0 - w) * alpha * torch.exp(
            -(scale ** 2) / (2.0 * sigma2) * sigma_diag * dim)
        mom, minrow, e1 = estep(t_src_t, row, sigma2)
        rmse_t = torch.sqrt(minrow).mean()
        px_t, nu, s1 = mom[:dim], mom[dim], mom[dim + 1].sum()
        (rot_n, t_n, scale_n, v_n, sigma_diag, alpha, sigma2_n) = _vi_mstep_t(
            ys_t, rot, t, scale, sigma2, gmat, lmd, k, px_t, nu, s1,
            e1=e1, t_src_t=t_src_t, v_prev_t=v_t)
        # rmse scores the INCOMING state; the VI keeps trading scale
        # against v after convergence, so the last iterate can be worse
        # than one it passed through.
        rmse_prev, rmse = rmse, float(rmse_t)
        if rmse < best_rmse:
            best, best_rmse = (rot, t, scale, v_t, sigma2), rmse
        rot, t, scale, v_t, sigma2 = rot_n, t_n, scale_n, v_n, sigma2_n
        i += 1
    log.debug("BCPD VI: %d iterations, criterion %s", i, rmse)

    # Score the last iterate once, at the start temperature with unit row
    # weights, and keep the better of (last, best visited).
    t_src_t = scale * rot @ (ys_t + v_t) + t[:, None]
    sigma2_0 = as_t(sigma2_0)
    row1 = torch.ones((m,), dtype=dt, device=dev)
    _, minrow, _ = estep(t_src_t, row1, sigma2_0)
    rmse_last = float(torch.sqrt(minrow).mean())
    last = (rot, t, scale, v_t, sigma2, sigma_diag, alpha, rmse_last)
    if not rmse_last <= best_rmse:
        rot, t, scale, v_t, sigma2 = best
    rmse = min(rmse_last, best_rmse)
    return (tf.CombinedTransformation(rot, t, scale, v_t.T, dim=dim),
            sigma_diag, alpha, sigma2, rmse, last)


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
        if int(callback_chunk) > 1:
            raise NotImplementedError(_NOT_PORTED.format(
                "callback_chunk > 1"))
        return self._registration_loop(target, w, maxiter, tol)

    @abc.abstractmethod
    def _registration_jit(self, target, w, maxiter, tol,
                          tf_init_params=None, v_init=None,
                          sigma2_init=None, extra_init=None,
                          want_last=False):
        ...

    @abc.abstractmethod
    def _registration_loop(self, target, w, maxiter, tol):
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

    def _registration_loop(self, target, w, maxiter, tol):
        """The callbacks loop (reference bcpd.py:838, callback_chunk 1):
        the dense reference-shaped E- and M-steps, the callbacks after each
        M-step, the NN-RMSE stop test on the host."""
        res = self._initialize(target)
        rmse = None
        for i in range(maxiter):
            t_source = res.transformation._transform(self._source)
            est = self.expectation_step(
                t_source, target, res.transformation.rigid_trans.scale,
                res.alpha, res.sigma_mat, res.sigma2, w)
            res = self.maximization_step(
                target, res.transformation.rigid_trans, est, res.sigma2)
            for c in self._callbacks:
                c(res.transformation)
            tmp_rmse = float(mu.compute_rmse(t_source, target))
            log.debug("Iteration: {}, Criteria: {}".format(i, tmp_rmse))
            if rmse is not None and abs(rmse - tmp_rmse) < tol:
                break
            rmse = tmp_rmse
        return res.transformation


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
    if int(kwargs.pop("n_starts", 1)) > 1:
        raise NotImplementedError(_NOT_PORTED.format("n_starts > 1"))
    src = np.asarray(interop.as_points(source, device="cpu"), np.float64)
    tgt = np.asarray(interop.as_points(target, device="cpu"), np.float64)
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
        callback_chunk: Only 1 is ported; larger values raise.
        tf_init_params / v_init / sigma2_init: Warm start in RAW
            coordinates: {'rot', 't', 'scale'}, the (M, D) displacement
            field and the starting variance.
        device: Device to run on (default ``config.device``, "cuda"). A
            missing CUDA device raises instead of running on the CPU.

    Keyword Args:
        lmd, k, gamma, rank: as ``CombinedBCPD`` takes them.

    Returns:
        CombinedTransformation: the estimated transformation.
    """
    transf, _ = _registration_bcpd_impl(
        source, target, w=w, maxiter=maxiter, tol=tol,
        callbacks=list(callbacks or []), normalize=normalize,
        callback_chunk=callback_chunk, tf_init_params=tf_init_params,
        v_init=v_init, sigma2_init=sigma2_init, device=device, **kwargs)
    return transf


def registration_bcpd_batch(*args, **kwargs):
    """Not ported yet (reference bcpd.py:1225)."""
    raise NotImplementedError(_NOT_PORTED.format("registration_bcpd_batch"))
