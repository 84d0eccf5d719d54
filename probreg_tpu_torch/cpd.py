"""Coherent Point Drift, rigid and affine (counterpart of probreg_tpu/cpd.py).

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

``registration_cpd_batch`` registers B pairs, fixed-size or ragged, in one
launch of the same kernel where the pairs fit it.

``use_pallas`` keeps the reference's name: None picks the kernels as above,
False runs plain tensors only (no hand-written kernel anywhere on the
path), True pins the streaming E-steps to the two-pass kernels.

The plain EM loops are Python loops that read q once per iteration for the
|q - q_prev| < tol test. Nonrigid and constrained CPD, callbacks and
multistart come with later slices of the port (ROADMAP, Queue 1 item 4).
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
        raise NotImplementedError(f"_run_em_t kind {kind!r} is not ported yet")
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
        del sigma2_p
        mom = self._moments_from_estep(estep_res, self._as_points(target))
        return self._mstep(self._source, mom)

    @staticmethod
    def _moments_from_estep(estep_res, target) -> EstepMoments:
        pt1, p1, px, n_p = estep_res
        xx = (pt1 * (target * target).sum(1)).sum()
        return EstepMoments(pt1, p1, px, n_p, xx)

    @abc.abstractmethod
    def _initial_tf(self) -> tf.Transformation:
        ...

    @abc.abstractmethod
    def _mstep(self, source, mom: EstepMoments) -> MstepResult:
        ...

    def _step_aux(self) -> Dict:
        return {}

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
            # sign=+1: raw -> centred; sign=-1: centred -> raw.
            if isinstance(tr, tf.RigidTransformation):
                shift = tr.scale * (tr.rot @ cen) - cen
                return tf.RigidTransformation(tr.rot, tr.t + sign * shift,
                                              tr.scale, device=tr.device)
            shift = tr.b @ cen - cen
            return tf.AffineTransformation(tr.b, tr.t + sign * shift,
                                           device=tr.device)

        # use_pallas False: no hand-written kernel anywhere, the small E-step
        # and the sorted culled branch included. True: the two-pass kernels,
        # on sorted clouds so that their tile culling fires. None: the stash
        # kernels from culled_estep_min_pairs on.
        if self._use_pallas is None:
            presort = (_config.config.use_culled_estep
                       and source.shape[0] * target.shape[0]
                       >= _config.config.culled_estep_min_pairs)
        else:
            presort = bool(self._use_pallas)
        if presort:
            # One Morton sort enables tile culling in every E-step with no
            # per-iteration sort. Valid for rigid and affine CPD because
            # their M-steps consume the moments only through row reductions,
            # so a consistent permutation changes nothing downstream. It runs
            # before _initialize so anything derived from the source shares
            # the permutation.
            from .ops.spatial import morton_order

            source = source[morton_order(source)]
            target = target[morton_order(target)]
        step_fn = partial(type(self)._STEP, assume_sorted=presort,
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

    def _mstep(self, source, mom: EstepMoments) -> MstepResult:
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

    def _mstep(self, source, mom: EstepMoments) -> MstepResult:
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


_NOT_PORTED = ("{} is not ported to probreg_tpu_torch yet (ROADMAP.md, "
               "Queue 1 item 4); use probreg_tpu.cpd")


def registration_cpd_batch(sources, targets, tf_type_name: str = "rigid",
                           w: float = 0.0, maxiter: int = 50,
                           tol: float = 0.001, update_scale: bool = True,
                           n_starts: int = 1,
                           use_pallas: Optional[bool] = None,
                           device=None) -> List[MstepResult]:
    """Register B cloud pairs at once (reference cpd.py:1306-1431).

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
        tf_type_name: 'rigid' or 'affine' (the nonrigid kinds are not
            ported yet).
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
        update_scale, tf_init_params, sigma2_init, use_pallas: as the
            ``RigidCPD`` / ``AffineCPD`` constructors take them.

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
    elif tf_type_name in ("nonrigid", "nonrigid_constrained"):
        raise NotImplementedError(
            _NOT_PORTED.format(f"CPD kind {tf_type_name!r}"))
    else:
        raise ValueError("Unknown transformation type %s" % tf_type_name)
    return cpd.registration(target, w, maxiter, tol)
