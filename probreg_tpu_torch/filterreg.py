"""Rigid FilterReg, pt2pt and pt2pl (counterpart of probreg_tpu/filterreg.py).

The E-step moments M0, M1, M2 and NX of each source point are exact Gauss
transforms of the target (ops/gausstransform.filterreg_moments), as in the
reference's default ``estep_method='dense'``. ``registration_filterreg``
splits by size as the reference does (filterreg.py:555-822):

* a 3-D pair from the identity with M * N <= ``config.fused_em_max_pairs``
  (and the kernel's shared-memory gate): the whole EM in one launch of the
  whole-EM kernel (ops/frg_cuda.py);
* up to ``config.transposed_em_max_pairs``: the whole-EM dense loop
  ``_run_em_rigid``, which holds the (M, N) Gaussian;
* above it: the streaming loop ``_run_em_rigid_streaming``. Both clouds are
  Morton-sorted once, so from ``config.culled_estep_min_pairs`` on every
  E-step is one launch of the tile-culled Gauss transform
  (ops/gt_cuda.py).

``registration_filterreg_batch`` registers B pairs, fixed-size or ragged,
in one launch of the whole-EM kernel where the pairs fit it.

``use_pallas`` keeps the reference's name: False keeps pairs off the
whole-EM kernel (the dense loop runs instead); the streaming E-step's
Gauss transform follows its own size gate, as in the reference.

The EM loops are Python loops that read q once per iteration for the
|q - q_prev| < tol test. ``callbacks`` run the reference's host loop over
``expectation_step`` / ``maximization_step``. The permutohedral lattice
E-step, the deformable-kinematic model, feature functions, multistart and
chunked callbacks come with later slices of the port (ROADMAP, Queue 1
item 6).
"""

from __future__ import annotations

import abc
import math
from collections import namedtuple
from typing import Any, Callable, List, Optional

import torch

from . import config as _config
from .cpd import _converged
from .log import log
from .models import transformation as tf
from .ops import gausstransform as gto
from .ops import pairwise as _pw
from .ops import rigid_solvers
from .utils import interop
from .utils import math_utils as mu
from .utils import se3_op as so

EstepResult = namedtuple("EstepResult", ["m0", "m1", "m2", "nx"])
MstepResult = namedtuple("MstepResult", ["transformation", "sigma2", "q"])
MstepResult.__doc__ = """Result of Maximization step.

    Attributes:
        transformation (tf.Transformation): Transformation from source to target.
        sigma2 (float): Variance of Gaussian distribution.
        q (float): Result of likelihood.
"""

_EPS = float(torch.finfo(torch.float32).eps)
_OBJECTIVES = ("pt2pt", "pt2pl")
_NOT_PORTED = ("{} is not ported to probreg_tpu_torch yet (ROADMAP.md, "
               "Queue 1 item 6); use probreg_tpu.filterreg")


def _check_objective(objective_type, normals):
    if objective_type not in _OBJECTIVES:
        raise ValueError("Unknown objective_type: %s." % objective_type)
    if objective_type == "pt2pl" and normals is None:
        raise ValueError("pt2pl requires target_normals.")


# --------------------------------------------------------------------------
# M-step math (reference filterreg.py:78-131)
# --------------------------------------------------------------------------

def _weights(m0, c, sigma2):
    """(mask, max(m0, eps), m0 / max(m0 + c, eps), drxdx). The m0 + c guard
    keeps rows with exactly zero mass (culled or padded, w = 0) out of
    0/0."""
    mask = (m0 > 0.0).to(m0.dtype)
    m0m0 = m0 / torch.clamp(m0 + c, min=_EPS)
    return (mask, torch.clamp(m0, min=_EPS), m0m0,
            mask * torch.sqrt(m0m0 / sigma2))


def rigid_mstep_pt2pt(t_source, m0, m1, m2, rot_p, t_p, sigma2, c):
    """Weighted Kabsch on the virtual targets m1 / m0 (reference
    filterreg.py:78): (rot, t, sigma2 updated or as given, q)."""
    mask, m0s, m0m0, drxdx = _weights(m0, c, sigma2)
    m1m0 = m1 / m0s[:, None]
    dr, dt = rigid_solvers.weighted_kabsch(t_source, m1m0, drxdx)
    q = torch.linalg.norm(drxdx[:, None] * (t_source - m1m0), dim=1).sum()
    sigma2_new = _sigma2_update(t_source, m0, m1, m2, m0m0, c, mask, sigma2)
    return dr @ rot_p, t_p @ dr.T + dt, sigma2_new, q


def rigid_mstep_pt2pl(t_source, m0, m1, m2, nx, rot_p, t_p, sigma2, c):
    """One point-to-plane Gauss-Newton twist step (reference
    filterreg.py:99)."""
    mask, m0s, m0m0, drxdx = _weights(m0, c, sigma2)
    tw, q = rigid_solvers.twist_for_pt2pl(t_source, m1 / m0s[:, None],
                                          nx / m0s[:, None], drxdx)
    rot, t = so.twist_mul(tw, rot_p, t_p)
    sigma2_new = _sigma2_update(t_source, m0, m1, m2, m0m0, c, mask, sigma2)
    return rot, t, sigma2_new, q


def _sigma2_update(t_source, m0, m1, m2, m0m0, c, mask, sigma2_old):
    """Reference filterreg.py:112; returns ``sigma2_old`` when m2 is None.
    Divides by the cloud's dimension (the reference's own deviation from
    the original's fixed 3)."""
    if m2 is None:
        return sigma2_old
    dim = t_source.shape[1]
    num = (m0 * (t_source * t_source).sum(1)
           - 2.0 * (t_source * m1).sum(1) + m2)
    s2 = (mask * num / torch.clamp(m0 + c, min=_EPS)).sum()
    return s2 / (dim * torch.clamp((mask * m0m0).sum(), min=_EPS))


def _outlier_c(sigma2, w, m, n, dim):
    """FilterReg outlier constant (reference filterreg.py:129)."""
    return w / (1.0 - w) * n / m * (2.0 * sigma2 * math.pi) ** (dim / 2.0)


# --------------------------------------------------------------------------
# Whole-EM dense loop in transposed (D, M) layout
# --------------------------------------------------------------------------

def _mstep_from_moments_t(t_src, m0, m1_t, m2, nx_t, rot, t, sigma2, w, m,
                          n, dim, objective_type):
    """Rigid M-step from (D, M) moments (reference filterreg.py:195):
    (rot, t, sigma2 re-estimated iff m2 is given, q). The reference's
    (D, M)-layout solvers ``_kabsch_t`` / ``_pt2pl_t`` exist for the TPU's
    relayout cost; here the row-major solvers take the transposes."""
    c = _outlier_c(sigma2, w, m, n, dim)
    mask, m0s, m0m0, drxdx = _weights(m0, c, sigma2)
    m1m0_t = m1_t / m0s[None, :]
    if objective_type == "pt2pt":
        dr, dt = rigid_solvers.weighted_kabsch(t_src.T, m1m0_t.T, drxdx)
        q = torch.sqrt(((drxdx[None, :] * (t_src - m1m0_t)) ** 2).sum(0)).sum()
        rot_n, t_n = dr @ rot, dr @ t + dt
    else:
        tw, q = rigid_solvers.twist_for_pt2pl(t_src.T, m1m0_t.T,
                                              (nx_t / m0s[None, :]).T, drxdx)
        rot_n, t_n = so.twist_mul(tw, rot, t)
    return rot_n, t_n, _sigma2_update(t_src.T, m0, m1_t.T, m2, m0m0, c,
                                      mask, sigma2), q


def _anneal(s2, sigma2, update_sigma2, sigma2_decay, min_sigma2):
    """Next iteration's sigma2: the M-step's estimate or the decayed one,
    floored at min_sigma2."""
    if not update_sigma2:
        s2 = sigma2 * sigma2_decay
    return torch.clamp(s2, min=min_sigma2)


def _auto_sigma2(source, target, objective_type, min_sigma2, smask=None,
                 tmask=None):
    """Starting sigma2 when none is given (reference filterreg.py:280-305,
    :802-817). pt2pt: the mean pairwise squared distance / D, floored at
    min_sigma2. pt2pl: the target's mean squared nearest-neighbour spacing,
    floored at min_sigma2 / 100; at the cloud-size scale the smoothed
    virtual targets sit inside the surface and pt2pl diverges. Optional
    0/1 masks leave padded points out and count the true sizes."""
    if objective_type == "pt2pl":
        if tmask is None:
            s2 = _pw.point_spacing_sq(target)
        else:
            nn2 = _pw.nearest_sqdist(target, target, exclude_zero=True,
                                     target_valid=tmask)
            nn2 = torch.where(torch.isfinite(nn2), nn2, 0.0) * tmask
            s2 = nn2.sum() / tmask.sum()
        return torch.clamp(s2, min=min_sigma2 * 0.01)
    if tmask is None:
        s2 = mu.squared_kernel_sum(source, target)
    else:
        s2 = mu.masked_squared_kernel_sum_t(source.T, target.T, smask, tmask)
    return torch.clamp(s2, min=min_sigma2)


def _run_em_rigid(source, target, normals, rot0, t0, sigma2_0, *,
                  objective_type, update_sigma2, w, maxiter, tol, min_sigma2,
                  sigma2_decay=1.0, auto_sigma2=False, smask=None,
                  tmask=None):
    """Whole-EM rigid FilterReg with the dense (M, N) Gaussian (reference
    filterreg.py:234).

    Both clouds are centred on their shared centroid (the transforms
    convert in and out), and all moments come from one (C, N) x (M, N)^T
    product with the channels [1, x, |x|^2, normals]. ``smask`` / ``tmask``:
    optional (M,) / (N,) 0/1 masks (ragged-batch padding): padded points
    carry no mass and the outlier constant and automatic sigma2 use the
    true counts, which is the registration of the pair without its
    padding. Returns MstepResult(RigidTransformation(rot, t), sigma2, q).
    """
    m, dim = source.shape
    n = target.shape[0]
    dev, dt = source.device, source.dtype
    masked = smask is not None
    ys_t, xs_t = source.T, target.T
    if masked:
        cen = (ys_t @ smask + xs_t @ tmask) / torch.clamp(
            smask.sum() + tmask.sum(), min=1.0)
    else:
        cen = (ys_t.sum(1) + xs_t.sum(1)) / (m + n)
    ys_t = ys_t - cen[:, None]
    xs_t = xs_t - cen[:, None]
    rot = torch.as_tensor(rot0, dtype=dt, device=dev)
    t = torch.as_tensor(t0, dtype=dt, device=dev)
    t = t + rot @ cen - cen
    x2 = (xs_t * xs_t).sum(0, keepdim=True)                  # (1, N)
    if masked:
        m, n = smask.sum(), tmask.sum()
        kmask = smask[:, None] * tmask[None, :]
    chans = [torch.ones_like(x2), xs_t]
    if update_sigma2:
        chans.append(x2)
    if objective_type == "pt2pl":
        chans.append(normals.T.to(dt))
    v_t = torch.cat(chans)                                   # (C, N)

    if auto_sigma2:
        sigma2 = _auto_sigma2(ys_t.T, xs_t.T, objective_type, min_sigma2,
                              smask, tmask)
    else:
        sigma2 = torch.as_tensor(sigma2_0, dtype=dt, device=dev)

    q = torch.tensor(math.inf, dtype=dt, device=dev)
    q_prev, i = math.inf, 0
    while True:
        done, q_prev_next = _converged(i, q, q_prev, maxiter, tol)
        if done:
            break
        t_src = rot @ ys_t + t[:, None]                      # (D, M)
        y2 = (t_src * t_src).sum(0)[:, None]
        k = torch.exp(-torch.clamp(y2 + x2 - 2.0 * (t_src.T @ xs_t),
                                   min=0.0) * (0.5 / sigma2))
        if masked:
            k = k * kmask
        mom = v_t @ k.T                                      # (C, M)
        col = 1 + dim
        m2 = None
        if update_sigma2:
            m2 = mom[col]
            col += 1
        nx_t = mom[col:col + dim] if objective_type == "pt2pl" else None
        rot, t, s2, q = _mstep_from_moments_t(
            t_src, mom[0], mom[1:1 + dim], m2, nx_t, rot, t, sigma2, w, m, n,
            dim, objective_type)
        sigma2 = _anneal(s2, sigma2, update_sigma2, sigma2_decay, min_sigma2)
        q_prev, i = q_prev_next, i + 1
    t = t + cen - rot @ cen                      # centred -> raw frame
    return MstepResult(tf.RigidTransformation(rot, t, device=dev), sigma2, q)


def _run_em_rigid_streaming(source, target, normals, rot0, t0, sigma2_0, *,
                            objective_type, update_sigma2, w, maxiter, tol,
                            min_sigma2, sigma2_decay=1.0, auto_sigma2=False):
    """Whole-EM rigid FilterReg for large clouds (reference
    filterreg.py:377): never forms the (M, N) Gaussian. Both clouds are
    Morton-sorted once, outside the loop, and every E-step is
    ``filterreg_moments(..., assume_sorted=True)``, which from
    ``config.culled_estep_min_pairs`` on is one launch of the tile-culled
    Gauss transform. The M-step reads only order-invariant sums of the
    per-row moments, so nothing is unsorted."""
    from .ops.spatial import morton_order

    m, dim = source.shape
    n = target.shape[0]
    dev, dt = source.device, source.dtype
    source = source[morton_order(source)]
    perm_t = morton_order(target)
    target = target[perm_t]
    if normals is not None:
        normals = normals[perm_t]
    if auto_sigma2:
        sigma2 = _auto_sigma2(source, target, objective_type, min_sigma2)
    else:
        sigma2 = torch.as_tensor(sigma2_0, dtype=dt, device=dev)
    rot = torch.as_tensor(rot0, dtype=dt, device=dev)
    t = torch.as_tensor(t0, dtype=dt, device=dev)
    q = torch.tensor(math.inf, dtype=dt, device=dev)
    q_prev, i = math.inf, 0
    while True:
        done, q_prev_next = _converged(i, q, q_prev, maxiter, tol)
        if done:
            break
        t_src = source @ rot.T + t
        sigma = torch.sqrt(sigma2)
        m0, m1, m2, nx = gto.filterreg_moments(
            t_src / sigma, target / sigma, target,
            normals if objective_type == "pt2pl" else None,
            need_m2=bool(update_sigma2), assume_sorted=True)
        c = _outlier_c(sigma2, w, m, n, dim)
        if objective_type == "pt2pt":
            rot, t, s2, q = rigid_mstep_pt2pt(t_src, m0, m1, m2, rot, t,
                                              sigma2, c)
        else:
            rot, t, s2, q = rigid_mstep_pt2pl(t_src, m0, m1, m2, nx, rot, t,
                                              sigma2, c)
        sigma2 = _anneal(s2, sigma2, update_sigma2, sigma2_decay, min_sigma2)
        q_prev, i = q_prev_next, i + 1
    return MstepResult(tf.RigidTransformation(rot, t, device=dev), sigma2, q)


def _stack_runs(runs):
    return (torch.stack([r.transformation.rot for r in runs]),
            torch.stack([r.transformation.t for r in runs]),
            torch.stack([r.sigma2 for r in runs]),
            torch.stack([r.q for r in runs]))


def _run_em_rigid_batch(sources, targets, normals, sigma2_0, smasks=None,
                        tmasks=None, **kw):
    """``_run_em_rigid`` from the identity over a (B, M, D) x (B, N, D)
    batch, pair by pair, with optional (B, M) / (B, N) masks for a padded
    ragged batch (reference filterreg.py:1299 and :1404, its
    ``_run_em_rigid_ragged_batch``): stacked (rot, t, sigma2, q)."""
    dim = sources.shape[-1]
    eye = torch.eye(dim, dtype=sources.dtype, device=sources.device)
    zero = sources.new_zeros(dim)
    runs = []
    for b in range(sources.shape[0]):
        masks = {} if smasks is None else dict(smask=smasks[b],
                                               tmask=tmasks[b])
        runs.append(_run_em_rigid(
            sources[b], targets[b], None if normals is None else normals[b],
            eye, zero, sigma2_0, **masks, **kw))
    return _stack_runs(runs)


# --------------------------------------------------------------------------
# Object surface (drop-in for the reference classes)
# --------------------------------------------------------------------------

def _is_identity_feature(fn: Callable) -> bool:
    """True for the default ``lambda x: x`` feature function."""
    try:
        probe = object()
        return fn(probe) is probe
    except Exception:
        return False


def _fused_batch_ok(m: int, n: int, dim: int, use_pallas) -> bool:
    """The reference's size conditions for the one-launch whole-EM kernel
    (filterreg.py:1423), less its backend test: the wrapper itself runs
    the kernel for CUDA tensors and the plain version for CPU ones."""
    from .ops import frg_cuda

    return (dim == 3 and _config.config.use_fused_em
            and use_pallas is not False
            and m * n <= _config.config.fused_em_max_pairs
            and frg_cuda.fused_dims_ok(m, n))


class FilterReg(abc.ABC):
    """Abstract FilterReg (reference filterreg.py:451).

    Args:
        source: Source point cloud.
        target_normals: Normals of the target points (pt2pl objective).
        sigma2: Fixed starting variance; None = estimated.
        update_sigma2: Update sigma2 in the M-step.
        estep_method: 'dense' (exact, the default). The reference's
            'lattice' is not ported yet.
        use_pallas: None or True: small pairs may run the whole-EM kernel;
            False keeps them on the dense loop.
        device: Device to run on (default ``config.device``).
    """

    def __init__(self, source=None, target_normals=None, sigma2=None,
                 update_sigma2: bool = False, estep_method: str = "dense",
                 use_pallas: Optional[bool] = None, device=None):
        if estep_method == "lattice":
            raise NotImplementedError(_NOT_PORTED.format(
                "estep_method='lattice' (ops/permutohedral)"))
        if estep_method != "dense":
            raise ValueError(f"unknown estep_method {estep_method!r}")
        self._device = _config.resolve_device(device)
        self._source = None if source is None else self._as_points(source)
        self._target_normals = interop.as_normals(target_normals,
                                                  device=self._device)
        self._sigma2 = sigma2
        self._update_sigma2 = update_sigma2
        self._use_pallas = use_pallas
        self._tf_type = None
        self._tf_result = None
        self._callbacks: List[Callable] = []

    def _as_points(self, x) -> torch.Tensor:
        return interop.as_points(x, device=self._device)

    def set_source(self, source):
        self._source = self._as_points(source)

    def set_target_normals(self, target_normals):
        self._target_normals = interop.as_normals(target_normals,
                                                  device=self._device)

    def set_callbacks(self, callbacks):
        self._callbacks = callbacks

    def expectation_step(self, t_source, target, y, sigma2,
                         update_sigma2=False, objective_type: str = "pt2pt",
                         alpha: float = 0.015) -> EstepResult:
        """E-step moments (reference filterreg.py:489): the filtering runs
        in the space of ``t_source`` / ``target`` scaled by 1/sigma, and the
        moments are of ``y``, the raw target points. ``alpha`` only means
        something for the lattice E-step."""
        del alpha
        t_source, target, y = (self._as_points(v) for v in
                               (t_source, target, y))
        need_nx = objective_type == "pt2pl"
        if need_nx and self._target_normals is None:
            raise ValueError("pt2pl requires target_normals.")
        sigma = torch.sqrt(torch.as_tensor(sigma2, dtype=t_source.dtype,
                                           device=self._device))
        return EstepResult(*gto.filterreg_moments(
            t_source / sigma, target / sigma, y,
            self._target_normals if need_nx else None,
            need_m2=bool(update_sigma2)))

    def maximization_step(self, t_source, target, estep_res, w=0.0,
                          objective_type: str = "pt2pt") -> MstepResult:
        return self._maximization_step(
            self._as_points(t_source), self._as_points(target), estep_res,
            self._tf_result, self._sigma2, w, objective_type=objective_type)

    @staticmethod
    @abc.abstractmethod
    def _maximization_step(t_source, target, estep_res, trans_p, sigma2,
                           w=0.0, objective_type="pt2pt"):
        ...

    def registration(self, target, w: float = 0.0,
                     objective_type: str = "pt2pt", maxiter: int = 50,
                     tol: float = 0.001, min_sigma2: float = 1.0e-4,
                     feature_fn: Callable = lambda x: x,
                     sigma2_decay: float = 1.0, n_starts: int = 1,
                     callback_chunk: int = 1) -> MstepResult:
        """Run the EM registration (reference filterreg.py:555)."""
        assert self._tf_type is not None, "transformation type is None."
        if int(n_starts) > 1:
            raise NotImplementedError(_NOT_PORTED.format("n_starts > 1"))
        if int(callback_chunk) > 1:
            raise NotImplementedError(_NOT_PORTED.format(
                "callback_chunk > 1"))
        if not _is_identity_feature(feature_fn):
            raise NotImplementedError(_NOT_PORTED.format(
                "a feature_fn (ops/fpfh)"))
        _check_objective(objective_type, self._target_normals)
        normals = self._target_normals if objective_type == "pt2pl" else None
        target = self._as_points(target)
        args = dict(objective_type=objective_type,
                    update_sigma2=bool(self._update_sigma2), w=float(w),
                    maxiter=int(maxiter), tol=float(tol),
                    min_sigma2=float(min_sigma2),
                    sigma2_decay=float(sigma2_decay))
        if self._callbacks:
            return self._registration_host_loop(target, normals, **args)
        res = self._registration_whole(target, normals, **args)
        self._tf_result = res.transformation
        self._sigma2 = float(res.sigma2)
        return res

    def _registration_whole(self, target, normals, **args) -> MstepResult:
        """The whole-EM runners; every registration without callbacks."""
        raise NotImplementedError

    def _registration_host_loop(self, target, normals, *, objective_type,
                                update_sigma2, w, maxiter, tol, min_sigma2,
                                sigma2_decay):
        """One E-step and M-step per host iteration, the callbacks after
        each (reference filterreg.py:881)."""
        if self._sigma2 is None:
            self._sigma2 = float(_auto_sigma2(self._source, target,
                                              objective_type, min_sigma2))
        q = None
        res = MstepResult(self._tf_result, self._sigma2, None)
        for i in range(maxiter):
            t_source = self._tf_result._transform(self._source)
            estep_res = self.expectation_step(
                t_source, target, target, self._sigma2, update_sigma2,
                objective_type)
            res = self.maximization_step(t_source, target, estep_res, w=w,
                                         objective_type=objective_type)
            if res.q is None:
                res = res._replace(q=q)
                break
            self._tf_result = res.transformation
            s2_next = (float(res.sigma2) if update_sigma2
                       else float(self._sigma2) * sigma2_decay)
            self._sigma2 = max(s2_next, min_sigma2)
            for c in self._callbacks:
                c(self._tf_result)
            log.debug("Iteration: {}, Criteria: {}".format(i, res.q))
            if q is not None and abs(float(res.q) - float(q)) < tol:
                break
            q = float(res.q)
        return res


class RigidFilterReg(FilterReg):
    """Rigid FilterReg (reference filterreg.py:1009). The dimension follows
    the source unless ``tf_init_params`` gives the start."""

    def __init__(self, source=None, target_normals=None, sigma2=None,
                 update_sigma2=False, tf_init_params=None, **kwargs):
        super().__init__(source=source, target_normals=target_normals,
                         sigma2=sigma2, update_sigma2=update_sigma2,
                         **kwargs)
        self._tf_type = tf.RigidTransformation
        params = dict(tf_init_params or {})
        params.pop("xp", None)
        self._dim_inferred = not params
        if not params and self._source is not None:
            params = {"dim": int(self._source.shape[1])}
        self._tf_result = self._tf_type(**params, device=self._device)

    def set_source(self, source):
        super().set_source(source)
        if self._dim_inferred:
            self._tf_result = self._tf_type(dim=int(self._source.shape[1]),
                                            device=self._device)

    @staticmethod
    def _maximization_step(t_source, target, estep_res, trans_p, sigma2,
                           w=0.0, objective_type="pt2pt"):
        m, dim = t_source.shape
        n = target.shape[0]
        m0, m1, m2, nx = estep_res
        if not bool((m0 > 0.0).any()):
            return MstepResult(trans_p, sigma2, None)
        sigma2 = torch.as_tensor(sigma2, dtype=t_source.dtype,
                                 device=t_source.device)
        c = _outlier_c(sigma2, w, m, n, dim)
        if objective_type == "pt2pt":
            rot, t, s2, q = rigid_mstep_pt2pt(
                t_source, m0, m1, m2, trans_p.rot, trans_p.t, sigma2, c)
        elif objective_type == "pt2pl":
            rot, t, s2, q = rigid_mstep_pt2pl(
                t_source, m0, m1, m2, nx, trans_p.rot, trans_p.t, sigma2, c)
        else:
            raise ValueError("Unknown objective_type: %s." % objective_type)
        return MstepResult(tf.RigidTransformation(rot, t,
                                                  device=t_source.device),
                           s2, q)

    def _registration_whole(self, target, normals, **args) -> MstepResult:
        m, n = self._source.shape[0], target.shape[0]
        auto = self._sigma2 is None
        sigma2_0 = 0.0 if auto else float(self._sigma2)
        if m * n > _config.config.transposed_em_max_pairs:
            return _run_em_rigid_streaming(
                self._source, target, normals, self._tf_result.rot,
                self._tf_result.t, sigma2_0, auto_sigma2=auto, **args)
        rot0, t0 = self._tf_result.rot, self._tf_result.t
        identity = (self._source.shape[1] == 3
                    and bool(torch.allclose(rot0, torch.eye(
                        3, dtype=rot0.dtype, device=rot0.device)))
                    and bool(torch.allclose(t0, torch.zeros_like(t0))))
        if identity and _fused_batch_ok(m, n, 3, self._use_pallas):
            from .ops import frg_cuda

            rot, t, sigma2, q = frg_cuda.run_em_filterreg_fused(
                self._source, target, normals, sigma2_0=sigma2_0,
                auto_sigma2=auto, objective=args.pop("objective_type"),
                **args)
            return MstepResult(tf.RigidTransformation(rot, t,
                                                      device=self._device),
                               sigma2, q)
        return _run_em_rigid(self._source, target, normals, rot0, t0,
                             sigma2_0, auto_sigma2=auto, **args)


class DeformableKinematicFilterReg(FilterReg):
    """Deformable-kinematic FilterReg (reference filterreg.py:1054): not
    ported yet; constructing one raises."""

    def __init__(self, *args, **kwargs):
        raise NotImplementedError(_NOT_PORTED.format(
            "DeformableKinematicFilterReg (utils/dualquat)"))

    @staticmethod
    def _maximization_step(*args, **kwargs):
        raise NotImplementedError


def _pad(clouds, dev):
    return interop.pad_ragged(list(clouds), device=dev)


def registration_filterreg_batch(
    sources,
    targets,
    target_normals=None,
    sigma2: Optional[float] = None,
    update_sigma2: bool = False,
    w: float = 0,
    objective_type: str = "pt2pt",
    maxiter: int = 50,
    tol: float = 0.001,
    min_sigma2: float = 1.0e-4,
    sigma2_decay: float = 1.0,
    n_starts: int = 1,
    use_pallas: Optional[bool] = None,
    device=None,
) -> List[MstepResult]:
    """Register B cloud pairs with rigid FilterReg at once (reference
    filterreg.py:1432).

    ``sources`` (B, M, D) and ``targets`` (B, N, D), plus ``target_normals``
    (B, N, D) for pt2pl, or lists of clouds with different point counts
    (zero-padded and registered with masks, which is the same as
    registering each pair without its padding). Each pair stops at its own
    convergence. 3-D pairs within ``config.fused_em_max_pairs`` run as ONE
    launch of the whole-EM kernel for the whole batch; others run the dense
    loop pair by pair. Returns a list of ``MstepResult``.
    """
    _check_objective(objective_type, target_normals)
    if int(n_starts) > 1:
        raise NotImplementedError(_NOT_PORTED.format("n_starts > 1"))
    dev = _config.resolve_device(device)
    pt2pl = objective_type == "pt2pl"
    ragged = isinstance(sources, (list, tuple)) \
        or isinstance(targets, (list, tuple))
    if ragged:
        sources, smasks = _pad(sources, dev)
        targets, tmasks = _pad(targets, dev)
        normals = _pad(target_normals, dev)[0] if pt2pl else None
    else:
        sources = interop.as_points(sources, device=dev)
        targets = interop.as_points(targets, device=dev)
        normals = interop.as_points(target_normals, device=dev) \
            if pt2pl else None
        smasks = tmasks = None
    auto = sigma2 is None
    sigma2_0 = 0.0 if auto else float(sigma2)
    args = dict(update_sigma2=bool(update_sigma2), w=float(w),
                maxiter=int(maxiter), tol=float(tol),
                min_sigma2=float(min_sigma2),
                sigma2_decay=float(sigma2_decay), auto_sigma2=auto)
    if _fused_batch_ok(sources.shape[1], targets.shape[1], sources.shape[2],
                       use_pallas):
        from .ops import frg_cuda

        rot, t, sigma2s, qs, _ = frg_cuda.run_em_filterreg_fused_batch(
            sources, targets, normals, smasks, tmasks, sigma2_0,
            objective=objective_type, **args)
    else:
        rot, t, sigma2s, qs = _run_em_rigid_batch(
            sources, targets, normals, sigma2_0, smasks, tmasks,
            objective_type=objective_type, **args)
    return [MstepResult(tf.RigidTransformation(rot[b], t[b], device=dev),
                        sigma2s[b], qs[b])
            for b in range(sources.shape[0])]


def registration_filterreg(
    source,
    target,
    target_normals=None,
    sigma2: Optional[float] = None,
    update_sigma2: bool = False,
    w: float = 0,
    objective_type: str = "pt2pt",
    maxiter: int = 50,
    tol: float = 0.001,
    min_sigma2: float = 1.0e-4,
    feature_fn: Callable = lambda x: x,
    callbacks: Optional[List[Callable]] = None,
    sigma2_decay: float = 1.0,
    n_starts: int = 1,
    callback_chunk: int = 1,
    device=None,
    **kwargs: Any,
) -> MstepResult:
    """FilterReg registration: drop-in equivalent of reference
    filterreg.py:1573.

    Args:
        source: Source point cloud ((M, D) ndarray, tensor or Open3D cloud).
        target: Target point cloud.
        target_normals: Target normals (pt2pl objective).
        sigma2: Fixed starting variance; None = estimated (pt2pt: the mean
            squared distance / D; pt2pl: the mean squared point spacing).
        update_sigma2: Update sigma2 each M-step.
        w: Weight of the uniform outlier distribution.
        objective_type: 'pt2pt' or 'pt2pl'.
        maxiter / tol / min_sigma2: EM controls.
        feature_fn: Only the identity is ported; any other raises.
        callbacks: Called with the current transformation each iteration.
        sigma2_decay: Per-iteration factor on sigma2 when ``update_sigma2``
            is False, floored at ``min_sigma2``.
        n_starts, callback_chunk: Only 1 is ported; more raises.
        device: Device to run on (default ``config.device``, "cuda"). A
            missing CUDA device raises instead of running on the CPU.

    Keyword Args:
        tf_init_params (dict): Initial rigid transformation.
        estep_method (str): 'dense' (the default; 'lattice' raises).
        use_pallas (bool): See ``FilterReg``.

    Returns:
        MstepResult: (transformation, sigma2, q).
    """
    frg = RigidFilterReg(source, target_normals, sigma2, update_sigma2,
                         device=device, **kwargs)
    frg.set_callbacks(list(callbacks or []))
    return frg.registration(
        target, w=w, objective_type=objective_type, maxiter=maxiter,
        tol=tol, min_sigma2=min_sigma2, feature_fn=feature_fn,
        sigma2_decay=sigma2_decay, n_starts=n_starts,
        callback_chunk=callback_chunk)
