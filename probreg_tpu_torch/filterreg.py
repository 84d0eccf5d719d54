"""FilterReg: rigid (pt2pt and pt2pl) and deformable-kinematic
(counterpart of probreg_tpu/filterreg.py).

The E-step moments M0, M1, M2 and NX of each source point are exact Gauss
transforms of the target (ops/gausstransform.filterreg_moments), as in the
reference's default ``estep_method='dense'``, or, with
``estep_method='lattice'``, the reference's permutohedral-lattice
approximation (ops/permutohedral.py; it underestimates the moments by a
d-dependent factor of ~0.7, so it is held to the reference's lattice, not
to the dense moments). ``registration_filterreg`` splits by size as the
reference does (filterreg.py:555-822):

* a 3-D pair from the identity with M * N <= ``config.fused_em_max_pairs``
  (and the kernel's shared-memory gate): the whole EM in one launch of the
  whole-EM kernel (ops/frg_cuda.py);
* up to ``config.transposed_em_max_pairs``: the whole-EM dense loop
  ``_run_em_rigid``, which holds the (M, N) Gaussian;
* above it: the streaming loop ``_run_em_rigid_streaming``. Both clouds are
  Morton-sorted once, so from ``config.culled_estep_min_pairs`` on every
  E-step is one launch of the tile-culled Gauss transform
  (ops/gt_cuda.py).

The other whole-EM loops: ``_run_em_rigid_lattice`` (the lattice rebuilt
every iteration), ``_run_em_rigid_feature`` (a ``feature_fn``: the E-step
in feature space, the M-step in point space, the source's features
recomputed every iteration) and ``_run_em_deformable``
(``DeformableKinematicFilterReg``: dual-quaternion blended skinning, a
Gauss-Newton M-step over all node twists; its exact E-step takes the
tile-culled kernel from M * N >= 2^28). A ``feature_fn`` may be any
callable: a numpy result is moved to the loop's device.

``registration_filterreg_batch`` registers B pairs, fixed-size or ragged,
in one launch of the whole-EM kernel where the pairs fit it.

``n_starts > 1`` (rigid, dense, no callbacks; single pairs and batches)
runs the EM from each rotation of the orientation grid about the pair's
shared centroid and keeps the start of least final sigma2 (with
``update_sigma2``) or q: for 3-D pairs within the whole-EM kernel's gate
all S starts of all B pairs are ONE launch of B S pairs, otherwise the
dense loop runs once per start.

``use_pallas`` keeps the reference's name: False keeps pairs off the
whole-EM kernel (the dense loop runs instead); the streaming E-step's
Gauss transform follows its own size gate, as in the reference.

The EM loops are Python loops that read q once per iteration for the
|q - q_prev| < tol test. ``callbacks``, and the combinations no whole-EM
loop takes (the deformable model with the lattice or a ``feature_fn``,
the lattice with a ``feature_fn``), run the reference's host loop over
``expectation_step`` / ``maximization_step``, ``callback_chunk`` K of its
steps queued between two host reads (utils/chunked.py): the callbacks see
the same transforms for every K.
"""

from __future__ import annotations

import abc
import math
from collections import namedtuple
from typing import Any, Callable, List, Optional

import numpy as np
import torch

from . import config as _config
from .cpd import _converged, _pair_centroid, first_min
from .log import log
from .models import transformation as tf
from .ops import gausstransform as gto
from .ops import pairwise as _pw
from .ops import permutohedral as phops
from .ops import rigid_solvers
from .utils import chunked
from .utils import dualquat as dq
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
# The blur switch of the lattice E-step: blur while the lattice has at
# most alpha * N vertices (reference filterreg.py:491).
_ALPHA = 0.015

# Module-level alias (reference filterreg.py:58).
dualquat_from_twist = dq.from_twist


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


def rigid_mstep_pt2pt(t_source, m0, m1, m2, rot_p, t_p, sigma2, c,
                      reduce=None):
    """Weighted Kabsch on the virtual targets m1 / m0 (reference
    filterreg.py:78): (rot, t, sigma2 updated or as given, q).
    ``reduce``: where the source rows are one shard of a mesh, sums a
    tensor of row sums over the ranks holding the other rows (the 2-D
    mesh's m axis)."""
    mask, m0s, m0m0, drxdx = _weights(m0, c, sigma2)
    m1m0 = m1 / m0s[:, None]
    dr, dt = rigid_solvers.weighted_kabsch(t_source, m1m0, drxdx, reduce)
    q = torch.linalg.norm(drxdx[:, None] * (t_source - m1m0), dim=1).sum()
    if reduce is not None:
        q = reduce(q.reshape(1))[0]
    sigma2_new = _sigma2_update(t_source, m0, m1, m2, m0m0, c, mask, sigma2,
                                reduce)
    return dr @ rot_p, t_p @ dr.T + dt, sigma2_new, q


def rigid_mstep_pt2pl(t_source, m0, m1, m2, nx, rot_p, t_p, sigma2, c,
                      reduce=None):
    """One point-to-plane Gauss-Newton twist step (reference
    filterreg.py:99); ``reduce`` as :func:`rigid_mstep_pt2pt`."""
    mask, m0s, m0m0, drxdx = _weights(m0, c, sigma2)
    tw, q = rigid_solvers.twist_for_pt2pl(t_source, m1 / m0s[:, None],
                                          nx / m0s[:, None], drxdx, reduce)
    rot, t = so.twist_mul(tw, rot_p, t_p)
    sigma2_new = _sigma2_update(t_source, m0, m1, m2, m0m0, c, mask, sigma2,
                                reduce)
    return rot, t, sigma2_new, q


def _sigma2_update(t_source, m0, m1, m2, m0m0, c, mask, sigma2_old,
                   reduce=None):
    """Reference filterreg.py:112; returns ``sigma2_old`` when m2 is None.
    Divides by the cloud's dimension (the reference's own deviation from
    the original's fixed 3)."""
    if m2 is None:
        return sigma2_old
    dim = t_source.shape[1]
    num = (m0 * (t_source * t_source).sum(1)
           - 2.0 * (t_source * m1).sum(1) + m2)
    s2 = (mask * num / torch.clamp(m0 + c, min=_EPS)).sum()
    mass = (mask * m0m0).sum()
    if reduce is not None:
        s2, mass = reduce(torch.stack([s2, mass]))
    return s2 / (dim * torch.clamp(mass, min=_EPS))


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


def _rigid_mstep(t_source, target, estep_res, trans_p, sigma2, w,
                 objective_type):
    """The rigid M-step of the host loop from an E-step's moments: (rot, t,
    sigma2 estimated or as given, q)."""
    m, dim = t_source.shape
    m0, m1, m2, nx = estep_res
    sigma2 = torch.as_tensor(sigma2, dtype=t_source.dtype,
                             device=t_source.device)
    c = _outlier_c(sigma2, w, m, target.shape[0], dim)
    if objective_type == "pt2pt":
        return rigid_mstep_pt2pt(t_source, m0, m1, m2, trans_p.rot,
                                 trans_p.t, sigma2, c)
    if objective_type == "pt2pl":
        return rigid_mstep_pt2pl(t_source, m0, m1, m2, nx, trans_p.rot,
                                 trans_p.t, sigma2, c)
    raise ValueError("Unknown objective_type: %s." % objective_type)


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


def _multistart_rots(n_starts: int, dim: int):
    """(S, D, D) rotation starts on the orientation grid (reference
    filterreg.py:1316)."""
    from . import cost_functions as cf

    return cf.RigidCostFunction.initial_multistart_rots(n_starts, dim)


def _run_em_rigid_multistart_batch(sources, targets, normals, rots0,
                                   sigma2_0, *, smasks=None, tmasks=None,
                                   fused=False, **kw):
    """The orientation search of a batch (reference filterreg.py:1323-1400):
    each start rotation ``rots0`` (S, D, D) about each pair's shared
    centroid (t0 = c - R0 c). ``fused``: all B S runs as ONE launch of the
    whole-EM kernel (3-D, its gate checked by the caller); else
    ``_run_em_rigid`` per start. Per pair the start of least final sigma2
    (``update_sigma2``) or q wins, the first of ties. Returns (rot, t,
    sigma2, q) stacked over the batch, the winning starts and every
    start's score (B, S)."""
    nb = sources.shape[0]
    rots0 = torch.as_tensor(rots0, dtype=sources.dtype,
                            device=sources.device)
    ns = rots0.shape[0]
    cens = torch.stack([_pair_centroid(
        sources[b], targets[b], None if smasks is None else smasks[b],
        None if tmasks is None else tmasks[b]) for b in range(nb)])
    t0 = cens[:, None, :] - (rots0[None] @ cens[:, None, :, None])[..., 0]
    if fused:
        from .ops import frg_cuda

        def rep(x):
            return None if x is None else x.repeat_interleave(ns, 0)

        rows = torch.cat([rots0.expand(nb, ns, 3, 3).reshape(nb * ns, 9),
                          t0.reshape(nb * ns, 3)], 1)
        kw = dict(kw)
        out = frg_cuda.run_em_filterreg_fused_batch(
            rep(sources), rep(targets), rep(normals), rep(smasks),
            rep(tmasks), sigma2_0, objective=kw.pop("objective_type"),
            inits=rows, **kw)[:4]
    else:
        out = _stack_runs([_run_em_rigid(
            sources[b], targets[b], None if normals is None else normals[b],
            rots0[s], t0[b, s], sigma2_0,
            smask=None if smasks is None else smasks[b],
            tmask=None if tmasks is None else tmasks[b], **kw)
            for b in range(nb) for s in range(ns)])
    rot, t, sigma2, q = (x.reshape(nb, ns, *x.shape[1:]) for x in out)
    score = sigma2 if kw["update_sigma2"] else q
    best = first_min(score)
    rows = torch.arange(nb, device=best.device)
    return (rot[rows, best], t[rows, best], sigma2[rows, best],
            q[rows, best]), best, score


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
# The lattice E-step, feature maps and the deformable-kinematic M-step
# --------------------------------------------------------------------------

def _features(feature_fn, x: torch.Tensor) -> torch.Tensor:
    """``feature_fn(x)`` as a tensor on x's device and dtype; a numpy (or
    other array) result is moved there."""
    f = feature_fn(x)
    if not isinstance(f, torch.Tensor):
        f = torch.as_tensor(np.asarray(f))
    return f.to(device=x.device, dtype=x.dtype)


def _lattice_filter(fin, vin, m, n, alpha):
    """The lattice E-step's filter (reference filterreg.py:516-531): splat
    the target rows of ``vin`` from ``m`` on, slice the first m rows. The
    blur runs while the blurred lattice has at most alpha n vertices, else
    the lattice is rebuilt without blur (the blurred one's neighbours are
    then never searched). The switch reads no more from the device than
    the build does (its vertex count sizes the table)."""
    lat = phops.build(fin, with_blur=True, max_size=int(n * alpha))
    blur = lat is not None
    if not blur:
        lat = phops.build(fin, with_blur=False)
    return phops.filter(lat, vin, start=m, with_blur=blur)[:m]


def _run_em_rigid_lattice(source, target, normals, rot0, t0, sigma2_0, *,
                          objective_type, update_sigma2, w, maxiter, tol,
                          min_sigma2, sigma2_decay=1.0, auto_sigma2=False,
                          alpha=_ALPHA):
    """Whole-EM rigid FilterReg with the permutohedral-lattice E-step
    (reference filterreg.py:914): the lattice of the transformed source and
    the target, scaled by 1 / sigma, is rebuilt every iteration. Host
    reads per iteration: one per lattice build (two when the blur switch
    rebuilds) and the loop test."""
    m, dim = source.shape
    n = target.shape[0]
    dev, dt = source.device, source.dtype
    if auto_sigma2:
        sigma2 = _auto_sigma2(source, target, objective_type, min_sigma2)
    else:
        sigma2 = torch.as_tensor(sigma2_0, dtype=dt, device=dev)
    pt2pl = objective_type == "pt2pl"
    vals = gto.moment_channels(target, normals if pt2pl else None,
                               update_sigma2)
    vin = torch.cat([vals.new_zeros((m, vals.shape[1])), vals])
    rot = torch.as_tensor(rot0, dtype=dt, device=dev)
    t = torch.as_tensor(t0, dtype=dt, device=dev)
    q = torch.tensor(math.inf, dtype=dt, device=dev)
    q_prev, i = math.inf, 0
    while True:
        done, q_prev_next = _converged(i, q, q_prev, maxiter, tol)
        if done:
            break
        t_src = source @ rot.T + t
        out = _lattice_filter(torch.cat([t_src, target]) / torch.sqrt(sigma2),
                              vin, m, n, alpha)
        m0, m1, m2, nx = gto.split_moments(out, dim, update_sigma2, pt2pl)
        rot, t, s2, q = _mstep_from_moments_t(
            t_src.T, m0, m1.T, m2, None if nx is None else nx.T, rot, t,
            sigma2, w, m, n, dim, objective_type)
        sigma2 = _anneal(s2, sigma2, update_sigma2, sigma2_decay, min_sigma2)
        q_prev, i = q_prev_next, i + 1
    return MstepResult(tf.RigidTransformation(rot, t, device=dev), sigma2, q)


def _feature_sigma2(source, target, ftarget, feature_fn, objective_type,
                    min_sigma2):
    """Starting sigma2 of a feature-space registration (reference
    filterreg.py:802-817): pt2pl the target's point spacing (in point
    space), pt2pt the mean squared feature distance / feature width."""
    if objective_type == "pt2pl":
        return _auto_sigma2(None, target, "pt2pl", min_sigma2)
    return _auto_sigma2(_features(feature_fn, source), ftarget, "pt2pt",
                        min_sigma2)


def _run_em_rigid_feature(source, target, normals, ftarget, rot0, t0,
                          sigma2_0, *, feature_fn, objective_type,
                          update_sigma2, w, maxiter, tol, min_sigma2,
                          sigma2_decay=1.0, auto_sigma2=False):
    """Whole-EM rigid FilterReg in a feature space (reference
    filterreg.py:1232): the E-step filters ``feature_fn`` of the moved
    source against ``ftarget`` (the target's features), the M-step moves
    the points. Feature spaces wider than 8 (FPFH's 33) take the dense
    blocked transform, as in the reference."""
    m, dim = source.shape
    n = target.shape[0]
    dev, dt = source.device, source.dtype
    pt2pl = objective_type == "pt2pl"
    if auto_sigma2:
        sigma2 = _feature_sigma2(source, target, ftarget, feature_fn,
                                 objective_type, min_sigma2)
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
            _features(feature_fn, t_src) / sigma, ftarget / sigma, target,
            normals if pt2pl else None, need_m2=bool(update_sigma2))
        c = _outlier_c(sigma2, w, m, n, dim)
        if pt2pl:
            rot, t, s2, q = rigid_mstep_pt2pl(t_src, m0, m1, m2, nx, rot, t,
                                              sigma2, c)
        else:
            rot, t, s2, q = rigid_mstep_pt2pt(t_src, m0, m1, m2, rot, t,
                                              sigma2, c)
        sigma2 = _anneal(s2, sigma2, update_sigma2, sigma2_decay, min_sigma2)
        q_prev, i = q_prev_next, i + 1
    return MstepResult(tf.RigidTransformation(rot, t, device=dev), sigma2, q)


def _node_weights(pair, val, n_nodes):
    """(P, n_nodes) skinning weight of each point on each node: the two
    weights of its pair put in their nodes' columns (one-hot, so the sums
    below are fixed-order products instead of scatter-adds)."""
    oh = torch.nn.functional.one_hot(pair, n_nodes).to(val.dtype)
    return oh[:, 0] * val[:, :1] + oh[:, 1] * val[:, 1:]


def _blend(dualquats, pair, val, points):
    """The points moved by their pair's linear blend of ``dualquats``."""
    return dq.transform_point(dq.dlb2(val[:, 0], dualquats[pair[:, 0]],
                                      val[:, 1], dualquats[pair[:, 1]]),
                              points)


def _deformable_mstep(t_source, m0, m1, m2, dualquats, pair, val, sigma2, c,
                      gn_maxiter=50, gn_tol=1.0e-4):
    """Blended-skinning Gauss-Newton M-step (reference filterreg.py:1087):
    (new dual quaternions (n_nodes, 8), sigma2 estimate, q).

    The normal matrix J^T J over all node twists is fixed within the step,
    so its SVD is taken once and every Gauss-Newton step is a least-squares
    solve through it with the reference's rcond = 1e-5: singular values
    below rcond times the largest are cut, as ``jnp.linalg.lstsq`` does.
    The matrix is exactly singular for degenerate clouds (rotation about a
    colinear bar is unobservable), which CUDA's ``torch.linalg.lstsq``
    (``gels``, full rank assumed) would not survive. The loop runs all
    ``gn_maxiter`` steps with no host read: once a step's norm falls below
    ``gn_tol`` the twists are frozen, which is the reference's early stop.
    Each step is capped at norm 0.5."""
    dim = t_source.shape[1]
    n6d = dim * 2
    n_nodes = dualquats.shape[0]
    m0 = torch.clamp(m0, min=_EPS)
    m1m0 = m1 / m0[:, None]
    m0m0 = m0 / (m0 + c)
    drxdx = torch.sqrt(m0m0 / sigma2)
    drxdz = drxdx[:, None, None] * so.diff_x_from_twist(t_source)  # (M,3,6)
    wn = _node_weights(pair, val, n_nodes)                        # (M, K)
    jtj = torch.einsum("mik,mil->mkl", drxdz, drxdz).reshape(-1, n6d * n6d)
    ww = (wn[:, :, None] * wn[:, None, :]).reshape(-1, n_nodes * n_nodes)
    a = (ww.T @ jtj).reshape(n_nodes, n_nodes, n6d, n6d).permute(
        0, 2, 1, 3).reshape(n_nodes * n6d, n_nodes * n6d)
    u, s, vh = torch.linalg.svd(a)
    keep = s >= 1e-5 * s[0]
    s_inv = torch.where(keep, 1.0 / torch.where(keep, s, 1.0), 0.0)

    def blend_apply(tw):
        return _blend(dq.from_twist(tw.reshape(n_nodes, n6d)), pair, val,
                      t_source)

    tw = t_source.new_zeros(n_nodes * n6d)
    done = torch.zeros((), dtype=torch.bool, device=t_source.device)
    for _ in range(gn_maxiter):
        rx = drxdx[:, None] * (blend_apply(tw) - m1m0)
        jr = torch.einsum("mik,mi->mk", drxdz, rx)                 # (M, 6)
        dtw = vh.T @ (s_inv * (u.T @ (wn.T @ jr).reshape(-1)))
        dn = torch.linalg.norm(dtw)
        dtw = dtw * torch.clamp(0.5 / torch.clamp(dn, min=_EPS), max=1.0)
        tw = torch.where(done, tw, tw - dtw)
        done = done | (torch.clamp(dn, max=0.5) < gn_tol)

    new_dq = dq.mul(dq.from_twist(tw.reshape(n_nodes, n6d)), dualquats)
    rx = drxdx[:, None] * (blend_apply(tw) - m1m0)
    q = (rx * rx).sum()
    s2 = sigma2
    if m2 is not None:
        num = (m0 * (t_source * t_source).sum(1)
               - 2.0 * (t_source * m1).sum(1) + m2)
        s2 = (num / (m0 + c)).sum() / (3.0 * m0m0.sum())
    return new_dq, s2, q


def _run_em_deformable(source, target, dq0, pair, val, sigma2_in, *,
                       update_sigma2, w, maxiter, tol, min_sigma2,
                       sigma2_decay=1.0, auto_sigma2=False, gn_maxiter=50,
                       gn_tol=1.0e-4):
    """Whole-EM DeformableKinematicFilterReg (reference
    filterreg.py:1178): the exact E-step on the blended source (the
    tile-culled Gauss transform once M * N >= 2^28), then
    :func:`_deformable_mstep`. One host read per iteration, the loop test.
    Returns (dual quaternions, sigma2, q)."""
    m = source.shape[0]
    n = target.shape[0]
    dev, dt = source.device, source.dtype
    c = w / (1.0 - w) * n / m
    if auto_sigma2:
        sigma2 = torch.clamp(mu.squared_kernel_sum(source, target),
                             min=min_sigma2)
    else:
        sigma2 = torch.as_tensor(sigma2_in, dtype=dt, device=dev)
    dqs = torch.as_tensor(dq0, dtype=dt, device=dev)
    q = torch.tensor(math.inf, dtype=dt, device=dev)
    q_prev, i = math.inf, 0
    while True:
        done, q_prev_next = _converged(i, q, q_prev, maxiter, tol)
        if done:
            break
        t_src = _blend(dqs, pair, val, source)
        sigma = torch.sqrt(sigma2)
        m0, m1, m2, _ = gto.filterreg_moments(
            t_src / sigma, target / sigma, target, None,
            need_m2=bool(update_sigma2))
        dqs, s2, q = _deformable_mstep(t_src, m0, m1, m2, dqs, pair, val,
                                       sigma2, c, gn_maxiter=gn_maxiter,
                                       gn_tol=gn_tol)
        sigma2 = _anneal(s2, sigma2, update_sigma2, sigma2_decay, min_sigma2)
        q_prev, i = q_prev_next, i + 1
    return dqs, sigma2, q


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
        estep_method: 'dense' (exact, the default) or 'lattice' (the
            permutohedral lattice).
        use_pallas: None or True: small pairs may run the whole-EM kernel;
            False keeps them on the dense loop.
        device: Device to run on (default ``config.device``).
    """

    def __init__(self, source=None, target_normals=None, sigma2=None,
                 update_sigma2: bool = False, estep_method: str = "dense",
                 use_pallas: Optional[bool] = None, device=None):
        if estep_method not in ("dense", "lattice"):
            raise ValueError(f"unknown estep_method {estep_method!r}")
        self._device = _config.resolve_device(device)
        self._source = None if source is None else self._as_points(source)
        self._target_normals = interop.as_normals(target_normals,
                                                  device=self._device)
        self._sigma2 = sigma2
        self._update_sigma2 = update_sigma2
        self._estep_method = estep_method
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
                         alpha: float = _ALPHA) -> EstepResult:
        """E-step moments (reference filterreg.py:489): the filtering runs
        in the space of ``t_source`` / ``target`` (positions or features)
        scaled by 1/sigma, and the moments are of ``y``, the raw target
        points. ``alpha``: the lattice's blur switch."""
        t_source, target, y = (self._as_points(v) for v in
                               (t_source, target, y))
        need_nx = objective_type == "pt2pl"
        if need_nx and self._target_normals is None:
            raise ValueError("pt2pl requires target_normals.")
        normals = self._target_normals if need_nx else None
        sigma = torch.sqrt(torch.as_tensor(sigma2, dtype=t_source.dtype,
                                           device=self._device))
        if self._estep_method == "dense":
            return EstepResult(*gto.filterreg_moments(
                t_source / sigma, target / sigma, y, normals,
                need_m2=bool(update_sigma2)))
        m = t_source.shape[0]
        vals = gto.moment_channels(y, normals, update_sigma2)
        out = _lattice_filter(
            torch.cat([t_source / sigma, target / sigma]),
            torch.cat([vals.new_zeros((m, vals.shape[1])), vals]), m,
            target.shape[0], alpha)
        return EstepResult(*gto.split_moments(out, y.shape[1],
                                              update_sigma2, need_nx))

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
        """Run the EM registration (reference filterreg.py:555).
        ``feature_fn``: the map of both clouds into the space the E-step
        filters in (identity by default; e.g. ``features.FPFH()``).
        ``n_starts > 1``: the orientation search (rigid dense path, no
        callbacks). ``callback_chunk``: EM iterations queued between two
        host reads in callback mode; the callbacks still fire every
        iteration (utils/chunked.py)."""
        assert self._tf_type is not None, "transformation type is None."
        target = self._as_points(target)
        identity = _is_identity_feature(feature_fn)
        if int(n_starts) > 1:
            if (not isinstance(self, RigidFilterReg) or self._callbacks
                    or self._estep_method != "dense" or not identity):
                raise ValueError("n_starts > 1 requires the rigid dense "
                                 "no-callback path")
            m, n = self._source.shape[0], target.shape[0]
            if m * n > _config.config.transposed_em_max_pairs:
                # The search runs n_starts dense (M, N) loops, a size the
                # single start streams instead.
                raise ValueError(
                    "n_starts > 1 FilterReg materializes n_starts dense "
                    f"(M, N) kernels; M*N = {m}*{n} exceeds "
                    "config.transposed_em_max_pairs. Run the orientation "
                    "search on a downsampled cloud "
                    "(pyramid.registration_filterreg_pyramid(n_starts=)) "
                    "and warm-start the full size with tf_init_params.")
        _check_objective(objective_type, self._target_normals)
        normals = self._target_normals if objective_type == "pt2pl" else None
        args = dict(objective_type=objective_type,
                    update_sigma2=bool(self._update_sigma2), w=float(w),
                    maxiter=int(maxiter), tol=float(tol),
                    min_sigma2=float(min_sigma2),
                    sigma2_decay=float(sigma2_decay))
        if int(n_starts) > 1:
            res = self._registration_multistart(target, normals,
                                                int(n_starts), **args)
        else:
            res = None if self._callbacks else self._registration_whole(
                target, normals, None if identity else feature_fn, **args)
            if res is None:
                return self._registration_host_loop(
                    target, feature_fn, int(callback_chunk), **args)
        self._tf_result = res.transformation
        self._sigma2 = float(res.sigma2)
        return res

    @abc.abstractmethod
    def _registration_whole(self, target, normals, feature_fn,
                            **args) -> Optional[MstepResult]:
        """The whole-EM loop of this class, estep method and feature map
        (``feature_fn`` None: the identity), or None where the reference
        has none and the host loop runs."""

    def _registration_multistart(self, target, normals, n_starts,
                                 **args) -> MstepResult:
        """The orientation search from the grid (reference
        filterreg.py:567-600); it ignores the start pose, as there."""
        m, dim = self._source.shape
        auto = self._sigma2 is None
        (rot, t, sigma2, q), *_ = _run_em_rigid_multistart_batch(
            self._source[None], target[None],
            None if normals is None else normals[None],
            _multistart_rots(n_starts, dim),
            0.0 if auto else float(self._sigma2), auto_sigma2=auto,
            fused=_fused_batch_ok(m, target.shape[0], dim, self._use_pallas),
            **args)
        return MstepResult(tf.RigidTransformation(rot[0], t[0],
                                                  device=self._device),
                           sigma2[0], q[0])

    @abc.abstractmethod
    def _mstep(self, t_source, target, estep_res, trans, sigma2, w,
               objective_type):
        """The host loop's M-step with no host read: (transformation,
        sigma2 estimated or as given, q, whether every moment is zero)."""

    def _registration_host_loop(self, target, feature_fn, chunk, *,
                                objective_type, update_sigma2, w, maxiter,
                                tol, min_sigma2, sigma2_decay):
        """One E-step (in ``feature_fn``'s space) and M-step per iteration,
        the callbacks after each (reference filterreg.py:881), ``chunk``
        iterations queued between two host reads: the chunk carries sigma2
        in float64 as the host loop's Python float, and an iteration whose
        moments are all zero ends the loop with the previous pose and q,
        as there (rigid only: the deformable M-step floors m0)."""
        ftarget = _features(feature_fn, target)
        if self._sigma2 is None:
            self._sigma2 = float(_feature_sigma2(
                self._source, target, ftarget, feature_fn, objective_type,
                min_sigma2))
        dt = self._source.dtype
        steps = []
        prev = {"q": None}

        def chunk_fn(state, k):
            trans, s2 = state
            steps.clear()
            for _ in range(k):
                s32 = s2.to(dt)
                t_source = trans._transform(self._source)
                estep_res = self.expectation_step(
                    _features(feature_fn, t_source), ftarget, target, s32,
                    update_sigma2, objective_type)
                trans, s2_m, q, empty = self._mstep(
                    t_source, target, estep_res, trans, s32, w,
                    objective_type)
                s2 = torch.clamp(s2_m.double() if update_sigma2
                                 else s2 * sigma2_decay, min=min_sigma2)
                steps.append((MstepResult(trans, s2_m, q), s2, empty))
            return (trans, s2), chunked.stack_history(
                [(res.q, s2_next, empty) for res, s2_next, empty in steps])

        def handle(i, host, j):
            qs, s2s, empties = host
            if bool(empties[j]):  # no weight anywhere: keep the last pose
                return True, MstepResult(self._tf_result, self._sigma2,
                                         prev["q"])
            res = steps[j][0]
            self._tf_result = res.transformation
            self._sigma2 = float(s2s[j])
            for c in self._callbacks:
                c(self._tf_result)
            qv = float(qs[j])
            log.debug("Iteration: {}, Criteria: {}".format(i, qv))
            stop = prev["q"] is not None and abs(qv - prev["q"]) < tol
            prev["q"] = qv
            return stop, res

        out = chunked.run_chunked(
            chunk_fn, (self._tf_result, torch.tensor(
                self._sigma2, dtype=torch.float64, device=self._device)),
            maxiter, chunk, handle)
        return out if out is not None else MstepResult(
            self._tf_result, self._sigma2, None)


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
        if not bool((estep_res[0] > 0.0).any()):
            return MstepResult(trans_p, sigma2, None)
        rot, t, s2, q = _rigid_mstep(t_source, target, estep_res, trans_p,
                                     sigma2, w, objective_type)
        return MstepResult(tf.RigidTransformation(rot, t,
                                                  device=t_source.device),
                           s2, q)

    def _mstep(self, t_source, target, estep_res, trans, sigma2, w,
               objective_type):
        rot, t, s2, q = _rigid_mstep(t_source, target, estep_res, trans,
                                     sigma2, w, objective_type)
        return (tf.RigidTransformation(rot, t, device=self._device), s2, q,
                ~(estep_res.m0 > 0.0).any())

    def _registration_whole(self, target, normals, feature_fn,
                            **args) -> Optional[MstepResult]:
        m, n = self._source.shape[0], target.shape[0]
        auto = self._sigma2 is None
        sigma2_0 = 0.0 if auto else float(self._sigma2)
        rot0, t0 = self._tf_result.rot, self._tf_result.t
        if self._estep_method == "lattice":
            if feature_fn is not None:
                return None
            return _run_em_rigid_lattice(self._source, target, normals, rot0,
                                         t0, sigma2_0, auto_sigma2=auto,
                                         **args)
        if feature_fn is not None:
            return _run_em_rigid_feature(
                self._source, target, normals, _features(feature_fn, target),
                rot0, t0, sigma2_0, feature_fn=feature_fn, auto_sigma2=auto,
                **args)
        if m * n > _config.config.transposed_em_max_pairs:
            return _run_em_rigid_streaming(
                self._source, target, normals, rot0, t0, sigma2_0,
                auto_sigma2=auto, **args)
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
    """Deformable-kinematic FilterReg (reference filterreg.py:1054): each
    point follows the dual-quaternion blend of its two skinning nodes, and
    the M-step is a Gauss-Newton loop over all node twists.

    Args:
        source: Source point cloud (3-D).
        skinning_weight: ``DeformableKinematicModel.SkinningWeight``, one
            row per source point.
        sigma2: Fixed starting variance; None = estimated.
        **kwargs: ``update_sigma2``, ``estep_method``, ``device``.
    """

    def __init__(self, source=None, skinning_weight=None, sigma2=None,
                 **kwargs):
        super().__init__(source, sigma2=sigma2, **kwargs)
        self._tf_type = tf.DeformableKinematicModel
        self._skinning_weight = skinning_weight
        idq = dq.identity(device=self._device).repeat(
            skinning_weight.n_nodes, 1)
        self._tf_result = self._tf_type(idq, skinning_weight,
                                        device=self._device)

    @staticmethod
    def _maximization_step(t_source, target, estep_res, trans_p, sigma2,
                           w=0.0, objective_type="", maxiter=50,
                           tol=1.0e-4):
        m0, m1, m2, _ = estep_res
        c = w / (1.0 - w) * target.shape[0] / t_source.shape[0]
        pair, val = trans_p.weights.tensors(t_source.dtype, t_source.device)
        new_dq, s2, q = _deformable_mstep(
            t_source, m0, m1, m2, trans_p.dualquats, pair, val,
            torch.as_tensor(sigma2, dtype=t_source.dtype,
                            device=t_source.device), c,
            gn_maxiter=maxiter, gn_tol=tol)
        return MstepResult(tf.DeformableKinematicModel(
            new_dq, trans_p.weights, device=t_source.device), s2, q)

    def _mstep(self, t_source, target, estep_res, trans, sigma2, w,
               objective_type):
        res = self._maximization_step(t_source, target, estep_res, trans,
                                      sigma2, w)
        return (res.transformation, res.sigma2, res.q,
                torch.zeros((), dtype=torch.bool, device=self._device))

    def _registration_whole(self, target, normals, feature_fn,
                            **args) -> Optional[MstepResult]:
        if self._estep_method != "dense" or feature_fn is not None:
            return None
        del args["objective_type"]
        auto = self._sigma2 is None
        weights = self._skinning_weight
        pair, val = weights.tensors(self._source.dtype, self._device)
        dqs, s2, q = _run_em_deformable(
            self._source, target, self._tf_result.dualquats, pair, val,
            0.0 if auto else float(self._sigma2), auto_sigma2=auto, **args)
        return MstepResult(tf.DeformableKinematicModel(
            dqs, weights, device=self._device), s2, q)


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
    loop pair by pair. ``n_starts > 1``: each pair's orientation search, the
    S starts of the B pairs one launch of B S pairs on the kernel. Returns a
    list of ``MstepResult``.
    """
    _check_objective(objective_type, target_normals)
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
    fused = _fused_batch_ok(sources.shape[1], targets.shape[1],
                            sources.shape[2], use_pallas)
    if int(n_starts) > 1:
        (rot, t, sigma2s, qs), *_ = _run_em_rigid_multistart_batch(
            sources, targets, normals,
            _multistart_rots(int(n_starts), sources.shape[2]), sigma2_0,
            smasks=smasks, tmasks=tmasks, fused=fused,
            objective_type=objective_type, **args)
    elif fused:
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
        feature_fn: Map of both clouds into the space the E-step filters
            in (e.g. ``features.FPFH()``); a numpy result is moved to the
            device.
        callbacks: Called with the current transformation each iteration.
        sigma2_decay: Per-iteration factor on sigma2 when ``update_sigma2``
            is False, floored at ``min_sigma2``.
        n_starts: EM restarts over the orientation grid (rigid dense path,
            no callbacks); the least final sigma2 (``update_sigma2``) or q
            wins.
        callback_chunk: EM iterations queued between two host reads in
            callback mode; the callbacks still fire every iteration.
        device: Device to run on (default ``config.device``, "cuda"). A
            missing CUDA device raises instead of running on the CPU.

    Keyword Args:
        tf_init_params (dict): Initial rigid transformation.
        estep_method (str): 'dense' (the default, exact) or 'lattice'.
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
