"""Coarse-to-fine (multiresolution) registration pipelines.

Counterpart of probreg_tpu/pyramid.py. The coarsest level registers
voxel-downsampled clouds from the identity; each finer level starts from
BOTH the recovered transform (``tf_init_params``) and the converged
variance (``sigma2_init``), so the full-resolution EM skips the dense
start-temperature iterations and runs in the annealed regime, where the
tile-culled E-step kernels skip most tile pairs (ops/estep_cuda.py).

Levels are built on the host with :func:`probreg_tpu_torch.utils.io.
voxel_down_sample`, the port's native loader, which also counts the voxels
of the schedule's density probes. The voxel schedule is geometric; the
coarsest size is fitted so the coarsest clouds hold ``coarse_points``
points (point clouds are surfaces, so occupied voxels scale ~ (diag/v)^2).

Each entry point runs every level through the port's own entry point for
that family (``registration_cpd``, ``registration_filterreg``,
``registration_gmmtree``, ``registration_icp``, BCPD's
``_registration_bcpd_impl``) on ``device``; the CPD pyramid's ``mesh=``
runs every level through ``parallel.registration_cpd_sharded``. The
low-rank nonrigid CPD pyramid carries the displacement field: the coarse
level's field is kernel-regressed onto the finer points
(``_interp_displacement``, one Gauss transform) and projected onto their
Nystrom basis (``v_init``). ``n_starts > 1`` (rigid) runs the orientation
search on the coarsest level only; every finer level refines the carried
pose. ``mesh=`` of the FilterReg pyramid runs every level through
``parallel.registration_filterreg_sharded`` (1-D or 2-D mesh), that of the
BCPD pyramid through ``parallel.registration_bcpd_2d`` (2-D mesh,
``rank=``).
"""

from __future__ import annotations

from typing import Any, Callable, List, Optional, Sequence

import numpy as np
import torch

from . import _io_native
from . import config as _config
from .utils import interop
from .utils import io as pio

__all__ = [
    "build_pyramid",
    "auto_voxel_sizes",
    "registration_cpd_pyramid",
    "registration_filterreg_pyramid",
    "registration_bcpd_pyramid",
    "registration_gmmtree_pyramid",
    "registration_icp_pyramid",
]

_F32_EPS = float(np.finfo(np.float32).eps)


def _np_dtype():
    return torch.empty((), dtype=_config.config.dtype).numpy().dtype


def _voxel_count(points: np.ndarray, voxel_size: float) -> int:
    """Number of occupied voxels at ``voxel_size`` (density probe), counted
    by the native loader with the keys of :func:`_voxel_count_plain`."""
    return _io_native.voxel_count(points, voxel_size)


def _voxel_count_plain(points: np.ndarray, voxel_size: float) -> int:
    """numpy version of :func:`_voxel_count`."""
    keys = np.floor((points - points.min(axis=0)) / voxel_size).astype(np.int64)
    flat = pio.pack_voxel_keys(keys)
    if flat is None:
        return int(np.unique(keys, axis=0).shape[0])
    return int(np.unique(flat).size)


def auto_voxel_sizes(
    source: np.ndarray,
    target: np.ndarray,
    levels: int = 3,
    coarse_points: int = 3000,
    factor: float = 4.0,
) -> List[float]:
    """Geometric voxel schedule, coarsest first, ``0.0`` = full resolution.

    The coarsest voxel is fitted so the coarser of the two downsampled
    clouds holds roughly ``coarse_points`` points; each finer level divides
    the voxel by ``factor``; the last level is always the original clouds.
    """
    if levels < 2:
        return [0.0]
    lo = np.minimum(source.min(axis=0), target.min(axis=0))
    hi = np.maximum(source.max(axis=0), target.max(axis=0))
    diag = float(np.linalg.norm(hi - lo))
    n = int(min(source.shape[0], target.shape[0]))
    if diag == 0.0 or n <= coarse_points:
        return [0.0]  # nothing to gain from downsampling: run flat
    probe = source if source.shape[0] <= target.shape[0] else target
    # Surface scaling: occupied voxels ~ (diag/v)^2, refined against the
    # true count (each probe is one np.unique pass).
    v = diag * float(np.sqrt(max(coarse_points, 8) / n))
    for _ in range(3):
        cnt = _voxel_count(probe, v)
        if cnt <= 8:  # collapsed: back off
            v *= 0.5
            continue
        ratio = cnt / float(coarse_points)
        if 0.6 <= ratio <= 1.7:
            break
        v *= float(np.sqrt(ratio))
    sizes = [v / (factor ** i) for i in range(levels - 1)]
    return sizes + [0.0]


def build_pyramid(points: np.ndarray,
                  voxel_sizes: Sequence[float]) -> List[np.ndarray]:
    """Downsampled copies of ``points`` per level (coarsest first).

    ``0.0`` (or None) keeps the original points for that level.
    """
    dtype = _np_dtype()
    out = []
    for v in voxel_sizes:
        if not v:
            out.append(np.asarray(points, dtype))
        else:
            out.append(np.asarray(pio.voxel_down_sample(points, float(v)),
                                  dtype))
    return out


def _carry_sigma2(prev_sigma2: float, prev_voxel: float,
                  inflation: float) -> float:
    """Warm-start variance for the next (finer) level.

    Moving to a finer level, the clouds differ from the coarse ones by up
    to ~voxel/2 per point (centroid averaging), so the carried variance is
    floored at (voxel/2)^2 and inflated for basin safety.
    """
    floor = 0.25 * float(prev_voxel) ** 2
    return max(float(prev_sigma2) * float(inflation), floor, _F32_EPS)


def _prepare_levels(source, target, voxel_sizes, levels, coarse_points,
                    factor, device, keep_device_last=True):
    """Shared level preparation: points, schedule, per-level downsampling.

    Returns ``(src_levels, tgt_levels, voxel_sizes)``, numpy clouds per
    level. With ``keep_device_last`` and a full-resolution finest level,
    that level is the caller's clouds as tensors on ``device`` (a tensor
    already there is not copied).
    """
    src = interop.as_points(source, device=device)
    tgt = interop.as_points(target, device=device)
    src_np = src.cpu().numpy()
    tgt_np = tgt.cpu().numpy()
    if voxel_sizes is None:
        voxel_sizes = auto_voxel_sizes(src_np, tgt_np, levels,
                                       coarse_points, factor)
    voxel_sizes = list(voxel_sizes)
    src_levels = build_pyramid(src_np, voxel_sizes)
    tgt_levels = build_pyramid(tgt_np, voxel_sizes)
    if keep_device_last and voxel_sizes[-1] in (0.0, None):
        src_levels[-1] = src
        tgt_levels[-1] = tgt
    return src_levels, tgt_levels, voxel_sizes


def _default_level_maxiters(n_levels, maxiter, polish_divisor):
    """Full budget coarse, half at intermediates, polish at full res."""
    if n_levels == 1:
        return [maxiter]
    polish = max(maxiter // polish_divisor, 10)
    return ([maxiter] + [max(maxiter // 2, 10)] * (n_levels - 2) + [polish])


def _fit_level_maxiters(level_maxiters, n_levels, maxiter, polish_divisor,
                        auto_schedule):
    """Resolve the per-level iteration budgets against the ACTUAL schedule.

    ``auto_voxel_sizes`` gives fewer levels than requested when there is
    nothing to downsample; then the coarse budget and the finest budgets
    are kept (the only level of a collapsed schedule is both coarsest and
    finest, so it gets the full coarse budget). An explicit
    ``voxel_sizes`` schedule still needs an exact length match.
    """
    if level_maxiters is None:
        return _default_level_maxiters(n_levels, maxiter, polish_divisor)
    lm = list(level_maxiters)
    if len(lm) == n_levels:
        return lm
    if auto_schedule and len(lm) > n_levels:
        return [lm[0]] + lm[len(lm) - (n_levels - 1):]
    raise ValueError("level_maxiters length must match the level count")


def _leaves(x) -> List[np.ndarray]:
    """The numbers of a warm state (nested dicts, tuples, lists, arrays,
    tensors, floats; None holds none), flattened in a fixed order: dict
    keys sorted, as ``jax.tree_util.tree_leaves`` orders them."""
    if x is None:
        return []
    if isinstance(x, dict):
        return [leaf for k in sorted(x) for leaf in _leaves(x[k])]
    if isinstance(x, (list, tuple)):
        return [leaf for v in x for leaf in _leaves(v)]
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu().numpy()
    return [np.ravel(np.asarray(x, np.float64))]


def _sliced_level(budget, dispatch_chunk, warm, run, carry, tol=0.0,
                  stop=None):
    """One pyramid level as warm-resumed runs of <= chunk iterations.

    ``run(maxiter, warm) -> res`` executes one run; ``carry(res)`` builds
    the next run's warm state. Always calls ``run`` at least once (a 0
    budget runs one maxiter=0 run: the warm-start state).

    A resumed run restarts its convergence test, so the in-run tol stop
    cannot fire across a chunk boundary. With ``tol > 0`` convergence is
    detected AT the boundaries instead: by ``stop()`` when given, else when
    a resumed chunk returns the warm state it started from. ``tol == 0``
    keeps the fixed budget (no early stop).
    """
    budget = int(budget)
    chunk = budget if not dispatch_chunk else int(dispatch_chunk)
    prev_state = None
    while True:
        res = run(max(min(chunk, budget), 0), warm)
        budget -= max(chunk, 1)
        if budget <= 0:
            return res
        if tol > 0.0 and stop is not None and stop():
            return res
        warm = carry(res)
        if tol > 0.0 and stop is None:
            leaves = _leaves(warm)
            state = np.concatenate(leaves) if leaves else None
            if (state is not None and prev_state is not None
                    and state.shape == prev_state.shape
                    and np.allclose(state, prev_state,
                                    rtol=1.0e-7, atol=1.0e-12)):
                return res
            prev_state = state


def _host(x) -> np.ndarray:
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x)


def _rigid_params(tr, scale=True):
    out = {"rot": _host(tr.rot), "t": _host(tr.t)}
    if scale:
        out["scale"] = float(tr.scale)
    return out


def registration_cpd_pyramid(
    source,
    target,
    tf_type_name: str = "rigid",
    w: float = 0.0,
    maxiter: int = 50,
    tol: float = 0.001,
    callbacks: List[Callable] = [],
    levels: int = 3,
    voxel_sizes: Optional[Sequence[float]] = None,
    coarse_points: int = 3000,
    factor: float = 4.0,
    sigma2_inflation: float = 3.0,
    level_maxiters: Optional[Sequence[int]] = None,
    mesh=None,
    device=None,
    **kwargs: Any,
):
    """Coarse-to-fine rigid, affine or low-rank nonrigid CPD (reference
    pyramid.py:221).

    Registers voxel-downsampled levels coarsest first, warm-starting each
    finer level with the previous level's transform (for 'nonrigid' its
    displacement field, interpolated to the finer points) and variance.
    The result is a :func:`probreg_tpu_torch.cpd.registration_cpd` result
    on the full-resolution clouds.

    Args:
        source / target: Point clouds (ndarray, tensor or Open3D cloud).
        tf_type_name: 'rigid', 'affine', or 'nonrigid' with ``rank=`` (the
            dense model has no cross-resolution warm start).
        w, maxiter, tol, callbacks: As in registration_cpd, at every level.
        levels: Number of pyramid levels including full resolution.
        voxel_sizes: Explicit schedule (coarsest first; 0 = full res).
            Overrides ``levels`` / ``coarse_points`` / ``factor``.
        coarse_points: Auto-schedule target size of the coarsest level.
        factor: Auto-schedule geometric voxel ratio between levels.
        sigma2_inflation: Safety factor on the carried variance.
        level_maxiters: Per-level maxiter (coarsest first). Default: full
            ``maxiter`` at the coarsest level, half at intermediate levels,
            ``maxiter // 5`` (>= 10) at full resolution.
        mesh: A ``torch.distributed`` device mesh: every level runs
            through ``parallel.registration_cpd_sharded`` on it (1-D:
            target sharded; 2-D ``(m, n)``: both clouds), every rank
            calling with the same clouds. Rigid or affine, no callbacks
            (the sharded runners have no displacement warm start).
        device: Device to run on (default ``config.device``, "cuda"; with
            ``mesh``, this rank's ``cuda:{LOCAL_RANK}``).
        **kwargs: Forwarded to registration_cpd at every level
            (update_scale, use_pallas, ...). ``dispatch_chunk`` (int)
            splits each level's EM into warm-resumed runs of at most that
            many iterations (an exact resume: CPD's result is its last EM
            iterate). ``n_starts`` (rigid, no callbacks) applies to the
            COARSEST level only, which then runs whole, on one device even
            with ``mesh``; finer levels refine the carried pose.

    Returns:
        MstepResult from the finest (full-resolution) level.
    """
    from . import cpd as _cpd

    if tf_type_name not in ("rigid", "affine", "nonrigid"):
        raise ValueError(
            "registration_cpd_pyramid supports 'rigid', 'affine' and "
            "low-rank 'nonrigid' (rank= required).")
    nonrigid = tf_type_name == "nonrigid"
    if nonrigid and kwargs.get("rank") is None:
        raise ValueError(
            "nonrigid pyramid requires rank= (low-rank Nystrom): the coarse "
            "displacement field is kernel-interpolated to each finer level "
            "and projected onto its Nystrom basis (v_init); the dense model "
            "has no cross-resolution warm start.")
    n_starts = int(kwargs.pop("n_starts", 1))
    if n_starts > 1 and tf_type_name != "rigid":
        raise ValueError("n_starts > 1 supports the rigid pyramid only")
    if n_starts > 1 and callbacks:
        raise ValueError("n_starts > 1 and callbacks are incompatible "
                         "(the multistart coarsest level runs the "
                         "no-callback path)")
    if mesh is not None and (nonrigid or callbacks):
        raise ValueError("mesh= pyramid supports rigid/affine without "
                         "callbacks (the sharded runner has no callback "
                         "or displacement warm-start path)")
    for managed in ("tf_init_params", "sigma2_init", "v_init"):
        if managed in kwargs:
            raise ValueError(f"{managed} is managed by the pyramid; pass it "
                             "to registration_cpd instead.")
    if mesh is None:
        dev = _config.resolve_device(device)
    else:  # the sharded runner takes host clouds and shards them itself
        from .parallel import sharded as _sharded
        from .parallel.mesh import rank_device

        dev = rank_device(device)
    auto_schedule = voxel_sizes is None
    src_levels, tgt_levels, voxel_sizes = _prepare_levels(
        source, target, voxel_sizes, levels, coarse_points, factor,
        dev if mesh is None else "cpu", keep_device_last=mesh is None)
    level_maxiters = _fit_level_maxiters(
        level_maxiters, len(voxel_sizes), maxiter, 5, auto_schedule)
    dispatch_chunk = kwargs.pop("dispatch_chunk", None)
    rigid = tf_type_name == "rigid"

    res = None
    tf_init = {}
    sigma2_init = None
    v_init = None
    for i, (s_i, t_i) in enumerate(zip(src_levels, tgt_levels)):
        # The orientation search belongs to the coarsest level: finer
        # levels carry a warm start, which excludes it, and a new search
        # would discard the carry. It runs whole (a resumed run would
        # carry a warm start into it).
        multistart = n_starts > 1 and i == 0

        def _run(mi, warm, s_i=s_i, t_i=t_i, multistart=multistart):
            tf_c, v_c, s2_c = warm
            if nonrigid:
                return _cpd.registration_cpd(
                    s_i, t_i, "nonrigid", w=w, maxiter=mi, tol=tol,
                    callbacks=callbacks, sigma2_init=s2_c, v_init=v_c,
                    device=dev, **kwargs)
            if multistart:  # one device even with mesh=: the level is small
                return _cpd.registration_cpd(
                    s_i, t_i, tf_type_name, w=w, maxiter=mi, tol=tol,
                    n_starts=n_starts, device=dev, **kwargs)
            if mesh is not None:
                return _sharded.registration_cpd_sharded(
                    s_i, t_i, tf_type_name, w=w, maxiter=mi, tol=tol,
                    mesh=mesh, tf_init_params=tf_c or None,
                    sigma2_init=s2_c, device=dev, **kwargs)
            return _cpd.registration_cpd(
                s_i, t_i, tf_type_name, w=w, maxiter=mi, tol=tol,
                callbacks=callbacks, tf_init_params=tf_c or None,
                sigma2_init=s2_c, device=dev, **kwargs)

        def _carry(res, s_i=s_i):
            s2_c = max(float(res.sigma2), _F32_EPS)
            tr = res.transformation
            if nonrigid:  # the displacement at this level's points
                return (None, _host(tr.transform(s_i)) - _host(s_i), s2_c)
            tf_c = _rigid_params(tr) if rigid else \
                {"b": _host(tr.b), "t": _host(tr.t)}
            return (tf_c, None, s2_c)

        res = _sliced_level(level_maxiters[i],
                            None if multistart else dispatch_chunk,
                            (dict(tf_init), v_init, sigma2_init), _run,
                            _carry, tol=tol)
        if i + 1 < len(src_levels):
            tf_c, disp, _ = _carry(res)
            if nonrigid:
                v_init = _interp_displacement(s_i, disp, src_levels[i + 1],
                                              voxel_sizes[i], device=dev)
            else:
                tf_init = tf_c
            sigma2_init = _carry_sigma2(float(res.sigma2), voxel_sizes[i],
                                        sigma2_inflation)
    return res


def _interp_displacement(coarse_pts, coarse_disp, fine_pts, voxel,
                         device=None):
    """Kernel-regress the coarse displacement field onto the fine points.

    Nadaraya-Watson with a Gaussian of bandwidth ~2 voxels: one Gauss
    transform (the tile-culled kernel on the card at large sizes)
    evaluates the weighted displacement sum and the normalizer (ones
    channel) together. Fine points with no coarse support (den ~ 0) get
    zero displacement. Returns a numpy array.
    """
    from .ops import gausstransform as gto

    coarse_pts = _host(coarse_pts)
    dim = coarse_pts.shape[1]
    if voxel:
        h = 2.0 * float(voxel)
    else:
        # No voxel (equal-resolution levels): ~2x the typical coarse point
        # spacing (surfaces: spacing ~ diag / sqrt(n)), in the cloud's own
        # units.
        ext = np.asarray(coarse_pts.max(axis=0) - coarse_pts.min(axis=0),
                         np.float64)
        diag = float(np.linalg.norm(ext))
        h = max(2.0 * diag / np.sqrt(max(coarse_pts.shape[0], 2)), 1e-12)
    dev = _config.resolve_device(device)
    src = interop.as_points(coarse_pts, device=dev)
    wts = torch.cat([interop.as_points(_host(coarse_disp), device=dev),
                     src.new_ones((src.shape[0], 1))], dim=1)
    out = gto.gauss_transform(src, interop.as_points(_host(fine_pts),
                                                     device=dev), wts, h)
    den = torch.clamp(out[:, dim:], min=float(np.finfo(np.float32).tiny)
                      * 1e10)
    return (out[:, :dim] / den).cpu().numpy()


def registration_bcpd_pyramid(
    source,
    target,
    w: float = 0.0,
    maxiter: int = 50,
    tol: float = 0.001,
    levels: int = 3,
    voxel_sizes: Optional[Sequence[float]] = None,
    coarse_points: int = 3000,
    factor: float = 4.0,
    sigma2_inflation: float = 3.0,
    level_maxiters: Optional[Sequence[int]] = None,
    mesh=None,
    device=None,
    **kwargs: Any,
):
    """Coarse-to-fine combined BCPD (reference pyramid.py:441).

    Each finer level starts from the coarse level's rigid parameters, its
    kernel-interpolated displacement field (``v_init``) and its converged
    variance (``sigma2_init``), all in raw coordinates. The level result is
    the best state (by the NN-RMSE the VI scores) over all its chunks.

    Args: As in :func:`probreg_tpu_torch.bcpd.registration_bcpd` (lmd, k,
        gamma, rank, normalize, ...), pyramid schedule args as in
        :func:`registration_cpd_pyramid`; ``level_maxiters`` defaults to
        ``maxiter // 3`` (>= 10) at full resolution. ``dispatch_chunk``
        splits each level's VI into warm-resumed runs (the resume carries
        the final VI iterate). ``n_starts`` applies to the COARSEST level
        only, which then runs whole. Callbacks are not supported (as in
        the reference). ``mesh=`` (a 2-axis ``(m, n)`` mesh, ``rank=``
        required, no ``dispatch_chunk``) runs every level through
        ``parallel.registration_bcpd_2d`` with the same raw-frame
        carries, the multistart coarsest level on this rank's device
        alone. The reference's TPU-only guard, which splits large levels
        on a TPU backend, has no counterpart.

    Returns:
        CombinedTransformation for the full-resolution source.
    """
    from . import bcpd as _bcpd

    for managed in ("tf_init_params", "sigma2_init", "v_init"):
        if managed in kwargs:
            raise ValueError(f"{managed} is managed by the pyramid; pass it "
                             "to registration_bcpd instead.")
    if kwargs.get("callbacks"):
        raise ValueError("registration_bcpd_pyramid does not support "
                         "callbacks (warm starts require the jitted path)")
    kwargs.pop("callbacks", None)
    normalize = bool(kwargs.pop("normalize", True))
    dispatch_chunk = kwargs.pop("dispatch_chunk", None)
    n_starts = int(kwargs.pop("n_starts", 1))
    if mesh is not None:
        if dispatch_chunk:
            raise ValueError("dispatch_chunk is not supported with mesh= "
                             "(the 2-D runner does not expose its final "
                             "VI iterate)")
        if kwargs.get("rank") is None:
            raise ValueError("mesh= BCPD pyramid requires rank= "
                             "(registration_bcpd_2d is low-rank only)")
        from .parallel.mesh import rank_device

        dev = rank_device(device)
    else:
        dev = _config.resolve_device(device)
    auto_schedule = voxel_sizes is None
    src_levels, tgt_levels, voxel_sizes = _prepare_levels(
        source, target, voxel_sizes, levels, coarse_points, factor, dev,
        keep_device_last=False)
    level_maxiters = _fit_level_maxiters(
        level_maxiters, len(voxel_sizes), maxiter, 3, auto_schedule)
    if mesh is not None:
        return _bcpd_pyramid_2d(src_levels, tgt_levels, voxel_sizes,
                                level_maxiters, mesh, w, tol, normalize,
                                sigma2_inflation, n_starts, dev, kwargs)

    res = None
    tf_init = None
    v_init = None
    sigma2_init = None
    for i, (s_i, t_i) in enumerate(zip(src_levels, tgt_levels)):
        out = {}
        # The orientation search on the coarsest level only, run whole.
        multistart = n_starts > 1 and i == 0

        def _run(mi, warm, s_i=s_i, t_i=t_i, out=out,
                 multistart=multistart):
            if multistart:
                warm = {}
            res, sigma2_raw, last, rinfo = _bcpd._registration_bcpd_impl(
                s_i, t_i, w=w, maxiter=mi, tol=tol, callbacks=[],
                normalize=normalize, callback_chunk=1, return_last=True,
                n_starts=n_starts if multistart else 1, device=dev, **warm,
                **kwargs)
            out["sigma2_raw"], out["last"] = sigma2_raw, last
            rinfo = rinfo or {}
            rmse = rinfo.get("best")
            if rmse is not None and (out.get("best_rmse") is None
                                     or rmse < out["best_rmse"]):
                out["best_rmse"] = rmse
                out["best"] = (res, sigma2_raw)
            out["prev_last_rmse"] = out.get("last_rmse")
            out["last_rmse"] = rinfo.get("last")
            return res

        def _carry(res, out=out):
            if out["last"] is None:
                # A path without last-state tracking: restart from the
                # result state.
                return {"tf_init_params": _rigid_params(res.rigid_trans),
                        "v_init": _host(res.v),
                        "sigma2_init": out["sigma2_raw"]}
            return out["last"]

        def _stop(out=out, tol=tol):
            # The in-run |rmse - rmse_prev| < tol criterion, applied to
            # consecutive chunks' final iterates.
            a, b = out.get("last_rmse"), out.get("prev_last_rmse")
            return a is not None and b is not None and abs(a - b) < tol

        res = _sliced_level(
            level_maxiters[i], None if multistart else dispatch_chunk,
            {"tf_init_params": tf_init, "v_init": v_init,
             "sigma2_init": sigma2_init},
            _run, _carry, tol=tol, stop=_stop)
        if out.get("best") is not None:
            res, sigma2_raw = out["best"]
        else:
            sigma2_raw = out["sigma2_raw"]
        if i + 1 < len(src_levels):
            tf_init = _rigid_params(res.rigid_trans)
            v_init = _interp_displacement(s_i, res.v, src_levels[i + 1],
                                          voxel_sizes[i], device=dev)
            if sigma2_raw is not None:
                sigma2_init = _carry_sigma2(sigma2_raw, voxel_sizes[i],
                                            sigma2_inflation)
    return res


def _bcpd_pyramid_2d(src_levels, tgt_levels, voxel_sizes, level_maxiters,
                     mesh, w, tol, normalize, sigma2_inflation, n_starts, dev,
                     kwargs):
    """The BCPD pyramid's levels on a 2-D ``(m, n)`` mesh (reference
    pyramid.py:655): every level through
    ``parallel.registration_bcpd_2d`` with the single-device schedule's
    raw-frame carries (rot / t / scale, the interpolated displacement as
    ``v_init``, the inflated sigma2); a multistart coarsest level
    (``n_starts > 1``) on ``dev`` alone, the 2-D runner having no
    orientation search."""
    from . import bcpd as _bcpd
    from .parallel import sharded2d as _s2d

    res = None
    tf_init = None
    v_init = None
    sigma2_init = None
    for i, (s_i, t_i) in enumerate(zip(src_levels, tgt_levels)):
        if n_starts > 1 and i == 0:
            res, sigma2_raw = _bcpd._registration_bcpd_impl(
                s_i, t_i, w=w, maxiter=int(level_maxiters[i]), tol=tol,
                callbacks=[], normalize=normalize, callback_chunk=1,
                n_starts=n_starts, device=dev, **kwargs)
        else:
            res, sigma2_raw = _s2d.registration_bcpd_2d(
                s_i, t_i, w=w, maxiter=int(level_maxiters[i]), tol=tol,
                normalize=normalize, mesh=mesh, tf_init_params=tf_init,
                v_init=v_init, sigma2_init=sigma2_init, return_sigma2=True,
                device=dev, **kwargs)
        if i + 1 < len(src_levels):
            tf_init = _rigid_params(res.rigid_trans)
            v_init = _interp_displacement(s_i, res.v, src_levels[i + 1],
                                          voxel_sizes[i], device=dev)
            if sigma2_raw is not None:
                sigma2_init = _carry_sigma2(sigma2_raw, voxel_sizes[i],
                                            sigma2_inflation)
    return res


def registration_filterreg_pyramid(
    source,
    target,
    target_normals=None,
    w: float = 0.0,
    objective_type: str = "pt2pt",
    maxiter: int = 50,
    tol: float = 0.001,
    min_sigma2: float = 1.0e-4,
    callbacks: List[Callable] = [],
    levels: int = 3,
    voxel_sizes: Optional[Sequence[float]] = None,
    coarse_points: int = 3000,
    factor: float = 4.0,
    sigma2_inflation: float = 3.0,
    sigma2_decay: float = 0.9,
    update_sigma2: bool = False,
    level_maxiters: Optional[Sequence[int]] = None,
    mesh=None,
    device=None,
    **kwargs: Any,
):
    """Coarse-to-fine rigid FilterReg (reference pyramid.py:697).

    Same schedule as :func:`registration_cpd_pyramid`, with ``maxiter //
    3`` (>= 10) polish iterations at full resolution. pt2pl needs normals
    per level, so only the full-resolution level uses ``target_normals``;
    coarser levels run pt2pt to produce the warm start. ``sigma2_decay``
    defaults to 0.9 here: with a fixed sigma2 FilterReg never anneals, so
    its final sigma2 would hand finer levels a cloud-scale variance. With
    annealing (or ``update_sigma2``) the converged variance is carried
    like CPD's; without either, each level estimates its own and only the
    transform is carried. ``n_starts`` (no callbacks) applies to the
    COARSEST level only, which then runs whole. ``mesh=`` runs every level
    through ``parallel.registration_filterreg_sharded`` (a 1-axis mesh
    shards the target, a 2-axis one both clouds) with the same carries,
    the multistart coarsest level on this rank's device alone; it takes
    neither callbacks nor ``dispatch_chunk`` nor other keyword arguments
    (``ValueError``).
    """
    from . import filterreg as _frg

    if "tf_init_params" in kwargs or "sigma2" in kwargs:
        raise ValueError("tf_init_params/sigma2 are managed by the pyramid; "
                         "pass them to registration_filterreg instead.")
    n_starts = int(kwargs.pop("n_starts", 1))
    if n_starts > 1 and callbacks:
        raise ValueError("n_starts > 1 and callbacks are incompatible "
                         "(the multistart coarsest level runs the "
                         "no-callback rigid dense path)")
    dispatch_chunk = kwargs.pop("dispatch_chunk", None)
    if mesh is not None and (callbacks or dispatch_chunk):
        raise ValueError("mesh= FilterReg pyramid supports neither "
                         "callbacks nor dispatch_chunk")
    if mesh is not None and kwargs:
        raise ValueError(
            f"mesh= FilterReg pyramid does not support {sorted(kwargs)}; "
            "supported there: sigma2/w/maxiter/tol/min_sigma2/"
            "sigma2_decay/update_sigma2/objective_type/target_normals/"
            "n_starts.")
    if mesh is None:
        dev = _config.resolve_device(device)
    else:  # the sharded runner takes host clouds and shards them itself
        from .parallel import sharded as _sharded
        from .parallel.mesh import rank_device

        dev = rank_device(device)
    auto_schedule = voxel_sizes is None
    src_levels, tgt_levels, voxel_sizes = _prepare_levels(
        source, target, voxel_sizes, levels, coarse_points, factor,
        dev if mesh is None else "cpu", keep_device_last=mesh is None)
    level_maxiters = _fit_level_maxiters(
        level_maxiters, len(voxel_sizes), maxiter, 3, auto_schedule)

    res = None
    tf_init = None
    sigma2 = None
    sigma2_meaningful = update_sigma2 or sigma2_decay < 1.0
    for i, (s_i, t_i) in enumerate(zip(src_levels, tgt_levels)):
        last = i + 1 == len(src_levels)
        # The orientation search on the coarsest level only, run whole.
        multistart = n_starts > 1 and i == 0

        def _run(mi, warm, s_i=s_i, t_i=t_i, last=last,
                 multistart=multistart):
            tf_c, s2_c = (None, None) if multistart else warm
            if mesh is not None and not multistart:
                return _sharded.registration_filterreg_sharded(
                    s_i, t_i,
                    target_normals=target_normals if last else None,
                    objective_type=objective_type if last else "pt2pt",
                    sigma2=s2_c, w=w, maxiter=mi, tol=tol,
                    min_sigma2=min_sigma2, sigma2_decay=sigma2_decay,
                    update_sigma2=update_sigma2, mesh=mesh,
                    tf_init_params=tf_c, device=dev)
            return _frg.registration_filterreg(
                s_i, t_i,
                target_normals=target_normals if last else None,
                sigma2=s2_c, w=w,
                objective_type=objective_type if last else "pt2pt",
                maxiter=mi, tol=tol, min_sigma2=min_sigma2,
                sigma2_decay=sigma2_decay, update_sigma2=update_sigma2,
                callbacks=callbacks, tf_init_params=tf_c or {},
                n_starts=n_starts if multistart else 1, device=dev,
                **kwargs)

        def _carry(res):
            return (_rigid_params(res.transformation, scale=False),
                    float(res.sigma2))

        res = _sliced_level(level_maxiters[i],
                            None if multistart else dispatch_chunk,
                            (tf_init, sigma2), _run, _carry, tol=tol)
        if not last:
            tf_init = _rigid_params(res.transformation, scale=False)
            if sigma2_meaningful:
                sigma2 = _carry_sigma2(float(res.sigma2), voxel_sizes[i],
                                       sigma2_inflation)
    return res


def registration_gmmtree_pyramid(
    source,
    target,
    maxiter: int = 20,
    tol: float = 1.0e-4,
    callbacks: List[Callable] = [],
    levels: int = 3,
    voxel_sizes: Optional[Sequence[float]] = None,
    coarse_points: int = 3000,
    factor: float = 4.0,
    level_maxiters: Optional[Sequence[int]] = None,
    device=None,
    **kwargs: Any,
):
    """Coarse-to-fine GMMTree (reference pyramid.py:846).

    Per level a tree is built from the downsampled source and the
    downsampled target registers against it. GMMTree's EM moves the TARGET
    and returns the inverse, so the carried initializer is the INVERSE of
    the previous level's returned transform. No variance carry: node
    covariances come from each level's tree. Args as in
    :func:`probreg_tpu_torch.gmmtree.registration_gmmtree`, schedule args
    as in :func:`registration_cpd_pyramid` (``maxiter // 2`` polish).
    ``n_starts`` applies to the COARSEST level only (not with
    ``dispatch_chunk``).
    """
    from . import gmmtree as _gt

    if "tf_init_params" in kwargs:
        raise ValueError("tf_init_params is managed by the pyramid; pass it "
                         "to registration_gmmtree instead.")
    n_starts = int(kwargs.pop("n_starts", 1))
    dev = _config.resolve_device(device)
    auto_schedule = voxel_sizes is None
    src_levels, tgt_levels, voxel_sizes = _prepare_levels(
        source, target, voxel_sizes, levels, coarse_points, factor, dev)
    level_maxiters = _fit_level_maxiters(
        level_maxiters, len(voxel_sizes), maxiter, 2, auto_schedule)
    dispatch_chunk = kwargs.pop("dispatch_chunk", None)
    if dispatch_chunk and n_starts > 1:
        raise ValueError("dispatch_chunk is incompatible with n_starts > 1")

    res = None
    tf_init: dict = {}
    for i, (s_i, t_i) in enumerate(zip(src_levels, tgt_levels)):
        def _run(mi, warm, s_i=s_i, t_i=t_i, i=i):
            return _gt.registration_gmmtree(
                s_i, t_i, maxiter=mi, tol=tol, callbacks=callbacks,
                tf_init_params=dict(warm) or {},
                n_starts=n_starts if i == 0 else 1, device=dev, **kwargs)

        def _carry(res):
            return _rigid_params(res.transformation.inverse(), scale=False)

        res = _sliced_level(level_maxiters[i], dispatch_chunk,
                            dict(tf_init), _run, _carry, tol=tol)
        if i + 1 < len(src_levels):
            tf_init = _carry(res)
    return res


def registration_icp_pyramid(
    source,
    target,
    maxiter: int = 50,
    tol: float = 1.0e-6,
    trim_fraction: float = 0.0,
    levels: int = 3,
    voxel_sizes: Optional[Sequence[float]] = None,
    coarse_points: int = 3000,
    factor: float = 4.0,
    level_maxiters: Optional[Sequence[int]] = None,
    device=None,
    **kwargs: Any,
):
    """Coarse-to-fine point-to-point ICP (reference pyramid.py:914): each
    finer level starts at the coarse level's pose, so the nearest-neighbour
    iterations at full resolution only polish (``maxiter // 2`` of them by
    default). Args as in :func:`probreg_tpu_torch.icp.registration_icp`,
    schedule args as in :func:`registration_cpd_pyramid`."""
    from . import icp as _icp

    if "tf_init_params" in kwargs:
        raise ValueError("tf_init_params is managed by the pyramid; pass it "
                         "to registration_icp instead.")
    dev = _config.resolve_device(device)
    auto_schedule = voxel_sizes is None
    src_levels, tgt_levels, voxel_sizes = _prepare_levels(
        source, target, voxel_sizes, levels, coarse_points, factor, dev)
    level_maxiters = _fit_level_maxiters(
        level_maxiters, len(voxel_sizes), maxiter, 2, auto_schedule)
    dispatch_chunk = kwargs.pop("dispatch_chunk", None)

    res = None
    tf_init: dict = {}
    for i, (s_i, t_i) in enumerate(zip(src_levels, tgt_levels)):
        def _run(mi, warm, s_i=s_i, t_i=t_i):
            return _icp.registration_icp(
                s_i, t_i, maxiter=mi, tol=tol, trim_fraction=trim_fraction,
                tf_init_params=dict(warm), device=dev, **kwargs)

        def _carry(res):
            return _rigid_params(res.transformation, scale=False)

        res = _sliced_level(level_maxiters[i], dispatch_chunk,
                            dict(tf_init), _run, _carry, tol=tol)
        if i + 1 < len(src_levels):
            tf_init = _carry(res)
    return res
