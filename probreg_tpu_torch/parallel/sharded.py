"""Sharded registration on a 1-D mesh: the target sharded, the source
replicated.

Counterpart of probreg_tpu/parallel/sharded.py. Each rank
holds the whole source and the transformation, and a shard of the target
(mesh.py). A target column's normalizer is a sum over source rows, so it is
complete on the rank, and one ``all_reduce`` of the (D + 2) M moment sums
(px, p1, xx) per E-step combines the ranks; pt1 stays with its shard. The
M-step (a D x D problem) is computed on every rank from the reduced sums,
so every rank holds the same transformation and takes the same stop
decision: the loop test reads only reduced values.

``registration_cpd_batch_sharded`` splits a batch of pairs over the ranks
instead: each rank runs its pairs through ``cpd.registration_cpd_batch``
(the whole-EM kernel K1 on the card) and one ``all_reduce`` of zero-filled
buffers hands every rank every result.

The nonrigid kind (``"nonrigid"``; with ``rank=`` the low-rank one)
keeps the whole source, its Gram matrix or its Nystrom factors U and lam
and the M-step's M x M or K x K solve replicated on every rank: only the
E-step is sharded, over the target, with the same one ``all_reduce`` of
the moments (``estep_sharded``).

The other families shard the same way, each E-step the single-card one
on the shard:

* FilterReg (``registration_filterreg_sharded``): one all_reduce of the
  (M, C) moment sums per E-step; the shards Morton-sorted once, so the
  Gauss transform is the tile-culled kernel K6 from
  ``config.culled_estep_min_pairs``;
* BCPD (``registration_bcpd_sharded``): one all_reduce of the (D + 2, M)
  moments and e1 and one min all_reduce of the per-row minima per E-step
  (the row-weighted kernel K8 under the single-card gate), the first
  rank's M-step state on every rank;
* GMMTree (``registration_gmmtree_sharded``): the tree built on the first
  rank, one all_reduce of the node moments per iteration;
* GMMReg and SVR (``registration_gmmreg_sharded``,
  ``registration_svr_sharded``): the GMM and one-class SVM fits over the
  mesh, the BFGS over the mixtures replicated.

A 2-D ``(m, n)`` mesh routes CPD, FilterReg and BCPD to sharded2d.py;
GMMTree, GMMReg and SVR take 1-D meshes only (``ValueError``).
"""

from __future__ import annotations

import math
from typing import Any, Optional

import numpy as np
import torch
import torch.distributed as dist

from .. import cpd as cpd_mod
from ..config import config
from ..models import transformation as tf
from ..ops import estep_cuda as ec
from ..ops import gausstransform as gto
from ..ops import lowrank, pairwise
from ..ops.estep import EstepMoments, outlier_constant
from ..ops.pairwise import sqdist
from ..utils import interop
from .mesh import (AXIS, COUNTS, all_reduce_, all_reduce_min_, axis_group,
                   from_first_rank, gather_shards, make_mesh, rank_device,
                   shard_points, shard_range)

_F32_EPS = float(torch.finfo(torch.float32).eps)


def _local_moments(t_source, x_shard, sigma2, c):
    """Exact moments of the posterior columns this rank owns."""
    g = torch.exp(-sqdist(t_source, x_shard) / (2.0 * sigma2))
    den_raw = g.sum(0)
    den = torch.where(den_raw == 0.0, _F32_EPS, den_raw) + c
    pt1 = den_raw / den
    pmat = g / den
    xx = (pt1 * (x_shard * x_shard).sum(1)).sum()
    return pt1, pmat.sum(1), pmat @ x_shard, xx


def _reduced(pt1, p1, px, xx, group) -> EstepMoments:
    """One E-step's moments with p1, px and xx summed over ``group`` in one
    all_reduce; pt1 stays this rank's."""
    m, dim = px.shape
    sums = all_reduce_(torch.cat([p1, px.reshape(-1), xx.reshape(1)]), group)
    COUNTS["esteps"] += 1
    p1, px = sums[:m], sums[m:m + m * dim].reshape(m, dim)
    return EstepMoments(pt1, p1, px, p1.sum(), sums[-1])


def estep_sharded(t_source: torch.Tensor, target_loc: torch.Tensor, sigma2,
                  w: float, n: int, mesh, axis: str = AXIS) -> EstepMoments:
    """E-step of the replicated transformed source (M, D) against this
    rank's target shard (Nl, D): p1, px, n_p and xx summed over the mesh,
    pt1 this shard's (Nl,). ``n`` is the whole target's count, used for
    the outlier constant (reference cpd.py:78-79)."""
    m, dim = t_source.shape
    c = outlier_constant(sigma2, w, m, n, dim)
    return _reduced(*_local_moments(t_source, target_loc, sigma2, c),
                    axis_group(mesh, axis)[0])


def _pack_init(tf_init_params, kind: str, dim: int):
    """The reference's packed (D*D + D + 1,) warm start: lin, t, scale."""
    p = tf_init_params or {}
    key = "rot" if kind == "rigid" else "b"
    return np.concatenate([
        np.asarray(p.get(key, np.eye(dim)), np.float32).ravel(),
        np.asarray(p.get("t", np.zeros(dim)), np.float32),
        np.atleast_1d(np.float32(p.get("scale", 1.0)))])


def _unpack_init(init, dim: int, dev):
    init = torch.as_tensor(init, dtype=torch.float32, device=dev)
    d2 = dim * dim
    return init[:d2].reshape(dim, dim), init[d2:d2 + dim], init[d2 + dim]


def _kernel_sum(ys_t, xs_t, n, grp):
    """squared_kernel_sum of the replicated (D, M) source and the (D, N)
    target from its shards' sums (one all_reduce); no centring, as the
    reference's sharded code."""
    dim, m = ys_t.shape
    st = all_reduce_(torch.cat([(xs_t * xs_t).sum().reshape(1),
                                xs_t.sum(1)]), grp)
    sx = ys_t.sum(1)
    return (n * (ys_t * ys_t).sum() + m * st[0] - 2.0 * sx @ st[1:]) \
        / (m * dim * n)


def _sigma2_start(ys_t, xs_t, sigma2_init, n, grp):
    """The starting variance: ``sigma2_init`` (floored at f32 eps), else
    :func:`_kernel_sum`."""
    if sigma2_init is not None:
        return torch.clamp(torch.as_tensor(sigma2_init, dtype=torch.float32,
                                           device=ys_t.device), min=_F32_EPS)
    return _kernel_sum(ys_t, xs_t, n, grp)


def _run_em_sharded_t(source, xs_loc, init, sigma2_init=None, *, kind,
                      w, maxiter, tol, update_scale, n, mesh, axis,
                      use_culled=False, culled_tile=1024):
    """Sharded whole EM, rigid or affine (reference ``sharded.py:159``):
    the source (M, D) replicated, ``xs_loc`` (Nl, D) this rank's target
    shard, ``init`` the packed (D*D + D + 1,) start (``_pack_init``); no
    centring, as the reference's sharded code.

    ``use_culled``: the per-shard tile-culled stash E-step (K3,
    ``estep_cuda.stash_estep``) of the replicated source against the shard,
    on clouds the caller sorted in Morton order. Its stash is (M_padded,
    tile_n) per rank whatever the mesh, so tile_n shrinks to fit the CPD
    stash budget (``config.stash_max_bytes``, the reference's
    ``cpd_stash_max_bytes``), and the call raises where even tile_n = 256
    does not fit. Otherwise the dense (M, Nl) posterior
    (``estep_sharded``).

    Returns (lin, t, scale, sigma2, q).
    """
    grp = axis_group(mesh, axis)[0]
    dev = source.device
    ys_t, xs_t = source.T, xs_loc.T
    dim, m = ys_t.shape
    nl = xs_loc.shape[0]
    sigma2 = _sigma2_start(ys_t, xs_t, sigma2_init, n, grp)
    q = 1.0 + n * dim * 0.5 * torch.log(sigma2)

    if use_culled:
        tm = min(culled_tile, ec._round_up(m, 8))
        tn = min(culled_tile, ec._round_up(max(nl, 1), 128))
        budget = ec.stash_budget(dev)
        tn_c = ec._capped_tile_n(m, tm, tn, budget, on_overflow="fallback")
        if tn_c is None:
            raise ValueError(
                f"sharded culled E-step: the per-device g-stash for M={m} "
                f"exceeds config.stash_max_bytes ({budget}) even at the "
                "tile_n=256 floor. Pass use_culled=False (dense per-shard "
                "scan) or use a 2-axis mesh (shards the source too).")
        tn = min(tn, tn_c)

    def estep(t_src, sigma2):
        """(px_t (D, M), p1 (M,), n_p, xx), summed over the mesh."""
        ys = t_src.T.contiguous()
        if not use_culled:
            mom = estep_sharded(ys, xs_loc, sigma2, w, n, mesh, axis)
        elif nl == 0:  # an empty shard adds zeros
            mom = _reduced(None, ys.new_zeros(m), torch.zeros_like(ys),
                           ys.new_zeros(()), grp)
        else:
            scal = ec._scalars(sigma2, w, m, n, dim, dev)
            mask = ec._active_mask(*ec._tile_bounds(ys, tm),
                                   *ec._tile_bounds(xs_loc, tn), scal[0])
            mom = _reduced(*ec.stash_estep(ys, xs_loc, scal, mask, tm, tn),
                           grp)
        return mom.px.T, mom.p1, mom.n_p, mom.xx

    lin, t, scale = _unpack_init(init, dim, dev)
    q_prev, i = math.inf, 0
    while True:
        done, q_prev_next = cpd_mod._converged(i, q, q_prev, maxiter, tol)
        if done:
            break
        px_t, p1, n_p, xx = estep(scale * lin @ ys_t + t[:, None], sigma2)
        if kind == "rigid":
            lin, t, scale, sigma2, q = cpd_mod._rigid_mstep_t(
                ys_t, p1, px_t, n_p, xx, update_scale)
        else:
            lin, t, sigma2, q = cpd_mod._affine_mstep_t(ys_t, p1, px_t, n_p,
                                                        xx)
        q_prev, i = q_prev_next, i + 1
    return lin, t, scale, sigma2, q


def _run_em_sharded_nonrigid(source, xs_loc, tf0, sigma2_init=None, *,
                             lmd, w, maxiter, tol, n, mesh, axis):
    """Sharded whole EM of the nonrigid kinds (reference ``sharded.py:373``
    ``_run_em_sharded``): ``tf0`` a ``NonRigidTransformation`` (dense Gram,
    an M x M solve per iteration) or a ``LowRankNonRigidTransformation``
    (a K x K Woodbury solve), replicated like the (M, D) ``source``; the
    E-step's moments all-reduced over ``axis`` (``estep_sharded``). The
    previous sigma2 is the M-step's sigma2_p; q is sigma2. Every rank
    solves the M-step, then takes the first rank's weights and sigma2
    (``from_first_rank``). Returns an MstepResult."""
    grp = axis_group(mesh, axis)[0]
    dim = source.shape[1]
    sigma2 = _sigma2_start(source.T, xs_loc.T, sigma2_init, n, grp)
    q = 1.0 + n * dim * 0.5 * torch.log(sigma2)
    transf = tf0
    q_prev, i = math.inf, 0
    while True:
        done, q_prev_next = cpd_mod._converged(i, q, q_prev, maxiter, tol)
        if done:
            break
        mom = estep_sharded(transf._transform(source), xs_loc, sigma2, w, n,
                            mesh, axis)
        if isinstance(transf, tf.LowRankNonRigidTransformation):
            transf, sigma2, _ = cpd_mod.nonrigid_lowrank_maximization_step(
                source, mom, transf.u, transf.lam, lmd, sigma2)
            weights = transf.zc
        else:
            transf, sigma2, _ = cpd_mod.nonrigid_maximization_step(
                source, mom, transf.g, lmd, sigma2)
            weights = transf.w
        state = from_first_rank(torch.cat([weights.reshape(-1),
                                           sigma2.reshape(1)]), grp)
        weights.copy_(state[:-1].reshape(weights.shape))
        sigma2 = q = state[-1]
        q_prev, i = q_prev_next, i + 1
    return cpd_mod.MstepResult(transf, sigma2, q)


def _result(kind, lin, t, scale, sigma2, q, dev):
    if kind == "rigid":
        transf = tf.RigidTransformation(lin, t, scale, device=dev)
    else:
        transf = tf.AffineTransformation(lin, t, device=dev)
    return cpd_mod.MstepResult(transf, sigma2, q)


def _host_points(x) -> np.ndarray:
    return interop.as_points(x, device="cpu").numpy()


def registration_cpd_sharded(
    source,
    target,
    tf_type_name: str = "rigid",
    w: float = 0.0,
    maxiter: int = 50,
    tol: float = 0.001,
    mesh=None,
    update_scale: bool = True,
    beta: float = 2.0,
    lmd: float = 2.0,
    device=None,
    **kwargs: Any,
) -> cpd_mod.MstepResult:
    """Multi-rank CPD registration, rigid, affine or nonrigid (reference
    ``sharded.py:401``). Same semantics as ``cpd.registration_cpd``.

    Every rank calls it with the same full clouds. The target is sharded
    over the 1-D ``mesh`` (default: every rank); source and transformation
    are replicated; the moments are all-reduced. On a 2-D ``(m, n)`` mesh
    both clouds are sharded: see :func:`sharded2d.registration_cpd_2d`.
    ``"nonrigid"`` takes ``beta`` and ``lmd``, and ``rank=`` for the
    low-rank model (Nystrom factors and the K x K solve replicated); its
    E-step is the dense sharded one, its clouds never sorted.

    Keyword Args:
        rank: the low-rank nonrigid model's rank (nonrigid only).
        use_culled: the per-shard tile-culled stash E-step (default: the
            tensors are on CUDA, ``config.use_culled_estep`` and M * N >=
            ``config.culled_estep_min_pairs``); both clouds are then sorted
            in Morton order once, on the host (rigid and affine results do
            not depend on point order).
        culled_tile: its tile size (default 1024).
        tf_init_params: warm start (``rot`` / ``b``, ``t``, ``scale``).
        sigma2_init: warm-start variance.
        device: this rank's device (default ``cuda:{LOCAL_RANK}``).
    """
    if mesh is None:
        mesh = make_mesh()
    if mesh.ndim == 2:
        from .sharded2d import registration_cpd_2d

        return registration_cpd_2d(
            source, target, tf_type_name, w=w, maxiter=maxiter, tol=tol,
            mesh=mesh, update_scale=update_scale, beta=beta, lmd=lmd,
            device=device, **kwargs)
    if tf_type_name not in ("rigid", "affine", "nonrigid"):
        raise ValueError("unknown tf_type_name %s" % tf_type_name)
    use_culled = kwargs.pop("use_culled", None)
    culled_tile = int(kwargs.pop("culled_tile", 1024))
    tf_init_params = dict(kwargs.pop("tf_init_params", None) or {})
    sigma2_init = kwargs.pop("sigma2_init", None)
    rank = kwargs.pop("rank", None)
    if kwargs:
        raise TypeError(f"registration_cpd_sharded: unknown kwargs "
                        f"{sorted(kwargs)}")
    dev = rank_device(device)
    axis = mesh.mesh_dim_names[0]
    src, tgt = _host_points(source), _host_points(target)
    if tf_type_name == "nonrigid":
        if tf_init_params:
            raise ValueError("tf_init_params warm starts are rigid/affine-"
                             "only on the sharded path (the nonrigid field "
                             "has no packed init)")
        xs_loc, n = shard_points(tgt, mesh, axis, dev)
        ys = torch.as_tensor(src, device=dev)
        grp = axis_group(mesh, axis)[0]
        # The Gram matrix or the Nystrom factors as the first rank builds
        # them, so that every rank holds the same model (from_first_rank).
        if rank is None:
            g = from_first_rank(pairwise.rbf_kernel(ys, ys, beta), grp)
            tf0 = tf.NonRigidTransformation(None, ys, g=g, device=dev)
        else:
            u, lam = lowrank.lowrank_rbf(ys, float(beta), int(rank))
            u, lam = from_first_rank(u, grp), from_first_rank(lam, grp)
            tf0 = tf.LowRankNonRigidTransformation(
                u.new_zeros((u.shape[1], ys.shape[1])), u, lam, device=dev)
        return _run_em_sharded_nonrigid(
            ys, xs_loc, tf0, sigma2_init, lmd=lmd, w=float(w),
            maxiter=int(maxiter), tol=float(tol), n=n, mesh=mesh, axis=axis)
    if use_culled is None:
        use_culled = (dev.type == "cuda" and config.use_culled_estep
                      and src.shape[0] * tgt.shape[0]
                      >= config.culled_estep_min_pairs)
    if use_culled:
        # One-time host Morton sort: each contiguous target shard and each
        # source tile becomes spatially compact, so the tile culling fires.
        from ..ops.spatial import morton_order_np

        src = src[morton_order_np(src)]
        tgt = tgt[morton_order_np(tgt)]
    xs_loc, n = shard_points(tgt, mesh, axis, dev)
    lin, t, scale, sigma2, q = _run_em_sharded_t(
        torch.as_tensor(src, device=dev), xs_loc,
        _pack_init(tf_init_params, tf_type_name, src.shape[1]), sigma2_init,
        kind=tf_type_name, w=float(w), maxiter=int(maxiter), tol=float(tol),
        update_scale=bool(update_scale), n=n, mesh=mesh, axis=axis,
        use_culled=bool(use_culled), culled_tile=culled_tile)
    return _result(tf_type_name, lin, t, scale, sigma2, q, dev)


def registration_cpd_batch_sharded(
    sources,
    targets,
    tf_type_name: str = "rigid",
    w: float = 0.0,
    maxiter: int = 50,
    tol: float = 0.001,
    update_scale: bool = True,
    mesh=None,
    axis_name: str = "batch",
    device=None,
):
    """B cloud pairs registered data-parallel over the ranks (reference
    ``sharded.py:753``).

    The pairs are split over the first axis of ``mesh`` (default: a 1-D
    mesh over every rank) in shards of ceil(B / P); each rank registers
    its pairs with ``cpd.registration_cpd_batch`` (one launch of the
    whole-EM kernel on the card) and one ``all_reduce`` of zero-filled
    (B, ...) buffers gives every rank every result, which is each pair's
    result bit for bit. ``sources`` / ``targets`` may be lists of clouds of
    different sizes (ragged). Returns a list of B MstepResult.
    """
    if tf_type_name not in ("rigid", "affine"):
        raise ValueError("batch registration supports 'rigid' and 'affine'")
    if mesh is None:
        mesh = make_mesh(axis=axis_name)
    grp, index, parts = axis_group(mesh, mesh.mesh_dim_names[0])
    dev = rank_device(device)
    ragged = isinstance(sources, (list, tuple)) \
        or isinstance(targets, (list, tuple))
    if not ragged:
        sources = interop.as_points(sources, device="cpu")
        targets = interop.as_points(targets, device="cpu")
    b = len(sources)
    dim = sources[0].shape[-1]
    start, stop = shard_range(b, parts, index)
    width = dim * dim + dim + 3  # lin, t, scale, sigma2, q
    buf = torch.zeros((b, width), dtype=torch.float32, device=dev)
    if stop > start:
        mine = cpd_mod.registration_cpd_batch(
            sources[start:stop], targets[start:stop], tf_type_name, w=w,
            maxiter=maxiter, tol=tol, update_scale=update_scale, device=dev)
        for row, res in zip(buf[start:stop], mine):
            tr = res.transformation
            rigid = tf_type_name == "rigid"
            row[:dim * dim] = (tr.rot if rigid else tr.b).reshape(-1)
            row[dim * dim:dim * dim + dim] = tr.t
            row[-3] = tr.scale if rigid else 1.0
            row[-2], row[-1] = res.sigma2, res.q
    all_reduce_(buf, grp)
    lin = buf[:, :dim * dim].reshape(b, dim, dim)
    t = buf[:, dim * dim:dim * dim + dim]
    return [_result(tf_type_name, lin[i], t[i], buf[i, -3], buf[i, -2],
                    buf[i, -1], dev) for i in range(b)]


# --------------------------------------------------------------------------
# FilterReg (rigid pt2pt / pt2pl)
# --------------------------------------------------------------------------

def _point_spacing(xs_loc, n, mesh, axis):
    """The whole target's mean squared nearest-neighbour spacing (the
    point itself excluded): this rank's points against the whole cloud,
    gathered once and streamed in blocks of 4,096
    (``pairwise.nearest_sqdist``); the sum over the shards in one
    all_reduce."""
    full = gather_shards(xs_loc, n, mesh, axis)
    nn2 = pairwise.nearest_sqdist(xs_loc, full, exclude_zero=True)
    total = torch.where(torch.isfinite(nn2), nn2, 0.0).sum().reshape(1)
    return all_reduce_(total, axis_group(mesh, axis)[0])[0] / max(n, 1)


def _run_filterreg_mesh(ys, xs_loc, nrm_loc, sigma2, rot, t, *,
                        objective_type, update_sigma2, w, maxiter, tol,
                        min_sigma2, sigma2_decay, m, n, n_grp, reduce=None):
    """The rigid FilterReg EM on a mesh (reference sharded.py:541 and
    sharded2d.py:472): ``ys`` (Ml, D) this rank's source rows (the whole
    source on a 1-D mesh), ``xs_loc`` / ``nrm_loc`` its target shard,
    both Morton-sorted by the caller; m, n the whole clouds' counts. Each
    E-step is the Gauss transform of the shard (``gauss_transform``: the
    tile-culled kernel K6 from ``config.culled_estep_min_pairs``, the
    dense product below) and one all_reduce of the (Ml, C) moments over
    ``n_grp``; the M-step is the single-card one, its sums over source
    rows summed over the source shards by ``reduce`` (None on a 1-D
    mesh). Returns (rot, t, sigma2, q)."""
    from .. import filterreg as frg

    dim = ys.shape[1]
    pt2pl = objective_type == "pt2pl"
    chans = gto.moment_channels(xs_loc, nrm_loc if pt2pl else None,
                                bool(update_sigma2))
    q = torch.tensor(math.inf, dtype=ys.dtype, device=ys.device)
    q_prev, i = math.inf, 0
    while True:
        done, q_prev_next = cpd_mod._converged(i, q, q_prev, maxiter, tol)
        if done:
            break
        t_src = ys @ rot.T + t
        sigma = torch.sqrt(sigma2)
        # Exact: the reference's mesh E-step forms its moments at HIGHEST
        # (probreg_tpu/parallel/sharded.py:611-628), never through the
        # start-temperature gate.
        out = gto.gauss_transform(xs_loc / sigma, t_src / sigma, chans,
                                  2.0 ** 0.5, assume_sorted=True,
                                  fast_start=False)
        COUNTS["esteps"] += 1
        m0, m1, m2, nx = gto.split_moments(all_reduce_(out, n_grp), dim,
                                           bool(update_sigma2), pt2pl)
        c = frg._outlier_c(sigma2, w, m, n, dim)
        if pt2pl:
            rot, t, s2, q = frg.rigid_mstep_pt2pl(t_src, m0, m1, m2, nx, rot,
                                                  t, sigma2, c, reduce)
        else:
            rot, t, s2, q = frg.rigid_mstep_pt2pt(t_src, m0, m1, m2, rot, t,
                                                  sigma2, c, reduce)
        sigma2 = frg._anneal(s2, sigma2, update_sigma2, sigma2_decay,
                             min_sigma2)
        q_prev, i = q_prev_next, i + 1
    return rot, t, sigma2, q


def _frg_clouds(source, target, target_normals, objective_type):
    """Host float32 clouds of a sharded FilterReg, each Morton-sorted once
    (the M-step reads only order-invariant sums), the normals with their
    target; checks the objective as registration_filterreg does."""
    from ..filterreg import _check_objective
    from ..ops.spatial import morton_order_np

    _check_objective(objective_type, target_normals)
    src, tgt = _host_points(source), _host_points(target)
    src = src[morton_order_np(src)]
    perm = morton_order_np(tgt)
    nrm = None
    if objective_type == "pt2pl":
        nrm = _host_points(target_normals)[perm]
    return src, tgt[perm], nrm


def _rigid_init(tf_init_params, dim, dev):
    """(rot, t) of a rigid warm start {'rot', 't'} (identity by default)."""
    return _unpack_init(_pack_init(tf_init_params, "rigid", dim), dim,
                        dev)[:2]


def registration_filterreg_sharded(
    source,
    target,
    target_normals=None,
    objective_type: str = "pt2pt",
    sigma2: Optional[float] = None,
    w: float = 0.0,
    maxiter: int = 50,
    tol: float = 0.001,
    min_sigma2: float = 1.0e-4,
    sigma2_decay: float = 1.0,
    update_sigma2: bool = False,
    mesh=None,
    tf_init_params: Optional[dict] = None,
    device=None,
):
    """Multi-rank rigid FilterReg (reference ``sharded.py:699``): the
    target (and its normals for pt2pl) sharded over the 1-D ``mesh``, the
    source replicated, one all_reduce of the (M, C) moments per E-step.
    Same semantics as registration_filterreg's streaming loop; every rank
    calls it with the same full clouds and gets the same result.
    ``tf_init_params`` {'rot', 't'} warm-starts the transform (the
    pyramid's carry); ``sigma2`` None estimates the start as the
    single-card path does (pt2pt: the squared kernel sum, pt2pl: the
    target's point spacing over the whole cloud). A 2-D ``(m, n)`` mesh
    shards both clouds (sharded2d.registration_filterreg_2d). Returns an
    MstepResult.
    """
    from .. import filterreg as frg

    if mesh is None:
        mesh = make_mesh()
    if mesh.ndim == 2:
        from .sharded2d import registration_filterreg_2d

        return registration_filterreg_2d(
            source, target, target_normals=target_normals,
            objective_type=objective_type, sigma2=sigma2, w=w,
            maxiter=maxiter, tol=tol, min_sigma2=min_sigma2,
            sigma2_decay=sigma2_decay, update_sigma2=update_sigma2,
            mesh=mesh, tf_init_params=tf_init_params, device=device)
    axis = mesh.mesh_dim_names[0]
    grp = axis_group(mesh, axis)[0]
    dev = rank_device(device)
    src, tgt, nrm = _frg_clouds(source, target, target_normals,
                                objective_type)
    m, dim = src.shape
    ys = torch.as_tensor(src, device=dev)
    xs_loc, n = shard_points(tgt, mesh, axis, dev)
    nrm_loc = None if nrm is None else shard_points(nrm, mesh, axis, dev)[0]
    if sigma2 is not None:
        sigma2_0 = torch.as_tensor(sigma2, dtype=ys.dtype, device=dev)
    elif objective_type == "pt2pl":
        sigma2_0 = torch.clamp(_point_spacing(xs_loc, n, mesh, axis),
                               min=min_sigma2 * 0.01)
    else:
        sigma2_0 = torch.clamp(_kernel_sum(ys.T, xs_loc.T, n, grp),
                               min=min_sigma2)
    rot, t, sigma2_out, q = _run_filterreg_mesh(
        ys, xs_loc, nrm_loc, sigma2_0, *_rigid_init(tf_init_params, dim, dev),
        objective_type=objective_type, update_sigma2=bool(update_sigma2),
        w=float(w), maxiter=int(maxiter), tol=float(tol),
        min_sigma2=float(min_sigma2), sigma2_decay=float(sigma2_decay), m=m,
        n=n, n_grp=grp)
    return frg.MstepResult(tf.RigidTransformation(rot, t, device=dev),
                           sigma2_out, q)


# --------------------------------------------------------------------------
# BCPD (variational inference over a sharded target)
# --------------------------------------------------------------------------

def _bcpd_normalized(source, target, normalize):
    """(source, target in the normalized frame as float32, centroid,
    scale) on the host in float64 (reference sharded.py:985-1000): the
    frame in which the squared kernel sum is 1."""
    from ..utils import math_utils as mu

    src = interop.as_points(source, dtype=torch.float64, device="cpu")
    tgt = interop.as_points(target, dtype=torch.float64, device="cpu")
    src, tgt = src.numpy(), tgt.numpy()
    if normalize:
        centroid = np.concatenate([src, tgt], axis=0).mean(axis=0)
        scale0 = max(np.sqrt(mu.squared_kernel_sum_np(src, tgt)), 1e-12)
    else:
        centroid, scale0 = np.zeros(src.shape[1]), 1.0
    return (((src - centroid) / scale0).astype(np.float32),
            ((tgt - centroid) / scale0).astype(np.float32), centroid, scale0)


def _first_rank_state(state, grp):
    """A tuple of tensors as the first rank of ``grp`` holds them (one
    all_reduce of them packed)."""
    flat = from_first_rank(torch.cat([x.reshape(-1) for x in state]), grp)
    out, at = [], 0
    for x in state:
        out.append(flat[at:at + x.numel()].reshape(x.shape))
        at += x.numel()
    return tuple(out)


def registration_bcpd_sharded(
    source,
    target,
    w: float = 0.0,
    maxiter: int = 50,
    tol: float = 0.001,
    lmd: float = 2.0,
    k: float = 1.0e20,
    gamma: float = 1.0,
    rank: Optional[int] = None,
    normalize: bool = True,
    mesh=None,
    device=None,
):
    """Multi-rank BCPD (reference ``sharded.py:944``): the target sharded
    over the 1-D ``mesh``, the source, the dense IMQ Gram matrix or its
    ``rank=`` Nystrom factors and the M-step replicated. Same semantics
    (the default scale normalization, the best-visited state and the final
    rescore of the last iterate) as bcpd.registration_bcpd.

    A target column's normalizer is a sum over source rows, so it is
    complete on the rank: each E-step is the single-card one on the shard
    (the row-weighted tile-culled kernel K8 where the single-card gate
    takes it, with the shard's size; the blocked dense one otherwise),
    then one all_reduce of the (D + 2, M) moments and e1 and one min
    all_reduce of the per-row minima (the NN-RMSE criterion). Every
    M-step's new state is the first rank's (its M x M or K x K solve may
    differ in the last bits between ranks), so every rank takes the same
    stop decision. ``mesh.COUNTS["esteps"]`` counts the loop's E-steps and
    the final rescore. A 2-D ``(m, n)`` mesh needs ``rank=`` and runs
    sharded2d.registration_bcpd_2d. Returns a CombinedTransformation.
    """
    from .. import bcpd as bcpd_mod
    from ..utils import math_utils as mu

    if mesh is None:
        mesh = make_mesh()
    if mesh.ndim == 2:
        if rank is None:
            raise ValueError("a 2-D mesh requires rank= (the dense M x M "
                             "Sigma solve does not distribute over the "
                             "m-axis)")
        from .sharded2d import registration_bcpd_2d

        return registration_bcpd_2d(
            source, target, w=w, maxiter=maxiter, tol=tol, lmd=lmd, k=k,
            gamma=gamma, rank=rank, normalize=normalize, mesh=mesh,
            device=device)
    axis = mesh.mesh_dim_names[0]
    grp, _, parts = axis_group(mesh, axis)
    dev = rank_device(device)
    src_n, tgt_n, centroid, scale0 = _bcpd_normalized(source, target,
                                                      normalize)
    m, dim = src_n.shape
    cfg = config
    # The single-card gate (bcpd.CombinedBCPD._use_culled) at the largest
    # shard's size, so that every rank takes the same branch.
    use_culled = (dev.type == "cuda" and cfg.use_culled_estep
                  and rank is not None and m <= cfg.bcpd_culled_max_points
                  and m * -(-tgt_n.shape[0] // parts)
                  >= cfg.culled_estep_min_pairs)
    perm_s = None
    if use_culled:
        from ..ops.spatial import morton_order_np

        perm_s = morton_order_np(src_n)
        src_n = src_n[perm_s]
        tgt_n = tgt_n[morton_order_np(tgt_n)]
    ys = torch.as_tensor(src_n, device=dev)
    xs_loc, n = shard_points(tgt_n, mesh, axis, dev)
    nl = xs_loc.shape[0]
    if rank is None:
        gmat = mu.inverse_multiquadric_kernel(ys, ys)[None]
    else:
        gmat = tuple(from_first_rank(a, grp)[None]
                     for a in lowrank.lowrank_imq(ys, 1.0, int(rank)))
    # Every rank holds the whole target: the start variance from it, as
    # the single card (and the reference's sharded runner) computes it.
    sigma2_0 = gamma * mu.squared_kernel_sum(
        ys, torch.as_tensor(tgt_n, device=dev))
    local = bcpd_mod._estep_of(xs_loc[None], w / n,
                               max(min(int(cfg.estep_chunk), nl), 1),
                               use_culled=use_culled)

    def estep(t_src_t, row, sigma2):
        if nl:
            mom, minrow, e1 = local(t_src_t, row, sigma2)
        else:  # an empty shard adds zeros and no minimum
            mom = t_src_t.new_zeros((1, dim + 2, m))
            minrow = t_src_t.new_full((1, m), math.inf)
            e1 = t_src_t.new_zeros(1)
        COUNTS["esteps"] += 1
        sums = all_reduce_(torch.cat([mom.reshape(-1), e1.reshape(-1)]),
                           grp)
        return (sums[:-1].reshape(mom.shape),
                all_reduce_min_(minrow.contiguous(), grp), sums[-1:])

    def as_t(x):
        return torch.as_tensor(x, dtype=ys.dtype, device=dev)

    (rot, t, scale, v_t, _), _, _ = bcpd_mod._vi_loop(
        ys[None], xs_loc[None], gmat, as_t(lmd), as_t(k),
        sigma2_0.reshape(1), w=float(w), maxiter=int(maxiter),
        tol=float(tol), estep=estep,
        agree=lambda new: _first_rank_state(new, grp))
    v = v_t[0].T
    if perm_s is not None:  # back to the caller's row order
        v = torch.empty_like(v).index_copy_(
            0, torch.as_tensor(perm_s, device=dev), v)
    cen = torch.as_tensor(centroid, dtype=v.dtype, device=dev)
    return tf.CombinedTransformation(rot[0], scale0 * t[0] + cen, scale[0],
                                     scale0 * v - cen, dim=dim, device=dev)


# --------------------------------------------------------------------------
# GMMTree (tree-descent E-step over a sharded target)
# --------------------------------------------------------------------------

def _require_1d_mesh(mesh, what):
    """Entries with no 2-D path reject a 2-axis mesh instead of sharding
    over its first axis only (reference sharded.py:1088)."""
    if mesh.ndim != 1:
        raise ValueError(
            f"{what} supports 1-axis meshes only (got axes "
            f"{tuple(mesh.mesh_dim_names)}); build one with make_mesh(), or "
            "use registration_cpd_sharded/_filterreg_/_bcpd_ for the "
            "2-D (m, n) mesh paths.")


def registration_gmmtree_sharded(
    source,
    target,
    maxiter: int = 20,
    tol: float = 1.0e-4,
    tree_level: int = 2,
    lambda_c: float = 0.01,
    lambda_s: float = 0.001,
    mesh=None,
    device=None,
    **kwargs: Any,
):
    """Multi-rank GMMTree registration (reference ``sharded.py:1099``),
    same semantics as gmmtree.registration_gmmtree: the EM moves the
    target onto the source's tree and the inverse transform is returned.

    The tree is built once, on the first rank (``GMMTree``, its kernel K9
    on the card where the single-card gate takes it), and every rank
    takes its nodes (``from_first_rank``). The target is sharded over the
    1-D ``mesh``: each rank runs the plain descent (gmmtree's
    ``_estep_t_factory``) over its shard, in the raw frame as the
    reference's sharded runner does, and one all_reduce per iteration
    sums the (T,) and (T, 3) node moments; the twist M-step is replicated
    with the 1e-7 eigenvalue floor. ``kwargs``: GMMTree's
    (``tf_init_params``, ``seed``). Returns an MstepResult.
    """
    from .. import gmmtree as gt_mod
    from ..ops.sym3 import eigh3

    if mesh is None:
        mesh = make_mesh()
    _require_1d_mesh(mesh, "registration_gmmtree_sharded")
    axis = mesh.mesh_dim_names[0]
    grp = axis_group(mesh, axis)[0]
    dev = rank_device(device)
    first = dist.get_rank(group=grp) == 0
    gt = gt_mod.GMMTree(_host_points(source) if first else None,
                        tree_level=tree_level, lambda_c=lambda_c,
                        lambda_s=lambda_s, device=dev, **kwargs)
    if first:
        nodes = gt._nodes
    else:  # the shapes of the first rank's nodes, filled by it
        n_nodes = gt_mod._n_total(int(tree_level))
        dim = gt._tf_result.t.shape[0]
        nodes = tuple(torch.zeros(shape, dtype=config.dtype, device=dev)
                      for shape in ((n_nodes,), (n_nodes, dim),
                                    (n_nodes, dim, dim)))
    pi, mu, cov = _first_rank_state(nodes, grp)
    lmd_nodes, nn_nodes = eigh3(cov)
    # An f32 build can leave slightly indefinite nodes (reference
    # sharded.py:1051-1056).
    lmd_nodes = torch.clamp(lmd_nodes, min=1e-7)
    estep_core = gt_mod._estep_t_factory(pi, mu, cov, int(tree_level),
                                         float(lambda_c))
    xs_t = shard_points(target, mesh, axis, dev)[0].T
    col_mask = xs_t.new_ones((1, xs_t.shape[1]))
    rot, t = gt._tf_result.rot, gt._tf_result.t
    q = torch.tensor(math.inf, dtype=xs_t.dtype, device=dev)
    q_f, q_prev, it = np.float32(np.inf), np.float32(np.inf), 0
    while gt_mod._go(it, int(maxiter), q_f, q_prev, float(tol)):
        m0, m1 = estep_core(rot @ xs_t + t[:, None], col_mask)
        sums = all_reduce_(torch.cat([m0, m1.reshape(-1)]), grp)
        COUNTS["esteps"] += 1
        rot, t, q = gt_mod._mstep_core(sums[:m0.shape[0]],
                                       sums[m0.shape[0]:].reshape(m1.shape),
                                       mu, lmd_nodes, nn_nodes, rot, t)
        q_prev, q_f = q_f, np.float32(float(q))
        it += 1
    inv = tf.RigidTransformation(rot, t, device=dev).inverse()
    return gt_mod.MstepResult(inv, q)


# --------------------------------------------------------------------------
# The L2-distance family (GMMReg / SVR)
# --------------------------------------------------------------------------
#
# The scalable work is the mixture fit of each cloud: the spherical GMM's
# k-means and EM (O(N K)) and the one-class SVM's dual (O(N^2)). Both run
# over the mesh with the points sharded; only (K,)- and (K, D)-sized sums
# and the (N,) dual iterate cross ranks. The BFGS over the mixtures is
# replicated (l2dist_regs' second on-device route).

def _amax(x: torch.Tensor) -> torch.Tensor:
    """The largest entry, -inf for an empty tensor (an empty shard)."""
    return torch.cat([x.reshape(-1), x.new_full((1,), -math.inf)]).amax()


def _fit_gmm_sharded(x, mu, n, *, kmeans_iters, em_iters, grp):
    """Spherical-GMM fit (features._fit_spherical_gmm) of the cloud whose
    shard is ``x`` (Nl, D), from the seed centres ``mu`` (K, D) (reference
    sharded.py:1146): each point's assignment and responsibilities are
    local, the (K,) and (K, D) sums are all_reduced. Returns (means,
    weights), the same on every rank."""
    k, d = mu.shape
    for _ in range(kmeans_iters):
        onehot = torch.nn.functional.one_hot(
            pairwise.sqdist(x, mu).argmin(1), k).to(x.dtype)
        sums = all_reduce_(torch.cat([onehot.sum(0),
                                      (onehot.T @ x).reshape(-1)]), grp)
        mu = sums[k:].reshape(k, d) / torch.clamp(sums[:k], min=1.0)[:, None]
    pi = x.new_full((k,), 1.0 / k)
    mom = all_reduce_(torch.cat([x.sum(0), (x * x).sum(0)]), grp) / n
    var = (mom[d:] - mom[:d] * mom[:d]).mean().expand(k)
    for _ in range(em_iters):
        log_p = (-0.5 * pairwise.sqdist(x, mu) / var
                 - 0.5 * d * torch.log(2.0 * math.pi * var) + torch.log(pi))
        r = torch.exp(log_p - torch.logsumexp(log_p, 1, keepdim=True))
        sums = all_reduce_(torch.cat([r.sum(0), (r.T @ x).reshape(-1)]), grp)
        nk = torch.clamp(sums[:k], min=1e-10)
        mu = sums[k:].reshape(k, d) / nk[:, None]
        var = torch.clamp(all_reduce_((r * pairwise.sqdist(x, mu)).sum(0),
                                      grp) / (d * nk), min=1e-12)
        pi = nk / n
    return mu, pi


def _fit_ocsvm_sharded(x, gamma, nu, n, *, iters, mesh, axis):
    """One-class SVM dual (features._fit_ocsvm_dual) with the kernel rows
    sharded (reference sharded.py:1194): each rank holds K[its rows, :]
    and forms its slice of the projected-gradient product; the (N,)
    iterate is gathered each step. Each projection evaluates the rank's
    2 Nl breakpoints against the whole iterate and brackets the crossing
    with one min all_reduce. Returns alpha (N,) scaled to libsvm's
    convention (sum = nu n), the same on every rank."""
    grp, index, parts = axis_group(mesh, axis)
    start, stop = shard_range(n, parts, index)
    c = 1.0 / (nu * n)
    kmat = torch.exp(-gamma * pairwise.sqdist(
        x, gather_shards(x, n, mesh, axis)))                 # (Nl, N)

    def s_of(v, b):
        return torch.clamp(v - b, min=0.0, max=c).sum(-1)

    def project(v):
        b = torch.cat([v[start:stop], v[start:stop] - c])
        valid = s_of(v[None, :], b[:, None]) >= 1.0
        neg_lo, b_hi = all_reduce_min_(torch.stack([
            -_amax(torch.where(valid, b, -math.inf)),
            -_amax(torch.where(valid, -math.inf, -b))]), grp)
        b_lo = -neg_lo
        s_lo, s_hi = s_of(v, b_lo), s_of(v, b_hi)
        tau = b_lo + (s_lo - 1.0) * (b_hi - b_lo) / torch.clamp(
            s_lo - s_hi, min=1e-30)
        return torch.clamp(v - tau, min=0.0, max=c)

    eta = -1.0 / all_reduce_min_(-_amax(kmat.abs().sum(1)).reshape(1),
                                 grp)[0]
    alpha = project(x.new_full((n,), 1.0 / n))
    for _ in range(iters):
        g = gather_shards(kmat @ alpha, n, mesh, axis)
        alpha = project(alpha - eta * g)
    return alpha * (nu * n)


class _ShardedFeature:
    """A single-device feature generator whose fit runs over the mesh
    (reference sharded.py:1258): every attribute, reads and writes,
    delegates to the wrapped object (the registrations re-estimate kernel
    widths onto their feature generator), and ``fused_fit`` is hidden, so
    the registration takes the route that calls ``compute``."""

    _OWN = ("_base", "_mesh", "_axis", "_device")

    def __init__(self, base, mesh, axis, device):
        for name, value in zip(self._OWN, (base, mesh, axis, device)):
            object.__setattr__(self, name, value)

    def __setattr__(self, name, value):
        if name in self._OWN:
            object.__setattr__(self, name, value)
        else:
            setattr(self._base, name, value)

    def __getattr__(self, name):
        if name == "fused_fit":
            raise AttributeError(name)
        return getattr(self._base, name)


class _ShardedGMM(_ShardedFeature):
    """features.GMM whose fit runs over the mesh; the seed centres drawn
    on the host from ``np.random.default_rng(seed + counter)``, as the
    reference's sharded fit draws them."""

    def compute(self, data):
        pts = _host_points(data)
        b = self._base
        k = min(b._n_gmm_components, pts.shape[0])
        rng = np.random.default_rng(b._seed + b._counter)
        mu0 = torch.as_tensor(pts[rng.choice(pts.shape[0], size=k,
                                             replace=False)],
                              device=self._device)
        x, n = shard_points(pts, self._mesh, self._axis, self._device)
        return _fit_gmm_sharded(x, mu0, n, kmeans_iters=10,
                                em_iters=b._em_iters,
                                grp=axis_group(self._mesh, self._axis)[0])


class _ShardedOneClassSVM(_ShardedFeature):
    """features.OneClassSVM whose dual solve runs over the mesh."""

    def compute(self, data):
        pts = _host_points(data)
        b = self._base
        x, n = shard_points(pts, self._mesh, self._axis, self._device)
        alpha = _fit_ocsvm_sharded(x, float(b._gamma), float(b._nu), n,
                                   iters=300, mesh=self._mesh,
                                   axis=self._axis)
        z = np.power(2.0 * np.pi * b._sigma ** 2, b._dim * 0.5)
        return (torch.as_tensor(pts, device=self._device),
                alpha * float(z) * (alpha > 1e-8))


def _sharded_l2(reg, mesh, axis, dev):
    """An L2DistRegistration with its feature generator's fit over the
    mesh, after its constructor estimated the widths on the original
    object, and its BFGS result the first rank's on every rank."""
    from .. import features as ft_mod

    fg = reg._feature_gen
    if isinstance(fg, ft_mod.GMM):
        reg._feature_gen = _ShardedGMM(fg, mesh, axis, dev)
    elif isinstance(fg, ft_mod.OneClassSVM):
        reg._feature_gen = _ShardedOneClassSVM(fg, mesh, axis, dev)
    else:
        raise ValueError(
            f"no sharded fit for feature type {type(fg).__name__}")
    solve, grp = reg._jax_optimizer, axis_group(mesh, axis)[0]

    def agreed(*args):
        x, fun = solve(*args)
        both = from_first_rank(torch.cat([x, fun.reshape(1)]), grp)
        return both[:-1], both[-1]

    reg._jax_optimizer = agreed
    return reg


def _l2_sharded(kind, source, tf_type_name, mesh, device, kwargs):
    from .. import l2dist_regs as l2

    if mesh is None:
        mesh = make_mesh()
    _require_1d_mesh(mesh, f"registration_{kind}_sharded")
    classes = {"gmmreg": {"rigid": l2.RigidGMMReg,
                          "nonrigid": l2.TPSGMMReg},
               "svr": {"rigid": l2.RigidSVR, "nonrigid": l2.TPSSVR}}[kind]
    if tf_type_name not in classes:
        raise ValueError("Unknown transform type %s" % tf_type_name)
    dev = rank_device(device)
    reg = classes[tf_type_name](_host_points(source), device=dev, **kwargs)
    return _sharded_l2(reg, mesh, mesh.mesh_dim_names[0], dev)


def registration_gmmreg_sharded(source, target, tf_type_name: str = "rigid",
                                mesh=None, device=None, **kwargs: Any):
    """Multi-rank GMMReg (reference ``sharded.py:1336``): the GMM fits of
    both clouds run over the 1-D ``mesh`` (``_fit_gmm_sharded``), the
    BFGS over the mixtures is replicated. ``kwargs`` as
    l2dist_regs.RigidGMMReg / TPSGMMReg take them. Returns the
    transformation."""
    reg = _l2_sharded("gmmreg", source, tf_type_name, mesh, device, kwargs)
    return reg.registration(_host_points(target))


def registration_svr_sharded(
    source,
    target,
    tf_type_name: str = "rigid",
    maxiter: int = 1,
    tol: float = 1.0e-3,
    opt_maxiter: int = 50,
    opt_tol: float = 1.0e-3,
    mesh=None,
    device=None,
    **kwargs: Any,
):
    """Multi-rank SVR (reference ``sharded.py:1357``): the one-class-SVM
    duals run over the 1-D ``mesh`` with the kernel rows sharded
    (``_fit_ocsvm_sharded``), the BFGS over the mixtures is replicated.
    ``kwargs`` as l2dist_regs.RigidSVR / TPSSVR take them. Returns the
    transformation."""
    reg = _l2_sharded("svr", source, tf_type_name, mesh, device, kwargs)
    return reg.registration(_host_points(target), maxiter, tol, opt_maxiter,
                            opt_tol)
