"""Sharded CPD on a 1-D mesh: the target sharded, the source replicated.

Counterpart of the CPD part of probreg_tpu/parallel/sharded.py. Each rank
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

Not ported yet (ROADMAP.md, Queue 1 item 12): the sharded FilterReg, BCPD,
GMMTree, GMMReg and SVR runners raise ``NotImplementedError``.
"""

from __future__ import annotations

import math
from typing import Any

import numpy as np
import torch

from .. import cpd as cpd_mod
from ..config import config
from ..models import transformation as tf
from ..ops import estep_cuda as ec
from ..ops import lowrank, pairwise
from ..ops.estep import EstepMoments, outlier_constant
from ..ops.pairwise import sqdist
from ..utils import interop
from .mesh import (AXIS, COUNTS, all_reduce_, axis_group, from_first_rank,
                   make_mesh, rank_device, shard_points, shard_range)

_F32_EPS = float(torch.finfo(torch.float32).eps)
_NOT_PORTED = ("{} is not ported to probreg_tpu_torch yet (ROADMAP.md, "
               "Queue 1 item {}); use probreg_tpu.parallel")


def _refuse(what: str, item: int = 12):
    raise NotImplementedError(_NOT_PORTED.format(what, item))


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


def _sigma2_start(ys_t, xs_t, sigma2_init, n, grp):
    """The starting variance: ``sigma2_init`` (floored at f32 eps), else
    squared_kernel_sum of the replicated (D, M) source and the target from
    its shards' sums (one all_reduce); no centring, as the reference's
    sharded code."""
    if sigma2_init is not None:
        return torch.clamp(torch.as_tensor(sigma2_init, dtype=torch.float32,
                                           device=ys_t.device), min=_F32_EPS)
    dim, m = ys_t.shape
    st = all_reduce_(torch.cat([(xs_t * xs_t).sum().reshape(1),
                                xs_t.sum(1)]), grp)
    sx = ys_t.sum(1)
    return (n * (ys_t * ys_t).sum() + m * st[0] - 2.0 * sx @ st[1:]) \
        / (m * dim * n)


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


def registration_filterreg_sharded(*args, **kwargs):
    """Not ported yet (ROADMAP.md, Queue 1 item 12)."""
    _refuse("registration_filterreg_sharded")


def registration_bcpd_sharded(*args, **kwargs):
    """Not ported yet (ROADMAP.md, Queue 1 item 12)."""
    _refuse("registration_bcpd_sharded")


def registration_gmmtree_sharded(*args, **kwargs):
    """Not ported yet (ROADMAP.md, Queue 1 item 12)."""
    _refuse("registration_gmmtree_sharded")


def registration_gmmreg_sharded(*args, **kwargs):
    """Not ported yet (ROADMAP.md, Queue 1 item 12.4; the single-card
    L2-distance family it shards is `l2dist_regs`)."""
    _refuse("registration_gmmreg_sharded")


def registration_svr_sharded(*args, **kwargs):
    """Not ported yet (ROADMAP.md, Queue 1 item 12.4; the single-card
    L2-distance family it shards is `l2dist_regs`)."""
    _refuse("registration_svr_sharded")
