"""CPD, FilterReg and BCPD on a 2-D ``(m, n)`` mesh: source AND target
sharded.

Counterpart of probreg_tpu/parallel/sharded2d.py. Rank
(i, j) holds source shard i (M / Pm rows) and target shard j (N / Pn
columns) and computes its block of the posterior once:

  den_j  = all_reduce over m of the block's column sums  (the normalizer
                                                          spans every
                                                          source shard)
  p1, px = all_reduce over n of the block's row moments  (stay m-sharded)
  pt1    = target shard j's, the same on every source shard

The rigid and affine M-steps need only sums over source rows, so each rank
reduces its rows and one all_reduce over m gives every rank the same
D x D system to solve. No rank holds an M-row or N-row array.

The culled E-step (``use_culled``) is the tile-culled E-step on the
shards, three launches and no stash: pass A stops at the raw column sums
of the whole target shard (kernel K11, ``stash_den_raw``), they are
all-reduced over m once, ``stash_finish`` forms inv_den, pt1 and xx, and
K3's pass B forms the Gaussian again. One den all_reduce per E-step,
where the reference psums each stripe's sums inside its stripe scan (a
column sums the same operands). Under NCCL it is ordered on the stream;
under gloo it blocks the host.

The low-rank nonrigid kind (``"nonrigid"`` with ``rank=``) shards the
Nystrom factor U over m with the source: the Woodbury core's moments
(U^T diag(p1) U, rhs^T U and n_p) are all-reduced over m in one call and
the K x K system solved on every rank, so no rank holds an M-row array
until the result. Culled, both clouds are Morton-sorted once (U is built
from the sorted source) and U's rows are put back in the caller's order
for the returned transformation. The dense nonrigid model raises
``ValueError`` here, as in the reference: its M x M solve does not
distribute.

FilterReg (``registration_filterreg_2d``) needs no normalizer across
source rows: the block's moments are all_reduced over n and the M-step's
row sums over m. BCPD (``registration_bcpd_2d``, ``rank=`` only) has
CPD's column normalizer: the block's raw column sums, formed in column
chunks, are all_reduced over m once per E-step, its moments over n, and
the Woodbury K x K core and the normal-equation strips over m, with U
sharded over m with the source.
"""

from __future__ import annotations

import math
from typing import Any, Optional

import numpy as np
import torch

from .. import cpd as cpd_mod
from ..config import config
from ..models import transformation as tf
from ..ops import estep_cuda as ec
from ..ops import lowrank
from ..ops.estep import outlier_constant
from .mesh import (COUNTS, M_AXIS, N_AXIS, all_reduce_, all_reduce_min_,
                   from_first_rank, gather_shards, make_mesh_2d, rank_device,
                   shard_points)
from .sharded import (_F32_EPS, _amax, _host_points, _pack_init, _result,
                      _unpack_init)


def _check_mesh_2d(mesh, who: str):
    if mesh.ndim != 2:
        raise ValueError(f"{who} needs a 2-D mesh; got axes "
                         f"{mesh.mesh_dim_names}")
    if tuple(mesh.mesh_dim_names) != (M_AXIS, N_AXIS):
        raise ValueError(f"2-D mesh axes must be named ({M_AXIS!r}, "
                         f"{N_AXIS!r}); got {mesh.mesh_dim_names}")


def _kernel_sum_2d(ys_t, xs_t, m, n, m_grp, n_grp):
    """squared_kernel_sum of the whole clouds from a (D, Ml) source shard
    and a (D, Nl) target shard: source sums over m, target sums over n."""
    dim = ys_t.shape[0]
    sy = all_reduce_(torch.cat([(ys_t * ys_t).sum().reshape(1),
                                ys_t.sum(1)]), m_grp)
    sx = all_reduce_(torch.cat([(xs_t * xs_t).sum().reshape(1),
                                xs_t.sum(1)]), n_grp)
    return (n * sy[0] + m * sx[0] - 2.0 * sy[1:] @ sx[1:]) / (m * dim * n)


def _mstep_2d(kind, ys_t, p1, px_t, xx, update_scale, m_grp):
    """Rigid or affine M-step of a source shard (reference sharded2d.py
    mstep_rigid / mstep_affine): every sum over source rows is this
    shard's, all-reduced over m. Returns (lin, t, scale, sigma2, q)."""
    dim = ys_t.shape[0]
    first = all_reduce_(torch.cat([p1.sum().reshape(1), px_t.sum(1),
                                   ys_t @ p1]), m_grp)
    n_p = first[0]
    mu_x, mu_y = first[1:1 + dim] / n_p, first[1 + dim:] / n_p
    src_hat = ys_t - mu_y[:, None]
    parts = [(px_t @ src_hat.T).reshape(-1), src_hat @ p1,
             (p1 * (src_hat * src_hat).sum(0)).sum().reshape(1)]
    if kind == "affine":
        parts.append(((src_hat * p1[None, :]) @ src_hat.T).reshape(-1))
    second = all_reduce_(torch.cat(parts), m_grp)
    d2 = dim * dim
    a = second[:d2].reshape(dim, dim) - torch.outer(mu_x,
                                                    second[d2:d2 + dim])
    tr_xp1x = xx - n_p * (mu_x * mu_x).sum()
    if kind == "rigid":
        rot = cpd_mod._svd_rotation(a)
        tr_atr = torch.trace(a.T @ rot)
        scale, sigma2, q = cpd_mod._rigid_sigma2_q(
            tr_xp1x, tr_atr, second[d2 + dim], n_p, dim, update_scale)
        return rot, mu_x - scale * rot @ mu_y, scale, sigma2, q
    yp1y = second[d2 + dim + 1:].reshape(dim, dim)
    b = torch.linalg.solve(yp1y.T, a.T).T
    sigma2, q = cpd_mod._affine_sigma2_q(tr_xp1x, torch.trace(a @ b.T), n_p,
                                         dim)
    return b, mu_x - b @ mu_y, torch.ones_like(q), sigma2, q


def _run_lowrank_2d(ys_t, estep, sigma2, u_loc, lam, lmd, *, maxiter, tol,
                    m_grp, n_grp):
    """The low-rank nonrigid loop of a source shard (reference
    ``sharded2d.py:245``): ``ys_t`` (D, Ml), ``u_loc`` (Ml, K) its rows of
    U, ``estep`` the mesh E-step. Per iteration two all_reduces over m: the
    Woodbury core's moments, then the two traces of sigma2; then rank
    (0, 0)'s zc and sigma2 on every rank (``from_first_rank`` over m, then
    over n). q is sigma2. Returns (zc_t (D, K), sigma2, q)."""
    dim = ys_t.shape[0]
    k = lam.shape[0]
    eye_k = torch.eye(k, dtype=ys_t.dtype, device=ys_t.device)
    zc_t = ys_t.new_zeros((dim, k))
    q, q_prev, i = math.inf, math.inf, 0
    while True:
        done, q_prev_next = cpd_mod._converged(i, q, q_prev, maxiter, tol)
        if done:
            break
        px_t, p1, xx = estep(ys_t + zc_t @ u_loc.T, sigma2)
        rhs_t = px_t - ys_t * p1[None, :]
        core = all_reduce_(torch.cat([
            p1.sum().reshape(1), ((u_loc * p1[:, None]).T @ u_loc).reshape(-1),
            (rhs_t @ u_loc).reshape(-1)]), m_grp)
        n_p, udu = core[0], core[1:1 + k * k].reshape(k, k)
        ru = core[1 + k * k:].reshape(dim, k)
        mk = lmd * sigma2 * eye_k + udu * lam[None, :]
        zc_t = torch.linalg.solve(mk, ru.T).T * lam[None, :]
        t_t = ys_t + zc_t @ u_loc.T
        trs = all_reduce_(torch.stack([(px_t * t_t).sum(),
                                       (p1 * (t_t * t_t).sum(0)).sum()]),
                          m_grp)
        sigma2 = torch.clamp((xx - 2.0 * trs[0] + trs[1]) / (n_p * dim),
                             min=_F32_EPS)
        state = torch.cat([zc_t.reshape(-1), sigma2.reshape(1)])
        for grp in (m_grp, n_grp):
            state = from_first_rank(state, grp)
        zc_t, sigma2 = state[:-1].reshape(dim, k), state[-1]
        q, q_prev, i = sigma2, q_prev_next, i + 1
    return zc_t, sigma2, torch.as_tensor(q, dtype=ys_t.dtype,
                                         device=ys_t.device)


def _run_em_2d(ys_loc, xs_loc, init, sigma2_init=None, *, kind, w, maxiter,
               tol, update_scale, m, n, mesh, use_culled=False,
               culled_tile=512, u_loc=None, lam=None, lmd=None):
    """Whole EM on the 2-D mesh, rigid, affine or "nonrigid_lowrank"
    (reference ``sharded2d.py:100``). ``ys_loc`` (Ml, D) / ``xs_loc`` (Nl,
    D): this rank's source and target shards; m, n the whole clouds'
    counts; ``init`` the packed (D*D + D + 1,) start (rigid, affine);
    ``sigma2_init`` > 0 replaces the squared_kernel_sum start;
    ``u_loc`` (Ml, K), ``lam`` and ``lmd`` the low-rank kind's shard of U,
    eigenvalues and regularizer. ``use_culled``: the culled E-step with
    K11, one den reduction per E-step (clouds sorted in Morton order by the
    caller). Returns (lin, t, scale, sigma2, q); for the low-rank kind
    (zc_t (D, K), None, None, sigma2, q)."""
    m_grp, n_grp = mesh.get_group(M_AXIS), mesh.get_group(N_AXIS)
    dev = ys_loc.device
    ys_t, xs_t = ys_loc.T, xs_loc.T
    dim, ml = ys_t.shape
    nl = xs_t.shape[1]
    if sigma2_init is not None and sigma2_init > 0.0:
        sigma2 = torch.clamp(torch.as_tensor(sigma2_init, dtype=torch.float32,
                                             device=dev), min=_F32_EPS)
    else:
        sigma2 = _kernel_sum_2d(ys_t, xs_t, m, n, m_grp, n_grp)
    q = 1.0 + n * dim * 0.5 * torch.log(sigma2)
    x2 = (xs_t * xs_t).sum(0, keepdim=True)
    xs_ext = torch.cat([xs_t, torch.ones_like(x2)])
    tm = max(8, min(culled_tile, ec._round_up(ml, 8)))
    tn = min(culled_tile, ec._round_up(max(nl, 1), 128))

    def reduce_den(den_raw):
        COUNTS["den_all_reduce"] += 1
        all_reduce_(den_raw, m_grp)

    def estep(t_src, sigma2):
        """(px_t (D, Ml), p1 (Ml,), xx): the source shard's moments over
        every target shard, and the whole xx."""
        if nl == 0:  # every rank of this target shard: zeros, no den
            pxp, xx = t_src.new_zeros((dim + 1, ml)), t_src.new_zeros(())
        elif use_culled:
            ys = t_src.T.contiguous()
            scal = ec._scalars(sigma2, w, m, n, dim, dev)
            mask = ec._active_mask(*ec._tile_bounds(ys, tm),
                                   *ec._tile_bounds(xs_loc, tn), scal[0])
            _, p1, px, xx = ec.stash_estep(ys, xs_loc, scal, mask, tm, tn,
                                           reduce_den=reduce_den)
            pxp = torch.cat([px.T, p1[None]])
        else:
            c = outlier_constant(sigma2, w, m, n, dim)
            y2 = (t_src * t_src).sum(0)[:, None]
            g = torch.exp(-torch.clamp(y2 + x2 - 2.0 * (t_src.T @ xs_t),
                                       min=0.0) / (2.0 * sigma2))
            den_raw = g.sum(0, keepdim=True)
            reduce_den(den_raw)
            den = torch.where(den_raw == 0.0, _F32_EPS, den_raw) + c
            pt1 = den_raw / den
            pxp, xx = xs_ext @ (g / den).T, (pt1 * x2).sum()
        sums = all_reduce_(torch.cat([pxp.reshape(-1), xx.reshape(1)]), n_grp)
        COUNTS["esteps"] += 1
        pxp = sums[:-1].reshape(dim + 1, ml)
        return pxp[:dim], pxp[dim], sums[-1]

    if kind == "nonrigid_lowrank":
        zc_t, sigma2, q = _run_lowrank_2d(ys_t, estep, sigma2, u_loc, lam,
                                          lmd, maxiter=maxiter, tol=tol,
                                          m_grp=m_grp, n_grp=n_grp)
        return zc_t, None, None, sigma2, q
    lin, t, scale = _unpack_init(init, dim, dev)
    q_prev, i = math.inf, 0
    while True:
        done, q_prev_next = cpd_mod._converged(i, q, q_prev, maxiter, tol)
        if done:
            break
        px_t, p1, xx = estep(scale * lin @ ys_t + t[:, None], sigma2)
        lin, t, scale, sigma2, q = _mstep_2d(kind, ys_t, p1, px_t, xx,
                                             update_scale, m_grp)
        q_prev, i = q_prev_next, i + 1
    return lin, t, scale, sigma2, q


def registration_cpd_2d(
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
    rank: Optional[int] = None,
    device=None,
    **kwargs: Any,
):
    """CPD registration on a 2-D ``(m, n)`` mesh, rigid, affine or
    low-rank nonrigid (``"nonrigid"`` with ``rank=``, ``beta``, ``lmd``;
    reference ``sharded2d.py:332``). Same semantics as
    ``cpd.registration_cpd``; every rank calls it with the same full clouds
    and gets the same result.

    Keyword Args:
        use_culled: the culled E-step with K11 (default: the tensors are on
            CUDA, ``config.use_culled_estep`` and M * N >=
            ``config.culled_estep_min_pairs``); both clouds are sorted in
            Morton order once, on the host.
        culled_tile: its tile size, source and target (default 512).
        tf_init_params, sigma2_init: warm start, as registration_cpd_sharded.
        device: this rank's device (default ``cuda:{LOCAL_RANK}``).
    Unknown keyword arguments raise ``TypeError``.
    """
    if mesh is None:
        mesh = make_mesh_2d()
    _check_mesh_2d(mesh, "registration_cpd_2d")
    use_culled = kwargs.pop("use_culled", None)
    culled_tile = int(kwargs.pop("culled_tile", 512))
    tf_init_params = dict(kwargs.pop("tf_init_params", None) or {})
    sigma2_init = kwargs.pop("sigma2_init", None)
    if kwargs:
        raise TypeError(f"registration_cpd_2d: unknown kwargs "
                        f"{sorted(kwargs)}")
    if tf_type_name not in ("rigid", "affine", "nonrigid"):
        raise ValueError("unknown tf_type_name %s" % tf_type_name)
    nonrigid = tf_type_name == "nonrigid"
    if nonrigid and tf_init_params:
        raise ValueError("tf_init_params is rigid/affine-only on the 2-D "
                         "mesh (the low-rank field has no packed init)")
    if nonrigid and rank is None:
        raise ValueError(
            "2-D-mesh nonrigid requires rank= (low-rank Nystrom): the dense "
            "M x M Gram solve does not distribute over the m-axis")
    dev = rank_device(device)
    src, tgt = _host_points(source), _host_points(target)
    m, dim = src.shape
    n = tgt.shape[0]
    if use_culled is None:
        use_culled = (dev.type == "cuda" and config.use_culled_estep
                      and m * n >= config.culled_estep_min_pairs)
    perm_s = None
    if use_culled:
        from ..ops.spatial import morton_order_np

        perm_s = morton_order_np(src)
        src = src[perm_s]
        tgt = tgt[morton_order_np(tgt)]
    ys_loc, _ = shard_points(src, mesh, M_AXIS, dev)
    xs_loc, _ = shard_points(tgt, mesh, N_AXIS, dev)
    lowrank_kw = {}
    if nonrigid:
        # Nystrom factors of the whole (sorted) source as rank (0, 0)
        # builds them, on every rank; then this rank's rows of U, as its
        # source shard.
        u, lam = lowrank.lowrank_rbf(torch.as_tensor(src, device=dev),
                                     float(beta), int(rank))
        for grp in (mesh.get_group(M_AXIS), mesh.get_group(N_AXIS)):
            u, lam = from_first_rank(u, grp), from_first_rank(lam, grp)
        lowrank_kw = dict(u_loc=shard_points(u, mesh, M_AXIS, dev)[0],
                          lam=lam, lmd=float(lmd))
    kind = "nonrigid_lowrank" if nonrigid else tf_type_name
    lin, t, scale, sigma2, q = _run_em_2d(
        ys_loc, xs_loc, _pack_init(tf_init_params, tf_type_name, dim),
        None if sigma2_init is None else float(sigma2_init),
        kind=kind, w=float(w), maxiter=int(maxiter), tol=float(tol),
        update_scale=bool(update_scale), m=m, n=n, mesh=mesh,
        use_culled=bool(use_culled), culled_tile=culled_tile, **lowrank_kw)
    if not nonrigid:
        return _result(tf_type_name, lin, t, scale, sigma2, q, dev)
    if perm_s is not None:
        # Back to the caller's row order: the displacement U zc is
        # positional, and U[inverse permutation] zc restores it exactly.
        u = u[torch.as_tensor(np.argsort(perm_s), device=dev)]
    return cpd_mod.MstepResult(
        tf.LowRankNonRigidTransformation(lin.T, u, lam, device=dev), sigma2,
        q)


def registration_filterreg_2d(
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
    """Rigid FilterReg on a 2-D ``(m, n)`` mesh, both clouds sharded
    (reference ``sharded2d.py:686``). FilterReg's moments are per source
    row sums over the target, with no normalizer across source rows: rank
    (i, j) forms the moments of source shard i against target shard j
    (the Gauss transform, K6 from ``config.culled_estep_min_pairs``), one
    all_reduce over n completes them, and the M-step's sums over source
    rows (weighted Kabsch, the point-to-plane normal equations, q and
    sigma2) are all_reduced over m. No rank holds an M-row or N-row
    array. Same semantics as registration_filterreg_sharded; returns an
    MstepResult."""
    from .. import filterreg as frg
    from .sharded import (_frg_clouds, _point_spacing, _rigid_init,
                          _run_filterreg_mesh)

    if mesh is None:
        mesh = make_mesh_2d()
    _check_mesh_2d(mesh, "registration_filterreg_2d")
    m_grp, n_grp = mesh.get_group(M_AXIS), mesh.get_group(N_AXIS)
    dev = rank_device(device)
    src, tgt, nrm = _frg_clouds(source, target, target_normals,
                                objective_type)
    m, dim = src.shape
    ys_loc, _ = shard_points(src, mesh, M_AXIS, dev)
    xs_loc, n = shard_points(tgt, mesh, N_AXIS, dev)
    nrm_loc = None if nrm is None \
        else shard_points(nrm, mesh, N_AXIS, dev)[0]
    if sigma2 is not None:
        sigma2_0 = torch.as_tensor(sigma2, dtype=ys_loc.dtype, device=dev)
    elif objective_type == "pt2pl":
        sigma2_0 = torch.clamp(_point_spacing(xs_loc, n, mesh, N_AXIS),
                               min=min_sigma2 * 0.01)
    else:
        sigma2_0 = torch.clamp(_kernel_sum_2d(ys_loc.T, xs_loc.T, m, n,
                                              m_grp, n_grp), min=min_sigma2)
    rot, t, sigma2_out, q = _run_filterreg_mesh(
        ys_loc, xs_loc, nrm_loc, sigma2_0,
        *_rigid_init(tf_init_params, dim, dev),
        objective_type=objective_type, update_sigma2=bool(update_sigma2),
        w=float(w), maxiter=int(maxiter), tol=float(tol),
        min_sigma2=float(min_sigma2), sigma2_decay=float(sigma2_decay), m=m,
        n=n, n_grp=n_grp, reduce=lambda x: all_reduce_(x, m_grp))
    return frg.MstepResult(tf.RigidTransformation(rot, t, device=dev),
                           sigma2_out, q)


# --------------------------------------------------------------------------
# BCPD (low-rank) on the 2-D mesh
# --------------------------------------------------------------------------

def _bcpd_estep_2d(t_src_t, row, sigma2, xs_t, w_over_n, chunk, m_grp,
                   n_grp):
    """The VI E-step of a (D, Ml) source shard against a (D, Nl) target
    shard (reference sharded2d.py:787): a target column's normalizer spans
    every source shard, so the block's raw column sums are formed in
    column chunks of ``chunk`` and all_reduced over m once, then the
    moments of the normalized block are formed again chunk by chunk:
    (Ml, chunk) temporaries. Returns (moments (D + 2, Ml) of [x; 1; |x|^2]
    summed over n, e1 = sum p d2 summed over n, per-row min d2 over the
    whole target)."""
    dim, ml = t_src_t.shape
    nl = xs_t.shape[1]
    y2 = (t_src_t * t_src_t).sum(0)[:, None]
    weight = (row / (2.0 * math.pi * sigma2) ** (dim * 0.5))[:, None]

    def block(c0):
        # In place where it can be: the (Ml, chunk) temporaries are the
        # E-step's memory.
        xb = xs_t[:, c0:c0 + chunk]
        d2 = torch.addmm(y2 + (xb * xb).sum(0, keepdim=True), t_src_t.T, xb,
                         alpha=-2.0).clamp_(min=0.0)
        return xb, d2, torch.exp(d2 * (-0.5 / sigma2)).mul_(weight)

    starts = range(0, nl, chunk)
    den_raw = t_src_t.new_zeros(nl)
    dmin = t_src_t.new_full((ml,), math.inf)
    for c0 in starts:
        _, d2, pmat = block(c0)
        den_raw[c0:c0 + chunk] = pmat.sum(0)
        dmin = torch.minimum(dmin, d2.amin(1))
    COUNTS["den_all_reduce"] += 1
    den = w_over_n + all_reduce_(den_raw, m_grp)
    den = torch.where(den == 0.0, _F32_EPS, den)
    mom = t_src_t.new_zeros((dim + 2, ml))
    e1 = t_src_t.new_zeros(())
    for c0 in starts:
        xb, d2, pmat = block(c0)
        pmat.div_(den[None, c0:c0 + chunk])
        x2b = (xb * xb).sum(0, keepdim=True)
        mom = mom + torch.cat([xb, torch.ones_like(x2b), x2b]) @ pmat.T
        e1 = e1 + torch.dot(pmat.reshape(-1), d2.reshape(-1))
    sums = all_reduce_(torch.cat([mom.reshape(-1), e1.reshape(1)]), n_grp)
    COUNTS["esteps"] += 1
    return (sums[:-1].reshape(dim + 2, ml), sums[-1],
            all_reduce_min_(dmin, n_grp))


def _run_bcpd_2d(ys_t, xs_t, u_loc, lam, lmd, k, sigma2_0, init, v0_t, *,
                 w, maxiter, tol, m, n, chunk, m_grp, n_grp):
    """The low-rank BCPD VI on the 2-D mesh (reference sharded2d.py:760):
    ``ys_t`` (D, Ml) / ``xs_t`` (D, Nl) this rank's shards, ``u_loc``
    (Ml, K) its rows of the Nystrom factor U, ``init`` (rot, t, scale),
    ``v0_t`` (D, Ml) the starting displacement of its rows. The E-step is
    :func:`_bcpd_estep_2d`; the M-step is bcpd._vi_mstep_t's Woodbury
    algebra with its sums over source rows all_reduced over m (three
    calls: the K x K core's moments and the normal-equation strip with
    the E-step's totals, the weighted means, the cross-covariances and
    the sigma2 terms), the K x K core taken from rank (0, 0)
    (``from_first_rank``, its solve may differ in the last bits between
    ranks). The K x K solve does not check for a singular matrix, as the
    single card's (``lowrank.solve``): once sigma2 nears the f32 floor
    the core can be singular to f32 and the loop keeps its best state.
    Returns the kept state (rot, t, scale, v_t, sigma2) as
    registration_bcpd keeps it: the best visited by the NN-RMSE or the
    last iterate rescored, whichever is better."""
    from ..bcpd import _digamma_alpha, _svd_rotation

    dim, ml = ys_t.shape
    dt, dev = ys_t.dtype, ys_t.device
    krank = lam.shape[0]
    eye_k = torch.eye(krank, dtype=dt, device=dev)
    eye_d = torch.eye(dim, dtype=dt, device=dev)
    w_over_n = w / n

    def estep(t_src_t, row, sigma2, w_over_n=w_over_n):
        """(moments, e1, this shard's sum of the rows' NN distances): a
        NaN row (a state past a singular solve) makes the NN-RMSE NaN,
        which ends the loop and is never kept, as in the reference."""
        mom, e1, dmin = _bcpd_estep_2d(t_src_t, row, sigma2, xs_t, w_over_n,
                                       chunk, m_grp, n_grp)
        return mom, e1, torch.sqrt(dmin).sum()

    def weights(scale, sigma2, sigma_diag, alpha):
        """The rows' mixing weights and the outlier term, both divided by
        the largest row weight over every source shard (one min
        all_reduce over m). The posterior is a ratio of the two, so this
        is the reference's E-step in exact arithmetic; in f32 it keeps a
        warm start whose sigma2 is small against its scale (every row's
        exp(-s^2 d sdiag / (2 sigma2)) under f32's range at sdiag = 1)
        from a posterior of 0 / 0."""
        logrow = math.log(1.0 - w) + torch.log(alpha) \
            - (scale ** 2) / (2.0 * sigma2) * sigma_diag * dim
        top = -all_reduce_min_(-_amax(logrow).reshape(1), m_grp)[0]
        return (torch.exp(logrow - top),
                w_over_n * torch.exp(-top) if w else 0.0)

    def moved(rot, t, scale, v_t):
        return scale * (rot @ (ys_t + v_t)) + t[:, None]

    rot, t, scale = init
    v_t = v0_t
    sigma_diag = torch.ones(ml, dtype=dt, device=dev)
    alpha = torch.full((ml,), 1.0 / m, dtype=dt, device=dev)
    sigma2 = torch.as_tensor(sigma2_0, dtype=dt, device=dev)
    best = (rot, t, scale, v_t, sigma2)
    best_rmse = rmse = rmse_prev = math.inf
    i = 0
    while i < maxiter and (i < 2 or abs(rmse - rmse_prev) >= tol):
        t_src_t = moved(rot, t, scale, v_t)
        row, w_shifted = weights(scale, sigma2, sigma_diag, alpha)
        mom, e1, root_sum = estep(t_src_t, row, sigma2, w_shifted)
        px_t, nu = mom[:dim], mom[dim]
        x_hat_t = px_t / torch.clamp(nu, min=_F32_EPS)[None, :]
        s2s2 = scale ** 2 / (sigma2 ** 2)
        residual_t = rot.T @ ((x_hat_t - t[:, None]) / scale) - ys_t
        first = all_reduce_(torch.cat([
            nu.sum().reshape(1), e1.reshape(1), root_sum.reshape(1),
            ((u_loc * nu[:, None]).T @ u_loc).reshape(-1),
            ((residual_t * nu[None, :]) @ u_loc).reshape(-1)]), m_grp)
        n_p = torch.clamp(first[0], min=_F32_EPS)
        e1 = first[1]
        rmse_t = float(first[2]) / m
        cmat = first[3:3 + krank * krank].reshape(krank, krank)
        strip = first[3 + krank * krank:].reshape(dim, krank)
        mk = lmd * eye_k + s2s2 * lam[:, None] * cmat
        s_core = torch.diag(lam) - s2s2 * lowrank.solve(
            mk, lam[:, None] * cmat * lam[None, :])
        s_core = 0.5 * (s_core + s_core.T)
        for grp in (m_grp, n_grp):
            s_core = from_first_rank(s_core, grp)
        sigma_diag_new = ((u_loc @ s_core) * u_loc).sum(1) / lmd
        v_new_t = (s2s2 / lmd) * ((strip @ s_core) @ u_loc.T)
        u_hat_t = ys_t + v_new_t
        alpha_new = _digamma_alpha(k, nu, k * m, n_p)
        second = all_reduce_(torch.cat([
            x_hat_t @ nu, (nu * sigma_diag_new).sum().reshape(1),
            u_hat_t @ nu]), m_grp)
        x_m = second[:dim] / n_p
        sigma2_m = second[dim] / n_p
        u_m = second[dim + 1:] / n_p
        u_hm = u_hat_t - u_m[:, None]
        delta_t = scale * (rot @ (v_new_t - v_t))
        r_t = px_t - nu[None, :] * t_src_t
        third = all_reduce_(torch.cat([
            (((x_hat_t - x_m[:, None]) * nu[None, :]) @ u_hm.T).reshape(-1),
            ((u_hm * nu[None, :]) @ u_hm.T).reshape(-1),
            (r_t * delta_t).sum().reshape(1),
            (nu * (delta_t * delta_t).sum(0)).sum().reshape(1)]), m_grp)
        d2_ = dim * dim
        s_xu = third[:d2_].reshape(dim, dim) / n_p
        s_uu = third[d2_:2 * d2_].reshape(dim, dim) / n_p + sigma2_m * eye_d
        rot_new = _svd_rotation(s_xu)
        scale_new = torch.trace(rot_new @ s_xu) / torch.trace(s_uu)
        t_new = x_m - scale_new * (rot_new @ u_m)
        numer = e1 - 2.0 * third[2 * d2_] + third[2 * d2_ + 1]
        sigma2_new = torch.clamp(numer / (n_p * dim)
                                 + scale_new ** 2 * sigma2_m, min=_F32_EPS)
        # rmse_t scores the incoming state; keep the best visited.
        if rmse_t < best_rmse:
            best, best_rmse = (rot, t, scale, v_t, sigma2), rmse_t
        rot, t, scale, v_t = rot_new, t_new, scale_new, v_new_t
        sigma_diag, alpha, sigma2 = sigma_diag_new, alpha_new, sigma2_new
        rmse, rmse_prev, i = rmse_t, rmse, i + 1
    # Score the last iterate once, at the start temperature with unit row
    # weights, and keep the better of (last, best visited).
    _, _, root_sum = estep(moved(rot, t, scale, v_t),
                           torch.ones(ml, dtype=dt, device=dev),
                           torch.as_tensor(sigma2_0, dtype=dt, device=dev))
    rmse_last = float(all_reduce_(root_sum.reshape(1), m_grp)) / m
    if rmse_last <= best_rmse:
        return rot, t, scale, v_t, sigma2
    return best


def registration_bcpd_2d(
    source,
    target,
    w: float = 0.0,
    maxiter: int = 50,
    tol: float = 0.001,
    lmd: float = 2.0,
    k: float = 1.0e20,
    gamma: float = 1.0,
    rank: Optional[int] = 64,
    normalize: bool = True,
    mesh=None,
    tf_init_params: Optional[dict] = None,
    v_init=None,
    sigma2_init: Optional[float] = None,
    return_sigma2: bool = False,
    device=None,
):
    """BCPD on a 2-D ``(m, n)`` mesh, both clouds sharded, low-rank Sigma
    (reference ``sharded2d.py:960``). Same semantics (the default scale
    normalization, ``rank=`` Nystrom factors) as registration_bcpd with
    ``rank=``; per-rank memory O(M/Pm * (chunk + K)), the E-step's target
    columns taken ``config.estep_chunk`` at a time. U is sharded over m
    with the source; the Woodbury K x K core and the normal-equation
    strips are all_reduced over m, the moments over n.

    ``tf_init_params`` ({'rot', 't', 'scale'}), ``v_init`` ((M, D) field)
    and ``sigma2_init`` warm-start the VI in raw coordinates (the
    pyramid's carries); ``return_sigma2`` also returns the kept state's
    sigma2 in raw units. Returns a CombinedTransformation (and sigma2).
    """
    if mesh is None:
        mesh = make_mesh_2d()
    _check_mesh_2d(mesh, "registration_bcpd_2d")
    if rank is None:
        raise ValueError("registration_bcpd_2d requires rank= (the dense "
                         "M x M Sigma solve does not distribute)")
    from .sharded import _bcpd_normalized

    m_grp, n_grp = mesh.get_group(M_AXIS), mesh.get_group(N_AXIS)
    dev = rank_device(device)
    src_n, tgt_n, centroid, scale0 = _bcpd_normalized(source, target,
                                                      normalize)
    m, dim = src_n.shape
    n = tgt_n.shape[0]
    # The Nystrom factors of the whole source as rank (0, 0) builds them,
    # on every rank; then this rank's rows of U, as its source shard.
    u, lam = lowrank.lowrank_imq(torch.as_tensor(src_n, device=dev), 1.0,
                                 int(rank))
    for grp in (m_grp, n_grp):
        u, lam = from_first_rank(u, grp), from_first_rank(lam, grp)
    if normalize:  # the squared kernel sum of the normalized clouds is 1
        sigma2_0 = float(gamma)
    else:
        from ..utils import math_utils as mu

        sigma2_0 = float(gamma) * mu.squared_kernel_sum_np(src_n, tgt_n)
    if sigma2_init is not None:
        sigma2_0 = max(float(sigma2_init) / scale0 ** 2, _F32_EPS)
    # Raw -> normalized warm starts: t_n = (t - c) / s, v_n = (v + c) / s
    # (a raw pose without a field is v_raw = 0).
    p = dict(tf_init_params or {})
    warm = bool(p) or v_init is not None
    t0 = (np.asarray(p.get("t", np.zeros(dim)), np.float64) - centroid) \
        / scale0 if warm else np.zeros(dim)
    v_n = ((np.zeros((m, dim)) if v_init is None
            else np.asarray(v_init, np.float64)) + centroid) / scale0 \
        if warm else np.zeros((m, dim))
    init = (torch.as_tensor(np.asarray(p.get("rot", np.eye(dim)),
                                       np.float32), device=dev),
            torch.as_tensor(t0, dtype=torch.float32, device=dev),
            torch.as_tensor(float(p.get("scale", 1.0)), dtype=torch.float32,
                            device=dev))
    ys_loc, _ = shard_points(src_n, mesh, M_AXIS, dev)
    xs_loc, _ = shard_points(tgt_n, mesh, N_AXIS, dev)
    v0_loc, _ = shard_points(v_n.astype(np.float32), mesh, M_AXIS, dev)
    rot, t, scale, v_t, sigma2 = _run_bcpd_2d(
        ys_loc.T, xs_loc.T, shard_points(u, mesh, M_AXIS, dev)[0], lam,
        float(lmd), float(k), sigma2_0, init, v0_loc.T.contiguous(),
        w=float(w), maxiter=int(maxiter), tol=float(tol), m=m, n=n,
        chunk=max(int(config.estep_chunk), 1), m_grp=m_grp, n_grp=n_grp)
    # Every rank gets the whole field: its rows from each source shard.
    v = gather_shards(v_t.T.contiguous(), m, mesh, M_AXIS)
    cen = torch.as_tensor(centroid, dtype=v.dtype, device=dev)
    out = tf.CombinedTransformation(rot, scale0 * t + cen, scale,
                                    scale0 * v - cen, dim=dim, device=dev)
    if return_sigma2:
        return out, float(sigma2) * scale0 ** 2
    return out
