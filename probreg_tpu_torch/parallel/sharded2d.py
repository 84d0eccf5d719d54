"""CPD on a 2-D ``(m, n)`` mesh: source AND target sharded.

Counterpart of the CPD part of probreg_tpu/parallel/sharded2d.py. Rank
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

Not ported yet: the low-rank nonrigid kind (ROADMAP.md, Queue 1 item 4),
and the 2-D FilterReg and BCPD runners (item 12), which raise
``NotImplementedError``.
"""

from __future__ import annotations

import math
from typing import Any, Optional

import torch

from .. import cpd as cpd_mod
from ..config import config
from ..ops import estep_cuda as ec
from ..ops.estep import outlier_constant
from .mesh import (COUNTS, M_AXIS, N_AXIS, all_reduce_, make_mesh_2d,
                   rank_device, shard_points)
from .sharded import (_F32_EPS, _host_points, _pack_init, _refuse, _result,
                      _unpack_init)


def _check_mesh_2d(mesh, who: str):
    if mesh.ndim != 2:
        raise ValueError(f"{who} needs a 2-D mesh; got axes "
                         f"{mesh.mesh_dim_names}")
    if tuple(mesh.mesh_dim_names) != (M_AXIS, N_AXIS):
        raise ValueError(f"2-D mesh axes must be named ({M_AXIS!r}, "
                         f"{N_AXIS!r}); got {mesh.mesh_dim_names}")


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


def _run_em_2d(ys_loc, xs_loc, init, sigma2_init=None, *, kind, w, maxiter,
               tol, update_scale, m, n, mesh, use_culled=False,
               culled_tile=512):
    """Whole EM on the 2-D mesh, rigid or affine (reference
    ``sharded2d.py:100``). ``ys_loc`` (Ml, D) / ``xs_loc`` (Nl, D): this
    rank's source and target shards; m, n the whole clouds' counts;
    ``init`` the packed (D*D + D + 1,) start; ``sigma2_init`` > 0 replaces
    the squared_kernel_sum start. ``use_culled``: the culled E-step with
    K11, one den reduction per E-step (clouds sorted in Morton order by the
    caller). Returns (lin, t,
    scale, sigma2, q)."""
    m_grp, n_grp = mesh.get_group(M_AXIS), mesh.get_group(N_AXIS)
    dev = ys_loc.device
    ys_t, xs_t = ys_loc.T, xs_loc.T
    dim, ml = ys_t.shape
    nl = xs_t.shape[1]
    if sigma2_init is not None and sigma2_init > 0.0:
        sigma2 = torch.clamp(torch.as_tensor(sigma2_init, dtype=torch.float32,
                                             device=dev), min=_F32_EPS)
    else:  # squared_kernel_sum: source sums over m, target sums over n
        sy = all_reduce_(torch.cat([(ys_t * ys_t).sum().reshape(1),
                                    ys_t.sum(1)]), m_grp)
        sx = all_reduce_(torch.cat([(xs_t * xs_t).sum().reshape(1),
                                    xs_t.sum(1)]), n_grp)
        sigma2 = (n * sy[0] + m * sx[0] - 2.0 * sy[1:] @ sx[1:]) \
            / (m * dim * n)
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
    """CPD registration on a 2-D ``(m, n)`` mesh, rigid or affine
    (reference ``sharded2d.py:332``). Same semantics as
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
    del beta, lmd
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
    if tf_type_name == "nonrigid":
        _refuse("the low-rank nonrigid CPD on the 2-D mesh (rank=)", 4)
    if tf_type_name not in ("rigid", "affine"):
        raise ValueError("unknown tf_type_name %s" % tf_type_name)
    del rank
    dev = rank_device(device)
    src, tgt = _host_points(source), _host_points(target)
    m, dim = src.shape
    n = tgt.shape[0]
    if use_culled is None:
        use_culled = (dev.type == "cuda" and config.use_culled_estep
                      and m * n >= config.culled_estep_min_pairs)
    if use_culled:
        from ..ops.spatial import morton_order_np

        src = src[morton_order_np(src)]
        tgt = tgt[morton_order_np(tgt)]
    ys_loc, _ = shard_points(src, mesh, M_AXIS, dev)
    xs_loc, _ = shard_points(tgt, mesh, N_AXIS, dev)
    lin, t, scale, sigma2, q = _run_em_2d(
        ys_loc, xs_loc, _pack_init(tf_init_params, tf_type_name, dim),
        None if sigma2_init is None else float(sigma2_init),
        kind=tf_type_name, w=float(w), maxiter=int(maxiter), tol=float(tol),
        update_scale=bool(update_scale), m=m, n=n, mesh=mesh,
        use_culled=bool(use_culled), culled_tile=culled_tile)
    return _result(tf_type_name, lin, t, scale, sigma2, q, dev)


def registration_filterreg_2d(*args, **kwargs):
    """Not ported yet (ROADMAP.md, Queue 1 item 12)."""
    _refuse("registration_filterreg_2d")


def registration_bcpd_2d(*args, **kwargs):
    """Not ported yet (ROADMAP.md, Queue 1 item 12)."""
    _refuse("registration_bcpd_2d")
