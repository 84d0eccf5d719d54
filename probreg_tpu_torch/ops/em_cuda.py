"""Whole-EM rigid / affine CPD in one kernel launch, beside its plain version.

Counterpart of the CPD part of probreg_tpu/ops/em_pallas.py
(``_em_kernel``): ``run_em_rigid_fused``, ``run_em_affine_fused`` and
``run_em_cpd_fused_batch`` run every EM iteration of a small 3-D pair, the
convergence test included, inside one launch of ``csrc/em.cu`` for the
whole batch, no host read before the result. A pair runs on one block of
1,024 threads or, when the batch leaves SMs idle, on a thread-block
cluster of ``cluster_size`` blocks (the bunny on 8 SMs, 64 pairs on 2
each); a batch of more pairs than SMs runs in ``work_order``, the largest
first. Neither changes a bit of any pair's result.

Unlike the reference's fused kernel, and like its twin ``cpd._run_em_t``,
the clouds are centred on their shared centroid (inside the kernel) and d2
is taken from differences, so far-from-origin clouds lose no digits.

Masked points (``smask`` / ``tmask`` 0, the padding of a ragged batch) carry
exactly zero mass: the wrapper moves each pair's valid points to the front
and hands the kernel the counts, so a block never sees a masked point, and
sigma2_0, q0 and the outlier ratio use the true counts. A masked pair is
therefore the same registration as the pair without its padding.

A pair may start from its own pose: ``inits`` (B, 14) rows [lin0 (9), t0
(3), scale0, sigma2_0] in the raw frame (``init_rows``), converted to the
centred frame inside as ``cpd._run_em_t`` converts its start; sigma2_0 <= 0
keeps the closed-form start variance of the un-moved clouds. So S starts of
B pairs are one launch of B S pairs (the multistart searches). No rows, or
identity rows with sigma2_0 = 0, give the bits of the identity start.

CUDA tensors run the kernel; CPU tensors run ``run_em_cpd_fused_plain``, the
same arithmetic in tensors with the loop test on the host. Nothing else picks
between them. Every launch adds one to ``LAUNCHES["em_rigid"]`` or
``LAUNCHES["em_affine"]``.
"""

from __future__ import annotations

import ctypes
import math

import torch

from . import _build
from .estep_cuda import _EPS, _check, _stream

# Shared memory a block may use on the card (227 KB) less what the kernel
# holds statically (block sums and the EM state, under 4 KB).
_SMEM_POINT_BYTES = 227 * 1024 - 4096

LAUNCHES = {"em_rigid": 0, "em_affine": 0}


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def fused_dims_ok(m: int, n: int) -> bool:
    """True iff one thread block can hold a pair of ``m`` source and ``n``
    target points: the kernel keeps the centred source, the transformed
    source (16 B each per point), the centred target (16 B) and 1/den (4 B)
    in shared memory for the whole run, 32 m + 20 n bytes of the 227 KB a
    block may use (less 4 KB of static state). That allows up to 7,136
    source points beside a handful of targets, or 11,417 targets. Callers
    gate on this and on ``config.fused_em_max_pairs``; above either the
    dense loop ``cpd._run_em_t`` runs."""
    return 32 * m + 20 * n <= _SMEM_POINT_BYTES


_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float


def _lib() -> ctypes.CDLL:
    lib = _build.load("em")
    if not getattr(lib, "_probreg_typed", False):
        lib.probreg_em_cpd.argtypes = [_P, _I, _P, _I, _P, _P, _I, _I, _F,
                                       _I, _F, _I, _I, _P, _P, _P]
        lib.probreg_em_cpd.restype = ctypes.c_int
        lib._probreg_typed = True
    return lib


def _check_batch(sources, targets, dims_ok=None):
    """The checked, contiguous (B, M, 3) and (B, N, 3) clouds of a whole-EM
    kernel; ``dims_ok`` is the kernel's shared-memory gate (default K1's)."""
    if sources.dim() != 3 or targets.dim() != 3 \
            or sources.shape[0] != targets.shape[0]:
        raise ValueError("expected (B, M, 3) and (B, N, 3) point tensors, got "
                         f"{tuple(sources.shape)} and {tuple(targets.shape)}")
    if sources.shape[2] != 3 or targets.shape[2] != 3:
        raise ValueError("the whole-EM kernel is 3-D only")
    if sources.shape[1] == 0 or targets.shape[1] == 0:
        raise ValueError("empty point cloud")
    if sources.device != targets.device:
        raise ValueError(f"sources on {sources.device}, targets on "
                         f"{targets.device}")
    if sources.dtype != torch.float32 or targets.dtype != torch.float32:
        raise ValueError("the whole-EM kernel takes float32 points")
    if not (dims_ok or fused_dims_ok)(sources.shape[1], targets.shape[1]):
        raise ValueError(
            f"a pair of {sources.shape[1]} x {targets.shape[1]} points does "
            "not fit one block's shared memory (see fused_dims_ok)")
    return sources.contiguous(), targets.contiguous()


def _compact(points: torch.Tensor, mask: torch.Tensor):
    """Move each cloud's valid points (mask > 0) to the front, in order.
    Returns the (B, M, 3) reordered clouds and the (B,) int32 counts."""
    valid = mask > 0
    order = torch.argsort((~valid).to(torch.int8), dim=1, stable=True)
    points = torch.gather(points, 1, order[:, :, None].expand_as(points))
    return points.contiguous(), valid.sum(1).to(torch.int32)


def compact_batch(sources, targets, smasks=None, tmasks=None, dims_ok=None):
    """What the kernel and its plain version take: the checked (B, M, 3) and
    (B, N, 3) clouds with each pair's valid points first, and the (B, 2)
    int32 counts of valid points (None without masks: all are valid).
    ``dims_ok`` is the kernel's size gate (default K1's)."""
    if (smasks is None) != (tmasks is None):
        raise ValueError("give both masks or neither")
    sources, targets = _check_batch(sources, targets, dims_ok)
    if smasks is None:
        return sources, targets, None
    sources, m_cnt = _compact(sources, smasks)
    targets, n_cnt = _compact(targets, tmasks)
    return sources, targets, torch.stack([m_cnt, n_cnt], dim=1).contiguous()


def init_rows(lin0, t0, scale0=1.0, sigma2_0=0.0):
    """(B, 14) f32 start rows [lin0 (9), t0 (3), scale0, sigma2_0] from
    (B, 3, 3) / (B, 3) tensors and scalars or (B,) tensors."""
    batch = lin0.shape[0]
    col = [torch.as_tensor(v, dtype=torch.float32, device=lin0.device)
           .reshape(-1, 1).expand(batch, 1) for v in (scale0, sigma2_0)]
    return torch.cat([lin0.reshape(batch, 9).float(),
                      t0.reshape(batch, 3).float(), *col], 1).contiguous()


def run_em_cpd_fused_batch(sources, targets, smasks=None, tmasks=None, *,
                           kind="rigid", w=0.0, maxiter=50, tol=1e-3,
                           update_scale=True, inits=None):
    """(B, M, 3) x (B, N, 3) [+ (B, M) / (B, N) 0/1 masks] -> stacked
    (lin (B, 3, 3), t (B, 3), sigma2 (B,), q (B,), n_iter (B,)) in ONE
    kernel launch for the whole batch. ``lin`` is scale * R for ``kind``
    "rigid" (scale 1 when ``update_scale`` is False) and B for "affine".
    ``inits``: optional (B, 14) start rows (``init_rows``)."""
    if kind not in ("rigid", "affine"):
        raise ValueError(f"unknown kind {kind!r}")
    sources, targets, counts = compact_batch(sources, targets, smasks, tmasks)
    if inits is not None:
        if tuple(inits.shape) != (sources.shape[0], 14):
            raise ValueError(f"inits {tuple(inits.shape)}: expected "
                             f"({sources.shape[0]}, 14)")
        inits = inits.to(sources).contiguous()
    args = dict(affine=kind == "affine", w=float(w), maxiter=int(maxiter),
                tol=float(tol), update_scale=bool(update_scale))
    run = _em_cuda if sources.is_cuda else run_em_cpd_fused_plain
    out = run(sources, targets, counts, inits, **args)
    return (out[:, :9].reshape(-1, 3, 3), out[:, 9:12], out[:, 12],
            out[:, 13], out[:, 14])


def cluster_size(batch: int, sms: int) -> int:
    """Blocks per pair of a K1, K5 or K7 launch (a thread-block cluster of
    that many blocks of 1,024 / G threads, one block an SM): the largest G
    of 8, 4 and 2 whose clusters for the whole batch fit the card's ``sms``
    SMs; 1 for a batch of more than sms / 2 pairs."""
    for g in (8, 4, 2):
        if batch * g <= sms:
            return g
    return 1


def work_order(counts: torch.Tensor) -> torch.Tensor:
    """(B,) int32 order of the blocks of K1, K5 or K7 from the (B, 2)
    counts: the pairs by m n, largest first, ties by index. Block b
    registers pair order[b] and writes its row, so the results keep the
    caller's order."""
    key = counts[:, 0].long() * counts[:, 1].long()
    return torch.sort(key, descending=True, stable=True).indices.to(
        torch.int32)


_sm_cache = {}


def sm_count(device) -> int:
    """Streaming multiprocessors of ``device`` (queried once)."""
    index = torch.device(device).index
    index = torch.cuda.current_device() if index is None else index
    if index not in _sm_cache:
        _sm_cache[index] = torch.cuda.get_device_properties(
            index).multi_processor_count
    return _sm_cache[index]


def launch_plan(batch: int, counts, sms: int, *, cluster=None,
                ordered=True):
    """(g, order) of a launch of a whole-loop kernel (K1, K5, K7) for
    ``batch`` pairs with (B, 2) ``counts`` (None: every pair full) on a
    card of ``sms`` SMs: g blocks per pair (``cluster_size``, or
    ``cluster`` when given) and, when the batch is ragged and its blocks
    outnumber the SMs, the ``work_order`` (else None: arrival order, as
    ``ordered=False`` forces)."""
    g = cluster or cluster_size(batch, sms)
    order = (work_order(counts) if ordered and counts is not None
             and batch * g > sms else None)
    return g, order


def _em_cuda(sources, targets, counts, inits=None, *, affine, w, maxiter,
             tol, update_scale, _cluster=None, _ordered=True):
    """One launch of K1 by ``launch_plan``. For checks and timings,
    ``_cluster`` forces the blocks per pair (1, 2, 4 or 8) and
    ``_ordered=False`` the arrival order."""
    batch, m_cap, n_cap = sources.shape[0], sources.shape[1], targets.shape[1]
    g, order = launch_plan(batch, counts, sm_count(sources.device),
                           cluster=_cluster, ordered=_ordered)
    out = sources.new_empty((batch, 16))
    status = _lib().probreg_em_cpd(
        sources.data_ptr(), m_cap, targets.data_ptr(), n_cap,
        None if counts is None else counts.data_ptr(),
        None if order is None else order.data_ptr(), batch, g, w, maxiter,
        tol, int(update_scale), int(affine),
        None if inits is None else inits.data_ptr(), out.data_ptr(),
        _stream(sources))
    _check(status, "em_cpd")
    LAUNCHES["em_affine" if affine else "em_rigid"] += 1
    return out


def _run_em_cpd_fused(source, target, smask=None, tmask=None, w=0.0,
                      maxiter=50, tol=1e-3, update_scale=True, kind="rigid"):
    """One pair as one launch: (lin (3, 3), t (3,), sigma2, q, n_iter)."""
    lin, t, sigma2, q, it = run_em_cpd_fused_batch(
        source[None], target[None],
        None if smask is None else smask[None],
        None if tmask is None else tmask[None],
        kind=kind, w=w, maxiter=maxiter, tol=tol, update_scale=update_scale)
    return lin[0], t[0], sigma2[0], q[0], it[0]


def unpack_rigid(lin: torch.Tensor):
    """(rot, scale) from lin = scale * R, for (..., 3, 3) stacks."""
    scale = torch.sqrt(torch.clamp((lin * lin).sum((-2, -1)) / 3.0,
                                   min=1e-30))
    return lin / scale[..., None, None], scale


def run_em_rigid_fused(source, target, w=0.0, maxiter=50, tol=1e-3,
                       update_scale=True):
    """Rigid CPD registration as one launch: (rot, t, scale, sigma2, q)."""
    lin, t, sigma2, q, _ = _run_em_cpd_fused(
        source, target, w=w, maxiter=maxiter, tol=tol,
        update_scale=update_scale, kind="rigid")
    rot, scale = unpack_rigid(lin)
    return rot, t, scale, sigma2, q


def run_em_affine_fused(source, target, w=0.0, maxiter=50, tol=1e-3):
    """Affine CPD registration as one launch: (b, t, sigma2, q)."""
    b, t, sigma2, q, _ = _run_em_cpd_fused(
        source, target, w=w, maxiter=maxiter, tol=tol, update_scale=False,
        kind="affine")
    return b, t, sigma2, q


# --------------------------------------------------------------------------
# Plain version
# --------------------------------------------------------------------------

def _horn_rotation(a: torch.Tensor) -> torch.Tensor:
    """The proper rotation maximizing tr(a^T R), by Horn's quaternion
    method: the dominant eigenvector of the 4 x 4 matrix N(S), S = a^T."""
    (sxx, syx, szx), (sxy, syy, szy), (sxz, syz, szz) = a.unbind(0)
    k4 = torch.stack([
        torch.stack([sxx + syy + szz, syz - szy, szx - sxz, sxy - syx]),
        torch.stack([syz - szy, sxx - syy - szz, sxy + syx, szx + sxz]),
        torch.stack([szx - sxz, sxy + syx, -sxx + syy - szz, syz + szy]),
        torch.stack([sxy - syx, szx + sxz, syz + szy, -sxx - syy + szz])])
    qw, qx, qy, qz = torch.linalg.eigh(k4)[1][:, -1].unbind(0)
    return torch.stack([
        torch.stack([qw * qw + qx * qx - qy * qy - qz * qz,
                     2.0 * (qx * qy - qw * qz), 2.0 * (qx * qz + qw * qy)]),
        torch.stack([2.0 * (qx * qy + qw * qz),
                     qw * qw - qx * qx + qy * qy - qz * qz,
                     2.0 * (qy * qz - qw * qx)]),
        torch.stack([2.0 * (qx * qz - qw * qy), 2.0 * (qy * qz + qw * qx),
                     qw * qw - qx * qx - qy * qy + qz * qz])])


def _plain_mstep(a, yp1y, mu_x, mu_y, n_p, xx, update_scale, affine):
    """M-step from the f32 sums, solved in float64 like the kernel:
    (lin, t, sigma2, q) as float32 tensors."""
    a, yp1y, mu_x, mu_y, n_p, xx = (v.double() for v in
                                    (a, yp1y, mu_x, mu_y, n_p, xx))
    tr_xp1x = xx - n_p * (mu_x * mu_x).sum()
    if affine:
        lin = a @ torch.linalg.inv(yp1y)
        resid = qnum = tr_xp1x - (a * lin).sum()
    else:
        rot = _horn_rotation(a)
        tr_atr = (a * rot).sum()
        tr_yp1y = torch.trace(yp1y)
        scale = tr_atr / tr_yp1y if update_scale else torch.ones_like(tr_atr)
        lin = scale * rot
        resid = (tr_xp1x - scale * tr_atr if update_scale
                 else tr_xp1x - 2.0 * scale * tr_atr + tr_yp1y)
        qnum = tr_xp1x - 2.0 * scale * tr_atr + scale * scale * tr_yp1y
    sigma2 = torch.clamp(resid / (n_p * 3.0), min=_EPS)
    q = qnum / (2.0 * sigma2) + 3.0 * n_p * 0.5 * torch.log(sigma2)
    t = mu_x - lin @ mu_y
    return lin.float(), t.float(), sigma2.float(), q.float()


def _plain_pair(ys, xs, init=None, *, affine, w, maxiter, tol,
                update_scale):
    """One pair of valid points from the identity or the (14,) start row
    ``init``: the (16,) output row of the kernel."""
    m, n = ys.shape[0], xs.shape[0]
    cen = (ys.sum(0) + xs.sum(0)) / (m + n)
    ys, xs = ys - cen, xs - cen
    x2 = (xs * xs).sum(1)
    sigma2 = (n * (ys * ys).sum() + m * x2.sum()
              - 2.0 * ys.sum(0) @ xs.sum(0)) / (m * 3.0 * n)
    if init is None:
        lin = torch.eye(3, dtype=ys.dtype, device=ys.device)
        t = ys.new_zeros(3)
    else:  # raw frame -> centred frame, as the kernel converts it
        lin = init[12] * init[:9].reshape(3, 3)
        t = init[9:12] + lin @ cen - cen
        if float(init[13]) > 0.0:
            sigma2 = init[13]
    q = 1.0 + n * 1.5 * torch.log(sigma2)
    wratio = w / (1.0 - w) * m / n if w > 0.0 else 0.0
    q_prev, it = math.inf, 0
    while it < maxiter:
        qv = float(q)  # the loop test on the host: one read per iteration
        if it > 0 and not abs(qv - q_prev) >= tol:
            break
        q_prev = qv
        ts = ys @ lin.T + t
        d2 = sum((ts[:, d, None] - xs[None, :, d]) ** 2 for d in range(3))
        g = torch.exp(-d2 * (0.5 / sigma2))
        den_raw = g.sum(0)
        c = wratio * (2.0 * math.pi * sigma2) ** 1.5
        inv_den = 1.0 / (torch.where(den_raw == 0.0, _EPS, den_raw) + c)
        xx = (den_raw * inv_den * x2).sum()
        p = g * inv_den[None, :]
        p1, px = p.sum(1), p @ xs
        n_p = p1.sum()
        mu_x, mu_y = px.sum(0) / n_p, (p1[:, None] * ys).sum(0) / n_p
        yh = ys - mu_y
        a = px.T @ yh - torch.outer(mu_x, p1 @ yh)
        yp1y = (yh * p1[:, None]).T @ yh
        lin, t, sigma2, q = _plain_mstep(a, yp1y, mu_x, mu_y, n_p, xx,
                                         update_scale, affine)
        it += 1
    t = t + cen - lin @ cen
    return torch.cat([lin.reshape(-1), t, sigma2.reshape(1), q.reshape(1),
                      t.new_tensor([float(it), 0.0])])


def run_em_cpd_fused_plain(sources, targets, counts=None, inits=None, *,
                           affine, w, maxiter, tol, update_scale):
    """Plain version of the whole-EM kernel: (B, 16) rows [lin (9), t (3),
    sigma2, q, n_iter, 0]. ``counts`` (B, 2) int32 gives each pair's valid
    points, which lie at the front; None means all. ``inits``: optional
    (B, 14) start rows."""
    rows = []
    for b in range(sources.shape[0]):
        m, n = ((sources.shape[1], targets.shape[1]) if counts is None
                else (int(counts[b, 0]), int(counts[b, 1])))
        rows.append(_plain_pair(sources[b, :m], targets[b, :n],
                                None if inits is None else inits[b],
                                affine=affine, w=w, maxiter=maxiter, tol=tol,
                                update_scale=update_scale))
    return torch.stack(rows)
