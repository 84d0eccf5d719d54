"""Whole point-to-point ICP in one kernel launch, beside its plain version.

Counterpart of the ICP part of probreg_tpu/ops/em_pallas.py
(``_icp_kernel``): ``run_icp_fused`` and ``run_icp_fused_batch`` run every
ICP iteration of small 3-D pairs, the stop test included, inside one launch
of ``csrc/icp.cu`` for the whole batch (the reference launches once per
pair). A pair runs on one block of 1,024 threads or, when the batch leaves
SMs idle, on a thread-block cluster of 2-8 blocks, and a ragged batch of
more blocks than SMs runs largest first (``em_cuda.launch_plan``, K1's
rule). Neither changes a bit of any pair's result.

Each iteration matches every source point to its nearest target (d2 from
differences, ties to the first index, as the reference's twin
``icp._run_icp`` and ``argmin`` do; the reference kernel instead averages
exactly tied targets), solves the rotation on the matched pairs by Horn's
method with scale 1 and t = mu_x - R mu_y, and takes
rmse = sqrt(sum dmin / n_p) at the incoming transform. It stops when
``it == maxiter``, or from the second iteration on when
|rmse_prev - rmse| < tol (reference em_pallas.py:645-649). The pair is
centred on the shared centroid of its valid points inside the kernel, as
``run_icp_fused`` does; the initial rot0 / t0 convert in and the result
converts back.

Masked points are moved to the front by the wrapper and the kernel gets the
counts (ops/em_cuda.py), so a masked pair is bit for bit the registration
of the pair without its padding.

CUDA tensors run the kernel; CPU tensors run ``run_icp_fused_plain``, the
same arithmetic in tensors with the stop test on the host. Nothing else
picks between them. Every launch adds one to ``LAUNCHES["icp"]``.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from . import _build, em_cuda
from .em_cuda import _horn_rotation
from .estep_cuda import _check, _stream
from .pairwise import sqdist_diff

# Shared memory a block may use on the card (227 KB) less what the kernel
# holds statically, rounded up to 4 KB: 3,488 B at its largest, one block of
# 1,024 threads (ptxas -v; two reduction buffers of 32 warps x 13 floats,
# the 13 sums and the ICP state, 3,484 B, and alignment).
_SMEM_POINT_BYTES = 227 * 1024 - 4096

LAUNCHES = {"icp": 0}


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def fused_dims_ok(m: int, n: int) -> bool:
    """True iff a pair of ``m`` source and ``n`` target points may run as one
    launch. Two gates, both required:

    * the reference's (em_pallas.fused_dims_ok): the padded pair
      ceil8(m) * ceil128(n) <= 2^20 and each padded side <= 2^14, kept so
      both packages take the kernel at the same sizes;
    * this kernel's shared memory: the centred source and target stay in
      shared memory for the whole run, 16 B per point, 16 (m + n) bytes of
      the 227 KB a block may use (less 4 KB of static state): m + n <=
      14,272.
    """
    mp = -(-m // 8) * 8
    np_ = -(-n // 128) * 128
    ref_ok = mp * np_ <= 1 << 20 and mp <= 1 << 14 and np_ <= 1 << 14
    return ref_ok and 16 * (m + n) <= _SMEM_POINT_BYTES


_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float


def _lib() -> ctypes.CDLL:
    lib = _build.load("icp")
    if not getattr(lib, "_probreg_typed", False):
        lib.probreg_icp.argtypes = [_P, _I, _P, _I, _P, _P, _P, _I, _I, _I,
                                    _F, _P, _P]
        lib.probreg_icp.restype = ctypes.c_int
        lib._probreg_typed = True
    return lib


def compact_batch(sources, targets, smasks=None, tmasks=None):
    """em_cuda.compact_batch under this kernel's size gate."""
    return em_cuda.compact_batch(sources, targets, smasks, tmasks,
                                 fused_dims_ok)


def _init_rows(batch, rot0, t0, like):
    """(B, 12) f32 rows [rot0 (9), t0 (3)], or None for the identity."""
    if rot0 is None and t0 is None:
        return None
    rot0 = torch.eye(3) if rot0 is None else torch.as_tensor(rot0)
    t0 = torch.zeros(3) if t0 is None else torch.as_tensor(t0)
    rot0 = rot0.to(like).reshape(-1, 9).expand(batch, 9)
    t0 = t0.to(like).reshape(-1, 3).expand(batch, 3)
    return torch.cat([rot0, t0], dim=1).contiguous()


def run_icp_fused_batch(sources, targets, smasks=None, tmasks=None,
                        rot0=None, t0=None, *, maxiter=30, tol=1e-6):
    """(B, M, 3) x (B, N, 3) [+ (B, M) / (B, N) 0/1 masks] -> stacked
    (rot (B, 3, 3), t (B, 3), rmse (B,), n_iter (B,) int) in ONE kernel
    launch for the whole batch. ``rot0`` / ``t0``: the starting transform,
    (3, 3) / (3,) for every pair or (B, 3, 3) / (B, 3); identity by
    default."""
    sources, targets, counts = compact_batch(sources, targets, smasks, tmasks)
    init = _init_rows(sources.shape[0], rot0, t0, sources)
    run = _icp_cuda if sources.is_cuda else run_icp_fused_plain
    out = run(sources, targets, counts, init, maxiter=int(maxiter),
              tol=float(tol))
    return (out[:, :9].reshape(-1, 3, 3), out[:, 9:12], out[:, 12],
            out[:, 13].to(torch.int32))


def run_icp_fused(source, target, rot0=None, t0=None, smask=None,
                  tmask=None, *, maxiter=30, tol=1e-6):
    """One pair as one launch: (rot (3, 3), t (3,), rmse, n_iter)."""
    rot, t, rmse, it = run_icp_fused_batch(
        source[None], target[None],
        None if smask is None else smask[None],
        None if tmask is None else tmask[None],
        rot0, t0, maxiter=maxiter, tol=tol)
    return rot[0], t[0], rmse[0], it[0]


def _icp_cuda(sources, targets, counts, init, *, maxiter, tol,
              _cluster=None, _ordered=True):
    """One launch of K7 by ``em_cuda.launch_plan``. For checks and timings,
    ``_cluster`` forces the blocks per pair (1, 2, 4 or 8) and
    ``_ordered=False`` the arrival order."""
    batch, m_cap, n_cap = sources.shape[0], sources.shape[1], targets.shape[1]
    g, order = em_cuda.launch_plan(batch, counts,
                                   em_cuda.sm_count(sources.device),
                                   cluster=_cluster, ordered=_ordered)
    out = sources.new_empty((batch, 16))
    status = _lib().probreg_icp(
        sources.data_ptr(), m_cap, targets.data_ptr(), n_cap,
        None if counts is None else counts.data_ptr(),
        None if order is None else order.data_ptr(),
        None if init is None else init.data_ptr(), batch, g, maxiter, tol,
        out.data_ptr(), _stream(sources))
    _check(status, "icp")
    LAUNCHES["icp"] += 1
    return out


# --------------------------------------------------------------------------
# Plain version
# --------------------------------------------------------------------------

def _go(it: int, maxiter: int, rmse_prev, rmse, tol) -> bool:
    """The kernel's stop test, in f32: go on while it < maxiter and (it < 2
    or |rmse_prev - rmse| >= tol)."""
    if it >= maxiter:
        return False
    return it < 2 or bool(np.abs(np.float32(rmse_prev) - np.float32(rmse))
                          >= np.float32(tol))


def _plain_pair(ys, xs, init, *, maxiter, tol):
    """One pair of valid points: the (16,) output row of the kernel."""
    m, n = ys.shape[0], xs.shape[0]
    cen = (ys.sum(0) + xs.sum(0)) / (m + n)
    ys, xs = ys - cen, xs - cen
    if init is None:
        rot = torch.eye(3, dtype=ys.dtype, device=ys.device)
        t = ys.new_zeros(3)
    else:
        rot = init[:9].reshape(3, 3)
        t = init[9:] + rot @ cen - cen
    n_p = float(max(m, 1))
    mu_y = ys.sum(0) / n_p
    yh = ys - mu_y
    sy = yh.sum(0)
    rmse = rmse_prev = np.float32(3.4e38)
    it = 0
    while _go(it, maxiter, rmse_prev, rmse, tol):
        ts = ys @ rot.T + t
        d2 = sqdist_diff(ts, xs)
        idx = torch.argmin(d2, dim=1)      # the first index on ties
        dmin = d2.gather(1, idx[:, None])[:, 0]
        xm = xs[idx]
        mu_x = xm.sum(0) / n_p
        a = (xm.T @ yh).double() - torch.outer(mu_x.double(), sy.double())
        rot_d = _horn_rotation(a)
        rot = rot_d.float()
        t = (mu_x.double() - rot_d @ mu_y.double()).float()
        rmse_prev = rmse
        rmse = np.float32(float(torch.sqrt(dmin.sum() / n_p)))
        it += 1
    t = t + cen - rot @ cen
    return torch.cat([rot.reshape(-1), t, t.new_tensor([float(rmse),
                                                        float(it), 0.0,
                                                        0.0])])


def run_icp_fused_plain(sources, targets, counts=None, init=None, *,
                        maxiter, tol):
    """Plain version of the whole-ICP kernel: (B, 16) rows [rot (9), t (3),
    rmse, n_iter, 0, 0]. ``counts`` (B, 2) int32 gives each pair's valid
    points, which lie at the front (None: all valid); ``init`` (B, 12) the
    starting [rot, t] rows (None: identity)."""
    rows = []
    for b in range(sources.shape[0]):
        m, n = ((sources.shape[1], targets.shape[1]) if counts is None
                else (int(counts[b, 0]), int(counts[b, 1])))
        rows.append(_plain_pair(sources[b, :m], targets[b, :n],
                                None if init is None else init[b],
                                maxiter=maxiter, tol=tol))
    return torch.stack(rows)
