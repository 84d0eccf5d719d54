"""Point-to-point ICP (counterpart of probreg_tpu/icp.py).

* correspondences: brute-force nearest neighbour, chunked on both axes
  (``_nearest_t``), d2 in the reference's expanded form on the centred
  clouds, ties to the first index;
* update: weighted Kabsch (``ops/rigid_solvers.weighted_kabsch``) with an
  optional trimmed quantile for outlier rejection;
* loop: ``_run_icp``, one host read of the rmse per iteration; small 3-D
  pairs on a CUDA device run the whole loop as one launch of the whole-ICP
  kernel (``ops/icp_cuda.py``), and a batch of them as one launch too.
"""

from __future__ import annotations

from collections import namedtuple
from typing import Any, Callable, List, Optional

import torch

from . import config as _config
from .models import transformation as tf
from .ops import icp_cuda
from .ops.rigid_solvers import weighted_kabsch
from .utils import interop

ICPResult = namedtuple("ICPResult", ["transformation", "rmse", "n_iter"])


def _nearest_t(t_src_t: torch.Tensor, xs_t: torch.Tensor, block: int = 4096,
               src_block: int = 4096):
    """(d2 (M,), idx (M,) int64) of each source point's nearest target, in
    the reference's transposed (D, M) / (D, N) layout (icp.py:35).

    Both axes are chunked, so the live distance buffer is (src_block,
    block) whatever the cloud sizes. d2 = max(|y|^2 + |x|^2 - 2 y.x, 0) as
    the reference takes it (one matmul per block; ``_run_icp`` centres the
    clouds first, so the cancellation stays ~|y|^2 eps). A later target
    block replaces the best only when strictly nearer, and ``min`` takes the
    first index within a block, so ties go to the first index.
    """
    src, tgt = t_src_t.T, xs_t.T
    m = src.shape[0]
    best_d2 = src.new_full((m,), float("inf"))
    best_ix = torch.zeros(m, dtype=torch.int64, device=src.device)
    x2 = (tgt * tgt).sum(1)
    for s0 in range(0, m, src_block):
        chunk = src[s0:s0 + src_block]
        y2 = (chunk * chunk).sum(1)[:, None]
        bd2, bix = best_d2[s0:s0 + src_block], best_ix[s0:s0 + src_block]
        for t0 in range(0, tgt.shape[0], block):
            blk = tgt[t0:t0 + block]
            d2 = torch.clamp(y2 + x2[None, t0:t0 + block]
                             - 2.0 * (chunk @ blk.T), min=0.0)
            d, i = d2.min(1)
            take = d < bd2
            bd2 = torch.where(take, d, bd2)
            bix = torch.where(take, i + t0, bix)
        best_d2[s0:s0 + src_block] = bd2
        best_ix[s0:s0 + src_block] = bix
    return best_d2, best_ix


def _run_icp(source, target, rot0, t0, *, maxiter, tol, trim_fraction):
    """The ICP loop (reference icp.py:93): (rot, t, rmse, n_iter).

    The clouds are centred on their shared centroid (rot0 / t0 convert in,
    the result converts back), so f32 distances keep their digits far from
    the origin. ``trim_fraction`` > 0 gives the k = round(trim_fraction * M)
    worst correspondences zero weight, k resolved once (``torch.topk`` for
    the reference's ``lax.top_k``)."""
    m = source.shape[0]
    cen = (source.sum(0) + target.sum(0)) / (m + target.shape[0])
    ys, xs = source - cen, target - cen
    rot, t = rot0, t0 + rot0 @ cen - cen
    k_trim = int(round(trim_fraction * m)) if trim_fraction > 0.0 else 0
    inf = torch.tensor(float("inf"), dtype=source.dtype, device=source.device)
    rmse, rmse_prev, it = inf, float("inf"), 0
    while it < maxiter:
        if it > 0 and not abs(rmse_prev - float(rmse)) >= tol:
            break
        rmse_prev = float(rmse)
        t_src = ys @ rot.T + t
        d2, idx = _nearest_t(t_src.T, xs.T)
        if k_trim > 0:
            worst = torch.topk(d2, k_trim).values
            w = (d2 < worst[-1]).to(source.dtype)
        else:
            w = torch.ones_like(d2)
        dr, dt = weighted_kabsch(t_src, xs[idx], w)
        rot, t = dr @ rot, dr @ t + dt
        rmse = torch.sqrt((w * d2).sum() / torch.clamp(w.sum(), min=1.0))
        it += 1
    return rot, t + cen - rot @ cen, rmse, it


def _fused_ok(src: torch.Tensor, tgt: torch.Tensor, trim_fraction) -> bool:
    """The whole-ICP kernel's branch (reference icp.py:188-192, a CUDA
    device in place of the TPU backend)."""
    return (trim_fraction == 0.0 and src.shape[-1] == 3
            and src.dtype == torch.float32 and src.is_cuda
            and _config.config.use_fused_em
            and icp_cuda.fused_dims_ok(src.shape[-2], tgt.shape[-2]))


def registration_icp(
    source,
    target,
    maxiter: int = 50,
    tol: float = 1.0e-6,
    trim_fraction: float = 0.0,
    tf_init_params: Optional[dict] = None,
    callbacks: Optional[List[Callable]] = None,
    device=None,
    **kwargs: Any,
) -> ICPResult:
    """Point-to-point ICP registration (reference icp.py:150).

    Args:
        source: Source point cloud ((M, D) ndarray, tensor or Open3D cloud).
        target: Target point cloud.
        maxiter: Maximum ICP iterations.
        tol: Convergence tolerance on the correspondence RMSE delta.
        trim_fraction: Fraction of worst correspondences to drop per
            iteration (trimmed ICP; 0 = classic).
        tf_init_params: Initial rigid transform ({'rot': ..., 't': ...}).
        callbacks: Called with the current transformation after each
            iteration (one registration step per iteration).
        device: Device to run on (default ``config.device``, "cuda"). A
            missing CUDA device raises instead of running on the CPU.

    Returns:
        ICPResult: (RigidTransformation, final rmse, iterations run).
    """
    dev = _config.resolve_device(device)
    src = interop.as_points(source, device=dev)
    tgt = interop.as_points(target, device=dev)
    dim = src.shape[1]
    params = dict(tf_init_params or {})
    rot0 = torch.as_tensor(params.get("rot", torch.eye(dim)),
                           dtype=src.dtype).to(dev)
    t0 = torch.as_tensor(params.get("t", torch.zeros(dim)),
                         dtype=src.dtype).to(dev)
    if not callbacks and _fused_ok(src, tgt, trim_fraction):
        rot, t, rmse, it = icp_cuda.run_icp_fused(
            src, tgt, rot0, t0, maxiter=int(maxiter), tol=float(tol))
        return ICPResult(tf.RigidTransformation(rot, t), rmse, int(it))
    if callbacks:
        rot, t, it = rot0, t0, 0
        rmse = torch.tensor(float("inf"), dtype=src.dtype, device=dev)
        rmse_prev = None
        for i in range(int(maxiter)):
            rot, t, rmse, _ = _run_icp(src, tgt, rot, t, maxiter=1, tol=0.0,
                                       trim_fraction=float(trim_fraction))
            it = i + 1
            for c in callbacks:
                c(tf.RigidTransformation(rot, t))
            r = float(rmse)
            if rmse_prev is not None and abs(rmse_prev - r) < tol:
                break
            rmse_prev = r
        return ICPResult(tf.RigidTransformation(rot, t), rmse, it)
    rot, t, rmse, it = _run_icp(src, tgt, rot0, t0, maxiter=int(maxiter),
                                tol=float(tol),
                                trim_fraction=float(trim_fraction))
    return ICPResult(tf.RigidTransformation(rot, t), rmse, it)


def registration_icp_batch(
    sources,
    targets,
    maxiter: int = 50,
    tol: float = 1.0e-6,
    trim_fraction: float = 0.0,
    device=None,
) -> List[ICPResult]:
    """Register B cloud pairs with ICP (reference icp.py:219).

    ``sources`` / ``targets`` are (B, M, 3) / (B, N, 3) stacks, or lists of
    clouds with different point counts (zero-padded to the batch maximum
    and registered with masks, which is the same as registering each pair
    without its padding). On a CUDA device, untrimmed 3-D pairs within the
    kernel's gate run as ONE launch of the whole-ICP kernel for the whole
    batch; otherwise each pair runs :func:`registration_icp`.

    Returns a list of ``ICPResult``.
    """
    dev = _config.resolve_device(device)
    ragged = isinstance(sources, (list, tuple)) \
        or isinstance(targets, (list, tuple))
    if ragged:
        src_p, smask = interop.pad_ragged(list(sources), device=dev)
        tgt_p, tmask = interop.pad_ragged(list(targets), device=dev)
    else:
        src_p = interop.as_points(sources, device=dev)
        tgt_p = interop.as_points(targets, device=dev)
        smask = tmask = None
    if _fused_ok(src_p, tgt_p, trim_fraction):
        rots, ts, rmses, iters = icp_cuda.run_icp_fused_batch(
            src_p, tgt_p, smask, tmask, maxiter=int(maxiter), tol=float(tol))
        iters = iters.tolist()
        return [ICPResult(tf.RigidTransformation(rots[b], ts[b]), rmses[b],
                          iters[b]) for b in range(src_p.shape[0])]
    srcs = sources if ragged else list(src_p)
    tgts = targets if ragged else list(tgt_p)
    return [registration_icp(s, t, maxiter=maxiter, tol=tol,
                             trim_fraction=trim_fraction, device=dev)
            for s, t in zip(srcs, tgts)]
