"""Whole-EM rigid FilterReg in one kernel launch, beside its plain version.

Counterpart of the FilterReg part of probreg_tpu/ops/em_pallas.py
(``_frg_kernel``): ``run_em_filterreg_fused`` and
``run_em_filterreg_fused_batch`` run every EM iteration of small 3-D pairs,
pt2pt or pt2pl, the convergence test included, inside one launch of
``csrc/frg.cu`` for the whole batch (the reference needs one launch per
pair). A pair runs on one block of 1,024 threads or, when the batch leaves
SMs idle, on a thread-block cluster of 2-8 blocks, and a ragged batch of
more blocks than SMs runs largest first (``em_cuda.launch_plan``, K1's
rule). Neither changes a bit of any pair's result.

Like the reference's twin ``filterreg._run_em_rigid``, and unlike its fused
kernel, the pair is centred on its shared centroid inside the kernel and d2
is taken from differences. The pt2pl step is the reference kernel's: the
6 x 6 normal equations with its relative ridge, a 0.5 rad cap and the exact
Rodrigues update.

Masks are treated as for the CPD kernel (ops/em_cuda.py): the wrapper moves
each pair's valid points (and the target's normals with them) to the front
and hands the kernel the counts. The automatic starting variance
(``auto_sigma2``) is computed from those valid points inside the launch
(pt2pt: the mean squared distance / 3, floored at min_sigma2; pt2pl: the
mean squared nearest-neighbour spacing of the target, floored at
min_sigma2 / 100), so a masked pair is the same registration, bit for bit,
as the pair without its padding, and a batch pair the same as its
single-pair launch.

CUDA tensors run the kernel; CPU tensors run
``run_em_filterreg_fused_plain``, the same arithmetic in tensors with the
loop test on the host. Nothing else picks between them. Every launch adds
one to ``LAUNCHES["frg_pt2pt"]`` or ``LAUNCHES["frg_pt2pl"]``.
"""

from __future__ import annotations

import ctypes
import math

import torch

from . import _build
from . import em_cuda
from .em_cuda import _check_batch, _compact, _horn_rotation
from .estep_cuda import _EPS, _check, _stream
from .pairwise import sqdist_diff

# Shared memory a block may use on the card (227 KB) less what the kernel
# holds statically, rounded up to 8 KB: 8,176 B at its largest, one block of
# 1,024 threads (ptxas -v; two reduction buffers of 32 warps x 31 floats,
# the 31 sums and the EM state, 8,164 B, and alignment).
_SMEM_POINT_BYTES = 227 * 1024 - 8192
_OBJECTIVES = ("pt2pt", "pt2pl")

LAUNCHES = {"frg_pt2pt": 0, "frg_pt2pl": 0}


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def fused_dims_ok(m: int, n: int) -> bool:
    """True iff one thread block can hold a pair of ``m`` source and ``n``
    target points: the kernel keeps the centred source and its per-row
    moments (48 B per point) and the centred target with its normals (32 B
    per point) in shared memory, 48 m + 32 n bytes of the 227 KB a block may
    use (less 8 KB of static state): up to 2,803 points each in a square
    pair. Callers gate on this and on ``config.fused_em_max_pairs``; above
    either the dense loop ``filterreg._run_em_rigid`` runs."""
    return 48 * m + 32 * n <= _SMEM_POINT_BYTES


_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float


def _lib() -> ctypes.CDLL:
    lib = _build.load("frg")
    if not getattr(lib, "_probreg_typed", False):
        lib.probreg_em_frg.argtypes = [_P, _I, _P, _I, _P, _P, _P, _I, _I,
                                       _F, _I, _F, _I, _F, _F, _I, _F, _I,
                                       _P, _P]
        lib.probreg_em_frg.restype = ctypes.c_int
        lib._probreg_typed = True
    return lib


def compact_batch(sources, targets, normals=None, smasks=None, tmasks=None):
    """What the kernel and its plain version take: the checked (B, M, 3)
    sources, (B, N, 3) targets and (B, N, 3) normals (or None) with each
    pair's valid points first, and the (B, 2) int32 counts of valid points
    (None without masks: all are valid)."""
    if (smasks is None) != (tmasks is None):
        raise ValueError("give both masks or neither")
    sources, targets = _check_batch(sources, targets, fused_dims_ok)
    if normals is not None:
        if normals.shape != targets.shape or normals.device != targets.device:
            raise ValueError(f"normals {tuple(normals.shape)} do not match "
                             f"the targets {tuple(targets.shape)}")
        normals = normals.to(torch.float32).contiguous()
    if smasks is None:
        return sources, targets, normals, None
    sources, m_cnt = _compact(sources, smasks)
    if normals is None:
        targets, n_cnt = _compact(targets, tmasks)
    else:  # the normals travel with their points
        both, n_cnt = _compact(torch.cat([targets, normals], dim=2), tmasks)
        targets = both[..., :3].contiguous()
        normals = both[..., 3:].contiguous()
    return (sources, targets, normals,
            torch.stack([m_cnt, n_cnt], dim=1).contiguous())


def run_em_filterreg_fused_batch(sources, targets, normals=None, smasks=None,
                                 tmasks=None, sigma2_0=0.0, *,
                                 objective="pt2pt", w=0.0, maxiter=50,
                                 tol=1e-3, update_sigma2=False,
                                 sigma2_decay=1.0, min_sigma2=1e-4,
                                 auto_sigma2=True):
    """(B, M, 3) x (B, N, 3) [+ (B, N, 3) normals for pt2pl, (B, M) / (B, N)
    0/1 masks] -> stacked (rot (B, 3, 3), t (B, 3), sigma2 (B,), q (B,),
    n_iter (B,)) in ONE kernel launch for the whole batch. ``sigma2_0`` is
    the starting variance of every pair when ``auto_sigma2`` is False."""
    if objective not in _OBJECTIVES:
        raise ValueError(f"unknown objective {objective!r}")
    if objective == "pt2pl" and normals is None:
        raise ValueError("pt2pl requires target normals")
    sources, targets, normals, counts = compact_batch(
        sources, targets, normals if objective == "pt2pl" else None, smasks,
        tmasks)
    args = dict(pt2pl=objective == "pt2pl", w=float(w), maxiter=int(maxiter),
                tol=float(tol), update_sigma2=bool(update_sigma2),
                sigma2_decay=float(sigma2_decay),
                min_sigma2=float(min_sigma2), auto_sigma2=bool(auto_sigma2),
                sigma2_0=float(sigma2_0))
    run = _frg_cuda if sources.is_cuda else run_em_filterreg_fused_plain
    out = run(sources, targets, normals, counts, **args)
    return (out[:, :9].reshape(-1, 3, 3), out[:, 9:12], out[:, 12],
            out[:, 13], out[:, 14])


def _frg_cuda(sources, targets, normals, counts, *, pt2pl, w, maxiter, tol,
              update_sigma2, sigma2_decay, min_sigma2, auto_sigma2,
              sigma2_0, _cluster=None, _ordered=True):
    """One launch of K5 by ``em_cuda.launch_plan``. For checks and timings,
    ``_cluster`` forces the blocks per pair (1, 2, 4 or 8) and
    ``_ordered=False`` the arrival order."""
    batch, m_cap, n_cap = sources.shape[0], sources.shape[1], targets.shape[1]
    g, order = em_cuda.launch_plan(batch, counts,
                                   em_cuda.sm_count(sources.device),
                                   cluster=_cluster, ordered=_ordered)
    out = sources.new_empty((batch, 16))
    status = _lib().probreg_em_frg(
        sources.data_ptr(), m_cap, targets.data_ptr(), n_cap,
        None if normals is None else normals.data_ptr(),
        None if counts is None else counts.data_ptr(),
        None if order is None else order.data_ptr(), batch, g, w, maxiter,
        tol, int(update_sigma2), sigma2_decay, min_sigma2, int(auto_sigma2),
        sigma2_0, int(pt2pl), out.data_ptr(), _stream(sources))
    _check(status, "em_frg")
    LAUNCHES["frg_pt2pl" if pt2pl else "frg_pt2pt"] += 1
    return out


def run_em_filterreg_fused(source, target, normals=None, smask=None,
                           tmask=None, sigma2_0=0.0, w=0.0, maxiter=50,
                           tol=1e-3, update_sigma2=False, sigma2_decay=1.0,
                           min_sigma2=1e-4, auto_sigma2=True,
                           objective="pt2pt"):
    """Rigid FilterReg of one pair as one launch: (rot, t, sigma2, q)."""
    rot, t, sigma2, q, _ = run_em_filterreg_fused_batch(
        source[None], target[None],
        None if normals is None else normals[None],
        None if smask is None else smask[None],
        None if tmask is None else tmask[None], sigma2_0,
        objective=objective, w=w, maxiter=maxiter, tol=tol,
        update_sigma2=update_sigma2, sigma2_decay=sigma2_decay,
        min_sigma2=min_sigma2, auto_sigma2=auto_sigma2)
    return rot[0], t[0], sigma2[0], q[0]


# --------------------------------------------------------------------------
# Plain version
# --------------------------------------------------------------------------

def _auto_sigma2(ys, xs, pt2pl, min_sigma2):
    """The kernel's starting variance of a centred pair."""
    m, n = ys.shape[0], xs.shape[0]
    if pt2pl:
        d2 = sqdist_diff(xs, xs)
        best = torch.where(d2 > 1e-12, d2, math.inf).amin(1)
        spacing = torch.where(torch.isfinite(best), best, 0.0).sum() / n
        return torch.clamp(spacing, min=min_sigma2 * 0.01)
    s2 = (n * (ys * ys).sum() + m * (xs * xs).sum()
          - 2.0 * ys.sum(0) @ xs.sum(0)) / (m * 3.0 * n)
    return torch.clamp(s2, min=min_sigma2)


def _pt2pl_step(ata, atb):
    """The kernel's twist step in double: ridge, solve, 0.5 rad cap,
    Rodrigues with the 1e-12 identity snap. Returns (dr, dt) in double."""
    ata, atb = ata.double(), atb.double()
    eye = torch.eye(6, dtype=ata.dtype, device=ata.device)
    lam = 1e-7 * torch.trace(ata) + _EPS * _EPS
    x = torch.linalg.solve(ata + lam * eye, atb)
    wn2 = (x[:3] * x[:3]).sum()
    x = x * torch.clamp(0.5 / torch.sqrt(torch.clamp(wn2, min=1e-24)),
                        max=1.0)
    twd2 = (x[:3] * x[:3]).sum()
    if float(twd2) < 1e-12:
        return eye[:3, :3], x[3:]
    twd = torch.sqrt(twd2)
    nv = x[:3] / twd
    skew = torch.stack([torch.stack([0.0 * nv[0], -nv[2], nv[1]]),
                        torch.stack([nv[2], 0.0 * nv[0], -nv[0]]),
                        torch.stack([-nv[1], nv[0], 0.0 * nv[0]])])
    dr = (torch.cos(twd) * eye[:3, :3]
          + (1.0 - torch.cos(twd)) * torch.outer(nv, nv)
          + torch.sin(twd) * skew)
    return dr, x[3:]


def _plain_pair(ys, xs, ns, *, pt2pl, w, maxiter, tol, update_sigma2,
                sigma2_decay, min_sigma2, auto_sigma2, sigma2_0):
    """One pair of valid points: the (16,) output row of the kernel."""
    m, n = ys.shape[0], xs.shape[0]
    cen = (ys.sum(0) + xs.sum(0)) / (m + n)
    ys, xs = ys - cen, xs - cen
    sigma2 = (_auto_sigma2(ys, xs, pt2pl, min_sigma2) if auto_sigma2
              else ys.new_tensor(sigma2_0))
    rot = torch.eye(3, dtype=ys.dtype, device=ys.device)
    t = ys.new_zeros(3)
    q = ys.new_tensor(1e30)
    wratio = w / (1.0 - w) * n / m if w > 0.0 else 0.0
    it, go = 0, maxiter > 0
    while go:
        c = float(wratio * (2.0 * math.pi * float(sigma2)) ** 1.5)
        ts = ys @ rot.T + t
        d2 = sqdist_diff(ts, xs)
        g = torch.exp(-d2 * (0.5 / sigma2))
        m0, m1 = g.sum(1), g @ xs
        mask = (m0 > 0.0).to(ys.dtype)
        inv_m0 = 1.0 / torch.clamp(m0, min=_EPS)
        m1m0 = m1 * inv_m0[:, None]
        den = torch.clamp(m0 + c, min=_EPS)
        m0m0 = m0 / den
        wt = mask * torch.sqrt(m0m0 / sigma2)
        total = wt.sum()
        if pt2pl:
            nxm0 = (g @ ns) * inv_m0[:, None]
            r = (nxm0 * (m1m0 - ts)).sum(1)
            jac = torch.cat([torch.linalg.cross(ts, nxm0), nxm0], dim=1)
            dr, dt = _pt2pl_step((jac * wt[:, None]).T @ jac,
                                 (wt * r) @ jac)
            q_new = ((wt * r) ** 2).sum()
        else:
            safe = torch.where(total == 0.0, 1.0, total)
            mc, tc = wt @ ts / safe, wt @ m1m0 / safe
            w2 = mask * m0m0 / sigma2
            hh = ((ts - mc) * w2[:, None]).T @ ((m1m0 - tc) * mask[:, None])
            dr = _horn_rotation(hh.T.double())
            dt = tc.double() - dr @ mc.double()
            q_new = (wt * torch.linalg.norm(ts - m1m0, dim=1)).sum()
        if float(total) == 0.0:
            dr = torch.eye(3, dtype=torch.float64, device=ys.device)
            dt = torch.zeros_like(dr[0])
        rot = (dr @ rot.double()).float()
        t = (dr @ t.double() + dt).float()
        s2 = ((mask * (g * d2).sum(1) / den).sum()
              / (3.0 * torch.clamp((mask * m0m0).sum(), min=_EPS))
              if update_sigma2 else sigma2 * sigma2_decay)
        sigma2 = torch.clamp(s2, min=min_sigma2)
        q_prev, q = float(q), q_new
        it += 1
        go = it < maxiter and abs(float(q) - q_prev) >= tol
    t = t + cen - rot @ cen
    return torch.cat([rot.reshape(-1), t, sigma2.reshape(1), q.reshape(1),
                      t.new_tensor([float(it), 0.0])])


def run_em_filterreg_fused_plain(sources, targets, normals=None, counts=None,
                                 *, pt2pl, w, maxiter, tol, update_sigma2,
                                 sigma2_decay, min_sigma2, auto_sigma2,
                                 sigma2_0):
    """Plain version of the whole-EM FilterReg kernel: (B, 16) rows [rot
    (9), t (3), sigma2, q, n_iter, 0]. ``counts`` (B, 2) int32 gives each
    pair's valid points, which lie at the front; None means all."""
    rows = []
    for b in range(sources.shape[0]):
        m, n = ((sources.shape[1], targets.shape[1]) if counts is None
                else (int(counts[b, 0]), int(counts[b, 1])))
        ns = None if normals is None else normals[b, :n]
        rows.append(_plain_pair(
            sources[b, :m], targets[b, :n], ns, pt2pl=pt2pl, w=w,
            maxiter=maxiter, tol=tol, update_sigma2=update_sigma2,
            sigma2_decay=sigma2_decay, min_sigma2=min_sigma2,
            auto_sigma2=auto_sigma2, sigma2_0=sigma2_0))
    return torch.stack(rows)
