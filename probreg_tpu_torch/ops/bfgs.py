"""Batched BFGS with a strong-Wolfe line search, on tensors.

The port's counterpart of ``jax.scipy.optimize.minimize(method="BFGS")``,
which the L2-distance registrations of the JAX package run on the device
(reference l2dist_regs.py:36). It follows jax.scipy.optimize's BFGS and its
line search step for step: H0 = I, the inf-norm gradient test against
``gtol``, maxiter 200 P by default, the inverse-Hessian update kept only
where 1 / (y.s) is finite, at most 10 line-search iterations per BFGS
iteration, c1 = 1e-4, c2 = 0.9, the start step from the previous decrease
(capped at 1), the doubling bracket, the zoom by cubic, quadratic or
bisection steps with its 1e-5 (f32) / 1e-10 (f64) interval floor and its 30
iterations, the 1e-8 floor on an f32 step, and jax's ``status`` codes (0
converged, 1 maxiter, 2 + the line search's code when it failed: 3 zoom
failed, 5 its maxiter).

``x0`` is a (B, P) batch of independent solves. Each row keeps its own
state and its own line search; a row that has finished is frozen while the
others go on, so every row ends where it ends when solved alone (the
meaning of ``vmap`` over jax's ``while_loop``). The objective takes the
(B, P) batch and returns the (B,) values; gradients are those of the
summed values by ``torch.autograd``, each row's its own.

A jax zoom runs inside the bracketing iteration that calls it; here a row's
line search is one loop in which every pass makes ONE batched evaluation,
at each row's next bracket step or next zoom step, so rows in different
phases share an evaluation. A row's own sequence of evaluations is jax's.
The loops end on a host read: one per BFGS iteration and one per
evaluation of the line search, which also tells whether any row brackets
or zooms (a phase no row is in is skipped). ``READS`` counts them,
``EVALS`` the batched evaluations (``value_and_grad`` calls), ``ITERS``
the BFGS iterations (the largest row's) and ``SOLVES`` the calls of
``minimize``, since ``reset_counts``.
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import torch

READS = 0
EVALS = 0
ITERS = 0
SOLVES = 0


def reset_counts() -> None:
    global READS, EVALS, ITERS, SOLVES
    READS = EVALS = ITERS = SOLVES = 0


def _flags(*masks: torch.Tensor):
    """Whether any row is set in each mask: the loops' end test, one host
    read."""
    global READS
    READS += 1
    return [bool(v) for v in torch.stack([m.any() for m in masks]).tolist()]


class BFGSResult(NamedTuple):
    """jax.scipy.optimize's OptimizeResults that the port reads, one row
    per solve."""

    x: torch.Tensor          # (B, P)
    fun: torch.Tensor        # (B,)
    status: torch.Tensor     # (B,) int
    nfev: torch.Tensor       # (B,) int
    nit: torch.Tensor        # (B,) int


def value_and_grad(fun: Callable, x: torch.Tensor):
    """(B,) values of ``fun`` at the (B, P) points and their (B, P)
    gradients."""
    global EVALS
    EVALS += 1
    with torch.enable_grad():
        xg = x.detach().requires_grad_(True)
        f = fun(xg)
        (g,) = torch.autograd.grad(f.sum(), xg)
    return f.detach(), g.detach()


def _cubicmin(a, fa, fpa, b, fb, c, fc):
    db = b - a
    dc = c - a
    denom = (db * dc) ** 2 * (db - dc)
    d2a = fb - fa - fpa * db
    d2b = fc - fa - fpa * dc
    big_a = (dc ** 2 * d2a - db ** 2 * d2b) / denom
    big_b = (-dc ** 3 * d2a + db ** 3 * d2b) / denom
    radical = big_b * big_b - 3.0 * big_a * fpa
    return a + (-big_b + torch.sqrt(radical)) / (3.0 * big_a)


def _quadmin(a, fa, fpa, b, fb):
    db = b - a
    big_b = (fb - fa - fpa * db) / (db ** 2)
    return a - fpa / (2.0 * big_b)


def _zoom_step(a_lo, phi_lo, dphi_lo, a_hi, phi_hi, a_rec, phi_rec, j,
               threshold):
    """The zoom's next trial step, by cubic, quadratic or bisection
    interpolation, and whether its bracket has shrunk below
    ``threshold``."""
    dalpha = a_hi - a_lo
    lo = torch.minimum(a_hi, a_lo)
    hi = torch.maximum(a_hi, a_lo)
    a_cubic = _cubicmin(a_lo, phi_lo, dphi_lo, a_hi, phi_hi, a_rec, phi_rec)
    use_cubic = (j > 0) & (a_cubic > lo + 0.2 * dalpha) \
        & (a_cubic < hi - 0.2 * dalpha)
    a_quad = _quadmin(a_lo, phi_lo, dphi_lo, a_hi, phi_hi)
    use_quad = ~use_cubic & (a_quad > lo + 0.1 * dalpha) \
        & (a_quad < hi - 0.1 * dalpha)
    a_z = torch.where(use_cubic, a_cubic, a_rec)
    a_z = torch.where(use_quad, a_quad, a_z)
    a_z = torch.where(~use_cubic & ~use_quad, (a_lo + a_hi) / 2.0, a_z)
    return a_z, dalpha <= threshold


def _line_search(fun, xk, pk, old_fval, old_old_fval, gfk, active,
                 c1=1e-4, c2=0.9, maxiter=10):
    """jax.scipy.optimize's strong-Wolfe line search for the rows of
    ``active``; returns (failed, nfev, a_k, f_k, g_k, status) per row."""
    dtype = xk.dtype
    nb = xk.shape[0]
    threshold = 1e-5 if torch.finfo(dtype).bits < 64 else 1e-10
    phi0 = old_fval
    dphi0 = (gfk * pk).sum(1)
    cand = 1.01 * 2 * (phi0 - old_old_fval) / dphi0
    start = torch.where(cand > 1, torch.ones_like(cand), cand)

    def wolfe_one(a, phi):
        return phi > phi0 + c1 * a * dphi0

    def wolfe_two(dphi):
        return dphi.abs() <= -c2 * dphi0

    zeros = torch.zeros_like(phi0)
    false = torch.zeros(nb, dtype=torch.bool, device=xk.device)
    izero = torch.zeros(nb, dtype=torch.int64, device=xk.device)
    done, failed, zooming = ~active, false, false
    i, j, nfev = izero + 1, izero, izero
    a_i1, phi_i1, dphi_i1 = zeros, phi0, dphi0
    a_star, phi_star, dphi_star, g_star = zeros, phi0, dphi0, gfk
    # The zoom's bracket (lo, hi) and its previous point (rec).
    a_lo = phi_lo = dphi_lo = a_hi = phi_hi = dphi_hi = zeros
    a_rec = phi_rec = zeros
    while True:
        bracket = ~done & ~failed & ~zooming & (i <= maxiter)
        zoom = ~done & ~failed & zooming
        any_b, any_z = _flags(bracket, zoom)
        if not (any_b or any_z):
            break
        # The bracket's next trial step; the zoom's (reference
        # line_search.py _zoom), computed only while a row zooms.
        a_b = torch.where(i == 1, start, a_i1 * 2.0)
        a_e = torch.where(bracket, a_b, zeros)
        if any_z:
            a_z, zfail = _zoom_step(a_lo, phi_lo, dphi_lo, a_hi, phi_hi,
                                    a_rec, phi_rec, j, threshold)
            a_e = torch.where(zoom, a_z, a_e)
        phi, g = value_and_grad(fun, xk + a_e[:, None] * pk)
        dphi = (g * pk).sum(1)
        nfev = nfev + (bracket | zoom).long()
        take = enter = false

        if any_z:
            # Zoom rows (reference line_search.py _zoom body).
            hi_to_j = wolfe_one(a_z, phi) | (phi >= phi_lo)
            star_to_j = wolfe_two(dphi) & ~hi_to_j
            hi_to_lo = (dphi * (a_hi - a_lo) >= 0.0) & ~hi_to_j & ~star_to_j
            lo_to_j = ~hi_to_j & ~star_to_j
            zj = zoom & hi_to_j
            zl = zoom & hi_to_lo
            zr = zoom & lo_to_j & ~hi_to_lo
            zlo = zoom & lo_to_j
            z_a_hi = torch.where(zj, a_z, torch.where(zl, a_lo, a_hi))
            z_phi_hi = torch.where(zj, phi, torch.where(zl, phi_lo, phi_hi))
            z_dphi_hi = torch.where(zj, dphi,
                                    torch.where(zl, dphi_lo, dphi_hi))
            a_rec = torch.where(zj | zl, a_hi, torch.where(zr, a_lo, a_rec))
            phi_rec = torch.where(zj | zl, phi_hi,
                                  torch.where(zr, phi_lo, phi_rec))
            a_lo = torch.where(zlo, a_z, a_lo)
            phi_lo = torch.where(zlo, phi, phi_lo)
            dphi_lo = torch.where(zlo, dphi, dphi_lo)
            a_hi, phi_hi, dphi_hi = z_a_hi, z_phi_hi, z_dphi_hi
            take = zoom & star_to_j
            j = j + zoom.long()
            zfailed = zoom & (zfail | (j >= 30))
            zend = take | zfailed
            zooming = zooming & ~zend
            done = done | zend
            failed = failed | zfailed

        if any_b:
            # Bracket rows (reference line_search.py line_search body).
            to_zoom1 = wolfe_one(a_b, phi) | ((phi >= phi_i1) & (i > 1))
            to_i = wolfe_two(dphi) & ~to_zoom1
            to_zoom2 = (dphi >= 0.0) & ~to_zoom1 & ~to_i
            enter = bracket & (to_zoom1 | to_zoom2)
            hit = bracket & to_i
            # A new zoom starts from its bracket: zoom(lo = the previous
            # step, hi = this one) or the reverse, the star at step 1.
            z1 = bracket & to_zoom1
            n_lo = (torch.where(z1, a_i1, a_b), torch.where(z1, phi_i1, phi),
                    torch.where(z1, dphi_i1, dphi))
            n_hi = (torch.where(z1, a_b, a_i1), torch.where(z1, phi, phi_i1),
                    torch.where(z1, dphi, dphi_i1))
            a_lo = torch.where(enter, n_lo[0], a_lo)
            phi_lo = torch.where(enter, n_lo[1], phi_lo)
            dphi_lo = torch.where(enter, n_lo[2], dphi_lo)
            a_hi = torch.where(enter, n_hi[0], a_hi)
            phi_hi = torch.where(enter, n_hi[1], phi_hi)
            dphi_hi = torch.where(enter, n_hi[2], dphi_hi)
            a_rec = torch.where(enter, (n_lo[0] + n_hi[0]) / 2.0, a_rec)
            phi_rec = torch.where(enter, (n_lo[1] + n_hi[1]) / 2.0, phi_rec)
            j = torch.where(enter, izero, j)
            take = take | hit
            zooming = zooming | enter
            done = done | hit
            i = i + bracket.long()
            a_i1 = torch.where(bracket, a_b, a_i1)
            phi_i1 = torch.where(bracket, phi, phi_i1)
            dphi_i1 = torch.where(bracket, dphi, dphi_i1)
            a_star = torch.where(enter, torch.ones_like(a_star), a_star)
            phi_star = torch.where(enter, n_lo[1], phi_star)
            dphi_star = torch.where(enter, n_lo[2], dphi_star)
            g_star = torch.where(enter[:, None], gfk, g_star)

        a_star = torch.where(take, a_e, a_star)
        phi_star = torch.where(take, phi, phi_star)
        dphi_star = torch.where(take, dphi, dphi_star)
        g_star = torch.where(take[:, None], g, g_star)

    status = torch.where(failed, izero + 1,
                         torch.where(i > maxiter, izero + 3, izero))
    if torch.finfo(dtype).bits != 64:
        a_star = torch.where(a_star.abs() < 1e-8,
                             torch.sign(a_star) * 1e-8, a_star)
    return failed | ~done, nfev, a_star, phi_star, g_star, status


def minimize(fun: Callable, x0: torch.Tensor, maxiter: int = None,
             gtol: float = 1e-5,
             line_search_maxiter: int = 10) -> BFGSResult:
    """Minimize each row of ``fun`` from the rows of ``x0`` (B, P).

    ``fun`` maps a (B, P) batch to its (B,) values; row b's value may
    depend on row b of its argument only.
    """
    global ITERS, SOLVES
    SOLVES += 1
    nb, d = x0.shape
    if maxiter is None:
        maxiter = d * 200
    f, g = value_and_grad(fun, x0)
    eye = torch.eye(d, dtype=x0.dtype, device=x0.device)
    h = eye.expand(nb, d, d).clone()
    izero = torch.zeros(nb, dtype=torch.int64, device=x0.device)
    converged = g.abs().amax(1) < gtol
    failed = torch.zeros_like(converged)
    k, nfev, ls_status = izero, izero + 1, izero
    x = x0
    old_old = f + torch.linalg.vector_norm(g, dim=1) / 2
    while True:
        active = ~converged & ~failed & (k < maxiter)
        if not _flags(active)[0]:
            break
        ITERS += 1
        p = -(h @ g[:, :, None])[:, :, 0]
        ls_failed, ls_nfev, a_k, f_1, g_1, ls_st = _line_search(
            fun, x, p, f, old_old, g, active, maxiter=line_search_maxiter)
        s = a_k[:, None] * p
        y = g_1 - g
        rho = 1.0 / (y * s).sum(1)
        w = eye - rho[:, None, None] * (s[:, :, None] * y[:, None, :])
        h_1 = w @ h @ w.transpose(1, 2) \
            + rho[:, None, None] * (s[:, :, None] * s[:, None, :])
        h_1 = torch.where(torch.isfinite(rho)[:, None, None], h_1, h)
        a1 = active[:, None]
        nfev = nfev + torch.where(active, ls_nfev, izero)
        failed = torch.where(active, ls_failed, failed)
        ls_status = torch.where(active, ls_st, ls_status)
        converged = torch.where(active, g_1.abs().amax(1) < gtol, converged)
        k = k + active.long()
        old_old = torch.where(active, f, old_old)
        x = torch.where(a1, x + s, x)
        f = torch.where(active, f_1, f)
        g = torch.where(a1, g_1, g)
        h = torch.where(a1[:, :, None], h_1, h)
    status = torch.where(
        converged, izero,
        torch.where(k == maxiter, izero + 1,
                    torch.where(failed, 2 + ls_status, izero - 1)))
    return BFGSResult(x=x, fun=f, status=status, nfev=nfev, nit=k)
