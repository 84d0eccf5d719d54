"""Weighted rigid solvers: Kabsch (2-D / 3-D) and the point-to-plane
Gauss-Newton step (counterpart of probreg_tpu/ops/rigid_solvers.py).

Plain tensor reductions and tiny dense solves, no kernel. The
point-to-plane normal equations are solved by an SVD pseudo-inverse with
the reference's relative cutoff 1e-6: on the card ``torch.linalg.lstsq``
has only the ``gels`` solver, which assumes full rank and ignores
``rcond``, and a single plane leaves a 3-D null space whose components the
minimum-norm solution keeps at zero.
"""

from __future__ import annotations

import torch

# Relative singular-value cutoff of the point-to-plane solve (the
# reference's lstsq rcond).
PT2PL_RCOND = 1e-6
# Largest rotation (rad) of one point-to-plane step: the trust region.
PT2PL_MAX_ROT = 0.5


def weighted_kabsch(model: torch.Tensor, target: torch.Tensor,
                    weight: torch.Tensor):
    """Weighted rigid fit (r, t) minimizing sum_i w_i^2 |r y_i + t - x_i|^2
    (reference rigid_solvers.py:17, kabsch.cc:6-56): centroids weighted by
    w, the cross-covariance by w^2. Zero total weight gives the identity."""
    dim = model.shape[1]
    total = weight.sum()
    safe_total = torch.where(total == 0.0, 1.0, total)
    mc = weight @ model / safe_total
    tc = weight @ target / safe_total
    w2 = weight * weight
    hh = ((model - mc) * w2[:, None]).T @ (target - tc)
    h_weight = w2.sum()
    hh = hh / torch.where(h_weight == 0.0, 1.0, h_weight)
    if dim == 2:  # the closed-form angle (kabsch.cc:58-109)
        angle = torch.atan2(hh[0, 1] - hh[1, 0], hh[0, 0] + hh[1, 1])
        ca, sa = torch.cos(angle), torch.sin(angle)
        r = torch.stack([torch.stack([ca, -sa]), torch.stack([sa, ca])])
    else:  # SVD with the det-sign fix
        u, _, vh = torch.linalg.svd(hh)
        s = torch.ones(dim, dtype=hh.dtype, device=hh.device)
        s[-1] = torch.linalg.det(u @ vh.T)
        r = (vh.T * s) @ u.T
    t = tc - r @ mc
    eye = torch.eye(dim, dtype=model.dtype, device=model.device)
    return (torch.where(total == 0.0, eye, r),
            torch.where(total == 0.0, torch.zeros_like(t), t))


def twist_for_pt2pl(model: torch.Tensor, target: torch.Tensor,
                    target_normal: torch.Tensor, weight: torch.Tensor):
    """One Gauss-Newton step of the point-to-plane objective (reference
    rigid_solvers.py:53, point_to_plane.cc:6-32): residual_k = n_k . (x_k -
    y_k), jacobian_k = [y_k x n_k, n_k]; solves (sum w J J^T) tw = sum w r J
    and returns (tw (6,), q = sum w^2 r^2)."""
    resid = (target_normal * (target - model)).sum(1)
    jac = torch.cat([torch.linalg.cross(model, target_normal),
                     target_normal], dim=1)                    # (M, 6)
    ata = (jac * weight[:, None]).T @ jac
    atb = (weight * resid) @ jac
    # The minimum-norm solution (singular values below 1e-6 of the largest
    # dropped), zero for an all-zero system, then capped to a rotation of
    # at most 0.5 rad with its direction kept.
    degenerate = ata.abs().amax() == 0.0
    eye = torch.eye(6, dtype=ata.dtype, device=ata.device)
    tw = torch.linalg.pinv(torch.where(degenerate, eye, ata),
                           rtol=PT2PL_RCOND) @ atb
    tw = torch.where(degenerate, torch.zeros_like(tw), tw)
    wn = torch.linalg.norm(tw[:3])
    tw = tw * torch.clamp(PT2PL_MAX_ROT / torch.clamp(wn, min=1e-12), max=1.0)
    return tw, (weight * weight * resid * resid).sum()
