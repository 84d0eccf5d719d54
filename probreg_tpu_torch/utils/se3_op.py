"""Rotation helpers (counterpart of probreg_tpu/utils/se3_op.py).

Only what the port's paths, tests and smoke run need: static-frame xyz
Euler angles (transforms3d's 'sxyz' default, as in the reference), the
geodesic angle between two rotations, and the twist helpers of FilterReg's
point-to-plane M-step (``skew``, ``twist_trans``, ``twist_mul``).
"""

from __future__ import annotations

import torch

# Squared rotation angle below which a twist's rotation is the identity
# (reference se3_op.py: the same 1e-12 as its _EPS).
_EPS = 1e-12


def _t(x, like=None):
    if isinstance(x, torch.Tensor):
        return x
    return torch.tensor(x, dtype=torch.float32,
                        device=None if like is None else like.device)


def euler2mat(ai, aj, ak) -> torch.Tensor:
    """Rotation matrix R = Rz(ak) @ Ry(aj) @ Rx(ai) ('sxyz')."""
    ai = _t(ai)
    aj, ak = _t(aj, ai), _t(ak, ai)
    si, ci = torch.sin(ai), torch.cos(ai)
    sj, cj = torch.sin(aj), torch.cos(aj)
    sk, ck = torch.sin(ak), torch.cos(ak)
    one, zero = torch.ones_like(ai), torch.zeros_like(ai)
    rx = torch.stack([torch.stack([one, zero, zero]),
                      torch.stack([zero, ci, -si]),
                      torch.stack([zero, si, ci])])
    ry = torch.stack([torch.stack([cj, zero, sj]),
                      torch.stack([zero, one, zero]),
                      torch.stack([-sj, zero, cj])])
    rz = torch.stack([torch.stack([ck, -sk, zero]),
                      torch.stack([sk, ck, zero]),
                      torch.stack([zero, zero, one])])
    return rz @ ry @ rx


def mat2euler(rot) -> torch.Tensor:
    """Static-frame xyz Euler angles ('sxyz') from a rotation matrix."""
    rot = _t(rot)
    cy = torch.sqrt(rot[2, 2] * rot[2, 2] + rot[2, 1] * rot[2, 1])
    ok = cy > 1e-6
    ax = torch.where(ok, torch.atan2(rot[2, 1], rot[2, 2]),
                     torch.atan2(-rot[1, 2], rot[1, 1]))
    ay = torch.atan2(-rot[2, 0], cy)
    az = torch.where(ok, torch.atan2(rot[1, 0], rot[0, 0]),
                     torch.zeros_like(cy))
    return torch.stack([ax, ay, az])


def rotation_angle(r_a, r_b) -> torch.Tensor:
    """Geodesic angle between two rotations (radians).

    From the chordal distance, 2 asin(|R_a - R_b|_F / (2 sqrt 2)), which
    equals the reference's arccos((tr(R_a R_b^T) - 1) / 2) for rotations
    but stays accurate for small angles: the arccos form cannot resolve
    angles below ~5e-4 rad from f32 matrices (their trace may exceed 3).
    """
    r_a = _t(r_a)
    chord = torch.linalg.norm(r_a - _t(r_b, r_a).to(r_a)) / (2.0 * 2.0 ** 0.5)
    return 2.0 * torch.asin(torch.clamp(chord, max=1.0))


def skew(x) -> torch.Tensor:
    """Skew-symmetric matrix of a 3-vector, batched ``(..., 3) -> (..., 3,
    3)`` (reference se3_op.py:21)."""
    x = _t(x)
    z = torch.zeros_like(x[..., 0])
    return torch.stack([
        torch.stack([z, -x[..., 2], x[..., 1]], dim=-1),
        torch.stack([x[..., 2], z, -x[..., 0]], dim=-1),
        torch.stack([-x[..., 1], x[..., 0], z], dim=-1)], dim=-2)


def twist_trans(tw, linear: bool = False):
    """Twist (w | v) -> (R, t) by the exact Rodrigues formula, or its
    linearization I + [w]x (reference se3_op.py:38). A rotation angle with
    square below 1e-12 gives the identity, as in the reference."""
    tw = _t(tw)
    w, v = tw[:3], tw[3:]
    eye = torch.eye(3, dtype=tw.dtype, device=tw.device)
    if linear:
        return eye + skew(w), v
    twd2 = (w * w).sum()
    twd = torch.sqrt(torch.clamp(twd2, min=_EPS))
    ntw = w / twd
    c, s = torch.cos(twd), torch.sin(twd)
    rot = c * eye + (1.0 - c) * torch.outer(ntw, ntw) + s * skew(ntw)
    return torch.where(twd2 < _EPS, eye, rot), v


def twist_mul(tw, rot, t, linear: bool = False):
    """Compose a twist increment with (rot, t): the increment rotates the
    old translation too (reference se3_op.py:58)."""
    tr, tt = twist_trans(tw, linear=linear)
    return tr @ rot, t @ tr.T + tt
