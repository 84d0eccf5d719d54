"""Dual quaternions as (..., 8) tensors [qr (w, x, y, z) | qd (w, x, y, z)]
(counterpart of probreg_tpu/utils/dualquat.py).

Every function batches over the leading axes, so the dual-quaternion
linear blend of a whole skinned cloud is one set of elementwise tensor
operations.
"""

from __future__ import annotations

import torch

# Floors of the rotation angle squared and of the real part's norm
# (reference dualquat.py: the same 1e-12).
_EPS = 1e-12


def identity(dtype=torch.float32, device=None) -> torch.Tensor:
    return torch.tensor([1.0, 0, 0, 0, 0, 0, 0, 0], dtype=dtype,
                        device=device)


def qmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Hamilton product of quaternions (w, x, y, z), batched."""
    aw, ax, ay, az = a.unbind(-1)
    bw, bx, by, bz = b.unbind(-1)
    return torch.stack([
        aw * bw - ax * bx - ay * by - az * bz,
        aw * bx + ax * bw + ay * bz - az * by,
        aw * by - ax * bz + ay * bw + az * bx,
        aw * bz + ax * by - ay * bx + az * bw,
    ], dim=-1)


def mul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Dual-quaternion product."""
    ar, ad = a[..., :4], a[..., 4:]
    br, bd = b[..., :4], b[..., 4:]
    return torch.cat([qmul(ar, br), qmul(ar, bd) + qmul(ad, br)], dim=-1)


def from_rot_trans(quat: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """Dual quaternion of a unit rotation quaternion and a translation."""
    tq = torch.cat([torch.zeros_like(t[..., :1]), t], dim=-1)
    return torch.cat([quat, 0.5 * qmul(tq, quat)], dim=-1)


def from_twist(tw: torch.Tensor) -> torch.Tensor:
    """Dual quaternion of a 6-twist (axis-angle w | translation v): the
    rotation by |w| about w / |w| and the translation v (reference
    filterreg.py:58, ``dualquat_from_twist``)."""
    w, v = tw[..., :3], tw[..., 3:]
    ang2 = (w * w).sum(-1, keepdim=True)
    ang = torch.sqrt(torch.clamp(ang2, min=_EPS))
    half = 0.5 * ang
    qr = torch.cat([torch.cos(half), torch.sin(half) * (w / ang)], dim=-1)
    one = torch.tensor([1.0, 0, 0, 0], dtype=tw.dtype, device=tw.device)
    qr = torch.where(ang2 < _EPS, one.expand_as(qr), qr)
    return from_rot_trans(qr, v)


def normalize(q: torch.Tensor) -> torch.Tensor:
    n = torch.linalg.norm(q[..., :4], dim=-1, keepdim=True)
    return q / torch.clamp(n, min=_EPS)


def dlb2(w0: torch.Tensor, q0: torch.Tensor, w1: torch.Tensor,
         q1: torch.Tensor) -> torch.Tensor:
    """Dual-quaternion linear blend of two dual quaternions, batched; q1 is
    flipped to its antipode where qr0 . qr1 < 0 (reference
    dualquat.py:73)."""
    dot = (q0[..., :4] * q1[..., :4]).sum(-1, keepdim=True)
    q1 = torch.where(dot < 0, -q1, q1)
    return normalize(w0[..., None] * q0 + w1[..., None] * q1)


def conj(q: torch.Tensor) -> torch.Tensor:
    return q * torch.tensor([1.0, -1, -1, -1], dtype=q.dtype,
                            device=q.device)


def transform_point(q: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
    """Apply unit dual quaternions to 3-points, batched."""
    qr, qd = q[..., :4], q[..., 4:]
    w = qr[..., :1]
    u, p = torch.broadcast_tensors(qr[..., 1:], p)
    uxp = torch.linalg.cross(u, p, dim=-1)
    rotated = p + 2.0 * torch.linalg.cross(u, uxp + w * p, dim=-1)
    return rotated + 2.0 * qmul(qd, conj(qr))[..., 1:]


def to_rot_trans(q: torch.Tensor):
    """(rotation quaternion, translation) of a dual quaternion."""
    qn = normalize(q)
    qr, qd = qn[..., :4], qn[..., 4:]
    return qr, 2.0 * qmul(qd, conj(qr))[..., 1:]
