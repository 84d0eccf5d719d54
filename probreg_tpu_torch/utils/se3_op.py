"""Rotation helpers (counterpart of probreg_tpu/utils/se3_op.py).

Only what the port's paths, tests and smoke run need: static-frame xyz
Euler angles (transforms3d's 'sxyz' default, as in the reference), the
geodesic angle between two rotations, the twist helpers of FilterReg's
point-to-plane M-step (``skew``, ``twist_trans``, ``twist_mul``) and the
quaternion helpers of the multistart orientation grid (``quat2mat``,
``quat2mat_np``, ``mat2quat``), which the rigid L2-distance cost also
differentiates through, and the jacobians ``diff_x_from_twist`` (the
deformable FilterReg's Gauss-Newton step) and
``diff_rot_from_quaternion``.
"""

from __future__ import annotations

import numpy as np
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


def diff_x_from_twist(x) -> torch.Tensor:
    """d(T(tw) x) / d(tw) at tw = 0: the 3 x 6 jacobian [-skew(x) | I]
    (reference se3_op.py:70), batched ``(..., 3) -> (..., 3, 6)``."""
    x = _t(x)
    eye = torch.eye(3, dtype=x.dtype, device=x.device).expand(
        *x.shape[:-1], 3, 3)
    return torch.cat([-skew(x), eye], dim=-1)


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


def _quat_rows(w, x, y, z, s):
    xx, yy, zz = x * x * s, y * y * s, z * z * s
    xy, xz, yz = x * y * s, x * z * s, y * z * s
    wx, wy, wz = w * x * s, w * y * s, w * z * s
    return ((1.0 - yy - zz, xy - wz, xz + wy),
            (xy + wz, 1.0 - xx - zz, yz - wx),
            (xz - wy, yz + wx, 1.0 - xx - yy))


def quat2mat(q) -> torch.Tensor:
    """Rotation matrix from a quaternion (w, x, y, z), normalized inside
    (transforms3d's quat2mat, reference se3_op.py:80). A (..., 4) stack of
    quaternions gives a (..., 3, 3) stack of matrices."""
    q = _t(q)
    w, x, y, z = q.unbind(-1)
    s = 2.0 / torch.clamp(w * w + x * x + y * y + z * z, min=_EPS)
    return torch.stack([torch.stack(row, -1)
                        for row in _quat_rows(w, x, y, z, s)], -2)


def quat2mat_np(q) -> np.ndarray:
    """:func:`quat2mat` in float64 numpy (reference se3_op.py:104)."""
    w, x, y, z = np.asarray(q, np.float64)
    s = 2.0 / max(w * w + x * x + y * y + z * z, _EPS)
    return np.array(_quat_rows(w, x, y, z, s))


# quat2mat(q) = I + s P(q), s = 2 / |q|^2, each P_ij = q^T A_ij q with
# these symmetric (4, 4) forms (the rows of _quat_rows over w, x, y, z).
_QUAT_FORMS = np.zeros((3, 3, 4, 4))
for (_i, _j), _terms in {
        (0, 0): ((2, 2, -1), (3, 3, -1)), (0, 1): ((1, 2, 1), (0, 3, -1)),
        (0, 2): ((1, 3, 1), (0, 2, 1)), (1, 0): ((1, 2, 1), (0, 3, 1)),
        (1, 1): ((1, 1, -1), (3, 3, -1)), (1, 2): ((2, 3, 1), (0, 1, -1)),
        (2, 0): ((1, 3, 1), (0, 2, -1)), (2, 1): ((2, 3, 1), (0, 1, 1)),
        (2, 2): ((1, 1, -1), (2, 2, -1))}.items():
    for _a, _b, _c in _terms:
        _QUAT_FORMS[_i, _j, _a, _b] += _c / (1.0 if _a == _b else 2.0)
        if _a != _b:
            _QUAT_FORMS[_i, _j, _b, _a] += _c / 2.0


def diff_rot_from_quaternion(q) -> torch.Tensor:
    """dR(q) / dq of :func:`quat2mat` (reference se3_op.py:164), batched
    ``(..., 4) -> (..., 4, 3, 3)``: entry [k, i, j] is dR_ij / dq_k, from
    R = I + s P(q): dR_ij / dq_k = 2 s (A_ij q)_k - s^2 q_k P_ij."""
    q = _t(q)
    forms = torch.as_tensor(_QUAT_FORMS, dtype=q.dtype, device=q.device)
    s = 2.0 / torch.clamp((q * q).sum(-1), min=_EPS)
    aq = torch.einsum("ijab,...b->...ija", forms, q)        # (..., 3, 3, 4)
    p = (aq * q[..., None, None, :]).sum(-1)                 # (..., 3, 3)
    jac = (2.0 * s[..., None, None, None] * aq
           - (s * s)[..., None, None, None] * p[..., None] * q[..., None, None, :])
    return jac.movedim(-1, -3)


def mat2quat(rot) -> torch.Tensor:
    """Unit quaternion (w, x, y, z) of a rotation matrix (reference
    se3_op.py:129): the construction of each of the four pivots, the one
    of the largest of (trace, r00, r11, r22) taken."""
    rot = _t(rot)
    (m00, m01, m02), (m10, m11, m12), (m20, m21, m22) = (
        r.unbind(0) for r in rot.unbind(0))
    tr = m00 + m11 + m22

    def root2(v):
        return torch.sqrt(torch.clamp(v, min=_EPS)) * 2.0

    s0 = root2(1.0 + tr)
    s1 = root2(1.0 + m00 - m11 - m22)
    s2 = root2(1.0 - m00 + m11 - m22)
    s3 = root2(1.0 - m00 - m11 + m22)
    cands = torch.stack([
        torch.stack([0.25 * s0, (m21 - m12) / s0, (m02 - m20) / s0,
                     (m10 - m01) / s0]),
        torch.stack([(m21 - m12) / s1, 0.25 * s1, (m01 + m10) / s1,
                     (m02 + m20) / s1]),
        torch.stack([(m02 - m20) / s2, (m01 + m10) / s2, 0.25 * s2,
                     (m12 + m21) / s2]),
        torch.stack([(m10 - m01) / s3, (m02 + m20) / s3, (m12 + m21) / s3,
                     0.25 * s3])])
    q = cands[torch.argmax(torch.stack([tr, m00, m11, m22]))]
    return q / torch.linalg.norm(q)
