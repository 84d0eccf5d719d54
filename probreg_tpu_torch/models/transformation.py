"""Transformation models (counterpart of probreg_tpu/models/transformation.py).

Parameters are tensors on one device. ``transform`` is the user-facing call
(numpy, tensors or Open3D clouds in, a tensor out); ``_transform`` works on
tensors already on the transformation's device. The nonrigid models are
CPD's (a dense Gram matrix, or its low-rank Nystrom factors) and BCPD's
combined transformation; like the reference's, each nonrigid displacement
field is defined at the source points it was fitted to, row by row.
"""

from __future__ import annotations

import abc

import torch

from .. import config as _config
from ..utils import interop


class Transformation(abc.ABC):
    """ABC matching reference transformation.py:18-30."""

    device: torch.device

    def transform(self, points) -> torch.Tensor:
        return self._transform(interop.as_points(points, device=self.device))

    @abc.abstractmethod
    def _transform(self, points: torch.Tensor) -> torch.Tensor:
        ...


def _param(x, device) -> torch.Tensor:
    return torch.as_tensor(x, dtype=_config.config.dtype, device=device)


def _device_of(device, *params) -> torch.device:
    """``device``, else the device of the first tensor parameter, else the
    configured one."""
    if device is None:
        given = [p for p in params if isinstance(p, torch.Tensor)]
        device = given[0].device if given else _config.resolve_device(None)
    return torch.device(device)


class RigidTransformation(Transformation):
    """x -> scale * R x + t (reference transformation.py:33-60)."""

    def __init__(self, rot=None, t=None, scale=1.0, dim: int = 3,
                 device=None):
        self.device = _device_of(device, rot, t, scale)
        if rot is None:
            rot = torch.eye(dim)
        if t is None:
            t = torch.zeros(dim)
        self.rot = _param(rot, self.device)
        self.t = _param(t, self.device)
        self.scale = _param(scale, self.device)

    def _transform(self, points):
        return self.scale * points @ self.rot.T + self.t

    def inverse(self) -> "RigidTransformation":
        return RigidTransformation(
            self.rot.T, -(self.rot.T @ self.t) / self.scale, 1.0 / self.scale,
            device=self.device)

    def __mul__(self, other: "RigidTransformation") -> "RigidTransformation":
        return RigidTransformation(
            self.rot @ other.rot,
            self.t + self.scale * self.rot @ other.t,
            self.scale * other.scale,
            device=self.device)

    def __repr__(self):
        return (f"RigidTransformation(rot={self.rot}, t={self.t}, "
                f"scale={self.scale})")


class AffineTransformation(Transformation):
    """x -> B x + t (reference transformation.py:63-78)."""

    def __init__(self, b=None, t=None, dim: int = 3, device=None):
        self.device = _device_of(device, b, t)
        if b is None:
            b = torch.eye(dim)
        if t is None:
            t = torch.zeros(dim)
        self.b = _param(b, self.device)
        self.t = _param(t, self.device)

    def _transform(self, points):
        return points @ self.b.T + self.t

    def __repr__(self):
        return f"AffineTransformation(b={self.b}, t={self.t})"


class NonRigidTransformation(Transformation):
    """x -> x + G(Y, Y; beta) W, the motion-coherence displacement field
    (reference transformation.py:126).

    ``g`` is the (M, M) RBF Gram matrix of the source points ``points``
    (``ops.pairwise.rbf_kernel``, beta the variance), built here unless
    given; ``w`` the (M, D) weights, zeros shaped like the points when
    None. ``transform`` takes the source the model was fitted to.
    """

    def __init__(self, w=None, points=None, beta: float = 2.0, g=None,
                 device=None):
        self.device = _device_of(device, w, points, g)
        if g is None:
            from ..ops import pairwise

            pts = _param(points, self.device)
            g = pairwise.rbf_kernel(pts, pts, beta)
        self.g = _param(g, self.device)
        if w is None:
            if points is None:
                raise ValueError(
                    "NonRigidTransformation(w=None) needs points= to "
                    "shape the zero displacement field")
            w = torch.zeros(tuple(_param(points, self.device).shape))
        self.w = _param(w, self.device)

    def _transform(self, points):
        return points + self.g @ self.w

    def __repr__(self):
        return f"NonRigidTransformation(g={self.g}, w={self.w})"


class LowRankNonRigidTransformation(Transformation):
    """x -> x + U zc: the nonrigid model with G(Y, Y; beta) held as its
    rank-K Nystrom factors U (M, K), ``lam`` (K,), and the weights as the
    spectral coefficients zc = diag(lam) U^T W (K, D), so that G W = U zc
    (reference transformation.py:164). O(M K) memory."""

    def __init__(self, zc, u, lam, device=None):
        self.device = _device_of(device, zc, u, lam)
        self.zc = _param(zc, self.device)
        self.u = _param(u, self.device)
        self.lam = _param(lam, self.device)

    def _transform(self, points):
        return points + self.u @ self.zc

    def __repr__(self):
        return (f"LowRankNonRigidTransformation(zc={self.zc}, u={self.u}, "
                f"lam={self.lam})")


class CombinedTransformation(Transformation):
    """x -> scale * R (x + v) + t: BCPD's combined rigid, scale and nonrigid
    model (reference transformation.py:196). ``v`` is the (M, D)
    displacement of each source point (or a scalar, as the reference
    allows), so ``transform`` takes the source the model was fitted to."""

    def __init__(self, rot=None, t=None, scale=1.0, v=0.0, dim: int = 3,
                 device=None):
        self.rigid_trans = RigidTransformation(rot, t, scale, dim=dim,
                                               device=device)
        self.device = self.rigid_trans.device
        self.v = _param(v, self.device)

    def _transform(self, points):
        return self.rigid_trans._transform(points + self.v)

    def __repr__(self):
        return (f"CombinedTransformation(rigid_trans={self.rigid_trans!r}, "
                f"v={self.v})")
