"""Transformation models (counterpart of probreg_tpu/models/transformation.py).

Parameters are tensors on one device. ``transform`` is the user-facing call
(numpy, tensors or Open3D clouds in, a tensor out); ``_transform`` works on
tensors already on the transformation's device. The nonrigid models are
CPD's (a dense Gram matrix, or its low-rank Nystrom factors), BCPD's
combined transformation and the thin-plate spline of the L2-distance
registrations; like the reference's, each nonrigid CPD or BCPD
displacement field is defined at the source points it was fitted to, row
by row, while the thin-plate spline moves any points. The deformable
kinematic model blends its nodes' dual quaternions with the skinning
weights of each point.
"""

from __future__ import annotations

import abc

import numpy as np
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


def tps_design(landmarks: torch.Tensor, control_pts: torch.Tensor, kfn):
    """The TPS basis of ``landmarks`` and the bending kernel (reference
    transformation.py:241-253).

    ``basis`` is [1, landmarks, U(landmarks, control_pts) pp] and
    ``kernel`` is pp^T U(control_pts, control_pts) pp, where pp, the
    columns of U past d + 1 of the full SVD of [1, control_pts], is an
    orthonormal basis of the null space of the control points' design
    matrix. Those columns belong to zero singular values, so any
    orthonormal basis of that space is as good and two SVDs may return
    different ones: the nonrigid weights v are coordinates in this basis
    (``interop.tps_from_reference`` carries them across).
    """
    pm = torch.cat([landmarks.new_ones((landmarks.shape[0], 1)), landmarks],
                   1)
    pp = null_basis(control_pts)
    kk = kfn(control_pts, control_pts)
    uu = kfn(landmarks, control_pts)
    return torch.cat([pm, uu @ pp], 1), pp.T @ kk @ pp


def null_basis(control_pts: torch.Tensor) -> torch.Tensor:
    """pp of :func:`tps_design`: the (N, N - d - 1) null-space basis of
    [1, control_pts] that the weights v are expressed in."""
    n, d = control_pts.shape
    pn = torch.cat([control_pts.new_ones((n, 1)), control_pts], 1)
    return torch.linalg.svd(pn, full_matrices=True)[0][:, d + 1:]


class TPSTransformation(Transformation):
    """Thin-plate-spline transformation x -> [1, x, U(x, c) pp] [a; v]
    (reference transformation.py:220): ``a`` (d + 1, d) is the affine
    part, ``v`` (N - d - 1, d) the nonrigid weights in the null-space basis
    pp of the N control points ``control_pts`` (see :func:`tps_design`).
    ``kernel`` is a callable U(x, y), or "auto" for the thin-plate kernel
    of the points' dimension."""

    def __init__(self, a, v, control_pts, kernel="auto", device=None):
        self.device = _device_of(device, a, v, control_pts)
        self.a = _param(a, self.device)
        self.v = _param(v, self.device)
        self.control_pts = _param(control_pts, self.device)
        self._kernel = kernel

    def _kfn(self, x, y):
        if callable(self._kernel):
            return self._kernel(x, y)
        from ..ops import pairwise

        if x.shape[1] == 2:
            return pairwise.tps_kernel_2d(x, y)
        return pairwise.tps_kernel_3d(x, y)

    def prepare(self, landmarks):
        """(basis, kernel) of ``landmarks`` (reference
        transformation.py:241)."""
        return tps_design(_param(landmarks, self.device), self.control_pts,
                          self._kfn)

    def transform_basis(self, basis):
        return basis @ torch.cat([self.a, self.v], 0)

    def _transform(self, points):
        basis, _ = self.prepare(points)
        return self.transform_basis(basis)

    def __repr__(self):
        return (f"TPSTransformation(a={self.a}, v={self.v}, "
                f"control_pts={self.control_pts})")


class DeformableKinematicModel(Transformation):
    """Dual-quaternion blended skinning (reference transformation.py:274):
    each point moves by the linear blend of its two nodes' dual
    quaternions. ``dualquats`` (n_nodes, 8) as in ``utils/dualquat``;
    ``weights`` a :class:`SkinningWeight`, one row per point, so
    ``transform`` takes the points the weights were made for."""

    class SkinningWeight:
        """Per point a pair of node ids and a pair of weights: ``pair``
        (P, 2) int and ``val`` (P, 2) float, kept as numpy arrays (the
        reference keeps these two arrays too)."""

        def __init__(self, pair, val):
            self.pair = np.asarray(pair, dtype=np.int64)
            self.val = np.asarray(val, dtype=np.float32)

        def __len__(self):
            return self.pair.shape[0]

        @property
        def n_nodes(self):
            return int(self.pair.max()) + 1

        def pairs_set(self):
            import itertools

            return itertools.permutations(range(self.n_nodes), 2)

        def in_pair(self, pair):
            return np.argwhere((self.pair == np.asarray(pair)).all(1)
                               ).flatten()

        def tensors(self, dtype, device):
            """(pair (P, 2) int64, val (P, 2)) as tensors on ``device``."""
            return (torch.as_tensor(self.pair, device=device),
                    torch.as_tensor(self.val, dtype=dtype, device=device))

    @classmethod
    def make_weight(cls, pairs, vals):
        return cls.SkinningWeight(pairs, vals)

    def __init__(self, dualquats, weights, device=None):
        if isinstance(dualquats, (list, tuple)):
            dualquats = torch.stack([torch.as_tensor(q) for q in dualquats])
        self.device = _device_of(device, dualquats)
        self.dualquats = _param(dualquats, self.device)
        self.weights = weights

    def _transform(self, points):
        from ..utils import dualquat as dq

        pair, val = self.weights.tensors(points.dtype, points.device)
        blended = dq.dlb2(val[:, 0], self.dualquats[pair[:, 0]],
                          val[:, 1], self.dualquats[pair[:, 1]])
        return dq.transform_point(blended, points)

    def __repr__(self):
        return (f"DeformableKinematicModel(dualquats={self.dualquats}, "
                f"n_points={len(self.weights)})")
