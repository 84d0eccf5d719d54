"""L2-distance cost functions of GMMReg and SVR (counterpart of
probreg_tpu/cost_functions.py).

Each objective is written once on tensors and differentiated by
``torch.autograd``, as the reference differentiates its own with
``jax.value_and_grad``: the rigid cost over theta = (quaternion (4),
translation (3)), the thin-plate-spline cost over (A, V) with its bending
energy, and ``compute_l2_dist``, the reference-shaped (value, gradient with
respect to the moved means) pair. The objectives take a batch: theta (B, P)
gives (B,) values, row by row, which the batched BFGS (``ops/bfgs.py``)
minimizes.

``RigidCostFunction.initial_multistart_rots`` is also the orientation grid
that the ``n_starts > 1`` searches of CPD, FilterReg, GMMTree and BCPD
share: in 3-D the identity, then 180, +90 and -90 degrees about each axis
(up to 10 starts); in 2-D ``n_starts`` angles evenly spaced on the circle
from the identity.
"""

from __future__ import annotations

import abc
import math
from typing import Tuple

import numpy as np
import torch

from . import config as _config
from .models import transformation as tf
from .ops import bfgs, pairwise
from .utils import math_utils
from .utils import se3_op as so


def _l2_overlap(mu_source, phi_source, mu_target, phi_target, sigma):
    """-sum_ij phi_s_i phi_t_j exp(-|mu_s_i - mu_t_j|^2 / (2 sigma^2)) / z
    for each pair of a batch, z = (2 pi sigma^2)^(d / 2) (reference
    cost_functions.py:29). mu (B, K, D), phi (B, K), sigma (B,)."""
    d = mu_source.shape[-1]
    s2 = (sigma * sigma)[:, None, None]
    z = (2.0 * math.pi * sigma ** 2) ** (d * 0.5)
    k = torch.exp(-pairwise.sqdist_batch(mu_source, mu_target) / (2.0 * s2))
    return -((phi_source[:, None, :] @ k) @ phi_target[:, :, None])[:, 0, 0] \
        / z


def _batch1(*tensors):
    return tuple(t[None] for t in tensors)


def compute_l2_dist(mu_source, phi_source, mu_target, phi_target, sigma):
    """(f, df / d mu_source) of the L2 overlap of two mixtures (reference
    cost_functions.py:44), the gradient by autograd."""
    mu_source = torch.as_tensor(mu_source)
    dev = mu_source.device
    args = [torch.as_tensor(a, dtype=mu_source.dtype, device=dev)
            for a in (phi_source, mu_target, phi_target, sigma)]
    with torch.enable_grad():
        mu = mu_source.detach().requires_grad_(True)
        f = _l2_overlap(*_batch1(mu, *args[:3]), args[3].reshape(1))[0]
        (g,) = torch.autograd.grad(f, mu)
    return f.detach(), g


class CostFunction(abc.ABC):
    """A cost over a flat parameter vector theta (reference
    cost_functions.py:58). ``device`` is where ``to_transformation``
    puts its transformation (default ``config.device``)."""

    def __init__(self, device=None):
        self.device = _config.resolve_device(device)

    @abc.abstractmethod
    def to_transformation(self, theta):
        ...

    @abc.abstractmethod
    def initial(self):
        ...

    @abc.abstractmethod
    def __call__(self, theta, *args) -> Tuple[float, np.ndarray]:
        ...

    @staticmethod
    def _value_and_grad(obj, theta, args):
        """(float, float64 gradient) of ``obj`` at the host vector theta,
        computed on the device of the first argument: the host BFGS
        route moves only theta and this pair."""
        x = torch.as_tensor(np.asarray(theta), dtype=_config.config.dtype,
                            device=args[0].device)[None]
        f, g = bfgs.value_and_grad(lambda y: obj(y, *args), x)
        return float(f[0]), g[0].double().cpu().numpy()


def _rigid_obj(theta, mu_source, phi_source, mu_target, phi_target, sigma):
    """The rigid L2 cost of each row of theta (B, 7) = (q, t) against its
    pair of mixtures (reference cost_functions.py:76): the source means
    rotated by quat2mat(q) and moved by t."""
    rot = so.quat2mat(theta[:, :4])
    t_mu = mu_source @ rot.transpose(1, 2) + theta[:, None, 4:7]
    return _l2_overlap(t_mu, phi_source, mu_target, phi_target, sigma)


class RigidCostFunction(CostFunction):
    """Quaternion + translation 7-vector rigid cost (reference
    cost_functions.py:85)."""

    # The batched objective: theta (B, 7), mixtures (B, K, D) / (B, K),
    # sigma (B,) -> (B,).
    batch_objective = staticmethod(_rigid_obj)

    @staticmethod
    def pure_objective(theta, mu_source, phi_source, mu_target, phi_target,
                       sigma):
        """The cost of one theta (7,) against one pair of mixtures: a
        0-d tensor."""
        sigma = torch.as_tensor(sigma, dtype=mu_source.dtype,
                                device=mu_source.device).reshape(1)
        return _rigid_obj(*_batch1(theta, mu_source, phi_source, mu_target,
                                   phi_target), sigma)[0]

    def objective(self, theta, mu_source, phi_source, mu_target, phi_target,
                  sigma):
        return self.pure_objective(theta, mu_source, phi_source, mu_target,
                                   phi_target, sigma)

    def extra_args(self):
        return ()

    def to_transformation(self, theta):
        theta = np.asarray(theta, np.float64)
        rot = so.quat2mat_np(theta[:4]).astype(np.float32)
        return tf.RigidTransformation(rot, theta[4:7].astype(np.float32),
                                      device=self.device)

    def initial(self):
        x0 = np.zeros(7)
        x0[0] = 1.0
        return x0

    @staticmethod
    def initial_multistart(n_starts: int) -> np.ndarray:
        """(S, 7) starts: identity, then 180, +90 and -90 degrees about
        each axis (reference cost_functions.py:118)."""
        h = np.sqrt(0.5)
        quats = [(1.0, 0, 0, 0)]
        for axis in range(3):
            v = [0.0, 0.0, 0.0]
            v[axis] = 1.0
            quats.append((0.0, *v))                       # 180 deg
        for axis in range(3):
            v = [0.0, 0.0, 0.0]
            v[axis] = h
            quats.append((h, *v))                          # +90 deg
            quats.append((-h, *v))                         # -90 deg
        x0s = np.zeros((len(quats), 7))
        x0s[:, :4] = np.asarray(quats)
        if n_starts > len(quats):
            raise ValueError(f"n_starts <= {len(quats)}")
        return x0s[:n_starts]

    @staticmethod
    def initial_multistart_rots(n_starts: int, dim: int = 3) -> np.ndarray:
        """(S, D, D) float32 rotations of the grid (reference
        cost_functions.py:141): 3-D the quaternions of
        ``initial_multistart``, 2-D ``n_starts`` evenly spaced angles."""
        if dim == 2:
            angs = 2.0 * np.pi * np.arange(n_starts) / n_starts
            return np.stack([
                np.asarray([[np.cos(a), -np.sin(a)], [np.sin(a), np.cos(a)]],
                           np.float32) for a in angs])
        quats = RigidCostFunction.initial_multistart(n_starts)[:, :4]
        return np.stack([np.asarray(so.quat2mat_np(q), np.float32)
                         for q in quats])

    def __call__(self, theta, *args):
        mu_source, phi_source, mu_target, phi_target, sigma = args
        sigma = torch.as_tensor(sigma, dtype=mu_source.dtype,
                                device=mu_source.device).reshape(1)
        return self._value_and_grad(
            _rigid_obj, theta,
            _batch1(mu_source, phi_source, mu_target, phi_target) + (sigma,))


def _tps_obj(theta, control_pts, mu_source, phi_source, mu_target,
             phi_target, sigma, alpha, beta, basis=None, kernel=None):
    """The TPS L2 cost of each row of theta (B, P) = (A, V) flattened, on
    one pair of mixtures (reference cost_functions.py:165): alpha times the
    L2 distance up to a constant, -f1 + 2 f2, plus beta times the bending
    energy tr(V^T K V). ``basis`` / ``kernel`` from ``pure_prepare`` skip
    the per-evaluation ``tps_design``."""
    dim = control_pts.shape[1]
    n_a = dim * (dim + 1)
    nb = theta.shape[0]
    a = theta[:, :n_a].reshape(nb, dim + 1, dim)
    v = theta[:, n_a:].reshape(nb, -1, dim)
    if basis is None:
        basis, kernel = tf.tps_design(mu_source, control_pts,
                                      math_utils.tps_kernel)
    t_mu = basis @ torch.cat([a, v], 1)
    bending = (v * (kernel @ v)).sum((1, 2))
    sig = torch.as_tensor(sigma, dtype=theta.dtype,
                          device=theta.device).reshape(1).expand(nb)
    phi_s = phi_source.expand(nb, -1)
    f1 = _l2_overlap(t_mu, phi_s, t_mu, phi_s, sig)
    f2 = _l2_overlap(t_mu, phi_s, mu_target.expand(nb, -1, -1),
                     phi_target.expand(nb, -1), sig)
    return alpha * (-f1 + 2.0 * f2) + beta * bending


class TPSCostFunction(CostFunction):
    """TPS (A, V) cost with bending energy (reference
    cost_functions.py:188)."""

    def __init__(self, control_pts, alpha: float = 1.0, beta: float = 0.1,
                 device=None):
        super().__init__(device)
        self._alpha = alpha
        self._beta = beta
        self._control_pts = control_pts

    @staticmethod
    def batch_objective(theta, mu_source, phi_source, mu_target, phi_target,
                        sigma, control_pts, alpha, beta, basis=None,
                        kernel=None):
        """The cost of each row of theta (B, P) on one pair of mixtures:
        (B,), in the argument order of ``pure_objective``."""
        return _tps_obj(theta, control_pts, mu_source, phi_source,
                        mu_target, phi_target, sigma, alpha, beta,
                        basis=basis, kernel=kernel)

    @staticmethod
    def pure_objective(theta, mu_source, phi_source, mu_target, phi_target,
                       sigma, control_pts, alpha, beta, basis=None,
                       kernel=None):
        """The cost of one theta (P,): a 0-d tensor."""
        return _tps_obj(theta[None], control_pts, mu_source, phi_source,
                        mu_target, phi_target, sigma, alpha, beta,
                        basis=basis, kernel=kernel)[0]

    def objective(self, theta, mu_source, phi_source, mu_target, phi_target,
                  sigma):
        return self.pure_objective(theta, mu_source, phi_source, mu_target,
                                   phi_target, sigma, *self.extra_args())

    @staticmethod
    def pure_prepare(mu_source, control_pts, alpha, beta):
        """The theta-independent basis and kernel, once per solve: appended
        to the extra args, they skip the per-evaluation design (reference
        cost_functions.py:214)."""
        basis, kernel = tf.tps_design(mu_source, control_pts,
                                      math_utils.tps_kernel)
        return (control_pts, alpha, beta, basis, kernel)

    def extra_args(self):
        return (self._control_pts, float(self._alpha), float(self._beta))

    def to_transformation(self, theta):
        control_pts = torch.as_tensor(self._control_pts).detach()
        dim = control_pts.shape[1]
        n_a = dim * (dim + 1)
        theta = np.asarray(theta, np.float32)
        return tf.TPSTransformation(theta[:n_a].reshape(dim + 1, dim),
                                    theta[n_a:].reshape(-1, dim),
                                    control_pts, device=self.device)

    def initial(self):
        n, dim = tuple(self._control_pts.shape)
        a = np.r_[np.zeros((1, dim)), np.identity(dim)]
        v = np.zeros((n - dim - 1, dim))
        return np.r_[a, v].flatten()

    def __call__(self, theta, *args):
        mu_source, phi_source, mu_target, phi_target, sigma = args
        ctrl = torch.as_tensor(self._control_pts, dtype=mu_source.dtype,
                               device=mu_source.device)
        return self._value_and_grad(
            lambda x, *a: _tps_obj(x, ctrl, *a, self._alpha, self._beta),
            theta, (mu_source, phi_source, mu_target, phi_target, sigma))
