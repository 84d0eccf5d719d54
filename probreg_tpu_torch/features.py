"""Feature generators of the L2-distance registrations (counterpart of
probreg_tpu/features.py).

Each summarizes a cloud as a Gaussian mixture (means, weights) on the
port's device:

* :class:`GMM`: a spherical mixture fit by seeded k-means (Lloyd) and EM;
* :class:`OneClassSVM`: the nu-one-class dual solved by projected gradient
  on the box-constrained simplex, each projection exact in one shot over
  all 2n breakpoints; the support vectors are the means.

:class:`FPFH` is FilterReg's feature map: 33-D histograms (ops/fpfh.py).

Both fit a batch of clouds at once, (B, N, D) with an optional (B, N)
validity mask for ragged batches: padded points never seed a centre,
carry no responsibility and hold a zero dual weight, and every normalizer
uses the true count.

The GMM's seed centres are drawn from a CPU ``torch.Generator`` seeded
with ``seed + counter`` (:func:`_seed_indices`), so CPU and CUDA runs
draw the same centres; the reference draws them with
``jax.random.choice``, so the two packages' draws differ.
"""

from __future__ import annotations

import abc
import math

import numpy as np
import torch

from . import config as _config
from .ops import pairwise


class Feature(abc.ABC):
    """A mixture generator (reference features.py:29)."""

    @abc.abstractmethod
    def init(self):
        pass

    @abc.abstractmethod
    def compute(self, data):
        ...

    def annealing(self):
        pass

    def __call__(self, data):
        return self.compute(data)


def np_prng_key(seed: int) -> np.ndarray:
    """The reference's threefry key data of ``seed`` as numpy uint32 (2,)
    (reference features.py:49). The port draws from ``torch.Generator``
    (:func:`_seed_indices`); this keeps the reference's name for code that
    passes keys across."""
    seed = int(seed)
    return np.asarray([(seed >> 32) & 0xFFFFFFFF, seed & 0xFFFFFFFF],
                      np.uint32)


def _seed_indices(seed: int, n: int, k: int, smask=None, device=None):
    """(B, k) distinct seed-centre indices in [0, n): one row for the whole
    batch when unmasked (every cloud has n points), else one row per
    cloud drawn among its valid points. Each row is drawn from a CPU
    ``torch.Generator`` seeded with ``seed``, so a cloud's draw depends on
    the seed and its own mask only."""
    if smask is None:
        gen = torch.Generator().manual_seed(int(seed))
        return torch.randperm(n, generator=gen)[:k][None].to(device)
    rows = []
    for m in smask.detach().cpu().double():
        gen = torch.Generator().manual_seed(int(seed))
        rows.append(torch.multinomial(m / m.sum(), k, replacement=False,
                                      generator=gen))
    return torch.stack(rows).to(device)


def _fit_spherical_gmm(idx, x, kmeans_iters=10, em_iters=40, smask=None):
    """Spherical GMM of each cloud of x (B, N, D) from the seed centres
    ``idx`` (B or 1, k): Lloyd iterations, then EM (reference
    features.py:63). Returns means (B, k, D) and weights (B, k)."""
    nb, n, d = x.shape
    k = idx.shape[1]
    masked = smask is not None
    n_eff = smask.sum(1) if masked else x.new_full((nb,), float(n))
    mu = torch.gather(x, 1, idx.expand(nb, k)[:, :, None].expand(nb, k, d))
    for _ in range(kmeans_iters):
        assign = pairwise.sqdist_batch(x, mu).argmin(2)
        onehot = torch.nn.functional.one_hot(assign, k).to(x.dtype)
        if masked:
            onehot = onehot * smask[:, :, None]
        counts = torch.clamp(onehot.sum(1), min=1.0)
        mu = (onehot.transpose(1, 2) @ x) / counts[:, :, None]

    pi = x.new_full((nb, k), 1.0 / k)
    if masked:
        xbar = (smask[:, None, :] @ x)[:, 0] / n_eff[:, None]
        var0 = (smask[:, :, None] * (x - xbar[:, None]) ** 2).sum((1, 2)) \
            / (n_eff * d)
    else:
        var0 = x.var(1, correction=0).mean(1)
    var = var0[:, None].expand(nb, k)
    for _ in range(em_iters):
        d2 = pairwise.sqdist_batch(x, mu)
        log_p = -0.5 * d2 / var[:, None] \
            - 0.5 * d * torch.log(2.0 * math.pi * var)[:, None] \
            + torch.log(pi)[:, None]
        r = torch.exp(log_p - torch.logsumexp(log_p, 2, keepdim=True))
        if masked:
            r = r * smask[:, :, None]
        nk = torch.clamp(r.sum(1), min=1e-10)
        mu = (r.transpose(1, 2) @ x) / nk[:, :, None]
        d2 = pairwise.sqdist_batch(x, mu)
        var = torch.clamp((r * d2).sum(1) / (d * nk), min=1e-12)
        pi = nk / n_eff[:, None]
    return mu, pi


class GMM(Feature):
    """Spherical GMM mixture extraction (reference features.py:119).

    ``init`` moves to fresh seed centres (counter + 1), as the reference's
    refit does each annealing round.
    """

    def __init__(self, n_gmm_components: int = 800, seed: int = 0,
                 em_iters: int = 40, device=None):
        self._n_gmm_components = n_gmm_components
        self._seed = seed
        self._em_iters = em_iters
        self._counter = 0
        self.device = _config.resolve_device(device)

    def init(self):
        self._counter += 1

    def compute(self, data):
        from .utils import interop

        x = interop.as_points(data, device=self.device)
        mu, pi = self.fused_fit(x[None], self.fused_static(x.shape[0]),
                                self.fused_dynamic())
        return mu[0], pi[0]

    # The hooks of a registration round (l2dist_regs): one fit of a batch
    # of clouds from (static, dynamic) settings.
    def fused_static(self, n):
        return (min(self._n_gmm_components, n), self._em_iters)

    def fused_dynamic(self):
        return (self._seed + self._counter,)

    @staticmethod
    def fused_fit(x, static, dynamic, smask=None):
        """Fit each cloud of x (B, N, D); the seed centres come from
        ``_seed_indices(seed, N, k, smask)``."""
        k, em_iters = static
        (seed,) = dynamic
        idx = _seed_indices(seed, x.shape[1], k, smask, device=x.device)
        return _fit_spherical_gmm(idx, x, em_iters=em_iters, smask=smask)


def _fit_ocsvm_dual(x, gamma, nu, iters=300, smask=None):
    """alpha of min 1/2 a^T K a s.t. 0 <= a_i <= 1 / (nu n), sum a = 1 for
    each cloud of x (B, N, D), gamma and nu (B,), scaled to libsvm's
    convention (sum = nu n) (reference features.py:160): 300 projected
    gradient steps of size 1 / ||K||_inf from the uniform point."""
    nb, n, _ = x.shape
    masked = smask is not None
    n_eff = smask.sum(1) if masked else x.new_full((nb,), float(n))
    k = torch.exp(-gamma[:, None, None] * pairwise.sqdist_batch(x, x))
    if masked:
        k = k * smask[:, :, None] * smask[:, None, :]
    c = (1.0 / (nu * n_eff))[:, None]
    pmask = smask if masked else torch.ones_like(x[:, :, 0])

    def project(v):
        # tau solves s(tau) = sum_i clip(v_i - tau, 0, c) = 1: s is
        # piecewise linear and nonincreasing with breakpoints {v_i} and
        # {v_i - c}; evaluate it at all 2n of them and interpolate on the
        # segment that crosses 1. Padded entries stay out of every sum and
        # end at 0.
        b = torch.cat([v, v - c], 1)
        clipped = torch.minimum(
            torch.clamp(v[:, None, :] - b[:, :, None], min=0.0),
            c[:, :, None])
        s = (pmask[:, None, :] * clipped).sum(2)
        valid = s >= 1.0
        b_lo = torch.where(valid, b, -math.inf).amax(1, keepdim=True)
        s_lo = (pmask * torch.minimum(torch.clamp(v - b_lo, min=0.0),
                                      c)).sum(1, keepdim=True)
        b_hi = torch.where(valid, math.inf, b).amin(1, keepdim=True)
        s_hi = (pmask * torch.minimum(torch.clamp(v - b_hi, min=0.0),
                                      c)).sum(1, keepdim=True)
        tau = b_lo + (s_lo - 1.0) * (b_hi - b_lo) / torch.clamp(
            s_lo - s_hi, min=1e-30)
        return pmask * torch.minimum(torch.clamp(v - tau, min=0.0), c)

    eta = 1.0 / k.abs().sum(2).amax(1, keepdim=True)
    alpha = project((1.0 / n_eff)[:, None] * pmask)
    for _ in range(iters):
        g = (k @ alpha[:, :, None])[:, :, 0]
        alpha = project(alpha - eta * g)
    return alpha * (nu * n_eff)[:, None]


class OneClassSVM(Feature):
    """One-class SVM mixture extraction (reference features.py:210).

    The means are the points, the weights the dual coefficients times
    z = (2 pi sigma^2)^(d / 2) where they exceed 1e-8 (0 elsewhere: the
    reference keeps all points as well, and a zero weight drops out of the
    L2 cost); gamma anneals by ``delta`` each outer round.
    """

    def __init__(self, dim: int, sigma: float, gamma: float = 0.5,
                 nu: float = 0.05, delta: float = 10.0, device=None):
        self._dim = dim
        self._sigma = sigma
        self._gamma = gamma
        self._nu = nu
        self._delta = delta
        self.device = _config.resolve_device(device)

    def init(self):
        pass

    def compute(self, data):
        from .utils import interop

        x = interop.as_points(data, device=self.device)
        mu, phi = self.fused_fit(x[None], (), self.fused_dynamic())
        return mu[0], phi[0]

    def annealing(self):
        self._gamma *= self._delta

    def fused_static(self, n):
        return ()

    def fused_dynamic(self):
        """(gamma, nu, z), float32 scalars as the reference passes them."""
        z = np.power(2.0 * np.pi * self._sigma ** 2, self._dim * 0.5)
        return (np.float32(self._gamma), np.float32(self._nu),
                np.float32(z))

    @staticmethod
    def fused_fit(x, static, dynamic, smask=None):
        """Fit each cloud of x (B, N, D); ``dynamic`` holds gamma, nu and z
        as scalars or (B,) values."""
        del static
        nb = x.shape[0]
        gamma, nu, z = (torch.as_tensor(a, dtype=x.dtype,
                                        device=x.device).reshape(-1)
                        .expand(nb) for a in dynamic)
        alpha = _fit_ocsvm_dual(x, gamma, nu, smask=smask)
        return x, alpha * z[:, None] * (alpha > 1e-8)


class FPFH(Feature):
    """Fast Point Feature Histograms, 33-D (reference features.py:263): the
    descriptor of ``ops/fpfh`` on the port's device. Used as FilterReg's
    ``feature_fn``: ``compute`` takes a cloud and returns (N, 33)."""

    def __init__(self, radius_normal: float = 0.1,
                 radius_feature: float = 0.5, max_nn_normal: int = 30,
                 max_nn_feature: int = 100, device=None):
        self._radius_normal = radius_normal
        self._radius_feature = radius_feature
        self._max_nn_normal = max_nn_normal
        self._max_nn_feature = max_nn_feature
        self.device = device

    def init(self):
        pass

    def _points(self, data):
        from .utils import interop

        if isinstance(data, torch.Tensor) and self.device is None:
            return data.to(torch.float32)
        return interop.as_points(data, dtype=torch.float32,
                                 device=self.device)

    def estimate_normals(self, points):
        """(N, 3) normals of a cloud (the reference sets them on its Open3D
        cloud; here they are returned)."""
        from .ops import fpfh as fpfh_ops

        return fpfh_ops.estimate_normals(
            self._points(points), radius=self._radius_normal,
            max_nn=self._max_nn_normal)

    def compute(self, data):
        from .ops import fpfh as fpfh_ops

        return fpfh_ops.fpfh(
            self._points(data), radius_normal=self._radius_normal,
            radius_feature=self._radius_feature,
            max_nn_normal=self._max_nn_normal,
            max_nn_feature=self._max_nn_feature)
