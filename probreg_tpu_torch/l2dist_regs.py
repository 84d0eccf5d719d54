"""L2-distance registrations: GMMReg and SVR (counterpart of
probreg_tpu/l2dist_regs.py).

Both clouds are summarized as Gaussian mixtures by a feature generator
(:mod:`probreg_tpu_torch.features`: a GMM or a one-class SVM); the L2
distance between the mixtures is minimized with BFGS over the transform's
parameters (:mod:`probreg_tpu_torch.cost_functions`: a rigid quaternion
and translation, or a thin-plate spline); an outer annealing loop scales
sigma by delta each round.

``optimizer`` keeps the reference's values, so user calls port unchanged:

* ``"jax"`` (the default) names the on-device route: each round fits the
  source and the target and runs the batched BFGS of ``ops/bfgs.py`` over
  the starts (``n_starts``), all on the device, with one host read of the
  round's result. A feature generator without ``fused_fit`` (the sharded
  fits of ``parallel/sharded.py``) takes the reference's second on-device
  route instead: its ``compute()`` mixtures of the source and the target,
  then the BFGS from the one warm start (``_jax_optimizer``);
* any other value, or any callback, runs the host route: scipy's BFGS
  (``jac=True``) on ``cost_fn.__call__``, whose value and gradient are
  computed on the device; only theta and that pair cross to the host.

The batch entry points run B pairs x S starts as one batched solve, the
annealing rounds unrolled (``maxiter``), ragged batches with masks.
"""

from __future__ import annotations

import logging
from typing import Any, Callable, List

import numpy as np
import torch
from scipy.optimize import minimize

from . import config as _config
from . import cost_functions as cf
from . import features as ft
from .log import log
from .models import transformation as tf
from .ops import bfgs
from .utils import interop

# Strided-subsample cap of the raw-point rescoring of multistart results
# (reference l2dist_regs.py:33).
_RESCORE_MAX_POINTS = 1024


def _host(x) -> np.ndarray:
    """A cloud as a host numpy array, its dtype kept."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    if interop._o3 is not None and isinstance(
            x, interop._o3.geometry.PointCloud):
        return np.asarray(x.points)
    return np.asarray(x)


def _rows(a: torch.Tensor, s: int) -> torch.Tensor:
    """(B, ...) -> (B S, ...): each pair's row repeated for its S starts."""
    return a[:, None].expand(a.shape[0], s, *a.shape[1:]).reshape(
        a.shape[0] * s, *a.shape[1:])


def _bfgs_solve(obj, x0, args, opt_maxiter, opt_tol):
    """One batched BFGS solve of ``obj(x, *args)`` from the rows of x0,
    with f32 conditioning for the rigid cost (reference
    l2dist_regs.py:36).

    The raw rigid objective is O(1e2) with O(1e4) translation gradients at
    small sigma (the 1/z normalizer), so the first unit-Hessian step
    overshoots by orders of magnitude and the line search exhausts its
    zoom in f32. Conditioning: the translation in units of sigma, and the
    objective times z / |sum phi_s sum phi_t|, which cancels 1/z and
    normalizes the mixture masses (OCSVM weights are unnormalized dual
    coefficients). The returned (x, fun) are in the original scaling.
    """
    if obj is not cf.RigidCostFunction.batch_objective:
        r = bfgs.minimize(lambda x: obj(x, *args), x0, maxiter=opt_maxiter,
                          gtol=opt_tol)
        return r.x, r.fun
    mu_s, phi_s, _, phi_t, sigma = args[:5]
    d = mu_s.shape[-1]
    z = (2.0 * np.pi * sigma * sigma) ** (d * 0.5)
    c = z / torch.clamp((phi_s.sum(1) * phi_t.sum(1)).abs(), min=1e-30)
    scale = torch.cat([torch.ones_like(x0[:, :4]),
                       sigma[:, None].expand(-1, x0.shape[1] - 4)], 1)
    r = bfgs.minimize(lambda y: c * obj(y * scale, *args), x0 / scale,
                      maxiter=opt_maxiter, gtol=opt_tol)
    return r.x * scale, r.fun / c


def _rescore_and_polish(xs, src, tgt, sigma, opt_maxiter, opt_tol,
                        smask=None, tmask=None):
    """Pick each pair's start among its multistart results xs (B, S, 7) by
    the RAW-point mixture L2, then polish it (reference
    l2dist_regs.py:75).

    The per-start values come from the fitted features, and a poor fit can
    score a flipped pose below the true one; the raw clouds (strided to at
    most 1,024 points, uniform weights over the valid points) rescore
    every start, a NaN score never wins, and a short BFGS on that same raw
    objective polishes the winner. Returns (x (B, 7), fun (B,)).
    """
    ss = max(1, -(-src.shape[1] // _RESCORE_MAX_POINTS))
    st = max(1, -(-tgt.shape[1] // _RESCORE_MAX_POINTS))
    s, t = src[:, ::ss], tgt[:, ::st]
    if smask is None:
        phi_s = s.new_full(s.shape[:2], 1.0 / s.shape[1])
        phi_t = t.new_full(t.shape[:2], 1.0 / t.shape[1])
    else:
        sm, tm = smask[:, ::ss], tmask[:, ::st]
        phi_s = sm / torch.clamp(sm.sum(1, keepdim=True), min=1.0)
        phi_t = tm / torch.clamp(tm.sum(1, keepdim=True), min=1.0)
    nb, ns = xs.shape[:2]
    args = (s, phi_s, t, phi_t, sigma)
    robj = cf.RigidCostFunction.batch_objective
    scores = robj(xs.reshape(nb * ns, -1),
                  *(_rows(a, ns) for a in args)).reshape(nb, ns)
    scores = torch.where(torch.isnan(scores), torch.inf, scores)
    best = xs[torch.arange(nb, device=xs.device), scores.argmin(1)]
    return _bfgs_solve(robj, best, args, opt_maxiter, opt_tol)


class L2DistRegistration:
    """L2 distance registration (reference l2dist_regs.py:111).

    Args:
        source: Source point cloud data.
        feature_gen: Mixture generator (features.Feature).
        cost_fn: Cost function (cost_functions.CostFunction).
        sigma: Scaling parameter for the L2 distance.
        delta: Annealing factor applied to sigma per outer round.
        use_estimated_sigma: Estimate sigma from the source covariance.
        optimizer: "jax" for the on-device batched BFGS (the reference's
            name of its in-program route), anything else for scipy's BFGS
            on the host.
        n_starts: > 1 solves from the first n_starts poses of the
            orientation grid as well (rigid only), in one batched solve;
            the raw points pick the winner.
        device: Device to run on (default ``config.device``).
    """

    def __init__(self, source, feature_gen: ft.Feature,
                 cost_fn: cf.CostFunction, sigma: float = 1.0,
                 delta: float = 0.9, use_estimated_sigma: bool = True,
                 optimizer: str = "jax", n_starts: int = 1, device=None):
        self._device = _config.resolve_device(device)
        self._source = None if source is None else _host(source)
        self._feature_gen = feature_gen
        self._cost_fn = cost_fn
        self._sigma = sigma
        self._delta = delta
        self._use_estimated_sigma = use_estimated_sigma
        self._n_starts = int(n_starts)
        if self._n_starts > 1 and not hasattr(cost_fn, "initial_multistart"):
            raise ValueError(
                "n_starts > 1 requires a cost function with "
                "initial_multistart (rigid)")
        self._optimizer = optimizer
        self._callbacks: List[Callable] = []
        if self._source is not None and self._use_estimated_sigma:
            self._estimate_sigma(self._source)

    def set_source(self, source):
        self._source = _host(source)
        if self._use_estimated_sigma:
            self._estimate_sigma(self._source)

    def set_callbacks(self, callbacks):
        self._callbacks.extend(callbacks)

    def _estimate_sigma(self, data):
        """sigma = det(cov)^(1 / 2d) (reference l2dist_regs.py:161)."""
        data = np.asarray(data)
        ndata, dim = data.shape
        data_hat = data - np.mean(data, axis=0)
        self._sigma = np.power(
            np.linalg.det(data_hat.T @ data_hat / (ndata - 1)),
            1.0 / (2.0 * dim))

    def _annealing(self):
        self._sigma *= self._delta

    def optimization_cb(self, x):
        tf_result = self._cost_fn.to_transformation(x)
        for c in self._callbacks:
            c(tf_result)

    def _fused_round(self, x0s, src, tgt, opt_maxiter: int, opt_tol: float):
        """One round on the device: fit(source) + fit(target) + the
        batched BFGS from the starts x0s (S, P); (x (P,), fun ()) of the
        best start (reference l2dist_regs.py:202)."""
        feat = self._feature_gen
        fit = type(feat).fused_fit
        dyn = feat.fused_dynamic()
        mu_s, phi_s = fit(src[None], feat.fused_static(src.shape[0]), dyn)
        mu_t, phi_t = fit(tgt[None], feat.fused_static(tgt.shape[0]), dyn)
        sigma = torch.tensor([float(self._sigma)], dtype=src.dtype,
                             device=src.device)
        ns = x0s.shape[0]
        if isinstance(self._cost_fn, cf.RigidCostFunction):
            args = tuple(_rows(a, ns) for a in (mu_s, phi_s, mu_t, phi_t,
                                                sigma))
            xs, fs = _bfgs_solve(cf.RigidCostFunction.batch_objective, x0s,
                                 args, opt_maxiter, opt_tol)
            if ns > 1:
                x, fval = _rescore_and_polish(
                    xs[None], src[None], tgt[None], sigma, opt_maxiter,
                    opt_tol)
                return x[0], fval[0]
        else:
            # The theta-independent TPS basis and kernel, once per solve.
            extra = cf.TPSCostFunction.pure_prepare(
                mu_s[0], *self._cost_fn.extra_args())
            xs, fs = _bfgs_solve(
                cf.TPSCostFunction.batch_objective, x0s,
                (mu_s[0], phi_s[0], mu_t[0], phi_t[0], sigma) + extra,
                opt_maxiter, opt_tol)
        i = fs.argmin()
        return xs[i], fs[i]

    def _jax_optimizer(self, x_ini, mu_s, phi_s, mu_t, phi_t,
                       opt_maxiter: int, opt_tol: float):
        """The BFGS of ``ops/bfgs.py`` on the device over two fitted
        mixtures, from the one start ``x_ini`` (reference
        l2dist_regs.py:178): (x (P,), fun ())."""
        dt = _config.config.dtype

        def dev_t(a):
            return torch.as_tensor(a, dtype=dt, device=self._device)

        mu_s, phi_s, mu_t, phi_t = (dev_t(a) for a in (mu_s, phi_s, mu_t,
                                                       phi_t))
        sigma = torch.tensor([float(self._sigma)], dtype=dt,
                             device=self._device)
        x0 = dev_t(x_ini)[None]
        if isinstance(self._cost_fn, cf.RigidCostFunction):
            xs, fs = _bfgs_solve(cf.RigidCostFunction.batch_objective, x0,
                                 (mu_s[None], phi_s[None], mu_t[None],
                                  phi_t[None], sigma), opt_maxiter, opt_tol)
        else:
            extra = cf.TPSCostFunction.pure_prepare(
                mu_s, *self._cost_fn.extra_args())
            xs, fs = _bfgs_solve(cf.TPSCostFunction.batch_objective, x0,
                                 (mu_s, phi_s, mu_t, phi_t, sigma) + extra,
                                 opt_maxiter, opt_tol)
        return xs[0], fs[0]

    def _start_stack(self, x_ini: np.ndarray) -> np.ndarray:
        """(S, P) starts: the warm start first, then the orientation
        grid."""
        if self._n_starts <= 1:
            return np.asarray(x_ini)[None]
        grid = self._cost_fn.initial_multistart(self._n_starts)
        return np.r_[np.asarray(x_ini)[None], grid[1:]]

    def registration(self, target, maxiter: int = 1, tol: float = 1.0e-3,
                     opt_maxiter: int = 50, opt_tol: float = 1.0e-3
                     ) -> tf.Transformation:
        """Register the source to ``target`` (reference
        l2dist_regs.py:260).

        Rigid solves run in the frame of the clouds' shared centroid
        (float64, on the host): the quaternion rotates about the origin,
        so far from it every rotation step throws the mixture away. The
        translation is converted back. TPS keeps the raw frame.
        """
        f = None
        x_ini = self._cost_fn.initial()
        target = _host(target)
        rigid_center = isinstance(self._cost_fn, cf.RigidCostFunction)
        saved_source = self._source
        if rigid_center:
            src64 = np.asarray(self._source, np.float64)
            tgt64 = np.asarray(target, np.float64)
            cen = (src64.mean(axis=0) * len(tgt64)
                   + tgt64.mean(axis=0) * len(src64)) \
                / (len(src64) + len(tgt64))
            self._source = (src64 - cen).astype(np.float32)
            target = (tgt64 - cen).astype(np.float32)
        try:
            out = self._registration_impl(target, maxiter, tol,
                                          opt_maxiter, opt_tol, x_ini, f)
        finally:
            self._source = saved_source
        if rigid_center:
            rot = out.rot.double().cpu().numpy()
            t_raw = out.t.double().cpu().numpy() + cen - rot @ cen
            out = tf.RigidTransformation(rot, t_raw, float(out.scale),
                                         device=self._device)
        return out

    def _registration_impl(self, target, maxiter, tol, opt_maxiter,
                           opt_tol, x_ini, f):
        use_jax_opt = (self._optimizer == "jax" and not self._callbacks
                       and hasattr(self._cost_fn, "batch_objective"))
        use_fused = use_jax_opt and hasattr(self._feature_gen, "fused_fit")
        dt = _config.config.dtype
        if use_fused:
            src_dev = torch.as_tensor(np.asarray(self._source), dtype=dt,
                                      device=self._device)
            tgt_dev = torch.as_tensor(np.asarray(target), dtype=dt,
                                      device=self._device)
        for _ in range(maxiter):
            self._feature_gen.init()
            if use_fused:
                x0s = torch.as_tensor(self._start_stack(x_ini), dtype=dt,
                                      device=self._device)
                rx, rf = self._fused_round(x0s, src_dev, tgt_dev,
                                           opt_maxiter, opt_tol)
                # One host read for both results.
                host = torch.cat([rx, rf[None]]).double().cpu().numpy()
                res_fun, res_x = float(host[-1]), host[:-1]
            else:
                mu_source, phi_source = self._feature_gen.compute(
                    self._source)
                mu_target, phi_target = self._feature_gen.compute(target)
                if use_jax_opt:
                    rx, rf = self._jax_optimizer(
                        x_ini, mu_source, phi_source, mu_target, phi_target,
                        opt_maxiter, opt_tol)
                    host = torch.cat([rx, rf[None]]).double().cpu().numpy()
                    res_fun, res_x = float(host[-1]), host[:-1]
                else:
                    args = (mu_source, phi_source, mu_target, phi_target,
                            self._sigma)
                    res = minimize(
                        self._cost_fn, x_ini, args=args, method="BFGS",
                        jac=True, tol=opt_tol,
                        options={"maxiter": opt_maxiter,
                                 "disp": log.level == logging.DEBUG},
                        callback=self.optimization_cb)
                    res_fun, res_x = res.fun, res.x
            self._annealing()
            self._feature_gen.annealing()
            if f is not None and abs(res_fun - f) < tol:
                break
            f = res_fun
            x_ini = res_x
        return self._cost_fn.to_transformation(res_x)


class RigidGMMReg(L2DistRegistration):
    def __init__(self, source, sigma=1.0, delta=0.9, n_gmm_components=800,
                 use_estimated_sigma=True, **kwargs):
        dev = _config.resolve_device(kwargs.get("device"))
        n_gmm_components = min(n_gmm_components, int(source.shape[0] * 0.8))
        super().__init__(source, ft.GMM(n_gmm_components, device=dev),
                         cf.RigidCostFunction(device=dev), sigma, delta,
                         use_estimated_sigma,
                         optimizer=kwargs.get("optimizer", "jax"),
                         n_starts=kwargs.get("n_starts", 1), device=dev)


class TPSGMMReg(L2DistRegistration):
    def __init__(self, source, sigma=1.0, delta=0.9, n_gmm_components=800,
                 alpha=1.0, beta=0.1, use_estimated_sigma=True, **kwargs):
        dev = _config.resolve_device(kwargs.get("device"))
        n_gmm_components = min(n_gmm_components, int(source.shape[0] * 0.8))
        super().__init__(source, ft.GMM(n_gmm_components, device=dev),
                         cf.TPSCostFunction([], alpha, beta, device=dev),
                         sigma, delta, use_estimated_sigma,
                         optimizer=kwargs.get("optimizer", "jax"),
                         n_starts=kwargs.get("n_starts", 1), device=dev)
        self._feature_gen.init()
        control_pts, _ = self._feature_gen.compute(self._source)
        self._cost_fn._control_pts = control_pts


class _SVRSigma:
    """SVR's sigma estimate also sets the OCSVM's sigma and gamma =
    1 / (2 sigma^2) (reference l2dist_regs.py:400)."""

    def _estimate_sigma(self, data):
        super()._estimate_sigma(data)
        self._feature_gen._sigma = self._sigma
        self._feature_gen._gamma = 1.0 / (2.0 * np.square(self._sigma))


class RigidSVR(_SVRSigma, L2DistRegistration):
    def __init__(self, source, sigma=1.0, delta=0.9, gamma=0.5, nu=0.1,
                 use_estimated_sigma=True, **kwargs):
        dev = _config.resolve_device(kwargs.get("device"))
        super().__init__(
            source, ft.OneClassSVM(source.shape[1], sigma, gamma, nu,
                                   device=dev),
            cf.RigidCostFunction(device=dev), sigma, delta,
            use_estimated_sigma, optimizer=kwargs.get("optimizer", "jax"),
            n_starts=kwargs.get("n_starts", 1), device=dev)


class TPSSVR(_SVRSigma, L2DistRegistration):
    def __init__(self, source, sigma=1.0, delta=0.9, gamma=0.5, nu=0.1,
                 alpha=1.0, beta=0.1, use_estimated_sigma=True, **kwargs):
        dev = _config.resolve_device(kwargs.get("device"))
        super().__init__(
            source, ft.OneClassSVM(source.shape[1], sigma, gamma, nu,
                                   device=dev),
            cf.TPSCostFunction([], alpha, beta, device=dev), sigma, delta,
            use_estimated_sigma, optimizer=kwargs.get("optimizer", "jax"),
            n_starts=kwargs.get("n_starts", 1), device=dev)
        self._feature_gen.init()
        control_pts, _ = self._feature_gen.compute(self._source)
        self._cost_fn._control_pts = control_pts


def _run_l2dist_batch(feat_cls, static_s, static_t, x0s, srcs, tgts,
                      smasks, tmasks, sigmas, dynamic, rounds, delta,
                      opt_maxiter, opt_tol):
    """B pairs x S starts: per round fit(sources) + fit(targets) + one
    batched solve (reference l2dist_regs.py:427).

    ``rounds`` > 1 unrolls the reference's annealing loop with no early
    stop: round r scales sigma by delta^r and refits the features (GMM:
    the seed of round r; OCSVM: gamma x 10^r), warm-starting from the
    previous round. The first round solves from every start; with S > 1
    the raw points pick each pair's start (``_rescore_and_polish``).
    """
    is_gmm = feat_cls is ft.GMM
    nb, ns = srcs.shape[0], x0s.shape[0]
    robj = cf.RigidCostFunction.batch_objective
    x = fval = None
    for r in range(rounds):
        if rounds > 1:
            dyn_r = (dynamic[0][r],) if is_gmm else \
                (dynamic[0] * (10.0 ** r), dynamic[1], dynamic[2])
        else:
            dyn_r = dynamic
        sigma_r = sigmas * (delta ** r)
        mu_s, phi_s = feat_cls.fused_fit(srcs, static_s, dyn_r, smask=smasks)
        mu_t, phi_t = feat_cls.fused_fit(tgts, static_t, dyn_r, smask=tmasks)
        args = (mu_s, phi_s, mu_t, phi_t, sigma_r)
        if r == 0:
            xs, fs = _bfgs_solve(robj, x0s.repeat(nb, 1),
                                 tuple(_rows(a, ns) for a in args),
                                 opt_maxiter, opt_tol)
            if ns > 1:
                x, fval = _rescore_and_polish(
                    xs.reshape(nb, ns, -1), srcs, tgts, sigma_r,
                    opt_maxiter, opt_tol, smask=smasks, tmask=tmasks)
            else:
                x, fval = xs, fs
        else:
            x, fval = _bfgs_solve(robj, x, args, opt_maxiter, opt_tol)
    return x, fval


def _batch_estimated_sigmas(sources) -> np.ndarray:
    """Per-cloud sigma = det(cov)^(1 / 2d) (reference
    l2dist_regs.py:505)."""
    b, n, d = sources.shape
    hat = sources - sources.mean(axis=1, keepdims=True)
    cov = np.einsum("bnd,bne->bde", hat, hat) / (n - 1)
    return np.power(np.linalg.det(cov), 1.0 / (2.0 * d))


def _registration_l2dist_batch(sources, targets, feature_kind: str,
                               opt_maxiter: int, opt_tol: float,
                               n_gmm_components: int, gamma, nu,
                               use_estimated_sigma: bool, sigma, seed: int,
                               n_starts: int = 1, maxiter: int = 1,
                               delta: float = 0.9, device=None
                               ) -> List[tf.Transformation]:
    """Reference l2dist_regs.py:513."""
    dev = _config.resolve_device(device)
    dt = _config.config.dtype
    ragged = isinstance(sources, (list, tuple)) \
        or isinstance(targets, (list, tuple))
    if ragged:
        raw_sources = [np.asarray(_host(s), np.float32) for s in sources]
        raw_targets = [np.asarray(_host(t), np.float32) for t in targets]
        srcs, smask = interop.pad_ragged(raw_sources, device=dev)
        tgts, tmask = interop.pad_ragged(raw_targets, device=dev)
        # The GMM component count is shared: it must not exceed ANY cloud
        # of the batch (source or target), or the masked seeding would
        # have to draw padded points.
        min_m = min(min(s.shape[0] for s in raw_sources),
                    min(t.shape[0] for t in raw_targets))
    else:
        host_s = np.asarray(_host(sources), np.float32)
        host_t = np.asarray(_host(targets), np.float32)
        if host_s.ndim != 3 or host_t.ndim != 3:
            raise ValueError("batch registration expects (B, N, D) stacks")
        srcs = torch.as_tensor(host_s, dtype=dt, device=dev)
        tgts = torch.as_tensor(host_t, dtype=dt, device=dev)
        smask = tmask = None
    b, n_s, d = srcs.shape
    n_t = tgts.shape[1]
    if use_estimated_sigma:
        if ragged:
            sigmas = np.asarray([_batch_estimated_sigmas(s[None])[0]
                                 for s in raw_sources])
        else:
            sigmas = _batch_estimated_sigmas(host_s)
    else:
        sigmas = np.full((b,), sigma, np.float64)

    if feature_kind == "gmm":
        feat_cls = ft.GMM
        # Every pair shares one component count, capped at the smallest
        # cloud when ragged (the masked seeding draws k valid points).
        cap = int((min_m if ragged else n_s) * 0.8)
        proto = ft.GMM(min(n_gmm_components, cap), device=dev)
        static_s = proto.fused_static(n_s)
        static_t = proto.fused_static(n_t)
        # The seed of the single pair's first round (counter 1), shared
        # by the batch; one per annealing round (counter 1 + r).
        seeds = [seed + 1 + r for r in range(maxiter)]
        dynamic = (seeds,) if maxiter > 1 else (seeds[0],)
    elif feature_kind == "svm":
        feat_cls = ft.OneClassSVM
        static_s = static_t = ()
        gammas = 1.0 / (2.0 * np.square(sigmas)) if use_estimated_sigma \
            else np.full((b,), gamma, np.float64)
        zs = np.power(2.0 * np.pi * np.square(sigmas), d * 0.5)
        dynamic = tuple(torch.as_tensor(np.asarray(a, np.float32),
                                        device=dev)
                        for a in (gammas, np.full((b,), nu), zs))
    else:
        raise ValueError("unknown feature kind %s" % feature_kind)

    x0s = torch.as_tensor(
        cf.RigidCostFunction.initial_multistart(max(1, n_starts)),
        dtype=dt, device=dev)
    rx, _ = _run_l2dist_batch(
        feat_cls, static_s, static_t, x0s, srcs, tgts, smask, tmask,
        torch.as_tensor(sigmas, dtype=dt, device=dev), dynamic,
        int(maxiter), float(delta), opt_maxiter, opt_tol)
    rx = rx.double().cpu().numpy()
    cost = cf.RigidCostFunction(device=dev)
    return [cost.to_transformation(rx[i]) for i in range(b)]


def registration_gmmreg_batch(sources, targets, n_gmm_components: int = 800,
                              sigma: float = 1.0,
                              use_estimated_sigma: bool = True,
                              opt_maxiter: int = 50, opt_tol: float = 1.0e-3,
                              seed: int = 0, n_starts: int = 1,
                              maxiter: int = 1, delta: float = 0.9,
                              device=None) -> List[tf.Transformation]:
    """Rigid GMMReg over B cloud pairs (reference l2dist_regs.py:603).

    ``sources`` (B, M, D) and ``targets`` (B, N, D), or lists of clouds of
    different sizes, are summarized and registered together: one batched
    fit per side and one batched BFGS of B pairs x ``n_starts`` starts
    per round. Returns B transformations, each the one its pair gets
    alone.
    """
    return _registration_l2dist_batch(
        sources, targets, "gmm", opt_maxiter, opt_tol, n_gmm_components,
        None, None, use_estimated_sigma, sigma, seed, n_starts,
        maxiter, delta, device=device)


def registration_svr_batch(sources, targets, gamma: float = 0.5,
                           nu: float = 0.1, sigma: float = 1.0,
                           use_estimated_sigma: bool = True,
                           opt_maxiter: int = 50, opt_tol: float = 1.0e-3,
                           n_starts: int = 1, maxiter: int = 1,
                           delta: float = 0.9,
                           device=None) -> List[tf.Transformation]:
    """Rigid SVR over B cloud pairs (reference l2dist_regs.py:627; see
    :func:`registration_gmmreg_batch`). ``maxiter`` > 1 unrolls the
    annealing rounds (sigma x delta, OCSVM gamma x 10 per round,
    warm-started BFGS)."""
    return _registration_l2dist_batch(
        sources, targets, "svm", opt_maxiter, opt_tol, 0, gamma, nu,
        use_estimated_sigma, sigma, 0, n_starts, maxiter, delta,
        device=device)


def registration_gmmreg(source, target, tf_type_name: str = "rigid",
                        callbacks: List = [], **kargs):
    """GMMReg (reference l2dist_regs.py:643).

    Args:
        source: Source point cloud data.
        target: Target point cloud data.
        tf_type_name: 'rigid' or 'nonrigid'.
        callbacks: Called with the current Transformation per BFGS
            iteration (the host route).
        **kargs: RigidGMMReg / TPSGMMReg settings, ``optimizer``,
            ``n_starts`` and ``device``.

    Returns:
        Transformation from source to target.
    """
    if tf_type_name == "rigid":
        gmmreg = RigidGMMReg(_host(source), **kargs)
    elif tf_type_name == "nonrigid":
        gmmreg = TPSGMMReg(_host(source), **kargs)
    else:
        raise ValueError("Unknown transform type %s" % tf_type_name)
    gmmreg.set_callbacks(callbacks)
    return gmmreg.registration(_host(target))


def registration_svr(
    source,
    target,
    tf_type_name: str = "rigid",
    maxiter: int = 1,
    tol: float = 1.0e-3,
    opt_maxiter: int = 50,
    opt_tol: float = 1.0e-3,
    callbacks: List[Callable] = [],
    **kwargs: Any,
):
    """Support Vector Registration (reference l2dist_regs.py:667).

    Args:
        source: Source point cloud data.
        target: Target point cloud data.
        tf_type_name: 'rigid' or 'nonrigid'.
        maxiter / tol: Outer annealing loop controls.
        opt_maxiter / opt_tol: Inner BFGS controls.
        callbacks: Called with the current Transformation per BFGS
            iteration (the host route).
        **kwargs: RigidSVR / TPSSVR settings, ``optimizer``, ``n_starts``
            and ``device``.

    Returns:
        Transformation from source to target.
    """
    if tf_type_name == "rigid":
        svr = RigidSVR(_host(source), **kwargs)
    elif tf_type_name == "nonrigid":
        svr = TPSSVR(_host(source), **kwargs)
    else:
        raise ValueError("Unknown transform type %s" % tf_type_name)
    svr.set_callbacks(callbacks)
    return svr.registration(_host(target), maxiter, tol, opt_maxiter,
                            opt_tol)
