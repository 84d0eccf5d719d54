"""Frame-to-frame tracking: warm-started sequence registration.

Counterpart of probreg_tpu/tracking.py. A :class:`RigidTracker` registers
each incoming frame against the previous one (or against a keyframe),
seeding every solve with the last frame's transform and converged
variance, so after the first frame the EM never revisits the dense
start-temperature regime: on a CUDA device each solve of a small 3-D pair
is one launch of the whole-loop kernel (K1 for CPD, K5 for FilterReg, K7
for ICP). A :class:`NonrigidTracker` registers a fixed template onto every
frame with BCPD, carrying the whole final VI state from one frame to the
next.

The pose and the carried state stay on the host in float64 numpy, as in
the reference; each frame goes to the device once, and each solve's result
comes back in one read.
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import numpy as np
import torch

from . import config as _config
from .models import transformation as tf
from .utils import interop
from .utils import math_utils as mu

__all__ = ["RigidTracker", "NonrigidTracker"]


def _nn_rmse_sub(a: np.ndarray, b: np.ndarray, max_pts: int = 512) -> float:
    """Subsampled nearest-neighbour RMSE on the host, O(max_pts^2)
    (reference tracking.py:33): the re-key monitor, a strided subsample of
    both clouds."""
    sa = a[:: max(1, a.shape[0] // max_pts)]
    sb = b[:: max(1, b.shape[0] // max_pts)]
    d2 = ((sa[:, None, :] - sb[None, :, :]) ** 2).sum(-1)
    return float(np.sqrt(d2.min(axis=1).mean()))


def _host(device, *values) -> np.ndarray:
    """Tensors (or numbers) flattened and concatenated on the host in
    float64: one device-to-host copy."""
    return torch.cat([torch.as_tensor(x, dtype=torch.float64,
                                      device=device).reshape(-1)
                      for x in values]).cpu().numpy()


def _pose(host: np.ndarray, dim: int):
    """(rot, t, the rest) of a flat host vector [rot; t; ...]."""
    return (host[:dim * dim].reshape(dim, dim),
            host[dim * dim:dim * dim + dim], host[dim * dim + dim:])


class RigidTracker:
    """Tracks a rigid pose through a sequence of point-cloud frames
    (reference tracking.py:46).

    Args:
        algorithm: 'cpd' (default), 'filterreg' or 'icp'.
        mode: 'frame_to_frame' registers consecutive frames and composes
            the increments into the world pose; 'keyframe' registers the
            current keyframe (initially the first frame) against every new
            frame, re-keying automatically (below).
        rekey_rmse: Keyframe mode only: promote the current frame to
            keyframe when the solve's subsampled NN-RMSE exceeds this.
            'auto' (default) uses max(4x the first keyframe solve's RMSE,
            2% of the first frame's bounding-box diagonal); a float is an
            absolute threshold, None disables. ``n_rekeys`` counts them.
        sigma2_inflation: Multiplier on the carried variance (the new frame
            moved). 1 disables.
        sigma2_floor_frac: Per-frame floor on the carried variance as a
            fraction of the dense start temperature (squared_kernel_sum of
            the pair, on the host). 0 disables.
        device: Device to run on (default ``config.device``, "cuda"). A
            missing CUDA device raises instead of running on the CPU.
        **kwargs: Forwarded to the ``registration_*`` call (maxiter, tol,
            w, sigma2_decay, trim_fraction, ...). CPD runs
            ``update_scale=False`` and FilterReg ``sigma2_decay=0.9``
            unless given; ``n_starts`` applies to the first solve only.

    Usage::

        trk = RigidTracker(maxiter=30, tol=1e-6)
        for frame in frames:                      # (N, 3) arrays
            pose = trk.update(frame)              # RigidTransformation
        # pose maps frame 0's coordinates onto the latest frame.
    """

    def __init__(self, algorithm: str = "cpd",
                 mode: str = "frame_to_frame",
                 sigma2_inflation: float = 2.0,
                 sigma2_floor_frac: float = 1.0e-3,
                 rekey_rmse="auto",
                 device=None,
                 **kwargs: Any):
        if algorithm not in ("cpd", "filterreg", "icp"):
            raise ValueError("algorithm must be 'cpd', 'filterreg' or "
                             f"'icp'; got {algorithm!r}")
        if mode not in ("frame_to_frame", "keyframe"):
            raise ValueError("mode must be 'frame_to_frame' or 'keyframe'; "
                             f"got {mode!r}")
        reserved = {"tf_init_params"}
        if algorithm == "cpd":
            reserved.add("sigma2_init")
        elif algorithm == "filterreg":
            reserved.add("sigma2")
        bad = sorted(set(kwargs) & reserved)
        if bad:
            raise ValueError(
                f"RigidTracker drives {bad} itself (the warm pose/variance "
                "carry); they cannot be overridden per construction.")
        if algorithm == "icp" and "n_starts" in kwargs:
            raise ValueError("ICP has no orientation multistart; n_starts "
                             "is supported for algorithm='cpd'/'filterreg'")
        self.device = _config.resolve_device(device)
        self.algorithm = algorithm
        self.mode = mode
        self.sigma2_inflation = float(sigma2_inflation)
        self.sigma2_floor_frac = float(sigma2_floor_frac)
        self.rekey_rmse = rekey_rmse
        self.kwargs = dict(kwargs)
        self.reset()

    @property
    def pose(self) -> tf.RigidTransformation:
        """World pose: maps frame 0's coordinates onto the latest frame."""
        if self._pose_rot is None:
            raise RuntimeError("no frames tracked yet")
        return tf.RigidTransformation(self._pose_rot, self._pose_t,
                                      device=self.device)

    def reset(self) -> None:
        """Forget all state (the next update() starts a new sequence)."""
        self._prev = None        # registration source: (host, device)
        self._pose_rot = None
        self._pose_t = None
        self._tf_init: Optional[Dict] = None
        self._sigma2: Optional[float] = None
        self._key_rot = None
        self._key_t = None
        self._rekey_threshold: Optional[float] = None
        self.n_rekeys = 0
        self.n_frames = 0

    def _register(self, source, target):
        """One warm solve; returns (rot, t, scale) and the carried
        (tf_init, sigma2), all on the host."""
        dim, dev = source.shape[1], self.device
        if self.algorithm == "cpd":
            from . import cpd as _cpd

            kw = {"update_scale": False, **self.kwargs}
            if self._tf_init is not None:
                kw.pop("n_starts", None)
            res = _cpd.registration_cpd(
                source, target, "rigid", tf_init_params=self._tf_init,
                sigma2_init=self._sigma2, device=self.device, **kw)
            trr = res.transformation
            rot, t, (scale, s2) = _pose(_host(dev, trr.rot, trr.t, trr.scale,
                                              res.sigma2), dim)
            carry_tf = {"rot": rot, "t": t, "scale": float(scale)}
            carry_s2 = float(s2) * self.sigma2_inflation
        elif self.algorithm == "filterreg":
            from . import filterreg as _frg

            # Each solve should converge: anneal unless told otherwise.
            kw = {"sigma2_decay": 0.9, **self.kwargs}
            if self._tf_init is not None:
                kw.pop("n_starts", None)
            res = _frg.registration_filterreg(
                source, target, sigma2=self._sigma2,
                tf_init_params=self._tf_init or {}, device=self.device,
                **kw)
            trr = res.transformation
            extra = () if res.sigma2 is None else (res.sigma2,)
            rot, t, rest = _pose(_host(dev, trr.rot, trr.t, *extra), dim)
            scale = 1.0
            carry_tf = {"rot": rot, "t": t}
            # With a fixed sigma2 the result echoes the input; inflating it
            # would compound every frame: inflate only when it evolved.
            evolving = kw.get("update_sigma2", False) \
                or kw.get("sigma2_decay", 1.0) < 1.0
            carry_s2 = None
            if extra:
                carry_s2 = float(rest[0])
                if evolving:
                    carry_s2 *= self.sigma2_inflation
        else:
            from . import icp as _icp

            res = _icp.registration_icp(
                source, target, tf_init_params=self._tf_init or {},
                device=self.device, **self.kwargs)
            trr = res.transformation
            rot, t, _ = _pose(_host(dev, trr.rot, trr.t), dim)
            scale = 1.0
            carry_tf = {"rot": rot, "t": t}
            carry_s2 = None
        return (rot, t, scale), carry_tf, carry_s2

    def update(self, frame) -> tf.RigidTransformation:
        """Ingest the next frame; returns the updated world pose."""
        pts = np.asarray(interop.as_points(frame, device="cpu"))
        cur = (pts, torch.as_tensor(pts, device=self.device))
        if self._prev is None:
            dim = pts.shape[1]
            self._prev = cur
            self._pose_rot = np.eye(dim)
            self._pose_t = np.zeros(dim)
            self._key_rot = np.eye(dim)
            self._key_t = np.zeros(dim)
            self.n_frames = 1
            return self.pose
        if self._sigma2 is not None and self.sigma2_floor_frac > 0.0:
            floor = self.sigma2_floor_frac \
                * mu.squared_kernel_sum_np(self._prev[0], pts)
            self._sigma2 = max(self._sigma2, floor)
        (rot, t, scale), carry_tf, carry_s2 = self._register(self._prev[1],
                                                             cur[1])
        rekeyed = False
        if self.mode == "frame_to_frame":
            # The increment maps prev -> current; the world pose composes
            # on top.
            self._pose_rot = rot @ self._pose_rot
            self._pose_t = rot @ self._pose_t + t
            self._prev = cur
        else:
            # The solve maps keyframe -> frame; the world pose composes on
            # the keyframe's own (identity until a re-key).
            self._pose_rot = rot @ self._key_rot
            self._pose_t = rot @ self._key_t + t
            rekeyed = self._maybe_rekey(rot, t, scale, cur)
        if not rekeyed:
            self._tf_init = carry_tf
            self._sigma2 = carry_s2
        self.n_frames += 1
        return self.pose

    def _maybe_rekey(self, rot, t, scale, cur) -> bool:
        """Auto re-key (reference tracking.py:255): when the keyframe
        solve's NN-RMSE degrades past the threshold, the current frame
        becomes the keyframe and the warm carry is dropped. Returns True if
        it re-keyed."""
        if self.rekey_rmse is None:
            return False
        key = self._prev[0].astype(np.float64)
        rmse = _nn_rmse_sub((scale * key @ rot.T + t).astype(np.float32),
                            cur[0])
        if self._rekey_threshold is None:
            if self.rekey_rmse == "auto":
                diag = float(np.linalg.norm(key.max(0) - key.min(0)))
                self._rekey_threshold = max(4.0 * rmse, 0.02 * diag)
            else:
                self._rekey_threshold = float(self.rekey_rmse)
        if rmse <= self._rekey_threshold:
            return False
        self._prev = cur
        self._key_rot = self._pose_rot.copy()
        self._key_t = self._pose_t.copy()
        self._tf_init = None
        self._sigma2 = None
        self.n_rekeys += 1
        return True


class NonrigidTracker:
    """Tracks a deforming cloud against a fixed template with warm BCPD
    (reference tracking.py:283).

    The template (the first frame) is registered onto every incoming frame
    with :func:`probreg_tpu_torch.bcpd.registration_bcpd`, each solve
    warm-started with the previous solve's whole final VI iterate: rigid
    parameters, the (M, D) displacement field, the variance, the mixing
    weights alpha and diag(Sigma), all per template row, so valid while the
    template is fixed. Template mode is the only mode.

    Args:
        sigma2_inflation: Multiplier on the carried variance. 1 disables.
        sigma2_floor_frac: Per-frame floor on the carried variance as a
            fraction of the dense start temperature (see RigidTracker).
        device: Device to run on (default ``config.device``, "cuda").
        **kwargs: Forwarded to registration_bcpd (maxiter, tol, lmd, k,
            gamma, rank, w, normalize, n_starts; ``n_starts`` applies to the
            first registered frame only).

    Usage::

        trk = NonrigidTracker(maxiter=30, tol=1e-4, lmd=10.0, rank=48)
        for frame in frames:                     # (N_k, 3) arrays
            transf = trk.update(frame)           # CombinedTransformation
        # transf.transform(template) lands on the latest frame.
    """

    _RESERVED = ("callbacks", "callback_chunk", "return_last",
                 "tf_init_params", "v_init", "sigma2_init",
                 "_alpha_init", "_sdiag_init", "device")

    def __init__(self, sigma2_inflation: float = 2.0,
                 sigma2_floor_frac: float = 1.0e-3, device=None,
                 **kwargs: Any):
        bad = sorted(set(kwargs) & set(self._RESERVED))
        if bad:
            raise ValueError(
                f"NonrigidTracker drives {bad} itself (the warm VI-state "
                "carry and the per-frame result fetch); they cannot be "
                "overridden per construction.")
        self.device = _config.resolve_device(device)
        self.sigma2_inflation = float(sigma2_inflation)
        self.sigma2_floor_frac = float(sigma2_floor_frac)
        self.kwargs = dict(kwargs)
        self.reset()

    def reset(self) -> None:
        self.template: Optional[np.ndarray] = None
        self.transformation = None   # latest CombinedTransformation
        self._warm: Optional[Dict] = None
        self._last_sigma2: Optional[float] = None
        self.n_frames = 0

    def _floored(self, s2, pts) -> float:
        """The carried variance inflated, then floored (the floor only
        when enabled)."""
        s2 = s2 * self.sigma2_inflation
        if self.sigma2_floor_frac > 0.0:
            s2 = max(s2, self.sigma2_floor_frac
                     * mu.squared_kernel_sum_np(self.template, pts))
        return s2

    def update(self, frame):
        """Ingest the next frame; returns the template -> frame
        transformation."""
        from . import bcpd as _bcpd

        pts = np.asarray(interop.as_points(frame, device="cpu"))
        if self.template is None:
            dim = pts.shape[1]
            self.template = pts
            self.transformation = tf.CombinedTransformation(
                np.eye(dim), np.zeros(dim), 1.0, np.zeros_like(pts),
                dim=dim, device=self.device)
            self.n_frames = 1
            return self.transformation
        warm = dict(self._warm or {})
        if warm.get("sigma2_init") is not None:
            warm["sigma2_init"] = self._floored(warm["sigma2_init"], pts)
        extra = {k: v for k, v in self.kwargs.items()
                 if k not in ("w", "maxiter", "tol", "normalize")}
        if self.n_frames > 1:
            # The search runs on the first registered frame only.
            extra.pop("n_starts", None)
            if not warm and self.transformation is not None:
                # The search returns no VI state: seed this frame from the
                # recovered pose and displacement field (and the winner's
                # variance), so the found orientation is kept.
                rt, dim = self.transformation.rigid_trans, pts.shape[1]
                rot, t, rest = _pose(_host(self.device, rt.rot, rt.t,
                                           rt.scale, self.transformation.v),
                                     dim)
                warm = {
                    "tf_init_params": {"rot": rot, "t": t,
                                       "scale": float(rest[0])},
                    "v_init": rest[1:].reshape(-1, dim),
                }
                if self._last_sigma2 is not None:
                    warm["sigma2_init"] = self._floored(self._last_sigma2,
                                                        pts)
        res, s2f, last, _ = _bcpd._registration_bcpd_impl(
            self.template, pts, w=self.kwargs.get("w", 0.0),
            maxiter=self.kwargs.get("maxiter", 50),
            tol=self.kwargs.get("tol", 1.0e-3), callbacks=[],
            normalize=self.kwargs.get("normalize", True), callback_chunk=1,
            return_last=True, device=self.device, **{**extra, **warm})
        self.transformation = res
        self._warm = last    # the whole raw-frame VI state, or None
        self._last_sigma2 = None if s2f is None else float(s2f)
        self.n_frames += 1
        return res
