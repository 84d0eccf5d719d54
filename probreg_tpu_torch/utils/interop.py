"""Host-boundary conversion helpers (counterpart of probreg_tpu/utils/interop.py).

``as_points`` turns point-cloud-ish input (numpy, lists, tensors, Open3D
clouds when Open3D is installed) into a tensor on the port's device. The
carry-across functions build the port's objects from the JAX package's
state given as numpy, so both packages can start from the same state.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Mapping, Optional

import numpy as np
import torch

from .. import config as _config

try:  # pragma: no cover - open3d is optional
    import open3d as _o3
except ImportError:  # pragma: no cover
    _o3 = None


def has_open3d() -> bool:
    return _o3 is not None


def maybe_o3_roundtrip(points, original):
    """``points`` in the container type of ``original``: an Open3D
    ``Vector3dVector`` in gives one out (as the reference's
    ``Transformation.transform`` does), anything else the points as
    they are."""
    if _o3 is not None and isinstance(original, _o3.utility.Vector3dVector):
        return _o3.utility.Vector3dVector(
            np.asarray(torch.as_tensor(points).cpu(), dtype=np.float64))
    return points


def as_points(x: Any, dtype=None, device=None) -> torch.Tensor:
    """Convert point-cloud-ish input to an (N, D) tensor on ``device``.

    ``device`` defaults to ``config.device`` and is checked by
    :func:`probreg_tpu_torch.config.resolve_device` (no silent CPU run).
    """
    dtype = dtype or _config.config.dtype
    dev = _config.resolve_device(device)
    if _o3 is not None:
        if isinstance(x, _o3.geometry.PointCloud):
            x = np.asarray(x.points)
        elif isinstance(x, _o3.utility.Vector3dVector):
            x = np.asarray(x)
    if isinstance(x, torch.Tensor):
        return x.to(device=dev, dtype=dtype)
    return torch.as_tensor(np.asarray(x), dtype=dtype, device=dev)


def as_normals(x: Any, dtype=None, device=None) -> Optional[torch.Tensor]:
    """Normals as an (N, D) tensor on ``device``: None stays None, an Open3D
    cloud gives its ``normals``, anything else goes through ``as_points``
    (reference interop.py:66)."""
    if x is None:
        return None
    if _o3 is not None and isinstance(x, _o3.geometry.PointCloud):
        x = np.asarray(x.normals)
    return as_points(x, dtype=dtype, device=device)


def pad_ragged(clouds, dtype=None, device=None):
    """Stack clouds of different lengths into (B, max_N, D) and (B, max_N)
    0/1 masks, both tensors on ``device``.

    The padded rows are zeros with mask 0; the batch entry points route
    masked inputs through E-steps where padded points carry no posterior
    mass (the same registration as each pair without its padding).
    """
    dtype = dtype or _config.config.dtype
    arrs = [as_points(c, dtype=dtype, device="cpu") for c in clouds]
    nmax = max(a.shape[0] for a in arrs)
    out = torch.zeros((len(arrs), nmax, arrs[0].shape[1]), dtype=dtype)
    mask = torch.zeros((len(arrs), nmax), dtype=dtype)
    for i, a in enumerate(arrs):
        out[i, :a.shape[0]] = a
        mask[i, :a.shape[0]] = 1.0
    dev = _config.resolve_device(device)
    return out.to(dev), mask.to(dev)


def rigid_from_reference(params: Mapping[str, Any], device=None):
    """Port RigidTransformation from a JAX one's parameters as numpy.

    ``params`` holds ``rot`` (D, D), ``t`` (D,) and optionally ``scale``,
    e.g. ``{k: np.asarray(getattr(tr, k)) for k in ("rot", "t", "scale")}``.
    """
    from ..models.transformation import RigidTransformation

    rot = np.asarray(params["rot"])
    return RigidTransformation(rot, np.asarray(params["t"]),
                               float(np.asarray(params.get("scale", 1.0))),
                               dim=rot.shape[0], device=device)


def affine_from_reference(params: Mapping[str, Any], device=None):
    """Port AffineTransformation from a JAX one's parameters as numpy:
    ``params`` holds ``b`` (D, D) and ``t`` (D,)."""
    from ..models.transformation import AffineTransformation

    b = np.asarray(params["b"])
    return AffineTransformation(b, np.asarray(params["t"]), dim=b.shape[0],
                                device=device)


def combined_from_reference(params: Mapping[str, Any], device=None):
    """Port CombinedTransformation from a JAX one's parameters as numpy:
    ``params`` holds ``rot`` (D, D), ``t`` (D,), ``scale`` and ``v`` (the
    (M, D) displacement field), e.g. ``rot``, ``t``, ``scale`` of its
    ``rigid_trans`` and its ``v``."""
    from ..models.transformation import CombinedTransformation

    rot = np.asarray(params["rot"])
    return CombinedTransformation(
        rot, np.asarray(params["t"]), float(np.asarray(params["scale"])),
        np.asarray(params["v"]), dim=rot.shape[0], device=device)


def nonrigid_from_reference(params: Mapping[str, Any], device=None):
    """Port a nonrigid CPD transformation from a JAX one's parameters as
    numpy: ``params`` holds ``w`` (M, D) and ``g`` (M, M) for a
    NonRigidTransformation, or ``zc`` (K, D), ``u`` (M, K) and ``lam``
    (K,) for a LowRankNonRigidTransformation, e.g. ``{k:
    np.asarray(getattr(tr, k)) for k in ("zc", "u", "lam")}``."""
    from ..models import transformation as tf

    if {"w", "g"} <= set(params):
        return tf.NonRigidTransformation(np.array(params["w"]),
                                         g=np.array(params["g"]),
                                         device=device)
    if {"zc", "u", "lam"} <= set(params):
        return tf.LowRankNonRigidTransformation(
            *(np.array(params[k]) for k in ("zc", "u", "lam")),
            device=device)
    raise ValueError("nonrigid_from_reference needs w, g (dense) or zc, u, "
                     f"lam (low-rank); got {sorted(params)}")


def deformable_from_reference(model, device=None):
    """Port DeformableKinematicModel from a JAX one: its ``dualquats``
    (n_nodes, 8) and its skinning weights' ``pair`` and ``val`` (P, 2),
    read with ``np.asarray``."""
    from ..models.transformation import DeformableKinematicModel as Dkm

    w = model.weights
    return Dkm(torch.tensor(np.array(model.dualquats),
                            dtype=_config.config.dtype),
               Dkm.SkinningWeight(np.array(w.pair), np.array(w.val)),
               device=_config.resolve_device(device))


def gmmtree_nodes_from_reference(pi, mu, cov, device=None):
    """A GMMTree's node tensors (pi (T,), mu (T, 3), cov (T, 3, 3)) from a
    tree the JAX package built, given as numpy (e.g. ``np.asarray`` of each
    of its ``GMMTree._nodes``), so that both packages register against the
    same tree. Returns the tuple ``GMMTree._nodes`` holds."""
    dev = _config.resolve_device(device)
    return tuple(torch.tensor(np.array(a), dtype=_config.config.dtype,
                              device=dev) for a in (pi, mu, cov))


def config_from_reference(fields: Mapping[str, Any]) -> "_config.Config":
    """Port Config carrying the JAX Config's fields that exist in both.

    ``fields`` is e.g. ``dataclasses.asdict(probreg_tpu.config.config)``.
    Fields of the JAX Config the port does not have (TPU-only knobs) and
    ``dtype`` (a JAX dtype object) are left out; ``cpd_stash_max_bytes``
    becomes ``stash_max_bytes`` (the same cap on the CPD stash);
    ``matmul_dtype`` and ``stash_dtype`` become the torch dtype of the
    same name (float32 or bfloat16); every other field keeps the port's
    default.
    """
    own = {f.name for f in dataclasses.fields(_config.Config)}
    kept = {_RENAMED.get(k, k): v for k, v in fields.items()}
    for k in _DTYPES:
        if k in kept:
            kept[k] = _torch_dtype(kept[k])
    return _config.Config(**{k: v for k, v in kept.items()
                             if k in own and k != "dtype"})


# JAX Config fields that the port keeps under another name.
_RENAMED = {"cpd_stash_max_bytes": "stash_max_bytes"}
# JAX Config fields that hold a dtype, carried as the torch dtype.
_DTYPES = ("matmul_dtype", "stash_dtype")


def _torch_dtype(dtype) -> torch.dtype:
    """float32 or bfloat16 from a JAX / numpy dtype, its name or a torch
    dtype."""
    if isinstance(dtype, torch.dtype):
        return dtype
    name = str(np.dtype(dtype)) if not isinstance(dtype, str) else dtype
    out = {"float32": torch.float32, "bfloat16": torch.bfloat16}.get(name)
    if out is None:
        raise ValueError(f"no torch counterpart for dtype {dtype!r}: the "
                         "port takes float32 or bfloat16")
    return out


def tps_from_reference(params: Mapping[str, Any], device=None):
    """Port TPSTransformation from a JAX one's parameters as numpy.

    ``params`` holds ``a`` (d + 1, d), ``v`` (N - d - 1, d),
    ``control_pts`` (N, d) and ``null_basis`` (N, N - d - 1): the columns
    past d + 1 of U of the reference's own full SVD of [1, control_pts]
    (``jnp.linalg.svd(pn, full_matrices=True)[0][:, d + 1:]``), the basis
    its ``v`` is expressed in. Those columns belong to zero singular
    values, so the port's SVD may return another orthonormal basis pp of
    the same null space; ``v`` is carried across as pp^T pp_ref v_ref,
    which moves every point exactly as the reference's does (both bases
    span one space, so pp pp^T pp_ref = pp_ref).
    """
    from ..models.transformation import TPSTransformation, null_basis

    dev = _config.resolve_device(device)
    f64 = dict(dtype=torch.float64, device=dev)
    ctrl = torch.as_tensor(np.asarray(params["control_pts"]), **f64)
    pp = null_basis(ctrl.to(_config.config.dtype)).double()
    v = pp.T @ (torch.as_tensor(np.asarray(params["null_basis"]), **f64)
                @ torch.as_tensor(np.asarray(params["v"]), **f64))
    return TPSTransformation(np.asarray(params["a"]), v.to(_config.config.dtype),
                             ctrl.to(_config.config.dtype), device=dev)
