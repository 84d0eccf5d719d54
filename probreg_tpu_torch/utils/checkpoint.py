"""Checkpoint and resume of registration state (counterpart of
probreg_tpu/utils/checkpoint.py).

A state is a tree of tuples, lists, dicts, named tuples, the port's
transformations, tensors, arrays and scalars. ``save_state`` writes its
leaves to an ``.npz`` file as ``leaf_0``, ``leaf_1``, ... in the JAX
package's flattening order (dicts by sorted key; a transformation's
parameters in the reference's pytree order, e.g. rot, t, scale), so
leaves saved by either package load with the other's ``load_leaves``.
``load_state`` puts them back into the structure of a given state, on its
devices.
"""

from __future__ import annotations

import copy
from typing import Any, Dict, List

import numpy as np
import torch

from ..models import transformation as tf

# Each transformation's parameters in the reference's pytree order
# (probreg_tpu/models/transformation.py, tree_flatten).
_FIELDS = (
    (tf.RigidTransformation, ("rot", "t", "scale")),
    (tf.AffineTransformation, ("b", "t")),
    (tf.NonRigidTransformation, ("g", "w")),
    (tf.LowRankNonRigidTransformation, ("zc", "u", "lam")),
    (tf.CombinedTransformation, ("rigid_trans", "v")),
    (tf.TPSTransformation, ("a", "v", "control_pts")),
    (tf.DeformableKinematicModel, ("dualquats",)),
)


def _fields(obj):
    for cls, names in _FIELDS:
        if type(obj) is cls:
            return names
    return None


def _flatten(state, out: List):
    if state is None:
        return
    names = _fields(state)
    if names is not None:
        for k in names:
            _flatten(getattr(state, k), out)
    elif isinstance(state, dict):
        for k in sorted(state):
            _flatten(state[k], out)
    elif isinstance(state, (list, tuple)):
        for v in state:
            _flatten(v, out)
    elif isinstance(state, torch.Tensor):
        out.append(state.detach().cpu().numpy())
    else:
        out.append(np.asarray(state))


def _unflatten(like, leaves):
    if like is None:
        return None
    names = _fields(like)
    if names is not None:
        obj = copy.copy(like)
        for k in names:
            setattr(obj, k, _unflatten(getattr(like, k), leaves))
        return obj
    if isinstance(like, dict):
        return {k: _unflatten(like[k], leaves) for k in sorted(like)}
    if isinstance(like, (list, tuple)):
        vals = [_unflatten(v, leaves) for v in like]
        return type(like)(*vals) if hasattr(like, "_fields") \
            else type(like)(vals)
    leaf = next(leaves)
    if isinstance(like, torch.Tensor):
        return torch.as_tensor(leaf, dtype=like.dtype, device=like.device)
    return leaf


def save_state(path: str, state: Any) -> None:
    """Save a state's leaves to ``path`` (.npz)."""
    leaves: List = []
    _flatten(state, leaves)
    np.savez(path,
             __treedef__=np.frombuffer(type(state).__name__.encode(),
                                       dtype=np.uint8),
             **{f"leaf_{i}": a for i, a in enumerate(leaves)})


def load_leaves(path: str):
    """The saved leaves as numpy arrays, in order."""
    data = np.load(path)
    n = sum(1 for k in data.files if k.startswith("leaf_"))
    return [data[f"leaf_{i}"] for i in range(n)]


def load_state(path: str, like: Any) -> Any:
    """A state saved by :func:`save_state` in the structure of ``like``;
    tensors take ``like``'s dtype and device."""
    return _unflatten(like, iter(load_leaves(path)))


def rigid_tf_init_params(transformation) -> Dict:
    """``tf_init_params`` that resume CPD or FilterReg from a rigid result
    (numpy, so either package takes them)."""
    out = {"rot": torch.as_tensor(transformation.rot).cpu().numpy(),
           "t": torch.as_tensor(transformation.t).cpu().numpy()}
    if hasattr(transformation, "scale"):
        out["scale"] = float(transformation.scale)
    return out
