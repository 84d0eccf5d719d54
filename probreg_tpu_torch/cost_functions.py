"""The rigid orientation grid of the multistart searches (counterpart of the
grid part of probreg_tpu/cost_functions.py).

``RigidCostFunction.initial_multistart_rots`` is the one grid that the
``n_starts > 1`` searches of CPD, FilterReg, GMMTree and BCPD share: in 3-D
the identity, then 180, +90 and -90 degrees about each axis (up to 10
starts); in 2-D ``n_starts`` angles evenly spaced on the circle from the
identity. The L2-distance objectives of GMMReg and SVR
(``compute_l2_dist``, ``RigidCostFunction.__call__``,
``TPSCostFunction``) come with the L2-distance family (ROADMAP, Queue 1
item 8).
"""

from __future__ import annotations

import numpy as np

from .utils import se3_op as so


class RigidCostFunction:
    """The rigid parameterization theta = (quaternion (4), t (3)) of the
    L2-distance registrations: here its starts only."""

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
