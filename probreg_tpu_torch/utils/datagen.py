"""Synthetic point-cloud generators shared by tests, benchmarks, examples.

One definition of the "blobby surface" (a sphere with a smooth radial
modulation — dense enough for multi-level pyramids, non-degenerate for
rigid recovery) so the perf floors, the tests, and the examples all
measure the SAME geometry.
"""

from __future__ import annotations

import numpy as np


def blobby_surface(n: int, seed: int = 0) -> np.ndarray:
    """(n, 3) float32 points on r(theta, phi) = 1 + 0.25 sin(3 theta) cos(2 phi)."""
    rng = np.random.default_rng(seed)
    theta = rng.uniform(0, np.pi, n)
    phi = rng.uniform(0, 2 * np.pi, n)
    r = 1.0 + 0.25 * np.sin(3 * theta) * np.cos(2 * phi)
    return np.stack([r * np.sin(theta) * np.cos(phi),
                     r * np.sin(theta) * np.sin(phi),
                     r * np.cos(theta)], axis=1).astype(np.float32)
