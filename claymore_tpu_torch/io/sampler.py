"""Geometry sampling: particle seeding (numpy).

A copy of the two samplers of ``claymore_tpu/io/sampler.py`` the port needs;
importing the JAX package would import JAX.
"""

from __future__ import annotations

import numpy as np


def sample_uniform_box_world(dx: float, lo, hi, ppc: float = 8.0) -> np.ndarray:
    """Uniformly fill a world-space AABB at ``ppc`` particles per cell."""
    lo = np.asarray(lo, np.float64)
    hi = np.asarray(hi, np.float64)
    per_axis = ppc ** (1.0 / 3.0)
    h = dx / per_axis
    spans = [np.arange(lo[d] + h / 2, hi[d], h) for d in range(3)]
    if any(len(s) == 0 for s in spans):
        return np.zeros((0, 3), np.float32)
    gx, gy, gz = np.meshgrid(*spans, indexing="ij")
    return np.stack([gx, gy, gz], axis=-1).reshape(-1, 3).astype(np.float32)


def sample_sphere(dx: float, center, radius: float, ppc: float = 8.0) -> np.ndarray:
    """Uniform lattice clipped to a sphere."""
    center = np.asarray(center, np.float64)
    lo = center - radius
    hi = center + radius
    pts = sample_uniform_box_world(dx, lo, hi, ppc)
    keep = np.sum((pts - center) ** 2, axis=-1) <= radius * radius
    return pts[keep]
