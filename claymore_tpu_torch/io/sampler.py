"""Geometry sampling: particle seeding (numpy).

A copy of the samplers of ``claymore_tpu/io/sampler.py`` the port needs;
importing the JAX package would import JAX.  ``poisson_disk_sample`` runs
the port's own C++ weighted sample elimination (``csrc/sample_elim.cpp``,
built by ``ops/_build.py:host_library``), or the JAX package's stratified
thinning where no library can be built.
"""

from __future__ import annotations

import numpy as np


def _lattice_spans(dx: float, lo, hi, ppc: float):
    lo = np.asarray(lo, np.float64)
    hi = np.asarray(hi, np.float64)
    h = dx / ppc ** (1.0 / 3.0)
    return [np.arange(lo[d] + h / 2, hi[d], h) for d in range(3)]


def _lattice(xs, ys, zs) -> np.ndarray:
    """[len(xs) * len(ys) * len(zs), 3] float32 lattice points, x-major."""
    gx, gy, gz = np.meshgrid(xs, ys, zs, indexing="ij")
    return np.stack([gx, gy, gz], axis=-1).reshape(-1, 3).astype(np.float32)


def sample_uniform_box(dx: float, lo_cell, hi_cell) -> np.ndarray:
    """8 particles per cell at +-0.25 dx offsets inside the cell range
    [lo_cell, hi_cell) given in cell coordinates: f32[cells * 8, 3], cells
    x-major, each cell's 8 offsets x-major."""
    lo = np.asarray(lo_cell, np.int64)
    hi = np.asarray(hi_cell, np.int64)
    cx, cy, cz = np.meshgrid(*(np.arange(lo[d], hi[d]) for d in range(3)), indexing="ij")
    centers = (np.stack([cx, cy, cz], axis=-1).reshape(-1, 3) + 0.5) * dx
    offs = np.array([[sx, sy, sz] for sx in (-0.25, 0.25) for sy in (-0.25, 0.25)
                     for sz in (-0.25, 0.25)], np.float32) * dx
    return (centers[:, None, :] + offs[None]).reshape(-1, 3).astype(np.float32)


def sample_uniform_box_world(dx: float, lo, hi, ppc: float = 8.0) -> np.ndarray:
    """Uniformly fill a world-space AABB at ``ppc`` particles per cell."""
    spans = _lattice_spans(dx, lo, hi, ppc)
    if any(len(s) == 0 for s in spans):
        return np.zeros((0, 3), np.float32)
    return _lattice(*spans)


SPHERE_PLANES = 16     # x planes of the lattice tested against the sphere at once


def sample_sphere(dx: float, center, radius: float, ppc: float = 8.0) -> np.ndarray:
    """Uniform lattice clipped to a sphere: the points of
    ``sample_uniform_box_world`` over the sphere's bounding box that lie in
    it, in the same order.  The lattice is made and tested
    ``SPHERE_PLANES`` x planes at a time, so the box's points (190M for
    config 5's sphere, ~12 GB in float64) never exist at once."""
    center = np.asarray(center, np.float64)
    xs, ys, zs = _lattice_spans(dx, center - radius, center + radius, ppc)
    parts = [np.zeros((0, 3), np.float32)]
    for i in range(0, len(xs) if len(ys) and len(zs) else 0, SPHERE_PLANES):
        pts = _lattice(xs[i:i + SPHERE_PLANES], ys, zs)
        keep = np.sum((pts - center) ** 2, axis=-1) <= radius * radius
        parts.append(pts[keep])
    return np.concatenate(parts)


def sample_elimination(points: np.ndarray, target: int):
    """Indices of the ``target`` points that weighted sample elimination
    keeps, ascending, or None where the host library cannot be built (the
    JAX package's ``native.sample_elimination_native``)."""
    import ctypes

    from ..ops import _build

    lib = _build.host_library()
    if lib is None:
        return None
    pts = np.ascontiguousarray(points, np.float32)
    n = pts.shape[0]
    lo = pts.min(axis=0)
    pts0 = pts - lo
    ext = np.maximum(pts0.max(axis=0), 1e-6)
    out = np.zeros(max(target, 1), np.int32)
    k = lib.cm_sample_elimination(pts0.ctypes.data_as(ctypes.c_void_p), n, target,
                                  float(ext[0]), float(ext[1]), float(ext[2]),
                                  out.ctypes.data_as(ctypes.c_void_p))
    return out[:k]


def poisson_disk_sample(points: np.ndarray, target_count: int, seed: int = 0) -> np.ndarray:
    """Down-select a candidate cloud to ``target_count`` points of blue-noise
    spacing by weighted sample elimination; where the host library cannot
    be built, jittered stratified thinning from ``seed``."""
    n = points.shape[0]
    if target_count >= n:
        return points
    kept = sample_elimination(points, target_count)
    if kept is not None:
        return points[kept]
    rng = np.random.default_rng(seed)
    # stratify by a coarse grid, keep proportional counts per cell
    lo = points.min(axis=0)
    hi = points.max(axis=0) + 1e-9
    cells = max(1, int(round((target_count / 2.0) ** (1.0 / 3.0))))
    idx = np.floor((points - lo) / (hi - lo) * cells).astype(np.int64)
    key = (idx[:, 0] * cells + idx[:, 1]) * cells + idx[:, 2]
    order = np.argsort(key, kind="stable")
    stride = n / target_count
    picks = order[(np.arange(target_count) * stride
                   + rng.uniform(0, stride, target_count)).astype(np.int64) % n]
    return points[picks]
