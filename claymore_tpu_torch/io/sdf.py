"""Signed-distance-field ingest and particle seeding.

Port of ``claymore_tpu/io/sdf.py`` (host numpy, set-up only): read and
write the SDFGen ASCII ``.sdf`` level set, seed particles inside its zero
level set, on a regular lattice or with blue-noise spacing (``"poisson"``),
and scale them into the world box [offset, offset + span].
"""

from __future__ import annotations

from typing import Tuple

import numpy as np


def read_sdf_file(path: str) -> Tuple[np.ndarray, np.ndarray, float]:
    """Read an SDFGen ``.sdf`` file: 'ni nj nk\\n ox oy oz\\n dx\\n' followed
    by ni*nj*nk values, i fastest.  Returns (values f64[ni, nj, nk],
    origin f64[3], dx)."""
    with open(path, "r") as f:
        dims = np.array(f.readline().split(), np.int64)
        origin = np.array(f.readline().split(), np.float64)
        dx = float(f.readline())
        vals = np.array(f.read().split(), np.float64)
    ni, nj, nk = dims
    if vals.size != ni * nj * nk:
        raise ValueError(f"{path}: {vals.size} values for dims {dims.tolist()}")
    return vals.reshape(nk, nj, ni).transpose(2, 1, 0), origin, dx


def write_sdf_file(path: str, values: np.ndarray, origin, dx: float) -> None:
    """Inverse of ``read_sdf_file``."""
    ni, nj, nk = values.shape
    with open(path, "w") as f:
        f.write(f"{ni} {nj} {nk}\n")
        f.write(f"{origin[0]} {origin[1]} {origin[2]}\n")
        f.write(f"{dx}\n")
        flat = values.transpose(2, 1, 0).reshape(-1)
        np.savetxt(f, flat, fmt="%.8g")


def _trilinear(values: np.ndarray, x: np.ndarray) -> np.ndarray:
    """Trilinear sample at fractional grid coordinates x [n, 3]."""
    dims = np.array(values.shape)
    c0 = np.clip(np.floor(x).astype(np.int64), 0, dims - 2)
    f = x - c0
    out = np.zeros(x.shape[0])
    for i in (0, 1):
        wx = (1 - f[:, 0]) if i == 0 else f[:, 0]
        for j in (0, 1):
            wy = (1 - f[:, 1]) if j == 0 else f[:, 1]
            for k in (0, 1):
                wz = (1 - f[:, 2]) if k == 0 else f[:, 2]
                out += wx * wy * wz * values[c0[:, 0] + i, c0[:, 1] + j, c0[:, 2] + k]
    return out


def sample_sdf(values: np.ndarray, sdf_dx: float, ppc: float, domain_dx: float,
               offset, span, mode: str = "uniform", seed: int = 0) -> np.ndarray:
    """Particles f32[n, 3] inside the zero level set, at ``ppc`` particles
    per cell of size ``domain_dx``, with the level set's box scaled onto
    [offset, offset + span].

    ``"uniform"``: a regular lattice.  ``"poisson"``: twice as many
    candidates on a lattice jittered from ``seed``, thinned to half by
    weighted sample elimination (``sampler.poisson_disk_sample``): blue-noise
    spacing, as the reference's read_sdf -> GeneratePoissonSamples."""
    if mode not in ("uniform", "poisson"):
        raise ValueError(f"unknown sampling mode {mode!r}")
    offset = np.asarray(offset, np.float64)
    span = np.asarray(span, np.float64)
    extent = np.array(values.shape, np.float64) * sdf_dx
    # particle spacing in world space, then in SDF units: the level set's
    # box fills the span
    h = domain_dx / ppc ** (1.0 / 3.0)
    scale = span / extent
    h_sdf = h / np.min(scale.clip(min=1e-12))

    def lattice(spacing, jitter):
        spans = [np.arange(spacing / 2, extent[d], spacing) for d in range(3)]
        if any(len(s) == 0 for s in spans):
            return np.zeros((0, 3), np.float64)
        gx, gy, gz = np.meshgrid(*spans, indexing="ij")
        pts = np.stack([gx, gy, gz], axis=-1).reshape(-1, 3)
        if jitter:
            rng = np.random.default_rng(seed)
            pts = pts + rng.uniform(-0.45, 0.45, pts.shape) * spacing
        return pts

    if mode == "poisson":
        from .sampler import poisson_disk_sample

        over = 2.0                      # candidates per particle kept
        pts = lattice(h_sdf / over ** (1.0 / 3.0), jitter=True)
        candidates = pts[_trilinear(values, pts / sdf_dx) <= 0.0]
        target = int(round(candidates.shape[0] / over))
        inside = poisson_disk_sample(candidates.astype(np.float32), target, seed=seed)
    else:
        pts = lattice(h_sdf, jitter=False)
        inside = pts[_trilinear(values, pts / sdf_dx) <= 0.0]
    world = offset + inside / extent * span
    return world.astype(np.float32)


def read_sdf(path: str, ppc: float, domain_dx: float, offset, span,
             mode: str = "uniform") -> np.ndarray:
    """``.sdf`` file -> world-space particle cloud (``sample_sdf``)."""
    values, _origin, sdf_dx = read_sdf_file(path)
    return sample_sdf(values, sdf_dx, ppc, domain_dx, offset, span, mode)
