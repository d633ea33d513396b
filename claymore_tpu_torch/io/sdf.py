"""Signed-distance-field ingest and particle seeding.

Port of ``claymore_tpu/io/sdf.py`` (host numpy, set-up only): read and
write the SDFGen ASCII ``.sdf`` level set, seed particles on a regular
lattice inside its zero level set, and scale them into the world box
[offset, offset + span].

``mode="poisson"`` (blue-noise seeding by weighted sample elimination) is
not ported: the JAX package runs it in its native runtime
(``claymore_tpu/native/src/runtime.cpp``), and it raises here.
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
    """Particles f32[n, 3] inside the zero level set, on a lattice of
    ``ppc`` particles per cell of size ``domain_dx``, with the level set's
    box scaled onto [offset, offset + span].  ``seed`` steers only the
    unported ``"poisson"`` mode."""
    if mode == "poisson":
        raise NotImplementedError(
            "sampling 'poisson' (weighted sample elimination) is not ported "
            "(ROADMAP Queue 1: poisson sampling); use 'uniform'")
    if mode != "uniform":
        raise ValueError(f"unknown sampling mode {mode!r}")
    offset = np.asarray(offset, np.float64)
    span = np.asarray(span, np.float64)
    extent = np.array(values.shape, np.float64) * sdf_dx
    # particle spacing in world space, then in SDF units: the level set's
    # box fills the span
    h = domain_dx / ppc ** (1.0 / 3.0)
    scale = span / extent
    h_sdf = h / np.min(scale.clip(min=1e-12))
    spans = [np.arange(h_sdf / 2, extent[d], h_sdf) for d in range(3)]
    if any(len(s) == 0 for s in spans):
        pts = np.zeros((0, 3), np.float64)
    else:
        gx, gy, gz = np.meshgrid(*spans, indexing="ij")
        pts = np.stack([gx, gy, gz], axis=-1).reshape(-1, 3)
    sd = _trilinear(values, pts / sdf_dx)
    inside = pts[sd <= 0.0]
    world = offset + inside / extent * span
    return world.astype(np.float32)


def read_sdf(path: str, ppc: float, domain_dx: float, offset, span,
             mode: str = "uniform") -> np.ndarray:
    """``.sdf`` file -> world-space particle cloud (``sample_sdf``)."""
    values, _origin, sdf_dx = read_sdf_file(path)
    return sample_sdf(values, sdf_dx, ppc, domain_dx, offset, span, mode)
