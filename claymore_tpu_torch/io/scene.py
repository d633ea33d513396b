"""JSON scene loading, the claymore-compatible schema.

Port of ``claymore_tpu/io/scene.py``:

    {
      "simulation": {"default_dt": 1e-4, "fps": 24, "frames": 60},
      "grid":      {"domain_bits": 8, "block_bits": 2, "max_active_blocks": N,
                    "gravity": [0,-9.8,0], "cfl": 0.5, "bound_blocks": 2},
      "models": [
        {"constitutive": "fixed_corotated" | "jfluid" | "sand" | "nacc",
         "shape": {"type": "box" | "sphere"}
           or  "file": "x.npy" | "x.bin" | "x.sdf"
                (+ "sampling": "uniform" | "poisson"),
         "offset": [x,y,z], "span": [x,y,z], "velocity": [x,y,z],
         "rho": ..., "volume": ..., material parameters ...}
      ],
      "colliders": [{"type": "halfspace" | "sphere" | "box" | "sdf" |
                     "sdf_file", "kind": "sticky" | "slip" | "separate",
                     "friction": f, ...}]
    }

An ``sdf`` collider reads an SDFGen ``.sdf`` file (``"file"``; its origin is
ignored, as in the JAX package); an ``sdf_file`` collider reads the
reference's raw asset (``"prefix"``, ``"resolution"``, ``"dx"`` defaulting
to the grid's, ``"bound_cells"``).  Collider paths are taken as given
(relative to the working directory), model files relative to the scene
file, as in the JAX package.  A ``device`` block asking for several
devices (``n_devices``, or ``mesh_shape`` such as ``[2, 2]`` for the (x, z)
box split, with ``halo_margin``, ``migration_capacity``, ``halo_capacity``)
builds a ``parallel.MultiChipEngine``.  ``device.use_pallas`` steers the
TPU kernels and is ignored.  The devices the engine runs on are the
caller's: one device (every shard on it) or one per shard.
"""

from __future__ import annotations

import json
import os
from typing import Any, Dict

import numpy as np

from ..config import SimConfig
from ..core.engine import MPMEngine
from ..models import boundary as bnd
from ..models.materials import from_scene as material_from_scene
from . import sdf as sdf_io
from .sampler import sample_sphere, sample_uniform_box_world


class Scene:
    def __init__(self, cfg: SimConfig, engine, state, frames: int,
                 materials, positions):
        self.cfg = cfg
        self.engine = engine
        self.state = state
        self.frames = frames
        self.materials = materials
        self.positions = positions


def _build_collider(spec: Dict[str, Any], cfg: SimConfig):
    kind = spec.get("kind", "sticky")
    friction = spec.get("friction", 0.0)
    motion = bnd.RigidMotion(
        trans=tuple(spec.get("trans", (0.0, 0.0, 0.0))),
        trans_vel=tuple(spec.get("trans_vel", (0.0, 0.0, 0.0))),
        omega=tuple(spec.get("omega", (0.0, 0.0, 0.0))),
        scale=spec.get("scale", 1.0),
        dsdt=spec.get("dsdt", 0.0),
    )
    t = spec["type"]
    if t == "halfspace":
        return bnd.HalfSpace(spec["origin"], spec["normal"], kind, friction, motion)
    if t == "sphere":
        return bnd.Sphere(spec["center"], spec["radius"], kind, friction, motion)
    if t == "box":
        return bnd.Box(spec["lo"], spec["hi"], kind, friction, motion)
    if t == "sdf":
        values, _origin, sdf_dx = sdf_io.read_sdf_file(spec["file"])
        return bnd.SignedDistanceCollider(values, sdf_dx, kind, friction, motion)
    if t == "sdf_file":
        return bnd.SignedDistanceCollider.from_claymore_files(
            spec["prefix"], spec["resolution"], spec.get("dx", cfg.dx), kind,
            friction, motion, bound_cells=spec.get("bound_cells", 8))
    raise ValueError(f"unknown collider type {t}")


def _model_positions(model: Dict[str, Any], cfg: SimConfig,
                     base_dir: str) -> np.ndarray:
    offset = model.get("offset", (0.0, 0.0, 0.0))
    span = model.get("span", (1.0, 1.0, 1.0))
    if "file" in model:
        path = model["file"]
        if not os.path.isabs(path):
            path = os.path.join(base_dir, path)
        if path.endswith(".sdf"):
            return sdf_io.read_sdf(path, cfg.ppc, cfg.dx, offset, span,
                                   mode=model.get("sampling", "uniform"))
        if path.endswith(".npy"):
            return np.asarray(np.load(path), np.float32)
        if path.endswith(".bin"):
            # raw float32 xyz triples
            return np.fromfile(path, np.float32).reshape(-1, 3)
        raise ValueError(f"unsupported model file {path}")
    shape = model.get("shape", {"type": "box"})
    lo = np.asarray(offset, np.float64)
    hi = lo + np.asarray(span, np.float64)
    if shape.get("type", "box") == "box":
        return sample_uniform_box_world(cfg.dx, lo, hi, cfg.ppc)
    if shape["type"] == "sphere":
        center = (lo + hi) / 2
        radius = float(min(hi - lo) / 2)
        return sample_sphere(cfg.dx, center, radius, cfg.ppc)
    raise ValueError(f"unknown shape {shape}")


def load_scene(path: str, device, tile_chunk: int = 32, positions=None) -> Scene:
    """Parse a scene file and build an engine on ``device`` (a device, or
    one per shard of a multi-device scene) and its initial state.
    ``positions``: a set-up shortcut for a caller that loads the same
    models twice (no scene file can set it): the particles an earlier load
    sampled (``Scene.positions``), taken in place of sampling them again (a
    100M-particle sphere takes the host tens of seconds and ~20 GB)."""
    with open(path) as f:
        doc = json.load(f)
    base_dir = os.path.dirname(os.path.abspath(path))

    sim = doc.get("simulation", {})
    grid = doc.get("grid", {})
    cfg = SimConfig(
        domain_bits=grid.get("domain_bits", 8),
        block_bits=grid.get("block_bits", 2),
        max_active_blocks=grid.get("max_active_blocks", 8192),
        gravity=tuple(grid.get("gravity", (0.0, -9.8, 0.0))),
        cfl=grid.get("cfl", 0.5),
        bound_blocks=grid.get("bound_blocks", 2),
        default_dt=sim.get("default_dt", 1e-4),
        fps=sim.get("fps", 24),
    )
    frames = sim.get("frames", 60)

    models = doc.get("models", [])
    if positions is not None and len(positions) != len(models):
        raise ValueError(f"{len(positions)} position arrays for {len(models)} models")
    materials, velocities = [], []
    sampled = positions is None
    positions = [] if sampled else list(positions)
    for model in models:
        materials.append(
            material_from_scene(model["constitutive"], cfg.default_volume(), model))
        if sampled:
            positions.append(_model_positions(model, cfg, base_dir))
        velocities.append(tuple(model.get("velocity", (0.0, 0.0, 0.0))))

    colliders = [_build_collider(c, cfg) for c in doc.get("colliders", [])]
    dev = doc.get("device", {})
    mesh_shape = dev.get("mesh_shape")
    if dev.get("n_devices", 1) > 1 or mesh_shape:
        from ..parallel.multi import MultiChipEngine

        engine = MultiChipEngine(
            cfg, materials, n_devices=dev.get("n_devices"), mesh_shape=mesh_shape,
            device=device, halo_margin=dev.get("halo_margin"),
            migration_capacity=dev.get("migration_capacity", 2048),
            halo_capacity=dev.get("halo_capacity"), colliders=colliders,
            tile_chunk=tile_chunk)
    else:
        if isinstance(device, (list, tuple)):
            if len(device) != 1:
                raise ValueError(f"a one-device scene takes one device, got {len(device)}")
            device = device[0]
        engine = MPMEngine(cfg, materials, colliders=colliders,
                           tile_chunk=tile_chunk, device=device)
    state = engine.init_state(positions, velocities)
    return Scene(cfg, engine, state, frames, materials, positions)
