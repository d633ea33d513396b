"""JSON scene loading, the claymore-compatible schema.

Port of ``claymore_tpu/io/scene.py``:

    {
      "simulation": {"default_dt": 1e-4, "fps": 24, "frames": 60},
      "grid":      {"domain_bits": 8, "block_bits": 2, "max_active_blocks": N,
                    "gravity": [0,-9.8,0], "cfl": 0.5, "bound_blocks": 2},
      "models": [
        {"constitutive": "fixed_corotated" | "jfluid" | "sand" | "nacc",
         "shape": {"type": "box" | "sphere"}  or  "file": "x.npy" | "x.bin",
         "offset": [x,y,z], "span": [x,y,z], "velocity": [x,y,z],
         "rho": ..., "volume": ..., material parameters ...}
      ],
      "colliders": [{"type": "halfspace" | "sphere" | "box", "kind":
                     "sticky" | "slip" | "separate", "friction": f, ...}]
    }

Not ported yet, and refused with ``NotImplementedError``: ``.sdf`` model
files, ``sdf``/``sdf_file`` colliders (ROADMAP Queue 1, SDF colliders) and a
``device`` block asking for several devices (ROADMAP Queue 1, multiple
devices).  ``device.use_pallas`` steers the TPU kernels and is ignored.
The device the engine runs on is the caller's.
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


def _build_collider(spec: Dict[str, Any]):
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
    if t in ("sdf", "sdf_file"):
        raise NotImplementedError(
            f"collider type {t!r} is not ported yet (ROADMAP Queue 1: SDF "
            "colliders in K2)")
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
            raise NotImplementedError(
                f"{path}: .sdf model files are not ported yet (ROADMAP Queue 1: "
                "IO, sdf/meshsdf)")
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


def load_scene(path: str, device, tile_chunk: int = 32) -> Scene:
    """Parse a scene file and build an engine on ``device`` and its
    initial state."""
    with open(path) as f:
        doc = json.load(f)
    base_dir = os.path.dirname(os.path.abspath(path))

    dev = doc.get("device", {})
    if dev.get("n_devices", 1) > 1 or dev.get("mesh_shape"):
        raise NotImplementedError(
            "multi-device scenes are not ported yet (ROADMAP Queue 1: multiple "
            "devices)")

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

    materials, positions, velocities = [], [], []
    for model in doc.get("models", []):
        materials.append(
            material_from_scene(model["constitutive"], cfg.default_volume(), model))
        positions.append(_model_positions(model, cfg, base_dir))
        velocities.append(tuple(model.get("velocity", (0.0, 0.0, 0.0))))

    colliders = [_build_collider(c) for c in doc.get("colliders", [])]
    engine = MPMEngine(cfg, materials, colliders=colliders,
                       tile_chunk=tile_chunk, device=device)
    state = engine.init_state(positions, velocities)
    return Scene(cfg, engine, state, frames, materials, positions)
