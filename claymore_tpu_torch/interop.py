"""Carry configurations, materials and states across from the JAX package.

The JAX side is reached only through plain data: ``dataclasses.asdict`` of
its config and materials, and its ``SimState`` as nested tuples of numpy
arrays (``jax.tree.map(np.asarray, state)``).  Nothing here imports JAX.
"""

from __future__ import annotations

import collections
import dataclasses
from typing import Any, Mapping

import numpy as np
import torch

from .config import SimConfig
from .core.types import Partition, ParticleModel, SimState, TileMap
from .models import boundary
from .models.materials import MATERIALS, Material
from .utils.debug import to_numpy

# JAX config fields that only steer the TPU kernels
_JAX_ONLY = frozenset({
    "mxu_precision", "force_mxu_split", "g2p_dot_precision", "g2p_arena_dtype",
    "g2p_window_dma", "pallas_chunk", "pallas_macro_tiles",
})

# the JAX containers' field names, for states handed back as numpy
PartitionNP = collections.namedtuple("PartitionNP", [f.name for f in dataclasses.fields(Partition)])
TileMapNP = collections.namedtuple("TileMapNP", [f.name for f in dataclasses.fields(TileMap)])
ParticleModelNP = collections.namedtuple("ParticleModelNP", [f.name for f in dataclasses.fields(ParticleModel)])
SimStateNP = collections.namedtuple("SimStateNP", [f.name for f in dataclasses.fields(SimState)])


def config_from_jax(d: Mapping[str, Any]) -> SimConfig:
    """``dataclasses.asdict`` of a ``claymore_tpu.SimConfig`` -> SimConfig.

    Drops the TPU-only fields; raises on a field the port does not know."""
    names = {f.name for f in dataclasses.fields(SimConfig)}
    kw = {k: v for k, v in d.items() if k not in _JAX_ONLY}
    unknown = set(kw) - names
    if unknown:
        raise ValueError(f"unknown config fields: {sorted(unknown)}")
    if "gravity" in kw:
        kw["gravity"] = tuple(float(g) for g in kw["gravity"])
    return SimConfig(**kw)


def material_from_jax(name: str, params: Mapping[str, Any]) -> Material:
    """Material by its JAX ``name`` from ``dataclasses.asdict`` of it."""
    if name not in MATERIALS:
        raise ValueError(f"unknown material {name!r}")
    cls = MATERIALS[name]
    fields = {f.name for f in dataclasses.fields(cls)} - {"name", "field_specs"}
    return cls(**{k: v for k, v in params.items() if k in fields})


def collider_from_jax(col) -> boundary.ColliderBase:
    """A JAX ``HalfSpace``, ``Sphere``, ``Box`` or ``SignedDistanceCollider``
    (read by its attributes) -> the port's collider with the same geometry,
    kind, friction and ``RigidMotion``.  The half-space normal is carried
    over as stored, not normalised again; an SDF collider's ``values`` and
    ``grads`` are copied as numpy float32, bit for bit (no second
    ``np.gradient``)."""
    mo = col.motion
    motion = boundary.RigidMotion(
        trans=tuple(float(c) for c in mo.trans),
        trans_vel=tuple(float(c) for c in mo.trans_vel),
        omega=tuple(float(c) for c in mo.omega),
        scale=float(mo.scale), dsdt=float(mo.dsdt))
    kind, friction = col.kind, col.friction
    name = type(col).__name__
    if name == "HalfSpace":
        out = boundary.HalfSpace(col.origin, col.normal, kind, friction, motion)
        out.normal = tuple(float(c) for c in col.normal)
        return out
    if name == "Sphere":
        return boundary.Sphere(col.center, col.radius, kind, friction, motion)
    if name == "Box":
        return boundary.Box(col.lo, col.hi, kind, friction, motion)
    if name == "SignedDistanceCollider":
        return boundary.SignedDistanceCollider(
            np.asarray(col.values, np.float32), col.dx, kind, friction, motion,
            gradients=np.asarray(col.grads, np.float32),
            bound_cells=col.bound_cells)
    raise NotImplementedError(f"{name} is not a collider of the port")


def _get(obj, name):
    return obj[name] if isinstance(obj, Mapping) else getattr(obj, name)


def _tensor(a, device) -> torch.Tensor:
    return torch.from_numpy(np.array(a, copy=True)).to(device)


def state_from_numpy(tree, device) -> SimState:
    """A JAX ``SimState`` of numpy arrays (or ``state_to_numpy``'s output)
    -> SimState on ``device``, same dtypes."""
    def t(a):
        return _tensor(a, device)

    p = _get(tree, "partition")
    models = []
    for m in _get(tree, "models"):
        tm = _get(m, "tiles")
        models.append(ParticleModel(
            pos=t(_get(m, "pos")),
            fields={k: t(v) for k, v in _get(m, "fields").items()},
            active=t(_get(m, "active")), pid=t(_get(m, "pid")),
            tiles=TileMap(block=t(_get(tm, "block")), bcoord=t(_get(tm, "bcoord")),
                          tvalid=t(_get(tm, "tvalid")), dropped=t(_get(tm, "dropped")))))
    return SimState(
        grid=t(_get(tree, "grid")),
        partition=Partition(table=t(_get(p, "table")), keys=t(_get(p, "keys")),
                            count=t(_get(p, "count")), overflow=t(_get(p, "overflow"))),
        models=tuple(models),
        **{k: t(_get(tree, k)) for k in ("dt", "max_vel", "t", "step",
                                         "mig_dropped", "halo_overflow")})


def state_to_numpy(state: SimState) -> SimStateNP:
    """SimState -> nested namedtuples of numpy arrays whose fields are the
    JAX ``SimState``'s, in its order (so ``claymore_tpu.SimState(*s)``
    rebuilds it level by level)."""
    n = to_numpy
    p = state.partition
    models = tuple(
        ParticleModelNP(
            pos=n(m.pos), fields={k: n(v) for k, v in m.fields.items()},
            active=n(m.active), pid=n(m.pid),
            tiles=TileMapNP(block=n(m.tiles.block), bcoord=n(m.tiles.bcoord),
                            tvalid=n(m.tiles.tvalid), dropped=n(m.tiles.dropped)))
        for m in state.models)
    return SimStateNP(
        grid=n(state.grid),
        partition=PartitionNP(table=n(p.table), keys=n(p.keys), count=n(p.count),
                              overflow=n(p.overflow)),
        models=models, dt=n(state.dt), max_vel=n(state.max_vel), t=n(state.t),
        step=n(state.step), mig_dropped=n(state.mig_dropped),
        halo_overflow=n(state.halo_overflow))
