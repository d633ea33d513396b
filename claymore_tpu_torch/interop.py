"""Carry configurations, materials and states across from the JAX package.

The JAX side is reached only through plain data: ``dataclasses.asdict`` of
its config and materials, and its ``SimState`` as nested tuples of numpy
arrays (``jax.tree.map(np.asarray, state)``).  A multi-device state is the
JAX package's stacked one there and a tuple of shard states here
(``shards_to_numpy``/``shards_from_numpy``).  Nothing here imports JAX.
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


# --------------------------------------------------------------------------
# multi-device states: the JAX package stacks its shards along the slot and
# row axes (``MultiChipEngine._out_state_spec``); the port keeps a tuple of
# per-shard states
# --------------------------------------------------------------------------

def _map_state(fn, states, scalar):
    """A SimState whose every tensor is ``fn`` of the matching tensors of
    ``states``: ``fn(xs, axis)`` with the axis shards stack along (0 for the
    grid, the last axis elsewhere); 0-d leaves take ``scalar(xs)``."""
    def leaf(xs, axis=-1):
        return scalar(xs) if xs[0].dim() == 0 else fn(xs, axis)

    models = []
    for ms in zip(*(s.models for s in states)):
        models.append(ParticleModel(
            pos=leaf([m.pos for m in ms]),
            fields={k: leaf([m.fields[k] for m in ms]) for k in ms[0].fields},
            active=leaf([m.active for m in ms]), pid=leaf([m.pid for m in ms]),
            tiles=TileMap(*(leaf([getattr(m.tiles, f.name) for m in ms])
                            for f in dataclasses.fields(TileMap)))))
    return SimState(
        grid=leaf([s.grid for s in states], 0),
        partition=Partition(*(leaf([getattr(s.partition, f.name) for s in states])
                              for f in dataclasses.fields(Partition))),
        models=tuple(models),
        **{k: leaf([getattr(s, k) for s in states])
           for k in ("dt", "max_vel", "t", "step", "mig_dropped", "halo_overflow")})


def stack_shards(states) -> SimState:
    """A tuple of shard states -> one state in the JAX package's stacked
    multi-device layout, on the CPU: shard i's slots, tiles, pool rows and
    table entries follow shard i-1's; the scalars are shard 0's."""
    return _map_state(lambda xs, axis: torch.cat([x.cpu() for x in xs], dim=axis),
                      states, lambda xs: xs[0].cpu())


def split_shards(state: SimState, devices) -> tuple:
    """``stack_shards``'s inverse: shard i of a stacked state on
    ``devices[i]``."""
    n = len(devices)

    def part(i):
        def cut(xs, axis):
            return xs[0].chunk(n, dim=axis)[i].contiguous().to(devices[i])

        return _map_state(cut, (state,), lambda xs: xs[0].to(devices[i]))

    return tuple(part(i) for i in range(n))


def shards_to_numpy(states) -> SimStateNP:
    """A tuple of shard states -> the JAX package's stacked multi-device
    state as nested namedtuples of numpy arrays."""
    return state_to_numpy(stack_shards(states))


def shards_from_numpy(tree, devices) -> tuple:
    """The JAX package's stacked multi-device state (numpy arrays) -> a
    tuple of shard states, shard i on ``devices[i]``."""
    return split_shards(state_from_numpy(tree, "cpu"), devices)
