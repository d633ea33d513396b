"""Checkpoints and frame output.

Port of ``claymore_tpu/io/checkpoint.py``.  ``save_state``/``load_state``
keep the JAX package's ``.npz`` format: ``__version__`` 2,
``__num_models__``, ``__fields__`` (each model's field names, sorted and
comma-joined) and ``leaf_{i}``, the state's arrays in the leaf order of
``jax.tree_util.tree_flatten`` of its ``SimState``.  Its state types are
NamedTuples, so that order is field order with dict keys sorted; ``leaves``
spells it out.  A JAX checkpoint resumes here and the reverse, bit for bit.
A multi-device state (a tuple of shard states) is saved in the JAX
package's stacked layout (``interop.stack_shards``), so its checkpoints of
the same mesh resume here too.  ``save_frame_bgeo``/``flush_io`` dump
per-model ``.bgeo`` frames (``io/bgeo.py``: the native writer for
uncompressed all-float frames, as in the JAX package).
"""

from __future__ import annotations

import dataclasses
from typing import Iterator, List

import numpy as np
import torch

from ..core.types import Partition, ParticleModel, SimState, TileMap
from ..interop import split_shards, stack_shards
from ..utils.debug import to_numpy
from . import async_io, bgeo

_FORMAT_VERSION = 2


def leaves(state: SimState) -> List[torch.Tensor]:
    """The state's tensors in the JAX ``SimState``'s flattening order."""
    p = state.partition
    out = [state.grid, p.table, p.keys, p.count, p.overflow]
    for m in state.models:
        out.append(m.pos)
        out.extend(m.fields[k] for k in sorted(m.fields))
        out.extend([m.active, m.pid, m.tiles.block, m.tiles.bcoord,
                    m.tiles.tvalid, m.tiles.dropped])
    out.extend([state.dt, state.max_vel, state.t, state.step, state.mig_dropped,
                state.halo_overflow])
    return out


def _unflatten(like: SimState, it: Iterator[torch.Tensor]) -> SimState:
    """A state shaped like ``like`` from tensors in ``leaves`` order."""
    grid = next(it)
    partition = Partition(*(next(it) for _ in range(4)))
    models = []
    for m in like.models:
        pos = next(it)
        fields = {k: next(it) for k in sorted(m.fields)}
        active, pid = next(it), next(it)
        tiles = TileMap(*(next(it) for _ in range(4)))
        models.append(ParticleModel(pos=pos, fields=fields, active=active, pid=pid,
                                    tiles=tiles))
    names = [f.name for f in dataclasses.fields(SimState)][3:]
    rest = {k: next(it) for k in names}
    return SimState(grid=grid, partition=partition, models=tuple(models), **rest)


def save_state(path: str, state: SimState) -> None:
    """Write ``state`` (or a tuple of shard states) to one ``.npz`` file."""
    if isinstance(state, tuple):
        state = stack_shards(state)
    arrays = {f"leaf_{i}": to_numpy(x) for i, x in enumerate(leaves(state))}
    field_names = [",".join(sorted(m.fields)) for m in state.models]
    np.savez_compressed(
        path,
        __version__=np.int64(_FORMAT_VERSION),
        __num_models__=np.int64(len(state.models)),
        __fields__=np.array(field_names),
        **arrays,
    )


def load_state(path: str, like: SimState) -> SimState:
    """Read a state written by ``save_state`` (either package's).  ``like``
    (``engine.init_state`` of the same scene) gives the structure, the
    device and the dtypes; every shape must match it.  A tuple ``like``
    reads a multi-device checkpoint into shards on its shards' devices."""
    if isinstance(like, tuple):
        stacked = load_state(path, stack_shards(like))
        return split_shards(stacked, [s.grid.device for s in like])
    with np.load(path, allow_pickle=False) as data:
        version = int(data["__version__"])
        if version != _FORMAT_VERSION:
            raise ValueError(f"{path}: checkpoint format {version}, expected "
                             f"{_FORMAT_VERSION}")
        if int(data["__num_models__"]) != len(like.models):
            raise ValueError(f"{path}: {int(data['__num_models__'])} models, the "
                             f"scene has {len(like.models)}")
        out = []
        for i, ref in enumerate(leaves(like)):
            arr = data[f"leaf_{i}"]
            if arr.shape != tuple(ref.shape):
                raise ValueError(
                    f"checkpoint shape mismatch at leaf {i}: {arr.shape} vs "
                    f"{tuple(ref.shape)} (config or materials differ from the "
                    "saved run)")
            out.append(torch.from_numpy(arr).to(
                device=ref.device, dtype=ref.dtype))
    return _unflatten(like, iter(out))


def save_frame_bgeo(path: str, engine, state: SimState, model_idx: int = 0,
                    asynchronous: bool = True) -> str:
    """Dump one model's active particles to ``path``.  The positions are
    copied to the host here; the file is written by an IO worker when
    ``asynchronous`` (``flush_io`` waits for it).  Returns the writer that
    took it (``bgeo.write_bgeo``)."""
    pos = engine.get_positions(state, model_idx)
    return bgeo.write_bgeo(path, pos, asynchronous=asynchronous)


def flush_io() -> None:
    """Wait for every queued frame dump, native and numpy; raise if one
    failed."""
    async_io.flush()
