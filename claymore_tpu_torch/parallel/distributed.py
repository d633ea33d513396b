"""One shard per process over ``torch.distributed`` (port of
``claymore_tpu/parallel/distributed.py``).

``init_multihost`` brings up the process group from the environment (or
from its arguments), ``pod_mesh`` lays the ranks out on a mesh, and
``DistGroup`` is the group the multi-device engine runs its collectives
through when each process holds one shard::

    from claymore_tpu_torch.parallel import distributed, MultiChipEngine

    distributed.init_multihost()                    # once per process
    group = distributed.DistGroup((2, 2), device=f"cuda:{local_rank}")
    eng = MultiChipEngine(cfg, mats, mesh_shape=(2, 2), device=group.devices[0],
                          group=group)

The backend is NCCL on cards and gloo on the CPU.  NCCL refuses two ranks
on one card, so on a machine with one card a ``DistGroup`` runs on the CPU
only; ``parallel.multi.LocalGroup`` holds several shards on one card.
"""

from __future__ import annotations

import contextlib
import math
import os
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

from .multi import neighbour


def init_multihost(init_method: Optional[str] = None, world_size: Optional[int] = None,
                   rank: Optional[int] = None, backend: Optional[str] = None) -> bool:
    """Initialise the default process group (idempotent).

    With no arguments, reads ``MASTER_ADDR``/``MASTER_PORT``, ``WORLD_SIZE``
    and ``RANK`` from the environment; explicit arguments (e.g.
    ``init_method="tcp://localhost:29500"``) cover manual clusters.  The
    backend defaults to NCCL where CUDA is available, else gloo.  Returns
    True when a group of more than one process is up, False when none is
    configured (a single-process run)."""
    if dist.is_initialized():
        return dist.get_world_size() > 1
    if world_size is None:
        world_size = int(os.environ.get("WORLD_SIZE", "0")) or None
    if rank is None and "RANK" in os.environ:
        rank = int(os.environ["RANK"])
    if init_method is None and "MASTER_ADDR" not in os.environ:
        return False
    if world_size is None or rank is None:
        return False
    backend = backend or ("nccl" if torch.cuda.is_available() else "gloo")
    dist.init_process_group(backend, init_method=init_method or "env://",
                            world_size=world_size, rank=rank)
    return dist.get_world_size() > 1


def pod_mesh(mesh_shape: Sequence[int],
             axis_names: Tuple[str, ...] = ("x",)) -> Tuple[np.ndarray, Tuple[str, ...]]:
    """The ranks laid out row-major on ``mesh_shape`` and the axis names:
    rank r holds shard r of ``MultiChipEngine``'s row-major mesh order."""
    mesh_shape = tuple(int(n) for n in mesh_shape)
    total = math.prod(mesh_shape)
    world = dist.get_world_size() if dist.is_initialized() else 1
    if total > world:
        raise ValueError(f"mesh {mesh_shape} needs {total} processes, have {world}")
    names = tuple(axis_names)[:len(mesh_shape)]
    if len(names) != len(mesh_shape):
        raise ValueError(f"{len(mesh_shape)} mesh axes, names {axis_names}")
    return np.arange(total).reshape(mesh_shape), names


class DistGroup:
    """This process's shard of a mesh whose shards are the ranks of
    ``group`` (the default group by default): rank r holds shard r on
    ``device``.  ``shift`` sends to and receives from the neighbour ranks
    with ``batch_isend_irecv`` (an edge rank receives zeros, as JAX's empty
    ``ppermute`` writes); ``reduce_max`` is ``all_reduce(MAX)``."""

    dense = True           # every rank sends a buffer, zeros where it has none

    def __init__(self, mesh_shape, device, group=None):
        self.mesh_shape = tuple(int(n) for n in mesh_shape)
        self.pg = group
        world = dist.get_world_size(group)
        if world != math.prod(self.mesh_shape):
            raise ValueError(f"mesh {self.mesh_shape} needs {math.prod(self.mesh_shape)} "
                             f"ranks, the group has {world}")
        self.rank = dist.get_rank(group)
        self.shards = [self.rank]
        self.devices = [torch.device(device)]

    def on_side(self, j):
        return contextlib.nullcontext()

    def keep_for_side(self, t, j) -> None:
        pass

    def begin_side(self) -> None:
        pass

    def wait_side(self) -> None:
        pass

    def _global(self, shard: int) -> int:
        return shard if self.pg is None else dist.get_global_rank(self.pg, shard)

    def shift(self, xs, axis: int, step: int, side: bool = False) -> List[torch.Tensor]:
        x = xs[0].contiguous()
        dst = neighbour(self.mesh_shape, self.rank, axis, step)
        src = neighbour(self.mesh_shape, self.rank, axis, -step)
        ops, recv = [], None
        if dst is not None:
            ops.append(dist.P2POp(dist.isend, x, self._global(dst), self.pg))
        if src is not None:
            recv = torch.empty_like(x)
            ops.append(dist.P2POp(dist.irecv, recv, self._global(src), self.pg))
        if ops:
            for req in dist.batch_isend_irecv(ops):
                req.wait()
        return [recv if recv is not None else torch.zeros_like(x)]

    def reduce_max(self, xs):
        x = xs[0].clone()
        dist.all_reduce(x, op=dist.ReduceOp.MAX, group=self.pg)
        return [x]

    def read_flags(self, flags) -> List[bool]:
        return [bool(flags[0])]

    def sum_all(self, values: np.ndarray) -> np.ndarray:
        t = torch.from_numpy(np.asarray(values, np.float64)).to(self.devices[0])
        dist.all_reduce(t, op=dist.ReduceOp.SUM, group=self.pg)
        return t.cpu().numpy()
