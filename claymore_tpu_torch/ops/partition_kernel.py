"""The partition rebuild and the first-k compaction: the wrapper of the CUDA
kernels of ``csrc/partition.cu``.

``first_marked`` is ``core/partition.py:_first_marked`` (``jnp.nonzero(mark,
size=, fill_value=)``) and also returns the count of marked entries, so
that callers drop their own sums.  ``rebuild`` is
``core/partition.py:rebuild`` as two kernels: ``oct_mask`` (the twin
``partition.oct_flags``: the octs holding grid mass, the tiles' blocks
dilated by the transfer stencil and the halo's blocks, never building the
G^3 block cube) and ``remap`` (the twin ``partition.remap``: the oct keys
compacted by ``first_marked``'s passes, the table, the count and overflow,
and the pool rows copied to their new slots).  ``finalize_tiles`` is
``core/partition.py:finalize_tiles``.  The JAX package runs all of them in
XLA (``claymore_tpu/core/partition.py:401`` and ``:353``): no TPU kernel is
replaced.

On CUDA tensors each function launches its kernels or raises; on CPU
tensors it runs its plain twin in ``core/partition.py``.  There is no
fallback from a kernel to its plain twin.  Each function counts its
launches in ``launches`` (one a call, however many CUDA kernels it runs;
``remap`` runs ``first_marked``'s passes for its keys and counts under
both).
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from ..config import SimConfig
from ..core import partition as part
from ..core.types import Partition, TileMap
from .grid_kernel import _expect

CHUNK = 16384            # csrc/partition.cu: kChunk, flags a CTA of the compaction
ROUND = 4096             # kRoundBytes: flags a CTA takes a round
VEC = 16                 # kVec: flags a thread loads at once
MAX_MODELS = 16          # kMaxModels
INFO = ("count", "scan", "write", "fill", "base", "mass", "tiles", "write_table", "rows",
        "finalize")      # cm_partition_info's sub-kernels, in order


def _aligned(x: torch.Tensor) -> torch.Tensor:
    """``x`` (contiguous), copied where its data is not 16-byte aligned:
    the kernels read flags 16 at a time."""
    return x if x.data_ptr() % 16 == 0 else x.clone()


def _stream(dev):
    return torch.cuda.current_stream(dev).cuda_stream


def first_marked(mark: torch.Tensor, size: int, fill: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """(idx i64[size], total i32[1]): the indices of the first ``size``
    True entries of ``mark`` (bool[N]) in ascending order, ``fill`` past
    the last one (``partition._first_marked``), and the count of True
    entries."""
    if not mark.is_cuda:
        return part._first_marked(mark, size, fill), mark.sum(dtype=torch.int32).reshape(1)
    from . import _build

    dev = mark.device
    n = mark.shape[0] if mark.dim() == 1 else -1
    if n <= 0 or n >= 1 << 31 or not 0 < size < 1 << 31 or not -(1 << 31) <= fill < 1 << 31:
        raise ValueError(f"first_marked: mark of shape {tuple(mark.shape)}, size {size}, "
                         f"fill {fill}: takes bool[1 .. 2^31 - 1] and 1 .. 2^31 - 1 indices")
    _expect(mark, torch.bool, (n,), dev, "mark")
    mark = _aligned(mark)
    out = torch.empty((size,), dtype=torch.int64, device=dev)
    total = torch.empty((1,), dtype=torch.int32, device=dev)
    scratch = torch.empty((2, -(-n // CHUNK)), dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        err = _build.library().cm_first_marked(
            mark.data_ptr(), n, size, fill, out.data_ptr(), total.data_ptr(),
            scratch[0].data_ptr(), scratch[1].data_ptr(), _stream(dev))
    _build.check(err, "cm_first_marked")
    launches["first_marked"] += 1
    return out, total


def oct_mask(cfg: SimConfig, pool: torch.Tensor, partition: Partition,
             model_block_keys: Tuple[torch.Tensor, ...],
             extra_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``partition.oct_flags``: bool[num_oct_keys], the octs the rebuild
    keeps; on the card the oct-mask kernels."""
    if not pool.is_cuda:
        return part.oct_flags(cfg, pool, partition, model_block_keys, extra_mask)
    from . import _build

    dev = pool.device
    no, nb, g = cfg.num_oct_keys, cfg.max_active_octs, cfg.grid_size
    _expect(pool, torch.float32, (nb + 1, 16, 128), dev, "pool")
    _expect(partition.keys, torch.int32, (nb,), dev, "partition.keys")
    _expect(partition.count, torch.int32, (1,), dev, "partition.count")
    if len(model_block_keys) > MAX_MODELS:
        raise NotImplementedError(f"{len(model_block_keys)} models: the oct-mask kernel "
                                  f"takes at most {MAX_MODELS}")
    for i, k in enumerate(model_block_keys):
        _expect(k, torch.int32, (k.shape[0],), dev, f"model_block_keys[{i}]")
    extra = None
    if extra_mask is not None:
        extra = extra_mask.reshape(-1)
        _expect(extra, torch.bool, (g ** 3,), dev, "extra_mask")
        extra = _aligned(extra)
    flags = torch.empty((no,), dtype=torch.bool, device=dev)
    ptrs = (ctypes.c_void_p * MAX_MODELS)(*[k.data_ptr() for k in model_block_keys])
    counts = (ctypes.c_int * MAX_MODELS)(*[k.shape[0] for k in model_block_keys])
    with torch.cuda.device(dev):
        err = _build.library().cm_partition_oct_mask(
            pool.data_ptr(), partition.keys.data_ptr(), partition.count.data_ptr(), nb, no,
            len(model_block_keys), ptrs, counts, None if extra is None else extra.data_ptr(),
            g, cfg.arena_lo, cfg.arena_span, flags.data_ptr(), _stream(dev))
    _build.check(err, "cm_partition_oct_mask")
    launches["oct_mask"] += 1
    return flags


def remap(cfg: SimConfig, pool: torch.Tensor, partition: Partition,
          flags: torch.Tensor) -> Tuple[Partition, torch.Tensor]:
    """``partition.remap``: (the new partition, the remapped pool) from the
    oct flags; on the card the remap kernels."""
    if not pool.is_cuda:
        return part.remap(cfg, pool, partition, flags)
    from . import _build

    dev = pool.device
    no, nb = cfg.num_oct_keys, cfg.max_active_octs
    _expect(pool, torch.float32, (nb + 1, 16, 128), dev, "pool")
    _expect(partition.table, torch.int32, (no + 1,), dev, "partition.table")
    _expect(flags, torch.bool, (no,), dev, "flags")
    flags = _aligned(flags)
    i32 = dict(dtype=torch.int32, device=dev)
    keys = torch.empty((nb,), **i32)
    table = torch.empty((no + 1,), **i32)
    count, overflow, total = (torch.empty((1,), **i32) for _ in range(3))
    scratch = torch.empty((2, -(-no // CHUNK)), **i32)
    new_pool = torch.empty_like(pool)
    with torch.cuda.device(dev):
        err = _build.library().cm_partition_remap(
            flags.data_ptr(), no, nb, cfg.null_oct, pool.data_ptr(), partition.table.data_ptr(),
            keys.data_ptr(), table.data_ptr(), count.data_ptr(), overflow.data_ptr(),
            new_pool.data_ptr(), total.data_ptr(), scratch[0].data_ptr(),
            scratch[1].data_ptr(), _stream(dev))
    _build.check(err, "cm_partition_remap")
    launches["first_marked"] += 1
    launches["remap"] += 1
    return Partition(table=table, keys=keys, count=count, overflow=overflow), new_pool


def rebuild(cfg: SimConfig, pool: torch.Tensor, partition: Partition,
            model_block_keys: Tuple[torch.Tensor, ...],
            extra_mask: Optional[torch.Tensor] = None) -> Tuple[Partition, torch.Tensor]:
    """``partition.rebuild`` (same arguments, same result bit for bit): on
    the card ``oct_mask`` then ``remap``; on the CPU the plain version."""
    if not pool.is_cuda:
        return part.rebuild(cfg, pool, partition, model_block_keys, extra_mask)
    return remap(cfg, pool, partition,
                 oct_mask(cfg, pool, partition, model_block_keys, extra_mask))


def finalize_tiles(cfg: SimConfig, partition: Partition, tile_keys: torch.Tensor,
                   dropped: torch.Tensor) -> TileMap:
    """``partition.finalize_tiles``: each tile's block address, coordinates
    and flag in the new partition; on the card the finalize kernel."""
    if not tile_keys.is_cuda:
        return part.finalize_tiles(cfg, partition, tile_keys, dropped)
    from . import _build

    dev = tile_keys.device
    n = tile_keys.shape[0]
    if n == 0 or n >= 1 << 31:
        raise ValueError(f"{n} tiles: the finalize kernel takes 1 .. 2^31 - 1")
    _expect(tile_keys, torch.int32, (n,), dev, "tile_keys")
    _expect(partition.table, torch.int32, (cfg.num_oct_keys + 1,), dev, "partition.table")
    block = torch.empty((n,), dtype=torch.int32, device=dev)
    bcoord = torch.empty((3, n), dtype=torch.int32, device=dev)
    tvalid = torch.empty((n,), dtype=torch.bool, device=dev)
    with torch.cuda.device(dev):
        err = _build.library().cm_partition_finalize_tiles(
            tile_keys.data_ptr(), n, partition.table.data_ptr(), cfg.grid_size,
            cfg.num_oct_keys, cfg.null_oct, cfg.null_block, block.data_ptr(),
            bcoord.data_ptr(), tvalid.data_ptr(), _stream(dev))
    _build.check(err, "cm_partition_finalize_tiles")
    launches["finalize_tiles"] += 1
    return TileMap(block=block, bcoord=bcoord, tvalid=tvalid, dropped=dropped)


def kernel_info() -> dict:
    """What the card gives each sub-kernel (``INFO``): registers per thread
    and resident blocks per SM."""
    from . import _build

    out = {}
    for i, name in enumerate(INFO):
        buf = (ctypes.c_int * 2)()
        _build.check(_build.library().cm_partition_info(i, buf), "cm_partition_info")
        out[name] = {"registers": buf[0], "blocks_per_sm": buf[1]}
    return out


# launches per function, counted where each is launched
launches = {"first_marked": 0, "oct_mask": 0, "remap": 0, "finalize_tiles": 0}
