"""The mesh's halo exchange and migration pack: the wrapper of the CUDA
kernels of ``csrc/halo.cu``.

* ``pack_count`` and ``pack_write``: one shard's halo packs over every
  direction (``parallel/halo.py:pack_windows``, split where
  ``HaloComm.exchange_halo`` splits it: the count, and so the overflow, on
  the main stream; the packs on the side stream); ``pack_windows`` runs
  both on the current stream;
* ``mass_mask``: ``halo.mass_mask``, the blocks a neighbour sent mass into;
* ``add_rows``: ``halo.add_rows``, the received rows added by key;
* ``migrate_pack``: ``halo.migrate_pack``, one shard's crossers along one
  axis as payloads, the new ``active`` and the dropped count.

The JAX package runs all of them in XLA (``claymore_tpu/parallel/multi.py``
``_pack_window``, ``halo_mass_mask``, ``add_halo``, ``migrate``): no TPU
kernel is replaced.  On CUDA tensors each function launches its kernels or
raises; on CPU tensors it runs its plain twin in ``parallel/halo.py``.
There is no fallback from a kernel to its plain twin.  Each function counts
its launches in ``launches`` (one a call, however many CUDA kernels it
runs; the halo pack under ``halo_pack`` in ``pack_count``).
"""

from __future__ import annotations

import ctypes
import dataclasses
from typing import List, Optional, Sequence

import torch

from ..config import SimConfig
from ..core.types import ParticleModel
from ..parallel import halo
from .grid_kernel import _expect

MAX_DIRS = 8             # csrc/halo.cu: kMaxDirs, directions of one pack
MAX_AXES = 2             # kMaxAxes, mesh axes a direction crosses
MAX_CHANNELS = 32        # kMaxChannels, rows of a migration payload
HALO_CHUNK = 256         # kThreads * kHaloRounds: pool rows a CTA of the halo plan
MIG_CHUNK = 4096         # kThreads * kMigRounds: slots a CTA of the migration plan
INFO = ("count", "scan", "write", "rows", "mask", "add", "migrate_count", "migrate_write",
        "payload")       # cm_halo_info's sub-kernels, in order


def _stream(dev):
    return torch.cuda.current_stream(dev).cuda_stream


def _spec(windows: Sequence[halo.Window]):
    if not 0 < len(windows) <= MAX_DIRS or any(len(w) > MAX_AXES for w in windows):
        raise ValueError(f"{len(windows)} windows: the halo kernels take 1 .. {MAX_DIRS}, "
                         f"each crossing at most {MAX_AXES} axes")
    flat = []
    for win in windows:
        axes = list(win) + [(0, 0)] * (MAX_AXES - len(win))
        flat += [len(win)] + [v for dim_edge in axes for v in dim_edge]
    return (ctypes.c_int * len(flat))(*flat)


def _pool_rows(x: torch.Tensor, name: str) -> None:
    if x.dim() != 3 or tuple(x.shape[1:]) != (16, 128) or x.dtype != torch.float32:
        raise ValueError(f"{name}: expected f32[R, 16, 128], got {x.dtype} {tuple(x.shape)}")
    if not x.is_contiguous() or x.data_ptr() % 16:
        raise ValueError(f"{name} must be contiguous and 16-byte aligned")


@dataclasses.dataclass
class PackPlan:
    """What ``pack_count`` leaves for ``pack_write``: the windows, and on
    the CPU each window's marks, on the card the compaction's chunk counts
    and prefixes (i32[2, windows, chunks]) and each window's oct count.
    ``buffers``: the tensors ``pack_write`` reads (made on the stream
    ``pack_count`` ran on)."""

    windows: tuple
    marks: Optional[List[torch.Tensor]] = None
    chunks: Optional[torch.Tensor] = None
    total: Optional[torch.Tensor] = None

    @property
    def buffers(self) -> List[torch.Tensor]:
        return list(self.marks) if self.marks is not None else [self.chunks, self.total]


def pack_count(cfg: SimConfig, keys: torch.Tensor, count: torch.Tensor,
               windows: Sequence[halo.Window], h: int, margin: int):
    """(plan, overflow i32[1]): which of the partition's octs each window
    holds, and the octs past ``h`` summed over every window
    (``halo.window_marks``); on the card the count and scan kernels."""
    windows = tuple(tuple(w) for w in windows)
    if not keys.is_cuda:
        marks, overflow = halo.window_marks(cfg, keys, count, windows, h, margin)
        return PackPlan(windows, marks=marks), overflow
    from . import _build

    dev = keys.device
    nb = cfg.max_active_octs
    _expect(keys, torch.int32, (nb,), dev, "keys")
    _expect(count, torch.int32, (1,), dev, "count")
    spec = _spec(windows)
    n = len(windows)
    i32 = dict(dtype=torch.int32, device=dev)
    scratch = torch.empty((2, n, -(-nb // HALO_CHUNK)), **i32)
    total, overflow = torch.empty((n,), **i32), torch.empty((1,), **i32)
    with torch.cuda.device(dev):
        err = _build.library().cm_halo_count(
            keys.data_ptr(), count.data_ptr(), nb, cfg.num_oct_keys, cfg.grid_size, margin,
            spec, n, h, scratch[0].data_ptr(), scratch[1].data_ptr(), total.data_ptr(),
            overflow.data_ptr(), _stream(dev))
    _build.check(err, "cm_halo_count")
    launches["halo_pack"] += 1
    return PackPlan(windows, chunks=scratch, total=total), overflow


def pack_write(cfg: SimConfig, pool: torch.Tensor, keys: torch.Tensor, count: torch.Tensor,
               plan: PackPlan, packed: Sequence[bool], h: int, margin: int):
    """Per window of ``plan``, ``halo.pack_marked``'s (meta i32[2, h], rows
    f32[h, 16, 128]) where ``packed``, else None; on the card the write
    pass and the rows kernel (one launch each for every packed window),
    each window's rows in a tensor of their own."""
    if not pool.is_cuda:
        return [halo.pack_marked(cfg, pool, keys, cond, win, h, margin) if p else None
                for cond, win, p in zip(plan.marks, plan.windows, packed)]
    from . import _build

    dev = pool.device
    nb = cfg.max_active_octs
    n = len(plan.windows)
    if len(packed) != n:
        raise ValueError(f"{len(packed)} packed flags for {n} windows")
    _pool_rows(pool, "pool")
    _expect(pool, torch.float32, (nb + 1, 16, 128), dev, "pool")
    _expect(keys, torch.int32, (nb,), dev, "keys")
    _expect(count, torch.int32, (1,), dev, "count")
    dirs = [d for d, p in enumerate(packed) if p]
    out: List[Optional[tuple]] = [None] * n
    if not dirs:
        return out
    idx = torch.empty((n, h), dtype=torch.int32, device=dev)
    meta = torch.empty((len(dirs), 2, h), dtype=torch.int32, device=dev)
    for p, d in enumerate(dirs):      # a row buffer each: it is freed once shipped
        out[d] = (meta[p], torch.empty((h, 16, 128), dtype=torch.float32, device=dev))
    ptrs = lambda i: (ctypes.c_void_p * MAX_DIRS)(*[out[d][i].data_ptr() for d in dirs])
    with torch.cuda.device(dev):
        err = _build.library().cm_halo_write(
            pool.data_ptr(), keys.data_ptr(), count.data_ptr(), nb, cfg.num_oct_keys,
            cfg.grid_size, margin, _spec(plan.windows), n, (ctypes.c_int * len(dirs))(*dirs),
            len(dirs), h, plan.chunks[0].data_ptr(), plan.chunks[1].data_ptr(),
            plan.total.data_ptr(), idx.data_ptr(), ptrs(0), ptrs(1), _stream(dev))
    _build.check(err, "cm_halo_write")
    return out


def pack_windows(cfg: SimConfig, pool: torch.Tensor, keys: torch.Tensor, count: torch.Tensor,
                 windows: Sequence[halo.Window], packed: Sequence[bool], h: int, margin: int):
    """``halo.pack_windows``: (packs, overflow), both passes on the current
    stream."""
    plan, overflow = pack_count(cfg, keys, count, windows, h, margin)
    return pack_write(cfg, pool, keys, count, plan, packed, h, margin), overflow


def _received(received, dev, what: str):
    """(n, h, keys pointers, second pointers) of the received (keys, bits,
    rows): ``what`` "bits" or "rows" picks the second."""
    n = len(received)
    if n > MAX_DIRS:
        raise ValueError(f"{n} received directions: the halo kernels take at most {MAX_DIRS}")
    h = received[0][0].shape[0]
    keys, other = [], []
    for d, (k, bits, rows) in enumerate(received):
        _expect(k, torch.int32, (h,), dev, f"received[{d}] keys")
        if what == "bits":
            _expect(bits, torch.int32, (h,), dev, f"received[{d}] bits")
            other.append(bits.data_ptr())
        else:
            _pool_rows(rows, f"received[{d}] rows")
            _expect(rows, torch.float32, (h, 16, 128), dev, f"received[{d}] rows")
            other.append(rows.data_ptr())
        keys.append(k.data_ptr())
    arr = lambda ptrs: (ctypes.c_void_p * MAX_DIRS)(*ptrs)
    return n, h, arr(keys), arr(other)


def mass_mask(cfg: SimConfig, received) -> Optional[torch.Tensor]:
    """``halo.mass_mask``: bool[G^3], the blocks whose mass bit is set in
    some received direction, None if nothing was received; on the card a
    memset and one launch over every direction."""
    if not received:
        return None
    if not received[0][0].is_cuda:
        return halo.mass_mask(cfg, received)
    from . import _build

    dev = received[0][0].device
    n, h, keys, bits = _received(received, dev, "bits")
    n3 = cfg.grid_size ** 3
    mask = torch.empty((n3 + 1,), dtype=torch.bool, device=dev)
    with torch.cuda.device(dev):
        err = _build.library().cm_halo_mask(n, keys, bits, h, cfg.num_oct_keys, cfg.grid_size,
                                            mask.data_ptr(), _stream(dev))
    _build.check(err, "cm_halo_mask")
    launches["halo_mask"] += 1
    return mask[:n3]


def add_rows(cfg: SimConfig, pool: torch.Tensor, table: torch.Tensor, received) -> torch.Tensor:
    """``halo.add_rows``: ``pool`` (in place) plus each received row at its
    key's slot, the null row zero; on the card one launch a direction, in
    order, after zeroing the null row."""
    if not received:
        return pool
    if not pool.is_cuda:
        return halo.add_rows(cfg, pool, table, received)
    from . import _build

    dev = pool.device
    no, nb = cfg.num_oct_keys, cfg.max_active_octs
    _pool_rows(pool, "pool")
    _expect(pool, torch.float32, (nb + 1, 16, 128), dev, "pool")
    _expect(table, torch.int32, (no + 1,), dev, "table")
    n, h, keys, rows = _received(received, dev, "rows")
    with torch.cuda.device(dev):
        err = _build.library().cm_halo_add(n, keys, rows, h, table.data_ptr(), no,
                                           cfg.null_oct, pool.data_ptr(), _stream(dev))
    _build.check(err, "cm_halo_add")
    launches["halo_add"] += 1
    return pool


def migrate_pack(cfg: SimConfig, m: ParticleModel, dim: int, lo: int, hi: int, k: int):
    """``halo.migrate_pack``: (left f32[C, k], right f32[C, k], active,
    dropped i32[1]), one shard's crossers along ``dim``; on the card the
    count, scan, write and payload kernels."""
    if not m.pos.is_cuda:
        return halo.migrate_pack(cfg, m, dim, lo, hi, k)
    from . import _build

    dev = m.pos.device
    s_cap = m.pos.shape[1]
    if not 0 < s_cap < 1 << 31 or not 0 < k < 1 << 31 or dim not in (0, 1, 2):
        raise ValueError(f"migrate_pack: {s_cap} slots, capacity {k}, dim {dim}")
    _expect(m.pos, torch.float32, (3, s_cap), dev, "pos")
    _expect(m.active, torch.bool, (s_cap,), dev, "active")
    _expect(m.pid, torch.int32, (s_cap,), dev, "pid")
    row = lambda x, c: x.data_ptr() + c * s_cap * 4
    src = [row(m.pos, 0), row(m.pos, 1), row(m.pos, 2), None, m.pid.data_ptr()]
    for name, v in sorted(m.fields.items()):
        c = 1 if v.dim() == 1 else v.shape[0]
        _expect(v, torch.float32, (s_cap,) if v.dim() == 1 else (c, s_cap), dev, name)
        src += [row(v, i) for i in range(c)]
    n_ch = len(src)
    if n_ch > MAX_CHANNELS:
        raise NotImplementedError(f"{n_ch} payload rows: the migration kernel takes at most "
                                  f"{MAX_CHANNELS}")
    i32 = dict(dtype=torch.int32, device=dev)
    left = torch.empty((n_ch, k), dtype=torch.float32, device=dev)
    right = torch.empty((n_ch, k), dtype=torch.float32, device=dev)
    active = torch.empty((s_cap,), dtype=torch.bool, device=dev)
    idx = torch.empty((2, k), **i32)
    scratch = torch.empty((2, 2, -(-s_cap // MIG_CHUNK)), **i32)
    total, dropped = torch.empty((2,), **i32), torch.empty((1,), **i32)
    with torch.cuda.device(dev):
        err = _build.library().cm_migrate_pack(
            row(m.pos, dim), m.active.data_ptr(), s_cap, cfg.dx_inv, cfg.block_bits, lo, hi, k,
            n_ch, (ctypes.c_void_p * MAX_CHANNELS)(*src), m.pid.data_ptr(), active.data_ptr(),
            idx.data_ptr(), scratch[0].data_ptr(), scratch[1].data_ptr(), total.data_ptr(),
            left.data_ptr(), right.data_ptr(), dropped.data_ptr(), _stream(dev))
    _build.check(err, "cm_migrate_pack")
    launches["migrate_pack"] += 1
    return left, right, active, dropped


def kernel_info() -> dict:
    """What the card gives each sub-kernel (``INFO``): registers per thread
    and resident blocks per SM."""
    from . import _build

    out = {}
    for i, name in enumerate(INFO):
        buf = (ctypes.c_int * 2)()
        _build.check(_build.library().cm_halo_info(i, buf), "cm_halo_info")
        out[name] = {"registers": buf[0], "blocks_per_sm": buf[1]}
    return out


# launches per function, counted where each is launched
launches = {"halo_pack": 0, "halo_mask": 0, "halo_add": 0, "migrate_pack": 0}
