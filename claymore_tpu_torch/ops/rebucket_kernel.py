"""The full rebucket: the wrapper of the CUDA kernels of ``csrc/rebucket.cu``.

``sort_permute`` is ``core/partition.py:sort_permute`` with every stage on
the card: the home-block keys (``home_keys``), their stable sort
(``key_sort``, this package's own LSD radix sort: the active slots alone,
over the bits below the sentinel, int32 slot indices: 16 bytes a slot in
the first pass and 20 an active slot in each later one, 1.6 GB on
sphere25m's 69.6M slots, against torch.sort's ~7 GB over every slot and
all 32 bits with an int64 index), the segment heads and the tile plan
(``tile_plan``: the segments' starts and bases, each tile's window) and
the placement of every channel (``place``).  A region predicate's offset
stays torch (``partition.region_source``: the predicate is Python).  The
JAX package runs the whole stage in XLA (``claymore_tpu/core/partition.py:83``,
``lax.sort``): no TPU kernel is replaced.

On CUDA tensors each stage launches its kernels or raises; on CPU tensors
it runs its plain twin in ``core/partition.py`` (for the sort,
``torch.sort``, whose index is int64 where the kernel's is int32: the
plain ``place`` takes either).  Under ``torch.profiler``
``sort_permute``'s three stages run inside ``claymore.rebuild.sort``,
``.plan`` and ``.place`` ranges.  There is no fallback from
a kernel to its plain twin.  Each stage counts its launches in
``launches`` (one a call, however many CUDA kernels the stage runs); the
sort also counts its calls, slots and passes in ``sort_stats`` and the
active slots it sorted on the device (``sorted_pair_counter``).
"""

from __future__ import annotations

import ctypes

import torch

from ..config import SimConfig
from ..core import partition
from ..utils.timers import span
from .grid_kernel import _expect

MAX_CHANNELS = 16        # csrc/rebucket.cu: kMaxChannels
_HEADS_CHUNK = 2048      # csrc/rebucket.cu: kChunk, sorted keys a CTA of the heads pass
_SEG_CTAS = 512          # csrc/rebucket.cu: kSegCtas
_SORT_CHUNK = 18432      # csrc/rebucket.cu: kSortChunk, keys a CTA of each sort pass
MAX_DIGIT_BITS = 10      # csrc/rebucket.cu: kMaxDigitBits


def sort_permute(cfg: SimConfig, model, num_tiles: int, region_fn=None):
    """``core/partition.py:sort_permute`` (same arguments, same result bit
    for bit): on a CUDA model every stage runs as kernels; on a CPU model
    each stage's plain twin runs."""
    if model.pos.shape[1] != num_tiles * cfg.particle_tile:
        raise ValueError(f"slot capacity {model.pos.shape[1]} != {num_tiles} tiles")
    with span("claymore.rebuild.sort"):
        skey, perm, region = sort_keys(cfg, model, region_fn)
    with span("claymore.rebuild.plan"):
        dstart, dlen, tile_keys, dropped = tile_plan(cfg, skey, num_tiles, region)
    with span("claymore.rebuild.place"):
        return place(cfg, model, perm, dstart, dlen), tile_keys, dropped


def sort_keys(cfg: SimConfig, model, region_fn=None):
    """``partition.sort_keys``: (skey, perm, region), the home-block keys
    (``home_keys``) with the region's offset, sorted stably; on the card by
    ``key_sort`` (perm int32), on the CPU by the plain twin (perm int64)."""
    if not model.pos.is_cuda:
        return partition.sort_keys(cfg, model, region_fn)
    region = region_fn is not None
    src = partition.region_source(cfg, home_keys(cfg, model), region_fn)
    skey, perm = key_sort(src, partition.region_offsets(cfg, region)[1])
    return skey, perm, region


def sort_plan(sentinel: int):
    """(bits, digit widths) of ``key_sort`` for keys below ``sentinel``: the
    bits of the largest active key, ``bit_length(sentinel - 1)``, in the
    fewest passes of at most ``MAX_DIGIT_BITS``, the widths as even as they
    go, the last the narrowest (18 bits: 9, 9; 26: 9, 9, 8; one pass of
    width 0 where every active key is 0)."""
    if not 1 <= sentinel <= 1 << 30:
        raise ValueError(f"sentinel {sentinel}: the sort takes 1 .. 2^30")
    bits = (sentinel - 1).bit_length()
    passes = max(1, -(-bits // MAX_DIGIT_BITS))
    digit = -(-bits // passes)
    return bits, tuple(min(digit, bits - q * digit) for q in range(passes))


def key_sort(src: torch.Tensor, sentinel: int):
    """``torch.sort(src, stable=True)`` of keys in ``[0, sentinel]`` (a key
    at the sentinel is an inactive slot), bit for bit: (skey i32[S], perm
    i32[S]); on the card the sort kernels of ``csrc/rebucket.cu`` (no host
    read), on the CPU ``torch.sort`` itself (perm int64)."""
    if not src.is_cuda:
        return torch.sort(src, stable=True)
    from . import _build

    dev = src.device
    n = src.shape[0] if src.dim() == 1 else 0
    if n == 0 or n >= 1 << 31:
        raise ValueError(f"{n} keys: the sort kernel takes 1 .. 2^31 - 1")
    _expect(src, torch.int32, (n,), dev, "src")
    bits, widths = sort_plan(sentinel)
    skey = torch.empty_like(src)
    perm = torch.empty_like(src)
    tmp = (torch.empty((min(len(widths) - 1, 2), 2, n), dtype=torch.int32, device=dev)
           if len(widths) > 1 else None)
    buckets = (1 << widths[0]) + 1
    counts = torch.empty((buckets * -(-n // _SORT_CHUNK),), dtype=torch.int32, device=dev)
    totals = torch.empty((buckets,), dtype=torch.int32, device=dev)
    active = torch.empty((1,), dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        err = _build.library().cm_rebucket_sort(
            src.data_ptr(), n, sentinel, bits, widths[0], skey.data_ptr(), perm.data_ptr(),
            None if tmp is None else tmp.data_ptr(), counts.data_ptr(), totals.data_ptr(),
            active.data_ptr(), sorted_pair_counter(dev).data_ptr(),
            torch.cuda.current_stream(dev).cuda_stream)
    _build.check(err, "cm_rebucket_sort")
    launches["rebucket_sort"] += 1
    sort_stats["calls"] += 1
    sort_stats["slots"] += n
    sort_stats["passes"] += len(widths)
    return skey, perm


def sorted_pair_counter(device) -> torch.Tensor:
    """The device counter (i64[1] on ``device``) of the active slots
    ``key_sort`` has sorted (the pairs its digit passes carry), summed over
    every call on the device; over ``sort_stats["slots"]`` it is the share
    of the slots the sort moves.  The rebuild never reads it; a profiling
    script zeroes it (``zero_()``) and reads it after its run."""
    dev = torch.device(device)
    if dev.index is None:
        dev = torch.device(dev.type, torch.cuda.current_device())
    if dev not in _PAIRS:
        _PAIRS[dev] = torch.zeros((1,), dtype=torch.int64, device=dev)
    return _PAIRS[dev]


def home_keys(cfg: SimConfig, model) -> torch.Tensor:
    """``partition.home_keys``: i32[S], each slot's home-block key (``G^3``
    for an inactive slot or one outside the grid); on the card the keys
    kernel."""
    if not model.pos.is_cuda:
        return partition.home_keys(cfg, model)
    from . import _build

    dev = model.pos.device
    s_cap = model.pos.shape[1]
    if s_cap == 0 or s_cap >= 1 << 31:
        raise ValueError(f"{s_cap} slots: the keys kernel takes 1 .. 2^31 - 1")
    _expect(model.pos, torch.float32, (3, s_cap), dev, "pos")
    _expect(model.active, torch.bool, (s_cap,), dev, "active")
    key = torch.empty((s_cap,), dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        err = _build.library().cm_rebucket_keys(
            model.pos.data_ptr(), model.active.data_ptr(), s_cap, cfg.dx_inv, cfg.block_bits,
            cfg.grid_size, key.data_ptr(), torch.cuda.current_stream(dev).cuda_stream)
    _build.check(err, "cm_rebucket_keys")
    launches["rebucket_keys"] += 1
    return key


def tile_plan(cfg: SimConfig, skey: torch.Tensor, num_tiles: int, region: bool = False):
    """``partition.tile_plan``: (dstart, dlen, tile_keys, dropped) of the
    sorted keys ``skey``; on the card the heads and plan kernels, with no
    host read."""
    if not skey.is_cuda:
        return partition.tile_plan(cfg, skey, num_tiles, region)
    seg_start, meta = launch_heads(cfg, skey, region)
    return launch_plan(cfg, skey, seg_start, meta, num_tiles, region)[:4]


def place(cfg: SimConfig, model, perm: torch.Tensor, dstart: torch.Tensor,
          dlen: torch.Tensor):
    """``partition.place``: the model moved into the planned layout, in new
    tensors; on the card the placement kernel."""
    if not model.pos.is_cuda:
        return partition.place(cfg, model, perm, dstart, dlen)
    from . import _build

    dev = model.pos.device
    s_cap = model.pos.shape[1]
    tile = cfg.particle_tile
    num_tiles = s_cap // tile
    if s_cap != num_tiles * tile or s_cap >= 1 << 31:
        raise ValueError(f"slot capacity {s_cap}: not whole tiles of {tile}, or too large")
    _expect(model.pos, torch.float32, (3, s_cap), dev, "pos")
    _expect(model.pid, torch.int32, (s_cap,), dev, "pid")
    _expect(perm, torch.int32, (s_cap,), dev, "perm")
    _expect(dstart, torch.int32, (num_tiles,), dev, "dstart")
    _expect(dlen, torch.int32, (num_tiles,), dev, "dlen")
    for k, v in model.fields.items():
        _expect(v, torch.float32, tuple(v.shape[:-1]) + (s_cap,), dev, k)
    pos = torch.empty_like(model.pos)
    fields = {k: torch.empty_like(v) for k, v in model.fields.items()}
    pid = torch.empty_like(model.pid)
    active = torch.empty((s_cap,), dtype=torch.bool, device=dev)

    def rows(x):
        return [x.data_ptr() + 4 * s_cap * r for r in range(x.numel() // s_cap)]

    ins = rows(model.pos) + [p for v in model.fields.values() for p in rows(v)]
    outs = rows(pos) + [p for k in model.fields for p in rows(fields[k])]
    if len(ins) > MAX_CHANNELS:
        raise NotImplementedError(f"{len(ins)} float channels: the placement kernel "
                                  f"takes at most {MAX_CHANNELS}")
    with torch.cuda.device(dev):
        err = _build.library().cm_rebucket_place(
            perm.data_ptr(), dstart.data_ptr(), dlen.data_ptr(), s_cap, tile, len(ins),
            (ctypes.c_void_p * MAX_CHANNELS)(*ins), (ctypes.c_void_p * MAX_CHANNELS)(*outs),
            model.pid.data_ptr(), pid.data_ptr(), active.data_ptr(),
            torch.cuda.current_stream(dev).cuda_stream)
    _build.check(err, "cm_rebucket_place")
    launches["rebucket_place"] += 1
    return type(model)(pos=pos, fields=fields, active=active, pid=pid, tiles=model.tiles)


def segment_capacity(cfg: SimConfig, slots: int) -> int:
    """The most block segments ``slots`` sorted keys can hold: one per slot,
    and one per block (a block's keys carry the region offset or not, never
    both)."""
    return min(slots, cfg.grid_size ** 3)


def launch_heads(cfg: SimConfig, skey: torch.Tensor, region: bool = False):
    """The heads kernels on the card: (seg_start i32[cap + 1], meta i32[2]);
    the first G + 1 entries of ``seg_start`` are ``partition.segment_heads``'
    result, ``meta`` = (G, active count)."""
    from . import _build

    dev = skey.device
    n = skey.shape[0]
    if n == 0 or n >= 1 << 31:
        raise ValueError(f"{n} sorted keys: the heads kernel takes 1 .. 2^31 - 1")
    _expect(skey, torch.int32, (n,), dev, "skey")
    sentinel = partition.region_offsets(cfg, region)[1]
    seg_start = torch.empty((segment_capacity(cfg, n) + 1,), dtype=torch.int32, device=dev)
    nb = -(-n // _HEADS_CHUNK)
    scratch = torch.empty((2, nb), dtype=torch.int32, device=dev)
    meta = torch.empty((2,), dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        err = _build.library().cm_rebucket_heads(
            skey.data_ptr(), n, sentinel, seg_start.data_ptr(), scratch[0].data_ptr(),
            scratch[1].data_ptr(), meta.data_ptr(), torch.cuda.current_stream(dev).cuda_stream)
    _build.check(err, "cm_rebucket_heads")
    launches["rebucket_heads"] += 1
    return seg_start, meta


def launch_plan(cfg: SimConfig, skey: torch.Tensor, seg_start: torch.Tensor,
                meta: torch.Tensor, num_tiles: int, region: bool = False):
    """The plan kernels on the card from ``launch_heads``' result: (dstart,
    dlen, tile_keys, dropped, base); the first G entries of ``base`` i64 are
    ``partition.segment_bases``' result."""
    from . import _build

    dev = skey.device
    n = skey.shape[0]
    cap = segment_capacity(cfg, n)
    _expect(skey, torch.int32, (n,), dev, "skey")
    _expect(seg_start, torch.int32, (cap + 1,), dev, "seg_start")
    _expect(meta, torch.int32, (2,), dev, "meta")
    if num_tiles * cfg.particle_tile != n:
        raise ValueError(f"{n} sorted keys != {num_tiles} tiles")
    off = partition.region_offsets(cfg, region)[0]
    base = torch.empty((cap,), dtype=torch.int64, device=dev)
    scratch = torch.empty((2, _SEG_CTAS), dtype=torch.int64, device=dev)
    out = torch.empty((3, num_tiles), dtype=torch.int32, device=dev)
    dropped = torch.empty((1,), dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        err = _build.library().cm_rebucket_plan(
            skey.data_ptr(), seg_start.data_ptr(), meta.data_ptr(), cfg.particle_tile,
            cfg.group_tiles, num_tiles, off, cfg.grid_size ** 3, scratch[0].data_ptr(),
            scratch[1].data_ptr(), base.data_ptr(), out[0].data_ptr(), out[1].data_ptr(),
            out[2].data_ptr(), dropped.data_ptr(), torch.cuda.current_stream(dev).cuda_stream)
    _build.check(err, "cm_rebucket_plan")
    launches["rebucket_plan"] += 1
    return out[0], out[1], out[2], dropped, base


# launches per stage, counted where each is launched
launches = {"rebucket_keys": 0, "rebucket_sort": 0, "rebucket_heads": 0, "rebucket_plan": 0,
            "rebucket_place": 0}
# the sort's calls, the slots they took and the digit passes they ran
sort_stats = {"calls": 0, "slots": 0, "passes": 0}
_PAIRS = {}              # device -> sorted_pair_counter
