"""The partition kernels' decomposition (``csrc/partition.cu``) emulated on
the CPU and held to the JAX package.

Each kernel is emulated pass by pass at its own chunk, round and vector
widths (``ops/partition_kernel.py``: ``CHUNK``, ``ROUND``, ``VEC``): the
compaction's per-CTA counts, their scan, the write pass in which only the
CTAs whose prefix lies below ``size`` read their chunk again (every CTA
where it writes the table) and the tail fill; the oct flags from their
three sources (the halo mask reduced 8 blocks to an oct, the live rows with
mass, the tiles' blocks dilated by the stencil's z range per (x, y)); the
remap's row copy; the per-tile finalize.  The emulations are held to
``jnp.nonzero(..., size=, fill_value=)`` and to the JAX package's
``rebuild`` / ``finalize_tiles`` on the same inputs, made from a numpy
seed, and to the port's plain twins (``core/partition.py``).  They move
data, compare floats with zero and do integer arithmetic: every result is
equal, pool rows bit for bit."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from claymore_tpu.core import partition as jpart
from claymore_tpu.core.types import Partition as JPartition
from claymore_tpu_torch.core import partition
from claymore_tpu_torch.core.types import Partition
from claymore_tpu_torch.ops import partition_kernel as pk

from tests.torch_port_helpers import configs, to_np

THREADS = pk.ROUND // pk.VEC          # threads of a compaction CTA
ROUNDS = pk.CHUNK // pk.ROUND         # rounds a CTA takes over its chunk
POISON = -7                           # written by no pass: every entry must be overwritten


# --------------------------------------------------------------------------
# the emulations
# --------------------------------------------------------------------------

def emulate_compact(mark: np.ndarray, size: int, fill: int, null_slot=None):
    """``csrc/partition.cu:compact``: (out i64[size], total, table i64[N] or
    None, the CTAs that read their chunk a second time).  With
    ``null_slot`` every CTA runs the write pass and also writes each flag's
    table entry (its rank below ``size``, else ``null_slot``)."""
    n = mark.shape[0]
    nchunks = -(-n // pk.CHUNK)
    flags = np.zeros(nchunks * pk.CHUNK, bool)
    flags[:n] = mark != 0
    lanes = flags.reshape(nchunks, ROUNDS, THREADS, pk.VEC)   # 16 flags a thread a round
    cta_count = lanes.sum(axis=(1, 2, 3))                     # pass 1
    cta_off = np.cumsum(cta_count) - cta_count                # pass 2: one CTA's scan
    total = int(cta_count.sum())
    out = np.full(size, POISON, np.int64)
    table = None if null_slot is None else np.full(n, POISON, np.int64)
    reread = 0
    j = np.arange(pk.VEC)[None, :]
    t = np.arange(THREADS)[:, None]
    for b in range(nchunks):                                  # pass 3
        carry = int(cta_off[b])
        if table is None and carry >= size:
            continue
        reread += 1
        for r in range(ROUNDS):
            w = lanes[b, r]
            c = w.sum(axis=1)
            k0 = carry + np.cumsum(c) - c                     # block scan of the threads' counts
            rank = k0[:, None] + np.cumsum(w, axis=1) - w     # along each thread's 16 flags
            idx = b * pk.CHUNK + r * pk.ROUND + t * pk.VEC + j
            place = w & (rank < size)
            assert (out[rank[place]] == POISON).all(), "an index written twice"
            out[rank[place]] = idx[place]
            if table is not None:
                inside = idx < n
                table[idx[inside]] = np.where(place, rank, null_slot)[inside]
            carry += int(c.sum())
            if table is None and carry >= size:
                break
    tail = np.arange(size) >= total                           # pass 4
    out[tail] = fill
    assert (out != POISON).all(), "an index never written"
    return out, total, table, reread


def emulate_oct_mask(cfg, pool, keys, count, tile_keys, extra):
    """``csrc/partition.cu:cm_partition_oct_mask``: bool[num_oct_keys]."""
    no, nb, g = cfg.num_oct_keys, cfg.max_active_octs, cfg.grid_size
    n3 = g ** 3
    # base pass: every flag from its oct's 8 block bytes of the halo mask
    flags = np.zeros(no, bool) if extra is None else extra.reshape(no, 8).any(axis=1)
    # mass pass: one warp a live row, lane l reading float4 l + 32 q of rows 0-3
    for row in range(min(nb, int(count))):
        key = int(keys[row])
        if 0 <= key < no:
            lanes = pool[row, 0:4].reshape(4, 32, 4)
            if (lanes != 0.0).any():
                flags[key] = True
    # tile pass: one thread a tile, one store per oct its stencil's z range meets
    lo, hi = cfg.arena_lo, cfg.arena_lo + cfg.arena_span - 1
    gzo = g >> 3
    for tk in tile_keys:
        for t, k in enumerate(tk):
            if not 0 <= k < n3 or (t > 0 and tk[t - 1] == k):
                continue
            bx, by, bz = k // (g * g), (k // g) % g, k % g
            z0, z1 = max(bz + lo, 0) >> 3, min(bz + hi, g - 1) >> 3
            for x in range(max(bx + lo, 0), min(bx + hi, g - 1) + 1):
                for y in range(max(by + lo, 0), min(by + hi, g - 1) + 1):
                    flags[(x * g + y) * gzo + z0:(x * g + y) * gzo + z1 + 1] = True
    return flags


def emulate_remap(cfg, pool, old_table, flags):
    """``csrc/partition.cu:cm_partition_remap``: (keys, table, count,
    overflow, new pool)."""
    no, nb = cfg.num_oct_keys, cfg.max_active_octs
    keys, total, table, reread = emulate_compact(flags, nb, no, null_slot=cfg.null_oct)
    assert reread == -(-no // pk.CHUNK)
    table = np.append(table, cfg.null_oct)
    new_pool = np.zeros_like(pool)
    for i in range(nb):                                       # one CTA a row
        if keys[i] < no:
            new_pool[i] = pool[old_table[keys[i]]]            # null_oct: the old null row
    return (keys.astype(np.int32), table.astype(np.int32), min(total, nb),
            max(total - nb, 0), new_pool)


def emulate_finalize(cfg, table, tk):
    """``csrc/partition.cu:finalize_kernel``: (block, bcoord, tvalid)."""
    g, no = cfg.grid_size, cfg.num_oct_keys
    n3 = g ** 3
    valid = tk < n3
    kc = np.minimum(tk, n3 - 1)
    okey = np.where(valid, (tk // g) * (g >> 3) + (tk % g) // 8, no)
    oslot = table[okey]
    bcoord = np.where(valid[None], np.stack([np.minimum(kc // (g * g), g - 1), (kc // g) % g,
                                             kc % g]), 0)
    block = np.where(valid & (oslot != cfg.null_oct), oslot * 8 + (kc & 7), cfg.null_block)
    return block.astype(np.int32), bcoord.astype(np.int32), valid


# --------------------------------------------------------------------------
# the first-k compaction
# --------------------------------------------------------------------------

N = 3 * pk.CHUNK + 123                # three and a bit chunks: the last one ragged


def _mark(case, rng):
    if case == "all_false":
        return np.zeros(N, bool)
    if case == "all_true":
        return np.ones(N, bool)
    if case == "suffix":              # ~active after a rebuild: holes, then a long suffix
        m = rng.uniform(size=N) < 0.02
        m[N // 3:] = True
        return m
    if case == "whole_chunks":
        return rng.uniform(size=2 * pk.CHUNK) < 0.3
    if case == "tiny":
        return np.array([False, True, True, False, True])
    return rng.uniform(size=N) < 0.01     # sparse


@pytest.mark.parametrize("case,size", [
    ("sparse", "below"), ("sparse", "equal"), ("sparse", "above"), ("sparse", "first"),
    ("all_false", "one"), ("all_false", "above"), ("all_true", "below"), ("all_true", "equal"),
    ("suffix", "below"), ("suffix", "above"), ("whole_chunks", "below"),
    ("whole_chunks", "above"), ("tiny", "below"), ("tiny", "above")])
def test_first_marked_emulation_equals_jnp_nonzero(case, size):
    rng = np.random.default_rng(11)
    mark = _mark(case, rng)
    total = int(mark.sum())
    size = {"below": max(total // 3, 1), "equal": total, "above": total + 37, "first": 1,
            "one": 1}[size]
    fill = mark.shape[0] + 5
    out, got_total, _, reread = emulate_compact(mark, size, fill)
    want = np.asarray(jnp.nonzero(jnp.asarray(mark), size=size, fill_value=fill)[0])
    np.testing.assert_array_equal(out, want)
    assert got_total == total
    # only the CTAs whose prefix lies below size read their chunk again
    counts = np.add.reduceat(np.append(mark, np.zeros(-mark.shape[0] % pk.CHUNK, bool)),
                             np.arange(0, mark.shape[0], pk.CHUNK))
    assert reread == int(((np.cumsum(counts) - counts) < size).sum())
    # the port's plain twin and the wrapper on the CPU
    twin = partition._first_marked(torch.from_numpy(mark), size, fill)
    np.testing.assert_array_equal(to_np(twin), out)
    idx, tot = pk.first_marked(torch.from_numpy(mark), size, fill)
    np.testing.assert_array_equal(to_np(idx), out)
    assert idx.dtype == torch.int64 and tot.dtype == torch.int32 and int(tot[0]) == total


def test_first_marked_on_the_cpu_launches_nothing():
    before = dict(pk.launches)
    pk.first_marked(torch.ones(10, dtype=torch.bool), 4, 10)
    assert pk.launches == before


# --------------------------------------------------------------------------
# the partition rebuild
# --------------------------------------------------------------------------

REBUILD_CASES = ["span2", "span4", "faces_span2", "faces_span4", "extra", "mass_only",
                 "overflow", "dirty_null", "two_models", "empty"]


def _face_keys(g):
    """Block keys of the 8 corners, the 6 face centres and some edge blocks."""
    c = []
    for x in (0, g - 1):
        for y in (0, g - 1):
            for z in (0, g - 1):
                c.append((x, y, z))
    m = g // 2
    c += [(0, m, m), (g - 1, m, m), (m, 0, m), (m, g - 1, m), (m, m, 0), (m, m, g - 1),
          (0, 0, m), (g - 1, m, 0), (m, g - 1, g - 1), (0, 7, 8), (g - 1, 8, 7)]
    return [(x * g + y) * g + z for x, y, z in c]


def _rebuild_inputs(case, seed=0):
    """(jcfg, cfg, pool, table, keys, count, tile key lists, extra mask or
    None, the rows that hold -0.0 and NaN mass): an old partition of
    random octs, its pool rows random (some without mass in rows 0-3, one
    of -0.0, one holding a NaN; rows past the count and, for
    ``dirty_null``, the null row dirty), tiles of random blocks (runs of
    one key, sentinels; the grid's faces, corners and edges for
    ``faces_*``)."""
    rng = np.random.default_rng(seed)
    nb = 24 if case == "overflow" else 160
    every = 4 if case.endswith("span4") else 1
    jcfg, cfg = configs(domain_bits=6, max_active_blocks=nb, rebucket_every=every)
    g, no = cfg.grid_size, cfg.num_oct_keys
    n3 = g ** 3
    count = 0 if case == "empty" else nb // 2
    old = np.sort(rng.choice(no, size=count, replace=False)).astype(np.int32)
    keys = np.full(nb, no, np.int32)
    keys[:count] = old
    keys[count:count + 3] = rng.choice(no, size=3)            # past the count: not live
    table = np.full(no + 1, cfg.null_oct, np.int32)
    table[old] = np.arange(count, dtype=np.int32)
    pool = rng.normal(size=(nb + 1, 16, 128)).astype(np.float32)
    pool[rng.uniform(size=nb + 1) < 0.3, 0:4] = 0.0           # momentum but no mass
    special = {}
    if count >= 2:
        pool[0, 0:4] = -0.0
        pool[1, 0:4] = 0.0
        pool[1, 2, 77] = np.nan
        special = {"negzero": int(old[0]), "nan": int(old[1])}
    if case != "dirty_null":
        pool[nb] = 0.0
    tiles = []
    if case not in ("mass_only", "empty"):
        n_tiles = 120 if case == "overflow" else 48
        blocks = rng.integers(0, n3, size=n_tiles)
        if case.startswith("faces"):
            blocks = np.array(_face_keys(g) * 2)
        runs = np.repeat(blocks, rng.integers(1, 4, size=blocks.shape[0]))
        runs[rng.uniform(size=runs.shape[0]) < 0.1] = n3      # tiles holding nothing
        tiles.append(runs.astype(np.int32))
        if case == "two_models":
            tiles.append(np.append(rng.integers(0, n3, size=9), n3).astype(np.int32))
    extra = None
    if case == "extra":
        extra = rng.uniform(size=n3) < 0.01
    return jcfg, cfg, pool, table, keys, count, tiles, extra, special


@pytest.mark.parametrize("case", REBUILD_CASES)
def test_oct_mask_emulation_equals_the_twin_and_jax(case):
    jcfg, cfg, pool, table, keys, count, tiles, extra, special = _rebuild_inputs(case)
    flags = emulate_oct_mask(cfg, pool, keys, count, tiles, extra)
    part = Partition(table=torch.from_numpy(table), keys=torch.from_numpy(keys),
                     count=torch.tensor([count], dtype=torch.int32),
                     overflow=torch.zeros(1, dtype=torch.int32))
    twin = partition.oct_flags(cfg, torch.from_numpy(pool), part,
                               tuple(torch.from_numpy(t) for t in tiles),
                               None if extra is None else torch.from_numpy(extra))
    np.testing.assert_array_equal(to_np(twin), flags)
    # JAX compacts the same octs (the first nb of them)
    jp, _ = jpart.rebuild(jcfg, jnp.asarray(pool),
                          JPartition(jnp.asarray(table), jnp.asarray(keys),
                                     jnp.asarray([count], jnp.int32), jnp.zeros(1, jnp.int32)),
                          tuple(jnp.asarray(t) for t in tiles),
                          None if extra is None else jnp.asarray(extra))
    want = np.nonzero(flags)[0]
    n = int(np.asarray(jp.count)[0])
    np.testing.assert_array_equal(np.asarray(jp.keys)[:n], want[:cfg.max_active_octs])
    assert int(np.asarray(jp.overflow)[0]) == max(len(want) - cfg.max_active_octs, 0)
    if special:                       # -0.0 is no mass, a NaN is
        assert case != "mass_only" or not flags[special["negzero"]]
        assert flags[special["nan"]]
    if case == "overflow":
        assert len(want) > cfg.max_active_octs


@pytest.mark.parametrize("case", REBUILD_CASES)
def test_remap_and_finalize_emulations_equal_jax_rebuild(case):
    jcfg, cfg, pool, table, keys, count, tiles, extra, _ = _rebuild_inputs(case)
    flags = emulate_oct_mask(cfg, pool, keys, count, tiles, extra)
    new_keys, new_table, n, over, new_pool = emulate_remap(cfg, pool, table, flags)
    jold = JPartition(jnp.asarray(table), jnp.asarray(keys), jnp.asarray([count], jnp.int32),
                      jnp.zeros(1, jnp.int32))
    jp, jpool = jpart.rebuild(jcfg, jnp.asarray(pool), jold, tuple(jnp.asarray(t) for t in tiles),
                              None if extra is None else jnp.asarray(extra))
    np.testing.assert_array_equal(new_keys, np.asarray(jp.keys))
    np.testing.assert_array_equal(new_table, np.asarray(jp.table))
    assert (n, over) == (int(np.asarray(jp.count)[0]), int(np.asarray(jp.overflow)[0]))
    np.testing.assert_array_equal(new_pool.view(np.int32), np.asarray(jpool).view(np.int32))
    # the port's plain twins, and the wrapper on the CPU (no launch)
    old = Partition(table=torch.from_numpy(table), keys=torch.from_numpy(keys),
                    count=torch.tensor([count], dtype=torch.int32),
                    overflow=torch.zeros(1, dtype=torch.int32))
    tp, tpool = partition.remap(cfg, torch.from_numpy(pool), old, torch.from_numpy(flags))
    before = dict(pk.launches)
    wp, wpool = pk.rebuild(cfg, torch.from_numpy(pool), old,
                           tuple(torch.from_numpy(t) for t in tiles),
                           None if extra is None else torch.from_numpy(extra))
    assert pk.launches == before
    for p, q in ((tp, tpool), (wp, wpool)):
        np.testing.assert_array_equal(to_np(p.keys), new_keys)
        np.testing.assert_array_equal(to_np(p.table), new_table)
        assert (int(p.count[0]), int(p.overflow[0])) == (n, over)
        np.testing.assert_array_equal(to_np(q).view(np.int32), new_pool.view(np.int32))
    if case == "dirty_null":          # a new oct takes the old null row, as in JAX
        fresh = [i for i in range(n) if table[new_keys[i]] == cfg.null_oct]
        assert fresh and all(np.array_equal(new_pool[i].view(np.int32),
                                            pool[cfg.null_oct].view(np.int32)) for i in fresh)
    # finalize: each model's tiles, and sentinels, against JAX
    for tk in tiles or [np.array([cfg.grid_size ** 3, 0], np.int32)]:
        block, bcoord, tvalid = emulate_finalize(cfg, new_table, tk)
        dropped = jnp.zeros(1, jnp.int32)
        jt = jpart.finalize_tiles(jcfg, jp, jnp.asarray(tk), dropped)
        np.testing.assert_array_equal(block, np.asarray(jt.block))
        np.testing.assert_array_equal(bcoord, np.asarray(jt.bcoord))
        np.testing.assert_array_equal(tvalid, np.asarray(jt.tvalid))
        t = pk.finalize_tiles(cfg, wp, torch.from_numpy(tk), torch.zeros(1, dtype=torch.int32))
        np.testing.assert_array_equal(to_np(t.block), block)
        np.testing.assert_array_equal(to_np(t.bcoord), bcoord)
        np.testing.assert_array_equal(to_np(t.tvalid), tvalid)


def test_incremental_plan_compactions_go_through_the_wrapper(monkeypatch):
    """incremental_plan's two compactions call ``partition_kernel.first_marked``
    (the kernel on a card; on the CPU its twin)."""
    from tests.test_torch_partition import _rebucket_both

    _, cfg, _, (pm, tk, dr), _ = _rebucket_both()
    calls = []
    real = pk.first_marked

    def spy(mark, size, fill):
        calls.append((mark.shape[0], size, fill))
        return real(mark, size, fill)

    monkeypatch.setattr(pk, "first_marked", spy)
    pm.tiles = partition.finalize_tiles(
        cfg, partition.rebuild(cfg, torch.zeros((cfg.max_active_octs + 1, 16, 128)),
                               _empty(cfg), (tk,))[0], tk, dr)
    partition.incremental_plan(cfg, pm, partition.tile_block_keys(cfg, pm.tiles))
    s_cap, nt = pm.pos.shape[1], tk.shape[0]
    assert [c[0] for c in calls] == [s_cap, nt] and calls[1] == (nt, nt, nt)


def _empty(cfg):
    from claymore_tpu_torch.core.engine import empty_partition

    return empty_partition(cfg, torch.device("cpu"))
