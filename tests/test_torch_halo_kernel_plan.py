"""The mesh's halo exchange and migration pack: the plain twins
(``parallel/halo.py``) held to the JAX package under ``jax.shard_map``, and
the CUDA kernels' plans (``csrc/halo.cu``) emulated on the CPU and held to
the twins.

The JAX side runs ``claymore_tpu.parallel.multi.HaloComm`` (its
``exchange_halo``, ``halo_mass_mask``, ``add_halo`` and ``migrate``) on the
conftest's virtual CPU devices, on inputs made from a numpy seed
(``tests/torch_port_helpers.py:halo_case``): random partitions, pools with
negative momentum and -0.0 mass lanes, particles around each shard's slab.
The twins move data, compare integers, multiply by 1.0 or 0.0 and add
once, so every result is exact: pool rows by their bits.

The emulations follow each kernel pass by pass at its own widths
(``ops/halo_kernel.py``: ``HALO_CHUNK``, ``MIG_CHUNK``): the flag words,
the per-chunk counts, one scan per flag, the write pass in the CTAs whose
chunk holds a wanted flag below the capacity (warp ballots, leaving once
every flag's prefix reaches it), the halo rows (one CTA a rank and direction, the lane
mask per float4, the bits OR-ed over the CTA), the mass mask, the adds in
direction order and the migration payload (slot S - 1 past the count)."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh, PartitionSpec as P

from claymore_tpu.core.types import Partition as JPartition
from claymore_tpu.core.types import ParticleModel as JParticleModel
from claymore_tpu.parallel.multi import HaloComm as JHaloComm
from claymore_tpu_torch.core.types import ParticleModel, Partition
from claymore_tpu_torch.ops import halo_kernel as hk
from claymore_tpu_torch.parallel import halo
from claymore_tpu_torch.parallel.multi import HaloComm, LocalGroup

from tests.torch_port_helpers import configs, halo_case, to_np

THREADS = 256                          # csrc/halo.cu: kThreads
WARPS = THREADS // 32
POISON = -7                            # written by no pass: every entry must be overwritten


def _bits(x):
    return to_np(x).view(np.int32)


def _setup(case, mesh):
    """(inputs, port cfg, JAX cfg, port comm, JAX comm, JAX mesh, axis spec)."""
    c = halo_case(case, mesh)
    jcfg, cfg = configs(**c["cfg_kw"])
    n = int(np.prod(mesh))
    names = ("x", "z")[:len(mesh)]
    axes = tuple(zip(names, (0, 2)))
    comm = HaloComm(cfg, axes, mesh, c["margin"], c["k"], c["h"],
                    group=LocalGroup(mesh, ["cpu"] * n))
    jcomm = JHaloComm(jcfg, axes, mesh, c["margin"], c["k"], c["h"])
    jmesh = Mesh(np.array(jax.devices()[:n]).reshape(mesh), names)
    return c, cfg, jcfg, comm, jcomm, jmesh, names[0] if len(names) == 1 else names


def _smap(fn, jmesh, ax, nargs):
    return jax.jit(jax.shard_map(fn, mesh=jmesh, in_specs=(P(ax),) * nargs, out_specs=P(ax),
                                 check_vma=False))


@functools.lru_cache(maxsize=None)
def _jax_halo(case, mesh):
    """The JAX package's exchange, mass mask and add on ``halo_case``'s
    inputs: per shard the received (keys, bits, rows) of every direction
    (zeros where no neighbour sends), the overflow, the mask and the pool
    after the add."""
    c, cfg, jcfg, comm, jcomm, jmesh, ax = _setup(case, mesh)
    n = len(c["pool"])

    def fn(pool, keys, count, pool2, table2):
        z = jnp.zeros((1,), jnp.int32)
        slabs = jcomm.exchange_halo(pool, JPartition(table=table2, keys=keys, count=count,
                                                     overflow=z))
        new = jcomm.add_halo(pool2, JPartition(table=table2, keys=keys, count=count,
                                               overflow=z), slabs)
        return slabs[0], slabs[1], jcomm.halo_mass_mask(slabs), new

    cat = lambda name: jnp.asarray(np.concatenate(c[name]))
    recv, over, mask, new = _smap(fn, jmesh, ax, 5)(
        cat("pool"), cat("keys"), jnp.asarray(np.asarray(c["count"], np.int32)),
        cat("pool2"), cat("table2"))
    split = lambda x: np.array(x).reshape((n, -1) + np.asarray(x).shape[1:])
    recv = [[tuple(split(x)[j] for x in r) for r in recv] for j in range(n)]
    return (c, cfg, comm, recv, np.asarray(over), split(mask), split(new))


def _sources(comm, j):
    """Per direction, the shard whose pack shard j receives, or None."""
    return [comm._target(comm.shards[j], tuple(-s for s in d)) for d in comm._directions()]


def _torch_in(c, j):
    t = torch.from_numpy
    return (t(c["pool"][j]), t(c["keys"][j]), torch.tensor([c["count"][j]], dtype=torch.int32))


HALO_RUNS = [("plain", (2,)), ("overflow", (2, 2)), ("sparse", (2, 2)), ("plain", (4, 2)),
             ("empty_shard", (4, 2))]


@pytest.mark.parametrize("case,mesh", HALO_RUNS)
def test_pack_windows_matches_jax(case, mesh):
    """Each shard's twin packs, shifted to their receivers, equal what the
    JAX exchange delivers (keys, mass bits, rows by bits), zeros where no
    neighbour sends; the overflow equals; and ``HaloComm.exchange_halo``
    (the wrapper on the CPU) delivers the same."""
    c, cfg, comm, recv, over, _, _ = _jax_halo(case, mesh)
    n, h, m = len(c["pool"]), c["h"], c["margin"]
    dirs = comm._directions()
    packs = []
    for j in range(n):
        p, o = halo.pack_windows(cfg, *_torch_in(c, j), comm._windows(j), [True] * len(dirs),
                                 h, m)
        assert int(o[0]) == int(over[j])
        packs.append(p)
    assert (over.sum() > 0) == (case == "overflow")
    port_recv, port_over = comm.exchange_halo(
        [_torch_in(c, j)[0] for j in range(n)],
        [Partition(table=torch.from_numpy(c["table2"][j]), keys=_torch_in(c, j)[1],
                   count=_torch_in(c, j)[2], overflow=torch.zeros(1, dtype=torch.int32))
         for j in range(n)])
    assert [int(o[0]) for o in port_over] == over.tolist()
    held, empty_windows = 0, 0
    for j in range(n):
        got = iter(port_recv[j])
        for i, src in enumerate(_sources(comm, j)):
            jk, jb, jr = recv[j][i]
            if src is None:
                assert not jk.any() and not jb.any() and not jr.any()
                continue
            meta, rows = packs[src][i]
            np.testing.assert_array_equal(to_np(meta[0]), jk)
            np.testing.assert_array_equal(to_np(meta[1]), jb)
            np.testing.assert_array_equal(_bits(rows), jr.view(np.int32))
            pk, pb, pr = next(got)
            np.testing.assert_array_equal(to_np(pk), jk)
            np.testing.assert_array_equal(to_np(pb), jb)
            np.testing.assert_array_equal(_bits(pr), jr.view(np.int32))
            held += int((jk < cfg.num_oct_keys).sum())
            empty_windows += int(not (jk < cfg.num_oct_keys).any())
        assert next(got, None) is None
    assert held > 0
    if case == "sparse":
        assert empty_windows > 0


@pytest.mark.parametrize("case,mesh", HALO_RUNS)
def test_mass_mask_and_add_match_jax(case, mesh):
    """The twins' mass mask and add, on what the JAX exchange delivered
    (every direction, zeros where no neighbour sends), equal the JAX
    package's: the mask exactly, the pool by bits."""
    c, cfg, comm, recv, _, mask, new = _jax_halo(case, mesh)
    for j in range(len(c["pool"])):
        rv = [tuple(torch.from_numpy(x) for x in r) for r in recv[j]]
        np.testing.assert_array_equal(to_np(halo.mass_mask(cfg, rv)), mask[j])
        out = halo.add_rows(cfg, torch.from_numpy(c["pool2"][j].copy()),
                            torch.from_numpy(c["table2"][j]), rv)
        np.testing.assert_array_equal(_bits(out), new[j].view(np.int32))
    assert mask.any()


@functools.lru_cache(maxsize=None)
def _jax_migrate(case, mesh):
    c, cfg, jcfg, comm, jcomm, jmesh, ax = _setup(case, mesh)
    n = len(c["pos"])

    def fn(pos, active, pid, f):
        model = JParticleModel(pos=pos, fields={"F": f}, active=active, pid=pid, tiles=None)
        (out,), dropped = jcomm.migrate([model], None, enable=True)
        return out.pos, out.active, out.pid, out.fields["F"], dropped

    cat = lambda name, axis=0: jnp.asarray(np.concatenate(c[name], axis=axis))
    res = jax.shard_map(fn, mesh=jmesh, in_specs=(P(None, ax), P(ax), P(ax), P(None, ax)),
                        out_specs=(P(None, ax), P(ax), P(ax), P(None, ax), P(ax)),
                        check_vma=False)
    pos, act, pid, f, dropped = jax.jit(res)(cat("pos", 1), cat("active"), cat("pid"),
                                             cat("F", 1))
    per = lambda x, axis=0: np.split(np.asarray(x), n, axis=axis)
    return c, cfg, comm, per(pos, 1), per(act), per(pid), per(f, 1), np.asarray(dropped)


def _port_models(c):
    t = torch.from_numpy
    return [[ParticleModel(pos=t(c["pos"][j].copy()), fields={"F": t(c["F"][j].copy())},
                           active=t(c["active"][j].copy()), pid=t(c["pid"][j].copy()),
                           tiles=None)] for j in range(len(c["pos"]))]


@pytest.mark.parametrize("case,mesh", [("plain", (2,)), ("mig_overflow", (2, 2)),
                                       ("empty_shard", (4, 2))])
def test_migrate_matches_jax(case, mesh):
    """``HaloComm.migrate`` (the twin's pack, then the placement) on every
    shard equals the JAX package's ``migrate``: positions, fields, ids and
    active flags slot for slot, and the dropped counts; the twin's pack
    deactivates every crosser and counts those past the capacity."""
    c, cfg, comm, jpos, jact, jpid, jf, jdrop = _jax_migrate(case, mesh)
    models, dropped, _ = comm.migrate(_port_models(c), [True] * len(c["pos"]))
    for j, (m,) in enumerate(models):
        np.testing.assert_array_equal(to_np(m.active), jact[j])
        np.testing.assert_array_equal(_bits(m.pos), jpos[j].view(np.int32))
        np.testing.assert_array_equal(to_np(m.pid), jpid[j])
        np.testing.assert_array_equal(_bits(m.fields["F"]), jf[j].view(np.int32))
    assert [int(d[0]) for d in dropped] == jdrop.tolist()
    assert (jdrop.sum() > 0) == (case == "mig_overflow")
    # the pack alone: crossers of the first live axis, both sides
    (m,) = _port_models(c)[1]
    dim = comm.axes[comm.live_axes[0]][1]
    lo, hi = comm._bounds(1, comm.live_axes[0])
    left, right, active, drop = halo.migrate_pack(cfg, m, dim, lo, hi, c["k"])
    shipped = int((left[3] > 0).sum() + (right[3] > 0).sum())
    gone = int(m.active.sum() - active.sum())
    assert gone == shipped + int(drop[0]) and gone > 0


# --------------------------------------------------------------------------
# the emulations
# --------------------------------------------------------------------------

def emulate_halo_flags(cfg, keys, count, windows, margin):
    """``HaloFlags``: u32[nb], bit d set where pool row i is live and meets
    window d (C integer arithmetic on non-negative keys)."""
    nb, no, g = keys.shape[0], cfg.num_oct_keys, cfg.grid_size
    gzo = g >> 3
    i = np.arange(nb)
    k = keys.astype(np.int64)
    live = (i < min(count, nb)) & (k >= 0) & (k < no)
    kc = np.where(live, k, 0)
    bzo, by, bx = kc % gzo, (kc // gzo) % g, np.minimum(kc // (gzo * g), g - 1)
    bits = np.zeros(nb, np.uint32)
    for d, win in enumerate(windows):
        inside = live.copy()
        for dim, e in win:
            lo = (bx, by, bzo * 8)[dim]
            hi = lo + (8 if dim == 2 else 1)
            inside &= (hi > e - margin) & (lo < e + margin)
        bits |= inside.astype(np.uint32) << d
    return bits


def emulate_plan(bits, nflags, want, cap, rounds):
    """``count_kernel`` / ``scan_kernel`` / ``write_kernel``: (idx i32[nflags,
    cap] with POISON where no pass wrote, totals, overflow, chunks that ran
    the write pass: those holding a wanted flag below the capacity)."""
    n = bits.shape[0]
    chunk = rounds * THREADS
    nchunks = -(-n // chunk)
    padded = np.zeros(nchunks * chunk, np.uint32)
    padded[:n] = bits
    flags = np.stack([(padded >> d) & 1 for d in range(nflags)]).astype(np.int64)
    cta_count = flags.reshape(nflags, nchunks, chunk).sum(axis=2)       # pass 1
    cta_off = np.cumsum(cta_count, axis=1) - cta_count                  # pass 2
    total = cta_count.sum(axis=1)
    overflow = int(np.maximum(total - cap, 0).sum())
    idx = np.full((nflags, cap), POISON, np.int64)
    reread = 0
    for b in range(nchunks):                                            # pass 3
        carry = [int(cta_off[d, b]) if (want >> d) & 1 and cta_count[d, b] else cap
                 for d in range(nflags)]
        if min(carry) >= cap:
            continue
        reread += 1
        for r in range(rounds):
            i = b * chunk + r * THREADS + np.arange(THREADS)
            for d in range(nflags):
                f = flags[d, i]
                per_warp = f.reshape(WARPS, 32)
                wc = per_warp.sum(axis=1)                               # ballots' popc
                before = np.repeat(np.cumsum(wc) - wc, 32)
                lanes = (np.cumsum(per_warp, axis=1) - per_warp).reshape(-1)
                rank = carry[d] + before + lanes
                place = (f == 1) & (rank < cap)
                assert (idx[d, rank[place]] == POISON).all(), "an index written twice"
                idx[d, rank[place]] = i[place]
                carry[d] += int(f.sum())
            if min(carry) >= cap:
                break
    for d in range(nflags):
        if (want >> d) & 1:
            assert (idx[d, :min(total[d], cap)] != POISON).all(), "a rank never written"
    return idx, total, overflow, reread


def emulate_halo_rows(cfg, pool, keys, idx, total, windows, dirs, h, margin):
    """``halo_rows_kernel``: meta i32[P, 2, h], rows f32[P, h, 16, 128]."""
    nb, no, gzo = cfg.max_active_octs, cfg.num_oct_keys, cfg.grid_size >> 3
    meta = np.zeros((len(dirs), 2, h), np.int32)
    rows = np.zeros((len(dirs), h, 16, 128), np.float32)
    group = np.arange(32)                  # a thread's 4 lanes: float4 t % 32 of a channel
    blk = group >> 2
    for p, d in enumerate(dirs):
        for r in range(h):
            valid = r < min(int(total[d]), h)
            slot = int(idx[d, r]) if valid else nb - 1
            key = int(keys[slot]) if valid else no
            inside = np.full(32, valid)
            if valid:
                bz = (key % gzo) * 8 + blk
                for dim, e in windows[d]:
                    if dim == 2:
                        inside &= (bz >= e - margin) & (bz < e + margin)
            f = inside.astype(np.float32)
            row = pool[slot].reshape(16, 32, 4) * f[None, :, None]
            rows[p, r] = row.reshape(16, 128)
            nz = (row[0:4] != 0.0).any(axis=(0, 2))                    # per thread group
            meta[p, :, r] = key, int(np.bitwise_or.reduce(np.where(nz, 1 << blk, 0)))
    return meta, rows


@pytest.mark.parametrize("case", ["plain", "overflow", "sparse", "empty_shard"])
def test_halo_pack_plan_matches_twin(case):
    """The count, scan, write and rows passes of ``cm_halo_count`` /
    ``cm_halo_write`` emulated on every shard of a 4x2 mesh (8 directions,
    a few of them not packed) equal ``halo.pack_windows``: keys, bits, rows
    by bits, the overflow; with h below the windows' octs the write pass
    leaves early."""
    mesh = (4, 2)
    c, cfg, _, comm, _, _, _ = _setup(case, mesh)
    h, m = c["h"], c["margin"]
    for j in range(len(c["pool"])):
        windows = comm._windows(j)
        packed = [comm._target(j, d) is not None for d in comm._directions()]
        dirs = [d for d, p in enumerate(packed) if p]
        want = sum(1 << d for d in dirs)
        bits = emulate_halo_flags(cfg, c["keys"][j], c["count"][j], windows, m)
        idx, total, overflow, _ = emulate_plan(bits, len(windows), want, h, 1)
        meta, rows = emulate_halo_rows(cfg, c["pool"][j], c["keys"][j], idx, total, windows,
                                       dirs, h, m)
        packs, over = halo.pack_windows(cfg, *_torch_in(c, j), windows, packed, h, m)
        assert overflow == int(over[0])
        for p, d in enumerate(dirs):
            np.testing.assert_array_equal(meta[p], to_np(packs[d][0]))
            np.testing.assert_array_equal(rows[p].view(np.int32), _bits(packs[d][1]))
        assert all(packs[d] is None for d, p in enumerate(packed) if not p)
    if case == "overflow":
        assert overflow > 0


def test_compaction_plan_leaves_early_and_counts_every_flag():
    """The shared compaction over several chunks: flags past the capacity
    in the first chunk end the write pass there (one chunk re-read), a flag
    not wanted is counted but never written, a chunk without a wanted flag
    is not re-read, and every rank below the capacity is written once."""
    rng = np.random.default_rng(5)
    n = 5 * THREADS * 4 + 37
    bits = (rng.uniform(size=n) < 0.6).astype(np.uint32) | (
        (rng.uniform(size=n) < 0.01).astype(np.uint32) << 1)
    idx, total, overflow, reread = emulate_plan(bits, 3, 0b001, 100, 4)
    assert reread == 1 and total[2] == 0
    assert (idx[1] == POISON).all()
    assert overflow == max(total[0] - 100, 0) + max(total[1] - 100, 0)
    np.testing.assert_array_equal(idx[0], np.flatnonzero(bits & 1)[:100])
    idx, total, _, reread = emulate_plan(bits, 2, 0b011, 100, 4)
    # flag 1 stays below the capacity: every chunk holding one reads again
    assert reread == len({i // (4 * THREADS) for i in np.flatnonzero(bits & 2)} | {0})
    np.testing.assert_array_equal(idx[1, :total[1]], np.flatnonzero(bits & 2))
    sparse = np.zeros(n, np.uint32)
    sparse[[5, 4 * THREADS * 3 + 7]] = 2                 # chunks 0 and 3 hold a flag
    idx, total, _, reread = emulate_plan(sparse, 2, 0b011, 100, 4)
    assert reread == 2 and idx[1, :2].tolist() == [5, 4 * THREADS * 3 + 7]


def emulate_mask(cfg, received):
    no, g = cfg.num_oct_keys, cfg.grid_size
    gzo = g >> 3
    mask = np.zeros(g ** 3 + 1, np.uint8)                               # the memset
    for keys, bits, _rows in received:
        for key, b in zip(keys.tolist(), bits.tolist()):
            if not 0 <= key < no or b & 0xFF == 0:
                continue
            bzo, by, bx = key % gzo, (key // gzo) % g, min(key // (gzo * g), g - 1)
            base = (bx * g + by) * g + bzo * 8
            for i in range(8):
                if (b >> i) & 1:
                    mask[base + i] = 1
    return mask[:g ** 3].astype(bool)


def emulate_add(cfg, pool, table, received):
    no = cfg.num_oct_keys
    pool = pool.copy()
    pool[cfg.null_oct] = 0.0                                            # zeroed first
    for keys, _bits, rows in received:                                  # direction order
        for r, key in enumerate(keys.tolist()):
            if not 0 <= key < no or table[key] == cfg.null_oct:
                continue
            pool[table[key]] = pool[table[key]] + rows[r]
    return pool


@pytest.mark.parametrize("case", ["plain", "overflow", "empty_shard"])
def test_mask_and_add_plans_match_twins(case):
    """The mass mask (memset, one store per set bit) and the adds (the null
    row zeroed first, rows of keys past the oct keys or octs the table does
    not hold skipped) equal ``halo.mass_mask`` and ``halo.add_rows`` on what
    each shard of a 2x2 mesh receives, with a direction's rows added on top
    of another's where both carry an oct."""
    mesh = (2, 2)
    c, cfg, _, comm, _, _, _ = _setup(case, mesh)
    n = len(c["pool"])
    recv, _ = comm.exchange_halo(
        [_torch_in(c, j)[0] for j in range(n)],
        [Partition(table=torch.from_numpy(c["table2"][j]), keys=_torch_in(c, j)[1],
                   count=_torch_in(c, j)[2], overflow=torch.zeros(1, dtype=torch.int32))
         for j in range(n)])
    shared = 0
    for j in range(n):
        rv = [(k, b, r) for k, b, r in recv[j]]
        rv.append(rv[0])                                   # one oct in two directions
        npr = [tuple(to_np(x) for x in t) for t in rv]
        np.testing.assert_array_equal(emulate_mask(cfg, npr), to_np(halo.mass_mask(cfg, rv)))
        got = emulate_add(cfg, c["pool2"][j], c["table2"][j], npr)
        want = halo.add_rows(cfg, torch.from_numpy(c["pool2"][j].copy()),
                             torch.from_numpy(c["table2"][j]), rv)
        np.testing.assert_array_equal(got.view(np.int32), _bits(want))
        keys = npr[0][0][npr[0][0] < cfg.num_oct_keys]
        shared += int((c["table2"][j][keys] != cfg.null_oct).sum())
    assert shared > 0 or case == "empty_shard"


def emulate_migrate(cfg, c, j, dim, lo, hi, k):
    """``cm_migrate_pack``: (left, right, new active, dropped)."""
    pos, active = c["pos"][j], c["active"][j]
    s_cap = pos.shape[1]
    x = pos[dim] * np.float32(cfg.dx_inv) + np.float32(0.5)          # two roundings
    cell = np.floor(x).astype(np.int64)
    hb = ((cell - 2 + 2 ** 31) % 2 ** 32 - 2 ** 31) >> cfg.block_bits  # 32-bit wrap
    bits = (active & (hb < lo)).astype(np.uint32) | ((active & (hb >= hi)).astype(np.uint32) << 1)
    new_active = active & (bits == 0)
    idx, total, dropped, _ = emulate_plan(bits, 2, 0b11, k, hk.MIG_CHUNK // THREADS)
    src = [pos[0], pos[1], pos[2], None, c["pid"][j].view(np.float32)] + list(c["F"][j])
    out = []
    for s in range(2):
        pay = np.zeros((len(src), k), np.float32)
        for col in range(k):
            valid = col < min(int(total[s]), k)
            slot = int(idx[s, col]) if valid else s_cap - 1
            for row, v in enumerate(src):
                pay[row, col] = (1.0 if valid else 0.0) if row == 3 else v[slot]
        out.append(pay)
    return out[0], out[1], new_active, dropped


@pytest.mark.parametrize("case", ["plain", "mig_overflow", "empty_shard"])
def test_migrate_pack_plan_matches_twin(case):
    """The count (with the new active), scan, write and payload passes of
    ``cm_migrate_pack`` emulated over 9,000 slots (three chunks of 4,096)
    equal ``halo.migrate_pack`` on every shard of a 2x2 mesh and both live
    axes: payloads by bits (pid's bits, slot S - 1 past the count), active,
    dropped."""
    mesh = (2, 2)
    c = halo_case(case, mesh, slots=9000)
    _, cfg = configs(**c["cfg_kw"])
    comm = HaloComm(cfg, (("x", 0), ("z", 2)), mesh, c["margin"], c["k"], c["h"],
                    group=LocalGroup(mesh, ["cpu"] * 4))
    crossed = 0
    for j in range(4):
        (m,) = _port_models(c)[j]
        for a in comm.live_axes:
            dim = comm.axes[a][1]
            lo, hi = comm._bounds(j, a)
            left, right, active, dropped = emulate_migrate(cfg, c, j, dim, lo, hi, c["k"])
            tl, tr, ta, td = halo.migrate_pack(cfg, m, dim, lo, hi, c["k"])
            np.testing.assert_array_equal(left.view(np.int32), _bits(tl))
            np.testing.assert_array_equal(right.view(np.int32), _bits(tr))
            np.testing.assert_array_equal(active, to_np(ta))
            assert dropped == int(td[0])
            crossed += int(c["active"][j].sum() - active.sum())
    assert crossed > 0
