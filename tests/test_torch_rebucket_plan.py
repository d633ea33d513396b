"""The full rebucket's plain twins (``core/partition.py``: ``sort_keys``,
``segment_heads``, ``segment_bases``, ``tile_windows``, ``place``; the
plain versions of ``csrc/rebucket.cu``) against the JAX package's
``sort_permute`` on layouts built at its edges: nothing active, one
segment, segments of whole tiles, many small octs (group padding), a
capacity too small (the last tile's window cut, particles dropped), and a
region predicate with both kinds of block, no interior or no boundary.
They only move data and do integer arithmetic, so everything must agree
exactly."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from claymore_tpu.core import partition as jpart
from claymore_tpu.core.types import ParticleModel as JModel
from claymore_tpu_torch.core import partition
from claymore_tpu_torch.core.types import ParticleModel
from claymore_tpu_torch.ops import rebucket_kernel

from tests.torch_port_helpers import configs, to_np

TILE = 16
LAYOUTS = {"fixed_corotated": {"F": 9}, "jfluid": {"J": 1}, "sand": {"F": 9, "logJp": 1},
           "nacc": {"F": 9, "logJp": 1}}


def _segments(case, g, rng):
    """[(block key, particles)] of a case on a grid of g^3 blocks."""
    n3 = g ** 3
    if case == "all_inactive":
        return []
    if case == "one_segment":
        return [(int(rng.integers(n3)), 37)]
    if case == "whole_tiles":
        return [(int(k), TILE * int(rng.integers(1, 4)))
                for k in rng.choice(n3, size=6, replace=False)]
    if case == "small_octs":           # one or two particles in each of many octs
        octs = rng.choice(n3 // 8, size=12, replace=False)
        return [(int(8 * o + rng.integers(8)), int(rng.integers(1, 3))) for o in octs]
    # scattered (also tight and the region cases): some full octs, some sparse
    keys = list(rng.choice(n3, size=14, replace=False))
    keys += [8 * int(keys[0] // 8) + z for z in range(8) if 8 * int(keys[0] // 8) + z
             not in keys]
    return [(int(k), int(rng.integers(1, 3 * TILE))) for k in keys]


def _models(case, layout, seed=0):
    """The same raw slot layout in both packages: particles in the blocks of
    ``_segments`` at random positions in their home blocks, shuffled over
    the slots with holes, random fields; the tile count fits them, but for
    ``tight``, which holds only 3/4 of the slots the plan needs."""
    jcfg, cfg = configs(domain_bits=5, max_active_blocks=256, particle_tile=TILE)
    g = cfg.grid_size
    rng = np.random.default_rng(seed)
    segs = _segments(case, g, rng)
    pts = []
    for key, count in segs:
        b = np.array([key // (g * g), (key // g) % g, key % g], np.float64)
        # home_block(x) = b for x / dx in [4 b + 1.5, 4 b + 5.5)
        cells = 4 * b[None, :] + 1.6 + rng.uniform(0.0, 3.8, size=(count, 3))
        pts.append((cells * cfg.dx).astype(np.float32))
    pts = np.concatenate(pts) if pts else np.zeros((0, 3), np.float32)
    need = sum(-(-c // TILE) for _, c in segs) + 8 * len({k // 8 for k, _ in segs})
    n_tiles = max(2, need * 3 // 4 if case == "tight" else need + 3)
    s_cap = n_tiles * TILE
    slots = rng.permutation(s_cap)[:len(pts)] if len(pts) <= s_cap else None
    if slots is None:                  # tight: more particles than slots
        pts = pts[rng.permutation(len(pts))[:s_cap - 5]]
        slots = rng.permutation(s_cap)[:len(pts)]
    pos = rng.uniform(0.0, 1.0, size=(3, s_cap)).astype(np.float32)   # holes: anywhere
    pos[:, slots] = pts.T
    active = np.zeros((s_cap,), bool)
    active[slots] = True
    fields = {k: rng.normal(size=(w, s_cap) if w > 1 else (s_cap,)).astype(np.float32)
              for k, w in LAYOUTS[layout].items()}
    pid = np.where(active, rng.permutation(s_cap), s_cap).astype(np.int32)
    port = ParticleModel(pos=torch.from_numpy(pos),
                         fields={k: torch.from_numpy(v) for k, v in fields.items()},
                         active=torch.from_numpy(active), pid=torch.from_numpy(pid),
                         tiles=None)
    jax = JModel(pos=jnp.asarray(pos), fields={k: jnp.asarray(v) for k, v in fields.items()},
                 active=jnp.asarray(active), pid=jnp.asarray(pid), tiles=None)
    return jcfg, cfg, jax, port, n_tiles


def _region(case, g):
    """(JAX predicate, port predicate) over flat block keys, or None."""
    if case == "region":
        return (lambda k: (k // (g * g)) < g // 2), (lambda k: (k // (g * g)) < g // 2)
    if case == "region_no_interior":
        return (lambda k: k >= 0), (lambda k: k >= 0)
    if case == "region_no_boundary":
        return (lambda k: k < 0), (lambda k: k < 0)
    return None


CASES = ["scattered", "all_inactive", "one_segment", "whole_tiles", "small_octs", "tight",
         "region", "region_no_interior", "region_no_boundary"]


@pytest.mark.parametrize("layout", list(LAYOUTS))
@pytest.mark.parametrize("case", CASES)
def test_plain_twins_equal_jax_sort_permute(case, layout):
    """``partition.sort_permute`` (sort_keys -> tile_plan -> place) and the
    wrapper on the CPU equal the JAX package's, channel for channel."""
    jcfg, cfg, jm, m, nt = _models(case, layout)
    region = _region(case, cfg.grid_size)
    jpm, jtk, jdr = jpart.sort_permute(jcfg, jm, nt, region_fn=region and region[0])
    for pm, tk, dr in (partition.sort_permute(cfg, m, nt, region and region[1]),
                       rebucket_kernel.sort_permute(cfg, m, nt, region and region[1])):
        for name, a, b in (("pos", pm.pos, jpm.pos), ("active", pm.active, jpm.active),
                           ("pid", pm.pid, jpm.pid), ("tile_keys", tk, jtk),
                           ("dropped", dr, jdr),
                           *((k, pm.fields[k], jpm.fields[k]) for k in LAYOUTS[layout])):
            np.testing.assert_array_equal(to_np(a), np.asarray(b), err_msg=name)
            assert to_np(a).dtype == np.asarray(b).dtype, name
    n_act = int(m.active.sum())
    assert (int(dr[0]) > 0) == (case == "tight")
    assert int(pm.active.sum()) == n_act - int(dr[0])
    if case.startswith("region"):
        g = cfg.grid_size
        valid = to_np(tk) < g ** 3
        kinds = region[1](torch.from_numpy(np.minimum(to_np(tk), g ** 3 - 1))).numpy()[valid]
        assert {"region": {True, False}, "region_no_interior": {True},
                "region_no_boundary": {False}}[case] == set(kinds.tolist())


def _jax_windows(jcfg, skey, num_tiles, sentinel):
    """The JAX function's tile windows (claymore_tpu/core/partition.py:154-179)
    of the sorted keys: its destination slots, then ``searchsorted``."""
    s_cap = skey.shape[0]
    tile = jcfg.particle_tile
    act_s = skey < sentinel
    iota = jnp.arange(s_cap, dtype=jnp.int32)
    prev_key = jnp.concatenate([jnp.full((1,), -1, jnp.int32), skey[:-1]])
    boundary = (skey != prev_key) & act_s
    seg_start = jnp.maximum.accumulate(jnp.where(boundary, iota, 0))
    prev_seg_start = jnp.concatenate([jnp.zeros((1,), jnp.int32), seg_start[:-1]])
    prev_len = jnp.where(boundary, iota - prev_seg_start, 0)
    p1 = iota + jnp.cumsum(jnp.where(boundary, (-prev_len) % tile, 0))
    gt = jcfg.group_tiles * tile
    o_boundary = ((skey >> 3) != (prev_key >> 3)) & boundary
    o_start_p1 = jnp.maximum.accumulate(jnp.where(o_boundary, p1, 0))
    prev_o_p1 = jnp.concatenate([jnp.zeros((1,), jnp.int32), o_start_p1[:-1]])
    prev_o_len = jnp.where(o_boundary, p1 - prev_o_p1, 0)
    new_slot = p1 + jnp.cumsum(jnp.where(o_boundary, (-prev_o_len) % gt, 0))
    new_slot = jnp.where(act_s & (new_slot < s_cap), new_slot, s_cap)
    starts = jnp.searchsorted(new_slot, jnp.arange(num_tiles + 1, dtype=jnp.int32) * tile,
                              side="left").astype(jnp.int32)
    return starts[:-1], jnp.minimum(starts[1:] - starts[:-1], tile)


@pytest.mark.parametrize("case", CASES)
def test_tile_plan_windows_equal_jax_searchsorted(case):
    """``tile_plan``'s dstart / dlen are the JAX function's searchsorted
    windows, empty tiles included; its segment heads and bases give each
    active element the JAX destination slot."""
    jcfg, cfg, _, m, nt = _models(case, "fixed_corotated", seed=1)
    region = _region(case, cfg.grid_size)
    skey, perm, is_region = partition.sort_keys(cfg, m, region and region[1])
    off, sentinel = partition.region_offsets(cfg, is_region)
    dstart, dlen, tile_keys, dropped = partition.tile_plan(cfg, skey, nt, is_region)
    jstart, jlen = _jax_windows(jcfg, jnp.asarray(skey.numpy()), nt, sentinel)
    np.testing.assert_array_equal(dstart.numpy(), np.asarray(jstart))
    np.testing.assert_array_equal(dlen.numpy(), np.asarray(jlen))
    assert dstart.dtype == dlen.dtype == tile_keys.dtype == torch.int32
    heads = partition.segment_heads(skey, sentinel)
    assert int(heads[-1]) == int(m.active.sum())
    base = partition.segment_bases(cfg, skey, heads)
    assert bool((base % TILE == 0).all()) and bool((torch.diff(base) > 0).all())
    # a tile's window is one segment's run, at the tile's first slot
    live = dlen > 0
    seg = torch.searchsorted(heads[:-1].long(), dstart[live].long(), right=True) - 1
    slot = base[seg] + dstart[live].long() - heads[seg].long()
    np.testing.assert_array_equal(slot.numpy(), (torch.nonzero(live).flatten() * TILE).numpy())
