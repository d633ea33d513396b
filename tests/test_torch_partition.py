"""The port's rebucket (sort_permute, rebuild, finalize_tiles, arena_margin)
against the JAX package on the same state.  These move and index data
without arithmetic, so everything but the margin must agree exactly: a
stable sort on the same keys gives the same slot order."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from claymore_tpu.core import engine as jengine
from claymore_tpu.core import partition as jpart
from claymore_tpu.core.types import ParticleModel as JModel
from claymore_tpu_torch.core import engine, partition
from claymore_tpu_torch.core.types import ParticleModel
from claymore_tpu_torch.io.sampler import sample_uniform_box_world

from tests.torch_port_helpers import CPU, configs, to_np


def _raw_models(seed=0, n_tiles=96):
    """A scattered cloud (two boxes plus jitter) with inactive slots, as a
    raw slot layout in both packages."""
    jcfg, cfg = configs(domain_bits=5, max_active_blocks=256)
    rng = np.random.default_rng(seed)
    pts = np.concatenate([
        sample_uniform_box_world(cfg.dx, [0.30, 0.40, 0.35], [0.42, 0.52, 0.47], cfg.ppc),
        sample_uniform_box_world(cfg.dx, [0.60, 0.30, 0.55], [0.68, 0.44, 0.66], cfg.ppc),
    ])
    pts = pts + rng.uniform(-0.3, 0.3, size=pts.shape).astype(np.float32) * cfg.dx
    pts = pts[rng.permutation(len(pts))]
    s_cap = n_tiles * cfg.particle_tile
    pos = np.zeros((3, s_cap), np.float32)
    pos[:, :len(pts)] = pts.T
    active = np.zeros((s_cap,), bool)
    active[:len(pts)] = True
    active[rng.choice(len(pts), size=40, replace=False)] = False   # holes
    f = rng.normal(size=(9, s_cap)).astype(np.float32)
    pid = np.where(active, np.arange(s_cap, dtype=np.int32), s_cap).astype(np.int32)
    port = ParticleModel(pos=torch.from_numpy(pos), fields={"F": torch.from_numpy(f)},
                         active=torch.from_numpy(active), pid=torch.from_numpy(pid),
                         tiles=None)
    jax = JModel(pos=jnp.asarray(pos), fields={"F": jnp.asarray(f)},
                 active=jnp.asarray(active), pid=jnp.asarray(pid), tiles=None)
    return jcfg, cfg, jax, port, n_tiles


def _eq(a, b, what):
    np.testing.assert_array_equal(to_np(a), to_np(b), err_msg=what)


def _rebucket_both():
    jcfg, cfg, jm, m, nt = _raw_models()
    jpm, jtk, jdr = jpart.sort_permute(jcfg, jm, nt)
    pm, tk, dr = partition.sort_permute(cfg, m, nt)
    return jcfg, cfg, (jpm, jtk, jdr), (pm, tk, dr), nt


def test_sort_permute_matches_jax():
    _, _, (jpm, jtk, jdr), (pm, tk, dr), _ = _rebucket_both()
    _eq(pm.pos, jpm.pos, "pos")
    _eq(pm.fields["F"], jpm.fields["F"], "F")
    _eq(pm.active, jpm.active, "active")
    _eq(pm.pid, jpm.pid, "pid")
    _eq(tk, jtk, "tile keys")
    _eq(dr, jdr, "dropped")
    assert tk.dtype == torch.int32 and int(dr[0]) == 0


@pytest.mark.parametrize("layout", [("J",), ("F", "logJp")])
def test_sort_permute_moves_scalar_fields_like_jax(layout):
    """JFluid's J [S] and Sand/NACC's logJp [S] move with the particles."""
    import dataclasses

    jcfg, cfg, jm, m, nt = _raw_models(seed=3)
    rng = np.random.default_rng(4)
    s_cap = m.pos.shape[1]
    fields = {k: (rng.normal(size=(9, s_cap)) if k == "F"
                  else rng.uniform(0.5, 1.5, s_cap)).astype(np.float32)
              for k in layout}
    m = dataclasses.replace(m, fields={k: torch.from_numpy(v) for k, v in fields.items()})
    jm = jm._replace(fields={k: jnp.asarray(v) for k, v in fields.items()})
    jpm, jtk, _ = jpart.sort_permute(jcfg, jm, nt)
    pm, tk, _ = partition.sort_permute(cfg, m, nt)
    assert set(pm.fields) == set(layout)
    for k in layout:
        assert pm.fields[k].shape == m.fields[k].shape
        _eq(pm.fields[k], jpm.fields[k], k)
    _eq(pm.pid, jpm.pid, "pid")
    _eq(tk, jtk, "tile keys")


def test_sort_permute_counts_dropped_like_jax():
    # too few tiles for the cloud: both drop the same particles
    jcfg, cfg, jm, m, nt = _raw_models(seed=3, n_tiles=8)
    jpm, jtk, jdr = jpart.sort_permute(jcfg, jm, nt)
    pm, tk, dr = partition.sort_permute(cfg, m, nt)
    assert int(dr[0]) > 0
    _eq(dr, jdr, "dropped")
    _eq(pm.pid, jpm.pid, "pid")
    _eq(tk, jtk, "tile keys")


def test_rebuild_and_finalize_match_jax():
    jcfg, cfg, (jpm, jtk, jdr), (pm, tk, dr), _ = _rebucket_both()
    rng = np.random.default_rng(5)
    pool = np.zeros((cfg.max_active_octs + 1, 16, 128), np.float32)
    jp0 = jengine.empty_partition(jcfg)
    p0 = engine.empty_partition(cfg, CPU)
    jp1, jpool1 = jpart.rebuild(jcfg, jnp.asarray(pool), jp0, (jtk,))
    p1, pool1 = partition.rebuild(cfg, torch.from_numpy(pool), p0, (tk,))
    for f in ("table", "keys", "count", "overflow"):
        _eq(getattr(p1, f), getattr(jp1, f), f)
    # second rebuild from a pool with mass in some rows and fewer particles:
    # grid-mass blocks keep their octs, rows are remapped by key
    g1 = rng.uniform(size=pool.shape).astype(np.float32)
    g1[rng.uniform(size=pool.shape[0]) < 0.5] = 0.0
    g1[-1] = 0.0
    half_j = jnp.where(jnp.arange(jtk.shape[0]) % 2 == 0, jtk, jcfg.grid_size ** 3)
    half = torch.where(torch.arange(tk.shape[0]) % 2 == 0, tk,
                       torch.full_like(tk, cfg.grid_size ** 3))
    jp2, jpool2 = jpart.rebuild(jcfg, jnp.asarray(g1), jp1, (half_j,))
    p2, pool2 = partition.rebuild(cfg, torch.from_numpy(g1), p1, (half,))
    for f in ("table", "keys", "count", "overflow"):
        _eq(getattr(p2, f), getattr(jp2, f), f)
    _eq(pool2, jpool2, "remapped pool")
    jt = jpart.finalize_tiles(jcfg, jp2, jtk, jdr)
    t = partition.finalize_tiles(cfg, p2, tk, dr)
    for f in ("block", "bcoord", "tvalid", "dropped"):
        _eq(getattr(t, f), getattr(jt, f), f)
        assert to_np(getattr(t, f)).dtype == np.asarray(getattr(jt, f)).dtype, f


def test_rebuild_reports_overflow_like_jax():
    jcfg, cfg, (_, jtk, _), (_, tk, _), _ = _rebucket_both()
    jcfg2, cfg2 = configs(domain_bits=5, max_active_blocks=3)
    jp, _ = jpart.rebuild(jcfg2, jnp.zeros((4, 16, 128)), jengine.empty_partition(jcfg2),
                          (jtk,))
    p, _ = partition.rebuild(cfg2, torch.zeros((4, 16, 128)),
                             engine.empty_partition(cfg2, CPU), (tk,))
    assert int(p.overflow[0]) > 0
    for f in ("table", "keys", "count", "overflow"):
        _eq(getattr(p, f), getattr(jp, f), f)


@pytest.mark.parametrize("shift_cells", [0.0, 0.4, -1.3])
def test_arena_margin_matches_jax(shift_cells):
    jcfg, cfg, (jpm, jtk, jdr), (pm, tk, dr), _ = _rebucket_both()
    p0 = engine.empty_partition(cfg, CPU)
    p1, _ = partition.rebuild(cfg, torch.zeros((cfg.max_active_octs + 1, 16, 128)),
                              p0, (tk,))
    jp1, _ = jpart.rebuild(jcfg, jnp.zeros((jcfg.max_active_octs + 1, 16, 128)),
                           jengine.empty_partition(jcfg), (jtk,))
    pm.tiles = partition.finalize_tiles(cfg, p1, tk, dr)
    jpm = jpm._replace(tiles=jpart.finalize_tiles(jcfg, jp1, jtk, jdr))
    # drift the particles without re-tiling
    d = np.float32(shift_cells * cfg.dx)
    pm.pos = pm.pos + torch.tensor([d, -d, 0.5 * d])[:, None]
    jpm = jpm._replace(pos=jpm.pos + jnp.asarray([d, -d, 0.5 * d])[:, None])
    got = float(partition.arena_margin(cfg, pm))
    ref = float(jpart.arena_margin(jcfg, jpm))
    # the same f32 expression on the same values
    assert abs(got - ref) <= 1e-6
