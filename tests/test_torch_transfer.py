"""The port's transfer (rasterize_model, g2p2g_model) against the JAX XLA
transfer, which the JAX suite holds equal to the Pallas kernel
(tests/test_pallas.py).  Both start from one state carried across with
``interop``; the bounds are tests/test_pallas.py's."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import claymore_tpu_torch as ct
from claymore_tpu.core import grid as jgrid
from claymore_tpu.core import transfer as jtransfer
from claymore_tpu.utils.debug import pool_to_dense as jax_pool_to_dense
from claymore_tpu_torch.core import grid, partition, transfer
from claymore_tpu_torch.interop import state_to_numpy
from claymore_tpu_torch.io.sampler import sample_uniform_box_world
from claymore_tpu_torch.ops import g2p2g_kernel
from claymore_tpu_torch.utils.debug import pool_to_dense

from tests.torch_port_helpers import (CPU, configs, fixed_corotated_pair, jax_state,
                                      material_pair, pid_matched)


def _scene(name="fixed_corotated"):
    jcfg, cfg = configs(domain_bits=5, max_active_blocks=256, default_dt=1e-3)
    jmat, mat = (fixed_corotated_pair(jcfg) if name == "fixed_corotated"
                 else material_pair(jcfg, name))
    rng = np.random.default_rng(7)
    pos = sample_uniform_box_world(cfg.dx, [0.40, 0.43, 0.41], [0.58, 0.60, 0.57],
                                   cfg.ppc)
    pos = pos + rng.uniform(-0.2, 0.2, size=pos.shape).astype(np.float32) * cfg.dx
    eng = ct.MPMEngine(cfg, [mat], tile_chunk=4, device=CPU)
    s = eng.init_state([pos], [(0.7, -1.5, 0.3)])
    return jcfg, cfg, jmat, mat, pos, s


def test_rasterize_matches_jax():
    jcfg, cfg, jmat, mat, pos, s = _scene()
    js = jax_state(state_to_numpy(s))
    v0 = (0.7, -1.5, 0.3)
    jpool = jtransfer.rasterize_model(
        jcfg, jmat, js.partition.table, js.models[0], jnp.asarray(v0, jnp.float32),
        jnp.zeros_like(js.grid), tile_chunk=4)
    jm, jmom = jax_pool_to_dense(jcfg, js._replace(grid=jpool))
    m, mom = pool_to_dense(cfg, s)
    np.testing.assert_allclose(m, jm, atol=1e-5, rtol=1e-4)
    np.testing.assert_allclose(mom, jmom, atol=1e-5, rtol=1e-4)
    expected = pos.shape[0] * mat.mass
    assert abs(m.sum() - expected) / expected < 1e-6
    np.testing.assert_allclose(mom.sum(axis=(0, 1, 2)), np.asarray(v0) * expected,
                               rtol=1e-5)


def _one_transfer(jcfg, cfg, jmat, mat, s, tile_chunk=4):
    """Grid update + G2P2G in both packages from the same state."""
    js = jax_state(state_to_numpy(s))
    fe = 1.0
    pool_v, mv = grid.grid_update(cfg, s.grid, s.partition, s.dt)
    next_dt = grid.compute_dt(cfg, mv, s.t + s.dt, torch.tensor(fe))
    m1, pool1 = transfer.g2p2g_model(cfg, mat, pool_v, s.partition.table,
                                     s.models[0], s.dt, next_dt,
                                     torch.zeros_like(s.grid), tile_chunk)
    jpool_v, jmv = jgrid.grid_update(jcfg, js.grid, js.partition, js.dt)
    jnext_dt = jgrid.compute_dt(jcfg, jmv, js.t + js.dt, jnp.float32(fe))
    jm1, jpool1 = jtransfer.g2p2g_model(jcfg, jmat, jpool_v, js.partition.table,
                                        js.models[0], js.dt, jnext_dt,
                                        jnp.zeros_like(js.grid), tile_chunk)
    return (m1, pool1), (jm1, jpool1), js


@pytest.mark.parametrize("tile_chunk", [4, 8])
def test_g2p2g_matches_jax(tile_chunk):
    jcfg, cfg, jmat, mat, pos, s = _scene()
    (m1, pool1), (jm1, jpool1), js = _one_transfer(jcfg, cfg, jmat, mat, s, tile_chunk)
    m, mom = pool_to_dense(cfg, dataclasses.replace(s, grid=pool1))
    jm, jmom = jax_pool_to_dense(jcfg, js._replace(grid=jpool1))
    np.testing.assert_allclose(m, jm, atol=1e-5, rtol=1e-4)
    np.testing.assert_allclose(mom, jmom, atol=1e-5, rtol=1e-4)
    assert float(pool1[cfg.null_oct].abs().sum()) == 0.0
    a, b = pid_matched(m1, jm1, "pos")
    assert np.max(np.abs(a - b)) < 1e-6
    a, b = pid_matched(m1, jm1, "F")
    assert np.max(np.abs(a - b)) < 1e-5
    # the particles moved and deformed
    a, b = pid_matched(m1, s.models[0], "pos")
    assert np.min(np.abs(a - b).max(axis=0)) > 0.0
    a, b = pid_matched(m1, s.models[0], "F")
    assert np.max(np.abs(a - b)) > 0.0


@pytest.mark.parametrize("name", ["jfluid", "sand", "nacc"])
def test_g2p2g_material_matches_jax(name):
    """Each material's transfer: grids, positions and every field, paired
    by pid (JFluid's J [S]; Sand's and NACC's F [9, S] and logJp [S])."""
    jcfg, cfg, jmat, mat, pos, s = _scene(name)
    # a velocity field with shear and compression, so J, F and the return
    # maps move (the rasterized v0 is uniform: A would vanish)
    rng = np.random.default_rng(9)
    grid = s.grid.clone()
    m = grid[:, 0:4].reshape(-1, 1, 4, 128)
    noise = torch.from_numpy(rng.normal(0.0, 2.0, size=(grid.shape[0], 3, 4, 128))
                             .astype(np.float32))
    grid[:, 4:16] += (noise * m).reshape(-1, 12, 128)
    s = dataclasses.replace(s, grid=grid)
    (m1, pool1), (jm1, jpool1), js = _one_transfer(jcfg, cfg, jmat, mat, s)
    m, mom = pool_to_dense(cfg, dataclasses.replace(s, grid=pool1))
    jm, jmom = jax_pool_to_dense(jcfg, js._replace(grid=jpool1))
    np.testing.assert_allclose(m, jm, atol=1e-5, rtol=1e-4)
    np.testing.assert_allclose(mom, jmom, atol=1e-5, rtol=1e-4)
    a, b = pid_matched(m1, jm1, "pos")
    assert np.max(np.abs(a - b)) < 1e-6
    assert set(m1.fields) == {k for k, _ in jmat.field_specs}
    for k in m1.fields:
        assert m1.fields[k].shape == s.models[0].fields[k].shape
        a, b = pid_matched(m1, jm1, k)
        assert np.max(np.abs(a - b)) <= 1e-5 * max(1.0, np.max(np.abs(b))), k
    a, b = pid_matched(m1, s.models[0], "J" if name == "jfluid" else "F")
    assert np.max(np.abs(a - b)) > 0.0


def test_g2p2g_wrapper_runs_plain_version_on_cpu():
    jcfg, cfg, jmat, mat, pos, s = _scene()
    pool_v, mv = grid.grid_update(cfg, s.grid, s.partition, s.dt)
    before = dict(g2p2g_kernel.g2p2g.launches)
    a, pa, margin = g2p2g_kernel.g2p2g(cfg, mat, pool_v, s.partition.table, s.models[0],
                                       s.dt, s.dt, torch.zeros_like(s.grid), 4)
    b, pb = transfer.g2p2g_model(cfg, mat, pool_v, s.partition.table, s.models[0],
                                 s.dt, s.dt, torch.zeros_like(s.grid), 4)
    assert g2p2g_kernel.g2p2g.launches == before       # no kernel on CPU
    assert torch.equal(pa, pb) and torch.equal(a.pos, b.pos)
    assert torch.equal(a.fields["F"], b.fields["F"]) and torch.equal(a.pid, b.pid)
    assert torch.equal(margin, partition.arena_margin(cfg, b))
