"""The port's grid update and CFL step against the JAX package: the XLA
``grid_update`` and the Pallas kernel in interpret mode (the cases of
tests/test_pallas_grid.py)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from claymore_tpu.core import grid as jgrid
from claymore_tpu.core.types import Partition as JPartition
from claymore_tpu.ops.pallas_grid import grid_update_pallas
from claymore_tpu_torch.core import grid
from claymore_tpu_torch.core.types import Partition
from claymore_tpu_torch.ops import grid_kernel

from tests.torch_port_helpers import configs


def _random_pool(cfg, n_active, seed, nan_at=None):
    rng = np.random.default_rng(seed)
    no = cfg.num_oct_keys
    nb = cfg.max_active_octs
    keys = np.full((nb,), no, np.int32)
    keys[:n_active] = rng.choice(no, size=n_active, replace=False)
    pool = np.zeros((nb + 1, 16, 128), np.float32)
    mass = rng.uniform(0.0, 2.0, size=(n_active, 4, 128)).astype(np.float32)
    mass[mass < 0.6] = 0.0                       # plenty of empty cells
    pool[:n_active, 0:4] = mass
    pool[:n_active, 4:16] = rng.normal(0.0, 1e-3, size=(n_active, 12, 128))
    if nan_at is not None:
        pool[nan_at, 5, 7] = np.nan              # mom-x row of cell cx=1
        pool[nan_at, 1, 7] = 1.0                 # massy, so the NaN counts
    return keys, pool


def _partitions(cfg, keys):
    no = cfg.num_oct_keys
    i32 = dict(dtype=torch.int32)
    port = Partition(table=torch.zeros((no + 1,), **i32), keys=torch.from_numpy(keys),
                     count=torch.zeros((1,), **i32), overflow=torch.zeros((1,), **i32))
    jax = JPartition(table=jnp.zeros((no + 1,), jnp.int32), keys=jnp.asarray(keys),
                     count=jnp.zeros((1,), jnp.int32), overflow=jnp.zeros((1,), jnp.int32))
    return port, jax


def _check(jcfg, cfg, keys, pool, dt=3e-4):
    part, jpart = _partitions(cfg, keys)
    pv, mx = grid.grid_update(cfg, torch.from_numpy(pool), part,
                              torch.tensor(dt, dtype=torch.float32))
    pv, mx = pv.numpy(), float(mx)
    refs = [
        grid_update_pallas(jcfg, jnp.asarray(pool), jpart, jnp.float32(dt),
                           interpret=True),
        jgrid.grid_update(jcfg, jnp.asarray(pool), jpart, jnp.float32(dt)),
    ]
    for rp, rm in refs:
        rp = np.asarray(rp)
        # mass rows pass through bit for bit
        np.testing.assert_array_equal(pv[:, 0:4], rp[:, 0:4])
        # velocities: FMA-contraction ulps between lowerings
        np.testing.assert_allclose(pv[:, 4:16], rp[:, 4:16], rtol=1e-5, atol=1e-9)
        rm = float(rm)
        if np.isinf(rm):
            assert np.isinf(mx)
        else:
            assert abs(mx - rm) <= 1e-6 * max(1.0, abs(rm))
    return pv, mx


def test_matches_jax_incl_boundary_octs():
    jcfg, cfg = configs(domain_bits=6, max_active_blocks=192)
    # enough active octs that boundary coordinates certainly occur
    keys, pool = _random_pool(cfg, n_active=150, seed=1)
    _check(jcfg, cfg, keys, pool)


def test_ragged_rows_and_mass_in_null_row():
    jcfg, cfg = configs(domain_bits=5, max_active_blocks=96)
    keys, pool = _random_pool(cfg, n_active=60, seed=2)
    pool[-1, 0:4] = 1.0
    pool[-1, 4:8] = 0.25
    pv, mx = _check(jcfg, cfg, keys, pool)
    # the null row sits inside the sticky slab: only gravity is left
    np.testing.assert_allclose(pv[-1, 8:12], np.float32(-9.8) * np.float32(3e-4))
    assert mx > 0.0


def test_nan_momentum_poisons_max():
    jcfg, cfg = configs(domain_bits=6, max_active_blocks=128)
    keys, pool = _random_pool(cfg, n_active=100, seed=3, nan_at=5)
    _, mx = _check(jcfg, cfg, keys, pool, dt=1e-4)
    assert np.isinf(mx)


def test_wrapper_runs_plain_version_on_cpu():
    _, cfg = configs(domain_bits=5, max_active_blocks=64)
    keys, pool = _random_pool(cfg, n_active=20, seed=4)
    part, _ = _partitions(cfg, keys)
    dt = torch.tensor(2e-4)
    before = dict(grid_kernel.grid_update.launches)
    a = grid_kernel.grid_update(cfg, torch.from_numpy(pool), part, dt)
    b = grid.grid_update(cfg, torch.from_numpy(pool), part, dt)
    assert grid_kernel.grid_update.launches == before       # no kernel on CPU
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])
    with pytest.raises(NotImplementedError):
        grid_kernel.grid_update(cfg, torch.from_numpy(pool), part, dt,
                                colliders=(object(),))


@pytest.mark.parametrize("max_vel_sqr,t,frame_end", [
    (0.0, 0.0, 1.0),          # at rest: default dt
    (4.0, 0.0, 1.0),          # CFL-limited
    (1e-6, 0.0, 1.0),         # slow: default dt again
    (4.0, 0.4, 0.4005),       # clamped to the frame end
    (float("inf"), 0.0, 1.0), # diverged: NaN poisons dt
])
def test_compute_dt_matches_jax(max_vel_sqr, t, frame_end):
    jcfg, cfg = configs(domain_bits=7, default_dt=2e-3)
    f = np.float32
    ref = float(jgrid.compute_dt(jcfg, jnp.float32(max_vel_sqr), jnp.float32(t),
                                 jnp.float32(frame_end)))
    got = float(grid.compute_dt(cfg, torch.tensor(f(max_vel_sqr)), torch.tensor(f(t)),
                                torch.tensor(f(frame_end))))
    if np.isnan(ref):
        assert np.isnan(got)
    else:
        assert abs(got - ref) <= 1e-10
