"""Span-4 states whose tiles are wider than K1's span-4 P2G window (6
stencil bases an axis), as ``prof_k1.spread_tiles`` builds them for the
card's checks: the port's plain span-4 transfer against the JAX package's
XLA span-4 transfer on the CPU, particles paired by pid at the bounds of
``tests/test_pallas.py``; and ``prof_k1.tile_extent`` / ``wide_tiles``,
which report the share of wide tiles, against a numpy loop."""

import dataclasses

import numpy as np
import pytest

import claymore_tpu_torch as ct
from claymore_tpu.utils.debug import pool_to_dense as jax_pool_to_dense
from claymore_tpu_torch.io.sampler import sample_uniform_box_world
from claymore_tpu_torch.scripts import prof_k1
from claymore_tpu_torch.utils.debug import pool_to_dense

from tests.test_torch_transfer import _one_transfer
from tests.torch_port_helpers import (CPU, configs, fixed_corotated_pair, material_pair,
                                      pid_matched, to_np)


def _span4_scene(name="fixed_corotated", every=2, **kw):
    """A small span-4 state (tiles of 64, ``rebucket_every=4``) after one
    substep, its grid velocities stirred, and every ``every``-th live tile's
    particles spread over its arena."""
    jcfg, cfg = configs(domain_bits=5, max_active_blocks=256, default_dt=1e-3,
                        particle_tile=64, rebucket_every=4, **kw)
    jmat, mat = (fixed_corotated_pair(jcfg) if name == "fixed_corotated"
                 else material_pair(jcfg, name))
    pos = sample_uniform_box_world(cfg.dx, [0.40, 0.43, 0.41], [0.58, 0.60, 0.57], cfg.ppc)
    eng = ct.MPMEngine(cfg, [mat], tile_chunk=4, device=CPU)
    s = eng.substep(eng.init_state([pos], [(0.7, -1.5, 0.3)]), 1.0)
    s = prof_k1.stir(s, scale=2.0)
    return jcfg, cfg, jmat, mat, s, prof_k1.spread_tiles(cfg, s, every=every)


@pytest.mark.parametrize("name", ["fixed_corotated", "jfluid", "sand", "nacc"])
def test_wide_tiles_transfer_matches_jax(name):
    jcfg, cfg, jmat, mat, _, s = _span4_scene(name)
    assert cfg.arena_span == 4 and cfg.arena_lo == -1
    (m1, pool1), (jm1, jpool1), js = _one_transfer(jcfg, cfg, jmat, mat, s)
    # the port's output holds tiles wider than the window, one reaching past
    # two windows on some axis (three P2G passes there)
    ext = to_np(prof_k1.tile_extent(cfg, m1))
    assert prof_k1.wide_tiles(cfg, m1)[0] > 0
    assert ext.max() > 2 * prof_k1.WINDOW_BASES
    m, mom = pool_to_dense(cfg, dataclasses.replace(s, grid=pool1))
    jm, jmom = jax_pool_to_dense(jcfg, js._replace(grid=jpool1))
    np.testing.assert_allclose(m, jm, atol=1e-5, rtol=1e-4)
    np.testing.assert_allclose(mom, jmom, atol=1e-5, rtol=1e-4)
    assert float(pool1[cfg.null_oct].abs().sum()) == 0.0
    np.testing.assert_array_equal(to_np(m1.active), np.asarray(jm1.active))
    a, b = pid_matched(m1, jm1, "pos")
    assert np.max(np.abs(a - b)) < 1e-6
    for k in m1.fields:
        a, b = pid_matched(m1, jm1, k)
        assert np.max(np.abs(a - b)) <= 1e-5 * max(1.0, np.max(np.abs(b))), k


def _extent_loop(cfg, model):
    """[3, T] stencil-base extent of each tile's active particles, by a
    numpy loop over tiles (0 for a dead or empty tile)."""
    pos, act = to_np(model.pos), to_np(model.active)
    tvalid = to_np(model.tiles.tvalid)
    n = cfg.particle_tile
    out = np.zeros((3, tvalid.shape[0]), np.int64)
    for t in range(tvalid.shape[0]):
        sl = slice(t * n, (t + 1) * n)
        live = act[sl] & tvalid[t]
        if not live.any():
            continue
        base = (np.floor(pos[:, sl][:, live] * np.float32(cfg.dx_inv) + np.float32(0.5))
                .astype(np.int64) - 1)
        out[:, t] = base.max(axis=1) - base.min(axis=1) + 1
    return out


@pytest.mark.parametrize("spread", [False, True])
def test_tile_extent_matches_a_numpy_loop(spread):
    _, cfg, _, _, natural, spread_state = _span4_scene(every=3)
    s = spread_state if spread else natural
    m = s.models[0]
    want = _extent_loop(cfg, m)
    np.testing.assert_array_equal(to_np(prof_k1.tile_extent(cfg, m)), want)
    wide, live = prof_k1.wide_tiles(cfg, m)
    assert wide == int((want > prof_k1.WINDOW_BASES).any(axis=0).sum())
    assert live == int((want > 0).any(axis=0).sum()) > 0
    if spread:
        # the spread tiles' relative stencil bases stay in the arena's 0..13
        # and most of them leave the window
        assert wide > 0
        tv = np.nonzero(to_np(m.tiles.tvalid))[0][::3]
        n = cfg.particle_tile
        org = (to_np(m.tiles.bcoord)[:, tv] + cfg.arena_lo) * cfg.block_size
        pos = to_np(m.pos).reshape(3, -1, n)[:, tv]
        act = to_np(m.active).reshape(-1, n)[tv]
        rel = (np.floor(pos * np.float32(cfg.dx_inv) + np.float32(0.5)).astype(np.int64) - 1
               - org[..., None])
        assert rel[:, act].min() >= 0 and rel[:, act].max() <= cfg.arena_cells - 3
    else:
        assert wide == 0
