"""Capacity regrow, material updates and the stage profile of the port's
engine against the JAX package.

The recipe is ``tests/test_regrow.py``'s: a FixedCorotated box falling in a
32^3 domain, an ample engine and a tight one whose capacity its initial
octs fill exactly, so that the >90% occupancy trigger fires at the end of
the first frame.  Both packages run on the CPU, JAX through its XLA path
with exact float32, the port through its kernels' plain versions.
Particles are paired by pid, never by sorted positions.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest

import claymore_tpu as cmt
import claymore_tpu_torch as ct
from claymore_tpu.utils.debug import pool_to_dense as jax_pool_to_dense
from claymore_tpu_torch.interop import config_from_jax
from claymore_tpu_torch.io.sampler import sample_uniform_box_world
from claymore_tpu_torch.utils.debug import check_partition, pool_to_dense

from tests.torch_port_helpers import CPU, configs, fixed_corotated_pair, pid_matched, to_np

V0 = [(0.0, -0.4, 0.0)]
STAGES = {"grid_update", "g2p2g", "rebuild", "substep", "overhead"}   # JAX's keys


def _recipe():
    jcfg, cfg = configs(domain_bits=5, max_active_blocks=256, default_dt=5e-4, fps=96)
    jmat, mat = fixed_corotated_pair(jcfg, e=1e4, nu=0.3)
    jmat = dataclasses.replace(jmat, volume=1e-6)
    mat = dataclasses.replace(mat, volume=1e-6)
    pos = sample_uniform_box_world(1 / 32, [0.45] * 3, [0.6] * 3, 8.0)
    return jcfg, cfg, jmat, mat, pos


def _tight(jcfg, cfg, mat, pos):
    octs0 = int(ct.MPMEngine(cfg, [mat], tile_chunk=4, device=CPU)
                .init_state([pos], V0).partition.count[0])
    jtight = dataclasses.replace(jcfg, max_active_blocks=octs0)
    return jtight, config_from_jax(dataclasses.asdict(jtight))


def test_regrow_matches_jax():
    """``run(1, auto_grow=True)`` from the tight engine in both packages:
    the same grown capacity, grids within the bounds of
    tests/test_pallas.py, particles by pid (renumbered alike) to 1e-6 and F
    to 1e-5, and the same partition and counters."""
    jcfg, cfg, jmat, mat, pos = _recipe()
    jtight, tight = _tight(jcfg, cfg, mat, pos)
    jeng = cmt.MPMEngine(jtight, [jmat], tile_chunk=4)
    eng = ct.MPMEngine(tight, [mat], tile_chunk=4, device=CPU)
    jeng2, js = jeng.run(jeng.init_state([pos], V0), 1, auto_grow=True)
    eng2, s = eng.run(eng.init_state([pos], V0), 1, auto_grow=True)

    assert eng2 is not eng and jeng2 is not jeng
    assert eng2.cfg.max_active_blocks == jeng2.cfg.max_active_blocks > tight.max_active_blocks
    assert eng2._num_tiles == jeng2._num_tiles
    jm, jmom = jax_pool_to_dense(jeng2.cfg, js)
    m, mom = pool_to_dense(eng2.cfg, s)
    np.testing.assert_allclose(m, jm, atol=1e-5, rtol=1e-4)
    np.testing.assert_allclose(mom, jmom, atol=1e-5, rtol=1e-4)
    np.testing.assert_array_equal(to_np(s.partition.keys), np.asarray(js.partition.keys))
    a, b = pid_matched(s.models[0], js.models[0], "pos")
    assert np.max(np.abs(a - b)) < 1e-6
    a, b = pid_matched(s.models[0], js.models[0], "F")
    assert np.max(np.abs(a - b)) < 1e-5
    dj, dp = jeng2.diagnostics(js), eng2.diagnostics(s)
    for k in ("active_octs", "block_overflow", "step", "model0_active",
              "model0_dropped_tiles"):
        assert dp[k] == dj[k], k
    assert dp["model0_active"] == pos.shape[0] and dp["null_block_mass"] == 0.0
    np.testing.assert_allclose(dp["t"], dj["t"], rtol=1e-7)
    check_partition(eng2.cfg, s.partition)


def test_regrown_run_matches_ample_run():
    """Two frames from the tight engine (regrown after the first) against
    two from the ample one: every particle and its mass kept, and the same
    positions particle by particle, new pid k being the k-th active slot
    at the regrow (the JAX package renumbers the same way)."""
    jcfg, cfg, _, mat, pos = _recipe()
    _, tight = _tight(jcfg, cfg, mat, pos)
    ample = ct.MPMEngine(cfg, [mat], tile_chunk=4, device=CPU)
    sa = ample.run(ample.init_state([pos], V0), 2)

    eng = ct.MPMEngine(tight, [mat], tile_chunk=4, device=CPU)
    seen = []
    grow = eng.regrow

    def recording(state, factor=1.5):
        m = state.models[0]
        seen.append(to_np(m.pid)[to_np(m.active)])
        return grow(state, factor)

    eng.regrow = recording
    eng2, st = eng.run(eng.init_state([pos], V0), 2, auto_grow=True)
    assert len(seen) == 1 and eng2.cfg.max_active_blocks > tight.max_active_blocks
    d = eng2.diagnostics(st)
    assert d["step"] == ample.diagnostics(sa)["step"]
    assert d["model0_active"] == pos.shape[0] and d["model0_dropped_tiles"] == 0
    assert d["block_overflow"] == 0 and d["null_block_mass"] == 0.0
    expected = pos.shape[0] * mat.mass
    assert abs(d["grid_mass"] - expected) / expected < 1e-5

    def by_pid(model):
        act = to_np(model.active)
        out = np.empty((3, pos.shape[0]), np.float32)
        out[:, to_np(model.pid)[act]] = to_np(model.pos)[:, act]
        return out

    assert np.max(np.abs(by_pid(st.models[0]) - by_pid(sa.models[0])[:, seen[0]])) < 1e-5


def test_needs_growth_triggers():
    """The growth test of the JAX package: overflow, octs above 0.9 of the
    capacity, dropped particles, valid tiles above 0.9 of the tiles."""
    _, cfg, _, mat, pos = _recipe()
    eng = ct.MPMEngine(cfg, [mat], tile_chunk=4, device=CPU)
    s = eng.init_state([pos], V0)
    assert not eng._needs_growth(s)
    m = s.models[0]
    cases = [
        dataclasses.replace(s, partition=dataclasses.replace(
            s.partition, overflow=s.partition.overflow + 1)),
        dataclasses.replace(s, partition=dataclasses.replace(
            s.partition, count=s.partition.count * 0 + int(0.9 * cfg.max_active_octs) + 1)),
        dataclasses.replace(s, models=(dataclasses.replace(m, tiles=dataclasses.replace(
            m.tiles, dropped=m.tiles.dropped + 1)),)),
        dataclasses.replace(s, models=(dataclasses.replace(m, tiles=dataclasses.replace(
            m.tiles, tvalid=m.tiles.tvalid | True)),)),
    ]
    assert all(eng._needs_growth(c) for c in cases)


def test_update_material_matches_jax():
    """``update_material`` in both packages, then 5 substeps: grids and
    particles agree; the new engine keeps the tile counts and its material
    is the only thing that changed, and it changes the result."""
    jcfg, cfg, jmat, mat, pos = _recipe()
    jeng = cmt.MPMEngine(jcfg, [jmat], tile_chunk=4)
    eng = ct.MPMEngine(cfg, [mat], tile_chunk=4, device=CPU)
    js, s = jeng.init_state([pos], V0), eng.init_state([pos], V0)
    jsoft, soft = jeng.update_material(0, e=100.0), eng.update_material(0, e=100.0)
    assert soft.materials[0] == dataclasses.replace(mat, e=100.0)
    assert soft._num_tiles == eng._num_tiles == jsoft._num_tiles
    stiff = s
    for _ in range(5):
        js = jsoft.substep(js, jnp.float32(1.0))
        s = soft.substep(s, 1.0)
        stiff = eng.substep(stiff, 1.0)
    jm, jmom = jax_pool_to_dense(jcfg, js)
    m, mom = pool_to_dense(cfg, s)
    np.testing.assert_allclose(m, jm, atol=1e-5, rtol=1e-4)
    np.testing.assert_allclose(mom, jmom, atol=1e-5, rtol=1e-4)
    a, b = pid_matched(s.models[0], js.models[0], "pos")
    assert np.max(np.abs(a - b)) < 1e-6
    a, b = pid_matched(s.models[0], js.models[0], "F")
    assert np.max(np.abs(a - b)) < 1e-5
    a, b = pid_matched(s.models[0], stiff.models[0], "F")
    assert np.max(np.abs(a - b)) > 0.0


def test_profile_stages_leaves_its_input():
    """``profile_stages`` gives JAX's stages with finite times and leaves the
    state it profiles bit for bit as it was."""
    from claymore_tpu_torch.interop import state_to_numpy

    _, cfg, _, mat, pos = _recipe()
    cfg = dataclasses.replace(cfg, rebucket_auto=True)
    eng = ct.MPMEngine(cfg, [mat], tile_chunk=4, device=CPU)
    s = eng.substep(eng.init_state([pos], V0), 1.0)
    before = state_to_numpy(s)
    out = eng.profile_stages(s, iters=2, reps=1)
    assert set(out) == STAGES and all(np.isfinite(v) for v in out.values())
    assert out["overhead"] == pytest.approx(
        out["substep"] - out["grid_update"] - out["g2p2g"] - out["rebuild"])
    after = state_to_numpy(s)

    def leaves(x):
        if isinstance(x, np.ndarray):
            return [x]
        if isinstance(x, dict):
            return [y for k in sorted(x) for y in leaves(x[k])]
        return [y for v in x for y in leaves(v)]

    for a, b in zip(leaves(before), leaves(after), strict=True):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
