"""The port's incremental (mover-only) rebucket against the JAX package on
the CPU (the lazy span-4 arenas: tests/test_torch_lazy.py).

``incremental_plan`` only moves data, so it must equal the JAX function
exactly.  The engines run the same substeps from the same positions, the
JAX side through its XLA path (``use_pallas=False``, exact float32; the
only JAX path for these settings), the port through the plain versions of
its kernels, and are held to ``tests/test_pallas.py``'s bounds with
particles paired by id.
"""

import json
import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import claymore_tpu as cmt
import claymore_tpu_torch as ct
from claymore_tpu.core import partition as jpart
from claymore_tpu.utils.debug import pool_to_dense as jax_pool_to_dense
from claymore_tpu_torch.core import partition as tpart
from claymore_tpu_torch.core.engine import full_rebuild
from claymore_tpu_torch.interop import state_to_numpy
from claymore_tpu_torch.io.sampler import sample_uniform_box_world
from claymore_tpu_torch.utils.debug import check_partition, pool_to_dense

from tests.torch_port_helpers import (CPU, by_pid, configs, fixed_corotated_pair,
                                      jax_state, material_pair, pid_matched, to_np)

BOX = ([0.40, 0.45, 0.42], [0.56, 0.6, 0.55])
V0 = [(2.0, -4.0, 1.5)]           # 0.26 cells of drift per substep at dt 2e-3


def _port_state(steps: int, **kw):
    """(jax cfg, port cfg, port state) after ``steps`` substeps of a span-4
    engine that rebuilds only every 4th substep, so the state has movers."""
    jcfg, cfg = configs(domain_bits=5, max_active_blocks=256, default_dt=2e-3,
                        rebucket_every=4, particle_tile=32, **kw)
    _, mat = fixed_corotated_pair(jcfg)
    pos = sample_uniform_box_world(cfg.dx, *BOX, cfg.ppc)
    eng = ct.MPMEngine(cfg, [mat], tile_chunk=4, device=CPU)
    s = eng.init_state([pos], V0)
    for _ in range(steps):
        s = eng.substep(s, 1.0)
    assert eng.rebuilds == 0
    return jcfg, cfg, s


def _tile_keys_np(cfg, m):
    n3 = cfg.grid_size ** 3
    return np.where(to_np(m.tiles.tvalid), to_np(tpart.flatten_key(cfg, m.tiles.bcoord)),
                    n3).astype(np.int32)


def _free_tiles_case(cfg):
    """(port model, tile keys) with one free tile for seven tiles' worth of
    movers: tiles 0..6 bind seven blocks and hold 24 particles each, the
    last 8 of them in the next tile's block; tile 7 holds nothing."""
    rng = np.random.default_rng(0)
    tile, t = cfg.particle_tile, 8
    g = cfg.grid_size
    blocks = [(1 + j % 3, 2 + j // 3, 3) for j in range(7)]
    keys = np.array([(bx * g + by) * g + bz for bx, by, bz in blocks] + [g ** 3], np.int32)
    pos = np.zeros((3, t * tile), np.float32)
    active = np.zeros(t * tile, bool)
    for j in range(7):
        for q in range(24):
            b = np.array(blocks[j if q < 16 else (j + 1) % 7])
            cell = 4 * b + 2 + rng.uniform(-0.4, 0.4, 3)
            pos[:, j * tile + q] = cell * cfg.dx
            active[j * tile + q] = True
    s_cap = t * tile
    pid = np.where(active, np.arange(s_cap), s_cap).astype(np.int32)
    f = rng.normal(size=(9, s_cap)).astype(np.float32)
    model = ct.ParticleModel(pos=torch.from_numpy(pos), fields={"F": torch.from_numpy(f)},
                             active=torch.from_numpy(active), pid=torch.from_numpy(pid),
                             tiles=None)
    return model, keys


# mover_capacity_frac, the input, what must defer
_PLAN_CASES = {
    "movers": (0.125, "state", None),
    "capacity": (0.01, "state", "capacity"),
    "free_tiles": (1.0, "synthetic", "free"),
}


@pytest.mark.parametrize("case", sorted(_PLAN_CASES))
def test_incremental_plan_equals_jax(case):
    from claymore_tpu.core import types as jt

    frac, source, defers = _PLAN_CASES[case]
    if source == "state":
        jcfg, cfg, s = _port_state(3, mover_capacity_frac=frac)
        m = s.models[0]
        tk = _tile_keys_np(cfg, m)
        jm = jax_state(state_to_numpy(s)).models[0]
    else:
        jcfg, cfg = configs(domain_bits=5, max_active_blocks=256, particle_tile=32,
                            mover_capacity_frac=frac)
        m, tk = _free_tiles_case(cfg)
        jm = jt.ParticleModel(pos=jnp.asarray(to_np(m.pos)),
                              fields={"F": jnp.asarray(to_np(m.fields["F"]))},
                              active=jnp.asarray(to_np(m.active)),
                              pid=jnp.asarray(to_np(m.pid)), tiles=None)
    m2, tk2, d2 = tpart.incremental_plan(cfg, m, torch.from_numpy(tk))
    jm2, jtk2, jd2 = jpart.incremental_plan(jcfg, jm, jnp.asarray(tk))

    pairs = [("pos", m2.pos, jm2.pos), ("active", m2.active, jm2.active),
             ("pid", m2.pid, jm2.pid), ("tile_keys", tk2, jtk2), ("deferred", d2, jd2)]
    pairs += [(k, m2.fields[k], jm2.fields[k]) for k in m.fields]
    for name, a, b in pairs:
        a, b = to_np(a), np.asarray(b)
        assert a.dtype == b.dtype, name
        np.testing.assert_array_equal(a, b, err_msg=name)

    key = to_np(tpart.flatten_key(cfg, tpart.home_block(cfg, m.pos)))
    movers = int((to_np(m.active) & (key != np.repeat(tk, cfg.particle_tile))).sum())
    deferred = int(to_np(d2)[0])
    assert movers > 0
    if defers is None:
        assert deferred == 0
    elif defers == "capacity":
        # the buffer holds max(tile, frac x slots) movers, the rest wait
        assert deferred == movers - max(cfg.particle_tile, int(len(key) * frac))
    else:
        # room for every mover in the buffer, one free tile: the movers of
        # one tile are placed, the other six tiles' worth deferred
        assert deferred == movers - 8
    # nothing is lost: every particle stays active once, under its id
    assert sorted(to_np(m2.pid)[to_np(m2.active)]) == sorted(to_np(m.pid)[to_np(m.active)])


def _compare(eng, s, jeng, js, npart, mass):
    """The two engines' states at the bounds of tests/test_pallas.py, plus
    the invariants of the port's state."""
    cfg = eng.cfg
    jm, jmom = jax_pool_to_dense(jeng.cfg, js)
    m, mom = pool_to_dense(cfg, s)
    np.testing.assert_allclose(m, jm, atol=1e-5, rtol=1e-4)
    np.testing.assert_allclose(mom, jmom, atol=1e-5, rtol=1e-4)
    a, b = pid_matched(s.models[0], js.models[0], "pos")
    assert np.max(np.abs(a - b)) < 1e-6
    a, b = pid_matched(s.models[0], js.models[0], "F")
    assert np.max(np.abs(a - b)) < 1e-5
    dj, dp = jeng.diagnostics(js), eng.diagnostics(s)
    for k in ("active_octs", "block_overflow", "step", "model0_active",
              "model0_dropped_tiles"):
        assert dp[k] == dj[k], k
    assert abs(m.sum() - npart * mass) / (npart * mass) < 1e-6
    assert dp["null_block_mass"] == 0.0
    assert dp["model0_active"] == npart
    assert dp["model0_dropped_tiles"] == 0
    check_partition(cfg, s.partition)
    eng.check_health(s, strict=True)


def _engines(**kw):
    jcfg, cfg = configs(domain_bits=5, max_active_blocks=256, default_dt=2e-3, **kw)
    jmat, mat = fixed_corotated_pair(jcfg)
    pos = sample_uniform_box_world(cfg.dx, *BOX, cfg.ppc)
    jeng = cmt.MPMEngine(jcfg, [jmat], tile_chunk=4)
    eng = ct.MPMEngine(cfg, [mat], tile_chunk=4, device=CPU)
    return jeng, eng, pos, mat


@pytest.mark.parametrize("k_every,defrag", [(1, 4), (2, 3), (4, 2)])
def test_incremental_engine_matches_jax(k_every, defrag):
    jeng, eng, pos, mat = _engines(rebucket_every=k_every, defrag_every=defrag)
    js, s = jeng.init_state([pos], V0), eng.init_state([pos], V0)
    holes = 0
    for _ in range(2 * k_every * defrag + 1):
        step = int(s.step)
        js = jeng.substep(js, jnp.float32(1.0))
        s = eng.substep(s, 1.0)
        if (step + 1) % k_every == 0 and not full_rebuild(eng.cfg, step):
            # an incremental rebuild: live tiles with empty slots remain
            act = to_np(s.models[0].active).reshape(-1, eng.cfg.particle_tile)
            live = to_np(s.models[0].tiles.tvalid)
            holes = max(holes, int((live[:, None] & ~act).sum()))
    assert holes > 0
    assert eng.rebuilds == (2 * k_every * defrag + 1) // k_every
    _compare(eng, s, jeng, js, pos.shape[0], mat.mass)


def test_checkpoint_with_holes_resumes_bit_for_bit(tmp_path):
    """A state with incremental holes and freed tiles saved and loaded
    equals itself leaf for leaf, and substeps from both agree bit for bit."""
    from claymore_tpu_torch.core.engine import clone_state
    from claymore_tpu_torch.io import checkpoint as ckpt

    _, cfg = configs(domain_bits=5, max_active_blocks=256, default_dt=2e-3,
                     rebucket_every=1, defrag_every=4)
    mat = ct.FixedCorotated(volume=cfg.default_volume(), e=1e4, nu=0.3)
    pos = sample_uniform_box_world(cfg.dx, *BOX, cfg.ppc)
    eng = ct.MPMEngine(cfg, [mat], tile_chunk=4, device=CPU)
    s = eng.init_state([pos], V0)
    for _ in range(2):
        s = eng.substep(s, 1.0)
    act = to_np(s.models[0].active).reshape(-1, cfg.particle_tile)
    assert (to_np(s.models[0].tiles.tvalid)[:, None] & ~act).any()
    path = str(tmp_path / "holes.npz")
    ckpt.save_state(path, s)
    back = ckpt.load_state(path, eng.init_state([pos], V0))
    for a, b in zip(ckpt.leaves(s), ckpt.leaves(back)):
        assert a.dtype == b.dtype
        assert torch.equal(a, b)
    a, b = clone_state(s), back
    for _ in range(2):
        a = eng.substep(a, 1.0)
        b = eng.substep(b, 1.0)
    for x, y in zip(ckpt.leaves(a), ckpt.leaves(b)):
        assert torch.equal(x, y)


def test_prof_rebuild_runs_on_cpu():
    """The entry point as a user runs it, on the CPU at bench.py's quick
    cube: one JSON line with the three stages of the JAX script."""
    proc = subprocess.run(
        [sys.executable, "-m", "claymore_tpu_torch.scripts.prof_rebuild", "--device", "cpu",
         "--quick", "--iters", "1", "--reps", "1"],
        capture_output=True, text=True, timeout=300,
        env={**os.environ, "OMP_NUM_THREADS": "1"})
    assert proc.returncode == 0, proc.stderr
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    for k in ("sort", "sort_permute", "table_rebuild+remap"):
        assert out[k] > 0.0, k
    assert out["particles"] == 226981 and out["device"] == "cpu"


def test_regrow_and_update_material_take_a_state_with_holes():
    """``regrow`` and ``update_material`` on a state whose tiles have holes
    from incremental rebuilds: regrow keeps every particle where it was
    (new pid k = the k-th active slot) and both engines step on."""
    _, cfg = configs(domain_bits=5, max_active_blocks=256, default_dt=2e-3,
                     rebucket_every=1, defrag_every=4)
    mat = ct.FixedCorotated(volume=cfg.default_volume(), e=1e4, nu=0.3)
    pos = sample_uniform_box_world(cfg.dx, *BOX, cfg.ppc)
    eng = ct.MPMEngine(cfg, [mat], tile_chunk=4, device=CPU)
    s = eng.init_state([pos], V0)
    for _ in range(2):
        s = eng.substep(s, 1.0)
    m = s.models[0]
    act = to_np(m.active)
    assert (to_np(m.tiles.tvalid)[:, None] & ~act.reshape(-1, cfg.particle_tile)).any()
    eng2, s2 = eng.regrow(s)
    m2 = s2.models[0]
    old = to_np(m.pos)[:, act]                      # slot order = the new pids
    new = np.empty_like(old)
    new[:, to_np(m2.pid)[to_np(m2.active)]] = to_np(m2.pos)[:, to_np(m2.active)]
    np.testing.assert_array_equal(new, old)
    soft = eng2.update_material(0, e=1e3)
    for e, st in ((eng2, s2), (soft, s2), (eng.update_material(0, e=1e3), s)):
        st = e.run_steps(st, 3, 1.0)
        d = e.diagnostics(st)
        assert d["model0_active"] == pos.shape[0] and d["null_block_mass"] == 0.0
        assert d["model0_dropped_tiles"] == 0 and d["block_overflow"] == 0
        assert abs(d["grid_mass"] - pos.shape[0] * mat.mass) < 1e-5 * pos.shape[0] * mat.mass


def test_free_tile_exhaustion_loses_the_same_particles_as_jax():
    """With few spare tiles, incremental rebuilds in a row run out of free
    tiles.  The JAX package defers movers (``tiles.dropped``) and then
    deactivates those that leave their old tile's arena, so mass leaves
    with them.  The port's plan defers the same movers at the same substep,
    and the engine runs the full sort instead: nothing deferred, nothing
    lost, mass kept."""
    jcfg, cfg = configs(domain_bits=5, max_active_blocks=256, default_dt=2e-3,
                        rebucket_auto=True, defrag_every=4, particle_tile=32)
    pos = sample_uniform_box_world(cfg.dx, [0.30, 0.45, 0.30], [0.62, 0.7, 0.62], cfg.ppc)
    n = pos.shape[0]
    tiles = ct.exact_tiles(cfg, [pos], slack=1.25)
    jcfg, cfg = configs(domain_bits=5, max_active_blocks=256, default_dt=2e-3,
                        rebucket_auto=True, defrag_every=4, particle_tile=32,
                        max_tiles=tiles)
    jmat, mat = material_pair(jcfg, "jfluid")
    jeng = cmt.MPMEngine(jcfg, [jmat], tile_chunk=4)
    eng = ct.MPMEngine(cfg, [mat], tile_chunk=4, device=CPU)
    v0 = [(3.0, -4.0, 2.0)]
    js, s = jeng.init_state([pos], v0), eng.init_state([pos], v0)
    jax_deferred, plan_deferred = [], []
    for _ in range(12):
        js = jeng.substep(js, jnp.float32(1.0))
        before = eng.rebuilds
        s = eng.substep(s, 1.0)
        dj, dp = jeng.diagnostics(js), eng.diagnostics(s)
        jax_deferred.append(dj["model0_dropped_tiles"])
        rebuilt = eng.rebuilds > before and eng.last_rebuild[0] != "full"
        plan_deferred.append(eng.last_rebuild[1][0] if rebuilt else 0)
        assert dp["model0_dropped_tiles"] == 0 and dp["model0_active"] == n
        assert dp["null_block_mass"] == 0.0
    assert max(jax_deferred) > 0 and dj["model0_active"] < n
    # up to the first deferral the two engines take the same steps
    first = next(i for i, d in enumerate(jax_deferred) if d > 0)
    assert plan_deferred[first] == jax_deferred[first]
    assert eng.fallbacks > 0
    np.testing.assert_allclose(dp["grid_mass"], n * mat.mass, rtol=1e-5)
    check_partition(cfg, s.partition)
