"""The PyTorch port's single-device substep against the JAX package.

Both engines start from ``init_state`` on the same positions and run the
same substeps on the CPU: the JAX side through its XLA path
(``use_pallas=False``, exact float32), the port through the plain PyTorch
versions of its kernels.
"""

import dataclasses
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest

import claymore_tpu as cmt
import claymore_tpu_torch as ct
from claymore_tpu.utils.debug import pool_to_dense as jax_pool_to_dense
from claymore_tpu_torch.interop import config_from_jax
from claymore_tpu_torch.io.sampler import sample_uniform_box_world
from claymore_tpu_torch.utils.debug import check_partition, check_tiles, pool_to_dense

from tests.torch_port_helpers import (CPU, configs, fixed_corotated_pair, material_pair,
                                      pid_matched, to_np)


@pytest.mark.parametrize("auto", [False, True])
def test_substeps_match_jax(auto):
    jcfg, cfg = configs(domain_bits=5, max_active_blocks=256, default_dt=2e-3,
                        rebucket_auto=auto)
    jmat, mat = fixed_corotated_pair(jcfg)
    pos = sample_uniform_box_world(cfg.dx, [0.40, 0.45, 0.42], [0.56, 0.6, 0.55],
                                   cfg.ppc)
    v0 = [(2.0, -4.0, 1.5)]
    jeng = cmt.MPMEngine(jcfg, [jmat], tile_chunk=4)
    eng = ct.MPMEngine(cfg, [mat], tile_chunk=4, device=CPU)
    js, s = jeng.init_state([pos], v0), eng.init_state([pos], v0)
    fe = 1.0
    for _ in range(6):
        js = jeng.substep(js, jnp.float32(fe))
        s = eng.substep(s, fe)
    # 0.26 cells of drift per substep: the drift check fires within the six
    # (auto), or every substep rebuilds (fixed cadence)
    assert eng.rebuilds >= (1 if auto else 6)

    # dense grids: f32 sums in another order (atol 1e-5 rtol 1e-4 as
    # tests/test_pallas.py holds the TPU kernel to the same oracle)
    jm, jmom = jax_pool_to_dense(jcfg, js)
    m, mom = pool_to_dense(cfg, s)
    np.testing.assert_allclose(m, jm, atol=1e-5, rtol=1e-4)
    np.testing.assert_allclose(mom, jmom, atol=1e-5, rtol=1e-4)
    # particles paired by id: positions to 1e-6, F to 1e-5
    a, b = pid_matched(s.models[0], js.models[0], "pos")
    assert np.max(np.abs(a - b)) < 1e-6
    a, b = pid_matched(s.models[0], js.models[0], "F")
    assert np.max(np.abs(a - b)) < 1e-5
    # dt is a CFL min over the same max |v|: f32 roundoff only
    assert abs(float(s.dt) - float(js.dt)) < 1e-10

    dj, dp = jeng.diagnostics(js), eng.diagnostics(s)
    for k in ("active_octs", "block_overflow", "migration_dropped", "step",
              "model0_active", "model0_dropped_tiles"):
        assert dp[k] == dj[k], k
    np.testing.assert_allclose(dp["grid_mass"], dj["grid_mass"], rtol=1e-6)
    np.testing.assert_allclose(dp["t"], dj["t"], rtol=1e-7)

    # invariants: mass to f32 roundoff, empty null row, nothing dropped
    expected = pos.shape[0] * mat.mass
    assert abs(m.sum() - expected) / expected < 1e-6
    assert dp["null_block_mass"] == 0.0
    assert dp["model0_active"] == pos.shape[0]
    check_partition(cfg, s.partition)
    check_tiles(cfg, s)


_SCENES = {
    # name: (materials, boxes, velocities, colliders)
    "jfluid": (["jfluid"], [([0.40, 0.40, 0.42], [0.56, 0.58, 0.55])],
               [(1.0, -3.0, 0.5)], False),
    "sand": (["sand"], [([0.40, 0.40, 0.42], [0.56, 0.58, 0.55])],
             [(1.5, -4.0, 0.5)], False),
    "nacc": (["nacc"], [([0.40, 0.40, 0.42], [0.56, 0.58, 0.55])],
             [(1.5, -4.0, 0.5)], False),
    "multimat": (["fixed_corotated", "jfluid", "sand"],
                 [([0.30, 0.50, 0.30], [0.40, 0.60, 0.40]),
                  ([0.45, 0.36, 0.45], [0.57, 0.46, 0.57]),
                  ([0.60, 0.50, 0.30], [0.70, 0.60, 0.40])],
                 [(2.0, -3.0, 1.0), (-1.0, -2.0, 0.5), (0.5, -3.0, 1.0)], False),
    "jfluid_halfspace": (["jfluid"], [([0.40, 0.28, 0.42], [0.56, 0.44, 0.55])],
                         [(1.0, -4.0, 0.5)], True),
}


@pytest.mark.parametrize("name", sorted(_SCENES))
def test_material_substeps_match_jax(name):
    """Every material, several materials in one pool, and a frictional
    half-space ramp: the same substeps in both packages, pid-matched."""
    from claymore_tpu.models.boundary import HalfSpace
    from claymore_tpu_torch.interop import collider_from_jax

    mats, boxes, v0, ramp = _SCENES[name]
    jcfg, cfg = configs(domain_bits=5, max_active_blocks=256, default_dt=2e-3,
                        rebucket_auto=True)
    pairs = [material_pair(jcfg, m) for m in mats]
    pos = [sample_uniform_box_world(cfg.dx, lo, hi, cfg.ppc) for lo, hi in boxes]
    jcols = ((HalfSpace((0.0, 0.3, 0.0), (0.25, 1.0, 0.0), kind="slip",
                        friction=0.2),) if ramp else ())
    jeng = cmt.MPMEngine(jcfg, [j for j, _ in pairs], colliders=jcols, tile_chunk=4)
    eng = ct.MPMEngine(cfg, [m for _, m in pairs], tile_chunk=4, device=CPU,
                       colliders=tuple(collider_from_jax(c) for c in jcols))
    js, s = jeng.init_state(pos, v0), eng.init_state(pos, v0)
    for _ in range(5):
        js = jeng.substep(js, jnp.float32(1.0))
        s = eng.substep(s, 1.0)
    assert eng.rebuilds >= 1

    jm, jmom = jax_pool_to_dense(jcfg, js)
    m, mom = pool_to_dense(cfg, s)
    np.testing.assert_allclose(m, jm, atol=1e-5, rtol=1e-4)
    np.testing.assert_allclose(mom, jmom, atol=1e-5, rtol=1e-4)
    for i, (jmat, _) in enumerate(pairs):
        a, b = pid_matched(s.models[i], js.models[i], "pos")
        assert np.max(np.abs(a - b)) < 1e-6, i
        for k, _ in jmat.field_specs:
            a, b = pid_matched(s.models[i], js.models[i], k)
            assert np.max(np.abs(a - b)) <= 1e-5 * max(1.0, np.max(np.abs(b))), (i, k)
    dj, dp = jeng.diagnostics(js), eng.diagnostics(s)
    for k in dj:
        if k.startswith("model") or k in ("active_octs", "block_overflow", "step"):
            assert dp[k] == dj[k], k
    expected = sum(p.shape[0] * mat.mass for p, (_, mat) in zip(pos, pairs))
    assert abs(m.sum() - expected) / expected < 1e-6
    assert dp["null_block_mass"] == 0.0
    for i, p in enumerate(pos):
        assert dp[f"model{i}_active"] == p.shape[0]
    check_partition(cfg, s.partition)
    eng.check_health(s, strict=True)
    if ramp:
        # the ramp stops the fall: no cell below the plane keeps moving into it
        assert np.min(eng.get_positions(s)[:, 1]) > 0.2


def test_run_frames_keep_invariants():
    _, cfg = configs(domain_bits=5, max_active_blocks=256, default_dt=1e-3,
                     fps=240, rebucket_auto=True)
    mat = ct.FixedCorotated(volume=cfg.default_volume())
    pos = sample_uniform_box_world(cfg.dx, [0.4, 0.5, 0.4], [0.55, 0.62, 0.55],
                                   cfg.ppc)
    eng = ct.MPMEngine(cfg, [mat], tile_chunk=4, device=CPU)
    s = eng.init_state([pos], [(0.0, -0.5, 0.0)])
    p0 = eng.get_positions(s)
    s = eng.run(s, frames=2)
    d = eng.diagnostics(s)
    # the frame loop ends exactly on the frame boundary
    assert abs(d["t"] - 2.0 / 240.0) < 1e-6
    assert d["step"] >= 2 * 4           # frame_dt / default_dt substeps
    assert d["null_block_mass"] == 0.0 and d["model0_active"] == pos.shape[0]
    expected = pos.shape[0] * mat.mass
    assert abs(d["grid_mass"] - expected) / expected < 1e-5
    p1 = eng.get_positions(s)
    assert p1.shape == p0.shape and np.all(np.isfinite(p1))
    # falling under gravity from v0 = -0.5: the cloud moved down
    assert p1[:, 1].mean() < p0[:, 1].mean()


def test_state_round_trip_through_numpy():
    from claymore_tpu_torch.interop import state_from_numpy, state_to_numpy

    _, cfg = configs(domain_bits=5, max_active_blocks=64)
    mat = ct.FixedCorotated(volume=cfg.default_volume())
    pos = sample_uniform_box_world(cfg.dx, [0.45] * 3, [0.52] * 3, cfg.ppc)
    eng = ct.MPMEngine(cfg, [mat], tile_chunk=8, device=CPU)
    s = eng.init_state([pos])
    back = state_from_numpy(state_to_numpy(s), CPU)
    flat_a = state_to_numpy(s)
    flat_b = state_to_numpy(back)
    assert flat_a._fields == cmt.SimState._fields
    assert flat_a.models[0]._fields == cmt.ParticleModel._fields
    np.testing.assert_array_equal(flat_a.grid, flat_b.grid)
    for x, y in zip(flat_a.models[0].tiles, flat_b.models[0].tiles):
        assert x.dtype == y.dtype
        np.testing.assert_array_equal(x, y)
    assert to_np(back.models[0].active).dtype == np.bool_


def test_config_from_jax_round_trip():
    jcfg = cmt.SimConfig(domain_bits=7, max_active_blocks=2048, particle_tile=512,
                         rebucket_auto=True, rebucket_safety=1.5, fps=30,
                         gravity=(0.0, -3.0, 1.0), max_tiles=96, rebucket_every=4,
                         defrag_every=2, mover_capacity_frac=0.2)
    cfg = config_from_jax(dataclasses.asdict(jcfg))
    for f in dataclasses.fields(cfg):
        assert getattr(cfg, f.name) == getattr(jcfg, f.name), f.name
    for prop in ("arena_span", "arena_lo", "grid_size", "num_oct_keys",
                 "null_oct", "null_block", "group_tiles", "d_inv", "dx"):
        assert getattr(cfg, prop) == getattr(jcfg, prop), prop
    assert cfg.tiles_for(100_000) == jcfg.tiles_for(100_000)
    assert cfg.default_volume() == jcfg.default_volume()
    assert cfg.frame_dt() == jcfg.frame_dt()


@pytest.mark.parametrize("kw", [dict(rebucket_every=4), dict(defrag_every=2)])
def test_rebucket_settings_carry_across(kw):
    """The span-4 arena and the incremental rebucket are ported: their
    settings and the mover buffer carry across from the JAX package, and an
    engine takes them."""
    jcfg = cmt.SimConfig(mover_capacity_frac=0.25, **kw)
    cfg = config_from_jax(dataclasses.asdict(jcfg))
    for name in ("rebucket_every", "defrag_every", "mover_capacity_frac",
                 "arena_span", "arena_lo"):
        assert getattr(cfg, name) == getattr(jcfg, name), name
    eng = ct.MPMEngine(cfg, [ct.FixedCorotated()], device=CPU)
    assert eng.cfg.mover_capacity_frac == 0.25


def test_import_leaves_jax_out():
    code = ("import sys, claymore_tpu_torch, claymore_tpu_torch.interop, "
            "claymore_tpu_torch.ops.g2p2g_kernel, claymore_tpu_torch.ops.grid_kernel, "
            "claymore_tpu_torch.io.scene, claymore_tpu_torch.models.boundary, "
            "claymore_tpu_torch.__main__, claymore_tpu_torch.io.checkpoint, "
            "claymore_tpu_torch.io.meshsdf, claymore_tpu_torch.utils.timers, "
            "claymore_tpu_torch.ops.probe_kernels, claymore_tpu_torch.scripts.prof_dma, "
            "claymore_tpu_torch.scripts.prof_laneops, "
            "claymore_tpu_torch.scripts.prof_stages25m, "
            "claymore_tpu_torch.scripts.prof_k1, claymore_tpu_torch.scripts.prof_k2, "
            "claymore_tpu_torch.scripts.prof_rebuild, claymore_tpu_torch.io.sampler, "
            "claymore_tpu_torch.scripts.ab_paths, "
            "claymore_tpu_torch.io.sdf;"
            "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'claymore_tpu')];"
            "print(bad); sys.exit(1 if bad else 0)")
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr
