"""The port's multi-device engine against the JAX package's on the CPU.

The JAX ``MultiChipEngine`` runs on the conftest's 8 virtual CPU devices
(its XLA path, exact float32); the port's runs every shard on ``cpu``
through ``LocalGroup`` with the plain versions of its kernels.  Each JAX
run is made once per module: a sharded compile costs 10-20 s here.

Particle ids differ by design: the JAX package numbers each shard's
particles from 0 (``claymore_tpu/core/engine.py:149``), the port gives
each particle its index in the input positions, so JAX pids are compared
through the shard's input-index map.
"""

import dataclasses
import functools
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import claymore_tpu as cmt
import claymore_tpu_torch as ct
from claymore_tpu.core import partition as jpart
from claymore_tpu.io.scene import load_scene as jax_load_scene
from claymore_tpu.parallel.multi import MultiChipEngine as JaxMultiChipEngine
from claymore_tpu_torch.core import partition
from claymore_tpu_torch.interop import (shards_from_numpy, shards_to_numpy, split_shards,
                                        stack_shards)
from claymore_tpu_torch.io.sampler import sample_uniform_box_world
from claymore_tpu_torch.io.scene import load_scene
from claymore_tpu_torch.ops import g2p2g_kernel
from claymore_tpu_torch.parallel import MultiChipEngine
from claymore_tpu_torch.utils.debug import pool_to_dense

from tests.test_torch_partition import _raw_models
from tests.torch_port_helpers import CPU, configs, fixed_corotated_pair, to_np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MESHES = [(2,), (2, 2), (1, 2), (1,), (4, 2)]
STEPS = 4


def _scene():
    """tests/test_multichip.py's make_scene in both packages' configs."""
    jcfg, cfg = configs(domain_bits=5, max_active_blocks=256, default_dt=5e-4)
    jmat, mat = fixed_corotated_pair(jcfg)
    pos = sample_uniform_box_world(cfg.dx, [0.35] * 3, [0.65] * 3, cfg.ppc)
    return jcfg, cfg, jmat, mat, pos, [(0.4, -0.2, 0.1)]


@functools.lru_cache(maxsize=None)
def _run(mesh):
    """(JAX states, port states, port engine, positions) after init and
    after ``STEPS`` substeps on ``mesh``."""
    jcfg, cfg, jmat, mat, pos, v0 = _scene()
    jeng = JaxMultiChipEngine(jcfg, [jmat], mesh_shape=mesh, tile_chunk=4,
                              migration_capacity=256)
    eng = MultiChipEngine(cfg, [mat], mesh_shape=mesh, tile_chunk=4,
                          migration_capacity=256, device=CPU)
    js, s = jeng.init_state([pos], v0), eng.init_state([pos], v0)
    jstates, states = [js], [s]
    for _ in range(STEPS):
        js = jeng.substep(js, jnp.float32(1.0))
        s = eng.substep(s, 1.0)
    jstates.append(js)
    states.append(s)
    return jeng, [jax.tree.map(np.asarray, x) for x in jstates], eng, states, pos


def _owned_dense(eng, states):
    """Dense (m, mom) of every shard's owned blocks, summed over shards."""
    cfg = eng.cfg
    m = mom = 0.0
    for j, s in enumerate(states):
        rows = eng.owned_rows(states, j)
        grid = torch.cat([rows, torch.zeros_like(s.grid[rows.shape[0]:])])
        a, b = pool_to_dense(cfg, dataclasses.replace(s, grid=grid))
        m, mom = m + a, mom + b
    return m, mom


@pytest.mark.parametrize("mesh", MESHES, ids=lambda m: "x".join(map(str, m)))
def test_multi_matches_jax(mesh):
    jeng, jstates, eng, states, pos = _run(mesh)
    nd = eng.n_dev
    shard = eng.shard_of(pos)
    for js, s in zip(jstates, states):
        jm = js.models[0]
        jact = jm.active.reshape(nd, -1)
        jpid = jm.pid.reshape(nd, -1)
        jpos = jm.pos.reshape(3, nd, -1)
        for j in range(nd):
            m = s[j].models[0]
            act = to_np(m.active)
            np.testing.assert_array_equal(act, jact[j])
            ids = np.flatnonzero(shard == j)
            np.testing.assert_array_equal(to_np(m.pid)[act], ids[jpid[j][act]])
            err = np.abs(to_np(m.pos)[:, act] - jpos[:, j][:, act])
            assert err.max(initial=0.0) < 2e-6
            np.testing.assert_array_equal(to_np(s[j].partition.keys),
                                          js.partition.keys.reshape(nd, -1)[j])
        assert abs(float(s[0].dt) - float(js.dt)) < 1e-10
        # the grid, each block counted on its owner (tests/test_pallas.py bounds)
        jshards = shards_from_numpy(js, [CPU] * nd)
        m, mom = _owned_dense(eng, s)
        jm_, jmom = _owned_dense(eng, jshards)
        np.testing.assert_allclose(m, jm_, atol=1e-5, rtol=1e-4)
        np.testing.assert_allclose(mom, jmom, atol=1e-5, rtol=1e-4)
        d, jd = eng.diagnostics(s), jeng.diagnostics(jax.tree.map(jnp.asarray, js))
        for k in ("active_blocks", "migration_dropped", "halo_overflow", "model0_active",
                  "model0_dropped_tiles"):
            assert d[k] == jd[k], k
        np.testing.assert_array_equal(
            np.concatenate([to_np(x.partition.overflow) for x in s]), js.partition.overflow)
        np.testing.assert_allclose(d["grid_mass"], jd["grid_mass"], rtol=1e-6)
    assert d["model0_active"] == pos.shape[0]
    assert d["null_block_mass"] == 0.0


def test_empty_shards_stay_empty_and_match_jax():
    """The 4x2 mesh of config 5 on ``_scene()``'s box, x in [0.35, 0.65]:
    the outer x slabs (shards 0, 1, 6, 7) start and stay without a
    particle, as config 5's do, in both packages; they lose nothing, count
    no overflow, and hold the same partition as the JAX package's (the
    halo blocks their neighbours send mass into)."""
    jeng, jstates, eng, states, pos = _run((4, 2))
    nd = eng.n_dev
    empty = [j for j in range(nd) if eng.comm.shards[j] // 2 in (0, 3)]
    assert empty == [0, 1, 6, 7]
    assert not np.isin(eng.shard_of(pos), empty).any()
    for js, s in zip(jstates, states):
        jact = js.models[0].active.reshape(nd, -1)
        for j in empty:
            m = s[j].models[0]
            assert int(m.active.sum()) == 0 and not jact[j].any()
            assert not bool(m.tiles.tvalid.any())
            for x in (m.tiles.dropped, s[j].mig_dropped, s[j].halo_overflow,
                      s[j].partition.overflow):
                assert int(x.sum()) == 0
            assert int(s[j].partition.count[0]) == int(js.partition.count.reshape(nd)[j])
        assert sum(int(x.models[0].active.sum()) for x in s) == pos.shape[0]
    # the substeps reached the empty shards: their partitions hold halo
    # blocks of the occupied neighbours
    assert all(int(states[-1][j].partition.count[0]) > 0 for j in empty)


def _by_pid(states, n):
    """Positions [3, n] of every shard's active particles, column = pid."""
    out = np.full((3, n), np.nan, np.float32)
    for st in states:
        m = st.models[0]
        act = to_np(m.active)
        out[:, to_np(m.pid)[act]] = to_np(m.pos)[:, act]
    return out


def test_mesh_of_one_is_trivial_and_matches_mpm_engine():
    """A mesh of one shard runs MPMEngine's pipeline: the same grid bit for
    bit and the same particles by pid (its tiles are sized with the
    engine's ``particle_capacity_factor``, so its slot layout differs)."""
    _, _, eng, states, pos = _run((1,))
    assert eng.comm.trivial and not eng.comm.overlap and eng.comm._directions() == []
    jcfg, cfg, jmat, mat, pos, v0 = _scene()
    single = ct.MPMEngine(cfg, [mat], tile_chunk=4, device=CPU)
    s = single.run_steps(single.init_state([pos], v0), STEPS, 1.0)
    assert torch.equal(s.grid, states[-1][0].grid)
    np.testing.assert_array_equal(_by_pid((s,), pos.shape[0]),
                                  _by_pid(states[-1], pos.shape[0]))


@pytest.mark.parametrize("mesh,live,dirs", [
    ((1,), (), 0), ((1, 2), (1,), 2), ((2,), (0,), 2), ((2, 2), (0, 1), 8)])
def test_live_axes_and_directions(mesh, live, dirs):
    """Axes of extent 1 carry no neighbours: skipped, as in the JAX package."""
    jcfg, cfg, jmat, mat, _, _ = _scene()
    eng = MultiChipEngine(cfg, [mat], mesh_shape=mesh, tile_chunk=4, device=CPU)
    jeng = JaxMultiChipEngine(jcfg, [jmat], mesh_shape=mesh, tile_chunk=4)
    assert eng.comm.live_axes == live == jeng.comm.live_axes
    assert eng.comm.trivial == (not live) == jeng.comm.trivial
    assert eng.comm._directions() == jeng.comm._directions()
    assert len(eng.comm._directions()) == dirs
    assert eng.comm.halo_capacity == jeng.comm.halo_capacity
    assert eng.comm.boundary_tile_cap(96, 8) == jeng.comm.boundary_tile_cap(96, 8)
    if mesh == (1, 2):
        assert all(d[0] == 0 for d in eng.comm._directions())


def test_halo_margin_must_cover_arena_reach():
    """rebucket_every=4 widens the arena to 4^3 (reach 2 blocks): a margin of
    1 would leak boundary mass, so the engine refuses it."""
    _, cfg = configs(domain_bits=5, max_active_blocks=128, rebucket_every=4)
    mat = ct.FixedCorotated(volume=cfg.default_volume(), e=1e4, nu=0.3)
    with pytest.raises(ValueError, match="halo_margin"):
        MultiChipEngine(cfg, [mat], n_devices=2, tile_chunk=4, halo_margin=1, device=CPU)
    assert MultiChipEngine(cfg, [mat], n_devices=2, tile_chunk=4, device=CPU).comm.margin == 2


def test_devices_are_checked():
    """A device list shorter or longer than the mesh, or a CUDA device
    without a card, raise."""
    _, cfg, _, mat, _, _ = _scene()
    for devices in ([CPU, CPU], [CPU] * 5):
        with pytest.raises(ValueError, match="needs 4 devices"):
            MultiChipEngine(cfg, [mat], mesh_shape=(2, 2), device=devices)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            MultiChipEngine(cfg, [mat], n_devices=2, device="cuda")


def test_load_scene_refuses_a_device_list_of_the_wrong_length(tmp_path):
    """``load_scene`` takes one device per shard: a list of another length
    raises for the 2x2 scene and for a one-device scene alike."""
    import json

    with pytest.raises(ValueError, match="needs 4 devices"):
        load_scene(os.path.join(REPO, "scenes", "cube_4dev.json"), device=[CPU] * 3)
    doc = {"grid": {"domain_bits": 5, "max_active_blocks": 128},
           "models": [{"constitutive": "jfluid", "shape": {"type": "box"},
                       "offset": [0.4, 0.4, 0.4], "span": [0.1, 0.1, 0.1]}]}
    path = tmp_path / "scene.json"
    path.write_text(json.dumps(doc))
    with pytest.raises(ValueError, match="takes one device, got 2"):
        load_scene(str(path), device=[CPU, CPU])


def test_halo_overflow_is_counted_like_jax():
    """halo_capacity=1 on a cloud across the slab face: overflow counted,
    the same count as the JAX package's."""
    jcfg, cfg = configs(domain_bits=5, max_active_blocks=128)
    jmat, mat = fixed_corotated_pair(jcfg)
    pos = sample_uniform_box_world(cfg.dx, [0.3] * 3, [0.7] * 3, cfg.ppc)
    jeng = JaxMultiChipEngine(jcfg, [jmat], n_devices=2, tile_chunk=4, halo_capacity=1)
    eng = MultiChipEngine(cfg, [mat], n_devices=2, tile_chunk=4, halo_capacity=1, device=CPU)
    js, s = jeng.init_state([pos], [(0.0, -0.2, 0.0)]), eng.init_state([pos], [(0.0, -0.2, 0.0)])
    for _ in range(2):
        js, s = jeng.substep(js, jnp.float32(1.0)), eng.substep(s, 1.0)
    d = eng.diagnostics(s)
    assert d["halo_overflow"] > 0
    assert d["halo_overflow"] == jeng.diagnostics(js)["halo_overflow"]
    np.testing.assert_array_equal(np.concatenate([to_np(x.halo_overflow) for x in s]),
                                  np.asarray(js.halo_overflow))
    with pytest.warns(RuntimeWarning, match="halo octs beyond halo_capacity"):
        eng.check_health(s, strict=False)


def test_check_health_reports_migration_and_halo_losses():
    """MPMEngine.check_health and MultiChipEngine.check_health share the
    JAX package's messages for the two multi-device counters."""
    _, cfg, _, mat, pos, v0 = _scene()
    single = ct.MPMEngine(cfg, [mat], tile_chunk=4, device=CPU)
    s = single.init_state([pos], v0)
    single.check_health(s)
    bad = dataclasses.replace(s, mig_dropped=torch.tensor([3], dtype=torch.int32),
                              halo_overflow=torch.tensor([2], dtype=torch.int32))
    with pytest.raises(RuntimeError, match="3 particles lost to migration capacity; "
                                           "2 halo octs beyond halo_capacity"):
        single.check_health(bad)
    eng = MultiChipEngine(cfg, [mat], n_devices=2, tile_chunk=4, device=CPU)
    with pytest.raises(RuntimeError, match="6 particles lost to migration capacity"):
        eng.check_health((bad, bad))


@pytest.mark.parametrize("shard", [0, 1])
def test_sort_permute_region_matches_jax(shard):
    """Boundary tiles first (``region_fn``): the same slots, keys and tiles
    as the JAX package, bit for bit."""
    jcfg, cfg, jm, m, nt = _raw_models()
    jeng = JaxMultiChipEngine(jcfg, [cmt.FixedCorotated(volume=1e-6)], n_devices=2,
                              tile_chunk=4)
    eng = MultiChipEngine(cfg, [ct.FixedCorotated(volume=1e-6)], n_devices=2,
                          tile_chunk=4, device=CPU)

    def jregion(keys):
        # HaloComm.is_boundary_key reads the shard from the mesh axis index
        return jax.shard_map(lambda k: jeng.comm.is_boundary_key(k),
                             mesh=jeng.mesh, in_specs=jax.sharding.PartitionSpec(),
                             out_specs=jax.sharding.PartitionSpec("x"),
                             check_vma=False)(keys).reshape(2, -1)[shard]

    jpm, jtk, jdr = jpart.sort_permute(jcfg, jm, nt, region_fn=jregion)
    pm, tk, dr = partition.sort_permute(
        cfg, m, nt, region_fn=lambda k: eng.comm.is_boundary_key(k, shard))
    keys = np.asarray(jtk)
    n3 = cfg.grid_size ** 3
    region = to_np(eng.comm.is_boundary_key(torch.from_numpy(np.minimum(keys, n3 - 1)), shard))
    valid = keys < n3
    # the boundary tiles form a prefix of the valid tiles; on shard 1 both
    # kinds occur (shard 0's particles all lie within a window's reach)
    kinds = (valid & region).any(), (valid & ~region).any()
    assert kinds == ((True, False) if shard == 0 else (True, True))
    first_interior = np.flatnonzero(valid & ~region)[:1]
    assert not (valid & region)[first_interior[0] if shard else len(keys):].any()
    np.testing.assert_array_equal(to_np(tk), keys)
    np.testing.assert_array_equal(to_np(dr), np.asarray(jdr))
    for a, b in ((pm.pos, jpm.pos), (pm.active, jpm.active), (pm.pid, jpm.pid),
                 (pm.fields["F"], jpm.fields["F"])):
        np.testing.assert_array_equal(to_np(a), np.asarray(b))


def test_rebuild_extra_mask_matches_jax():
    """``rebuild``'s extra_mask (the halo mass mask) activates the same octs
    as the JAX package's."""
    jcfg, cfg, jm, m, nt = _raw_models()
    jpm, jtk, jdr = jpart.sort_permute(jcfg, jm, nt)
    pm, tk, dr = partition.sort_permute(cfg, m, nt)
    n3 = cfg.grid_size ** 3
    rng = np.random.default_rng(3)
    extra = rng.uniform(size=n3) < 0.02
    from claymore_tpu.core import engine as jengine
    from claymore_tpu_torch.core import engine

    pool = np.zeros((cfg.max_active_octs + 1, 16, 128), np.float32)
    jp, jpool = jpart.rebuild(jcfg, jnp.asarray(pool), jengine.empty_partition(jcfg), (jtk,),
                              extra_mask=jnp.asarray(extra))
    p, ppool = partition.rebuild(cfg, torch.from_numpy(pool), engine.empty_partition(cfg, CPU),
                                 (tk,), extra_mask=torch.from_numpy(extra))
    p0, _ = partition.rebuild(cfg, torch.from_numpy(pool), engine.empty_partition(cfg, CPU),
                              (tk,))
    assert int(p.count[0]) > int(p0.count[0])
    for a, b in ((p.table, jp.table), (p.keys, jp.keys), (p.count, jp.count),
                 (p.overflow, jp.overflow)):
        np.testing.assert_array_equal(to_np(a), np.asarray(b))


def test_g2p2g_tile_range_matches_whole_call():
    """K1's plain version on [0, bt) then [bt, T) into one output equals the
    whole-range call bit for bit, and its margin is the minimum of the two;
    an empty range launches nothing and returns +inf."""
    _, _, eng, states, _ = _run((2,))
    cfg, mat = eng.cfg, eng.materials[0]
    s = states[-1][0]
    from claymore_tpu_torch.ops import grid_kernel

    pool_v, _ = grid_kernel.grid_update(cfg, s.grid, s.partition, s.dt)
    model = s.models[0]
    nt = model.tiles.tvalid.shape[0]
    args = (cfg, mat, pool_v, s.partition.table, model, s.dt, s.dt)
    whole, pw, mw = g2p2g_kernel.g2p2g(*args, torch.zeros_like(s.grid), 4)
    bt = 8 * (nt // 16)
    acc = torch.zeros_like(s.grid)
    a, acc, ma = g2p2g_kernel.g2p2g(*args, acc, 4, (0, bt))
    b, acc, mb = g2p2g_kernel.g2p2g(*args, acc, 4, (bt, nt), a)
    assert b.pos is a.pos
    for x, y in ((b.pos, whole.pos), (b.active, whole.active), (b.pid, whole.pid),
                 (b.fields["F"], whole.fields["F"]), (acc, pw)):
        assert torch.equal(x, y)
    assert float(torch.minimum(ma, mb)) == float(mw)
    c, _, mc = g2p2g_kernel.g2p2g(*args, acc, 4, (nt, nt), b)
    assert c.pos is b.pos and float(mc) == float("inf")
    with pytest.raises(ValueError, match="whole chunks"):
        g2p2g_kernel.g2p2g(*args, acc, 4, (1, nt))


def test_interop_round_trips():
    """The port's shard tuple <-> the JAX package's stacked state: the
    JAX state of a (2, 2) run comes back bit for bit, and so do the port's
    shards."""
    _, jstates, eng, states, _ = _run((2, 2))
    js = jstates[-1]
    shards = shards_from_numpy(js, [CPU] * 4)
    back = shards_to_numpy(shards)
    for a, b in zip(jax.tree.leaves(js), jax.tree.leaves(back)):
        np.testing.assert_array_equal(np.asarray(a), b)
    again = split_shards(stack_shards(states[-1]), [CPU] * 4)
    for a, b in zip(states[-1], again):
        for x, y in zip(jax.tree.leaves(shards_to_numpy((a,))),
                        jax.tree.leaves(shards_to_numpy((b,)))):
            np.testing.assert_array_equal(x, y)
    # the port's shards and the JAX state agree where no float sums differ
    np.testing.assert_array_equal(np.concatenate([to_np(s.partition.table) for s in shards]),
                                  js.partition.table)


def test_load_scene_cube_4dev():
    """The package's own multi-device scene: a (2, 2) mesh, every shard on
    the CPU, holding the same particles per shard as the JAX package."""
    path = os.path.join(REPO, "scenes", "cube_4dev.json")
    sc = load_scene(path, device=CPU, tile_chunk=4)
    assert isinstance(sc.engine, MultiChipEngine)
    assert sc.engine.mesh_shape == (2, 2) and sc.engine.comm.mig_cap == 512
    assert len(sc.state) == 4
    jsc = jax_load_scene(path, tile_chunk=4)
    jact = np.asarray(jsc.state.models[0].active).reshape(4, -1)
    jpos = np.asarray(jsc.state.models[0].pos).reshape(3, 4, -1)
    for j, s in enumerate(sc.state):
        act = to_np(s.models[0].active)
        np.testing.assert_array_equal(act, jact[j])
        np.testing.assert_array_equal(to_np(s.models[0].pos)[:, act], jpos[:, j][:, act])
    d = sc.engine.diagnostics(sc.state)
    assert d["model0_active"] == sc.positions[0].shape[0]


def test_multi_pids_pair_with_mpm_engine():
    """Pids are input indices, the ids MPMEngine gives the same input, so a
    (2, 2) run pairs with a single-device one by pid."""
    _, _, eng, states, pos = _run((2, 2))
    jcfg, cfg, jmat, mat, pos, v0 = _scene()
    single = ct.MPMEngine(cfg, [mat], tile_chunk=4, device=CPU)
    s = single.run_steps(single.init_state([pos], v0), STEPS, 1.0)
    assert np.abs(_by_pid(states[-1], pos.shape[0]) - _by_pid((s,), pos.shape[0])).max() < 2e-6


def test_cli_runs_a_multi_device_scene_and_resumes(tmp_path):
    """The CLI on a small (2,) scene: frames, a checkpoint per frame in the
    JAX stacked layout, and a resume that lands on the full run's second
    checkpoint (the plain versions on one thread are deterministic)."""
    import json

    doc = {"simulation": {"default_dt": 5e-4, "fps": 480, "frames": 2},
           "grid": {"domain_bits": 5, "max_active_blocks": 128},
           "device": {"n_devices": 2, "migration_capacity": 256},
           "models": [{"constitutive": "fixed_corotated", "shape": {"type": "box"},
                       "offset": [0.4, 0.45, 0.4], "span": [0.2, 0.1, 0.1],
                       "velocity": [1.0, 0.0, 0.0]}]}
    path = tmp_path / "scene.json"
    path.write_text(json.dumps(doc))
    env = dict(os.environ, PYTHONPATH=REPO, CUDA_VISIBLE_DEVICES="", OMP_NUM_THREADS="1")

    def cli(*args):
        proc = subprocess.run([sys.executable, "-m", "claymore_tpu_torch", "-f", str(path),
                               "--device", "cpu,cpu", "--tile-chunk", "4", *args],
                              capture_output=True, text=True, timeout=300,
                              cwd=str(tmp_path), env=env)
        assert proc.returncode == 0, proc.stdout + proc.stderr
        return proc.stdout

    out = cli("-o", str(tmp_path / "full"), "--checkpoint-every", "1")
    assert "frame 2/2" in out
    cli("-o", str(tmp_path / "part"), "--frames", "1", "--no-output",
        "--resume", str(tmp_path / "full" / "ckpt_0000.npz"), "--checkpoint-every", "1")
    a = np.load(tmp_path / "full" / "ckpt_0001.npz")
    b = np.load(tmp_path / "part" / "ckpt_0000.npz")
    assert a["leaf_0"].shape[0] == 2 * 129          # two shards' pools, stacked
    for k in a.files:
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    sc = load_scene(str(path), device=CPU, tile_chunk=4)
    from claymore_tpu_torch.io import bgeo

    p, _ = bgeo.read_bgeo(str(tmp_path / "full" / "model0_frame0001.bgeo"))
    assert p.shape == sc.positions[0].shape


def test_prof_multichip_runs_on_the_cpu(capsys):
    """The profiling entry point at its CPU size: one JSON line with both
    engines' ms/substep and the exchanged bytes; a mesh of one exchanges
    nothing, a 2x2 mesh's static halo outweighs its trimmed one."""
    import json

    from claymore_tpu_torch.scripts import prof_multichip

    assert prof_multichip.main(["--device", "cpu", "--quick", "--steps", "1",
                                "--reps", "1"]) == 0
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert out["device"] == "cpu" and out["mesh1_ms_per_step"] > 0
    assert out["mesh1_bytes"] == {"halo": 0, "halo_trimmed": 0, "migration": 0}
    b = out["2x2_bytes"]
    # 4 shards, each 2 faces (one hop) and a corner (two hops)
    assert b["halo"] == 4 * 4 * out["2x2_halo_capacity"] * (8 + 16 * 128 * 4)
    assert 0 < b["halo_trimmed"] < b["halo"] and b["migration"] > 0


def test_multi_device_checkpoints_cross_packages(tmp_path):
    """A JAX (2, 2) state saved by the JAX package loads into the port's
    shards bit for bit, and the port's save reads back in the JAX package."""
    from claymore_tpu.io import checkpoint as jckpt
    from claymore_tpu_torch.io import checkpoint

    jeng, jstates, eng, states, _ = _run((2, 2))
    js = jax.tree.map(jnp.asarray, jstates[-1])
    jckpt.save_state(str(tmp_path / "jax.npz"), js)
    loaded = checkpoint.load_state(str(tmp_path / "jax.npz"), states[-1])
    for a, b in zip(jax.tree.leaves(shards_to_numpy(loaded)), jax.tree.leaves(jstates[-1])):
        np.testing.assert_array_equal(a, np.asarray(b))
    checkpoint.save_state(str(tmp_path / "port.npz"), states[-1])
    back = jckpt.load_state(str(tmp_path / "port.npz"), js)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(shards_to_numpy(states[-1]))):
        np.testing.assert_array_equal(np.asarray(a), b)
