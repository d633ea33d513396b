"""Config 5 (``scenes/sphere_100m_8dev.json``: the reference's 100M-particle
sphere on a 1024^3 grid, a 4x2 mesh) on the CPU, at a size the CPU runs.

* ``load_scene`` of a copy of the scene file with only the sphere's span
  shrunk, in both packages: the same configuration, mesh, capacities, tile
  counts, and particles (positions and ids) per shard.  The port builds
  its whole state; the JAX package runs its loader and the host half of
  ``MultiChipEngine.init_state`` (the shard assignment, the tile counts,
  the stacked positions), and its sharded device init is replaced by the
  identity: at ``max_active_blocks`` 65536 that init holds eight 537 MB
  pools and their halo buffers on the 8 virtual devices at once.
* ``prof_multichip --config5shard --quick``: one shard of config 5 on the
  CPU, the grid at domain_bits 10 and the sphere's radius shrunk.
"""

import dataclasses
import json
import os

import numpy as np

import claymore_tpu.parallel.multi as jmulti
from claymore_tpu.io.scene import load_scene as jax_load_scene
from claymore_tpu_torch.interop import config_from_jax
from claymore_tpu_torch.io.scene import load_scene

from tests.torch_port_helpers import CPU, to_np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCENE = os.path.join(REPO, "scenes", "sphere_100m_8dev.json")


def _shrunk_copy(tmp_path, span: float) -> str:
    """The scene file with the sphere's span cut to ``span`` about its centre."""
    with open(SCENE) as f:
        doc = json.load(f)
    m = doc["models"][0]
    centre = [o + s / 2 for o, s in zip(m["offset"], m["span"])]
    m["offset"] = [c - span / 2 for c in centre]
    m["span"] = [span] * 3
    path = tmp_path / "sphere_8dev_small.json"
    path.write_text(json.dumps(doc))
    return str(path)


def test_config5_scene_loads_as_in_jax(tmp_path, monkeypatch):
    path = _shrunk_copy(tmp_path, 0.03)
    sc = load_scene(path, device=CPU, tile_chunk=4)

    real_shared = jmulti._shared

    def host_only(key, build):
        if key[0] == "init":
            return lambda pos, act: (pos, act)
        return real_shared(key, build)

    monkeypatch.setattr(jmulti, "_shared", host_only)
    jsc = jax_load_scene(path, tile_chunk=4)
    eng, jeng = sc.engine, jsc.engine

    assert sc.cfg == config_from_jax(dataclasses.asdict(jsc.cfg))
    assert (sc.cfg.domain_bits, sc.cfg.max_active_blocks) == (10, 65536)
    assert eng.mesh_shape == tuple(jeng.mesh_shape) == (4, 2)
    for a in ("axes", "margin", "mig_cap", "halo_capacity", "live_axes", "overlap"):
        assert getattr(eng.comm, a) == getattr(jeng.comm, a), a
    assert (eng.comm.mig_cap, eng.comm.halo_capacity) == (262144, 8192)
    assert eng._num_tiles == jeng._num_tiles
    s_cap = eng._num_tiles[0] * sc.cfg.particle_tile
    assert jeng._pcaps == [s_cap]
    np.testing.assert_array_equal(sc.positions[0], jsc.positions[0])

    raw = sc.positions[0]
    jpos = np.asarray(jsc.state[0][0]).reshape(3, 8, s_cap)
    jact = np.asarray(jsc.state[1][0]).reshape(8, s_cap)
    shard = eng.shard_of(raw)
    counts = []
    for j, st in enumerate(sc.state):
        m = st.models[0]
        act = to_np(m.active)
        pid = to_np(m.pid)[act]
        order = np.argsort(pid)
        # the port's ids are input indices; the JAX package keeps each
        # shard's particles in input order, numbered from 0
        np.testing.assert_array_equal(pid[order], np.flatnonzero(shard == j))
        assert jact[j].sum() == act.sum()
        np.testing.assert_array_equal(to_np(m.pos)[:, act][:, order], jpos[:, j][:, jact[j]])
        np.testing.assert_array_equal(to_np(m.pos)[:, act], raw[pid].T)
        counts.append(int(act.sum()))
    # config 5's outer x slabs start empty, and every particle is on a shard
    assert counts[0] == counts[1] == counts[6] == counts[7] == 0
    assert sum(counts) == raw.shape[0] > 0
    d = eng.diagnostics(sc.state)
    assert d["model0_active"] == raw.shape[0] and d["halo_overflow"] == 0


def test_prof_multichip_config5shard_quick(capsys):
    """The config-5 shard mode on the CPU: the JAX script's keys, every
    particle kept."""
    from claymore_tpu_torch.scripts import prof_multichip

    assert prof_multichip.main(["--device", "cpu", "--quick", "--config5shard",
                                "--steps", "1", "--reps", "1"]) == 0
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    cfg, _, pos, _ = prof_multichip.config5_shard(prof_multichip.C5_QUICK_RADIUS)
    assert cfg.domain_bits == 10 and cfg.max_active_blocks == 40960
    assert out["config5_shard_particles"] == pos.shape[0] > 10000
    assert out["config5_shard_ms_per_step"] > 0
    assert out["config5_shard_dropped"] == 0


def test_load_scene_takes_positions_sampled_before(tmp_path):
    """``positions=`` skips the sampling: the same state as a load that
    samples, on one device and on a mesh of the same models; a list of the
    wrong length raises."""
    import pytest
    import torch

    doc = {"grid": {"domain_bits": 5, "max_active_blocks": 256},
           "models": [{"constitutive": "fixed_corotated", "shape": {"type": "sphere"},
                       "offset": [0.35, 0.4, 0.35], "span": [0.3, 0.3, 0.3]}]}
    one = tmp_path / "one.json"
    one.write_text(json.dumps(doc))
    doc["device"] = {"mesh_shape": [4, 2], "migration_capacity": 256}
    mesh = tmp_path / "mesh.json"
    mesh.write_text(json.dumps(doc))
    a = load_scene(str(one), device=CPU, tile_chunk=4)
    b = load_scene(str(one), device=CPU, tile_chunk=4, positions=a.positions)
    c = load_scene(str(mesh), device=CPU, tile_chunk=4, positions=a.positions)
    assert b.positions[0] is a.positions[0] and c.positions[0] is a.positions[0]
    assert torch.equal(a.state.models[0].pos, b.state.models[0].pos)
    assert torch.equal(a.state.grid, b.state.grid)
    assert c.engine.diagnostics(c.state)["model0_active"] == a.positions[0].shape[0]
    with pytest.raises(ValueError, match="1 position arrays for 2 models"):
        doc["models"] *= 2
        two = tmp_path / "two.json"
        two.write_text(json.dumps(doc))
        load_scene(str(two), device=CPU, positions=a.positions)
