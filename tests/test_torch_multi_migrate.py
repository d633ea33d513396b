"""Particle migration of the port's multi-device engine against the JAX
package's on the CPU (2 shards along x, every port shard on ``cpu``).

Two faults of the JAX package show here, both closed in the port:

* pids: the JAX package numbers each shard's particles from 0, so after a
  migration two particles in one shard share an id; the port's ids are the
  input indices, unique across shards;
* arrivals in a shard that does not rebuild (``rebucket_auto``): the JAX
  package places them in free slots of other blocks' tiles, and the next
  transfer drops them; the port makes such a shard rebuild.
"""

import functools

import numpy as np

from claymore_tpu.parallel.multi import MultiChipEngine as JaxMultiChipEngine
from claymore_tpu_torch.io.sampler import sample_uniform_box_world
from claymore_tpu_torch.parallel import MultiChipEngine

from tests.torch_port_helpers import CPU, configs, fixed_corotated_pair, to_np


def _engines(lo_hi, v0, steps, **kw):
    """(JAX final state, port final state, port initial state, positions)
    of a FixedCorotated box ``lo_hi`` launched at ``v0`` without gravity
    for ``steps`` substeps on 2 x-slabs."""
    jcfg, cfg = configs(domain_bits=5, max_active_blocks=256, default_dt=5e-4,
                        gravity=(0.0, 0.0, 0.0), **kw)
    jmat, mat = fixed_corotated_pair(jcfg, e=1e3)
    pos = np.concatenate([sample_uniform_box_world(cfg.dx, lo, hi, cfg.ppc)
                          for lo, hi in lo_hi])
    jeng = JaxMultiChipEngine(jcfg, [jmat], n_devices=2, tile_chunk=4,
                              migration_capacity=4096)
    eng = MultiChipEngine(cfg, [mat], n_devices=2, tile_chunk=4, migration_capacity=4096,
                          device=CPU)
    js = jeng.run_steps(jeng.init_state([pos], [v0]), steps, 1.0)
    s0 = eng.init_state([pos], [v0])
    s = eng.run_steps(s0, steps, 1.0)
    return jeng, js, eng, s, s0, pos


@functools.lru_cache(maxsize=None)
def _crossing():
    """tests/test_multichip.py::test_migration_across_boundary's scene: a
    box that starts in shard 0 and flies +x into shard 1."""
    return _engines([([0.40, 0.45, 0.45], [0.48, 0.55, 0.55])], (4.0, 0.0, 0.0), 55)


def test_migration_matches_jax():
    jeng, js, eng, s, s0, pos = _crossing()
    n = pos.shape[0]
    assert [int(x.models[0].active.sum()) for x in s0] == [n, 0]
    jact = np.asarray(js.models[0].active).reshape(2, -1)
    counts = [int(x.models[0].active.sum()) for x in s]
    assert counts == jact.sum(axis=1).tolist()
    assert counts[1] > 0 and sum(counts) == n
    for j, x in enumerate(s):
        np.testing.assert_array_equal(to_np(x.models[0].active), jact[j])
    d, jd = eng.diagnostics(s), jeng.diagnostics(js)
    assert d["migration_dropped"] == jd["migration_dropped"] == 0
    assert abs(d["grid_mass"] - n * eng.materials[0].mass) < 1e-3 * n * eng.materials[0].mass
    assert eng.get_positions(s)[:, 0].mean() > 0.47


def _ids(states):
    return np.concatenate([to_np(x.models[0].pid)[to_np(x.models[0].active)]
                           for x in states])


def test_port_pids_are_unique_where_jax_pids_repeat():
    """A box across the slab face, flying +x: shard 0's particles migrate
    into shard 1, which holds particles numbered from 0 too in the JAX
    package.  The port's ids are the input indices: unique, and those
    MPMEngine gives the same positions (each id's position at init is its
    input position)."""
    jeng, js, eng, s, s0, pos = _engines([([0.50, 0.45, 0.45], [0.60, 0.55, 0.55])],
                                         (4.0, 0.0, 0.0), 30)
    assert [int(x.models[0].active.sum()) > 0 for x in s0] == [True, True]
    jact = np.asarray(js.models[0].active).reshape(2, -1)
    jpid = np.asarray(js.models[0].pid).reshape(2, -1)
    assert jact[0].sum() < int(s0[0].models[0].active.sum())        # some migrated
    repeats = jact[1].sum() - len(np.unique(jpid[1][jact[1]]))
    assert repeats > 0
    ids = _ids(s)
    assert len(ids) == pos.shape[0] == len(np.unique(ids))
    for x in s0:
        m = x.models[0]
        act = to_np(m.active)
        np.testing.assert_array_equal(to_np(m.pos)[:, act].T, pos[to_np(m.pid)[act]])


def test_arrivals_in_a_shard_that_does_not_rebuild_are_kept():
    """Drift-triggered rebuilds: the shards decide apart, so migrants reach
    shard 1 on substeps where it would not rebuild.  The JAX package loses
    them (no migration counter moves); the port rebuilds the receiving
    shard and keeps every particle."""
    boxes = [([0.40, 0.45, 0.45], [0.48, 0.55, 0.55]),
             ([0.56, 0.20, 0.45], [0.62, 0.30, 0.55])]
    jeng, js, eng, s, s0, pos = _engines(boxes, (8.0, 0.0, 0.0), 30, rebucket_auto=True)
    n = pos.shape[0]
    jd, d = jeng.diagnostics(js), eng.diagnostics(s)
    assert jd["migration_dropped"] == 0 and jd["model0_active"] < n
    assert d["migration_dropped"] == 0 and d["model0_active"] == n
    assert [int(x.models[0].active.sum()) for x in s][1] > int(s0[1].models[0].active.sum())
    assert len(np.unique(_ids(s))) == n
    assert eng.rebuilds > 0
