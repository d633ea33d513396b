"""The port's benchmark entry point (``claymore_tpu_torch/scripts/bench.py``)
against the root ``bench.py`` and the JAX package, on the CPU.

The scenes are held to ``bench.py``'s own ``build``; the timed run and the
gate's oracle side to the JAX package's XLA path (``use_pallas=False``,
exact float32) at the bounds of ``tests/test_pallas.py``: grid atol 1e-5
rtol 1e-4, positions by pid within 1e-6.
"""

import dataclasses
import importlib
import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import claymore_tpu as cmt
from claymore_tpu.utils.debug import pool_to_dense as jax_pool_to_dense
from claymore_tpu_torch.interop import collider_from_jax, config_from_jax, material_from_jax
from claymore_tpu_torch.io.sampler import sample_uniform_box_world
from claymore_tpu_torch.scripts import bench, prof_k1
from claymore_tpu_torch.utils.debug import pool_to_dense

from tests.torch_port_helpers import CPU, configs, fixed_corotated_pair, pid_matched

# bench.py's JSON keys in its order, less its TPU knobs, and the port's
KEYS = ["metric", "value", "unit", "vs_baseline", "particles", "ms_per_step", "steps",
        "backend", "grid_backend", "device", "power_limit_w", "active_particles",
        "dropped_tiles", "block_overflow", "model_tflops", "model_hbm_gbs",
        "roofline_share", "mass_rel_err", "displacement", "moves", "ms_per_step_reps",
        "rebuilds_per_rep", "validate_ok"]


def same_collider(port, jax_col):
    """The port's collider equals the JAX one carried over by
    ``collider_from_jax``: type, kind, friction, motion and geometry; SDF
    values and gradients bit for bit."""
    ref = collider_from_jax(jax_col)
    assert type(port) is type(ref)
    a = {k: v for k, v in vars(port).items() if not k.startswith("_")}
    b = {k: v for k, v in vars(ref).items() if not k.startswith("_")}
    assert a.keys() == b.keys()
    for k, v in a.items():
        if isinstance(v, np.ndarray):
            assert v.dtype == b[k].dtype and np.array_equal(v, b[k]), k
        else:
            assert v == b[k], k


@pytest.mark.parametrize("scene", [
    "cube", "sphere", "dambreak", "dambreak_hs", "dambreak_sdf", "sand", "nacc",
    "multimat",
    # these two ignore --quick: 25.1M and 12.1M particles sampled and tiled
    # in both packages (~17 s together on one CPU core)
    pytest.param("sphere25m", marks=pytest.mark.slow),
    pytest.param("dambreak12m", marks=pytest.mark.slow)])
def test_scene_matches_bench_py(scene):
    jcfg, jmats, jparts, jv0s, jcols = importlib.import_module("bench").build(scene, True)
    cfg, mats, parts, v0s, cols = bench.build(scene, True)
    assert config_from_jax(dataclasses.asdict(jcfg)) == cfg
    assert cfg.max_tiles == jcfg.max_tiles > 0
    assert [material_from_jax(m.name, dataclasses.asdict(m)) for m in jmats] == list(mats)
    assert len(parts) == len(jparts)
    for p, jp in zip(parts, jparts):
        assert p.dtype == jp.dtype == np.float32 and np.array_equal(p, jp)
    assert [tuple(v) for v in v0s] == [tuple(v) for v in jv0s]
    assert len(cols) == len(jcols)
    for c, jc in zip(cols, jcols):
        same_collider(c, jc)


def test_profiling_scenes_are_bench_scenes():
    """The profiling scripts build their scenes through ``bench.build``
    alone; its quick cube (``--quick``, span 0.12) is its cube cut down:
    the same configuration but the tile count, material and velocity, its
    particles a subset of the cube's box."""
    from claymore_tpu_torch.scripts import prof_k2

    assert not hasattr(prof_k1, "scene") and not hasattr(prof_k2, "scene")
    cfg, mats, parts, v0s, cols = bench.build("cube", True)
    fcfg, fmats, fparts, fv0s, fcols = bench.build("cube", False)
    assert cfg == dataclasses.replace(fcfg, max_tiles=cfg.max_tiles)
    assert 0 < cfg.max_tiles < fcfg.max_tiles
    assert mats == fmats and v0s == fv0s and cols == fcols == ()
    (pos,), (fpos,) = parts, fparts
    assert 0 < pos.shape[0] < fpos.shape[0]
    assert (pos.min(axis=0) >= fpos.min(axis=0)).all()
    assert (pos.max(axis=0) <= fpos.max(axis=0)).all()
    assert np.allclose(pos.max(axis=0) - pos.min(axis=0), 0.12, atol=2 * cfg.dx)


@pytest.mark.parametrize("words, want", [
    ([264, 74_897, 306, 264 * 7_000_000, 7_350_000, 2_400],
     {"blocks": 264, "live_max": 306, "live_mean": 74_897 / 264,
      "live_ratio": 306 * 264 / 74_897, "block_ms_max": 7.35, "block_ms_mean": 7.0,
      "time_ratio": 1.05, "claims_per_block": 2_400 / 264}),
    ([3, 0, 0, 3_000, 1_500, 3],
     {"blocks": 3, "live_max": 0, "live_mean": 0.0, "live_ratio": None,
      "block_ms_max": 0.0015, "block_ms_mean": 0.001, "time_ratio": 1.5,
      "claims_per_block": 1.0}),
])
def test_block_balance_decodes_the_kernel_counter(words, want):
    """``prof_k1.block_balance`` reads K1's ``block_balance_counter`` (blocks,
    live tiles' sum and max, block ns' sum and max, claims) as a block's
    mean and max and their ratio; no ratio where no block took a live
    tile, and no report where no block ran."""
    got = prof_k1.block_balance(torch.tensor(words, dtype=torch.int64).tolist())
    assert got.keys() == want.keys()
    for key, value in want.items():
        assert got[key] == (None if value is None else pytest.approx(value)), key
    assert prof_k1.block_balance([0] * 6) is None


def test_block_loads_models_the_static_walks():
    """``prof_k1.block_loads``: live tiles a block of a static walk takes,
    block b taking tiles b, b + blocks, ... and, rotated, the k-th tile of
    block b at k blocks + (b + k) mod blocks; the tail padded dead."""
    live = torch.tensor([1, 1, 0, 1,  1, 1, 0, 1,  1, 1, 0], dtype=torch.bool)
    got = prof_k1.block_loads(live, 4)
    # columns: 3, 3, 0, 2 live; rotated walks of 3 rows: block 0 takes
    # tiles 0, 5, 10 (2 live), block 1: 1, 6, 11 (1), block 2: 2, 7, 8
    # (2), block 3: 3, 4, 9 (3)
    assert got == {"blocks": 4, "max": 3.0, "mean": 2.0, "rotated_max": 3.0}
    got = prof_k1.block_loads(torch.tensor([True] * 6 + [False] * 2), 2)
    assert got == {"blocks": 2, "max": 3.0, "mean": 3.0, "rotated_max": 3.0}


def small_scene():
    """(jax cfg, port cfg, jax material, port material, positions, v0): a
    few thousand FixedCorotated particles at domain_bits 6, drift-triggered
    rebuilds as the bench scenes have."""
    jcfg, cfg = configs(domain_bits=6, max_active_blocks=512, default_dt=2e-4,
                        rebucket_auto=True)
    jmat, mat = fixed_corotated_pair(jcfg)
    pos = sample_uniform_box_world(cfg.dx, [0.4, 0.45, 0.4], [0.52, 0.6, 0.52], cfg.ppc)
    return jcfg, cfg, jmat, mat, pos, (0.5, -1.0, 0.3)


def test_main_on_the_cpu_matches_jax(monkeypatch, capsys):
    jcfg, cfg, jmat, mat, pos, v0 = small_scene()
    monkeypatch.setattr(bench, "build", lambda scene, quick: (cfg, [mat], [pos], [v0], ()))
    monkeypatch.setattr(bench, "window", lambda n, quick: 2)
    runs = []
    measure = bench.measure

    def spy(*a, **kw):
        runs.append(measure(*a, **kw))
        return runs[-1]

    monkeypatch.setattr(bench, "measure", spy)
    assert bench.main(["--device=cpu", "--nogate", "--scene=cube"]) == 0
    lines = capsys.readouterr().out.strip().splitlines()
    records = [json.loads(ln) for ln in lines if ln.startswith("{")]
    assert len(records) == 1 and lines[-1].startswith("{")
    rec = records[0]
    assert list(rec) == KEYS
    assert any(ln.startswith("gate: skipped") for ln in lines)
    assert any(ln.startswith("launches {") for ln in lines)

    n = pos.shape[0]
    assert rec["particles"] == rec["active_particles"] == n
    assert rec["dropped_tiles"] == 0 and rec["block_overflow"] == 0
    assert rec["moves"] is True and rec["displacement"] > 0.0
    assert rec["mass_rel_err"] < 1e-5
    assert rec["steps"] == 2 and len(rec["ms_per_step_reps"]) == 3
    assert len(rec["rebuilds_per_rep"]) == 3
    assert rec["backend"] == rec["grid_backend"] == rec["device"] == "cpu"
    assert rec["validate_ok"] is None and rec["roofline_share"] is None
    assert rec["ms_per_step"] == min(rec["ms_per_step_reps"])

    # the run's final state against the JAX package after as many substeps
    state, _, _ = runs[0]
    substeps = int(state.step)
    assert substeps == 1 + 2 + 3 * 2
    jeng = cmt.MPMEngine(jcfg, [jmat], tile_chunk=64)
    js = jeng.init_state([pos], [v0])
    for _ in range(substeps):
        js = jeng.substep(js, jnp.float32(1e9))
    a, b = pid_matched(state.models[0], js.models[0], "pos")
    assert a.shape[1] == n and np.max(np.abs(a - b)) < 1e-6
    jm, jmom = jax_pool_to_dense(jcfg, js)
    m, mom = pool_to_dense(cfg, state)
    np.testing.assert_allclose(m, jm, atol=1e-5, rtol=1e-4)
    np.testing.assert_allclose(mom, jmom, atol=1e-5, rtol=1e-4)


def test_cuda_without_a_card_exits_nonzero(capsys):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: --device cuda would run the benchmark")
    assert bench.main(["--device=cuda", "--quick", "--scene=cube"]) == 2
    assert "no CUDA device" in capsys.readouterr().err


def test_gate_oracle_side_matches_jax():
    """The gate's pair runner on the CPU (its oracle side) at the JAX pair's
    geometry (domain_bits 6, FixedCorotated, 4 substeps) against the JAX
    package's XLA oracle."""
    jcfg, cfg = configs(domain_bits=6, max_active_blocks=512, default_dt=2e-4)
    jmat, mat = fixed_corotated_pair(jcfg)
    pos, state = bench.gate_side(cfg, mat, CPU)
    jeng = cmt.MPMEngine(jcfg, [jmat], tile_chunk=8)
    js = jeng.init_state([pos], [bench.GATE_V0])
    for _ in range(bench.GATE_SUBSTEPS):
        js = jeng.substep(js, jnp.float32(1.0))
    a, b = pid_matched(state.models[0], js.models[0], "pos")
    assert a.shape[1] == pos.shape[0] and np.max(np.abs(a - b)) < 1e-6
    assert np.max(np.abs(a - pos.T)) > 0.0
    jm, jmom = jax_pool_to_dense(jcfg, js)
    m, mom = pool_to_dense(cfg, state)
    np.testing.assert_allclose(m, jm, atol=1e-5, rtol=1e-4)
    np.testing.assert_allclose(mom, jmom, atol=1e-5, rtol=1e-4)


GOOD = {"grid_err": 3e-9, "cloud_err": 6e-8, "grid_mass_rel": 1e-9,
        "mass_vs_analytic": 2e-8, "displacement": 4e-4, "displacement_oracle": 4e-4}


@pytest.mark.parametrize("change, ok", [
    ({}, True),
    ({"displacement": 0.0}, False),                     # a frozen transfer
    ({"displacement": 1e-4}, False),                    # under half the oracle's
    ({"displacement": 0.0, "displacement_oracle": 0.0}, False),   # nothing moved
    ({"grid_err": 2e-4}, False),
    ({"cloud_err": float("inf")}, False),               # a particle missing
    ({"mass_vs_analytic": 2e-6}, False),
    ({"grid_mass_rel": float("nan")}, False),
])
def test_gate_verdict(change, ok):
    assert bench.pair_ok({**GOOD, **change}) is ok
