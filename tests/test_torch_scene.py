"""The port's scene loading, BGEO output and CLI against the JAX package."""

import dataclasses
import json
import os
import subprocess
import sys

import numpy as np
import pytest

from claymore_tpu.io import bgeo as jbgeo
from claymore_tpu.io.scene import load_scene as jax_load_scene
from claymore_tpu_torch.io import bgeo
from claymore_tpu_torch.io.scene import load_scene
from claymore_tpu_torch.parallel import MultiChipEngine
from claymore_tpu_torch.utils.debug import pool_to_dense
from claymore_tpu.utils.debug import pool_to_dense as jax_pool_to_dense

from tests.torch_port_helpers import CPU

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _scene_doc(tmp_path):
    rng = np.random.default_rng(0)
    cloud = (np.asarray([0.62, 0.5, 0.6], np.float32)
             + rng.uniform(0.0, 0.06, size=(300, 3)).astype(np.float32))
    np.save(tmp_path / "cloud.npy", cloud)
    (cloud + np.float32(0.0)).reshape(-1).tofile(tmp_path / "cloud.bin")
    return {
        "simulation": {"default_dt": 1e-3, "fps": 240, "frames": 2},
        "grid": {"domain_bits": 5, "max_active_blocks": 512,
                 "gravity": [0.0, -9.0, 0.5]},
        "models": [
            {"constitutive": "jfluid", "shape": {"type": "box"},
             "offset": [0.3, 0.3, 0.3], "span": [0.12, 0.2, 0.1],
             "velocity": [0.5, -1.0, 0.0], "bulk_modulus": 3e4, "gamma": 7.0},
            {"constitutive": "sand", "shape": {"type": "sphere"},
             "offset": [0.5, 0.5, 0.3], "span": [0.1, 0.1, 0.1],
             "rho": 1500.0, "youngs_modulus": 1e4},
            {"constitutive": "fixed_corotated", "file": "cloud.npy",
             "poisson_ratio": 0.3},
            {"constitutive": "nacc", "file": "cloud.bin", "beta": 0.4},
        ],
        "colliders": [
            {"type": "halfspace", "origin": [0.0, 0.25, 0.0],
             "normal": [0.1, 1.0, 0.0], "kind": "slip", "friction": 0.2},
            {"type": "sphere", "center": [0.4, 0.3, 0.4], "radius": 0.05,
             "kind": "separate", "trans_vel": [0.1, 0.0, 0.0]},
            {"type": "box", "lo": [0.7, 0.1, 0.7], "hi": [0.9, 0.3, 0.9]},
        ],
        "device": {"use_pallas": True},
    }


def _write(tmp_path, doc, name="scene.json"):
    path = tmp_path / name
    path.write_text(json.dumps(doc))
    return str(path)


def test_load_scene_matches_jax(tmp_path):
    path = _write(tmp_path, _scene_doc(tmp_path))
    sc = load_scene(path, device=CPU, tile_chunk=4)
    jdoc = _scene_doc(tmp_path)
    jdoc["device"] = {"use_pallas": False}
    jsc = jax_load_scene(_write(tmp_path, jdoc, "jax.json"), tile_chunk=4)
    jcfg = jsc.cfg
    for f in dataclasses.fields(sc.cfg):
        assert getattr(sc.cfg, f.name) == getattr(jcfg, f.name), f.name
    assert sc.frames == jsc.frames == 2
    assert [type(m).__name__ for m in sc.materials] == \
        [type(m).__name__ for m in jsc.materials]
    for m, jm in zip(sc.materials, jsc.materials):
        assert dataclasses.asdict(m) == dataclasses.asdict(jm)
    for p, jp in zip(sc.positions, jsc.positions):
        np.testing.assert_array_equal(p, jp)
    cols, jcols = sc.engine.colliders, jsc.engine.colliders
    assert [type(c).__name__ for c in cols] == [type(c).__name__ for c in jcols]
    for c, jc in zip(cols, jcols):
        assert (c.kind, c.friction) == (jc.kind, jc.friction)
        assert dataclasses.asdict(c.motion) == dataclasses.asdict(jc.motion)
        for attr in ("origin", "normal", "center", "radius", "lo", "hi"):
            if hasattr(jc, attr):
                assert getattr(c, attr) == getattr(jc, attr), attr
    # the same initial state: rasterized grids and per-model counts
    m, mom = pool_to_dense(sc.cfg, sc.state)
    jm, jmom = jax_pool_to_dense(jcfg, jsc.state)
    np.testing.assert_allclose(m, jm, atol=1e-5, rtol=1e-4)
    np.testing.assert_allclose(mom, jmom, atol=1e-5, rtol=1e-4)
    for i, (md, jmd) in enumerate(zip(sc.state.models, jsc.state.models)):
        assert int(md.active.sum()) == int(np.asarray(jmd.active).sum()) > 0, i
        assert set(md.fields) == set(jmd.fields)
    # and the scene runs
    st = sc.engine.run_steps(sc.state, 2, 1.0)
    assert sc.engine.diagnostics(st)["null_block_mass"] == 0.0


def _sdf_assets(tmp_path):
    """A ball ``.sdf`` (SDFGen format, not cubic) and a 16^3 bowl in the
    reference's raw collider format; returns their paths."""
    from claymore_tpu_torch.io.sdf import write_sdf_file

    ax = [np.arange(m) * 0.05 for m in (16, 14, 12)]
    x, y, z = np.meshgrid(*ax, indexing="ij")
    ball = np.sqrt((x - 0.38) ** 2 + (y - 0.33) ** 2 + (z - 0.28) ** 2) - 0.25
    write_sdf_file(str(tmp_path / "ball.sdf"), ball, (0.0, 0.0, 0.0), 0.05)
    n = np.arange(16, dtype=np.float32) / 16
    x, y, z = np.meshgrid(n, n, n, indexing="ij")
    bowl = (0.3 - np.sqrt((x - 0.5) ** 2 + (y - 0.6) ** 2 + (z - 0.5) ** 2)).astype(np.float32)
    prefix = str(tmp_path / "bowl")
    bowl.reshape(-1).tofile(prefix + "_sdf.bin")
    for c, gc in enumerate(np.gradient(bowl, 1 / 16)):
        gc.astype(np.float32).reshape(-1).tofile(f"{prefix}_grad_{c}.bin")
    return str(tmp_path / "ball.sdf"), prefix


@pytest.mark.parametrize("change", ["sdf_model", "sdf_collider", "sdf_file_collider"])
def test_load_scene_sdf_inputs_match_jax(tmp_path, change):
    """``.sdf`` model files and ``sdf``/``sdf_file`` colliders load as in
    the JAX package: the same particles and the same collider arrays."""
    ball, prefix = _sdf_assets(tmp_path)
    doc = _scene_doc(tmp_path)
    doc["models"] = doc["models"][:1]
    doc["colliders"] = doc["colliders"][:1]
    if change == "sdf_model":
        doc["models"].append({"constitutive": "jfluid", "file": "ball.sdf",
                              "offset": [0.55, 0.4, 0.5], "span": [0.2, 0.16, 0.14],
                              "sampling": "uniform"})
    elif change == "sdf_collider":
        doc["colliders"].append({"type": "sdf", "file": ball, "kind": "slip",
                                 "friction": 0.3, "omega": [0.0, 0.5, 0.0]})
    else:
        doc["colliders"].append({"type": "sdf_file", "prefix": prefix,
                                 "resolution": [16, 16, 16], "kind": "separate",
                                 "bound_cells": 2, "trans": [0.0, 0.05, 0.0]})
    sc = load_scene(_write(tmp_path, doc), device=CPU, tile_chunk=4)
    doc["device"] = {"use_pallas": False}
    jsc = jax_load_scene(_write(tmp_path, doc, "jax.json"), tile_chunk=4)
    for p, jp in zip(sc.positions, jsc.positions):
        np.testing.assert_array_equal(p, jp)
    assert sc.positions[-1].shape[0] > 100
    cols, jcols = sc.engine.colliders, jsc.engine.colliders
    assert [type(c).__name__ for c in cols] == [type(c).__name__ for c in jcols]
    c, jc = cols[-1], jcols[-1]
    assert (c.kind, c.friction) == (jc.kind, jc.friction)
    assert dataclasses.asdict(c.motion) == dataclasses.asdict(jc.motion)
    if change != "sdf_model":
        np.testing.assert_array_equal(c.values, np.asarray(jc.values))
        np.testing.assert_array_equal(c.grads, np.asarray(jc.grads))
        assert (c.dx, c.bound_cells) == (jc.dx, jc.bound_cells)
    st = sc.engine.run_steps(sc.state, 2, 1.0)
    assert sc.engine.diagnostics(st)["null_block_mass"] == 0.0


@pytest.mark.parametrize("change", ["n_devices", "mesh_shape", "poisson"])
def test_load_scene_refuses_unported(tmp_path, change):
    """Nothing is refused any more.  Several devices build a
    ``MultiChipEngine`` on the scene's mesh, every shard on the CPU, each
    particle on the shard of its home block and none lost over a substep.
    ``"sampling": "poisson"`` loads the same particles as the JAX package
    (both thin their candidates with the same weighted sample
    elimination)."""
    doc = _scene_doc(tmp_path)
    if change in ("n_devices", "mesh_shape"):
        doc["device"] = {"n_devices": 4} if change == "n_devices" else {"mesh_shape": [2, 2]}
        sc = load_scene(_write(tmp_path, doc), device=CPU, tile_chunk=4)
        eng = sc.engine
        assert isinstance(eng, MultiChipEngine)
        assert eng.mesh_shape == ((4,) if change == "n_devices" else (2, 2))
        for i, p in enumerate(sc.positions):
            counts = np.bincount(eng.shard_of(p), minlength=4)
            assert [int(st.models[i].active.sum()) for st in sc.state] == counts.tolist()
        st = eng.run_steps(sc.state, 1, 1.0)
        d = eng.diagnostics(st)
        for i, p in enumerate(sc.positions):
            assert d[f"model{i}_active"] == p.shape[0]
        assert d["migration_dropped"] == d["halo_overflow"] == 0
        return
    _sdf_assets(tmp_path)
    doc["models"][0] = {"constitutive": "jfluid", "file": "ball.sdf",
                        "sampling": "poisson"}
    sc = load_scene(_write(tmp_path, doc), device=CPU, tile_chunk=4)
    doc["device"] = {"use_pallas": False}
    jsc = jax_load_scene(_write(tmp_path, doc, "jax.json"), tile_chunk=4)
    for p, jp in zip(sc.positions, jsc.positions):
        np.testing.assert_array_equal(p, jp)
    assert sc.positions[0].shape[0] > 100


def test_bgeo_round_trip_with_jax_reader(tmp_path):
    rng = np.random.default_rng(1)
    pos = rng.normal(size=(257, 3)).astype(np.float32)
    attrs = {"J": rng.uniform(size=257).astype(np.float32),
             "id": np.arange(257, dtype=np.int32),
             "v": rng.normal(size=(257, 3)).astype(np.float32)}
    for name in ("a.bgeo", "a.bgeo.gz"):
        path = str(tmp_path / name)
        bgeo.write_bgeo(path, pos, attrs)
        for reader in (bgeo.read_bgeo, jbgeo.read_bgeo):
            p, a = reader(path)
            np.testing.assert_array_equal(p, pos)
            for k, v in attrs.items():
                np.testing.assert_array_equal(a[k], v)
    # the JAX writer's (numpy) output reads back here too
    path = str(tmp_path / "j.bgeo.gz")
    jbgeo.write_bgeo(path, pos, attrs)
    p, a = bgeo.read_bgeo(path)
    np.testing.assert_array_equal(p, pos)
    np.testing.assert_array_equal(a["id"], attrs["id"])


def _cli(args, tmp_path):
    env = dict(os.environ, PYTHONPATH=REPO, CUDA_VISIBLE_DEVICES="")
    return subprocess.run([sys.executable, "-m", "claymore_tpu_torch", *args],
                          capture_output=True, text=True, timeout=300,
                          cwd=str(tmp_path), env=env)


def test_cli_writes_frames_jax_reads(tmp_path):
    doc = _scene_doc(tmp_path)
    doc["models"] = doc["models"][:2]
    path = _write(tmp_path, doc)
    out = tmp_path / "out"
    proc = _cli(["-f", path, "-o", str(out), "--frames", "1", "--tile-chunk", "4",
                 "--device", "cpu", "--profile"], tmp_path)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "frame 1/1" in proc.stdout and "done: 1 frames" in proc.stdout
    sc = load_scene(path, device=CPU, tile_chunk=4)
    for mi, p in enumerate(sc.positions):
        for frame in (-1, 0):
            pos, _ = jbgeo.read_bgeo(str(out / f"model{mi}_frame{frame:04d}.bgeo"))
            assert pos.shape == (p.shape[0], 3), (mi, frame)
            assert np.all(np.isfinite(pos))
        # frame -1 is the initial cloud, in slot order
        pos, _ = jbgeo.read_bgeo(str(out / f"model{mi}_frame-001.bgeo"))
        np.testing.assert_array_equal(np.sort(pos, axis=0), np.sort(p, axis=0))


def test_cli_refuses_cuda_without_a_card(tmp_path):
    path = _write(tmp_path, _scene_doc(tmp_path))
    proc = _cli(["-f", path, "--frames", "1", "--no-output"], tmp_path)
    assert proc.returncode != 0
    assert "no CUDA device" in proc.stderr
    assert "frame" not in proc.stdout
