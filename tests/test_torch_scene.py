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


@pytest.mark.parametrize("change", ["sdf_model", "sdf_collider", "sdf_file_collider",
                                    "n_devices", "mesh_shape"])
def test_load_scene_refuses_unported(tmp_path, change):
    doc = _scene_doc(tmp_path)
    if change == "sdf_model":
        doc["models"][0] = {"constitutive": "jfluid", "file": "bunny.sdf"}
    elif change == "sdf_collider":
        doc["colliders"].append({"type": "sdf", "file": "dome.sdf"})
    elif change == "sdf_file_collider":
        doc["colliders"].append({"type": "sdf_file", "prefix": "x",
                                 "resolution": [8, 8, 8]})
    elif change == "n_devices":
        doc["device"] = {"n_devices": 4}
    else:
        doc["device"] = {"mesh_shape": [2, 2]}
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        load_scene(_write(tmp_path, doc), device=CPU, tile_chunk=4)


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
