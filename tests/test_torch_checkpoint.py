"""Checkpoints: the port's ``save_state``/``load_state`` against the JAX
package's (same ``.npz`` leaves, both ways, bit for bit), resume exactness
on the CPU, and the CLI's ``--checkpoint-every``/``--resume``."""

import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import claymore_tpu as cmt
import claymore_tpu_torch as ct
from claymore_tpu.io import checkpoint as jckpt
from claymore_tpu_torch.io import checkpoint as ckpt
from claymore_tpu_torch.io.sampler import sample_uniform_box_world

from tests.torch_port_helpers import CPU, configs, material_pair, to_np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _pair():
    """Both engines on one scene with two models (FixedCorotated and Sand,
    so a model with two fields tests the sorted field order)."""
    jcfg, cfg = configs(domain_bits=5, max_active_blocks=256, default_dt=5e-4)
    pairs = [material_pair(jcfg, "fixed_corotated"), material_pair(jcfg, "sand")]
    pos = [sample_uniform_box_world(cfg.dx, [0.40, 0.45, 0.42], [0.52, 0.57, 0.52], cfg.ppc),
           sample_uniform_box_world(cfg.dx, [0.55, 0.4, 0.5], [0.65, 0.5, 0.6], cfg.ppc)]
    v0 = [(0.2, -0.3, 0.1), (-0.1, -0.2, 0.0)]
    jeng = cmt.MPMEngine(jcfg, [p[0] for p in pairs], tile_chunk=4)
    eng = ct.MPMEngine(cfg, [p[1] for p in pairs], tile_chunk=4, device=CPU)
    return jeng, eng, pos, v0


def _assert_same_leaves(port_state, jax_state):
    ours = ckpt.leaves(port_state)
    theirs = jax.tree_util.tree_flatten(jax_state)[0]
    assert len(ours) == len(theirs)
    for i, (a, b) in enumerate(zip(ours, theirs)):
        a, b = to_np(a), np.asarray(b)
        assert a.dtype == b.dtype and a.shape == b.shape, i
        np.testing.assert_array_equal(a, b, err_msg=f"leaf {i}")


def test_jax_checkpoint_resumes_in_port(tmp_path):
    jeng, eng, pos, v0 = _pair()
    js = jeng.init_state(pos, v0)
    for _ in range(3):
        js = jeng.substep(js, jnp.float32(1.0))
    path = str(tmp_path / "jax.npz")
    jckpt.save_state(path, js)
    s = ckpt.load_state(path, eng.init_state(pos, v0))
    _assert_same_leaves(s, js)
    assert set(s.models[1].fields) == {"F", "logJp"}
    # and it runs on
    s = eng.substep(s, 1.0)
    assert eng.diagnostics(s)["null_block_mass"] == 0.0


def test_port_checkpoint_loads_in_jax(tmp_path):
    jeng, eng, pos, v0 = _pair()
    s = eng.init_state(pos, v0)
    for _ in range(3):
        s = eng.substep(s, 1.0)
    path = str(tmp_path / "port.npz")
    ckpt.save_state(path, s)
    js = jckpt.load_state(path, jeng.init_state(pos, v0))
    _assert_same_leaves(s, js)
    with np.load(path) as data:
        assert list(data["__fields__"]) == ["F", "F,logJp"]
        assert int(data["__version__"]) == 2 and int(data["__num_models__"]) == 2


def test_checkpoint_resume_bitexact(tmp_path):
    """The JAX package's tests/test_checkpoint_cli.py:17 property."""
    _, eng, pos, v0 = _pair()
    state = eng.init_state(pos, v0)
    for _ in range(3):
        state = eng.substep(state, 1.0)
    path = str(tmp_path / "ck.npz")
    ckpt.save_state(path, state)
    cont = state
    for _ in range(3):
        cont = eng.substep(cont, 1.0)
    resumed = ckpt.load_state(path, eng.init_state(pos, v0))
    for _ in range(3):
        resumed = eng.substep(resumed, 1.0)
    for i, (a, b) in enumerate(zip(ckpt.leaves(cont), ckpt.leaves(resumed))):
        assert a.dtype == b.dtype and bool((a == b).all()), i


def test_load_state_refuses_another_scene(tmp_path):
    _, eng, pos, v0 = _pair()
    state = eng.init_state(pos, v0)
    path = str(tmp_path / "ck.npz")
    ckpt.save_state(path, state)
    cfg = eng.cfg
    one = ct.MPMEngine(cfg, eng.materials[:1], tile_chunk=4, device=CPU)
    with pytest.raises(ValueError, match="models"):
        ckpt.load_state(path, one.init_state(pos[:1], v0[:1]))
    other = ct.MPMEngine(cfg, eng.materials, tile_chunk=4, device=CPU)
    bigger = [np.concatenate([pos[0], pos[0] + np.float32(0.2)]), pos[1]]
    with pytest.raises(ValueError, match="shape mismatch"):
        ckpt.load_state(path, other.init_state(bigger, v0))


def test_cli_checkpoint_and_resume(tmp_path):
    """Two frames with a checkpoint after each, then the second frame again
    from the first checkpoint: the same state, bit for bit (the plain
    versions on the CPU are deterministic)."""
    scene = {
        "simulation": {"default_dt": 1e-3, "fps": 240, "frames": 2},
        "grid": {"domain_bits": 5, "max_active_blocks": 256},
        "models": [{"constitutive": "jfluid", "shape": {"type": "box"},
                    "offset": [0.35, 0.4, 0.35], "span": [0.15, 0.15, 0.12],
                    "velocity": [0.5, -0.5, 0.0]}],
        "colliders": [{"type": "halfspace", "origin": [0, 0.3, 0],
                       "normal": [0.1, 1, 0], "kind": "slip", "friction": 0.2}],
    }
    path = tmp_path / "scene.json"
    path.write_text(json.dumps(scene))
    env = dict(os.environ, PYTHONPATH=REPO, CUDA_VISIBLE_DEVICES="")

    def cli(*args):
        proc = subprocess.run(
            [sys.executable, "-m", "claymore_tpu_torch", "-f", str(path),
             "--tile-chunk", "4", "--device", "cpu", *args],
            capture_output=True, text=True, timeout=300, cwd=str(tmp_path), env=env)
        assert proc.returncode == 0, proc.stdout + proc.stderr
        return proc.stdout

    full, part = tmp_path / "full", tmp_path / "part"
    cli("-o", str(full), "--checkpoint-every", "1")
    assert sorted(f for f in os.listdir(full) if f.endswith(".npz")) == \
        ["ckpt_-001.npz", "ckpt_0000.npz", "ckpt_0001.npz"]
    out = cli("-o", str(part), "--frames", "1", "--checkpoint-every", "1",
              "--resume", str(full / "ckpt_0000.npz"))
    assert "resumed from" in out and "frame 1/1" in out
    with np.load(full / "ckpt_0001.npz") as a, np.load(part / "ckpt_0000.npz") as b:
        keys = sorted(k for k in a.files if k.startswith("leaf_"))
        assert keys == sorted(k for k in b.files if k.startswith("leaf_"))
        for k in keys:
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)
