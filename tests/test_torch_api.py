"""The port's package-level API (``load_scene``, ``utils.timers.profile_trace``),
the drift margin that ``g2p2g`` returns, and the slot reordering that
``scripts/prof_k1.py`` times K1 under, on CPU tensors.  The margin is held
against the JAX package's ``arena_margin`` of the JAX transfer from the same
state, and bit for bit against the port's ``arena_margin`` of its own output."""

import dataclasses
import json
import os

import numpy as np
import pytest
import torch

import claymore_tpu_torch as ct
from claymore_tpu.core import partition as jpartition
from claymore_tpu_torch.core import grid, partition, transfer
from claymore_tpu_torch.io import scene
from claymore_tpu_torch.ops import g2p2g_kernel
from claymore_tpu_torch.scripts.prof_k1 import permute_tiles
from claymore_tpu_torch.utils.debug import pool_to_dense
from claymore_tpu_torch.utils.timers import profile_trace

from tests.torch_port_helpers import CPU, pid_matched


def _scene_file(tmp_path):
    doc = {
        "simulation": {"default_dt": 1e-3, "fps": 240, "frames": 1},
        "grid": {"domain_bits": 5, "max_active_blocks": 256},
        "models": [
            {"constitutive": "jfluid", "shape": {"type": "box"},
             "offset": [0.3, 0.3, 0.3], "span": [0.12, 0.15, 0.1],
             "velocity": [0.5, -1.0, 0.0]},
            {"constitutive": "fixed_corotated", "shape": {"type": "sphere"},
             "offset": [0.5, 0.5, 0.45], "span": [0.1, 0.1, 0.1]},
        ],
        "colliders": [{"type": "halfspace", "origin": [0.0, 0.25, 0.0],
                       "normal": [0.0, 1.0, 0.0], "kind": "slip", "friction": 0.2}],
    }
    path = tmp_path / "scene.json"
    path.write_text(json.dumps(doc))
    return str(path)


def test_package_exports(tmp_path):
    """``claymore_tpu_torch.load_scene`` (the JAX package's
    ``claymore_tpu.load_scene``) loads a scene as ``io.scene.load_scene``
    does when asked for the CPU."""
    assert callable(ct.load_scene) and "load_scene" in ct.__all__
    path = _scene_file(tmp_path)
    a = ct.load_scene(path, device="cpu", tile_chunk=4)
    b = scene.load_scene(path, device=CPU, tile_chunk=4)
    assert a.cfg == b.cfg and a.frames == b.frames == 1
    assert [dataclasses.asdict(m) for m in a.materials] == \
        [dataclasses.asdict(m) for m in b.materials]
    for p, q in zip(a.positions, b.positions):
        np.testing.assert_array_equal(p, q)
    assert a.state.grid.device == CPU
    assert torch.equal(a.state.grid, b.state.grid)
    for ma, mb in zip(a.state.models, b.state.models):
        assert torch.equal(ma.pos, mb.pos) and torch.equal(ma.pid, mb.pid)
    assert len(a.engine.colliders) == len(b.engine.colliders) == 1


def test_profile_trace_writes_a_chrome_trace(tmp_path):
    logdir = str(tmp_path / "trace")
    x = torch.arange(4096, dtype=torch.float32)
    with profile_trace(logdir) as prof:
        y = (x * 2.0).sum()
    assert float(y) == 4096.0 * 4095.0
    files = os.listdir(logdir)
    assert len(files) == 1 and files[0].endswith(".json")
    with open(os.path.join(logdir, files[0])) as f:
        events = json.load(f)["traceEvents"]
    names = {e.get("name") for e in events}
    assert any("mul" in str(n) for n in names)
    assert len(prof.key_averages()) > 0


def _transfer_scene(name):
    from tests.test_torch_transfer import _scene

    jcfg, cfg, jmat, mat, pos, s = _scene(name)
    # shear and compression on the grid, so the fields move
    rng = np.random.default_rng(11)
    g = s.grid.clone()
    m = g[:, 0:4].reshape(-1, 1, 4, 128)
    noise = torch.from_numpy(rng.normal(0.0, 2.0, size=(g.shape[0], 3, 4, 128))
                             .astype(np.float32))
    g[:, 4:16] += (noise * m).reshape(-1, 12, 128)
    return jcfg, cfg, jmat, mat, dataclasses.replace(s, grid=g)


@pytest.mark.parametrize("name", ["fixed_corotated", "jfluid", "sand", "nacc"])
def test_g2p2g_returns_arena_margin_on_cpu(name):
    """``g2p2g`` on CPU tensors returns ``arena_margin`` of its own output
    bit for bit, and that margin is the JAX package's ``arena_margin`` of
    the JAX transfer from the same state to float32 roundoff."""
    from tests.test_torch_transfer import _one_transfer

    jcfg, cfg, jmat, mat, s = _transfer_scene(name)
    pool_v, mv = grid.grid_update(cfg, s.grid, s.partition, s.dt)
    next_dt = grid.compute_dt(cfg, mv, s.t + s.dt, torch.tensor(1.0))
    new, _, margin = g2p2g_kernel.g2p2g(cfg, mat, pool_v, s.partition.table, s.models[0],
                                        s.dt, next_dt, torch.zeros_like(s.grid), 4)
    assert margin.shape == () and margin.dtype == torch.float32
    assert torch.equal(margin, partition.arena_margin(cfg, new))
    (_, _), (jm1, _), _ = _one_transfer(jcfg, cfg, jmat, mat, s)
    want = float(jpartition.arena_margin(jcfg, jm1))
    assert 0.0 < float(margin) < cfg.arena_cells - 2
    assert abs(float(margin) - want) < 1e-4


@pytest.mark.parametrize("order", ["permuted", "sorted"])
def test_permute_tiles_keeps_the_transfer(order):
    """Reordering the slots inside every tile (how K1's order sensitivity
    is timed) keeps the state valid: the same particles in the same tiles,
    and the same transfer up to the order of float sums."""
    _, cfg, _, mat, s = _transfer_scene("fixed_corotated")
    r = permute_tiles(cfg, s, order)
    m0, m1 = s.models[0], r.models[0]
    t, n = m0.tiles.tvalid.shape[0], cfg.particle_tile
    assert torch.equal(m0.active.reshape(t, n).sum(1), m1.active.reshape(t, n).sum(1))
    assert not torch.equal(m0.pos, m1.pos)
    for k in ("pos", "F"):
        a, b = pid_matched(m0, m1, k)
        np.testing.assert_array_equal(a, b)
    pool_v, _ = grid.grid_update(cfg, s.grid, s.partition, s.dt)
    outs = [transfer.g2p2g_model(cfg, mat, pool_v, s.partition.table, st.models[0],
                                 s.dt, s.dt, torch.zeros_like(s.grid), 4)
            for st in (s, r)]
    (a0, p0), (a1, p1) = outs
    d0 = pool_to_dense(cfg, dataclasses.replace(s, grid=p0))
    d1 = pool_to_dense(cfg, dataclasses.replace(s, grid=p1))
    for x, y in zip(d0, d1):
        np.testing.assert_allclose(x, y, atol=1e-6, rtol=1e-5)
    a, b = pid_matched(a0, a1, "pos")
    assert np.max(np.abs(a - b)) < 1e-6
    assert torch.equal(partition.arena_margin(cfg, a0), partition.arena_margin(cfg, a1))
