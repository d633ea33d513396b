"""``DistGroup`` (one shard per process, ``torch.distributed`` over gloo)
against ``LocalGroup`` (every shard in one process): two processes on a
(2,) mesh give every shard's state bit for bit, and the same diagnostics.

The scene crosses the slab face at 8 m/s under drift-triggered rebuilds,
so the run migrates particles and reads each shard's decision apart.
"""

import os
import socket
import subprocess
import sys

import numpy as np
import torch

import claymore_tpu_torch as ct
from claymore_tpu_torch.io.sampler import sample_uniform_box_world
from claymore_tpu_torch.parallel import MultiChipEngine

from tests.torch_port_helpers import CPU

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
STEPS = 12


def _engine(group=None):
    cfg = ct.SimConfig(domain_bits=5, max_active_blocks=256, default_dt=5e-4,
                       rebucket_auto=True)
    mat = ct.FixedCorotated(volume=cfg.default_volume(), e=1e4, nu=0.3)
    pos = sample_uniform_box_world(cfg.dx, [0.35] * 3, [0.65] * 3, cfg.ppc)
    eng = MultiChipEngine(cfg, [mat], n_devices=2, tile_chunk=4, migration_capacity=4096,
                          device=CPU, group=group)
    s0 = eng.init_state([pos], [(8.0, -0.2, 0.1)])
    counts = [int(x.models[0].active.sum()) for x in s0]
    return eng, counts, eng.run_steps(s0, STEPS, 1.0)


def rank_main(rank: int, port: int, out: str) -> None:
    """One rank of the test: its shard's final leaves and the group's
    diagnostics into ``out``."""
    from claymore_tpu_torch.parallel import distributed

    torch.set_num_threads(1)
    assert distributed.init_multihost(f"tcp://localhost:{port}", world_size=2, rank=rank,
                                      backend="gloo")
    group = distributed.DistGroup((2,), CPU)
    eng, _, (st,) = _engine(group)
    d = eng.diagnostics((st,))
    leaves = [x.detach().numpy() for x in _torch_leaves(st)]
    np.savez(out, *leaves, mass=d["grid_mass"], active=d["model0_active"],
             mig=d["migration_dropped"], rebuilds=eng.rebuilds)
    torch.distributed.destroy_process_group()


def _torch_leaves(state):
    from claymore_tpu_torch.io.checkpoint import leaves

    return leaves(state)


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def test_dist_group_matches_local_group(tmp_path):
    port = _free_port()
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1", CUDA_VISIBLE_DEVICES="")
    procs = [subprocess.Popen(
        [sys.executable, "-c",
         f"from tests.test_torch_multi_dist import rank_main; "
         f"rank_main({r}, {port}, {str(tmp_path / f'rank{r}.npz')!r})"],
        cwd=REPO, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for r in range(2)]
    for p in procs:
        out, _ = p.communicate(timeout=600)
        assert p.returncode == 0, out
    eng, counts, states = _engine()
    d = eng.diagnostics(states)
    assert d["migration_dropped"] == 0 and eng.rebuilds > 0
    moved = 0
    for r, st in enumerate(states):
        got = np.load(tmp_path / f"rank{r}.npz")
        want = [x.numpy() for x in _torch_leaves(st)]
        assert len(want) == len(got.files) - 4
        for i, w in enumerate(want):
            np.testing.assert_array_equal(got[f"arr_{i}"], w, err_msg=f"rank {r} leaf {i}")
        assert float(got["mass"]) == d["grid_mass"]
        assert int(got["active"]) == d["model0_active"]
        assert int(got["rebuilds"]) > 0
        moved += int(st.models[0].active.sum())
    assert moved == d["model0_active"] == sum(counts)
    assert [int(st.models[0].active.sum()) for st in states] != counts


def test_multi_device_modules_leave_jax_out():
    """The multi-device modules, their scripts and chip_smoke import neither
    JAX nor the JAX package."""
    code = ("import sys, chip_smoke, claymore_tpu_torch.parallel, "
            "claymore_tpu_torch.parallel.multi, claymore_tpu_torch.parallel.distributed, "
            "claymore_tpu_torch.scripts.prof_multichip, "
            "claymore_tpu_torch.scripts.validate_scale;"
            "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'claymore_tpu')];"
            "print(bad); sys.exit(1 if bad else 0)")
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                          timeout=120, cwd=REPO, env=dict(os.environ, PYTHONPATH=REPO))
    assert proc.returncode == 0, proc.stdout + proc.stderr


def test_init_multihost_and_pod_mesh_without_a_group(monkeypatch):
    """With no process group configured, ``init_multihost`` reports a
    single-process run and ``pod_mesh`` lays out one rank; a mesh wider
    than the processes raises."""
    import pytest

    from claymore_tpu_torch.parallel import distributed

    for var in ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK"):
        monkeypatch.delenv(var, raising=False)
    assert distributed.init_multihost() is False
    ranks, names = distributed.pod_mesh((1,), ("x", "z"))
    assert ranks.tolist() == [0] and names == ("x",)
    with pytest.raises(ValueError, match="needs 4 processes"):
        distributed.pod_mesh((2, 2), ("x", "z"))
