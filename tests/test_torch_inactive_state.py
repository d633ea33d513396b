"""What an inactive slot holds is never read.

K1 on the card writes positions and fields only over each tile's occupied
prefix (``ops/g2p2g_kernel.py:occupied_slots``): past it, and over every
tile that is not valid, they stay as the output tensor held them, which
may be anything.  So every reader of a state must select by ``active``.
Here the plain versions on the CPU get a state whose inactive slots (every
slot of the dead tiles among them) hold NaN, and must give what they give
on the same state with those slots as the transfer left them: the
substeps (transfer and rebucket), the drift margin, the rebucket's keys
and placement, ``diagnostics``, ``get_positions`` and a checkpoint.
"""

import dataclasses

import numpy as np
import pytest
import torch

import claymore_tpu_torch as ct
from claymore_tpu_torch.core import partition
from claymore_tpu_torch.io import checkpoint
from claymore_tpu_torch.io.sampler import sample_uniform_box_world
from claymore_tpu_torch.ops import g2p2g_kernel, rebucket_kernel

from tests.torch_port_helpers import CPU

MATERIALS = {"fixed_corotated": lambda v: ct.FixedCorotated(volume=v, e=1e4, nu=0.3),
             "jfluid": lambda v: ct.JFluid(volume=v)}


def _state(name, span):
    """An engine at arena span ``span`` and its state after one substep: a
    jittered box in tiles of 64 with spare capacity, so that live tiles
    have empty tails and some tiles are dead."""
    every = 1 if span == 2 else 4
    cfg = ct.SimConfig(domain_bits=5, max_active_blocks=256, default_dt=2e-3,
                       particle_tile=64, rebucket_every=every)
    pos = sample_uniform_box_world(cfg.dx, [0.4, 0.45, 0.4], [0.56, 0.6, 0.53], cfg.ppc)
    rng = np.random.default_rng(7)
    h = cfg.dx / cfg.ppc ** (1.0 / 3.0)
    pos = (pos + (rng.random(pos.shape) - 0.5) * h).astype(np.float32)
    cfg = dataclasses.replace(cfg, max_tiles=ct.exact_tiles(cfg, [pos], slack=1.5))
    eng = ct.MPMEngine(cfg, [MATERIALS[name](cfg.default_volume())], tile_chunk=4,
                       device=CPU)
    state = eng.run_steps(eng.init_state([pos], [(0.6, -0.8, 0.4)]), 1, 1.0)
    m = state.models[0]
    tiles = m.tiles.tvalid.shape[0]
    act = m.active.reshape(tiles, -1)
    assert int((~m.tiles.tvalid).sum()) > 0, "no dead tile"
    assert int((act.any(dim=1) & ~act.all(dim=1)).sum()) > 0, "no partly filled tile"
    return eng, state


def _poisoned(state):
    """``state`` with NaN in the position and fields of every inactive slot
    and of every slot of the tiles that are not valid."""
    m = state.models[0]
    tile = m.active.shape[0] // m.tiles.tvalid.shape[0]
    keep = m.active & m.tiles.tvalid.repeat_interleave(tile)

    def nan(x):
        return torch.where(keep, x, torch.full_like(x, float("nan")))

    model = dataclasses.replace(m, pos=nan(m.pos), fields={k: nan(v) for k, v in m.fields.items()})
    return dataclasses.replace(state, models=(model,))


def _same_particles(a, b):
    """Equal active sets and ids, and bit-equal positions and fields of the
    active particles."""
    assert torch.equal(a.active, b.active) and torch.equal(a.pid, b.pid)
    act = a.active
    assert torch.equal(a.pos[:, act], b.pos[:, act])
    for k in a.fields:
        assert torch.equal(a.fields[k][..., act], b.fields[k][..., act]), k


@pytest.mark.parametrize("span", [2, 4])
@pytest.mark.parametrize("name", list(MATERIALS))
def test_substeps_ignore_inactive_slots(name, span):
    """The plain substeps (transfer, drift margin, rebucket; span 4 runs the
    transfers of a rebucket period) from the poisoned state equal those
    from the state itself: particles, ids and grid, bit for bit."""
    eng, state = _state(name, span)
    bad = _poisoned(state)
    cfg = eng.cfg
    assert float(partition.arena_margin(cfg, bad.models[0])) == float(
        partition.arena_margin(cfg, state.models[0]))
    rebuilds = eng.rebuilds
    steps = cfg.rebucket_every + 1
    a = eng.run_steps(state, steps, 1.0)
    b = eng.run_steps(bad, steps, 1.0)
    assert eng.rebuilds - rebuilds == (4 if span == 2 else 2)
    assert torch.equal(a.grid, b.grid)
    _same_particles(a.models[0], b.models[0])
    assert float(partition.arena_margin(cfg, a.models[0])) == float(
        partition.arena_margin(cfg, b.models[0]))
    # the transfer alone: its output's inactive slots are undefined, the
    # particles it keeps and the pool are not
    outs = []
    for s in (state, bad):
        out, pool, margin = g2p2g_kernel.g2p2g(
            cfg, eng.materials[0], s.grid, s.partition.table, s.models[0], s.dt, s.dt,
            torch.zeros_like(s.grid), 4)
        outs.append((out, pool, float(margin)))
    assert torch.equal(outs[0][1], outs[1][1]) and outs[0][2] == outs[1][2]
    _same_particles(outs[0][0], outs[1][0])


@pytest.mark.parametrize("span", [2, 4])
@pytest.mark.parametrize("name", list(MATERIALS))
def test_rebucket_ignores_inactive_slots(name, span):
    """The plain rebucket of the poisoned state: the same home-block keys,
    the same placement of the active particles, tiles and dropped count."""
    eng, state = _state(name, span)
    cfg, bad = eng.cfg, _poisoned(state)
    m, mb = state.models[0], bad.models[0]
    assert torch.equal(partition.home_keys(cfg, m), partition.home_keys(cfg, mb))
    nt = m.tiles.tvalid.shape[0]
    pa, ka, da = rebucket_kernel.sort_permute(cfg, m, nt)
    pb, kb, db = rebucket_kernel.sort_permute(cfg, mb, nt)
    assert torch.equal(ka, kb) and torch.equal(da, db)
    _same_particles(pa, pb)


@pytest.mark.parametrize("span", [2, 4])
@pytest.mark.parametrize("name", list(MATERIALS))
def test_outputs_ignore_inactive_slots(name, span, tmp_path):
    """``diagnostics`` and ``get_positions`` of the poisoned state, and a
    checkpoint of it read back: what the state itself gives, for every
    active particle."""
    eng, state = _state(name, span)
    bad = _poisoned(state)
    da, db = eng.diagnostics(state), eng.diagnostics(bad)
    assert da.keys() == db.keys()
    for k in da:
        assert np.array_equal(da[k], db[k]), k
    assert np.array_equal(eng.get_positions(state), eng.get_positions(bad))
    path = str(tmp_path / "bad.npz")
    checkpoint.save_state(path, bad)
    back = checkpoint.load_state(path, state)
    _same_particles(state.models[0], back.models[0])
    assert torch.equal(back.grid, state.grid)
