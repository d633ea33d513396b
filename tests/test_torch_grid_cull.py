"""The collider kernels' row cull, through its plain twin
``ops/grid_kernel.py:collider_row_mask``: a (row, collider) pair it skips
must hold no cell with sd <= 0, by the port's ``pose`` +
``sdf_and_normal_soa`` and by the JAX package's collider of the same
parameters; it must skip a good share of pairs; and it must keep every row
that straddles a surface."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from claymore_tpu.models import boundary as jb
from claymore_tpu_torch.core import grid
from claymore_tpu_torch.core.types import Partition
from claymore_tpu_torch.interop import collider_from_jax
from claymore_tpu_torch.ops import grid_kernel

from tests.torch_port_helpers import configs


def _dome(res=32):
    """scripts/bench.py:sdf_dome at ``res`` nodes: the same cap and band."""
    dx = 1.0 / res
    ax = (np.arange(res, dtype=np.float32) + 0.5) * dx
    x, y, z = np.meshgrid(ax, ax, ax, indexing="ij")
    sdf = np.sqrt((x - 0.55) ** 2 + (y - 0.02) ** 2 + (z - 0.35) ** 2) - 0.12
    return jb.SignedDistanceCollider(sdf, dx, kind="slip", friction=0.1,
                                     bound_cells=res // 16)


def _spinner(res=48, motion=None):
    """prof_k2.sdf_spinner at ``res`` nodes on its first axis."""
    dx = 1.0 / res
    ax = [np.arange(n, dtype=np.float32) * dx for n in (res, res * 5 // 6, res * 2 // 3)]
    x, y, z = np.meshgrid(*ax, indexing="ij")
    sdf = (np.sqrt(((x - 0.45) / 0.25) ** 2 + ((y - 0.4) / 0.15) ** 2
                   + ((z - 0.33) / 0.2) ** 2) - 1.0) * 0.15
    motion = motion or jb.RigidMotion(trans=(0.03, 0.05, 0.1), trans_vel=(0.1, 0.0, -0.05),
                                      omega=(0.4, 1.2, -0.3))
    return jb.SignedDistanceCollider(sdf, dx, kind="separate", friction=0.3,
                                     bound_cells=res // 24, motion=motion)


def _colliders(name):
    if name == "pallas":        # tests/test_pallas_grid.py:92-99
        return (
            jb.HalfSpace((0.0, 0.3, 0.0), (0.1, 1.0, 0.0), kind="slip", friction=0.3),
            jb.Sphere((0.5, 0.5, 0.5), 0.2, kind="separate", friction=0.1,
                      motion=jb.RigidMotion(trans_vel=(0.05, 0.0, 0.0),
                                            omega=(0.0, 1.5, 0.0))),
            jb.Box((0.6, 0.1, 0.6), (0.9, 0.4, 0.9), kind="sticky"),
        )
    if name == "sdf":           # prof_k2.sdf_colliders
        return (_dome(), jb.HalfSpace((0.0, 0.3, 0.0), (0.1, 1.0, 0.0), kind="slip",
                                      friction=0.3), _spinner())
    # scaled and moving: s = 1 + dsdt t != 1
    grow = jb.RigidMotion(trans=(0.05, -0.02, 0.0), trans_vel=(0.0, 0.05, 0.0),
                          scale=1.2, dsdt=0.4)
    return (jb.Box((0.3, 0.3, 0.3), (0.5, 0.45, 0.6), kind="slip", motion=grow),
            jb.Sphere((0.4, 0.6, 0.5), 0.15, kind="sticky",
                      motion=jb.RigidMotion(omega=(0.7, 0.0, -0.4), scale=0.9, dsdt=-0.2)),
            _spinner(motion=jb.RigidMotion(trans_vel=(0.02, 0.0, 0.0), omega=(0.0, 0.5, 0.0),
                                           scale=1.1, dsdt=0.3)))


def _jax_sd(jcol, x3, t):
    """The JAX collider's signed distance at world positions ``x3`` (numpy
    [3, N]) posed at ``t``: the first lines of its ``resolve_soa``."""
    mo = jcol.motion
    t = jnp.float32(t)
    x3 = tuple(jnp.asarray(c) for c in x3)
    off = tuple(jnp.float32(mo.trans[k]) + jnp.float32(mo.trans_vel[k]) * t for k in range(3))
    s = 1.0 + mo.dsdt * t
    x0 = tuple((x3[k] - off[k]) / s for k in range(3))
    if mo.omega != (0.0, 0.0, 0.0):
        r = jb._rot_xyz_scalars(tuple(jnp.float32(c) for c in mo.omega), t)
        x0 = tuple(r[k] * x0[0] + r[3 + k] * x0[1] + r[6 + k] * x0[2] for k in range(3))
    if isinstance(jcol, jb.SignedDistanceCollider):
        return np.asarray(jcol.sdf_and_normal(jnp.stack(x0))[0])
    return np.asarray(jcol.sdf_and_normal_soa(x0)[0])


def _partition(cfg, octs):
    keys = np.full((cfg.max_active_octs,), cfg.num_oct_keys, np.int32)
    keys[:len(octs)] = octs
    i32 = dict(dtype=torch.int32)
    return Partition(table=torch.zeros((cfg.num_oct_keys + 1,), **i32),
                     keys=torch.from_numpy(keys), count=torch.tensor([len(octs)], **i32),
                     overflow=torch.zeros((1,), **i32))


def _cell_sd(cfg, part, jcols, cols, t):
    """Per collider, the sd of every cell of every pool row, [O+1, 512],
    by the port and by JAX."""
    x3 = grid.cell_positions(cfg, part)
    o1 = x3[0].shape[0]
    tt = torch.tensor(np.float32(t))
    flat = np.stack([c.reshape(-1).numpy() for c in x3])
    port, ref = [], []
    for jcol, col in zip(jcols, cols):
        _, x_mat, _ = col.pose(x3, tt)
        port.append(col.sdf_and_normal_soa(x_mat)[0].reshape(o1, -1).numpy())
        ref.append(_jax_sd(jcol, flat, t).reshape(o1, -1))
    return port, ref


@pytest.mark.parametrize("t", [0.0, 0.37, 2.0])
@pytest.mark.parametrize("name", ["pallas", "sdf", "scaled"])
def test_culled_rows_hold_no_hit(name, t):
    """Random partitions at domain_bits 7: every (row, collider) the mask
    culls has no cell with sd <= 0, by the port and by JAX; at least half
    of the pairs are culled."""
    _, cfg = configs(domain_bits=7, max_active_blocks=1536)
    rng = np.random.default_rng(17)
    part = _partition(cfg, rng.choice(cfg.num_oct_keys, size=1500, replace=False))
    jcols = _colliders(name)
    cols = tuple(collider_from_jax(c) for c in jcols)
    mask = grid_kernel.collider_row_mask(cfg, part, cols, torch.tensor(np.float32(t)))
    assert mask.shape == (cfg.max_active_octs + 1, len(cols)) and mask.dtype == torch.bool
    port, ref = _cell_sd(cfg, part, jcols, cols, t)
    hits = 0
    for i in range(len(cols)):
        for sd in (port[i], ref[i]):
            hit = (sd <= 0.0).any(axis=1)
            assert not (hit & ~mask[:, i].numpy()).any(), (name, t, i)
        hits += int((port[i] <= 0.0).any(axis=1).sum())
    assert hits > 0                                    # the colliders are in the domain
    culled = 1.0 - float(mask.float().mean())
    assert culled >= 0.5, culled


@pytest.mark.parametrize("name", ["pallas", "sdf", "scaled"])
def test_straddling_rows_are_kept(name):
    """Partitions of only the rows whose cells lie on both sides of a
    collider's surface (by the port's sd): the mask keeps that collider on
    every one of them."""
    t = 0.37
    _, full_cfg = configs(domain_bits=7, max_active_blocks=4096)
    full = _partition(full_cfg, np.arange(full_cfg.num_oct_keys))
    jcols = _colliders(name)
    cols = tuple(collider_from_jax(c) for c in jcols)
    x3 = grid.cell_positions(full_cfg, full)
    tt = torch.tensor(np.float32(t))
    for i, col in enumerate(cols):
        _, x_mat, _ = col.pose(x3, tt)
        sd = col.sdf_and_normal_soa(x_mat)[0].reshape(x3[0].shape[0], -1)[:-1]
        octs = np.flatnonzero(((sd <= 0.0).any(dim=1) & (sd > 0.0).any(dim=1)).numpy())
        assert len(octs) > 0, (name, i)
        part = _partition(full_cfg, octs)
        mask = grid_kernel.collider_row_mask(full_cfg, part, cols, tt)
        assert bool(mask[:len(octs), i].all()), (name, i)


def test_wrapper_fills_row_mask_on_cpu():
    """On a CPU pool the grid wrapper's optional ``row_mask`` receives the
    twin's decision, and the grid update is the plain version's."""
    _, cfg = configs(domain_bits=7, max_active_blocks=256)
    rng = np.random.default_rng(3)
    part = _partition(cfg, rng.choice(cfg.num_oct_keys, size=200, replace=False))
    cols = tuple(collider_from_jax(c) for c in _colliders("sdf"))
    pool = torch.zeros((cfg.max_active_octs + 1, 16, 128))
    pool[:200, 0:4] = torch.from_numpy(rng.uniform(0.0, 2.0, (200, 4, 128)).astype(np.float32))
    dt, tt = torch.tensor(3e-4), torch.tensor(0.37)
    mask = torch.zeros((cfg.max_active_octs + 1, len(cols)), dtype=torch.bool)
    a = grid_kernel.grid_update(cfg, pool, part, dt, cols, tt, row_mask=mask)
    b = grid.grid_update(cfg, pool, part, dt, cols, tt)
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])
    assert torch.equal(mask, grid_kernel.collider_row_mask(cfg, part, cols, tt))
    assert 0 < int(mask.sum()) < mask.numel()


def test_bricks_and_packed_brick_address():
    """``bricks`` is the least node of each 8^3 brick (NaN nodes left out);
    an SDF row of the packed table carries its address in words 7 and 23
    when its band is at least two nodes thick, else 0."""
    rng = np.random.default_rng(5)
    vals = rng.normal(size=(19, 12, 9)).astype(np.float32)
    vals[3, 4, 5] = np.nan
    col = collider_from_jax(jb.SignedDistanceCollider(vals, 0.05, bound_cells=2))
    br = col.bricks("cpu").numpy()
    assert br.shape == (3, 2, 2) and br.dtype == np.float32
    for i in range(3):
        for j in range(2):
            for k in range(2):
                blk = vals[8 * i:8 * i + 8, 8 * j:8 * j + 8, 8 * k:8 * k + 8]
                assert br[i, j, k] == np.nanmin(blk)
    assert col.bricks(torch.device("cpu")) is col.bricks("cpu")      # made once
    thin = collider_from_jax(jb.SignedDistanceCollider(vals, 0.05, bound_cells=1))
    words = grid_kernel.pack_colliders((col, thin), "cpu").numpy().view(np.uint32)
    addr = int(words[0, 7]) | (int(words[0, 23]) << 32)
    assert addr == col.bricks("cpu").data_ptr()
    assert words[1, 7] == 0 and words[1, 23] == 0
