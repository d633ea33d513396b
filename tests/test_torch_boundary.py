"""The port's analytic colliders against the JAX package: ``resolve_soa``
per collider type, kind, friction and motion, and the grid update with the
colliders of tests/test_pallas_grid.py against the Pallas kernel in
interpret mode (the math the CUDA grid kernel carries)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from claymore_tpu.models import boundary as jb
from claymore_tpu.ops.pallas_grid import grid_update_pallas
from claymore_tpu_torch.core import grid
from claymore_tpu_torch.interop import collider_from_jax
from claymore_tpu_torch.models import boundary as tb
from claymore_tpu_torch.ops import grid_kernel

from tests.test_torch_grid import _partitions, _random_pool
from tests.torch_port_helpers import configs

_MOTIONS = {
    "static": jb.RigidMotion(),
    "moving": jb.RigidMotion(trans=(0.01, -0.02, 0.0), trans_vel=(0.05, 0.0, -0.1)),
    "rotating": jb.RigidMotion(trans_vel=(0.05, 0.0, 0.0), omega=(0.3, 1.5, -0.7)),
    "scaling": jb.RigidMotion(scale=1.2, dsdt=0.4),
}


def _jax_collider(shape, kind, friction, motion):
    if shape == "halfspace":
        return jb.HalfSpace((0.0, 0.45, 0.1), (0.2, 1.0, -0.1), kind=kind,
                            friction=friction, motion=motion)
    if shape == "sphere":
        return jb.Sphere((0.5, 0.5, 0.45), 0.22, kind=kind, friction=friction,
                         motion=motion)
    return jb.Box((0.3, 0.35, 0.4), (0.7, 0.6, 0.8), kind=kind, friction=friction,
                  motion=motion)


@pytest.mark.parametrize("motion", sorted(_MOTIONS))
@pytest.mark.parametrize("kind,friction", [("sticky", 0.0), ("slip", 0.0),
                                           ("slip", 0.4), ("separate", 0.0),
                                           ("separate", 0.3)])
@pytest.mark.parametrize("shape", ["halfspace", "sphere", "box"])
def test_resolve_soa_matches_jax(shape, kind, friction, motion):
    rng = np.random.default_rng(11)
    x = rng.uniform(0.1, 0.9, size=(3, 2048)).astype(np.float32)
    v = rng.normal(0.0, 1.0, size=(3, 2048)).astype(np.float32)
    jcol = _jax_collider(shape, kind, friction, _MOTIONS[motion])
    col = collider_from_jax(jcol)
    t = np.float32(0.37)
    ref = jcol.resolve_soa(tuple(jnp.asarray(c) for c in x),
                           tuple(jnp.asarray(c) for c in v), jnp.float32(t))
    got = col.resolve_soa(tuple(torch.from_numpy(c) for c in x),
                          tuple(torch.from_numpy(c) for c in v), torch.tensor(t))
    ref = np.stack([np.asarray(c) for c in ref])
    got = torch.stack(got).numpy()
    # cells that collide: a good share, so every branch is exercised
    assert 0 < int(np.any(ref != v, axis=0).sum()) < x.shape[1]
    # the FMA ordering of the two libraries: a few ulps of |v| ~ 1
    np.testing.assert_allclose(got, ref, rtol=1e-4, atol=1e-6)


def test_collider_from_jax_carries_parameters():
    motion = _MOTIONS["rotating"]
    for shape in ("halfspace", "sphere", "box"):
        jcol = _jax_collider(shape, "separate", 0.3, motion)
        col = collider_from_jax(jcol)
        assert type(col).__name__ == type(jcol).__name__
        assert (col.kind, col.friction) == (jcol.kind, jcol.friction)
        assert col.motion == tb.RigidMotion(**vars(jcol.motion))
        for attr in ("origin", "normal", "center", "radius", "lo", "hi"):
            if hasattr(jcol, attr):
                assert getattr(col, attr) == getattr(jcol, attr), attr
    with pytest.raises(NotImplementedError):
        collider_from_jax(jb.SignedDistanceCollider(np.ones((8, 8, 8)), 1.0 / 8))


def _pallas_colliders():
    """The colliders of tests/test_pallas_grid.py:92-99."""
    return (
        jb.HalfSpace((0.0, 0.3, 0.0), (0.1, 1.0, 0.0), kind="slip", friction=0.3),
        jb.Sphere((0.5, 0.5, 0.5), 0.2, kind="separate", friction=0.1,
                  motion=jb.RigidMotion(trans_vel=(0.05, 0.0, 0.0),
                                        omega=(0.0, 1.5, 0.0))),
        jb.Box((0.6, 0.1, 0.6), (0.9, 0.4, 0.9), kind="sticky"),
    )


def test_grid_update_with_colliders_matches_jax():
    jcfg, cfg = configs(domain_bits=6, max_active_blocks=192)
    keys, pool = _random_pool(cfg, n_active=150, seed=4)
    part, jpart = _partitions(cfg, keys)
    jcols = _pallas_colliders()
    cols = tuple(collider_from_jax(c) for c in jcols)
    dt, t = np.float32(3e-4), np.float32(0.37)
    pv, mx = grid.grid_update(cfg, torch.from_numpy(pool), part, torch.tensor(dt),
                              cols, torch.tensor(t))
    pv, mx = pv.numpy(), float(mx)
    rp, rm = grid_update_pallas(jcfg, jnp.asarray(pool), jpart, jnp.float32(dt),
                                colliders=jcols, collider_time=jnp.float32(t),
                                interpret=True)
    rp = np.asarray(rp)
    np.testing.assert_array_equal(pv[:, 0:4], rp[:, 0:4])
    # the JAX package's own bound between its kernel and its oracle
    np.testing.assert_allclose(pv[:, 4:16], rp[:, 4:16], rtol=1e-4, atol=1e-7)
    assert abs(mx - float(rm)) <= 1e-6 * max(1.0, abs(float(rm)))
    # the colliders changed something
    plain, _ = grid.grid_update(cfg, torch.from_numpy(pool), part, torch.tensor(dt))
    assert not np.array_equal(plain.numpy(), pv)


def test_grid_update_collider_time_defaults_to_zero():
    _, cfg = configs(domain_bits=5, max_active_blocks=96)
    keys, pool = _random_pool(cfg, n_active=60, seed=2)
    part, _ = _partitions(cfg, keys)
    cols = tuple(collider_from_jax(c) for c in _pallas_colliders())
    dt = torch.tensor(3e-4)
    a = grid_kernel.grid_update(cfg, torch.from_numpy(pool), part, dt, cols)
    b = grid.grid_update(cfg, torch.from_numpy(pool), part, dt, cols,
                         torch.zeros(()))
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])


def test_sdf_collider_raises():
    import claymore_tpu_torch as ct

    with pytest.raises(NotImplementedError):
        tb.SignedDistanceCollider(np.ones((8, 8, 8)), 1.0 / 8)
    _, cfg = configs(domain_bits=5, max_active_blocks=64)
    with pytest.raises(NotImplementedError):
        ct.MPMEngine(cfg, [ct.FixedCorotated()], colliders=(object(),), device="cpu")
    with pytest.raises(NotImplementedError):
        grid_kernel.pack_colliders((object(),), "cpu")


def test_pack_colliders_layout():
    cols = tuple(collider_from_jax(c) for c in _pallas_colliders())
    table = grid_kernel.pack_colliders(cols, "cpu").numpy()
    assert table.shape == (3, 24) and table.dtype == np.int32
    f = table.view(np.float32)
    assert list(table[:, 0]) == [0, 1, 2] and list(table[:, 1]) == [1, 2, 0]
    assert list(table[:, 2]) == [0, 1, 0]                   # only the sphere rotates
    np.testing.assert_array_equal(f[0, 11:14], np.float32(cols[0].normal))
    assert f[1, 7] == np.float32(0.2) and f[1, 4] == np.float32(0.1)
    np.testing.assert_array_equal(f[1, 20:23], np.float32((0.0, 1.5, 0.0)))
    np.testing.assert_array_equal(f[2, 8:11], np.float32((0.75, 0.25, 0.75)))
    np.testing.assert_array_equal(f[2, 11:14], np.float32((0.15, 0.15, 0.15)))
