"""The port's SDF-grid collider and SDF assets against the JAX package:
``sdf_and_normal``, the grid update with static, animated and mixed
collider lists (the JAX Pallas kernel's float32 cache and its XLA path),
an engine run with an SDF sphere, ``io/sdf.py``, ``io/meshsdf.py`` and the
reference's ``_sdf.bin`` asset."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import claymore_tpu as cmt
import claymore_tpu_torch as ct
from claymore_tpu.core import grid as jgrid
from claymore_tpu.io import meshsdf as jmeshsdf
from claymore_tpu.io import sdf as jsdf
from claymore_tpu.models import boundary as jb
from claymore_tpu.ops.pallas_grid import grid_update_pallas
from claymore_tpu_torch.core import grid
from claymore_tpu_torch.interop import collider_from_jax
from claymore_tpu_torch.io import meshsdf, sdf
from claymore_tpu_torch.io.sampler import sample_uniform_box_world
from claymore_tpu_torch.models import boundary as tb

from tests.test_torch_grid import _partitions, _random_pool
from tests.torch_port_helpers import CPU, configs, material_pair, pid_matched


def _sphere_sdf_grid(n, dx, center, radius, shape=None):
    """The node grid of tests/test_pallas_grid.py:122 (optionally not cubic)."""
    shape = shape or (n, n, n)
    ax = [(np.arange(m) * dx).astype(np.float32) for m in shape]
    x, y, z = np.meshgrid(*ax, indexing="ij")
    return (np.sqrt((x - center[0]) ** 2 + (y - center[1]) ** 2
                    + (z - center[2]) ** 2) - radius).astype(np.float32)


def _cube_obj(path, lo=0.3, hi=0.7):
    """A closed unit-normal cube as a Wavefront .obj (quads, one negative
    index face) to exercise read_obj's fan and index rules."""
    v = [(x, y, z) for x in (lo, hi) for y in (lo, hi) for z in (lo, hi)]
    faces = [(1, 3, 4, 2), (5, 6, 8, 7), (1, 2, 6, 5), (3, 7, 8, 4),
             (1, 5, 7, 3), (2, 4, 8, 6)]
    with open(path, "w") as f:
        for p in v:
            f.write("v %r %r %r\n" % p)
        for fc in faces[:-1]:
            f.write("f " + " ".join(f"{i}/{i}" for i in fc) + "\n")
        f.write("f " + " ".join(str(i - 9) for i in faces[-1]) + "\n")


_SHAPES = {"cubic": (32, 32, 32), "oblong": (32, 20, 26)}


@pytest.mark.parametrize("shape", sorted(_SHAPES))
def test_sdf_and_normal_matches_jax(shape):
    dx = 1.0 / 32
    vals = _sphere_sdf_grid(32, dx, (0.5, 0.45, 0.4), 0.22, _SHAPES[shape])
    jcol = jb.SignedDistanceCollider(vals, dx, kind="slip", bound_cells=3)
    col = collider_from_jax(jcol)
    rng = np.random.default_rng(5)
    x = rng.uniform(-0.05, 1.05, size=(3, 4096)).astype(np.float32)
    # the band edges, and nodes, exactly
    lo, hi = np.float32(3 * dx), np.float32((32 - 3) * dx)
    x[:, :6] = np.array([[lo, lo, lo], [hi, 0.5, 0.5], [0.5, hi, 0.5],
                         [np.nextafter(hi, 0, dtype=np.float32), 0.5, 0.5],
                         [np.nextafter(lo, 0, dtype=np.float32), 0.5, 0.5],
                         [0.5, 0.5, 0.5]], np.float32).T
    rsd, rn = jcol.sdf_and_normal(jnp.asarray(x)[:, :, None])
    sd, n = col.sdf_and_normal_soa(tuple(torch.from_numpy(c) for c in x))
    rsd, rn = np.asarray(rsd)[:, 0], np.asarray(rn)[:, :, 0]
    # inside, outside the shape, and outside the band (sd = 1) all occur
    assert (rsd <= 0).sum() > 50 and (rsd == 1.0).sum() > 50
    np.testing.assert_allclose(sd.numpy(), rsd, rtol=0, atol=1e-6)
    np.testing.assert_allclose(torch.stack(n).numpy(), rn, rtol=0, atol=1e-6)


def test_values_gradients_and_node_table():
    vals = _sphere_sdf_grid(16, 1.0 / 16, (0.5, 0.5, 0.5), 0.3)
    col, jcol = tb.SignedDistanceCollider(vals, 1.0 / 16), jb.SignedDistanceCollider(vals, 1.0 / 16)
    assert col.grads.dtype == np.float32
    np.testing.assert_array_equal(col.grads, np.asarray(jcol.grads))
    np.testing.assert_array_equal(col.values, np.asarray(jcol.values))
    tab = col.table("cpu")
    assert tab.shape == (16, 16, 16, 4) and tab.dtype == torch.float32
    np.testing.assert_array_equal(tab[..., 0].numpy(), vals)
    np.testing.assert_array_equal(tab[..., 1:].numpy(), np.moveaxis(col.grads, 0, -1))
    assert col.table(torch.device("cpu")) is tab          # uploaded once
    with pytest.raises(ValueError):
        tb.SignedDistanceCollider(np.ones((1, 4, 4)), 0.1)


@pytest.mark.parametrize("kind,friction", [("sticky", 0.0), ("slip", 0.2),
                                           ("separate", 0.2), ("separate", 0.0)])
def test_grid_update_static_sdf_matches_pallas_cache(kind, friction):
    """The JAX kernel's f32 per-cell cache (tests/test_pallas_grid.py:129),
    with a constant offset baked in."""
    jcfg, cfg = configs(domain_bits=6, max_active_blocks=192)
    keys, pool = _random_pool(cfg, n_active=150, seed=7)
    part, jpart = _partitions(cfg, keys)
    vals = _sphere_sdf_grid(32, 1.0 / 32, (0.5, 0.45, 0.5), 0.22)
    jcol = jb.SignedDistanceCollider(vals, 1.0 / 32, kind=kind, friction=friction,
                                     motion=jb.RigidMotion(trans=(0.02, -0.03, 0.0)))
    assert jcol.oct_cache_ok(jcfg)
    jcol.build_oct_cache(jcfg, dtype=jnp.float32)
    col = collider_from_jax(jcol)
    dt = np.float32(3e-4)
    pv, mx = grid.grid_update(cfg, torch.from_numpy(pool), part, torch.tensor(dt),
                              (col,), torch.zeros(()))
    rp, rm = grid_update_pallas(jcfg, jnp.asarray(pool), jpart, jnp.float32(dt),
                                colliders=(jcol,), interpret=True)
    pv, rp = pv.numpy(), np.asarray(rp)
    np.testing.assert_array_equal(pv[:, 0:4], rp[:, 0:4])
    np.testing.assert_allclose(pv[:, 4:16], rp[:, 4:16], rtol=1e-4, atol=1e-7)
    assert abs(float(mx) - float(rm)) <= 1e-6 * max(1.0, abs(float(rm)))
    free, _ = grid.grid_update(cfg, torch.from_numpy(pool), part, torch.tensor(dt))
    assert int((free.numpy() != pv).sum()) > 100          # the collider acted


def _xla_check(jcfg, cfg, jcols, t=0.37, seed=4):
    keys, pool = _random_pool(cfg, n_active=150, seed=seed)
    part, jpart = _partitions(cfg, keys)
    cols = tuple(collider_from_jax(c) for c in jcols)
    dt = np.float32(3e-4)
    pv, mx = grid.grid_update(cfg, torch.from_numpy(pool), part, torch.tensor(dt),
                              cols, torch.tensor(np.float32(t)))
    rp, rm = jgrid.grid_update(jcfg, jnp.asarray(pool), jpart, jnp.float32(dt),
                               jcols, jnp.float32(t))
    pv, rp = pv.numpy(), np.asarray(rp)
    np.testing.assert_array_equal(pv[:, 0:4], rp[:, 0:4])
    np.testing.assert_allclose(pv[:, 4:16], rp[:, 4:16], rtol=1e-4, atol=1e-7)
    assert abs(float(mx) - float(rm)) <= 1e-6 * max(1.0, abs(float(rm)))
    return pool, part, pv


_ANIMATED = {
    "rotating": jb.RigidMotion(trans=(0.01, 0.0, -0.02), trans_vel=(0.05, 0.0, 0.1),
                               omega=(0.3, 1.5, -0.7)),
    "scaling": jb.RigidMotion(trans_vel=(0.0, -0.1, 0.0), scale=1.2, dsdt=0.4),
}


@pytest.mark.parametrize("motion", sorted(_ANIMATED))
def test_grid_update_animated_sdf_matches_xla(motion):
    jcfg, cfg = configs(domain_bits=6, max_active_blocks=192)
    vals = _sphere_sdf_grid(32, 1.0 / 32, (0.5, 0.5, 0.45), 0.24, (32, 30, 28))
    jcol = jb.SignedDistanceCollider(vals, 1.0 / 32, kind="separate", friction=0.3,
                                     motion=_ANIMATED[motion], bound_cells=2)
    assert not jcol.motion.is_static and not collider_from_jax(jcol).motion.is_static
    pool, part, pv = _xla_check(jcfg, cfg, (jcol,))
    free, _ = grid.grid_update(cfg, torch.from_numpy(pool), part, torch.tensor(3e-4))
    assert int((free.numpy() != pv).sum()) > 100


def test_grid_update_mixed_colliders_follow_list_order():
    """Analytic and SDF colliders interleaved, held against the XLA path,
    which resolves the list in order (the Pallas kernel would run the
    analytic ones first)."""
    jcfg, cfg = configs(domain_bits=6, max_active_blocks=192)
    vals = _sphere_sdf_grid(32, 1.0 / 32, (0.45, 0.5, 0.5), 0.2)
    jcols = (
        jb.Sphere((0.55, 0.5, 0.5), 0.18, kind="slip", friction=0.2),
        jb.SignedDistanceCollider(vals, 1.0 / 32, kind="separate", friction=0.1,
                                  motion=jb.RigidMotion(trans_vel=(0.05, 0, 0))),
        jb.HalfSpace((0.0, 0.35, 0.0), (0.1, 1.0, 0.0), kind="sticky"),
        jb.SignedDistanceCollider(vals, 1.0 / 32, kind="slip"),
    )
    _, _, fwd = _xla_check(jcfg, cfg, jcols)
    _, _, back = _xla_check(jcfg, cfg, jcols[::-1])
    assert not np.array_equal(fwd, back)                  # the order matters


def test_sdf_engine_matches_jax():
    """The set-up of tests/test_pallas_grid.py:163: a JFluid box falling on
    a static slip SDF sphere, both engines, particles paired by id."""
    jcfg, cfg = configs(domain_bits=5, max_active_blocks=256, default_dt=5e-4)
    jmat, mat = material_pair(jcfg, "jfluid")
    pos = sample_uniform_box_world(cfg.dx, [0.45] * 3, [0.58] * 3, cfg.ppc)
    vals = _sphere_sdf_grid(16, 1.0 / 16, (0.5, 0.35, 0.5), 0.18)
    jcol = jb.SignedDistanceCollider(vals, 1.0 / 16, kind="slip", friction=0.1,
                                     bound_cells=1)
    jeng = cmt.MPMEngine(jcfg, [jmat], colliders=(jcol,), tile_chunk=4)
    eng = ct.MPMEngine(cfg, [mat], colliders=(collider_from_jax(jcol),), tile_chunk=4,
                       device=CPU)
    v0 = [(0.2, -0.4, 0.1)]
    js, s = jeng.init_state([pos], v0), eng.init_state([pos], v0)
    s0 = s
    for _ in range(4):
        js = jeng.substep(js, jnp.float32(1.0))
        s = eng.substep(s, 1.0)
    a, b = pid_matched(s.models[0], js.models[0], "pos")
    assert np.max(np.abs(a - b)) < 1e-6
    d = eng.diagnostics(s)
    expected = pos.shape[0] * mat.mass
    assert abs(d["grid_mass"] - expected) / expected < 1e-5
    assert d["null_block_mass"] == 0.0 and d["block_overflow"] == 0
    assert d["model0_active"] == pos.shape[0] and d["model0_dropped_tiles"] == 0
    a0, a1 = pid_matched(s0.models[0], s.models[0], "pos")
    assert np.max(np.abs(a1 - a0)) > 0
    # the sphere changes the grid velocities where the box meets it
    pv, _ = grid.grid_update(cfg, s.grid, s.partition, s.dt, eng.colliders, s.t)
    free, _ = grid.grid_update(cfg, s.grid, s.partition, s.dt)
    assert bool((pv != free).any())


def test_sdf_file_round_trip_and_uniform_sampling_match_jax(tmp_path):
    n, dx = 24, 1.0 / 24
    vals = _sphere_sdf_grid(n, dx, (0.5, 0.5, 0.5), 0.3, (24, 20, 16)).astype(np.float64)
    path = str(tmp_path / "ball.sdf")
    sdf.write_sdf_file(path, vals, (0.1, -0.2, 0.3), dx)
    jpath = str(tmp_path / "jball.sdf")
    jsdf.write_sdf_file(jpath, vals, (0.1, -0.2, 0.3), dx)
    assert open(path).read() == open(jpath).read()
    got, ref = sdf.read_sdf_file(path), jsdf.read_sdf_file(path)
    np.testing.assert_array_equal(got[0], ref[0])
    np.testing.assert_array_equal(got[1], ref[1])
    assert got[2] == ref[2] and got[0].shape == (24, 20, 16)
    assert np.max(np.abs(got[0] - vals)) < 1e-7
    kw = dict(ppc=8.0, domain_dx=1.0 / 64, offset=(0.2, 0.25, 0.3), span=(0.4, 0.35, 0.3))
    pts = sdf.read_sdf(path, **kw)
    np.testing.assert_array_equal(pts, jsdf.read_sdf(path, **kw))
    assert pts.dtype == np.float32 and pts.shape[0] > 1000
    # "poisson" is ported (tests/test_torch_sampler.py holds it to the JAX
    # package); an unknown mode raises
    with pytest.raises(ValueError):
        sdf.sample_sdf(vals, dx, 8.0, 1.0 / 64, (0, 0, 0), (1, 1, 1), mode="blue")


def test_mesh_to_sdf_matches_jax(tmp_path):
    obj = str(tmp_path / "cube.obj")
    _cube_obj(obj)
    verts, tris = meshsdf.read_obj(obj)
    jverts, jtris = jmeshsdf.read_obj(obj)
    np.testing.assert_array_equal(verts, jverts)
    np.testing.assert_array_equal(tris, jtris)
    assert tris.shape == (12, 3)
    sd, origin, d = meshsdf.mesh_to_sdf(verts, tris, 0.05)
    jsd, jorigin, jd = jmeshsdf.mesh_to_sdf(jverts, jtris, 0.05)
    np.testing.assert_array_equal(sd, jsd)
    np.testing.assert_array_equal(origin, jorigin)
    assert d == jd
    # inside is negative, and the file the port writes is the JAX one's
    assert sd[sd.shape[0] // 2, sd.shape[1] // 2, sd.shape[2] // 2] < 0
    meshsdf.obj_to_sdf_file(obj, str(tmp_path / "a.sdf"), 0.05)
    jmeshsdf.obj_to_sdf_file(obj, str(tmp_path / "b.sdf"), 0.05)
    assert open(tmp_path / "a.sdf").read() == open(tmp_path / "b.sdf").read()


def test_from_claymore_files_matches_jax(tmp_path):
    rng = np.random.default_rng(3)
    res = (10, 12, 14)
    sdf_vals = rng.normal(size=res).astype(np.float32)
    grads = rng.normal(size=(3,) + res).astype(np.float32)
    prefix = str(tmp_path / "dragon")
    sdf_vals.reshape(-1).tofile(prefix + "_sdf.bin")
    for c in range(3):
        grads[c].reshape(-1).tofile(f"{prefix}_grad_{c}.bin")
    motion = tb.RigidMotion(trans=(0.1, 0.0, 0.0), omega=(0.0, 0.5, 0.0))
    col = tb.SignedDistanceCollider.from_claymore_files(
        prefix, res, 0.05, kind="slip", friction=0.2, motion=motion, bound_cells=2)
    jcol = jb.SignedDistanceCollider.from_claymore_files(
        prefix, res, 0.05, kind="slip", friction=0.2,
        motion=jb.RigidMotion(**dataclasses.asdict(motion)), bound_cells=2)
    np.testing.assert_array_equal(col.values, np.asarray(jcol.values))
    np.testing.assert_array_equal(col.grads, np.asarray(jcol.grads))
    assert (col.dx, col.bound_cells, col.kind, col.friction) == \
        (jcol.dx, jcol.bound_cells, jcol.kind, jcol.friction)
    with pytest.raises(ValueError):
        tb.SignedDistanceCollider.from_claymore_files(prefix, (10, 12, 15), 0.05)
