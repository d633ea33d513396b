"""Shared helpers for the PyTorch port's tests (tests/test_torch_*.py).

The suite runs under several pytest workers, so torch is held to one
thread per process.  JAX and the port exchange data only as numpy arrays.
"""

import dataclasses

import numpy as np
import torch

torch.set_num_threads(1)

CPU = torch.device("cpu")


def configs(**kw):
    """The same configuration in both packages: (jax_cfg, port_cfg).

    The JAX side is pinned to exact float32 transfers, the only setting
    the port reproduces."""
    import claymore_tpu as cmt
    from claymore_tpu_torch.interop import config_from_jax

    jcfg = cmt.SimConfig(mxu_precision="highest", g2p_arena_dtype="float32",
                         g2p_dot_precision="highest", **kw)
    return jcfg, config_from_jax(dataclasses.asdict(jcfg))


def fixed_corotated_pair(jcfg, e=1e4, nu=0.3):
    import claymore_tpu as cmt
    from claymore_tpu_torch.interop import material_from_jax

    jmat = cmt.FixedCorotated(volume=jcfg.default_volume(), e=e, nu=nu)
    return jmat, material_from_jax(jmat.name, dataclasses.asdict(jmat))


def material_pair(jcfg, name):
    """The JAX material ``name`` at bench-like parameters and its port."""
    import claymore_tpu as cmt
    from claymore_tpu_torch.interop import material_from_jax

    vol = jcfg.default_volume()
    jmat = {
        "fixed_corotated": lambda: cmt.FixedCorotated(volume=vol, e=1e4, nu=0.3),
        "jfluid": lambda: cmt.JFluid(volume=vol),
        "sand": lambda: cmt.Sand(volume=vol, e=1e4, rho=1500.0),
        "nacc": lambda: cmt.NACC(volume=vol, e=1e4),
    }[name]()
    return jmat, material_from_jax(jmat.name, dataclasses.asdict(jmat))


def jax_state(np_state):
    """The port's ``state_to_numpy`` output -> a JAX SimState."""
    import jax.numpy as jnp
    from claymore_tpu.core import types as jt

    a = jnp.asarray
    p = np_state.partition
    models = tuple(
        jt.ParticleModel(
            pos=a(m.pos), fields={k: a(v) for k, v in m.fields.items()},
            active=a(m.active), pid=a(m.pid),
            tiles=jt.TileMap(*(a(x) for x in m.tiles)))
        for m in np_state.models)
    return jt.SimState(
        grid=a(np_state.grid), partition=jt.Partition(*(a(x) for x in p)),
        models=models,
        **{k: a(getattr(np_state, k)) for k in
           ("dt", "max_vel", "t", "step", "mig_dropped", "halo_overflow")})


def to_np(x):
    if hasattr(x, "detach"):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def by_pid(model):
    """{pid: slot} for the active slots of a model of either package."""
    act = to_np(model.active)
    pid = to_np(model.pid)
    return dict(zip(pid[act].tolist(), np.flatnonzero(act).tolist()))


def pid_matched(model_a, model_b, field):
    """Arrays [C, N] of ``field`` from both models, rows paired by pid."""
    ia, ib = by_pid(model_a), by_pid(model_b)
    assert set(ia) == set(ib), "active particle sets differ"
    keys = sorted(ia)
    sa = np.asarray([ia[k] for k in keys], np.int64)
    sb = np.asarray([ib[k] for k in keys], np.int64)

    def get(m):
        return to_np(m.pos if field == "pos" else m.fields[field])

    return get(model_a)[..., sa], get(model_b)[..., sb]


HALO_CASES = ("plain", "overflow", "empty_shard", "sparse", "mig_overflow")


def halo_case(case: str, mesh_shape, nan: bool = False, slots: int = 2500):
    """Seeded numpy inputs of the halo and migration packs on a mesh of
    ``mesh_shape`` at domain_bits 6 (16 blocks an axis, 512 oct keys, 160
    pool rows a shard): a dict with ``cfg_kw``, ``h`` (halo capacity), ``k``
    (migration capacity), ``margin`` and per shard ``pool`` f32[161, 16,
    128], ``keys`` i32[160], ``count``; ``pool2`` and ``table2`` (a receiver's
    rebuilt pool and its table of 100 octs); ``pos`` f32[3, slots] (the
    shard's slab widened by 6 cells a side, so some particles cross),
    ``active``, ``pid``, ``F`` f32[9, slots].

    Pool rows: normal (negative momentum), each block's mass lanes (channels
    0-3) zeroed or set to -0.0 with probability 0.4 (a -0.0 block has no
    mass), rows past the count and the null row dirty; ``nan`` puts NaN in
    a few mass lanes.  Cases: ``overflow`` (a halo capacity of 6, below most
    windows' octs), ``empty_shard`` (shard 0 holds no oct and no particle),
    ``sparse`` (4 octs a shard: most windows hold none), ``mig_overflow``
    (a migration capacity of 16, below the crossers)."""
    rng = np.random.default_rng(0)
    n = int(np.prod(mesh_shape))
    nb, no = 160, 512
    out = {"cfg_kw": dict(domain_bits=6, max_active_blocks=nb), "margin": 1,
           "h": 6 if case == "overflow" else 128, "k": 16 if case == "mig_overflow" else 4096,
           "pool": [], "keys": [], "count": [], "pool2": [], "table2": [], "pos": [],
           "active": [], "pid": [], "F": []}
    for j in range(n):
        count = 0 if case == "empty_shard" and j == 0 else 4 if case == "sparse" else 120
        keys = np.full(nb, no, np.int32)
        keys[:count] = np.sort(rng.choice(no, size=count, replace=False))
        keys[count:count + 3] = rng.choice(no, size=3)        # past the count: not live
        pool = rng.normal(size=(nb + 1, 16, 128)).astype(np.float32)
        blocks = pool[:, 0:4].reshape(nb + 1, 4, 8, 16)
        u = rng.uniform(size=(nb + 1, 8))
        blocks[np.broadcast_to((u < 0.2)[:, None, :, None], blocks.shape)] = 0.0
        blocks[np.broadcast_to(((u >= 0.2) & (u < 0.4))[:, None, :, None],
                               blocks.shape)] = -0.0
        pool[:, 0:4] = blocks.reshape(nb + 1, 4, 128)
        if nan:
            pool[rng.integers(0, nb + 1, size=5), rng.integers(0, 4, size=5),
                 rng.integers(0, 128, size=5)] = np.nan
        held = np.sort(rng.choice(no, size=100, replace=False))
        table2 = np.full(no + 1, nb, np.int32)
        table2[held] = np.arange(100, dtype=np.int32)
        pool2 = rng.normal(size=(nb + 1, 16, 128)).astype(np.float32)
        pool2[rng.uniform(size=nb + 1) < 0.3, 0:4] = -0.0
        out["pool"].append(pool)
        out["keys"].append(keys)
        out["count"].append(count)
        out["pool2"].append(pool2)
        out["table2"].append(table2)
        # particles: the shard's slab along each decomposed axis (x, then z)
        # widened by 6 cells (1.5 blocks) a side
        coord = np.unravel_index(j, mesh_shape)
        lo, hi = np.zeros(3), np.ones(3)
        for a, (dim, ext) in enumerate(zip((0, 2), mesh_shape)):
            lo[dim] = max(coord[a] / ext - 6 / 64, 0.02)
            hi[dim] = min((coord[a] + 1) / ext + 6 / 64, 0.98)
        lo, hi = np.maximum(lo, 0.02), np.minimum(hi, 0.98)
        pos = rng.uniform(lo[:, None], hi[:, None], size=(3, slots)).astype(np.float32)
        active = rng.uniform(size=slots) < (0.0 if case == "empty_shard" and j == 0 else 0.7)
        out["pos"].append(pos)
        out["active"].append(active)
        out["pid"].append((np.arange(slots) + j * slots).astype(np.int32))
        out["F"].append(rng.normal(size=(9, slots)).astype(np.float32))
    return out
