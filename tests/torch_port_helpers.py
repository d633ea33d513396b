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
