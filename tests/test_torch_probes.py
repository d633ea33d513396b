"""The probes P1-P6 of the port against the TPU scripts' Pallas probes.

``scripts/prof_laneops.py`` and ``scripts/prof_dma.py`` are imported by
file path and their kernels run on the CPU in interpret mode
(``pl.pallas_call`` patched to ``interpret=True`` for the test); the port's
wrappers run their plain PyTorch versions on CPU tensors.  Every comparison
is exact: the probes move values, and the pools of the small cases hold
integers whose sums stay below 2**24.
"""

import importlib.util
import json
import os
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from claymore_tpu_torch.ops import probe_kernels as pk
from tests.torch_port_helpers import to_np

ROOT = Path(__file__).resolve().parents[1]
LANE_PROBES = {   # port name: (TPU script function, lanes of its input rows)
    "dyn_roll": ("dyn_roll", 128),
    "dyn_lane_read": ("dyn_lane_read", 128),
    "dyn_lane_read_wide": ("dyn_lane_read_wide", 384),
    "dyn_lane_write": ("dyn_lane_write", 128),
}
LABELS = {"dyn_roll": "dynamic roll (traced shift)",
          "dyn_lane_read": "dynamic lane ds read [16,128]->32",
          "dyn_lane_read_wide": "dynamic lane ds read [16,384]->32",
          "dyn_lane_write": "dynamic lane ds write/accum"}


@pytest.fixture(scope="module")
def scripts():
    """The two TPU scripts as modules; they set compilation-cache variables
    for the TPU on import, which are taken back."""
    env = dict(os.environ)
    mods = {}
    for name in ("prof_laneops", "prof_dma"):
        spec = importlib.util.spec_from_file_location(f"tpu_{name}",
                                                      ROOT / "scripts" / f"{name}.py")
        mods[name] = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mods[name])
    os.environ.clear()
    os.environ.update(env)
    return mods


@pytest.fixture
def made(monkeypatch):
    """``pl.pallas_call`` in interpret mode; the list of the callables it
    returned, newest last."""
    calls = []
    orig = pl.pallas_call

    def interpret(*args, **kwargs):
        fn = orig(*args, interpret=True, **kwargs)
        calls.append(fn)
        return fn

    monkeypatch.setattr(pl, "pallas_call", interpret)
    return calls


def _script_input(lanes):
    x = torch.arange(16 * lanes, dtype=torch.float32).reshape(1, 16, lanes)
    return x, torch.tensor([48], dtype=torch.int32)


@pytest.mark.parametrize("name", sorted(LANE_PROBES))
def test_lane_probe_matches_jax(scripts, made, capsys, name):
    """The TPU probe on its own tile and shift 48 against the port's
    wrapper (its plain version here), and the scripts' printed lines."""
    fn, lanes = LANE_PROBES[name]
    mod = scripts["prof_laneops"]
    want = np.asarray(getattr(mod, fn)())
    x, s = _script_input(lanes)
    got = to_np(getattr(pk, name)(x, s))
    assert got.shape == (1,) + want.shape
    np.testing.assert_array_equal(got[0], want)

    capsys.readouterr()
    mod.probe(LABELS[name], getattr(mod, fn))
    jax_line = capsys.readouterr().out.strip()
    assert jax_line == f"{LABELS[name]}: OK   sum={float(got.astype(np.float64).sum()):.1f}"


def _numpy_probe(name, x, s):
    if name == "dyn_roll":
        return np.roll(x, -s, axis=1)
    if name == "dyn_lane_read":
        return x[:, s:s + 32]
    if name == "dyn_lane_read_wide":
        return x[:, s + 112:s + 144]
    o = np.zeros((16, 128), np.float32)
    o[:, s:s + 32] = x[:, :32] * np.float32(2.0)
    o[:, s + 32:s + 48] += x[:, :16]
    return o


@pytest.mark.parametrize("name", sorted(LANE_PROBES))
def test_lane_probe_on_many_tiles(name):
    """G tiles with a shift each against a numpy loop over the tiles; P1
    takes any shift (mod 128), the others raise outside their window."""
    lanes = LANE_PROBES[name][1]
    rng = np.random.default_rng(5)
    g = 7
    x = rng.standard_normal((g, 16, lanes)).astype(np.float32)
    hi = 300 if name == "dyn_roll" else pk.MAX_SHIFT[name]
    s = rng.integers(-hi if name == "dyn_roll" else 0, hi + 1, size=g).astype(np.int32)
    s[0] = hi
    got = to_np(getattr(pk, name)(torch.from_numpy(x), torch.from_numpy(s)))
    want = np.stack([_numpy_probe(name, x[i], int(s[i])) for i in range(g)])
    np.testing.assert_array_equal(got, want)
    if name != "dyn_roll":
        for bad in (-1, hi + 1):
            with pytest.raises(ValueError):
                getattr(pk, name)(torch.from_numpy(x[:1]),
                                  torch.tensor([bad], dtype=torch.int32))


@pytest.mark.parametrize("double_buffer", [False, True])
def test_dma_gather_matches_jax(scripts, made, double_buffer):
    """P5 at (O, G, D, R) = (64, 4, 2, 3): the TPU kernel that
    ``dma_gather_bench`` built, called on the script's pool and starts,
    against the port's wrapper, both variants."""
    o, g, d, r = 64, 4, 2, 3
    scripts["prof_dma"].dma_gather_bench(o, g, d, r, double_buffer=double_buffer)
    pool = np.arange(o * 16 * 128, dtype=np.float32).reshape(o, 16, 128)
    idx = np.random.default_rng(0).integers(0, o - r, size=(g * d,)).astype(np.int32)
    want = np.asarray(made[-1](jnp.asarray(idx), jnp.asarray(pool)))
    tp, ti = torch.from_numpy(pool), torch.from_numpy(idx).view(g, d)
    for ring in (False, True):
        np.testing.assert_array_equal(to_np(pk.dma_gather(tp, ti, r, ring=ring)), want)
    loop = sum(pool[i:i + r].sum(axis=0) for i in idx[:d])
    np.testing.assert_array_equal(want[0], loop)


def test_rmw_matches_jax(scripts, made):
    """P6 at (64, 4, 2, 3): the TPU kernel ``rmw_bench`` built against the
    port's wrapper on the script's starts (overlapping runs): the pool
    after the adds, and ``out[:, 0]`` (the TPU kernel writes only that)."""
    o, g, d, r = 64, 4, 2, 3
    scripts["prof_dma"].rmw_bench(o, g, d, r)
    idx = np.random.default_rng(0).permutation(o - r)[: g * d].astype(np.int32)
    jpool, jout = made[-1](jnp.asarray(idx), jnp.zeros((o, 16, 128), jnp.float32))
    pool = torch.zeros((o, 16, 128))
    out = pk.rmw(pool, torch.from_numpy(idx).view(g, d), r)
    np.testing.assert_array_equal(to_np(pool), np.asarray(jpool))
    np.testing.assert_array_equal(to_np(out[:, 0]), np.asarray(jout)[:, 0])
    assert float(out[:, 1:].abs().sum()) == 0.0


def test_rmw_overlapping_runs_count_every_run():
    """P6 on runs that overlap, within a program and across programs: each
    row gains one per program whose runs cover it, as the TPU's sequential
    grid adds them (a program reads all its runs before it writes any, so
    two of its runs that share a row add 1 once); starts outside the pool
    raise."""
    rng = np.random.default_rng(2)
    o, g, d, r = 40, 6, 3, 4
    idx = rng.integers(0, o - r + 1, size=(g, d)).astype(np.int32)
    pool = rng.integers(0, 50, size=(o, 16, 128)).astype(np.float32)
    want = pool.copy()
    for starts in idx:
        covered = np.zeros(o, bool)
        for start in starts:
            covered[start:start + r] = True
        want[covered] += 1.0
    got = torch.from_numpy(pool.copy())
    pk.rmw(got, torch.from_numpy(idx), r)
    np.testing.assert_array_equal(to_np(got), want)
    for fn in (lambda p, i: pk.rmw(p, i, r), lambda p, i: pk.dma_gather(p, i, r)):
        with pytest.raises(ValueError):
            fn(torch.zeros((o, 16, 128)), torch.tensor([[o - r + 1]], dtype=torch.int32))


ENTRY_ARGS = {
    "prof_laneops": ["--tiles", "8"],
    "prof_dma": ["--rows", "256", "--scale", "256"],
    "prof_stages25m": ["--domain-bits", "5", "--radius", "0.08", "--max-blocks", "256",
                       "--iters", "1", "--reps", "1"],
}


@pytest.mark.parametrize("module", sorted(ENTRY_ARGS))
def test_entry_point_runs_on_cpu(capsys, module):
    """The three profiling entry points at a small size with ``--device
    cpu``: exit 0 and print what the TPU scripts print."""
    import importlib

    mod = importlib.import_module(f"claymore_tpu_torch.scripts.{module}")
    assert mod.main(["--device", "cpu", *ENTRY_ARGS[module]]) == 0
    out = capsys.readouterr().out
    if module == "prof_laneops":
        assert out.count(": OK   sum=") == 4 and out.count(" G=8: ") == 4
    elif module == "prof_dma":
        assert out.count("== ") == 7 and sum(" ms " in ln for ln in out.splitlines()) == 23
    else:
        assert "PROF25M stages {" in out and "particle_stream_floor_ms" in out
    if module != "prof_stages25m":
        # the last line counts the kernel launches: none on the CPU
        last = out.strip().splitlines()[-1]
        assert last.startswith("launches ")
        assert json.loads(last.split(" ", 1)[1]) == {k: 0 for k in pk.launches}


@pytest.mark.parametrize("module", sorted(ENTRY_ARGS))
def test_entry_point_refuses_missing_card(capsys, module):
    """``--device cuda``, the default, exits 2 where there is no card."""
    import importlib

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    mod = importlib.import_module(f"claymore_tpu_torch.scripts.{module}")
    assert mod.main([]) == 2
