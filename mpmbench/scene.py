"""Configurations, cells and the inputs both sides are given.

A configuration is ``configs/<name>.json`` (the scene: grid, materials,
shapes, initial velocities, capacities, the guarantees, what was assumed);
a cell is ``workloads/<name>.json`` (its configuration, the traffic: how
the scene is stepped, episode length, what the check compares and its
limits).  ``make_inputs`` turns a configuration and a seed into the
particles of every model: the configuration's lattice of ``ppc`` points a
cell (the arithmetic of the source's sampler, copied below), each point
moved by a seeded uniform offset inside its own lattice spacing (times
``inputs.jitter``, 1 in every configuration), and a
seeded pre-strain of the deformation field (F = I + e U(-1, 1) per
component, or J = 1 + e U(-1, 1)), so that the material's stress acts from
the first substep.  The same seed gives the same inputs, on the same kind
of device.  Nothing here imports the program.
"""

from __future__ import annotations

import json
from pathlib import Path

import numpy as np
import torch

HERE = Path(__file__).resolve().parent
CONFIGS = HERE / "configs"
WORKLOADS = HERE / "workloads"

# the deformation field of each material: (name in the program's state,
# floats a particle)
FIELDS = {"FixedCorotated": ("F", 9), "JFluid": ("J", 1)}

# lattice points tested against a sphere at once (x planes)
_PLANES = 32


def load_config(name: str, root: Path = CONFIGS) -> dict:
    cfg = json.loads((Path(root) / f"{name}.json").read_text())
    if cfg.get("name") != name:
        raise ValueError(f"configs/{name}.json names itself {cfg.get('name')!r}")
    return cfg


def load_cell(name: str, root: Path = WORKLOADS, configs: Path = CONFIGS) -> dict:
    """The cell file ``<root>/<name>.json`` with its configuration under
    ``"configuration"``."""
    cell = json.loads((Path(root) / f"{name}.json").read_text())
    if cell.get("name") != name:
        raise ValueError(f"workloads/{name}.json names itself {cell.get('name')!r}")
    cell["configuration"] = load_config(cell["config"], configs)
    return cell


def lattice_spans(dx: float, lo, hi, ppc: float):
    """Per-axis lattice coordinates in [lo, hi), float64: spacing
    ``dx / ppc^(1/3)``, the first half a spacing in (copied from
    claymore_tpu_torch/io/sampler.py:_lattice_spans at 5f9f87e)."""
    lo = np.asarray(lo, np.float64)
    hi = np.asarray(hi, np.float64)
    h = dx / ppc ** (1.0 / 3.0)
    return [np.arange(lo[d] + h / 2, hi[d], h) for d in range(3)], h


def lattice(shape: dict, dx: float, ppc: float, device) -> tuple:
    """(points f32 [N, 3] on ``device``, x-major, and the spacing) of a
    shape: ``{"kind": "box", "lo", "hi"}`` (the source's
    ``sample_uniform_box_world``) or ``{"kind": "sphere", "center",
    "radius"}`` (its ``sample_sphere``: the lattice of the bounding box,
    the points with |p - c|^2 <= r^2 in float64)."""
    dev = torch.device(device)
    if shape["kind"] == "box":
        spans, h = lattice_spans(dx, shape["lo"], shape["hi"], ppc)
        ax = [torch.as_tensor(s, dtype=torch.float64, device=dev) for s in spans]
        g = torch.meshgrid(*ax, indexing="ij")
        return torch.stack(g, dim=-1).reshape(-1, 3).float(), h
    if shape["kind"] == "sphere":
        c = np.asarray(shape["center"], np.float64)
        r = float(shape["radius"])
        spans, h = lattice_spans(dx, c - r, c + r, ppc)
        ys, zs = (torch.as_tensor(s, dtype=torch.float64, device=dev) for s in spans[1:])
        ct = torch.as_tensor(c, dtype=torch.float64, device=dev)
        parts = []
        for i in range(0, len(spans[0]), _PLANES):
            xs = torch.as_tensor(spans[0][i:i + _PLANES], dtype=torch.float64, device=dev)
            p = torch.stack(torch.meshgrid(xs, ys, zs, indexing="ij"), dim=-1)
            p = p.reshape(-1, 3).float()
            d = p.double() - ct
            keep = d[:, 0] * d[:, 0] + d[:, 1] * d[:, 1] + d[:, 2] * d[:, 2] <= r * r
            parts.append(p[keep])
        return torch.cat(parts), h
    raise ValueError(f"unknown shape kind {shape['kind']!r}")


def make_inputs(config: dict, seed: int, device) -> list:
    """One dict per model: ``pos`` f32 [N, 3] (jittered lattice), ``field``
    (F0 f32 [N, 9] row-major or J0 f32 [N]), ``v0`` and ``material``.
    Raises when a model's count differs from the configuration's
    ``particles``."""
    dev = torch.device(device)
    sim = config["sim"]
    dx = 1.0 / (1 << int(sim["domain_bits"]))
    gen = torch.Generator(device=dev)
    gen.manual_seed(int(seed))
    eps = float(config["inputs"]["prestrain"])
    spread = float(config["inputs"]["jitter"])
    out = []
    for i, m in enumerate(config["models"]):
        pts, h = lattice(m["shape"], dx, float(sim["ppc"]), dev)
        n = pts.shape[0]
        if n != int(m["particles"]):
            raise ValueError(f"model {i}: {n} lattice points, the configuration "
                             f"states {m['particles']}")
        u = torch.rand((n, 3), generator=gen, device=dev, dtype=torch.float32)
        pos = pts + (u - 0.5) * (h * spread)
        _, width = FIELDS[m["material"]]
        s = torch.rand((n, width), generator=gen, device=dev, dtype=torch.float32)
        strain = eps * (2.0 * s - 1.0)
        if width == 9:
            field = torch.eye(3, dtype=torch.float32, device=dev).reshape(1, 9) + strain
        else:
            field = 1.0 + strain[:, 0]
        out.append({"pos": pos, "field": field, "v0": [float(c) for c in m["v0"]],
                    "material": m["material"]})
    return out
