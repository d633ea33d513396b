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
the first substep; a plastic material's ``logJp`` starts at its
``log_jp0``.  ``make_colliders`` turns the configuration's ``colliders``
into the specs both sides are given, an SDF's node table sampled here.
The same seed gives the same inputs, on the same kind of device.  Nothing
here imports the program.
"""

from __future__ import annotations

import json
from pathlib import Path

import numpy as np
import torch

HERE = Path(__file__).resolve().parent
CONFIGS = HERE / "configs"
WORKLOADS = HERE / "workloads"

# the fields of each material beyond the position: (name in the program's
# state, floats a particle), in the order they are stored
FIELDS = {"FixedCorotated": (("F", 9),), "JFluid": (("J", 1),),
          "Sand": (("F", 9), ("logJp", 1)), "NACC": (("F", 9), ("logJp", 1))}
# collider kinds of a configuration file, and the boundary conditions
COLLIDERS = ("half_space", "sphere", "box", "sdf")
BOUNDARIES = ("sticky", "slip", "separate")

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
    """One dict per model: ``pos`` f32 [N, 3] (jittered lattice), ``fields``
    (name -> F0 f32 [N, 9] row-major, J0 f32 [N] or logJp0 f32 [N]), ``v0``
    and ``material``.  Raises when a model's count differs from the
    configuration's ``particles``."""
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
        fields = {}
        for name, width in FIELDS[m["material"]]:
            if name == "logJp":
                fields[name] = torch.full((n,), float(m["params"]["log_jp0"]),
                                          dtype=torch.float32, device=dev)
                continue
            s = torch.rand((n, width), generator=gen, device=dev, dtype=torch.float32)
            strain = eps * (2.0 * s - 1.0)
            if width == 9:
                fields[name] = torch.eye(3, dtype=torch.float32, device=dev).reshape(1, 9) + strain
            else:
                fields[name] = 1.0 + strain[:, 0]
        out.append({"pos": pos, "fields": fields, "v0": [float(c) for c in m["v0"]],
                    "material": m["material"]})
    return out


def sdf_nodes(shape: dict, nodes: int, spacing: float):
    """(values f32 [n, n, n], gradients f32 [3, n, n, n]) of an analytic
    signed distance (positive outside) sampled at node (i, j, k) =
    (i, j, k) x ``spacing``, in float64 then rounded: ``{"kind": "sphere",
    "center", "radius"}`` or ``{"kind": "box", "lo", "hi"}``.  The gradient
    is the distance's own: (x - c) / |x - c| for the sphere (0 at its
    centre); for the box the direction to the nearest point outside it,
    inside it the axis of the nearest face (the first on ties) with the
    side's sign."""
    ax = np.arange(nodes, dtype=np.float64) * float(spacing)
    x = np.stack(np.meshgrid(ax, ax, ax, indexing="ij"))          # [3, n, n, n]
    if shape["kind"] == "sphere":
        d = x - np.asarray(shape["center"], np.float64)[:, None, None, None]
        r = np.sqrt((d * d).sum(axis=0))
        grad = np.where(r > 0, d / np.where(r > 0, r, 1.0), 0.0)
        sd = r - float(shape["radius"])
    elif shape["kind"] == "box":
        lo = np.asarray(shape["lo"], np.float64)[:, None, None, None]
        hi = np.asarray(shape["hi"], np.float64)[:, None, None, None]
        c, half = (lo + hi) / 2, (hi - lo) / 2
        q = np.abs(x - c) - half
        out = np.maximum(q, 0.0)
        out_n = np.sqrt((out * out).sum(axis=0))
        qmax = q.max(axis=0)
        sd = out_n + np.minimum(qmax, 0.0)
        sign = np.where(x - c < 0, -1.0, 1.0)
        axis = np.argmax(q, axis=0)
        face = np.stack([(axis == k) * sign[k] for k in range(3)])
        grad = np.where(out_n > 0, sign * out / np.where(out_n > 0, out_n, 1.0), face)
    else:
        raise ValueError(f"unknown SDF shape {shape['kind']!r}")
    return sd.astype(np.float32), grad.astype(np.float32)


def make_colliders(config: dict, device) -> list:
    """The configuration's static colliders, in list order, as the specs
    both sides are given: each entry of ``colliders`` with ``boundary``,
    ``friction`` and its geometry (``half_space``: ``origin``, ``normal``;
    ``sphere``: ``center``, ``radius``; ``box``: ``lo``, ``hi``; ``sdf``:
    ``shape``, ``nodes``, ``spacing``, ``band``), an ``sdf`` also with
    ``table``, f32 [n, n, n, 4] of (value, gradient) at its nodes on
    ``device`` (``sdf_nodes``)."""
    out = []
    for c in config.get("colliders", []):
        if c["kind"] not in COLLIDERS:
            raise ValueError(f"unknown collider kind {c['kind']!r}")
        if c["boundary"] not in BOUNDARIES:
            raise ValueError(f"unknown boundary {c['boundary']!r}")
        spec = dict(c, friction=float(c["friction"]))
        if c["kind"] == "sdf":
            sd, grad = sdf_nodes(c["shape"], int(c["nodes"]), float(c["spacing"]))
            table = np.concatenate([sd[..., None], np.moveaxis(grad, 0, -1)], axis=-1)
            spec["table"] = torch.from_numpy(np.ascontiguousarray(table)).to(device)
        out.append(spec)
    return out
