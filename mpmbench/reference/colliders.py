"""The static colliders of the plain reference, on the grid's nodes.

A collider is a signed distance (positive outside) and its outward
normal: a half-space ``(x - origin) . n`` with ``n`` the unit normal, a
sphere ``|x - c| - r`` with normal ``(x - c) / |x - c|``, an axis-aligned
box (its exact distance; the normal the axis whose face is nearest, the
first on ties, with the side's sign), or an SDF node table sampled by the
benchmark (``mpmbench/scene.py:sdf_nodes``), whose value and gradient are
trilinear between the nodes (i, j, k) x spacing and whose normal is the
gradient made unit.  A node hits a collider where the distance is at most
0; its velocity v is then projected (the boundary conditions of
Stomakhin et al. 2013, section 8, with Coulomb friction mu):

* ``sticky``: v = 0;
* ``slip``: the normal part removed, v_t = v - (v . n) n; where the node
  approaches (v . n < 0), friction takes mu |v . n| off v_t's length, to
  0 at most;
* ``separate``: where the node approaches, as ``slip``; elsewhere v is
  left as it is.

Departures from the method, as the reference simulator and the system
under test have them: ``slip`` removes the normal part also from a node
that moves away; an SDF collider acts only inside its interior band, the
nodes at least ``band`` spacings from each face of its table (elsewhere
it is not there); a trilinear cell is found from ``floor(x / spacing)``
clipped to the table.  Colliders act in list order, each on the
velocities the previous one left.  Nothing here imports the program.
"""

from __future__ import annotations

import math

import torch


def _unit(n) -> list:
    a = [float(c) for c in n]
    s = math.sqrt(sum(c * c for c in a))
    return [c / s for c in a]


def distance_and_normal(c: dict, x: torch.Tensor, dtype):
    """(signed distance [B], unit normal [B, 3]) of collider ``c`` (a spec of
    ``scene.make_colliders``) at the positions ``x`` [B, 3] f32, in
    ``dtype``."""
    dev = x.device
    if c["kind"] == "half_space":
        n = torch.tensor(_unit(c["normal"]), dtype=dtype, device=dev)
        o = torch.tensor(c["origin"], dtype=dtype, device=dev)
        sd = ((x.to(dtype) - o) * n).sum(dim=1)
        return sd, n.expand(x.shape[0], 3)
    if c["kind"] == "sphere":
        d = x.to(dtype) - torch.tensor(c["center"], dtype=dtype, device=dev)
        r = torch.sqrt((d * d).sum(dim=1))
        return r - float(c["radius"]), d / torch.clamp(r, min=1e-20)[:, None]
    if c["kind"] == "box":
        lo = torch.tensor(c["lo"], dtype=torch.float64)
        hi = torch.tensor(c["hi"], dtype=torch.float64)
        ctr = ((lo + hi) / 2).to(dtype=dtype, device=dev)
        half = ((hi - lo) / 2).to(dtype=dtype, device=dev)
        rel = x.to(dtype) - ctr
        q = rel.abs() - half
        out = torch.clamp(q, min=0.0)
        qmax = q.max(dim=1).values
        sd = torch.sqrt((out * out).sum(dim=1)) + torch.clamp(qmax, max=0.0)
        axis = torch.argmax((q >= qmax[:, None]).to(torch.int8), dim=1)
        n = torch.nn.functional.one_hot(axis, 3).to(dtype) * torch.sign(rel)
        nn = torch.sqrt((n * n).sum(dim=1))
        return sd, n / torch.clamp(nn, min=1e-20)[:, None]
    return _sdf(c, x, dtype)


def _sdf(c: dict, x: torch.Tensor, dtype):
    tab = c["table"].to(device=x.device, dtype=dtype)
    n = tab.shape[0]
    h = float(c["spacing"])
    lo, hi = int(c["band"]) * h, (n - int(c["band"])) * h
    inside = ((x >= lo) & (x < hi)).all(dim=1)
    xc = x / torch.tensor(h, dtype=torch.float32, device=x.device)
    base = torch.clamp(torch.floor(xc), 0, n - 2)
    fr = (xc - base).to(dtype)
    b = base.to(torch.int64)
    acc = torch.zeros((x.shape[0], 4), dtype=dtype, device=x.device)
    for i in (0, 1):
        for j in (0, 1):
            for k in (0, 1):
                w = ((fr[:, 0] if i else 1.0 - fr[:, 0]) * (fr[:, 1] if j else 1.0 - fr[:, 1])
                     * (fr[:, 2] if k else 1.0 - fr[:, 2]))
                acc = acc + w[:, None] * tab[b[:, 0] + i, b[:, 1] + j, b[:, 2] + k]
    g = acc[:, 1:]
    norm = torch.sqrt((g * g).sum(dim=1))
    sd = torch.where(inside, acc[:, 0], 1.0)
    return sd, g / torch.clamp(norm, min=1e-20)[:, None]


def project(v: torch.Tensor, n: torch.Tensor, boundary: str, friction: float) -> torch.Tensor:
    """The velocities ``v`` [B, 3] of nodes that hit, projected by the
    boundary condition with normals ``n`` [B, 3]."""
    if boundary == "sticky":
        return torch.zeros_like(v)
    vn = (v * n).sum(dim=1)
    vt = v - n * vn[:, None]
    approach = vn < 0.0
    if friction > 0.0:
        t = torch.sqrt((vt * vt).sum(dim=1))
        stop = -vn * friction >= t
        slowed = vt * (1.0 + vn * friction / torch.clamp(t, min=1e-20))[:, None]
        closing = torch.where(stop[:, None], 0.0, slowed)
    else:
        closing = vt
    away = vt if boundary == "slip" else v
    return torch.where(approach[:, None], closing, away)


def apply(colliders, x: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Node velocities ``v`` [B, 3] at positions ``x`` [B, 3] f32 after every
    collider, in list order."""
    for c in colliders:
        sd, n = distance_and_normal(c, x, v.dtype)
        hit = sd <= 0.0
        v = torch.where(hit[:, None], project(v, n, c["boundary"], c["friction"]), v)
    return v
