"""Analytic collision objects: half-space, sphere and box.

Port of the component form of ``claymore_tpu/models/boundary.py``
(``_project_soa``, ``_rot_xyz_scalars``, ``RigidMotion``,
``ColliderBase.resolve_soa``, ``sdf_and_normal_soa``): the math the JAX
package runs inside its grid kernel, written out on tuples of same-shaped
tensors in the same order.  ``core/grid.py`` runs it as the plain version of
the CUDA grid kernel, which carries the same math per cell
(``csrc/grid_update.cu``).

The SDF-grid collider is not ported yet: constructing one raises.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch

STICKY = "sticky"
SLIP = "slip"
SEPARATE = "separate"
KINDS = (STICKY, SLIP, SEPARATE)

Vec3 = Tuple[torch.Tensor, torch.Tensor, torch.Tensor]


def _project_soa(vr: Vec3, n: Vec3, kind: str, friction: float) -> Vec3:
    """Velocity projection in the object frame, on component tuples."""
    if kind == STICKY:
        return tuple(torch.zeros_like(c) for c in vr)

    v_dot_n = vr[0] * n[0] + vr[1] * n[1] + vr[2] * n[2]
    tang = tuple(vr[k] - n[k] * v_dot_n for k in range(3))

    if kind == SLIP:
        if friction <= 0.0:
            return tang
        vn = torch.sqrt(tang[0] ** 2 + tang[1] ** 2 + tang[2] ** 2)
        safe_vn = torch.clamp(vn, min=1e-20)
        scl = 1.0 + v_dot_n * friction / safe_vn
        stop = (-v_dot_n * friction) >= vn
        approaching = v_dot_n < 0
        return tuple(
            torch.where(approaching, torch.where(stop, 0.0, tang[k] * scl), tang[k])
            for k in range(3))

    if kind == SEPARATE:
        approaching = v_dot_n < 0
        if friction == 0.0:
            return tuple(torch.where(approaching, tang[k], vr[k]) for k in range(3))
        vn = torch.sqrt(tang[0] ** 2 + tang[1] ** 2 + tang[2] ** 2)
        safe_vn = torch.clamp(vn, min=1e-20)
        scl = 1.0 + v_dot_n * friction / safe_vn
        stop = (-v_dot_n * friction) >= vn
        return tuple(
            torch.where(approaching, torch.where(stop, 0.0, tang[k] * scl), vr[k])
            for k in range(3))
    raise ValueError(f"unknown boundary type {kind}")


def _rot_xyz_scalars(omega, t: torch.Tensor):
    """Rx(ox t) Ry(oy t) Rz(oz t) as nine row-major 0-d tensors."""
    one = torch.ones_like(t)
    zero = torch.zeros_like(t)
    cx, sx = torch.cos(omega[0] * t), torch.sin(omega[0] * t)
    cy, sy = torch.cos(omega[1] * t), torch.sin(omega[1] * t)
    cz, sz = torch.cos(omega[2] * t), torch.sin(omega[2] * t)
    rx = (one, zero, zero, zero, cx, -sx, zero, sx, cx)
    ry = (cy, zero, sy, zero, one, zero, -sy, zero, cy)
    rz = (cz, -sz, zero, sz, cz, zero, zero, zero, one)

    def mm(a, b):
        return tuple(
            sum(a[3 * i + k] * b[3 * k + j] for k in range(3))
            for i in range(3)
            for j in range(3)
        )

    return mm(mm(rx, ry), rz)


@dataclasses.dataclass(frozen=True)
class RigidMotion:
    """Animated rigid transform x(t) = R(t) s(t) X + b(t)."""

    trans: Tuple[float, float, float] = (0.0, 0.0, 0.0)
    trans_vel: Tuple[float, float, float] = (0.0, 0.0, 0.0)
    omega: Tuple[float, float, float] = (0.0, 0.0, 0.0)   # rotation rates
    scale: float = 1.0
    dsdt: float = 0.0

    @property
    def rotating(self) -> bool:
        return tuple(self.omega) != (0.0, 0.0, 0.0)


class ColliderBase:
    """Shared animated-transform machinery.  Subclasses implement
    ``sdf_and_normal_soa(x3)`` in material space."""

    kind: str
    friction: float
    motion: RigidMotion

    def __init__(self, kind=STICKY, friction=0.0, motion: Optional[RigidMotion] = None):
        if kind not in KINDS:
            raise ValueError(f"unknown boundary type {kind}")
        self.kind = kind
        self.friction = float(friction)
        self.motion = motion or RigidMotion()

    def sdf_and_normal_soa(self, x3: Vec3):
        raise NotImplementedError

    def resolve_soa(self, x3: Vec3, v3: Vec3, t: torch.Tensor) -> Vec3:
        """Projected cell velocities: ``x3``/``v3`` are 3-tuples of
        same-shaped tensors, ``t`` the collider time as a 0-d tensor."""
        mo = self.motion
        off = tuple(mo.trans[k] + mo.trans_vel[k] * t for k in range(3))
        x_mt = tuple(x3[k] - off[k] for k in range(3))
        s = 1.0 + mo.dsdt * t
        x0 = tuple(c / s for c in x_mt)
        if mo.rotating:
            r = _rot_xyz_scalars(mo.omega, t)
            # material coords: X = R^T x0
            x_mat = tuple(
                r[0 + k] * x0[0] + r[3 + k] * x0[1] + r[6 + k] * x0[2]
                for k in range(3))
        else:
            x_mat = x0

        sd, n_mat = self.sdf_and_normal_soa(x_mat)
        hit = sd <= 0.0

        om = mo.omega
        v_obj = tuple(
            om[(k + 1) % 3] * x_mt[(k + 2) % 3]
            - om[(k + 2) % 3] * x_mt[(k + 1) % 3]
            + x_mt[k] * (mo.dsdt / max(mo.scale, 1e-20))
            + mo.trans_vel[k]
            for k in range(3))
        if mo.rotating:
            n_world = tuple(
                r[3 * k] * n_mat[0] + r[3 * k + 1] * n_mat[1] + r[3 * k + 2] * n_mat[2]
                for k in range(3))
        else:
            n_world = n_mat
        v_rel = tuple(v3[k] - v_obj[k] for k in range(3))
        v_proj = _project_soa(v_rel, n_world, self.kind, self.friction)
        return tuple(torch.where(hit, v_proj[k] + v_obj[k], v3[k]) for k in range(3))


class HalfSpace(ColliderBase):
    """Analytic plane collider: sdf = (x - origin) . normal."""

    def __init__(self, origin, normal, kind=SLIP, friction=0.0, motion=None):
        super().__init__(kind, friction, motion)
        self.origin = tuple(float(c) for c in origin)
        n = np.asarray(normal, np.float64)
        n = n / np.linalg.norm(n)
        self.normal = tuple(float(c) for c in n)

    def sdf_and_normal_soa(self, x3):
        o, n = self.origin, self.normal
        sd = sum((x3[k] - o[k]) * n[k] for k in range(3))
        return sd, tuple(torch.full_like(sd, n[k]) for k in range(3))


class Sphere(ColliderBase):
    """Analytic sphere collider."""

    def __init__(self, center, radius, kind=SEPARATE, friction=0.0, motion=None):
        super().__init__(kind, friction, motion)
        self.center = tuple(float(c) for c in center)
        self.radius = float(radius)

    def sdf_and_normal_soa(self, x3):
        d = tuple(x3[k] - self.center[k] for k in range(3))
        r = torch.sqrt(d[0] ** 2 + d[1] ** 2 + d[2] ** 2)
        inv = 1.0 / torch.clamp(r, min=1e-20)
        return r - self.radius, tuple(dk * inv for dk in d)


class Box(ColliderBase):
    """Analytic axis-aligned box collider (material space)."""

    def __init__(self, lo, hi, kind=STICKY, friction=0.0, motion=None):
        super().__init__(kind, friction, motion)
        self.lo = tuple(float(c) for c in lo)
        self.hi = tuple(float(c) for c in hi)

    @property
    def center(self):
        return tuple((self.lo[k] + self.hi[k]) / 2 for k in range(3))

    @property
    def half(self):
        return tuple((self.hi[k] - self.lo[k]) / 2 for k in range(3))

    def sdf_and_normal_soa(self, x3):
        center, half = self.center, self.half
        d = tuple(torch.abs(x3[k] - center[k]) - half[k] for k in range(3))
        out = tuple(torch.clamp(dk, min=0.0) for dk in d)
        dmax = torch.maximum(torch.maximum(d[0], d[1]), d[2])
        sd = (torch.sqrt(out[0] ** 2 + out[1] ** 2 + out[2] ** 2)
              + torch.clamp(dmax, max=0.0))
        # the axis of largest d, first one on ties (jnp.argmax's rule)
        is0 = d[0] >= dmax
        is1 = ~is0 & (d[1] >= dmax)
        is2 = ~is0 & ~is1
        n = tuple(
            torch.where(sel, torch.sign(x3[k] - center[k]), 0.0)
            for k, sel in enumerate((is0, is1, is2)))
        nn = torch.sqrt(n[0] ** 2 + n[1] ** 2 + n[2] ** 2)
        inv = 1.0 / torch.clamp(nn, min=1e-20)
        return sd, tuple(nk * inv for nk in n)


class SignedDistanceCollider(ColliderBase):
    """The SDF-grid collider is not ported yet (ROADMAP Queue 1, "SDF
    colliders in K2")."""

    def __init__(self, *args, **kwargs):
        raise NotImplementedError(
            "SignedDistanceCollider is not ported yet (ROADMAP Queue 1: SDF "
            "colliders in K2)")


ANALYTIC = (HalfSpace, Sphere, Box)


def check_analytic(colliders) -> None:
    """Raise NotImplementedError unless every collider is analytic."""
    for c in colliders:
        if not isinstance(c, ANALYTIC):
            raise NotImplementedError(
                f"{type(c).__name__}: only the analytic colliders (HalfSpace, "
                "Sphere, Box) are ported; SDF colliders are ROADMAP Queue 1")
