"""Collision objects: half-space, sphere, box and the SDF grid.

Port of the component form of ``claymore_tpu/models/boundary.py``
(``_project_soa``, ``_rot_xyz_scalars``, ``RigidMotion``,
``ColliderBase.resolve_soa``, ``sdf_and_normal_soa``): the math the JAX
package runs inside its grid kernel, written out on tuples of same-shaped
tensors in the same order.  ``core/grid.py`` runs it as the plain version of
the CUDA grid kernel, which carries the same math per cell
(``csrc/grid_update.cu``).

``SignedDistanceCollider`` is ``sdf_and_normal`` of the JAX package's
collider of that name (trilinear value and gradient on a node grid) in the
same component form, so static and animated SDF colliders both go through
``resolve_soa``; the CUDA kernel samples the same node table per cell.
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
BRICK = 8          # nodes per edge of a brick of SignedDistanceCollider.bricks

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

    @property
    def is_static(self) -> bool:
        return (
            self.trans_vel == (0.0, 0.0, 0.0)
            and self.omega == (0.0, 0.0, 0.0)
            and self.dsdt == 0.0
        )


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

    def pose(self, x3: Vec3, t: torch.Tensor):
        """(x_mt, x_mat, r) of world positions ``x3`` at collider time
        ``t``: relative to the moving origin, in the material frame, and
        the rotation's nine entries (None when the collider does not
        rotate)."""
        mo = self.motion
        off = tuple(mo.trans[k] + mo.trans_vel[k] * t for k in range(3))
        x_mt = tuple(x3[k] - off[k] for k in range(3))
        s = 1.0 + mo.dsdt * t
        x0 = tuple(c / s for c in x_mt)
        if not mo.rotating:
            return x_mt, x0, None
        r = _rot_xyz_scalars(mo.omega, t)
        # material coords: X = R^T x0
        x_mat = tuple(
            r[0 + k] * x0[0] + r[3 + k] * x0[1] + r[6 + k] * x0[2] for k in range(3))
        return x_mt, x_mat, r

    def resolve_soa(self, x3: Vec3, v3: Vec3, t: torch.Tensor) -> Vec3:
        """Projected cell velocities: ``x3``/``v3`` are 3-tuples of
        same-shaped tensors, ``t`` the collider time as a 0-d tensor."""
        mo = self.motion
        x_mt, x_mat, r = self.pose(x3, t)
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
    """Dense SDF-grid collider: trilinear value and gradient interpolation
    on a node grid whose node (i, j, k) sits at (i, j, k) * dx.

    ``values`` f32[n0, n1, n2] and ``grads`` f32[3, n0, n1, n2] stay numpy
    on the host; ``table(device)`` is their interleaved (sd, gx, gy, gz)
    copy on a device, made once per device.  As in the JAX package, the
    clip of the base node and the interior band use ``n0`` on every axis,
    and a corner index past the end of a shorter axis reads that axis's
    last node."""

    def __init__(self, sdf, dx: float, kind=STICKY, friction: float = 0.0,
                 motion: Optional[RigidMotion] = None,
                 gradients: Optional[np.ndarray] = None, bound_cells: int = 8):
        super().__init__(kind, friction, motion)
        sdf = np.asarray(sdf, np.float32)
        if sdf.ndim != 3 or min(sdf.shape) < 2:
            raise ValueError(f"SDF grid must be 3-D with >= 2 nodes per axis, "
                             f"got {sdf.shape}")
        if gradients is None:
            gx, gy, gz = np.gradient(sdf, dx)
            gradients = np.stack([gx, gy, gz], axis=0)
        self.values = sdf
        self.grads = np.asarray(gradients).astype(np.float32)
        if self.grads.shape != (3,) + sdf.shape:
            raise ValueError(f"gradients {self.grads.shape} do not match {sdf.shape}")
        self.dx = float(dx)
        self.bound_cells = int(bound_cells)
        self._tables = {}
        self._bricks = {}

    @classmethod
    def from_claymore_files(cls, prefix: str, resolution, dx: float,
                            kind=STICKY, friction: float = 0.0,
                            motion: Optional[RigidMotion] = None,
                            bound_cells: int = 8):
        """The collider asset format of the reference: four raw float32
        files ``{prefix}_sdf.bin`` and ``{prefix}_grad_{0,1,2}.bin``, each
        resolution.prod() values in C row-major (z innermost) order."""
        res = tuple(int(r) for r in resolution)

        def read(suffix):
            arr = np.fromfile(f"{prefix}{suffix}", dtype=np.float32)
            if arr.size != res[0] * res[1] * res[2]:
                raise ValueError(f"{prefix}{suffix}: {arr.size} values, expected {res}")
            return arr.reshape(res)

        sdf = read("_sdf.bin")
        grads = np.stack([read(f"_grad_{c}.bin") for c in range(3)], axis=0)
        return cls(sdf, dx, kind=kind, friction=friction, motion=motion,
                   gradients=grads, bound_cells=bound_cells)

    @property
    def band(self) -> Tuple[float, float]:
        """[lo, hi) of the interior band, per axis, in world units."""
        n = self.values.shape[0]
        return self.bound_cells * self.dx, (n - self.bound_cells) * self.dx

    def table(self, device) -> torch.Tensor:
        """f32[n0, n1, n2, 4] of (sd, gx, gy, gz) on ``device``, uploaded
        on the first call for that device and kept."""
        dev = torch.device(device)
        if dev.type == "cuda" and dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
        tab = self._tables.get(dev)
        if tab is None:
            host = np.concatenate(
                [self.values[..., None], np.moveaxis(self.grads, 0, -1)], axis=-1)
            tab = torch.from_numpy(np.ascontiguousarray(host)).to(dev)
            self._tables[dev] = tab
        return tab

    def bricks(self, device) -> torch.Tensor:
        """f32[ceil(n0/8), ceil(n1/8), ceil(n2/8)]: the least node value of
        each brick of 8^3 nodes (the last brick of an axis holds what is
        left of it; NaN nodes are left out), on ``device``, made on the first
        call for that device and kept.  The CUDA grid kernel reads it to
        skip the rows whose nodes are all positive."""
        dev = torch.device(device)
        if dev.type == "cuda" and dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
        out = self._bricks.get(dev)
        if out is None:
            b = BRICK
            nb = tuple(-(-n // b) for n in self.values.shape)
            pad = np.full(tuple(n * b for n in nb), np.inf, np.float32)
            n0, n1, n2 = self.values.shape
            pad[:n0, :n1, :n2] = np.where(np.isnan(self.values), np.inf, self.values)
            mins = pad.reshape(nb[0], b, nb[1], b, nb[2], b).min(axis=(1, 3, 5))
            out = torch.from_numpy(np.ascontiguousarray(mins)).to(dev)
            self._bricks[dev] = out
        return out

    def sdf_and_normal_soa(self, x3):
        dev = x3[0].device
        flat = self.table(dev).reshape(-1, 4)
        n0, n1, n2 = self.values.shape
        # a tensor divisor: ``tensor / python float`` on CUDA rounds through
        # a reciprocal
        dx = torch.tensor(self.dx, dtype=torch.float32, device=dev)
        xc = tuple(c / dx for c in x3)
        c0 = tuple(torch.clamp(torch.floor(c).to(torch.int32), 0, n0 - 2) for c in xc)
        fr = tuple(xc[k] - c0[k].to(torch.float32) for k in range(3))
        ix = tuple(c0[0].long() + i for i in (0, 1))
        iy = tuple(torch.clamp(c0[1].long() + j, max=n1 - 1) for j in (0, 1))
        iz = tuple(torch.clamp(c0[2].long() + k, max=n2 - 1) for k in (0, 1))
        sd = torch.zeros_like(x3[0])
        nr = [torch.zeros_like(x3[0]) for _ in range(3)]
        for i in (0, 1):
            wx = 1.0 - fr[0] if i == 0 else fr[0]
            for j in (0, 1):
                wy = 1.0 - fr[1] if j == 0 else fr[1]
                for k in (0, 1):
                    wz = 1.0 - fr[2] if k == 0 else fr[2]
                    w = wx * wy * wz
                    node = flat[(ix[i] * n1 + iy[j]) * n2 + iz[k]]
                    sd = sd + w * node[..., 0]
                    for c in range(3):
                        nr[c] = nr[c] + w * node[..., 1 + c]
        # outside the interior band: no collision
        lo, hi = self.band
        inside = ((x3[0] >= lo) & (x3[0] < hi) & (x3[1] >= lo) & (x3[1] < hi)
                  & (x3[2] >= lo) & (x3[2] < hi))
        sd = torch.where(inside, sd, 1.0)
        norm = torch.sqrt(nr[0] * nr[0] + nr[1] * nr[1] + nr[2] * nr[2])
        den = torch.clamp(norm, min=1e-20)
        return sd, tuple(c / den for c in nr)


TYPES = (HalfSpace, Sphere, Box, SignedDistanceCollider)


def check_colliders(colliders) -> None:
    """Raise NotImplementedError for anything but the four collider types."""
    for c in colliders:
        if not isinstance(c, TYPES):
            raise NotImplementedError(
                f"{type(c).__name__}: the port's colliders are HalfSpace, "
                "Sphere, Box and SignedDistanceCollider")
