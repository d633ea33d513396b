"""Constitutive models.

Each material is a frozen dataclass of static parameters plus a batched
``update(d_inv, dt, A, fields) -> (new_fields, contrib)`` on SoA component
tensors, as in ``claymore_tpu/models/materials.py``.  ``A`` is the unscaled
APIC moment  A_rc = sum_i W_i v_i_r (x_i - x_p)_c  and ``contrib`` the
Kirchhoff-like stress  P F^T V_0  the fused momentum scatter consumes:
Q = (A m - contrib dt_next) D^-1.

Only FixedCorotated is ported so far; the CUDA transfer kernel
(``csrc/g2p2g.cu``) carries the same update per thread.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Tuple

import torch

from ..ops import soa3
from ..ops.soa3 import Mat3

Fields = Dict[str, torch.Tensor]

_I9 = (1.0, 0.0, 0.0, 0.0, 1.0, 0.0, 0.0, 0.0, 1.0)


def lame_parameters(e: float, nu: float) -> Tuple[float, float]:
    lam = e * nu / ((1 + nu) * (1 - 2 * nu))
    mu = e / (2 * (1 + nu))
    return lam, mu


def identity_f9(n: int, device) -> torch.Tensor:
    """Component-leading identity deformation gradients: [9, n]."""
    eye = torch.tensor(_I9, dtype=torch.float32, device=device)
    return eye[:, None].expand(9, n).contiguous()


def f9_to_soa(f: torch.Tensor) -> Mat3:
    """[9, ...] -> nine component tensors."""
    return tuple(f[k] for k in range(9))


def soa_to_f9(m: Mat3) -> torch.Tensor:
    return torch.stack(m, dim=0)


def deformation_update(a: Mat3, dt, d_inv, f: Mat3) -> Mat3:
    """F <- (I + dt D^-1 A) F (MLS-MPM)."""
    c = soa3.add_scaled_identity(soa3.scale(a, dt * d_inv), 1.0)
    return soa3.matmul(c, f)


@dataclasses.dataclass(frozen=True)
class Material:
    """Base: common mass/volume bookkeeping."""

    rho: float = 1e3
    volume: float = (1.0 / 256.0) ** 3 / 8.0

    @property
    def mass(self) -> float:
        return self.rho * self.volume

    name: str = "base"
    # particle fields beyond position: (name, per-particle shape)
    field_specs: Tuple[Tuple[str, Tuple[int, ...]], ...] = ()

    def init_fields(self, n: int, device) -> Fields:
        raise NotImplementedError

    def update(self, d_inv, dt, A: Mat3, fields: Fields):
        raise NotImplementedError


@dataclasses.dataclass(frozen=True)
class FixedCorotated(Material):
    """Fixed corotated elasticity."""

    e: float = 5e3
    nu: float = 0.4
    name: str = "fixed_corotated"
    field_specs: Tuple[Tuple[str, Tuple[int, ...]], ...] = (("F", (9,)),)

    @property
    def lame(self) -> Tuple[float, float]:
        return lame_parameters(self.e, self.nu)

    def init_fields(self, n: int, device) -> Fields:
        return {"F": identity_f9(n, device)}

    def update(self, d_inv, dt, A: Mat3, fields: Fields):
        # P = 2 mu (F - R) + lam (J - 1) J F^{-T}, so the fused-scatter
        # contribution P F^T V0 = V0 [2 mu (F F^T - R F^T) + lam (J-1) J I]
        # needs only the polar rotation R and det(F).
        lam, mu = self.lame
        f = deformation_update(A, dt, d_inv, f9_to_soa(fields["F"]))
        r = soa3.polar3(f)
        J = soa3.det(f)
        # inverted elements: polar3 gives the det = -1 orthogonal factor;
        # negating it restores a det = +1 rotation whose stress pushes the
        # element back
        neg = J < 0.0
        r = tuple(torch.where(neg, -rk, rk) for rk in r)
        ff = soa3.matmul_bt(f, f)
        rf = soa3.matmul_bt(r, f)
        dev = tuple(2.0 * mu * (x - y) for x, y in zip(ff, rf))
        contrib = soa3.scale(
            soa3.add_scaled_identity(dev, lam * (J - 1.0) * J), self.volume)
        return {"F": soa_to_f9(f)}, contrib


MATERIALS = {"fixed_corotated": FixedCorotated}
