"""Constitutive models.

Each material is a frozen dataclass of static parameters plus a batched
``update(d_inv, dt, A, fields) -> (new_fields, contrib)`` on SoA component
tensors, as in ``claymore_tpu/models/materials.py``.  ``A`` is the unscaled
APIC moment  A_rc = sum_i W_i v_i_r (x_i - x_p)_c  and ``contrib`` the
Kirchhoff-like stress  P F^T V_0  the fused momentum scatter consumes:
Q = (A m - contrib dt_next) D^-1.

The four materials of the JAX package, with its field layouts (JFluid: J
[S]; FixedCorotated: F [9, S]; Sand and NACC: F [9, S] and logJp [S]) and
its arithmetic written out in the same order; the CUDA transfer kernel
(``csrc/g2p2g.cu``) carries the same updates per thread.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Tuple

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
class JFluid(Material):
    """Weakly compressible Tait fluid."""

    bulk: float = 4e4
    gamma: float = 7.15
    viscosity: float = 0.01
    name: str = "jfluid"
    field_specs: Tuple[Tuple[str, Tuple[int, ...]], ...] = (("J", ()),)

    def init_fields(self, n: int, device) -> Fields:
        return {"J": torch.ones((n,), dtype=torch.float32, device=device)}

    def update(self, d_inv, dt, A: Mat3, fields: Fields):
        J = fields["J"]
        J = J + soa3.trace(A) * (dt * d_inv) * J
        J = torch.clamp(J, min=0.1)
        voln = J * self.volume
        pressure = self.bulk * (torch.pow(J, -self.gamma) - 1.0)
        vd = d_inv * self.viscosity
        at = soa3.transpose(A)
        sym = tuple((x + y) * vd for x, y in zip(A, at))
        contrib = soa3.scale(soa3.add_scaled_identity(sym, -pressure), voln)
        return {"J": J}, contrib


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


@dataclasses.dataclass(frozen=True)
class Sand(Material):
    """Drucker-Prager sand with StVK-Hencky elasticity."""

    e: float = 5e3
    nu: float = 0.4
    cohesion: float = 0.0
    beta: float = 1.0
    log_jp0: float = 0.0
    friction_angle: float = 30.0
    volume_correction: bool = True
    name: str = "sand"
    field_specs: Tuple[Tuple[str, Tuple[int, ...]], ...] = (
        ("F", (9,)),
        ("logJp", ()),
    )

    @property
    def lame(self) -> Tuple[float, float]:
        return lame_parameters(self.e, self.nu)

    @property
    def yield_surface(self) -> float:
        sin_phi = math.sin(self.friction_angle / 180.0 * math.pi)
        return math.sqrt(2.0 / 3.0) * 2.0 * sin_phi / (3.0 - sin_phi)

    def init_fields(self, n: int, device) -> Fields:
        return {
            "F": identity_f9(n, device),
            "logJp": torch.full((n,), self.log_jp0, dtype=torch.float32,
                                device=device),
        }

    def update(self, d_inv, dt, A: Mat3, fields: Fields):
        lam, mu = self.lame
        f = deformation_update(A, dt, d_inv, f9_to_soa(fields["F"]))
        log_jp = fields["logJp"]
        u, s, v = soa3.svd3(f)

        eps = [torch.log(torch.clamp(torch.abs(sk), min=1e-4)) - self.cohesion
               for sk in s]
        sum_eps = eps[0] + eps[1] + eps[2]
        trace_eps = sum_eps + log_jp
        third = trace_eps / 3.0
        eps_hat = [e_ - third for e_ in eps]
        hat_sqr = eps_hat[0] ** 2 + eps_hat[1] ** 2 + eps_hat[2] ** 2
        hat_norm = torch.sqrt(hat_sqr)
        safe_norm = torch.clamp(hat_norm, min=1e-20)

        tip = trace_eps >= 0.0
        s_tip = math.exp(self.cohesion)

        delta_gamma = (
            hat_norm
            + (3.0 * lam + 2.0 * mu) / (2.0 * mu) * trace_eps * self.yield_surface
        )
        inside = delta_gamma <= 0.0
        coef = delta_gamma / safe_norm
        new_s = []
        for k in range(3):
            h_in = eps[k] + self.cohesion
            h_proj = eps[k] - coef * eps_hat[k] + self.cohesion
            h = torch.where(inside, h_in, h_proj)
            new_s.append(torch.where(tip, s_tip, torch.exp(h)))

        if self.volume_correction:
            new_log_jp = torch.where(tip, self.beta * sum_eps + log_jp, 0.0)
        else:
            new_log_jp = torch.where(tip, log_jp, 0.0)

        f = soa3.u_diag_vt(u, new_s[0], new_s[1], new_s[2], v)

        log_s = [torch.log(ns) for ns in new_s]
        trace_log = log_s[0] + log_s[1] + log_s[2]
        ph = [(2.0 * mu * log_s[k] + lam * trace_log) / new_s[k] for k in range(3)]
        p = soa3.u_diag_vt(u, ph[0], ph[1], ph[2], v)
        contrib = soa3.scale(soa3.matmul_bt(p, f), self.volume)
        return {"F": soa_to_f9(f), "logJp": new_log_jp}, contrib


@dataclasses.dataclass(frozen=True)
class NACC(Material):
    """Non-associated Cam-Clay."""

    e: float = 5e3
    nu: float = 0.4
    beta: float = 0.5
    xi: float = 0.8
    log_jp0: float = -0.01
    friction_angle: float = 45.0
    hardening_on: bool = True
    name: str = "nacc"
    field_specs: Tuple[Tuple[str, Tuple[int, ...]], ...] = (
        ("F", (9,)),
        ("logJp", ()),
    )

    @property
    def lame(self) -> Tuple[float, float]:
        return lame_parameters(self.e, self.nu)

    @property
    def bm(self) -> float:
        lam, mu = self.lame
        return 2.0 / 3.0 * mu + lam

    @property
    def msqr(self) -> float:
        sin_phi = math.sin(self.friction_angle / 180.0 * math.pi)
        mohr_columb_friction = math.sqrt(2.0 / 3.0) * 2.0 * sin_phi / (3.0 - sin_phi)
        m = mohr_columb_friction * 3.0 / math.sqrt(2.0 / 3.0)
        return m * m

    def init_fields(self, n: int, device) -> Fields:
        return {
            "F": identity_f9(n, device),
            "logJp": torch.full((n,), self.log_jp0, dtype=torch.float32,
                                device=device),
        }

    def update(self, d_inv, dt, A: Mat3, fields: Fields):
        _, mu = self.lame
        bm, xi, beta, msqr = self.bm, self.xi, self.beta, self.msqr
        f = deformation_update(A, dt, d_inv, f9_to_soa(fields["F"]))
        log_jp = fields["logJp"]
        u, (s0, s1, s2), v = soa3.svd3(f)

        # sinh spelled through exp, as the JAX package does
        xh = xi * torch.clamp(-log_jp, min=0.0)
        p0 = bm * (1e-5 + 0.5 * (torch.exp(xh) - torch.exp(-xh)))
        p_min = -beta * p0
        je = s0 * s1 * s2

        b0, b1, b2 = s0 * s0, s1 * s1, s2 * s2
        tr3 = (b0 + b1 + b2) / 3.0
        jmu = mu * torch.pow(je, -2.0 / 3.0)
        sh0, sh1, sh2 = jmu * (b0 - tr3), jmu * (b1 - tr3), jmu * (b2 - tr3)
        p_trial = -bm * 0.5 * (je - 1.0 / je) * je

        ys_half = 1.5 * (1.0 + 2.0 * beta)
        yp_half = msqr * (p_trial - p_min) * (p_trial - p0)
        sh_sqr = sh0 * sh0 + sh1 * sh1 + sh2 * sh2
        y = ys_half * sh_sqr + yp_half

        hit_max = p_trial > p0
        hit_min = p_trial < p_min
        hit = hit_max | hit_min
        p_tip = torch.where(hit_max, p0, p_min)
        je_tip = torch.sqrt(torch.clamp(-2.0 * p_tip / bm + 1.0, min=1e-12))
        s_tip = torch.pow(je_tip, 1.0 / 3.0)

        outside = (~hit) & (y >= 1e-4)
        safe_sh = torch.clamp(sh_sqr, min=1e-20)
        b_coeff = (
            torch.pow(je, 2.0 / 3.0) / mu
            * torch.sqrt(torch.clamp(-yp_half, min=0.0) / ys_half)
            / torch.sqrt(safe_sh)
        )
        proj = [torch.sqrt(torch.clamp(shk * b_coeff + tr3, min=1e-12))
                for shk in (sh0, sh1, sh2)]
        new_s = [torch.where(hit, s_tip, torch.where(outside, pk, sk))
                 for pk, sk in zip(proj, (s0, s1, s2))]

        new_log_jp = log_jp
        if self.hardening_on:
            tip_update = torch.log(
                torch.clamp(je, min=1e-12) / torch.clamp(je_tip, min=1e-12))
            new_log_jp = torch.where(hit, log_jp + tip_update, new_log_jp)

            harden3 = (outside & (p0 > 1e-4) & (p_trial < p0 - 1e-4)
                       & (p_trial > 1e-4 + p_min))
            p_center = (1.0 - beta) * p0 / 2.0
            q_trial = torch.sqrt(1.5 * safe_sh)
            dir0, dir1 = p_center - p_trial, -q_trial
            dn = torch.sqrt(torch.clamp(dir0 * dir0 + dir1 * dir1, min=1e-20))
            dir0, dir1 = dir0 / dn, dir1 / dn
            cc = msqr * (p_center - p_min) * (p_center - p0)
            bb = msqr * dir0 * (2.0 * p_center - p0 - p_min)
            aa = msqr * dir0 * dir0 + (1.0 + 2.0 * beta) * dir1 * dir1
            disc = torch.sqrt(torch.clamp(bb * bb - 4.0 * aa * cc, min=0.0))
            safe_aa = torch.where(torch.abs(aa) < 1e-20, 1e-20, aa)
            l1 = (-bb + disc) / (2.0 * safe_aa)
            l2 = (-bb - disc) / (2.0 * safe_aa)
            p1 = p_center + l1 * dir0
            p2 = p_center + l2 * dir0
            p_fake = torch.where((p_trial - p_center) * (p1 - p_center) > 0.0, p1, p2)
            je_fake = torch.sqrt(torch.abs(-2.0 * p_fake / bm + 1.0))
            h_update = torch.log(
                torch.clamp(je, min=1e-12) / torch.clamp(je_fake, min=1e-12))
            new_log_jp = torch.where(harden3 & (je_fake > 1e-4),
                                     new_log_jp + h_update, new_log_jp)

        f = soa3.u_diag_vt(u, new_s[0], new_s[1], new_s[2], v)

        J = new_s[0] * new_s[1] * new_s[2]
        b = soa3.matmul_bt(f, f)
        b_dev = soa3.add_scaled_identity(b, -soa3.trace(b) / 3.0)
        dev_coeff = mu * torch.pow(torch.clamp(J, min=1e-12), -2.0 / 3.0)
        i_coeff = bm * 0.5 * ((J * J - 1.0) * 0.5
                              - torch.log(torch.clamp(J, min=1e-12)))
        contrib = soa3.scale(
            soa3.add_scaled_identity(soa3.scale(b_dev, dev_coeff), i_coeff),
            self.volume)
        return {"F": soa_to_f9(f), "logJp": new_log_jp}, contrib


MATERIALS: Dict[str, Any] = {
    "jfluid": JFluid,
    "fixed_corotated": FixedCorotated,
    "sand": Sand,
    "nacc": NACC,
}


def from_scene(constitutive: str, cfg_volume: float, params: Dict[str, Any]) -> Material:
    """Build a material from claymore scene-JSON keys."""
    if constitutive == "fixed_corotated":
        return FixedCorotated(
            rho=params.get("rho", 1e3),
            volume=params.get("volume", cfg_volume),
            e=params.get("youngs_modulus", 5e3),
            nu=params.get("poisson_ratio", 0.4),
        )
    if constitutive == "jfluid":
        return JFluid(
            rho=params.get("rho", 1e3),
            volume=params.get("volume", cfg_volume),
            bulk=params.get("bulk_modulus", 4e4),
            gamma=params.get("gamma", 7.15),
            viscosity=params.get("viscosity", 0.01),
        )
    if constitutive == "nacc":
        return NACC(
            rho=params.get("rho", 1e3),
            volume=params.get("volume", cfg_volume),
            e=params.get("youngs_modulus", 5e3),
            nu=params.get("poisson_ratio", 0.4),
            beta=params.get("beta", 0.5),
            xi=params.get("xi", 0.8),
        )
    if constitutive == "sand":
        return Sand(
            rho=params.get("rho", 1e3),
            volume=params.get("volume", cfg_volume),
            e=params.get("youngs_modulus", 5e3),
            nu=params.get("poisson_ratio", 0.4),
        )
    raise ValueError(f"unknown constitutive model: {constitutive}")
