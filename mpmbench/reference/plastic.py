"""The plastic materials of the plain reference: Drucker-Prager sand and
non-associated Cam-Clay, on batches of [B, 3, 3] matrices in plain PyTorch.

Both are the return maps of the reference simulator's
``compute_stress<Sand>`` and ``compute_stress<NACC>``
(``Projects/GMPM/constitutive_models.cuh:239-335`` and ``:78-234``), written
from the methods:

* **Sand** (Klar et al., SIGGRAPH 2016): StVK elasticity in Hencky strain;
  the trial strain ``eps = log(sigma) - cohesion`` with the plastic volume
  ``logJp`` added to its trace is projected onto the Drucker-Prager cone of
  ``alpha = sqrt(2/3) 2 sin(phi) / (3 - sin(phi))``: to the tip
  (sigma = exp(cohesion)) in tension, unchanged inside the cone, else along
  the deviator by ``delta_gamma = |eps_hat| + (3 lam + 2 mu) / (2 mu)
  tr(eps) alpha``.  Volume correction: at the tip
  ``logJp <- beta sum(eps) + logJp``, elsewhere 0.
* **NACC** (Wolper et al., SIGGRAPH 2019): Neo-Hookean elasticity in
  (p, q), the yield ellipse ``(1 + 2 beta) q^2 + M^2 (p - p_min)(p - p0) =
  0`` with ``p0 = kappa (1e-5 + sinh(xi max(-logJp, 0)))`` and ``p_min =
  -beta p0``; a trial pressure past either end goes to that tip, a trial
  point outside the ellipse is scaled back along the deviator; hardening
  moves ``logJp`` by the volume the projection took away.

Departures from the methods' papers, as the reference simulator has them:
the singular values enter ``log`` as ``max(|sigma|, 1e-4)``; NACC's
``sinh`` is spelled with two ``exp``, its yield test has the tolerance
``1e-4``, its hardening of a point outside the ellipse uses the point where
the ray from the ellipse's centre through the trial point meets it, and it
guards every square root, ``log`` and division with the floors below.

The singular value decomposition is ``torch.linalg.svd`` in float32 (in
float64 for a float64 run), made signed as the method wants it: U and V proper rotations, the sign of
det(F) carried by the smallest singular value.  In a lower precision
(the control) the matrix is rounded to float32 before the decomposition
and its factors rounded back after it.  Nothing here imports the program.
"""

from __future__ import annotations

import math

import torch


def lame(e: float, nu: float):
    """(lambda, mu) of Young's modulus ``e`` and Poisson's ratio ``nu``."""
    return e * nu / ((1 + nu) * (1 - 2 * nu)), e / (2 * (1 + nu))


def _det(a: torch.Tensor) -> torch.Tensor:
    return (a[:, 0] * torch.linalg.cross(a[:, 1], a[:, 2])).sum(dim=-1)


def signed_svd(f: torch.Tensor):
    """(U [B, 3, 3], sigma [B, 3], V [B, 3, 3]) with F = U diag(sigma) V^T,
    U and V rotations (det +1), sigma in descending magnitude and its last
    entry negative where det(F) < 0; in ``f``'s dtype, computed in
    float32 (float64 for float64; a row with a non-finite entry gives NaN
    singular values)."""
    work = f.double() if f.dtype == torch.float64 else f.float()
    # a non-finite matrix is decomposed as the identity, its sigma made NaN
    bad = ~torch.isfinite(work).flatten(1).all(dim=1)
    work = torch.where(bad[:, None, None], torch.eye(3, dtype=work.dtype, device=f.device), work)
    u, s, vh = torch.linalg.svd(work)
    s = torch.where(bad[:, None], torch.nan, s)
    v = vh.transpose(-1, -2)
    su = torch.where(_det(u) < 0, -1.0, 1.0)
    sv = torch.where(_det(v) < 0, -1.0, 1.0)
    u = torch.cat([u[:, :, :2], u[:, :, 2:] * su[:, None, None]], dim=2)
    v = torch.cat([v[:, :, :2], v[:, :, 2:] * sv[:, None, None]], dim=2)
    s = torch.cat([s[:, :2], s[:, 2:] * (su * sv)[:, None]], dim=1)
    return u.to(f.dtype), s.to(f.dtype), v.to(f.dtype)


def u_diag_vt(u: torch.Tensor, s: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """U diag(s) V^T, as sums of products."""
    return ((u * s[:, None, :])[:, :, None, :] * v[:, None, :, :]).sum(dim=-1)


def _mul_t(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a b^T, as sums of products."""
    return (a[:, :, None, :] * b[:, None, :, :]).sum(dim=-1)


class Sand:
    """Drucker-Prager sand with StVK-Hencky elasticity."""

    KEYS = ("e", "nu", "cohesion", "beta", "friction_angle", "volume_correction")

    def __init__(self, p: dict, volume: float):
        self.lam, self.mu = lame(float(p["e"]), float(p["nu"]))
        self.cohesion = float(p["cohesion"])
        self.beta = float(p["beta"])
        sin_phi = math.sin(float(p["friction_angle"]) / 180.0 * math.pi)
        self.alpha = math.sqrt(2.0 / 3.0) * 2.0 * sin_phi / (3.0 - sin_phi)
        self.volume_correction = bool(p["volume_correction"])
        self.volume = volume

    def project(self, f: torch.Tensor, log_jp: torch.Tensor):
        """(new F, new logJp, P F^T V0) of the trial ``f`` [B, 3, 3]."""
        lam, mu = self.lam, self.mu
        u, s, v = signed_svd(f)
        eps = torch.log(torch.clamp(s.abs(), min=1e-4)) - self.cohesion
        sum_eps = eps.sum(dim=-1)
        tr = sum_eps + log_jp
        eps_hat = eps - (tr / 3.0)[:, None]
        hat = torch.sqrt((eps_hat * eps_hat).sum(dim=-1))
        dgamma = hat + (3.0 * lam + 2.0 * mu) / (2.0 * mu) * tr * self.alpha
        tip = tr >= 0.0
        coef = dgamma / torch.clamp(hat, min=1e-20)
        h = torch.where((dgamma <= 0.0)[:, None], eps, eps - coef[:, None] * eps_hat)
        s_new = torch.where(tip[:, None], math.exp(self.cohesion),
                            torch.exp(h + self.cohesion))
        keep = self.beta * sum_eps + log_jp if self.volume_correction else log_jp
        log_jp = torch.where(tip, keep, 0.0)
        f = u_diag_vt(u, s_new, v)
        log_s = torch.log(s_new)
        p_hat = (2.0 * mu * log_s + lam * log_s.sum(dim=-1, keepdim=True)) / s_new
        stress = _mul_t(u_diag_vt(u, p_hat, v), f)
        return f, log_jp, stress * self.volume


class NACC:
    """Non-associated Cam-Clay with hardening."""

    KEYS = ("e", "nu", "beta", "xi", "friction_angle", "hardening_on")

    def __init__(self, p: dict, volume: float):
        lam, self.mu = lame(float(p["e"]), float(p["nu"]))
        self.kappa = 2.0 / 3.0 * self.mu + lam
        self.beta = float(p["beta"])
        self.xi = float(p["xi"])
        sin_phi = math.sin(float(p["friction_angle"]) / 180.0 * math.pi)
        m = math.sqrt(2.0 / 3.0) * 2.0 * sin_phi / (3.0 - sin_phi) * 3.0 / math.sqrt(2.0 / 3.0)
        self.m2 = m * m
        self.hardening = bool(p["hardening_on"])
        self.volume = volume

    def project(self, f: torch.Tensor, log_jp: torch.Tensor):
        """(new F, new logJp, P F^T V0) of the trial ``f`` [B, 3, 3]."""
        mu, kappa, beta, m2 = self.mu, self.kappa, self.beta, self.m2
        u, s, v = signed_svd(f)
        x = self.xi * torch.clamp(-log_jp, min=0.0)
        p0 = kappa * (1e-5 + 0.5 * (torch.exp(x) - torch.exp(-x)))
        p_min = -beta * p0
        je = s[:, 0] * s[:, 1] * s[:, 2]
        b = s * s
        b_mean = b.sum(dim=-1) / 3.0
        s_hat = (mu * torch.pow(je, -2.0 / 3.0))[:, None] * (b - b_mean[:, None])
        p = -kappa * 0.5 * (je - 1.0 / je) * je
        ys = 1.5 * (1.0 + 2.0 * beta)
        yp = m2 * (p - p_min) * (p - p0)
        s_hat2 = (s_hat * s_hat).sum(dim=-1)
        y = ys * s_hat2 + yp

        # past either end of the ellipse: to that tip
        hit_max, hit_min = p > p0, p < p_min
        hit = hit_max | hit_min
        p_tip = torch.where(hit_max, p0, p_min)
        je_tip = torch.sqrt(torch.clamp(-2.0 * p_tip / kappa + 1.0, min=1e-12))
        s_tip = torch.pow(je_tip, 1.0 / 3.0)
        # outside it: the deviator scaled back onto it
        outside = ~hit & (y >= 1e-4)
        s_hat2_safe = torch.clamp(s_hat2, min=1e-20)
        scale = (torch.pow(je, 2.0 / 3.0) / mu * torch.sqrt(torch.clamp(-yp, min=0.0) / ys)
                 / torch.sqrt(s_hat2_safe))
        back = torch.sqrt(torch.clamp(s_hat * scale[:, None] + b_mean[:, None], min=1e-12))
        s_new = torch.where(hit[:, None], s_tip[:, None], torch.where(outside[:, None], back, s))

        if self.hardening:
            log_jp = torch.where(hit, log_jp + torch.log(torch.clamp(je, min=1e-12)
                                                         / torch.clamp(je_tip, min=1e-12)),
                                 log_jp)
            grows = outside & (p0 > 1e-4) & (p < p0 - 1e-4) & (p > 1e-4 + p_min)
            # the ray from the ellipse's centre through the trial point
            pc = (1.0 - beta) * p0 / 2.0
            q = torch.sqrt(1.5 * s_hat2_safe)
            d0, d1 = pc - p, -q
            dn = torch.sqrt(torch.clamp(d0 * d0 + d1 * d1, min=1e-20))
            d0, d1 = d0 / dn, d1 / dn
            qa = m2 * d0 * d0 + (1.0 + 2.0 * beta) * d1 * d1
            qb = m2 * d0 * (2.0 * pc - p0 - p_min)
            qc = m2 * (pc - p_min) * (pc - p0)
            root = torch.sqrt(torch.clamp(qb * qb - 4.0 * qa * qc, min=0.0))
            qa = torch.where(torch.abs(qa) < 1e-20, 1e-20, qa)
            p1 = pc + (-qb + root) / (2.0 * qa) * d0
            p2 = pc + (-qb - root) / (2.0 * qa) * d0
            p_far = torch.where((p - pc) * (p1 - pc) > 0.0, p1, p2)
            je_far = torch.sqrt(torch.abs(-2.0 * p_far / kappa + 1.0))
            step = torch.log(torch.clamp(je, min=1e-12) / torch.clamp(je_far, min=1e-12))
            log_jp = torch.where(grows & (je_far > 1e-4), log_jp + step, log_jp)

        f = u_diag_vt(u, s_new, v)
        j = s_new[:, 0] * s_new[:, 1] * s_new[:, 2]
        bf = _mul_t(f, f)
        tr_b = bf[:, 0, 0] + bf[:, 1, 1] + bf[:, 2, 2]
        eye = torch.eye(3, dtype=f.dtype, device=f.device)
        b_dev = bf - (tr_b / 3.0)[:, None, None] * eye
        jc = torch.clamp(j, min=1e-12)
        dev = mu * torch.pow(jc, -2.0 / 3.0)
        iso = kappa * 0.5 * ((j * j - 1.0) * 0.5 - torch.log(jc))
        stress = dev[:, None, None] * b_dev + iso[:, None, None] * eye
        return f, log_jp, stress * self.volume


PLASTIC = {"Sand": Sand, "NACC": NACC}
