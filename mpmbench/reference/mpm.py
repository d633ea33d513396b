"""The plain reference: explicit MLS-MPM on a dense grid, in plain PyTorch.

It computes what a substep of the system under test computes, written from
the method and not from the program: the grid update (momentum to velocity,
the sticky slab of ``bound_blocks`` blocks at every domain face, gravity
after the slab, the largest speed), the CFL step, and the fused
grid-to-particle-to-grid transfer with quadratic B-splines and APIC
moments (MLS-MPM, Hu et al. 2018): gather the velocity and its moment
``A_rc = sum_i w_i v_ir (x_i - x_p)_c``, update the material, advect, and
scatter ``w_i (m v + Q (x_i - x_p))`` at the advected position with
``Q = (m A - P F^T V0 dt_next) D^-1``, ``D^-1 = 4 / dx^2``.  Materials:
fixed corotated elasticity (the polar rotation by an unscaled Newton
iteration) and the weakly compressible J-fluid (Tait pressure, viscosity).

There are no blocks, tiles, arenas or rebuilds: every particle scatters
into one dense ``(2^domain_bits)^3`` grid by ``index_add_``, and particles
are addressed by their input row, the id the program reports.  The
particles run in chunks of ``chunk`` rows so that the temporaries fit.
It imports nothing of the program and takes only the inputs the benchmark
made (``mpmbench/scene.py``) and the configuration file's numbers.

``dtype`` is the precision everything but the positions is computed and
stored in: the grid, the weights and offsets, velocities, moments, the
material and its fields.  float32 is the reference, and bfloat16 the
control (``mpmbench/control.py``).  Positions, and the stencil's base
cells worked out from them, stay float32 in both: at a 256^3 grid a
bfloat16 position (8 bits) resolves only about a cell, and a run with
bfloat16 positions diverges within a few substeps and gives no number.
"""

from __future__ import annotations

import math

import torch


def lame(e: float, nu: float):
    """(lambda, mu) of Young's modulus ``e`` and Poisson's ratio ``nu``."""
    return e * nu / ((1 + nu) * (1 - 2 * nu)), e / (2 * (1 + nu))


def cofactor3(a: torch.Tensor) -> torch.Tensor:
    """Cofactor matrices of [B, 3, 3] matrices (so that a^-T = cof / det):
    row r is the cross product of the other two rows."""
    r0, r1, r2 = a[:, 0], a[:, 1], a[:, 2]
    return torch.stack([torch.linalg.cross(r1, r2), torch.linalg.cross(r2, r0),
                        torch.linalg.cross(r0, r1)], dim=1)


def det3(a: torch.Tensor, cof=None) -> torch.Tensor:
    """Determinants of [B, 3, 3] matrices."""
    cof = cofactor3(a) if cof is None else cof
    return (a[:, 0] * cof[:, 0]).sum(dim=-1)


def polar_rotation(f: torch.Tensor, iters: int = 6) -> torch.Tensor:
    """The orthogonal polar factor of [B, 3, 3] matrices by Newton's
    iteration ``R <- (R + R^-T) / 2``; it keeps the sign of the
    determinant, so a reflection for det < 0."""
    r = f
    for _ in range(iters):
        cof = cofactor3(r)
        r = 0.5 * (r + cof / det3(r, cof)[:, None, None])
    return r


def matmul3(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """[..., 3, 3] @ [..., 3, 3] as sums of products (no tensor cores)."""
    return (a[..., :, :, None] * b[..., None, :, :]).sum(dim=-2)


class Material:
    """A material of the configuration file: its constants and update."""

    def __init__(self, spec: dict, volume: float):
        self.kind = spec["material"]
        p = spec["params"]
        self.rho = float(p["rho"])
        self.volume = volume
        self.mass = self.rho * volume
        if self.kind == "FixedCorotated":
            self.lam, self.mu = lame(float(p["e"]), float(p["nu"]))
        elif self.kind == "JFluid":
            self.bulk = float(p["bulk"])
            self.gamma = float(p["gamma"])
            self.viscosity = float(p["viscosity"])
        else:
            raise ValueError(f"the reference has no material {self.kind!r}")

    def update(self, a, dt, d_inv, field):
        """(new field, P F^T V0) of a chunk: ``a`` [B, 3, 3] the APIC
        moment, ``field`` [B, 3, 3] (F) or [B] (J)."""
        eye = torch.eye(3, dtype=a.dtype, device=a.device)
        if self.kind == "FixedCorotated":
            f = matmul3(eye + (dt * d_inv) * a, field)
            r = polar_rotation(f)
            j = det3(f)
            r = torch.where((j < 0)[:, None, None], -r, r)
            ft = f.transpose(-1, -2)
            stress = 2.0 * self.mu * (matmul3(f, ft) - matmul3(r, ft)) \
                + (self.lam * (j - 1.0) * j)[:, None, None] * eye
            return f, stress * self.volume
        j = field + (a[:, 0, 0] + a[:, 1, 1] + a[:, 2, 2]) * (dt * d_inv) * field
        j = torch.clamp(j, min=0.1)
        pressure = self.bulk * (torch.pow(j, -self.gamma) - 1.0)
        stress = (a + a.transpose(-1, -2)) * (d_inv * self.viscosity) \
            - pressure[:, None, None] * eye
        return j, stress * (j * self.volume)[:, None, None]


class DenseMPM:
    """The reference simulation of one configuration.

    ``config`` is the configuration file's dict; ``inputs`` one dict per
    model with ``pos`` [N, 3], ``field`` ([N, 9] F or [N] J) and ``v0``
    (3 floats), as ``mpmbench/scene.py`` makes them.  ``frame_end`` is the
    end time the program's substeps are given."""

    def __init__(self, config: dict, inputs, dtype=torch.float32, device="cpu",
                 frame_end: float = 1e9, chunk: int = 1 << 21):
        sim = config["sim"]
        self.dtype = dtype
        self.device = torch.device(device)
        self.n = 1 << int(sim["domain_bits"])
        self.dx = 1.0 / self.n
        self.dx_inv = float(self.n)
        self.d_inv = 4.0 * self.dx_inv * self.dx_inv
        self.cfl = float(sim["cfl"])
        self.default_dt = float(sim["default_dt"])
        self.gravity = torch.tensor(sim["gravity"], dtype=dtype, device=self.device)
        self.frame_end = frame_end
        self.chunk = chunk
        volume = self.dx ** 3 / float(sim["ppc"])
        self.materials = [Material(m, volume) for m in config["models"]]
        # the slab: nodes whose block (4 cells) lies within bound_blocks of a face
        g = self.n >> 2
        b = int(sim["bound_blocks"])
        blk = torch.arange(self.n, device=self.device) >> 2
        self.near = (blk < b) | (blk >= g - b)
        r = torch.arange(3, device=self.device)
        self.offsets = ((r[:, None, None] * self.n + r[None, :, None]) * self.n
                        + r[None, None, :]).reshape(1, 27)
        self.iota = torch.arange(3, dtype=torch.float32, device=self.device)

        f = dict(dtype=dtype, device=self.device)
        self.pos = [x["pos"].to(torch.float32).contiguous() for x in inputs]
        self.field = []
        for x, mat in zip(inputs, self.materials):
            fld = x["field"].to(**f)
            self.field.append(fld.reshape(-1, 3, 3).clone() if mat.kind == "FixedCorotated"
                              else fld.clone())
        self.t = torch.zeros((), **f)
        self.dt = torch.full((), self.default_dt, **f)
        self.step_count = 0
        self.grid = torch.zeros((self.n ** 3, 4), **f)
        for x, mat, pos in zip(inputs, self.materials, self.pos):
            v0 = torch.tensor(x["v0"], **f)
            for lo in range(0, pos.shape[0], chunk):
                xs = pos[lo:lo + chunk]
                w, idx, _ = self._stencil(xs)
                vals = torch.cat([torch.full((4,), mat.mass, **f)[:1], mat.mass * v0])
                self.grid.index_add_(0, idx.reshape(-1), (w[..., None] * vals).reshape(-1, 4))

    # ------------------------------------------------------------------

    def _stencil(self, xs: torch.Tensor):
        """The quadratic B-spline stencils of ``xs`` [B, 3]: the weights
        [B, 27] of the 3^3 nodes (x-major), their flat indices [B, 27] and
        the node-minus-particle offsets per axis [B, 3 (axis), 3 (node)]."""
        xi = xs * self.dx_inv
        base = torch.floor(xi + 0.5) - 1.0
        d = (xi - base).to(self.dtype)
        w = torch.stack([0.5 * (1.5 - d) ** 2, 0.75 - (d - 1.0) ** 2,
                         0.5 * (d - 0.5) ** 2], dim=-1)          # [B, 3 (axis), 3 (node)]
        wt = (w[:, 0, :, None, None] * w[:, 1, None, :, None]
              * w[:, 2, None, None, :]).reshape(-1, 27)
        # a position gone non-finite still indexes inside the grid; its NaN
        # weights carry into the outputs, which the check reads as failed
        b = torch.clamp(torch.nan_to_num(base, nan=0.0), 0, self.n - 3).to(torch.int64)
        idx = ((b[:, 0] * self.n + b[:, 1]) * self.n + b[:, 2])[:, None] + self.offsets
        dpos = ((base[:, :, None] + self.iota) * self.dx - xs[:, :, None]).to(self.dtype)
        return wt, idx, dpos

    def _grid_update(self):
        """(velocities [n^3, 3], largest |v|^2 over massive nodes)."""
        m = self.grid[:, 0]
        has = m > 0
        v = torch.where(has[:, None], self.grid[:, 1:4] / torch.where(has, m, 1.0)[:, None],
                        0.0)
        n = self.n
        v = v.view(n, n, n, 3)
        v = torch.stack([
            torch.where(self.near[:, None, None], 0.0, v[..., 0]),
            torch.where(self.near[None, :, None], 0.0, v[..., 1]),
            torch.where(self.near[None, None, :], 0.0, v[..., 2])], dim=-1).view(-1, 3)
        v = v + self.gravity * self.dt
        v = torch.where(has[:, None], v, 0.0)
        vs = (v * v).sum(dim=1)
        vs = torch.where(torch.isnan(vs), torch.inf, vs)
        return v, torch.where(has, vs, 0.0).max()

    def _cfl_dt(self, max_vel_sqr, t_after):
        vmax = torch.sqrt(max_vel_sqr)
        dt = torch.full_like(vmax, self.default_dt)
        cfl_dx = torch.full_like(vmax, self.dx * self.cfl)
        dt = torch.where(vmax > 0, torch.minimum(dt, cfl_dx / torch.clamp(vmax, min=1e-30)),
                         dt)
        fe = torch.full_like(vmax, self.frame_end)
        dt = torch.minimum(dt, torch.clamp(fe - t_after, min=0.0))
        return torch.where(torch.isfinite(vmax), dt, torch.nan)

    def step(self):
        """One substep of every model."""
        v, max_vel_sqr = self._grid_update()
        t_after = self.t + self.dt
        next_dt = self._cfl_dt(max_vel_sqr, t_after)
        dt, d_inv = self.dt, self.d_inv
        nxt = torch.zeros_like(self.grid)
        for mi, mat in enumerate(self.materials):
            pos, field = self.pos[mi], self.field[mi]
            for lo in range(0, pos.shape[0], self.chunk):
                sl = slice(lo, lo + self.chunk)
                xs = pos[sl]
                w, idx, d = self._stencil(xs)
                wv = (w[..., None] * v[idx]).reshape(-1, 3, 3, 3, 3)   # [B, i, j, k, r]
                vel = wv.sum(dim=(1, 2, 3))
                # A_rc = sum over nodes of w v_r d_c, d_c depending on one axis
                a = torch.stack([(wv.sum(dim=(2, 3)) * d[:, 0, :, None]).sum(dim=1),
                                 (wv.sum(dim=(1, 3)) * d[:, 1, :, None]).sum(dim=1),
                                 (wv.sum(dim=(1, 2)) * d[:, 2, :, None]).sum(dim=1)],
                                dim=-1)                               # [B, 3 (r), 3 (c)]
                new_field, stress = mat.update(a, dt, d_inv, field[sl])
                xn = xs + (vel * dt).float()
                q = (a * mat.mass - stress * next_dt) * d_inv
                w2, idx2, d2 = self._stencil(xn)
                # (Q (x_i - x_p))_r per node, a sum of one term an axis
                qd = ((q[:, None, :, 0] * d2[:, 0, :, None])[:, :, None, None, :]
                      + (q[:, None, :, 1] * d2[:, 1, :, None])[:, None, :, None, :]
                      + (q[:, None, :, 2] * d2[:, 2, :, None])[:, None, None, :, :])
                mom = mat.mass * vel[:, None, :] + qd.reshape(-1, 27, 3)
                vals = torch.cat([torch.full_like(w2[..., None], mat.mass), mom], dim=-1)
                nxt.index_add_(0, idx2.reshape(-1), (w2[..., None] * vals).reshape(-1, 4))
                pos[sl] = xn
                field[sl] = new_field
        self.grid = nxt
        self.t = t_after
        self.dt = next_dt
        self.step_count += 1

    def run(self, substeps: int):
        for _ in range(substeps):
            self.step()
        return self

    # ------------------------------------------------------------------

    def outputs(self):
        """Per model: positions [N, 3] and the deformation field, F as
        [N, 9] row-major or J as [N], in float32; plus the grid's mass in
        float64 and the step size the next substep would take."""
        models = [{"pos": p.float(), "field": (f.reshape(-1, 9) if f.dim() == 3 else f).float()}
                  for p, f in zip(self.pos, self.field)]
        return {"models": models, "mass": float(self.grid[:, 0].double().sum()),
                "dt": float(self.dt), "substeps": self.step_count}


def particle_mass(config: dict, model: int) -> float:
    """A particle's mass in model ``model`` (rho times dx^3 / ppc)."""
    sim = config["sim"]
    dx = 1.0 / (1 << int(sim["domain_bits"]))
    return float(config["models"][model]["params"]["rho"]) * dx ** 3 / float(sim["ppc"])


def expected_mass(config: dict, counts) -> float:
    """The total mass of the configuration's particles."""
    return math.fsum(n * particle_mass(config, i) for i, n in enumerate(counts))
