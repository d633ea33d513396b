"""The check that decides ``correct``.

``Capture`` takes, inside the window's first episode, what the timed path
produced after its ``K``-th substep: every particle's position and
deformation field filed by its id (the input row), how many live slots
hold each id, the grid's mass (a float64 sum), the next step size and the
loss counters.  ``K`` is the first substep count at or past the cell's
``check.substeps`` that also lies ``check.past_first_rebuild`` substeps
past the episode's first rebuild, so that the compared stretch holds a
rebucket (or the episode's end, where none came).  The capture is a few
device copies queued between two substeps: no synchronise.  A mesh's
capture files every shard's live particles into the same buffers (on
card 0): ``seen`` counts an id's live slots over every shard, the mass
sums each shard's own blocks (``owned``, so no halo copy counts twice),
and the loss counters take in the migration's and the halo's.  It also
counts the ids held by another shard than at set-up (``moved``, not
compared).

``compare`` holds two sets of outputs (``outputs`` of a capture, or of the
reference) against each other and against the configuration's guarantees
and returns every compared number beside its limit.
"""

from __future__ import annotations

import math

import torch

from .scene import FIELDS

# every compared number, in the order they are printed
NAMES = ("pos_gap_dx", "def_gap", "mass_rel", "dt_rel", "missing", "dropped", "overflow")


class Capture:
    """Buffers for the program's outputs at the compared substep, made in
    set-up (so the window allocates nothing for them)."""

    def __init__(self, config: dict, counts, check: dict, device, owned=None):
        self.owned = owned
        self.counts = list(counts)
        self.min_substeps = int(check["substeps"])
        self.past = int(check["past_first_rebuild"])
        self.widths = [FIELDS[m["material"]] for m in config["models"]]
        f = dict(dtype=torch.float32, device=device)
        self.pos = [torch.full((3, n + 1), math.nan, **f) for n in self.counts]
        self.field = [torch.full((w, n + 1), math.nan, **f) for (_, w), n in
                      zip(self.widths, self.counts)]
        self.seen = [torch.zeros((n + 1,), dtype=torch.int32, device=device)
                     for n in self.counts]
        self.stray = torch.zeros((), dtype=torch.int64, device=device)
        self.mass = torch.zeros((), dtype=torch.float64, device=device)
        self.dt = torch.zeros((), **f)
        self.dropped = torch.zeros((), dtype=torch.int64, device=device)
        self.overflow = torch.zeros((), dtype=torch.int64, device=device)
        self.substeps = None
        self.home = self.holder = None

    def mark_home(self, states) -> None:
        """Note which shard of a mesh's initial ``states`` holds each id."""
        self.home = self._holders(states)
        self.holder = [torch.full_like(h, -1) for h in self.home]

    def _holders(self, states, out=None):
        """Per model, the shard holding each id (-1: none), int8 [N + 1]."""
        dev = self.mass.device
        out = out or [torch.full((n + 1,), -1, dtype=torch.int8, device=dev)
                      for n in self.counts]
        for j, st in enumerate(states):
            for i, (m, n) in enumerate(zip(st.models, self.counts)):
                ok = m.active & (m.pid >= 0) & (m.pid < n)
                idx = torch.where(ok, m.pid.long(), n).to(dev)
                out[i].index_fill_(0, idx, j)
        return out

    def due(self, done: int, first_rebuild) -> bool:
        """Whether to take the capture after ``done`` substeps of an episode
        whose first rebuild came on substep ``first_rebuild`` (1-based, or
        None)."""
        if done < self.min_substeps:
            return False
        return first_rebuild is not None and done >= first_rebuild + self.past

    def take(self, state, done: int) -> None:
        """File ``state``'s particles by id (every shard's, for a mesh's
        tuple of shard states); queue-only."""
        states = state if isinstance(state, tuple) else (state,)
        dev = self.mass.device
        stray = torch.zeros((), dtype=torch.int64, device=dev)
        for seen in self.seen:
            seen.zero_()
        for st in states:
            for i, (m, n) in enumerate(zip(st.models, self.counts)):
                ok = m.active & (m.pid >= 0) & (m.pid < n)
                stray = stray + (m.active & ~ok).sum().to(dev)
                idx = torch.where(ok, m.pid.long(), n).to(dev)
                self.pos[i].index_copy_(1, idx, m.pos.to(dev))
                name, width = self.widths[i]
                self.field[i].index_copy_(1, idx, m.fields[name].reshape(width, -1).to(dev))
                self.seen[i].index_add_(0, idx, torch.ones_like(idx, dtype=torch.int32))
        self.stray.copy_(stray)
        self.dt.copy_(states[0].dt)
        dropped = sum(m.tiles.dropped.sum().to(dev) for st in states for m in st.models)
        overflow = sum(st.partition.overflow.sum().to(dev) for st in states)
        if self.owned is None:
            self.mass.copy_(state.grid[:-1, 0:4].sum(dtype=torch.float64))
        else:
            self.mass.copy_(sum(self.owned(states, j)[:, 0:4].sum(dtype=torch.float64).to(dev)
                                for j in range(len(states))))
            dropped = dropped + sum(st.mig_dropped.sum().to(dev) for st in states)
            overflow = overflow + sum(st.halo_overflow.sum().to(dev) for st in states)
            self._holders(states, [h.fill_(-1) for h in self.holder])
        self.dropped.copy_(dropped)
        self.overflow.copy_(overflow)
        self.substeps = done

    def outputs(self) -> dict:
        """The captured outputs in ``compare``'s form."""
        missing = sum(int((s[:n] != 1).sum()) for s, n in zip(self.seen, self.counts))
        return {
            "models": [{"pos": p[:, :n].t(), "field": f[0, :n] if f.shape[0] == 1 else f[:, :n].t()}
                       for p, f, n in zip(self.pos, self.field, self.counts)],
            "mass": float(self.mass), "dt": float(self.dt),
            "missing": missing + int(self.stray),
            "dropped": int(self.dropped), "overflow": int(self.overflow),
            "substeps": self.substeps,
            **({"moved": sum(int(((h[:n] != -1) & (h[:n] != g[:n])).sum())
                             for h, g, n in zip(self.holder, self.home, self.counts))}
               if self.home is not None else {}),
        }


def row_gaps(a: torch.Tensor, b: torch.Tensor, chunk: int = 1 << 22) -> torch.Tensor:
    """Per row of two [N, ...] tensors, the widest element gap |a - b|
    (NaN counted as infinite)."""
    out = []
    for lo in range(0, a.shape[0], chunk):
        d = (a[lo:lo + chunk].float() - b[lo:lo + chunk].float()).abs()
        out.append(torch.nan_to_num(d, nan=math.inf).reshape(d.shape[0], -1).amax(dim=1))
    return torch.cat(out) if out else torch.zeros((0,))


def compare(got: dict, ref: dict, dx: float, expected_mass: float, limits: dict):
    """(checks, attempted, failed): ``checks`` maps each name of ``NAMES``
    to (number, limit); ``attempted`` is the particles compared and
    ``failed`` those whose position or field lies past its limit, plus
    the ids not held by exactly one live slot."""
    pos_gap = def_gap = 0.0
    attempted = bad = 0
    for g, r in zip(got["models"], ref["models"]):
        pg = row_gaps(g["pos"], r["pos"])
        fg = row_gaps(g["field"], r["field"])
        if pg.numel():
            pos_gap = max(pos_gap, float(pg.max()))
            def_gap = max(def_gap, float(fg.max()))
        attempted += pg.numel()
        bad += int(((pg > limits["pos_gap_dx"] * dx) | (fg > limits["def_gap"])).sum())
    values = {
        "pos_gap_dx": pos_gap / dx,
        "def_gap": def_gap,
        "mass_rel": abs(got["mass"] - expected_mass) / expected_mass,
        "dt_rel": abs(got["dt"] - ref["dt"]) / abs(ref["dt"]) if ref["dt"] else math.inf,
        "missing": got.get("missing", 0),
        "dropped": got.get("dropped", 0),
        "overflow": got.get("overflow", 0),
    }
    checks = {k: (values[k], limits[k]) for k in NAMES}
    return checks, attempted, min(attempted, bad + values["missing"])


def passed(checks: dict) -> bool:
    """Every number at or under its limit (NaN fails)."""
    return all(v <= lim for v, lim in checks.values())
