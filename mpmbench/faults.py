"""Faults planted under the timed path, to show that the check sees them.

Each is a wrapper of ``MPMEngine.substep`` (the function the window
calls), installed by ``harness.run_cell(..., fault=name)``; neither the
benchmark's command nor its runs use them.  The tests drive a whole run
with each (``tests/test_mpmbench_faults.py``) and ``control.py`` reads
them at a cell's own size.

* ``unchanged``: the substep returns its state as it was given.
* ``half``: the particles with even ids keep the position and deformation
  they had before the substep: half of the particles left out of it.
* ``altered``: the particle with id 0 is moved by 0.05 dx along x where
  the substep produces it, once an episode (on its first substep).
"""

from __future__ import annotations

import dataclasses

import torch

from .scene import FIELDS


def _by_id(model, counts_n, name, width):
    """A model's positions and field filed by id: ([3, N+1], [width, N+1])."""
    ok = model.active & (model.pid >= 0) & (model.pid < counts_n)
    idx = torch.where(ok, model.pid.long(), counts_n)
    pos = torch.zeros((3, counts_n + 1), dtype=model.pos.dtype, device=model.pos.device)
    pos.index_copy_(1, idx, model.pos)
    fld = model.fields[name].reshape(width, -1)
    f = torch.zeros((width, counts_n + 1), dtype=fld.dtype, device=fld.device)
    f.index_copy_(1, idx, fld)
    return pos, f


def install(engine, fault: str, config: dict, counts):
    """Replace ``engine.substep`` by its faulty form ``fault``."""
    real = engine.substep
    fields = [FIELDS[m["material"]] for m in config["models"]]

    if fault == "unchanged":
        def substep(state, frame_end):
            return state
    elif fault == "half":
        def substep(state, frame_end):
            before = [_by_id(m, n, *f) for m, n, f in zip(state.models, counts, fields)]
            state = real(state, frame_end)
            models = []
            for m, n, (name, width), (pos0, f0) in zip(state.models, counts, fields, before):
                keep = m.active & (m.pid >= 0) & (m.pid < n) & (m.pid % 2 == 0)
                idx = torch.clamp(m.pid.long(), 0, n)
                pos = torch.where(keep, pos0[:, idx], m.pos)
                fld = m.fields[name].reshape(width, -1)
                fld = torch.where(keep, f0[:, idx], fld).reshape(m.fields[name].shape)
                models.append(dataclasses.replace(m, pos=pos, fields={**m.fields, name: fld}))
            return dataclasses.replace(state, models=tuple(models))
    elif fault == "altered":
        dx = 1.0 / (1 << int(config["sim"]["domain_bits"]))

        def substep(state, frame_end):
            first = int(state.step) == 0
            state = real(state, frame_end)
            if first:
                m = state.models[0]
                pos = m.pos.clone()
                pos[0] += torch.where(m.active & (m.pid == 0), 0.05 * dx, 0.0)
                state = dataclasses.replace(
                    state, models=(dataclasses.replace(m, pos=pos),) + state.models[1:])
            return state
    else:
        raise ValueError(f"unknown fault {fault!r}")
    engine.substep = substep
