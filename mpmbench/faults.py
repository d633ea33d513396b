"""Faults planted under the timed path, to show that the check sees them.

Each is installed by ``harness.run_cell(..., fault=name)`` on the engine
the window drives, ``MPMEngine`` or a mesh's ``MultiChipEngine``; neither
the benchmark's command nor its runs use them.  The tests drive a whole
run with each (``tests/test_mpmbench_faults.py``) and ``control.py`` reads
them at a cell's own size.

Wrappers of the engine's ``substep`` (every engine):

* ``unchanged``: the substep returns its state as it was given.
* ``half``: the particles with even ids keep the position and deformation
  they had before the substep: half of the particles left out of it.
* ``altered``: the particle with id 0 is moved by 0.05 dx along x where
  the substep produces it, once an episode (on its first substep).

Wrappers of the mesh's exchange (``MultiChipEngine`` only):

* ``halo_dropped``: each shard adds all but the first direction's rows it
  received (``HaloComm.add_halo``): one direction's halo left out.
* ``migrants_lost``: the migrants shipped across the +x faces never
  arrive (the group's ``shift`` by +1 along the first mesh axis outside
  the halo's side streams returns nothing), and no counter counts them.
"""

from __future__ import annotations

import dataclasses

import torch

from .harness import shards as _shards
from .scene import FIELDS


def _by_id(states, i, counts_n, name, width, device):
    """Model ``i``'s positions and field filed by id over every shard, on
    ``device``: ([3, N+1], [width, N+1])."""
    pos = torch.zeros((3, counts_n + 1), dtype=torch.float32, device=device)
    f = torch.zeros((width, counts_n + 1), dtype=torch.float32, device=device)
    for st in states:
        model = st.models[i]
        ok = model.active & (model.pid >= 0) & (model.pid < counts_n)
        idx = torch.where(ok, model.pid.long(), counts_n).to(device)
        pos.index_copy_(1, idx, model.pos.to(device))
        f.index_copy_(1, idx, model.fields[name].reshape(width, -1).to(device))
    return pos, f


def install(engine, fault: str, config: dict, counts):
    """Replace the engine's ``substep``, or a hook of its mesh exchange, by
    its faulty form ``fault``."""
    real = engine.substep
    fields = [FIELDS[m["material"]] for m in config["models"]]

    if fault in ("halo_dropped", "migrants_lost"):
        comm = getattr(engine, "comm", None)
        if comm is None or comm.trivial:
            raise ValueError(f"fault {fault!r} needs a mesh")
        if fault == "halo_dropped":
            add_halo = comm.add_halo
            comm.add_halo = lambda pool, partition, received: add_halo(
                pool, partition, received[1:])
        else:
            shift = comm.group.shift

            def lossy(xs, axis, step, side=False):
                out = shift(xs, axis, step, side)
                return [None] * len(out) if (not side and axis == 0 and step == 1) else out
            comm.group.shift = lossy
        return
    if fault == "unchanged":
        def substep(state, frame_end):
            return state
    elif fault == "half":
        def substep(state, frame_end):
            dev = _shards(state)[0].grid.device
            before = [_by_id(_shards(state), i, n, *f, dev)
                      for i, (n, f) in enumerate(zip(counts, fields))]
            state = real(state, frame_end)
            out = []
            for st in _shards(state):
                models = []
                for m, n, (name, width), (pos0, f0) in zip(st.models, counts, fields, before):
                    keep = m.active & (m.pid >= 0) & (m.pid < n) & (m.pid % 2 == 0)
                    idx = torch.clamp(m.pid.long(), 0, n).to(dev)
                    pos = torch.where(keep, pos0[:, idx].to(m.pos.device), m.pos)
                    fld = m.fields[name].reshape(width, -1)
                    fld = torch.where(keep, f0[:, idx].to(fld.device), fld)
                    fld = fld.reshape(m.fields[name].shape)
                    models.append(dataclasses.replace(m, pos=pos,
                                                      fields={**m.fields, name: fld}))
                out.append(dataclasses.replace(st, models=tuple(models)))
            return tuple(out) if isinstance(state, tuple) else out[0]
    elif fault == "altered":
        dx = 1.0 / (1 << int(config["sim"]["domain_bits"]))

        def substep(state, frame_end):
            first = int(_shards(state)[0].step) == 0
            state = real(state, frame_end)
            if not first:
                return state
            out = []
            for st in _shards(state):
                m = st.models[0]
                pos = m.pos.clone()
                pos[0] += torch.where(m.active & (m.pid == 0), 0.05 * dx, 0.0)
                out.append(dataclasses.replace(
                    st, models=(dataclasses.replace(m, pos=pos),) + st.models[1:]))
            return tuple(out) if isinstance(state, tuple) else out[0]
    else:
        raise ValueError(f"unknown fault {fault!r}")
    engine.substep = substep
