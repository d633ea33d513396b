"""One run of one cell: set-up, the window of replayed episodes, the
traced episodes, the reference and the check.

The window replays **episodes**.  Set-up makes the cell's initial state
once and keeps it, the snapshot; each episode restores a copy of it
(synchronised, outside the episode's clock) and runs the cell's
``episode_substeps`` substeps through ``MPMEngine.substep``, so a fast
program and a slow one are judged on the same substeps of the same scene.
An episode's clock starts after the restore's synchronise and stops at the
synchronise that ends it; the window ends at the first substep boundary
after ``seconds`` of summed episode time.  A CUDA event is recorded on the
stream before and after every ``substep`` call, and the events are read
only after an episode's closing synchronise: the window adds no
synchronise between substeps.  A substep rebuilt when
``MPMEngine.rebuilds`` rose during its call.

Set-up: the inputs (``scene.make_inputs``), the program's ``SimConfig``,
materials, ``exact_tiles`` and ``init_state``, the pre-strain written into
the initial state by id, the snapshot, the capture's buffers, and one
whole warm-up episode (every shape the window runs, a rebuild included).

A configuration with a ``mesh`` runs the program's mesh,
``MultiChipEngine`` over ``LocalGroup``, one shard a card (``cuda:0`` to
``cuda:<cards - 1>``; on the CPU every shard on ``cpu``): its state is a
tuple of shard states, the synchronises cover every card, the CUDA events
are recorded on every card's stream (a substep's span is the longest of
its cards' spans), the peak is the fullest card's, and the capture files
every shard's particles into buffers on card 0.
"""

from __future__ import annotations

import dataclasses
import gc
import time

import torch

from . import check, scene

SUBSTEP = "mpmbench.substep"


def import_program():
    """The system under test, ``claymore_tpu_torch``, and its kernel
    wrappers (whose launch counters the run prints)."""
    import claymore_tpu_torch as program
    from claymore_tpu_torch.ops import (g2p2g_kernel, grid_kernel,  # noqa: F401
                                        partition_kernel, rebucket_kernel)

    return program


def clone(x):
    """A deep copy of a state: every tensor cloned on its device."""
    if isinstance(x, torch.Tensor):
        return x.clone()
    if dataclasses.is_dataclass(x) and not isinstance(x, type):
        return type(x)(**{f.name: clone(getattr(x, f.name)) for f in dataclasses.fields(x)})
    if isinstance(x, dict):
        return {k: clone(v) for k, v in x.items()}
    if isinstance(x, (tuple, list)):
        return type(x)(clone(v) for v in x)
    return x


def sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def shards(state) -> tuple:
    """The shard states of a state: a mesh's tuple, or one state."""
    return state if isinstance(state, tuple) else (state,)


def cards(cell: dict, device) -> list:
    """The devices a cell's run uses: ``device`` alone, or for a mesh one
    card a shard from ``cuda:0`` (every shard on ``device`` off the cards).
    Refuses a cell whose ``chips`` differs from its mesh's ``cards``."""
    dev = torch.device(device)
    mesh = cell["configuration"].get("mesh")
    n = int(mesh["cards"]) if mesh else 1
    if int(cell["chips"]) != n:
        raise ValueError(f"{cell['name']}: chips {cell['chips']}, its configuration runs "
                         f"on {n} card(s)")
    if not mesh:
        return [dev]
    return [torch.device("cuda", i) for i in range(n)] if dev.type == "cuda" else [dev] * n


def launch_counts() -> dict:
    """The program's launch counters (kernel wrapper calls), where it has
    them."""
    out = {}
    try:
        from claymore_tpu_torch.ops import (g2p2g_kernel, grid_kernel, partition_kernel,
                                            rebucket_kernel)
        for name, c in (("k2", grid_kernel.grid_update.launches),
                        ("k1", g2p2g_kernel.g2p2g.launches),
                        ("partition", partition_kernel.launches),
                        ("rebucket", getattr(rebucket_kernel, "launches", {}))):
            for k, v in c.items():
                if v:
                    out[f"{name}.{k}"] = v
    except (ImportError, AttributeError):
        pass
    return out


def build_program(program, config: dict, traffic: dict, inputs, device, devices=None):
    """(engine, initial state) through the program's public API, as a user
    builds a scene: ``SimConfig``, the materials, ``exact_tiles``,
    ``MPMEngine`` and ``init_state``; then the inputs' deformation field
    written into the state by id.  With a ``mesh`` in the configuration,
    ``MultiChipEngine`` over ``devices`` (one a shard), which sizes its
    tiles itself (``exact_tiles`` with ``tile_slack`` as its capacity
    factor), and the field written into every shard."""
    sim = dict(config["sim"])
    sim["gravity"] = tuple(sim["gravity"])
    sim.update(rebucket_auto=bool(traffic["rebucket_auto"]),
               rebucket_every=int(traffic["rebucket_every"]))
    cfg = program.SimConfig(**sim)
    parts = [x["pos"].cpu().numpy() for x in inputs]
    for x in inputs:
        x["pos"] = None
    mesh = config.get("mesh")
    if mesh is None:
        cfg = dataclasses.replace(cfg, max_tiles=program.exact_tiles(
            cfg, parts, slack=float(config["tile_slack"])))
    mats = [getattr(program, m["material"])(volume=cfg.default_volume(), **m["params"])
            for m in config["models"]]
    if mesh is None:
        eng = program.MPMEngine(cfg, mats, (), tile_chunk=int(config["tile_chunk"]),
                                device=device)
    else:
        eng = program.MultiChipEngine(
            cfg, mats, mesh_shape=tuple(mesh["shape"]), device=list(devices),
            halo_capacity=int(mesh["halo_capacity"]),
            migration_capacity=int(mesh["migration_capacity"]),
            tile_chunk=int(config["tile_chunk"]),
            particle_capacity_factor=float(config["tile_slack"]))
    state = eng.init_state(parts, [x["v0"] for x in inputs])
    del parts
    for shard in shards(state):
        for m, x in zip(shard.models, inputs):
            name, width = scene.FIELDS[x["material"]]
            fld = m.fields[name]
            src = x["field"].device
            idx = torch.clamp(torch.where(m.active, m.pid.long(), 0), 0,
                              x["field"].shape[0] - 1).to(src)
            val = x["field"][idx].to(fld.device)
            val = val.t().reshape(fld.shape) if width > 1 else val
            fld.copy_(torch.where(m.active, val, fld))
    for x in inputs:
        x["field"] = None
    return eng, state


class Episodes:
    """The snapshot and the episode loop."""

    def __init__(self, engine, snapshot, frame_end, episode_substeps: int, device,
                 capture=None, devices=None):
        self.engine = engine
        self.snapshot = snapshot
        self.frame_end = frame_end
        self.n = episode_substeps
        self.device = device
        self.devices = list(devices) if devices else [device]
        self.capture = capture
        self.state = None
        cuda = device.type == "cuda"
        # one (start, end) pair a card for every substep
        self.events = [[(torch.cuda.Event(enable_timing=True),
                         torch.cuda.Event(enable_timing=True)) for _ in self.devices]
                       for _ in range(self.n)] if cuda else None

    def run(self, limit_s=None, elapsed: float = 0.0, capture: bool = False, label=None):
        """One episode: (seconds, spans ms, rebuilt flags).  Stops early at
        the first substep boundary where ``elapsed`` plus this episode's
        time reaches ``limit_s`` (never before a pending capture)."""
        eng, dev = self.engine, self.device
        self.state = None
        state = clone(self.snapshot)
        for d in self.devices:
            sync(d)
        streams = [torch.cuda.current_stream(d) for d in self.devices] if self.events else None
        host_marks = []
        rebuilt = []
        first_rebuild = None
        pending = capture and self.capture is not None
        rng = torch.profiler.record_function(label) if label else None
        if rng is not None:
            rng.__enter__()
        t0 = time.perf_counter()
        for k in range(self.n):
            r0 = eng.rebuilds
            if self.events:
                for (start, _), stream in zip(self.events[k], streams):
                    start.record(stream)
            else:
                host_marks.append(time.perf_counter())
            if label:
                with torch.profiler.record_function(SUBSTEP):
                    state = eng.substep(state, self.frame_end)
            else:
                state = eng.substep(state, self.frame_end)
            if self.events:
                for (_, end), stream in zip(self.events[k], streams):
                    end.record(stream)
            else:
                host_marks.append(time.perf_counter())
            rebuilt.append(eng.rebuilds != r0)
            if rebuilt[-1] and first_rebuild is None:
                first_rebuild = k + 1
            if pending and (self.capture.due(k + 1, first_rebuild) or k + 1 == self.n):
                self.capture.take(state, k + 1)
                pending = False
            if (limit_s is not None and not pending
                    and elapsed + time.perf_counter() - t0 >= limit_s):
                break
        for d in self.devices:
            sync(d)
        t = time.perf_counter() - t0
        if rng is not None:
            rng.__exit__(None, None, None)
        done = len(rebuilt)
        if self.events:
            spans = [max(a.elapsed_time(b) for a, b in self.events[k]) for k in range(done)]
        else:
            spans = [(host_marks[2 * k + 1] - host_marks[2 * k]) * 1e3 for k in range(done)]
        self.state = state
        return t, spans, rebuilt

    def window(self, seconds: float) -> dict:
        """Episodes until ``seconds`` of episode time: the window's record."""
        total, eps = 0.0, []
        while True:
            t, spans, rebuilt = self.run(seconds, total, capture=not eps)
            total += t
            eps.append({"seconds": t, "spans": spans, "rebuilt": rebuilt})
            if total >= seconds:
                return {"seconds": total, "episodes": eps}

    def close(self):
        self.state = None
        self.snapshot = None


def window_stats(win: dict, particles: int) -> dict:
    """The numbers the end-to-end readers take from a window."""
    eps = win["episodes"]
    spans = [s for e in eps for s in e["spans"]]
    flags = [f for e in eps for f in e["rebuilt"]]
    return {
        "particles": particles,
        "window_s": win["seconds"],
        "episodes": len(eps),
        "substeps": len(flags),
        "rebuilds": sum(flags),
        "rebuilds_per_episode": [sum(e["rebuilt"]) for e in eps],
        "rebuild_ms": [s for s, f in zip(spans, flags) if f],
        "drift_ms": [s for s, f in zip(spans, flags) if not f],
    }


def state_sizes(state, config: dict, cfg) -> dict:
    """Counts of a state the frozen bounds take (``counts.py``); of a mesh,
    its fullest shard's (the most live particles)."""
    if isinstance(state, tuple):
        state = max(state, key=lambda s: sum(int(m.active.sum()) for m in s.models))
    rows = state.grid.shape[0]
    massive = int((state.grid[:, 0:4] > 0).sum())
    models = []
    for m, mc in zip(state.models, config["models"]):
        act = m.active
        pos = m.pos[:, act]
        base = torch.floor(pos * cfg.dx_inv + 0.5).to(torch.int64) - 1
        hb = (base - 1) >> cfg.block_bits
        g = cfg.grid_size
        keys = (hb[0] * g + hb[1]) * g + hb[2]
        _, width = scene.FIELDS[mc["material"]]
        models.append({"material": mc["material"], "slots": int(m.pos.shape[1]),
                       "tiles": int(m.tiles.block.shape[0]), "active": int(act.sum()),
                       "segments": int(torch.unique(keys).numel()),
                       "channels": 3 + width + 1})
    return {"pool_rows": rows, "massive_cells": massive,
            "octs": int(state.partition.count[0]), "max_active_octs": cfg.max_active_octs,
            "num_oct_keys": cfg.num_oct_keys, "particle_tile": cfg.particle_tile,
            "models": models}


def run_cell(cell: dict, seed: int, seconds: float, trace: bool, device, t_start=None,
             fault=None, log=print) -> dict:
    """One run of ``cell``: returns the run's record (window numbers,
    set-up time, peak memory, the checks, the traced record or None)."""
    from . import traced
    from .reference.mpm import DenseMPM, expected_mass

    t_start = time.time() if t_start is None else t_start
    dev = torch.device(device)
    config, traffic = cell["configuration"], cell["traffic"]
    devs = cards(cell, dev)
    mesh = "mesh" in config
    program = import_program()
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
        for d in devs:
            torch.cuda.reset_peak_memory_stats(d)

    # ---- set-up
    inputs = scene.make_inputs(config, seed, dev)
    counts = [x["pos"].shape[0] for x in inputs]
    particles = sum(counts)
    eng, snapshot = build_program(program, config, traffic, inputs, dev, devs)
    del inputs
    if fault is not None:
        from . import faults
        faults.install(eng, fault, config, counts)
    frame_end = torch.tensor(float(traffic["frame_end"]), dtype=torch.float32, device=dev)
    if mesh:
        frame_end = tuple(frame_end.to(d) for d in eng.devices)
    capture = check.Capture(config, counts, cell["check"], dev,
                            owned=eng.owned_rows if mesh else None)
    if mesh:
        capture.mark_home(snapshot)
    eps = Episodes(eng, snapshot, frame_end, int(traffic["episode_substeps"]), dev, capture,
                   devs)
    del snapshot
    _, _, warm = eps.run(capture=True)                      # warm-up
    capture.substeps = None
    for d in devs:
        sync(d)
    setup_s = time.time() - t_start
    log(f"warm-up episode: {sum(warm)} rebuilds in {len(warm)} substeps, the first on substep "
        f"{warm.index(True) + 1 if any(warm) else None}")

    # ---- the window
    win = eps.window(seconds)
    stats = window_stats(win, particles)
    stats["setup_s"] = setup_s
    log(f"window: {stats['episodes']} episodes, {stats['substeps']} substeps, "
        f"{stats['rebuilds']} rebuilds, {stats['window_s']:.6f} s; rebuilds per episode "
        f"{stats['rebuilds_per_episode']}; compared after substep {capture.substeps}")
    log("episodes (seconds, substeps, summed spans ms): " + "; ".join(
        f"{e['seconds']:.4f} {len(e['spans'])} {sum(e['spans']):.1f}" for e in win["episodes"]))
    log(f"launches {launch_counts()}")

    rec = None
    if trace:
        t_trace = time.time()
        rec = traced.trace_episodes(eps, int(traffic["trace_episodes"]), dev)
        rec["sizes"] = state_sizes(eps.snapshot, config, eng.cfg)
        log(f"traced: {traffic['trace_episodes']} episode(s) and the reduction in "
            f"{time.time() - t_trace:.1f} s")
    closing = shards(eps.state)
    stats["dropped_end"] = int(sum(int(m.tiles.dropped.sum()) for s in closing
                                   for m in s.models))
    stats["overflow_end"] = int(sum(int(s.partition.overflow.sum()) for s in closing))
    if mesh:
        stats["dropped_end"] += int(sum(int(s.mig_dropped.sum()) for s in closing))
        stats["overflow_end"] += int(sum(int(s.halo_overflow.sum()) for s in closing))
    closing = None
    stats["peak_bytes"] = (max(torch.cuda.max_memory_allocated(d) for d in devs)
                           if dev.type == "cuda" else None)

    # ---- the check: the program's state freed, then the reference
    got = capture.outputs()
    if mesh:
        stats["moved"] = got["moved"]
        log(f"particles held by another shard than at set-up when compared: {got['moved']}")
    got["dropped"] = max(got["dropped"], stats["dropped_end"])
    got["overflow"] = max(got["overflow"], stats["overflow_end"])
    cfg = eng.cfg
    eps.close()
    del eps, eng
    capture_substeps = capture.substeps
    capture = None
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    t_ref = time.time()
    ref = DenseMPM(config, scene.make_inputs(config, seed, dev), torch.float32, dev,
                   float(traffic["frame_end"])).run(capture_substeps)
    out = ref.outputs()
    checks, attempted, failed = check.compare(
        got, out, cfg.dx, expected_mass(config, counts), cell["check"]["limits"])
    del ref, out, got
    log(f"reference: {capture_substeps} substeps in {time.time() - t_ref:.1f} s")
    stats.update(checks=checks, attempted=attempted, failed=failed,
                 correct=check.passed(checks), trace=rec, compared_substeps=capture_substeps)
    if rec is not None:
        rec["window"] = stats
        rec["bounds"] = traced.bounds(rec["sizes"])
    return stats

