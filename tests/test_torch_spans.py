"""The port's ``claymore.*`` profiler ranges: how they nest in a substep,
that they cost no ``record_function`` while no profiler records, that
``on_stage`` keeps its names and order, and ``utils/timers.py``'s
attribution of device operations to the ranges that launched them."""

from types import SimpleNamespace

import pytest
import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

import claymore_tpu_torch as ct
from claymore_tpu_torch.io.sampler import sample_uniform_box_world
from claymore_tpu_torch.utils import timers
from tests.torch_port_helpers import CPU

FE = torch.tensor(1.0)
STAGES = ["K2", "K1", "decision", "rebuild"]


def _engine(**kw):
    cfg = ct.SimConfig(domain_bits=5, max_active_blocks=256, default_dt=2e-3, **kw)
    # one tile chunk: the plain transfer then runs few operations to profile
    eng = ct.MPMEngine(cfg, [ct.FixedCorotated(volume=cfg.default_volume())], tile_chunk=64,
                       device=CPU)
    pos = sample_uniform_box_world(cfg.dx, [0.4] * 3, [0.5] * 3, cfg.ppc)
    # fast enough that the drift check rebuilds within a few substeps
    return eng, eng.init_state([pos], [(4.0, -6.0, 3.0)])


def _parents(prof):
    """{span name: set of the names of its nearest enclosing spans}."""
    out = {}
    for e in prof.events():
        if not e.name.startswith(timers.PREFIX):
            continue
        p = e.cpu_parent
        while p is not None and not p.name.startswith(timers.PREFIX):
            p = p.cpu_parent
        out.setdefault(e.name, set()).add(p.name if p is not None else None)
    return out


def test_substep_spans_nest():
    eng, st = _engine(rebucket_auto=True)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        for _ in range(3):
            st = eng.substep(st, FE)
    assert eng.substeps == 3 and eng.rebuilds >= 1
    sub = "claymore.substep"
    assert _parents(prof) == {
        sub: {None},
        "claymore.k2": {sub}, "claymore.dt": {sub}, "claymore.k1": {sub},
        "claymore.decision": {sub}, "claymore.rebuild": {sub},
        "claymore.sync.decision": {"claymore.decision"},
        **{f"claymore.rebuild.{k}": {"claymore.rebuild"}
           for k in ("sort", "plan", "place", "partition", "tiles")},
    }
    summary = timers.span_summary(prof.events())
    assert summary[sub]["count"] == 3
    assert summary["claymore.sync.decision"]["count"] == 3
    assert summary["claymore.rebuild.sort"]["count"] == eng.rebuilds
    # no CUDA activity: nothing on a device to attribute
    assert all(v["device_ms"] == 0.0 and v["stall_ms"] == 0.0 for v in summary.values())


@pytest.mark.parametrize("kw, reads", [
    (dict(rebucket_every=4), {"claymore.sync.cadence": 3}),
    (dict(rebucket_auto=True, defrag_every=2),
     {"claymore.sync.decision": 3, "claymore.sync.defrag": None,
      "claymore.sync.deferred": None}),
    (dict(rebucket_every=1), {}),
])
def test_host_reads_are_spans(kw, reads):
    """Each host read of the substep is one ``claymore.sync.<site>`` range;
    a fixed rebuild every substep reads nothing."""
    eng, st = _engine(**kw)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        for _ in range(3):
            st = eng.substep(st, FE)
    got = {k: v["count"] for k, v in timers.span_summary(prof.events()).items()
           if k.startswith(timers.SYNC)}
    assert set(got) == set(reads)
    for k, n in reads.items():
        if n is None:
            # once per rebuild that took the incremental path's choice
            assert 1 <= got[k] <= eng.rebuilds
        else:
            assert got[k] == n


def test_frame_loop_reads_once_a_substep():
    eng, st = _engine(rebucket_auto=True)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        st = eng.run_frame(st, float(st.t) + 3.5 * eng.cfg.default_dt)
    summary = timers.span_summary(prof.events())
    # one read before each substep, and the one that ends the loop
    assert eng.substeps == int(st.step) >= 4
    assert summary["claymore.sync.loop"]["count"] == eng.substeps + 1
    assert summary["claymore.substep"]["count"] == eng.substeps


def test_no_profiler_no_record_function(monkeypatch):
    """Without a profiler recording, no range is opened."""
    def refuse(*a, **k):
        raise AssertionError("record_function opened with no profiler running")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    monkeypatch.setattr(torch.autograd.profiler, "record_function", refuse)
    monkeypatch.setattr(timers, "_Range", refuse)
    eng, st = _engine(rebucket_auto=True, defrag_every=2)
    stages = []
    for _ in range(4):
        st = eng.substep(st, FE, on_stage=stages.append)
    st = eng.run_frame(st, float(st.t) + eng.cfg.default_dt)
    assert eng.rebuilds >= 1
    assert stages == STAGES * 4


@pytest.mark.parametrize("kw", [dict(rebucket_auto=True), dict(rebucket_every=1)])
def test_on_stage_names_and_order(kw):
    eng, st = _engine(**kw)
    stages = []
    for _ in range(2):
        st = eng.substep(st, FE, on_stage=stages.append)
    assert stages == STAGES * 2


@pytest.mark.parametrize("overlap, stages", [
    (True, ["K2", "reduce_max", "K1 boundary", "exchange issued", "K1 interior", "decision",
            "migrate", "mask", "rebuild", "add_halo"]),
    (False, ["K2", "reduce_max", "K1", "exchange issued", "decision", "migrate", "mask",
             "rebuild", "add_halo"]),
])
def test_mesh_stages_and_spans(overlap, stages):
    """A live comm on the CPU: ``on_stage`` in today's names and order, and
    the comm's stages and reads as ranges inside the substep."""
    cfg = ct.SimConfig(domain_bits=5, max_active_blocks=128, default_dt=5e-4,
                       rebucket_auto=True)
    mat = ct.FixedCorotated(volume=cfg.default_volume(), e=1e4, nu=0.3)
    eng = ct.MultiChipEngine(cfg, [mat], n_devices=2, tile_chunk=32, migration_capacity=256,
                             overlap_halo=overlap, device=CPU)
    pos = sample_uniform_box_world(cfg.dx, [0.35] * 3, [0.65] * 3, cfg.ppc)
    st = eng.init_state([pos], [(0.4, -0.2, 0.1)])
    got = []
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        st = eng.substep(st, 1.0, on_stage=got.append)
    assert got == stages and eng.substeps == 1
    parents = _parents(prof)
    sub = "claymore.substep"
    k1 = ["claymore.k1.boundary", "claymore.k1.interior"] if overlap else ["claymore.k1"]
    for name in ["claymore.k2", "claymore.reduce_max", "claymore.dt", *k1,
                 "claymore.exchange", "claymore.decision", "claymore.migrate",
                 "claymore.mask", "claymore.rebuild", "claymore.add_halo"]:
        assert parents[name] == {sub}, name
    assert parents["claymore.sync.flags"] == {"claymore.decision"}
    # every shard rebuilds its partition every substep under a live comm
    assert parents["claymore.rebuild.partition"] == {"claymore.rebuild"}


def ev(name, start, end, device=DeviceType.CPU, id=0, **kw):
    return SimpleNamespace(name=name, time_range=SimpleNamespace(start=start, end=end),
                           device_type=device, id=id, **kw)


def timeline(linked=True):
    """One substep 0..100 us: K2 launched at 2 under ``claymore.k2`` runs
    10..20; a fill launched at 22 under ``claymore.k1`` runs 22.5..24, K1
    launched at 23 runs 25..60; the read 62..70 (its copy launched at 63
    runs 64..65); a sort launched at 80 under ``claymore.rebuild.sort``
    runs 85..95; a copy launched by the harness at 105 runs 106..108.  The
    framework's own events number from 1 (an ``aten::zero_`` shares the
    fill's id)."""
    cuda = DeviceType.CUDA

    def op(name, s, t, cid):
        kw = dict(linked_correlation_id=cid) if linked else {}
        return ev(name, s, t, cuda, id=cid if not linked else 900 + cid, **kw)

    return [
        ev("claymore.substep", 0, 100, id=1, is_user_annotation=True),
        ev("claymore.k2", 1, 5, id=2), ev("cudaLaunchKernel", 2, 3, id=11),
        ev("claymore.k1", 21, 24.5, id=3), ev("aten::zero_", 21.5, 22.5, id=12),
        ev("cudaLaunchKernel", 22, 22.4, id=12), ev("cudaLaunchKernel", 23, 23.5, id=13),
        ev("claymore.sync.decision", 62, 70, id=4), ev("cudaMemcpyAsync", 63, 63.5, id=14),
        ev("claymore.rebuild", 75, 99, id=5), ev("claymore.rebuild.sort", 78, 90, id=6),
        ev("cudaLaunchKernel", 80, 81, id=15), ev("cudaMemcpyAsync", 105, 106, id=16),
        ev("claymore.k2", 10, 20, cuda, id=2, is_user_annotation=True),
        op("grid_update_kernel", 10, 20, 11), op("FillFunctor", 22.5, 24, 12),
        op("g2p2g_kernel", 25, 60, 13), op("Memcpy DtoH", 64, 65, 14),
        op("DeviceRadixSortOnesweepKernel", 85, 95, 15), op("Memcpy DtoD", 106, 108, 16),
        op("launched before the profile", 120, 121, 17),
    ]


@pytest.mark.parametrize("linked", [True, False])
def test_span_ops_attribution(linked):
    spans, ops = timers.span_ops(timeline(linked))
    assert [s[0] for s in spans] == ["claymore.substep", "claymore.k2", "claymore.k1",
                                     "claymore.sync.decision", "claymore.rebuild",
                                     "claymore.rebuild.sort"]
    sub = ("claymore.substep",)
    assert [(o[0], o[3]) for o in ops] == [
        ("grid_update_kernel", sub + ("claymore.k2",)),
        ("FillFunctor", sub + ("claymore.k1",)),
        ("g2p2g_kernel", sub + ("claymore.k1",)),
        ("Memcpy DtoH", sub + ("claymore.sync.decision",)),
        ("DeviceRadixSortOnesweepKernel", sub + ("claymore.rebuild", "claymore.rebuild.sort")),
        ("Memcpy DtoD", ()),
        ("launched before the profile", ()),
    ]


def test_span_summary():
    got = timers.span_summary(timeline())
    assert got["claymore.substep"]["count"] == 1
    assert got["claymore.substep"]["host_ms"] == pytest.approx(0.1)
    assert got["claymore.substep"]["device_ms"] == pytest.approx(0.0575)
    assert got["claymore.k1"]["device_ms"] == pytest.approx(0.0365)
    assert got["claymore.k2"]["device_ms"] == pytest.approx(0.010)
    # a span's sum holds its children's
    assert got["claymore.rebuild"]["device_ms"] == pytest.approx(0.010)
    assert got["claymore.rebuild.sort"]["device_ms"] == pytest.approx(0.010)
    # idle from the read's end (70) to the sort (85)
    assert got["claymore.sync.decision"]["stall_ms"] == pytest.approx(0.015)
    assert all(v["stall_ms"] == 0.0 for k, v in got.items() if not k.startswith(timers.SYNC))


def test_stall_only_where_the_device_idles():
    """A read that ends while an earlier operation still runs stalls
    nothing; a read with no later operation stalls nothing either."""
    cuda = DeviceType.CUDA
    events = [
        ev("claymore.sync.flags", 0, 10, id=1), ev("cudaLaunchKernel", 1, 2, id=11),
        ev("k", 5, 30, cuda, id=11), ev("cudaLaunchKernel", 15, 16, id=12),
        ev("k2", 31, 40, cuda, id=12), ev("claymore.sync.loop", 50, 60, id=2),
    ]
    got = timers.span_summary(events)
    assert got["claymore.sync.flags"]["stall_ms"] == 0.0
    assert got["claymore.sync.loop"]["stall_ms"] == 0.0
    assert got["claymore.sync.flags"]["device_ms"] == pytest.approx(0.025)


def test_span_summary_without_spans():
    cuda = DeviceType.CUDA
    assert timers.span_summary([ev("cudaLaunchKernel", 1, 2, id=11),
                                ev("k", 5, 30, cuda, id=11)]) == {}
