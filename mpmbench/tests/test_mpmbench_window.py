"""The window's arithmetic: the trace's reduction on a made-up timeline,
the readers of the end-to-end and per-layer metrics, and the capture's
choice of the compared substep."""

from types import SimpleNamespace

import pytest
from torch.autograd import DeviceType

from mpmbench import check, run, traced

CPU, CUDA = DeviceType.CPU, DeviceType.CUDA


def ev(name, start, end, device=CUDA, card=0):
    return SimpleNamespace(name=name, time_range=SimpleNamespace(start=start, end=end),
                           device_type=device, device_index=card)


def timeline():
    # one episode 0..100 us: K2 at 10..20, K1 at 25..65, a sort at 70..80;
    # the host inside the substep call from 8 to 95, a read at 66..69
    return [
        ev(traced.EPISODE, 0, 100, CPU), ev("mpmbench.substep", 8, 95, CPU),
        ev("aten::item", 66, 69, CPU), ev(traced.EPISODE, 0, 100),
        ev("(anonymous namespace)::grid_update_kernel(float const*)", 10, 20),
        ev("void (anonymous namespace)::g2p2g_kernel<A, B>((anonymous namespace)::Params)",
           25, 65),
        ev("void at_cuda_detail::cub::DeviceRadixSortOnesweepKernel<P>(int)", 70, 80),
        ev("outside the episodes", 120, 130),
    ]


def test_reduce():
    rec = traced.reduce(timeline(), [(1e-4, [0.1], [True])])
    assert rec["window_us"] == 100 and rec["busy_us"] == 60
    assert rec["substeps"] == 1 and rec["rebuilds"] == 1
    assert len(rec["device_ops"]) == 3
    ops = dict(rec["breakdown"]["device_ops"])
    assert ops["g2p2g_kernel<A, B>"] == pytest.approx(40e-6)
    gaps = dict(rec["breakdown"]["idle_gaps"])
    # 0..10 is the harness's (no range runs at its middle), 20..25 and
    # 80..100 the substep call's, 65..70 the read's
    assert gaps["aten::item"] == pytest.approx(5e-6)
    assert gaps["mpmbench.substep"] == pytest.approx(25e-6)
    assert gaps["harness"] == pytest.approx(10e-6)


def mesh_timeline():
    # two cards, one episode 0..100 us: card 0 runs K1 at 10..50 and a halo
    # pack at 50..60, card 1 K1 at 10..30 and a peer copy at 70..75
    return [
        ev(traced.EPISODE, 0, 100, CPU), ev("mpmbench.substep", 5, 95, CPU),
        ev("aten::item", 30, 70, CPU),
        ev("g2p2g_kernel<A>", 10, 50, card=0), ev("void halo::halo_rows_kernel(int)", 50, 60),
        ev("g2p2g_kernel<A>", 10, 30, card=1), ev("Memcpy PtoP (Device -> Device)", 70, 75,
                                                  card=1),
    ]


def test_reduce_keeps_each_card():
    rec = traced.reduce(mesh_timeline(), [(1e-4, [0.1, 0.1], [False, True])], cards=[0, 1])
    assert rec["cards"] == [0, 1] and rec["op_cards"] == [0, 0, 1, 1]
    assert [tuple(op) for op in rec["device_ops"]][0] == ("g2p2g_kernel<A>", 10.0, 50.0)
    assert rec["card_busy_us"] == [50, 25] and rec["busy_us"] == 55
    ops = dict(rec["breakdown"]["device_ops"])
    assert ops["g2p2g_kernel<A>@cuda:0"] == pytest.approx(40e-6)
    assert ops["g2p2g_kernel<A>@cuda:1"] == pytest.approx(20e-6)
    gaps = dict(rec["breakdown"]["idle_gaps"])
    # card 1 idles 30..70 under the read; both 0..10 and past their last
    # operation under the substep call
    assert gaps["aten::item@cuda:1"] == pytest.approx(40e-6)
    assert gaps["mpmbench.substep@cuda:0"] == pytest.approx(50e-6)
    assert gaps["mpmbench.substep@cuda:1"] == pytest.approx(35e-6)
    got = {m: run.load_reader("metrics", m).read(rec)
           for m in ("exchange_ms", "mesh_idle_share")}
    # per substep: card 0 10 us of halo, card 1 5 us of copy
    assert got["exchange_ms"] == pytest.approx(0.005)
    assert got["mesh_idle_share"] == pytest.approx(75.0)


MESH_READERS = ("exchange_ms", "mesh_idle_share", "k1_card_ms", "rebucket_card_ms",
                "card_rebuild_ms_p95")


def test_card_readers():
    """K1 and the rebucket on the card where each is largest; the p95 of
    the window's rebuilding spans (each the longest of its cards')."""
    events = mesh_timeline() + [ev("void rebucket::place_kernel(int)", 60, 68, card=0),
                                ev("cub::DeviceRadixSortOnesweepKernel", 76, 90, card=1)]
    rec = traced.reduce(events, [(1e-4, [0.1, 0.1], [True, True])], cards=[0, 1])
    rec["window"] = {"rebuild_ms": [float(i) for i in range(1, 101)]}
    got = {m: run.load_reader("metrics", m).read(rec)
           for m in ("k1_card_ms", "rebucket_card_ms", "card_rebuild_ms_p95")}
    # two substeps, two rebuilds: card 0's 40 us of K1, card 1's 14 us of sort
    assert got["k1_card_ms"] == pytest.approx(0.02)
    assert got["rebucket_card_ms"] == pytest.approx(0.007)
    assert got["card_rebuild_ms_p95"] == pytest.approx(95.05)


def test_mesh_readers_find_nothing_on_one_card():
    rec = traced.reduce(timeline(), [(1e-4, [0.1], [True])], cards=[0])
    rec["window"] = {"rebuild_ms": [1.0]}
    assert rec["card_busy_us"] == [rec["busy_us"]]
    for m in MESH_READERS:
        assert run.load_reader("metrics", m).read(rec) is None


def test_per_layer_readers():
    rec = traced.reduce(timeline(), [(1e-4, [0.1], [True])])
    rec["bounds"] = {"k1_ms": 0.02, "k2_ms": 0.005, "rebucket_ms": 0.004}
    rec["window"] = {"drift_ms": [2.0, 4.0], "rebuild_ms": [9.0]}
    got = {m: run.load_reader("metrics", m).read(rec) for m in (
        "k1_roofline", "k2_roofline", "rebucket_ms", "rebucket_roofline", "substep_roofline",
        "device_idle_share", "drift_substep_ms")}
    assert got["k1_roofline"] == pytest.approx(50.0)
    assert got["k2_roofline"] == pytest.approx(50.0)
    assert got["rebucket_ms"] == pytest.approx(0.01)
    assert got["rebucket_roofline"] == pytest.approx(40.0)
    assert got["substep_roofline"] == pytest.approx(29.0)
    assert got["device_idle_share"] == pytest.approx(40.0)
    assert got["drift_substep_ms"] == pytest.approx(3.0)


def test_readers_find_nothing():
    rec = traced.reduce([ev(traced.EPISODE, 0, 100, CPU)], [(1e-4, [0.1], [False])])
    rec["bounds"] = {"k1_ms": 0.02, "k2_ms": 0.005, "rebucket_ms": 0.004}
    rec["window"] = {"drift_ms": [], "rebuild_ms": []}
    for m in ("k1_roofline", "k2_roofline", "rebucket_ms", "rebucket_roofline",
              "drift_substep_ms"):
        assert run.load_reader("metrics", m).read(rec) is None


def test_end_to_end_readers():
    win = {"particles": 1000, "substeps": 50, "window_s": 0.5,
           "rebuild_ms": [float(i) for i in range(1, 101)], "peak_bytes": 2 ** 31,
           "setup_s": 12.5}
    got = {m: run.load_reader("e2e", m).read(win)
           for m in ("mpps", "rebuild_ms_p95", "peak_mem_gib", "setup_s")}
    assert got == {"mpps": pytest.approx(0.1), "rebuild_ms_p95": pytest.approx(95.05),
                   "peak_mem_gib": 2.0, "setup_s": 12.5}
    assert run.load_reader("e2e", "rebuild_ms_p95").read(dict(win, rebuild_ms=[])) is None


@pytest.mark.parametrize("done,first,due", [(3, 1, False), (4, None, False), (4, 1, True),
                                            (4, 3, False), (5, 3, True), (20, 18, True)])
def test_capture_due(done, first, due):
    cap = check.Capture({"models": []}, [], {"substeps": 4, "past_first_rebuild": 2}, "cpu")
    assert cap.due(done, first) is due


def test_finite_json():
    line = run.finite_json({"a": float("inf"), "b": [float("nan"), 1.5], "c": 2})
    assert line == {"a": "inf", "b": ["nan", 1.5], "c": 2}
