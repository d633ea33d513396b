"""The frozen counts (mpmbench/counts.py) on tiny sizes against values
worked by hand."""

import pytest

from mpmbench import counts


def test_g2p2g_bound():
    # 2 x 1024 slots x (12 position + 36 F + 1 flag + 4 id) + 2 tiles x 13
    # + 3 octs x 28 x 512; 1000 particles x (1797 + 576)
    b = counts.g2p2g_bound("FixedCorotated", slots=1024, tiles=2, octs=3, active=1000)
    assert b["bytes"] == 108544 + 26 + 43008
    assert b["ops"] == 2373000
    assert b["bound_by"] == "bytes"
    assert b["bound_ms"] == pytest.approx(151578 / 3.35e12 * 1e3)
    j = counts.g2p2g_bound("JFluid", slots=512, tiles=1, octs=1, active=512)
    assert j["bytes"] == 2 * 512 * 21 + 13 + 28 * 512
    assert j["ops"] == 512 * (1797 + 42)


def test_grid_bound():
    b = counts.grid_bound(pool_rows=5, max_active_octs=4, massive_cells=100)
    assert b["bytes"] == 2 * 5 * 8192 + 16
    assert b["ops"] == 1200


def test_rebucket_bound():
    b = counts.rebucket_bound(64, slots=128, channels=13, active=100, segments=3)
    # keys 5*128 + 12*100; heads 4*101 + 4*4; plan 4*4 + 4*3 + 12*2 + 4;
    # place 8*2 + 100*(8 + 52) + 128*(52 + 1)
    assert b["bytes"] == 1840 + 420 + 56 + 12800
    assert b["sort"]["bytes"] == 16 * 128


def test_partition_bound():
    b = counts.partition_bound(64, 4, live_rows=3, tiles=2, octs=3)
    oct_mask = 3 * (4 + 2048) + 4 + 8 + 64
    remap = 64 + 16 + 4 * 65 + 8 + 3 * (4 + 8192) + 5 * 8192
    assert b["bytes"] == oct_mask + remap + 50


def test_bound_picks_the_larger():
    b = counts.bound(0, 67e9)
    assert b["bound_by"] == "operations" and b["bound_ms"] == pytest.approx(1.0)


@pytest.mark.parametrize("rows,octs,massive", [(5, 4, 100), (65537, 8192, 3_000_123),
                                               (1, 1, 0)])
def test_grid_bound_without_colliders_is_as_before(rows, octs, massive):
    """No colliders: bit for bit the arithmetic the bound had before it
    took colliders."""
    before = counts.bound(2 * rows * counts.ROW_BYTES + octs * 4, counts.K2_OPS * massive)
    assert counts.grid_bound(rows, octs, massive) == before
    assert counts.grid_bound(rows, octs, massive, ()) == before


def test_grid_bound_with_colliders_equals_the_program():
    """On a tiny state with one collider of each kind, the frozen bound of
    the harness's sizes equals the program's ``utils/bounds.py:grid_bound``
    on the same state."""
    from pathlib import Path

    import torch
    from claymore_tpu_torch.utils import bounds

    from mpmbench import harness, scene

    torch.set_num_threads(2)
    data = Path(__file__).resolve().parent / "data"
    cell = scene.load_cell("tiny_sdf.run", data / "workloads", data / "configs")
    config = cell["configuration"]
    config["colliders"] = config["colliders"] + [
        {"kind": "half_space", "origin": [0.0, 0.42, 0.0], "normal": [0.25, 1.0, 0.0],
         "boundary": "slip", "friction": 0.2},
        {"kind": "sphere", "center": [0.4, 0.3, 0.4], "radius": 0.05, "boundary": "separate",
         "friction": 0.0},
        {"kind": "box", "lo": [0.42, 0.25, 0.3], "hi": [0.6, 0.4, 0.6], "boundary": "sticky",
         "friction": 0.0}]
    eng, state = harness.build_program(harness.import_program(), config, cell["traffic"],
                                       scene.make_inputs(config, 7, "cpu"), torch.device("cpu"))
    for _ in range(3):
        state = eng.substep(state, torch.tensor(1e9))
    sizes = harness.state_sizes(state, config, eng.cfg)
    assert [c["type"] for c in sizes["colliders"]] == [
        "SignedDistanceCollider", "HalfSpace", "Sphere", "Box"]
    assert 0 < sizes["colliders"][0]["band_cells"] <= sizes["massive_cells"]
    got = counts.grid_bound(sizes["pool_rows"], sizes["max_active_octs"],
                            sizes["massive_cells"], sizes["colliders"])
    want = bounds.grid_bound(eng.cfg, state.grid, state.partition, eng.colliders)
    assert (got["bytes"], got["ops"], got["bound_by"]) == (want["bytes"], want["ops"],
                                                           want["bound_by"])
    assert got["bound_ms"] == pytest.approx(want["bound_ms"], rel=1e-12)
    assert got["bytes"] > counts.grid_bound(sizes["pool_rows"], sizes["max_active_octs"],
                                            sizes["massive_cells"])["bytes"]


def test_sdf_band_cells():
    import torch

    x = torch.tensor([0.05, 0.0625, 0.5, 0.9375, 0.95])
    y = torch.full_like(x, 0.5)
    # [2/32, 30/32) on every axis
    assert counts.sdf_band_cells((x, y, y), 0.0625, 0.9375) == 2
