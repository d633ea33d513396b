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
