"""P5's two plans and P6's count-then-stream design: the plain twins of
every phase of ``csrc/prof_dma.cu`` against numpy loops and against the TPU
probes of ``scripts/prof_dma.py`` in interpret mode.

The twins are ``probe_kernels.rmw_cover`` (P6's count), ``gather_slots``
(P5's plan of distinct starts), ``window_entries`` (the rows each block of
the window sums streams, and the window ending at each),
``plain_window_sums`` and ``plain_dma_gather_two_pass``; ``gather_plan``
picks the plan.  Every comparison is exact: the twins move values, count
whole numbers or add in the plain version's order.  Where the TPU kernels
sum, the pools hold integers whose sums stay below 2**24, except for P6's
pool of 2**24 with 0.1 in every odd lane, where adding 1.0 once per
covering program and adding the count at once round differently.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from claymore_tpu_torch.ops import probe_kernels as pk
from claymore_tpu_torch.utils.bounds import dma_bound
from tests.test_torch_probes import made, scripts  # noqa: F401  (fixtures)
from tests.torch_port_helpers import to_np

O = 64   # the TPU kernels' pool in interpret mode


def _p6_pool(o=O):
    pool = np.full((o, 16, 128), 2.0 ** 24, np.float32)
    pool[..., 1::2] = np.float32(0.1)
    return pool


# (G, D, R, starts): overlapping runs within and across programs, R = 1, 3
# and 9, every start equal, starts at 0 and at O - R, G = 1
P6_CASES = {
    "overlapping": (4, 2, 3, [0, 1, 2, 3, 10, 11, 12, 20]),
    "r1_repeats": (4, 2, 1, [5, 5, 0, 63, 7, 5, 63, 0]),
    "r9_edges": (3, 3, 9, [0, 4, 8, 55, 50, 0, 55, 55, 1]),
    "all_equal": (4, 2, 3, [7] * 8),
    "one_program": (1, 4, 3, [0, 61, 2, 1]),
}


@pytest.mark.parametrize("case", sorted(P6_CASES))
def test_rmw_matches_tpu_on_the_2p24_pool(scripts, made, case):  # noqa: F811
    """The TPU ``rmw_bench`` kernel on the pool of 2**24 with 0.1 in every
    odd lane against ``pk.rmw`` (its plain version on the CPU): the pool
    after the adds and ``out[:, 0]``, bit for bit."""
    g, d, r, starts = P6_CASES[case]
    scripts["prof_dma"].rmw_bench(O, g, d, r)
    idx = np.asarray(starts, np.int32)
    jpool, jout = made[-1](jnp.asarray(idx), jnp.asarray(_p6_pool()))
    pool = torch.from_numpy(_p6_pool())
    out = pk.rmw(pool, torch.from_numpy(idx).view(g, d), r)
    np.testing.assert_array_equal(to_np(pool), np.asarray(jpool))
    np.testing.assert_array_equal(to_np(out[:, 0]), np.asarray(jout)[:, 0])


def _numpy_cover(idx, o, r):
    cover = np.zeros(o, np.int32)
    for starts in idx:
        hit = np.zeros(o, bool)
        for s in starts:
            if 0 <= s <= o - r:
                hit[s:s + r] = True
        cover += hit
    return cover


@pytest.mark.parametrize("r", [1, 3, 9])
def test_rmw_cover_counts_programs(r):
    """P6's count twin: programs covering each row, a row two runs of one
    program share counted once, starts outside the pool left out; and the
    plain P6 adds 1.0 that many times, one add at a time."""
    rng = np.random.default_rng(r)
    o, g, d = 300, 40, 4
    idx = rng.integers(0, o - r + 1, size=(g, d)).astype(np.int32)
    idx[0] = 0
    idx[1] = o - r
    idx[2] = idx[2, 0]
    bad = idx.copy()
    bad[3, 1], bad[4, 0] = -1, o - r + 1
    for starts in (idx, bad):
        got = to_np(pk.rmw_cover(torch.from_numpy(starts), o, r))
        np.testing.assert_array_equal(got, _numpy_cover(starts, o, r))
    pool = _p6_pool(o)
    want = pool.copy()
    for k in range(1, _numpy_cover(idx, o, r).max() + 1):
        want[_numpy_cover(idx, o, r) >= k] += np.float32(1.0)
    got = torch.from_numpy(pool.copy())
    pk.rmw(got, torch.from_numpy(idx), r)
    np.testing.assert_array_equal(to_np(got), want)


@pytest.mark.parametrize("r", [1, 3, 9])
def test_gather_slots_mark_distinct_starts(r):
    """P5's plan twin: 1 + the largest flat run index naming each start."""
    rng = np.random.default_rng(10 + r)
    o, g, d = 257, 30, 4
    idx = rng.integers(0, o - r + 1, size=(g, d)).astype(np.int32)
    idx[0, 0], idx[1, 1], idx[5] = 0, o - r, idx[5, 0]
    idx[7, 2] = -3
    want = np.zeros(o, np.int32)
    for k, s in enumerate(idx.reshape(-1)):
        if 0 <= s <= o - r:
            want[s] = k + 1
    np.testing.assert_array_equal(to_np(pk.gather_slots(torch.from_numpy(idx), o, r)), want)


def _numpy_entries(slot, r, unit):
    """The window kernel's lists, block by block, as its source builds them."""
    o = slot.shape[0]
    blocks = []
    for b in range(0, o, unit):
        e = min(b + unit, o)
        rows = [x for x in range(b, min(e + r - 1, o))
                if any(slot[s] > 0 for s in range(max(b, x - r + 1), min(x, e - 1) + 1))]
        win = [int(slot[x - r + 1]) - 1 if b <= x - r + 1 < e and slot[x - r + 1] > 0
               else -1 for x in rows]
        blocks.append((rows, win))
    return blocks


def _slot_cases(o, r):
    rng = np.random.default_rng(o + r)
    return {
        "uniform": rng.integers(0, o - r + 1, size=(40, 4)),
        "all_equal": np.full((6, 4), o // 2),
        "edges": np.array([[0, o - r, 0, 1], [o - r, o - r - 1, 127, 128]]),
        "one_program": rng.integers(0, o - r + 1, size=(1, 3)),
    }


@pytest.mark.parametrize("o", [256, 300])
@pytest.mark.parametrize("r", [1, 3, 9])
def test_window_entries_match_the_kernel_lists(o, r):
    """The window twin's lists against a numpy loop over the blocks (O a
    multiple of the block's 128 rows and not): each block streams the rows
    its starts' windows span, halo past the block included, in order; each
    window's R rows are the R entries ending at its last row; every
    distinct start gets exactly one window."""
    for name, idx in _slot_cases(o, r).items():
        slot = pk.gather_slots(torch.from_numpy(idx.astype(np.int32)), o, r)
        rows, need, win = pk.window_entries(slot, r)
        blocks = _numpy_entries(to_np(slot), r, pk.WINDOW_UNIT)
        assert len(blocks) == rows.shape[0], name
        seen = []
        for u, (want_rows, want_win) in enumerate(blocks):
            got_rows = to_np(rows[u][need[u]]).tolist()
            assert got_rows == want_rows, (name, u)
            assert to_np(win[u][need[u]]).tolist() == want_win, (name, u)
            for k, w in enumerate(want_win):
                if w >= 0:
                    x = want_rows[k]
                    assert want_rows[k - r + 1:k + 1] == list(range(x - r + 1, x + 1))
                    seen.append(w)
        want = sorted(int(v) - 1 for v in to_np(slot) if v > 0)
        assert sorted(seen) == want, name


@pytest.mark.parametrize("r", [1, 3, 9])
def test_window_sums_and_two_pass_equal_plain(r):
    """The window sums against a numpy loop (row_s + ... + row_{s+R-1} in
    that order), and the two-pass plan against ``plain_dma_gather`` bit for
    bit on the TPU script's pool (``arange``, sums past 2**24) and on a
    random pool, through the wrapper's ``plan`` too."""
    rng = np.random.default_rng(20 + r)
    o = 300
    for name, idx in _slot_cases(o, r).items():
        ti = torch.from_numpy(idx.astype(np.int32))
        for pool in (np.arange(o * 2048, dtype=np.float32).reshape(o, 16, 128) * 1024,
                     rng.standard_normal((o, 16, 128)).astype(np.float32)):
            tp = torch.from_numpy(pool)
            slot = pk.gather_slots(ti, o, r)
            w = to_np(pk.plain_window_sums(tp, slot, r, ti.numel()))
            for s in np.nonzero(to_np(slot))[0]:
                part = pool[s].copy()
                for k in range(1, r):
                    part = part + pool[s + k]
                np.testing.assert_array_equal(w[int(slot[s]) - 1], part, err_msg=name)
            want = to_np(pk.plain_dma_gather(tp, ti, r))
            np.testing.assert_array_equal(to_np(pk.plain_dma_gather_two_pass(tp, ti, r)),
                                          want, err_msg=name)
            plans = pk.PLANS if r >= 2 else ("direct",)
            for plan in plans:
                np.testing.assert_array_equal(to_np(pk._launch_gather(tp, ti, r, False, plan)),
                                              want, err_msg=name)


@pytest.mark.parametrize("double_buffer", [False, True])
@pytest.mark.parametrize("r", [1, 3, 9])
def test_two_pass_matches_tpu_gather(scripts, made, double_buffer, r):  # noqa: F811
    """The TPU ``dma_gather_bench`` kernel in interpret mode against the
    two-pass twin and the direct plain version, on an integer pool (exact
    sums), with every start equal in one program, starts at 0 and O - R,
    and repeats across programs."""
    g, d = 3, 4
    scripts["prof_dma"].dma_gather_bench(O, g, d, r, double_buffer=double_buffer)
    idx = np.array([[O // 3] * 4, [0, O - r, 0, 1], [O - r, 5, O // 3, 0]], np.int32)
    pool = np.random.default_rng(r).integers(0, 1000, size=(O, 16, 128)).astype(np.float32)
    want = np.asarray(made[-1](jnp.asarray(idx.reshape(-1)), jnp.asarray(pool)))
    tp, ti = torch.from_numpy(pool), torch.from_numpy(idx)
    np.testing.assert_array_equal(to_np(pk.plain_dma_gather_two_pass(tp, ti, r)), want)
    np.testing.assert_array_equal(to_np(pk.plain_dma_gather(tp, ti, r)), want)


def test_gather_plan_rule():
    """The plan rule at the TPU script's configurations (O = 65,536): the
    expected rows of the source header, two-pass at (8192, 4, 9) (0.44 of
    the direct plan's rows), direct at (2048, 4, 9) (0.84) and (8192, 4, 3)
    (1.11), for R = 1 and past MAX_WINDOW_ROWS; the wrapper refuses a
    two-pass call it cannot run."""
    o = 65536
    est = pk.gather_rows(o, 8192, 4, 9)
    assert est["direct"] == 303104 and round(est["two_pass"]) == 134876
    assert round(pk.gather_rows(o, 2048, 4, 9)["two_pass"]) == 63869
    assert round(pk.gather_rows(o, 8192, 4, 3)["two_pass"]) == 118186
    assert pk.gather_plan(o, 8192, 4, 9) == "two_pass"
    assert pk.gather_plan(o, 2048, 4, 9) == "direct"
    assert pk.gather_plan(o, 8192, 4, 3) == "direct"
    for g, d in ((8192, 8), (5120, 16)):
        assert pk.gather_plan(o, g, d, 1) == "direct"
    assert pk.gather_plan(o, 8192, 4, pk.MAX_WINDOW_ROWS + 1) == "direct"
    pool, idx = torch.zeros((40, 16, 128)), torch.zeros((2, 2), dtype=torch.int32)
    for r, plan in ((1, "two_pass"), (pk.MAX_WINDOW_ROWS + 1, "two_pass"), (3, "sorted")):
        with pytest.raises(ValueError):
            pk._launch_gather(pool, idx, r, False, plan)


@pytest.mark.parametrize("g,d,r", [(8192, 4, 9), (2048, 4, 9), (8192, 4, 3)])
def test_gather_rows_estimate_matches_the_twins(g, d, r):
    """The rule's expected rows against what the twins count on the TPU
    script's starts (``default_rng(0).integers``): distinct starts and rows
    the window blocks stream, within 3%; ``dma_bytes`` adds them up."""
    from claymore_tpu_torch.scripts.prof_dma import gather_starts

    o = 65536
    idx = torch.from_numpy(gather_starts(o, g, d, r).astype(np.int32)).view(g, d)
    slot = pk.gather_slots(idx, o, r)
    _, need, _ = pk.window_entries(slot, r)
    counted = int(need.sum()) + int((slot > 0).sum()) + g * d + g
    est = pk.gather_rows(o, g, d, r)["two_pass"]
    assert abs(counted - est) < 0.03 * est
    pool = torch.empty((o, 16, 128))
    row = 16 * 128 * 4
    two = pk.dma_bytes("dma_gather", pool, idx, r, "two_pass")
    assert two == counted * row + 3 * o * 4 + 2 * idx.numel() * 4
    assert pk.dma_bytes("dma_gather", pool, idx, r) == (g * d * r + g) * row + idx.numel() * 4


def test_dma_bound_counts_distinct_rows():
    """The bound moved into utils/bounds.py: distinct rows once (twice for
    P6), the starts, the output."""
    idx = torch.tensor([[0, 2], [2, 10]], dtype=torch.int32)
    row = 16 * 128 * 4
    b5, b6 = dma_bound(idx, 3), dma_bound(idx, 3, rmw=True)
    assert b5["bytes"] == 8 * row + 16 + 2 * row
    assert b6["bytes"] == 2 * 8 * row + 16 + 2 * 128 * 4
    assert b5["bound_by"] == "bytes" and b6["bound_ms"] > b5["bound_ms"]
