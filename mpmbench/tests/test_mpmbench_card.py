"""A whole run of a small cell on a card, traced (``-m cuda``; skips
without a card)."""

import copy
from pathlib import Path

import pytest

from mpmbench import harness, run, scene

DATA = Path(__file__).resolve().parent / "data"


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["tiny_sphere.fall", "tiny_fluid.launch", "tiny_halfspace.run",
                                  "tiny_ball.run", "tiny_box.run", "tiny_sdf.run", "tiny_sand.run",
                                  "tiny_nacc.run", "tiny_multimat.run"])
def test_small_cell_on_card(card, name):
    cell = copy.deepcopy(scene.load_cell(name, DATA / "workloads", DATA / "configs"))
    cell["configuration"]["sim"]["particle_tile"] = 256
    r = harness.run_cell(cell, 2 ** 33 + 1, 1.0, True, card, log=lambda s: None)
    assert r["correct"], r["checks"]
    rec = r["trace"]
    assert rec["busy_us"] > 0 and rec["substeps"] > 0
    k1 = run.load_reader("metrics", "k1_roofline").read(rec)
    assert k1 is not None and 0 < k1 <= 105
