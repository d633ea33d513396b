"""Whole runs of a tiny cell on the CPU (the harness's look for a card
skipped): sound, the run is correct; with the timed path broken
underneath (``mpmbench/faults.py``), ``correct`` comes out false."""

from pathlib import Path

import pytest
import torch

from mpmbench import harness, scene

DATA = Path(__file__).resolve().parent / "data"


def run(name, fault=None, seed=2 ** 31 + 5):
    torch.set_num_threads(2)
    cell = scene.load_cell(name, DATA / "workloads", DATA / "configs")
    return harness.run_cell(cell, seed, 0.5, False, "cpu", fault=fault, log=lambda s: None)


@pytest.mark.parametrize("name", ["tiny_sphere.fall", "tiny_fluid.launch"])
def test_sound_run_is_correct(name):
    r = run(name)
    assert r["correct"], r["checks"]
    assert r["failed"] == 0 and r["attempted"] > 0
    assert r["rebuilds"] >= 1 and r["substeps"] >= 1
    assert r["setup_s"] > 0 and r["window_s"] >= 0.5


@pytest.mark.parametrize("fault", ["unchanged", "half", "altered"])
def test_fault_is_caught(fault):
    r = run("tiny_sphere.fall", fault)
    assert not r["correct"], (fault, r["checks"])
    assert r["failed"] >= 1
