"""A meshed cell on the CPU: a 2x2 ``LocalGroup`` with every shard on
``cpu`` (``data/configs/tiny_mesh.json``, a sphere across both planes of
the split, moving along +x so that particles change shard), driven
through ``harness.run_cell`` as the four-card cell is; its capture against
the same scene's one-device capture; the mesh's faults; and a one-card
run against the record the harness gave before it ran meshes."""

import copy
import json
from pathlib import Path

import pytest
import torch

from mpmbench import check, harness, scene

DATA = Path(__file__).resolve().parent / "data"
SEED = 2 ** 31 + 5


def cell_of(name):
    return scene.load_cell(name, DATA / "workloads", DATA / "configs")


def run(name, fault=None):
    torch.set_num_threads(2)
    return harness.run_cell(cell_of(name), SEED, 0.5, False, "cpu", fault=fault,
                            log=lambda s: None)


def captured(cell, substeps, seed=SEED):
    """The capture of ``cell``'s scene after ``substeps`` substeps, and the
    engine's rebuild count."""
    torch.set_num_threads(2)
    config, traffic = cell["configuration"], cell["traffic"]
    inputs = scene.make_inputs(config, seed, "cpu")
    counts = [x["pos"].shape[0] for x in inputs]
    devs = harness.cards(cell, "cpu")
    eng, state = harness.build_program(harness.import_program(), config, traffic, inputs,
                                       torch.device("cpu"), devs)
    mesh = "mesh" in config
    fe = torch.tensor(traffic["frame_end"], dtype=torch.float32)
    fe = tuple(fe for _ in devs) if mesh else fe
    cap = check.Capture(config, counts, cell["check"], "cpu",
                        owned=eng.owned_rows if mesh else None)
    if mesh:
        cap.mark_home(state)
    for _ in range(substeps):
        state = eng.substep(state, fe)
    cap.take(state, substeps)
    return cap.outputs(), eng.rebuilds


MESH_CELLS = ["tiny_mesh.fall", "tiny_mesh.rebuild_each"]


@pytest.mark.parametrize("name", MESH_CELLS)
def test_mesh_cell_is_correct(name):
    r = run(name)
    assert r["correct"], r["checks"]
    assert r["failed"] == 0 and r["attempted"] == 1905
    assert r["rebuilds"] >= 1 and r["moved"] > 0
    assert r["dropped_end"] == 0 and r["overflow_end"] == 0


def test_mesh_capture_matches_one_device():
    """Filed by id, the mesh's particles are the one-device run's, within
    the bounds ``tests/test_torch_multi.py`` holds the two engines to."""
    cell = cell_of("tiny_mesh.fall")
    one = copy.deepcopy(cell)
    del one["configuration"]["mesh"]
    one["chips"] = 1
    got, rebuilds = captured(cell, 12)
    want, _ = captured(one, 12)
    assert rebuilds >= 1 and got["moved"] > 0
    assert got["missing"] == want["missing"] == 0
    for g, w in zip(got["models"], want["models"]):
        assert float((g["pos"] - w["pos"]).abs().max()) < 2e-6
        for name, f in g["fields"].items():
            assert float((f - w["fields"][name]).abs().max()) < 2e-6
    assert got["mass"] == pytest.approx(want["mass"], rel=1e-6)


@pytest.mark.parametrize("name", MESH_CELLS)
@pytest.mark.parametrize("fault", ["halo_dropped", "migrants_lost", "unchanged", "half",
                                   "altered"])
def test_mesh_fault_is_caught(fault, name):
    r = run(name, fault)
    assert not r["correct"], (fault, r["checks"])
    assert r["failed"] >= 1
    if fault == "migrants_lost":
        assert r["checks"]["missing"][0] > 0


def test_mesh_faults_need_a_mesh():
    with pytest.raises(ValueError, match="needs a mesh"):
        run("tiny_sphere.fall", "halo_dropped")


def test_chips_must_match_the_mesh():
    cell = cell_of("tiny_mesh.fall")
    cell["chips"] = 1
    with pytest.raises(ValueError, match="chips"):
        harness.cards(cell, "cpu")
    one = cell_of("tiny_sphere.fall")
    one["chips"] = 4
    with pytest.raises(ValueError, match="chips"):
        harness.cards(one, "cpu")


@pytest.mark.parametrize("name", ["tiny_sphere.fall", "tiny_fluid.launch"])
def test_one_card_run_is_as_before(name):
    """The record's keys and every compared number of a one-card run equal,
    bit for bit, those of the harness before it ran meshes
    (``data/one_card_record.json``, taken from it on the CPU with this
    seed)."""
    want = json.loads((DATA / "one_card_record.json").read_text())[name]
    r = run(name)
    assert sorted(r) == want["keys"]
    assert {k: list(v) for k, v in r["checks"].items()} == want["checks"]
    for k in ("attempted", "failed", "correct", "compared_substeps", "particles",
              "dropped_end", "overflow_end"):
        assert r[k] == want[k], k
