"""The plain reference against the program's CPU path (the kernels' plain
versions) on tiny scenes, driven from the test through the program's
public API; and the control, the reference in bfloat16, failing the check
at the same size."""

from pathlib import Path

import pytest
import torch

from mpmbench import check, harness, scene
from mpmbench.reference.mpm import DenseMPM, expected_mass, polar_rotation

DATA = Path(__file__).resolve().parent / "data"
SEED = 2 ** 31 + 977
CELLS = ["tiny_sphere.fall", "tiny_fluid.launch"]


def cell_of(name):
    return scene.load_cell(name, DATA / "workloads", DATA / "configs")


def program_outputs(cell, seed, substeps):
    """The program's state after ``substeps`` substeps of ``cell``'s scene,
    in ``check.compare``'s form."""
    torch.manual_seed(0)
    config, traffic = cell["configuration"], cell["traffic"]
    program = harness.import_program()
    inputs = scene.make_inputs(config, seed, "cpu")
    counts = [x["pos"].shape[0] for x in inputs]
    eng, state = harness.build_program(program, config, traffic, inputs, torch.device("cpu"))
    fe = torch.tensor(traffic["frame_end"], dtype=torch.float32)
    for _ in range(substeps):
        state = eng.substep(state, fe)
    cap = check.Capture(config, counts, cell["check"], "cpu")
    cap.take(state, substeps)
    return cap.outputs(), counts, eng.rebuilds


@pytest.mark.parametrize("name", CELLS)
def test_reference_matches_program(name):
    torch.set_num_threads(2)
    cell = cell_of(name)
    config = cell["configuration"]
    got, counts, rebuilds = program_outputs(cell, SEED, 14)
    assert rebuilds >= 1
    ref = DenseMPM(config, scene.make_inputs(config, SEED, "cpu")).run(14).outputs()
    dx = 1.0 / (1 << config["sim"]["domain_bits"])
    checks, attempted, failed = check.compare(got, ref, dx, expected_mass(config, counts),
                                              cell["check"]["limits"])
    assert check.passed(checks), checks
    assert attempted == sum(counts) and failed == 0
    # both moved the particles: the comparison is not of two frozen states
    x0 = scene.make_inputs(config, SEED, "cpu")[0]["pos"]
    assert float((ref["models"][0]["pos"] - x0).abs().max()) > 0.1 * dx


@pytest.mark.parametrize("name", CELLS)
def test_control_fails(name):
    """The reference in bfloat16, the precision below the configuration's
    float32, put in the program's place: the check says not correct."""
    torch.set_num_threads(2)
    cell = cell_of(name)
    config = cell["configuration"]
    ref = DenseMPM(config, scene.make_inputs(config, SEED, "cpu")).run(8).outputs()
    low = DenseMPM(config, scene.make_inputs(config, SEED, "cpu"),
                   torch.bfloat16).run(8).outputs()
    counts = [int(m["particles"]) for m in config["models"]]
    dx = 1.0 / (1 << config["sim"]["domain_bits"])
    checks, _, failed = check.compare(low, ref, dx, expected_mass(config, counts),
                                      cell["check"]["limits"])
    assert not check.passed(checks)
    assert checks["pos_gap_dx"][0] > checks["pos_gap_dx"][1]
    assert failed > 0


def test_polar_rotation():
    torch.manual_seed(1)
    f = torch.eye(3) + 0.1 * torch.randn(64, 3, 3, dtype=torch.float64)
    r = polar_rotation(f)
    u, _, vh = torch.linalg.svd(f)
    want = u @ vh
    assert torch.allclose(r, want, atol=1e-10)
