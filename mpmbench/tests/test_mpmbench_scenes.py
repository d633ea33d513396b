"""Colliders and the plastic materials through the harness on the CPU:
tiny configurations with each collider kind (half-space, sphere, box, SDF),
Sand, NACC and three materials on one grid, each driven through
``harness.run_cell``; the faults that drop the colliders or freeze the
plastic state; the control; what the harness hands the program; and the
reference's colliders and plastic laws against the program's on the same
inputs."""

from pathlib import Path

import numpy as np
import pytest
import torch

from mpmbench import check, harness, scene
from mpmbench.reference import colliders as ref_colliders
from mpmbench.reference.mpm import DenseMPM, expected_mass
from mpmbench.reference.plastic import NACC, Sand, signed_svd

DATA = Path(__file__).resolve().parent / "data"
SEED = 2 ** 31 + 5
COLLIDER_CELLS = ["tiny_halfspace.run", "tiny_ball.run", "tiny_box.run", "tiny_sdf.run",
                  "tiny_multimat.run"]
PLASTIC_CELLS = ["tiny_sand.run", "tiny_nacc.run", "tiny_multimat.run"]
CELLS = COLLIDER_CELLS[:4] + PLASTIC_CELLS


def cell_of(name):
    return scene.load_cell(name, DATA / "workloads", DATA / "configs")


def run(name, fault=None, seed=SEED):
    torch.set_num_threads(2)
    return harness.run_cell(cell_of(name), seed, 0.3, False, "cpu", fault=fault,
                            log=lambda s: None)


@pytest.mark.parametrize("name", CELLS)
def test_sound_run_is_correct(name):
    r = run(name)
    assert r["correct"], r["checks"]
    assert r["failed"] == 0 and r["attempted"] == sum(
        m["particles"] for m in cell_of(name)["configuration"]["models"])
    assert r["substeps"] >= 1 and r["setup_s"] > 0


@pytest.mark.parametrize("name", COLLIDER_CELLS)
def test_colliders_dropped_is_caught(name):
    r = run(name, "colliders_dropped")
    assert not r["correct"], r["checks"]
    assert r["checks"]["pos_gap_dx"][0] > r["checks"]["pos_gap_dx"][1]
    assert r["failed"] >= 1


@pytest.mark.parametrize("name", PLASTIC_CELLS)
def test_plastic_frozen_is_caught(name):
    r = run(name, "plastic_frozen")
    assert not r["correct"], r["checks"]
    assert r["checks"]["def_gap"][0] > r["checks"]["def_gap"][1]
    assert r["failed"] >= 1


@pytest.mark.parametrize("name", ["tiny_sand.run", "tiny_sdf.run"])
@pytest.mark.parametrize("fault", ["unchanged", "half", "altered"])
def test_old_faults_are_caught(name, fault):
    r = run(name, fault)
    assert not r["correct"], (fault, r["checks"])


@pytest.mark.parametrize("name,fault", [("tiny_sand.run", "colliders_dropped"),
                                        ("tiny_sdf.run", "plastic_frozen")])
def test_fault_needs_what_it_breaks(name, fault):
    with pytest.raises(ValueError, match="needs"):
        run(name, fault)


@pytest.mark.parametrize("name", CELLS)
def test_control_fails(name):
    """The reference in bfloat16 (colliders and plastic laws included) in
    the program's place: the check says not correct."""
    torch.set_num_threads(2)
    cell = cell_of(name)
    config = cell["configuration"]
    ref = DenseMPM(config, scene.make_inputs(config, SEED, "cpu")).run(4).outputs()
    low = DenseMPM(config, scene.make_inputs(config, SEED, "cpu"),
                   torch.bfloat16).run(4).outputs()
    counts = [int(m["particles"]) for m in config["models"]]
    dx = 1.0 / (1 << config["sim"]["domain_bits"])
    checks, _, failed = check.compare(low, ref, dx, expected_mass(config, counts),
                                      cell["check"]["limits"])
    assert not check.passed(checks)
    assert failed > 0


def test_harness_hands_colliders_and_fields():
    """Every collider of the file reaches the engine as the program's own
    class with its boundary and friction; every field of every material is
    written into the state by id."""
    torch.set_num_threads(2)
    program = harness.import_program()
    cell = cell_of("tiny_multimat.run")
    config = cell["configuration"]
    inputs = scene.make_inputs(config, SEED, "cpu")
    want = [{k: v.clone() for k, v in x["fields"].items()} for x in inputs]
    eng, state = harness.build_program(program, config, cell["traffic"], inputs,
                                       torch.device("cpu"))
    (col,) = eng.colliders
    assert isinstance(col, program.SignedDistanceCollider)
    assert (col.kind, col.friction, col.bound_cells) == ("slip", 0.2, 2)
    assert col.values.shape == (32, 32, 32)
    for m, mc, w in zip(state.models, config["models"], want):
        assert set(m.fields) == {n for n, _ in scene.FIELDS[mc["material"]]}
        ids = m.pid[m.active].long()
        for name, width in scene.FIELDS[mc["material"]]:
            got = m.fields[name].reshape(width, -1)[:, m.active]
            exp = w[name][ids].reshape(-1, width).t()
            assert torch.equal(got, exp), name
    sand = config["models"][2]["params"]["log_jp0"]
    assert torch.all(state.models[2].fields["logJp"][state.models[2].active] == sand)
    none, _ = harness.build_program(program, config, cell["traffic"],
                                    scene.make_inputs(config, SEED, "cpu"),
                                    torch.device("cpu"), colliders=False)
    assert none.colliders == ()


@pytest.mark.parametrize("kind", ["half_space", "sphere", "box", "sdf", "sdf_box"])
@pytest.mark.parametrize("boundary,friction", [("sticky", 0.0), ("slip", 0.0), ("slip", 0.3),
                                               ("separate", 0.0), ("separate", 0.3)])
def test_collider_projection_matches_program(kind, boundary, friction):
    """The reference's colliders against the program's ``resolve_soa`` on
    the same nodes and velocities (the plain version of its grid kernel)."""
    torch.manual_seed(3)
    shape = {"kind": "sphere", "center": [0.45, 0.5, 0.55], "radius": 0.2}
    spec = {"half_space": {"origin": [0.1, 0.5, 0.0], "normal": [0.3, 1.0, -0.2]},
            "sphere": {"center": [0.45, 0.5, 0.55], "radius": 0.2},
            "box": {"lo": [0.3, 0.35, 0.4], "hi": [0.6, 0.62, 0.7]},
            "sdf": {"shape": shape, "nodes": 32, "spacing": 1 / 32, "band": 2},
            "sdf_box": {"shape": {"kind": "box", "lo": [0.3, 0.35, 0.4], "hi": [0.6, 0.62, 0.7]},
                        "nodes": 32, "spacing": 1 / 32, "band": 2}}[kind]
    spec = dict(spec, kind="sdf" if kind.startswith("sdf") else kind, boundary=boundary,
                friction=friction)
    (c,) = scene.make_colliders({"colliders": [spec]}, "cpu")
    (col,) = harness.program_colliders(harness.import_program(), [c])
    ijk = torch.randint(4, 60, (20000, 3))
    x = ijk.float() / 64
    v = torch.randn(20000, 3)
    got = ref_colliders.apply([c], x, v)
    want = torch.stack(col.resolve_soa(tuple(x.t()), tuple(v.t()), torch.zeros(())), dim=1)
    hit = ~torch.isclose(got, v).all(dim=1)
    assert int(hit.sum()) > 200
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)


def test_sdf_nodes_sit_on_multiples_of_the_spacing():
    sd, grad = scene.sdf_nodes({"kind": "sphere", "center": [0.5, 0.25, 0.5], "radius": 0.125},
                               9, 0.125)
    assert sd.shape == (9, 9, 9) and grad.shape == (3, 9, 9, 9)
    assert sd[4, 2, 4] == -0.125 and sd[4, 3, 4] == 0.0 and sd[4, 4, 4] == 0.125
    assert np.array_equal(grad[:, 4, 4, 4], [0.0, 1.0, 0.0])
    assert np.array_equal(grad[:, 4, 2, 4], [0.0, 0.0, 0.0])
    sd, grad = scene.sdf_nodes({"kind": "box", "lo": [0.25, 0.25, 0.25], "hi": [0.75, 0.5, 0.75]},
                               9, 0.125)
    assert sd[4, 3, 4] == -0.125 and sd[4, 4, 4] == 0.0 and sd[7, 7, 4] == pytest.approx(
        np.sqrt(0.125 ** 2 + 0.375 ** 2))
    assert np.array_equal(grad[:, 4, 3, 4], [0.0, 1.0, 0.0])


def test_signed_svd():
    torch.manual_seed(2)
    f = torch.eye(3) + 0.3 * torch.randn(4096, 3, 3)
    f[::7] = f[::7] * torch.tensor([1.0, 1.0, -1.0])
    u, s, v = signed_svd(f)
    assert torch.allclose(u @ torch.diag_embed(s) @ v.transpose(1, 2), f, atol=2e-5)
    assert torch.allclose(torch.linalg.det(u), torch.ones(4096), atol=1e-5)
    assert torch.allclose(torch.linalg.det(v), torch.ones(4096), atol=1e-5)
    assert torch.equal(s[:, 2] < 0, torch.linalg.det(f) < 0)
    assert torch.all(s[:, 0] >= s[:, 1]) and torch.all(s[:, 1] >= s[:, 2].abs())


PLASTIC_PARAMS = {
    "Sand": {"e": 1e4, "nu": 0.4, "cohesion": 0.0, "beta": 1.0, "friction_angle": 30.0,
             "volume_correction": True, "log_jp0": 0.0},
    "NACC": {"e": 1e4, "nu": 0.4, "beta": 0.5, "xi": 0.8, "friction_angle": 45.0,
             "hardening_on": True, "log_jp0": -0.01},
}


@pytest.mark.parametrize("material", ["Sand", "NACC"])
def test_plastic_law_matches_program(material):
    """The reference's return map against the program's plain material
    update on the same deformation gradients: Sand to float32 rounding;
    NACC, whose return map is discontinuous at its tips, on all but a few
    particles whose rounding puts them on the other side of a branch."""
    torch.manual_seed(4)
    n = 20000
    p = PLASTIC_PARAMS[material]
    f = torch.eye(3) + 0.01 * (2 * torch.rand(n, 3, 3) - 1)
    log_jp = p["log_jp0"] + 0.005 * torch.rand(n) * (material == "NACC")
    prog = getattr(harness.import_program(), material)(volume=1e-6, rho=1000.0, **p)
    zero = torch.zeros(n)
    out, contrib = prog.update(0.0, 0.0, (zero,) * 9,
                               {"F": f.reshape(n, 9).t().contiguous(), "logJp": log_jp})
    law = {"Sand": Sand, "NACC": NACC}[material](p, 1e-6)
    rf, rj, rc = law.project(f.clone(), log_jp.clone())
    gap = torch.maximum((out["F"].t().reshape(n, 3, 3) - rf).abs().amax(dim=(1, 2)),
                        (out["logJp"] - rj).abs())
    stress = (torch.stack(contrib, 1).reshape(n, 3, 3) - rc).abs().amax(dim=(1, 2))
    if material == "Sand":
        assert float(gap.max()) < 1e-5
        assert float(stress.max()) < 1e-4 * float(rc.abs().max())
    else:
        assert int((gap > 1e-5).sum()) < n // 200
        assert float(gap.median()) < 1e-6
