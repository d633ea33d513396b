"""The benchmark's files: every configuration, cell and metric named in
BENCHMARK.json loads by its name, and every entry keeps the contract's
shape and characters."""

import json
import re
from pathlib import Path

import pytest

from mpmbench import run, scene

ROOT = Path(__file__).resolve().parents[2]
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
ENTRY_KEYS = {
    "configs": {"name", "source", "file", "reduced", "why"},
    "workloads": {"name", "config", "traffic", "chips", "why"},
    "end_to_end": {"name", "unit", "better", "bound", "source"},
    "per_layer": {"name", "unit", "better", "source", "layer", "moves"},
}


def line_ok(text: str) -> bool:
    return 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


def test_top_level_keys():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["mpmbench"]
    assert 1 <= BENCH["run_seconds"] <= 51 and isinstance(BENCH["run_seconds"], int)
    assert all(line_ok(w) for w in BENCH["command"]) and len(BENCH["command"]) <= 32
    assert len(json.dumps(BENCH)) <= 64 * 1024


@pytest.mark.parametrize("section", sorted(ENTRY_KEYS))
def test_entry_keys_and_names(section):
    names = set()
    for e in BENCH[section]:
        extra = set(e) - ENTRY_KEYS[section]
        assert set(e) >= ENTRY_KEYS[section]
        assert extra <= ({"workloads"} if section in ("end_to_end", "per_layer") else set())
        assert NAME.match(e["name"]), e["name"]
        assert e["name"] not in names
        names.add(e["name"])
        if "unit" in e:
            assert UNIT.match(e["unit"]), e["unit"]
            assert e["better"] in ("lower", "higher")
        for key in ("why", "layer", "source"):
            if key in e and section not in ("end_to_end", "per_layer"):
                assert line_ok(e[key]), (e["name"], key)
        if section == "workloads":
            assert NAME.match(e["config"]) and NAME.match(e["traffic"])
            assert e["chips"] in (1, 4)
        if section == "configs":
            assert all(NAME.match(k) for k in e["reduced"]) and len(e["reduced"]) <= 16


def test_metric_sources_and_moves():
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    cells = [w["name"] for w in BENCH["workloads"]]
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for m in BENCH["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in BENCH["per_layer"]:
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
        assert line_ok(m["layer"])
        moved = e2e[m["moves"]]
        reported = moved.get("workloads", cells)
        assert set(m.get("workloads", cells)) <= set(reported), m["name"]
    for c in cells:
        got = [m for m in BENCH["end_to_end"] if c in m.get("workloads", cells)]
        assert len(got) >= 2 and any(m["name"] == "setup_s" for m in got)
        assert any(c in m.get("workloads", cells) for m in BENCH["per_layer"])


@pytest.mark.parametrize("entry", BENCH["configs"], ids=lambda e: e["name"])
def test_config_file_loads(entry):
    assert entry["file"] == f"mpmbench/configs/{entry['name']}.json"
    cfg = scene.load_config(entry["name"])
    assert cfg["source"] == entry["source"]
    assert cfg["reduced"] == entry["reduced"]
    for m in cfg["models"]:
        assert m["material"] in scene.FIELDS


@pytest.mark.parametrize("entry", BENCH["workloads"], ids=lambda e: e["name"])
def test_cell_file_loads(entry):
    cell = scene.load_cell(entry["name"])
    assert cell["config"] == entry["config"] and cell["chips"] == entry["chips"]
    assert cell["why"] == entry["why"]
    assert entry["name"] == f"{entry['config']}.{entry['traffic']}"
    limits = cell["check"]["limits"]
    assert set(limits) == {"pos_gap_dx", "def_gap", "mass_rel", "dt_rel", "missing",
                           "dropped", "overflow"}
    assert limits["missing"] == limits["dropped"] == limits["overflow"] == 0


@pytest.mark.parametrize("kind,entry", [("e2e", m) for m in BENCH["end_to_end"]]
                         + [("metrics", m) for m in BENCH["per_layer"]],
                         ids=lambda x: x if isinstance(x, str) else x["name"])
def test_metric_reader_loads(kind, entry):
    mod = run.load_reader(kind, entry["name"])
    assert callable(mod.read)
    if kind == "metrics":
        assert (mod.LAYER, mod.UNIT, mod.MOVES) == (entry["layer"], entry["unit"],
                                                     entry["moves"])
    else:
        assert mod.UNIT == entry["unit"]


UNLISTED = sorted({p.stem for p in (ROOT / "mpmbench" / "metrics").glob("*.py")}
                  - {m["name"] for m in BENCH["per_layer"]} - {"__init__"})


@pytest.mark.parametrize("name", UNLISTED)
def test_unlisted_reader_loads(name):
    """A per-layer reader that no ``BENCHMARK.json`` entry names yet (the
    mesh's, kept for a later cell) loads, and its metric would be a valid
    entry: a name, a unit, a layer on one line, an end-to-end metric it
    moves."""
    mod = run.load_reader("metrics", name)
    assert callable(mod.read) and NAME.match(name) and UNIT.match(mod.UNIT)
    assert line_ok(mod.LAYER)
    assert mod.MOVES in {m["name"] for m in BENCH["end_to_end"]}


def test_paths_hold_only_the_benchmark():
    files = [p for p in (ROOT / "mpmbench").rglob("*") if p.is_file()
             and "__pycache__" not in p.parts]
    assert all(re.match(r"^[A-Za-z0-9_./-]+$", str(p.relative_to(ROOT))) for p in files)


CELL_FILES = sorted(p.stem for p in (ROOT / "mpmbench" / "workloads").glob("*.json"))


@pytest.mark.parametrize("name", CELL_FILES)
def test_mesh_matches_chips(name):
    """A configuration's ``mesh`` spreads its shards over the cell's cards,
    one a card; a configuration without one runs on one card (every cell
    file, in ``BENCHMARK.json`` or not)."""
    cell = scene.load_cell(name)
    mesh = cell["configuration"].get("mesh")
    if mesh is None:
        assert cell["chips"] == 1
        return
    assert set(mesh) == {"shape", "cards", "halo_capacity", "migration_capacity"}
    assert len(mesh["shape"]) == 2 and mesh["shape"][0] * mesh["shape"][1] == mesh["cards"]
    assert mesh["cards"] == cell["chips"]
    assert mesh["halo_capacity"] > 0 and mesh["migration_capacity"] > 0
    assert {"halo_overflow", "mig_dropped"} <= set(cell["configuration"]["guarantees"])


def test_four_card_cells_within_the_allowance():
    four = [w for w in BENCH["workloads"] if w["chips"] == 4]
    assert len(four) <= max(1, len(BENCH["workloads"]) // 4)


def test_every_mpps_metric_lists_its_cells():
    for m in BENCH["per_layer"]:
        if m["moves"] == "mpps":
            assert m.get("workloads"), m["name"]
