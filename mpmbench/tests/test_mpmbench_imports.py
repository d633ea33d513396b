"""What the benchmark loads: no module whose top-level name is JAX's or the
JAX package's, compared whole; the reference loads nothing of the
program."""

import json
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]


def loaded_top_names(code: str) -> set:
    out = subprocess.run(
        [sys.executable, "-c", code + "\nimport sys, json\n"
         "print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))"],
        cwd=ROOT, capture_output=True, text=True, timeout=300,
        env={"PATH": "/usr/bin:/bin", "PYTHONPATH": str(ROOT)})
    assert out.returncode == 0, out.stderr
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_run_and_program_load_no_jax():
    names = loaded_top_names(
        "import mpmbench.run as r, mpmbench.harness as h, mpmbench.traced, mpmbench.check\n"
        "h.import_program()\n"
        "for k in ('e2e', 'metrics'):\n"
        "    import pathlib\n"
        "    for p in sorted(pathlib.Path('mpmbench', k).glob('*.py')):\n"
        "        r.load_reader(k, p.stem)")
    assert "claymore_tpu_torch" in names
    assert not names & {"jax", "jaxlib", "flax", "claymore_tpu"}


def test_reference_loads_nothing_of_the_program():
    names = loaded_top_names("import mpmbench.reference.mpm, mpmbench.scene, mpmbench.check")
    assert not names & {"jax", "jaxlib", "flax", "claymore_tpu", "claymore_tpu_torch"}


def test_forbidden_names_are_whole():
    from mpmbench import run
    assert run.forbidden_modules(["claymore_tpu_torch", "claymore_tpu_torch.ops",
                                  "jaxtyping", "torch"]) == []
    assert run.forbidden_modules(["claymore_tpu.core.engine", "jax.numpy",
                                  "flax"]) == ["claymore_tpu", "flax", "jax"]


@pytest.mark.parametrize("argv", [["--workload", "sphere25m.fall", "--seed", "4294967296",
                                   "--seconds", "1", "--trace", "0"],
                                  ["--workload", "sphere100m.4card", "--seed", "4294967297",
                                   "--seconds", "1", "--trace", "1"]])
def test_cli_without_a_card_prints_no_result(argv):
    out = subprocess.run([sys.executable, "mpmbench/run.py", *argv], cwd=ROOT,
                         capture_output=True, text=True, timeout=300,
                         env={"PATH": "/usr/bin:/bin", "CUDA_VISIBLE_DEVICES": ""})
    assert out.returncode != 0
    assert "{" not in out.stdout
