"""mpmbench: the benchmark of claymore_tpu_torch on NVIDIA H100 cards.

    python3 mpmbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

runs one cell once from the root of a checkout.  The cell is
``mpmbench/workloads/<cell>.json``, its configuration
``mpmbench/configs/<config>.json``; which metrics it reports comes from
``BENCHMARK.json`` (``end_to_end`` with ``--trace 0``, ``per_layer`` with
``--trace 1``, each entry's ``workloads`` where it has one), and each
metric's reader is ``mpmbench/e2e/<name>.py`` or
``mpmbench/metrics/<name>.py``.  Earlier lines say what ran; standard
error ends with every compared number beside its limit; the last line of
standard output is the result, one JSON object.  Exits 2 without enough
CUDA cards, 3 when a module of JAX or of the JAX package is loaded.
"""

import time

T_START = time.time()

import argparse  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
# run as a file, the script's own directory would shadow modules by name
sys.path[:] = [p for p in sys.path if Path(p or ".").resolve() != HERE]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

# the program's kernel caches inside the checkout, at fixed paths
for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"), ("TRITON_CACHE_DIR", "triton"),
                 ("PYTORCH_KERNEL_CACHE_PATH", "torch_kernels")):
    os.environ.setdefault(var, str(ROOT / "build" / "mpmbench" / sub))

FORBIDDEN = ("jax", "jaxlib", "flax", "claymore_tpu")


def forbidden_modules(names=None):
    """Loaded modules (or ``names``) whose top-level name is JAX's or the
    JAX package's, compared whole."""
    names = list(sys.modules) if names is None else names
    return sorted({m.split(".")[0] for m in names} & set(FORBIDDEN))


def load_reader(kind: str, name: str):
    """The reader module ``mpmbench/<kind>/<name>.py``."""
    path = HERE / kind / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        f"mpmbench_{kind}_{name.replace('.', '_').replace('-', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def load_benchmark() -> dict:
    return json.loads((ROOT / "BENCHMARK.json").read_text())


def metrics_for(bench: dict, cell: str, trace: bool) -> list:
    """The ``BENCHMARK.json`` metric entries this cell reports."""
    entries = bench["per_layer"] if trace else bench["end_to_end"]
    return [m for m in entries if "workloads" not in m or cell in m["workloads"]]


def read_metrics(entries, kind: str, data: dict) -> dict:
    """{name: {"value", "unit"}} of the readers that find something."""
    out = {}
    for m in entries:
        value = load_reader(kind, m["name"]).read(data)
        if value is not None:
            out[m["name"]] = {"value": value, "unit": m["unit"]}
    return out


def power_limit_w():
    """The card's power limit in watts (nvidia-smi), None where unreadable."""
    try:
        out = subprocess.run(["nvidia-smi", "--id=0", "--query-gpu=power.limit",
                              "--format=csv,noheader,nounits"],
                             capture_output=True, text=True, timeout=60)
        return float(out.stdout.strip().splitlines()[0])
    except (OSError, subprocess.SubprocessError, ValueError, IndexError):
        return None


def finite_json(x):
    """``x`` with every non-finite float written as a string, so the line
    stays JSON."""
    if isinstance(x, float) and not math.isfinite(x):
        return str(x)
    if isinstance(x, dict):
        return {k: finite_json(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return [finite_json(v) for v in x]
    return x


def result_line(run: dict, cell: str, bench: dict, trace: bool, device_info: dict) -> dict:
    """The contract's JSON object, the checks under the last key."""
    rec = run["trace"]
    if trace:
        metrics = read_metrics(metrics_for(bench, cell, True), "metrics", rec)
        device_info = dict(device_info, busy_s=rec["busy_us"] * 1e-6,
                           window_s=rec["window_us"] * 1e-6)
    else:
        metrics = read_metrics(metrics_for(bench, cell, False), "e2e", run)
    line = {"correct": run["correct"], "attempted": run["attempted"], "failed": run["failed"],
            "metrics": metrics, "device": device_info}
    if trace:
        line["breakdown"] = rec["breakdown"]
    line["checks"] = {k: {"value": v, "limit": lim} for k, (v, lim) in run["checks"].items()}
    return finite_json(line)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser("mpmbench", description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    import torch

    from mpmbench import harness, scene

    cell = scene.load_cell(args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < int(cell["chips"]):
        print(f"mpmbench: {args.workload} needs {cell['chips']} CUDA card(s); "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0} available",
              file=sys.stderr)
        return 2
    bench = load_benchmark()
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    run = harness.run_cell(cell, args.seed, args.seconds, bool(args.trace), dev,
                           t_start=T_START, log=lambda s: print(s, flush=True))
    limit = power_limit_w()
    print(f"device: {int(cell['chips'])} x {torch.cuda.get_device_name(dev)}, power limit "
          f"{limit} W; "
          f"torch {torch.__version__}, CUDA {torch.version.cuda}", flush=True)
    if args.trace:
        rec = run["trace"]
        print(f"traced: {rec['substeps']} substeps, {rec['rebuilds']} rebuilds, "
              f"{len(rec['device_ops'])} device operations; least times (ms, 3.35 TB/s "
              f"at {limit} W) {json.dumps(rec['bounds'])}", flush=True)
    bad = forbidden_modules()
    if bad:
        print(f"mpmbench: modules of JAX or the JAX package are loaded: {bad}", file=sys.stderr)
        return 3
    device_info = {"platform": "gpu", "kind": torch.cuda.get_device_name(dev),
                   "count": int(cell["chips"]), "memory_peak_bytes": run["peak_bytes"]}
    line = result_line(run, args.workload, bench, bool(args.trace), device_info)
    for k, c in line["checks"].items():
        print(f"check {k} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
