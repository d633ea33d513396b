"""Build and load the port's CUDA kernels.

Each ``csrc/*.cu`` is compiled by its own ``nvcc`` for ``sm_90a``, all of
them at once, and the objects are linked into one shared library with a
plain C interface, loaded with ``ctypes``.  The library lands in
``build/claymore_tpu_torch/`` at the repository root and is rebuilt when the
SHA-256 of the sources changes.  Import this module only where a kernel is
about to launch: machines without ``nvcc`` import the package fine.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import sys
import tempfile
from pathlib import Path

_PKG = Path(__file__).resolve().parents[1]
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG.parent / "build" / "claymore_tpu_torch"
LIB_NAME = "libcm_kernels.so"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC"]

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float

# C signatures: pointers and the stream as c_void_p, ints as c_int
_G2P2G = [_P] * 17 + [_I] * 6 + [_F] * 4 + [_P, _I, _P]
SIGNATURES = {
    "cm_grid_update": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _F, _F, _F, _P],
    "cm_grid_update_colliders": (
        [_P] * 6 + [_I, _P] + [_I] * 6 + [_F] * 4 + [_P]),
    "cm_g2p2g_fixed_corotated": _G2P2G,
    "cm_g2p2g_jfluid": _G2P2G,
    "cm_g2p2g_sand": _G2P2G,
    "cm_g2p2g_nacc": _G2P2G,
}


def _sources():
    return sorted(CSRC.glob("*.cu")) + sorted(CSRC.glob("*.cuh"))


def source_hash() -> str:
    h = hashlib.sha256()
    for f in _sources():
        h.update(f.name.encode())
        h.update(f.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return h.hexdigest()


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def build(verbose: bool = False) -> Path:
    """Compile the kernels unless a library for the current sources exists:
    one ``nvcc -c`` per source, all started together, then one link.
    Returns the library path; raises with nvcc's stderr on failure."""
    lib = BUILD_DIR / LIB_NAME
    stamp = BUILD_DIR / (LIB_NAME + ".sha256")
    digest = source_hash()
    if lib.exists() and stamp.exists() and stamp.read_text().strip() == digest:
        return lib
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmpdir:
        objs, procs = [], []
        for cu in sorted(CSRC.glob("*.cu")):
            obj = os.path.join(tmpdir, cu.stem + ".o")
            cmd = [nvcc, *NVCC_FLAGS, "-c", "-o", obj, str(cu)]
            if verbose:
                cmd.insert(1, "-Xptxas=-v")
            objs.append(obj)
            procs.append((cu.name, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)))
        failed = []
        for name, proc in procs:
            out, err = proc.communicate()
            if proc.returncode != 0:
                failed.append(f"{name}: nvcc exit {proc.returncode}\n{err}")
            elif verbose:
                sys.stdout.write(f"--- {name}\n{out}{err}")
        if failed:
            sys.stderr.write("\n".join(failed))
            raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
        tmp = os.path.join(tmpdir, LIB_NAME)
        link = subprocess.run([nvcc, "-shared", "-o", tmp, *objs],
                              capture_output=True, text=True)
        if link.returncode != 0:
            sys.stderr.write(link.stderr)
            raise RuntimeError(f"link failed ({link.returncode}):\n{link.stderr}")
        os.replace(tmp, lib)
    stamp.write_text(digest + "\n")
    return lib


@functools.lru_cache(maxsize=None)
def library() -> ctypes.CDLL:
    """The loaded kernel library (built first if needed)."""
    lib = ctypes.CDLL(str(build()))
    for name, argtypes in SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return lib


def check(err: int, name: str) -> None:
    """Raise if a kernel entry point returned a cudaError_t other than 0."""
    if err != 0:
        raise RuntimeError(f"{name} failed to launch: cudaError_t {err}")
