"""Build and load the port's CUDA kernels.

``csrc/*.cu`` is compiled by ``nvcc`` for ``sm_90a`` into one shared library
with a plain C interface, loaded with ``ctypes``.  The library lands in
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
              "-shared", "-Xcompiler", "-fPIC"]

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float

# C signatures: pointers and the stream as c_void_p, ints as c_int
SIGNATURES = {
    "cm_grid_update": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _F, _F, _F, _P],
    "cm_g2p2g_fixed_corotated": (
        [_P] * 15 + [_I] * 6 + [_F] * 7 + [_P]),
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
    """Compile the kernels unless a library for the current sources exists.
    Returns the library path; raises with nvcc's stderr on failure."""
    lib = BUILD_DIR / LIB_NAME
    stamp = BUILD_DIR / (LIB_NAME + ".sha256")
    digest = source_hash()
    if lib.exists() and stamp.exists() and stamp.read_text().strip() == digest:
        return lib
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    cu = [str(f) for f in sorted(CSRC.glob("*.cu"))]
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp, *cu]
    if verbose:
        cmd.insert(1, "-Xptxas=-v")
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        os.unlink(tmp)
        sys.stderr.write(proc.stderr)
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{proc.stderr}")
    if verbose:
        sys.stdout.write(proc.stdout + proc.stderr)
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
