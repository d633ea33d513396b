"""Build and load the port's CUDA kernels.

Each ``csrc/*.cu`` is compiled by its own ``nvcc`` for ``sm_90a``, all of
them at once, and the objects are linked into one shared library with a
plain C interface, loaded with ``ctypes``.  The library lands in
``build/claymore_tpu_torch/`` at the repository root and is rebuilt when the
SHA-256 of the sources changes.  Import this module only where a kernel is
about to launch: machines without ``nvcc`` import the package fine.

The host code in ``csrc/*.cpp`` (weighted sample elimination, the BGEO
writer) is built the same way by ``g++`` into a library of its own
(``host_library``), which is None where no compiler is found or the build
fails: its callers have a plain fallback.
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
_G2P2G = [_P] * 21 + [_I] * 9 + [_F] * 4 + [_P, _I, _P]
# the probes: (x, shifts, out, tiles, stream); P5 (pool, idx, out, slot,
# wsum, rows, programs, runs, run_rows, plan, stream); P6 (pool, idx, out,
# cover, rows, programs, runs, run_rows, stream)
_LANEOPS = [_P, _P, _P, _I, _P]
_DMA = [_P] * 5 + [_I] * 5 + [_P]
SIGNATURES = {
    "cm_prof_dyn_roll": _LANEOPS,
    "cm_prof_dyn_lane_read": _LANEOPS,
    "cm_prof_dyn_lane_read_wide": _LANEOPS,
    "cm_prof_dyn_lane_write": _LANEOPS,
    "cm_prof_dma_gather": _DMA,
    "cm_prof_dma_gather_ring": _DMA,
    "cm_prof_rmw": [_P] * 4 + [_I] * 4 + [_P],
    # (sub-kernel, run_rows, out i32[3]): registers, blocks per SM, smem
    "cm_prof_dma_info": [_I, _I, _P],
    "cm_grid_update": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _F, _F, _F, _P],
    "cm_grid_update_colliders": (
        [_P] * 6 + [_I, _P, _P] + [_I] * 6 + [_F] * 4 + [_P]),
    "cm_grid_update_sdf": (
        [_P] * 6 + [_I, _P, _I, _P, _P] + [_I] * 6 + [_F] * 4 + [_P]),
    # (variant, colliders, out i32[4]): registers, blocks per SM, dynamic
    # shared memory, the most colliders a launch takes
    "cm_grid_update_info": [_I, _I, _P],
    "cm_g2p2g_fixed_corotated": _G2P2G,
    "cm_g2p2g_jfluid": _G2P2G,
    "cm_g2p2g_sand": _G2P2G,
    "cm_g2p2g_nacc": _G2P2G,
    # (variant, span, tile, out i32[3]) or (probe, out i32[3]): registers,
    # blocks per SM, smem
    "cm_g2p2g_info": [_I, _I, _I, _P],
    "cm_prof_laneops_info": [_I, _P],
    # the rebucket (csrc/rebucket.cu): keys (pos, active, n, dx_inv,
    # block_bits, g, key, stream); heads (skey, n, sentinel, seg_start,
    # cta_count, cta_off, meta, stream); plan (skey, seg_start, meta, tile,
    # group_tiles, num_tiles, off, n3, cta_sum, cta_off, base, dstart, dlen,
    # tile_keys, dropped, stream); place (perm, dstart, dlen, s_cap, tile,
    # channels, in pointers, out pointers, pid in, pid out, active, stream)
    "cm_rebucket_keys": [_P, _P, _I, _F, _I, _I, _P, _P],
    "cm_rebucket_heads": [_P, _I, _I] + [_P] * 5,
    "cm_rebucket_plan": [_P] * 3 + [_I] * 5 + [_P] * 8,
    "cm_rebucket_place": [_P] * 3 + [_I] * 3 + [_P] * 6,
    # the partition rebuild (csrc/partition.cu): first_marked (mark, n, size,
    # fill, out, total, cta_count, cta_off, stream); oct_mask (pool, keys,
    # count, nb, no, models, tile key pointers, tile counts, extra, g, lo,
    # span, flags, stream); remap (flags, no, nb, null_oct, pool, old table,
    # keys, table, count, overflow, new pool, total, cta_count, cta_off,
    # stream); finalize_tiles (tile keys, n, table, g, no, null_oct,
    # null_block, block, bcoord, tvalid, stream); info (sub-kernel, out
    # i32[2]: registers, blocks per SM)
    "cm_first_marked": [_P, _I, _I, _I] + [_P] * 5,
    "cm_partition_oct_mask": [_P] * 3 + [_I] * 3 + [_P] * 3 + [_I] * 3 + [_P] * 2,
    "cm_partition_remap": [_P] + [_I] * 3 + [_P] * 11,
    "cm_partition_finalize_tiles": [_P, _I, _P] + [_I] * 4 + [_P] * 4,
    "cm_partition_info": [_I, _P],
    # the halo exchange and migration pack (csrc/halo.cu): count (keys,
    # count, nb, no, g, margin, spec, windows, h, cta_count, cta_off, total,
    # overflow, stream); write (pool, keys, count, nb, no, g, margin, spec,
    # windows, packed directions, their number, h, cta_count, cta_off, total,
    # idx, meta pointers, row pointers, stream); mask (directions, key
    # pointers, bit pointers, h, no, g, mask, stream); add (directions, key pointers, row pointers, h,
    # table, no, null_oct, pool, stream); migrate (pos[dim], active, slots,
    # dx_inv, block_bits, lo, hi, k, channels, channel pointers, pid, new
    # active, idx, cta_count, cta_off, total, left, right, dropped, stream);
    # info (sub-kernel, out i32[2]: registers, blocks per SM)
    "cm_halo_count": [_P, _P] + [_I] * 4 + [_P, _I, _I] + [_P] * 5,
    "cm_halo_write": [_P] * 3 + [_I] * 4 + [_P, _I, _P, _I, _I] + [_P] * 7,
    "cm_halo_mask": [_I, _P, _P, _I, _I, _I, _P, _P],
    "cm_halo_add": [_I, _P, _P, _I, _P, _I, _I, _P, _P],
    "cm_migrate_pack": [_P, _P, _I, _F] + [_I] * 5 + [_P] * 11,
    "cm_halo_info": [_I, _P],
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


HOST_LIB_NAME = "libcm_host.so"
HOST_FLAGS = ["-O3", "-std=c++17", "-shared", "-fPIC", "-pthread"]


def _host_build() -> Path:
    """Compile ``csrc/*.cpp`` with g++ unless a library for the current
    sources exists; returns its path, raises on failure."""
    lib = BUILD_DIR / HOST_LIB_NAME
    stamp = BUILD_DIR / (HOST_LIB_NAME + ".sha256")
    h = hashlib.sha256()
    sources = sorted(CSRC.glob("*.cpp"))
    for f in sources:
        h.update(f.name.encode())
        h.update(f.read_bytes())
    h.update(" ".join(HOST_FLAGS).encode())
    digest = h.hexdigest()
    if lib.exists() and stamp.exists() and stamp.read_text().strip() == digest:
        return lib
    gxx = shutil.which("g++")
    if gxx is None:
        raise RuntimeError("g++ not found")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmpdir:
        tmp = os.path.join(tmpdir, HOST_LIB_NAME)
        subprocess.run([gxx, *HOST_FLAGS, *map(str, sources), "-o", tmp], check=True,
                       capture_output=True, timeout=240)
        os.replace(tmp, lib)
    stamp.write_text(digest + "\n")
    return lib


@functools.lru_cache(maxsize=None)
def host_library():
    """The loaded host library, built first if needed; None where it cannot
    be built or loaded."""
    try:
        lib = ctypes.CDLL(str(_host_build()))
    except (OSError, RuntimeError, subprocess.SubprocessError):
        return None
    signatures = {
        "cm_sample_elimination": [_P, ctypes.c_int64, ctypes.c_int64, _F, _F, _F, _P],
        # (path, n, positions, attributes, names, widths, attribute pointers)
        "cm_write_bgeo": [ctypes.c_char_p, ctypes.c_int64, _P, _I, _P, _P, _P],
    }
    for name, argtypes in signatures.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return lib


def check(err: int, name: str) -> None:
    """Raise if a kernel entry point returned a cudaError_t other than 0."""
    if err != 0:
        raise RuntimeError(f"{name} failed to launch: cudaError_t {err}")
