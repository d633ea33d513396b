"""Houdini BGEO (version 5) particle writer and reader.

The classic big-endian BGEO V5 layout (magic 'Bgeo', 'V', header counts,
per-point attributes with position + homogeneous w, trailer 0x00 0xff),
which partio and the JAX package's reader read.  Two writers of the same
bytes, chosen as ``claymore_tpu/io/bgeo.py`` chooses: the native one
(``csrc/bgeo_io.cpp``, host C++ built by g++ at first use) for uncompressed
frames whose attributes are all float, numpy otherwise or where no library
can be built.  Either runs on the IO thread of ``async_io`` when asked to
write asynchronously.
"""

from __future__ import annotations

import ctypes
import gzip
import struct
from typing import Dict, Optional, Tuple

import numpy as np

from ..ops import _build
from . import async_io

_MAGIC = (ord("B") << 24) | (ord("g") << 16) | (ord("e") << 8) | ord("o")


def _houdini_str(s: str) -> bytes:
    b = s.encode()
    return struct.pack(">h", len(b)) + b


def write_bgeo(
    path: str,
    positions: np.ndarray,
    attributes: Optional[Dict[str, np.ndarray]] = None,
    compress: Optional[bool] = None,
    asynchronous: bool = False,
) -> str:
    """Write a particle cloud.  positions: [n, 3] float.  attributes: map of
    name -> [n] or [n, k] float32/int32 arrays.  ``compress`` defaults to
    gzip for a ``.gz`` path.  ``asynchronous``: queue the write on the IO
    thread (``async_io.flush`` waits for it and raises if it failed); the
    arrays must not change until then.  Returns the writer that takes it,
    ``"native"`` or ``"numpy"``."""
    attributes = attributes or {}
    if compress is None:
        compress = path.endswith(".gz")
    all_float = all(not np.issubdtype(np.asarray(v).dtype, np.integer)
                    for v in attributes.values())
    native = not compress and all_float and _build.host_library() is not None

    def write():
        if native:
            write_bgeo_native(path, positions, attributes)
        else:
            write_bgeo_numpy(path, positions, attributes, compress)

    if asynchronous:
        async_io.insert_job(write)
    else:
        write()
    return "native" if native else "numpy"


def write_bgeo_native(path: str, positions: np.ndarray,
                      attributes: Optional[Dict[str, np.ndarray]] = None) -> None:
    """The native writer (``csrc/bgeo_io.cpp``): every attribute as float.
    Raises ``OSError`` if the write fails and ``RuntimeError`` where the
    library cannot be built."""
    lib = _build.host_library()
    if lib is None:
        raise RuntimeError("the native BGEO writer (csrc/bgeo_io.cpp) cannot be built")
    pos = np.ascontiguousarray(positions, np.float32).reshape(-1, 3)
    cols = []
    for name, v in (attributes or {}).items():
        v = np.ascontiguousarray(v, np.float32)
        cols.append((name.encode(), v[:, None] if v.ndim == 1 else v))
    k = max(len(cols), 1)
    names = (ctypes.c_char_p * k)(*[c[0] for c in cols])
    widths = (ctypes.c_int * k)(*[c[1].shape[1] for c in cols])
    ptrs = (ctypes.c_void_p * k)(*[c[1].ctypes.data for c in cols])
    rc = lib.cm_write_bgeo(path.encode(), pos.shape[0], pos.ctypes.data, len(cols),
                           names, widths, ptrs)
    if rc != 0:
        raise OSError(f"{path}: the native BGEO writer failed (code {rc})")


def write_bgeo_numpy(path: str, positions: np.ndarray,
                     attributes: Optional[Dict[str, np.ndarray]] = None,
                     compress: bool = False) -> None:
    """The numpy writer: integer attributes as Houdini INT, gzip on
    ``compress``."""
    positions = np.asarray(positions, np.float32)
    n = positions.shape[0]
    attributes = attributes or {}
    body = [struct.pack(">icIiiiiiiii", _MAGIC, b"V", 5, n, 0, 0, 0,
                        len(attributes), 0, 0, 0)]
    cols = []
    for name, arr in attributes.items():
        arr = np.asarray(arr)
        if arr.ndim == 1:
            arr = arr[:, None]
        count = arr.shape[1]
        if np.issubdtype(arr.dtype, np.integer):
            htype, dt = 1, np.int32
        else:
            htype, dt = 0, np.float32
        body.append(_houdini_str(name))
        body.append(struct.pack(">hi", count, htype))
        body.append(struct.pack(">i", 0) * count)  # defaults
        cols.append(np.ascontiguousarray(arr.astype(dt)))

    # per-particle records: x y z w [attrs...] as big-endian 32-bit words
    parts = [positions, np.ones((n, 1), np.float32)] + cols
    rec = np.concatenate([np.ascontiguousarray(p).view(np.uint32) for p in parts],
                         axis=1).astype(">u4")
    body.append(rec.tobytes())
    body.append(struct.pack(">bB", 0x00, 0xFF))   # no fixed attributes

    data = b"".join(body)
    opener = gzip.open if compress else open
    with opener(path, "wb") as f:
        f.write(data)


def read_bgeo(path: str) -> Tuple[np.ndarray, Dict[str, np.ndarray]]:
    """Read back positions and attributes written by ``write_bgeo`` (point
    attributes of float/int type)."""
    with open(path, "rb") as f:
        data = f.read()
    if data[:2] == b"\x1f\x8b":
        data = gzip.decompress(data)

    off = 0

    def u(fmt):
        nonlocal off
        vals = struct.unpack_from(">" + fmt, data, off)
        off += struct.calcsize(">" + fmt)
        return vals

    magic, _ver_char, version, n_points, _n_prims, _npg = u("icIiii")
    _nprg, n_point_attr, _nva, _npa, _nfixed = u("iiiii")
    if magic != _MAGIC or version != 5:
        raise ValueError(f"{path}: not a BGEO V5 file ({magic:#x}, {version})")

    names, counts, types = [], [], []
    for _ in range(n_point_attr):
        (slen,) = u("h")
        name = data[off: off + slen].decode()
        off += slen
        cnt, htype = u("hi")
        if htype not in (0, 1, 5):
            raise ValueError(f"{path}: attribute {name} has type {htype}")
        off += 4 * cnt  # defaults
        names.append(name)
        counts.append(cnt)
        types.append(htype)

    rec_words = 4 + sum(counts)
    raw = np.frombuffer(data, dtype=">u4", count=n_points * rec_words,
                        offset=off).reshape(n_points, rec_words)
    positions = raw[:, :3].astype("=u4").view(np.float32).copy()
    attrs = {}
    col = 4
    for name, cnt, htype in zip(names, counts, types):
        block = raw[:, col: col + cnt].astype("=u4")
        arr = block.view(np.int32) if htype == 1 else block.view(np.float32)
        attrs[name] = arr.copy().squeeze(-1) if cnt == 1 else arr.copy()
        col += cnt
    return positions, attrs
