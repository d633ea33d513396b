"""Minimal Houdini BGEO (version 5) particle writer and reader, numpy only.

A copy of ``claymore_tpu/io/bgeo.py`` without its native writer: the
classic big-endian BGEO V5 layout (magic 'Bgeo', 'V', header counts,
per-point attributes with position + homogeneous w, trailer 0x00 0xff),
which partio and the JAX package's reader read.
"""

from __future__ import annotations

import gzip
import struct
from typing import Dict, Optional, Tuple

import numpy as np

_MAGIC = (ord("B") << 24) | (ord("g") << 16) | (ord("e") << 8) | ord("o")


def _houdini_str(s: str) -> bytes:
    b = s.encode()
    return struct.pack(">h", len(b)) + b


def write_bgeo(
    path: str,
    positions: np.ndarray,
    attributes: Optional[Dict[str, np.ndarray]] = None,
    compress: Optional[bool] = None,
) -> None:
    """Write a particle cloud.  positions: [n, 3] float.  attributes: map of
    name -> [n] or [n, k] float32/int32 arrays.  ``compress`` defaults to
    gzip for a ``.gz`` path."""
    positions = np.asarray(positions, np.float32)
    n = positions.shape[0]
    attributes = attributes or {}
    if compress is None:
        compress = path.endswith(".gz")

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
