"""The port's native BGEO writer (``csrc/bgeo_io.cpp``, built by g++) and
asynchronous writes on the IO thread, against the port's numpy writer and
the JAX package's Python writer.

The JAX package's native library (``claymore_tpu/native``) is kept out:
its loader would build ``libcm_runtime.so`` inside the JAX package, so its
``load`` is replaced by one that finds no library, and its ``write_bgeo``
takes its Python path.
"""

import os

import numpy as np
import pytest

import claymore_tpu.native as jnative
from claymore_tpu.io import bgeo as jbgeo
from claymore_tpu_torch.io import async_io, bgeo
from claymore_tpu_torch.ops import _build


@pytest.fixture
def lib():
    out = _build.host_library()
    assert out is not None, "the host library (g++) could not be built"
    return out


@pytest.fixture
def jax_python_writer(monkeypatch):
    monkeypatch.setattr(jnative, "load", lambda: None)
    return jbgeo.write_bgeo


def _cloud(n: int, widths):
    rng = np.random.default_rng(n + len(widths))
    pos = rng.normal(size=(n, 3)).astype(np.float32)
    attrs = {f"a{w}_{i}": rng.normal(size=(n, w) if w > 1 else (n,)).astype(np.float32)
             for i, w in enumerate(widths)}
    return pos, attrs


CASES = {"n0": (0, ()), "n0_attrs": (0, (1, 3)), "n257_w1": (257, (1,)),
         "n257_w1_w3": (257, (1, 3)), "n70000_w3": (70000, (3,))}


@pytest.mark.parametrize("case", CASES)
def test_native_bytes_equal_numpy_and_jax(case, tmp_path, lib, jax_python_writer):
    """The same bytes from the three writers, at n = 0 and with float
    attributes of width 1 and 3 (70,000 points cross the native writer's
    chunk of 65,536 records)."""
    pos, attrs = _cloud(*CASES[case])
    paths = {k: str(tmp_path / f"{k}.bgeo") for k in ("native", "numpy", "jax")}
    bgeo.write_bgeo_native(paths["native"], pos, attrs)
    bgeo.write_bgeo_numpy(paths["numpy"], pos, attrs)
    jax_python_writer(paths["jax"], pos, attrs)
    data = {k: open(p, "rb").read() for k, p in paths.items()}
    assert data["native"] == data["numpy"] == data["jax"]
    p, a = bgeo.read_bgeo(paths["native"])
    np.testing.assert_array_equal(p, pos)
    for k, v in attrs.items():
        np.testing.assert_array_equal(a[k], v)


def test_write_bgeo_picks_the_writer_as_jax_does(tmp_path, lib):
    """Native for uncompressed all-float frames; numpy for gzip or an
    integer attribute, which keep their own bytes."""
    pos, attrs = _cloud(100, (1,))
    assert bgeo.write_bgeo(str(tmp_path / "a.bgeo"), pos, attrs) == "native"
    assert bgeo.write_bgeo(str(tmp_path / "a.bgeo.gz"), pos, attrs) == "numpy"
    ids = {"id": np.arange(100, dtype=np.int32)}
    assert bgeo.write_bgeo(str(tmp_path / "i.bgeo"), pos, ids) == "numpy"
    np.testing.assert_array_equal(bgeo.read_bgeo(str(tmp_path / "i.bgeo"))[1]["id"],
                                  ids["id"])


@pytest.mark.parametrize("attrs_case", ["native", "numpy"])
def test_async_write_is_on_disk_after_flush(attrs_case, tmp_path, lib):
    """An asynchronous write through either writer on the IO thread: on
    disk, whole, after ``flush``."""
    pos, attrs = _cloud(50000, (3,))
    if attrs_case == "numpy":
        attrs["id"] = np.arange(50000, dtype=np.int32)
    want = pos.copy()
    path = str(tmp_path / "async.bgeo")
    assert bgeo.write_bgeo(path, pos, attrs, asynchronous=True) == attrs_case
    async_io.flush()
    p, a = bgeo.read_bgeo(path)
    np.testing.assert_array_equal(p, want)
    np.testing.assert_array_equal(a["a3_0"], attrs["a3_0"])


@pytest.mark.parametrize("attrs_case", ["native", "numpy"])
def test_failed_async_write_raises_at_flush(attrs_case, tmp_path, lib):
    """A write that cannot open its file raises at ``flush`` (the JAX
    package's native queue drops the code), once: the next flush is clean."""
    pos, attrs = _cloud(10, (1,))
    if attrs_case == "numpy":
        attrs["id"] = np.arange(10, dtype=np.int32)
    bad = str(tmp_path / "missing_dir" / "f.bgeo")
    good = str(tmp_path / "f.bgeo")
    assert bgeo.write_bgeo(bad, pos, attrs, asynchronous=True) == attrs_case
    bgeo.write_bgeo(good, pos, attrs, asynchronous=True)
    with pytest.raises(OSError, match="missing_dir"):
        async_io.flush()
    assert os.path.exists(good)
    async_io.flush()


def test_failed_native_write_raises(tmp_path, lib):
    pos, _ = _cloud(10, ())
    with pytest.raises(OSError, match="native BGEO writer failed"):
        bgeo.write_bgeo_native(str(tmp_path / "missing_dir" / "f.bgeo"), pos)
