"""The port's Poisson-disk sampling against the JAX package on the CPU.

``poisson_disk_sample`` runs the port's own copy of the weighted sample
elimination (``claymore_tpu_torch/csrc/sample_elim.cpp``, built by g++) and
must keep the same indices as the JAX package's native runtime; without a
library both fall back to the same stratified thinning.
"""

import numpy as np
import pytest

from claymore_tpu import native as jnative
from claymore_tpu.io import sampler as jsampler
from claymore_tpu.io import sdf as jsdf
from claymore_tpu_torch.io import sampler, sdf
from claymore_tpu_torch.ops import _build


def _cloud(n, seed):
    rng = np.random.default_rng(seed)
    return rng.uniform(0.0, 1.0, (n, 3)).astype(np.float32) * np.float32([1.0, 0.7, 0.4])


@pytest.mark.parametrize("n,target", [(3000, 1500), (2048, 700), (50, 49)])
def test_sample_elimination_equals_jax_native(n, target):
    pts = _cloud(n, n)
    want = jnative.sample_elimination_native(pts, target)
    assert want is not None, "the JAX package's native library did not build"
    got = sampler.sample_elimination(pts, target)
    assert got is not None, "the port's host library did not build"
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)
    assert len(got) == target and np.all(np.diff(got) > 0)
    np.testing.assert_array_equal(sampler.poisson_disk_sample(pts, target, seed=3),
                                  jsampler.poisson_disk_sample(pts, target, seed=3))


def test_fallback_thinning_equals_jax(monkeypatch):
    """With no library on either side, the same stratified thinning."""
    pts = _cloud(1000, 1)
    monkeypatch.setattr(_build, "host_library", lambda: None)
    monkeypatch.setattr(jnative, "sample_elimination_native", lambda p, t: None)
    got = sampler.poisson_disk_sample(pts, 400, seed=5)
    np.testing.assert_array_equal(got, jsampler.poisson_disk_sample(pts, 400, seed=5))
    assert got.shape == (400, 3)


def _ball(n=24):
    ax = (np.arange(n) + 0.5) / n - 0.5
    gx, gy, gz = np.meshgrid(ax, ax, ax, indexing="ij")
    return np.sqrt(gx ** 2 + gy ** 2 + gz ** 2) - 0.35


def test_poisson_sdf_sampling_is_blue_noise_and_equals_jax():
    """tests/test_io.py's blue-noise check on the port: at equal count the
    5th-percentile nearest-neighbour spacing beats a jittered lattice
    clipped to the same level set by 1.5x; and the cloud equals the JAX
    package's, point for point."""
    values = _ball()
    kw = dict(sdf_dx=1.0 / 24, ppc=8.0, domain_dx=1.0 / 32, offset=[0.3] * 3,
              span=[0.4] * 3)
    pois = sdf.sample_sdf(values, mode="poisson", seed=1, **kw)
    np.testing.assert_array_equal(pois, jsdf.sample_sdf(values, mode="poisson", seed=1, **kw))
    assert pois.dtype == np.float32 and pois.shape[0] > 200

    rng = np.random.default_rng(1)
    h = kw["domain_dx"] / kw["ppc"] ** (1 / 3)
    uni = sdf.sample_sdf(values, mode="uniform", **kw)
    jit = uni + rng.uniform(-0.45, 0.45, uni.shape) * h
    k = min(len(pois), len(jit))
    pois, jit = pois[:k], jit[:k]

    def min_nn(pts):
        d = np.linalg.norm(pts[:, None, :] - pts[None, :, :], axis=-1)
        np.fill_diagonal(d, np.inf)
        return d.min(axis=1)

    q_pois = np.quantile(min_nn(pois), 0.05)
    q_jit = np.quantile(min_nn(jit), 0.05)
    assert q_pois > 1.5 * q_jit, (q_pois, q_jit)


@pytest.mark.parametrize("dx,center,radius", [
    (1 / 256, (0.3, 0.6, 0.5), 0.11),       # 113 x planes: 8 chunks, the last short
    (1 / 32, (0.5, 0.5, 0.5), 0.3),
    (1 / 1024, (0.5, 0.55, 0.5), 0.01),     # config 5's shard sphere at --quick size
    (1 / 32, (0.5, 0.5, 0.5), 0.0)])
def test_sphere_sampled_by_planes_equals_the_whole_lattice(dx, center, radius):
    """``sample_sphere`` tests SPHERE_PLANES x planes of the lattice at a
    time: the same points in the same order, bit for bit, as the JAX
    package's sampler, which tests the whole box at once."""
    got = sampler.sample_sphere(dx, center, radius)
    want = jsampler.sample_sphere(dx, center, radius)
    assert got.dtype == want.dtype == np.float32
    np.testing.assert_array_equal(got, want)
