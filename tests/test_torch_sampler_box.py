"""The port's ``sample_uniform_box`` (a box given in cells) against the JAX
package's, exactly."""

import numpy as np
import pytest

from claymore_tpu.io import sampler as jsampler
from claymore_tpu_torch.io import sampler


@pytest.mark.parametrize("dx,lo,hi", [
    (1 / 64, [0, 0, 0], [1, 1, 1]),
    (1 / 64, [2, 3, 4], [5, 4, 7]),
    (1 / 128, [10, 0, 3], [12, 2, 3]),          # no cell in z: no particle
    (1 / 256, [100, 17, 60], [108, 29, 61]),
])
def test_sample_uniform_box_equals_jax(dx, lo, hi):
    got = sampler.sample_uniform_box(dx, lo, hi)
    want = jsampler.sample_uniform_box(dx, lo, hi)
    assert got.dtype == want.dtype == np.float32 and got.shape == want.shape
    np.testing.assert_array_equal(got, want)
    assert got.shape[0] == 8 * int(np.prod(np.maximum(np.subtract(hi, lo), 0)))
