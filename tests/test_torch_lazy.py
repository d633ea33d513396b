"""The port's lazy rebucketing at span 4 (``rebucket_every`` 3..8: the
4^3-block arena, one block below the home block) against the JAX package's
XLA path on the CPU, with particles paired by id at the bounds of
``tests/test_pallas.py``; the span-4 drift margin and the span-4 dilation
of ``rebuild`` exactly."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from claymore_tpu.core import partition as jpart
from claymore_tpu_torch.core import partition as tpart
from claymore_tpu_torch.interop import state_to_numpy

from tests.test_torch_rebucket import V0, _compare, _engines, _tile_keys_np
from tests.torch_port_helpers import jax_state, to_np


@pytest.mark.parametrize("k_every,auto", [(3, False), (3, True), (4, False), (4, True)])
def test_lazy_span4_matches_jax(k_every, auto):
    jeng, eng, pos, mat = _engines(rebucket_every=k_every, rebucket_auto=auto)
    cfg, jcfg = eng.cfg, jeng.cfg
    assert cfg.arena_span == 4 and cfg.arena_lo == -1
    # the span-4 arena tolerates ~5 cells of drift: under rebucket_auto the
    # cloud moves twice as fast and for longer, so that a rebuild fires
    v0 = [tuple(2 * v for v in V0[0])] if auto else V0
    js, s = jeng.init_state([pos], v0), eng.init_state([pos], v0)
    for _ in range(12 if auto else 2 * k_every + 1):
        js = jeng.substep(js, jnp.float32(1.0))
        s = eng.substep(s, 1.0)
    assert eng.rebuilds >= (1 if auto else 2)
    _compare(eng, s, jeng, js, pos.shape[0], mat.mass)

    # the span-4 margin and the span-4 dilation of rebuild, exactly, on the
    # port's state handed to both packages
    jst = jax_state(state_to_numpy(s))
    assert float(tpart.arena_margin(cfg, s.models[0])) == float(
        jpart.arena_margin(jcfg, jst.models[0]))
    tk = _tile_keys_np(cfg, s.models[0])
    p2, pool2 = tpart.rebuild(cfg, s.grid, s.partition, (torch.from_numpy(tk),))
    jp2, jpool2 = jpart.rebuild(jcfg, jst.grid, jst.partition, (jnp.asarray(tk),))
    for a, b in zip((p2.table, p2.keys, p2.count, p2.overflow, pool2),
                    (jp2.table, jp2.keys, jp2.count, jp2.overflow, jpool2)):
        np.testing.assert_array_equal(to_np(a), np.asarray(b))
    mask = np.zeros((cfg.grid_size,) * 3, bool)
    mask[2, 3, 3] = True
    dil = to_np(tpart._dilate(cfg, torch.from_numpy(mask)))
    np.testing.assert_array_equal(dil, np.asarray(jpart._dilate(jcfg, jnp.asarray(mask))))
    assert dil.sum() == 64 and dil[1:5, 2:6, 2:6].all()      # offsets -1..2
