"""The CUDA kernels against their plain PyTorch versions on the card.

Needs a CUDA device and nvcc (skips otherwise).  On a machine with a card:

    python -m pytest tests/test_torch_kernels_cuda.py -m cuda -q

The checks and their tolerances are chip_smoke.py's, at a smaller size.
"""

import dataclasses

import pytest
import torch

import claymore_tpu_torch as ct
from claymore_tpu_torch.io.sampler import sample_uniform_box_world

pytestmark = pytest.mark.cuda


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    import chip_smoke

    return chip_smoke


def test_grid_kernel_matches_plain(card):
    cfg = ct.SimConfig(domain_bits=7, max_active_blocks=5000)   # ragged: 5001 rows
    card.check_grid_kernel(cfg, n_active=cfg.num_oct_keys, time_it=False)


def test_grid_colliders_kernel_matches_plain(card):
    cfg = ct.SimConfig(domain_bits=7, max_active_blocks=5000)
    card.check_grid_colliders_kernel(cfg, n_active=cfg.num_oct_keys, t=0.37,
                                     time_it=False)


def _material(name, vol):
    return {"fixed_corotated": lambda: ct.FixedCorotated(volume=vol, e=5e3, nu=0.4),
            "jfluid": lambda: ct.JFluid(volume=vol),
            "sand": lambda: ct.Sand(volume=vol, e=1e4, rho=1500.0),
            "nacc": lambda: ct.NACC(volume=vol, e=1e4)}[name]()


@pytest.mark.parametrize("name", ["fixed_corotated", "jfluid", "sand", "nacc"])
def test_g2p2g_kernel_matches_plain(card, name):
    cfg = ct.SimConfig(domain_bits=7, max_active_blocks=2048, default_dt=2e-4,
                       particle_tile=512)
    pos = sample_uniform_box_world(cfg.dx, [0.3, 0.45, 0.35], [0.55, 0.6, 0.5], cfg.ppc)
    cfg = dataclasses.replace(cfg, max_tiles=ct.exact_tiles(cfg, [pos], slack=1.25))
    mat = _material(name, cfg.default_volume())
    eng = ct.MPMEngine(cfg, [mat], tile_chunk=8, device="cuda")
    state = eng.init_state([pos], [(0.3, -0.5, 0.2)])
    card.check_g2p2g_kernel(cfg, mat, state, tile_chunk=8, time_it=False)
    # a sheared, compressed velocity field takes the return maps' branches
    card.check_g2p2g_kernel(cfg, mat, card.stir(state), tile_chunk=8, time_it=False)
