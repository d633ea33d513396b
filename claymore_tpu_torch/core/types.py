"""Simulation state containers.

Dataclasses of tensors with the field names of ``claymore_tpu/core/types.py``
so states convert one to one (``claymore_tpu_torch.interop``).  Layout rule,
as in the JAX package: per-particle arrays are component-leading ([3, S]
positions, [9, S] deformation gradients) and stored slot-major, in tile
order, ``S = num_tiles * particle_tile``.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import torch


@dataclasses.dataclass
class Partition:
    """Sparse oct partition."""

    table: torch.Tensor     # i32[num_oct_keys + 1]; oct key -> pool row
    keys: torch.Tensor      # i32[max_active_octs]; oct key per pool row
    count: torch.Tensor     # i32[1]; number of active octs
    overflow: torch.Tensor  # i32[1]; octs that did not fit (diagnostic)


@dataclasses.dataclass
class TileMap:
    """Per-tile home-block binding for slot-major particle storage."""

    block: torch.Tensor    # i32[T]; home-block address (null_block if unused)
    bcoord: torch.Tensor   # i32[3, T]; home-block coordinates
    tvalid: torch.Tensor   # bool[T]; tile holds at least one particle
    dropped: torch.Tensor  # i32[1]; particles that did not fit (diagnostic)


@dataclasses.dataclass
class ParticleModel:
    """One material's particle set in slot-major SoA storage."""

    pos: torch.Tensor                 # f32[3, S]
    fields: Dict[str, torch.Tensor]   # e.g. F: f32[9, S]
    active: torch.Tensor              # bool[S]; slot occupied
    pid: torch.Tensor                 # i32[S]; stable particle id (S = empty)
    tiles: Optional[TileMap]


@dataclasses.dataclass
class SimState:
    """Full simulation state."""

    grid: torch.Tensor                # f32[max_active_octs + 1, 16, 128]
    partition: Partition
    models: Tuple[ParticleModel, ...]
    dt: torch.Tensor                  # f32[]
    max_vel: torch.Tensor             # f32[]
    t: torch.Tensor                   # f32[]
    step: torch.Tensor                # i32[]
    mig_dropped: torch.Tensor         # i32[1]; multi-device only, kept for parity
    halo_overflow: torch.Tensor       # i32[1]; multi-device only, kept for parity
