"""Simulation configuration.

The PyTorch port's counterpart of ``claymore_tpu/config.py``: the same
frozen dataclass of static parameters and the same derived geometry, so a
configuration means the same grid, pool and tile plan in both packages.
The fields that only steer the TPU kernels (matrix-unit precision, bf16
arenas, window DMA, Pallas launch shapes) have no counterpart here; the
port computes in float32 throughout.
"""

from __future__ import annotations

import dataclasses
import math
from functools import cached_property


@dataclasses.dataclass(frozen=True)
class SimConfig:
    """Static simulation configuration (one per engine)."""

    # --- background grid geometry ---
    domain_bits: int = 8          # grid resolution = 2**domain_bits per axis
    block_bits: int = 2           # cells per block edge = 2**block_bits (4^3 blocks)

    # --- capacities (static shapes) ---
    max_active_blocks: int = 8192     # sparse grid pool capacity (blocks)
    particle_tile: int = 256          # particles per tile (one home block each)
    max_tiles: int = 0                # 0 -> derived from particle capacity at init

    # --- transfer scheme ---
    ppc: float = 8.0              # particles per cell used for default volumes
    cfl: float = 0.5

    # --- physics ---
    gravity: tuple[float, float, float] = (0.0, -9.8, 0.0)
    bound_blocks: int = 2         # sticky slab thickness in blocks at domain faces

    # --- stepping ---
    default_dt: float = 1e-4
    fps: int = 24
    # hard cap on substeps per frame, so run_frame ends even under a
    # pathological dt
    max_substeps_per_frame: int = 1_000_000

    # --- rebucketing ---
    # Rebuild buckets/partition every K substeps; K <= 2 keeps the 2^3-block
    # transfer arena (one cell of drift tolerance).
    rebucket_every: int = 1
    # Every defrag_every-th rebucket is a full sort; 1 = always (the only
    # value the port supports so far).
    defrag_every: int = 1
    # Drift-triggered rebucketing: rebuild only when some particle could
    # leave its tile's transfer arena on the next substep.
    rebucket_auto: bool = False
    rebucket_safety: float = 2.0

    @cached_property
    def arena_span(self) -> int:
        """Neighbor blocks per axis in the transfer arena."""
        return 2 if self.rebucket_every <= 2 else 4

    @cached_property
    def arena_lo(self) -> int:
        """First arena block offset relative to the home block."""
        return 0 if self.rebucket_every <= 2 else -1

    @cached_property
    def arena_cells(self) -> int:
        return self.arena_span * self.block_size

    # ----- derived geometry -----
    @cached_property
    def domain_size(self) -> int:
        """Cells per axis."""
        return 1 << self.domain_bits

    @cached_property
    def dx(self) -> float:
        return 1.0 / float(1 << self.domain_bits)

    @cached_property
    def dx_inv(self) -> float:
        return float(1 << self.domain_bits)

    @cached_property
    def d_inv(self) -> float:
        """APIC inertia-tensor inverse for quadratic B-splines: 4/dx^2."""
        return 4.0 * self.dx_inv * self.dx_inv

    @cached_property
    def block_size(self) -> int:
        """Cells per block edge."""
        return 1 << self.block_bits

    @cached_property
    def block_volume(self) -> int:
        return self.block_size ** 3

    @cached_property
    def grid_size(self) -> int:
        """Blocks per axis."""
        return 1 << (self.domain_bits - self.block_bits)

    @cached_property
    def num_table_entries(self) -> int:
        return self.grid_size ** 3

    @cached_property
    def null_block(self) -> int:
        """Block-address sentinel: first block of the null oct row."""
        return self.null_oct * self.oct_z

    # ----- oct-packed grid pool (see core/octpool.py) -----
    @cached_property
    def oct_z(self) -> int:
        """Blocks per pool row (z-major)."""
        return 8

    @cached_property
    def grid_size_zo(self) -> int:
        """Oct rows per z column."""
        return self.grid_size // self.oct_z

    @cached_property
    def num_oct_keys(self) -> int:
        return self.grid_size * self.grid_size * self.grid_size_zo

    @cached_property
    def max_active_octs(self) -> int:
        """Oct-row pool capacity (every active oct holds an active block)."""
        return self.max_active_blocks

    @cached_property
    def null_oct(self) -> int:
        """Pool row absorbing traffic for inactive octs."""
        return self.max_active_octs

    @cached_property
    def group_tiles(self) -> int:
        """Tiles per transfer group = one aligned home oct (8 z-blocks)."""
        return 8

    def tiles_for(self, num_particles: int) -> int:
        """Static tile capacity for a model of ``num_particles``."""
        if self.max_tiles:
            return self.max_tiles
        base = -(-num_particles // self.particle_tile)
        blocks = max(64, int(1.1 * num_particles / (self.ppc * self.block_volume)))
        return base + min(blocks, self.max_active_blocks)

    def default_volume(self) -> float:
        """Per-particle volume at the nominal particles-per-cell."""
        return (self.dx ** 3) / self.ppc

    def frame_dt(self) -> float:
        return 1.0 / float(self.fps)

    def __post_init__(self):
        if not self.domain_bits > self.block_bits >= 1:
            raise ValueError("need domain_bits > block_bits >= 1")
        if self.block_bits != 2:
            raise ValueError("grid pool layout requires 4^3 blocks")
        if self.domain_bits - self.block_bits < 3:
            raise ValueError("domain must span >= 8 blocks (one pool oct) per axis")
        if self.max_active_blocks < 1:
            raise ValueError("max_active_blocks must be >= 1")
        if math.log2(self.particle_tile) != int(math.log2(self.particle_tile)):
            raise ValueError("particle_tile must be a power of two")
        if self.num_table_entries >= (1 << 30):
            raise ValueError("domain too large for key packing")
        if not 1 <= self.rebucket_every <= 8:
            raise ValueError("rebucket_every must be in [1, 8]")
