"""claymore_tpu_torch — the PyTorch/CUDA port of claymore_tpu.

Sparse-grid explicit MPM on one NVIDIA GPU.  Same data layout, state
containers and public API as the JAX package ``claymore_tpu``, which stays
beside it as the reference; this package imports neither JAX nor
``claymore_tpu``.

The substep's two hot kernels are CUDA C++ for Hopper (``csrc/``), built by
``nvcc`` at first use (``ops/_build.py``): the grid update (with the
analytic colliders) and the fused G2P2G transfer (one variant per
material).  Each has a plain PyTorch version that the wrapper runs on CPU
tensors.  Nothing in the simulator is learned, so there are no
``nn.Module``s and no autograd functions: plain functions on tensors and
dataclasses of tensors.  Ported so far: the four materials, the analytic
colliders, scene files and the CLI (``python -m claymore_tpu_torch``), on a
single device.
"""

from .config import SimConfig
from .core.engine import MPMEngine, exact_tiles
from .core.types import Partition, ParticleModel, SimState, TileMap
from .models.boundary import Box, HalfSpace, RigidMotion, Sphere
from .models.materials import MATERIALS, NACC, FixedCorotated, JFluid, Material, Sand

__version__ = "0.1.0"

__all__ = [
    "SimConfig",
    "MPMEngine",
    "exact_tiles",
    "Partition",
    "ParticleModel",
    "SimState",
    "TileMap",
    "MATERIALS",
    "Material",
    "FixedCorotated",
    "JFluid",
    "Sand",
    "NACC",
    "HalfSpace",
    "Sphere",
    "Box",
    "RigidMotion",
]
