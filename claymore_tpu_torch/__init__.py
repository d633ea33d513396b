"""claymore_tpu_torch — the PyTorch/CUDA port of claymore_tpu.

Sparse-grid explicit MPM on one NVIDIA GPU.  Same data layout, state
containers and public API as the JAX package ``claymore_tpu``, which stays
beside it as the reference; this package imports neither JAX nor
``claymore_tpu``.

The substep's two hot kernels are CUDA C++ for Hopper (``csrc/``), built by
``nvcc`` at first use (``ops/_build.py``): the grid update (with the
analytic and SDF-grid colliders) and the fused G2P2G transfer (one
variant per material).  Each has a plain PyTorch version that the wrapper
runs on CPU tensors.  Nothing in the simulator is learned, so there are no
``nn.Module``s and no autograd functions: plain functions on tensors and
dataclasses of tensors.  Ported: the four materials, analytic and SDF
colliders, ``.sdf``/``.obj`` assets, scene files, checkpoints and the CLI
(``python -m claymore_tpu_torch``) on one device, and the spatial
decomposition across devices (``parallel``: ``MultiChipEngine``, several
shards per card or one per card or process).
"""

from .config import SimConfig
from .core.engine import MPMEngine, exact_tiles
from .core.types import Partition, ParticleModel, SimState, TileMap
from .models.boundary import Box, HalfSpace, RigidMotion, SignedDistanceCollider, Sphere
from .models.materials import MATERIALS, NACC, FixedCorotated, JFluid, Material, Sand
from .parallel.multi import MultiChipEngine

__version__ = "0.1.0"

__all__ = [
    "SimConfig",
    "MPMEngine",
    "MultiChipEngine",
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
    "SignedDistanceCollider",
    "RigidMotion",
    "load_scene",
]


def load_scene(path: str, device="cuda", **kw):
    """A scene file -> its engine and initial state (``io.scene.Scene``), on
    the card unless ``device`` says otherwise (a device, or one per shard of
    a multi-device scene)."""
    from .io.scene import load_scene as _load_scene

    return _load_scene(path, device=device, **kw)
