"""Spatial decomposition across devices: the packed halo exchange, particle
migration and the multi-device engine (port of ``claymore_tpu/parallel``)."""

from . import distributed
from .multi import HaloComm, LocalGroup, MultiChipEngine

__all__ = ["HaloComm", "LocalGroup", "MultiChipEngine", "distributed"]
