"""KV storage tiers behind one protocol (:class:`~repro_torch.tiers.base.KVTier`).

This slice carries the authoritative :class:`DiskTier`; the warm and prefix
tiers come with later slices of the port.
"""

from repro_torch.tiers.base import KVTier
from repro_torch.tiers.disk import DiskTier

__all__ = ["KVTier", "DiskTier"]
