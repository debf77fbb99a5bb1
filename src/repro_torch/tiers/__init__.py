"""KV storage tiers behind one protocol (:class:`~repro_torch.tiers.base.KVTier`).

``WarmTier`` (host-RAM victim cache), ``DiskTier`` (planner + retry over
the authoritative disk store) and ``PrefixTier`` (content-addressed block
cache) all speak ``lookup/serve/admit/invalidate/free_row`` with
accountant charging, so :class:`~repro_torch.core.manager.KVCacheManager` walks
an ordered tier chain and the disagg handoff publishes into / restores
from a shared tier rather than special-casing each layer of the stack.
"""

from repro_torch.tiers.base import KVTier
from repro_torch.tiers.disk import DiskTier
from repro_torch.tiers.prefix import PrefixTier
from repro_torch.tiers.warm import (INDEX_ENTRY_BYTES, WarmTier, WarmTierStats,
                              warm_serve_time)

__all__ = ["INDEX_ENTRY_BYTES", "KVTier", "DiskTier", "PrefixTier",
           "WarmTier", "WarmTierStats", "warm_serve_time"]
