"""Persistent cross-request prefix cache: content-addressed KV block store.

KVSwap's disk tier (``KVDiskStore``) is per-request scratch; this package
turns the disk into a *serving asset*: prompt KV published once is restored
by any later request sharing the prefix, so warm prefill pays sequential
disk reads instead of recomputing attention from token zero.

See ``docs/architecture.md`` ("Prefix cache") for the design and
``docs/tuning.md`` for the knobs.
"""

from repro_torch.cache.blocks import ROOT_ID, TokenBlock, block_id, chain_blocks
from repro_torch.cache.manifest import BlockMeta, CacheGeometry, Manifest
from repro_torch.cache.policy import LRUPinPolicy
from repro_torch.cache.prefix_cache import PrefixCache, PrefixCacheConfig, PrefixCacheStats
from repro_torch.cache.store import PrefixBlockStore

__all__ = [
    "ROOT_ID",
    "BlockMeta",
    "CacheGeometry",
    "LRUPinPolicy",
    "Manifest",
    "PrefixBlockStore",
    "PrefixCache",
    "PrefixCacheConfig",
    "PrefixCacheStats",
    "TokenBlock",
    "block_id",
    "chain_blocks",
]
