"""Manifest: the index of the content-addressed block store.

Maps ``block_id`` → where that block's KV groups live in the slab
(:class:`repro.cache.store.PrefixBlockStore`) plus the chain and LRU
metadata the eviction policy needs.  The manifest is the unit of
persistence: saved as JSON next to the slab file, so a cache directory can
be reopened by a later process and keep serving warm prefixes.

Pins (``pins``) are *runtime* state — a block is pinned while an engine is
restoring from it — and are deliberately not persisted: a fresh process
starts with everything unpinned.
"""

from __future__ import annotations

import dataclasses
import json
import os
import tempfile

import numpy as np

from repro_torch.faults.errors import ManifestCorrupt


@dataclasses.dataclass
class BlockMeta:
    """Everything the cache knows about one resident block."""

    block_id: str
    parent_id: str
    index: int                  # chain depth (0 = first block)
    n_tokens: int
    start_group: int            # extent [start_group, start_group + n_groups)
    n_groups: int               # ... in the slab, per layer
    last_used: int              # logical LRU clock tick
    checksum: int = 0           # CRC32 of the extent's at-rest bytes; 0 = unverifiable (pre-checksum manifest)
    pins: int = 0               # runtime refcount; never persisted

    def to_json(self) -> dict:
        d = dataclasses.asdict(self)
        d.pop("pins")
        return d

    @classmethod
    def from_json(cls, d: dict) -> "BlockMeta":
        d = dict(d)
        # manifests written before the integrity PR carry no checksum;
        # 0 means "skip verification" rather than "must equal zero"
        d.setdefault("checksum", 0)
        return cls(pins=0, **d)


@dataclasses.dataclass(frozen=True)
class CacheGeometry:
    """Array geometry the slab was created with; must match the engine's."""

    n_layers: int
    group_size: int
    n_kv_heads: int
    head_dim: int
    dtype: str
    capacity_groups: int
    block_tokens: int
    kv_bits: int = 16           # 16 = raw dtype on disk; 8 = int8 slab (§7)

    @property
    def np_dtype(self):
        return np.dtype(self.dtype)

    @property
    def store_itemsize(self) -> int:
        return 1 if self.kv_bits == 8 else self.np_dtype.itemsize

    @property
    def group_nbytes(self) -> int:
        """Bytes of one group in ONE layer (matches KVDiskStore.group_nbytes)."""
        return (self.group_size * 2 * self.n_kv_heads * self.head_dim
                * self.store_itemsize)

    @property
    def block_nbytes(self) -> int:
        """Bytes of one block across ALL layers — the budget accounting unit."""
        g = self.block_tokens // self.group_size
        return self.n_layers * g * self.group_nbytes


class Manifest:
    """In-memory index + JSON (de)serialization."""

    def __init__(self, geometry: CacheGeometry):
        self.geometry = geometry
        self.blocks: dict[str, BlockMeta] = {}
        self.clock = 0          # logical LRU time

    # -- bookkeeping ------------------------------------------------------
    def tick(self) -> int:
        self.clock += 1
        return self.clock

    def touch(self, meta: BlockMeta) -> None:
        meta.last_used = self.tick()

    def resident_bytes(self) -> int:
        g = self.geometry
        return sum(m.n_groups for m in self.blocks.values()) * g.group_nbytes * g.n_layers

    # -- persistence ------------------------------------------------------
    def save(self, path: str) -> None:
        """Durable atomic write: tmp file → fsync(file) → rename →
        fsync(directory).

        The file fsync *before* ``os.replace`` guarantees the rename can
        only ever expose fully-written bytes (rename-before-data lets a
        power cut leave the final name pointing at a truncated file); the
        directory fsync afterwards persists the rename itself.  Either
        way a crash leaves the old manifest or the new one — never a torn
        hybrid — and :meth:`load` treats anything torn as
        :class:`~repro.faults.errors.ManifestCorrupt` rather than
        trusting it.
        """
        payload = {
            "geometry": dataclasses.asdict(self.geometry),
            "clock": self.clock,
            "blocks": [m.to_json() for m in self.blocks.values()],
        }
        d = os.path.dirname(os.path.abspath(path))
        fd, tmp = tempfile.mkstemp(dir=d, prefix=".manifest_", suffix=".json")
        try:
            with os.fdopen(fd, "w") as f:
                json.dump(payload, f)
                f.flush()
                os.fsync(f.fileno())
            os.replace(tmp, path)
            dirfd = os.open(d, os.O_RDONLY)
            try:
                os.fsync(dirfd)
            finally:
                os.close(dirfd)
        except BaseException:
            if os.path.exists(tmp):
                os.unlink(tmp)
            raise

    @classmethod
    def load(cls, path: str) -> "Manifest":
        """Parse a manifest, raising the typed
        :class:`~repro.faults.errors.ManifestCorrupt` on a truncated or
        garbage file so callers can run recovery (empty index + orphan
        GC, see ``PrefixCache``) instead of crashing the open."""
        try:
            with open(path) as f:
                payload = json.load(f)
            m = cls(CacheGeometry(**payload["geometry"]))
            m.clock = int(payload["clock"])
            for d in payload["blocks"]:
                meta = BlockMeta.from_json(d)
                m.blocks[meta.block_id] = meta
        except (json.JSONDecodeError, KeyError, TypeError, ValueError,
                UnicodeDecodeError) as exc:
            raise ManifestCorrupt(
                f"unreadable manifest {path}: {exc}", path=path) from exc
        return m
