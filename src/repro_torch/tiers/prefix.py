"""Prefix tier: the content-addressed block cache behind the KVTier verbs.

The :class:`~repro.cache.PrefixCache` is keyed by hash-chained token
blocks, not ``(layer, row, gid)`` — its identity is *what tokens the KV
encodes*, not where it sits.  This wrapper reconciles the two views, which
is exactly the reconciliation the disaggregated handoff relies on: a
prefill engine publishes a row into the shared tier, a decode session
restores the same row by content, and neither needs to know the other's
row numbering.

The bridge is an explicit per-row **binding** (:meth:`bind_row`): the
caller declares which token stream a row represents, and from then on the
group key ``(layer, row, gid)`` denotes tokens
``[gid*G, (gid+1)*G)`` of that stream:

* :meth:`lookup`/:meth:`serve` resolve through the cache's longest-prefix
  match and slab reads (accountant-charged, checksum-verified — a corrupt
  block quarantines and reads as a miss, never as wrong KV);
* :meth:`admit` stages group payloads and publishes every block the
  staged set completes (all layers × ``block_tokens`` worth of groups),
  root-first, through the normal ``put_block`` path — eviction, dedup and
  at-rest fault injection included;
* :meth:`invalidate` quarantines the resident block covering the group
  (and, per chain semantics, every descendant) and drops its staged
  payload;
* :meth:`free_row` releases the binding and staging; published blocks
  stay — they are the *cache's* shared property, found again by any row
  that binds the same tokens — so :meth:`row_bytes` counts only the
  row-attributed (staged, unpublished) bytes.
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np

from repro_torch.cache.blocks import chain_blocks
from repro_torch.faults.errors import CorruptBlockError
from repro_torch.tiers.base import KVTier

__all__ = ["PrefixTier"]


@dataclasses.dataclass
class _Binding:
    tokens: np.ndarray                      # the row's declared token stream
    staged: dict = dataclasses.field(default_factory=dict)
    # (layer, gid) -> [G, 2, Hkv, d]; bytes below mirror it for row_bytes
    staged_bytes: int = 0


class PrefixTier(KVTier):
    """Group-granular :class:`KVTier` adapter over a ``PrefixCache``.

    The cache must be :meth:`~repro.cache.PrefixCache.open`-ed (the
    geometry defines group size / block size / layer count) before any
    verb is used, and rows must be bound to token streams first — an
    unbound row has no content identity, so every operation on it misses
    or declines.
    """

    name = "prefix"

    def __init__(self, cache):
        self.cache = cache
        self._rows: dict[int, _Binding] = {}

    # -- binding -----------------------------------------------------------
    def bind_row(self, row: int, tokens: np.ndarray) -> None:
        """Declare ``row``'s token stream (re-binding replaces the previous
        binding and drops its staging — a recycled slot must never publish
        a previous tenant's payload under new tokens)."""
        toks = np.ascontiguousarray(
            np.asarray(tokens).reshape(-1), dtype=np.int64)
        self._rows[row] = _Binding(tokens=toks)

    def _geo(self):
        if self.cache.manifest is None:
            raise RuntimeError("PrefixTier requires an opened PrefixCache")
        return self.cache.manifest.geometry

    def _chain(self, binding: _Binding):
        return chain_blocks(binding.tokens, self._geo().block_tokens)

    # -- KVTier verbs ------------------------------------------------------
    def lookup(self, layer: int, row: int,
               gids: Sequence[int]) -> list[int]:
        binding = self._rows.get(row)
        if binding is None:
            return []
        g = self._geo().group_size
        resident_groups = self.cache.peek(binding.tokens) // g
        return [int(gid) for gid in gids if int(gid) < resident_groups]

    def serve(self, layer: int, row: int, gid: int,
              dtype) -> np.ndarray | None:
        served, _ = self.serve_run(layer, row, [int(gid)], dtype)
        return served[0][1] if served else None

    def serve_run(self, layer: int, row: int, gids: Sequence[int],
                  dtype) -> tuple[list[tuple[int, np.ndarray]], list[int]]:
        """Match the row's chain once, restore it once (per-layer planned
        slab reads, accountant-charged, checksums verified), then slice the
        requested groups out of the restored span.  Corruption quarantines
        inside ``read_chain`` and degrades the whole batch to a miss — the
        caller's next tier (or a re-publish) is authoritative."""
        binding = self._rows.get(row)
        if binding is None or not gids:
            return [], [int(g) for g in gids]
        geo = self._geo()
        g = geo.group_size
        metas = self.cache.match(binding.tokens)
        n_groups = sum(m.n_tokens for m in metas) // g
        hit = [int(x) for x in gids if int(x) < n_groups]
        residue = [int(x) for x in gids if int(x) >= n_groups]
        if not hit:
            return [], residue
        self.cache.pin(metas)
        try:
            k, v = self.cache.read_chain(metas)   # [nl, n_tok, hkv, d]
        except CorruptBlockError:
            return [], [int(x) for x in gids]
        finally:
            self.cache.unpin(metas)
        served = []
        for gid in hit:
            kg = k[layer, gid * g:(gid + 1) * g]
            vg = v[layer, gid * g:(gid + 1) * g]
            served.append(
                (gid, np.stack([kg, vg], axis=1).astype(dtype)))
        return served, residue

    def admit(self, layer: int, row: int, gid: int, kv: np.ndarray, *,
              scale=None, disk_nbytes: int | None = None) -> bool:
        """Stage one group payload; publish every block the staged set now
        completes.  Declines groups beyond the bound stream's full blocks
        (the tail that ``chain_blocks`` never caches)."""
        binding = self._rows.get(row)
        if binding is None:
            return False
        geo = self._geo()
        bg = geo.block_tokens // geo.group_size
        full_groups = (len(binding.tokens) // geo.block_tokens) * bg
        if int(gid) >= full_groups:
            return False
        kv = np.asarray(kv)
        key = (int(layer), int(gid))
        old = binding.staged.pop(key, None)
        if old is not None:
            binding.staged_bytes -= old.nbytes
        binding.staged[key] = kv
        binding.staged_bytes += kv.nbytes
        self._publish_complete(binding, geo)
        return True

    def _publish_complete(self, binding: _Binding, geo) -> None:
        """Publish staged blocks root-first.  A block is publishable once
        every (layer, gid) of its extent is staged AND its parent is
        resident; publishing consumes the staged payload."""
        bg = geo.block_tokens // geo.group_size
        chain = self._chain(binding)
        for blk in chain:
            if self.cache.contains(blk.block_id):
                continue
            if blk.parent_id != "root" \
                    and not self.cache.contains(blk.parent_id):
                break   # chains publish root-first; a gap stops the walk
            g0 = blk.index * bg
            keys = [(layer, g0 + off)
                    for layer in range(geo.n_layers) for off in range(bg)]
            if not all(k in binding.staged for k in keys):
                break
            k = np.empty((geo.n_layers, bg, geo.group_size,
                          geo.n_kv_heads, geo.head_dim), dtype=geo.np_dtype)
            v = np.empty_like(k)
            for layer in range(geo.n_layers):
                for off in range(bg):
                    kv = binding.staged[(layer, g0 + off)]
                    k[layer, off] = kv[:, 0]
                    v[layer, off] = kv[:, 1]
            if not self.cache.put_block(blk, k, v):
                break   # budget exhausted by pinned blocks; retry later
            for key in keys:
                binding.staged_bytes -= binding.staged.pop(key).nbytes

    def invalidate(self, layer: int, row: int, gid: int) -> None:
        """Quarantine the resident block covering ``gid`` (descendants
        fall with it — their chains pass through the dropped data) and
        drop the group's staged payload across all layers."""
        binding = self._rows.get(row)
        if binding is None:
            return
        geo = self._geo()
        bg = geo.block_tokens // geo.group_size
        chain = self._chain(binding)
        blk_index = int(gid) // bg
        if blk_index < len(chain):
            self.cache.quarantine(chain[blk_index].block_id)
        for key in [k for k in binding.staged if k[1] == int(gid)]:
            binding.staged_bytes -= binding.staged.pop(key).nbytes

    def free_row(self, row: int) -> None:
        self._rows.pop(row, None)

    def row_bytes(self, row: int) -> int:
        binding = self._rows.get(row)
        return int(binding.staged_bytes) if binding is not None else 0
