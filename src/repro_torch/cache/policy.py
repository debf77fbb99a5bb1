"""Eviction policy for the prefix cache: LRU over chains, with pinning.

Two constraints shape the policy beyond plain LRU:

* **Pins** — a block being restored into an engine right now must not be
  evicted from under the read.  Pinned blocks (and, transitively, their
  ancestors: a pinned block is only useful with its whole prefix) are never
  victims.

* **Chain integrity** — lookup walks a chain root-first and stops at the
  first miss, so a cached block whose parent is gone is dead weight: it can
  never be matched again.  Evicting a block therefore evicts its cached
  descendants with it, keeping the invariant that resident blocks always
  form rooted chains.  Combined with LRU ordering this naturally sheds cold
  *suffixes* first (a child is never more recently used than its chain's
  match point).
"""

from __future__ import annotations

from repro_torch.cache.manifest import BlockMeta, Manifest


class LRUPinPolicy:
    """Pick eviction victims under the rules above."""

    def victims(self, manifest: Manifest, need_groups: int) -> list[BlockMeta] | None:
        """Blocks to evict so ≥ ``need_groups`` group slots come free.

        Victims are chosen least-recently-used first; choosing a block pulls
        in its resident descendants.  Returns ``None`` when even evicting
        every unpinned block cannot free enough (the caller then declines to
        publish rather than thrash).

        Note: freed groups may be fragmented across the slab; the caller
        retries allocation after each eviction wave and asks again if the
        *contiguous* extent it needs still doesn't exist.
        """
        protected = self._pinned_closure(manifest)
        # one-pass child index: scanning the manifest per visited node in
        # _descend would make an eviction wave O(N²) in resident blocks
        kids: dict[str, list[BlockMeta]] = {}
        for meta in manifest.blocks.values():
            kids.setdefault(meta.parent_id, []).append(meta)
        chosen: list[BlockMeta] = []
        chosen_ids: set[str] = set()
        freed = 0
        for meta in sorted(manifest.blocks.values(), key=lambda m: m.last_used):
            if freed >= need_groups:
                break
            if meta.block_id in protected or meta.block_id in chosen_ids:
                continue
            subtree = self._descend(kids, meta)
            if any(m.block_id in protected for m in subtree):
                continue  # a pinned descendant shields the whole prefix
            for m in subtree:
                if m.block_id not in chosen_ids:
                    chosen_ids.add(m.block_id)
                    chosen.append(m)
                    freed += m.n_groups
        return chosen if freed >= need_groups else None

    # -- helpers ----------------------------------------------------------
    @staticmethod
    def _pinned_closure(manifest: Manifest) -> set[str]:
        """Pinned blocks plus every ancestor along their chains."""
        out: set[str] = set()
        for meta in manifest.blocks.values():
            if meta.pins <= 0:
                continue
            cur: BlockMeta | None = meta
            while cur is not None and cur.block_id not in out:
                out.add(cur.block_id)
                cur = manifest.blocks.get(cur.parent_id)
        return out

    @staticmethod
    def _descend(kids: dict[str, list[BlockMeta]], meta: BlockMeta) -> list[BlockMeta]:
        """``meta`` plus all its resident descendants (DFS over the index)."""
        out, stack = [], [meta]
        while stack:
            cur = stack.pop()
            out.append(cur)
            stack.extend(kids.get(cur.block_id, ()))
        return out
