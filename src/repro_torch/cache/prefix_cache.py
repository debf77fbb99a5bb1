"""The persistent, content-addressed prefix cache: public facade.

Glues the pieces together — :mod:`blocks` (chain identity), :mod:`manifest`
(index + persistence), :mod:`store` (slab of KV groups), :mod:`policy`
(LRU+pin eviction under the disk budget) — behind the three operations the
engine uses:

* :meth:`PrefixCache.match`    — longest cached prefix of a prompt,
* :meth:`PrefixCache.read_chain` — restore matched blocks' KV (sequential,
  run-planned, accountant-charged reads),
* :meth:`PrefixCache.put_block`  — publish one block (dedup, budget-evict).

A cache outlives engines: :class:`~repro.serving.scheduler.BatchServer`
keeps one handle across flushes, and with ``cfg.dir`` set the manifest +
slab survive the process, so the *next* run starts warm too.
"""

from __future__ import annotations

import dataclasses
import os

import numpy as np

from repro_torch.cache.blocks import ROOT_ID, TokenBlock, chain_blocks
from repro_torch.cache.manifest import BlockMeta, CacheGeometry, Manifest
from repro_torch.cache.policy import LRUPinPolicy
from repro_torch.cache.store import PrefixBlockStore
from repro_torch.core.offload import IOAccountant
from repro_torch.faults.errors import (CorruptBlockError, InjectedCrash,
                                 ManifestCorrupt)
from repro_torch.io.scheduler import ReadScheduler

from repro_torch.utils.bytesize import MiB


@dataclasses.dataclass(frozen=True)
class PrefixCacheConfig:
    """Knobs (see ``docs/tuning.md`` → "Prefix cache").

    * ``block_tokens`` — tokens per cache block; must be a multiple of the
      engine's ``group_size``.  Bigger blocks → fewer hash links and longer
      sequential reads, but coarser sharing (a one-token prompt divergence
      discards the whole block).
    * ``budget_bytes`` — slab size on disk; LRU eviction keeps resident
      blocks under it.  Fixed at slab **creation**: reopening a persistent
      ``dir`` cache keeps its original capacity (delete the directory to
      resize).
    * ``dir`` — persistent directory (``manifest.json`` + ``blocks.bin``).
      ``None`` = process-lifetime cache in a temp file.
    * ``coalesce_gap`` — ``ReadScheduler`` gap (in groups) for restores;
      lets a restore read through small holes between matched extents.
    * ``kv_bits`` — 16 stores the raw engine dtype (restores are
      bit-identical to cold prefill); **8** stores per-group int8 (§7),
      shrinking every restore read ~4× for a small requantization error.
    """

    block_tokens: int = 32
    budget_bytes: int = 256 * MiB
    dir: str | None = None
    coalesce_gap: int = 0
    kv_bits: int = 16


@dataclasses.dataclass
class PrefixCacheStats:
    """Cumulative session counters.

    ``matched_tokens`` counts each row's longest-prefix match as returned by
    :meth:`PrefixCache.match` — i.e. *matchable* tokens.  A batched engine
    may restore fewer (it trims to the batch-common prefix), so the exact
    restored fraction per flush is ``prefill_report['cached_tokens'] /
    prompt_tokens``, which is what ``BatchServer.last_stats`` reports as
    ``hit_rate``; ``session_hit_rate`` is this cumulative matchable rate.
    """

    lookups: int = 0
    lookup_tokens: int = 0      # full-block-aligned tokens eligible to hit
    matched_tokens: int = 0     # matchable (pre-batch-trim; see docstring)
    published_blocks: int = 0
    dedup_blocks: int = 0       # publish hits (block already resident)
    evicted_blocks: int = 0
    declined_blocks: int = 0    # budget full of pinned blocks
    corrupt_blocks: int = 0     # extent-checksum mismatches on restore
    quarantined_blocks: int = 0  # blocks dropped by quarantine (incl. descendants)

    @property
    def hit_rate(self) -> float:
        return self.matched_tokens / self.lookup_tokens if self.lookup_tokens else 0.0


class PrefixCache:
    """Cross-request, content-addressed KV block cache on the disk tier."""

    def __init__(self, cfg: PrefixCacheConfig = PrefixCacheConfig(), *,
                 accountant: IOAccountant | None = None):
        self.cfg = cfg
        self.manifest: Manifest | None = None
        self.store: PrefixBlockStore | None = None
        self.policy = LRUPinPolicy()
        self.scheduler = ReadScheduler(max_gap=cfg.coalesce_gap)
        self.stats = PrefixCacheStats()
        self._accountant = accountant
        self._obs = None
        self._faults = None
        self.recovered_from: str | None = None
        if cfg.dir:
            os.makedirs(cfg.dir, exist_ok=True)
            mpath = self._manifest_path()
            if os.path.exists(mpath):
                try:
                    self.manifest = Manifest.load(mpath)
                    self._open_store(self.manifest.geometry)
                    for meta in self.manifest.blocks.values():
                        self.store.mark_allocated(meta.start_group,
                                                  meta.n_groups)
                except (ManifestCorrupt, RuntimeError, OSError,
                        ValueError) as exc:
                    # torn manifest / impossible extents: the index can't
                    # be trusted, so recover instead of refusing to open
                    self._recover_dir(exc)

    # -- setup ------------------------------------------------------------
    def _manifest_path(self) -> str:
        return os.path.join(self.cfg.dir, "manifest.json")

    def _recover_dir(self, exc: BaseException) -> None:
        """Recover a persistent cache directory whose index is unusable
        (docs/robustness.md): drop the manifest, GC the orphaned slab
        files (their extents have no trustworthy owner left), and start
        the directory empty.  Losing cached prefixes only costs
        warm-prefill speed — serving anything the torn index pointed at
        could cost correctness."""
        self.recovered_from = f"{type(exc).__name__}: {exc}"
        if self.store is not None:
            self.store.close()
            self.store = None
        self.manifest = None
        for name in ("manifest.json", "blocks.bin", "blocks.bin.scales.npy"):
            p = os.path.join(self.cfg.dir, name)
            if os.path.exists(p):
                os.unlink(p)

    def _open_store(self, geo: CacheGeometry) -> None:
        path = os.path.join(self.cfg.dir, "blocks.bin") if self.cfg.dir else None
        self.store = PrefixBlockStore(
            n_layers=geo.n_layers, capacity_groups=geo.capacity_groups,
            group_size=geo.group_size, n_kv_heads=geo.n_kv_heads,
            head_dim=geo.head_dim, dtype=geo.np_dtype, path=path,
            accountant=self._accountant,
            quant_bits=8 if geo.kv_bits == 8 else 0,
        )

    def open(self, *, n_layers: int, group_size: int, n_kv_heads: int,
             head_dim: int, dtype) -> None:
        """Create (or validate) the slab for this KV geometry.

        Called lazily by the engine; idempotent.  A persistent cache reopened
        under a different geometry raises — mixing layouts would corrupt it.
        """
        if self.cfg.block_tokens % group_size:
            raise ValueError(
                f"block_tokens={self.cfg.block_tokens} must be a multiple of "
                f"group_size={group_size}")
        dt = np.dtype(dtype)
        if self.manifest is not None:
            g = self.manifest.geometry
            got = (g.n_layers, g.group_size, g.n_kv_heads, g.head_dim, g.dtype,
                   g.block_tokens, g.kv_bits)
            want = (n_layers, group_size, n_kv_heads, head_dim, dt.name,
                    self.cfg.block_tokens, self.cfg.kv_bits)
            if got != want:
                raise ValueError(f"prefix cache geometry mismatch: cache has "
                                 f"{got}, engine wants {want}")
            return
        itemsize = 1 if self.cfg.kv_bits == 8 else dt.itemsize
        group_nbytes = group_size * 2 * n_kv_heads * head_dim * itemsize
        block_groups = self.cfg.block_tokens // group_size
        cap = max(int(self.cfg.budget_bytes // (group_nbytes * n_layers)),
                  block_groups)
        geo = CacheGeometry(
            n_layers=n_layers, group_size=group_size, n_kv_heads=n_kv_heads,
            head_dim=head_dim, dtype=dt.name, capacity_groups=cap,
            block_tokens=self.cfg.block_tokens, kv_bits=self.cfg.kv_bits)
        self.manifest = Manifest(geo)
        self._open_store(geo)

    @property
    def is_open(self) -> bool:
        return self.store is not None

    def use_accountant(self, accountant: IOAccountant | None) -> None:
        """Charge subsequent reads/writes to ``accountant`` (engines each
        bring their own; the cache itself is engine-agnostic)."""
        self._accountant = accountant
        if self.store is not None:
            self.store.accountant = accountant

    def use_obs(self, obs) -> None:
        """Record subsequent lookups/restores into an
        :class:`~repro.obs.Observability` handle (same engine-agnostic
        attach pattern as :meth:`use_accountant`): restore spans on the
        ``prefix-cache`` lane plus lookup/match/restore/publish counters
        mirroring :class:`PrefixCacheStats`."""
        self._obs = obs if (obs is not None and obs.enabled) else None
        if self._obs is not None:
            c = self._obs.registry.counter
            self._m = {
                "lookups": c("kvswap_prefix_lookups_total",
                             "prefix-cache longest-prefix matches attempted"),
                "lookup_tokens": c("kvswap_prefix_lookup_tokens_total",
                                   "prompt tokens offered for matching"),
                "matched_tokens": c("kvswap_prefix_matched_tokens_total",
                                    "prompt tokens served from cached blocks"),
                "restored_tokens": c("kvswap_prefix_restored_tokens_total",
                                     "KV tokens restored via read_chain"),
                "published_blocks": c("kvswap_prefix_published_blocks_total",
                                      "blocks newly published"),
                "dedup_blocks": c("kvswap_prefix_dedup_blocks_total",
                                  "publishes deduplicated by content hash"),
                "corrupt_blocks": c("kvswap_prefix_corrupt_blocks_total",
                                    "extent-checksum mismatches on restore"),
                "quarantined_blocks": c(
                    "kvswap_prefix_quarantined_blocks_total",
                    "blocks dropped by quarantine (incl. descendants)"),
            }

    def use_faults(self, plan) -> None:
        """Attach a fault-injection plan (:class:`repro.faults.FaultPlan`):
        published extents may be corrupted at rest and manifest saves may
        hit crash points — the injection side of the integrity machinery
        (same engine-agnostic attach pattern as :meth:`use_accountant`)."""
        self._faults = plan

    # -- lookup -----------------------------------------------------------
    def _walk_chain(self, tokens: np.ndarray) -> tuple[list[BlockMeta], int]:
        """Walk ``tokens``'s block-ID chain until the first non-resident
        block: ``(matched metas, full-block tokens offered)``.  Pure
        metadata lookup — no pinning, no LRU movement, no stats, no I/O —
        shared by :meth:`match` (which then touches/charges) and
        :meth:`peek` (which must not)."""
        out: list[BlockMeta] = []
        chain = chain_blocks(tokens, self.cfg.block_tokens)
        for blk in chain:
            meta = self.manifest.blocks.get(blk.block_id)
            if meta is None:
                break
            out.append(meta)
        return out, sum(b.n_tokens for b in chain)

    def peek(self, tokens: np.ndarray) -> int:
        """Longest cached prefix of ``tokens`` in tokens — **observably
        side-effect-free**.

        The affinity router's scoring primitive: it hashes the prompt into
        the same content-addressed chain :meth:`match` uses, but performs a
        pure metadata walk — no pin, no LRU touch, no accountant charge, no
        stats or obs mutation, and no slab I/O — so a front end may score
        every replica's cache per routed request without perturbing any
        replica's eviction order or hit-rate accounting (asserted by
        ``tests/test_router.py``).  An unopened cache peeks 0.
        """
        if self.manifest is None:
            return 0
        matched, _ = self._walk_chain(tokens)
        return sum(m.n_tokens for m in matched)

    def match(self, tokens: np.ndarray, *, max_tokens: int | None = None
              ) -> list[BlockMeta]:
        """Longest-prefix match: chain ``tokens`` and walk until a miss.

        ``max_tokens`` caps the match (the engine always leaves ≥ 1 prompt
        token to recompute, so a fully-cached prompt still yields logits).
        Matched blocks are LRU-touched deepest-first, so within one chain
        the root is always the most recently used — cold *suffixes* evict
        first.

        Restore discipline: callers that go on to :meth:`read_chain` must
        ``pin`` the returned metas first and ``unpin`` them on **every**
        exit path (``try/finally``), including failed restores — a pin
        leaked by an exception would make the block unevictable forever
        (:class:`~repro.cache.policy.LRUPinPolicy` never victimizes pinned
        blocks).  The engine's restore loops follow this discipline;
        ``tests/test_prefix_cache.py`` pins it with a fault-injected
        restore.
        """
        self.stats.lookups += 1
        if self._obs is not None:
            self._m["lookups"].inc()
        if self.manifest is None:
            return []
        out, offered = self._walk_chain(tokens)
        self.stats.lookup_tokens += offered
        if max_tokens is not None:
            while out and sum(m.n_tokens for m in out) > max_tokens:
                out.pop()
        for meta in reversed(out):
            self.manifest.touch(meta)
        matched = sum(m.n_tokens for m in out)
        self.stats.matched_tokens += matched
        if self._obs is not None:
            self._m["lookup_tokens"].inc(offered)
            self._m["matched_tokens"].inc(matched)
        return out

    def contains(self, block_id: str) -> bool:
        return self.manifest is not None and block_id in self.manifest.blocks

    def touch(self, block_id: str) -> None:
        """LRU-refresh a resident block (publish hit) without re-reading KV."""
        meta = self.manifest.blocks.get(block_id) if self.manifest else None
        if meta is not None:
            self.manifest.touch(meta)
            self.stats.dedup_blocks += 1
            if self._obs is not None:
                self._m["dedup_blocks"].inc()

    def chain_metas(self, head_id: str) -> list[BlockMeta] | None:
        """Resolve a chain by its **head** block id: walk parent pointers
        root-ward and return the metas root-first, or ``None`` if any link
        (including the head itself) is no longer resident — a quarantined
        or evicted ancestor breaks the whole handle.

        This is the restore-by-reference primitive of the disagg handoff: a
        prefill ticket carries only the chain head id, and the decode side
        resolves it here without re-hashing the prompt.  Pure metadata walk
        — no LRU touch, no stats, no I/O (same contract as :meth:`peek`).
        """
        if self.manifest is None:
            return None
        out: list[BlockMeta] = []
        cur: str = head_id
        while cur != ROOT_ID:
            meta = self.manifest.blocks.get(cur)
            if meta is None:
                return None
            out.append(meta)
            cur = meta.parent_id
        out.reverse()
        return out

    def verify_chain(self, metas: list[BlockMeta]) -> bool:
        """Re-hash every block's extent against its published CRC32 without
        serving any KV.  A mismatch quarantines the block (and descendants)
        exactly like :meth:`read_chain` would, bumps the corruption stats,
        and returns ``False`` — the caller's signal to re-prefill rather
        than hand the chain to a decode session.  Blocks with
        ``checksum == 0`` (pre-checksum manifests) pass vacuously.
        """
        for m in metas:
            if m.checksum and self.store.checksum_extent(
                    m.start_group, m.n_groups) != m.checksum:
                dropped = self.quarantine(m.block_id)
                self.stats.corrupt_blocks += 1
                if self._obs is not None:
                    self._m["corrupt_blocks"].inc()
                    self._m["quarantined_blocks"].inc(dropped)
                return False
        return True

    # -- pinning ----------------------------------------------------------
    def pin(self, metas: list[BlockMeta]) -> None:
        for m in metas:
            m.pins += 1

    def unpin(self, metas: list[BlockMeta]) -> None:
        for m in metas:
            m.pins -= 1
            if m.pins < 0:
                raise RuntimeError(f"unbalanced unpin of block {m.block_id}")

    # -- restore ----------------------------------------------------------
    def read_chain(self, metas: list[BlockMeta]) -> tuple[np.ndarray, np.ndarray]:
        """Read a matched chain's KV: ``(k, v)`` each
        ``[n_layers, n_tokens, H_kv, d]`` in chain (token) order.

        Reads are planned per layer across *all* matched extents, so chains
        that were published contiguously restore as one long sequential read
        per layer, charged through the accountant.

        Integrity (docs/robustness.md): before any bytes are served, every
        block's extent is re-hashed against the CRC32 its manifest entry
        recorded at publish time.  A mismatch quarantines the block (and
        every resident descendant — their chains pass through the bad
        data) and raises :class:`~repro.faults.errors.CorruptBlockError`;
        the engine then re-matches the now-shorter chain, so warm prefill
        degrades block by block toward a cold prefill instead of ever
        computing on corrupt KV.  ``checksum == 0`` (pre-checksum
        manifests) skips verification for that block.
        """
        geo = self.manifest.geometry
        for idx, m in enumerate(metas):
            if m.checksum and self.store.checksum_extent(
                    m.start_group, m.n_groups) != m.checksum:
                dropped = self.quarantine(m.block_id)
                self.stats.corrupt_blocks += 1
                if self._obs is not None:
                    self._m["corrupt_blocks"].inc()
                    self._m["quarantined_blocks"].inc(dropped)
                raise CorruptBlockError(
                    f"block {m.block_id} (chain depth {m.index}) failed its "
                    f"extent checksum; quarantined {dropped} block(s)",
                    block_id=m.block_id, index=m.index, verified_blocks=idx)
        extents = [(m.start_group, m.n_groups) for m in metas]
        n_tok = sum(m.n_tokens for m in metas)
        hkv, d = geo.n_kv_heads, geo.head_dim
        obs = self._obs
        if obs is not None:
            r0 = obs.tracer.now_ns()
        k = np.empty((geo.n_layers, n_tok, hkv, d), dtype=geo.np_dtype)
        v = np.empty_like(k)
        for layer in range(geo.n_layers):
            kl, vl = self.store.read_extents(layer, extents, self.scheduler)
            k[layer] = kl.reshape(-1, hkv, d)
            v[layer] = vl.reshape(-1, hkv, d)
        if obs is not None:
            obs.tracer.add(
                "restore_chain", "prefix-cache", cat="prefix",
                wall_t0_ns=r0, wall_t1_ns=obs.tracer.now_ns(),
                args={"blocks": len(metas), "tokens": n_tok,
                      "layers": geo.n_layers})
            self._m["restored_tokens"].inc(n_tok)
        return k, v

    # -- publish ----------------------------------------------------------
    def put_block(self, block: TokenBlock, k: np.ndarray, v: np.ndarray) -> bool:
        """Publish one block (``k, v: [n_layers, n_groups, G, H_kv, d]``).

        Content addressing makes this idempotent: a resident block is just
        LRU-touched.  A full slab evicts LRU chains (never pinned ones);
        returns ``False`` if the budget is entirely pinned and the block was
        declined.  The parent must already be resident (publish chains
        root-first) so resident blocks always form rooted chains.
        """
        geo = self.manifest.geometry
        existing = self.manifest.blocks.get(block.block_id)
        if existing is not None:
            self.manifest.touch(existing)
            self.stats.dedup_blocks += 1
            if self._obs is not None:
                self._m["dedup_blocks"].inc()
            return True
        if block.parent_id != "root" and block.parent_id not in self.manifest.blocks:
            raise ValueError(f"parent {block.parent_id} of block "
                             f"{block.block_id} is not resident; publish chains root-first")
        ng = block.n_tokens // geo.group_size
        # pin the incoming block's ancestors while we make room: evicting
        # them to fit their own descendant would orphan the chain
        ancestors: list[BlockMeta] = []
        cur = self.manifest.blocks.get(block.parent_id)
        while cur is not None:
            ancestors.append(cur)
            cur = self.manifest.blocks.get(cur.parent_id)
        self.pin(ancestors)
        try:
            while True:
                start = self.store.alloc(ng)
                if start is not None:
                    break
                victims = self.policy.victims(self.manifest, ng)
                if not victims:
                    self.stats.declined_blocks += 1
                    return False
                self._evict(victims)
        finally:
            self.unpin(ancestors)
        checksum = self.store.write_block(start, k, v)
        if self._faults is not None:
            # at-rest corruption is injected after the checksum is taken,
            # so a flipped extent is exactly what verification must catch
            self._faults.corrupt_block(self.store, start, ng,
                                       key=block.block_id)
        meta = BlockMeta(
            block_id=block.block_id, parent_id=block.parent_id,
            index=block.index, n_tokens=block.n_tokens,
            start_group=start, n_groups=ng, last_used=self.manifest.tick(),
            checksum=checksum)
        self.manifest.blocks[meta.block_id] = meta
        self.stats.published_blocks += 1
        if self._obs is not None:
            self._m["published_blocks"].inc()
        return True

    def _evict(self, victims: list[BlockMeta]) -> None:
        for m in victims:
            del self.manifest.blocks[m.block_id]
            self.store.free(m.start_group, m.n_groups)
            self.stats.evicted_blocks += 1

    def quarantine(self, block_id: str) -> int:
        """Drop a corrupt block and every resident descendant (their chains
        pass through the bad data, so none of them is restorable).  Returns
        the number of blocks removed.  Pins are deliberately ignored:
        integrity beats residency — a pinned-but-corrupt block must never
        be served again, and in-flight restore loops re-match afterwards.
        """
        if self.manifest is None or block_id not in self.manifest.blocks:
            return 0
        doomed = {block_id}
        changed = True
        while changed:
            changed = False
            for m in self.manifest.blocks.values():
                if m.block_id not in doomed and m.parent_id in doomed:
                    doomed.add(m.block_id)
                    changed = True
        for bid in doomed:
            m = self.manifest.blocks.pop(bid)
            self.store.free(m.start_group, m.n_groups)
        self.stats.quarantined_blocks += len(doomed)
        return len(doomed)

    # -- introspection ----------------------------------------------------
    def resident_blocks(self) -> int:
        return len(self.manifest.blocks) if self.manifest else 0

    def resident_bytes(self) -> int:
        return self.manifest.resident_bytes() if self.manifest else 0

    # -- persistence / lifecycle ------------------------------------------
    def save(self) -> None:
        """Persist the manifest (and flush the slab) for ``dir`` caches."""
        if self.cfg.dir and self.manifest is not None and self.store is not None:
            self.store.flush()
            if self._faults is not None and \
                    self._faults.should_crash("manifest_write"):
                # simulate dying mid-manifest-write: leave a torn file
                # where the manifest belongs (what a power cut during the
                # pre-fsync copy would leave as the *tmp* file, or a
                # non-atomic writer would leave in place), then die.  The
                # next process opening this dir exercises _recover_dir.
                with open(self._manifest_path(), "w") as f:
                    f.write('{"geometry": {"n_layers": ')
                raise InjectedCrash("crashed during manifest write",
                                    point="manifest_write")
            self.manifest.save(self._manifest_path())

    def close(self) -> None:
        self.save()
        if self.store is not None:
            self.store.close()
            self.store = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
