"""Budgeted host-RAM warm tier: a quantized victim cache between the
per-layer :class:`~repro.core.reuse_buffer.ReuseBuffer` and the
:class:`~repro.core.offload.KVDiskStore`.

The reuse buffer converts a few megabytes into skipped disk reads (Fig. 8:
75-81 % of critical groups recur step to step), but every group that falls
out of it goes straight back to disk and must be re-read at full
eMMC/UFS/NVMe cost.  The warm tier absorbs that re-read tail: on
reuse-buffer eviction a group is **admitted** as a per-group-scaled int8
copy (the same format as the int8 disk tier, via
:func:`~repro.core.offload.quant_groups`); on a later fetch miss the
:class:`~repro.core.manager.KVCacheManager` consults the warm tier *first*
and only sends true misses to the :class:`~repro.io.scheduler.ReadScheduler`.

Hierarchy after this module::

    ReuseBuffer (hot, fp, per layer)  →  WarmTier (int8, global budget)  →  disk

Design points:

* **One tier per engine** — the ``warm_budget_bytes`` knob is a single
  global byte budget shared by every layer and batch row, charged per entry
  as slab bytes (int8 payload + scale) **plus** a fixed per-entry index
  overhead, so the knob is auditable against resident memory
  (``KVSwapEngine.metadata_bytes()``).
* **LRU with per-row accounting** — eviction is globally least-recently-
  admitted/served across ``(layer, row, group)`` keys; per-row byte counts
  let :meth:`clear_row` free a retired slot's entries in O(entries-of-row).
* **Exclusive (victim-cache) residency** — a hit *pops* the entry while the
  group re-enters the reuse buffer; the next reuse eviction re-admits it.
  Nothing is ever resident in both tiers, so the budget buys distinct bytes.
* **Honest cost model** — a hit is served at a modeled memcpy+dequantize
  cost on the :class:`~repro.core.hardware.ComputeSpec` (one
  multiply per element, int8 read + full-dtype write), charged to the
  :class:`~repro.core.offload.IOAccountant` as a *warm* source — never as
  ``DiskSpec.read_time`` — so ``StepStats``/``overlap_report`` show the
  saving without pretending RAM is a disk.
* **Bit-identity at ``kv_bits=8``** — when the disk tier is itself int8,
  admission reuses the group's *on-disk scale* (resident metadata,
  4 B/group): re-quantizing the dequantized slot contents with that scale
  recovers the exact on-disk int8 payload, so a warm hit returns bytes
  bit-identical to the disk read it replaces.  With a raw (fp) disk tier
  the warm copy is freshly quantized and a hit is within int8 quantization
  tolerance instead.
* **Coherence** — the store invalidates a warm entry whenever its
  ``(layer, row, group)`` extent is rewritten (:meth:`invalidate`), and
  row retirement (:meth:`clear_row`, via ``KVDiskStore.free_row``) drops
  all of a slot's entries so a recycled slot can never serve a previous
  tenant's KV.
* **Thread safety** — fetches run on prefetch-worker threads (one per
  layer, but layers in parallel) while the engine thread appends/retires;
  a single lock guards all tier state.
"""

from __future__ import annotations

import collections
import dataclasses
import threading

import numpy as np

from repro_torch.core import hardware
from repro_torch.core.offload import quant_groups
from repro_torch.tiers.base import KVTier

# Modeled per-entry index overhead (key tuple, LRU links, row accounting),
# charged against the budget alongside the slab bytes so the knob bounds
# *total* resident growth, not just payload.
INDEX_ENTRY_BYTES = 96


def warm_serve_time(spec: hardware.ComputeSpec, q_nbytes: int,
                    out_nbytes: int) -> float:
    """Modeled seconds to serve one warm hit: dequantize ``q_nbytes`` int8
    elements (one multiply each) while moving the int8 payload in and the
    full-dtype group out of host RAM.  Priced on the platform
    :class:`~repro.core.hardware.ComputeSpec` — host memory bandwidth, not
    ``DiskSpec`` — which is the whole point of the tier."""
    return spec.op_time(2.0 * q_nbytes, q_nbytes + out_nbytes)


@dataclasses.dataclass
class WarmTierStats:
    """Lifetime counters (lookups only happen for reuse-buffer misses, so
    ``hit_rate`` is exactly the fraction of reuse misses the warm tier
    absorbed)."""

    hits: int = 0
    misses: int = 0
    admitted: int = 0
    evicted: int = 0
    invalidated: int = 0
    rejected: int = 0          # admissions refused (entry alone over budget)
    serve_errors: int = 0      # hits degraded to misses by internal failures

    @property
    def hit_rate(self) -> float:
        tot = self.hits + self.misses
        return self.hits / tot if tot else 0.0


@dataclasses.dataclass
class _Entry:
    q: np.ndarray              # int8 [G, 2, H_kv, d]
    scale: float               # per-group scale (float32 semantics)
    charged: int               # bytes charged to the budget (slab + index)
    disk_nbytes: int           # bytes the replaced disk read would have moved


class WarmTier(KVTier):
    """Budgeted, quantized host-RAM victim cache keyed by
    ``(layer, row, group)``.

    ``budget_bytes`` bounds ``bytes_used`` (slab payload + scales + modeled
    index overhead); admission evicts LRU entries until the newcomer fits
    and refuses outright if it alone exceeds the budget.  A zero/negative
    budget disables every operation (cheap early-outs), which is what makes
    ``warm_budget_bytes=0`` byte-identical to not having the tier at all.

    One of the three :class:`~repro.tiers.base.KVTier` implementations:
    the manager's fetch chain walks ``[warm, disk]``, so every verb here
    (``lookup``/``serve``/``admit``/``invalidate``/``free_row``) conforms
    to the shared protocol and the tier is interchangeable with the disk
    and prefix wrappers in the conformance suite.
    """

    name = "warm"

    def __init__(self, *, budget_bytes: int,
                 compute: hardware.ComputeSpec = hardware.ORIN,
                 accountant=None, obs=None):
        self.budget_bytes = int(budget_bytes)
        self.compute = compute
        self.accountant = accountant
        self.stats = WarmTierStats()
        # observability: mirror every stats increment into registry counters
        # inside the tier lock, so counter totals always equal snapshot()
        self._obs = obs
        self._metrics = None
        if obs is not None and obs.enabled:
            c = obs.registry.counter
            self._metrics = {
                "hits": c("kvswap_warm_hits_total", "warm-tier hits"),
                "misses": c("kvswap_warm_misses_total", "warm-tier misses"),
                "admitted": c("kvswap_warm_admitted_total",
                              "groups demoted from a reuse buffer"),
                "evicted": c("kvswap_warm_evicted_total",
                             "LRU evictions under the byte budget"),
                "invalidated": c("kvswap_warm_invalidated_total",
                                 "entries dropped for coherence"),
                "rejected": c("kvswap_warm_rejected_total",
                              "admissions refused (entry alone over budget)"),
                "serve_errors": c("kvswap_warm_serve_errors_total",
                                  "hits degraded to misses by internal "
                                  "failures (fail-safe serve)"),
            }
        self._lock = threading.Lock()
        # key (layer, row, gid) -> _Entry; order = LRU (oldest first)
        self._entries: "collections.OrderedDict[tuple, _Entry]" = \
            collections.OrderedDict()
        self._row_bytes: dict[int, int] = {}
        self._bytes_used = 0

    # -- sizing / audit ---------------------------------------------------
    @property
    def enabled(self) -> bool:
        return self.budget_bytes > 0

    @property
    def bytes_used(self) -> int:
        """Budget-charged resident bytes (slab + index)."""
        return self._bytes_used

    @property
    def nbytes(self) -> int:
        """Slab payload bytes (int8 groups + 4 B scale each)."""
        with self._lock:
            return sum(e.q.nbytes + 4 for e in self._entries.values())

    @property
    def index_nbytes(self) -> int:
        """Modeled index overhead (keys, LRU links, row accounting)."""
        return len(self._entries) * INDEX_ENTRY_BYTES

    def row_bytes(self, row: int) -> int:
        """Budget-charged bytes currently held for one batch row."""
        with self._lock:
            return self._row_bytes.get(row, 0)

    def __len__(self) -> int:
        return len(self._entries)

    def _minc(self, key: str, n: int = 1) -> None:
        """Mirror one stats increment into the bound registry counter.
        Called with the tier lock held, right where the stats field moves,
        so counter totals always equal :meth:`snapshot`."""
        if self._metrics is not None and n:
            self._metrics[key].inc(n)

    # -- the victim-cache protocol ---------------------------------------
    def lookup(self, layer: int, row: int, gids) -> list[int]:
        """Resident subset of ``gids``, side-effect-free: no stats, no LRU
        movement, no pop — the scheduling-probe counterpart of
        :meth:`serve` (whose hits are exclusive and counted)."""
        if not self.enabled:
            return []
        with self._lock:
            return [int(g) for g in gids
                    if (layer, row, int(g)) in self._entries]

    def admit(self, layer: int, row: int, gid: int, kv: np.ndarray, *,
              scale: float | None = None, disk_nbytes: int | None = None) -> bool:
        """Admit one evicted group (``kv: [G, 2, H_kv, d]``, full dtype).

        ``scale`` — the group's on-disk int8 scale when the disk tier is
        int8: re-quantizing with it makes the round trip exact (the
        ``kv_bits=8`` bit-identity contract).  ``None`` quantizes fresh
        with a max-based per-group scale.  ``disk_nbytes`` is the size of
        the disk read a future hit replaces (defaults to the int8 payload
        size) — it is what hit accounting reports as warm-served bytes so
        the per-source breakdown stays in disk-read units.
        """
        if not self.enabled:
            return False
        kv = np.asarray(kv)
        if scale is not None and scale > 0:
            q = np.clip(np.rint(kv / np.float32(scale)), -127, 127).astype(np.int8)
            s = float(scale)
        else:
            q, s_arr = quant_groups(kv)
            s = float(s_arr)
        charged = q.nbytes + 4 + INDEX_ENTRY_BYTES
        with self._lock:
            if charged > self.budget_bytes:
                self.stats.rejected += 1
                self._minc("rejected")
                return False
            key = (layer, row, gid)
            old = self._entries.pop(key, None)
            if old is not None:
                self._uncharge(row, old.charged)
            while self._bytes_used + charged > self.budget_bytes:
                vkey, victim = self._entries.popitem(last=False)
                self._uncharge(vkey[1], victim.charged)
                self.stats.evicted += 1
                self._minc("evicted")
            self._entries[key] = _Entry(
                q=q, scale=s, charged=charged,
                disk_nbytes=int(disk_nbytes) if disk_nbytes else q.nbytes)
            self._bytes_used += charged
            self._row_bytes[row] = self._row_bytes.get(row, 0) + charged
            self.stats.admitted += 1
            self._minc("admitted")
        return True

    def serve(self, layer: int, row: int, gid: int, dtype) -> np.ndarray | None:
        """Serve one group (``[G, 2, H_kv, d]`` in ``dtype``) or ``None``.

        A hit is exclusive: the entry pops (the caller promotes the group
        back into the reuse buffer) and its modeled memcpy+dequantize cost
        is charged to the accountant's *warm* lane.

        Fail-safe (docs/robustness.md): the warm tier is an optimization,
        never a correctness dependency, so any internal failure while
        serving degrades to a miss — the caller falls through to the
        authoritative disk read — instead of tearing the decode step.  The
        popped entry is simply lost (exclusive-residency semantics already
        allow that) and ``serve_errors`` counts the event.
        """
        if not self.enabled:
            return None
        try:
            with self._lock:
                entry = self._entries.pop((layer, row, gid), None)
                if entry is None:
                    self.stats.misses += 1
                    self._minc("misses")
                    return None
                self._uncharge(row, entry.charged)
                self.stats.hits += 1
                self._minc("hits")
            obs = self._obs
            if obs is not None and obs.enabled:
                # hits are sparse enough to mark individually; admissions are
                # every reuse eviction and stay counter-only
                obs.tracer.add("warm_hit", "warm-tier", cat="warm",
                               wall_t0_ns=obs.tracer.now_ns(), instant=True,
                               args={"layer": layer, "row": row, "group": gid})
            out = (entry.q.astype(np.float32)
                   * np.float32(entry.scale)).astype(dtype)
            if self.accountant is not None:
                self.accountant.charge_warm(
                    entry.disk_nbytes,
                    warm_serve_time(self.compute, entry.q.nbytes, out.nbytes))
            return out
        except Exception:
            with self._lock:
                self.stats.serve_errors += 1
                self._minc("serve_errors")
            return None

    # -- coherence --------------------------------------------------------
    def invalidate(self, layer: int, row: int, gid: int) -> None:
        """Drop one entry because its disk extent was rewritten."""
        if not self.enabled:
            return
        with self._lock:
            entry = self._entries.pop((layer, row, gid), None)
            if entry is not None:
                self._uncharge(row, entry.charged)
                self.stats.invalidated += 1
                self._minc("invalidated")

    def invalidate_range(self, layer: int, row: int, n_groups: int) -> None:
        """Drop every entry for groups ``[0, n_groups)`` of one (layer, row)
        — the prefill-write coherence path.  One lock acquisition and a scan
        of *resident* entries, not ``n_groups`` individual lookups (prefills
        rewrite thousands of groups; the tier usually holds none of them)."""
        if not self.enabled:
            return
        with self._lock:
            if not self._entries:
                return
            doomed = [k for k in self._entries
                      if k[0] == layer and k[1] == row and k[2] < n_groups]
            for key in doomed:
                self._uncharge(row, self._entries.pop(key).charged)
            self.stats.invalidated += len(doomed)
            self._minc("invalidated", len(doomed))

    def clear_row(self, row: int) -> None:
        """Retire a batch row: free every layer's entries for it (the slot-
        recycling contract — a re-admitted tenant can never hit stale KV)."""
        if not self.enabled:
            return
        with self._lock:
            doomed = [k for k in self._entries if k[1] == row]
            for key in doomed:
                self._uncharge(row, self._entries.pop(key).charged)
            self.stats.invalidated += len(doomed)
            self._minc("invalidated", len(doomed))

    def free_row(self, row: int) -> None:
        """Protocol name for :meth:`clear_row` (the historical verb the
        store's coherence hooks call); both drop every layer's entries for
        the row and zero its :meth:`row_bytes` accounting."""
        self.clear_row(row)

    def _uncharge(self, row: int, charged: int) -> None:
        """Caller holds the lock."""
        self._bytes_used -= charged
        left = self._row_bytes.get(row, 0) - charged
        if left > 0:
            self._row_bytes[row] = left
        else:
            self._row_bytes.pop(row, None)

    # -- reporting --------------------------------------------------------
    def snapshot(self) -> dict:
        with self._lock:
            return {
                "budget_bytes": self.budget_bytes,
                "bytes_used": self._bytes_used,
                "entries": len(self._entries),
                "index_nbytes": len(self._entries) * INDEX_ENTRY_BYTES,
                "hits": self.stats.hits,
                "misses": self.stats.misses,
                "hit_rate": self.stats.hit_rate,
                "admitted": self.stats.admitted,
                "evicted": self.stats.evicted,
                "invalidated": self.stats.invalidated,
                "rejected": self.stats.rejected,
                "serve_errors": self.stats.serve_errors,
            }
