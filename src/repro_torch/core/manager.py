"""KV cache manager: mapping table over heterogeneous memory (KVSwap §3.4.4).

Attention consumes KV entries from three physical regions:

1. **reuse-buffer slots** that hit,
2. **freshly loaded groups** from disk (inserted into reuse slots),
3. the **rolling buffer** of not-yet-grouped recent tokens.

The manager keeps a *mapping table* — logical slot → (region, physical index)
— rebuilt before each attention call, mirroring OS virtual memory.  This is
what makes the scheme PagedAttention-compatible: the kernel sees one logical,
contiguous KV view plus a validity mask.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.core.offload import KVDiskStore
from repro_torch.core.reuse_buffer import ReuseBuffer
from repro_torch.core.rolling_buffer import RollingBuffer
from repro_torch.core.upload import DeviceUpload, SlabRing, SlabUpload, staged_tokens
from repro_torch.faults.errors import FetchFailed
from repro_torch.faults.retry import RetryPolicy
from repro_torch.io.scheduler import ReadRun, ReadScheduler
from repro_torch.tiers.disk import DiskTier

_EMPTY = np.zeros(0, np.int64)

REGION_REUSE = 0
REGION_ROLLING = 1


@dataclasses.dataclass
class MappingTable:
    """Logical layout handed to the attention kernel for one layer/step."""

    # [B, M] group ids selected (post-mask); -1 for invalid
    group_ids: np.ndarray
    # [B, M] slot index within the reuse buffer holding each selected group
    # (-2 = staged transiently because the reuse buffer is pinned full)
    slots: np.ndarray
    # [B, M] bool — logical group validity
    group_mask: np.ndarray
    # [B] valid rolling-buffer tokens per row (rows advance independently
    # under continuous batching; lockstep batches keep them uniform)
    rolling_fill: np.ndarray
    # transient staging for groups that couldn't enter the reuse buffer
    staged: dict = dataclasses.field(default_factory=dict)  # (bi, gid) -> [G,2,Hkv,d]
    # device-resident path: the slab holding this fetch's served groups (the
    # *delta*: reuse hits ship zero bytes) and the indices that place them
    upload: SlabUpload | None = None


class KVCacheManager:
    """Per-layer runtime state binding the store, reuse and rolling buffers.

    ``fetch`` is the unit of work the async :class:`repro.io.PrefetchWorker`
    services off the critical path: it only touches host memory (reuse slots,
    memmap reads) so it is safe to run on a worker thread, as long as no two
    fetches for the *same* layer run concurrently (the worker's per-layer
    queue guarantees that).
    """

    def __init__(self, *, store: KVDiskStore, reuse: ReuseBuffer, rolling: RollingBuffer,
                 layer: int, scheduler: ReadScheduler | None = None, warm=None,
                 obs=None, retry: RetryPolicy | None = None,
                 slabs: SlabRing | None = None):
        self.store = store
        self.reuse = reuse
        self.rolling = rolling
        self.layer = layer
        self.scheduler = scheduler or ReadScheduler(max_gap=0)
        # the authoritative bottom of the tier chain: run planning, bounded
        # retry-with-backoff (docs/robustness.md) and the typed FetchFailed
        # escalation all live in the DiskTier wrapper now
        self.disk = DiskTier(store=store, layer=layer,
                             scheduler=self.scheduler, retry=retry, obs=obs)
        self.retry = retry
        # optional host-RAM warm tier (repro.tiers.WarmTier) between the
        # reuse buffer and disk: fetch consults it before planning disk
        # reads, and reuse-buffer evictions demote into it (victim cache)
        self.warm = warm
        if warm is not None:
            reuse.victim_sink = self._demote
        self._obs = obs
        # the device-resident engine's upload slabs (None: host gather)
        self.slabs = slabs

    # lifetime fault counters live on the disk tier (it owns the retry
    # ladder); these views keep the serving layer's accounting stable
    @property
    def retries(self) -> int:
        """Retried disk-read attempts, lifetime (see ``DiskTier``)."""
        return self.disk.retries

    @property
    def fetch_failures(self) -> int:
        """Group runs given up on after the retry budget, lifetime."""
        return self.disk.fetch_failures

    def _demote(self, batch_idx: int, gid: int, kv: np.ndarray) -> None:
        """Reuse-buffer eviction → warm-tier admission.  With an int8 disk
        tier the group's on-disk scale makes the quantized copy exact (the
        kv_bits=8 bit-identity contract); ``disk_nbytes`` keeps warm-served
        accounting in disk-read units."""
        self.warm.admit(self.layer, batch_idx, gid, kv,
                        scale=self.store.scale_of(self.layer, batch_idx, gid),
                        disk_nbytes=self.store.group_nbytes)

    def read_run_with_retry(self, batch_idx: int,
                            run: ReadRun) -> tuple[np.ndarray, np.ndarray]:
        """One coalesced run with bounded retry-with-backoff — delegated to
        the :class:`~repro.tiers.disk.DiskTier` (which owns the retry
        ladder and its counters).  Kept on the manager because the engine's
        publish path reads chains through it."""
        return self.disk.read_run_with_retry(batch_idx, run)

    def fetch(self, group_ids: np.ndarray, group_mask: np.ndarray) -> MappingTable:
        """Resolve selected groups: reuse hits stay put, each row's misses go
        down the tier chain before the next row's are looked at.

        Miss resolution order is the memory hierarchy: reuse buffer → warm
        tier (when attached) → disk.  The warm tier serves what it holds,
        group by group (``KVTier.serve_run``); the disk tier takes the
        residue in ascending order, whose runs the store vets first where a
        read can fault (:meth:`DiskTier.vet`), and is authoritative.  Every
        served group is placed by ``ReuseBuffer.place`` in the order it was
        served: a slot each, or staged where the step's working set pins
        the buffer full.  Then the disk's runs of every row are charged in
        one call and their groups read with one gather, straight into an
        upload slab with the indices that place them on the device
        (``table.upload``, delivered by :meth:`sync_device`), or into one
        host buffer.

        A run that stays unreadable raises :class:`FetchFailed` once the
        groups already placed are written: the earlier rows', and this
        row's from the warm tier.

        ``group_ids, group_mask``: ``[B, M]``.
        """
        group_mask = np.asarray(group_mask, bool)
        warm_loads: list = []   # (row, ids, their slots or -1, the warm tier's kv each)
        disk_loads: list = []   # (row, ids ascending, their slots or -1, None)
        try:
            for bi in range(group_ids.shape[0]):
                # de-dup, preserving order (top-k can repeat id 0 on masked rows)
                want = list(dict.fromkeys(group_ids[bi][group_mask[bi]].tolist()))
                want_set = set(want)
                _, misses = self.reuse.lookup(bi, want)
                if misses and self.warm is not None:
                    served, misses = self.warm.serve_run(self.layer, bi, misses, self.store.dtype)
                    if served:
                        gids = np.array([gid for gid, _ in served], np.int64)
                        warm_loads.append((bi, gids, self.reuse.place(bi, gids, want_set),
                                           [kv for _, kv in served]))
                if misses:
                    gids = np.sort(np.array(misses, np.int64))
                    self.disk.vet(bi, gids)
                    disk_loads.append((bi, gids, self.reuse.place(bi, gids, want_set), None))
        except FetchFailed:
            self._load(warm_loads + disk_loads, None)
            raise
        # residency is settled: each selected group's slot, -2 if staged
        held = group_ids[:, :, None] == self.reuse.slot_table[:, None, :]
        slots = np.where(group_mask, np.where(held.any(axis=2), held.argmax(axis=2), -2), -1)
        table = MappingTable(group_ids=np.where(group_mask, group_ids, -1), slots=slots,
                             group_mask=group_mask, rolling_fill=self.rolling.fills.copy())
        self._load(warm_loads + disk_loads, table)
        return table

    def _load(self, loads: list, table: MappingTable | None) -> None:
        """Charge the disk's runs of ``loads`` and write their groups: the
        reuse buffer's by one indexed assignment, the staged ones into
        ``table.staged`` as views of the bytes read, keyed in the order they
        were served.  ``loads``: the warm tier's, then the disk's, rows
        ascending in each.  ``table`` None (a failed fetch): the reuse
        buffer's alone.

        The destinations are the reuse buffer's groups, the warm tier's
        first, then the staged groups (on the device path, one a staged
        position of the table), the disk's first: one gather from the store
        fills the disk's block between the warm tier's groups."""
        warm = {(bi, gid): kv for bi, g, _, kvs in loads if kvs is not None
                for gid, kv in zip(g.tolist(), kvs)}
        rows = np.repeat(np.array([bi for bi, _, _, _ in loads], np.int64),
                         [g.size for _, g, _, _ in loads])
        gids = np.concatenate([g for _, g, _, _ in loads] + [_EMPTY])
        placed = np.concatenate([at for _, _, at, _ in loads] + [_EMPTY])
        self.disk.charge_rows(rows[len(warm):], gids[len(warm):])
        kept = placed >= 0
        m_rows, m_slots = rows[kept], placed[kept]
        n_m, lo = m_rows.size, int(np.count_nonzero(kept[:len(warm)])) if warm else 0
        staged = np.flatnonzero(~kept)
        if warm:   # keyed in the order served: row by row, the warm tier's first
            staged = staged[np.argsort(rows[staged], kind="stable")]
        keys = list(zip(rows[staged].tolist(), gids[staged].tolist()))
        s_rows = s_gids = tok_rows = toks = _EMPTY
        if table is not None and self.slabs is None:
            s_rows, s_gids = rows[staged], gids[staged]
        elif table is not None:
            s_rows, s_pos, tok_rows, toks = staged_tokens(table.slots, self.reuse.group_size)
            s_gids = table.group_ids[s_rows, s_pos]
        n_ws = 0
        if warm and s_rows.size:   # the warm tier's staged groups last
            s_warm = np.array([key in warm for key in zip(s_rows.tolist(), s_gids.tolist())])
            order = np.argsort(s_warm, kind="stable")
            s_rows, s_gids, n_ws = s_rows[order], s_gids[order], int(np.count_nonzero(s_warm))
            if tok_rows.size:
                g = self.reuse.group_size
                tok_rows, toks = (t.reshape(-1, g)[order].reshape(-1) for t in (tok_rows, toks))
        to_rows, to_gids = np.concatenate((m_rows, s_rows)), np.concatenate((gids[kept], s_gids))
        hi = to_rows.size - n_ws

        def write(out: np.ndarray) -> None:
            if hi > lo:
                self.store.gather_groups(self.layer, to_rows[lo:hi], to_gids[lo:hi], out[lo:hi])
            for i in [*range(lo), *range(hi, to_rows.size)]:
                out[i] = warm[(int(to_rows[i]), int(to_gids[i]))]
            self.reuse.slots[m_rows, m_slots] = out[:n_m]
            if table is not None:
                # a group staged at two positions takes the view of either (the same bytes)
                table.staged = dict.fromkeys(keys)
                table.staged.update(zip(zip(s_rows.tolist(), s_gids.tolist()), out[n_m:]))

        if table is None or self.slabs is None:
            write(np.empty((to_rows.size,) + self.reuse.slots.shape[2:], self.reuse.slots.dtype))
        else:
            table.upload = self.slabs.fill(write, n_m, s_rows.size, m_rows, m_slots,
                                           table.slots, table.rolling_fill, tok_rows, toks)

    def gather(self, table: MappingTable) -> tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
        """Materialize the logical KV view.

        Returns ``(k, v, token_mask, positions)`` with
        ``k, v: [B, M*G + G, H_kv, d]`` (one array as both for latent
        records), ``token_mask: [B, M*G + G]``,
        ``positions: [B, M*G + G]`` absolute token positions (for kernels
        that need them; RoPE is already baked into cached K).

        The tail region is always ``G`` wide — one full rolling buffer — with
        per-row validity masks (``table.rolling_fill``), so the context shape
        is fixed regardless of each row's fill level; rows at different fill
        levels (continuous batching) share one tensor.  Attention weights on
        masked columns underflow to exactly zero, so the extra columns never
        change a row's output.
        """
        b, m = table.slots.shape
        g = self.reuse.group_size
        fill = table.rolling_fill
        hkv, d = self.rolling.k.shape[2], self.rolling.k.shape[3]
        n_tok = m * g + g
        k = np.zeros((b, n_tok, hkv, d), dtype=self.rolling.k.dtype)
        v = k if self.rolling.planes == 1 else np.zeros_like(k)   # one plane: once
        mask = np.zeros((b, n_tok), dtype=bool)
        pos = np.zeros((b, n_tok), dtype=np.int64)
        for bi in range(b):
            for mi in range(m):
                if not table.group_mask[bi, mi]:
                    continue
                if table.slots[bi, mi] == -2:   # staged (reuse buffer pinned full)
                    kv = table.staged[(bi, int(table.group_ids[bi, mi]))]
                else:
                    kv = self.reuse.slots[bi, table.slots[bi, mi]]  # [G, P, Hkv, d]
                sl = slice(mi * g, (mi + 1) * g)
                k[bi, sl] = kv[:, 0]
                v[bi, sl] = kv[:, -1]
                mask[bi, sl] = True
                gid = table.group_ids[bi, mi]
                pos[bi, sl] = np.arange(gid * g, (gid + 1) * g)
        k[:, m * g :] = self.rolling.k
        v[:, m * g :] = self.rolling.v
        mask[:, m * g :] = np.arange(g)[None, :] < fill[:, None]
        base = self.store.n_groups[self.layer][:, None] * g
        pos[:, m * g :] = base + np.arange(g)[None, :]
        return k, v, mask, pos

    def sync_device(self, table: MappingTable) -> tuple[DeviceUpload, int]:
        """Deliver a device-resident fetch's slab to the device: one copy,
        the reuse mirror written in place by ``index_put_``.

        The delta-upload contract: a step whose working set fully hits the
        reuse buffer moves **zero** group bytes (the copy carries only the
        table's addressing).  Runs on the engine's main thread, which owns
        the device work; the fetch itself stays host-only.  Returns the
        delivered views (slot addressing, fills, staged groups) and the
        bytes charged to the step's host-to-device count: the mirror's
        groups and each staged group once.
        """
        mirror = self.reuse.device
        if mirror is None or table.upload is None:
            raise RuntimeError("no device mirror or upload slab (host-gather mode?)")
        b, m = table.slots.shape
        up = self.slabs.deliver(table.upload, mirror, b, m)
        return up, (table.upload.n_mirror + len(table.staged)) * self.slabs.group_nbytes

    def spill_group_row(self, batch_idx: int, k_group: np.ndarray,
                        v_group: np.ndarray) -> None:
        """Write one row's completed group to disk (device-resident flush).

        Counterpart of :meth:`append_token_rows` for the device path: the
        rolling tokens lived on device, were counted by
        ``RollingBuffer.advance_rows()``, and are downloaded once per ``G``
        steps as this ``[G, H_kv, d]`` pair.  Rows flush independently —
        continuous batching admits them at different offsets.
        """
        self.store.append_group_row(self.layer, batch_idx, k_group, v_group)

    def append_token_rows(self, k_new: np.ndarray, v_new: np.ndarray,
                          active: np.ndarray) -> list[tuple[int, np.ndarray, np.ndarray]]:
        """Route one new token's KV for every active row: rolling buffer,
        flushing each row's full group to disk as it completes.  Returns the
        completed ``(row, k_group, v_group)`` triples for K_lr append."""
        completed = self.rolling.append_rows(k_new, v_new, active)
        for bi, k_g, v_g in completed:
            self.store.append_group_row(self.layer, bi, k_g, v_g)
        return completed

    def free_row(self, batch_idx: int) -> None:
        """Retire one row in this layer's memory regions (reuse slots and
        rolling tail); the shared store's watermark is reset once by the
        engine via :meth:`KVDiskStore.free_row`."""
        self.reuse.clear_row(batch_idx)
        self.rolling.clear_row(batch_idx)
