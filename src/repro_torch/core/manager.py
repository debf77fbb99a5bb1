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
        # the ordered miss-resolution chain (repro.tiers.KVTier): fetch
        # walks it top to bottom, handing each tier's residue to the next.
        # The disk tier is always last and always authoritative.
        self.chain = ([warm] if warm is not None else []) + [self.disk]
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
        """Resolve selected groups: reuse hits stay put, everything else
        walks the **ordered tier chain** (``self.chain``).

        Miss resolution order is the memory hierarchy: reuse buffer →
        warm tier (when attached) → disk.  Each tier serves what it holds
        (``KVTier.serve_run``) and hands the residue to the next; the disk
        tier plans its residue into sorted, coalesced sequential runs
        before touching the store (§3.4.4) and is authoritative, so the
        chain never ends with unresolved groups.  Every group a tier
        serves is promoted into the reuse buffer exactly like a disk load
        — including the staged-overflow path.  With upload slabs attached
        (the device-resident engine), each served group is also copied once
        into a slab with the indices that place it on the device
        (``table.upload``, delivered by :meth:`sync_device`).

        Where the chain is the disk tier alone over a plain store, the
        misses take the batched path (:meth:`_load_batched`): the same
        charges, placements and bytes, from one gather of the layer's
        groups instead of a read, a charge and an insert a group.

        ``group_ids, group_mask``: ``[B, M]``.
        """
        group_mask = np.asarray(group_mask, bool)
        ids_out = np.where(group_mask, group_ids, -1)
        batched = self._batched()
        staged: dict = {}
        mirror: list = []   # (bi, slot, kv) the reuse buffer took
        loads: list = []    # batched: (bi, missed ids ascending, their slots or -1)
        for bi in range(group_ids.shape[0]):
            # de-dup, preserving order (top-k can repeat id 0 on masked rows)
            want = list(dict.fromkeys(group_ids[bi][group_mask[bi]].tolist()))
            want_set = set(want)
            _, misses = self.reuse.lookup(bi, want)
            if batched:
                if misses:
                    gids = np.sort(np.array(misses, np.int64))
                    loads.append((bi, gids, self.reuse.place(bi, gids, want_set)))
            else:
                self._walk_chain(bi, misses, want_set, staged, mirror)
        # residency is settled: each selected group's slot, -2 if staged
        held = group_ids[:, :, None] == self.reuse.slot_table[:, None, :]
        slots = np.where(group_mask, np.where(held.any(axis=2), held.argmax(axis=2), -2), -1)
        table = MappingTable(
            group_ids=ids_out, slots=slots, group_mask=group_mask,
            rolling_fill=self.rolling.fills.copy(), staged=staged,
        )
        if batched:
            self._load_batched(table, loads)
        elif self.slabs is not None:
            rows, pos, tok_rows, toks = staged_tokens(slots, self.reuse.group_size)
            table.upload = self.slabs.fill(
                mirror, [staged[(r, g)] for r, g in zip(rows.tolist(), ids_out[rows, pos].tolist())],
                slots, table.rolling_fill, tok_rows, toks)
        return table

    def _batched(self) -> bool:
        """Whether this fetch's misses may be read in one gather: the chain
        is the disk tier alone (a warm tier serves group by group in its LRU
        order), over a plain :class:`KVDiskStore` whose reads nothing
        watches.  A ``FaultyDisk`` forwards the store's attributes, so it is
        told apart by type; each of its runs must stay separately faultable.
        A read replaced on the store or the tier keeps the walk too."""
        return (len(self.chain) == 1 and type(self.store) is KVDiskStore
                and "read_run" not in vars(self.store) and "serve_run" not in vars(self.disk))

    def _walk_chain(self, bi: int, misses: list, want_set: set, staged: dict,
                    mirror: list) -> None:
        """One row's misses through the tier chain, group by group."""
        for tier in self.chain:
            if not misses:
                break
            served, misses = tier.serve_run(self.layer, bi, misses, self.store.dtype)
            for gid, kv in served:
                # current working set is pinned; overflow stays staged
                slot = self.reuse.insert(bi, gid, kv, protected=want_set)
                if slot is None:
                    staged[(bi, gid)] = kv
                else:
                    mirror.append((bi, slot, kv))
        if misses:
            raise FetchFailed(
                f"layer {self.layer} row {bi} groups {misses} not "
                f"resolved by any tier in the chain "
                f"({[t.name for t in self.chain]})",
                layer=self.layer, row=bi, start=int(misses[0]),
                count=len(misses))

    def _load_batched(self, table: MappingTable, loads: list) -> None:
        """Read every row's misses, already placed by ``ReuseBuffer.place``,
        with one gather from the store: into the slab's payload (the mirror's
        groups, then each staged position's) or, on the host-gather path,
        into one buffer.  The reuse slots take their groups by one indexed
        assignment; ``table.staged`` holds views of the gathered bytes, keyed
        as the walk keys them (row, then ascending id)."""
        if loads:
            rows = np.concatenate([np.full(gids.size, bi) for bi, gids, _ in loads])
            gids = np.concatenate([gids for _, gids, _ in loads])
            placed = np.concatenate([at for _, _, at in loads])
            self.disk.charge_rows(rows, gids)
        else:
            rows = gids = placed = np.zeros(0, np.int64)
        kept = placed >= 0
        m_rows, m_slots = rows[kept], placed[kept]
        s_keys = list(zip(rows[~kept].tolist(), gids[~kept].tolist()))
        n_m = m_rows.size
        if self.slabs is None:
            out = np.empty((gids.size,) + self.reuse.slots.shape[2:], self.reuse.slots.dtype)
            order = np.concatenate((np.flatnonzero(kept), np.flatnonzero(~kept)))
            self.store.gather_groups(self.layer, rows[order], gids[order], out)
            self.reuse.slots[m_rows, m_slots] = out[:n_m]
            table.staged = dict(zip(s_keys, out[n_m:]))
            return
        s_rows, s_pos, tok_rows, toks = staged_tokens(table.slots, self.reuse.group_size)
        s_gids = table.group_ids[s_rows, s_pos]

        def write(out: np.ndarray) -> None:
            self.store.gather_groups(self.layer, np.concatenate((m_rows, s_rows)),
                                     np.concatenate((gids[kept], s_gids)), out)
            self.reuse.slots[m_rows, m_slots] = out[:n_m]
            # keyed in the walk's order; a group staged at two positions
            # takes the view of either (the same bytes)
            table.staged = dict.fromkeys(s_keys)
            table.staged.update(zip(zip(s_rows.tolist(), s_gids.tolist()), out[n_m:]))

        table.upload = self.slabs.fill_with(write, n_m, s_rows.size, m_rows, m_slots,
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
