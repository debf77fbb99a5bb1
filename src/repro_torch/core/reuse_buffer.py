"""Reuse buffer: software cache of recently accessed KV groups (KVSwap §3.4.3).

Adjacent decode steps share 75-81 % of their critical groups (paper Fig. 8 /
Tab. 5), so retaining loaded groups in fixed memory slots avoids most disk
re-reads.  Implementation matches the paper: a fixed set of slots each holding
one group, a slot table mapping slot → group id, FIFO replacement.

Slots are keyed per (layer, batch row); capacity ``C`` counts groups.  The
host :class:`ReuseBuffer` is the reference's, copied; the device mirror is
the port's own (:class:`DeviceReuseMirror`).
"""

from __future__ import annotations

import collections
import dataclasses

import numpy as np
import torch


@dataclasses.dataclass
class ReuseStats:
    hits: int = 0
    misses: int = 0

    @property
    def ratio(self) -> float:
        tot = self.hits + self.misses
        return self.hits / tot if tot else 0.0


class DeviceReuseMirror:
    """Device-side mirror of a :class:`ReuseBuffer`'s slot storage.

    Holds ``k/v: [B, C, G, H_kv, d]`` tensors on the run's device, addressed
    by the *same* slot indices the host slot table assigns, so a
    :class:`~repro_torch.core.manager.MappingTable`'s ``slots`` array is
    directly a gather index into device memory.  Only newly fetched groups
    cross the host→device boundary, inside the fetch's upload slab
    (:mod:`repro_torch.core.upload`), written in place by one ``index_put_``
    into each of ``k`` and ``v``; reuse hits move zero bytes.  Must be
    called from the thread that owns the device work (the engine's main
    thread), never from a prefetch worker.

    ``uploaded_bytes`` counts the payload bytes shipped host→device.  The
    reference padded each scatter to a power-of-two row count (and
    pre-compiled those shapes) only to spare XLA recompiles; PyTorch runs
    eagerly, so there is no padding and ``padded_bytes == uploaded_bytes``.
    """

    def __init__(self, slots: np.ndarray, slot_table: np.ndarray | None, device):
        # slots: host [B, C, G, P, H_kv, d] → split K/V device mirrors (one
        # mirror, as both, for a single plane of latent records).  At
        # attach time the reuse buffer is normally empty (first decode step
        # after prefill): allocate zeros on device instead of uploading them.
        self.device = torch.device(device)
        shape = slots.shape[:3] + slots.shape[4:]
        self.planes = planes = slots.shape[3]
        if slot_table is not None and (slot_table == -1).all():
            dtype = torch.from_numpy(slots[:0]).dtype
            self.k = torch.zeros(shape, dtype=dtype, device=self.device)
            self.v = self.k if planes == 1 else torch.zeros(shape, dtype=dtype, device=self.device)
        else:
            self.k = torch.from_numpy(np.ascontiguousarray(slots[:, :, :, 0])).to(self.device)
            self.v = self.k if planes == 1 else torch.from_numpy(
                np.ascontiguousarray(slots[:, :, :, 1])).to(self.device)
        self.capacity = slots.shape[1]
        self.uploaded_bytes = 0
        self.uploaded_groups = 0
        self.scatter_calls = 0

    @property
    def padded_bytes(self) -> int:
        return self.uploaded_bytes

    @property
    def nbytes(self) -> int:
        return self.k.numel() * self.k.element_size() * self.planes

    def scatter(self, rows: torch.Tensor, slots: torch.Tensor, kv: torch.Tensor) -> int:
        """Write ``kv [n, G, P, H_kv, d]`` (on the device) into slots
        ``(rows, slots)``, ``n`` distinct pairs.  Returns the payload bytes
        uploaded."""
        self.k.index_put_((rows, slots), kv[:, :, 0])
        if self.planes == 2:
            self.v.index_put_((rows, slots), kv[:, :, 1])
        nbytes = kv.numel() * kv.element_size()
        self.uploaded_bytes += nbytes
        self.uploaded_groups += kv.shape[0]
        self.scatter_calls += 1
        return nbytes


class ReuseBuffer:
    """FIFO cache of KV groups for one layer of one batched sequence set."""

    def __init__(self, *, batch: int, capacity: int, group_size: int, n_kv_heads: int,
                 head_dim: int, dtype=np.float32, planes: int = 2):
        self.batch = batch
        self.capacity = capacity
        self.group_size = group_size
        # slot storage: [B, C, G, P, H_kv, d] (P: K and V, or one latent record)
        self.slots = np.zeros((batch, capacity, group_size, planes, n_kv_heads, head_dim),
                              dtype=dtype)
        # slot_table[b][slot] = group id or -1
        self.slot_table = np.full((batch, capacity), -1, dtype=np.int64)
        self._fifo: list[collections.deque] = [collections.deque() for _ in range(batch)]
        self._index: list[dict[int, int]] = [dict() for _ in range(batch)]  # gid -> slot
        self._free: list[list[int]] = [list(range(capacity - 1, -1, -1)) for _ in range(batch)]
        self.stats = ReuseStats()
        # device-side mirror (attached by the engine's device-resident path)
        self.device: DeviceReuseMirror | None = None
        # eviction hook (batch_idx, group_id, kv_view) → None, called with
        # the victim's slot contents *before* they are overwritten; the warm
        # tier (repro.tiers) registers here to admit evicted groups.  Not
        # called for clear_row/invalidate — those drop state, they don't
        # demote it.
        self.victim_sink = None

    def attach_device_mirror(self, device) -> DeviceReuseMirror:
        """(Re)build the device mirror on ``device`` from the current host
        slot contents.

        Called once per request at the first decode step; thereafter the
        mirror is kept coherent by delta scatters of fetch misses only
        (:meth:`KVCacheManager.sync_device`)."""
        self.device = DeviceReuseMirror(self.slots, self.slot_table, device)
        return self.device

    @property
    def nbytes(self) -> int:
        return self.slots.nbytes + self.slot_table.nbytes

    def lookup(self, batch_idx: int, group_ids) -> tuple[list[int], list[int]]:
        """Split requested ids into (hit ids, miss ids); updates hit stats."""
        idx = self._index[batch_idx]
        hits = [g for g in group_ids if g in idx]
        misses = [g for g in group_ids if g not in idx]
        self.stats.hits += len(hits)
        self.stats.misses += len(misses)
        return hits, misses

    def get(self, batch_idx: int, group_id: int) -> np.ndarray:
        """Return the slot contents ``[G, 2, H_kv, d]`` for a resident group."""
        slot = self._index[batch_idx][group_id]
        return self.slots[batch_idx, slot]

    def insert(self, batch_idx: int, group_id: int, kv_group: np.ndarray,
               protected: set | None = None) -> int | None:
        """Insert a loaded group (``[G, 2, H_kv, d]``); FIFO-evicts if full.

        ``protected`` pins the current step's working set: those resident
        groups are never chosen as eviction victims (the preload buffer is
        merged into the reuse buffer — paper App. A.2).  Returns the slot
        index, or ``None`` if insertion would require evicting a protected
        group (caller stages the group transiently instead).
        """
        idx = self._index[batch_idx]
        fifo = self._fifo[batch_idx]
        if group_id in idx:  # refresh in place (idempotent insert)
            slot = idx[group_id]
            self.slots[batch_idx, slot] = kv_group
            return slot
        free = self._free[batch_idx]
        if free:
            slot = free.pop()
        else:
            victim = None
            if protected:
                for cand in fifo:
                    if cand not in protected:
                        victim = cand
                        break
                if victim is None:
                    return None
                fifo.remove(victim)
            else:
                victim = fifo.popleft()
            slot = idx.pop(victim)
            self.slot_table[batch_idx, slot] = -1
            if self.victim_sink is not None:
                # demote to the warm tier while the slot bytes are intact
                self.victim_sink(batch_idx, victim, self.slots[batch_idx, slot])
        idx[group_id] = slot
        fifo.append(group_id)
        self.slot_table[batch_idx, slot] = group_id
        self.slots[batch_idx, slot] = kv_group
        return slot

    def clear_row(self, batch_idx: int) -> None:
        """Retire a batch row: drop every resident group so the next tenant
        of the slot starts cold (its first fetch misses on everything and
        reads only its own groups — the slot-recycling contract).

        Slot *data* is left in place: with the row's slot table empty no
        mapping table can reference it, and the device mirror (if attached)
        is likewise unreachable until fresh inserts scatter over it.
        """
        self._index[batch_idx].clear()
        self._fifo[batch_idx].clear()
        self._free[batch_idx] = list(range(self.capacity - 1, -1, -1))
        self.slot_table[batch_idx, :] = -1

    def invalidate(self, batch_idx: int, group_id: int) -> None:
        """Drop a group (e.g. its on-disk contents were superseded)."""
        idx = self._index[batch_idx]
        if group_id in idx:
            slot = idx.pop(group_id)
            self.slot_table[batch_idx, slot] = -1
            self._fifo[batch_idx].remove(group_id)
            self._free[batch_idx].append(slot)

    def resident(self, batch_idx: int) -> set[int]:
        return set(self._index[batch_idx].keys())
