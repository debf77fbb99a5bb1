"""Slab-backed block store for the persistent prefix cache.

One memmap file holds every cached block's KV groups with the same
group-contiguous layout as :class:`repro.core.offload.KVDiskStore`::

    [n_layers, capacity_groups, G, 2, H_kv, d]        (axis 3 = K|V)

Blocks are allocated *extents* — ``n_groups`` consecutive group slots — from
a first-fit free list.  Chains published together land in adjacent extents,
so restoring a chain is a handful of long sequential reads: the group ids of
all matched extents are handed to a :class:`~repro.io.scheduler.ReadScheduler`,
which coalesces adjacent (and, with ``max_gap > 0``, near-adjacent) extents
into runs, and each run is one charged request on the
:class:`~repro.core.offload.IOAccountant` — exactly the read-amplification
discipline of §3.4.4, applied across requests instead of within one.
"""

from __future__ import annotations

import os
import tempfile
import zlib

import numpy as np

from repro_torch.core.offload import IOAccountant, dequant_groups, quant_groups
from repro_torch.io.scheduler import ReadScheduler

_ADJACENT = ReadScheduler(max_gap=0)


class PrefixBlockStore:
    """Extent-allocated slab of KV groups shared by all cached blocks.

    ``quant_bits=8`` stores per-group-scaled int8 on disk (§7 "low-bit KV",
    same format as ``KVDiskStore``): restores shrink ~``itemsize``× at the
    cost of a small requantization error on warm prefill.  Scales live in
    RAM (4 B per layer per group) and persist beside the slab.
    """

    def __init__(
        self,
        *,
        n_layers: int,
        capacity_groups: int,
        group_size: int,
        n_kv_heads: int,
        head_dim: int,
        dtype=np.float32,
        path: str | None = None,
        accountant: IOAccountant | None = None,
        quant_bits: int = 0,
    ):
        if capacity_groups <= 0:
            raise ValueError(f"capacity_groups must be positive, got {capacity_groups}")
        if quant_bits not in (0, 8):
            raise ValueError("quant_bits must be 0 (raw) or 8 (int8)")
        self.n_layers = n_layers
        self.capacity_groups = capacity_groups
        self.group_size = group_size
        self.n_kv_heads = n_kv_heads
        self.head_dim = head_dim
        self.dtype = np.dtype(dtype)
        self.accountant = accountant
        self.quant_bits = quant_bits
        self._store_dtype = np.dtype(np.int8) if quant_bits == 8 else self.dtype
        shape = (n_layers, capacity_groups, group_size, 2, n_kv_heads, head_dim)
        if path is None:
            fd, path = tempfile.mkstemp(prefix="kvswap_prefix_", suffix=".bin")
            os.close(fd)
            self._owns_file = True
            mode = "w+"
        else:
            self._owns_file = False
            mode = "r+" if os.path.exists(path) and os.path.getsize(path) else "w+"
        self.path = path
        self._mm = np.memmap(path, dtype=self._store_dtype, mode=mode, shape=shape)
        self._scales = None
        if quant_bits == 8:
            self._scales = np.zeros((n_layers, capacity_groups), np.float32)
            if not self._owns_file and os.path.exists(self._scales_path()):
                self._scales = np.load(self._scales_path())
        # free extents as sorted, disjoint, non-adjacent [start, stop) pairs
        self._free: list[tuple[int, int]] = [(0, capacity_groups)]

    def _scales_path(self) -> str:
        return self.path + ".scales.npy"

    # -- geometry ---------------------------------------------------------
    @property
    def group_nbytes(self) -> int:
        """Bytes of one group in one layer (same formula as KVDiskStore)."""
        return (self.group_size * 2 * self.n_kv_heads * self.head_dim
                * self._store_dtype.itemsize)

    def free_groups(self) -> int:
        return sum(b - a for a, b in self._free)

    def largest_free_extent(self) -> int:
        return max((b - a for a, b in self._free), default=0)

    # -- extent allocator -------------------------------------------------
    def alloc(self, n_groups: int) -> int | None:
        """First-fit allocation; returns the start group or ``None`` if no
        single free extent is large enough (caller evicts and retries)."""
        if n_groups <= 0:
            raise ValueError(f"n_groups must be positive, got {n_groups}")
        for i, (a, b) in enumerate(self._free):
            if b - a >= n_groups:
                if b - a == n_groups:
                    self._free.pop(i)
                else:
                    self._free[i] = (a + n_groups, b)
                return a
        return None

    def free(self, start: int, n_groups: int) -> None:
        """Return an extent to the free list, merging adjacent holes."""
        stop = start + n_groups
        if start < 0 or stop > self.capacity_groups:
            raise IndexError(f"extent [{start}, {stop}) outside slab")
        # reject a double free BEFORE touching the list — a raise after the
        # append would leave overlapping free extents behind, and alloc
        # could then hand the same groups to two blocks
        for a, b in self._free:
            if start < b and a < stop:
                raise RuntimeError(f"double free of extent [{start}, {stop})")
        self._free.append((start, stop))
        self._free.sort()
        merged: list[tuple[int, int]] = []
        for a, b in self._free:
            if merged and a == merged[-1][1]:
                merged[-1] = (merged[-1][0], b)
            else:
                merged.append((a, b))
        self._free = merged

    def mark_allocated(self, start: int, n_groups: int) -> None:
        """Carve a specific extent out of the free list (manifest reload)."""
        stop = start + n_groups
        for i, (a, b) in enumerate(self._free):
            if a <= start and stop <= b:
                self._free.pop(i)
                if a < start:
                    self._free.insert(i, (a, start))
                if stop < b:
                    self._free.insert(i + (1 if a < start else 0), (stop, b))
                return
        raise RuntimeError(f"extent [{start}, {stop}) is not free")

    # -- writes -----------------------------------------------------------
    def write_block(self, start: int, k: np.ndarray, v: np.ndarray) -> int:
        """Store one block's KV at extent ``start``.

        ``k, v``: ``[n_layers, n_groups, G, H_kv, d]``.  Charged as one
        sequential write per layer (a block's groups are contiguous).
        Returns the CRC32 of the extent's at-rest bytes — the checksum
        recorded on the block's manifest entry and re-verified by
        :meth:`checksum_extent` before any restore serves from it.
        """
        nl, ng = k.shape[0], k.shape[1]
        if nl != self.n_layers:
            raise ValueError(f"layer mismatch {nl} != {self.n_layers}")
        if start < 0 or start + ng > self.capacity_groups:
            raise IndexError(f"extent [{start}, {start + ng}) outside slab")
        block = np.stack([k, v], axis=3)  # [L, ng, G, 2, Hkv, d]
        if self.quant_bits == 8:
            qblk, scale = quant_groups(block)
            self._mm[:, start:start + ng] = qblk
            self._scales[:, start:start + ng] = scale
            crc = zlib.crc32(np.ascontiguousarray(qblk).tobytes())
            crc = zlib.crc32(
                np.ascontiguousarray(scale.astype(np.float32)).tobytes(), crc)
        else:
            data = np.ascontiguousarray(block.astype(self.dtype))
            self._mm[:, start:start + ng] = data
            crc = zlib.crc32(data.tobytes())
        if self.accountant is not None:
            self.accountant.charge_write(nl * ng * self.group_nbytes, nl)
        return crc

    def checksum_extent(self, start: int, n_groups: int) -> int:
        """CRC32 of an extent as it sits in the slab (plus the int8 scales
        that dequantize it) — byte-order-identical to what
        :meth:`write_block` hashed, so any at-rest flip changes the value.
        Not charged to the accountant: real stacks checksum the buffer a
        read just delivered; modeling it as extra disk traffic would
        double-bill every verified restore."""
        crc = zlib.crc32(
            np.ascontiguousarray(self._mm[:, start:start + n_groups]).tobytes())
        if self._scales is not None:
            crc = zlib.crc32(
                np.ascontiguousarray(
                    self._scales[:, start:start + n_groups]).tobytes(), crc)
        return crc

    # -- reads ------------------------------------------------------------
    def read_extents(
        self,
        layer: int,
        extents: list[tuple[int, int]],
        scheduler: ReadScheduler | None = None,
    ) -> tuple[np.ndarray, np.ndarray]:
        """Read the groups of ``extents`` (list of ``(start, n_groups)``) for
        one layer, in extent order.

        All requested group ids go through the scheduler's run planning, so
        adjacent extents (the common case for chains published together)
        merge into single sequential reads; each run is charged as **one**
        request, gap groups included.

        Returns ``(k, v)`` each ``[total_groups, G, H_kv, d]`` ordered as the
        extents were given.
        """
        order: list[int] = []
        for s, n in extents:
            order.extend(range(s, s + n))
        if not order:
            empty = np.empty((0, self.group_size, self.n_kv_heads, self.head_dim),
                             self.dtype)
            return empty, empty.copy()
        got: dict[int, np.ndarray] = {}
        for run in (scheduler or _ADJACENT).plan(order):
            if run.stop > self.capacity_groups:
                raise IndexError(f"run [{run.start}, {run.stop}) outside slab")
            blk = np.asarray(self._mm[layer, run.start:run.stop])
            if self.quant_bits == 8:
                blk = dequant_groups(
                    blk, self._scales[layer, run.start:run.stop], self.dtype)
            if self.accountant is not None:
                self.accountant.charge_read(run.count * self.group_nbytes, 1)
            for gid in run.ids:
                got[gid] = blk[gid - run.start]
        stacked = np.stack([got[g] for g in order])  # [N, G, 2, Hkv, d]
        return stacked[:, :, 0], stacked[:, :, 1]

    # -- lifecycle --------------------------------------------------------
    def flush(self) -> None:
        self._mm.flush()
        if self._scales is not None and not self._owns_file:
            # atomic like Manifest.save: a crash mid-write must not leave a
            # manifest pointing at truncated scales
            tmp = self._scales_path() + ".tmp.npy"
            np.save(tmp, self._scales)
            os.replace(tmp, self._scales_path())

    def close(self) -> None:
        mm, self._mm = self._mm, None
        if mm is not None:
            del mm
        if self._owns_file and os.path.exists(self.path):
            os.unlink(self.path)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
