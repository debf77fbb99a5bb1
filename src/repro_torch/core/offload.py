"""Disk tier for the KV cache (KVSwap §2.3, §3.4).

Two pieces:

* :class:`DiskSpec` — an analytic timing model of a block-granular storage
  device (NVMe / eMMC / UFS).  The container's physical disk is neither a
  Jetson NVMe nor an eMMC part, so throughput numbers in the benchmarks are
  *modeled* from this spec, calibrated against the paper's Fig. 2 bandwidth
  curve (effective BW < 6 % of peak at 512 B requests, approaching peak for
  >= 256 KiB requests).  Correctness always uses the real store below.

* :class:`KVDiskStore` — a real, file-backed store for the full KV cache.
  Layout is **group-contiguous**: one KV group (G consecutive tokens, K and V,
  all KV heads) is one contiguous byte range, so loading a group is a single
  sequential read — exactly the read-amplification-aware access pattern the
  paper orchestrates (§3.3).
"""

from __future__ import annotations

import contextlib
import dataclasses
import math
import os
import tempfile
import threading

import numpy as np

from repro_torch.io.scheduler import ReadScheduler
from repro_torch.obs.metrics import fold


@dataclasses.dataclass(frozen=True)
class DiskSpec:
    """Analytic model of a block-granular storage device.

    Time for one request of ``n`` bytes::

        t = request_latency + ceil(n / page_bytes) * page_bytes / peak_bw

    ``page_bytes`` models read amplification: the controller always reads
    whole NAND pages (§2.3, [27, 45]).  ``request_latency`` is the effective
    per-request overhead at the benchmark queue depth.
    """

    name: str
    peak_bw: float          # bytes / second
    page_bytes: int         # NAND page / min transfer unit
    request_latency: float  # seconds per request (effective, at QD)

    def read_time(self, n_bytes: int, n_requests: int = 1) -> float:
        """Modeled wall time to service ``n_requests`` totaling ``n_bytes``."""
        if n_bytes <= 0:
            return 0.0
        # Effective bandwidth is a function of the *per-request* size (Fig. 2):
        # each request pays the fixed latency and is rounded up to whole NAND
        # pages, so small requests spend most of their time on overhead and
        # amplification while >= 256 KiB requests approach peak_bw.
        per_req = n_bytes / max(n_requests, 1)
        pages = n_requests * math.ceil(per_req / self.page_bytes)
        return n_requests * self.request_latency + pages * self.page_bytes / self.peak_bw

    def write_time(self, n_bytes: int, n_requests: int = 1) -> float:
        # Writes are buffered by the page cache in practice; model at read cost.
        return self.read_time(n_bytes, n_requests)

    def effective_bw(self, block_bytes: int) -> float:
        """Effective bandwidth for a stream of ``block_bytes`` requests (Fig. 2)."""
        return block_bytes / self.read_time(block_bytes, 1)


# Calibrated to the paper: NVMe peak 1.8 GB/s, eMMC peak 250 MB/s; at 512 B
# requests both drop below 6 % of peak (Fig. 2).  UFS sits between them —
# the paper's third evaluated device class (UFS 3.x mobile storage: ~1 GB/s
# sequential read, per-request overhead between the NVMe and eMMC parts).
NVME = DiskSpec("nvme", peak_bw=1.8e9, page_bytes=4096, request_latency=3.5e-6)
UFS = DiskSpec("ufs", peak_bw=1.0e9, page_bytes=4096, request_latency=8e-6)
EMMC = DiskSpec("emmc", peak_bw=250e6, page_bytes=4096, request_latency=20e-6)
DISKS = {"nvme": NVME, "ufs": UFS, "emmc": EMMC}

# -- int8 group quantization (§7 "low-bit KV"), shared by KVDiskStore and
# -- the prefix-cache slab (repro.cache.store) -------------------------------
def quant_groups(block: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """``block [..., G, 2, H, d]`` → (int8 block, per-group scales [...])."""
    amax = np.abs(block).reshape(*block.shape[:-4], -1).max(axis=-1)
    scale = np.maximum(amax / 127.0, 1e-12)
    q = np.clip(np.rint(block / scale[..., None, None, None, None]), -127, 127)
    return q.astype(np.int8), scale.astype(np.float32)


def dequant_groups(q: np.ndarray, scale: np.ndarray, dtype) -> np.ndarray:
    return (q.astype(np.float32)
            * scale[..., None, None, None, None]).astype(dtype)


@dataclasses.dataclass
class IOTracker:
    """Per-scope I/O counters captured by :meth:`IOAccountant.track`.

    ``warm_*`` counts KV served by the host-RAM warm tier
    (:mod:`repro.tiers`) instead of disk: ``warm_bytes`` is in disk-read
    units (the read each hit replaced) and ``warm_seconds`` is the modeled
    memcpy+dequantize cost on the ComputeSpec — a separate *source* lane so
    callers can report a disk/warm breakdown without reaching into the tier.
    """

    read_bytes: int = 0
    read_requests: int = 0
    write_bytes: int = 0
    write_requests: int = 0
    read_seconds: float = 0.0
    write_seconds: float = 0.0
    warm_bytes: int = 0
    warm_requests: int = 0
    warm_seconds: float = 0.0
    # modeled seconds with no bytes moved (flash-GC stalls, retry backoff);
    # also folded into read_seconds so io totals stay one number
    stall_seconds: float = 0.0


class IOAccountant:
    """Accumulates modeled I/O time + byte/request counters per decode step.

    Thread-safe: the prefetch worker charges reads from its own threads while
    the engine's main thread charges rolling-buffer-flush writes.  ``track()``
    opens a *thread-local* scope that additionally captures the charges made
    by the current thread — the engine and the worker use it to attribute
    modeled seconds to one fetch without a second accountant.
    """

    def __init__(self, spec: DiskSpec):
        self.spec = spec
        self._lock = threading.Lock()
        self._local = threading.local()
        self._metrics: dict | None = None
        self.reset()

    def bind_metrics(self, registry) -> None:
        """Mirror every charge into ``kvswap_io_*`` counters of a
        :class:`~repro.obs.metrics.MetricsRegistry`.

        The mirror increments happen *inside* this accountant's lock, so
        the counters accumulate the identical float sequence in the
        identical order as the fields — registry totals are bit-equal to
        :meth:`snapshot`, even with worker threads charging concurrently.
        :meth:`reset` zeroes the bound counters in the same critical
        section, preserving the equality invariant across engine resets.
        """
        c = registry.counter
        with self._lock:
            self._metrics = {
                "read_bytes": c("kvswap_io_read_bytes_total",
                                "bytes read from the disk tier"),
                "read_requests": c("kvswap_io_read_requests_total",
                                   "disk read requests issued"),
                "read_seconds": c("kvswap_io_read_seconds_total",
                                  "modeled disk read seconds"),
                "write_bytes": c("kvswap_io_write_bytes_total",
                                 "bytes written to the disk tier"),
                "write_requests": c("kvswap_io_write_requests_total",
                                    "disk write requests issued"),
                "write_seconds": c("kvswap_io_write_seconds_total",
                                   "modeled disk write seconds"),
                "warm_bytes": c("kvswap_warm_served_bytes_total",
                                "bytes served by the warm tier "
                                "(disk-read units)"),
                "warm_requests": c("kvswap_warm_served_requests_total",
                                   "warm-tier serves"),
                "warm_seconds": c("kvswap_warm_served_seconds_total",
                                  "modeled warm-tier serve seconds"),
                "stall_seconds": c("kvswap_io_stall_seconds_total",
                                   "modeled stall seconds (GC spikes + "
                                   "retry backoff), also in read_seconds"),
            }

    def reset(self) -> None:
        with self._lock:
            self.read_bytes = 0
            self.read_requests = 0
            self.write_bytes = 0
            self.write_requests = 0
            self.read_seconds = 0.0
            self.write_seconds = 0.0
            self.warm_bytes = 0
            self.warm_requests = 0
            self.warm_seconds = 0.0
            self.stall_seconds = 0.0
            if self._metrics is not None:
                for m in self._metrics.values():
                    m._reset()

    @contextlib.contextmanager
    def track(self):
        """Scope capturing this thread's charges into an :class:`IOTracker`."""
        tr = IOTracker()
        stack = self._local.__dict__.setdefault("stack", [])
        stack.append(tr)
        try:
            yield tr
        finally:
            # scopes are strictly LIFO per thread; pop by position, not value
            # (zeroed IOTrackers compare equal, so remove() could hit the
            # wrong one)
            assert stack[-1] is tr
            stack.pop()

    def _trackers(self) -> list[IOTracker]:
        return self._local.__dict__.get("stack", [])

    def charge_read(self, n_bytes: int, n_requests: int = 1) -> float:
        t = self.spec.read_time(n_bytes, n_requests)
        with self._lock:
            self.read_bytes += n_bytes
            self.read_requests += n_requests
            self.read_seconds += t
            m = self._metrics
            if m is not None:
                m["read_bytes"].inc(n_bytes)
                m["read_requests"].inc(n_requests)
                m["read_seconds"].inc(t)
        for tr in self._trackers():
            tr.read_bytes += n_bytes
            tr.read_requests += n_requests
            tr.read_seconds += t
        return t

    def charge_reads(self, sizes: np.ndarray) -> None:
        """:meth:`charge_read` of each of ``sizes`` (bytes, one request
        each) in turn, under one hold of the lock: every total, bound
        counter and open :meth:`track` scope ends as the calls one by one
        leave it, bit for bit (each request's seconds are added in order)."""
        if not sizes.size:
            return
        sizes_of, at = np.unique(sizes, return_inverse=True)
        secs = np.array([self.spec.read_time(int(n), 1) for n in sizes_of])[at]
        n_bytes, n_requests = int(sizes.sum()), int(sizes.size)
        with self._lock:
            self.read_bytes += n_bytes
            self.read_requests += n_requests
            self.read_seconds = fold(self.read_seconds, secs)
            m = self._metrics
            if m is not None:
                m["read_bytes"].inc(n_bytes)
                m["read_requests"].inc(n_requests)
                m["read_seconds"].inc_each(secs)
        for tr in self._trackers():
            tr.read_bytes += n_bytes
            tr.read_requests += n_requests
            tr.read_seconds = fold(tr.read_seconds, secs)

    def charge_write(self, n_bytes: int, n_requests: int = 1) -> float:
        t = self.spec.write_time(n_bytes, n_requests)
        with self._lock:
            self.write_bytes += n_bytes
            self.write_requests += n_requests
            self.write_seconds += t
            m = self._metrics
            if m is not None:
                m["write_bytes"].inc(n_bytes)
                m["write_requests"].inc(n_requests)
                m["write_seconds"].inc(t)
        for tr in self._trackers():
            tr.write_bytes += n_bytes
            tr.write_requests += n_requests
            tr.write_seconds += t
        return t

    def charge_warm(self, n_bytes: int, seconds: float,
                    n_requests: int = 1) -> float:
        """Charge one warm-tier serve: ``n_bytes`` in disk-read units (the
        read this hit replaced) at a caller-modeled ``seconds`` cost (the
        tier prices memcpy+dequantize on a ComputeSpec — this accountant
        only owns the DiskSpec, which must never price RAM)."""
        with self._lock:
            self.warm_bytes += n_bytes
            self.warm_requests += n_requests
            self.warm_seconds += seconds
            m = self._metrics
            if m is not None:
                m["warm_bytes"].inc(n_bytes)
                m["warm_requests"].inc(n_requests)
                m["warm_seconds"].inc(seconds)
        for tr in self._trackers():
            tr.warm_bytes += n_bytes
            tr.warm_requests += n_requests
            tr.warm_seconds += seconds
        return seconds

    def charge_stall(self, seconds: float) -> float:
        """Charge modeled stall time with no bytes moved: injected flash-GC
        spikes and retry backoff (docs/robustness.md).  Folded into
        ``read_seconds`` so every existing ``io_seconds`` consumer —
        :class:`StepStats`, pipeline overlap, SLO attainment — prices the
        stall without new plumbing, plus a dedicated ``stall_seconds``
        lane so fault reports can split it back out."""
        with self._lock:
            self.read_seconds += seconds
            self.stall_seconds += seconds
            m = self._metrics
            if m is not None:
                m["read_seconds"].inc(seconds)
                m["stall_seconds"].inc(seconds)
        for tr in self._trackers():
            tr.read_seconds += seconds
            tr.stall_seconds += seconds
        return seconds

    def snapshot(self) -> dict:
        return {
            "read_bytes": self.read_bytes,
            "read_requests": self.read_requests,
            "write_bytes": self.write_bytes,
            "write_requests": self.write_requests,
            "read_seconds": self.read_seconds,
            "write_seconds": self.write_seconds,
            "warm_bytes": self.warm_bytes,
            "warm_requests": self.warm_requests,
            "warm_seconds": self.warm_seconds,
            "stall_seconds": self.stall_seconds,
            # per-source serve breakdown: bytes delivered to fetches by the
            # disk tier vs the host-RAM warm tier (both in disk-read units)
            "served_by_source": {
                "disk": {"bytes": self.read_bytes,
                         "requests": self.read_requests,
                         "seconds": self.read_seconds},
                "warm": {"bytes": self.warm_bytes,
                         "requests": self.warm_requests,
                         "seconds": self.warm_seconds},
            },
        }


class KVRun(tuple):
    """One read run as ``(k, v)``, each ``[count, G, H_kv, d]``: the two
    halves of ``block``, the ``[count, G, P, H_kv, d]`` extent as the store
    holds it (dequantised for an int8 store), so a reader that wants whole
    groups takes ``block[i]`` without restacking the halves.  A store of
    one plane (``P = 1``, latent records) gives its one plane as both."""

    def __new__(cls, block: np.ndarray):
        run = super().__new__(cls, (block[:, :, 0], block[:, :, -1]))
        run.block = block
        return run


class KVDiskStore:
    """File-backed full KV cache with group-contiguous layout.

    Logical shape: ``[layers, batch, max_groups, G, P, H_kv, d]`` where axis
    4 is (K, V) (``planes`` P = 2), or a token's one latent record (``P =
    1``: MLA, whose V is derived from the record, so the ``v`` the writers
    take is ignored and the readers return the record as both).  The
    innermost 4 axes of one ``(layer, batch, group)`` index are contiguous
    on disk, so one group load is one sequential read of ``group_nbytes``
    bytes.
    """

    def __init__(
        self,
        *,
        n_layers: int,
        batch: int,
        max_groups: int,
        group_size: int,
        n_kv_heads: int,
        head_dim: int,
        dtype=np.float32,
        path: str | None = None,
        accountant: IOAccountant | None = None,
        quant_bits: int = 0,
        planes: int = 2,
    ):
        """``quant_bits=8`` stores int8 per-group-scaled KV on disk (paper §7
        "low-bit KV" combination): group reads shrink ~dtype_size×, trading a
        small dequantization error.  Scales live in memory (4 B/group)."""
        self.n_layers = n_layers
        self.batch = batch
        self.max_groups = max_groups
        self.group_size = group_size
        self.n_kv_heads = n_kv_heads
        self.head_dim = head_dim
        if planes not in (1, 2):
            raise ValueError("planes must be 1 (latent records) or 2 (K and V)")
        self.planes = planes
        self.dtype = np.dtype(dtype)
        self.accountant = accountant
        if quant_bits not in (0, 8):
            raise ValueError("quant_bits must be 0 (raw) or 8 (int8)")
        self.quant_bits = quant_bits
        self._store_dtype = np.dtype(np.int8) if quant_bits == 8 else self.dtype
        self._scales = (np.zeros((n_layers, batch, max_groups), np.float32)
                        if quant_bits == 8 else None)

        shape = (n_layers, batch, max_groups, group_size, planes, n_kv_heads, head_dim)
        if path is None:
            fd, path = tempfile.mkstemp(prefix="kvswap_store_", suffix=".bin")
            os.close(fd)
            self._owns_file = True
        else:
            self._owns_file = False
        self.path = path
        self._mm = np.memmap(path, dtype=self._store_dtype, mode="w+", shape=shape)
        # number of groups currently valid on disk, per (layer, batch)
        self.n_groups = np.zeros((n_layers, batch), dtype=np.int64)
        # optional host-RAM warm tier (repro.tiers.WarmTier): the store owns
        # write-coherence — rewriting a (layer, row, group) extent drops its
        # warm copy, and freeing a row drops every entry the row held
        self.warm = None

    # -- int8 helpers -------------------------------------------------------
    def _quant(self, block: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
        """``block [..., G, 2, H, d]`` → (int8 block, scales [...])."""
        return quant_groups(block)

    def _dequant(self, q: np.ndarray, scale: np.ndarray) -> np.ndarray:
        return dequant_groups(q, scale, self.dtype)

    def scale_of(self, layer: int, batch_idx: int, gid: int) -> float | None:
        """The on-disk int8 scale of one group (``None`` for a raw store).

        Resident metadata (4 B/group): the warm tier re-quantizes evicted
        groups with it so a warm hit reproduces the disk read bit-for-bit.
        """
        if self._scales is None:
            return None
        return float(self._scales[layer, batch_idx, gid])

    # -- geometry ---------------------------------------------------------
    @property
    def group_nbytes(self) -> int:
        return self.group_size * self.entry_nbytes

    @property
    def entry_nbytes(self) -> int:
        """One token's K+V across heads — the paper's 'KV entry' (its
        latent record with one plane)."""
        return self.planes * self.n_kv_heads * self.head_dim * self._store_dtype.itemsize

    def _stack(self, k: np.ndarray, v: np.ndarray, axis: int) -> np.ndarray:
        """The planes of a block stacked on ``axis``: K and V, or K alone."""
        return np.stack([k, v] if self.planes == 2 else [k], axis=axis)

    def total_bytes_on_disk(self) -> int:
        return int(self.n_groups.sum()) * self.group_nbytes

    # -- writes -----------------------------------------------------------
    def write_prefill(self, layer: int, k: np.ndarray, v: np.ndarray) -> int:
        """Write the prefill KV for ``layer``; returns number of full groups.

        ``k, v``: ``[batch, seq, H_kv, d]``.  Only full groups are written;
        the trailing ``seq % G`` tokens stay in the rolling buffer (§3.4.1).
        """
        b, seq = k.shape[0], k.shape[1]
        g = self.group_size
        ng = seq // g
        if ng > 0:
            kg = k[:, : ng * g].reshape(b, ng, g, self.n_kv_heads, self.head_dim)
            vg = v[:, : ng * g].reshape(b, ng, g, self.n_kv_heads, self.head_dim)
            block = self._stack(kg, vg, 3)  # [B, ng, G, P, H, d]
            if self.quant_bits == 8:
                qblk, scale = self._quant(block)
                self._mm[layer, :, :ng] = qblk
                self._scales[layer, :, :ng] = scale
            else:
                self._mm[layer, :, :ng] = block.astype(self.dtype)
            if self.accountant is not None:
                # Sequential layer-sized write, one request per batch row.
                self.accountant.charge_write(b * ng * self.group_nbytes, b)
            if self.warm is not None:
                for bi in range(b):
                    self.warm.invalidate_range(layer, bi, ng)
        self.n_groups[layer, :] = ng
        return ng

    def write_prefill_row(self, layer: int, batch_idx: int, k: np.ndarray,
                          v: np.ndarray) -> int:
        """Row-level :meth:`write_prefill` (continuous-batching admission).

        ``k, v``: ``[seq, H_kv, d]`` for one batch row.  Only full groups are
        written; the trailing ``seq % G`` tokens stay in the rolling buffer.
        Charged as one sequential write.
        """
        seq = k.shape[0]
        g = self.group_size
        ng = seq // g
        if ng > self.max_groups:
            raise RuntimeError(f"KVDiskStore overflow: layer={layer} batch={batch_idx}")
        if ng > 0:
            kg = k[: ng * g].reshape(ng, g, self.n_kv_heads, self.head_dim)
            vg = v[: ng * g].reshape(ng, g, self.n_kv_heads, self.head_dim)
            block = self._stack(kg, vg, 2)  # [ng, G, P, H, d]
            if self.quant_bits == 8:
                qblk, scale = self._quant(block)
                self._mm[layer, batch_idx, :ng] = qblk
                self._scales[layer, batch_idx, :ng] = scale
            else:
                self._mm[layer, batch_idx, :ng] = block.astype(self.dtype)
            if self.accountant is not None:
                self.accountant.charge_write(ng * self.group_nbytes, 1)
            if self.warm is not None:
                self.warm.invalidate_range(layer, batch_idx, ng)
        self.n_groups[layer, batch_idx] = ng
        return ng

    def append_group(self, layer: int, k_group: np.ndarray, v_group: np.ndarray) -> None:
        """Append one full group per batch row (rolling-buffer flush).

        ``k_group, v_group``: ``[batch, G, H_kv, d]``.
        """
        for bi in range(self.batch):
            self.append_group_row(layer, bi, k_group[bi], v_group[bi])

    def append_group_row(self, layer: int, batch_idx: int, k_group: np.ndarray,
                         v_group: np.ndarray) -> None:
        """Append one full group for a single row (``[G, H_kv, d]`` each).

        The continuous-batching flush unit: rows retire/flush independently,
        so each completed group is one write request for one row.
        """
        gi = int(self.n_groups[layer, batch_idx])
        if gi >= self.max_groups:
            raise RuntimeError(f"KVDiskStore overflow: layer={layer} batch={batch_idx}")
        block = self._stack(k_group, v_group, 1)  # [G, P, H, d]
        if self.quant_bits == 8:
            qblk, scale = self._quant(block)
            self._mm[layer, batch_idx, gi] = qblk
            self._scales[layer, batch_idx, gi] = scale
        else:
            self._mm[layer, batch_idx, gi] = block.astype(self.dtype)
        self.n_groups[layer, batch_idx] = gi + 1
        if self.accountant is not None:
            self.accountant.charge_write(self.group_nbytes, 1)
        if self.warm is not None:
            # the extent at gi was just (re)written; any warm copy is stale
            self.warm.invalidate(layer, batch_idx, gi)

    def free_row(self, batch_idx: int) -> None:
        """Retire a batch row: its extents become reusable by the next tenant.

        The layout is a fixed ``(layer, row, group)``-indexed memmap, so
        "freeing" is resetting the valid-group watermark — the recycled
        slot's writes then overwrite the old extents in place.  Any warm-
        tier entries the row held are freed with it (slot recycling must
        never serve a previous tenant's KV).
        """
        self.n_groups[:, batch_idx] = 0
        if self.warm is not None:
            self.warm.clear_row(batch_idx)

    # -- reads ------------------------------------------------------------
    def read_run(self, layer: int, batch_idx: int, start: int, count: int) -> tuple[np.ndarray, np.ndarray]:
        """Execute one coalesced run: a single sequential read of ``count``
        groups starting at ``start`` (a :class:`repro.io.scheduler.ReadRun`).

        Returns ``(k, v)`` each ``[count, G, H_kv, d]``, a :class:`KVRun`
        over the extent read.  Charged to the accountant as **one** request
        of ``count * group_nbytes`` bytes — gap groups a gap-coalescing
        scheduler reads through are real bytes moved, so they are billed
        too.
        """
        run = self.peek_run(layer, batch_idx, start, count)
        if self.accountant is not None:
            self.accountant.charge_read(count * self.group_nbytes, 1)
        return run

    def peek_run(self, layer: int, batch_idx: int, start: int,
                 count: int) -> tuple[np.ndarray, np.ndarray]:
        """:meth:`read_run`'s read without its charge to the accountant:
        for an observer outside the engine's I/O (the modeled clock and the
        byte counts stay as if it had not looked)."""
        if start < 0 or start + count > self.max_groups:
            raise IndexError(
                f"run [{start}, {start + count}) outside [0, {self.max_groups})")
        blk = np.asarray(self._mm[layer, batch_idx, start:start + count])
        if self.quant_bits == 8:
            blk = self._dequant(blk, self._scales[layer, batch_idx, start:start + count])
        return KVRun(blk)

    def gather_groups(self, layer: int, rows: np.ndarray, gids: np.ndarray,
                      out: np.ndarray) -> None:
        """Copy group ``gids[i]`` of row ``rows[i]`` into ``out[i]``
        (``[n, G, P, H_kv, d]``), as :meth:`peek_run` reads it and without
        its charge: one gather over the layer's ``[B·max_groups, …]`` view,
        dequantised from an int8 store.  The caller charges the reads."""
        if gids.size and (gids.min() < 0 or gids.max() >= self.max_groups):
            raise IndexError(f"group ids outside [0, {self.max_groups})")
        src = self._mm[layer].reshape((-1,) + self._mm.shape[3:])
        at = rows * self.max_groups + gids
        if self.quant_bits == 8:
            out[...] = self._dequant(src.take(at, axis=0), self._scales[layer].reshape(-1)[at])
        else:
            src.take(at, axis=0, out=out, mode="clip")   # checked above; "raise" buffers

    def vet_runs(self, layer: int, batch_idx: int, gids: np.ndarray,
                 scheduler: ReadScheduler, read) -> None:
        """Clear row ``batch_idx``'s planned runs of ``gids`` for a fetch
        that gathers them (``DiskTier.vet``), ``read(batch_idx, run)``
        being the disk tier's retrying read of one run.  A plain store's
        extents always read: nothing to do, and the runs are charged with
        the fetch's others (:meth:`charge_runs`)."""

    def charge_runs(self, counts: np.ndarray) -> None:
        """Charge one read request a run of ``counts[i]`` groups, in order,
        for the groups :meth:`gather_groups` copies."""
        if self.accountant is not None:
            self.accountant.charge_reads(counts * self.group_nbytes)

    # -- lifecycle --------------------------------------------------------
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
