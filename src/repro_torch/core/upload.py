"""Host slabs that carry a fetch's missed KV groups to the device in one copy.

On the device-resident path a fetch (:meth:`KVCacheManager.fetch`, on a
prefetch worker or inline) writes each group it serves once into a host
slab, then an int64 index block behind the payload: the step's slot table,
the rolling fills, the reuse mirror's ``(row, slot)`` entries and the staged
groups' ``(row, token)`` entries.  The engine's main thread moves the used
bytes to the device with one non-blocking copy and writes the mirror and the
staged context rows with ``index_put_`` (:meth:`SlabRing.deliver`).

On a CUDA device the slabs are pinned, so the copy runs asynchronously; each
slab keeps the event of the copy that last read it, and a fetch that takes
the slab waits for that event before writing.  A ring holds as many slabs as
tables can be live at once: the double buffer's two plus one whose copy may
still be pending (one on the synchronous path).
"""

from __future__ import annotations

import collections
import dataclasses
import itertools
import threading

import numpy as np
import torch

_ALIGN = 8   # the index block starts on an int64 boundary


class Slab:
    """One host buffer: payload groups, then the index block.  Held as int64
    words, the unit the index block is read in on the device."""

    def __init__(self, nbytes: int, device: torch.device):
        cuda = device.type == "cuda"
        self.words = torch.empty(nbytes // 8, dtype=torch.int64, pin_memory=cuda)
        self.u8 = self.words.numpy().view(np.uint8)
        # the copy that last read this slab (never recorded: nothing pending)
        self.event = torch.cuda.Event() if cuda else None


@dataclasses.dataclass
class SlabUpload:
    """What a fetch left in its slab for the main thread to deliver."""

    slab: Slab
    n_mirror: int    # groups for the reuse mirror, first in the payload
    n_staged: int    # staged group positions, after the mirror's groups
    index_at: int    # byte offset of the int64 index block
    nbytes: int      # bytes used: payload, then the index block


@dataclasses.dataclass
class DeviceUpload:
    """One delivered slab on the device: views into a single copy."""

    slots: torch.Tensor         # [B, M] int64, the table's slot addressing
    fill: torch.Tensor          # [B] int64, valid rolling-tail tokens
    staged_rows: torch.Tensor   # [n_staged·G] row of each staged token
    staged_toks: torch.Tensor   # [n_staged·G] its context position
    staged_kv: torch.Tensor     # [n_staged·G, P, H_kv, d] its K and V (or record)

    def put_staged(self, k_ctx: torch.Tensor, v_ctx: torch.Tensor) -> None:
        """Overwrite the staged groups' rows of a gathered context (``k_ctx``
        alone where the groups hold one plane, latent records)."""
        idx = (self.staged_rows, self.staged_toks)
        k_ctx.index_put_(idx, self.staged_kv[:, 0])
        if self.staged_kv.shape[1] == 2:
            v_ctx.index_put_(idx, self.staged_kv[:, 1])


def staged_tokens(slots: np.ndarray, g: int) -> tuple[np.ndarray, ...]:
    """The staged groups' context tokens of a ``[B, M]`` slot table.

    Returns ``(rows, positions, tok_rows, toks)``: the ``(row, position)``
    of every ``-2`` slot in row-major order, and for each of its ``G``
    tokens the row and the context index ``position·G + t``.  A group
    selected at two positions counts twice, as the context holds it twice.
    """
    rows, pos = np.nonzero(slots == -2)
    toks = (pos[:, None] * g + np.arange(g)).reshape(-1)
    return rows, pos, np.repeat(rows, g), toks


class SlabRing:
    """A fixed ring of host slabs shared by one engine's KV layers.

    ``acquire`` (the fetch, any thread) takes the slab released longest ago
    and waits for its pending copy; ``deliver`` (the main thread) copies a
    filled slab to the device, records the copy's event and releases the
    slab.  ``reclaim`` returns every slab after a failed step.
    """

    def __init__(self, n_slabs: int, *, batch: int, n_select: int, group_shape: tuple,
                 dtype, device, obs=None):
        self.device = torch.device(device)
        self.dtype = np.dtype(dtype)
        self.torch_dtype = torch.from_numpy(np.zeros(0, self.dtype)).dtype
        self.group_shape = tuple(group_shape)                      # (G, P, H_kv, d)
        self.group_numel = int(np.prod(self.group_shape))
        self.group_nbytes = self.group_numel * self.dtype.itemsize
        groups = batch * n_select
        # slots and fills, then at most 2 ints a mirror group and 2·G a staged one
        index_len = groups + batch + 2 * self.group_shape[0] * groups
        nbytes = -(-groups * self.group_nbytes // _ALIGN) * _ALIGN + 8 * index_len
        self.slabs = tuple(Slab(nbytes, self.device) for _ in range(n_slabs))
        self._free = collections.deque(self.slabs)
        self._lock = threading.Lock()
        self._obs = obs
        if obs is not None and obs.enabled:
            reg = obs.registry
            self._m_bytes = reg.counter(
                "kvswap_upload_slab_bytes_total",
                "KV payload bytes delivered to the device through host slabs")
            self._m_waits = reg.counter(
                "kvswap_upload_slab_waits_total",
                "fetches that found their slab's last copy still pending")

    @property
    def n_free(self) -> int:
        with self._lock:
            return len(self._free)

    def _on(self) -> bool:
        return self._obs is not None and self._obs.enabled

    # -- the fetch's side (any thread) ------------------------------------
    def acquire(self) -> Slab:
        """Take the slab released longest ago; wait out its pending copy."""
        with self._lock:
            if not self._free:
                raise RuntimeError(
                    f"all {len(self.slabs)} upload slabs are held: a fetched table "
                    "was dropped without delivery or reclaim")
            slab = self._free.popleft()
        if slab.event is not None and not slab.event.query():
            if self._on():
                self._m_waits.inc()
            slab.event.synchronize()
        return slab

    def release(self, slab: Slab) -> None:
        with self._lock:
            self._free.append(slab)

    def reclaim(self) -> None:
        """Return every held slab (a step failed with tables undelivered)."""
        with self._lock:
            held = [s for s in self.slabs if all(s is not f for f in self._free)]
            self._free.extend(held)

    def fill(self, write, n_mirror: int, n_staged: int, mirror_rows: np.ndarray,
             mirror_slots: np.ndarray, slots: np.ndarray, fills: np.ndarray,
             staged_tok_rows: np.ndarray, staged_toks: np.ndarray) -> SlabUpload:
        """Write one fetch into a slab: the payload by ``write(out)``, where
        ``out`` is the slab's ``[n_mirror + n_staged, G, P, H_kv, d]``
        payload, the groups for the reuse mirror's ``(mirror_rows,
        mirror_slots)`` first, then each staged position's, whose tokens are
        ``(staged_tok_rows, staged_toks)``; then the index block.  Each
        payload group is written once."""
        slab = self.acquire()
        try:
            n = n_mirror + n_staged
            pay = n * self.group_nbytes
            if n:
                write(slab.u8[:pay].view(self.dtype).reshape(n, *self.group_shape))
            at = -(-pay // _ALIGN) * _ALIGN
            parts = [slots.reshape(-1), fills, mirror_rows, mirror_slots,
                     staged_tok_rows, staged_toks]
            n_ix = sum(p.size for p in parts)
            np.concatenate(parts, out=slab.u8[at:at + 8 * n_ix].view(np.int64))
        except BaseException:
            self.release(slab)
            raise
        return SlabUpload(slab, n_mirror, n_staged, at, at + 8 * n_ix)

    # -- the main thread's side ------------------------------------------
    def deliver(self, up: SlabUpload, mirror, batch: int, n_select: int) -> DeviceUpload:
        """One non-blocking copy of the slab's used bytes into a device
        buffer sized to them; the mirror's groups go into ``mirror`` by
        ``index_put_``; the slab goes back to the ring behind its copy's
        event.  Returns the staged groups and the table's addressing as
        views of the copy.

        Each PyTorch call that dispatches an operator hands the interpreter
        lock to the prefetch workers and waits to take it back, so the
        views are cut by indexing where it can (which keeps the lock)."""
        dev = up.slab.words[:up.nbytes // 8].to(self.device, non_blocking=True)
        if up.slab.event is not None:
            up.slab.event.record(torch.cuda.current_stream(self.device))
        self.release(up.slab)
        n_m, n = up.n_mirror, up.n_mirror + up.n_staged
        at = up.index_at // 8
        kv = dev[:at].view(self.torch_dtype)[:n * self.group_numel].view(n, *self.group_shape)
        n_tok = up.n_staged * self.group_shape[0]
        cut = list(itertools.accumulate([at, batch * n_select, batch, n_m, n_m, n_tok, n_tok]))
        slots, fill, m_rows, m_slots, s_rows, s_toks = (dev[a:b] for a, b in zip(cut, cut[1:]))
        if n_m:
            mirror.scatter(m_rows, m_slots, kv[:n_m])
        if self._on():
            self._m_bytes.inc(n * self.group_nbytes)
        return DeviceUpload(slots.view(batch, n_select), fill, s_rows, s_toks,
                            kv[n_m:].reshape(-1, *self.group_shape[1:]))
