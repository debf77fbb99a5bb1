"""Rolling buffer (RB) for freshly decoded KV entries (KVSwap §3.4.1).

Critical entries are predicted at *group* granularity, so the importance of
a new token cannot be assessed until its group completes.  The RB keeps the
most recent ``< G`` tokens in memory; once a full group of ``G`` accumulates
it is flushed to disk and its keys appended to the compressed K cache.
Disabling the RB drops accuracy by >= 29 % (paper Tab. 3, App. B): new tokens
must participate in attention immediately.

Fill is tracked **per batch row**: under the continuous-batching serving API
rows are admitted and retired independently, so each row's tail advances on
its own schedule (``fills``).  The classic lockstep entry points (``append``,
``advance``, ``seed``) remain and reduce to the uniform-fill behavior.
"""

from __future__ import annotations

import numpy as np


class RollingBuffer:
    """Per-layer rolling buffer over a shared batch. Host-side (numpy)."""

    def __init__(self, *, batch: int, group_size: int, n_kv_heads: int, head_dim: int, dtype=np.float32):
        self.batch = batch
        self.group_size = group_size
        self.k = np.zeros((batch, group_size, n_kv_heads, head_dim), dtype=dtype)
        self.v = np.zeros_like(self.k)
        self.fills = np.zeros(batch, dtype=np.int64)  # tokens held, per row

    @property
    def fill(self) -> int:
        """Uniform (lockstep) fill level: the max over rows.

        The lockstep engine paths keep every row at the same level, so this
        is exact there; per-row consumers read ``fills`` directly.
        """
        return int(self.fills.max(initial=0))

    @property
    def nbytes(self) -> int:
        return self.k.nbytes + self.v.nbytes

    # -- per-row lifecycle -------------------------------------------------
    def append_rows(self, k_new: np.ndarray, v_new: np.ndarray,
                    active: np.ndarray) -> list[tuple[int, np.ndarray, np.ndarray]]:
        """Append one token for every ``active`` row (``k_new/v_new [B, H_kv, d]``).

        Returns ``[(row, k_group [G, H_kv, d], v_group), ...]`` for the rows
        whose group completed this step (their fill wraps to 0).
        """
        completed: list[tuple[int, np.ndarray, np.ndarray]] = []
        for bi in np.flatnonzero(active):
            f = int(self.fills[bi])
            self.k[bi, f] = k_new[bi]
            self.v[bi, f] = v_new[bi]
            self.fills[bi] = f + 1
            if f + 1 == self.group_size:
                completed.append((int(bi), self.k[bi].copy(), self.v[bi].copy()))
                self.fills[bi] = 0
        return completed

    def advance_rows(self, active: np.ndarray) -> list[int]:
        """Count one appended token per active row without a host copy.

        The device-resident decode path keeps ``k_new/v_new`` on device (a
        device rolling mirror in the engine) and only downloads a completed
        group at flush time; this keeps ``fills`` — which the mapping-table
        rebuild reads — in sync without a per-token device→host transfer.
        Returns the rows whose group completed (caller must spill the device
        group via :meth:`KVCacheManager.spill_group_row`); the host ``k/v``
        arrays are NOT updated for those rows and are invalid until reseeded.
        """
        completed: list[int] = []
        for bi in np.flatnonzero(active):
            self.fills[bi] += 1
            if self.fills[bi] == self.group_size:
                self.fills[bi] = 0
                completed.append(int(bi))
        return completed

    def seed_row(self, bi: int, k_tail: np.ndarray, v_tail: np.ndarray) -> None:
        """Seed one row with its prefill tail (``[t, H_kv, d]``, ``t < G``)."""
        t = k_tail.shape[0]
        if t >= self.group_size:
            raise ValueError("tail longer than a group")
        self.k[bi, :t] = k_tail
        self.v[bi, :t] = v_tail
        self.fills[bi] = t

    def clear_row(self, bi: int) -> None:
        """Retire a row: its in-flight tail is dropped for the next tenant."""
        self.fills[bi] = 0

    # -- lockstep entry points (all rows together) -------------------------
    def append(self, k_new: np.ndarray, v_new: np.ndarray) -> tuple[np.ndarray, np.ndarray] | None:
        """Append one token per batch row (``[B, H_kv, d]``).

        Returns the completed ``(k_group, v_group)`` of shape
        ``[B, G, H_kv, d]`` when the buffer fills, else ``None``.
        """
        done = self.append_rows(k_new, v_new, np.ones(self.batch, bool))
        if len(done) == self.batch:
            return (np.stack([k for _, k, _ in done]),
                    np.stack([v for _, _, v in done]))
        return None

    def advance(self) -> bool:
        """Lockstep :meth:`advance_rows`: ``True`` when the group completes."""
        return len(self.advance_rows(np.ones(self.batch, bool))) == self.batch

    def seed(self, k_tail: np.ndarray, v_tail: np.ndarray) -> None:
        """Seed with the prefill tail (``seq % G`` tokens): ``[B, t, H_kv, d]``."""
        t = k_tail.shape[1]
        if t >= self.group_size:
            raise ValueError("tail longer than a group")
        self.k[:, :t] = k_tail
        self.v[:, :t] = v_tail
        self.fills[:] = t

    def current(self) -> tuple[np.ndarray, np.ndarray]:
        """Valid in-flight entries (lockstep view): ``[B, fill, H_kv, d]``."""
        return self.k[:, : self.fill], self.v[:, : self.fill]
