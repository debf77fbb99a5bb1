"""Seeded, deterministic fault-injection plans (docs/robustness.md).

A :class:`FaultPlan` decides, for every storage operation, whether it
fails — and it decides *deterministically*: each decision is a hash draw
keyed by the operation's logical identity (kind, layer, row, extent) plus
an **occurrence counter** that only advances when the logical operation
finally succeeds.  Two properties follow, and both are load-bearing:

* **Schedule independence.**  Prefetch workers race; wall-clock ordering
  of reads is nondeterministic.  Hash-keyed draws make the fault pattern
  a pure function of *what* is accessed, not *when*, so a faulted run is
  reproducible across sync/async modes and thread interleavings.
* **Retries terminate.**  A transient decision arms a **burst** of
  ``error_burst`` consecutive failing attempts for that one operation,
  after which attempts succeed.  Keep ``error_burst <
  RetryPolicy.max_attempts`` and every transient fault is recovered
  in-place by retries — which is exactly the configuration under which
  ``benchmarks/fault_injection.py`` asserts tokens stay bit-identical.
  Set ``error_burst`` at/above the retry budget and the same machinery
  produces persistent-looking failures that exercise the escalation
  ladder instead.

Persistent faults are modeled where real ones are born: **at write
time**.  ``bad_extent_rate`` marks (layer, row, group) extents as grown
bad blocks when they are written; every later read of a marked extent
raises :class:`~repro.faults.errors.MediaError` until the extent is
rewritten (rewrites remap — and redraw — the marks).  Payload corruption
(``corrupt_block_rate``) flips bytes of a published prefix-cache extent
*at rest*, so the checksum verifier and the serve path see the same
damaged bytes.  Crash points (``crash_points``) fire once each at named
sites (``"manifest_write"``) and leave torn state behind, the way a real
power cut would.

Latency spikes (``spike_rate``/``spike_seconds``) model flash
garbage-collection stalls and fire only on the disk classes that exhibit
them (``spike_disks``, default emmc+ufs); they charge modeled seconds,
never raise, and never sleep.
"""

from __future__ import annotations

import dataclasses
import hashlib
import threading
from typing import Tuple

import numpy as np

from repro_torch.faults.errors import (MediaError, TornReadError,
                                 TransientReadError)

__all__ = ["FaultSpec", "FaultStats", "FaultPlan"]


@dataclasses.dataclass(frozen=True)
class FaultSpec:
    """Declarative description of one fault campaign (all rates in [0, 1],
    per logical operation).  The zero spec injects nothing."""

    seed: int = 0
    read_error_rate: float = 0.0    # transient device errors on read_run
    torn_read_rate: float = 0.0     # transient short reads on read_run
    error_burst: int = 1            # failing attempts per armed transient
    spike_rate: float = 0.0         # flash-GC stall probability per read
    spike_seconds: float = 0.005    # modeled stall length
    spike_disks: Tuple[str, ...] = ("emmc", "ufs")
    corrupt_block_rate: float = 0.0  # at-rest prefix-block corruption
    bad_extent_rate: float = 0.0    # grown-bad-block probability per write
    crash_points: Tuple[str, ...] = ()  # one-shot named crash sites

    def __post_init__(self):
        for f in ("read_error_rate", "torn_read_rate", "spike_rate",
                  "corrupt_block_rate", "bad_extent_rate"):
            v = getattr(self, f)
            if not 0.0 <= v <= 1.0:
                raise ValueError(f"{f} must be in [0, 1], got {v}")
        if self.error_burst < 1:
            raise ValueError(f"error_burst must be >= 1, got {self.error_burst}")


@dataclasses.dataclass
class FaultStats:
    """Lifetime injection counters (what the plan *did*, for reports)."""

    read_errors: int = 0
    torn_reads: int = 0
    media_errors: int = 0
    gc_stalls: int = 0
    stall_seconds: float = 0.0
    corrupted_blocks: int = 0
    bad_extents_marked: int = 0
    crashes: int = 0


class FaultPlan:
    """Runtime decision engine for one :class:`FaultSpec`.

    Thread-safe: prefetch workers consult it concurrently.  One plan may
    be shared by the disk wrapper and the prefix cache of the same
    engine.
    """

    def __init__(self, spec: FaultSpec):
        self.spec = spec
        self.stats = FaultStats()
        self._lock = threading.Lock()
        self._occ: dict = {}      # logical-op key -> completed occurrences
        self._burst: dict = {}    # logical-op key -> [kind, attempts left]
        self._bad: set = set()    # (layer, row, gid) grown bad blocks
        self._crash_left = set(spec.crash_points)

    # -- the deterministic draw -------------------------------------------
    def _unit(self, *key) -> float:
        """Uniform [0, 1) draw, a pure function of (seed, key)."""
        h = hashlib.blake2b(repr((self.spec.seed,) + key).encode(),
                            digest_size=8).digest()
        return int.from_bytes(h, "big") / 2.0 ** 64

    # -- read surface ------------------------------------------------------
    def on_read(self, layer: int, row: int, start: int, count: int, *,
                disk: str = "nvme") -> float:
        """Decide faults for one ``read_run`` attempt.

        Raises the injected fault, or returns the extra modeled stall
        seconds (0.0 or one GC spike) the caller must charge.
        """
        spec = self.spec
        with self._lock:
            for gid in range(start, start + count):
                if (layer, row, gid) in self._bad:
                    self.stats.media_errors += 1
                    raise MediaError(
                        f"injected grown bad block: layer {layer} row {row} "
                        f"group {gid}", layer=layer, row=row, group=gid)
            key = ("read", layer, row, start, count)
            ent = self._burst.get(key)
            if ent is None and (spec.read_error_rate or spec.torn_read_rate):
                u = self._unit(*key, self._occ.get(key, 0))
                if u < spec.read_error_rate:
                    ent = self._burst[key] = ["error", spec.error_burst]
                elif u < spec.read_error_rate + spec.torn_read_rate:
                    ent = self._burst[key] = ["torn", spec.error_burst]
            # the armed entry stays in _burst until the op SUCCEEDS (not
            # until the burst is spent): the draw above keys on the
            # occurrence counter, which only advances on success, so
            # popping early would redraw the same (key, occ) on the next
            # attempt and deterministically re-arm the "transient" fault
            # forever
            if ent is not None and ent[1] > 0:
                ent[1] -= 1
                ctx = dict(layer=layer, row=row, start=start, count=count)
                if ent[0] == "error":
                    self.stats.read_errors += 1
                    raise TransientReadError(
                        f"injected transient read error: layer {layer} row "
                        f"{row} groups [{start},{start + count})", **ctx)
                self.stats.torn_reads += 1
                raise TornReadError(
                    f"injected short read: layer {layer} row {row} groups "
                    f"[{start},{start + count})", **ctx)
            # attempt succeeds -> the logical op completes
            self._burst.pop(key, None)
            occ = self._occ.get(key, 0)
            self._occ[key] = occ + 1
            if spec.spike_rate and disk in spec.spike_disks \
                    and self._unit("spike", layer, row, start, count, occ) \
                    < spec.spike_rate:
                self.stats.gc_stalls += 1
                self.stats.stall_seconds += spec.spike_seconds
                return spec.spike_seconds
            return 0.0

    # -- write surface -----------------------------------------------------
    def on_write(self, layer: int, row: int, start: int, count: int) -> None:
        """Account one extent write: rewrites remap (clear) existing bad
        marks over the extent, then maybe grow one new bad block in it."""
        spec = self.spec
        if not spec.bad_extent_rate:
            return
        with self._lock:
            for gid in range(start, start + count):
                self._bad.discard((layer, row, gid))
            key = ("write", layer, row, start, count)
            occ = self._occ.get(key, 0)
            self._occ[key] = occ + 1
            if self._unit(*key, occ) < spec.bad_extent_rate:
                gid = start + int(self._unit("badgid", layer, row, start,
                                             count, occ) * count)
                self._bad.add((layer, row, min(gid, start + count - 1)))
                self.stats.bad_extents_marked += 1

    def bad_extents(self) -> set:
        """Snapshot of currently-marked (layer, row, group) bad blocks."""
        with self._lock:
            return set(self._bad)

    # -- prefix-cache surface ---------------------------------------------
    def corrupt_block(self, store, start: int, n_groups: int, *,
                      key: str) -> bool:
        """Maybe corrupt a just-published prefix-cache extent **at rest**.

        Flips one byte of the slab slice so the checksum verifier and any
        later restore read identical damaged bytes (corrupting only the
        in-flight copy would let the two disagree).  Returns True when a
        flip happened.
        """
        if not self.spec.corrupt_block_rate:
            return False
        with self._lock:
            if self._unit("corrupt", key) >= self.spec.corrupt_block_rate:
                return False
            self.stats.corrupted_blocks += 1
            idx_draw = self._unit("corrupt_idx", key)
        view = np.ascontiguousarray(
            store._mm[:, start:start + n_groups]).view(np.uint8)
        flat = view.reshape(-1)
        idx = min(int(idx_draw * flat.size), flat.size - 1)
        flat[idx] ^= 0xFF
        store._mm[:, start:start + n_groups] = view.view(
            store._mm.dtype).reshape(store._mm[:, start:start + n_groups].shape)
        return True

    def should_crash(self, point: str) -> bool:
        """One-shot named crash site; fires at most once per plan."""
        with self._lock:
            if point in self._crash_left:
                self._crash_left.discard(point)
                self.stats.crashes += 1
                return True
            return False

    # -- reporting ---------------------------------------------------------
    def snapshot(self) -> dict:
        with self._lock:
            d = dataclasses.asdict(self.stats)
            d["bad_extents_active"] = len(self._bad)
            d["crash_points_left"] = sorted(self._crash_left)
            return d
