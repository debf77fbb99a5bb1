"""Asynchronous group preloading (KVSwap §3.3–§3.4).

The paper's pipeline issues the disk reads for layer *i+1*'s predicted
critical groups while layer *i* computes, so I/O time hides under compute.
Two pieces implement that here:

* :class:`PrefetchWorker` — a small thread pool servicing group-read requests
  from **per-layer queues**.  Per-layer queuing is a correctness property,
  not an optimization: a fetch mutates that layer's reuse buffer, so two
  requests for the same layer must never run concurrently.  Requests across
  layers are drained FIFO by submission order.

* :class:`DoubleBuffer` — the front/back staging area between the engine and
  the worker.  While layer *i* computes against the *front* result, layer
  *i+1*'s request is in flight in the *back* slot; reaching layer *i+1*
  rotates the back to the front (blocking only if the read hasn't landed).

The worker runs host-side code only (numpy + memmap); all JAX compute stays
on the caller's thread.  Modeled I/O time per request is captured with
``IOAccountant.track()`` so the engine can report both the *modeled* overlap
(DiskSpec seconds) and the *measured* one (wall-clock seconds).
"""

from __future__ import annotations

import collections
import dataclasses
import itertools
import threading
import time
from concurrent.futures import Future
from typing import Callable

__all__ = [
    "DoubleBuffer",
    "PrefetchQueueFull",
    "PrefetchResult",
    "PrefetchWorker",
]


class PrefetchQueueFull(RuntimeError):
    """Raised by ``submit(block=False)`` when the pending queue is at capacity."""


@dataclasses.dataclass
class PrefetchResult:
    """What a serviced request returns: the payload plus its I/O cost."""

    table: object            # whatever fetch_fn produced (engine: MappingTable)
    io_seconds: float = 0.0  # modeled serve time of this fetch (disk + warm tier)
    io_bytes: int = 0        # disk bytes read
    io_requests: int = 0
    wall_seconds: float = 0.0  # measured service time on the worker thread


@dataclasses.dataclass
class _Request:
    seq: int
    layer: int
    args: tuple
    future: Future


class PrefetchWorker:
    """Thread pool draining per-layer queues of group-read requests.

    ``fetch_fn(layer, *args)`` runs on a worker thread and must only touch
    host memory (the engine passes ``managers[layer].fetch``).  ``submit``
    returns a :class:`concurrent.futures.Future` resolving to a
    :class:`PrefetchResult`.

    Invariants:

    * at most one in-flight request per layer (queued requests for a busy
      layer wait until it frees up);
    * across layers, the oldest submitted request is serviced first;
    * at most ``max_pending`` requests queued; ``submit`` blocks (or raises
      :class:`PrefetchQueueFull` with ``block=False``) beyond that;
    * ``close()`` cancels queued requests, lets in-flight ones finish, and
      joins the threads;
    * **worker threads survive every request failure** (docs/robustness.md):
      a raised fetch resolves only *that* request's future — the original
      exception object, enriched with ``prefetch_layer``/``prefetch_args``
      context — and the thread goes back to the queue.  ``deaths`` counts
      threads lost to failures outside any request (should stay 0) and
      ``dropped_errors`` counts exceptions that had no live future left to
      carry them (consumer cancelled first).
    """

    def __init__(
        self,
        fetch_fn: Callable,
        *,
        n_threads: int = 2,
        max_pending: int = 64,
        accountant=None,
        name: str = "kvswap-prefetch",
        obs=None,
    ):
        if n_threads < 1:
            raise ValueError("need at least one worker thread")
        if max_pending < 1:
            raise ValueError("max_pending must be >= 1")
        self._fetch_fn = fetch_fn
        self._accountant = accountant
        # observability: each worker thread records its serviced fetches as
        # wall spans on its own lane (the thread's name), which is where the
        # measured overlap — worker lanes busy under the engine lane — shows
        self._obs = obs
        self.max_pending = max_pending
        self._cv = threading.Condition()
        self._pending: dict[int, collections.deque] = {}
        self._active: set[int] = set()
        self._n_pending = 0
        self._seq = itertools.count()
        self._shutdown = False
        self.serviced = 0
        self.deaths = 0         # worker threads lost outside a request
        self.dropped_errors = 0  # failures with no live future to carry them
        self._threads = [
            threading.Thread(target=self._run, name=f"{name}-{i}", daemon=True)
            for i in range(n_threads)
        ]
        for t in self._threads:
            t.start()

    # -- producer side ----------------------------------------------------
    def submit(self, layer: int, *args, block: bool = True,
               timeout: float | None = None) -> Future:
        """Enqueue a read for ``layer``; returns a Future[PrefetchResult]."""
        fut: Future = Future()
        deadline = None if timeout is None else time.monotonic() + timeout
        with self._cv:
            if self._shutdown:
                raise RuntimeError("PrefetchWorker is shut down")
            while self._n_pending >= self.max_pending:
                if not block:
                    raise PrefetchQueueFull(
                        f"{self._n_pending} requests pending (cap {self.max_pending})")
                remaining = None if deadline is None else deadline - time.monotonic()
                if remaining is not None and remaining <= 0:
                    raise PrefetchQueueFull(f"queue still full after {timeout}s")
                self._cv.wait(timeout=remaining)
                if self._shutdown:
                    raise RuntimeError("PrefetchWorker is shut down")
            req = _Request(next(self._seq), int(layer), args, fut)
            self._pending.setdefault(req.layer, collections.deque()).append(req)
            self._n_pending += 1
            self._cv.notify_all()
        return fut

    @property
    def pending_count(self) -> int:
        with self._cv:
            return self._n_pending + len(self._active)

    # -- worker side ------------------------------------------------------
    def _pick(self) -> _Request | None:
        """Oldest pending request whose layer is idle.  Caller holds _cv."""
        best: _Request | None = None
        for layer, dq in self._pending.items():
            if not dq or layer in self._active:
                continue
            if best is None or dq[0].seq < best.seq:
                best = dq[0]
        return best

    def _run(self) -> None:
        try:
            while True:
                with self._cv:
                    req = self._pick()
                    while req is None:
                        if self._shutdown:
                            return
                        self._cv.wait()
                        req = self._pick()
                    self._pending[req.layer].popleft()
                    self._n_pending -= 1
                    self._active.add(req.layer)
                    self._cv.notify_all()
                self._serve(req)
        except BaseException:
            # nothing in _serve lets an exception out, so only queue
            # bookkeeping can land here; count the death so harnesses can
            # assert it never happens, then re-raise for the traceback
            with self._cv:
                self.deaths += 1
                self._cv.notify_all()
            raise

    def _serve(self, req: _Request) -> None:
        """Service one request.  Never raises: success and failure both
        resolve ``req.future``, and the worker thread lives on either way
        (a dead worker would silently serialize every later layer)."""
        ok = False
        try:
            if not req.future.set_running_or_notify_cancel():
                return  # consumer cancelled while queued
            obs = self._obs
            on = obs is not None and obs.enabled   # read once: a handle may be switched
            if on:
                f0 = obs.tracer.now_ns()
            t0 = time.perf_counter()
            if self._accountant is not None:
                with self._accountant.track() as tr:
                    table = self._fetch_fn(req.layer, *req.args)
                res = PrefetchResult(
                    table=table,
                    io_seconds=tr.read_seconds + tr.warm_seconds,
                    io_bytes=tr.read_bytes, io_requests=tr.read_requests,
                    wall_seconds=time.perf_counter() - t0)
            else:
                table = self._fetch_fn(req.layer, *req.args)
                res = PrefetchResult(
                    table=table, wall_seconds=time.perf_counter() - t0)
            if on:
                obs.tracer.add(
                    f"fetch L{req.layer}",
                    threading.current_thread().name, cat="prefetch",
                    wall_t0_ns=f0, wall_t1_ns=obs.tracer.now_ns(),
                    args={"layer": req.layer,
                          "modeled_io_s": res.io_seconds,
                          "read_bytes": res.io_bytes})
            req.future.set_result(res)
            ok = True
        except BaseException as exc:  # propagate to the consumer
            # surface the *original* exception (callers match on its type)
            # enriched with request context; some exception types forbid
            # new attributes, hence the guard
            try:
                exc.prefetch_layer = req.layer
                exc.prefetch_args = req.args
            except (AttributeError, TypeError):
                pass
            try:
                req.future.set_exception(exc)
            except BaseException:
                # future already cancelled/completed — the error has no
                # consumer; count it instead of killing the thread
                with self._cv:
                    self.dropped_errors += 1
        finally:
            with self._cv:
                if ok:
                    self.serviced += 1
                self._active.discard(req.layer)
                self._cv.notify_all()

    def alive_threads(self) -> int:
        """Worker threads still running (harness assertion helper)."""
        return sum(1 for t in self._threads if t.is_alive())

    # -- lifecycle --------------------------------------------------------
    def close(self, *, wait: bool = True, timeout: float = 10.0) -> None:
        """Cancel queued requests, finish in-flight ones, join the pool."""
        with self._cv:
            if self._shutdown:
                return
            self._shutdown = True
            leftovers = [r for dq in self._pending.values() for r in dq]
            self._pending.clear()
            self._n_pending = 0
            self._cv.notify_all()
        for req in leftovers:
            req.future.cancel()
        if wait:
            deadline = time.perf_counter() + timeout
            for t in self._threads:
                t.join(max(0.0, deadline - time.perf_counter()))

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


class DoubleBuffer:
    """Front/back staging of per-layer prefetch futures.

    In steady state exactly two results are live: the *front* (layer *i*'s
    table, being consumed by compute) and the *back* (layer *i+1*'s read, in
    flight).  ``stage`` files the back slot; ``take`` rotates it to the front
    when compute reaches that layer, blocking only on an I/O-bound step.
    ``depth`` guards against the engine leaking slots (a staged result that
    is never taken).
    """

    def __init__(self, depth: int = 2):
        self.depth = depth
        self._slots: dict[int, Future] = {}
        self.drained_errors = 0

    def stage(self, key: int, future: Future) -> None:
        if key in self._slots:
            raise RuntimeError(f"slot {key} already staged")
        if len(self._slots) >= self.depth:
            raise RuntimeError(
                f"double buffer over depth {self.depth}: {sorted(self._slots)}")
        self._slots[key] = future

    def take(self, key: int, timeout: float | None = None) -> PrefetchResult:
        fut = self._slots.pop(key)
        return fut.result(timeout=timeout)

    def pending(self) -> int:
        return len(self._slots)

    def drain(self) -> int:
        """Wait out / discard staged results (error-path cleanup).

        Returns how many discarded results carried an exception (also
        accumulated on ``drained_errors``) so error paths can report what
        they threw away instead of swallowing it silently.  Only
        ``Exception`` is absorbed — ``KeyboardInterrupt``/``SystemExit``
        still propagate.
        """
        errors = 0
        for key in sorted(self._slots):
            fut = self._slots.pop(key)
            if not fut.cancel():
                try:
                    fut.result()
                except Exception:
                    errors += 1
        self.drained_errors += errors
        return errors
