"""Dual-clock span tracer with Chrome/Perfetto ``trace_event`` export.

Every span carries up to two placements:

* **wall clock** — measured ``time.time_ns()`` readings, kept in absolute
  nanoseconds: the clock ``torch.profiler`` stamps device events with, so a
  span can be set against the device's busy and idle time.  The export
  places them relative to the tracer's birth.  This is where the async
  pipeline's *actual* overlap shows: prefetch-worker lanes busy while the
  engine lane computes.  Each span records the thread that took it.
* **modeled clock** — the DiskSpec/ComputeSpec clock the repo's latency
  claims are made on (the same clock :class:`~repro.serving.api.
  ServeSession` schedules with).  This is where the *paper's* overlap
  shows: per-layer modeled I/O bars hiding under the previous layer's
  compute bar, request lifecycles spanning queued→finished.

The two clocks export as two Perfetto **processes** (pid 1 "wall clock",
pid 2 "modeled clock"); tracks within each are threads, named by ``"M"``
metadata events.  A span placed on both clocks emits one ``"X"`` complete
event per clock.  Open ``chrome://tracing`` or https://ui.perfetto.dev and
load the exported JSON.

Recording is append-to-list (worker threads record their own fetch spans;
a phase span, the engine's hot path, is appended as a bare tuple and made a
:class:`Span` when read), with timestamps resolved by the caller — the
tracer never invents time, so modeled spans are exactly as deterministic as
the modeled clock that produced them.  A wall span takes its start reading where its
work starts (:meth:`SpanTracer.now_ns`) and is closed by
:meth:`SpanTracer.phase`, which reads the end.
"""

from __future__ import annotations

import dataclasses
import json
import threading
import time

__all__ = ["Span", "SpanTracer", "WALL_PID", "MODEL_PID",
           "validate_trace_events"]

WALL_PID = 1
MODEL_PID = 2
_PROCESS_NAMES = {WALL_PID: "wall clock", MODEL_PID: "modeled clock"}


@dataclasses.dataclass(slots=True)
class Span:
    """One recorded operation.  ``None`` start means "not on that clock"."""

    name: str
    track: str                       # lane (Perfetto thread) within a clock
    cat: str = ""                    # category filter string
    wall_t0_ns: int | None = None    # time.time_ns() at the start
    wall_t1_ns: int = 0              # time.time_ns() at the end
    model_t0: float | None = None    # modeled seconds since engine start
    model_dur: float = 0.0
    args: dict | None = None
    instant: bool = False            # zero-duration marker ("i" event)
    thread: int = 0                  # threading.get_ident() of the recorder


class SpanTracer:
    """Thread-safe span recorder.  ``enabled=False`` turns every method into
    an early-out; the engine additionally guards hot call sites so the
    disabled path does not even build the argument tuples."""

    def __init__(self, enabled: bool = True):
        self.enabled = enabled
        self._lock = threading.Lock()
        self._spans: list[Span | tuple] = []
        self.birth_ns = time.time_ns()

    # -- recording --------------------------------------------------------
    @staticmethod
    def now_ns() -> int:
        """A wall reading: ``time.time_ns()``, the profiler's clock."""
        return time.time_ns()

    def add(self, name: str, track: str, *, cat: str = "",
            wall_t0_ns: int | None = None, wall_t1_ns: int | None = None,
            model_t0: float | None = None, model_dur: float = 0.0,
            args: dict | None = None, instant: bool = False) -> None:
        """Record one pre-timed span: its wall readings (``wall_t1_ns``
        defaults to the start, an instant's) and its modeled placement."""
        if not self.enabled:
            return
        sp = Span(name, track, cat, wall_t0_ns,
                  wall_t0_ns if wall_t1_ns is None else wall_t1_ns,
                  model_t0, model_dur, args, instant, threading.get_ident())
        with self._lock:
            self._spans.append(sp)

    def phase(self, cat: str, name: str, t0_ns: int, args: dict | None = None) -> int:
        """Close the wall span ``name`` of phase ``cat`` (its lane) opened
        by the ``t0_ns`` reading; returns the end reading, which a caller
        may take as the next span's start.  Call sites guard on
        ``obs.enabled``; a disabled tracer records nothing all the same."""
        t1 = time.time_ns()
        if self.enabled:
            # one tuple and no lock: list.append is atomic, and a phase
            # span costs the step a few microseconds, hundreds of times
            self._spans.append((name, cat, t0_ns, t1, args, threading.get_ident()))
        return t1

    def wall_span(self, name: str, track: str, *, cat: str = "",
                  args: dict | None = None) -> "_WallScope":
        """``with tracer.wall_span(...)`` measures the body on the wall
        clock.  Only enter this under an ``if tracer.enabled`` guard."""
        return _WallScope(self, name, track, cat, args)

    def __len__(self) -> int:
        with self._lock:
            return len(self._spans)

    def spans(self) -> list[Span]:
        with self._lock:
            got = list(self._spans)
        return [sp if type(sp) is Span else
                Span(sp[0], sp[1], sp[1], sp[2], sp[3], None, 0.0, sp[4], False, sp[5])
                for sp in got]

    def clear(self) -> None:
        with self._lock:
            self._spans.clear()

    # -- Perfetto export --------------------------------------------------
    def to_trace_events(self) -> list[dict]:
        """Chrome ``trace_event`` list: ``"M"`` metadata naming processes
        and tracks, then one ``"X"``/``"i"`` event per span per clock.
        Timestamps are microseconds (the format's unit)."""
        spans = self.spans()
        # stable tid assignment: tracks in first-appearance order per clock
        tids: dict[tuple[int, str], int] = {}

        def tid_of(pid: int, track: str) -> int:
            key = (pid, track)
            if key not in tids:
                tids[key] = sum(1 for k in tids if k[0] == pid) + 1
            return tids[key]

        events: list[dict] = []
        for sp in spans:
            wall = (None if sp.wall_t0_ns is None else
                    (max(sp.wall_t0_ns - self.birth_ns, 0) / 1e3,
                     max(sp.wall_t1_ns - sp.wall_t0_ns, 0) / 1e3))
            model = (None if sp.model_t0 is None else
                     (sp.model_t0 * 1e6, max(sp.model_dur, 0.0) * 1e6))
            for pid, at in ((WALL_PID, wall), (MODEL_PID, model)):
                if at is None:
                    continue
                ev = {"name": sp.name, "cat": sp.cat or "kvswap",
                      "pid": pid, "tid": tid_of(pid, sp.track),
                      "ts": round(at[0], 3)}
                if sp.instant:
                    ev["ph"] = "i"
                    ev["s"] = "t"       # thread-scoped instant
                else:
                    ev["ph"] = "X"
                    ev["dur"] = round(at[1], 3)
                if sp.args:
                    ev["args"] = sp.args
                events.append(ev)
        meta: list[dict] = []
        for pid in sorted({k[0] for k in tids}):
            meta.append({"name": "process_name", "ph": "M", "pid": pid,
                         "tid": 0, "args": {"name": _PROCESS_NAMES[pid]}})
        for (pid, track), tid in sorted(tids.items(), key=lambda kv: kv[1]):
            meta.append({"name": "thread_name", "ph": "M", "pid": pid,
                         "tid": tid, "args": {"name": track}})
        return meta + events

    def export(self, path) -> dict:
        """Write ``{"traceEvents": [...], ...}`` JSON to ``path`` and return
        the object (Perfetto and chrome://tracing both load this shape)."""
        obj = {"traceEvents": self.to_trace_events(),
               "displayTimeUnit": "ms",
               "otherData": {"exporter": "repro.obs", "clockUnit": "us"}}
        with open(path, "w") as f:
            json.dump(obj, f, indent=1)
        return obj


class _WallScope:
    __slots__ = ("_tracer", "_name", "_track", "_cat", "args", "_t0")

    def __init__(self, tracer, name, track, cat, args):
        self._tracer = tracer
        self._name = name
        self._track = track
        self._cat = cat
        self.args = dict(args) if args else {}

    def __enter__(self):
        self._t0 = time.time_ns()
        return self

    def __exit__(self, *exc):
        self._tracer.add(self._name, self._track, cat=self._cat,
                         wall_t0_ns=self._t0, wall_t1_ns=time.time_ns(),
                         args=self.args or None)


def validate_trace_events(obj) -> dict:
    """Schema-check a Perfetto ``trace_event`` export.

    Accepts the ``{"traceEvents": [...]}`` object form or a bare event
    list.  Raises ``ValueError`` on the first violation; on success returns
    ``{"events": N, "tracks": {(pid, tid) name, ...}, "processes": {...}}``
    so tests (and ``repro.obs.report --check``) can assert lane coverage.
    """
    if isinstance(obj, dict):
        events = obj.get("traceEvents")
        if not isinstance(events, list):
            raise ValueError("missing traceEvents list")
    elif isinstance(obj, list):
        events = obj
    else:
        raise ValueError(f"expected dict or list, got {type(obj).__name__}")
    processes: dict[int, str] = {}
    tracks: dict[tuple[int, int], str] = {}
    n_x = 0
    for i, ev in enumerate(events):
        where = f"event {i}"
        if not isinstance(ev, dict):
            raise ValueError(f"{where}: not an object")
        ph = ev.get("ph")
        if ph not in ("X", "i", "M", "B", "E", "C"):
            raise ValueError(f"{where}: bad ph {ph!r}")
        for key in ("pid", "tid"):
            if not isinstance(ev.get(key), int):
                raise ValueError(f"{where}: {key} must be an int")
        if ph == "M":
            name = ev.get("name")
            if name not in ("process_name", "thread_name"):
                raise ValueError(f"{where}: bad metadata name {name!r}")
            label = (ev.get("args") or {}).get("name")
            if not isinstance(label, str) or not label:
                raise ValueError(f"{where}: metadata needs args.name")
            if name == "process_name":
                processes[ev["pid"]] = label
            else:
                tracks[(ev["pid"], ev["tid"])] = label
            continue
        if not isinstance(ev.get("name"), str) or not ev["name"]:
            raise ValueError(f"{where}: missing name")
        ts = ev.get("ts")
        if not isinstance(ts, (int, float)) or ts < 0:
            raise ValueError(f"{where}: ts must be a number >= 0")
        if ph == "X":
            dur = ev.get("dur")
            if not isinstance(dur, (int, float)) or dur < 0:
                raise ValueError(f"{where}: X event needs dur >= 0")
            n_x += 1
            if (ev["pid"], ev["tid"]) not in tracks:
                raise ValueError(
                    f"{where}: track ({ev['pid']}, {ev['tid']}) has no "
                    "thread_name metadata")
    if not n_x:
        raise ValueError("trace has no complete (X) events")
    return {"events": len(events), "complete_events": n_x,
            "processes": processes,
            "tracks": {f"{pid}:{tid}": name
                       for (pid, tid), name in sorted(tracks.items())}}
