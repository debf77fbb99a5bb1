"""The split of a traced window by the port's engine phases: every idle
nanosecond and every device operation set down to the main thread's phase
span that caused it.

The program's wall spans (``repro_torch.obs.SpanTracer``) and the profiler's
events share one clock, ``time.time_ns()``.  Only the main thread's spans (the
one that steps the session) take idle or device time; the prefetch workers'
``fetch`` spans are summed apart (:func:`worker_seconds`).  A phase is a span's
``cat``; :data:`GROUPS` sums the phases into the per-layer metrics, and a
phase in no group is reported (``unassigned``) and refused by
:func:`per_step_ms`, so that a renamed or new phase cannot drop out of the
metrics unseen.
"""

from __future__ import annotations

import bisect

OUTSIDE = "outside"      # idle, or a launch, while the main thread had no span open
UNLINKED = "unlinked"    # a device operation whose launch was not found

# the phases (a span's ``cat``) each per-layer metric sums
GROUPS = {
    "predictor": ("predict", "readback", "quality"),
    "fetch": ("fetch", "wait", "upload", "spill", "flush", "prefix"),
    "block": ("embed", "gather", "block", "tail", "logits"),
    "session": ("serve.step", "serve.admit", "serve.sample", "serve.logits_wait", "decode",
                "stats", "admission"),
}
GROUPED = frozenset(c for cats in GROUPS.values() for c in cats)


def main_spans(tracer, thread: int) -> list[tuple[str, int, int]]:
    """``(cat, t0_ns, t1_ns)`` of the wall spans ``thread`` recorded, but
    the requests' lifecycles, which span many steps and nest in none."""
    return [(s.cat, s.wall_t0_ns, s.wall_t1_ns) for s in tracer.spans()
            if s.thread == thread and s.wall_t0_ns is not None and not s.instant
            and s.cat != "request"]


def _change_points(spans: list[tuple[str, int, int]]) -> tuple[list[int], list[str]]:
    """From ``times[i]`` on, ``labels[i]`` is the innermost span open (spans
    of one thread nest; a child's end is clamped to its parent's)."""
    times: list[int] = []
    labels: list[str] = []
    stack: list[tuple[int, str]] = []

    def close_until(t: int) -> None:
        while stack and stack[-1][0] <= t:
            end, _ = stack.pop()
            times.append(end)
            labels.append(stack[-1][1] if stack else OUTSIDE)

    for cat, s, e in sorted(spans, key=lambda x: (x[1], -x[2])):
        close_until(s)
        e = max(s, min(e, stack[-1][0]) if stack else e)
        stack.append((e, cat))
        times.append(s)
        labels.append(cat)
    close_until(float("inf"))
    return times, labels


def reduce_phases(spans: list[tuple[str, int, int]], ops: list[tuple[str, int, int, int]],
                  launches: dict[int, int], t0: int, t1: int) -> dict:
    """Idle and device time of the window ``[t0, t1]`` by phase.

    ``spans``: the main thread's ``(cat, start, end)``; ``ops``: the device's
    ``(name, start, end, correlation id)``; ``launches``: correlation id ->
    the host time of the runtime call that launched it.  Every idle
    nanosecond goes to the innermost span open at that instant (``outside``
    when none is); each operation's time inside the window to the innermost
    span open at its launch (``unlinked`` when no launch matches).
    ``unassigned`` names the phases that took time and are in no group of
    :data:`GROUPS`; ``unassigned_s`` is their idle time."""
    times, labels = _change_points(spans)

    def label_at(t: int) -> str:
        i = bisect.bisect_right(times, t) - 1
        return labels[i] if i >= 0 else OUTSIDE

    device: dict[str, int] = {}
    busy, reach, gaps = 0, t0, []
    for _, s, e, corr in sorted(ops, key=lambda x: x[1]):
        s, e = max(s, t0), min(e, t1)
        if e <= s:
            continue
        at = launches.get(corr)
        key = UNLINKED if at is None else label_at(at)
        device[key] = device.get(key, 0) + (e - s)
        if s > reach:
            gaps.append((reach, s))
        busy += max(0, e - max(s, reach))
        reach = max(reach, e)
    if t1 > reach:
        gaps.append((reach, t1))
    idle: dict[str, int] = {}
    for g0, g1 in gaps:
        i = bisect.bisect_right(times, g0) - 1
        t = g0
        while t < g1:
            nxt = times[i + 1] if i + 1 < len(times) else g1
            end = min(max(nxt, t), g1)
            key = labels[i] if i >= 0 else OUTSIDE
            idle[key] = idle.get(key, 0) + (end - t)
            t, i = end, i + 1
    stray = sorted((set(idle) | set(device)) - GROUPED - {OUTSIDE, UNLINKED})
    return {"idle_s": {k: v / 1e9 for k, v in idle.items()},
            "device_s": {k: v / 1e9 for k, v in device.items()},
            "outside_s": idle.get(OUTSIDE, 0) / 1e9, "unlinked_s": device.get(UNLINKED, 0) / 1e9,
            "unassigned": stray, "unassigned_s": sum(idle.get(k, 0) for k in stray) / 1e9,
            "busy_s": busy / 1e9, "window_s": (t1 - t0) / 1e9}


def profiler_events(prof) -> tuple[list[tuple[str, int, int, int]], dict[int, int], dict]:
    """The device's operations ``(name, start, end, correlation id)``, the
    host start of each launching runtime call by correlation id, and how
    many host-side events of each name carried one."""
    from torch.autograd import DeviceType

    ops, launches, names = [], {}, {}
    for ev in prof.profiler.kineto_results.events():
        if ev.device_type() == DeviceType.CUDA:
            start = ev.start_ns()
            ops.append((ev.name(), start, start + ev.duration_ns(), ev.correlation_id()))
        elif ev.name().startswith("cu") and ev.correlation_id():
            # the CUDA API's calls (cudaLaunchKernel, cudaMemcpyAsync,
            # cuLaunchKernel, ...), not the framework's ops
            launches.setdefault(ev.correlation_id(), ev.start_ns())
            names[ev.name()] = names.get(ev.name(), 0) + 1
    return ops, launches, names


def worker_seconds(tracer, thread: int, t0: int, t1: int) -> float | None:
    """Summed wall of the prefetch workers' ``fetch`` spans inside the
    window, or ``None`` where no worker ran (a synchronous engine)."""
    got = [(s.wall_t0_ns, s.wall_t1_ns) for s in tracer.spans()
           if s.cat == "prefetch" and s.thread != thread and s.wall_t0_ns is not None]
    if not got:
        return None
    return sum(max(0, min(e, t1) - max(s, t0)) for s, e in got) / 1e9


def span_wall(tracer, thread: int, t0: int, t1: int) -> dict[str, float]:
    """Summed wall of the main thread's spans inside the window by name,
    the layer index dropped (nested spans counted in their parents too):
    ``upload`` (the reuse mirror's scatter) apart from ``staged`` (the
    groups the full reuse buffer could not take), which share a phase."""
    out: dict[str, float] = {}
    for sp in tracer.spans():
        if sp.thread != thread or sp.wall_t0_ns is None or sp.cat == "request":
            continue
        dt = min(sp.wall_t1_ns, t1) - max(sp.wall_t0_ns, t0)
        if dt > 0:
            key = sp.name.split(" ")[0]
            out[key] = out.get(key, 0.0) + dt / 1e9
    return out


def reuse_counts(engine) -> tuple[int, int]:
    """Reuse-buffer hits and misses so far, summed over the KV layers."""
    return (sum(r.stats.hits for r in engine.reuse), sum(r.stats.misses for r in engine.reuse))


def per_step_ms(rec: dict, group: str, key: str = "idle_s") -> float | None:
    """A group's idle (or device) time a decode step of the window, in ms;
    ``None`` off the card or without a phase split.  Raises where a phase
    took time that no group sums."""
    ph = rec.get("phases")
    steps = len(rec["step_wall_s"])
    if not (rec["on_card"] and ph and steps):
        return None
    if ph["unassigned"]:
        raise ValueError(f"phases in no group of GROUPS: {ph['unassigned']}")
    return 1e3 * sum(ph[key].get(cat, 0.0) for cat in GROUPS[group]) / steps
