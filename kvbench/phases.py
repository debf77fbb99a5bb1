"""A traced run of one cell with the program's own tracer attached: every idle
nanosecond and every device operation of the window set down to the engine
phase that caused it, and the cost of that tracer.

    python3 kvbench/phases.py --workload <name> --seed <n> --seconds <s> [--cost]

runs ``kvbench/run.py``'s traced run (``--trace 1``: the harness's spans,
the profiler's device trace) with an :class:`repro_torch.obs.Observability`
handle on the session.  Before the result line it prints
``{"phases": {"idle_s", "device_s", "outside_s", "unlinked_s", ...}}``
(with the workers' ``fetch_busy_s`` and the spans' wall by name), and
the result line adds the per-layer metrics of ``kvbench/phase_metrics.json``
that apply to the cell (``metrics.<name>``, read by
``kvbench/metrics/<name>.py`` through :mod:`kvbench.phase_reduce`).  The same
traced run without the handle is ``kvbench/run.py --trace 1``.

With ``--cost`` the handle is switched on for one step of each pair of
window steps and off for the other, the one chosen by a coin drawn from the
seed, and the last line is ``{"handle_cost": ...}``: the on/off ratio of the
two steps' wall times over the window's pairs (:func:`handle_cost`).  The
steps of one pair share the host's and the disk's state of the moment,
which a pair of whole runs does not.
"""

from __future__ import annotations

import json
import math
import random
import statistics
import sys
import threading
import weakref
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
if sys.path and Path(sys.path[0]).resolve() == ROOT / "kvbench":
    sys.path.pop(0)      # the script's own directory would shadow the standard library
for p in (ROOT / "src", ROOT):
    if str(p) not in sys.path:
        sys.path.insert(0, str(p))


def phase_metrics(man: dict, cell: str) -> list[dict]:
    """The entries of ``kvbench/phase_metrics.json`` that apply to ``cell``,
    chosen as ``BENCHMARK.json``'s per-layer metrics are."""
    from kvbench import bench

    extra = json.loads((Path(__file__).resolve().parent / "phase_metrics.json").read_text())
    return bench.metrics_for({**man, "per_layer": extra}, cell, True)


def run(name: str, seed: int, seconds: float, *, device: str = "cuda", root: Path = ROOT,
        emit=print) -> dict:
    """``run.run_cell(name, seed, seconds, trace=True)`` with a tracer on
    the session; returns the result line's object."""
    import repro_torch.serving as serving
    from kvbench import bench, devtrace
    from kvbench import run as harness
    from kvbench.phase_reduce import (main_spans, profiler_events, reduce_phases, reuse_counts,
                                      span_wall, worker_seconds)
    from repro_torch.obs import Observability

    obs = Observability()
    if not hasattr(obs.tracer, "phase"):
        raise RuntimeError("this program's tracer records no phase spans: nothing to split")
    thread = threading.get_ident()
    state: dict = {}
    saved = (serving.ServeSession, devtrace.LaunchCapture, devtrace.device_events,
             devtrace.reduce, bench.read_metrics)
    Session, Capture, device_events, reduce, read_metrics = saved

    class TracedSession(Session):
        def __init__(self, *args, **kwargs):
            super().__init__(*args, **{**kwargs, "obs": obs})
            state["session"] = weakref.ref(self)

    class WindowCapture(Capture):
        # entered just before the window's first step, left after its last
        def __enter__(self):
            state["reuse0"] = reuse_counts(state["session"]().engine)
            return super().__enter__()

        def __exit__(self, *exc):
            state["reuse1"] = reuse_counts(state["session"]().engine)
            return super().__exit__(*exc)

    def keep_events(prof):
        state["prof"] = prof
        return device_events(prof)

    def keep_window(events, spans, t0, t1):
        state["window"] = (t0, t1)
        return reduce(events, spans, t0, t1)

    def read_with_phases(metrics, rec):
        t0, t1 = state["window"]
        (h0, m0), (h1, m1) = state["reuse0"], state["reuse1"]
        rec["reuse"] = {"hits": h1 - h0, "misses": m1 - m0}
        ops, launches, names = (profiler_events(state.pop("prof")) if state.get("prof")
                                else ([], {}, {}))
        ph = reduce_phases(main_spans(obs.tracer, thread), ops, launches, t0, t1)
        ph["fetch_busy_s"] = worker_seconds(obs.tracer, thread, t0, t1)
        ph["span_wall_s"] = span_wall(obs.tracer, thread, t0, t1)
        ph["launch_events"] = names
        ph["spans"] = len(obs.tracer)
        rec["phases"] = ph
        emit(json.dumps({"phases": ph}))
        return read_metrics(metrics + phase_metrics(bench.load_manifest(root), name), rec)

    serving.ServeSession = TracedSession
    devtrace.LaunchCapture = WindowCapture
    devtrace.device_events = keep_events
    devtrace.reduce = keep_window
    bench.read_metrics = read_with_phases
    try:
        return harness.run_cell(name, seed, seconds, True, device=device, root=root, emit=emit)
    finally:
        (serving.ServeSession, devtrace.LaunchCapture, devtrace.device_events,
         devtrace.reduce, bench.read_metrics) = saved


def handle_cost(name: str, seed: int, seconds: float, *, device: str = "cuda",
                root: Path = ROOT, emit=print) -> dict:
    """``run.run_cell(name, seed, seconds, trace=True)`` with a tracer on
    the session that is on for one step of each pair ``(2p, 2p + 1)`` of
    the session's steps and off for the other, the one chosen by a coin of
    ``random.Random(seed)``.  Returns (and emits as ``{"handle_cost": ...}``)
    the window's whole pairs: their count, the quartiles of the on/off
    ratio of each pair's step walls and the 95 % interval of its median."""
    import repro_torch.serving as serving
    from kvbench import devtrace
    from kvbench import run as harness
    from repro_torch.obs import Observability

    obs = Observability()
    coin = random.Random(seed)
    first_on: list[bool] = []     # a pair's draw
    on_at: list[bool] = []        # each step of the session: was the handle on
    window: list[int] = []        # the steps at the window's start and end
    lines: list[str] = []
    saved = serving.ServeSession, devtrace.LaunchCapture
    Session, Capture = saved

    class Switched(Session):
        def __init__(self, *args, **kwargs):
            super().__init__(*args, **{**kwargs, "obs": obs})
            # the I/O accountant's counters, bound to the handle's registry
            # when the engine is built, are the handle's cost too
            self._counters = self.engine.accountant._metrics

        def step(self):
            k = len(on_at)
            if k % 2 == 0:
                first_on.append(coin.random() < 0.5)
            on = first_on[-1] == (k % 2 == 0)
            obs.enabled = obs.tracer.enabled = on
            self.engine.accountant._metrics = self._counters if on else None
            on_at.append(on)
            return super().step()

    class WindowCapture(Capture):
        def __enter__(self):
            window.append(len(on_at))
            return super().__enter__()

        def __exit__(self, *exc):
            window.append(len(on_at))
            return super().__exit__(*exc)

    def keep(line):
        lines.append(line)
        emit(line)

    serving.ServeSession, devtrace.LaunchCapture = Switched, WindowCapture
    try:
        harness.run_cell(name, seed, seconds, True, device=device, root=root, emit=keep)
    finally:
        serving.ServeSession, devtrace.LaunchCapture = saved
    walls = next(json.loads(x)["window"]["step_ms"] for x in lines if x.startswith('{"window"'))
    k0, k1 = window
    if k1 - k0 != len(walls):
        raise RuntimeError(f"{len(walls)} window steps timed, {k1 - k0} stepped")
    pairs = []
    for p in range((k0 + 1) // 2, k1 // 2):
        a, b = 2 * p, 2 * p + 1
        on, off = (a, b) if on_at[a] else (b, a)
        pairs.append((walls[on - k0], walls[off - k0]))
    ratios = sorted(on / off for on, off in pairs)
    n = len(ratios)
    q1, q2, q3 = statistics.quantiles(ratios, n=4) if n > 1 else ratios * 3
    # the coin makes each pair's ratio an unbiased draw; the median's 95 %
    # interval by order statistics holds whatever the host's stalls do to
    # a few pairs, which swing a mean or a sum
    h = 0.98 * n ** 0.5
    ci = [ratios[max(0, math.floor(n / 2 - h))], ratios[min(n - 1, math.ceil(n / 2 + h))]]
    out = {"pairs": n, "ratio_q1": q1, "ratio_median": q2, "ratio_q3": q3,
           "ratio_median_ci95": ci,
           "on_step_ms_median": statistics.median(on for on, _ in pairs),
           "off_step_ms_median": statistics.median(off for _, off in pairs)}
    emit(json.dumps({"handle_cost": out}))
    return out


def main(argv: list[str] | None = None) -> int:
    import argparse

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--cost", action="store_true",
                    help="switch the tracer on and off on alternate steps and time it")
    args = ap.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("this run needs a CUDA device", file=sys.stderr)
        return 2
    if args.cost:
        handle_cost(args.workload, args.seed, args.seconds)
        return 0
    out = run(args.workload, args.seed, args.seconds)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
