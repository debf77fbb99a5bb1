"""Render an exported Perfetto trace into latency-breakdown tables.

The port of :mod:`repro.obs.report`: the same tables, over the port's
:mod:`repro_torch.obs.span` schema, which is the reference's.  Only the
program name differs.

The benchmarks hand-roll per-step latency tables from ``overlap_report``;
this CLI derives the same breakdown from a trace file instead, so any
exported run — benchmark, test, or ad-hoc session — can be inspected
without rerunning it::

    PYTHONPATH=src python -m repro_torch.obs.report trace.json
    PYTHONPATH=src python -m repro_torch.obs.report trace.json --check

``--check`` only validates the trace_event schema (the same
:func:`repro_torch.obs.validate_trace_events` helper the tests use) and exits
non-zero on a malformed file — CI runs this against the trace artifact it
uploads.

Tables: per-track span totals (count / total / mean / p50 / p95) for each
clock, plus a modeled compute-vs-IO overlap summary when the engine lanes
are present (busy seconds per lane vs the engine-step lane's span —
the trace-level view of ``overlap_saved_seconds``).
"""

from __future__ import annotations

import argparse
import json
import sys
from collections import defaultdict

from repro_torch.obs.span import MODEL_PID, WALL_PID, validate_trace_events
from repro_torch.utils import stats as stats_util

__all__ = ["load_trace", "track_table", "overlap_summary", "main"]


def load_trace(path) -> dict:
    with open(path) as f:
        return json.load(f)


def _events(obj) -> list[dict]:
    return obj["traceEvents"] if isinstance(obj, dict) else obj


def _track_names(events) -> dict[tuple[int, int], str]:
    names = {}
    for ev in events:
        if ev.get("ph") == "M" and ev.get("name") == "thread_name":
            names[(ev["pid"], ev["tid"])] = ev["args"]["name"]
    return names


def track_table(obj, pid: int) -> list[dict]:
    """Per-track span statistics for one clock (``pid``), sorted by total
    busy time descending.  Durations come back in seconds."""
    events = _events(obj)
    names = _track_names(events)
    durs: dict[tuple[int, int], list[float]] = defaultdict(list)
    for ev in events:
        if ev.get("ph") == "X" and ev["pid"] == pid:
            durs[(ev["pid"], ev["tid"])].append(ev["dur"] / 1e6)
    rows = []
    for key, xs in durs.items():
        pct = stats_util.percentiles(xs, (50.0, 95.0))
        rows.append({
            "track": names.get(key, f"tid{key[1]}"),
            "spans": len(xs),
            "total_s": sum(xs),
            "mean_ms": sum(xs) / len(xs) * 1e3,
            "p50_ms": pct["p50"] * 1e3,
            "p95_ms": pct["p95"] * 1e3,
        })
    rows.sort(key=lambda r: -r["total_s"])
    return rows


def overlap_summary(obj) -> dict | None:
    """Modeled compute/IO overlap from the engine lanes, when present:
    ``saved = compute_busy + io_busy - step_busy`` — the per-trace view of
    ``StepStats.overlap_saved_seconds`` summed over steps."""
    rows = {r["track"]: r for r in track_table(obj, MODEL_PID)}
    step = rows.get("engine-step")
    comp = rows.get("compute")
    io = rows.get("io")
    if step is None or comp is None:
        return None
    io_s = io["total_s"] if io else 0.0
    # admission spans share the engine-step lane; exclude them by name is
    # not possible at table granularity, so derive from decode spans only
    events = _events(obj)
    names = _track_names(events)
    decode = [ev["dur"] / 1e6 for ev in events
              if ev.get("ph") == "X" and ev["pid"] == MODEL_PID
              and names.get((ev["pid"], ev["tid"])) == "engine-step"
              and ev["name"] == "decode_step"]
    decode_s = sum(decode)
    return {
        "decode_steps": len(decode),
        "decode_s": decode_s,
        "compute_s": comp["total_s"],
        "io_s": io_s,
        "overlap_saved_s": max(0.0, comp["total_s"] + io_s - decode_s),
    }


def _print_table(title: str, rows: list[dict]) -> None:
    print(f"\n== {title} ==")
    if not rows:
        print("(no spans)")
        return
    hdr = (f"{'track':24s} {'spans':>6s} {'total_s':>10s} {'mean_ms':>9s} "
           f"{'p50_ms':>9s} {'p95_ms':>9s}")
    print(hdr)
    for r in rows:
        print(f"{r['track']:24s} {r['spans']:6d} {r['total_s']:10.6f} "
              f"{r['mean_ms']:9.3f} {r['p50_ms']:9.3f} {r['p95_ms']:9.3f}")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="repro_torch.obs.report",
        description="latency-breakdown tables from a Perfetto trace export")
    ap.add_argument("trace", help="trace_event JSON file (repro_torch.obs export)")
    ap.add_argument("--check", action="store_true",
                    help="validate the schema only; exit non-zero if bad")
    args = ap.parse_args(argv)
    obj = load_trace(args.trace)
    try:
        info = validate_trace_events(obj)
    except ValueError as exc:
        print(f"INVALID trace: {exc}", file=sys.stderr)
        return 1
    if args.check:
        print(f"OK: {info['complete_events']} spans on "
              f"{len(info['tracks'])} tracks "
              f"({', '.join(sorted(set(info['tracks'].values())))})")
        return 0
    print(f"{args.trace}: {info['events']} events, "
          f"{len(info['tracks'])} tracks, "
          f"processes={list(info['processes'].values())}")
    _print_table("wall clock (measured)", track_table(obj, WALL_PID))
    _print_table("modeled clock (DiskSpec + ComputeSpec)",
                 track_table(obj, MODEL_PID))
    ov = overlap_summary(obj)
    if ov is not None:
        print("\n== modeled overlap ==")
        print(f"decode steps        {ov['decode_steps']}")
        print(f"decode (pipelined)  {ov['decode_s']:.6f} s")
        print(f"compute lane busy   {ov['compute_s']:.6f} s")
        print(f"io lane busy        {ov['io_s']:.6f} s")
        print(f"overlap saved       {ov['overlap_saved_s']:.6f} s")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
