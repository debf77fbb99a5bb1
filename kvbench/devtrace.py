"""What a traced run (``--trace 1``) records besides the clock: the harness's
own host spans around its calls into the program's layers, the arguments
of each launch of the decode path's two kernels, and the profiler's device
trace of the window.  The per-layer readers (``kvbench/metrics``) reduce
them.

Host spans and device events share one clock: the profiler gives each
event's start in nanoseconds of ``time.time_ns()``, and the spans are taken
with it.
"""

from __future__ import annotations

import time

import torch

from kvbench import roofline

# the kernels whose launches are captured: name in the program's ``ops``
# module, the substring of their device name in the trace
KERNELS = {"lowrank_group_scores": "lowrank_group_scores", "gather_attention": "gather_attention"}


class Spans:
    """Host spans ``(name, t0_ns, t1_ns)`` around calls the harness wraps."""

    def __init__(self):
        self.items: list[tuple[str, int, int]] = []
        self._undo: list = []

    def add(self, name: str, t0: int, t1: int) -> None:
        self.items.append((name, t0, t1))

    def wrap(self, obj, attr: str, name: str) -> None:
        """Time every call of ``obj.attr`` (an instance attribute shadows
        the method, and is deleted again by :meth:`restore`)."""
        fn = getattr(obj, attr, None)
        if fn is None:
            return

        def call(*args, **kwargs):
            t0 = time.time_ns()
            try:
                return fn(*args, **kwargs)
            finally:
                self.items.append((name, t0, time.time_ns()))

        setattr(obj, attr, call)
        self._undo.append(lambda: delattr(obj, attr))

    def restore(self) -> None:
        while self._undo:
            self._undo.pop()()


class LaunchCapture:
    """Each call of the program's kernel wrappers (``ops.<name>``) with the
    tensors that fix its work, kept until the window closes (the wrapper
    replaces the module attribute that callers look up at call time)."""

    def __init__(self):
        self.calls: dict[str, list] = {name: [] for name in KERNELS}
        self._saved: dict = {}

    def __enter__(self):
        from repro_torch.kernels import ops

        self._ops = ops
        for name in KERNELS:
            fn = getattr(ops, name, None)
            if fn is None:
                continue
            self._saved[name] = fn
            log = self.calls[name]

            def call(*args, _fn=fn, _log=log, **kwargs):
                # shapes, and the one small tensor the work depends on (the
                # valid lengths, the mask): nothing that holds the KV alive
                _log.append(([tuple(a.shape) for a in args[:3]], args[3 if len(args) > 3 else 2],
                             kwargs.get("group_size")))
                return _fn(*args, **kwargs)

            call.launches = getattr(fn, "launches", 0)
            setattr(ops, name, call)
        return self

    def __exit__(self, *exc):
        for name, fn in self._saved.items():
            fn.launches = getattr(getattr(self._ops, name), "launches", fn.launches)
            setattr(self._ops, name, fn)
        return False

    def work(self) -> dict:
        """Per kernel: launches, summed roofline bound (s), and for kernel B
        the unmasked tokens over all launches (rows summed)."""
        out = {}
        calls = self.calls["lowrank_group_scores"]
        if calls:
            ((b, h, r), (_, n, _), _), _, g = calls[0]
            vl = torch.stack([c[1] for c in calls]).clamp(max=n).sum(dim=1).tolist()
            bound = sum(roofline.bound_seconds(*roofline.lowrank_scores_work(b, h, r, n, g, int(v)))
                        for v in vl)
            out["lowrank_group_scores"] = {"launches": len(calls), "bound_s": bound}
        calls = self.calls["gather_attention"]
        if calls:
            by_shape: dict = {}
            for (q_shape, k_shape, _), mask, _ in calls:
                by_shape.setdefault((q_shape, k_shape), []).append(mask)
            bound, flops = 0.0, 0
            for ((b, h, d), (_, s, hk, _)), masks in by_shape.items():
                for n_tok in torch.stack(masks).sum(dim=(1, 2)).tolist():
                    bound += roofline.bound_seconds(
                        *roofline.gather_attention_work(b, h, hk, d, s, int(n_tok)))
                    flops += roofline.attention_flops(int(n_tok), h, d)
            out["gather_attention"] = {"launches": len(calls), "bound_s": bound,
                                       "attention_flops": flops}
        return out


def device_events(prof) -> list[tuple[str, int, int]]:
    """``(name, start_ns, end_ns)`` of every operation the device ran."""
    from torch.autograd import DeviceType

    out = []
    for ev in prof.profiler.kineto_results.events():
        if ev.device_type() == DeviceType.CUDA:
            start = ev.start_ns()
            out.append((ev.name(), start, start + ev.duration_ns()))
    return out


def reduce(events: list[tuple[str, int, int]], spans: list[tuple[str, int, int]],
           t0: int, t1: int) -> dict:
    """Busy time (the union of the device's operations inside ``[t0, t1]``),
    device time by operation name, and idle time by the innermost harness
    span open at each idle gap's midpoint."""
    by_name: dict[str, int] = {}
    busy, reach = 0, t0
    gaps = []
    for name, s, e in sorted(events, key=lambda x: x[1]):
        s, e = max(s, t0), min(e, t1)
        if e <= s:
            continue
        by_name[name] = by_name.get(name, 0) + (e - s)
        if s > reach:
            gaps.append((reach, s))
        busy += max(0, e - max(s, reach))
        reach = max(reach, e)
    if t1 > reach:
        gaps.append((reach, t1))
    # spans nest (one host thread makes the wrapped calls): sweep the gaps in
    # time order with a stack of open spans, whose top is the innermost
    ordered = sorted(spans, key=lambda x: x[1])
    idle: dict[str, int] = {}
    stack: list = []
    i = 0
    for g0, g1 in gaps:
        mid = (g0 + g1) // 2
        while i < len(ordered) and ordered[i][1] <= mid:
            while stack and stack[-1][2] < ordered[i][1]:
                stack.pop()
            stack.append(ordered[i])
            i += 1
        while stack and stack[-1][2] < mid:
            stack.pop()
        name = stack[-1][0] if stack else "harness"
        idle[name] = idle.get(name, 0) + (g1 - g0)
    return {"busy_s": busy / 1e9, "window_s": (t1 - t0) / 1e9,
            "ops_s": {k: v / 1e9 for k, v in by_name.items()},
            "idle_s": {k: v / 1e9 for k, v in idle.items()}}


def kernel_device_seconds(ops_s: dict[str, float]) -> dict[str, float]:
    return {k: sum(t for name, t in ops_s.items() if sub in name) for k, sub in KERNELS.items()}


def top(d: dict[str, float], n: int = 10) -> list:
    return [[k[:160], v] for k, v in sorted(d.items(), key=lambda kv: -kv[1])[:n]]
