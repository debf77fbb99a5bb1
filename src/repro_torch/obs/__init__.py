"""Observability for the KVSwap stack: structured tracing + typed metrics.

One :class:`Observability` handle bundles the two subsystems and the
modeled-clock cursor they share:

* :class:`~repro.obs.span.SpanTracer` — dual-clock spans (measured wall
  time and the modeled DiskSpec/ComputeSpec clock) exportable as
  Chrome/Perfetto ``trace_event`` JSON;
* :class:`~repro.obs.metrics.MetricsRegistry` — counters/gauges/histograms
  with JSON-snapshot and Prometheus text exporters, kept in exact
  agreement with the stack's legacy stats dicts.

Usage::

    from repro_torch.obs import Observability

    obs = Observability()
    eng = KVSwapEngine(model, params, cfg, batch=2, calib_k=k, obs=obs)
    ...
    obs.export_trace("trace.json")          # open in ui.perfetto.dev
    print(obs.registry.to_prometheus())

The handle is passed **alongside** the config (an ``obs=`` keyword on
:class:`~repro.core.engine.KVSwapEngine` and :class:`~repro.serving.api.
ServeSession`), never inside :class:`~repro.core.engine.EngineConfig` —
the config is a frozen, ``dataclasses.asdict``-serialized value object and
must stay one.

Disabled-path contract: with no ``obs`` handle (or ``enabled=False``)
every instrumentation site reduces to one attribute load + bool test, no
allocation, no lock — and the token streams are bit-identical to an
uninstrumented engine (``tests/test_obs.py`` pins both properties).
"""

from __future__ import annotations

from repro_torch.obs.metrics import Counter, Gauge, Histogram, MetricsRegistry
from repro_torch.obs.quality import PrefetchQualityMeter, QualityCounts
from repro_torch.obs.span import (MODEL_PID, WALL_PID, Span, SpanTracer,
                            validate_trace_events)

__all__ = [
    "Counter",
    "Gauge",
    "Histogram",
    "MetricsRegistry",
    "MODEL_PID",
    "NULL_OBS",
    "Observability",
    "PrefetchQualityMeter",
    "QualityCounts",
    "Span",
    "SpanTracer",
    "WALL_PID",
    "validate_trace_events",
]


class Observability:
    """Tracing + metrics + the modeled-clock cursor, one handle.

    ``enabled=False`` builds a null handle: the tracer refuses spans, the
    registry stays empty (no instrumented component writes when disabled),
    and every engine call site guards on :attr:`enabled` before doing any
    work.  One handle may be shared by several components (engine +
    session + tiers) — that is the point: their spans land on one timeline
    and their metrics in one registry.
    """

    def __init__(self, enabled: bool = True, labels: dict | None = None):
        self.enabled = bool(enabled)
        self.tracer = SpanTracer(enabled=self.enabled)
        # instance labels (e.g. {"replica": "r0"}) stamp every kvswap_*
        # series this handle's components create, so N engines in one
        # process export N disjoint series sets instead of colliding; no
        # labels keeps the historical bare-name series byte-identical
        self.registry = MetricsRegistry(labels=labels)
        # modeled-clock cursor: advanced by the engine (admission modeled
        # seconds, per-step pipelined seconds) and re-synced by a serving
        # session whose clock can also jump to future arrivals
        self.model_time = 0.0

    def advance_model(self, dt: float) -> tuple[float, float]:
        """Advance the modeled cursor by ``dt``; returns ``(t0, t1)`` so
        the caller can place a span over exactly that interval."""
        t0 = self.model_time
        self.model_time = t1 = t0 + dt
        return t0, t1

    def sync_model(self, t: float) -> None:
        """Jump the cursor (idle sessions fast-forward to the next
        arrival; the cursor must follow or later spans would overlap)."""
        if t > self.model_time:
            self.model_time = t

    def export_trace(self, path) -> dict:
        return self.tracer.export(path)

    def snapshot(self) -> dict:
        return self.registry.snapshot()


NULL_OBS = Observability(enabled=False)
"""Shared disabled handle — the default for every instrumented component.
Never written to (all call sites guard on ``enabled``), so sharing one
instance across engines is safe and keeps the disabled path allocation-free.
"""
