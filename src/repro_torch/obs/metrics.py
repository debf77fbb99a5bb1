"""Typed metrics registry: counters, gauges, histograms.

One process-local registry per :class:`~repro.obs.Observability` handle.
The stack's existing stats dicts (``IOAccountant.snapshot()``,
``summarize_steps``, ``WarmTier.snapshot()``, ``PrefixCacheStats``,
``ServeSession.stats()``) stay the canonical shapes; when obs is attached
the same increments are mirrored into this registry, so the snapshot here
and the legacy dicts agree **exactly** (asserted by ``tests/test_obs.py``).

Exactness is by construction, not by reconciliation:

* :class:`IOAccountant` mirrors each charge *inside its own lock*, so the
  registry counter accumulates the identical float sequence in the
  identical order as the accountant's field — bit-equal totals even with
  prefetch-worker threads charging concurrently.
* The engine observes per-step histograms in ``step_log`` append order on
  the main thread, so histogram sums equal ``sum()`` over ``step_log``.
* Histogram quantiles are computed with the repo's single percentile
  implementation (:func:`repro.utils.stats.percentiles`), the same helper
  ``summarize_steps`` uses for the step tails.

Exports: :meth:`MetricsRegistry.snapshot` (plain JSON-able dict) and
:meth:`MetricsRegistry.to_prometheus` (text exposition format, histograms
rendered summary-style with pXX quantile labels).

Thread safety: each metric carries its own lock; creation is guarded by a
registry lock.  All operations are cheap enough for per-fetch hot paths,
but the disabled-obs path never reaches them at all (the engine guards
every call site with ``if obs.enabled``).

Instance labels: several engines/sessions in one process (a multi-replica
router fleet) would collide on shared series names — every replica's
``kvswap_io_read_bytes_total`` would land on one counter.  A registry may
therefore carry **default labels** (``MetricsRegistry(labels={"replica":
"r0"})``) applied to every metric it creates, and each create call may add
per-metric labels; a metric's identity becomes ``name{k="v",...}`` with
sorted label keys.  The zero-label case renders bare names, so a
single-replica process's ``snapshot()`` and ``to_prometheus()`` output is
byte-identical to the unlabeled format (asserted by ``tests/test_obs.py``).
"""

from __future__ import annotations

import threading
from typing import Iterable, Mapping

import numpy as np

from repro_torch.utils import stats as stats_util

__all__ = ["Counter", "Gauge", "Histogram", "MetricsRegistry"]

_NAME_OK = set("abcdefghijklmnopqrstuvwxyz"
               "ABCDEFGHIJKLMNOPQRSTUVWXYZ0123456789_:")


def _check_name(name: str) -> str:
    if not name or not set(name) <= _NAME_OK or name[0].isdigit():
        raise ValueError(f"invalid metric name: {name!r}")
    return name


def _check_labels(labels: Mapping[str, str] | None) -> dict[str, str]:
    out: dict[str, str] = {}
    for key, value in (labels or {}).items():
        _check_name(key)
        value = str(value)
        if any(c in value for c in '"\\\n'):
            raise ValueError(f"invalid label value for {key!r}: {value!r}")
        out[key] = value
    return out


def render_labels(labels: Mapping[str, str]) -> str:
    """``{k="v",...}`` with sorted keys; empty string for no labels (the
    byte-identity contract with unlabeled registries)."""
    if not labels:
        return ""
    return "{" + ",".join(f'{k}="{v}"'
                          for k, v in sorted(labels.items())) + "}"


def fold(total, amounts):
    """``total`` plus each of ``amounts`` in turn, left to right: the float a
    loop of ``+=`` gives (``np.add.accumulate`` adds in that order; a sum
    would pair the terms)."""
    if not len(amounts):
        return total
    return float(np.add.accumulate(np.concatenate(([total], amounts)))[-1])


class Counter:
    """Monotonically increasing value (int or float)."""

    kind = "counter"

    def __init__(self, name: str, help: str = "",
                 labels: Mapping[str, str] | None = None):
        self.name = _check_name(name)
        self.help = help
        self.labels = _check_labels(labels)
        self._lock = threading.Lock()
        self._value = 0

    def inc(self, amount=1) -> None:
        if amount < 0:
            raise ValueError(f"counter {self.name} cannot decrease")
        with self._lock:
            self._value += amount

    def inc_each(self, amounts) -> None:
        """:meth:`inc` by each of ``amounts`` in turn, under one hold of the
        lock: the value a loop of ``inc`` calls leaves, bit for bit."""
        if (np.asarray(amounts) < 0).any():
            raise ValueError(f"counter {self.name} cannot decrease")
        with self._lock:
            self._value = fold(self._value, amounts)

    @property
    def value(self):
        with self._lock:
            return self._value

    def _reset(self) -> None:
        """Internal: keep a mirrored counter in lockstep with a source that
        resets (``IOAccountant.reset``).  Not part of the public API —
        Prometheus counters are monotone between restarts."""
        with self._lock:
            self._value = 0


class Gauge:
    """A value that can go up and down (queue depth, resident bytes)."""

    kind = "gauge"

    def __init__(self, name: str, help: str = "",
                 labels: Mapping[str, str] | None = None):
        self.name = _check_name(name)
        self.help = help
        self.labels = _check_labels(labels)
        self._lock = threading.Lock()
        self._value = 0

    def set(self, value) -> None:
        with self._lock:
            self._value = value

    def inc(self, amount=1) -> None:
        with self._lock:
            self._value += amount

    def dec(self, amount=1) -> None:
        with self._lock:
            self._value -= amount

    @property
    def value(self):
        with self._lock:
            return self._value


class Histogram:
    """Sample accumulator with exact count/sum and percentile views.

    Samples are kept verbatim (these are per-step / per-request series,
    thousands at most — not production-cardinality buckets), so quantiles
    are exact order statistics from the shared helper rather than bucket
    interpolations, and ``sum`` accumulates in observation order (the
    exactness contract with ``summarize_steps``).
    """

    kind = "histogram"

    def __init__(self, name: str, help: str = "",
                 labels: Mapping[str, str] | None = None):
        self.name = _check_name(name)
        self.help = help
        self.labels = _check_labels(labels)
        self._lock = threading.Lock()
        self._samples: list[float] = []
        self._sum = 0.0

    def observe(self, value) -> None:
        v = float(value)
        with self._lock:
            self._samples.append(v)
            self._sum += v

    @property
    def count(self) -> int:
        with self._lock:
            return len(self._samples)

    @property
    def sum(self) -> float:
        with self._lock:
            return self._sum

    def samples(self) -> list[float]:
        with self._lock:
            return list(self._samples)

    def percentiles(self, qs: Iterable[float] = stats_util.DEFAULT_QS) -> dict:
        return stats_util.percentiles(self.samples(), qs)


class MetricsRegistry:
    """Series-keyed collection of typed metrics.

    ``counter()``/``gauge()``/``histogram()`` are get-or-create: the first
    call registers, later calls return the same object (re-registering
    under a different type raises — a series means one thing).  A series is
    ``name`` plus its labels — the registry's default ``labels`` (set at
    construction, e.g. ``{"replica": "r0"}`` for one fleet member) merged
    with any per-call ``labels=``.  Registries with no labels anywhere key
    by bare name, exactly as before.
    """

    def __init__(self, labels: Mapping[str, str] | None = None):
        self._lock = threading.Lock()
        self.labels = _check_labels(labels)
        self._metrics: dict[str, Counter | Gauge | Histogram] = {}

    def _get_or_create(self, cls, name: str, help: str,
                       labels: Mapping[str, str] | None = None):
        merged = ({**self.labels, **_check_labels(labels)}
                  if (self.labels or labels) else {})
        key = _check_name(name) + render_labels(merged)
        with self._lock:
            m = self._metrics.get(key)
            if m is None:
                m = self._metrics[key] = cls(name, help, labels=merged)
            elif not isinstance(m, cls):
                raise TypeError(
                    f"metric {key!r} already registered as {m.kind}")
            return m

    def counter(self, name: str, help: str = "",
                labels: Mapping[str, str] | None = None) -> Counter:
        return self._get_or_create(Counter, name, help, labels)

    def gauge(self, name: str, help: str = "",
              labels: Mapping[str, str] | None = None) -> Gauge:
        return self._get_or_create(Gauge, name, help, labels)

    def histogram(self, name: str, help: str = "",
                  labels: Mapping[str, str] | None = None) -> Histogram:
        return self._get_or_create(Histogram, name, help, labels)

    def get(self, name: str, labels: Mapping[str, str] | None = None):
        """Look up a series by bare name (an unlabeled registry) or by
        name + explicit labels; ``labels=None`` on a labeled registry
        resolves through the registry's own defaults."""
        merged = ({**self.labels, **_check_labels(labels)}
                  if (self.labels or labels) else {})
        with self._lock:
            return self._metrics.get(name + render_labels(merged))

    def __len__(self) -> int:
        with self._lock:
            return len(self._metrics)

    def __contains__(self, name: str) -> bool:
        with self._lock:
            return name in self._metrics

    # -- exporters --------------------------------------------------------
    def snapshot(self) -> dict:
        """JSON-able view: counters/gauges as plain values, histograms as
        ``{count, sum, p50, p95, p99}``.  Deterministic key order (sorted);
        keys are series keys — bare names for unlabeled registries (the
        historical format, byte-identical), ``name{k="v"}`` otherwise, so
        snapshots of differently-labeled registries merge without
        collisions (``dict.update`` is a fleet aggregation)."""
        with self._lock:
            items = sorted(self._metrics.items())
        out = {}
        for key, m in items:
            if isinstance(m, Histogram):
                out[key] = {"count": m.count, "sum": m.sum,
                            **m.percentiles()}
            else:
                out[key] = m.value
        return out

    def to_prometheus(self) -> str:
        """Prometheus text exposition (version 0.0.4).  Histograms render
        summary-style: ``{name}{quantile="0.5"}`` lines plus ``_sum`` and
        ``_count`` — exact order statistics, not bucketed estimates.
        HELP/TYPE headers are emitted once per metric *family* (bare name);
        labeled series render their labels on every sample line."""
        with self._lock:
            items = sorted(self._metrics.items())
        lines: list[str] = []
        seen_family: set[str] = set()
        for _, m in items:
            if m.name not in seen_family:
                seen_family.add(m.name)
                if m.help:
                    lines.append(f"# HELP {m.name} {m.help}")
                kind = "summary" if isinstance(m, Histogram) else m.kind
                lines.append(f"# TYPE {m.name} {kind}")
            tag = render_labels(m.labels)
            if isinstance(m, Histogram):
                for key, val in m.percentiles().items():
                    q = float(key[1:]) / 100.0
                    quantiled = render_labels(
                        {**m.labels, "quantile": f"{q:g}"})
                    lines.append(f"{m.name}{quantiled} {val}")
                lines.append(f"{m.name}_sum{tag} {m.sum}")
                lines.append(f"{m.name}_count{tag} {m.count}")
            else:
                lines.append(f"{m.name}{tag} {m.value}")
        return "\n".join(lines) + ("\n" if lines else "")
