"""The manifest and the files it names, found by name: ``BENCHMARK.json`` at
the root of the checkout, a configuration's file, a traffic mix
(``kvbench/traffic/<mix>.json``), a model family (``kvbench/models/<family>.py``)
and one reader a metric (``kvbench/metrics/<metric>.py``)."""

from __future__ import annotations

import importlib
import importlib.util
import json
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parent
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def load_manifest(root: Path) -> dict:
    return json.loads((root / "BENCHMARK.json").read_text())


def workload(man: dict, name: str) -> dict:
    for cell in man["workloads"]:
        if cell["name"] == name:
            return cell
    raise SystemExit(f"no workload {name!r} in BENCHMARK.json; "
                     f"known: {[c['name'] for c in man['workloads']]}")


def config(root: Path, man: dict, name: str) -> dict:
    entry = next(c for c in man["configs"] if c["name"] == name)
    return {"name": name, **json.loads((root / entry["file"]).read_text())}


def traffic(name: str) -> dict:
    return json.loads((HERE / "traffic" / f"{name}.json").read_text())


def family(name: str):
    return importlib.import_module(f"kvbench.models.{name}")


def applies(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def metrics_for(man: dict, cell: str, trace: bool) -> list[dict]:
    """The cell's end-to-end metrics (``trace`` false) or its per-layer
    ones: those that list the cell, or list none and move an end-to-end
    metric the cell reports."""
    e2e = [m for m in man["end_to_end"] if applies(m, cell)]
    if not trace:
        return e2e
    moved = {m["name"] for m in e2e}
    return [m for m in man["per_layer"]
            if (cell in m["workloads"] if "workloads" in m else m["moves"] in moved)]


def reader(name: str):
    """``read(rec) -> float | None`` of ``kvbench/metrics/<name>.py``."""
    path = HERE / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"kvbench_metric_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def read_metrics(metrics: list[dict], rec: dict) -> dict:
    """Each metric whose reader finds something to read, with its unit."""
    out = {}
    for m in metrics:
        value = reader(m["name"])(rec)
        if value is not None:
            out[m["name"]] = {"value": float(value), "unit": m["unit"]}
    return out


def forbidden_modules() -> list[str]:
    """Loaded modules whose top-level name is JAX's or the JAX package's."""
    return sorted({m for m in list(sys.modules) if m.split(".")[0] in FORBIDDEN})
