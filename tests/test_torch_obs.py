"""The port's tracer on the profiler's clock, the engine's phase spans, and the
benchmark's split of a traced window by phase.

Wall spans take ``time.time_ns()`` readings and the thread that took them; a
session with an obs handle records one span per engine phase, nested
``serve.step`` ⊃ ``decode`` ⊃ phase on the thread that steps it, the prefetch
workers' ``fetch`` spans on theirs.  Tokens do not depend on the handle.
``kvbench.phase_reduce.reduce_phases`` charges idle and device time to the
phases of a hand-built timeline exactly, and the traced run that uses it, and
the one that switches the tracer on and off to time it, are rehearsed on the
CPU over the benchmark's tiny cells.
"""

import json
import threading
import time

import numpy as np
import pytest
import torch

from kvbench.phase_reduce import (GROUPED, GROUPS, OUTSIDE, UNLINKED, main_spans, per_step_ms,
                                  reduce_phases)
from kvbench.tests.helpers import copy_with_tiny_cells, rehearse
from repro_torch.core.engine import EngineConfig
from repro_torch.models.transformer import ModelConfig, TransformerAdapter, init_params
from repro_torch.obs import NULL_OBS, Observability, SpanTracer
from repro_torch.serving import ServeSession

CFG = ModelConfig(name="tiny", arch_type="dense", n_layers=2, d_model=64, n_heads=4,
                  n_kv_heads=2, head_dim=16, d_ff=128, vocab_size=97)
# reuse capacity under the selection: some groups are staged every step
ENGINE = dict(group_size=4, n_select=3, rank=8, reuse_capacity=2, max_seq=128)
LAYER_PHASES = ("predict", "readback", "quality", "upload", "gather", "block", "tail", "spill")
STEP_PHASES = ("embed", "flush", "stats", "logits")
SERVE_PHASES = ("serve.admit", "serve.sample", "serve.logits_wait")


@pytest.fixture(scope="module")
def parts():
    params = init_params(CFG, generator=torch.Generator().manual_seed(0), device="cpu")
    calib = np.random.default_rng(5).standard_normal((256, 2, 16)).astype(np.float32)
    return TransformerAdapter(CFG), params, calib


def serve(parts, obs=None, **engine):
    """Three requests through a two-slot session; the tokens by request."""
    model, params, calib = parts
    cfg = EngineConfig(**{**ENGINE, **engine})
    rng = np.random.default_rng(1)
    with ServeSession(model, params, cfg, slots=2, calib_k=calib, device="cpu", obs=obs) as s:
        for n in (20, 27, 33):
            s.submit(rng.integers(0, CFG.vocab_size, n), 9)
        done = s.drain()
    return {rid: req.output.tolist() for rid, req in done.items()}, done


def test_spans_bracket_a_reading_taken_inside_and_carry_their_thread():
    tr = SpanTracer()
    t0 = tr.now_ns()
    inside = time.time_ns()
    end = tr.phase("block", "block L7", t0, {"step": 3})
    with tr.wall_span("scope", "lane"):
        inside_scope = time.time_ns()
    worker = threading.Thread(target=lambda: tr.phase("prefetch", "fetch L1", tr.now_ns()))
    worker.start()
    worker.join()
    sp, scope, other = tr.spans()
    assert sp.wall_t0_ns <= inside <= sp.wall_t1_ns == end
    assert scope.wall_t0_ns <= inside_scope <= scope.wall_t1_ns
    assert (sp.cat, sp.track, sp.args) == ("block", "block", {"step": 3})
    assert sp.thread == scope.thread == threading.get_ident() != other.thread == worker.ident
    # the export keeps its shape: microseconds from the tracer's birth
    ev = next(e for e in tr.to_trace_events() if e.get("name") == "block L7")
    assert ev["ts"] == round((sp.wall_t0_ns - tr.birth_ns) / 1e3, 3)
    assert ev["dur"] == round((sp.wall_t1_ns - sp.wall_t0_ns) / 1e3, 3)


@pytest.mark.parametrize("async_io", [True, False])
def test_a_session_records_every_phase_nested_on_one_thread(parts, async_io):
    obs = Observability()
    serve(parts, obs, device_resident=True, async_io=async_io)
    main = threading.get_ident()
    spans = [s for s in obs.tracer.spans() if s.wall_t0_ns is not None and not s.instant]
    mine = [s for s in spans if s.thread == main and s.cat != "request"]
    cats = {s.cat for s in mine}
    assert {*STEP_PHASES, *SERVE_PHASES, "serve.step", "decode"} <= cats
    fetch = "wait" if async_io else "fetch"
    for layer in range(CFG.n_layers):
        names = {s.name for s in mine}
        for phase in (*LAYER_PHASES, fetch):
            assert f"{phase} L{layer}" in names, (phase, layer)
    assert "attn L0" not in {s.name for s in spans}
    steps = [s for s in mine if s.cat == "serve.step"]
    decodes = [s for s in mine if s.cat == "decode"]

    def within(inner, outer):
        return outer.wall_t0_ns <= inner.wall_t0_ns <= inner.wall_t1_ns <= outer.wall_t1_ns

    for d in decodes:
        parent = [s for s in steps if within(d, s)]
        assert len(parent) == 1 and parent[0].args["step"] == d.args["step"]
    for s in mine:
        if s.cat in (*LAYER_PHASES, *STEP_PHASES, fetch):
            parent = [d for d in decodes if within(s, d)]
            assert len(parent) == 1 and parent[0].args["step"] == s.args["step"], s.name
        elif s.cat in SERVE_PHASES:
            assert any(within(s, p) for p in steps) and not any(within(s, d) for d in decodes)
    workers = [s for s in spans if s.cat == "prefetch"]
    assert bool(workers) is async_io
    assert all(s.thread != main for s in workers)
    # every phase is summed by one metric's group: over the session's own
    # span (no device work, all of it idle), the groups and ``outside`` add
    # up to the whole
    assert cats <= GROUPED, cats - GROUPED
    t0, t1 = min(s.wall_t0_ns for s in mine), max(s.wall_t1_ns for s in mine)
    got = reduce_phases(main_spans(obs.tracer, main), [], {}, t0 - 500, t1 + 500)
    assert got["unassigned"] == [] and got["unassigned_s"] == 0
    grouped = sum(got["idle_s"].get(c, 0.0) for cats in GROUPS.values() for c in cats)
    assert abs(grouped + got["outside_s"] - (t1 - t0 + 1000) / 1e9) < 1e-9


@pytest.mark.parametrize("device_resident", [True, False])
@pytest.mark.parametrize("async_io", [True, False])
def test_tokens_do_not_depend_on_the_handle(parts, device_resident, async_io):
    kw = dict(device_resident=device_resident, async_io=async_io)
    on, _ = serve(parts, Observability(), **kw)
    off, _ = serve(parts, None, **kw)
    assert on == off


@pytest.mark.parametrize("device_resident", [True, False])
@pytest.mark.parametrize("async_io", [True, False])
@pytest.mark.parametrize("handle", ["disabled", "none"])
def test_a_disabled_handle_records_nothing(parts, handle, async_io, device_resident):
    obs = Observability(enabled=False) if handle == "disabled" else None
    _, done = serve(parts, obs, device_resident=device_resident, async_io=async_io)
    tracer = (obs or NULL_OBS).tracer
    assert len(tracer) == 0 and len(NULL_OBS.tracer) == 0
    assert (obs or NULL_OBS).snapshot() == NULL_OBS.snapshot()
    assert all(r.admitted_wall is None and r.finished_wall is None for r in done.values())


def test_requests_carry_their_lifecycle_on_the_wall_clock(parts):
    obs = Observability()
    _, done = serve(parts, obs, device_resident=True, async_io=True)
    for r in done.values():
        assert r.submitted_wall <= r.admitted_wall <= r.first_token_wall <= r.finished_wall
    running = {s.args["rid"]: s for s in obs.tracer.spans()
               if s.cat == "request" and not s.instant and "queued" not in s.name}
    for rid, r in done.items():
        sp = running[rid]
        assert (sp.wall_t0_ns, sp.wall_t1_ns) == (r.admitted_wall, r.finished_wall)
        assert sp.model_t0 == r.admitted_at
        assert sp.args["ttft_wall_s"] == (r.first_token_wall - r.submitted_wall) / 1e9


def test_reduce_phases_splits_a_hand_built_timeline_exactly():
    base = 1_792_000_000_000_000_000          # a time.time_ns() reading
    us = 1000
    spans = [("serve.step", 0, 100), ("serve.sample", 2, 5), ("decode", 10, 90),
             ("predict", 12, 20), ("block", 30, 60), ("serve.logits_wait", 92, 98)]
    spans = [(c, base + s * us, base + e * us) for c, s, e in spans]
    # (start, end, correlation id); the one launched from block runs on into
    # the decode step's own time; the last one's launch was never seen
    ops = [(14, 18, 1), (40, 70, 2), (95, 97, 3), (104, 106, 99)]
    ops = [(f"op{c}", base + s * us, base + e * us, c) for s, e, c in ops]
    launches = {1: base + 13 * us, 2: base + 35 * us, 3: base + 93 * us}
    got = reduce_phases(spans, ops, launches, base, base + 110 * us)
    idle = {k: round(v * 1e9 / us) for k, v in got["idle_s"].items()}
    device = {k: round(v * 1e9 / us) for k, v in got["device_s"].items()}
    assert idle == {"serve.step": 11, "serve.sample": 3, "decode": 32, "predict": 4, "block": 10,
                    "serve.logits_wait": 4, OUTSIDE: 8}
    assert device == {"predict": 4, "block": 30, "serve.logits_wait": 2, UNLINKED: 2}
    assert round(got["outside_s"] * 1e9) == 8 * us and round(got["unlinked_s"] * 1e9) == 2 * us
    assert round(got["busy_s"] * 1e9) == 38 * us
    assert sum(idle.values()) == 110 - 38
    assert got["unassigned"] == [] and got["unassigned_s"] == 0


def test_a_phase_in_no_group_is_reported_and_refused():
    """A phase a later change renames or adds, summed by no metric, shows
    as ``unassigned`` and stops the metrics rather than read as a gain."""
    us = 1000
    spans = [("decode", 0, 100 * us), ("block", 10 * us, 40 * us), ("resample", 50 * us, 80 * us)]
    ops = [("op1", 20 * us, 30 * us, 1), ("op2", 60 * us, 70 * us, 2)]
    got = reduce_phases(spans, ops, {1: 15 * us, 2: 55 * us}, 0, 100 * us)
    assert got["unassigned"] == ["resample"]
    assert round(got["unassigned_s"] * 1e9) == 20 * us
    rec = {"phases": got, "step_wall_s": [0.1], "on_card": True}
    with pytest.raises(ValueError, match="resample"):
        per_step_ms(rec, "block")
    assert per_step_ms({**rec, "on_card": False}, "block") is None
    clean = reduce_phases(spans[:2], ops, {1: 15 * us, 2: 55 * us}, 0, 100 * us)
    # one step: block's 20 us of idle, and op1's 10 us of device time
    assert per_step_ms({**rec, "phases": clean}, "block") == pytest.approx(20 * us / 1e6)
    assert per_step_ms({**rec, "phases": clean}, "block", "device_s") == pytest.approx(10 * us / 1e6)


@pytest.mark.parametrize("async_io", [True, False])
def test_a_handle_switched_between_steps_keeps_the_session_whole(parts, async_io, monkeypatch):
    """The tracer's cost is timed by switching the handle on and off between
    steps: the session runs on, serves the same tokens, and records spans
    in the steps it was on for only; a request's wall figures are set or
    left out, never wrong."""
    obs = Observability()
    real = ServeSession.step
    on_at = []

    def step(self):
        obs.enabled = obs.tracer.enabled = len(on_at) % 3 != 1
        on_at.append(obs.enabled)
        return real(self)

    monkeypatch.setattr(ServeSession, "step", step)
    switched, done = serve(parts, obs, device_resident=True, async_io=async_io)
    monkeypatch.setattr(ServeSession, "step", real)
    off, _ = serve(parts, None, device_resident=True, async_io=async_io)
    assert switched == off and False in on_at
    steps = [s for s in obs.tracer.spans() if s.cat == "serve.step"]
    assert len(steps) == sum(on_at)
    for r in done.values():
        walls = [w for w in (r.submitted_wall, r.admitted_wall, r.first_token_wall,
                             r.finished_wall) if w is not None]
        assert walls == sorted(walls)
    running = [s for s in obs.tracer.spans() if s.cat == "request" and "rid" in (s.args or {})
               and "ttft_wall_s" in s.args]
    assert running and all(s.args["ttft_wall_s"] is None or s.args["ttft_wall_s"] > 0
                           for s in running)


RUN = """
import json
import repro_torch.serving as serving
from kvbench import phases
from kvbench.run import run_cell
from repro_torch.obs import NULL_OBS
seen = []
real = serving.ServeSession.__init__
def init(self, *args, **kwargs):
    real(self, *args, **kwargs)
    seen.append(self.obs is NULL_OBS)
serving.ServeSession.__init__ = init
plain = run_cell("tiny-dense", 2**31 + 11, 0.5, True, device="cpu", emit=lambda line: None)
untraced = run_cell("tiny-dense", 2**31 + 11, 0.5, False, device="cpu", emit=lambda line: None)
lines = []
traced = phases.run("tiny-dense", 2**31 + 11, 0.5, device="cpu", emit=lines.append)
cost = phases.handle_cost("tiny-dense", 2**31 + 11, 0.5, device="cpu", emit=lines.append)
print(json.dumps({"seen": seen, "plain": plain, "untraced": untraced, "traced": traced,
                  "cost": cost, "phases": [json.loads(x) for x in lines if '"phases"' in x]}))
"""


def test_traced_run_reads_the_program_spans_on_the_cpu(tmp_path):
    """The benchmark's run with the program's tracer attached, over a tiny
    cell: the harness's runs leave the session on ``NULL_OBS``, the traced
    one reads ``reuse_hit_pct`` and ``fetch_busy_ms`` and prints the phase
    split before a result line of the same keys; the device's metrics read
    nothing on the CPU."""
    root = copy_with_tiny_cells(tmp_path)
    proc = rehearse(root, RUN)
    assert proc.returncode == 0, proc.stderr[-3000:]
    out = json.loads(proc.stdout.splitlines()[-1])
    assert out["seen"] == [True, True, False, False]
    plain, traced = out["plain"], out["traced"]
    assert list(traced) == list(plain) and traced["correct"] is True
    assert set(plain["metrics"]) < set(traced["metrics"])
    assert 0 <= traced["metrics"]["reuse_hit_pct"]["value"] <= 100
    assert traced["metrics"]["fetch_busy_ms"]["value"] > 0
    assert not {"idle_fetch_ms", "block_device_ms"} & set(traced["metrics"])
    ph = out["phases"][0]["phases"]
    assert {"idle_s", "device_s", "outside_s", "unlinked_s"} <= set(ph)
    assert {"upload", "block", "predict"} <= set(ph["idle_s"])
    assert {"upload", "block", "step", "decode_step"} <= set(ph["span_wall_s"])
    assert ph["unassigned"] == []
    # the handle switched on and off within one run: whole pairs of window
    # steps, one of each timed with it
    cost = out["cost"]
    assert cost["pairs"] >= 1 and cost["ratio_q1"] <= cost["ratio_median"] <= cost["ratio_q3"]
    lo, hi = cost["ratio_median_ci95"]
    assert lo <= cost["ratio_median"] <= hi and cost["on_step_ms_median"] > 0
