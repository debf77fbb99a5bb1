"""Run one cell of the benchmark once, on the card.

    python3 kvbench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout that holds ``BENCHMARK.json``, ``kvbench/`` and
the program under test (``src/repro_torch``).  Set-up builds the kernels
(cached under ``build/``), draws the weights and the documents from the
seed, fits the low-rank adapter, admits one document a slot and runs a few
decode steps; then ``ServeSession.step()`` runs for ``--seconds``, a
closed loop in which a finished row takes the next document.  After the
window the program's state is freed and the served tokens are compared
with the plain reference.

Standard output ends with one JSON line (``correct``, ``attempted``,
``failed``, ``metrics``, ``device``, with ``--trace 1`` ``breakdown``, and
``checks``: each number compared beside its limit); earlier lines record
the card, the host, the engine tuple and the KV bytes written.  With
``--trace 1`` the metrics are the per-layer ones, read from the harness's
spans, the program's counters and the profiler's device trace of the
window.  Without a card, or with fewer than the cell asks for, it exits 2
and prints no result; a JAX module loaded by the run makes it exit 3.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import statistics  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
if sys.path and Path(sys.path[0]).resolve() == ROOT / "kvbench":
    sys.path.pop(0)      # the script's own directory would shadow the standard library
for p in (ROOT / "src", ROOT):
    if str(p) not in sys.path:
        sys.path.insert(0, str(p))
# the CUDA driver's JIT cache at a fixed path inside the checkout
os.environ.setdefault("CUDA_CACHE_PATH", str(ROOT / "build" / "kvbench" / "cuda-cache"))


def _query(cmd: list[str]) -> str | None:
    try:
        return subprocess.run(cmd, capture_output=True, text=True, timeout=30).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        return None


def environment(dev, engine: dict) -> dict:
    import torch

    cpu = {}
    try:
        with open("/proc/cpuinfo") as f:
            for line in f:
                key, _, value = line.partition(":")
                key = key.strip()
                if key in ("model name", "vendor_id", "cpu family", "model", "cpu MHz"):
                    cpu.setdefault(key, value.strip())
                elif not key and cpu:
                    break
    except OSError:
        pass
    return {"card": torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu",
            "nvidia_smi": _query(["nvidia-smi", "--query-gpu=name,power.limit,clocks.sm,"
                                  "clocks.max.sm,temperature.gpu", "--format=csv,noheader"])
            if dev.type == "cuda" else None,
            "host_cpu": cpu, "host_cores": os.cpu_count(), "torch": torch.__version__,
            "cuda": torch.version.cuda, "python": sys.version.split()[0], "engine": engine}


def _smi(dev) -> str | None:
    """The card's clocks, power and temperature now."""
    if dev.type != "cuda":
        return None
    return _query(["nvidia-smi", "--query-gpu=clocks.sm,clocks.mem,power.draw,power.limit,"
                   "temperature.gpu", "--format=csv,noheader"])


def _sync(dev) -> None:
    import torch

    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _peak(dev) -> int:
    import torch

    return torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0


def run_cell(name: str, seed: int, seconds: float, trace: bool, *, device: str = "cuda",
             root: Path = ROOT, control: bool = False, t_start: float = T_START,
             emit=print) -> dict:
    """One run of cell ``name``; returns the result line's object."""
    import numpy as np
    import torch

    from kvbench import bench, check, devtrace, roofline, weights, workload

    man = bench.load_manifest(root)
    cell = bench.workload(man, name)
    cfg = bench.config(root, man, cell["config"])
    mix = bench.traffic(cell["traffic"])
    fam = bench.family(cfg["model"])
    engine = cfg["engine"]
    dev = torch.device(device)
    emit(json.dumps({"env": environment(dev, engine), "workload": name, "seed": seed}))

    from repro_torch.models.transformer import TransformerAdapter
    from repro_torch.serving import ServeSession

    torch.set_grad_enabled(False)
    build = {}
    if dev.type == "cuda":
        from repro_torch.kernels import _build

        build = {k: v["seconds"] for k, v in _build.build().items()}
    flat = weights.make(fam.leaves(cfg), seed, dev)
    w = weights.nested(flat)
    param_bytes = weights.nbytes(flat)
    pcfg = fam.port_config(cfg, engine)
    model = TransformerAdapter(pcfg)
    params = fam.port_params(cfg, w)
    calib = torch.as_tensor(workload.calibration(seed, cfg["vocab_size"], engine["calib_tokens"]),
                            device=dev)[None]
    pos = torch.arange(calib.shape[1], device=dev)[None]
    _, k0, _ = model.prefill_block(params, 0, model.embed(params, calib), pos)
    calib_k = k0[0].cpu().numpy()
    del k0
    sess = ServeSession(model, params, fam.engine_config(engine), slots=mix["slots"],
                        calib_k=calib_k, device=dev)
    eng = sess.engine
    acct = eng.accountant

    # the program's discrete choices, observed as it makes them: the group
    # selections as each decode step's layers start (the engine's
    # ``layer_hook``), and each MoE layer's experts (its dispatch's output);
    # the check follows them
    picks: dict[tuple[int, int], tuple] = {}        # (engine step, layer) -> ids, mask
    routes_decode: dict[tuple[int, int], object] = {}
    routes_admit: dict[tuple[int, int], list] = {}  # (engine step, row) -> one a layer
    ctx: dict = {"admit": None, "decode": None}

    def observe(layer, x, pos, table):
        ctx["decode"] = (len(eng.step_log), layer)
        picks[ctx["decode"]] = (table.group_ids.copy(), table.group_mask.copy())

    from repro_torch.models import layers as port_layers

    moe_dispatch = getattr(port_layers, "_moe_dispatch", None)

    def dispatch(*args, **kwargs):
        out = moe_dispatch(*args, **kwargs)
        if ctx["admit"] is not None:
            ctx["admit"].append(out[1])
        elif ctx["decode"] is not None:
            routes_decode[ctx["decode"]] = out[1]
        return out

    admit_s: list[float] = []
    admit_row = eng.admit_row

    def timed_admit(bi, *args, **kwargs):
        ctx["admit"] = []
        t0 = time.perf_counter()
        out = admit_row(bi, *args, **kwargs)
        _sync(dev)
        admit_s.append(time.perf_counter() - t0)
        routes_admit[len(eng.step_log), bi] = [e.cpu() for e in ctx["admit"]]
        ctx["admit"] = None
        return out

    # the logits each served token is chosen from: the session's sampler,
    # wrapped where the session makes it; one list of rows a sampler, in the
    # order of admission
    from repro_torch.serving import api as port_api

    make_sampler = port_api.make_row_sampler
    sampled: list[list] = []

    def make_row_sampler(*args, **kwargs):
        inner, rows = make_sampler(*args, **kwargs), []
        sampled.append(rows)

        def sample(logits):
            rows.append(logits)
            return inner(logits)

        return sample

    eng.admit_row = timed_admit
    eng.layer_hook = observe
    port_api.make_row_sampler = make_row_sampler
    logits_of: dict[int, list] = {}
    if moe_dispatch is not None:
        port_layers._moe_dispatch = dispatch
    first_step: dict[int, int] = {}   # request -> the engine step of its first decode
    slot_of: dict[int, int] = {}

    docs = workload.documents(mix, seed, cfg["vocab_size"])
    bpt = fam.kv_bytes_per_token(cfg)
    cap = mix["write_cap_bytes"]
    prompts: dict[int, np.ndarray] = {}
    served: dict[int, list[int]] = {}
    last_token: dict[int, float] = {}
    timeline: dict[int, dict] = {}   # per request: host-clock submission, first token
    capped: list[int] = []
    committed = [0]

    def submit_next() -> None:
        # the KV a run writes stays under the cap: each document reserves
        # its prompt and all its decode steps when it is submitted
        doc = next(docs)
        need = (len(doc) + mix["decode_tokens"]) * bpt
        if committed[0] + need > cap:
            if not capped:
                capped.append(acct.write_bytes)
                emit(json.dumps({"write_cap": {"written_bytes": acct.write_bytes,
                                               "reserved_bytes": committed[0],
                                               "next_document_bytes": need, "cap_bytes": cap,
                                               "note": "no further document is admitted"}}))
            return
        committed[0] += need
        rid = sess.submit(doc, mix["decode_tokens"])
        prompts[rid], served[rid] = doc, []
        timeline[rid] = {"submitted": time.perf_counter(), "first_token": None}

    def step() -> tuple[int, list[float]]:
        k = len(eng.step_log)
        events = sess.step()
        _sync(dev)
        now = time.perf_counter()
        n, gaps = 0, []
        for ev in events:
            if ev["type"] == "token":
                served[ev["rid"]].append(ev["token"])
                if timeline[ev["rid"]]["first_token"] is None:
                    timeline[ev["rid"]]["first_token"] = now
                if ev["rid"] in last_token:
                    gaps.append(now - last_token[ev["rid"]])
                last_token[ev["rid"]] = now
                n += 1
            elif ev["type"] == "admit":
                first_step[ev["rid"]], slot_of[ev["rid"]] = k, ev["slot"]
                logits_of[ev["rid"]] = (sampled[len(logits_of)] if len(sampled) > len(logits_of)
                                        else None)
            elif ev["type"] == "finish":
                submit_next()
        return n, gaps

    for _ in range(mix["slots"]):
        submit_next()
    for _ in range(1 + mix["warm_steps"]):
        step()
    setup_peak = _peak(dev)
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)

    spans = devtrace.Spans()
    capture = devtrace.LaunchCapture()
    prof = None
    if trace:
        for attr in ("embed", "predict_query", "gather_context", "decode_block", "logits"):
            spans.wrap(eng.model, attr, f"model.{attr}")
        spans.wrap(eng, "admit_row", "engine.admit_row")
        capture.__enter__()
        if dev.type == "cuda":
            from torch.profiler import ProfilerActivity, profile

            prof = profile(activities=[ProfilerActivity.CUDA])
            prof.__enter__()
    # the set-up's objects live for the whole run: the collector need not
    # walk them again in every collection inside the window; and the KV the
    # admissions wrote goes to the disk now, not by the kernel's writeback in
    # the middle of the window
    gc.collect()
    gc.freeze()
    os.sync()
    smi_before = _smi(dev)
    read0, steps0 = acct.read_bytes, len(eng.step_log)
    tokens, itl, walls = 0, [], []
    t_setup = time.perf_counter() - t_start
    w0_ns = time.time_ns()
    t0 = last = time.perf_counter()
    while sess.has_work:
        s0 = time.time_ns()
        n, gaps = step()
        now = time.perf_counter()
        spans.add("session.step", s0, time.time_ns())
        tokens += n
        itl += gaps
        walls.append(now - last)
        last = now
        if now - t0 >= seconds:
            break
    window_s = last - t0
    w1_ns = time.time_ns()
    if prof is not None:
        prof.__exit__(None, None, None)
    capture.__exit__(None, None, None)
    spans.restore()
    window_peak = _peak(dev)
    gc.unfreeze()
    quarter = max(1, len(walls) // 4)
    emit(json.dumps({"window": {
        "steps": len(walls), "step_ms_first_quarter": 1e3 * statistics.median(walls[:quarter]),
        "step_ms_last_quarter": 1e3 * statistics.median(walls[-quarter:]),
        "gc_collections": [g["collections"] for g in gc.get_stats()],
        "step_ms": [round(1e3 * x, 1) for x in walls],
        "nvidia_smi_before": smi_before, "nvidia_smi_after": _smi(dev)}}))
    rec = {
        "setup_s": t_setup, "window_s": window_s, "tokens": tokens, "itl_s": itl,
        "step_wall_s": walls, "admit_s": admit_s,
        # each request's submission and first token, seconds from the window's start
        "requests": [{k: (None if v is None else v - t0) for k, v in timeline[r].items()}
                     | {"served": len(served[r])} for r in prompts],
        "io_wait_s": [s.io_wait_seconds for s in eng.step_log[steps0:]],
        "decoded_rows": sum(s.active_rows for s in eng.step_log[steps0:]),
        "read_bytes": acct.read_bytes - read0, "written_bytes": acct.write_bytes,
        "peak_window_bytes": window_peak, "param_bytes": param_bytes,
        "flops_per_token": fam.flops_per_token(cfg), "peak_flops": roofline.FP32_FLOPS_PER_S,
        "cfg": cfg,
        "trace": None, "on_card": dev.type == "cuda",
    }
    failed = len(sess.failed) + sess.rejected
    eng.layer_hook = None
    port_api.make_row_sampler = make_sampler
    ctx["decode"] = None
    if moe_dispatch is not None:
        port_layers._moe_dispatch = moe_dispatch
    routes_decode = {key: e.cpu() for key, e in routes_decode.items()}
    requests = [choices({"prompt": prompts[r], "served": np.asarray(served[r], np.int64),
                         "logits": np.concatenate(logits_of[r]) if logits_of.get(r) else None},
                        picks, routes_admit, routes_decode, first_step.get(r), slot_of.get(r),
                        pcfg.n_layers, engine["group_size"], bool(cfg.get("num_experts")))
                for r in prompts if r in first_step]    # a request still waiting served nothing
    del picks, routes_decode, routes_admit
    attempted = len(eng.admit_log)
    if trace:
        work = capture.work()
        red = devtrace.reduce(devtrace.device_events(prof) if prof is not None else [],
                              spans.items, w0_ns, w1_ns)
        dev_s = devtrace.kernel_device_seconds(red["ops_s"])
        rec["trace"] = {**red, "kernels": {k: {**work.get(k, {}), "device_s": dev_s[k]}
                                           for k in devtrace.KERNELS}}
    del capture, spans
    sess.close()
    del sess, eng, acct, model, params, admit_row, timed_admit
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()

    loaded = bench.forbidden_modules()
    if loaded:
        print(f"forbidden modules loaded: {loaded}", file=sys.stderr)
        raise SystemExit(3)

    metrics = bench.read_metrics(bench.metrics_for(man, name, trace), rec)
    emit(json.dumps({"kernel_build_s": build, "kv_written_bytes": rec["written_bytes"],
                     "write_cap_bytes": cap,
                     "cap_reached": bool(capped), "window_steps": len(walls),
                     "window_tokens": tokens}))
    got = check.compare(w, cfg, requests, seed, dev, control=control)
    lim = cfg["correct"]
    checks = {"logit_error": {"value": got["error"], "limit": lim["max_logit_error"]},
              "selection_slack": {"value": got["slack"], "limit": lim["max_selection_slack"]},
              "routing_slack": {"value": got["routing_slack"],
                                "limit": lim.get("max_routing_slack", 0.0)},
              "selections_missing": {"value": got["missing"], "limit": 0},
              "failed_requests": {"value": failed, "limit": 0},
              "tokens_compared": {"value": got["tokens"], "min": 1}}
    program_correct = verdict(checks)
    correct = program_correct
    if control:
        # the control in the program's place: its numbers, under the same
        # limits, decide ``correct``; the program's stay beside them
        judged = {"control_error": {"value": got["control_error"],
                                    "limit": lim["max_logit_error"]},
                  "control_slack": {"value": got["control_slack"],
                                    "limit": lim["max_selection_slack"]},
                  "control_routing_slack": {"value": got["control_routing_slack"],
                                            "limit": lim.get("max_routing_slack", 0.0)},
                  "tokens_compared": checks["tokens_compared"]}
        correct = verdict(judged)
        checks |= judged
    device_out = {"platform": "gpu" if dev.type == "cuda" else dev.type,
                  "kind": torch.cuda.get_device_name(dev) if dev.type == "cuda" else dev.type,
                  "count": cell["chips"], "memory_peak_bytes": max(setup_peak, window_peak)}
    out = {"correct": correct, "attempted": attempted, "failed": failed, "metrics": metrics,
           "device": device_out}
    if control:
        out["program_correct"] = program_correct
    if trace and rec["trace"] is not None:
        device_out["busy_s"] = rec["trace"]["busy_s"]
        device_out["window_s"] = rec["trace"]["window_s"]
        out["breakdown"] = {"device_ops": devtrace.top(rec["trace"]["ops_s"]),
                            "idle_gaps": devtrace.top(rec["trace"]["idle_s"])}
    out["checks"] = checks
    for key, c in checks.items():
        bound = f"limit {c['limit']}" if "limit" in c else f"min {c['min']}"
        print(f"check {key} {c['value']} {bound}", file=sys.stderr)
    return out


def verdict(checks: dict) -> bool:
    """Correct: every number at or under its limit, and each minimum met."""
    return all(c["value"] <= c["limit"] if "limit" in c else c["value"] >= c["min"]
               for c in checks.values())


def choices(req: dict, picks: dict, routes_admit: dict, routes_decode: dict,
            first: int | None, slot: int | None, n_layers: int, g: int, moe: bool) -> dict:
    """The program's choices for one request (``first``: the engine step of
    its first decode, which admitted it; ``slot``: its engine row): its group
    selection at each decode position, one ``[Td, n_groups]`` mask a layer;
    with ``moe``, its experts at every position, one ``[T, k]`` a layer; and
    how many choices were not observed."""
    import torch

    td = max(len(req["served"]) - 1, 0)
    n_prompt = len(req["prompt"])
    masks = [torch.zeros((td, -(-(n_prompt + td) // g)), dtype=torch.bool)
             for _ in range(n_layers)]
    routes = None
    missing = 0
    if first is None or req["logits"] is None or len(req["logits"]) != len(req["served"]):
        return {**req, "selections": masks, "routes": routes, "missing": 1}
    admitted = routes_admit.get((first, slot), []) if moe else None
    if moe:
        if len(admitted) != n_layers:
            return {**req, "selections": masks, "routes": routes, "missing": 1}
        routes = [[a.reshape(n_prompt, -1)] for a in admitted]
    for i in range(td):
        for layer in range(n_layers):
            got = picks.get((first + i, layer))
            if got is None:
                missing += 1
                continue
            ids, keep = got
            masks[layer][i, torch.as_tensor(ids[slot][keep[slot]], dtype=torch.long)] = True
            if moe:
                e = routes_decode.get((first + i, layer))
                if e is None:
                    missing += 1
                    continue
                routes[layer].append(e[slot].reshape(1, -1))
    if moe and not missing:
        routes = [torch.cat(r) for r in routes]
    return {**req, "selections": masks, "routes": routes, "missing": missing}


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    from kvbench import bench

    chips = bench.workload(bench.load_manifest(ROOT), args.workload)["chips"]
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"this cell needs {chips} CUDA device(s); "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0} available",
              file=sys.stderr)
        return 2
    out = run_cell(args.workload, args.seed, args.seconds, bool(args.trace))
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
