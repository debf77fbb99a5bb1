"""The harness on the CPU, in a copy of the benchmark with tiny cells:
files found by name, what a run loads, where its KV store lives, what it
writes, and how it refuses to run without a card."""

import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

from kvbench.tests.helpers import REPO, TINY_DOCS, copy_with_tiny_cells, rehearse

GIB = 2**30


def result(proc):
    assert proc.returncode == 0, proc.stderr[-3000:]
    lines = [json.loads(x) for x in proc.stdout.splitlines() if x.startswith("{")]
    return lines[:-1], lines[-1]


RUN = """
import json, sys
from kvbench.run import run_cell
from kvbench import bench
out = run_cell({name!r}, {seed}, {seconds}, {trace}, device="cpu")
print(json.dumps(out))
"""


def run_script(seconds=0.5, **kw) -> str:
    return RUN.format(seconds=seconds, **kw)


@pytest.fixture(scope="module")
def copy(tmp_path_factory):
    return copy_with_tiny_cells(tmp_path_factory.mktemp("bench"))


def test_new_cell_config_and_metric_are_found_by_name(copy):
    """A cell, its configuration, its traffic mix and a per-layer metric
    added as files and manifest entries only are found and run; the earlier
    lines record the card, the host, torch, the engine tuple and the KV
    bytes written, and ``device`` names the card."""
    man = json.loads((copy / "BENCHMARK.json").read_text())
    man["per_layer"].append({"name": "decoded_rows_per_step", "unit": "rows", "better": "higher",
                             "source": "program_counter", "layer": "engine decode step",
                             "moves": "tokens_per_s", "workloads": ["tiny-dense"]})
    (copy / "BENCHMARK.json").write_text(json.dumps(man))
    (copy / "kvbench" / "metrics" / "decoded_rows_per_step.py").write_text(
        "def read(rec):\n    n = len(rec['step_wall_s'])\n"
        "    return rec['decoded_rows'] / n if n else None\n")
    early, out = result(rehearse(copy, run_script(name="tiny-dense", seed=2**31 + 5, trace=1)))
    assert out["correct"] is True
    assert out["metrics"]["decoded_rows_per_step"]["value"] > 0
    assert {"step_ms", "admit_ms", "io_wait_ms", "read_kib_per_token"} <= set(out["metrics"])
    env = early[0]["env"]
    assert {"card", "nvidia_smi", "host_cpu", "torch", "engine"} <= set(env)
    assert env["engine"]["n_select"] == 4
    assert any("kv_written_bytes" in line for line in early)
    assert out["device"]["kind"] == "cpu" and list(out)[-1] == "checks"
    _, plain = result(rehearse(copy, run_script(name="tiny-moe", seed=3, trace=0)))
    assert set(plain["metrics"]) == {"tokens_per_s", "itl_p90_ms", "setup_s"}   # no card: no memory


def test_run_loads_no_jax_and_the_reference_nothing_of_the_program(copy):
    script = run_script(name="tiny-moe", seed=9, trace=0) + (
        "import kvbench.reference.decoder\n"
        "print(json.dumps({'forbidden': bench.forbidden_modules()}))\n")
    proc = rehearse(copy, script)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert json.loads(proc.stdout.splitlines()[-1]) == {"forbidden": []}
    proc = rehearse(copy, "import sys, kvbench.reference.decoder, kvbench.check\n"
                          "print(sorted({m.split('.')[0] for m in sys.modules}))")
    tops = set(json.loads(proc.stdout.splitlines()[-1].replace("'", '"')))
    assert not tops & {"repro_torch", "repro", "jax", "jaxlib", "flax"}


def test_forbidden_names_are_compared_whole():
    from kvbench import bench

    sys.modules["repro_torch_lookalike"] = sys  # a name that only begins with "repro"
    try:
        assert "repro_torch_lookalike" not in bench.forbidden_modules()
        sys.modules["repro.fake"] = sys
        assert bench.forbidden_modules() == ["repro.fake"]
    finally:
        sys.modules.pop("repro_torch_lookalike")
        sys.modules.pop("repro.fake", None)


def test_kv_store_lives_in_tmpdir_and_is_deleted(copy, tmp_path):
    tmpdir = tmp_path / "tmpdir"
    tmpdir.mkdir()
    shm = set(os.listdir("/dev/shm")) if os.path.isdir("/dev/shm") else set()
    tmp = set(os.listdir("/tmp"))
    script = ("import json, tempfile\n"
              "made = []\n"
              "orig = tempfile.mkstemp\n"
              "def mkstemp(*a, **k):\n"
              "    fd, path = orig(*a, **k)\n"
              "    made.append(path)\n"
              "    return fd, path\n"
              "tempfile.mkstemp = mkstemp\n"
              + run_script(name="tiny-moe", seed=4, trace=0) +
              "print(json.dumps(made))\n")
    proc = rehearse(copy, script, env={"TMPDIR": str(tmpdir)})
    assert proc.returncode == 0, proc.stderr[-3000:]
    made = json.loads(proc.stdout.splitlines()[-1])
    assert made and all(Path(p).parent == tmpdir for p in made)
    assert list(tmpdir.iterdir()) == []
    assert (set(os.listdir("/dev/shm")) if os.path.isdir("/dev/shm") else set()) <= shm
    assert set(os.listdir("/tmp")) <= tmp | {tmp_path.parents[1].name}


def test_write_reckoning_under_the_cap():
    """Each cell's worst case (its largest documents and all their decode
    steps) fits the mix's cap, which is under 3.5 GiB; and the admission
    stop keeps a run's writes under a small cap."""
    from kvbench import bench
    from kvbench.models import decoder

    man = bench.load_manifest(REPO)
    for cell in man["workloads"]:
        cfg = bench.config(REPO, man, cell["config"])
        mix = bench.traffic(cell["traffic"])
        assert mix["write_cap_bytes"] <= 3.5 * GIB
        first = sorted(mix["doc_tokens"])[-mix["slots"]:]
        worst = (sum(first) + mix["slots"] * mix["decode_tokens"]) * decoder.kv_bytes_per_token(cfg)
        assert worst <= mix["write_cap_bytes"], cell["name"]


def test_each_cell_reports_what_its_metrics_need():
    """Every cell reports ``setup_s``, another end-to-end metric and a
    per-layer one; a per-layer metric's cells report the metric it moves;
    every metric has its reader, and a metric read per layer under another
    name reads as the end-to-end one does."""
    from kvbench import bench

    man = bench.load_manifest(REPO)
    names = {c["name"] for c in man["workloads"]}
    for cell in names:
        e2e = {m["name"] for m in bench.metrics_for(man, cell, False)}
        assert "setup_s" in e2e and len(e2e) >= 2, cell
        assert bench.metrics_for(man, cell, True), cell
    for m in man["end_to_end"] + man["per_layer"]:
        assert set(m.get("workloads", names)) <= names, m["name"]
        assert (bench.HERE / "metrics" / f"{m['name']}.py").is_file(), m["name"]
    for m in man["per_layer"]:
        for cell in m.get("workloads", ()):
            assert m["moves"] in {e["name"] for e in bench.metrics_for(man, cell, False)}, m
    rec = {"tokens": 120, "window_s": 4.0, "itl_s": [0.1, 0.2, 0.3], "step_wall_s": [0.1, 0.3],
           "io_wait_s": [0.01, 0.03], "read_bytes": 3 << 20, "decoded_rows": 120,
           "on_card": True, "trace": {"window_s": 4.0, "busy_s": 1.0}}
    for m in man["per_layer"]:
        base, _, suffix = m["name"].partition(".")
        if suffix:
            assert bench.reader(m["name"])(rec) == bench.reader(base)(rec), m["name"]


def test_admission_stop(copy):
    # the window outlasts the mix: after the stop the session drains and the
    # loop ends, however slow the host
    early, out = result(rehearse(copy, run_script(name="tiny-moe", seed=8, trace=0, seconds=120)))
    written = next(line for line in early if "kv_written_bytes" in line)
    assert written["cap_reached"] and written["kv_written_bytes"] <= TINY_DOCS["write_cap_bytes"]
    assert any("write_cap" in line for line in early)


CONTROL = """
from kvbench import check
real = check.compare
def compare(*args, **kwargs):
    got = real(*args, **kwargs)
    got["control_error"] = {control_error!r}
    return got
check.compare = compare
import json
from kvbench.run import run_cell
print(json.dumps(run_cell("tiny-dense", 31, 0.5, False, device="cpu", control=True)))
"""


@pytest.mark.parametrize("control_error", [0.0, 1.0])
def test_the_control_decides_a_control_run(copy, control_error):
    """With the control in the program's place, its numbers under the same
    limits decide ``correct`` (on the CPU the TF32 control reads as the
    reference, so its error is planted); the program's verdict stays apart."""
    _, out = result(rehearse(copy, CONTROL.format(control_error=control_error)))
    assert out["program_correct"] is True, out["checks"]
    assert out["correct"] is (control_error == 0.0), out["checks"]
    assert out["checks"]["control_error"]["value"] == control_error
    assert list(out)[-1] == "checks"


def test_no_card_no_result(copy):
    """On a host without a card the command exits 2 and prints no result;
    so does a checkout without the program."""
    for root in (REPO, copy):
        proc = subprocess.run([sys.executable, "kvbench/run.py", "--workload", "olmoe-docs-decode",
                               "--seed", "1", "--seconds", "1", "--trace", "0"],
                              cwd=root, capture_output=True, text=True, timeout=300)
        assert proc.returncode == 2 and not proc.stdout.strip()
