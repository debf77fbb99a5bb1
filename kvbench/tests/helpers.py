"""A copy of the benchmark with tiny cells, for rehearsals on the CPU."""

from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parents[2]

TINY = dict(source="test", hidden_size=64, intermediate_size=32, num_hidden_layers=2,
            num_attention_heads=4, num_key_value_heads=2, num_experts=4, num_experts_per_tok=2,
            vocab_size=256, rope_theta=10000.0, rms_norm_eps=1e-6, norm_topk_prob=True,
            tie_word_embeddings=False, model="decoder",
            engine=dict(group_size=4, n_select=3, rank=8, reuse_capacity=4, max_seq=128,
                        device_resident=True, async_io=True, io_threads=2, disk="nvme",
                        moe_capacity_factor=2.0, calib_tokens=32),
            correct=dict(max_logit_error=1e-4, max_selection_slack=1e-5, max_routing_slack=1e-5))
TINY_DENSE = {**{k: v for k, v in TINY.items() if k not in ("num_experts", "num_experts_per_tok")},
              "tie_word_embeddings": True,
              "engine": {**TINY["engine"], "group_size": 2, "n_select": 4, "reuse_capacity": 3}}
TINY_DOCS = dict(kind="closed_loop_documents", slots=2, doc_tokens=[24, 33, 40], decode_tokens=7,
                 warm_steps=2, write_cap_bytes=100_000)


def copy_with_tiny_cells(dest: Path) -> Path:
    """``dest`` holding ``BENCHMARK.json`` and ``kvbench/`` with two tiny
    cells (MoE and dense) added as files and manifest entries only."""
    shutil.copytree(REPO / "kvbench", dest / "kvbench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    man = json.loads((REPO / "BENCHMARK.json").read_text())
    for name, cfg in (("tiny-moe", TINY), ("tiny-dense", TINY_DENSE)):
        (dest / "kvbench" / "configs" / f"{name}.json").write_text(json.dumps(cfg))
        man["configs"].append(dict(name=name, source="test", file=f"kvbench/configs/{name}.json",
                                   reduced=[], why="test"))
        man["workloads"].append(dict(name=name, config=name, traffic="tiny-docs", chips=1, why="test"))
        for metric in man["end_to_end"]:    # a new cell reports every end-to-end metric
            metric.get("workloads", []).append(name)
    (dest / "kvbench" / "traffic" / "tiny-docs.json").write_text(json.dumps(TINY_DOCS))
    (dest / "BENCHMARK.json").write_text(json.dumps(man))
    return dest


def rehearse(root: Path, script: str, env: dict | None = None) -> subprocess.CompletedProcess:
    """Run ``script`` in a fresh interpreter that imports ``kvbench`` from
    ``root`` and the program from this repository."""
    full = {**os.environ, "PYTHONPATH": f"{root}{os.pathsep}{REPO / 'src'}", **(env or {})}
    return subprocess.run([sys.executable, "-c", script], cwd=root, env=full,
                          capture_output=True, text=True, timeout=600)
