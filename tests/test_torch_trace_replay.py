"""Trace replay through the port's ``ServeSession`` against the JAX
package's replay, and the port's ``obs.report`` against the reference's.

Replays run with ``async_io=False`` (the reference's determinism contract:
accountant floats then add up in one order).  The metrics JSON holds only
modeled quantities, so it equals the reference's byte for byte: the same
selections give the same I/O charges, the same admissions the same
modeled prefill seconds.  Inside the port, two replays of one trace give
the same bytes.  The report CLI prints the same text over the same trace
file.
"""

import dataclasses
import json

import jax
import numpy as np
import pytest

from repro.cache import PrefixCache as JCache, PrefixCacheConfig as JCacheConfig
from repro.core.engine import EngineConfig as JConfig
from repro.obs import Observability as JObservability
from repro.obs.report import main as jreport
from repro.serving import trace as jtrace
from repro.serving.api import ServeSession as JSession
from repro.serving.metrics import SLOClass as JSLOClass
from repro_torch.bridge import params_from_numpy
from repro_torch.cache import PrefixCache, PrefixCacheConfig
from repro_torch.core.engine import EngineConfig
from repro_torch.models.transformer import ModelConfig, TransformerAdapter
from repro_torch.obs import Observability
from repro_torch.obs.report import main as report
from repro_torch.serving import ServeSession, Trace, burst_trace, chat_trace, replay
from repro_torch.serving.metrics import SLOClass

CFG = dict(group_size=4, n_select=6, rank=8, reuse_capacity=12, max_seq=128,
           predict_from="self", async_io=False)
SLO = {"interactive": SLOClass("interactive", ttft_s=0.5, tpot_s=0.1),
       "batch": SLOClass("batch", ttft_s=2.0, tpot_s=0.5),
       "bulk": SLOClass("bulk", ttft_s=1.5, tpot_s=0.3)}
JSLO = {name: JSLOClass(c.name, c.ttft_s, c.tpot_s) for name, c in SLO.items()}


@pytest.fixture(scope="module")
def parts(tiny_cfg, tiny_params, tiny_adapter):
    params = params_from_numpy(jax.tree_util.tree_map(np.asarray, tiny_params), "cpu")
    calib = np.random.default_rng(5).standard_normal(
        (256, tiny_cfg.n_kv_heads, tiny_cfg.head_dim)).astype(np.float32)
    return (tiny_adapter, tiny_params,
            TransformerAdapter(ModelConfig(**dataclasses.asdict(tiny_cfg))), params, calib)


def session(parts, slots=2, **kw):
    _, _, model, params, calib = parts
    return ServeSession(model, params, EngineConfig(**CFG), slots=slots, calib_k=calib,
                        device="cpu", **kw)


def ref_session(parts, slots=2, **kw):
    jm, jp, _, _, calib = parts
    return JSession(jm, jp, JConfig(**CFG), slots=slots, calib_k=calib, **kw)


def tiny_burst(slo=SLO, gen=burst_trace):
    return gen(3, bursts=2, burst_size=3, quiet_s=0.1, within_s=0.01, prompt_tokens=(16, 24),
               max_new_choices=(3, 5), slo_classes=slo, vocab_size=97)


def tiny_chat(slo=SLO, gen=chat_trace):
    return gen(7, conversations=1, turns=3, sys_tokens=24, user_tokens=8, max_new=4,
               turn_gap_s=1.0, slo_classes=slo, vocab_size=97)


def blob(metrics: dict) -> str:
    return json.dumps(metrics, sort_keys=True)


def test_replay_matches_reference(parts):
    with session(parts) as sess:
        got = replay(tiny_burst(), sess)
    with ref_session(parts) as js:
        want = jtrace.replay(tiny_burst(JSLO, jtrace.burst_trace), js)
    assert blob(got) == blob(want)
    assert got["requests"] == 6 and got["cached_prompt_tokens"] == 0


def test_chat_replay_with_cache_matches_reference(parts):
    """The chat workload through a cached session restores its later turns,
    token for token and second for second as the reference does."""
    with PrefixCache(PrefixCacheConfig(block_tokens=8)) as pc, \
            session(parts, slots=1, prefix_cache=pc) as sess:
        got = replay(tiny_chat(), sess)
    with JCache(JCacheConfig(block_tokens=8)) as jc, \
            ref_session(parts, slots=1, prefix_cache=jc) as js:
        want = jtrace.replay(tiny_chat(JSLO, jtrace.chat_trace), js)
    assert blob(got) == blob(want)
    assert got["cached_prompt_tokens"] > 0


def test_replay_twice_and_via_file_byte_identical(parts, tmp_path):
    tr = tiny_burst()
    tr.save(tmp_path / "t.jsonl")
    blobs = []
    for t in (tr, tr, Trace.load(tmp_path / "t.jsonl")):
        with session(parts) as sess:
            blobs.append(blob(replay(t, sess)))
    assert blobs[0] == blobs[1] == blobs[2]


def test_lifecycle_timestamps_ordered(parts):
    tr = tiny_burst()
    with session(parts) as sess:
        m = replay(tr, sess)
        reqs = sess.completed
    assert m["requests"] == tr.n_requests
    assert 0.0 <= m["goodput_under_slo_tokens_per_s"] <= m["goodput_tokens_per_s"] + 1e-12
    for rec in m["per_request"]:
        assert rec["arrival"] <= rec["admitted_at"] <= rec["first_token_at"] <= rec["finished_at"]
        assert rec["ttft_seconds"] > 0 and rec["tpot_seconds"] >= 0
        assert rec["tokens"] == len(reqs[rec["rid"]].output)


def test_replay_requires_fresh_session(parts):
    with session(parts) as sess:
        sess.submit(np.arange(8), max_new=1)
        sess.drain()
        with pytest.raises(ValueError, match="fresh"):
            replay(tiny_burst(), sess)


def _exported(parts, tmp_path) -> str:
    obs = Observability()
    with session(parts, obs=obs) as sess:
        replay(tiny_burst(), sess)
    path = str(tmp_path / "trace.json")
    obs.export_trace(path)
    return path


def test_report_matches_reference(parts, tmp_path, capsys):
    """The port's report and the reference's print the same tables over the
    port's exported trace, and both accept its schema."""
    path = _exported(parts, tmp_path)
    outs = []
    for main in (report, jreport):
        assert main([path]) == 0
        assert main([path, "--check"]) == 0
        outs.append(capsys.readouterr().out)
    assert outs[0] == outs[1]
    assert "== modeled overlap ==" in outs[0]


def test_report_reads_the_reference_trace_and_rejects_a_bad_one(parts, tmp_path, capsys):
    """A trace the reference exports reads the same through both reports;
    a span without a duration fails ``--check`` in both."""
    jm, jp, _, _, calib = parts
    obs = JObservability()
    with JSession(jm, jp, JConfig(**CFG), slots=2, calib_k=calib, obs=obs) as js:
        jtrace.replay(tiny_burst(JSLO, jtrace.burst_trace), js)
    path = str(tmp_path / "ref.json")
    obs.export_trace(path)
    assert report([path]) == 0
    ours = capsys.readouterr().out
    assert jreport([path]) == 0
    assert capsys.readouterr().out == ours
    bad = tmp_path / "bad.json"
    bad.write_text(json.dumps({"traceEvents": [{"name": "a", "ph": "X", "pid": 1, "tid": 1,
                                                "ts": 0}]}))
    assert report([str(bad), "--check"]) == 1
    assert jreport([str(bad), "--check"]) == 1
