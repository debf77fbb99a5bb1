"""The port's trace format and generators (``repro_torch.serving.trace``)
against the JAX package's: the same seeds give the same requests and the
same JSONL bytes, a file written by either package loads in the other,
and the schema rules (round trip, version 1, foreign and future files)
are the reference's.  ``test_torch_trace_replay.py`` replays traces."""

import dataclasses
import json

import numpy as np
import pytest

from repro.serving import trace as jtrace
from repro.serving.metrics import SLOClass as JSLOClass
from repro_torch.serving import trace as ttrace
from repro_torch.serving.metrics import SLOClass
from repro_torch.utils.stats import percentile, percentiles

SLO = {"interactive": SLOClass("interactive", ttft_s=0.5, tpot_s=0.1),
       "batch": SLOClass("batch", ttft_s=2.0, tpot_s=0.5),
       "bulk": SLOClass("bulk", ttft_s=1.5, tpot_s=0.3)}
JSLO = {name: JSLOClass(c.name, c.ttft_s, c.tpot_s) for name, c in SLO.items()}
WORKLOADS = sorted(ttrace.GENERATORS)


def test_generator_names_match_reference():
    assert WORKLOADS == sorted(jtrace.GENERATORS)
    assert (ttrace.TRACE_FORMAT, ttrace.TRACE_VERSION) == (jtrace.TRACE_FORMAT,
                                                            jtrace.TRACE_VERSION)


@pytest.mark.parametrize("workload", WORKLOADS)
@pytest.mark.parametrize("seed,vocab", [(7, 512), (0, 128256)])
def test_dumped_jsonl_byte_equal_to_reference(tmp_path, workload, seed, vocab):
    """Each generator's file is the reference's, byte for byte, and each
    package loads the other's file into the same requests and prompts."""
    ours = ttrace.GENERATORS[workload](seed, slo_classes=SLO, vocab_size=vocab)
    theirs = jtrace.GENERATORS[workload](seed, slo_classes=JSLO, vocab_size=vocab)
    ours.save(tmp_path / "port.jsonl")
    theirs.save(tmp_path / "ref.jsonl")
    assert (tmp_path / "port.jsonl").read_bytes() == (tmp_path / "ref.jsonl").read_bytes()
    loaded = jtrace.Trace.load(tmp_path / "port.jsonl")
    assert [dataclasses.asdict(r) for r in ttrace.Trace.load(tmp_path / "ref.jsonl").requests] \
        == [dataclasses.asdict(r) for r in loaded.requests]
    for a, b in zip(ours.prompts(), loaded.prompts()):
        np.testing.assert_array_equal(a, b)


def test_router_path_trace_matches_reference(tmp_path):
    """The chip run's router trace: three tenants, three turns, a 1024-token
    system segment and 128 more a turn, at Llama-3.1-8B's vocabulary."""
    kw = dict(tenants=3, turns=3, sys_tokens=1024, user_tokens=128, max_new=16,
              turn_gap_s=20.0, vocab_size=128256)
    ours = ttrace.mixed_tenant_trace(0, slo_classes=SLO, **kw)
    theirs = jtrace.mixed_tenant_trace(0, slo_classes=JSLO, **kw)
    ours.save(tmp_path / "a.jsonl")
    theirs.save(tmp_path / "b.jsonl")
    assert (tmp_path / "a.jsonl").read_bytes() == (tmp_path / "b.jsonl").read_bytes()
    assert sorted(r.prompt_tokens for r in ours.requests) == [1152] * 3 + [1280] * 3 + [1408] * 3


@pytest.mark.parametrize("workload", WORKLOADS)
def test_roundtrip_generate_dump_load(tmp_path, workload):
    tr = ttrace.GENERATORS[workload](7, slo_classes=SLO)
    tr.save(tmp_path / "t.jsonl")
    tr2 = ttrace.Trace.load(tmp_path / "t.jsonl")
    assert tr2 == tr
    for a, b in zip(tr.prompts(), tr2.prompts()):
        np.testing.assert_array_equal(a, b)


def test_explicit_tokens_roundtrip(tmp_path):
    tr = ttrace.Trace(workload="hand", seed=0, vocab_size=10, slo_classes={},
                      requests=[ttrace.TraceRequest(rid=0, arrival=0.0, max_new=2,
                                                    tokens=(1, 2, 3))])
    tr.save(tmp_path / "hand.jsonl")
    np.testing.assert_array_equal(
        ttrace.Trace.load(tmp_path / "hand.jsonl").requests[0].materialize(10), [1, 2, 3])


def test_load_rejects_foreign_and_future_accepts_version_1(tmp_path):
    p = tmp_path / "bad.jsonl"
    p.write_text(json.dumps({"format": "something-else"}) + "\n")
    with pytest.raises(ValueError, match="not a kvswap-trace"):
        ttrace.Trace.load(p)
    p.write_text(json.dumps({"format": "kvswap-trace", "version": 99, "workload": "x",
                             "seed": 0, "vocab_size": 8}) + "\n")
    with pytest.raises(ValueError, match="newer"):
        ttrace.Trace.load(p)
    p.write_text(json.dumps({"format": "kvswap-trace", "version": 1, "workload": "chat",
                             "seed": 7, "vocab_size": 97, "slo_classes": {}}) + "\n"
                 + json.dumps({"rid": 0, "arrival": 0.0, "max_new": 2,
                               "slo_class": "interactive", "segments": [[7000001, 8]]}) + "\n")
    tr = ttrace.Trace.load(p)
    assert tr.version == 1 and tr.requests[0].tenant == ""


def test_turns_extend_each_other():
    """Chat and mixed-tenant turns extend the previous turn token for token
    (the prefix-reuse shape the router relies on)."""
    for tr, key in ((ttrace.chat_trace(7, conversations=2, turns=3, slo_classes=SLO),
                     lambda r: r.segments[0]),
                    (ttrace.mixed_tenant_trace(7, tenants=3, turns=2, slo_classes=SLO),
                     lambda r: r.tenant)):
        groups: dict = {}
        for r in tr.requests:
            groups.setdefault(key(r), []).append(r)
        for turns in groups.values():
            turns.sort(key=lambda r: len(r.segments))
            for prev, cur in zip(turns, turns[1:]):
                a, b = prev.materialize(tr.vocab_size), cur.materialize(tr.vocab_size)
                np.testing.assert_array_equal(a, b[:len(a)])


def test_segment_seeds_match_reference():
    ours, theirs = ttrace._SegmentSeeds(7), jtrace._SegmentSeeds(7)
    a = [ours.next() for _ in range(100)]
    assert a == [theirs.next() for _ in range(100)]
    assert len(set(a)) == 100 and ttrace._SegmentSeeds(8).next() not in a


def test_percentiles_match_numpy():
    xs = np.random.default_rng(0).standard_normal(37).tolist()
    for q in (0, 13, 50, 95, 99, 100):
        assert percentile(xs, q) == pytest.approx(float(np.percentile(xs, q)), abs=1e-12)
    assert set(percentiles([1.0, 2.0])) == {"p50", "p95", "p99"}
