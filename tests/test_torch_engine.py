"""The port's ``KVSwapEngine`` against the JAX engine, and its own
bit-identity grid.

Port vs reference (``tiny_cfg``, the reference's weights through the
bridge, the same calibration K): equal greedy tokens, equal per-layer
``(ids, mask)`` at every step, equal ``IOAccountant.snapshot()``, equal
modeled ``StepStats``, and logits within 1e-4 (fp32 on both sides; XLA's
fused decode block and PyTorch's eager one round differently by a few
ulps per layer).

Exact selections across two frameworks hold only away from near-ties, so
the test also checks at every step and layer that the gap between the
M-th and the (M+1)-th group score exceeds 1e-4 of the row's score scale.
The seeds below were chosen so that no step comes closer (the check fails
loudly, naming the step, if a change of inputs brings a near-tie).
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro.core.engine import EngineConfig as JConfig, KVSwapEngine as JEngine
from repro_torch.bridge import params_from_numpy
from repro_torch.core.engine import EngineConfig, KVSwapEngine
from repro_torch.kernels import ops
from repro_torch.models.transformer import ModelConfig, TransformerAdapter
from repro_torch.serving import ServeSession

CFG = dict(group_size=4, n_select=6, rank=8, reuse_capacity=4, max_seq=128)
STEPS = 12
PROMPT_LEN = 30          # 7 full groups + a partial one of 2 tokens
GAP_RTOL = 1e-4
STAT_FIELDS = ("io_seconds", "compute_seconds", "pipelined_seconds", "io_bytes",
               "io_requests", "h2d_bytes", "active_rows")


@pytest.fixture(scope="module")
def port_model(tiny_cfg, tiny_params):
    params = params_from_numpy(jax.tree_util.tree_map(np.asarray, tiny_params), "cpu")
    return TransformerAdapter(ModelConfig(**dataclasses.asdict(tiny_cfg))), params


@pytest.fixture(scope="module")
def calib(tiny_cfg):
    return np.random.default_rng(11).standard_normal(
        (256, tiny_cfg.n_kv_heads, tiny_cfg.head_dim)).astype(np.float32)


def record(engine, calls: list, port: bool):
    """Wrap the engine's per-layer selection to log ``(ids, mask)``."""
    inner = engine._predict_for

    def logged(*args):
        ids, mask = inner(*args)
        calls.append((np.asarray(ids).copy(), np.asarray(mask).copy()))
        return ids, mask

    engine._predict_for = logged
    if port:
        predict = engine._predict

        def gap_checked(j, q_pred, valid):
            # the same scores the selection sees, recomputed op by op
            q_lr = torch.einsum("bhd,hdr->bhr", q_pred.float(),
                                torch.repeat_interleave(engine._per_head_a,
                                                        q_pred.shape[1] // engine._per_head_a.shape[0], 0))
            gs = ops.lowrank_group_scores_plain(q_lr, engine.k_lr[j], valid,
                                                group_size=engine.cfg.group_size)
            srt = torch.sort(gs, dim=1, descending=True).values
            m = engine.n_select
            for bi in range(gs.shape[0]):
                if srt.shape[1] <= m or srt[bi, m] <= -1e29:
                    continue
                scale = float(srt[bi][srt[bi] > -1e29].abs().max())
                gap = float(srt[bi, m - 1] - srt[bi, m])
                assert gap > GAP_RTOL * scale, (
                    f"near-tie at step {len(engine.step_log)} layer {j} row {bi}: "
                    f"gap {gap:.3g}; choose another seed")
            return predict(j, q_pred, valid)

        engine._predict = gap_checked


def test_port_matches_reference_engine(tiny_cfg, tiny_adapter, tiny_params, port_model, calib):
    prompt = np.random.default_rng(5).integers(0, tiny_cfg.vocab_size, (2, PROMPT_LEN))

    def run(engine, port: bool):
        calls, logits = [], []
        record(engine, calls, port)
        step = engine.decode_step

        def logged_step(tok):
            out = step(tok)
            logits.append(np.asarray(out.numpy() if port else out))
            return out

        engine.decode_step = logged_step
        tokens = engine.generate(prompt, STEPS)
        snap = engine.accountant.snapshot()
        stats = [{f: getattr(s, f) for f in STAT_FIELDS} for s in engine.step_log]
        engine.close()
        return tokens, calls, logits, snap, stats

    want = run(JEngine(tiny_adapter, tiny_params, JConfig(**CFG), batch=2, calib_k=calib), False)
    got = run(KVSwapEngine(*port_model, EngineConfig(**CFG), batch=2, calib_k=calib,
                           device="cpu"), True)
    np.testing.assert_array_equal(got[0], want[0])                 # tokens
    assert len(got[1]) == len(want[1]) == STEPS * tiny_cfg.n_layers
    for (gi, gm), (wi, wm) in zip(got[1], want[1]):                # per-layer selections
        np.testing.assert_array_equal(gi, wi)
        np.testing.assert_array_equal(gm, wm)
    for gl, wl in zip(got[2], want[2]):                            # logits
        np.testing.assert_allclose(gl, wl, rtol=0, atol=1e-4)
    assert got[3] == want[3]                                       # I/O accounting
    assert got[4] == want[4]                                       # modeled StepStats


def test_device_mirror_counts_payload_only(port_model, calib, tiny_cfg):
    prompt = np.random.default_rng(6).integers(0, tiny_cfg.vocab_size, (2, 26))
    with KVSwapEngine(*port_model, EngineConfig(**CFG), batch=2, calib_k=calib,
                      device="cpu") as eng:
        eng.generate(prompt, 6)
        mirrors = [r.device for r in eng.reuse]
        assert all(m.padded_bytes == m.uploaded_bytes > 0 for m in mirrors)
        assert sum(m.uploaded_groups for m in mirrors) > 0
        assert all(m.scatter_calls >= 1 for m in mirrors)


# -- the port's own bit-identity grid (tests/test_equality_matrix.py's slice) --

GRID = dict(group_size=4, n_select=6, rank=8, reuse_capacity=4, max_seq=128,
            predict_from="self")
_REFS: dict = {}


def serve(port_model, calib, tiny_cfg, **kw):
    rng = np.random.default_rng(42)
    prompts = [rng.integers(0, tiny_cfg.vocab_size, 57), rng.integers(0, tiny_cfg.vocab_size, 49)]
    with ServeSession(*port_model, EngineConfig(**{**GRID, **kw}), slots=2,
                      calib_k=calib, device="cpu") as sess:
        rids = [sess.submit(p, 8) for p in prompts]
        done = sess.drain()
        return [done[r].output for r in rids]


@pytest.mark.parametrize("dr", [False, True], ids=["host", "resident"])
@pytest.mark.parametrize("aio", [False, True], ids=["sync", "async"])
@pytest.mark.parametrize("kvb", [16, 8], ids=["kv16", "kv8"])
def test_bit_identity_grid(port_model, calib, tiny_cfg, dr, aio, kvb):
    if kvb not in _REFS:
        _REFS[kvb] = serve(port_model, calib, tiny_cfg, device_resident=False,
                           async_io=False, kv_bits=kvb)
    got = serve(port_model, calib, tiny_cfg, device_resident=dr, async_io=aio, kv_bits=kvb)
    for g, w in zip(got, _REFS[kvb]):
        assert len(g) == 8
        np.testing.assert_array_equal(g, w)


# -- refusals of what later slices bring ------------------------------------

@pytest.mark.parametrize("what", ["faults", "warm_tier", "prefill_cached", "publish",
                                  "admit_with_cache", "session_prefix_cache"])
def test_later_slices_are_refused(port_model, calib, what):
    model, params = port_model
    make = lambda **kw: KVSwapEngine(model, params, EngineConfig(**{**CFG, **kw}), batch=1,
                                     calib_k=calib, device="cpu", **(
                                         {"faults": object()} if what == "faults" else {}))
    with pytest.raises(NotImplementedError, match="later slice"):
        if what in ("faults", "warm_tier"):
            make(**({"warm_budget_bytes": 1 << 20} if what == "warm_tier" else {}))
        elif what == "session_prefix_cache":
            ServeSession(model, params, EngineConfig(**CFG), slots=1, calib_k=calib,
                         prefix_cache=object(), device="cpu")
        else:
            with make() as eng:
                if what == "prefill_cached":
                    eng.prefill_cached(np.zeros((1, 8), np.int64), object())
                elif what == "publish":
                    eng.publish(object())
                else:
                    eng.admit_row(0, np.zeros(8, np.int64), cache=object())


def test_generate_stop_ids_masks_the_row(port_model, calib, tiny_cfg):
    """Engine-level EOS in the port: the stopped row repeats its stop token
    and charges nothing more while the other row decodes to the horizon.

    The reference's own version of this check
    (``test_serving_api.py::TestStopTokens::test_generate_stop_ids_mask_row``)
    passes alone but fails in a full run of the reference suite (its inputs
    come from a shared generator, so they depend on test order), so it is not
    used as an oracle: the expected behaviour is written out here, with a
    stop id chosen so that it is unique to row 0."""
    prompts = np.random.default_rng(12).integers(0, tiny_cfg.vocab_size, (2, 24))
    make = lambda: KVSwapEngine(*port_model, EngineConfig(**CFG), batch=2, calib_k=calib,
                                device="cpu")
    with make() as eng:
        free = eng.generate(prompts, 6)
    at = next(i for i in range(1, 5)
              if free[0, i] not in free[1] and free[0, i] not in free[0, :i])
    stop = int(free[0, at])
    with make() as eng:
        out = eng.generate(prompts, 6, stop_ids=(stop,))
        assert eng.last_stop_mask.tolist() == [True, False]
        np.testing.assert_array_equal(out[0, :at + 1], free[0, :at + 1])
        assert (out[0, at:] == stop).all()
        np.testing.assert_array_equal(out[1], free[1])
        # token ``at`` is drawn from decode step ``at - 1``'s logits; row 0
        # stops before decode step ``at``, so from there only row 1 decodes
        assert [s.active_rows for s in eng.step_log] == [2] * at + [1] * (5 - at)
