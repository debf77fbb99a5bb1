"""The port's ``ServeSession`` against the JAX one, ``run_main_path`` on
the CPU, and the samplers.

Five greedy requests over two slots with staggered arrivals must give equal
outputs and an equal modeled session clock: the session schedules on the
modeled clock, so any difference in group selection (I/O charges) or in
admission order would show there.
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro.core.engine import EngineConfig as JConfig
from repro.serving.api import ServeSession as JSession
from repro_torch.bridge import params_from_numpy
from repro_torch.core.engine import EngineConfig
from repro_torch.main_path import run_main_path
from repro_torch.models.transformer import ModelConfig, TransformerAdapter
from repro_torch.serving import SamplingParams, ServeSession, make_row_sampler
from repro_torch.serving.sampling import greedy, make_sampler

CFG = dict(group_size=4, n_select=6, rank=8, reuse_capacity=8, max_seq=128)
ARRIVALS = [0.0, 0.0, 2e-5, 6e-5, 1.5e-4]     # modeled seconds


def port_cfg(cfg) -> ModelConfig:
    return ModelConfig(**dataclasses.asdict(cfg))


def drive(sess, prompts):
    rids = [sess.submit(p, 6, arrival=t) for p, t in zip(prompts, ARRIVALS)]
    done = sess.drain()
    return [done[r].output for r in rids], [done[r].admitted_at for r in rids], sess.now


def test_session_matches_reference(tiny_cfg, tiny_adapter, tiny_params):
    rng = np.random.default_rng(8)
    calib = rng.standard_normal((256, tiny_cfg.n_kv_heads, tiny_cfg.head_dim)).astype(np.float32)
    # one prompt length: the reference compiles its prefill once per length
    prompts = [rng.integers(0, tiny_cfg.vocab_size, 30) for _ in range(5)]
    with JSession(tiny_adapter, tiny_params, JConfig(**CFG), slots=2, calib_k=calib) as js:
        want = drive(js, prompts)
    params = params_from_numpy(jax.tree_util.tree_map(np.asarray, tiny_params), "cpu")
    with ServeSession(TransformerAdapter(port_cfg(tiny_cfg)), params, EngineConfig(**CFG),
                      slots=2, calib_k=calib, device="cpu") as ts:
        got = drive(ts, prompts)
    for g, w in zip(got[0], want[0]):
        np.testing.assert_array_equal(g, w)
    assert got[1] == want[1]          # admission times on the modeled clock
    assert got[2] == want[2]          # the session clock


def test_main_path_on_cpu(tiny_cfg):
    """The chip smoke run's main path, rehearsed at a tiny size."""
    kw = dict(device="cpu", slots=2, n_requests=5, prompt_len=(20, 40), max_new=8)
    runs = {aio: run_main_path(port_cfg(tiny_cfg), n_layers=3,
                               engine_cfg=EngineConfig(**CFG, async_io=aio), **kw)
            for aio in (True, False)}
    run = runs[True]
    assert run["n_layers"] == 3
    assert [len(o) for o in run["outputs"]] == [8] * 5
    assert run["logits_finite"]
    assert run["decode_steps"] > 0
    # the CPU runs the plain versions: no kernel launch is counted
    assert run["launches"] == {"lowrank_group_scores": 0, "gather_attention": 0}
    for a, b in zip(runs[True]["outputs"], runs[False]["outputs"]):
        np.testing.assert_array_equal(a, b)
    assert runs[True]["session_clock"] == runs[False]["session_clock"]


class TestSampling:
    def test_greedy_takes_the_first_maximum(self):
        logits = np.array([[0.5, 2.0, 2.0, 1.0], [3.0, 3.0, 3.0, 3.0]], np.float32)
        np.testing.assert_array_equal(greedy(logits), [1, 0])
        np.testing.assert_array_equal(greedy(torch.from_numpy(logits)), [1, 0])
        assert make_row_sampler(None) is greedy
        assert make_row_sampler(SamplingParams(temperature=0.0)) is greedy

    def test_stochastic_sampler_is_seeded(self):
        logits = np.random.default_rng(9).standard_normal((3, 50)).astype(np.float32)
        draw = lambda seed: make_sampler(temperature=0.8, seed=seed)(logits)
        np.testing.assert_array_equal(draw(3), draw(3))
        a = make_sampler(temperature=1.0, seed=3)
        assert not all(np.array_equal(a(logits), a(logits)) for _ in range(5))

    @pytest.mark.parametrize("top_k,top_p", [(3, 0.0), (0, 0.8)])
    def test_truncation_limits_the_support(self, top_k, top_p):
        logits = np.array([[4.0, 3.0, 2.0, 1.0, 0.0, -1.0]], np.float32)
        sample = make_sampler(temperature=1.0, top_k=top_k, top_p=top_p, seed=0)
        allowed = {0, 1, 2} if top_k else {0, 1}
        drawn = {int(sample(logits)[0]) for _ in range(200)}
        assert drawn <= allowed and len(drawn) > 1
