"""The plain reference against the program's CPU path at tiny sizes: the
same weights and prompts, every served position's logits within fp32
rounding and every decode step's group selection equal."""

import numpy as np
import pytest
import torch

from kvbench import weights, workload
from kvbench.models import decoder
from kvbench.reference import decoder as ref
from kvbench.tests.helpers import TINY, TINY_DENSE

# fp32 on the CPU: the two sides multiply the same numbers in different
# shapes (one row against a batch, a prompt against prompt and served
# tokens), which moves the last bits; logits here are O(1)
ATOL = 1e-4


def port_run(cfg, w, prompts, n_steps):
    """Admit each prompt into its own slot, decode greedily; returns each
    row's logits per served position and its selections per (step, layer)."""
    from repro_torch.core.engine import KVSwapEngine
    from repro_torch.models.transformer import TransformerAdapter

    engine = cfg["engine"]
    model = TransformerAdapter(decoder.port_config(cfg, engine))
    params = decoder.port_params(cfg, w)
    calib = torch.as_tensor(workload.calibration(0, cfg["vocab_size"], engine["calib_tokens"]))[None]
    _, k0, _ = model.prefill_block(params, 0, model.embed(params, calib),
                                   torch.arange(calib.shape[1])[None])
    eng = KVSwapEngine(model, params, decoder.engine_config(engine), batch=len(prompts),
                       calib_k=k0[0].numpy(), device="cpu")
    sel = {}

    def hook(layer, x, pos, table):
        for b in range(len(prompts)):
            ids = table.group_ids[b][table.group_mask[b]]
            sel[len(eng.step_log), layer, b] = set(ids.tolist())

    eng.layer_hook = hook
    logits = [[eng.admit_row(b, p)] for b, p in enumerate(prompts)]
    for _ in range(n_steps):
        tok = np.array([int(row[-1].argmax()) for row in logits])
        out = eng.decode_step(tok)
        for b, row in enumerate(logits):
            row.append(out[b])
    eng.close()
    return [torch.stack(row) for row in logits], sel


@pytest.mark.parametrize("cfg", [TINY, TINY_DENSE], ids=["moe", "dense"])
def test_reference_matches_port(cfg):
    torch.set_grad_enabled(False)
    w = weights.nested(weights.make(decoder.leaves(cfg), 11, "cpu"))
    rng = np.random.default_rng(5)
    prompts = [rng.integers(0, cfg["vocab_size"], n) for n in (37, 50)]
    n_steps = 20
    port_logits, port_sel = port_run(cfg, w, prompts, n_steps)
    engine = cfg["engine"]
    calib = torch.as_tensor(workload.calibration(0, cfg["vocab_size"], engine["calib_tokens"]))
    adapter = ref.fit_adapter(w, cfg, calib, engine["rank"])
    g = engine["group_size"]
    for b, prompt in enumerate(prompts):
        served = port_logits[b].argmax(dim=-1)
        tokens = torch.cat([torch.as_tensor(prompt), served[:-1]])
        rec, stats = [], {}
        got = ref.served_logits(w, cfg, engine, adapter, tokens, len(prompt), record=rec)
        assert got.shape == port_logits[b].shape
        assert float((got - port_logits[b]).abs().max()) < ATOL
        for layer, chosen in enumerate(rec):
            for step in range(n_steps):
                groups = set(torch.nonzero(chosen[step])[:, 0].tolist())
                assert groups == port_sel[step, layer, b], (b, layer, step)
        # following the program's selections gives the same logits, and the
        # selections are top-M sets under the reference's scores
        follow = [torch.zeros_like(c) for c in rec]
        for layer, mask in enumerate(follow):
            for step in range(n_steps):
                mask[step, list(port_sel[step, layer, b])] = True
        again = ref.served_logits(w, cfg, engine, adapter, tokens, len(prompt), follow=follow,
                                  stats=stats)
        assert torch.equal(again, got)
        assert stats["slack"] == 0.0
        # a selection that swaps the best group for the worst is caught
        bad = [m.clone() for m in follow]
        gs = None
        row = bad[0][n_steps - 1]
        on, off = torch.nonzero(row)[:, 0], torch.nonzero(~row)[:, 0]
        row[on[0]], row[off[-1]] = False, True
        ref.served_logits(w, cfg, engine, adapter, tokens, len(prompt), follow=bad, stats=stats)
        assert stats["slack"] > 1e-3
