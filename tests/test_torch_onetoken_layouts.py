"""The DTensor one-token steps on the fake 16x16 world at full width, depth
cut: what moves is the tokens' activations, never a weight or a whole
per-layer tensor (``repro_torch.models.layers.moves_activations``).

* xLSTM: at a few tokens the sLSTM leaves ``w_x`` and ``w_h`` split as
  stored and brings each token's pre-activations to gate-aligned columns
  by one all-to-all; at many it moves the weights instead.
* Llama-4 Maverick (FSDP weights): each rank looks the tokens up in its
  ``[V/16, D/16]`` block of the vocab table; no collective carries the
  table.
* Whisper: each decoder block's cross K/V is built when the block runs, so
  the step's temp holds one block's, whatever the depth.

Everything runs in this process (no spawned ranks), seconds a test.
"""

import dataclasses
import math

import pytest
import torch

from repro_torch.configs import registry
from repro_torch.launch import dryrun as DR
from repro_torch.sharding import partition as SP

BF16 = 2
_GET, _RECORD = registry.get, DR.LocalCounter._record


def _cut(cfg, blocks: int):
    """``cfg`` at its own widths with its first ``blocks`` blocks."""
    if registry.is_whisper(cfg):
        return dataclasses.replace(cfg, n_layers=blocks, n_enc_layers=blocks)
    if cfg.block_pattern:
        return dataclasses.replace(cfg, n_layers=blocks, block_pattern=cfg.block_pattern[:blocks])
    return dataclasses.replace(cfg, n_layers=blocks)


def _run(monkeypatch, arch: str, shape: str, blocks: int):
    """``run_one`` at ``blocks`` blocks → ``(result, [(kind, input shape)]``
    of every collective)."""
    monkeypatch.setattr(registry, "get", lambda a: _cut(_GET(a), blocks))
    seen = []

    def spy(self, func, args, kwargs, out):
        kind = DR._collective_kind(func)
        ins = DR._tensors((args, kwargs))
        if kind and ins:
            seen.append((kind, tuple(ins[0].shape)))
        return _RECORD(self, func, args, kwargs, out)

    monkeypatch.setattr(DR.LocalCounter, "_record", spy)
    res = DR.run_one(arch, shape, verbose=False)
    assert res.ok, res.error
    return res, seen


@pytest.mark.parametrize("shape,rows", [("decode_32k", 128 // 16), ("long_500k", 1)])
def test_slstm_step_moves_activations_not_weights(monkeypatch, shape, rows):
    """xLSTM-1.3B's first 8 blocks (7 mLSTM, 1 sLSTM): the step's one
    all-to-all is the sLSTM token's pre-activations, ``[4·D/16, rows]``
    bf16 — not ``w_x`` or ``w_h``, whose shard is ``[D, 4·D/16]``."""
    res, seen = _run(monkeypatch, "xlstm-1.3b", shape, 8)
    d, m = 2048, 16
    a2a = [s for kind, s in seen if kind == "all-to-all"]
    assert a2a == [(4 * d // m, rows)]
    assert res.collectives["all-to-all"] == 4 * d // m * rows * BF16
    assert max(math.prod(s) for _, s in seen) < d * 4 * d // m


def _slstm_counts(s: int) -> dict:
    """One sLSTM block of xLSTM-1.3B over ``[256, s, 2048]`` bf16 rows (16 a
    rank) on the fake world → ``DR.measure``."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    from repro_torch.launch.mesh import fake_world, make_fake_production_mesh
    from repro_torch.models import ssm as S

    with fake_world(256):
        mesh = make_fake_production_mesh()
        with FakeTensorMode():
            p = {"slstm": S.init_slstm(d_model=2048, n_heads=4, generator=torch.Generator(),
                                       device="cpu", dtype=torch.bfloat16)}
            x = torch.empty((256, s, 2048), dtype=torch.bfloat16)
            return DR.measure(lambda p, x: S.slstm_forward(p["slstm"], x)[0], (p, x),
                              (DR.param_shardings(p, mesh, fsdp=False), SP.P("data", None, None)),
                              mesh)


@pytest.mark.parametrize("s", [16, 128])
def test_slstm_layout_follows_the_token_count(s):
    """16 rows × ``s`` tokens against the weight shard's 2048 rows: 256
    tokens move their fp32 pre-activations, one all-to-all a token; 2048
    move ``w_x`` and ``w_h`` once each, ``[4·D/16, D]`` bf16."""
    c = _slstm_counts(s)["collectives"]
    if s * 16 < 2048:
        assert (c["_counts"]["all-to-all"], c["all-to-all"]) == (s, s * 512 * 16 * 4)
    else:
        assert (c["_counts"]["all-to-all"], c["all-to-all"]) == (2, 2 * 512 * 2048 * BF16)


@pytest.mark.parametrize("shape", ["decode_32k", "long_500k"])
def test_maverick_step_never_gathers_the_vocab_table(monkeypatch, shape):
    """Llama-4 Maverick's first 2 layers under FSDP: no collective carries
    a rank's block of the vocab table (``[V/16, D/16]``).  At one token
    (``long_500k``) the temp stays below the table's rows of one model
    rank, ``[V/16, D]`` bf16 — the tensor that gathering the table's
    ``data`` split would build."""
    res, seen = _run(monkeypatch, "llama4-maverick-400b-a17b", shape, 2)
    v, d, m = 202048, 5120, 16
    assert seen and all(math.prod(s) != (v // m) * (d // m) for _, s in seen)
    if shape == "long_500k":
        assert res.memory["temp_bytes"] < (v // m) * d * BF16


@pytest.mark.parametrize("shape,rows", [("decode_32k", 128 // 16), ("long_500k", 1)])
def test_whisper_step_holds_one_blocks_cross_kv(monkeypatch, shape, rows):
    """Whisper-large-v3's step at 1 and at 4 decoder blocks: the temp does
    not grow by a block's cross K/V (``rows × 1500 × 1280`` bf16 each), and
    stays below two blocks' worth — one block's K or V is whole only while
    the rank takes its heads from it."""
    kv = 2 * rows * 1500 * 1280 * BF16
    one = _run(monkeypatch, "whisper-large-v3", shape, 1)[0].memory["temp_bytes"]
    four = _run(monkeypatch, "whisper-large-v3", shape, 4)[0].memory["temp_bytes"]
    assert four - one < kv
    assert four < 2 * kv
