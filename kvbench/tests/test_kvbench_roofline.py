"""The yardstick's arithmetic against the kernel table's Bound column
(PERF.md, Findings: launches timed on the H100 with their shapes)."""

import json
from pathlib import Path

import pytest

from kvbench import roofline
from kvbench.models import decoder

CONFIGS = Path(__file__).resolve().parents[1] / "configs"


def us(work):
    return roofline.bound_seconds(*work) * 1e6


@pytest.mark.parametrize("valid,bound_us", [
    ([1024, 1536, 2048, 1200], 0.46),   # serving path
    ([1868, 2012, 1876, 1820], 0.59),   # prefix path
    ([1160, 1288, 1416, 1160], 0.40),   # router path
    ([1980, 1870, 1806, 1682], 0.58),   # disagg path
    ([2064] * 4, 0.65),                 # Zamba2
])
def test_kernel_a_bound_column(valid, bound_us):
    b, h, r, n, g = 4, 32, 64, 4096, 4
    assert round(us(roofline.lowrank_scores_work(b, h, r, n, g, sum(valid))), 2) == bound_us


def test_kernel_a_sequence_sharded_bound():
    # llama3-8b-seqshard, world 1: B 1, H 32, r 64, N 524,288, G 4, 500,000 valid
    assert round(us(roofline.lowrank_scores_work(1, 32, 64, 524_288, 4, 500_000)), 2) == 38.37


def test_kernel_b_bound_column():
    # llama3-8b-device: B 4, H 32, H_kv 8, d 128, S 401, 1,272 of the 1,604
    # (row, token) pairs unmasked by that path's random mask
    assert round(us(roofline.gather_attention_work(4, 32, 8, 128, 401, 1272)), 2) == 3.15
    # every token unmasked is bound by bytes, not operations
    n_bytes, n_ops = roofline.gather_attention_work(4, 32, 8, 128, 405, 4 * 405)
    assert n_bytes / roofline.HBM_BYTES_PER_S > n_ops / roofline.FP32_FLOPS_PER_S


@pytest.mark.parametrize("name,active", [("olmoe-1b-7b", 1_281_884_160 - 50304 * 2048),
                                         ("granite-8b-code", 8_053_063_680 - 49152 * 4096)])
def test_flops_per_token_counts_active_weights(name, active):
    """Two FLOPs a weight the token multiplies through: the embedding table
    is looked up, not multiplied (tied in Granite, where the head uses it)."""
    cfg = json.loads((CONFIGS / f"{name}.json").read_text())
    extra = 0 if not cfg["tie_word_embeddings"] else cfg["vocab_size"] * cfg["hidden_size"]
    assert decoder.flops_per_token(cfg) == 2 * (active + extra)
