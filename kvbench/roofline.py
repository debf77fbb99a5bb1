"""The yardstick's arithmetic: the card's published peaks, the bytes and fp32
operations each launch of the decode path's two kernels needs, and the
model FLOPs of one output token.

Every count is what the inputs need, whatever the kernel reads again: each
input byte read once, each output byte written once, and the operations of
the tokens that are valid.  A later kernel that replaces one of these is
read against the same work.
"""

from __future__ import annotations

# NVIDIA H100 SXM (data sheet, dense, at its 700 W limit)
HBM_BYTES_PER_S = 3.35e12
FP32_FLOPS_PER_S = 67e12


def bound_seconds(n_bytes: float, n_flops: float) -> float:
    """The least time the card could take: the larger of bytes over the
    memory bandwidth and fp32 operations over the fp32 peak."""
    return max(n_bytes / HBM_BYTES_PER_S, n_flops / FP32_FLOPS_PER_S)


def lowrank_scores_work(b: int, h: int, r: int, n: int, g: int, n_valid: int) -> tuple[int, int]:
    """Kernel A (``lowrank_group_scores``): ``q_lr [b, h, r]`` against the
    compressed keys ``k_lr [b, n, r]`` of which ``n_valid`` rows (summed over
    the batch) are valid, group maxima ``[b, n / g]`` out.  Bytes: the
    queries, the valid keys, the ``b`` valid lengths and the group scores,
    4 B each.  Operations: the head sum of the queries, then one
    multiply-add per valid key element."""
    n_bytes = 4 * (b * h * r + n_valid * r + b + b * n // g)
    return n_bytes, 2 * n_valid * r + b * h * r


def gather_attention_work(b: int, h: int, hk: int, d: int, s: int, n_tok: int) -> tuple[int, int]:
    """Kernel B (``gather_attention``): ``q [b, h, d]`` over ``k, v [b, s,
    hk, d]`` of which ``n_tok`` tokens (summed over the batch) are unmasked,
    ``[b, h, d]`` out.  Bytes: queries and output, the unmasked tokens' K and
    V (4 B) and the mask (1 B a token).  Operations: a score and a weighted
    sum of V per unmasked token and query head."""
    n_bytes = 4 * (2 * b * h * d + 2 * n_tok * hk * d) + b * s
    return n_bytes, 4 * n_tok * h * d


def matmul_params_per_token(cfg: dict) -> int:
    """Weights one token multiplies through (the embedding lookup excluded,
    the LM head included, a MoE layer's router and its ``k`` routed experts
    only), from the published sizes of a decoder config file."""
    d = cfg["hidden_size"]
    hd = cfg.get("head_dim") or d // cfg["num_attention_heads"]
    attn = d * hd * (2 * cfg["num_attention_heads"] + 2 * cfg["num_key_value_heads"])
    if cfg.get("num_experts"):
        ffn = d * cfg["num_experts"] + 3 * cfg["num_experts_per_tok"] * d * cfg["intermediate_size"]
    else:
        ffn = 3 * d * cfg["intermediate_size"]
    return cfg["num_hidden_layers"] * (attn + ffn) + d * cfg["vocab_size"]


def attention_flops(n_attended: int, n_heads: int, head_dim: int) -> int:
    """FLOPs of one layer's attention for one query over ``n_attended``
    keys: ``Q K^T`` and ``P V``, two multiply-adds a key, head and dim."""
    return 4 * n_attended * n_heads * head_dim
