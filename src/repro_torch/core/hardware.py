"""Hardware constants + analytic compute-time model.

The container is CPU-only; throughput benchmarks *model* compute time for the
paper's evaluation platform (Jetson Orin AGX) and the dry-run roofline uses
TPU v5e constants (the deployment target).
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class ComputeSpec:
    name: str
    peak_flops: float   # FLOP/s at the benchmark dtype
    mem_bw: float       # bytes/s main-memory bandwidth
    link_bw: float = 0  # bytes/s per interconnect link (0 = single device)

    def op_time(self, flops: float, bytes_moved: float) -> float:
        """Roofline time for one fused region: max(compute, memory)."""
        return max(flops / self.peak_flops, bytes_moved / self.mem_bw)


# Jetson Orin AGX: Ampere iGPU, ~10.6 TFLOP/s dense fp16, LPDDR5 ~204.8 GB/s.
ORIN = ComputeSpec("jetson-orin-agx", peak_flops=10.6e12, mem_bw=204.8e9)

# Jetson Orin Nano class (entry on-device tier): ~1.28 TFLOP/s dense fp16,
# LPDDR5 ~68 GB/s.  The weakest platform the paper's eMMC/UFS story targets;
# the SLO trace harness defaults to it so prefill compute and storage reads
# sit at realistic relative scales for a small model.
ORIN_NANO = ComputeSpec("jetson-orin-nano", peak_flops=1.28e12, mem_bw=68e9)

# TPU v5e (dry-run/roofline target): 197 TFLOP/s bf16, 819 GB/s HBM,
# ~50 GB/s per ICI link (constants fixed by the reproduction brief).
TPU_V5E = ComputeSpec("tpu-v5e", peak_flops=197e12, mem_bw=819e9, link_bw=50e9)

# Platform registry for ``EngineConfig.compute``; unknown names fall back to
# TPU_V5E (the historical behavior for anything non-Jetson).
COMPUTES: dict[str, ComputeSpec] = {s.name: s for s in (ORIN, ORIN_NANO, TPU_V5E)}


@dataclasses.dataclass(frozen=True)
class ModelDims:
    """Minimal dims needed for per-layer decode cost modeling."""

    d_model: int
    n_heads: int
    n_kv_heads: int
    head_dim: int
    d_ff: int
    dtype_bytes: int = 2  # fp16 on the Jetson target


def decode_layer_flops(dims: ModelDims, n_ctx: int, batch: int) -> float:
    """FLOPs for one decode token through one transformer block."""
    d, h, hk, hd, ff = dims.d_model, dims.n_heads, dims.n_kv_heads, dims.head_dim, dims.d_ff
    proj = 2 * d * (h * hd) + 2 * 2 * d * (hk * hd) + 2 * (h * hd) * d
    attn = 2 * 2 * h * hd * n_ctx
    ffn = 2 * 3 * d * ff
    return batch * (proj + attn + ffn)


def decode_layer_bytes(dims: ModelDims, n_ctx: int, batch: int) -> float:
    """Bytes touched: layer weights (stream once) + KV context + activations."""
    d, h, hk, hd, ff = dims.d_model, dims.n_heads, dims.n_kv_heads, dims.head_dim, dims.d_ff
    w = (d * h * hd + 2 * d * hk * hd + h * hd * d + 3 * d * ff) * dims.dtype_bytes
    kv = batch * n_ctx * 2 * hk * hd * dims.dtype_bytes
    act = batch * d * dims.dtype_bytes * 8
    return w + kv + act


def predictor_flops(dims: ModelDims, rank: int, n_tokens: int, batch: int) -> float:
    """Low-rank scoring cost (Eq. 1): QA projection + (QA)·K_lr^T."""
    qa = 2 * dims.n_heads * dims.head_dim * rank
    score = 2 * dims.n_heads * rank * n_tokens
    return batch * (qa + score)


def prefill_layer_flops(dims: ModelDims, n_new: int, n_ctx0: int, batch: int) -> float:
    """FLOPs to prefill ``n_new`` tokens through one block when ``n_ctx0``
    context tokens already exist (0 = cold prefill; >0 = the chunked warm
    path restoring a cached prefix).  Causal attention cost is the sum of a
    context growing from ``n_ctx0 + 1`` to ``n_ctx0 + n_new``."""
    d, h, hk, hd, ff = dims.d_model, dims.n_heads, dims.n_kv_heads, dims.head_dim, dims.d_ff
    proj = 2 * d * (h * hd) + 2 * 2 * d * (hk * hd) + 2 * (h * hd) * d
    ffn = 2 * 3 * d * ff
    attn = 2 * 2 * h * hd * (n_new * n_ctx0 + n_new * (n_new + 1) // 2)
    return batch * (n_new * (proj + ffn) + attn)


def prefill_layer_bytes(dims: ModelDims, n_new: int, n_ctx0: int, batch: int) -> float:
    """Bytes touched by one block's (chunked) prefill: weights stream once
    for the whole chunk; KV and activations scale with the tokens."""
    d, h, hk, hd, ff = dims.d_model, dims.n_heads, dims.n_kv_heads, dims.head_dim, dims.d_ff
    w = (d * h * hd + 2 * d * hk * hd + h * hd * d + 3 * d * ff) * dims.dtype_bytes
    kv = batch * (n_ctx0 + n_new) * 2 * hk * hd * dims.dtype_bytes
    act = batch * n_new * d * dims.dtype_bytes * 8
    return w + kv + act


def prefill_layer_time(spec: ComputeSpec, dims: ModelDims, *, n_new: int,
                       n_ctx0: int = 0, batch: int = 1) -> float:
    """Modeled compute time for one block's (chunked) prefill."""
    if n_new <= 0:
        return 0.0
    return spec.op_time(prefill_layer_flops(dims, n_new, n_ctx0, batch),
                        prefill_layer_bytes(dims, n_new, n_ctx0, batch))


def decode_layer_time(
    spec: ComputeSpec, dims: ModelDims, *, n_ctx: int, batch: int, rank: int = 0, n_lr_tokens: int = 0
) -> float:
    """Modeled compute time for one block's decode step (+ prediction)."""
    fl = decode_layer_flops(dims, n_ctx, batch)
    by = decode_layer_bytes(dims, n_ctx, batch)
    if rank:
        fl += predictor_flops(dims, rank, n_lr_tokens, batch)
        by += batch * n_lr_tokens * rank * 2  # K_lr stream (fp16)
    return spec.op_time(fl, by)
