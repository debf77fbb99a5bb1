#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

1. prints the card's name and power limit, builds every CUDA kernel from
   ``src/repro_torch/kernels/csrc/`` with nvcc for sm_90a (build seconds
   and, per compiled kernel, ptxas's registers, static shared memory,
   stack and spills), and kernel C's dynamic shared memory, blocks per SM
   and waves at the Zamba2 path's shapes;
2. runs the paper's offline tuner (``tuner.solve``) for OLMoE-1B-7B's dims
   (b_max 4, s_max 4096, a budget of 256 MiB a batch, disk nvme) and for
   Llama-3.1-8B's at the same inputs, and prints their ``TunedParams``
   (Llama's rank, 512, must take kernel A past rank 256); holds each kernel
   against its plain PyTorch version on the card, at each main path's
   shapes (those of paths 8-10 from their seeded prompt lengths and the
   tuned tuples, those of paths 11-14) and at ragged and edge shapes
   (kernel A at rank 512 in one launch and past 256 with ragged chunks;
   kernel C also bitwise equal over 5 repeated calls), and times the
   kernel, the plain version and (where one exists) one library call with
   CUDA events at each path's shapes, and the kernel alone with
   ``torch.profiler``; prints the events' floor (one launch of a trivial
   fill); checks kernel B past head_dim 128 (stablelm-12b's d = 160, and
   d = 256; the StableLM path's entry times it) and prints its blocks per
   SM at each width; with ``--parent DIR`` (a checkout of another tree)
   builds that tree's kernels A, B and C and times each in turns with this
   tree's (A at ranks 64, 256 and 30, B at the serving and hybrid paths'
   shapes, C at the Zamba2 prefill's through ``SSDChunk``; bit-equal
   outputs required), and does the same for its MoE
   layer at the OLMoE path's decode and prefill shapes; runs the tiny
   engine on the card and on the CPU
   and compares every group selection and token (the flipped selections,
   each with its score gaps);
3. drives the first main path: a ``ServeSession`` at Llama-3.1-8B width (all
   32 layers, fp32 random weights from seed 0) answering 6 greedy requests
   of 1024-2048 prompt tokens and 32 new tokens each over 4 slots, and
   checks that every request completes, the logits stay finite, and kernels
   A and B were launched once per layer per decode step;
4. drives the prefix path on the same weights: a ``ServeSession`` with a
   prefix cache (32-token blocks, 2 GiB) answering 8 greedy requests whose
   prompts share one 1536-token prefix, each with its own suffix of 256-512
   tokens, 32 new tokens each over 4 slots: the first four admissions run
   cold and publish at retirement, the last four must restore 1536 tokens;
   prints each admission's wall with its cached and computed tokens, the
   restore and publish bytes, the decode-step wall, tokens/s, peak memory
   and the launches of kernels A and B (once per layer per decode step); a
   control session without the cache serves the same requests, and each
   request's tokens are compared with the control's; one more such prompt
   is admitted at slot 0 of two fresh engines, cold and warm (the warm one
   under ``torch.profiler``: where its time goes), and the last-position
   logits must be bit-equal (then every request's tokens must equal the
   control's) or within 1e-4 of their largest magnitude, with the first
   operation of layer 0 whose bits differ printed;
5. drives the router path on the same weights: two replicas, each a
   ``ServeSession`` with its own prefix cache, behind ``FrontEnd(pool,
   PrefixAffinityRouter())``, replaying a three-tenant chat trace (1024
   system tokens and 128 more a turn, three turns, 16 new tokens): every
   later turn must go to its tenant's first replica, arrive after the
   previous turn finished on the modeled clock and restore at least 1024
   tokens; prints routes, cached and computed tokens, the fleet's hit rate,
   cold and warm admission walls, each replica's decode-step median,
   tokens/s and peak memory; then the disaggregated path: a
   ``PrefillEngine`` handing off to a decode ``ServeSession`` over one
   prefix cache for 4 prompts of 1536-2048 tokens arriving at once (every
   ticket done, each decode admission restoring every published block
   below the prompt's last token, no kernel launched in the prefill
   engine, tokens equal to a co-located control's, first-token logits
   within 1e-4 of their largest magnitude), printing each ticket's
   prefill, publish and decode-admission walls;
6. at 4 layers (full width, one set of weights): the main path's requests
   with ``async_io`` on and off (bit-identical tokens); the warm tier
   (``kv_bits=8``, 256 MiB) against the tier off (bit-identical tokens,
   warm-served bytes above 0); transient read faults with retries
   (bit-identical to the unfaulted run, retries above 0, no failed request,
   no dead prefetch thread); grown bad extents at 35 % and at 1 % of writes
   (the session drains, every request completes or fails, some fail at 35
   %, some survive at 1 %, and survivors' tokens equal the unfaulted
   run's);
   and the prefix path with blocks corrupted at rest (quarantines above 0,
   tokens equal to the control without cache or faults); ``BatchServer``
   flushes bit-identical to a ``ServeSession``; the router's tokens
   bit-identical to each replica's arrivals replayed in a fresh solo
   session, scoring that leaves every cache as it was, and
   ``repro_torch.obs.report`` over each replica's exported trace; a
   disaggregated chain corrupted at rest re-queued without a decode
   admission and completed with the control's tokens; a trace replayed
   twice with byte-identical metrics;
7. drives the hybrid path: Zamba2-1.2B at full width (all 38 blocks:
   32 Mamba2, 6 shared attention; fp32 random weights from seed 0) through
   ``KVSwapEngine.generate`` for 4 prompts of 2048 tokens and 32 new tokens,
   and checks the tokens' shape, finite logits, that only the 6 attention
   layers own disk KV, that kernel C ran once per Mamba2 layer in the one
   prefill and kernels A and B once per attention layer per decode step;
   prefills the same prompts once more under ``torch.profiler`` and prints
   where that prefill's time goes (the top device operations, kernel C
   among them, the device's busy share and the host's time alone); then
   generates at 12 blocks with ``async_io`` and ``device_resident`` each
   on and off and requires bit-identical tokens;
8. serves OLMoE-1B-7B at full width (all 16 MoE layers, 64
   experts top-8, fp32 random weights from seed 0) through a
   ``ServeSession`` on the tuned ``EngineConfig``: 6 greedy requests of
   1024-2048 prompt tokens, 32 new each over 4 slots, with the same checks
   as the first path, the decode step's split, and the expert-read floor
   of a decode step (every expert's weights, every layer) beside one MoE
   layer's time at the decode shape; at decode step 8 it takes layer 8's
   true query and full K and V to the host and prints each baseline's
   ``FidelityResult`` (FlexGen, InfiniGen, InfiniGen*, ShadowKV, Loki,
   KVSwap at a budget of M·G tokens) and the recall of the engine's own
   selection against the exact group scores (recalls and masses in [0,
   1], FlexGen's recall 1 and output error below 1e-6);
9. serves StableLM-2-12B at full width (all 40 layers, head_dim 160) with
   the first path's ``EngineConfig``: 4 greedy requests of 1024-2048
   tokens, 16 new each over 4 slots, the same checks (kernel B launched at
   d = 160 once per layer per decode step);
10. serves Granite-8B, Qwen3-32B and Chameleon-34B at full width, cut to 2
   layers each: 2 greedy requests of 512-1024 tokens, 8 new each over 2
   slots (kernel B at rep 4, 8 and 8), the same checks; then Llama-3.1-8B
   on its tuned tuple (G 4, M 100, rank 512) at full width cut to 4
   layers, 6 requests, the same checks (kernel A at rank 512);
11. drives the full-cache device path (``serving/decode.py``, what
   ``repro_torch.launch.serve --engine device`` runs) at Llama-3.1-8B
   width on the serving path's weights, before they are freed: 4 prompts
   of 2048 tokens, 32 new, ``max_len`` 4096, in three modes: ``full``,
   ``kvswap`` (``KVSwapServeConfig(4, 100, 64)``: kernel B at S 401, 32 x
   32 launches, none in ``full``) and ``kvswap`` with the rolling buffer
   and cross-layer prediction (S 405, a flush every 4 steps); prints each
   prefill wall, step median, tokens/s and peak memory.  At 4 layers
   (after the 4-layer runs): ``kvswap`` selecting every group against
   ``full`` on the same tokens (within 1e-4 of the largest |logit|), and
   the rolling buffer against the direct path (within 2e-4);
12. after the hybrid path, Zamba2-1.2B through the device path
   (``kvswap``, 38 blocks, 4 x 2048): kernel C 32 times in the prefill,
   kernel B 6 a step;
13. Whisper-large-v3 at full width (32 + 32 layers, d_model 1280, 20
   heads, head_dim 64; the encoder over 4 seeded 1500-frame sequences):
   ``KVSwapEngine.generate`` on 4 x 2048 decoder tokens, 32 new (the
   engine's host-gather route; kernels A and B once per layer per decode
   step), then the same weights through the device path (``kvswap``);
14. xLSTM-1.3B at full width (48 blocks) through the device path, 4 x
   1024 tokens, 32 new: no kernel launches; and two of its blocks (an
   mLSTM and an sLSTM) whose prefill and steps must equal the
   teacher-forced forward within 2e-4 of max(1, the largest |logit|);
15. drives the sequence-sharded decode attention (``serving/distributed.py``)
   at the reference's long_500k shape at Llama-3.1-8B width (B 1, H 32,
   H_kv 8, d 128, N 524288, r 64, G 4, M 100, 500,000 tokens, one layer of
   fp32 K/V): at world 1 over NCCL in this process, and at world 4 over
   gloo in four spawned processes on this one card, each rank making only
   its own 131,072-token shard; each output within 1e-5 of max(1, |o|max)
   of the port's ``reference_decode_attn`` with the same number of shards,
   each shard's selected groups equal to the plain scores' (or every flip
   printed and within kernel A's 1e-5), kernel A launched once a rank a
   call; prints the step median over 20 calls (the slowest rank's), kernel
   A's time a shard against its bound and the combine's time and bytes;
   then Llama-3.1-8B at full width cut to 2 layers, its params distributed
   over a 1x1 NCCL mesh: ``forward`` on the DTensors within 1e-6 of the
   largest |logit| of the plain ``forward`` (bit-equality printed);
16. trains Zamba2-1.2B at full width and depth (fp32, B 2 x S 1024, AdamW
   lr 1e-3, warmup 2): 8 steps over one batch (every loss finite, the last
   below the first, kernel C launched 32 times a forward), then 4 steps of
   ``train_loop`` with ``remat=True`` (64 launches a step: the forward and
   the recompute); prints the step median, tokens/s, peak memory, one
   forward's and one backward's wall; kernel C's forward and its plain
   backward are timed and its grads held to the plain version's at the
   path's shapes; then at Llama-3.1-8B width cut to 2 layers (B 2 x S
   512): ``accum_steps`` 2 against 1 (loss within 1e-5 relative, params
   within 2e-6), ``remat`` against none (loss and grads within 1e-6,
   bit-equality printed), and a ``save_pytree`` / ``load_pytree`` round
   trip, bit-equal;
17. prints the ``{"kernels": [...]}`` line, one entry per kernel and main
   path that runs it (``path``): its time, bound, plain and library times
   at that path's shapes, and ``launches`` in that path's main run, counted
   from 0 just before it (every entry's above 0); then, last, the
   ``{"ok": true, ...}`` line.

Any failed phase exits nonzero without the last line.  Imports no JAX and
nothing of the JAX package ``repro``.  Needs one CUDA card.
"""

from __future__ import annotations

import dataclasses
import functools
import gc
import json
import math
import re
import statistics
import subprocess
import sys
import time
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent
HBM_BYTES_PER_S = 3.35e12      # H100 SXM device memory (published)
FP32_FLOPS_PER_S = 67e12       # H100 SXM fp32 outside the tensor cores (published)
SCORE_RTOL = 1e-5              # kernel A: |err| <= 1e-5 x the row's score scale
ATTN_TOL = 1e-5                # kernel B: |err| <= 1e-5 x max(1, |output|max)
# kernel C sums up to Q = 128 decayed products in another order than its
# plain version, on the tensor cores with split operands (each product term
# to ~2^-18 of its size) and a fast exp: |err| <= 1e-4 x max(1, |y|max)
SSD_TOL = 1e-4
LLAMA, ZAMBA = "llama3-8b", "zamba2-1.2b"      # the serving and hybrid paths
PREFIX = "llama3-8b-prefix"                    # the serving path over the prefix cache
ROUTER = "llama3-8b-router"                    # two replicas behind the KV-affinity router
DISAGG = "llama3-8b-disagg"                    # a prefill engine handing off to a decode session
OLMOE, STABLELM = "olmoe-1b-7b", "stablelm-12b"  # the MoE path and kernel B at head_dim 160
DENSE_2L = ("granite-8b", "qwen3-32b", "chameleon-34b")   # full width, 2 layers each
# the paths served after the hybrid one (run_main_path's arguments; n_layers
# None = every layer): slots, requests, prompt lengths, new tokens
SERVED = {OLMOE: dict(n_layers=None, slots=4, n_requests=6, prompt_len=(1024, 2048), max_new=32),
          STABLELM: dict(n_layers=None, slots=4, n_requests=4, prompt_len=(1024, 2048),
                         max_new=16),
          **{arch: dict(n_layers=2, slots=2, n_requests=2, prompt_len=(512, 1024), max_new=8)
             for arch in DENSE_2L}}
# the tuner's inputs on the OLMoE path: batch 4, 4096 tokens, 256 MiB a batch
OLMOE_TUNE = dict(b_max=4, s_max=4096, budget_bytes=256 << 20, disk="nvme")
OLMOE_PROBE = (8, 8)                           # decode step 8, layer 8: the baselines' tensors
# stablelm-12b's attention (configs/stablelm_12b.py): kernel B at head_dim 160
STABLELM_ATTN = (4, 32, 8, 160, 405)
# the tuner's tuple for Llama-3.1-8B at the OLMoE path's budget: rank 512,
# kernel A's wide instance; served at full width cut to 4 layers
TUNED = "llama3-8b-tuned"
SERVED[TUNED] = dict(n_layers=4, slots=4, n_requests=6, prompt_len=(1024, 2048), max_new=32)
ARCH_OF = {TUNED: LLAMA}
# the full-cache device path (serving/decode.py) and the paths it serves
WHISPER, XLSTM = "whisper-large-v3", "xlstm-1.3b"
LLAMA_DEV, LLAMA_ROLL = "llama3-8b-device", "llama3-8b-device-rolling"
ZAMBA_DEV, WHISPER_DEV = "zamba2-1.2b-device", "whisper-large-v3-device"
DEVICE_RUN = dict(batch=4, prompt_len=2048, max_new=32, max_len=4096)
XLSTM_RUN = dict(batch=4, prompt_len=1024, max_new=32, max_len=1024 + 32 + 4)
# KVSwapServeConfig(group_size, n_select, rank) of every kvswap run
DEVICE_KVSWAP = (4, 100, 64)
# kernel C at the Zamba2 prefill: B 4, S 2048 in 16 chunks of Q 128, H 64, P 64, N 64
ZAMBA_SSD = dict(b=4, nc=16, q=128, h=64, p=64, n=64)
# the sequence-sharded decode at the reference's long_500k attention shape
# (benchmarks/shardmap_ab.py): Llama-3.1-8B width, B 1, N 524288 in blocks
# of 131072 (one a rank at world 4), r 64, G 4, M 100, 500,000 tokens; one
# layer of fp32 K/V (4.3 GB; 32 layers would be 137 GB)
SEQSHARD = "llama3-8b-seqshard"
SEQSHARD_SPEC = dict(b=1, h=32, hk=8, d=128, r=64, n=524288, block=131072, group_size=4)
SEQSHARD_CASE = {"length": 500_000, "n_select": 100}
SEQSHARD_REPS = 20                               # timed calls after the checked one
# Zamba2-1.2B trained at full width and depth: B 2, S 1024, AdamW lr 1e-3,
# warmup 2; 8 steps over one batch, then 4 of train_loop with remat
TRAIN = "zamba2-1.2b-train"
TRAIN_RUN = dict(batch=2, seq_len=1024, fixed_steps=8, loop_steps=4, lr=1e-3, warmup=2)
TRAIN_SSD = dict(b=2, nc=8, q=128, h=64, p=64, n=64)   # kernel C in its forward
# each kernel's source and the TPU kernel it replaces
SOURCES = {"lowrank_group_scores": ("lowrank_score.cu", "src/repro/kernels/lowrank_score.py:23"),
           "gather_attention": ("gather_attention.cu", "src/repro/kernels/gather_attention.py:28"),
           "ssd_chunk": ("ssd_chunk.cu", "src/repro/kernels/ssd_chunk.py:25")}


def fail(msg: str) -> None:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def check(cond: bool, msg: str) -> None:
    if not cond:
        fail(msg)


def device_ms(fn, flush: torch.Tensor, reps: int = 30) -> float:
    """Median device time of one ``fn()`` call, in ms, with L2 flushed first.

    A sleep kernel queued ahead of the start event keeps the card busy while
    the host enqueues ``fn``'s launches, so the events bracket device time,
    not Python overhead."""
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    for _ in range(3):
        fn()
    times = []
    for _ in range(reps):
        flush.zero_()
        torch.cuda._sleep(2_000_000)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def profiled_ms(fn, flush: torch.Tensor, kernel: str, reps: int = 20) -> float | None:
    """Device time of one ``fn()`` call spent in kernels whose name holds
    ``kernel``, in ms, from ``torch.profiler`` over ``reps`` calls with L2
    flushed before each: the kernel alone, without the launch and event
    overhead that ``device_ms`` includes.  None where the profiler records
    no device time."""
    from torch.profiler import ProfilerActivity, profile

    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            flush.zero_()
            fn()
        torch.cuda.synchronize()
    total_us = sum(ev.device_time_total for ev in prof.key_averages() if kernel in ev.key)
    return total_us / reps / 1e3 if total_us else None


# the names of a kernel's bool template arguments, in order: (true, false)
BOOL_ARGS = {"gather_attention_kernel": [("wide", "narrow")],
             "lowrank_group_scores_kernel": [("vec", "scalar"), ("wide", "narrow")]}


def ptxas_lines(log: str) -> list[str]:
    """One line per kernel compiled in nvcc's ``-Xptxas -v`` log: its
    registers, static shared memory, stack frame and spills."""
    keys = {"registers": r"Used (\d+) registers", "smem": r"(\d+) bytes smem",
            "stack": r"(\d+) bytes stack frame", "spill stores": r"(\d+) bytes spill stores",
            "spill loads": r"(\d+) bytes spill loads"}
    kernels: list[tuple[str, dict]] = []
    for line in log.splitlines():
        entry = re.search(r"Compiling entry function '(\w+)'", line)
        if entry:
            # template arguments: ints as numbers, bools by their names
            name = re.search(r"([a-z_]+_kernel)((?:I|L[ib]-?\d+E)*)", entry.group(1))
            args, bools = [], list(BOOL_ARGS.get(name.group(1), [])) if name else []
            for kind, val in re.findall(r"L([ib])(-?\d+)E", name.group(2) if name else ""):
                if kind == "b" and bools:
                    args.append(bools.pop(0)[0 if val == "1" else 1])
                else:
                    args.append(val)
            kernels.append((f"{name.group(1)}<{', '.join(args)}>" if args else
                            name.group(1) if name else entry.group(1), {}))
        elif kernels:
            for key, pat in keys.items():
                hit = re.search(pat, line)
                if hit:
                    kernels[-1][1][key] = int(hit.group(1))
    return [f"{name}: {info.get('registers', '?')} registers, {info.get('smem', 0)} B static "
            f"shared memory, {info.get('stack', 0)} B stack, {info.get('spill stores', 0)} B "
            f"spill stores, {info.get('spill loads', 0)} B spill loads" for name, info in kernels]


def free_device() -> None:
    """Return the memory of a finished phase to the card before the next one
    (what the phase left in reference cycles is freed only by a collection)."""
    gc.collect()
    torch.cuda.empty_cache()


def bound_ms(n_bytes: float, n_flops: float) -> tuple[float, str]:
    t_bytes, t_ops = n_bytes / HBM_BYTES_PER_S, n_flops / FP32_FLOPS_PER_S
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def check_scores(ops, select_groups, dev, gen, b, h, r, n, g, valid, m_sel) -> float:
    q = torch.randn((b, h, r), generator=gen, device=dev)
    k = torch.randn((b, n, r), generator=gen, device=dev)
    vl = torch.tensor(valid, dtype=torch.int32, device=dev)
    got = ops.lowrank_group_scores(q, k, vl, group_size=g)
    want = ops.lowrank_group_scores_plain(q, k, vl, group_size=g)
    torch.cuda.synchronize()
    check(got.shape == want.shape, f"kernel A shape {tuple(got.shape)} != {tuple(want.shape)}")
    masked = want <= -1e29
    check(bool((got[masked] == want[masked]).all()), "kernel A: masked groups differ from -1e30")
    scale = torch.where(masked, 0.0, want.abs()).amax(dim=1, keepdim=True).clamp_min(1.0)
    err = ((got - want).abs() / scale).masked_fill(masked, 0.0)
    rel = float(err.max())
    check(rel <= SCORE_RTOL, f"kernel A {b, h, r, n, g}: rel err {rel:.3g} > {SCORE_RTOL}")
    # selections agree wherever the M-th / (M+1)-th boundary is clear of the tolerance
    ids_k, mask_k = select_groups(got, m_sel)
    ids_p, mask_p = select_groups(want, m_sel)
    srt = torch.sort(want, dim=1, descending=True).values
    for bi in range(b):
        if srt.shape[1] > m_sel and \
                float(srt[bi, m_sel - 1] - srt[bi, m_sel]) <= 2 * SCORE_RTOL * float(scale[bi]):
            continue
        check(set(ids_k[bi][mask_k[bi]].tolist()) == set(ids_p[bi][mask_p[bi]].tolist()),
              f"kernel A {b, h, r, n, g}: selected groups differ in row {bi}")
    return float((got - want).abs().masked_fill(masked, 0.0).max())


def check_attention(ops, dev, gen, b, h, hk, d, s, mask) -> float:
    q = torch.randn((b, h, d), generator=gen, device=dev)
    k = torch.randn((b, s, hk, d), generator=gen, device=dev)
    v = torch.randn((b, s, hk, d), generator=gen, device=dev)
    got = ops.gather_attention(q, k, v, mask)
    want = ops.gather_attention_plain(q, k, v, mask)
    torch.cuda.synchronize()
    check(bool(torch.isfinite(got).all()), f"kernel B {b, h, hk, d, s}: non-finite output")
    err = float((got - want).abs().max())
    check(err <= ATTN_TOL * max(1.0, float(want.abs().max())),
          f"kernel B {b, h, hk, d, s}: max abs err {err:.3g} > {ATTN_TOL}")
    check(not bool(got[~mask.any(dim=1)].any()), f"kernel B {b, h, hk, d, s}: a fully "
          f"masked row is not 0")
    return err


def ssd_inputs(gen, dev, b, nc, q, h, p, n, steep=False, pad=0):
    """Kernel C's inputs as ``mamba2_forward`` makes them: ``cum`` is the
    in-chunk cumsum of a non-positive log-decay; ``steep`` lets it fall by up
    to 45 a token (the exponent above the diagonal then passes +5000);
    ``pad`` zeroes the last chunk's last ``pad`` tokens, as padding arrives."""
    xh = torch.randn((b, nc, q, h, p), generator=gen, device=dev)
    bm = torch.randn((b, nc, q, n), generator=gen, device=dev)
    cm = torch.randn((b, nc, q, n), generator=gen, device=dev)
    dt = torch.rand((b, nc, q, h), generator=gen, device=dev)
    rate = (torch.linspace(1.0, 45.0, h, device=dev) if steep
            else torch.rand(h, generator=gen, device=dev))
    ld = -dt * rate
    if pad:
        for t in (xh, bm, cm, dt, ld):
            t[:, -1, q - pad:] = 0
    return xh, bm, cm, dt, torch.cumsum(ld, dim=2)


def check_ssd(ops, dev, gen, shape: dict) -> float:
    args = ssd_inputs(gen, dev, **shape)
    got = ops.ssd_chunk(*args)
    want = ops.ssd_chunk_plain(*args)
    torch.cuda.synchronize()
    check(bool(torch.isfinite(got).all()), f"kernel C {shape}: non-finite output")
    if shape.get("pad"):
        check(not bool(got[:, -1, shape["q"] - shape["pad"]:].any()),
              f"kernel C {shape}: padded tokens are not 0")
    err = float((got - want).abs().max())
    check(err <= SSD_TOL * max(1.0, float(want.abs().max())),
          f"kernel C {shape}: max abs err {err:.3g} > {SSD_TOL} of max(1, |y|max)")
    return err


def time_scores(ops, dev, gen, flush, b, h, r, n, g, valid) -> dict:
    q = torch.randn((b, h, r), generator=gen, device=dev)
    k = torch.randn((b, n, r), generator=gen, device=dev)
    vl = torch.tensor(valid, dtype=torch.int32, device=dev)
    n_valid = sum(valid)
    bound, by = bound_ms(4 * (b * h * r + n_valid * r + b + b * n // g), 2 * n_valid * r + b * h * r)
    kernel = functools.partial(ops.lowrank_group_scores, q, k, vl, group_size=g)
    return {"ms": device_ms(kernel, flush),
            "device_ms": profiled_ms(kernel, flush, "lowrank_group_scores_kernel"),
            "plain_ms": device_ms(lambda: ops.lowrank_group_scores_plain(q, k, vl, group_size=g),
                                  flush),
            "bound_ms": bound, "bound_by": by, "library_ms": None}


def time_attention(ops, dev, gen, flush, b, h, hk, d, s, mask) -> dict:
    import torch.nn.functional as F

    q = torch.randn((b, h, d), generator=gen, device=dev)
    k = torch.randn((b, s, hk, d), generator=gen, device=dev)
    v = torch.randn((b, s, hk, d), generator=gen, device=dev)
    q4, k4, v4, m4 = q[:, :, None], k.transpose(1, 2), v.transpose(1, 2), mask[:, None, None, :]
    n_tok = int(mask.sum())
    bound, by = bound_ms(4 * (2 * b * h * d + 2 * n_tok * hk * d) + b * s, 4 * n_tok * h * d)
    kernel = functools.partial(ops.gather_attention, q, k, v, mask)
    return {"ms": device_ms(kernel, flush),
            "device_ms": profiled_ms(kernel, flush, "gather_attention_kernel"),
            "plain_ms": device_ms(lambda: ops.gather_attention_plain(q, k, v, mask), flush),
            "bound_ms": bound, "bound_by": by,
            "library_ms": device_ms(lambda: F.scaled_dot_product_attention(
                q4, k4, v4, attn_mask=m4, enable_gqa=hk != h), flush)}


def kernel_entry(name, path, err, timed) -> dict:
    return {"name": name, "path": path, "route": "cuda",
            "source": f"src/repro_torch/kernels/csrc/{SOURCES[name][0]}",
            "replaces": SOURCES[name][1], "max_abs_err": err, **timed}


def kernel_checks(ops, select_groups, dev) -> list[dict]:
    """The three kernels against their plain versions at each main path's
    shapes and at ragged shapes, then timed at each path's shapes: one
    entry per (kernel, path).  An entry's ``max_abs_err`` is the largest
    over its path's shapes and the kernel's ragged shapes."""
    gen = torch.Generator(device=dev).manual_seed(1)
    flush = torch.empty(64 << 20, dtype=torch.uint8, device=dev)   # > 50 MB L2
    entries = []

    def entry(name, path, err, timed):
        entries.append(kernel_entry(name, path, err, timed))

    # kernel A: B=4, H=32, r=64, N=4096 (k_lr capacity), G=4, M=100 on every
    # path; valid lengths: the Llama path's prompts, the Zamba2 path's
    # prompts of 2048 and the prefix path's first four prompts halfway
    # through their 32 decode steps
    b, h, r, n, g = 4, 32, 64, 4096, 4
    # the router path's three turn lengths and the disagg path's four prompts,
    # halfway through their 16 decode steps
    valid_a = {LLAMA: [1024, 1536, 2048, 1200], ZAMBA: [2064] * 4,
               PREFIX: [1868, 2012, 1876, 1820], ROUTER: [1160, 1288, 1416, 1160],
               DISAGG: [1980, 1870, 1806, 1682]}
    err_a = 0.0
    for shape, vl in [((3, 16, 64, 1000, 4), [1000, 0, 100]),   # ragged N, empty row, masked tiles
                      ((2, 8, 32, 130, 8), [130, 7]),            # ragged last group
                      ((1, 4, 16, 64, 4), [64]),
                      ((2, 8, 256, 600, 4), [600, 257]),         # r = 256: 16 float4 a lane
                      ((2, 4, 30, 300, 4), [300, 45]),           # r % 4 != 0: scalar path
                      ((2, 4, 3, 77, 5), [77, 12]),
                      ((2, 16, 64, 1000, 1), [1000, 513]),       # G = 1
                      ((1, 4, 16, 1000, 100), [900]),            # G > 64: several passes
                      ((2, 8, 64, 130, 4), [5000, 131]),         # valid_len > N
                      ((2, 8, 260, 300, 4), [300, 33]),          # r > 256: a last chunk of 1 float4
                      ((2, 4, 513, 200, 4), [200, 77]),          # r > 256, r % 4 != 0
                      ((1, 8, 1024, 1000, 100), [900]),          # four chunks, G > 64
                      ((4, 20, 64, 4096, 4), [2064] * 4)]:       # whisper-large-v3: H = 20
        err_a = max(err_a, check_scores(ops, select_groups, dev, gen, *shape, vl, 6))
    # Llama-3.1-8B at the tuner's tuple for 256 MiB a batch (rank 512), in one launch
    before = ops.lowrank_group_scores.launches
    err_a = max(err_a, check_scores(ops, select_groups, dev, gen, 4, 32, 512, 4096, 4,
                                    [1024, 1536, 2048, 1200], 100))
    check(ops.lowrank_group_scores.launches == before + 1, "kernel A at rank 512 took more than "
          "one launch")
    for path, valid in valid_a.items():
        err = check_scores(ops, select_groups, dev, gen, b, h, r, n, g, valid, 100)
        entry("lowrank_group_scores", path, max(err, err_a),
              time_scores(ops, dev, gen, flush, b, h, r, n, g, valid))

    # kernel B: S = M*G + G + 1 = 405; Llama H=32, H_kv=8, d=128 (both of its
    # paths); Zamba2 H = H_kv = 32, d=64 (one query head per KV head)
    shape_b = {LLAMA: (4, 32, 8, 128, 405), ZAMBA: (4, 32, 32, 64, 405),
               PREFIX: (4, 32, 8, 128, 405), ROUTER: (4, 32, 8, 128, 405),
               DISAGG: (4, 32, 8, 128, 405)}
    err_b = 0.0
    for shape in [(2, 8, 2, 64, 37), (3, 16, 8, 128, 301), (1, 4, 4, 32, 1)]:
        bb, _, _, _, ss = shape
        m2 = torch.rand((bb, ss), generator=gen, device=dev) > 0.3
        m2[0, :min(ss, 64)] = False          # a fully masked tile (row 0 of S=1: fully masked)
        err_b = max(err_b, check_attention(ops, dev, gen, *shape, m2))
    # the split design's edges: S = 1, one token past a split boundary, many
    # splits; rep = 8 at d = 128, 32 and 64, rep = 3, rep = 1; row 0 with a
    # fully masked split in mid-row, the last row fully masked
    for shape in [(2, 8, 8, 64, 1), (2, 8, 1, 128, 33), (3, 16, 2, 32, 4101),
                  (3, 8, 1, 64, 405), (2, 6, 2, 32, 97), (2, 32, 32, 64, 65)]:
        bb, _, _, _, ss = shape
        m2 = torch.rand((bb, ss), generator=gen, device=dev) > 0.3
        m2[0, 32:64] = False
        m2[0, -1] = True
        m2[-1] = False
        err_b = max(err_b, check_attention(ops, dev, gen, *shape, m2))
    for path, (b, h, hk, d, s) in shape_b.items():
        mask = torch.rand((b, s), generator=gen, device=dev) > 0.2
        mask[:, -1] = True                                   # the token itself
        err = check_attention(ops, dev, gen, b, h, hk, d, s, mask)
        entry("gather_attention", path, max(err, err_b),
              time_attention(ops, dev, gen, flush, b, h, hk, d, s, mask))

    # kernel C: Zamba2 prefill B=4, S=2048 in 16 chunks of Q=128, H=64, P=64, N=64
    path = ZAMBA_SSD
    err_c = check_ssd(ops, dev, gen, path)
    for shape in [dict(b=2, nc=1, q=128, h=64, p=64, n=64),          # one chunk
                  dict(b=1, nc=2, q=16, h=2, p=8, n=4),
                  dict(b=2, nc=3, q=64, h=4, p=16, n=16),
                  dict(b=1, nc=2, q=128, h=64, p=64, n=64, steep=True),
                  dict(b=2, nc=2, q=128, h=8, p=64, n=64, pad=37),
                  dict(b=1, nc=1, q=64, h=4, p=16, n=16, steep=True, pad=11),
                  dict(b=3, nc=2, q=1, h=9, p=32, n=16),              # Q = 1, H % 4 != 0
                  dict(b=2, nc=2, q=128, h=17, p=64, n=12)]:          # N = 12: a part chunk
        err_c = max(err_c, check_ssd(ops, dev, gen, shape))
    args = ssd_inputs(gen, dev, **path)
    first = ops.ssd_chunk(*args)
    check(all(torch.equal(ops.ssd_chunk(*args), first) for _ in range(5)),
          "kernel C: repeated calls at the Zamba2 path's shapes differ in their bits")
    del first, args
    entry("ssd_chunk", ZAMBA, err_c, time_ssd(ops, dev, gen, flush, path))
    return entries


def time_ssd(ops, dev, gen, flush, shape: dict) -> dict:
    args = ssd_inputs(gen, dev, **shape)
    bc, q, h, p, n = shape["b"] * shape["nc"], shape["q"], shape["h"], shape["p"], shape["n"]
    tri = q * (q + 1) // 2                    # (i, j) pairs on and below the diagonal
    bound_c, by_c = bound_ms(4 * sum(a.numel() for a in args) + 4 * bc * q * h * p,
                             bc * tri * (2 * n + 3 * h + 2 * h * p))
    return {"ms": device_ms(lambda: ops.ssd_chunk(*args), flush),
            "device_ms": profiled_ms(lambda: ops.ssd_chunk(*args), flush, "ssd_chunk_kernel"),
            "plain_ms": device_ms(lambda: ops.ssd_chunk_plain(*args), flush),
            "bound_ms": bound_c, "bound_by": by_c, "library_ms": None}


def attention_entry(ops, dev, gen, flush, path, shape) -> dict:
    """Kernel B at ``shape = (B, H, H_kv, d, S)``, held against its plain
    version and timed (with SDPA's time), as ``path``'s entry."""
    b, h, hk, d, s = shape
    mask = torch.rand((b, s), generator=gen, device=dev) > 0.2
    mask[:, -1] = True                                   # the token itself
    err = check_attention(ops, dev, gen, b, h, hk, d, s, mask)
    return kernel_entry("gather_attention", path, err,
                        time_attention(ops, dev, gen, flush, b, h, hk, d, s, mask))


def device_entries(main_path, registry, ecfg, ops, select_groups, dev) -> list[dict]:
    """The kernel entries of the paths this script drives after the dense
    ones: kernels A and B at Whisper's shapes through the engine (H = H_kv =
    20, d 64, S = M·G + G + 1), and kernel B at each full-cache device
    path's (S = M·G + 1, or M·G + G + 1 with the rolling buffer), kernel C
    at the Zamba2 prefill's."""
    gen = torch.Generator(device=dev).manual_seed(5)
    flush = torch.empty(64 << 20, dtype=torch.uint8, device=dev)
    g, m, _ = DEVICE_KVSWAP
    w = registry.get(WHISPER)
    out = path_entries(ops, select_groups, dev, WHISPER,
                       [DEVICE_RUN["prompt_len"]] * DEVICE_RUN["batch"], ecfg,
                       h=w.n_heads, hk=w.n_kv_heads, d=w.head_dim, slots=DEVICE_RUN["batch"],
                       max_new=DEVICE_RUN["max_new"])
    for path, arch, s in ((LLAMA_DEV, LLAMA, m * g + 1), (LLAMA_ROLL, LLAMA, m * g + g + 1),
                          (ZAMBA_DEV, ZAMBA, m * g + 1), (WHISPER_DEV, WHISPER, m * g + 1)):
        cfg = registry.get(arch)
        out.append(attention_entry(ops, dev, gen, flush, path, (
            DEVICE_RUN["batch"], cfg.n_heads, cfg.n_kv_heads, cfg.head_dim, s)))
    out.append(kernel_entry("ssd_chunk", ZAMBA_DEV, check_ssd(ops, dev, gen, ZAMBA_SSD),
                            time_ssd(ops, dev, gen, flush, ZAMBA_SSD)))
    return out


def attention_inputs(dev, gen, b, h, hk, d, s):
    q = torch.randn((b, h, d), generator=gen, device=dev)
    k = torch.randn((b, s, hk, d), generator=gen, device=dev)
    v = torch.randn((b, s, hk, d), generator=gen, device=dev)
    mask = torch.rand((b, s), generator=gen, device=dev) > 0.2
    mask[:, -1] = True
    return q, k, v, mask


def wide_attention(ops, dev, card) -> None:
    """Kernel B past head_dim 128: held against its plain version at
    stablelm-12b's attention shape (and S = 1) and at d = 256, bitwise
    repeatable at stablelm-12b's shape (the StableLM path times it); its
    blocks per SM at each path's (rep, d)."""
    gen = torch.Generator(device=dev).manual_seed(2)
    err = 0.0
    for shape in [STABLELM_ATTN, (2, 32, 8, 160, 1), (2, 16, 2, 256, 300), (3, 8, 1, 256, 33)]:
        bb, _, _, _, ss = shape
        m2 = torch.rand((bb, ss), generator=gen, device=dev) > 0.3
        m2[0, 32:64] = False
        m2[0, -1] = True
        m2[-1] = False
        err = max(err, check_attention(ops, dev, gen, *shape, m2))
    q, k, v, mask = attention_inputs(dev, gen, *STABLELM_ATTN)
    first = ops.gather_attention(q, k, v, mask)
    check(all(torch.equal(ops.gather_attention(q, k, v, mask), first) for _ in range(5)),
          "kernel B at d = 160: repeated calls differ in their bits")
    print(f"kernel gather_attention past head_dim 128: max abs err {err:.3g} against its plain "
          f"version (d 160 and 256, S 1-405, masked splits and rows); bitwise repeatable at "
          f"stablelm-12b's attention shape {STABLELM_ATTN}  [{card}]")
    occ = {(rep, dd): ops.gather_attention_occupancy(rep, dd)
           for rep, dd in ((4, 128), (1, 64), (4, 160), (8, 128), (8, 256))}
    print("kernel gather_attention blocks per SM (dynamic shared memory a block): " + "; ".join(
        f"rep {rep}, d {dd}: {o['blocks_per_sm']} ({o['smem_bytes']} B)"
        for (rep, dd), o in occ.items()), flush=True)


def parent_lib(parent: Path, name: str, dev):
    """The ``csrc/<name>.cu`` of the tree at ``parent``, built with this
    tree's nvcc flags into ``build/parent_kernels/``; its ptxas lines are
    printed."""
    import ctypes

    from repro_torch.kernels import _build

    src = parent / "src" / "repro_torch" / "kernels" / "csrc" / f"{name}.cu"
    lib = ROOT / "build" / "parent_kernels" / f"lib{name}.so"
    lib.parent.mkdir(parents=True, exist_ok=True)
    out = subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(lib), str(src)],
                         capture_output=True, text=True)
    check(out.returncode == 0, f"the parent's {name}.cu did not build:\n{out.stdout}{out.stderr}")
    for line in ptxas_lines(out.stdout + out.stderr):
        print(f"  ptxas parent {name}: {line}")
    return ctypes.CDLL(str(lib))


def parent_attention(parent: Path, dev):
    """Kernel B as the tree at ``parent`` builds it (the same nvcc flags), as
    a callable of ``(q, k, v, mask)``; the C entry point is the same."""
    import ctypes

    fn = parent_lib(parent, "gather_attention", dev).gather_attention_f32
    fn.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 6 + [ctypes.c_void_p]
    counter = torch.zeros(4096, dtype=torch.int32, device=dev)

    def call(q, k, v, mask):
        b, h, d = q.shape
        s, hk = k.shape[1], k.shape[2]
        n = -(-s // 32)
        o = torch.empty_like(q)
        pacc = torch.empty((b, h, n, d), device=dev)
        pml = torch.empty((b, h, n, 2), device=dev)
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), mask.data_ptr(), o.data_ptr(),
                 pacc.data_ptr(), pml.data_ptr(), counter.data_ptr(), b, h, hk, s, d, n,
                 torch.cuda.current_stream(dev).cuda_stream)
        check(err == 0, f"the parent's kernel B failed to launch: CUDA error {err}")
        return o
    return call


def parent_scores(parent: Path, dev):
    """Kernel A as the tree at ``parent`` builds it, as a callable of ``(q_lr,
    k_lr, valid_len, group_size)``; the C entry point is the same."""
    import ctypes

    fn = parent_lib(parent, "lowrank_score", dev).lowrank_group_scores_f32
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 5 + [ctypes.c_void_p]

    def call(q, k, vl, g):
        b, h, r = q.shape
        n = k.shape[1]
        o = torch.empty((b, -(-n // g)), device=dev)
        err = fn(q.data_ptr(), k.data_ptr(), vl.data_ptr(), o.data_ptr(), b, h, n, r, g,
                 torch.cuda.current_stream(dev).cuda_stream)
        check(err == 0, f"the parent's kernel A failed to launch: CUDA error {err}")
        return o
    return call


def parent_ssd(parent: Path, dev):
    """Kernel C as the tree at ``parent`` builds it, as a callable of ``(xh,
    bm, cm, dt, cum)``; the C entry point is the same."""
    import ctypes

    fn = parent_lib(parent, "ssd_chunk", dev).ssd_chunk_f32
    fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 5 + [ctypes.c_void_p]

    def call(xh, bm, cm, dt, cum):
        b, nc, q, h, p = xh.shape
        o = torch.empty_like(xh)
        err = fn(xh.data_ptr(), bm.data_ptr(), cm.data_ptr(), dt.data_ptr(), cum.data_ptr(),
                 o.data_ptr(), b * nc, q, h, p, bm.shape[-1],
                 torch.cuda.current_stream(dev).cuda_stream)
        check(err == 0, f"the parent's kernel C failed to launch: CUDA error {err}")
        return o
    return call


def against_parent(ops, parent: Path, dev, card) -> None:
    """Kernels A, B and C of this tree and of the parent's, timed in turns
    (parent, this, this, parent) on the same inputs: A at the serving
    path's (r 64), the OLMoE path's (r 256, G 16) and a scalar-path shape
    (r 30), B at the serving and hybrid paths' shapes, C at the Zamba2
    prefill's through ``ops.ssd_chunk`` (``SSDChunk``) on inputs that take
    no gradient, as every serving path calls it; the two agree in their
    bits there."""
    gen = torch.Generator(device=dev).manual_seed(3)
    flush = torch.empty(64 << 20, dtype=torch.uint8, device=dev)
    old_a = parent_scores(parent, dev)
    for path, (b, h, r, n, g), valid in ((LLAMA, (4, 32, 64, 4096, 4), [1024, 1536, 2048, 1200]),
                                         (OLMOE, (4, 16, 256, 4096, 16), [1040, 1552, 2064, 1216]),
                                         ("scalar", (4, 32, 30, 4096, 4), [1024, 1536, 2048, 1200])):
        q = torch.randn((b, h, r), generator=gen, device=dev)
        k = torch.randn((b, n, r), generator=gen, device=dev)
        vl = torch.tensor(valid, dtype=torch.int32, device=dev)
        new_a = functools.partial(ops.lowrank_group_scores, group_size=g)
        check(torch.equal(old_a(q, k, vl, g), new_a(q, k, vl)),
              f"kernel A at {path}'s shapes differs in its bits from the parent's")
        turns = [device_ms(fn, flush) for fn in (lambda: old_a(q, k, vl, g), lambda: new_a(q, k, vl),
                                                  lambda: new_a(q, k, vl), lambda: old_a(q, k, vl, g))]
        print(f"kernel lowrank_group_scores at {path}'s shapes (B {b}, H {h}, r {r}, N {n}, G "
              f"{g}) against the parent tree, in turns (parent, this, this, parent): "
              f"{', '.join(f'{t * 1e3:.2f}' for t in turns)} us; bit-equal outputs  [{card}]",
              flush=True)
    old = parent_attention(parent, dev)
    for path, shape in ((LLAMA, (4, 32, 8, 128, 405)), (ZAMBA, (4, 32, 32, 64, 405))):
        q, k, v, mask = attention_inputs(dev, gen, *shape)
        check(torch.equal(old(q, k, v, mask), ops.gather_attention(q, k, v, mask)),
              f"kernel B at {path}'s shapes differs in its bits from the parent's")
        turns = [device_ms(functools.partial(fn, q, k, v, mask), flush)
                 for fn in (old, ops.gather_attention, ops.gather_attention, old)]
        print(f"kernel gather_attention at {path}'s shapes against the parent tree, in turns "
              f"(parent, this, this, parent): {', '.join(f'{t * 1e3:.2f}' for t in turns)} us; "
              f"bit-equal outputs  [{card}]", flush=True)
    old_c = parent_ssd(parent, dev)
    args = ssd_inputs(gen, dev, **ZAMBA_SSD)
    check(torch.equal(old_c(*args), ops.ssd_chunk(*args)),
          f"kernel C at {ZAMBA}'s shapes differs in its bits from the parent's")
    turns = [device_ms(functools.partial(fn, *args), flush)
             for fn in (old_c, ops.ssd_chunk, ops.ssd_chunk, old_c)]
    print(f"kernel ssd_chunk at {ZAMBA}'s shapes {ZAMBA_SSD} against the parent tree, in turns "
          f"(parent, this through SSDChunk, this, parent): "
          f"{', '.join(f'{t * 1e3:.2f}' for t in turns)} us; bit-equal outputs  [{card}]",
          flush=True)
    del args
    parent_moe(parent, dev, flush, card)


def parent_moe(parent: Path, dev, flush, card) -> None:
    """One OLMoE-1B-7B MoE layer (``layers.moe``) of this tree and of the
    parent's, timed in turns (parent, this, this, parent) with CUDA events
    at the OLMoE path's decode shape (B 4, S 1) and one prefill's (B 1,
    S 2048), on the same random weights; the two must agree within 1e-5 of
    the output's largest magnitude."""
    import importlib.util

    from repro_torch.configs import registry
    from repro_torch.models import layers as L

    spec = importlib.util.spec_from_file_location(
        "parent_layers", parent / "src" / "repro_torch" / "models" / "layers.py")
    old = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(old)
    if not hasattr(old, "moe"):
        print("the parent tree has no MoE layer: nothing to time against it", flush=True)
        return
    cfg = registry.get(OLMOE)
    gen = torch.Generator(device=dev).manual_seed(4)
    p = L.init_moe(generator=gen, device=dev, d_model=cfg.d_model, d_ff=cfg.moe_d_ff,
                   n_experts=cfg.n_experts)
    kw = dict(top_k=cfg.moe_top_k, capacity_factor=cfg.moe_capacity_factor)
    for b, s in ((SERVED[OLMOE]["slots"], 1), (1, 2048)):
        x = torch.randn((b, s, cfg.d_model), device=dev, generator=gen)
        y_old, y_new = old.moe(p, x, **kw)[0], L.moe(p, x, **kw)[0]
        err = float((y_old - y_new).abs().max())
        check(err <= 1e-5 * max(1.0, float(y_old.abs().max())),
              f"the MoE layer at (B {b}, S {s}) differs from the parent's by {err}")
        turns = [device_ms(lambda fn=fn: fn(p, x, **kw), flush)
                 for fn in (old.moe, L.moe, L.moe, old.moe)]
        print(f"{OLMOE} MoE layer at (B {b}, S {s}) against the parent tree, in turns (parent, "
              f"this, this, parent): {', '.join(f'{t:.3f}' for t in turns)} ms; bit-equal "
              f"{torch.equal(y_old, y_new)}, max abs diff {err:.3g}  [{card}]", flush=True)
    del p, x, y_old, y_new


def route_phase(compare_routes, dev, card) -> None:
    """The engine's card route (kernels A and B) against its CPU route (the
    plain versions) on one set of tiny weights."""
    run = compare_routes(dev)
    flips = run["flips"]
    print(f"card route against CPU route (tiny_cfg shape, device_resident, 12 greedy steps, 2 "
          f"rows): tokens equal {run['tokens_equal']}; {len(flips)} flipped selections of "
          f"{run['selections']}; card launches {run['launches_card']}  [{card}]")
    for f in flips:
        print(f"  flip at step {f['step']}, layer {f['layer']}, row {f['row']}: the card chose "
              f"{f['groups_a']} over {f['groups_b']} by {f['gap_a']:.3g}, the CPU the other way "
              f"by {f['gap_b']:.3g}, the two sides' scores differ by {f['score_diff']:.3g} "
              f"(of the row's score scale {f['scale']:.3g}; kernel A's tolerance {SCORE_RTOL})")
    check(run["tokens_equal"], f"card and CPU routes give different tokens: "
          f"{run['tokens_card'].tolist()} against {run['tokens_cpu'].tolist()}")
    check(all(n > 0 for n in run["launches_card"].values()), "the card route ran no kernel")
    check(all(max(f["gap_a"], f["gap_b"]) <= max(f["score_diff"], SCORE_RTOL) for f in flips),
          "a flipped selection is not a near-tie within the two sides' score difference")


def step_kernels_ms(entries, path, launches, steps) -> float:
    """Device ms per decode step in the decode kernels of ``path``: each
    kernel's launches x its time at that path's shapes, over the steps."""
    return sum(e["ms"] * launches[e["name"]] for e in entries
               if e["path"] == path and e["name"] != "ssd_chunk") / steps


def hybrid_phases(run_hybrid_path, cfg, ecfg, dev, entries, card) -> dict:
    """The second main path (Zamba2-1.2B through ``generate``) and its
    12-block bit-identity checks; returns the main run's launches."""
    n_mamba, n_kv = cfg.blocks.count("mamba2"), cfg.blocks.count("shared_attn")
    t0 = time.perf_counter()
    run = run_hybrid_path(cfg, device=dev, engine_cfg=ecfg, batch=4, prompt_len=2048,
                          max_new=32, seed=0, profile_prefill=True)
    check(run["n_layers"] == 38 and (n_mamba, n_kv) == (32, 6),
          f"hybrid path ran {run['n_layers']} blocks ({n_mamba} Mamba2, {n_kv} attention)")
    check(run["tokens"].shape == (4, 32), f"hybrid tokens {run['tokens'].shape} != (4, 32)")
    check(run["logits_finite"], "non-finite logits on the hybrid path")
    check(run["n_store_layers"] == n_kv, f"engine.store.n_layers {run['n_store_layers']} != {n_kv}")
    check(run["n_states"] == n_mamba, f"{run['n_states']} recurrent states, expected {n_mamba}")
    steps = run["decode_steps"]
    launches = run["launches"]
    check(launches["ssd_chunk"] == n_mamba,
          f"ssd_chunk launched {launches['ssd_chunk']} times, expected {n_mamba} (one prefill)")
    for name in ("lowrank_group_scores", "gather_attention"):
        check(launches[name] == steps * n_kv,
              f"{name} launched {launches[name]} times, expected {steps} steps x {n_kv}")
    walls = run["decode_step_wall_seconds"]
    med = statistics.median(walls) * 1e3
    print(f"hybrid path: zamba2-1.2b, 38 blocks ({n_mamba} Mamba2, {n_kv} shared attention), "
          f"batch 4 x 2048 prompt tokens, {steps} decode steps, launches {launches}, "
          f"total {time.perf_counter() - t0:.1f} s  [{card}]")
    print(f"hybrid path: prefill wall {run['prefill_seconds'] * 1e3:.1f} ms; decode step wall "
          f"median {med:.1f} ms, mean {statistics.fmean(walls) * 1e3:.1f} ms over {steps} "
          f"steps; {run['tokens_per_s']:.1f} tokens/s over generate ({run['wall_seconds']:.2f} s, "
          f"prefill included); peak device memory {run['peak_memory_bytes'] / 2**30:.2f} GiB"
          f"  [{card}]", flush=True)
    # decode step: blocked on group reads, kernels A and B (launches per
    # step x their time at this path's shapes; kernel C runs only in the
    # prefill), and the rest
    wait_ms = statistics.median(run["decode_step_io_wait_seconds"]) * 1e3
    kern_ms = step_kernels_ms(entries, ZAMBA, launches, steps)
    ssd_ms = next(e["ms"] for e in entries if e["name"] == "ssd_chunk") * launches["ssd_chunk"]
    print(f"hybrid path: decode step median {med:.1f} ms = wait on group reads {wait_ms:.1f} ms"
          f" + kernels A, B {kern_ms:.2f} ms + rest {med - wait_ms - kern_ms:.1f} ms; prefill "
          f"{run['prefill_seconds'] * 1e3:.1f} ms holds kernel C {ssd_ms:.2f} ms  [{card}]",
          flush=True)
    # where a prefill's time goes: the same prompts once more under torch.profiler
    prof = run["prefill_profile"]
    check(prof["device_busy_ms"] > 0, "torch.profiler recorded no device time in the prefill")
    ops_ = prof["ops"]
    shown = ops_[:8] + [op for op in ops_[8:] if "ssd_chunk_kernel" in op[0]]
    print(f"hybrid prefill profile: a second prefill of the same prompts under torch.profiler: "
          f"window {prof['window_ms']:.1f} ms (unprofiled {run['prefill_seconds'] * 1e3:.1f} ms); "
          f"device busy {prof['device_busy_ms']:.1f} ms ({100 * prof['device_busy_share']:.1f} %), "
          f"host alone {prof['host_only_ms']:.1f} ms; {len(ops_)} device operations, "
          f"{sum(ms for _, ms, _ in ops_):.1f} ms in all  [{card}]")
    print("hybrid prefill profile: top device operations by total time: " + "; ".join(
        f"{name[:80]} {ms:.2f} ms x{n}" for name, ms, n in shown) + f"  [{card}]", flush=True)
    del run
    free_device()

    toks = {}
    for aio, dr in ((False, False), (True, False), (False, True), (True, True)):
        r = run_hybrid_path(cfg, device=dev, n_layers=12, batch=4, prompt_len=2048, max_new=16,
                            engine_cfg=dataclasses.replace(ecfg, async_io=aio, device_resident=dr))
        check(r["launches"]["ssd_chunk"] == 10 and r["n_store_layers"] == 2,
              f"12-block run: {r['launches']}, {r['n_store_layers']} KV layers on disk")
        toks[aio, dr] = r["tokens"]
    ref = toks[False, False]
    check(all(t.shape == (4, 16) and (t == ref).all() for t in toks.values()),
          "12-block hybrid tokens differ across async_io / device_resident")
    print("12 blocks: hybrid tokens bit-identical with async_io and device_resident "
          "on and off", flush=True)
    return launches


def ms_list(walls) -> str:
    return "[" + ", ".join(f"{w * 1e3:.1f}" for w in walls) + "]"


def prefix_phases(run_prefix_path, cfg, ecfg, weights, dev, card) -> dict:
    """The prefix path at full width on the main path's weights: 8 requests
    over a shared 1536-token prefix through the prefix cache, the control
    session without it, and the warm-cold comparison; returns the cache
    session's launches."""
    t0 = time.perf_counter()
    run = run_prefix_path(cfg, device=dev, engine_cfg=ecfg, weights=weights)
    n_layers, steps = run["n_layers"], run["decode_steps"]
    check(n_layers == 32, f"prefix path ran {n_layers} layers")
    check(all(o is not None and len(o) == 32 for o in run["outputs"]) and len(run["outputs"]) == 8,
          "not every prefix-path request completed with 32 tokens")
    check(run["logits_finite"], "non-finite logits on the prefix path")
    adm = run["admissions"]
    cached = [a["cached_tokens"] for a in adm]
    check(len(adm) == 8 and cached[:4] == [0] * 4 and cached[4:] == [1536] * 4,
          f"prefix path admissions cached {cached}, expected 4 x 0 then 4 x 1536")
    launches = run["launches"]
    for name, n in launches.items():
        check(n == steps * n_layers,
              f"prefix path: {name} launched {n} times, expected {steps} steps x {n_layers}")
    cold, warm = adm[:4], adm[4:]
    walls = run["decode_step_wall_seconds"]
    print(f"prefix path: llama3-8b, {n_layers} layers, 8 requests (prompts {run['prompt_lens']}: "
          f"a shared 1536-token prefix + 256-512 own tokens), {steps} decode steps, launches "
          f"{launches}, total {time.perf_counter() - t0:.1f} s (control run and comparison "
          f"included)  [{card}]")
    print(f"prefix path: cold admissions ms {ms_list(a['wall_seconds'] for a in cold)} "
          f"(computed {[a['computed_tokens'] for a in cold]}), median "
          f"{statistics.median(a['wall_seconds'] for a in cold) * 1e3:.1f} ms; warm admissions "
          f"ms {ms_list(a['wall_seconds'] for a in warm)} (cached 1536, computed "
          f"{[a['computed_tokens'] for a in warm]}), median "
          f"{statistics.median(a['wall_seconds'] for a in warm) * 1e3:.1f} ms; control (no "
          f"cache) admissions of the last four ms "
          f"{ms_list(a['wall_seconds'] for a in run['control_admissions'][4:])}  [{card}]")
    print(f"prefix path: restore bytes per warm admission "
          f"{[a['restore_bytes'] for a in warm]}; publish read {run['publish_read_bytes']} B "
          f"from the engine's disk, wrote {run['publish_write_bytes']} B to the cache in "
          f"{run['publish_seconds'] * 1e3:.1f} ms; {run['resident_blocks']} blocks resident; "
          f"decode step wall median {statistics.median(walls) * 1e3:.1f} ms over {len(walls)} "
          f"steps without admissions; {run['tokens_per_s']:.1f} tokens/s over the drain "
          f"({run['wall_seconds']:.1f} s, admissions included); peak device memory "
          f"{run['peak_memory_bytes'] / 2**30:.2f} GiB  [{card}]", flush=True)
    wc = run["warm_cold"]
    check(wc["cached_tokens"] == 1536, f"warm-cold comparison restored {wc['cached_tokens']} tokens")
    print(f"prefix path: tokens equal to the control's (no cache), by request: "
          f"{run['tokens_equal']}")
    print(f"prefix path: warm vs cold admission of one more prompt at slot 0 of two fresh "
          f"engines (1536 cached): last-position logits bit-equal {wc['bits_equal']}, max abs "
          f"diff {wc['max_abs_diff']:.3g} (largest |logit| {wc['max_abs_logit']:.3g}); first "
          f"operation whose bits differ, cold forward against warm (restored K, V): "
          f"{wc['first_divergence'] or 'none'} (max abs diff "
          f"{wc['first_divergence_diff']:.3g}); between the cold forwards of the prompt that "
          f"published the prefix and of this one, on their shared rows: "
          f"{wc['prefix_divergence'] or 'none'} (max abs diff {wc['prefix_divergence_diff']:.3g})"
          f"  [{card}]", flush=True)
    if wc["bits_equal"]:
        check(all(run["tokens_equal"]), "warm logits are bit-equal to cold, yet the prefix "
              f"path's tokens differ from the control's: {run['tokens_equal']}")
    else:
        check(wc["max_abs_diff"] <= 1e-4 * wc["max_abs_logit"],
              f"warm logits differ from cold by {wc['max_abs_diff']:.3g}, more than 1e-4 of "
              f"{wc['max_abs_logit']:.3g}")
    prof = run["warm_profile"]
    ops_, host = prof["ops"], prof["host_ms"]
    dev_ms = {kind: sum(ms for name, ms, _ in ops_ if kind in name)
              for kind in ("Memcpy HtoD", "Memcpy DtoH")}
    rest = prof["window_ms"] - sum(host.values())
    print(f"prefix path: the warm admission under torch.profiler: window "
          f"{prof['window_ms']:.1f} ms; host time in the restore read (checksums and copy of "
          f"{prof['restore_bytes']} B) {host['read_chain']:.1f} ms, uploads of the restored K, V "
          f"{host['_upload']:.1f} ms, downloads of the computed K, V (each waiting for its "
          f"layer) {host['_host']:.1f} ms, writes of the prompt's K, V to the engine's disk "
          f"store {host['write_prefill_row']:.1f} ms, the rest {rest:.1f} ms; device busy "
          f"{prof['device_busy_ms']:.1f} ms ({100 * prof['device_busy_share']:.1f} %), of which "
          f"uploads {dev_ms['Memcpy HtoD']:.1f} ms and downloads {dev_ms['Memcpy DtoH']:.1f} ms"
          f"  [{card}]")
    print("prefix path: warm admission's top device operations by total time: " + "; ".join(
        f"{name[:80]} {ms:.2f} ms x{n}" for name, ms, n in ops_[:8]) + f"  [{card}]", flush=True)
    return launches


def median_ms(walls) -> str:
    return f"{statistics.median(walls) * 1e3:.1f}" if walls else "-"


def router_phase(run_router_path, cfg, ecfg, weights, dev, card) -> dict:
    """The router path at full width on the main path's weights: two
    replicas behind the KV-affinity router replaying a three-tenant chat
    trace; returns the replay's launches."""
    t0 = time.perf_counter()
    run = run_router_path(cfg, device=dev, engine_cfg=ecfg, weights=weights)
    n_layers, reqs = run["n_layers"], run["requests"]
    check(n_layers == 32, f"router path ran {n_layers} layers")
    check(len(reqs) == 9 and all(q["output"] is not None and len(q["output"]) == 16
                                 for q in reqs),
          "not every router-path request completed with 16 tokens")
    check(run["logits_finite"], "non-finite logits on the router path")
    for q in reqs:
        print(f"router path: request {reqs.index(q)} tenant {q['tenant']} turn {q['turn']} -> "
              f"{q['replica']}; prompt {q['prompt_tokens']}, cached {q['cached_tokens']}, "
              f"computed {q['prompt_tokens'] - q['cached_tokens']}; modeled arrival "
              f"{q['arrival']:.3f} s, previous turn finished at "
              + ("-" if q["prev_finished_at"] is None else f"{q['prev_finished_at']:.3f} s"))
    first = {q["tenant"]: q["replica"] for q in reqs if q["turn"] == 1}
    for q in reqs:
        if q["turn"] > 1:
            check(q["arrival"] >= q["prev_finished_at"],
                  f"tenant {q['tenant']} turn {q['turn']} arrived at {q['arrival']:.3f} s, "
                  f"before its previous turn finished ({q['prev_finished_at']:.3f} s)")
            check(q["replica"] == first[q["tenant"]],
                  f"tenant {q['tenant']} turn {q['turn']} went to {q['replica']}, turn 1 to "
                  f"{first[q['tenant']]}")
            check(q["cached_tokens"] >= 1024,
                  f"tenant {q['tenant']} turn {q['turn']} restored {q['cached_tokens']} tokens")
    steps = run["decode_steps"]
    for name, n in run["launches"].items():
        check(n == sum(steps.values()) * n_layers,
              f"router path: {name} launched {n} times, expected {sum(steps.values())} "
              f"steps x {n_layers}")
    adm = [a for walls in run["admissions"].values() for a in walls]
    cold = [a["wall_seconds"] for a in adm if not a["cached_tokens"]]
    warm = [a["wall_seconds"] for a in adm if a["cached_tokens"]]
    fleet = run["fleet"]
    print(f"router path: llama3-8b, {n_layers} layers, 2 replicas x 4 slots, "
          f"PrefixAffinityRouter, 9 requests of 3 tenants (1024 system + 128 a turn, 16 new); "
          f"decode steps {steps}, launches {run['launches']}, total "
          f"{time.perf_counter() - t0:.1f} s  [{card}]")
    print(f"router path: warm-prefill hit rate {fleet['cached_prompt_tokens']} / "
          f"{fleet['prompt_tokens']} = {fleet['prefix_hit_rate']:.4f} cached prompt tokens; cold "
          f"admissions ms {ms_list(cold)}, warm admissions ms {ms_list(warm)}; decode step wall "
          f"median by replica " + ", ".join(f"{n} {median_ms(w)} ms over {len(w)}" for n, w in
                                            run["decode_step_wall_seconds"].items())
          + f"; publish {', '.join(f'{n} {t:.2f} s' for n, t in run['publish_seconds'].items())}; "
          f"{run['tokens_per_s']:.1f} tokens/s over the replay ({run['wall_seconds']:.1f} s); "
          f"peak device memory {run['peak_memory_bytes'] / 2**30:.2f} GiB  [{card}]", flush=True)
    return run["launches"]


def disagg_phase(run_disagg_path, cfg, ecfg, weights, dev, card) -> dict:
    """The disaggregated path at full width on the main path's weights: one
    prefill engine handing off to one decode session over a shared prefix
    cache, 4 long prompts arriving at once, and the co-located control;
    returns the front end's launches."""
    t0 = time.perf_counter()
    run = run_disagg_path(cfg, device=dev, engine_cfg=ecfg, weights=weights)
    n_layers, steps = run["n_layers"], run["decode_steps"]
    check(n_layers == 32, f"disagg path ran {n_layers} layers")
    check(run["states"] == ["done"] * 4, f"disagg tickets ended {run['states']}")
    check(run["logits_finite"], "non-finite logits on the disagg path")
    for n, t in zip(run["prompt_lens"], run["tickets"]):
        adm = t["decode_admission"]
        print(f"disagg path: prompt {n}: prefill {t['prefill_seconds'] * 1e3:.1f} ms, publish "
              f"{t['publish_seconds'] * 1e3:.1f} ms ({t['published_blocks']} blocks), decode "
              f"admission {adm['wall_seconds'] * 1e3:.1f} ms (restored {adm['cached_tokens']}, "
              f"computed {adm['computed_tokens']})  [{card}]")
        # every published block below the prompt's last token, which a
        # restore always leaves to compute
        check(adm["cached_tokens"] == (n - 1) // 32 * 32 and t["published_blocks"] == n // 32,
              f"disagg prompt {n}: the decode admission restored {adm['cached_tokens']} tokens, "
              f"{t['published_blocks']} blocks were published")
    for name, k in run["prefill_launches"].items():
        check(k == 0, f"disagg path: {name} launched {k} times in the prefill engine's steps")
    for name, k in run["launches"].items():
        check(k == steps * n_layers,
              f"disagg path: {name} launched {k} times, expected {steps} steps x {n_layers}")
    check(all(run["tokens_equal"]), f"disagg tokens differ from the co-located control's: "
          f"{run['tokens_equal']}")
    fl = run["first_logits"]
    for f in fl:
        check(f["max_abs_diff"] <= 1e-4 * f["max_abs_logit"],
              f"disagg first-token logits differ from the control's by {f['max_abs_diff']:.3g}, "
              f"more than 1e-4 of {f['max_abs_logit']:.3g}")
    walls = run["decode_step_wall_seconds"]
    print(f"disagg path: llama3-8b, {n_layers} layers, PrefillEngine p0 -> ServeSession(4 slots) "
          f"over one prefix cache, prompts {run['prompt_lens']} at t = 0, 16 new each; tickets "
          f"{run['states']}, {steps} decode steps, launches {run['launches']} (in the prefill "
          f"engine's steps {run['prefill_launches']}); tokens equal to the co-located control's; "
          f"first-token logits bit-equal {[f['bits_equal'] for f in fl]}, max abs diff "
          f"{max(f['max_abs_diff'] for f in fl):.3g} (largest |logit| "
          f"{max(f['max_abs_logit'] for f in fl):.3g}); total {time.perf_counter() - t0:.1f} s "
          f"(control included)  [{card}]")
    print(f"disagg path: decode step wall median {median_ms(walls)} ms over {len(walls)} steps; "
          f"{run['tokens_per_s']:.1f} tokens/s over the front end's drain "
          f"({run['wall_seconds']:.1f} s, prefills and publishes included); peak device memory "
          f"{run['peak_memory_bytes'] / 2**30:.2f} GiB  [{card}]", flush=True)
    return run["launches"]


def front_half_reduced(main_mod, cfg, ecfg, weights, dev, card) -> None:
    """The serving front half at 4 layers (full width, the 4-layer weights):
    BatchServer against ServeSession, routed against solo sessions, peek
    neutrality, the report over an exported trace, a corrupt chain at the
    handoff, and a trace replayed twice."""
    import tempfile

    from repro_torch.faults import FaultPlan, FaultSpec
    from repro_torch.obs.report import main as report_main
    from repro_torch.serving import BatchServer, SLOClass, ServeSession, burst_trace, replay

    t0 = time.perf_counter()
    model, params, adapter = weights
    rng = __import__("numpy").random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab_size, int(n)) for n in rng.integers(256, 513, 6)]
    with BatchServer(model, params, ecfg, batch=4, adapter=adapter, device=dev) as srv:
        engine = srv.session.engine
        rids = [srv.submit(p, 16) for p in prompts]          # the fourth submit flushes
        first = dict(srv.last_stats)
        srv.flush()
        second = dict(srv.last_stats)
        check(srv.session.engine is engine, "BatchServer built a second engine")
        batched = [srv.result(r) for r in rids]
    check((first["real_requests"], first["padded_requests"]) == (4, 0)
          and (second["real_requests"], second["padded_requests"]) == (2, 2),
          f"BatchServer flushes: real/padded {first['real_requests']}/"
          f"{first['padded_requests']}, {second['real_requests']}/{second['padded_requests']}")
    solo = main_mod._serve(model, params, adapter, ecfg, dev, prompts, 16, slots=4)["outputs"]
    check(all((a == b).all() for a, b in zip(batched, solo)),
          "BatchServer tokens differ from the same requests in a ServeSession")
    print(f"4 layers, BatchServer(batch=4): flushes of 4 and 2 requests (padded 0 and 2), one "
          f"engine; tokens bit-identical to a ServeSession's", flush=True)

    with tempfile.TemporaryDirectory(prefix="router-trace-") as tmp:
        run = main_mod.run_router_path(cfg, device=dev, n_layers=4, engine_cfg=ecfg,
                                       weights=weights, solo=True, peek=True, trace_dir=tmp)
        check(all(run["solo_equal"]), f"4 layers: routed tokens differ from solo sessions' "
              f"{run['solo_equal']}")
        check(run["peek_neutral"], "4 layers: affinity scoring changed a replica's cache")
        print(f"4 layers, router: routes {[q['replica'] for q in run['requests']]}; tokens "
              f"bit-identical to each replica's arrivals replayed in a fresh solo session; 10 "
              f"rounds of affinity scores left every cache's stats, LRU stamps and pins as they "
              f"were", flush=True)
        for name, path in run["trace_files"].items():
            print(f"4 layers, router: repro_torch.obs.report over replica {name}'s exported "
                  f"trace:", flush=True)
            check(report_main([path]) == 0 and report_main([path, "--check"]) == 0,
                  f"repro_torch.obs.report rejected replica {name}'s trace")
    sys.stdout.flush()

    plan = FaultPlan(FaultSpec(seed=0, corrupt_block_rate=0.05))
    dg = main_mod.run_disagg_path(cfg, device=dev, n_layers=4, engine_cfg=ecfg,
                                  weights=weights, cache_faults=plan)
    rq = dg["requeued"]
    check(rq is not None and rq["rids"] and not any(rq["decode_admitted"])
          and rq["cache_stats"]["quarantined_blocks"] > 0,
          f"4 layers, disagg with blocks corrupted at rest: {rq}")
    check(dg["states"] == ["done"] * 4 and all(dg["tokens_equal"]),
          f"4 layers, disagg after a corrupt chain: tickets {dg['states']}, tokens equal to "
          f"the control's {dg['tokens_equal']}")
    check(all(dg["attempts"][r] == 2 for r in rq["rids"]),
          f"4 layers, disagg: attempts {dg['attempts']}")
    print(f"4 layers, disagg with 5 % of published blocks corrupted at rest until the first "
          f"re-queue: ticket(s) {rq['rids']} re-queued with no decode row admitted "
          f"({rq['cache_stats']['corrupt_blocks']} checksum failures, "
          f"{rq['cache_stats']['quarantined_blocks']} blocks quarantined), then every ticket "
          f"done (attempts {dg['attempts']}) with the control's tokens", flush=True)

    slo = {"interactive": SLOClass("interactive", ttft_s=0.5, tpot_s=0.1),
           "bulk": SLOClass("bulk", ttft_s=1.5, tpot_s=0.3)}
    tr = burst_trace(0, bursts=2, burst_size=4, prompt_tokens=(256, 384, 512),
                     max_new_choices=(8, 16), slo_classes=slo, vocab_size=cfg.vocab_size)
    blobs = []
    for _ in range(2):
        with ServeSession(model, params, dataclasses.replace(ecfg, async_io=False), slots=4,
                          adapter=adapter, device=dev) as sess:
            blobs.append(json.dumps(replay(tr, sess), sort_keys=True))
    check(blobs[0] == blobs[1], "4 layers: two replays of one trace gave different metrics JSON")
    m = json.loads(blobs[0])
    print(f"4 layers, trace replay (burst, {m['n_requests']} requests, async_io off) twice: "
          f"metrics JSON byte-identical ({len(blobs[0])} B; modeled makespan "
          f"{m['makespan_seconds']:.3f} s, SLO attainment {m['slo_attainment']:.3f}); front-half "
          f"4-layer checks {time.perf_counter() - t0:.1f} s", flush=True)


def reduced_phases(run_main_path, run_prefix_path, build_weights, cfg, ecfg, dev) -> tuple:
    """Bit-identity and fault checks at 4 layers (full width), on one set of
    weights shared by every run."""
    from repro_torch.faults import FaultPlan, FaultSpec

    t0 = time.perf_counter()
    weights = build_weights(cfg, device=dev, n_layers=4, rank=ecfg.rank)
    main = functools.partial(run_main_path, cfg, device=dev, n_layers=4, weights=weights)
    same = lambda a, b: all(x is not None and y is not None and x.shape == y.shape
                            and (x == y).all() for x, y in zip(a, b))
    runs = {}
    for aio in (True, False):
        run = main(engine_cfg=dataclasses.replace(ecfg, async_io=aio))
        for name, n in run["launches"].items():
            check(n == run["decode_steps"] * 4, f"4-layer run: {name} launched {n} times")
        runs[aio] = run
    base = runs[True]["outputs"]
    check(all(math.prod(a.shape) == 32 for a in base) and same(base, runs[False]["outputs"]),
          "4-layer tokens differ between async_io on and off")
    print("4 layers: tokens bit-identical with async_io on and off", flush=True)

    kv8 = dataclasses.replace(ecfg, kv_bits=8)
    off = main(engine_cfg=kv8)
    on = main(engine_cfg=dataclasses.replace(kv8, warm_budget_bytes=256 << 20))
    warm_bytes = on["accountant"]["warm_bytes"]
    check(same(off["outputs"], on["outputs"]), "4 layers, kv_bits=8: tokens differ with the "
          "warm tier on and off")
    check(warm_bytes > 0, "4 layers: the warm tier served no bytes, the check proved nothing")
    print(f"4 layers, kv_bits=8: tokens bit-identical with the warm tier (256 MiB) on and off; "
          f"warm-served {warm_bytes} B, disk reads {on['accountant']['read_bytes']} B against "
          f"{off['accountant']['read_bytes']} B with the tier off", flush=True)

    plan = FaultPlan(FaultSpec(seed=3, read_error_rate=0.05, torn_read_rate=0.02, error_burst=1))
    faulted = main(engine_cfg=dataclasses.replace(ecfg, io_max_attempts=3), faults=plan)
    st = faulted["stats"]
    check(same(base, faulted["outputs"]), "4 layers: transient faults changed the tokens")
    check(st["io_retries"] > 0 and st["failed_requests"] == 0 and faulted["prefetch_deaths"] == 0,
          f"4 layers, transient faults: retries {st['io_retries']}, failed "
          f"{st['failed_requests']}, prefetch deaths {faulted['prefetch_deaths']}")
    print(f"4 layers, transient read faults (5 % errors, 2 % torn reads, bursts of 1, 3 "
          f"attempts): tokens bit-identical to the unfaulted run; {st['io_retries']} retries, "
          f"0 failed requests, 0 prefetch deaths; injected {plan.snapshot()}", flush=True)

    # 35 % of writes growing a bad extent fails every request at these
    # sizes; 1 % leaves survivors, whose tokens are then held to the
    # unfaulted run's
    for rate, need in ((0.35, "failed_requests"), (0.01, "completed_requests")):
        bad = main(engine_cfg=ecfg, faults=FaultPlan(FaultSpec(seed=11, bad_extent_rate=rate)))
        st = bad["stats"]
        check(st["failed_requests"] + st["completed_requests"] == len(base) and st[need] > 0,
              f"4 layers, bad extents at {rate}: {st['failed_requests']} failed + "
              f"{st['completed_requests']} completed of {len(base)} requests")
        check(all(o is None or (o == b).all() for o, b in zip(bad["outputs"], base)),
              f"4 layers, bad extents at {rate}: a surviving request's tokens differ from the "
              f"unfaulted run")
        print(f"4 layers, grown bad extents ({100 * rate:g} % of writes): the session drained; "
              f"{st['completed_requests']} completed with the unfaulted tokens, "
              f"{st['failed_requests']} failed, {st['recovered_rows']} rows replayed", flush=True)

    plan = FaultPlan(FaultSpec(seed=0, corrupt_block_rate=0.05))
    px = run_prefix_path(cfg, device=dev, n_layers=4, engine_cfg=ecfg, weights=weights,
                         cache_faults=plan, compare=False)
    cs = px["cache_stats"]
    check(cs["quarantined_blocks"] > 0, f"4 layers, corrupt blocks: nothing quarantined ({cs})")
    check(all(px["tokens_equal"]), f"4 layers, corrupt blocks: tokens differ from the control "
          f"without cache or faults: {px['tokens_equal']}")
    print(f"4 layers, prefix path with blocks corrupted at rest (5 %): {cs['corrupt_blocks']} "
          f"checksum failures, {cs['quarantined_blocks']} blocks quarantined, cached tokens "
          f"{[a['cached_tokens'] for a in px['admissions']]}; tokens equal to the control's "
          f"(no cache, no faults); 4-layer checks {time.perf_counter() - t0:.1f} s", flush=True)
    return weights


def print_entry(e: dict, card: str) -> None:
    lib = "-" if e["library_ms"] is None else f"{e['library_ms'] * 1e3:.2f} us"
    dev_t = "-" if e["device_ms"] is None else f"{e['device_ms'] * 1e3:.2f} us"
    print(f"kernel {e['name']} at {e['path']}'s shapes: {e['ms'] * 1e3:.2f} us (kernel alone "
          f"{dev_t}, profiler), plain {e['plain_ms'] * 1e3:.2f} us, bound "
          f"{e['bound_ms'] * 1e3:.2f} us ({e['bound_by']}), library {lib}, max abs err "
          f"{e['max_abs_err']:.3g}  [{card}]", flush=True)


def path_entries(ops, select_groups, dev, path, prompt_lens, ecfg, *, h, hk, d, slots,
                 max_new) -> list[dict]:
    """Kernels A and B at one served path's shapes, held against their plain
    versions and timed, one entry each: B = the slots, the model's heads and
    head_dim, the engine's rank, G and M, N = the compressed cache's
    capacity, each row's valid length the first prompts' groups halfway
    through their new tokens, S = M·G + G + 1."""
    gen = torch.Generator(device=dev).manual_seed(4)
    flush = torch.empty(64 << 20, dtype=torch.uint8, device=dev)
    g, m, r = ecfg.group_size, ecfg.n_select, ecfg.rank
    n = -(-ecfg.max_seq // g) * g
    valid = [min(n, (p + max_new // 2) // g * g) for p in prompt_lens[:slots]]
    err_a = check_scores(ops, select_groups, dev, gen, slots, h, r, n, g, valid, m)
    s = m * g + g + 1
    mask = torch.rand((slots, s), generator=gen, device=dev) > 0.2
    mask[:, -1] = True
    err_b = check_attention(ops, dev, gen, slots, h, hk, d, s, mask)
    return [kernel_entry("lowrank_group_scores", path, err_a,
                         time_scores(ops, dev, gen, flush, slots, h, r, n, g, valid)),
            kernel_entry("gather_attention", path, err_b,
                         time_attention(ops, dev, gen, flush, slots, h, hk, d, s, mask))]


def served_entries(main_path, registry, ecfgs, ops, select_groups, dev) -> list[dict]:
    """The kernel entries of the paths served after the hybrid one
    (``SERVED``), at each path's shapes, taken before any path runs (their
    prompt lengths come from ``main_path.main_prompts``, as the runs draw
    them)."""
    out = []
    for path, kw in SERVED.items():
        cfg = registry.get(ARCH_OF.get(path, path))
        _, prompts = main_path.main_prompts(cfg, n_requests=kw["n_requests"],
                                            prompt_len=kw["prompt_len"])
        out += path_entries(ops, select_groups, dev, path, [len(p) for p in prompts],
                            ecfgs[path], h=cfg.n_heads, hk=cfg.n_kv_heads, d=cfg.head_dim,
                            slots=kw["slots"], max_new=kw["max_new"])
    return out


def served_run(main_path, registry, path, ecfg, dev, **extra) -> tuple:
    """``run_main_path`` on ``path`` as ``SERVED`` sizes it, with every
    request completed with its new tokens, finite logits, the depth served,
    and kernels A and B launched once per layer per decode step."""
    kw = SERVED[path]
    cfg = registry.get(ARCH_OF.get(path, path))
    run = main_path.run_main_path(cfg, device=dev, engine_cfg=ecfg, **kw, **extra)
    n_layers = kw["n_layers"] or cfg.n_layers
    check(run["n_layers"] == n_layers, f"{path} path ran {run['n_layers']} layers")
    outs = run["outputs"]
    check(len(outs) == kw["n_requests"]
          and all(o is not None and len(o) == kw["max_new"] for o in outs),
          f"{path} path: not every request completed with {kw['max_new']} tokens")
    check(run["logits_finite"], f"non-finite logits on the {path} path")
    for kernel, n in run["launches"].items():
        check(n == run["decode_steps"] * n_layers,
              f"{path} path: {kernel} launched {n} times, expected {run['decode_steps']} "
              f"steps x {n_layers}")
    return cfg, run


def served_report(run, name: str, entries, card: str, t0: float) -> float:
    """Print a served path's decode-step split (wait on group reads, kernels
    A and B at its shapes, the rest), tokens/s and peak memory; returns the
    step median in ms."""
    walls = run["decode_step_wall_seconds"]
    med = statistics.median(walls) * 1e3
    wait_ms = statistics.median(run["decode_step_io_wait_seconds"]) * 1e3
    kern_ms = step_kernels_ms(entries, name, run["launches"], run["decode_steps"])
    print(f"{name} path: {run['n_layers']} layers, {len(run['outputs'])} requests (prompts "
          f"{run['prompt_lens']}), {run['decode_steps']} decode steps, launches "
          f"{run['launches']}, total {time.perf_counter() - t0:.1f} s  [{card}]")
    print(f"{name} path: decode step median {med:.1f} ms = wait on group reads {wait_ms:.1f} ms "
          f"+ kernels A, B {kern_ms:.2f} ms + rest {med - wait_ms - kern_ms:.1f} ms over "
          f"{len(walls)} steps without admissions; {run['tokens_per_s']:.1f} tokens/s over the "
          f"drain ({run['wall_seconds']:.1f} s, prefills included); peak device memory "
          f"{run['peak_memory_bytes'] / 2**30:.2f} GiB  [{card}]", flush=True)
    return med


def tuner_phase(main_path, registry, card):
    """The paper's offline tuner for OLMoE-1B-7B's dims, and for
    Llama-3.1-8B's at the same inputs; returns the engine parameters the
    OLMoE path and the tuned Llama path serve with."""
    cfg = registry.get(OLMOE)
    tuned, ecfg = main_path.tuned_engine_config(cfg, **OLMOE_TUNE, device_resident=True,
                                                async_io=True)
    print(f"tuner: {OLMOE} (dims {dataclasses.asdict(main_path.model_dims(cfg))}, "
          f"{cfg.n_layers} layers), b_max {OLMOE_TUNE['b_max']}, s_max {OLMOE_TUNE['s_max']}, "
          f"budget {OLMOE_TUNE['budget_bytes'] >> 20} MiB a batch, disk {OLMOE_TUNE['disk']}, "
          f"compute model jetson-orin-agx: TunedParams {json.dumps(dataclasses.asdict(tuned))}; "
          f"engine reuse_capacity {ecfg.reuse_capacity} (tuned {tuned.reuse_capacity})",
          flush=True)
    llama = registry.get(LLAMA)
    tuned_l, ecfg_l = main_path.tuned_engine_config(llama, **OLMOE_TUNE, device_resident=True,
                                                    async_io=True)
    print(f"tuner: {LLAMA} ({llama.n_layers} layers) at the same inputs: TunedParams "
          f"{json.dumps(dataclasses.asdict(tuned_l))}; served as {TUNED} at full width, cut to "
          f"{SERVED[TUNED]['n_layers']} layers (kernel A at rank {tuned_l.rank})", flush=True)
    check(tuned_l.rank > 256, f"{LLAMA}'s tuned rank {tuned_l.rank}: kernel A's wide instance "
          "(rank > 256) would not run")
    return ecfg, ecfg_l


def moe_phase(main_path, registry, ecfg, entries, dev, card) -> dict:
    """OLMoE-1B-7B at full width on the tuned engine parameters, the
    expert-read floor of its decode step, and the paper's baselines on one
    decode step's tensors; returns the run's launches."""
    from repro_torch.models import layers as L

    t0 = time.perf_counter()
    cfg = registry.get(OLMOE)
    weights = main_path.build_weights(cfg, device=dev, rank=ecfg.rank)
    _, run = served_run(main_path, registry, OLMOE, ecfg, dev, weights=weights,
                        probe=OLMOE_PROBE)
    med = served_report(run, OLMOE, entries, card, t0)
    # the reference's dispatch runs every expert at S = 1 (capacity 1), so a
    # decode step reads every expert's weights in every layer
    moe_p = weights[1]["blocks"][0]["moe"]
    expert_bytes = cfg.n_layers * sum(moe_p[w].numel() * 4 for w in ("w_gate", "w_up", "w_down"))
    flush = torch.empty(64 << 20, dtype=torch.uint8, device=dev)
    x = torch.randn((SERVED[OLMOE]["slots"], 1, cfg.d_model), device=dev)
    layer_ms = device_ms(lambda: L.moe(moe_p, x, top_k=cfg.moe_top_k,
                                       capacity_factor=cfg.moe_capacity_factor), flush)
    print(f"{OLMOE} path: a decode step reads every expert of every layer: "
          f"{expert_bytes / 1e9:.2f} GB, floor {expert_bytes / HBM_BYTES_PER_S * 1e3:.2f} ms at "
          f"3.35 TB/s; one MoE layer at the decode shape (B {x.shape[0]}, S 1) {layer_ms:.3f} ms "
          f"on the card, x {cfg.n_layers} = {layer_ms * cfg.n_layers:.2f} ms of the {med:.1f} ms "
          f"step  [{card}]", flush=True)
    del weights, moe_p, x, flush
    probe = run["probe"]
    check(probe is not None and "q" in probe and "ids" in probe,
          f"{OLMOE} path: decode step {OLMOE_PROBE[0]} layer {OLMOE_PROBE[1]} was not probed")
    fid = main_path.probe_fidelity(probe, group_size=ecfg.group_size, n_select=ecfg.n_select,
                                   rank=ecfg.rank)
    print(f"baselines: {OLMOE} decode step {fid['step']}, layer {fid['layer']}, row "
          f"{fid['row']} ({fid['n_tokens']} tokens of context), budget {fid['budget_tokens']} "
          f"tokens (M·G); the engine's own selection: recall {fid['recall']:.4f} of the exact "
          f"top-{ecfg.n_select} groups over rows {fid['rows']}", flush=True)
    for name, r in fid["fidelity"].items():
        print(f"baselines: {name}: {json.dumps(r)}")
        # the masses are float64 sums of softmax weights: 1 + rounding at most
        check(0.0 <= r["recall"] <= 1.0 and -1e-12 <= r["mass"] <= 1.0 + 1e-12,
              f"baseline {name}: recall {r['recall']} or mass {r['mass']} outside [0, 1]")
    check(0.0 <= fid["recall"] <= 1.0, f"engine recall {fid['recall']} outside [0, 1]")
    flex = fid["fidelity"]["flexgen"]
    check(flex["recall"] == 1.0 and flex["out_err"] < 1e-6,
          f"FlexGen (every token): recall {flex['recall']}, output error {flex['out_err']}")
    sys.stdout.flush()
    return run["launches"]


def dense_phases(main_path, registry, ecfg, ecfgs, entries, dev, card) -> dict:
    """StableLM-2-12B at full width (40 layers, head_dim 160), then
    Granite-8B, Qwen3-32B and Chameleon-34B at full width cut to 2 layers,
    each on the first path's engine parameters, then Llama-3.1-8B on its
    tuned tuple (``ecfgs``) cut to 4 layers; returns each run's launches."""
    launches = {}
    for path in (STABLELM, *DENSE_2L, TUNED):
        t0 = time.perf_counter()
        cfg, run = served_run(main_path, registry, path, ecfgs.get(path, ecfg), dev)
        if SERVED[path]["n_layers"]:
            print(f"{path} path (GQA ratio {cfg.n_heads // cfg.n_kv_heads}, head_dim "
                  f"{cfg.head_dim}, qk_norm {cfg.qk_norm}, tied embeddings "
                  f"{cfg.tie_embeddings}, rope theta {cfg.rope_theta:g}; full width, depth cut "
                  f"to {run['n_layers']} of {cfg.n_layers}):", flush=True)
        served_report(run, path, entries, card, t0)
        launches[path] = run["launches"]
        del run
        free_device()
    return launches


def device_report(name: str, run, card: str, t0: float) -> None:
    walls = run["decode_step_wall_seconds"]
    print(f"{name}: {run['n_layers']} blocks, mode {run['mode']}, batch "
          f"{DEVICE_RUN['batch']}, prefill wall {run['prefill_seconds'] * 1e3:.1f} ms, decode "
          f"step median {statistics.median(walls) * 1e3:.2f} ms over {len(walls)} steps, "
          f"{run['tokens_per_s']:.1f} tokens/s over the steps, peak device memory "
          f"{run['peak_memory_bytes'] / 2**30:.2f} GiB, launches {run['launches']}, flushes "
          f"{run['flushes']}, total {time.perf_counter() - t0:.1f} s  [{card}]", flush=True)


def device_run(main_path, name, cfg, mode, params, dev, card, *, serve_cfg=None, run=None,
               expect: dict, **kw) -> dict:
    """``run_device_path`` with its checks: tokens of the run's shape, finite
    logits, the cache at prompt + new tokens, and each kernel launched
    exactly as ``expect`` says."""
    run = run or DEVICE_RUN
    t0 = time.perf_counter()
    out = main_path.run_device_path(cfg, mode, params=params, device=dev, serve_cfg=serve_cfg,
                                    **run, **kw)
    check(out["tokens"].shape == (run["batch"], run["max_new"]),
          f"{name}: tokens {out['tokens'].shape}")
    check(out["logits_finite"], f"{name}: non-finite logits")
    check(out["length"] == run["prompt_len"] + run["max_new"], f"{name}: length {out['length']}")
    for kernel, n in out["launches"].items():
        check(n == expect.get(kernel, 0),
              f"{name}: {kernel} launched {n} times, expected {expect.get(kernel, 0)}")
    device_report(name, out, card, t0)
    return out


def llama_device_phase(main_path, cfg, params, dev, card) -> dict:
    """Llama-3.1-8B at full width through the full-cache device path on the
    serving path's weights: ``full``, ``kvswap``, and ``kvswap`` with the
    rolling buffer and cross-layer prediction; returns the two kvswap runs'
    launches."""
    from repro_torch.serving.decode import KVSwapServeConfig

    scfg = KVSwapServeConfig(*DEVICE_KVSWAP)
    n_b = cfg.n_layers * DEVICE_RUN["max_new"]          # one a layer a step
    device_run(main_path, f"{LLAMA} device path", cfg, "full", params, dev, card, expect={})
    free_device()
    kv = device_run(main_path, LLAMA_DEV, cfg, "kvswap", params, dev, card, serve_cfg=scfg,
                    expect={"gather_attention": n_b})
    free_device()
    roll = device_run(main_path, LLAMA_ROLL, cfg, "kvswap", params, dev, card,
                      serve_cfg=dataclasses.replace(scfg, rolling=True, predict_from="prev"),
                      expect={"gather_attention": n_b})
    check(roll["flushes"] == DEVICE_RUN["max_new"] // scfg.rb_len,
          f"{LLAMA_ROLL}: {roll['flushes']} flushes")
    free_device()
    return {LLAMA_DEV: kv["launches"], LLAMA_ROLL: roll["launches"]}


def device_reduced(main_path, cfg, params, dev, card) -> None:
    """At 4 layers (full width): ``kvswap`` with ``n_select`` covering every
    group against ``full`` on the same forced tokens (within 1e-4 of full's
    largest |logit|), and the rolling buffer against the direct path
    (within the reference's 2e-4, of max(1, largest |logit|))."""
    from repro_torch.serving.decode import KVSwapServeConfig

    run = dict(batch=4, prompt_len=512, max_new=8, max_len=1024)
    g, _, r = DEVICE_KVSWAP
    cover = KVSwapServeConfig(g, run["max_len"] // g, r)
    full = device_run(main_path, f"{LLAMA} device path, 4 layers", cfg, "full", params, dev,
                      card, run=run, expect={}, keep_logits=True)
    kw = dict(run=run, forced=full["tokens"], keep_logits=True)
    n_b = cfg.n_layers * run["max_new"]
    kv = device_run(main_path, f"{LLAMA} device path, 4 layers, every group", cfg, "kvswap",
                    params, dev, card, serve_cfg=cover, expect={"gather_attention": n_b}, **kw)
    roll = device_run(main_path, f"{LLAMA} device path, 4 layers, every group, rolling", cfg,
                      "kvswap", params, dev, card,
                      serve_cfg=dataclasses.replace(cover, rolling=True, predict_from="prev"),
                      expect={"gather_attention": n_b}, **kw)
    big = max(float(t.abs().max()) for t in full["logits"])
    d_kv = max(float((a - b).abs().max()) for a, b in zip(kv["logits"], full["logits"]))
    d_roll = max(float((a - b).abs().max()) for a, b in zip(roll["logits"], kv["logits"]))
    print(f"4 layers, device path: kvswap selecting every group against full attention on the "
          f"same tokens: max abs logit diff {d_kv:.3g} (largest |logit| {big:.3g}); rolling "
          f"buffer against direct: {d_roll:.3g}  [{card}]", flush=True)
    check(d_kv <= 1e-4 * big, f"4 layers: kvswap over every group differs from full by {d_kv:.3g}")
    check(d_roll <= 2e-4 * max(1.0, big), f"4 layers: rolling differs from direct by {d_roll:.3g}")


def zamba_device_phase(main_path, registry, dev, card) -> dict:
    """Zamba2-1.2B at full width through the full-cache device path
    (``kvswap``): kernel C in each Mamba2 block's prefill, kernel B on the
    shared-attention blocks each step."""
    from repro_torch.serving.decode import KVSwapServeConfig

    cfg = registry.get(ZAMBA)
    params = registry.init_params(cfg, generator=torch.Generator(device=dev).manual_seed(0),
                                  device=dev)
    n_mamba, n_kv = cfg.blocks.count("mamba2"), len(cfg.kv_layers)
    run = device_run(main_path, ZAMBA_DEV, cfg, "kvswap", params, dev, card,
                     serve_cfg=KVSwapServeConfig(*DEVICE_KVSWAP),
                     expect={"ssd_chunk": n_mamba,
                             "gather_attention": n_kv * DEVICE_RUN["max_new"]})
    return run["launches"]


def whisper_phase(main_path, registry, ecfg, entries, dev, card) -> dict:
    """Whisper-large-v3 at full width (32 + 32 layers): the encoder over 4
    seeded frame sequences, ``KVSwapEngine.generate`` over 4 x 2048 decoder
    tokens (the engine's host-gather route), then the same weights through
    the full-cache device path (``kvswap``); returns both runs' launches."""
    from repro_torch.serving.decode import KVSwapServeConfig
    from repro_torch.utils import tree_count

    t0 = time.perf_counter()
    weights = main_path.whisper_weights(registry.get(WHISPER), device=dev,
                                        batch=DEVICE_RUN["batch"])
    cfg, params, enc_out, enc_s = weights
    n_params = tree_count(params)
    print(f"{WHISPER}: {cfg.enc_layers} encoder + {cfg.n_layers} decoder layers, d_model "
          f"{cfg.d_model}, {cfg.n_heads} heads = {cfg.n_kv_heads} KV heads, head_dim "
          f"{cfg.head_dim}, {n_params / 1e9:.3f} B parameters; encoder over "
          f"{DEVICE_RUN['batch']} x {cfg.enc_frames} frames {enc_s * 1e3:.1f} ms  [{card}]",
          flush=True)
    run = main_path.run_whisper_path(cfg, weights=weights, device=dev, engine_cfg=ecfg,
                                     prompt_len=DEVICE_RUN["prompt_len"],
                                     max_new=DEVICE_RUN["max_new"])
    steps = run["decode_steps"]
    check(run["tokens"].shape == (DEVICE_RUN["batch"], DEVICE_RUN["max_new"]),
          f"{WHISPER}: tokens {run['tokens'].shape}")
    check(run["logits_finite"], f"{WHISPER}: non-finite logits")
    check(run["host_gather"], f"{WHISPER}: the engine did not take its host-gather route")
    for kernel, n in run["launches"].items():
        check(n == steps * cfg.n_layers,
              f"{WHISPER}: {kernel} launched {n} times, expected {steps} steps x {cfg.n_layers}")
    walls = run["decode_step_wall_seconds"]
    med = statistics.median(walls) * 1e3
    wait_ms = statistics.median(run["decode_step_io_wait_seconds"]) * 1e3
    kern_ms = step_kernels_ms(entries, WHISPER, run["launches"], steps)
    print(f"{WHISPER} path (engine, host gather): prefill wall {run['prefill_seconds'] * 1e3:.1f}"
          f" ms; {steps} decode steps, launches {run['launches']}; decode step median "
          f"{med:.1f} ms = wait on group reads {wait_ms:.1f} ms + kernels A, B {kern_ms:.2f} ms "
          f"+ rest {med - wait_ms - kern_ms:.1f} ms; {run['tokens_per_s']:.1f} tokens/s over "
          f"generate ({run['wall_seconds']:.2f} s); peak device memory "
          f"{run['peak_memory_bytes'] / 2**30:.2f} GiB; total {time.perf_counter() - t0:.1f} s"
          f"  [{card}]", flush=True)
    launches = run["launches"]
    del run
    free_device()
    dev_run = device_run(main_path, WHISPER_DEV, cfg, "kvswap", params, dev, card,
                         serve_cfg=KVSwapServeConfig(*DEVICE_KVSWAP), enc_out=enc_out,
                         expect={"gather_attention": cfg.n_layers * DEVICE_RUN["max_new"]})
    return {WHISPER: launches, WHISPER_DEV: dev_run["launches"]}


def xlstm_phase(main_path, registry, dev, card) -> None:
    """xLSTM-1.3B at full width (48 blocks) through the full-cache device
    path: no kernel runs.  Then two of its blocks (the first mLSTM and the
    first sLSTM): prefill plus steps against the teacher-forced forward."""
    from repro_torch.models import transformer as T

    cfg = registry.get(XLSTM)
    params = registry.init_params(cfg, generator=torch.Generator(device=dev).manual_seed(0),
                                  device=dev)
    print(f"{XLSTM}: {cfg.n_layers} blocks ({cfg.blocks.count('mlstm')} mLSTM, "
          f"{cfg.blocks.count('slstm')} sLSTM), d_model {cfg.d_model}, {cfg.n_heads} heads, "
          f"{cfg.param_count() / 1e9:.3f} B parameters  [{card}]", flush=True)
    device_run(main_path, f"{XLSTM} device path", cfg, "full", params, dev, card, run=XLSTM_RUN,
               expect={})
    free_device()
    pick = [cfg.blocks.index("mlstm"), cfg.blocks.index("slstm")]
    cfg2 = dataclasses.replace(cfg, n_layers=2, block_pattern=("mlstm", "slstm"))
    params2 = {**params, "blocks": [params["blocks"][i] for i in pick]}
    run = dict(batch=4, prompt_len=256, max_new=8, max_len=256 + 8 + 4)
    out = device_run(main_path, f"{XLSTM} device path, 2 blocks", cfg2, "full", params2, dev,
                     card, run=run, expect={}, keep_logits=True)
    toks = torch.cat([torch.as_tensor(main_path.device_prompts(
        cfg.vocab_size, batch=run["batch"], prompt_len=run["prompt_len"], seed=0)),
        torch.as_tensor(out["tokens"])], 1).to(dev)
    ref = T.forward(params2, cfg2, toks)[0][:, run["prompt_len"] - 1:-1].cpu()
    got = torch.stack(out["logits"], 1)
    err = float((got - ref).abs().max())
    big = max(1.0, float(ref.abs().max()))
    print(f"{XLSTM}, 2 blocks: prefill and {run['max_new']} steps against the teacher-forced "
          f"forward: max abs logit diff {err:.3g} (largest |logit| {big:.3g})  [{card}]",
          flush=True)
    check(err <= 2e-4 * big, f"{XLSTM}, 2 blocks: steps differ from the forward by {err:.3g}")


def scale_entries(ops, select_groups, dev) -> list[dict]:
    """The kernel entries of the two paths driven last: kernel A on one
    rank's whole context at the sequence-sharded decode's shapes (world 1:
    B 1, H 32, N 524288, r 64, G 4, 500,000 valid tokens) and kernel C at
    the Zamba2 training forward's (B 2, nc 8), where ``SSDChunk``'s grads in
    all five inputs are also held to autograd of the plain version (1e-4
    of max(1, |g|max)) and its backward (the plain version's VJP) is timed
    beside the forward."""
    gen = torch.Generator(device=dev).manual_seed(6)
    flush = torch.empty(64 << 20, dtype=torch.uint8, device=dev)
    sp = SEQSHARD_SPEC
    shape = (sp["b"], sp["h"], sp["r"], sp["n"], sp["group_size"])
    valid = [SEQSHARD_CASE["length"]] * sp["b"]
    err = check_scores(ops, select_groups, dev, gen, *shape, valid, SEQSHARD_CASE["n_select"])
    out = [kernel_entry("lowrank_group_scores", SEQSHARD, err,
                        time_scores(ops, dev, gen, flush, *shape, valid))]
    args = [a.requires_grad_() for a in ssd_inputs(gen, dev, **TRAIN_SSD)]
    cot = torch.randn((*args[0].shape,), generator=gen, device=dev)
    grads = torch.autograd.grad(ops.ssd_chunk(*args), args, cot)
    plain = torch.autograd.grad(ops.ssd_chunk_plain(*args), args, cot)
    torch.cuda.synchronize()
    g_err = max(float((g - w).abs().max()) / max(1.0, float(w.abs().max()))
                for g, w in zip(grads, plain))
    check(all(bool(torch.isfinite(g).all()) for g in grads), "SSDChunk: non-finite grads")
    check(g_err <= SSD_TOL, f"SSDChunk grads at {TRAIN}'s shapes: err {g_err:.3g} of max(1, "
                            f"|g|max) > {SSD_TOL}")
    y = ops.ssd_chunk(*args)
    bwd_ms = device_ms(lambda: torch.autograd.grad(y, args, cot, retain_graph=True), flush)
    print(f"kernel ssd_chunk at {TRAIN}'s shapes {TRAIN_SSD}: SSDChunk's grads against autograd "
          f"of the plain version: largest err {g_err:.3g} of max(1, |g|max); its backward (the "
          f"plain version's VJP) {bwd_ms * 1e3:.2f} us", flush=True)
    del grads, plain, y, args
    with torch.no_grad():
        err_c = check_ssd(ops, dev, gen, TRAIN_SSD)
        timed = time_ssd(ops, dev, gen, flush, TRAIN_SSD)
    out.append(kernel_entry("ssd_chunk", TRAIN, err_c, {**timed, "backward_ms": bwd_ms}))
    return out


def seqshard_phase(dev, card) -> dict:
    """The sequence-sharded decode attention (``serving/distributed.py``) at
    the reference's long_500k shape: at world 1 over NCCL in this process
    and at world 4 over gloo in four spawned processes on this one card,
    each rank making only its own blocks of the context; each output
    against the port's ``reference_decode_attn`` on the card with the same
    number of shards; then Llama-3.1-8B's params at full width, cut to 2
    layers, distributed over a 1x1 NCCL mesh, ``forward`` on the DTensors
    against the plain ``forward``.  Returns kernel A's launches at world 1."""
    import torch.distributed as dist
    from torch.distributed.tensor.experimental import implicit_replication

    from repro_torch.configs import registry
    from repro_torch.launch.mesh import make_mesh_auto
    from repro_torch.models import transformer as T
    from repro_torch.seqshard_path import (SeqShardSpec, kv_blocks, replicated_inputs, run_rank,
                                           spawn_ranks)
    from repro_torch.serving.distributed import reference_decode_attn
    from repro_torch.sharding import distribute_params, param_pspecs

    spec, case = SeqShardSpec(**SEQSHARD_SPEC), SEQSHARD_CASE
    workdir = ROOT / "build" / "seqshard"
    workdir.mkdir(parents=True, exist_ok=True)
    store = workdir / "pg_world1"
    store.unlink(missing_ok=True)
    n_blocks = spec.n // spec.block
    rep = replicated_inputs(spec, dev)
    k_lr, k, v = kv_blocks(spec, 0, n_blocks, rep["a"])
    args = (rep["q"], rep["q_lr"], k_lr, k, v, rep["k_new"], rep["v_new"], case["length"])
    want = {w: reference_decode_attn(*args, group_size=spec.group_size,
                                     n_select=case["n_select"], n_shards=w) for w in (1, 4)}
    del k_lr, k, v, args
    free_device()

    def report(world, results, backend):
        outs = [r["out"] for r in results]
        ref = want[world].cpu()
        err = float((outs[0] - ref).abs().max())
        big = max(1.0, float(ref.abs().max()))
        steps = [statistics.median(r["step_ms"]) for r in results]
        ranks_ms = ", ".join(f"{t:.3f}" for t in steps)
        score_us = ", ".join(f"{r['score_ms'] * 1e3:.2f}" for r in results)
        combine_ms = ", ".join(f"{r['combine_ms']:.3f}" for r in results)
        bound_us = ", ".join(f"{spec.b * r['valid'] * spec.r * 4 / HBM_BYTES_PER_S * 1e6:.2f}"
                             for r in results)
        print(f"{SEQSHARD}, world {world} ({backend}): N {spec.n}, length {case['length']}, "
              f"M {case['n_select']} (a quota of {max(1, case['n_select'] // world)} a shard): "
              f"max abs diff to reference_decode_attn(n_shards={world}) {err:.3g} (largest |o| "
              f"{big:.3g}); step median {max(steps):.3f} ms over {SEQSHARD_REPS} calls (the "
              f"slowest rank's; ranks {ranks_ms}); kernel A alone a shard (one rank at a "
              f"time) {score_us} us against bounds of {bound_us} us (the shard's valid tokens x "
              f"r x 4 B over 3.35 TB/s); combine {combine_ms} "
              f"ms, {results[0]['combine_bytes']} B into the all_reduces a rank; launches "
              f"{[r['launches'] for r in results]}; selections flipped against the plain "
              f"scores {sum(len(r['flips']) for r in results)}  [{card}]", flush=True)
        check(all(torch.equal(o, outs[0]) for o in outs), f"{SEQSHARD} world {world}: ranks "
              f"end with different outputs")
        check(bool(torch.isfinite(outs[0]).all()), f"{SEQSHARD} world {world}: non-finite output")
        check(err <= ATTN_TOL * big, f"{SEQSHARD} world {world}: output differs from the oracle "
                                     f"by {err:.3g}")
        check(all(r["launches"] == 1 + SEQSHARD_REPS for r in results),
              f"{SEQSHARD} world {world}: kernel A launched {[r['launches'] for r in results]} "
              f"times, expected once a rank a call ({1 + SEQSHARD_REPS})")
        for rank, r in enumerate(results):
            for f in r["flips"]:
                print(f"  flip on rank {rank}, row {f['row']}: kernel only {f['kernel_only']}, "
                      f"plain only {f['plain_only']}, score gap {f['gap']:.3g} of the row's "
                      f"score scale", flush=True)
            check(all(f["gap"] <= SCORE_RTOL for f in r["flips"]),
                  f"{SEQSHARD} world {world}: a flipped selection beyond kernel A's tolerance")

    dist.init_process_group("nccl", init_method=f"file://{store}", rank=0, world_size=1)
    try:
        mesh = make_mesh_auto((1,), ("data",))
        [res1] = run_rank(spec, mesh, [case], device=dev, reps=SEQSHARD_REPS)
        free_device()
        report(1, [res1], "nccl")
        t0 = time.perf_counter()
        res4 = spawn_ranks(spec, [case], world=4, workdir=workdir, backend="gloo",
                           device="cuda", reps=SEQSHARD_REPS, timeout=600)
        report(4, [r[0] for r in res4], "gloo, 4 processes sharing this one card: their times "
               f"are not a cluster's; {time.perf_counter() - t0:.1f} s with start-up")

        cfg = dataclasses.replace(registry.get(LLAMA), n_layers=2)
        params = registry.init_params(cfg, generator=torch.Generator(device=dev).manual_seed(0),
                                      device=dev)
        toks = torch.randint(0, cfg.vocab_size, (2, 256), device=dev,
                             generator=torch.Generator(device=dev).manual_seed(1))
        with torch.no_grad():
            ref, _ = T.forward(params, cfg, toks)
            mesh2 = make_mesh_auto((1, 1), ("data", "model"))
            dparams = distribute_params(params, mesh2, param_pspecs(params, mesh2))
            with implicit_replication():
                got = T.forward(dparams, cfg, toks)[0].full_tensor()
        err = float((got - ref).abs().max())
        big = max(1.0, float(ref.abs().max()))
        print(f"{LLAMA} at full width, 2 layers, params distributed over a 1x1 NCCL mesh: "
              f"forward on DTensors against the plain forward: max abs logit diff {err:.3g} "
              f"(largest |logit| {big:.3g}), bit-equal {torch.equal(got, ref)}  [{card}]",
              flush=True)
        check(err <= 1e-6 * big, f"forward on DTensor params differs by {err:.3g}")
        del params, dparams, got, ref
    finally:
        dist.destroy_process_group()
    return {"lowrank_group_scores": res1["launches"]}


def train_phase(dev, card) -> dict:
    """Zamba2-1.2B at full width and depth trained through the port's train
    step (kernel C in every Mamba2 block's forward, ``SSDChunk``'s plain VJP
    backward), then the step's variants held to each other at Llama-3.1-8B
    width cut to 2 layers; returns kernel C's launches in the first run."""
    from repro_torch.configs import registry
    from repro_torch.train_path import run_train_checks, run_train_path

    cfg = registry.get(ZAMBA)
    n_mamba = cfg.blocks.count("mamba2")
    t0 = time.perf_counter()
    run = run_train_path(cfg, device=dev, **TRAIN_RUN)
    walls = run["step_wall_seconds"]
    losses, remat = run["losses"], run["remat_losses"]
    med = statistics.median(walls)
    print(f"{TRAIN}: {cfg.n_layers} blocks ({n_mamba} Mamba2, {cfg.blocks.count('shared_attn')} "
          f"shared attention), {run['n_params'] / 1e9:.3f} B parameters, fp32, B "
          f"{TRAIN_RUN['batch']} x S {TRAIN_RUN['seq_len']}: {TRAIN_RUN['fixed_steps']} steps on "
          f"one batch, losses {', '.join(f'{x:.4f}' for x in losses)}; step median "
          f"{med * 1e3:.1f} ms ({', '.join(f'{w * 1e3:.1f}' for w in walls)}), "
          f"{run['tokens'] / med:.0f} tokens/s, peak device memory "
          f"{run['peak_memory_bytes'] / 2**30:.2f} GiB; one forward {run['forward_seconds'] * 1e3:.1f}"
          f" ms, its backward {run['backward_seconds'] * 1e3:.1f} ms; train_loop with remat, "
          f"{TRAIN_RUN['loop_steps']} steps: losses {', '.join(f'{x:.4f}' for x in remat)}, "
          f"{run['remat_seconds']:.2f} s; kernel C launches {run['launches']} and "
          f"{run['remat_launches']} (steps x {n_mamba} Mamba2 blocks x (1 + remat)); total "
          f"{time.perf_counter() - t0:.1f} s  [{card}]", flush=True)
    check(all(math.isfinite(x) for x in losses + remat), f"{TRAIN}: a loss is not finite")
    check(losses[-1] < losses[0], f"{TRAIN}: the loss did not fall over one batch ({losses})")
    # launches = steps x Mamba2 blocks x (1 + remat): one a block a forward,
    # and again in each block's recompute during a checkpointed backward
    check(run["launches"] == TRAIN_RUN["fixed_steps"] * n_mamba,
          f"{TRAIN}: kernel C launched {run['launches']} times, expected "
          f"{TRAIN_RUN['fixed_steps']} x {n_mamba}")
    check(run["remat_launches"] == TRAIN_RUN["loop_steps"] * n_mamba * 2,
          f"{TRAIN}: kernel C launched {run['remat_launches']} times with remat, expected "
          f"{TRAIN_RUN['loop_steps']} x {n_mamba} x 2")
    free_device()

    cfg2 = dataclasses.replace(registry.get(LLAMA), n_layers=2)
    t0 = time.perf_counter()
    chk = run_train_checks(cfg2, device=dev, batch=2, seq_len=512, workdir=ROOT / "build")
    (l1, l2), (r0, r1) = chk["accum_loss"], chk["remat_loss"]
    print(f"{LLAMA} at full width, 2 layers, B 2 x S 512: accum_steps 2 against 1: losses {l1:.6f}"
          f" / {l2:.6f}, params after the step differ by {chk['accum_param_diff']:.3g}, first "
          f"moments by {chk['accum_mu_diff']:.3g} (largest {chk['mu_max']:.3g}); remat against "
          f"none: losses {r0:.6f} / {r1:.6f}, grads differ by {chk['remat_grad_diff']:.3g} "
          f"(largest |g| {chk['grad_max']:.3g}), bit-equal {chk['remat_bit_equal']}; checkpoint "
          f"round trip of {chk['checkpoint_bytes'] / 2**30:.2f} GiB in "
          f"{chk['checkpoint_seconds']:.1f} s, bit-equal {chk['checkpoint_bit_equal']}; total "
          f"{time.perf_counter() - t0:.1f} s  [{card}]", flush=True)
    check(abs(l1 - l2) <= 1e-5 * abs(l1), f"accum_steps 2 changes the loss: {l1} against {l2}")
    check(chk["accum_param_diff"] <= 2e-6, f"accum_steps 2 changes the params by "
                                           f"{chk['accum_param_diff']:.3g}")
    check(chk["accum_mu_diff"] <= 1e-5 * chk["mu_max"], "accum_steps 2 changes the grads by "
                                                         f"{chk['accum_mu_diff']:.3g}")
    check(abs(r0 - r1) <= 1e-6 * abs(r0), f"remat changes the loss: {r0} against {r1}")
    check(chk["remat_grad_diff"] <= 1e-6 * max(1.0, chk["grad_max"]),
          f"remat changes the grads by {chk['remat_grad_diff']:.3g}")
    check(chk["checkpoint_bit_equal"], "save_pytree -> load_pytree changed bits")
    return {"ssd_chunk": run["launches"]}


def main() -> None:
    import argparse

    ap = argparse.ArgumentParser(description="smoke run of the port on one CUDA card")
    ap.add_argument("--parent", type=Path, default=None,
                    help="a checkout of another tree: its kernels A, B and C and its MoE "
                         "layer are timed in turns with this tree's")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this smoke run needs a CUDA card")
    sys.path.insert(0, str(ROOT / "src"))
    try:
        from repro_torch.configs import llama3_8b, registry, zamba2_1p2b
        from repro_torch.core.engine import EngineConfig
        from repro_torch.core.predictor import select_groups
        from repro_torch.kernels import _build, ops
        from repro_torch import main_path
        from repro_torch.main_path import (build_weights, compare_routes, run_disagg_path,
                                           run_hybrid_path, run_main_path, run_prefix_path,
                                           run_router_path)
    except ImportError as exc:
        fail(f"the port is not next to this script ({exc})")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True).stdout.strip().splitlines()[0]
    print(card, flush=True)
    dev = torch.device("cuda")
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"python {sys.version.split()[0]}", flush=True)

    t0 = time.perf_counter()
    built = _build.build()
    per_source = ", ".join(f"{k} {v['seconds']:.2f} s" for k, v in built.items())
    print(f"build: {time.perf_counter() - t0:.2f} s ({per_source})", flush=True)
    for name, rep in built.items():
        for line in ptxas_lines(rep["log"]):
            print(f"  ptxas {name}: {line}")
    occ = ops.ssd_chunk_occupancy(64)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    blocks = 4 * 16 * -(-64 // occ["heads_per_block"])
    print(f"kernel ssd_chunk at {ZAMBA}'s shapes (B*nc = 64, H = 64, P = 64): "
          f"{occ['smem_bytes']} B dynamic shared memory a block, {occ['blocks_per_sm']} blocks "
          f"an SM, {blocks} blocks of {occ['heads_per_block']} heads = "
          f"{blocks / (sms * occ['blocks_per_sm']):.2f} waves on {sms} SMs", flush=True)

    entries = kernel_checks(ops, select_groups, dev)
    ecfg = EngineConfig(group_size=4, n_select=100, rank=64, reuse_capacity=160,
                        max_seq=4096, disk="nvme", device_resident=True, async_io=True)
    olmoe_ecfg, tuned_ecfg = tuner_phase(main_path, registry, card)
    entries += served_entries(main_path, registry, {OLMOE: olmoe_ecfg, TUNED: tuned_ecfg,
                                                    **dict.fromkeys((STABLELM, *DENSE_2L), ecfg)},
                              ops, select_groups, dev)
    entries += device_entries(main_path, registry, ecfg, ops, select_groups, dev)
    entries += scale_entries(ops, select_groups, dev)
    flush = torch.empty(64 << 20, dtype=torch.uint8, device=dev)
    tiny = torch.empty(1, device=dev)
    print(f"timing floor: one launch of a one-element fill {device_ms(tiny.zero_, flush) * 1e3:.2f}"
          f" us (the events and launch around every time below)  [{card}]")
    del flush
    for e in entries:
        print_entry(e, card)
    wide_attention(ops, dev, card)
    if args.parent is not None:
        against_parent(ops, args.parent.resolve(), dev, card)
    route_phase(compare_routes, dev, card)
    free_device()

    cfg = llama3_8b.config()
    t0 = time.perf_counter()
    weights = build_weights(cfg, device=dev, rank=ecfg.rank)
    main_run = run_main_path(cfg, device=dev, engine_cfg=ecfg, weights=weights)
    n_layers = main_run["n_layers"]
    check(n_layers == 32, f"main path ran {n_layers} layers")
    check(all(len(o) == 32 for o in main_run["outputs"]) and len(main_run["outputs"]) == 6,
          f"not every request completed with 32 tokens: {[len(o) for o in main_run['outputs']]}")
    check(main_run["logits_finite"], "non-finite logits on the main path")
    for name, n in main_run["launches"].items():
        check(n == main_run["decode_steps"] * n_layers,
              f"{name} launched {n} times, expected {main_run['decode_steps']} steps x {n_layers}")
    steps = main_run["decode_step_wall_seconds"]
    print(f"main path: llama3-8b, {n_layers} layers, 6 requests "
          f"(prompts {main_run['prompt_lens']}), {main_run['decode_steps']} decode steps, "
          f"launches {main_run['launches']}, total {time.perf_counter() - t0:.1f} s  [{card}]")
    print(f"main path: decode step wall median {statistics.median(steps) * 1e3:.1f} ms, "
          f"mean {statistics.fmean(steps) * 1e3:.1f} ms over {len(steps)} steps without "
          f"admissions; {main_run['tokens_per_s']:.1f} tokens/s over the drain "
          f"({main_run['wall_seconds']:.1f} s, prefills included); peak device memory "
          f"{main_run['peak_memory_bytes'] / 2**30:.2f} GiB  [{card}]", flush=True)
    launches = main_run["launches"]
    # where a decode step's wall time goes: blocked on group reads (measured
    # by the engine), the two kernels (launches per step x their timed ms),
    # and the rest (host work and the other device operations)
    wait_ms = statistics.median(main_run["decode_step_io_wait_seconds"]) * 1e3
    kern_ms = step_kernels_ms(entries, LLAMA, launches, main_run["decode_steps"])
    print(f"main path: decode step median {statistics.median(steps) * 1e3:.1f} ms = "
          f"wait on group reads {wait_ms:.1f} ms + kernels {kern_ms:.2f} ms + rest "
          f"{statistics.median(steps) * 1e3 - wait_ms - kern_ms:.1f} ms  [{card}]", flush=True)
    del main_run
    prefix_launches = prefix_phases(run_prefix_path, cfg, ecfg, weights, dev, card)
    free_device()
    router_launches = router_phase(run_router_path, cfg, ecfg, weights, dev, card)
    free_device()
    disagg_launches = disagg_phase(run_disagg_path, cfg, ecfg, weights, dev, card)
    free_device()
    device_launches = llama_device_phase(main_path, cfg, weights[1], dev, card)
    del weights
    free_device()

    weights4 = reduced_phases(run_main_path, run_prefix_path, build_weights, cfg, ecfg, dev)
    free_device()
    front_half_reduced(main_path, cfg, ecfg, weights4, dev, card)
    device_reduced(main_path, dataclasses.replace(cfg, n_layers=4), weights4[1], dev, card)
    del weights4
    free_device()

    path_launches = {LLAMA: launches, PREFIX: prefix_launches, ROUTER: router_launches,
                     DISAGG: disagg_launches, **device_launches,
                     ZAMBA: hybrid_phases(run_hybrid_path, zamba2_1p2b.config(), ecfg, dev,
                                          entries, card)}
    free_device()
    path_launches[ZAMBA_DEV] = zamba_device_phase(main_path, registry, dev, card)
    free_device()
    path_launches[OLMOE] = moe_phase(main_path, registry, olmoe_ecfg, entries, dev, card)
    free_device()
    path_launches.update(dense_phases(main_path, registry, ecfg, {TUNED: tuned_ecfg}, entries,
                                      dev, card))
    free_device()
    path_launches.update(whisper_phase(main_path, registry, ecfg, entries, dev, card))
    free_device()
    xlstm_phase(main_path, registry, dev, card)
    free_device()
    path_launches[SEQSHARD] = seqshard_phase(dev, card)
    free_device()
    path_launches[TRAIN] = train_phase(dev, card)
    free_device()
    for e in entries:
        e["launches"] = path_launches[e["path"]][e["name"]]
        check(e["launches"] > 0, f"{e['name']} was never launched on the {e['path']} path")
    print(json.dumps({"kernels": [{key: e[key] for key in (
        "name", "path", "route", "source", "replaces", "launches", "max_abs_err", "ms",
        "plain_ms", "bound_ms", "bound_by", "library_ms")} for e in entries]}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
