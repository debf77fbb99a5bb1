#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

1. prints the card's name and power limit, builds every CUDA kernel from
   ``src/repro_torch/kernels/csrc/`` with nvcc for sm_90a (build seconds
   and, per compiled kernel, ptxas's registers, static shared memory,
   stack and spills), and kernel C's dynamic shared memory, blocks per SM
   and waves at the Zamba2 path's shapes;
2. holds each kernel against its plain PyTorch version on the card, at
   each main path's shapes and at ragged and edge shapes (kernel C also
   bitwise equal over 5 repeated calls), and times the kernel, the plain
   version and (where one exists) one library call with CUDA events at
   each path's shapes, and the kernel alone with ``torch.profiler``;
   prints the events' floor (one launch of a trivial fill); checks and
   times kernel B past head_dim 128 (stablelm-12b's d = 160, and d = 256)
   and prints its blocks per SM at each width; with ``--parent DIR`` (a
   checkout of another tree) builds that tree's kernel B and times both in
   turns at the serving and hybrid paths' shapes; runs the tiny engine on
   the card and on the CPU and compares every group selection and token
   (the flipped selections, each with its score gaps);
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
8. prints the ``{"kernels": [...]}`` line, one entry per kernel and main
   path that runs it (``path``): its time, bound, plain and library times
   at that path's shapes, and ``launches`` in that path's main run, counted
   from 0 just before it; then, last, the ``{"ok": true, ...}`` line.

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
# stablelm-12b's attention (configs/stablelm_12b.py): kernel B at head_dim 160
STABLELM_ATTN = (4, 32, 8, 160, 405)
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
            # template arguments: an int, then (kernel B) whether it is the wide one
            name = re.search(r"([a-z_]+_kernel)(?:ILi(\d+)E(?:Lb([01])E)?)?", entry.group(1))
            args = [] if not name else [a for a in name.group(2, 3) if a is not None]
            if len(args) == 2:
                args[1] = "wide" if args[1] == "1" else "narrow"
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


def kernel_checks(ops, select_groups, dev) -> list[dict]:
    """The three kernels against their plain versions at each main path's
    shapes and at ragged shapes, then timed at each path's shapes: one
    entry per (kernel, path).  An entry's ``max_abs_err`` is the largest
    over its path's shapes and the kernel's ragged shapes."""
    gen = torch.Generator(device=dev).manual_seed(1)
    flush = torch.empty(64 << 20, dtype=torch.uint8, device=dev)   # > 50 MB L2
    entries = []

    def entry(name, path, err, timed):
        entries.append({"name": name, "path": path, "route": "cuda",
                        "source": f"src/repro_torch/kernels/csrc/{SOURCES[name][0]}",
                        "replaces": SOURCES[name][1], "max_abs_err": err, **timed})

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
                      ((2, 8, 64, 130, 4), [5000, 131])]:        # valid_len > N
        err_a = max(err_a, check_scores(ops, select_groups, dev, gen, *shape, vl, 6))
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
    path = dict(b=4, nc=16, q=128, h=64, p=64, n=64)
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
    del first
    bc, q, h, p, n = path["b"] * path["nc"], path["q"], path["h"], path["p"], path["n"]
    tri = q * (q + 1) // 2                    # (i, j) pairs on and below the diagonal
    bound_c, by_c = bound_ms(4 * sum(a.numel() for a in args) + 4 * bc * q * h * p,
                             bc * tri * (2 * n + 3 * h + 2 * h * p))
    entry("ssd_chunk", ZAMBA, err_c,
          {"ms": device_ms(lambda: ops.ssd_chunk(*args), flush),
           "device_ms": profiled_ms(lambda: ops.ssd_chunk(*args), flush, "ssd_chunk_kernel"),
           "plain_ms": device_ms(lambda: ops.ssd_chunk_plain(*args), flush),
           "bound_ms": bound_c, "bound_by": by_c, "library_ms": None})
    return entries


def attention_inputs(dev, gen, b, h, hk, d, s):
    q = torch.randn((b, h, d), generator=gen, device=dev)
    k = torch.randn((b, s, hk, d), generator=gen, device=dev)
    v = torch.randn((b, s, hk, d), generator=gen, device=dev)
    mask = torch.rand((b, s), generator=gen, device=dev) > 0.2
    mask[:, -1] = True
    return q, k, v, mask


def wide_attention(ops, dev, card) -> None:
    """Kernel B past head_dim 128: held against its plain version at
    stablelm-12b's attention shape (and S = 1) and at d = 256, timed at
    stablelm-12b's shape; its blocks per SM at each path's (rep, d)."""
    gen = torch.Generator(device=dev).manual_seed(2)
    flush = torch.empty(64 << 20, dtype=torch.uint8, device=dev)
    b, h, hk, d, s = STABLELM_ATTN
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
    t = time_attention(ops, dev, gen, flush, b, h, hk, d, s, mask)
    print(f"kernel gather_attention at stablelm-12b's attention shape (B {b}, H {h}, H_kv {hk}, "
          f"d {d}, S {s}): {t['ms'] * 1e3:.2f} us (kernel alone {t['device_ms'] * 1e3:.2f} us), "
          f"plain {t['plain_ms'] * 1e3:.2f} us, bound {t['bound_ms'] * 1e3:.2f} us "
          f"({t['bound_by']}), library {t['library_ms'] * 1e3:.2f} us, max abs err {err:.3g} "
          f"(d 160 and 256, S 1-405, masked splits and rows)  [{card}]")
    occ = {(rep, dd): ops.gather_attention_occupancy(rep, dd)
           for rep, dd in ((4, 128), (1, 64), (4, 160), (8, 256))}
    print("kernel gather_attention blocks per SM (dynamic shared memory a block): " + "; ".join(
        f"rep {rep}, d {dd}: {o['blocks_per_sm']} ({o['smem_bytes']} B)"
        for (rep, dd), o in occ.items()), flush=True)


def parent_attention(parent: Path, dev):
    """Kernel B as the tree at ``parent`` builds it (the same nvcc flags), as
    a callable of ``(q, k, v, mask)``; the C entry point is the same."""
    import ctypes

    from repro_torch.kernels import _build

    src = parent / "src" / "repro_torch" / "kernels" / "csrc" / "gather_attention.cu"
    lib = ROOT / "build" / "parent_kernels" / "libgather_attention.so"
    lib.parent.mkdir(parents=True, exist_ok=True)
    out = subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(lib), str(src)],
                         capture_output=True, text=True)
    check(out.returncode == 0, f"the parent's kernel B did not build:\n{out.stdout}{out.stderr}")
    for line in ptxas_lines(out.stdout + out.stderr):
        print(f"  ptxas parent gather_attention: {line}")
    fn = ctypes.CDLL(str(lib)).gather_attention_f32
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


def against_parent(ops, parent: Path, dev, card) -> None:
    """Kernel B of this tree and of the parent's, timed in turns (parent,
    this, this, parent) at the serving and hybrid paths' shapes, on the same
    inputs; the two agree in their bits at d <= 128."""
    old = parent_attention(parent, dev)
    gen = torch.Generator(device=dev).manual_seed(3)
    flush = torch.empty(64 << 20, dtype=torch.uint8, device=dev)
    for path, shape in ((LLAMA, (4, 32, 8, 128, 405)), (ZAMBA, (4, 32, 32, 64, 405))):
        q, k, v, mask = attention_inputs(dev, gen, *shape)
        check(torch.equal(old(q, k, v, mask), ops.gather_attention(q, k, v, mask)),
              f"kernel B at {path}'s shapes differs in its bits from the parent's")
        turns = [device_ms(functools.partial(fn, q, k, v, mask), flush)
                 for fn in (old, ops.gather_attention, ops.gather_attention, old)]
        print(f"kernel gather_attention at {path}'s shapes against the parent tree, in turns "
              f"(parent, this, this, parent): {', '.join(f'{t * 1e3:.2f}' for t in turns)} us; "
              f"bit-equal outputs  [{card}]", flush=True)


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


def main() -> None:
    import argparse

    ap = argparse.ArgumentParser(description="smoke run of the port on one CUDA card")
    ap.add_argument("--parent", type=Path, default=None,
                    help="a checkout of another tree: its kernel B is built and timed in "
                         "turns with this tree's")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this smoke run needs a CUDA card")
    sys.path.insert(0, str(ROOT / "src"))
    try:
        from repro_torch.configs import llama3_8b, zamba2_1p2b
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
    flush = torch.empty(64 << 20, dtype=torch.uint8, device=dev)
    tiny = torch.empty(1, device=dev)
    print(f"timing floor: one launch of a one-element fill {device_ms(tiny.zero_, flush) * 1e3:.2f}"
          f" us (the events and launch around every time below)  [{card}]")
    del flush
    for e in entries:
        lib = "-" if e["library_ms"] is None else f"{e['library_ms'] * 1e3:.2f} us"
        dev_t = "-" if e["device_ms"] is None else f"{e['device_ms'] * 1e3:.2f} us"
        print(f"kernel {e['name']} at {e['path']}'s shapes: {e['ms'] * 1e3:.2f} us (kernel alone "
              f"{dev_t}, profiler), plain {e['plain_ms'] * 1e3:.2f} us, bound "
              f"{e['bound_ms'] * 1e3:.2f} us ({e['bound_by']}), library {lib}, max abs err "
              f"{e['max_abs_err']:.3g}  [{card}]", flush=True)
    wide_attention(ops, dev, card)
    if args.parent is not None:
        against_parent(ops, args.parent.resolve(), dev, card)
    route_phase(compare_routes, dev, card)
    free_device()

    cfg = llama3_8b.config()
    ecfg = EngineConfig(group_size=4, n_select=100, rank=64, reuse_capacity=160,
                        max_seq=4096, disk="nvme", device_resident=True, async_io=True)
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
    del weights
    free_device()

    weights4 = reduced_phases(run_main_path, run_prefix_path, build_weights, cfg, ecfg, dev)
    free_device()
    front_half_reduced(main_path, cfg, ecfg, weights4, dev, card)
    del weights4
    free_device()

    path_launches = {LLAMA: launches, PREFIX: prefix_launches, ROUTER: router_launches,
                     DISAGG: disagg_launches,
                     ZAMBA: hybrid_phases(run_hybrid_path, zamba2_1p2b.config(), ecfg, dev,
                                          entries, card)}
    for e in entries:
        e["launches"] = path_launches[e["path"]][e["name"]]
    print(json.dumps({"kernels": [{key: e[key] for key in (
        "name", "path", "route", "source", "replaces", "launches", "max_abs_err", "ms",
        "plain_ms", "bound_ms", "bound_by", "library_ms")} for e in entries]}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
