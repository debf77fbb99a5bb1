#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

1. prints the card's name and power limit, builds every CUDA kernel from
   ``src/repro_torch/kernels/csrc/`` with nvcc for sm_90a (build seconds
   and the compiler's register/shared-memory report);
2. holds each kernel against its plain PyTorch version on the card, at the
   main path's shapes and at ragged shapes, and times the kernel, the plain
   version and (where one exists) one library call with CUDA events;
3. drives the main path: a ``ServeSession`` at Llama-3.1-8B width (all 32
   layers, fp32 random weights from seed 0) answering 6 greedy requests of
   1024-2048 prompt tokens and 32 new tokens each over 4 slots, and checks
   that every request completes, the logits stay finite, and each kernel was
   launched once per layer per decode step; then serves the same requests
   at 4 layers with ``async_io`` on and off and requires bit-identical
   tokens;
4. prints the ``{"kernels": [...]}`` line, then, last, the ``{"ok": true, ...}``
   line.

Any failed phase exits nonzero without the last line.  Imports no JAX and
nothing of the JAX package ``repro``.  Needs one CUDA card.
"""

from __future__ import annotations

import dataclasses
import json
import math
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
    return err


def kernel_checks(ops, select_groups, dev) -> list[dict]:
    """Both kernels against their plain versions (main-path and ragged
    shapes), then timed at the main path's shapes."""
    import torch.nn.functional as F

    gen = torch.Generator(device=dev).manual_seed(1)
    flush = torch.empty(64 << 20, dtype=torch.uint8, device=dev)   # > 50 MB L2

    # kernel A: main path B=4, H=32, r=64, N=4096 (k_lr capacity), G=4, M=100
    b, h, r, n, g = 4, 32, 64, 4096, 4
    valid = [1024, 1536, 2048, 1200]
    err_a = check_scores(ops, select_groups, dev, gen, b, h, r, n, g, valid, 100)
    for shape, vl in [((3, 16, 64, 1000, 4), [1000, 0, 100]),   # ragged N, empty row, masked tiles
                      ((2, 8, 32, 130, 8), [130, 7]),            # ragged last group
                      ((1, 4, 16, 64, 4), [64])]:
        err_a = max(err_a, check_scores(ops, select_groups, dev, gen, *shape, vl, 6))
    q = torch.randn((b, h, r), generator=gen, device=dev)
    k = torch.randn((b, n, r), generator=gen, device=dev)
    vl = torch.tensor(valid, dtype=torch.int32, device=dev)
    ms_a = device_ms(lambda: ops.lowrank_group_scores(q, k, vl, group_size=g), flush)
    plain_a = device_ms(lambda: ops.lowrank_group_scores_plain(q, k, vl, group_size=g), flush)
    n_valid = sum(valid)
    bound_a, by_a = bound_ms(4 * (b * h * r + n_valid * r + b + b * n // g),
                             2 * n_valid * r + b * h * r)

    # kernel B: main path H=32, H_kv=8, d=128, S = M*G + G + 1 = 405
    b, h, hk, d, s = 4, 32, 8, 128, 405
    mask = torch.rand((b, s), generator=gen, device=dev) > 0.2
    mask[:, -1] = True                                       # the token itself
    err_b = check_attention(ops, dev, gen, b, h, hk, d, s, mask)
    for shape in [(2, 8, 2, 64, 37), (3, 16, 8, 128, 301), (1, 4, 4, 32, 1)]:
        bb, _, _, _, ss = shape
        m2 = torch.rand((bb, ss), generator=gen, device=dev) > 0.3
        m2[0, :min(ss, 64)] = False          # a fully masked tile (row 0 of S=1: fully masked)
        err_b = max(err_b, check_attention(ops, dev, gen, *shape, m2))
    q = torch.randn((b, h, d), generator=gen, device=dev)
    kk = torch.randn((b, s, hk, d), generator=gen, device=dev)
    vv = torch.randn((b, s, hk, d), generator=gen, device=dev)
    ms_b = device_ms(lambda: ops.gather_attention(q, kk, vv, mask), flush)
    plain_b = device_ms(lambda: ops.gather_attention_plain(q, kk, vv, mask), flush)
    q4, k4, v4 = q[:, :, None], kk.transpose(1, 2), vv.transpose(1, 2)
    m4 = mask[:, None, None, :]
    lib_b = device_ms(lambda: F.scaled_dot_product_attention(
        q4, k4, v4, attn_mask=m4, enable_gqa=True), flush)
    n_tok = int(mask.sum())
    bound_b, by_b = bound_ms(4 * (2 * b * h * d + 2 * n_tok * hk * d) + b * s,
                             4 * n_tok * h * d)
    return [
        {"name": "lowrank_group_scores", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/lowrank_score.cu",
         "replaces": "src/repro/kernels/lowrank_score.py:23",
         "max_abs_err": err_a, "ms": ms_a, "plain_ms": plain_a,
         "bound_ms": bound_a, "bound_by": by_a, "library_ms": None},
        {"name": "gather_attention", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/gather_attention.cu",
         "replaces": "src/repro/kernels/gather_attention.py:28",
         "max_abs_err": err_b, "ms": ms_b, "plain_ms": plain_b,
         "bound_ms": bound_b, "bound_by": by_b, "library_ms": lib_b},
    ]


def main() -> None:
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this smoke run needs a CUDA card")
    sys.path.insert(0, str(ROOT / "src"))
    try:
        from repro_torch.configs import llama3_8b
        from repro_torch.core.engine import EngineConfig
        from repro_torch.core.predictor import select_groups
        from repro_torch.kernels import _build, ops
        from repro_torch.main_path import run_main_path
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
        for line in rep["log"].splitlines():
            if "registers" in line or "spill" in line or "smem" in line:
                print(f"  ptxas {name}: {line.strip()}")

    kernels = kernel_checks(ops, select_groups, dev)
    for kr in kernels:
        lib = "-" if kr["library_ms"] is None else f"{kr['library_ms'] * 1e3:.2f} us"
        print(f"kernel {kr['name']}: {kr['ms'] * 1e3:.2f} us, plain {kr['plain_ms'] * 1e3:.2f} us, "
              f"bound {kr['bound_ms'] * 1e3:.2f} us ({kr['bound_by']}), library {lib}, "
              f"max abs err {kr['max_abs_err']:.3g}  [{card}]", flush=True)

    cfg = llama3_8b.config()
    ecfg = EngineConfig(group_size=4, n_select=100, rank=64, reuse_capacity=160,
                        max_seq=4096, disk="nvme", device_resident=True, async_io=True)
    t0 = time.perf_counter()
    main_run = run_main_path(cfg, device=dev, engine_cfg=ecfg)
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
    kern_ms = sum(kr["ms"] * launches[kr["name"]] for kr in kernels) / main_run["decode_steps"]
    print(f"main path: decode step median {statistics.median(steps) * 1e3:.1f} ms = "
          f"wait on group reads {wait_ms:.1f} ms + kernels {kern_ms:.2f} ms + rest "
          f"{statistics.median(steps) * 1e3 - wait_ms - kern_ms:.1f} ms  [{card}]", flush=True)
    del main_run
    torch.cuda.empty_cache()

    runs = {}
    for aio in (True, False):
        run = run_main_path(cfg, device=dev, n_layers=4,
                            engine_cfg=dataclasses.replace(ecfg, async_io=aio))
        for name, n in run["launches"].items():
            check(n == run["decode_steps"] * 4, f"4-layer run: {name} launched {n} times")
        runs[aio] = run["outputs"]
    check(all(math.prod(a.shape) == 32 and (a == b).all() for a, b in zip(runs[True], runs[False])),
          "4-layer tokens differ between async_io on and off")
    print("4 layers: tokens bit-identical with async_io on and off", flush=True)

    for kr in kernels:
        kr["launches"] = launches[kr["name"]]
    print(json.dumps({"kernels": [{key: kr[key] for key in (
        "name", "route", "source", "replaces", "launches", "max_abs_err", "ms",
        "plain_ms", "bound_ms", "bound_by", "library_ms")} for kr in kernels]}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
