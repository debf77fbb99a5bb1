"""The sequence-sharded decode path: :mod:`repro_torch.serving.distributed`'s
attention at a long context over the ranks of ``torch.distributed``.

The context's K and V, and ``K_lr = K·A``, are made in blocks of
``spec.block`` tokens, block ``i`` from a generator seeded with ``(seed,
i)``, so each rank makes only its own blocks and a single-process oracle
makes them all, bit for bit alike (:func:`kv_blocks`).  The replicated
inputs (the query, its low-rank projection through ``A``, the new token's
K and V) come from ``seed`` itself (:func:`replicated_inputs`).

:func:`run_rank` is one rank's part, in a process whose process group is
up: for each case (a context length and a budget M) one call of the
attention, checked against nothing here but returned, its kernel A
launches counted from 0, the shard's selected groups on the kernel's
scores against those on the plain scores, and, with ``reps``, the step's,
kernel A's and the combine's times.  ``python -m repro_torch.seqshard_path``
runs it as one of ``world`` processes, which :func:`spawn_ranks` starts,
waits for (with a deadline) and reads back.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import math
import os
import statistics
import subprocess
import sys
import time
from pathlib import Path

import torch
import torch.distributed as dist

from repro_torch.device import resolve
from repro_torch.kernels import ops
from repro_torch.serving import distributed as SD


@dataclasses.dataclass(frozen=True)
class SeqShardSpec:
    b: int              # batch rows
    h: int              # query heads
    hk: int             # KV heads
    d: int              # head_dim
    r: int              # low rank
    n: int              # context capacity in tokens, split evenly over the ranks
    block: int          # tokens a generated block
    group_size: int
    seed: int = 0


def replicated_inputs(spec: SeqShardSpec, device) -> dict:
    """``q [B,H,d]``, the adapter ``a [Hk·d, r]`` (scaled by 1/√(Hk·d)),
    ``q_lr [B,H,r]`` (each head through its KV head's slice of ``a``) and
    the new token's ``k_new/v_new [B,Hk,d]``, from ``spec.seed``."""
    dev = resolve(device)
    gen = torch.Generator(device=dev).manual_seed(spec.seed)
    s = spec
    q = torch.randn((s.b, s.h, s.d), generator=gen, device=dev)
    a = torch.randn((s.hk * s.d, s.r), generator=gen, device=dev) / math.sqrt(s.hk * s.d)
    a3 = a.reshape(s.hk, s.d, s.r).repeat_interleave(s.h // s.hk, dim=0)
    k_new = torch.randn((s.b, s.hk, s.d), generator=gen, device=dev)
    v_new = torch.randn((s.b, s.hk, s.d), generator=gen, device=dev)
    return {"q": q, "a": a, "q_lr": torch.einsum("bhd,hdr->bhr", q, a3),
            "k_new": k_new, "v_new": v_new}


def kv_blocks(spec: SeqShardSpec, first: int, count: int, a: torch.Tensor):
    """Blocks ``first .. first + count - 1`` of the context as ``(k_lr [B,
    n, r], k [B, n, Hk, d], v)``, ``n = count · block``, on ``a``'s device."""
    s, dev = spec, a.device
    n = count * s.block
    k = torch.empty((s.b, n, s.hk, s.d), device=dev)
    v = torch.empty_like(k)
    k_lr = torch.empty((s.b, n, s.r), device=dev)
    for j in range(count):
        gen = torch.Generator(device=dev).manual_seed(s.seed * 65536 + 1 + first + j)
        sl = slice(j * s.block, (j + 1) * s.block)
        k[:, sl] = torch.randn((s.b, s.block, s.hk, s.d), generator=gen, device=dev)
        v[:, sl] = torch.randn((s.b, s.block, s.hk, s.d), generator=gen, device=dev)
        k_lr[:, sl] = k[:, sl].reshape(s.b, s.block, -1) @ a
    return k_lr, k, v


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _flips(gsc_k, gsc_p, quota: int) -> list[dict]:
    """Rows whose selection on the kernel's scores differs from the one on
    the plain scores: the groups each side chose alone, and how far their
    plain scores lie from the plain M-th score, over the row's score scale."""
    ids_k, ok_k = SD.shard_select(gsc_k, quota)
    ids_p, ok_p = SD.shard_select(gsc_p, quota)
    out = []
    for row in range(gsc_p.shape[0]):
        set_k = set(ids_k[row][ok_k[row]].tolist())
        set_p = set(ids_p[row][ok_p[row]].tolist())
        if set_k == set_p:
            continue
        plain = gsc_p[row]
        scale = max(1.0, float(plain.masked_fill(plain <= SD.NEG / 2, 0).abs().max()))
        edge = float(plain[ids_p[row][-1]])
        gap = max(abs(float(plain[g]) - edge) for g in set_k ^ set_p) / scale
        out.append({"row": row, "kernel_only": sorted(set_k - set_p),
                    "plain_only": sorted(set_p - set_k), "gap": gap})
    return out


def _wall_ms(fn, dev: torch.device) -> float:
    """Host wall of one synchronised ``fn()``, in ms."""
    _sync(dev)
    t0 = time.perf_counter()
    fn()
    _sync(dev)
    return (time.perf_counter() - t0) * 1e3


def _kernel_ms(fn, dev: torch.device, reps: int) -> float | None:
    """Median device time of one ``fn()`` over ``reps`` calls (CUDA events;
    a 64 MiB write flushes L2 before each, and a sleep kernel queued ahead
    of the start event keeps the host's enqueue out of the bracket); None
    off a CUDA device."""
    if dev.type != "cuda":
        return None
    flush = torch.empty(64 << 20, dtype=torch.uint8, device=dev)
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
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


def run_rank(spec: SeqShardSpec, mesh, cases: list[dict], *, device=None, axis: str = "data",
             reps: int = 0) -> list[dict]:
    """This rank's part of each case ``{"length": L, "n_select": M}`` over
    ``mesh``'s ``axis``.  Per case: ``out`` (the attention's output, on the
    CPU), ``valid`` (the shard's tokens inside the context), ``launches``
    (kernel A's, from 0 over the case's ``1 + reps`` calls), ``flips``
    (:func:`_flips`) and ``step_ms`` (each timed call's synchronised wall);
    with ``reps``, also ``score_ms`` and ``plain_ms`` (kernel A and its
    plain version alone on this shard, :func:`_kernel_ms`, one rank after
    the other: the chip run's ranks share one card), ``combine_ms``
    (median wall of the combine alone) and ``combine_bytes`` (what this
    rank sends into its two ``all_reduce`` calls)."""
    dev = resolve(device)
    dim = mesh.mesh_dim_names.index(axis)
    world, rank, group = mesh.size(dim), mesh.get_local_rank(dim), mesh.get_group(dim)
    g = spec.group_size
    n_loc = spec.n // world
    start = rank * n_loc
    rep = replicated_inputs(spec, dev)
    k_lr, k, v = kv_blocks(spec, start // spec.block, n_loc // spec.block, rep["a"])
    results = []
    for case in cases:
        length, quota = case["length"], max(1, case["n_select"] // world)
        attn = SD.make_seqshard_decode_attn(mesh, axis=axis, group_size=g,
                                            n_select=case["n_select"], n_kv_heads=spec.hk)
        args = (rep["q"], rep["q_lr"], k_lr, k, v, rep["k_new"], rep["v_new"], length)
        valid = torch.full((spec.b,), min(max(length - start, 0), n_loc), dtype=torch.int32,
                           device=dev)
        score = lambda: ops.lowrank_group_scores(rep["q_lr"], k_lr, valid,
                                                 group_size=g)[:, : n_loc // g]
        plain = ops.lowrank_group_scores_plain(rep["q_lr"], k_lr, valid, group_size=g)
        res = {"valid": int(valid[0]), "flips": _flips(score(), plain[:, : n_loc // g], quota)}
        ops.lowrank_group_scores.launches = 0
        res["out"] = attn(*args).cpu()
        res["step_ms"] = [_wall_ms(lambda: attn(*args), dev) for _ in range(reps)]
        res["launches"] = ops.lowrank_group_scores.launches
        if reps:
            for turn in range(world):
                dist.barrier(group=group)
                if turn == rank:
                    res["score_ms"] = _kernel_ms(score, dev, reps)
                    res["plain_ms"] = _kernel_ms(lambda: ops.lowrank_group_scores_plain(
                        rep["q_lr"], k_lr, valid, group_size=g), dev, reps)
            dist.barrier(group=group)
            gids, ok = SD.shard_select(score(), quota)
            k_sel, v_sel, mask = SD.select_tokens(k, v, gids, ok, start, length, g)
            parts = SD.shard_partial(rep["q"], k_sel, v_sel, mask, rep["k_new"], rep["v_new"],
                                     is_last=rank == world - 1)
            res["combine_ms"] = statistics.median(
                _wall_ms(lambda: SD.combine(*parts, group), dev) for _ in range(reps))
            res["combine_bytes"] = 4 * sum(t.numel() for t in parts)
        results.append(res)
    return results


def spawn_ranks(spec: SeqShardSpec, cases: list[dict], *, world: int, workdir: Path,
                backend: str = "gloo", device=None, reps: int = 0,
                timeout: float = 120.0) -> list[list[dict]]:
    """Run :func:`run_rank` in ``world`` new processes over a process group
    of ``backend`` (rendezvous through a file under ``workdir``), wait for
    every one within ``timeout`` seconds (then kill the rest and raise),
    and return each rank's results, rank 0 first."""
    workdir = Path(workdir)
    workdir.mkdir(parents=True, exist_ok=True)
    store = workdir / "pg_store"
    store.unlink(missing_ok=True)
    src = str(Path(__file__).resolve().parents[1])
    env = {**os.environ, "PYTHONPATH": os.pathsep.join(
        p for p in (src, os.environ.get("PYTHONPATH", "")) if p)}
    outs = [workdir / f"rank{r}.pt" for r in range(world)]
    procs = []
    try:
        for r in range(world):
            outs[r].unlink(missing_ok=True)
            procs.append(subprocess.Popen(
                [sys.executable, "-m", "repro_torch.seqshard_path", "--rank", str(r),
                 "--world", str(world), "--init", f"file://{store}", "--backend", backend,
                 "--device", str(device) if device is not None else "",
                 "--spec", json.dumps(dataclasses.asdict(spec)), "--cases", json.dumps(cases),
                 "--reps", str(reps), "--out", str(outs[r])],
                env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
        deadline = time.monotonic() + timeout
        logs = [p.communicate(timeout=max(1.0, deadline - time.monotonic()))[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    bad = [(r, p.returncode, logs[r]) for r, p in enumerate(procs) if p.returncode]
    if bad:
        raise RuntimeError("seqshard ranks failed:\n" + "\n".join(
            f"rank {r} exited {rc}:\n{log[-4000:]}" for r, rc, log in bad))
    return [torch.load(o) for o in outs]


def main(argv: list[str] | None = None) -> None:
    from repro_torch.launch.mesh import make_mesh_auto

    ap = argparse.ArgumentParser(description="one rank of the sequence-sharded decode path")
    ap.add_argument("--rank", type=int, required=True)
    ap.add_argument("--world", type=int, required=True)
    ap.add_argument("--init", required=True, help="init_method of the process group")
    ap.add_argument("--backend", default="gloo")
    ap.add_argument("--device", default="", help="torch device ('' = the CUDA card)")
    ap.add_argument("--spec", required=True, help="SeqShardSpec as JSON")
    ap.add_argument("--cases", required=True, help="[{length, n_select}, ...] as JSON")
    ap.add_argument("--reps", type=int, default=0)
    ap.add_argument("--out", required=True)
    args = ap.parse_args(argv)
    device = args.device or None
    spec = SeqShardSpec(**json.loads(args.spec))
    dist.init_process_group(args.backend, init_method=args.init, rank=args.rank,
                            world_size=args.world)
    try:
        mesh = make_mesh_auto((args.world,), ("data",), device=device)
        results = run_rank(spec, mesh, json.loads(args.cases), device=device, reps=args.reps)
        torch.save(results, args.out)
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    main()
