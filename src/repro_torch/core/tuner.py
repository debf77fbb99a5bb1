"""Offline parameter tuning (KVSwap §3.5, Appendix A).

Selects runtime parameters ``(σ, G, M, C)`` under a user memory budget
``B_max`` for a target model + disk + compute platform, using:

* precomputed lookup tables (App. A.1):
  - reuse-buffer capacity C → expected reuse rate (input-invariant, so the
    average suffices — paper Tab. 5),
  - compression ratio σ → low-rank adapter (delegated to ``lowrank.fit``),
* modeled I/O delay ``T_io(b, Const, G, C)`` and model delay
  ``T_model(b, Const, C, S, σ)`` (App. A.3 — *measured* with NVTX on the
  Jetson in the paper; *modeled* from DiskSpec/ComputeSpec here),
* the greedy solver of App. A.4: pick the smallest σ that fits the budget,
  then the smallest G that hides ``(1−α)`` of I/O under compute; if even
  ``G_max`` fails, grow C by δ (re-shrinking σ to stay within budget) and
  restart from G=1.

The reference's module (``repro/core/tuner.py``) under the port's package:
numpy over the port's ``hardware``, ``offload`` and ``tiers``.  The compute
model stays the Jetson Orin (``hardware.ORIN``), as the engine's modeled
clock does; the tuned tuple is what the engine's ``EngineConfig`` takes.
"""

from __future__ import annotations

import dataclasses
import json
import math

import numpy as np

from repro_torch.core import hardware
from repro_torch.core.offload import DISKS, DiskSpec


@dataclasses.dataclass(frozen=True)
class TunerInputs:
    dims: hardware.ModelDims
    n_layers: int
    b_max: int
    s_max: int
    budget_bytes: int            # B_max/b_max: *per-batch* KV-management budget (App. A.4)
    disk: str = "nvme"
    # host-RAM warm tier (repro_torch.tiers): a single global byte budget for int8
    # copies of reuse-evicted groups.  Charged against the memory budget in
    # full (conservative — it is shared across rows) and credited in t_io as
    # re-reads served at memcpy cost instead of disk cost.  0 = no tier.
    warm_budget_bytes: int = 0
    mg_const: int = 400          # M·G preset (App. A.2)
    sigma_max: float = 32.0
    g_max: int = 16
    alpha: float = 0.25          # allow α fraction of I/O to stay exposed
    c_delta: int = 32            # reuse-capacity increment per solver round
    compute: hardware.ComputeSpec = hardware.ORIN
    dtype_bytes: int = 2

    @property
    def disk_spec(self) -> DiskSpec:
        return DISKS[self.disk]


@dataclasses.dataclass
class TunedParams:
    group_size: int
    n_select: int
    rank: int
    sigma: float
    reuse_capacity: int
    meets_overlap: bool
    mem_bytes: int
    t_io: float
    t_model: float

    def to_json(self) -> str:
        return json.dumps(dataclasses.asdict(self), indent=2)


def default_reuse_table() -> dict[int, float]:
    """C (groups) → reuse rate.  Saturates near the paper's ~0.77 once C
    covers the working set of hot groups (Fig. 8: <22 % of groups = 80 % of
    accesses).  Callers may substitute a measured table
    (``build_reuse_table``)."""
    return {0: 0.0, 16: 0.25, 32: 0.42, 64: 0.60, 96: 0.69, 128: 0.74,
            192: 0.77, 256: 0.785, 512: 0.80, 1024: 0.81}


def lookup_reuse(table: dict[int, float], c: int) -> float:
    ks = sorted(table)
    if c <= ks[0]:
        return table[ks[0]]
    if c >= ks[-1]:
        return table[ks[-1]]
    for lo, hi in zip(ks, ks[1:]):
        if lo <= c <= hi:
            w = (c - lo) / (hi - lo)
            return table[lo] * (1 - w) + table[hi] * w
    return table[ks[-1]]


def build_reuse_table(step_overlap: float = 0.77, working_set: int = 512,
                      n_steps: int = 400, seed: int = 0) -> dict[int, float]:
    """Measure reuse rate vs capacity on a synthetic Zipf-ish group-access
    trace with the paper's adjacent-step overlap statistic (Fig. 8)."""
    rng = np.random.default_rng(seed)
    table = {}
    ranks = np.arange(1, working_set + 1)
    probs = 1.0 / ranks
    probs /= probs.sum()
    m = 100
    prev = rng.choice(working_set, m, replace=False, p=probs)
    trace = [prev]
    for _ in range(n_steps - 1):
        keep = rng.random(m) < step_overlap
        nxt = prev.copy()
        resample = np.where(~keep)[0]
        if len(resample):
            nxt[resample] = rng.choice(working_set, len(resample), p=probs)
        trace.append(np.unique(nxt)[:m])
        prev = nxt
    for cap in (0, 16, 32, 64, 96, 128, 192, 256, 512, 1024):
        from collections import deque
        fifo: deque = deque()
        resident: set = set()
        hits = total = 0
        for ids in trace:
            for g in ids:
                total += 1
                if g in resident:
                    hits += 1
                elif cap > 0:
                    if len(fifo) >= cap:
                        resident.discard(fifo.popleft())
                    fifo.append(g)
                    resident.add(g)
        table[cap] = hits / max(total, 1)
    return table


# -- memory / delay models (App. A.3) ---------------------------------------

def memory_bytes(inp: TunerInputs, *, sigma: float, g: int, m: int, c: int, b: int, s: int) -> int:
    """Per-run KVSwap metadata memory for batch b at context S."""
    dims = inp.dims
    feat = dims.n_kv_heads * dims.head_dim
    r = max(1, int(round(feat / sigma)))
    entry = dims.kv_planes * feat * inp.dtype_bytes
    k_lr = b * s * r * inp.dtype_bytes * inp.n_layers
    reuse = c * b * g * entry * inp.n_layers
    rolling = b * g * entry * inp.n_layers
    # preload buffer shared across layers; merged into reuse when enabled
    staging = b * m * g * entry
    # warm tier: one global slab+index budget (repro_torch.tiers), charged whole —
    # it is shared across rows/layers, so per-batch accounting is conservative
    return k_lr + reuse + rolling + staging + inp.warm_budget_bytes


def warm_hit_fraction(inp: TunerInputs, *, g: int, m: int, b: int,
                      misses_per_layer: float) -> float:
    """Modeled fraction of reuse misses the warm tier absorbs.

    The tier holds int8 copies of recently evicted groups under one global
    budget; its coverage is capacity over the recent-eviction pool it must
    track — every layer's and row's per-step miss churn over a short recency
    window (re-reads recur within a few steps, the Fig. 8 tail).
    """
    if inp.warm_budget_bytes <= 0 or misses_per_layer <= 0:
        return 0.0
    from repro_torch.tiers import INDEX_ENTRY_BYTES
    entry_q = inp.dims.kv_planes * inp.dims.n_kv_heads * inp.dims.head_dim  # int8: 1 B/elem
    per_group = g * entry_q + 4 + INDEX_ENTRY_BYTES
    capacity_groups = inp.warm_budget_bytes / per_group
    window = 8  # steps of eviction churn the tier should cover
    pool = inp.n_layers * b * misses_per_layer * window
    return min(1.0, capacity_groups / max(pool, 1.0))


def t_io(inp: TunerInputs, *, g: int, m: int, c: int, b: int,
         reuse_table: dict[int, float]) -> float:
    """Modeled per-layer fetch-serve time for one decode step: disk reads
    for true misses plus (with ``warm_budget_bytes``) memcpy+dequantize for
    the re-reads the warm tier absorbs."""
    dims = inp.dims
    entry = dims.kv_planes * dims.n_kv_heads * dims.head_dim * inp.dtype_bytes
    rr = lookup_reuse(reuse_table, c)
    misses = m * (1.0 - rr)
    wf = warm_hit_fraction(inp, g=g, m=m, b=b, misses_per_layer=misses)
    disk_misses = misses * (1.0 - wf)
    nbytes = int(disk_misses * g * entry) * b
    nreq = max(1, int(math.ceil(disk_misses))) * b
    t = inp.disk_spec.read_time(nbytes, nreq)
    if wf > 0.0:
        warm_groups = misses * wf * b
        q_bytes = warm_groups * g * dims.kv_planes * dims.n_kv_heads * dims.head_dim
        out_bytes = q_bytes * inp.dtype_bytes
        t += inp.compute.op_time(2.0 * q_bytes, q_bytes + out_bytes)
    return t


def t_model(inp: TunerInputs, *, g: int, m: int, b: int, s: int, sigma: float) -> float:
    """Modeled per-layer compute time (attention over M·G + prediction)."""
    dims = inp.dims
    feat = dims.n_kv_heads * dims.head_dim
    r = max(1, int(round(feat / sigma)))
    return hardware.decode_layer_time(
        inp.compute, dims, n_ctx=m * g, batch=b, rank=r, n_lr_tokens=s)


# -- greedy solver (App. A.4) ------------------------------------------------

def solve(inp: TunerInputs, *, reuse_table: dict[int, float] | None = None,
          b: int | None = None, s: int | None = None) -> TunedParams:
    """Greedy search for one (b, S) point (defaults to the max point)."""
    reuse_table = reuse_table or default_reuse_table()
    b = b or inp.b_max
    s = s or inp.s_max
    feat = inp.dims.n_kv_heads * inp.dims.head_dim

    c = 0
    sigma = 1.0
    while True:
        # (1) smallest σ (best quality) that fits the budget at this C
        sigma = None
        for cand in (1, 2, 4, 8, 16, 24, 32, 48, 64):
            if cand > inp.sigma_max:
                break
            g_probe = 1
            m_probe = inp.mg_const // g_probe
            if memory_bytes(inp, sigma=cand, g=g_probe, m=m_probe, c=c, b=1, s=s) <= inp.budget_bytes:
                sigma = float(cand)
                break
        if sigma is None:
            sigma = float(inp.sigma_max)
        # (2) smallest G whose residual I/O ≤ α·T_model
        for g in range(1, inp.g_max + 1):
            m = max(1, inp.mg_const // g)
            if memory_bytes(inp, sigma=sigma, g=g, m=m, c=c, b=1, s=s) > inp.budget_bytes:
                continue
            ti = t_io(inp, g=g, m=m, c=c, b=b, reuse_table=reuse_table)
            tm = t_model(inp, g=g, m=m, b=b, s=s, sigma=sigma)
            # App. A.4: stop once (1−α) of the I/O overlaps with computation
            if (1.0 - inp.alpha) * ti <= tm:
                r = max(1, int(round(feat / sigma)))
                return TunedParams(
                    group_size=g, n_select=m, rank=r, sigma=sigma,
                    reuse_capacity=c, meets_overlap=True,
                    mem_bytes=memory_bytes(inp, sigma=sigma, g=g, m=m, c=c, b=1, s=s),
                    t_io=ti, t_model=tm)
        # (3) failed at G_max: grow the reuse buffer and restart from G=1 —
        # but only while σ_max can still absorb the growth within budget.
        g_max, m_min = inp.g_max, max(1, inp.mg_const // inp.g_max)
        grown_fits = memory_bytes(
            inp, sigma=inp.sigma_max, g=g_max, m=m_min, c=c + inp.c_delta, b=1, s=s
        ) <= inp.budget_bytes
        if grown_fits and c + inp.c_delta <= 4096:
            c += inp.c_delta
            continue
        # Give up on full overlap.  Jointly pick (σ, C) within budget that
        # minimizes exposed I/O: a larger σ frees memory that a larger C
        # (reuse buffer) converts into fewer disk reads — the solver's
        # "reallocate part of the memory budget to the reuse buffer" step.
        g, m = g_max, m_min
        best = None
        # two passes: prefer σ ≤ σ_max; exceed it only as a last resort so the
        # budget is always respected (quality flagged via meets_overlap=False)
        ladder = [c for c in (1, 2, 4, 8, 16, 24, 32, 48, 64, 128, 256)
                  if c <= inp.sigma_max]
        ladder += [c for c in (48, 64, 128, 256, 512) if c > inp.sigma_max]
        for cand in ladder:
            if best is not None and cand > inp.sigma_max:
                break
            cc = 0
            while (cc + inp.c_delta <= 4096 and memory_bytes(
                    inp, sigma=cand, g=g, m=m, c=cc + inp.c_delta, b=1, s=s)
                    <= inp.budget_bytes):
                cc += inp.c_delta
            if memory_bytes(inp, sigma=cand, g=g, m=m, c=cc, b=1, s=s) > inp.budget_bytes:
                continue
            ti_c = t_io(inp, g=g, m=m, c=cc, b=b, reuse_table=reuse_table)
            # prefer lower I/O; tie-break on quality (smaller σ)
            key = (round(ti_c, 6), cand)
            if best is None or key < best[0]:
                best = (key, float(cand), cc, ti_c)
        if best is None:  # even σ=512 doesn't fit: infeasible budget
            raise ValueError(
                f"budget {inp.budget_bytes} B infeasible for S={s} even at "
                f"extreme compression; raise the budget or lower S_max")
        _, sigma, c, ti = best
        r = max(1, int(round(feat / sigma)))
        tm = t_model(inp, g=g, m=m, b=b, s=s, sigma=sigma)
        return TunedParams(
            group_size=g, n_select=m, rank=r, sigma=float(sigma),
            reuse_capacity=c, meets_overlap=False,
            mem_bytes=memory_bytes(inp, sigma=sigma, g=g, m=m, c=c, b=1, s=s),
            t_io=ti, t_model=tm)


def solve_grid(inp: TunerInputs, *, reuse_table: dict[int, float] | None = None,
               b_step: int = 1, s_step: int = 2048, s_min: int = 4096) -> dict:
    """App. A.4 'record solutions': one tuned tuple per (b, S) pair."""
    out = {}
    for b in range(1, inp.b_max + 1, b_step):
        for s in range(s_min, inp.s_max + 1, s_step):
            out[f"b{b}_s{s}"] = dataclasses.asdict(
                solve(inp, reuse_table=reuse_table, b=b, s=s))
    return out
