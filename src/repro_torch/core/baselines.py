"""Competing KV-offloading baselines (paper §4.2), adapted to disk offloading.

Each baseline is a *selection policy*: given the true query and the full K
cache (plus whatever compact in-memory state the method keeps), it picks the
KV entries to fetch and reports the I/O pattern (bytes + request count) and
its in-memory metadata footprint.  A shared simulator replays decode steps
through a policy to produce throughput (DiskSpec + ComputeSpec models) and
quality proxies (oracle-recall, attention-output error) — the quantities
behind paper Tabs. 2–4.

Policies:

* :class:`FlexGenPolicy` — full KV restored from disk layer-by-layer.
* :class:`InfiniGenPolicy` — per-head, per-token selection from a partial
  (index-selected embedding dims) K cache; fragmented per-entry reads.
* ``InfiniGenPolicy(head_agg=True)`` — InfiniGen*: + head aggregation.
* :class:`ShadowKVPolicy` — low-rank K resident (conservative rank) with
  on-the-fly K reconstruction; only V entries are read from disk.
* :class:`LokiPolicy` — PCA low-rank keys as the score predictor; per-token.
* :class:`KVSwapPolicy` — ours: grouped prediction on the aggressive
  low-rank K_lr; group-granular reads; optional reuse.

The reference's module (``repro/core/baselines.py``) under the port's
package: numpy on the host over the port's ``hardware`` and ``DiskSpec``.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.core import hardware
from repro_torch.core.offload import DiskSpec

# Each selected "entry" is one token's K+V across KV heads.


def _entry_bytes(n_kv_heads: int, head_dim: int, dtype_bytes: int = 2) -> int:
    return 2 * n_kv_heads * head_dim * dtype_bytes


def _softmax(x, axis=-1):
    x = x - x.max(axis=axis, keepdims=True)
    e = np.exp(x)
    return e / e.sum(axis=axis, keepdims=True)


def head_scores(q: np.ndarray, k: np.ndarray) -> np.ndarray:
    """Exact per-head scores.  q [H, d], k [N, Hk, d] → [H, N]."""
    h, d = q.shape
    hk = k.shape[1]
    rep = h // hk
    kq = np.repeat(k, rep, axis=1)  # [N, H, d]
    return np.einsum("hd,nhd->hn", q, kq)


@dataclasses.dataclass
class Selection:
    token_ids: np.ndarray       # selected token indices (sorted, unique)
    io_bytes: int
    io_requests: int
    mem_bytes: int              # method's resident metadata for this layer


class BasePolicy:
    name = "base"

    def reset(self, n_tokens: int) -> None:  # called at sequence start
        pass

    def select(self, q: np.ndarray, k: np.ndarray, budget_tokens: int) -> Selection:
        raise NotImplementedError

    def effective_k(self, k: np.ndarray) -> np.ndarray:
        """K the method actually computes attention with.  ShadowKV must
        reconstruct K from its low-rank factors (its quality bottleneck under
        tight budgets); everyone else attends over the true K it loaded."""
        return k


class FlexGenPolicy(BasePolicy):
    """Loads the full KV cache for every layer, every step."""

    name = "flexgen"

    def __init__(self, n_kv_heads: int, head_dim: int):
        self.eb = _entry_bytes(n_kv_heads, head_dim)

    def select(self, q, k, budget_tokens):
        n = k.shape[0]
        # one big sequential read per layer
        return Selection(np.arange(n), n * self.eb, 1, 0)


class InfiniGenPolicy(BasePolicy):
    """Partial-weight (index-selected K dims) prediction; per-token reads.

    ``partial_ratio`` ρ keeps ρ·d of each head's K dims in memory; prediction
    scores use only those dims (the paper's "index-selecting strategy").
    ``head_agg=True`` gives InfiniGen* (our head-aggregation grafted on);
    ``reuse=True`` gives InfiniGen*+ru.
    """

    def __init__(self, n_kv_heads: int, head_dim: int, *, partial_ratio: float = 0.5,
                 head_agg: bool = False, reuse: bool = False, seed: int = 0):
        self.hk, self.d = n_kv_heads, head_dim
        self.eb = _entry_bytes(n_kv_heads, head_dim)
        self.rho = partial_ratio
        self.head_agg = head_agg
        self.reuse = reuse
        self.name = "infinigen" + ("*" if head_agg else "") + ("+ru" if reuse else "")
        rng = np.random.default_rng(seed)
        n_keep = max(1, int(round(partial_ratio * head_dim)))
        # fixed selected dims per head (pre-determined indices)
        self.dims = np.stack([rng.choice(head_dim, n_keep, replace=False)
                              for _ in range(n_kv_heads)])
        self._resident: set[int] = set()

    def reset(self, n_tokens: int) -> None:
        self._resident = set()

    def select(self, q, k, budget_tokens):
        h, d = q.shape
        n, hk, _ = k.shape
        rep = h // hk
        # score on index-selected dims only
        scores = np.zeros((h, n))
        for hi in range(h):
            khead = hi // rep
            dims = self.dims[khead]
            scores[hi] = k[:, khead, dims] @ q[hi, dims]
        if self.head_agg:
            agg = scores.sum(axis=0)
            ids = np.argsort(-agg)[:budget_tokens]
        else:
            per_head = max(1, budget_tokens // h)
            ids = np.unique(np.argsort(-scores, axis=1)[:, :per_head].ravel())[:budget_tokens]
        ids = np.sort(np.unique(ids))
        if self.reuse:
            misses = [i for i in ids if i not in self._resident]
            self._resident = set(ids.tolist())
        else:
            misses = list(ids)
        nb = len(misses) * self.eb
        # fragmented: one request per (token) entry — runs of adjacent coalesce
        if misses:
            ms = np.sort(np.asarray(misses))
            reqs = 1 + int(np.sum(np.diff(ms) != 1))
        else:
            reqs = 0
        mem = n * self.hk * self.dims.shape[1] * 2  # partial K cache (fp16)
        return Selection(ids, nb, reqs, mem)


class ShadowKVPolicy(BasePolicy):
    """Low-rank K resident + reconstruction; only V streamed from disk."""

    name = "shadowkv"

    def __init__(self, n_kv_heads: int, head_dim: int, *, rank: int = 160, reuse: bool = False):
        self.hk, self.d = n_kv_heads, head_dim
        self.vb = n_kv_heads * head_dim * 2  # V-only entry
        if reuse:
            self.name = "shadowkv+ru"
        self.rank = rank
        self.reuse = reuse
        self._proj = None
        self._klr = None
        self._resident: set[int] = set()

    def reset(self, n_tokens: int) -> None:
        self._proj = None
        self._resident = set()

    def _fit(self, k: np.ndarray):
        n = k.shape[0]
        flat = k.reshape(n, -1)
        r = min(self.rank, min(flat.shape))
        # online SVD at prefill (the paper notes its 4.9x prefill cost)
        _, _, vt = np.linalg.svd(flat, full_matrices=False)
        self._proj = vt[:r].T
        self._klr = flat @ self._proj

    def select(self, q, k, budget_tokens):
        n = k.shape[0]
        if self._proj is None or self._klr.shape[0] != n:
            self._fit(k)
        h, d = q.shape
        rep = h // self.hk
        # reconstruct K from the low-rank factors, score exactly on it
        k_rec = (self._klr @ self._proj.T).reshape(n, self.hk, d)
        scores = head_scores(q, k_rec).sum(axis=0)
        ids = np.sort(np.argsort(-scores)[:budget_tokens])
        if self.reuse:
            misses = [i for i in ids if i not in self._resident]
            self._resident = set(ids.tolist())
        else:
            misses = list(ids)
        if misses:
            ms = np.sort(np.asarray(misses))
            reqs = 1 + int(np.sum(np.diff(ms) != 1))
        else:
            reqs = 0
        mem = self._klr.shape[0] * self._klr.shape[1] * 2 + self._proj.size * 2
        return Selection(ids, len(misses) * self.vb, reqs, mem)

    def effective_k(self, k):
        n = k.shape[0]
        if self._proj is None or self._klr.shape[0] != n:
            self._fit(k)
        return (self._klr @ self._proj.T).reshape(n, self.hk, self.d).astype(np.float32)


class LokiPolicy(BasePolicy):
    """PCA low-rank keys as predictor; per-token selection and loads."""

    name = "loki"

    def __init__(self, n_kv_heads: int, head_dim: int, *, rank: int = 32, calib: np.ndarray | None = None):
        self.hk, self.d = n_kv_heads, head_dim
        self.eb = _entry_bytes(n_kv_heads, head_dim)
        self.rank = rank
        self._proj = None
        if calib is not None:
            flat = calib.reshape(-1, n_kv_heads * head_dim)
            _, _, vt = np.linalg.svd(flat - flat.mean(0), full_matrices=False)
            self._proj = vt[: min(rank, vt.shape[0])].T

    def select(self, q, k, budget_tokens):
        n = k.shape[0]
        flat = k.reshape(n, -1)
        if self._proj is None:
            _, _, vt = np.linalg.svd(flat - flat.mean(0), full_matrices=False)
            self._proj = vt[: min(self.rank, vt.shape[0])].T
        h = q.shape[0]
        rep = h // self.hk
        proj3 = self._proj.reshape(self.hk, self.d, -1)
        klr = flat @ self._proj
        scores = np.zeros(n)
        for hi in range(h):
            qlr = q[hi] @ proj3[hi // rep]
            scores += klr @ qlr
        ids = np.sort(np.argsort(-scores)[:budget_tokens])
        reqs = 1 + int(np.sum(np.diff(ids) != 1)) if len(ids) else 0
        mem = klr.size * 2
        return Selection(ids, len(ids) * self.eb, reqs, mem)


class KVSwapPolicy(BasePolicy):
    """Ours, in the same harness: grouped low-rank prediction + reuse."""

    name = "kvswap"

    def __init__(self, n_kv_heads: int, head_dim: int, *, group_size: int = 4,
                 rank: int = 32, reuse: bool = True, calib: np.ndarray | None = None,
                 kv_bytes: int = 2):
        """``kv_bytes=1`` models int8 KV on disk (§7 low-bit combination)."""
        self.hk, self.d = n_kv_heads, head_dim
        self.g = group_size
        self.rank = rank
        self.reuse = reuse
        self.eb = _entry_bytes(n_kv_heads, head_dim, kv_bytes)
        if kv_bytes == 1:
            self.name = "kvswap-int8"
        self._proj = None
        if calib is not None:
            flat = calib.reshape(-1, n_kv_heads * head_dim)
            _, _, vt = np.linalg.svd(flat, full_matrices=False)
            self._proj = vt[: min(rank, vt.shape[0])].T
        self._resident: set[int] = set()

    def reset(self, n_tokens: int) -> None:
        self._resident = set()

    def select(self, q, k, budget_tokens):
        n, hk, d = k.shape
        flat = k.reshape(n, -1)
        if self._proj is None:
            _, _, vt = np.linalg.svd(flat, full_matrices=False)
            self._proj = vt[: min(self.rank, vt.shape[0])].T
        klr = flat @ self._proj                       # offline-adapter projection
        h = q.shape[0]
        rep = h // hk
        proj3 = self._proj.reshape(hk, d, -1)
        scores = np.zeros(n)
        for hi in range(h):
            scores += klr @ (q[hi] @ proj3[hi // rep])  # Eq. 1 + head sum
        g = self.g
        npad = (-n) % g
        gsc = np.pad(scores, (0, npad), constant_values=-1e30).reshape(-1, g).max(axis=1)
        m = max(1, budget_tokens // g)
        gids = np.sort(np.argsort(-gsc)[:m])
        token_ids = (gids[:, None] * g + np.arange(g)[None, :]).ravel()
        token_ids = token_ids[token_ids < n]
        if self.reuse:
            miss_groups = [gi for gi in gids if gi not in self._resident]
            self._resident = set(gids.tolist())
        else:
            miss_groups = list(gids)
        nb = len(miss_groups) * g * self.eb
        if miss_groups:
            ms = np.sort(np.asarray(miss_groups))
            reqs = 1 + int(np.sum(np.diff(ms) != 1))
        else:
            reqs = 0
        mem = klr.size * 2
        return Selection(np.sort(token_ids), nb, reqs, mem)


# --------------------------------------------------------------------------
# shared evaluation harness
# --------------------------------------------------------------------------

def attention_output(q: np.ndarray, k: np.ndarray, v: np.ndarray,
                     token_ids: np.ndarray | None = None) -> np.ndarray:
    """Reference attention output over (a subset of) the cache.  [H, d]."""
    h, d = q.shape
    hk = k.shape[1]
    if token_ids is not None:
        k = k[token_ids]
        v = v[token_ids]
    scores = head_scores(q, k) / np.sqrt(d)
    w = _softmax(scores, axis=-1)
    vq = np.repeat(v, h // hk, axis=1)
    return np.einsum("hn,nhd->hd", w, vq)


@dataclasses.dataclass
class FidelityResult:
    recall: float          # oracle top-budget token recall
    mass: float            # true softmax attention mass covered by selection
    out_err: float         # relative L2 error of the method's attention output
    io_bytes: int
    io_requests: int
    mem_bytes: int


def attention_mass(q: np.ndarray, k: np.ndarray, token_ids: np.ndarray) -> float:
    """Fraction of the true softmax probability mass the selection covers
    (head-averaged) — the quality proxy grouping actually optimizes."""
    h, d = q.shape
    w = _softmax(head_scores(q, k) / np.sqrt(d), axis=-1)   # [H, N]
    return float(w[:, token_ids].sum(axis=1).mean())


def evaluate_policy(policy: BasePolicy, q: np.ndarray, k: np.ndarray, v: np.ndarray,
                    budget_tokens: int) -> FidelityResult:
    sel = policy.select(q, k, budget_tokens)
    exact = head_scores(q, k).sum(axis=0)
    oracle = set(np.argsort(-exact)[:budget_tokens].tolist())
    got = set(sel.token_ids.tolist())
    recall = len(oracle & got) / max(len(oracle), 1)
    mass = attention_mass(q, k, sel.token_ids)
    ref = attention_output(q, k, v)
    k_eff = policy.effective_k(k)
    approx = attention_output(q, k_eff, v, sel.token_ids)
    err = float(np.linalg.norm(approx - ref) / (np.linalg.norm(ref) + 1e-9))
    return FidelityResult(recall, mass, err, sel.io_bytes, sel.io_requests, sel.mem_bytes)


def simulate_throughput(
    policy: BasePolicy,
    *,
    disk: DiskSpec,
    dims: hardware.ModelDims,
    n_layers: int,
    batch: int,
    n_ctx: int,
    budget_tokens: int,
    n_steps: int = 32,
    compute: hardware.ComputeSpec = hardware.ORIN,
    seed: int = 0,
    locality: float = 0.9,
) -> dict:
    """Replay a decode trace with temporally local queries (paper Fig. 8)
    through a policy; returns modeled tokens/s + I/O stats.

    The synthetic K cache and the slowly-drifting query reproduce the
    "adjacent steps overlap ~77%" statistic that makes reuse effective.
    """
    rng = np.random.default_rng(seed)
    h, hk, d = dims.n_heads, dims.n_kv_heads, dims.head_dim
    # token-correlated keys: real K caches are locally coherent (nearby
    # tokens share context), which is what makes grouped selection stable
    # (paper Fig. 8) — an i.i.d. K cache would understate group locality.
    k = np.empty((n_ctx, hk, d), np.float32)
    prev = rng.standard_normal((hk, d))
    tok_rho = 0.7
    for t in range(n_ctx):
        prev = tok_rho * prev + np.sqrt(1 - tok_rho**2) * rng.standard_normal((hk, d))
        k[t] = prev
    q = rng.standard_normal((h, d)).astype(np.float32)
    policy.reset(n_ctx)
    t_io_layers = []
    io_bytes = io_reqs = 0
    mem = 0
    for step in range(n_steps):
        q = locality * q + np.sqrt(1 - locality**2) * rng.standard_normal((h, d)).astype(np.float32)
        sel = policy.select(q, k, budget_tokens)
        t_io = disk.read_time(sel.io_bytes, max(sel.io_requests, 1)) if sel.io_bytes else 0.0
        t_io_layers.append(t_io)
        io_bytes += sel.io_bytes
        io_reqs += sel.io_requests
        mem = max(mem, sel.mem_bytes)
    t_io_step = float(np.mean(t_io_layers)) * n_layers * batch
    n_attend = min(budget_tokens, n_ctx)
    t_c = hardware.decode_layer_time(compute, dims, n_ctx=n_attend, batch=batch) * n_layers
    # layer-pipelined overlap: exposed I/O beyond compute, plus one layer lead-in
    t_step = max(t_c, t_io_step) + t_io_step / n_layers
    return {
        "policy": policy.name,
        "tokens_per_s": batch / t_step,
        "t_io": t_io_step,
        "t_compute": t_c,
        "io_bytes_per_step": io_bytes / n_steps,
        "io_requests_per_step": io_reqs / n_steps,
        "mem_bytes": mem * n_layers * batch,
    }
