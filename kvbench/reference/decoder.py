"""Plain fp32 reference of a llama-style decoder (dense SwiGLU or top-k routed
experts) served through KVSwap's selective decode.

It reads the benchmark's weights (a dict made by :mod:`kvbench.weights`)
and its configuration file, and works out again itself everything the
program derives from them: the low-rank adapter fitted from the first
layer's keys on the calibration prompt, the compressed keys, each decode
step's group selection, the rolling tail and the attention over them.  It
imports nothing of the program.

KVSwap's decode as the configuration runs it (group size ``G``, ``M``
groups a layer, predicted from the previous layer's input):

* a prompt of ``s`` tokens is prefilled with full causal attention; its
  complete groups go to the store and their keys, projected through the
  adapter, to the compressed cache;
* the token at position ``p >= s`` sees ``valid = floor(p / G) * G`` tokens
  in the compressed cache.  Layer ``L`` scores them with its own query
  (input norm, Q projection, RoPE) formed from the input of layer ``L - 1``
  (of layer 0 for ``L = 0``), per head through the adapter's slice of the
  head's KV head, summed over heads; each group's score is the maximum of
  its tokens' and the ``M`` best groups (ties to the lower index) are
  selected;
* it attends to the selected groups' exact keys and values, to the tokens
  ``[valid, p)`` of the rolling tail and to itself.

A selection is discrete: where two groups' scores (or two experts'
probabilities) lie within rounding, the program and this reference may keep
different ones, and the step's output then differs by far more than
rounding, in every later step too.  So the comparison can ``follow`` the
program's own group selections and ``routes``, and check them apart: each
must be a top-``M`` (top-``k``) choice under this reference's numbers up to
a small slack.

Every position of a row runs in one pass, layer by layer: the selections
need only the previous layer's inputs, which the pass already holds.
"""

from __future__ import annotations

import math

import numpy as np
import torch

NEG = -1e30


def rmsnorm(x: torch.Tensor, scale: torch.Tensor, eps: float) -> torch.Tensor:
    xf = x.float()
    return xf * torch.rsqrt(xf.square().mean(dim=-1, keepdim=True) + eps) * scale


def rope(x: torch.Tensor, pos: torch.Tensor, theta: float) -> torch.Tensor:
    """Rotary embedding in the split-halves convention: ``x [T, H, d]`` at
    positions ``pos [T]``."""
    d = x.shape[-1]
    freqs = 1.0 / (theta ** (torch.arange(0, d, 2, dtype=torch.float32, device=x.device) / d))
    ang = pos[:, None].float() * freqs
    cos, sin = torch.cos(ang)[:, None, :], torch.sin(ang)[:, None, :]
    x1, x2 = x.chunk(2, dim=-1)
    return torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)


class Dims:
    def __init__(self, cfg: dict):
        self.d = cfg["hidden_size"]
        self.h = cfg["num_attention_heads"]
        self.hk = cfg["num_key_value_heads"]
        self.hd = cfg.get("head_dim") or self.d // self.h
        self.n_layers = cfg["num_hidden_layers"]
        self.eps = cfg["rms_norm_eps"]
        self.theta = cfg["rope_theta"]
        self.n_experts = cfg.get("num_experts", 0)
        self.top_k = cfg.get("num_experts_per_tok", 0)
        self.renorm = cfg.get("norm_topk_prob", False)


def qkv(lw: dict, dm: Dims, h: torch.Tensor, pos: torch.Tensor):
    t = h.shape[0]
    q = rope((h @ lw["wq"]).reshape(t, dm.h, dm.hd), pos, dm.theta)
    k = rope((h @ lw["wk"]).reshape(t, dm.hk, dm.hd), pos, dm.theta)
    v = (h @ lw["wv"]).reshape(t, dm.hk, dm.hd)
    return q, k, v


def fit_adapter(w: dict, cfg: dict, calib: torch.Tensor, rank: int) -> torch.Tensor:
    """The adapter ``A [H_kv·d, r]``: the top-``r`` right singular vectors
    (float64 SVD) of the first layer's keys on the calibration prompt."""
    dm = Dims(cfg)
    lw = w["layers"][0]
    pos = torch.arange(calib.shape[0], device=calib.device)
    h = rmsnorm(w["embed"][calib], lw["attn_norm"], dm.eps)
    _, k, _ = qkv(lw, dm, h, pos)
    flat = k.reshape(k.shape[0], -1).cpu().numpy().astype(np.float64)
    _, _, vt = np.linalg.svd(flat, full_matrices=False)
    return torch.as_tensor(np.ascontiguousarray(vt[:rank].T), dtype=torch.float32,
                           device=calib.device)


def ffn(lw: dict, dm: Dims, h: torch.Tensor, experts: torch.Tensor | None = None,
        stats: dict | None = None) -> torch.Tensor:
    """Dense SwiGLU, or the routed experts without a capacity: every token
    goes to its top-k experts (softmax over the router, the gates
    renormalised where the configuration says so).  With ``experts [T, k]``
    the tokens go to those, and ``stats["routing_slack"]`` gets how far
    they fall short of a top-k choice under these probabilities."""
    if not dm.n_experts:
        return (torch.nn.functional.silu(h @ lw["w_gate"]) * (h @ lw["w_up"])) @ lw["w_down"]
    probs = torch.softmax((h @ lw["router"]).float(), dim=-1)
    if experts is None:
        experts = torch.sort(probs, dim=-1, descending=True, stable=True)[1][:, :dm.top_k]
    elif stats is not None:
        chosen = torch.zeros_like(probs, dtype=torch.bool).scatter_(1, experts, True)
        lo = probs.masked_fill(~chosen, float("inf")).amin(dim=1)
        hi = probs.masked_fill(chosen, float("-inf")).amax(dim=1)
        short = ((hi - lo) / probs.amax(dim=1)).clamp_min(0.0)
        bad = chosen.sum(dim=1) != dm.top_k
        stats["routing_slack"] = max(stats.get("routing_slack", 0.0),
                                     float("inf") if bool(bad.any()) else float(short.max()))
    gates = probs.gather(1, experts)
    if dm.renorm:
        gates = gates / (gates.sum(dim=-1, keepdim=True) + 1e-9)
    y = torch.zeros_like(h)
    for e in torch.unique(experts).tolist():
        tok, slot = torch.nonzero(experts == e, as_tuple=True)
        he = h[tok]
        out = (torch.nn.functional.silu(he @ lw["w_gate"][e]) * (he @ lw["w_up"][e])) @ lw["w_down"][e]
        y.index_add_(0, tok, out * gates[tok, slot, None])
    return y


def group_scores(scores: torch.Tensor, valid: torch.Tensor, g: int) -> torch.Tensor:
    """``scores [Td, T]`` of the decode positions over every token → each
    group's score, the maximum of its tokens' ``[Td, ceil(T / G)]``; a group
    at or past the row's ``valid`` reads ``NEG``."""
    td, t = scores.shape
    n = torch.arange(t, device=scores.device)
    scores = scores.masked_fill(n[None, :] >= valid[:, None], NEG)
    scores = torch.nn.functional.pad(scores, (0, -t % g), value=NEG)
    return scores.reshape(td, -1, g).amax(dim=-1)


def top_groups(gs: torch.Tensor, m: int) -> torch.Tensor:
    """The ``m`` best valid groups of each row (ties to the lower group) as a
    ``[Td, n_groups]`` mask."""
    top, ids = torch.sort(gs, dim=-1, descending=True, stable=True)
    chosen = torch.zeros_like(gs, dtype=torch.bool)
    chosen.scatter_(1, ids[:, :m], top[:, :m] > NEG / 2)
    return chosen


def slack(gs: torch.Tensor, chosen: torch.Tensor, m: int) -> float:
    """How far a given selection falls short of a top-``m`` one under these
    scores: the most by which an unselected valid group outscores a selected
    one, over the row's largest score magnitude (0 where it is a top-``m``
    set; infinite where it selects an invalid group or the wrong count)."""
    ok = gs > NEG / 2
    if bool((chosen & ~ok).any()) or bool((chosen.sum(1) != torch.clamp(ok.sum(1), max=m)).any()):
        return float("inf")
    scale = gs.masked_fill(~ok, 0.0).abs().amax(dim=1).clamp_min(1e-30)
    lo = gs.masked_fill(~chosen, float("inf")).amin(dim=1)
    hi = gs.masked_fill(chosen | ~ok, float("-inf")).amax(dim=1)
    return float(((hi - lo) / scale).clamp_min(0.0).max())


def attend(q, k, v, allowed, chunk: int = 256) -> torch.Tensor:
    """``q [T, H, d]`` over ``k, v [T, Hk, d]`` where ``allowed [T, T]``."""
    t, h, d = q.shape
    rep = h // k.shape[1]
    kq, vq = k.repeat_interleave(rep, dim=1), v.repeat_interleave(rep, dim=1)
    out = torch.empty_like(q)
    for i in range(0, t, chunk):
        s = torch.einsum("qhd,khd->hqk", q[i:i + chunk], kq) / math.sqrt(d)
        s = s.masked_fill(~allowed[None, i:i + chunk], float("-inf"))
        out[i:i + chunk] = torch.einsum("hqk,khd->qhd", torch.softmax(s, dim=-1), vq)
    return out


def served_logits(w: dict, cfg: dict, engine: dict, adapter: torch.Tensor,
                  tokens: torch.Tensor, n_prompt: int, *, follow: list | None = None,
                  routes: list | None = None, record: list | None = None,
                  record_routes: list | None = None, stats: dict | None = None) -> torch.Tensor:
    """Logits ``[T - n_prompt + 1, V]`` at positions ``n_prompt - 1 .. T - 1``
    of one row, ``tokens [T]`` its prompt and then its served tokens (all
    but the last served one): the prefill's last position, then each decode
    step's, as KVSwap serves them.

    Each decode position selects its own ``M`` best groups a layer, or, with
    ``follow`` (one ``[T - n_prompt, n_groups]`` mask a layer), attends to the
    groups given there; ``stats["slack"]`` then gets the largest
    :func:`slack` of those selections under this reference's scores.
    Likewise ``routes`` (one ``[T, k]`` expert choice a layer) routes every
    position to the experts given (``stats["routing_slack"]``, :func:`ffn`).
    ``record`` and ``record_routes`` receive the choices used, layer by
    layer."""
    dm = Dims(cfg)
    g, m = engine["group_size"], engine["n_select"]
    t = tokens.shape[0]
    dev = tokens.device
    pos = torch.arange(t, device=dev)
    dec = pos[n_prompt:]
    valid = dec // g * g
    causal = pos[None, :] <= pos[:, None]
    a_head = adapter.reshape(dm.hk, dm.hd, -1).repeat_interleave(dm.h // dm.hk, dim=0)
    x = w["embed"][tokens]
    src = x
    for layer in range(dm.n_layers):
        lw = w["layers"][layer]
        h = rmsnorm(x, lw["attn_norm"], dm.eps)
        q, k, v = qkv(lw, dm, h, pos)
        allowed = causal.clone()
        if dec.numel():
            hs = rmsnorm(src[n_prompt:], lw["attn_norm"], dm.eps)
            qp = rope((hs @ lw["wq"]).reshape(-1, dm.h, dm.hd), dec, dm.theta)
            q_lr = torch.einsum("thd,hdr->thr", qp, a_head)
            k_lr = k.reshape(t, -1) @ adapter
            scores = torch.einsum("thr,nr->thn", q_lr, k_lr).sum(dim=1)
            gs = group_scores(scores, valid, g)
            if follow is None:
                chosen = top_groups(gs, m)
            else:
                chosen = follow[layer][:, :gs.shape[1]].to(gs.device)
                if stats is not None:
                    stats["slack"] = max(stats.get("slack", 0.0), slack(gs, chosen, m))
            if record is not None:
                record.append(chosen)
            tail = (pos[None, :] >= valid[:, None]) & (pos[None, :] <= dec[:, None])
            sel = torch.repeat_interleave(chosen, g, dim=1)[:, :t] & (pos[None, :] < valid[:, None])
            allowed[n_prompt:] = sel | tail
        o = attend(q, k, v, allowed)
        src = x
        x = x + o.reshape(t, -1) @ lw["wo"]
        h2 = rmsnorm(x, lw["mlp_norm"], dm.eps)
        experts = None
        if dm.n_experts:
            experts = (routes[layer].to(h2.device) if routes is not None else
                       torch.sort(torch.softmax((h2 @ lw["router"]).float(), dim=-1), dim=-1,
                                  descending=True, stable=True)[1][:, :dm.top_k])
            if record_routes is not None:
                record_routes.append(experts)
        x = x + ffn(lw, dm, h2, experts, stats if routes is not None else None)
    x = rmsnorm(x[n_prompt - 1:], w["final_norm"], dm.eps)
    head = w["embed"].T if cfg.get("tie_word_embeddings") else w["lm_head"]
    return x @ head
