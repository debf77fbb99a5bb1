"""Plain fp32 reference of a multi-head latent attention (MLA) decoder with
routed experts, Mistral-Small-4's layer (DeepSeek-V3's equations), served
through KVSwap's selective decode.

It reads the benchmark's weights (a dict made by :mod:`kvbench.weights`,
laid out by :mod:`kvbench.models.mla`) and the configuration file, and
works out again itself everything the program derives from them.  It
imports nothing of the program.

The layer, at positions ``pos``, from its normed input ``h``:

* queries ``c_q = RMSNorm(h W_qa)``, ``q_h = c_q W_qb = [q_nope_h (nope) ‖
  q_pe_h (rope)]``, ``q_pe_h`` rotated;
* the latent record ``[c ‖ k_pe] = [RMSNorm(c_kv) ‖ RoPE(k_pe)]`` of ``[c_kv
  ‖ k_pe] = h W_kva``: what the KV layer caches, one a token for all heads;
* keys and values ``[k_nope_h ‖ v_h] = c W_kvb``, ``k_h = [k_nope_h ‖
  k_pe]``;
* attention with the softmax scale ``(nope + rope)^-½ · m²``, ``m = 0.1 ·
  mscale_all_dim · ln(factor) + 1``; the output ``concat_h(o_h) W_o``;
* RoPE is YaRN's (NTK-by-parts inverse frequencies, arXiv:2309.00071, the
  ramp's ends floored and ceiled as DeepSeek-V3's code does) on interleaved
  pairs ``(x[2i], x[2i+1])``, the output in the same order;
* the experts: scores ``sigmoid(h2 W_r)`` over every routed expert, the top
  ``k`` by score (ties to the lower expert), gates the chosen scores over
  their sum; one shared expert on every token.  Only the experts this
  device holds, ``[0, held)``, are computed: the others' part of the output
  lies on other devices and is left out, here as in the program.

KVSwap's decode (group size ``G``, ``M`` groups a layer, predicted from the
previous layer's input), as :mod:`kvbench.reference.decoder` describes it,
but on the latent records: the adapter ``A [kv_lora + rope, r]`` is fitted
on layer 0's records, and layer ``L`` scores the compressed records with
each head's absorbed query ``q̃_h = [q_nope_h W_UK,hᵀ ‖ q_pe_h]`` (``W_UK,h``
the head's key part of ``W_kvb``), whose product with a record is the head's
exact logit before scaling; the attention then runs over the selected
groups' and the tail's decompressed heads.

Departures from the published model, each the program's too: fp32 in place
of bf16; the router's score-correction bias zero (random weights); the
gates' sum guarded by ``+ 1e-9`` (DeepSeek-V3: ``1e-20``); positions under
YaRN's original context (8,192), where the query scaling
``llama_4_scaling_beta`` is exactly 1, so it is not applied; the vision
tower left out.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from kvbench.reference.decoder import group_scores, rmsnorm, slack, top_groups


class Dims:
    def __init__(self, cfg: dict):
        self.d = cfg["hidden_size"]
        self.h = cfg["num_attention_heads"]
        self.q_lora = cfg["q_lora_rank"]
        self.kv_lora = cfg["kv_lora_rank"]
        self.nope = cfg["qk_nope_head_dim"]
        self.rope = cfg["qk_rope_head_dim"]
        self.v = cfg["v_head_dim"]
        self.n_layers = cfg["num_hidden_layers"]
        self.eps = cfg["rms_norm_eps"]
        self.top_k = cfg["num_experts_per_tok"]
        self.held = cfg["n_routed_experts"]
        rp = cfg["rope_parameters"]
        self.theta = float(rp["rope_theta"])
        self.factor = float(rp["factor"])
        self.original = rp["original_max_position_embeddings"]
        self.beta_fast, self.beta_slow = float(rp["beta_fast"]), float(rp["beta_slow"])
        m = 0.1 * rp["mscale_all_dim"] * math.log(self.factor) + 1.0
        self.scale = m * m / math.sqrt(self.nope + self.rope)


def yarn_inv_freq(dm: Dims, device) -> torch.Tensor:
    """YaRN's inverse frequencies of the ``rope`` rotary dims."""
    dim = dm.rope

    def turns(rotations):      # the dim that turns ``rotations`` times over the original context
        return dim * math.log(dm.original / (rotations * 2 * math.pi)) / (2 * math.log(dm.theta))

    lo = max(math.floor(turns(dm.beta_fast)), 0)
    hi = min(math.ceil(turns(dm.beta_slow)), dim - 1)
    hi = hi + 0.001 if lo == hi else hi
    plain = 1.0 / dm.theta ** (torch.arange(0, dim, 2, dtype=torch.float64) / dim)
    ramp = ((torch.arange(dim // 2, dtype=torch.float64) - lo) / (hi - lo)).clamp(0.0, 1.0)
    return (plain / dm.factor * ramp + plain * (1.0 - ramp)).float().to(device)


def rope(x: torch.Tensor, pos: torch.Tensor, inv_freq: torch.Tensor) -> torch.Tensor:
    """Interleaved pairs of ``x [T, H, rope]`` rotated at positions ``pos [T]``."""
    ang = pos[:, None].float() * inv_freq
    cos, sin = torch.cos(ang)[:, None, :], torch.sin(ang)[:, None, :]
    a, b = x[..., 0::2], x[..., 1::2]
    out = torch.empty_like(x)
    out[..., 0::2] = a * cos - b * sin
    out[..., 1::2] = a * sin + b * cos
    return out


def queries(lw: dict, dm: Dims, h: torch.Tensor, pos: torch.Tensor, inv_freq) -> torch.Tensor:
    """``q [T, H, nope + rope]`` of the normed ``h [T, D]``, unscaled."""
    q = (rmsnorm(h @ lw["wq_a"], lw["q_norm"], dm.eps) @ lw["wq_b"]).reshape(-1, dm.h,
                                                                            dm.nope + dm.rope)
    return torch.cat([q[..., :dm.nope], rope(q[..., dm.nope:], pos, inv_freq)], dim=-1)


def records(lw: dict, dm: Dims, h: torch.Tensor, pos: torch.Tensor, inv_freq) -> torch.Tensor:
    """The latent records ``[T, kv_lora + rope]`` of the normed ``h [T, D]``."""
    kv = h @ lw["wkv_a"]
    k_pe = rope(kv[:, None, dm.kv_lora:], pos, inv_freq)[:, 0]
    return torch.cat([rmsnorm(kv[:, :dm.kv_lora], lw["kv_norm"], dm.eps), k_pe], dim=-1)


def expand(lw: dict, dm: Dims, rec: torch.Tensor):
    """Records ``[T, kv_lora + rope]`` → ``k [T, H, nope + rope]``, ``v [T, H, v]``."""
    kv = (rec[:, :dm.kv_lora] @ lw["wkv_b"]).reshape(-1, dm.h, dm.nope + dm.v)
    k_pe = rec[:, None, dm.kv_lora:].expand(-1, dm.h, dm.rope)
    return torch.cat([kv[..., :dm.nope], k_pe], dim=-1), kv[..., dm.nope:]


def absorbed(lw: dict, dm: Dims, q: torch.Tensor) -> torch.Tensor:
    """``q [T, H, nope + rope]`` → ``[T, H, kv_lora + rope]``: each head's
    query against the records."""
    w_uk = lw["wkv_b"].reshape(dm.kv_lora, dm.h, dm.nope + dm.v)[..., :dm.nope]
    return torch.cat([torch.einsum("thn,rhn->thr", q[..., :dm.nope], w_uk), q[..., dm.nope:]],
                     dim=-1)


def fit_adapter(w: dict, cfg: dict, calib: torch.Tensor, rank: int) -> torch.Tensor:
    """The adapter ``A [kv_lora + rope, r]``: the top-``r`` right singular
    vectors (float64 SVD) of the first layer's records on the calibration
    prompt."""
    dm = Dims(cfg)
    lw = w["layers"][0]
    pos = torch.arange(calib.shape[0], device=calib.device)
    h = rmsnorm(w["embed"][calib], lw["attn_norm"], dm.eps)
    rec = records(lw, dm, h, pos, yarn_inv_freq(dm, calib.device))
    _, _, vt = np.linalg.svd(rec.cpu().numpy().astype(np.float64), full_matrices=False)
    return torch.as_tensor(np.ascontiguousarray(vt[:rank].T), dtype=torch.float32,
                           device=calib.device)


def route(lw: dict, dm: Dims, h2: torch.Tensor) -> torch.Tensor:
    """Each token's top-``k`` experts ``[T, k]`` by sigmoid score."""
    scores = torch.sigmoid((h2 @ lw["router"]).float())
    return torch.sort(scores, dim=-1, descending=True, stable=True)[1][:, :dm.top_k]


def swiglu(h: torch.Tensor, gate: torch.Tensor, up: torch.Tensor, down: torch.Tensor):
    return (torch.nn.functional.silu(h @ gate) * (h @ up)) @ down


def ffn(lw: dict, dm: Dims, h: torch.Tensor, experts: torch.Tensor,
        stats: dict | None = None) -> torch.Tensor:
    """The shared expert, plus the routed experts this device holds for the
    tokens ``experts [T, k]`` sends them; with ``stats``,
    ``stats["routing_slack"]`` gets how far ``experts`` fall short of a
    top-``k`` choice under the sigmoid scores."""
    scores = torch.sigmoid((h @ lw["router"]).float())
    if stats is not None:
        chosen = torch.zeros_like(scores, dtype=torch.bool).scatter_(1, experts, True)
        lo = scores.masked_fill(~chosen, float("inf")).amin(dim=1)
        hi = scores.masked_fill(chosen, float("-inf")).amax(dim=1)
        short = ((hi - lo) / scores.amax(dim=1)).clamp_min(0.0)
        bad = chosen.sum(dim=1) != dm.top_k
        stats["routing_slack"] = max(stats.get("routing_slack", 0.0),
                                     float("inf") if bool(bad.any()) else float(short.max()))
    gates = scores.gather(1, experts)
    gates = gates / (gates.sum(dim=-1, keepdim=True) + 1e-9)
    y = swiglu(h, lw["shared_gate"], lw["shared_up"], lw["shared_down"])
    for e in torch.unique(experts).tolist():
        if e >= dm.held:
            continue
        tok, slot = torch.nonzero(experts == e, as_tuple=True)
        out = swiglu(h[tok], lw["w_gate"][e], lw["w_up"][e], lw["w_down"][e])
        y.index_add_(0, tok, out * gates[tok, slot, None])
    return y


def attend(q, k, v, allowed, scale: float, chunk: int = 256) -> torch.Tensor:
    """``q, k [T, H, dq]``, ``v [T, H, dv]`` where ``allowed [T, T]``."""
    out = q.new_empty(q.shape[0], q.shape[1], v.shape[-1])
    for i in range(0, q.shape[0], chunk):
        s = torch.einsum("qhd,khd->hqk", q[i:i + chunk], k) * scale
        s = s.masked_fill(~allowed[None, i:i + chunk], float("-inf"))
        out[i:i + chunk] = torch.einsum("hqk,khd->qhd", torch.softmax(s, dim=-1), v)
    return out


def served_logits(w: dict, cfg: dict, engine: dict, adapter: torch.Tensor,
                  tokens: torch.Tensor, n_prompt: int, *, follow: list | None = None,
                  routes: list | None = None, record: list | None = None,
                  record_routes: list | None = None, stats: dict | None = None) -> torch.Tensor:
    """Logits ``[T - n_prompt + 1, V]`` at positions ``n_prompt - 1 .. T - 1``
    of one row, as :func:`kvbench.reference.decoder.served_logits` gives
    them (the same arguments), for the MLA layer above."""
    dm = Dims(cfg)
    g, m = engine["group_size"], engine["n_select"]
    t = tokens.shape[0]
    dev = tokens.device
    inv_freq = yarn_inv_freq(dm, dev)
    pos = torch.arange(t, device=dev)
    dec = pos[n_prompt:]
    valid = dec // g * g
    causal = pos[None, :] <= pos[:, None]
    x = w["embed"][tokens]
    src = x
    for layer in range(dm.n_layers):
        lw = w["layers"][layer]
        h = rmsnorm(x, lw["attn_norm"], dm.eps)
        q = queries(lw, dm, h, pos, inv_freq)
        rec = records(lw, dm, h, pos, inv_freq)
        allowed = causal.clone()
        if dec.numel():
            hs = rmsnorm(src[n_prompt:], lw["attn_norm"], dm.eps)
            q_lr = absorbed(lw, dm, queries(lw, dm, hs, dec, inv_freq)) @ adapter
            scores = torch.einsum("thr,nr->thn", q_lr, rec @ adapter).sum(dim=1)
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
        k, v = expand(lw, dm, rec)
        o = attend(q, k, v, allowed, dm.scale)
        src = x
        x = x + o.reshape(t, -1) @ lw["wo"]
        h2 = rmsnorm(x, lw["mlp_norm"], dm.eps)
        experts = routes[layer].to(h2.device) if routes is not None else route(lw, dm, h2)
        if record_routes is not None:
            record_routes.append(experts)
        x = x + ffn(lw, dm, h2, experts, stats if routes is not None else None)
    x = rmsnorm(x[n_prompt - 1:], w["final_norm"], dm.eps)
    return x @ w["lm_head"]
