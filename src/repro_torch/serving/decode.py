"""Device-resident serving path: the whole KV cache in device memory, and
KVSwap's grouped low-rank selection deciding which KV *groups* each decode
step's attention reads — the PyTorch port of :mod:`repro.serving.decode`.

Two serve modes:

* ``full``   — masked decode attention over the whole cache (plain PyTorch);
* ``kvswap`` — score against the compressed ``k_lr`` (Eq. 1, head-summed,
  plain PyTorch), ReduceMax over groups of G, top-M groups gathered and
  attended through :func:`repro_torch.models.layers.decode_attention`
  (kernel B on the card, at S = M·G + 1, or M·G + G + 1 with the rolling
  buffer).

A Mamba2 block's prefill runs its chunked SSD (kernel C on the card); the
xLSTM blocks launch no kernel.

**The cache is updated in place.**  The reference's ``serve_step`` is
functional (``dynamic_update_slice`` returns a new cache, so it jits and
lowers under pjit); copying a multi-GB cache every step is not an option
here, so :func:`prefill`, :func:`serve_step` and :func:`flush_rolling`
write the new entries into the cache's tensors, at ``[:, length]`` or at
the rolling slot, and return the same dict.  ``length`` and ``main_len``
are host ints, so a step never waits on the device to learn where to
write.  A caller that needs the old cache keeps a copy of its tensors.
"""

from __future__ import annotations

import dataclasses
import math

import torch

from repro_torch.device import resolve
from repro_torch.models import layers as L
from repro_torch.models import ssm as S
from repro_torch.models import transformer as T
from repro_torch.models import whisper as W
from repro_torch.models.transformer import ATTN_KINDS

NEG = -1e30


@dataclasses.dataclass(frozen=True)
class KVSwapServeConfig:
    group_size: int = 4
    n_select: int = 100
    rank: int = 64
    # §3.4.1 rolling buffer, device edition: new tokens append into a small
    # buffer of G tokens, always attended; ``flush_rolling`` merges a full
    # buffer into the main cache (and its compressed keys into ``k_lr``)
    # once every G steps.
    rolling: bool = False
    # §3.3 cross-layer prediction, device edition: "prev" scores layer i's
    # groups with a query projected from layer i−1's *input*; "self"
    # (default) scores from the layer's own input.
    predict_from: str = "self"

    @property
    def rb_len(self) -> int:
        return self.group_size


def _is_whisper(cfg) -> bool:
    return type(cfg).__name__ == "WhisperConfig"


def _blocks(cfg) -> tuple:
    return ("attn",) * cfg.n_layers if _is_whisper(cfg) else cfg.blocks


# --------------------------------------------------------------------------
# adapters as params
# --------------------------------------------------------------------------


def attach_kvswap_adapters(params, cfg, rank: int, *, generator: torch.Generator,
                           dtype=torch.float32) -> dict:
    """A copy of ``params`` with per-KV-layer low-rank adapters ``A [H_k·d,
    r]`` under ``"kvswap_adapters"``: the Q of a QR of a Gaussian matrix
    drawn from ``generator`` (which lives on the params' device), as the
    reference builds them without calibration data."""
    feat = cfg.n_kv_heads * cfg.head_dim
    n_kv = sum(1 for k in _blocks(cfg) if k in ATTN_KINDS)
    adapters = []
    for _ in range(n_kv):
        m = torch.randn((feat, rank), generator=generator, device=generator.device,
                        dtype=dtype)
        q, _ = torch.linalg.qr(m)
        adapters.append(q[:, :rank].contiguous())
    return {**params, "kvswap_adapters": adapters}


# --------------------------------------------------------------------------
# cache
# --------------------------------------------------------------------------


def init_cache(cfg, batch: int, max_len: int, *, dtype=torch.float32,
               kvswap: KVSwapServeConfig | None = None, device=None) -> dict:
    """An empty cache: per block its KV (with ``k_lr`` and the rolling
    buffer in ``kvswap`` mode) or its recurrent state; ``length`` (and
    ``main_len`` with the rolling buffer) as host ints.  The xLSTM
    stabilisers start at -1e30, as the reference's cache has them (its
    ``*_init_state`` functions use -inf)."""
    dev = resolve(device)
    zeros = lambda *shape: torch.zeros(shape, dtype=dtype, device=dev)
    layers = []
    for kind in _blocks(cfg):
        if kind in ATTN_KINDS:
            ent = {"k": zeros(batch, max_len, cfg.n_kv_heads, cfg.head_dim),
                   "v": zeros(batch, max_len, cfg.n_kv_heads, cfg.head_dim)}
            if kvswap is not None:
                ent["k_lr"] = zeros(batch, max_len, kvswap.rank)
                if kvswap.rolling:
                    ent["rb_k"] = zeros(batch, kvswap.rb_len, cfg.n_kv_heads, cfg.head_dim)
                    ent["rb_v"] = torch.zeros_like(ent["rb_k"])
            layers.append(ent)
        elif kind == "mamba2":
            di = cfg.ssm_expand * cfg.d_model
            layers.append({"conv": zeros(batch, di + 2 * cfg.ssm_state, 3),
                           "ssm": zeros(batch, di // 64, 64, cfg.ssm_state)})
        elif kind == "mlstm":
            hd = cfg.d_model // cfg.n_heads
            layers.append({"c": zeros(batch, cfg.n_heads, hd, hd),
                           "n": zeros(batch, cfg.n_heads, hd),
                           "m": torch.full((batch, cfg.n_heads), -1e30, dtype=dtype, device=dev)})
        elif kind == "slstm":
            hd = cfg.d_model // cfg.n_heads
            layers.append({"c": zeros(batch, cfg.n_heads, hd),
                           "n": zeros(batch, cfg.n_heads, hd),
                           "h": zeros(batch, cfg.n_heads, hd),
                           "m": torch.full((batch, cfg.n_heads), -1e30, dtype=dtype, device=dev)})
        else:
            raise ValueError(kind)
    cache = {"layers": layers, "length": 0}
    if kvswap is not None and kvswap.rolling:
        cache["main_len"] = 0          # tokens flushed into the main cache
    return cache


# --------------------------------------------------------------------------
# attention over the cache
# --------------------------------------------------------------------------


def _full_decode_attn(q, ent, length: int, k_new, v_new):
    """``q [B,H,d]``: attention over ``cache[:length]`` plus the new token.

    The reference masks the whole cache to ``pos < length``; a masked
    token's weight is exactly 0, so this reads only the first ``length``
    entries.  GQA groups the query heads by KV head instead of repeating
    K and V."""
    b, h, d = q.shape
    hk = ent["k"].shape[2]
    qg = q.reshape(b, hk, h // hk, d)
    k, v = ent["k"][:, :length], ent["v"][:, :length]
    scale = math.sqrt(d)
    scores = torch.einsum("bkrd,bnkd->bkrn", qg, k) / scale
    self_score = torch.einsum("bkrd,bkd->bkr", qg, k_new) / scale
    w = torch.softmax(torch.cat([scores, self_score[..., None]], dim=-1).float(),
                      dim=-1).to(q.dtype)
    out = torch.einsum("bkrn,bnkd->bkrd", w[..., :-1], v) + w[..., -1:] * v_new[:, :, None]
    return out.reshape(b, h, d)


def _top_groups(gsc: torch.Tensor, m: int):
    """The ``m`` largest group scores of each row and their ids, by a stable
    descending sort: equal scores keep the lower id first, as
    ``jax.lax.top_k`` does (every group past the flushed tokens ties at
    -1e30)."""
    top_sc, gids = torch.sort(gsc, dim=-1, descending=True, stable=True)
    return top_sc[:, :m], gids[:, :m]


def _kvswap_decode_attn(q, ent, adapter, length: int, k_new, v_new, scfg: KVSwapServeConfig,
                        n_kv_heads: int, main_len: int | None = None, q_pred=None):
    """Grouped low-rank selection + gathered attention (Eq. 1 / §3.3).

    With ``scfg.rolling``, selection covers only the flushed prefix
    (``main_len`` tokens) and the rolling buffer's recent tokens are always
    attended (§3.4.1).  ``q_pred`` is the query used for *scoring* only
    (cross-layer prediction); attention always uses the true ``q``."""
    b, h, d = q.shape
    g, m = scfg.group_size, scfg.n_select
    n = ent["k"].shape[1]
    n_groups = n // g
    flushed = length if main_len is None else main_len
    if q_pred is None:
        q_pred = q

    # Eq. 1: low-rank queries per head, shared-K-head adapter slices
    a_h = torch.repeat_interleave(adapter.reshape(n_kv_heads, d, -1), h // n_kv_heads, dim=0)
    q_lr = torch.einsum("bhd,hdr->bhr", q_pred, a_h)            # [B,H,r]
    scores = torch.einsum("bhr,bnr->bn", q_lr, ent["k_lr"])     # head-summed
    pos = torch.arange(n, device=q.device)
    scores = scores.masked_fill((pos >= flushed)[None, :], NEG)
    gsc = scores[:, : n_groups * g].reshape(b, n_groups, g).amax(dim=-1)
    top_sc, gids = _top_groups(gsc, min(m, n_groups))            # [B,M]
    sel_valid = top_sc > NEG / 2

    tok_idx = (gids[..., None] * g + torch.arange(g, device=q.device)).reshape(b, -1)  # [B,M*G]
    rows = torch.arange(b, device=q.device)[:, None]
    k_sel, v_sel = ent["k"][rows, tok_idx], ent["v"][rows, tok_idx]
    tok_mask = (tok_idx < flushed) & torch.repeat_interleave(sel_valid, g, dim=-1)
    if main_len is not None:
        rb_mask = (torch.arange(scfg.rb_len, device=q.device) < length - main_len)
        k_sel = torch.cat([k_sel, ent["rb_k"]], dim=1)
        v_sel = torch.cat([v_sel, ent["rb_v"]], dim=1)
        tok_mask = torch.cat([tok_mask, rb_mask[None, :].expand(b, -1)], dim=1)
    return L.decode_attention(q, k_sel, v_sel, tok_mask, k_new, v_new)


# --------------------------------------------------------------------------
# prefill + serve_step
# --------------------------------------------------------------------------


def prefill(params, cfg, tokens: torch.Tensor, cache: dict, *,
            kvswap: KVSwapServeConfig | None = None, enc_out: torch.Tensor | None = None):
    """Full attention over the prompt ``tokens [B, S]``, writing its KV (and
    ``k_lr``) into ``cache[:, :S]`` and each state block's state into the
    cache.  Returns ``(last-position logits [B, V], cache)`` — the same
    dict, updated in place."""
    b, s = tokens.shape
    positions = torch.arange(s, device=tokens.device)[None, :].repeat(b, 1)
    whisper = _is_whisper(cfg)
    if whisper:
        x = params["embed"][tokens] + W.sinusoid_positions(positions, cfg.d_model)
        ckv = W.cross_kv(params, cfg, enc_out)
    else:
        x = params["embed"][tokens]
    layers = cache["layers"]
    kv_idx = 0
    for i, kind in enumerate(_blocks(cfg)):
        if kind in ATTN_KINDS:
            if whisper:
                blk = params["dec_blocks"][i]
                q, k, v = W._proj_qkv(blk["attn"], L.layernorm(blk["ln1"], x), cfg)
                o = L.causal_attention(q, k, v)
                x = x + o.reshape(b, s, -1) @ blk["attn"]["wo"]
                x = W.cross_and_mlp(blk, cfg, x, *ckv[i])
            else:
                x, _, (k, v) = T.block_forward(params, cfg, i, x, positions, return_kv=True)
            ent = layers[i]
            ent["k"][:, :s] = k
            ent["v"][:, :s] = v
            if kvswap is not None:
                ent["k_lr"][:, :s] = k.reshape(b, s, -1) @ params["kvswap_adapters"][kv_idx]
            kv_idx += 1
        else:
            x, _, layers[i] = T.block_forward(params, cfg, i, x, positions, layers[i])
    if whisper:
        logits = L.layernorm(params["final_norm"], x)[:, -1] @ params["embed"].T
    else:
        head = params["embed"].T if cfg.tie_embeddings else params["lm_head"]
        logits = L.rmsnorm(params["final_norm"], x)[:, -1] @ head
    cache["length"] = s
    if kvswap is not None and kvswap.rolling:
        cache["main_len"] = s          # the whole prompt lives in the main cache
    return logits, cache


def serve_step(params, cfg, tokens: torch.Tensor, cache: dict, *,
               kvswap: KVSwapServeConfig | None = None, enc_out: torch.Tensor | None = None):
    """One decode step: ``tokens [B, 1]`` → ``(logits [B, V], cache)``.  The
    new token's KV goes into the cache in place (at ``[:, length]``, or into
    the rolling buffer), and ``length`` grows by one."""
    b = tokens.shape[0]
    length = cache["length"]
    main_len = cache.get("main_len")
    pos = torch.full((b,), length, dtype=torch.int32, device=tokens.device)
    whisper = _is_whisper(cfg)
    if whisper:
        x = params["embed"][tokens[:, 0]] + W.sinusoid_positions(pos, cfg.d_model)
        ckv = W.cross_kv(params, cfg, enc_out)
    else:
        x = params["embed"][tokens[:, 0]]
    layers = cache["layers"]
    rolling = kvswap is not None and kvswap.rolling
    kv_idx = 0
    x_prev = x   # input to the previous block (cross-layer prediction source)
    for i, kind in enumerate(_blocks(cfg)):
        x_in = x
        if kind in ATTN_KINDS:
            if whisper:
                blk = params["dec_blocks"][i]
                nb_norm = lambda t, blk=blk: L.layernorm(blk["ln1"], t)
                attn_p = blk["attn"]
            else:
                nb, attn_p, mlp_holder = T._attn_params(params, cfg, i)
                nb_norm = lambda t, nb=nb: L.rmsnorm(nb["attn_norm"], t)

            def _q_of(t):
                """Layer i's query projection of an arbitrary residual input."""
                qq = (nb_norm(t) @ attn_p["wq"]).reshape(b, cfg.n_heads, cfg.head_dim)
                if not whisper:
                    if cfg.qk_norm:
                        qq = L.rmsnorm(attn_p["q_norm"], qq)
                    qq = L.apply_rope(qq[:, None], pos[:, None], cfg.rope_theta)[:, 0]
                return qq

            h = nb_norm(x)
            q = (h @ attn_p["wq"]).reshape(b, cfg.n_heads, cfg.head_dim)
            k_new = (h @ attn_p["wk"]).reshape(b, cfg.n_kv_heads, cfg.head_dim)
            v_new = (h @ attn_p["wv"]).reshape(b, cfg.n_kv_heads, cfg.head_dim)
            if not whisper:
                if cfg.qk_norm:
                    q = L.rmsnorm(attn_p["q_norm"], q)
                    k_new = L.rmsnorm(attn_p["k_norm"], k_new)
                q = L.apply_rope(q[:, None], pos[:, None], cfg.rope_theta)[:, 0]
                k_new = L.apply_rope(k_new[:, None], pos[:, None], cfg.rope_theta)[:, 0]
            ent = layers[i]
            if kvswap is not None:
                # §3.3: score from the previous block's input
                q_pred = _q_of(x_prev) if kvswap.predict_from == "prev" and i > 0 else None
                o = _kvswap_decode_attn(q, ent, params["kvswap_adapters"][kv_idx], length,
                                        k_new, v_new, kvswap, cfg.n_kv_heads,
                                        main_len=main_len if rolling else None, q_pred=q_pred)
            else:
                o = _full_decode_attn(q, ent, length, k_new, v_new)
            x = x + o.reshape(b, -1) @ attn_p["wo"]
            # append the new token's KV, in place
            if rolling:
                ent["rb_k"][:, length - main_len] = k_new
                ent["rb_v"][:, length - main_len] = v_new
            else:
                ent["k"][:, length] = k_new
                ent["v"][:, length] = v_new
                if kvswap is not None:
                    ent["k_lr"][:, length] = (k_new.reshape(b, 1, -1)
                                              @ params["kvswap_adapters"][kv_idx])[:, 0]
            if whisper:
                x = W.cross_and_mlp(params["dec_blocks"][i], cfg, x, *ckv[i])
            else:
                h2 = L.rmsnorm(mlp_holder["mlp_norm"], x)
                if kind == "moe_attn":    # one token a row, routed as a call of S = 1
                    x = x + T._ffn(params, cfg, i, mlp_holder, h2[:, None])[0][:, 0]
                else:
                    x = x + L.swiglu(mlp_holder["mlp"], h2)
            kv_idx += 1
        else:
            blk = params["blocks"][i]
            h = L.rmsnorm(blk["norm"], x)
            if kind == "mamba2":
                y, layers[i] = S.mamba2_step(blk["mamba"], h, layers[i])
            elif kind == "mlstm":
                y, layers[i] = S.mlstm_step(blk["mlstm"], h, layers[i])
            else:
                y, layers[i] = S.slstm_step(blk["slstm"], h, layers[i])
            x = x + y
        x_prev = x_in
    if whisper:
        logits = L.layernorm(params["final_norm"], x) @ params["embed"].T
    else:
        head = params["embed"].T if cfg.tie_embeddings else params["lm_head"]
        logits = L.rmsnorm(params["final_norm"], x) @ head
    cache["length"] = length + 1
    return logits, cache


def flush_rolling(params, cfg, cache: dict, kvswap: KVSwapServeConfig) -> dict:
    """Merge full rolling buffers into the main cache at ``main_len``, with
    the flushed group's compressed keys appended to ``k_lr`` (engine
    §3.4.1 parity); the caller calls it once every ``kvswap.rb_len`` decode
    steps.  Updates the cache in place and returns it."""
    main_len, g = cache["main_len"], kvswap.rb_len
    kv_idx = 0
    for i, kind in enumerate(_blocks(cfg)):
        if kind not in ATTN_KINDS:
            continue
        ent = cache["layers"][i]
        b = ent["rb_k"].shape[0]
        ent["k"][:, main_len:main_len + g] = ent["rb_k"]
        ent["v"][:, main_len:main_len + g] = ent["rb_v"]
        ent["k_lr"][:, main_len:main_len + g] = (ent["rb_k"].reshape(b, g, -1)
                                                 @ params["kvswap_adapters"][kv_idx])
        kv_idx += 1
    cache["main_len"] = main_len + g
    return cache
