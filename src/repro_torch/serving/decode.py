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

**On DTensors** (params and cache laid out by
:mod:`repro_torch.sharding` over a mesh, as the dry run does) each
attention layer's step runs on each rank's shard (:func:`_decode_attn`):
the writes stay local, and a cache split along the sequence
(``long_500k``) selects over every shard's gathered group scores and
combines per-shard partial softmaxes, so no layer is ever gathered whole.
"""

from __future__ import annotations

import dataclasses
import functools
import math

import torch

from repro_torch.device import resolve
from repro_torch.models import layers as L
from repro_torch.models import ssm as S
from repro_torch.models import transformer as T
from repro_torch.models import whisper as W
from repro_torch.models.transformer import ATTN_KINDS
from repro_torch.serving.distributed import combine, shard_partial
from repro_torch.sharding.partition import (P, axis_index, axis_size, like, local_region,
                                            rows)

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
    if getattr(cfg, "latent", False):
        raise ValueError("latent attention (MLA) is served by KVSwapEngine only: this "
                         "full-cache path and its sequence-sharded attention keep K/V pairs")
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


def _group_scores(q_pred, k_lr, adapter, flushed: int, scfg: KVSwapServeConfig,
                  n_kv_heads: int, start: int = 0):
    """Eq. 1 over ``k_lr [B, n, r]`` (positions from ``start``): low-rank
    queries per head through the shared-K-head adapter slices, head-summed
    scores masked past ``flushed`` → ``[B, n // G]`` group maxima."""
    b, h, d = q_pred.shape
    g = scfg.group_size
    n = k_lr.shape[1]
    a_h = torch.repeat_interleave(adapter.reshape(n_kv_heads, d, -1), h // n_kv_heads, dim=0)
    q_lr = torch.einsum("bhd,hdr->bhr", q_pred, a_h)             # [B,H,r]
    scores = torch.einsum("bhr,bnr->bn", q_lr, k_lr)             # head-summed
    pos = torch.arange(n, device=k_lr.device) + start if start else \
        torch.arange(n, device=k_lr.device)
    scores = scores.masked_fill((pos >= flushed)[None, :], NEG)
    return scores[:, : (n // g) * g].reshape(b, n // g, g).amax(dim=-1)


def _selected_tokens(gsc, flushed: int, scfg: KVSwapServeConfig):
    """The top-M groups of ``gsc [B, n_groups]`` → their tokens ``[B, M·G]``
    and the tokens' mask (inside the flushed prefix, a valid selection)."""
    b = gsc.shape[0]
    g = scfg.group_size
    top_sc, gids = _top_groups(gsc, min(scfg.n_select, gsc.shape[1]))  # [B,M]
    sel_valid = top_sc > NEG / 2
    tok_idx = (gids[..., None] * g + torch.arange(g, device=gsc.device)).reshape(b, -1)
    tok_mask = (tok_idx < flushed) & torch.repeat_interleave(sel_valid, g, dim=-1)
    return tok_idx, tok_mask


def _attend_selected(q, ent, tok_idx, tok_mask, length: int, k_new, v_new,
                     scfg: KVSwapServeConfig, main_len: int | None):
    """Decode attention of ``q`` over the selected tokens of ``ent`` (plus
    the rolling buffer when ``main_len`` is given) and the new token."""
    b = q.shape[0]
    rows = torch.arange(b, device=q.device)[:, None]
    k_sel, v_sel = ent["k"][rows, tok_idx], ent["v"][rows, tok_idx]
    if main_len is not None:
        rb_mask = (torch.arange(scfg.rb_len, device=q.device) < length - main_len)
        k_sel = torch.cat([k_sel, ent["rb_k"]], dim=1)
        v_sel = torch.cat([v_sel, ent["rb_v"]], dim=1)
        tok_mask = torch.cat([tok_mask, rb_mask[None, :].expand(b, -1)], dim=1)
    return L.decode_attention(q, k_sel, v_sel, tok_mask, k_new, v_new)


# --------------------------------------------------------------------------
# prefill + serve_step
# --------------------------------------------------------------------------


def _write_prompt_kv(ent: dict, k: torch.Tensor, v: torch.Tensor, adapter, s: int) -> None:
    """``k/v [B, S, Hk, d]`` (and ``k_lr`` through ``adapter``) into the
    cache entry at ``[:, :S]``, in place."""
    b = k.shape[0]
    ent["k"][:, :s] = k
    ent["v"][:, :s] = v
    if adapter is not None:
        ent["k_lr"][:, :s] = k.reshape(b, s, -1) @ adapter


def _cache_layout(ent: dict):
    """``(placements of each cache tensor, batch axes, sequence axes)`` of a
    cache entry of DTensors: the mesh axes that split its batch and its
    sequence dim."""
    from torch.distributed.tensor import Shard

    pl = {key: t.placements for key, t in ent.items()}
    names = ent["k"].device_mesh.mesh_dim_names
    on = lambda dim: tuple(n for n, p in zip(names, pl["k"]) if isinstance(p, Shard)
                           and p.dim == dim) or None
    return pl, on(0), on(1)


def _write_prompt(ent: dict, k, v, adapter, s: int) -> None:
    """:func:`_write_prompt_kv` on each rank's shard of a DTensor cache (the
    prompt's K and V brought to the cache's layout first)."""
    def layout(mesh):
        pl, dp, _ = _cache_layout(ent)
        return [pl, pl["k"], pl["v"], P()], [None], {}

    local_region(functools.partial(_write_prompt_kv, s=s), (ent, k, v, adapter), layout)


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
        pe = W.sinusoid_positions(positions, cfg.d_model).to(params["embed"].dtype)
        x = rows(L.embed_lookup(params["embed"], tokens) + pe)
        ckv = W.cross_kv(params, cfg, enc_out)
    else:
        x = rows(L.embed_lookup(params["embed"], tokens))
    layers = cache["layers"]
    kv_idx = 0
    for i, kind in enumerate(_blocks(cfg)):
        if kind in ATTN_KINDS:
            if whisper:
                blk = params["dec_blocks"][i]
                o, k, v = L.attention(blk["attn"], L.layernorm(blk["ln1"], x), None,
                                      n_heads=cfg.n_heads, n_kv_heads=cfg.n_kv_heads,
                                      head_dim=cfg.head_dim, attend=L.causal_attention)
                x = x + like(L.linear_rows(o, blk["attn"]["wo"]), x)
                x = W.cross_and_mlp(blk, cfg, x, *ckv[i])
            else:
                x, _, (k, v) = T.block_forward(params, cfg, i, x, positions, return_kv=True)
            adapter = params["kvswap_adapters"][kv_idx] if kvswap is not None else None
            _write_prompt(layers[i], k, v, adapter, s)
            kv_idx += 1
        else:
            x, _, layers[i] = T.block_forward(params, cfg, i, x, positions, layers[i])
    if whisper:
        logits = L.linear_cols(L.layernorm(params["final_norm"], x)[:, -1], params["embed"].T)
    else:
        head = params["embed"].T if cfg.tie_embeddings else params["lm_head"]
        logits = L.linear_cols(L.rmsnorm(params["final_norm"], x)[:, -1], head)
    cache["length"] = s
    if kvswap is not None and kvswap.rolling:
        cache["main_len"] = s          # the whole prompt lives in the main cache
    return logits, cache


def _seq_shard_attn(q, q_pred, ent, adapter, length: int, k_new, v_new, *, scfg, n_kv_heads,
                    main_len, start: int, owner: bool, groups):
    """Decode attention over a cache whose sequence is split over ``groups``
    (mesh dims, major to minor), this rank holding ``[start, start +
    n_loc)``: the same selection as on one device (Eq. 1 group scores of
    every shard gathered, the global top M), each rank's partial
    flash-decode over its selected tokens (the rolling buffer and the new
    token on the ``owner``, which holds position ``length``), combined by
    :func:`repro_torch.serving.distributed.combine`."""
    from torch.distributed import _functional_collectives as funcol

    b, n_loc = ent["k"].shape[:2]
    if scfg is None:                        # full: every token of the shard
        k_sel, v_sel = ent["k"], ent["v"]
        mask = ((torch.arange(n_loc, device=q.device) + start) < length)[None].expand(b, -1)
    else:
        flushed = length if main_len is None else main_len
        gsc = _group_scores(q_pred, ent["k_lr"], adapter, flushed, scfg, n_kv_heads, start)
        for g in reversed(groups):          # minor axis first: shards in order
            gsc = funcol.all_gather_tensor(gsc, 1, g)
        tok_idx, tok_mask = _selected_tokens(gsc, flushed, scfg)
        mine = (tok_idx >= start) & (tok_idx < start + n_loc)
        idx, mask = (tok_idx - start).clamp(0, n_loc - 1), tok_mask & mine
        rows = torch.arange(b, device=q.device)[:, None]
        k_sel, v_sel = ent["k"][rows, idx], ent["v"][rows, idx]
    if main_len is not None:
        rb_mask = (torch.arange(scfg.rb_len, device=q.device) < length - main_len) & owner
        k_sel = torch.cat([k_sel, ent["rb_k"]], dim=1)
        v_sel = torch.cat([v_sel, ent["rb_v"]], dim=1)
        mask = torch.cat([mask, rb_mask[None, :].expand(b, -1)], dim=1)
    parts = shard_partial(q, k_sel, v_sel, mask, k_new, v_new, is_last=owner)
    return combine(*parts, [mesh.get_group(d) for mesh, d in groups]).to(q.dtype)


def _decode_attn_layer(qf, kf, vf, pos, norms, ent, adapter, qpf, *, length: int, main_len,
                       scfg, n_kv_heads: int, head_dim: int, rope_theta, qk_norm: bool,
                       h0: int = 0, hl: int | None = None, seq: dict | None = None):
    """One attention layer of :func:`serve_step` from the flat projections
    ``qf [B, H·d]``, ``kf/vf [B, Hk·d]`` (and ``qpf``, the prediction
    source's, or ``None``): heads, qk-norm and RoPE at ``pos``, attention
    over the cache entry ``ent`` (``full`` or ``kvswap``), and the new
    token's K/V written into ``ent`` in place → ``o [B, Hq·d]``.

    On a rank's shard (:func:`serve_step` on DTensors): ``ent`` holds its
    batch rows (or its slice of the sequence, ``seq``) with every KV head,
    the selection scores every head, and attention runs over the query
    heads ``[h0, h0 + hl)`` only."""
    b = qf.shape[0]
    q, k_new, v_new = (t.reshape(b, -1, head_dim) for t in (qf, kf, vf))
    rope = lambda t: L.apply_rope(t[:, None], pos[:, None], rope_theta)[:, 0]
    if qk_norm:
        q = L.rmsnorm(norms["q_norm"], q)
        k_new = L.rmsnorm(norms["k_norm"], k_new)
    if rope_theta is not None:
        q, k_new = rope(q), rope(k_new)
    q_pred = q
    if qpf is not None:                     # §3.3: score from the previous block's input
        q_pred = qpf.reshape(b, -1, head_dim)
        if qk_norm:
            q_pred = L.rmsnorm(norms["q_norm"], q_pred)
        if rope_theta is not None:
            q_pred = rope(q_pred)
    rolling = scfg is not None and scfg.rolling
    q_at, ent_at, kn_at, vn_at = q, ent, k_new, v_new
    if hl is not None and hl < q.shape[1]:  # this rank's query heads and their KV heads
        rep = q.shape[1] // k_new.shape[1]
        heads = lambda t: L.local_kv_heads(t, h0, hl, rep)
        q_at = q[:, h0:h0 + hl]
        ent_at = {key: heads(t) if key != "k_lr" else t for key, t in ent.items()}
        kn_at, vn_at = heads(k_new), heads(v_new)
    if seq is not None:
        o = _seq_shard_attn(q_at, q_pred, ent_at, adapter, length, kn_at, vn_at, scfg=scfg,
                            n_kv_heads=n_kv_heads, main_len=main_len if rolling else None,
                            **seq)
    elif scfg is not None:
        flushed = main_len if rolling else length
        gsc = _group_scores(q_pred, ent["k_lr"], adapter, flushed, scfg, n_kv_heads)
        tok_idx, tok_mask = _selected_tokens(gsc, flushed, scfg)
        o = _attend_selected(q_at, ent_at, tok_idx, tok_mask, length, kn_at, vn_at, scfg,
                             main_len if rolling else None)
    else:
        o = _full_decode_attn(q_at, ent_at, length, kn_at, vn_at)
    # append the new token's KV, in place
    start = 0 if seq is None else seq["start"]
    if rolling:
        ent["rb_k"][:, length - main_len] = k_new
        ent["rb_v"][:, length - main_len] = v_new
    elif seq is None or seq["owner"]:
        ent["k"][:, length - start] = k_new
        ent["v"][:, length - start] = v_new
        if scfg is not None:
            ent["k_lr"][:, length - start] = (k_new.reshape(b, 1, -1) @ adapter)[:, 0]
    return o.reshape(b, -1)


def _decode_attn(qf, kf, vf, pos, norms, ent, adapter, qpf, *, n_heads: int, **kw):
    """:func:`_decode_attn_layer`, on each rank's shard for a DTensor cache:
    rows over the cache's batch axes, every projection whole over
    ``model`` (the cache keeps every KV head, and the selection scores
    every query head), attention over this rank's query heads where
    ``model`` splits them, and a sequence split combined across ranks."""
    n_kv = kw["n_kv_heads"]

    def layout(mesh):
        pl, dp, seq_axes = _cache_layout(ent)
        _, hq, _, h0 = L.head_layout(mesh, qf.shape[0], n_heads, n_kv)
        if seq_axes is not None and "model" in seq_axes:
            hq, h0 = None, 0
        kwargs = {"h0": h0, "hl": n_heads // axis_size(mesh, hq)}
        if seq_axes is not None:
            n_loc = ent["k"].shape[1] // axis_size(mesh, seq_axes)
            start = axis_index(mesh, seq_axes) * n_loc
            kwargs["seq"] = {"start": start, "owner": start <= kw["length"] < start + n_loc,
                             "groups": [(mesh, mesh.mesh_dim_names.index(a)) for a in seq_axes]}
        row = P(dp)
        return [row, row, row, row, P(), pl, P(), row], P(dp, hq), kwargs

    return local_region(functools.partial(_decode_attn_layer, **kw),
                        (qf, kf, vf, pos, norms, ent, adapter, qpf), layout)


def serve_step(params, cfg, tokens: torch.Tensor, cache: dict, *,
               kvswap: KVSwapServeConfig | None = None, enc_out: torch.Tensor | None = None):
    """One decode step: ``tokens [B, 1]`` → ``(logits [B, V], cache)``.  The
    new token's KV goes into the cache in place (at ``[:, length]``, or into
    the rolling buffer), and ``length`` grows by one.  On DTensors each
    attention layer runs on each rank's shard (:func:`_decode_attn`)."""
    b = tokens.shape[0]
    length = cache["length"]
    main_len = cache.get("main_len")
    pos = torch.full((b,), length, dtype=torch.int32, device=tokens.device)
    whisper = _is_whisper(cfg)
    if whisper:
        pe = W.sinusoid_positions(pos, cfg.d_model).to(params["embed"].dtype)
        x = rows(L.embed_lookup(params["embed"], tokens[:, 0]) + pe)
    else:
        x = rows(L.embed_lookup(params["embed"], tokens[:, 0]))
    layers = cache["layers"]
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
            qk_norm = not whisper and cfg.qk_norm
            h = nb_norm(x)
            qf, kf, vf = (L.linear_cols(h, attn_p[w]) for w in ("wq", "wk", "wv"))
            predict_prev = kvswap is not None and kvswap.predict_from == "prev" and i > 0
            o = _decode_attn(
                qf, kf, vf, pos, {k: attn_p[k] for k in ("q_norm", "k_norm") if qk_norm},
                layers[i], params["kvswap_adapters"][kv_idx] if kvswap is not None else None,
                L.linear_cols(nb_norm(x_prev), attn_p["wq"]) if predict_prev else None,
                n_heads=cfg.n_heads, length=length, main_len=main_len, scfg=kvswap,
                n_kv_heads=cfg.n_kv_heads, head_dim=cfg.head_dim,
                rope_theta=None if whisper else cfg.rope_theta, qk_norm=qk_norm)
            x = x + like(L.linear_rows(o, attn_p["wo"]), x)
            if whisper:
                # this block's cross K/V, built here: one block's are live at a time
                x = W.cross_and_mlp(params["dec_blocks"][i], cfg, x, enc_out=enc_out)
            else:
                h2 = L.rmsnorm(mlp_holder["mlp_norm"], x)
                if kind == "moe_attn":    # one token a row, routed as a call of S = 1
                    x = x + like(T._ffn(params, cfg, i, mlp_holder, h2[:, None])[0][:, 0], x)
                else:
                    x = x + like(L.swiglu(mlp_holder["mlp"], h2), x)
            kv_idx += 1
        else:
            blk = params["blocks"][i]
            h = L.rmsnorm(blk["norm"], x)
            if kind == "mamba2":
                y, new = S.mamba2_step(blk["mamba"], h, layers[i])
            elif kind == "mlstm":
                y, new = S.mlstm_step(blk["mlstm"], h, layers[i])
            else:
                y, new = S.slstm_step(blk["slstm"], h, layers[i])
            for key, t in new.items():           # the state in place, as the KV
                layers[i][key].copy_(t)
            x = x + like(y, x)
        x_prev = x_in
    if whisper:
        logits = L.linear_cols(L.layernorm(params["final_norm"], x), params["embed"].T)
    else:
        head = params["embed"].T if cfg.tie_embeddings else params["lm_head"]
        logits = L.linear_cols(L.rmsnorm(params["final_norm"], x), head)
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
