"""Mamba2 (SSD) and xLSTM (mLSTM, sLSTM) blocks — the PyTorch port of
:mod:`repro.models.ssm`.

Mamba2 carries O(1) decode state (a causal-conv window and the SSD state
``h [B, H, P, N]``), so KVSwap's disk offloading does not apply to it; in a
hybrid model (Zamba2) the engine runs these blocks through its state path.

Prefill uses the chunked SSD formulation: within a chunk of Q tokens a
decayed quadratic form, the intra-chunk term, goes through
:func:`repro_torch.kernels.ops.ssd_chunk` (kernel C on the card, its plain
version on the CPU); across chunks the state is carried by a Python loop
over chunks.  The recurrence runs in fp32, as the reference's does.
Functions keep the reference's layouts (``[B, nc, Q, H, P]`` and so on),
and params are plain dicts of tensors in the reference's layout.

The xLSTM blocks (arXiv:2405.04517) carry O(1) state too: the mLSTM a
matrix memory ``c [B, H, d, d]`` with its normaliser and stabiliser, the
sLSTM a scalar memory with a true hidden recurrence.  Their full-sequence
forward is the reference's scan over time, as a Python loop over tokens
(no chunkwise-parallel form), and they launch no kernel.

On DTensor params the projections are tensor-parallel over ``model`` and
the mixers in between (Mamba2's conv and SSD, the xLSTM scans) run on each
rank's batch rows, whole over ``model`` (:func:`_state_region`,
:func:`_xlstm_region`); on plain tensors they run as written.
"""

from __future__ import annotations

import functools
import math

import torch
import torch.nn.functional as F

from repro_torch.kernels import ops
from repro_torch.models.layers import dense_init, linear_cols, linear_rows, rmsnorm
from repro_torch.sharding.partition import (P, axis_index, axis_size, batch_axes, local_region,
                                            split_axes)


def init_mamba2(*, generator: torch.Generator, device, d_model: int, d_state: int,
                d_conv: int = 4, expand: int = 2, head_p: int = 64,
                dtype=torch.float32) -> dict:
    """Random Mamba2 weights with the reference's scales: dense ``N(0,
    1/fan_in)``, ``conv_w`` ``N(0, 0.1²)``, ``a_log = log(linspace(1, H,
    H))``, ``dt_bias`` 0 and ``d_skip`` 1."""
    d_inner = expand * d_model
    n_heads = d_inner // head_p
    conv_dim = d_inner + 2 * d_state
    kw = dict(generator=generator, device=device, dtype=dtype)
    dense = lambda fan_in, fan_out: dense_init(fan_in, fan_out, **kw)
    return {
        # projects to [z (gate), x, B, C, dt]
        "in_proj": dense(d_model, 2 * d_inner + 2 * d_state + n_heads),
        "conv_w": torch.randn((conv_dim, d_conv), **kw).mul_(0.1),
        "conv_b": torch.zeros(conv_dim, device=device, dtype=dtype),
        "a_log": torch.log(torch.linspace(1.0, float(n_heads), n_heads,
                                          device=device, dtype=dtype)),
        "d_skip": torch.ones(n_heads, device=device, dtype=dtype),
        "dt_bias": torch.zeros(n_heads, device=device, dtype=dtype),
        "norm": {"scale": torch.ones(d_inner, device=device, dtype=dtype)},
        "out_proj": dense(d_inner, d_model),
    }


def mamba2_meta(p) -> dict:
    """Dims from the param shapes."""
    d_inner = p["norm"]["scale"].shape[0]
    d_conv = p["conv_w"].shape[1]
    d_state = (p["conv_w"].shape[0] - d_inner) // 2
    n_heads = p["a_log"].shape[0]
    return {"d_inner": d_inner, "n_heads": n_heads, "head_p": d_inner // n_heads,
            "d_state": d_state, "d_conv": d_conv}


def mamba2_init_state(p, batch: int, dtype=torch.float32) -> dict:
    m = mamba2_meta(p)
    dev = p["conv_w"].device
    return {
        "conv": torch.zeros((batch, m["d_inner"] + 2 * m["d_state"], m["d_conv"] - 1),
                            dtype=dtype, device=dev),
        "ssm": torch.zeros((batch, m["n_heads"], m["head_p"], m["d_state"]),
                           dtype=dtype, device=dev),
    }


def _causal_conv(p, xbc: torch.Tensor, conv_state: torch.Tensor | None = None):
    """Depthwise causal conv1d.  ``xbc [B, S, C]`` (+ optional carried state
    of the last ``d_conv-1`` inputs) → same shape + new state."""
    dk = mamba2_meta(p)["d_conv"]
    b, s, cdim = xbc.shape
    seq = xbc.transpose(1, 2)                                 # [B,C,S]
    pad = (torch.zeros((b, cdim, dk - 1), dtype=xbc.dtype, device=xbc.device)
           if conv_state is None else conv_state)
    full = torch.cat([pad, seq], dim=-1)                      # [B,C,S+dk-1]
    windows = full.unfold(-1, dk, 1)                          # [B,C,S,dk]
    out = torch.einsum("bcsk,ck->bcs", windows, p["conv_w"]) + p["conv_b"][None, :, None]
    out = F.silu(out).transpose(1, 2)                         # [B,S,C]
    # the carried window as a tensor of its own: a view would keep the whole
    # padded sequence [B, C, S + dk - 1] alive for as long as the state
    return out, full[:, :, -(dk - 1):].contiguous()


_MIXER = ("conv_w", "conv_b", "a_log", "d_skip", "dt_bias", "norm")


def _mixer(p) -> dict:
    return {k: p[k] for k in _MIXER}


def _state_region(fn, p, zxbcdt: torch.Tensor, state: dict, **kw):
    """``fn(mixer params, zxbcdt, state, **kw)`` → ``(y, state)`` on each
    rank's shard: ``in_proj``'s output arrives whole (its split into z, x,
    B, C and dt does not follow the ``model`` split of its columns), the
    rows over the batch axes; ``y [..., d_inner]`` comes back whole, and
    the state in the serving cache's layout (channels and heads over
    ``model``, :func:`~repro_torch.sharding.cache_pspecs`), each rank
    keeping its slice."""
    def layout(mesh):
        dp = split_axes(mesh, batch_axes(mesh), zxbcdt.shape[0])
        md = split_axes(mesh, "model", state["conv"].shape[1])
        mh = split_axes(mesh, "model", state["ssm"].shape[1])
        if md is None or mh is None:
            md = mh = None
        y = P(dp)
        st_in = {"conv": P(dp, None, None), "ssm": P(dp, None, None, None)}
        st_out = {"conv": P(dp, md, None), "ssm": P(dp, mh, None, None)}
        # every rank of ``model`` computes the same y: gradients are whole there
        return ([P(), y, st_in], [y, st_out["conv"], st_out["ssm"]],
                {"part": axis_index(mesh, md), "parts": axis_size(mesh, md)}, dp)

    return local_region(functools.partial(_keep_part, fn, **kw), (_mixer(p), zxbcdt, state),
                        layout)


def _keep_part(fn, pm, zxbcdt, state, *, part: int = 0, parts: int = 1, **kw):
    """``fn``'s ``(y, state)`` with the state cut to slice ``part`` of
    ``parts`` along its channel / head dim (the whole state for one part)."""
    y, st = fn(pm, zxbcdt, state, **kw)
    if parts > 1:
        st = {k: t.chunk(parts, dim=1)[part].contiguous() for k, t in st.items()}
    return y, st


def mamba2_forward(p, x: torch.Tensor, state: dict | None = None, *, chunk: int = 128):
    """Full-sequence forward.  ``x [B, S, D]`` → ``(y [B, S, D], state)``.

    Chunked SSD: the intra-chunk decayed quadratic form goes through
    :func:`repro_torch.kernels.ops.ssd_chunk`; the inter-chunk state
    ``h [B, H, P, N]`` is carried chunk by chunk.  The tail is zero-padded
    to a whole chunk (dt and log-decay 0, so padded tokens add nothing).
    On DTensors the mixer between ``in_proj`` and ``out_proj`` runs on each
    rank's rows (:func:`_state_region`).
    """
    if state is None:
        state = mamba2_init_state(p, x.shape[0], x.dtype)
    y, state = _state_region(_mamba2_mix, p, linear_cols(x, p["in_proj"]), state, chunk=chunk)
    return linear_rows(y, p["out_proj"]), state


def _mamba2_mix(p, zxbcdt: torch.Tensor, state: dict, *, chunk: int = 128):
    """The mixer of :func:`mamba2_forward` from ``in_proj``'s output
    ``[B, S, 2·d_inner + 2·N + H]`` to the gated, normed ``y [B, S,
    d_inner]``, and the new state."""
    m = mamba2_meta(p)
    nh, hp, ds = m["n_heads"], m["head_p"], m["d_state"]
    bsz, s, _ = zxbcdt.shape
    z, xc, bmat, cmat, dt = torch.split(zxbcdt, [m["d_inner"], m["d_inner"], ds, ds, nh], dim=-1)
    xbc = torch.cat([xc, bmat, cmat], dim=-1)
    xbc, conv_state = _causal_conv(p, xbc, state["conv"])
    xc, bmat, cmat = torch.split(xbc, [m["d_inner"], ds, ds], dim=-1)

    # SSD recurrence in float32: exp/cumsum chains underflow in bf16
    in_dtype = zxbcdt.dtype
    state_dtype = state["ssm"].dtype
    dt = F.softplus(dt.float() + p["dt_bias"].float())
    a = -torch.exp(p["a_log"].float())                        # [H] (negative)
    log_decay = dt * a[None, None, :]                         # [B,S,H]  (= log a_t)
    xh = xc.float().reshape(bsz, s, nh, hp)                   # [B,S,H,P]
    bmat = bmat.float()
    cmat = cmat.float()

    q = chunk
    pad = (-s) % q
    if pad:
        zpad = lambda t: F.pad(t, [0, 0] * (t.dim() - 2) + [0, pad])
        xh, bmat, cmat, dt, log_decay = map(zpad, (xh, bmat, cmat, dt, log_decay))
    nc = (s + pad) // q
    xh = xh.reshape(bsz, nc, q, nh, hp).contiguous()
    bm = bmat.reshape(bsz, nc, q, ds).contiguous()
    cm = cmat.reshape(bsz, nc, q, ds).contiguous()
    dtc = dt.reshape(bsz, nc, q, nh).contiguous()
    cum = torch.cumsum(log_decay.reshape(bsz, nc, q, nh), dim=2)   # [B,nc,q,H]

    y_intra = ops.ssd_chunk(xh, bm, cm, dtc, cum)

    # inter-chunk state scan
    chunk_decay = torch.exp(cum[:, :, -1])                    # [B,nc,H] total decay
    # contribution of each in-chunk token to the end-of-chunk state
    tail = torch.exp(cum[:, :, -1:, :] - cum)                 # [B,nc,q,H]
    db = (dtc * tail)[..., None] * bm[:, :, :, None, :]       # [B,nc,q,H,N]
    chunk_state = torch.einsum("bkqhn,bkqhp->bkhpn", db, xh)  # [B,nc,H,P,N]
    h = state["ssm"].float()
    h_starts = []
    for c in range(nc):
        h_starts.append(h)
        h = chunk_decay[:, c, :, None, None] * h + chunk_state[:, c]
    h_starts = torch.stack(h_starts, dim=1)                   # [B,nc,H,P,N]
    inter_decay = torch.exp(cum)                              # decay from chunk start
    y_inter = torch.einsum("bnqs,bnhps->bnqhp", cm, h_starts) * inter_decay[..., None]

    y = (y_intra + y_inter).reshape(bsz, nc * q, nh, hp)[:, :s]
    y = y + xc.float().reshape(bsz, s, nh, hp) * p["d_skip"].float()[None, None, :, None]
    y = y.reshape(bsz, s, nh * hp).to(in_dtype)
    y = rmsnorm(p["norm"], y * F.silu(z))
    return y, {"conv": conv_state, "ssm": h.to(state_dtype)}


def mamba2_step(p, x: torch.Tensor, state: dict):
    """Single-token decode.  ``x [B, D]`` → ``(y [B, D], state)``."""
    y, state = _state_region(_mamba2_step_mix, p, linear_cols(x[:, None], p["in_proj"]), state)
    return linear_rows(y, p["out_proj"]), state


def _mamba2_step_mix(p, zxbcdt: torch.Tensor, state: dict):
    """The mixer of :func:`mamba2_step` from ``in_proj``'s output ``[B, 1,
    ·]`` to ``y [B, d_inner]`` and the new state."""
    m = mamba2_meta(p)
    nh, hp, ds = m["n_heads"], m["head_p"], m["d_state"]
    bsz = zxbcdt.shape[0]
    z, xc, bmat, cmat, dt = torch.split(zxbcdt, [m["d_inner"], m["d_inner"], ds, ds, nh], dim=-1)
    xbc = torch.cat([xc, bmat, cmat], dim=-1)[:, 0]           # [B,C]
    conv = torch.cat([state["conv"], xbc[:, :, None]], dim=-1)   # [B,C,dk]
    out = F.silu(torch.einsum("bck,ck->bc", conv, p["conv_w"]) + p["conv_b"])
    xc1, b1, c1 = torch.split(out, [m["d_inner"], ds, ds], dim=-1)

    dt1 = F.softplus(dt[:, 0] + p["dt_bias"])                 # [B,H]
    a = -torch.exp(p["a_log"])
    decay = torch.exp(dt1 * a[None, :])                       # [B,H]
    xh = xc1.reshape(bsz, nh, hp)
    h = decay[..., None, None] * state["ssm"] + \
        (dt1[..., None, None] * xh[..., None]) * b1[:, None, None, :]
    y = torch.einsum("bhpn,bn->bhp", h, c1) + xh * p["d_skip"][None, :, None]
    y = y.reshape(bsz, nh * hp)
    y = rmsnorm(p["norm"], y * F.silu(z[:, 0]))
    return y, {"conv": conv[:, :, 1:], "ssm": h}


# --------------------------------------------------------------------------
# xLSTM: mLSTM (matrix memory) and sLSTM (scalar memory, hidden recurrence)
# --------------------------------------------------------------------------


def init_mlstm(*, generator: torch.Generator, device, d_model: int, n_heads: int,
               dtype=torch.float32) -> dict:
    """Random mLSTM weights with the reference's scales: Q, K, V and O
    ``N(0, 1/d_model)``, the gate projection ``N(0, 0.02²)``, input-gate
    bias 0 and forget-gate bias 3."""
    kw = dict(generator=generator, device=device, dtype=dtype)
    return {
        "wq": dense_init(d_model, d_model, **kw),
        "wk": dense_init(d_model, d_model, **kw),
        "wv": dense_init(d_model, d_model, **kw),
        "w_if": dense_init(d_model, 2 * n_heads, scale=0.02, **kw),
        "b_if": torch.cat([torch.zeros(n_heads, device=device, dtype=dtype),
                           torch.full((n_heads,), 3.0, device=device, dtype=dtype)]),
        "wo": dense_init(d_model, d_model, **kw),
        "norm": {"scale": torch.ones(d_model // n_heads, device=device, dtype=dtype)},
    }


def mlstm_meta(p) -> dict:
    n_heads = p["b_if"].shape[0] // 2
    return {"n_heads": n_heads, "head_dim": p["wq"].shape[0] // n_heads}


def mlstm_init_state(p, batch: int, dtype=torch.float32) -> dict:
    m = mlstm_meta(p)
    h, d = m["n_heads"], m["head_dim"]
    dev = p["wq"].device
    return {
        "c": torch.zeros((batch, h, d, d), dtype=dtype, device=dev),   # matrix memory
        "n": torch.zeros((batch, h, d), dtype=dtype, device=dev),      # normaliser
        "m": torch.full((batch, h), float("-inf"), dtype=dtype, device=dev),  # stabiliser
    }


def _mlstm_gates(p, x: torch.Tensor):
    h = mlstm_meta(p)["n_heads"]
    g = x @ p["w_if"] + p["b_if"]
    return g[..., :h], g[..., h:]          # pre-activation i, f


def _promote(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a`` in the dtype ``a`` and ``b`` promote to (bf16 activations
    against an fp32 state compute in fp32, as ``jnp`` promotes them)."""
    return a.to(torch.promote_types(a.dtype, b.dtype))


def _mlstm_cell(p, state: dict, q, k, v, i_pre, f_pre):
    """One step.  ``q, k, v [B,H,d]``; ``i_pre, f_pre [B,H]``."""
    d = q.shape[-1]
    m_prev = state["m"]
    logf = -F.softplus(-f_pre)                          # log sigmoid(f)
    m_new = torch.maximum(logf + m_prev, i_pre)
    i = torch.exp(i_pre - m_new)
    f = torch.exp(logf + m_prev - m_new)
    k_s = k / math.sqrt(d)
    c = f[..., None, None] * state["c"] + i[..., None, None] * (k_s[..., :, None] * v[..., None, :])
    n = f[..., None] * state["n"] + i[..., None] * k_s
    denom = torch.maximum(torch.einsum("bhd,bhd->bh", n, _promote(q, n)).abs(), torch.exp(-m_new))
    y = torch.einsum("bhd,bhde->bhe", _promote(q, c), c) / denom[..., None]
    return {"c": c, "n": n, "m": m_new}, y


def _xlstm_region(fn, args: tuple, state: dict):
    """``fn(*args, state)`` → ``(y, state)`` on each rank's rows: every
    tensor of ``args`` whole over ``model`` (the heads do not divide it),
    the rows of ``args``, ``state`` and ``y`` over the batch axes."""
    def layout(mesh):
        dp = split_axes(mesh, batch_axes(mesh), next(iter(state.values())).shape[0])
        return [P()] + [P(dp)] * (len(args) - 1) + [P(dp)], [P(dp)] * (1 + len(state)), {}

    return local_region(fn, args + (state,), layout)


def mlstm_forward(p, x: torch.Tensor, state: dict | None = None):
    """``x [B,S,D]`` → ``(y [B,S,D], state)``, one token at a time (on
    DTensors the scan runs on each rank's rows, :func:`_xlstm_region`)."""
    if state is None:
        state = mlstm_init_state(p, x.shape[0])
    q, k, v = (linear_cols(x, p[w]) for w in ("wq", "wk", "wv"))
    ip, fp = _mlstm_gates(p, x)                         # [B,S,H]
    ys, state = _xlstm_region(_mlstm_scan, (p["norm"], q, k, v, ip, fp), state)
    return linear_rows(ys, p["wo"]), state


def _mlstm_scan(norm, q, k, v, ip, fp, state: dict):
    """The token loop of :func:`mlstm_forward` from the flat projections
    ``q/k/v [B,S,D]`` and gate pre-activations ``[B,S,H]`` to the normed
    ``ys [B,S,D]`` before ``wo``."""
    bsz, s, dmod = q.shape
    h = ip.shape[-1]
    q, k, v = (t.reshape(bsz, s, h, dmod // h) for t in (q, k, v))
    ys = []
    for t in range(s):
        state, y = _mlstm_cell(None, state, q[:, t], k[:, t], v[:, t], ip[:, t], fp[:, t])
        ys.append(y)
    ys = rmsnorm(norm, torch.stack(ys, dim=1)).reshape(bsz, s, dmod)
    return ys, state


def mlstm_step(p, x: torch.Tensor, state: dict):
    """Single-token decode.  ``x [B, D]`` → ``(y [B, D], state)``."""
    q, k, v = (linear_cols(x, p[w]) for w in ("wq", "wk", "wv"))
    ip, fp = _mlstm_gates(p, x)
    y, state = _xlstm_region(_mlstm_step_local, (p["norm"], q, k, v, ip, fp), state)
    return linear_rows(y, p["wo"]), state


def _mlstm_step_local(norm, q, k, v, ip, fp, state: dict):
    bsz, dmod = q.shape
    h = ip.shape[-1]
    q, k, v = (t.reshape(bsz, h, dmod // h) for t in (q, k, v))
    state, y = _mlstm_cell(None, state, q, k, v, ip, fp)
    return rmsnorm(norm, y).reshape(bsz, dmod), state


def init_slstm(*, generator: torch.Generator, device, d_model: int, n_heads: int,
               dtype=torch.float32) -> dict:
    """Random sLSTM weights with the reference's scales: the input
    projection to ``[z, i, f, o]`` and O ``N(0, 1/d_model)``, the hidden
    projection ``N(0, 0.02²)``, bias 0."""
    kw = dict(generator=generator, device=device, dtype=dtype)
    return {
        "w_x": dense_init(d_model, 4 * d_model, **kw),
        "w_h": dense_init(d_model, 4 * d_model, scale=0.02, **kw),
        "b": torch.zeros(4 * d_model, device=device, dtype=dtype),
        "norm": {"scale": torch.ones(d_model // n_heads, device=device, dtype=dtype)},
        "wo": dense_init(d_model, d_model, **kw),
    }


def slstm_meta(p) -> dict:
    hd = p["norm"]["scale"].shape[0]
    return {"n_heads": p["w_x"].shape[0] // hd, "head_dim": hd}


def slstm_init_state(p, batch: int, dtype=torch.float32) -> dict:
    m = slstm_meta(p)
    shape = (batch, m["n_heads"], m["head_dim"])
    dev = p["w_x"].device
    zeros = lambda: torch.zeros(shape, dtype=dtype, device=dev)
    return {"c": zeros(), "n": zeros(), "h": zeros(),
            "m": torch.full(shape[:2], float("-inf"), dtype=dtype, device=dev)}


def _slstm_cell(p, state: dict, x_t: torch.Tensor):
    m = slstm_meta(p)
    nh, hds = m["n_heads"], m["head_dim"]
    bsz, dmod = x_t.shape
    h_prev = state["h"].reshape(bsz, dmod)
    g = x_t @ p["w_x"] + _promote(h_prev, p["w_h"]) @ _promote(p["w_h"], h_prev) + p["b"]
    z, i_pre, f_pre, o = g.chunk(4, dim=-1)
    rs = lambda t: t.reshape(bsz, nh, hds)
    z, o = torch.tanh(rs(z)), torch.sigmoid(rs(o))
    # exponential gating with a per-head stabiliser (head-mean pre-activations)
    i_h = rs(i_pre).mean(-1)
    f_h = rs(f_pre).mean(-1)
    logf = -F.softplus(-f_h)
    m_new = torch.maximum(logf + state["m"], i_h)
    i = torch.exp(i_h - m_new)[..., None]
    f = torch.exp(logf + state["m"] - m_new)[..., None]
    c = f * state["c"] + i * z
    n = f * state["n"] + i
    h_new = o * (c / torch.clamp_min(n, 1.0))
    return {"c": c, "n": n, "h": h_new, "m": m_new}, h_new


_SLSTM = ("w_x", "w_h", "b", "norm")


def slstm_forward(p, x: torch.Tensor, state: dict | None = None):
    """``x [B,S,D]`` → ``(y [B,S,D], state)``, one token at a time (on
    DTensors the scan runs on each rank's rows, :func:`_xlstm_region`)."""
    if state is None:
        state = slstm_init_state(p, x.shape[0])
    hs, state = _xlstm_region(_slstm_scan, ({k: p[k] for k in _SLSTM}, x), state)
    return linear_rows(hs, p["wo"]), state


def _slstm_scan(p, x: torch.Tensor, state: dict):
    bsz, s, dmod = x.shape
    hs = []
    for t in range(s):
        state, h = _slstm_cell(p, state, x[:, t])
        hs.append(h)
    return rmsnorm(p["norm"], torch.stack(hs, dim=1)).reshape(bsz, s, dmod), state


def slstm_step(p, x: torch.Tensor, state: dict):
    """Single-token decode.  ``x [B, D]`` → ``(y [B, D], state)``."""
    h, state = _xlstm_region(_slstm_step_local, ({k: p[k] for k in _SLSTM}, x), state)
    return linear_rows(h, p["wo"]), state


def _slstm_step_local(p, x: torch.Tensor, state: dict):
    state, h = _slstm_cell(p, state, x)
    return rmsnorm(p["norm"], h).reshape(x.shape[0], -1), state
