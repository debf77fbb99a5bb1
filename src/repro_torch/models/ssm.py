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
sLSTM a scalar memory with a true hidden recurrence.  The mLSTM's
full-sequence forward is chunkwise (:func:`mlstm_chunkwise`: the
reference's scan within rtol 1e-4; the token loop stays as
:func:`mlstm_forward_tokens`); the sLSTM's recurrence runs a token at a
time through one fused cell with its own gradient.  They launch no kernel.

On DTensor params the projections are tensor-parallel over ``model`` and
the mixers in between run on each rank's shard: Mamba2's conv and SSD over
heads (:func:`_mix_region`), the xLSTM cells over each head's columns
(:func:`head_slices`), the decode steps' cells whole on every rank
(:func:`_state_region`, :func:`_xlstm_region`), as the serving cache keeps
their state; on plain tensors they run as written.
"""

from __future__ import annotations

import functools
import math

import torch
import torch.nn.functional as F

from repro_torch.kernels import ops
from repro_torch.models.layers import (dense_init, linear_cols, linear_rows, moves_activations,
                                       rmsnorm)
from repro_torch.sharding.partition import (P, axis_index, axis_size, batch_axes, gather_over,
                                            local_region, mesh_of, split_axes, sum_over)


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
    dk = p["conv_w"].shape[1]
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


def _mix_region(p, zxbcdt: torch.Tensor, state: dict, *, chunk: int):
    """:func:`_mamba2_mix` on each rank's shard, split over ``model`` by
    heads as the SSM state is: each rank convolves its heads' x channels
    (and B, C, which every head reads), runs the SSD over its heads and
    returns its columns of ``y [..., d_inner]``, the gated norm's sum of
    squares summed over ``model`` (:func:`_mamba2_mix`'s ``split``).  The
    conv state comes back in the cache's layout.  Where the heads do not
    divide ``model``, every rank runs the whole mixer
    (:func:`_state_region`)."""
    n_heads, conv_dim = state["ssm"].shape[1], state["conv"].shape[1]

    def layout(mesh):
        dp = split_axes(mesh, batch_axes(mesh), zxbcdt.shape[0])
        md = split_axes(mesh, "model", conv_dim)
        mh = split_axes(mesh, "model", n_heads)
        parts = axis_size(mesh, mh)
        hl = n_heads // parts
        return ([P(), P(dp), {"conv": P(dp, None, None), "ssm": P(dp, mh, None, None)}],
                [P(dp, None, mh), P(dp, md, None), P(dp, mh, None, None)],
                {"chunk": chunk,
                 "split": (mesh, axis_index(mesh, mh) * hl, hl, axis_index(mesh, md),
                           axis_size(mesh, md))})

    mesh = mesh_of((zxbcdt, state))
    if (mesh is None or split_axes(mesh, "model", n_heads) is None
            or split_axes(mesh, "model", conv_dim) is None):
        return _state_region(_mamba2_mix, p, zxbcdt, state, chunk=chunk)
    return local_region(_mamba2_mix, (_mixer(p), zxbcdt, state), layout)


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
    y, state = _mix_region(p, linear_cols(x, p["in_proj"]), state, chunk=chunk)
    return linear_rows(y, p["out_proj"]), state


def _mamba2_mix(p, zxbcdt: torch.Tensor, state: dict, *, chunk: int = 128,
                split: tuple | None = None):
    """The mixer of :func:`mamba2_forward` from ``in_proj``'s output
    ``[B, S, 2·d_inner + 2·N + H]`` to the gated, normed ``y [B, S,
    d_inner]``, and the new state.

    With ``split = (mesh, h0, hl, part, parts)`` (:func:`_mix_region`) only
    heads ``[h0, h0 + hl)`` run: ``state["ssm"]`` holds those heads,
    ``state["conv"]`` every channel; ``y`` is those heads' columns, the
    norm's sum of squares summed over ``model``, and the conv state comes
    back as slice ``part`` of ``parts`` of every channel (gathered over
    ``model``)."""
    m = mamba2_meta(p)
    nh, hp, ds, di = m["n_heads"], m["head_p"], m["d_state"], m["d_inner"]
    bsz, s, _ = zxbcdt.shape
    z, xc, bmat, cmat, dt = torch.split(zxbcdt, [di, di, ds, ds, nh], dim=-1)
    conv_p, conv_in = p, state["conv"]
    if split is not None:
        mesh, h0, nh, part, parts = split
        c0, cl = h0 * hp, nh * hp
        z, xc, dt = z[..., c0:c0 + cl], xc[..., c0:c0 + cl], dt[..., h0:h0 + nh]
        chans = torch.cat([torch.arange(c0, c0 + cl), torch.arange(di, di + 2 * ds)]).to(
            zxbcdt.device)
        conv_p = {"conv_w": p["conv_w"][chans], "conv_b": p["conv_b"][chans]}
        conv_in = conv_in[:, chans]
        p = {"a_log": p["a_log"][h0:h0 + nh], "dt_bias": p["dt_bias"][h0:h0 + nh],
             "d_skip": p["d_skip"][h0:h0 + nh], "norm": {"scale": p["norm"]["scale"][c0:c0 + cl]}}
        di = cl
    xbc = torch.cat([xc, bmat, cmat], dim=-1)
    xbc, conv_state = _causal_conv(conv_p, xbc, conv_in)
    xc, bmat, cmat = torch.split(xbc, [di, ds, ds], dim=-1)

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
    if split is None:
        y = rmsnorm(p["norm"], y * F.silu(z))
        return y, {"conv": conv_state, "ssm": h.to(state_dtype)}
    g = (y * F.silu(z)).float()
    var = sum_over(g.square().sum(dim=-1, keepdim=True), mesh, "model") / m["d_inner"]
    y = (g * torch.rsqrt(var + 1e-6) * p["norm"]["scale"].float()).to(y.dtype)
    # every channel's window (B and C are each rank's own), cut to the cache's slice
    conv_x = gather_over(conv_state[:, :cl], mesh, "model", 1)
    conv_state = torch.cat([conv_x, conv_state[:, cl:]], dim=1).chunk(parts, dim=1)[part]
    return y, {"conv": conv_state.contiguous(), "ssm": h.to(state_dtype)}


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
    tensor of ``args`` whole over ``model``, the rows of ``args``,
    ``state`` and ``y`` over the batch axes (the decode steps: the state
    is whole on every rank, as the serving cache keeps it)."""
    def layout(mesh):
        dp = split_axes(mesh, batch_axes(mesh), next(iter(state.values())).shape[0])
        return [P()] + [P(dp)] * (len(args) - 1) + [P(dp)], [P(dp)] * (1 + len(state)), {}

    return local_region(fn, args + (state,), layout)


def head_slices(mesh, n_heads: int, width: int):
    """How a ``model`` split of ``n_heads · head`` columns ``width`` wide
    falls on heads: ``(h0, nh, e0, el)``, this rank's heads ``[h0, h0 +
    nh)`` and their columns ``[e0, e0 + el)`` (whole heads, or one head's
    slice), or ``None`` where the columns do not split that way."""
    m = axis_size(mesh, "model")
    head = width // n_heads
    if m == 1 or width % m:
        return None
    cl, r = width // m, axis_index(mesh, "model")
    if cl % head == 0:
        return r * (cl // head), cl // head, 0, head
    if head % cl == 0:
        return r // (head // cl), 1, (r % (head // cl)) * cl, cl
    return None


def _head_sum(t: torch.Tensor, split: tuple, n_heads: int) -> torch.Tensor:
    """``t [..., nh]``, sums over this rank's columns of its heads, → the
    sums over each head's whole width: where the rank holds one head's
    slice, a zero-padded ``[..., H]`` summed over ``model`` (the ranks that
    share the head)."""
    mesh, h0, nh, e0, el, head = split
    if el == head:
        return t
    return sum_over(F.pad(t, (h0, n_heads - h0 - nh)), mesh, "model")[..., h0:h0 + nh]


def mlstm_forward(p, x: torch.Tensor, state: dict | None = None, *, chunk: int = 64):
    """``x [B,S,D]`` → ``(y [B,S,D], state)`` through the chunkwise form
    (:func:`mlstm_chunkwise`).  On DTensors each rank runs its columns of
    ``v`` (a head's slice of the matrix memory's value dim, or whole
    heads) with the queries and keys of their heads; the head's norm sums
    over the ranks that share it, and the state comes back whole."""
    if state is None:
        state = mlstm_init_state(p, x.shape[0])
    q, k, v = (linear_cols(x, p[w]) for w in ("wq", "wk", "wv"))
    ip, fp = _mlstm_gates(p, x)                         # [B,S,H]
    n_heads, width = ip.shape[-1], v.shape[-1]

    def layout(mesh):
        dp = split_axes(mesh, batch_axes(mesh), x.shape[0])
        heads = head_slices(mesh, n_heads, width)
        if heads is None:
            return [P()] + [P(dp)] * 6, [P(dp)] * 4, {}
        return ([P(), P(dp), P(dp), P(dp, None, "model"), P(dp), P(dp), P(dp)],
                [P(dp, None, "model")] + [P(dp)] * 3,
                {"split": (mesh, *heads, width // n_heads)})

    ys, state = local_region(functools.partial(_mlstm_local, chunk=chunk),
                             (p["norm"], q, k, v, ip, fp, state), layout)
    return linear_rows(ys, p["wo"]), state


def _mlstm_local(norm, q, k, v, ip, fp, state: dict, *, chunk: int, split: tuple | None = None):
    """:func:`mlstm_forward` between the projections and ``wo`` on one
    rank: ``q/k [B,S,D]``, ``v [B,S,·]`` (its columns), gates ``[B,S,H]``,
    the whole state → ``(ys [B,S,·]`` normed, the whole new state).  With
    ``split = (mesh, h0, nh, e0, el, head)`` only heads ``[h0, h0 + nh)``
    and value columns ``[e0, e0 + el)`` of each run."""
    bsz, s, dmod = q.shape
    h = ip.shape[-1]
    hd = dmod // h
    q, k = (t.reshape(bsz, s, h, hd) for t in (q, k))
    out_dtype = torch.promote_types(q.dtype, state["c"].dtype)
    if split is None:
        y, new = mlstm_chunkwise(q, k, v.reshape(bsz, s, h, hd), ip, fp, state, chunk=chunk)
        y = rmsnorm(norm, y.to(out_dtype)).reshape(bsz, s, dmod)
        return y.to(q.dtype), new
    mesh, h0, nh, e0, el, _ = split
    hs = slice(h0, h0 + nh)
    st = {"c": state["c"][:, hs, :, e0:e0 + el], "n": state["n"][:, hs], "m": state["m"][:, hs]}
    y, new = mlstm_chunkwise(q[:, :, hs], k[:, :, hs], v.reshape(bsz, s, nh, el), ip[..., hs],
                             fp[..., hs], st, chunk=chunk)
    yf = y.to(out_dtype).float()
    var = _head_sum(yf.square().sum(dim=-1), split, h) / hd        # [B,S,nh]
    y = yf * torch.rsqrt(var + 1e-6)[..., None] * norm["scale"][e0:e0 + el].float()
    y = y.to(out_dtype).reshape(bsz, s, nh * el).to(q.dtype)
    # the whole state on every rank: each rank's block of the memory, and
    # the normaliser and stabiliser of each head (every rank of a head has them)
    c = gather_over(new["c"], mesh, "model", -1 if el < hd else 1)
    if el < hd:
        c = c.reshape(bsz, hd, h, hd).transpose(1, 2)
    g = hd // el
    n = gather_over(new["n"], mesh, "model", 1)[:, ::g]
    m = gather_over(new["m"], mesh, "model", 1)[:, ::g]
    return y, {"c": c.contiguous(), "n": n.contiguous(), "m": m.contiguous()}


def mlstm_chunkwise(q, k, v, ip, fp, state: dict, *, chunk: int = 64):
    """The mLSTM recurrence (:func:`_mlstm_cell`) over a sequence in
    chunks → ``(h [B,S,H,e]`` before the head norm, in fp32, the new
    state in the state's dtypes).  ``q, k [B,S,H,d]``, ``v [B,S,H,e]``,
    ``ip, fp [B,S,H]``; ``state`` ``c [B,H,d,e]``, ``n [B,H,d]``, ``m
    [B,H]``.

    With ``b_t`` the cumulative log forget gate within a chunk and ``m0``
    the stabiliser carried in, token ``t``'s stabiliser is ``m_t = max(b_t
    + m0, max_{s≤t} b_t − b_s + i_s)`` — the recurrence ``max(log f_t +
    m_{t−1}, i_t)`` unrolled — and its output is the stabilised quadratic
    form over the chunk's keys plus the carried memory's term, both scaled
    by ``exp(· − m_t)``.  Across chunks ``(c, n, m)`` is carried as
    :func:`mamba2_forward` carries ``h``.  A tail shorter than a chunk is
    padded with tokens whose input gate is ``−inf`` (they add nothing) and
    whose forget gate is 1."""
    bsz, s, nh, d = q.shape
    f32 = torch.float32
    pad = (-s) % chunk
    nc = (s + pad) // chunk
    k = k / math.sqrt(d)

    def blocks(t):                                   # [B,S,H,·] → [B,H,nc,L,·]
        t = F.pad(t.to(f32), (0, 0, 0, 0, 0, pad))
        return t.reshape(bsz, nc, chunk, nh, -1).permute(0, 3, 1, 2, 4)

    qc, kc, vc = blocks(q), blocks(k), blocks(v)
    logf = F.pad(-F.softplus(-fp.to(f32)), (0, 0, 0, pad))
    ig = F.pad(ip.to(f32), (0, 0, 0, pad), value=float("-inf"))
    logf = logf.reshape(bsz, nc, chunk, nh).permute(0, 3, 1, 2)      # [B,H,nc,L]
    ig = ig.reshape(bsz, nc, chunk, nh).permute(0, 3, 1, 2)
    b = torch.cumsum(logf, dim=-1)
    tri = torch.ones(chunk, chunk, dtype=torch.bool, device=q.device).tril()
    dmat = (b[..., :, None] - b[..., None, :] + ig[..., None, :]).masked_fill(~tri, float("-inf"))

    # each chunk's own contribution to the memory at its end, stabilised by
    # lmax; the normaliser rides along as the memory's last value column
    wend = b[..., -1:] - b + ig                                        # [B,H,nc,L]
    lmax = wend.amax(dim=-1)                                           # [B,H,nc]
    wk = kc * torch.exp(wend - lmax[..., None])[..., None]
    cn_loc = wk.transpose(-1, -2) @ F.pad(vc, (0, 1), value=1.0)       # [B,H,nc,d,e+1]

    # the stabiliser at each chunk's end, unrolled as within a chunk:
    # m_c = B_c + max(m0, max_{j≤c} lmax_j − B_j), B the inclusive cumsum of
    # the chunks' total log decay
    bl = b[..., -1]
    bi = torch.cumsum(bl, dim=-1)
    m_in = state["m"].to(f32)
    m_end = bi + torch.maximum(m_in[..., None], torch.cummax(lmax - bi, dim=-1).values)
    m0 = torch.cat([m_in[..., None], m_end[..., :-1]], dim=-1)         # at each chunk's start
    fa = torch.exp(bl + m0 - m_end)[..., None, None]
    fb = torch.exp(lmax - m_end)[..., None, None]
    cn = torch.cat([state["c"].to(f32), state["n"].to(f32)[..., None]], dim=-1)
    starts = []
    for fa_c, fb_c, cn_c in zip(fa.unbind(2), fb.unbind(2), cn_loc.unbind(2)):
        starts.append(cn)
        cn = torch.addcmul(fa_c * cn, fb_c, cn_c)
    cn0 = torch.stack(starts, dim=2)                                   # [B,H,nc,d,e+1]
    c, n, m = cn[..., :-1], cn[..., -1], m_end[..., -1]

    g = b + m0[..., None]                                              # carried-in weight
    mt = torch.maximum(g, dmat.amax(dim=-1))                           # [B,H,nc,L]
    sc = (qc @ kc.transpose(-1, -2)) * torch.exp(dmat - mt[..., None])
    inter = torch.exp(g - mt)
    num = F.pad(sc @ vc, (0, 1)) + F.pad(sc.sum(dim=-1, keepdim=True), (vc.shape[-1], 0))
    num = num + inter[..., None] * (qc @ cn0)                          # [..., e+1]: y, q·n
    y = num[..., :-1] / torch.maximum(num[..., -1].abs(), torch.exp(-mt))[..., None]
    y = y.permute(0, 2, 3, 1, 4).reshape(bsz, nc * chunk, nh, -1)[:, :s]
    return y, {"c": c.to(state["c"].dtype), "n": n.to(state["n"].dtype),
               "m": m.to(state["m"].dtype)}


def mlstm_forward_tokens(p, x: torch.Tensor, state: dict | None = None):
    """:func:`mlstm_forward` one token at a time through :func:`_mlstm_cell`
    (the reference's scan; the plain oracle of :func:`mlstm_chunkwise`)."""
    if state is None:
        state = mlstm_init_state(p, x.shape[0])
    bsz, s, dmod = x.shape
    h = mlstm_meta(p)["n_heads"]
    q, k, v = ((x @ p[w]).reshape(bsz, s, h, dmod // h) for w in ("wq", "wk", "wv"))
    ip, fp = _mlstm_gates(p, x)
    ys = []
    for t in range(s):
        state, y = _mlstm_cell(None, state, q[:, t], k[:, t], v[:, t], ip[:, t], fp[:, t])
        ys.append(y)
    ys = rmsnorm(p["norm"], torch.stack(ys, dim=1)).reshape(bsz, s, dmod)
    return ys @ p["wo"], state


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


_SLSTM = ("w_x", "w_h", "b", "norm")


def slstm_forward(p, x: torch.Tensor, state: dict | None = None):
    """``x [B,S,D]`` → ``(y [B,S,D], state)``: the input projection ``x @
    w_x`` for every token at once, then the recurrence one token at a time
    (:func:`_slstm_scan`).  On DTensors each rank runs its columns of every
    gate (:func:`head_slices` of ``D``), the hidden state gathered over
    ``model`` each token, the i and f gates' head means summed over the
    ranks that share a head; the state comes back whole.  Many tokens bring
    the weights to that layout, by one all-to-all each; a few tokens
    (:func:`~repro_torch.models.layers.moves_activations`) leave the
    weights where they are and bring each token's pre-activations there
    instead, by one all-to-all a token."""
    if state is None:
        state = slstm_init_state(p, x.shape[0])
    n_heads, d = state["m"].shape[1], x.shape[-1]

    def layout(mesh):
        dp = split_axes(mesh, batch_axes(mesh), x.shape[0])
        heads = head_slices(mesh, n_heads, d)
        cols = split_axes(mesh, "model", 4 * d)
        if heads is None or cols is None:
            return [P()] * 4 + [P(dp), P(dp)], [P(dp)] * 5, {}
        w = P(None, "model")
        tokens = x.shape[0] // axis_size(mesh, dp) * x.shape[1]
        acts = moves_activations(mesh, tokens, p["w_x"], 1, 4 * d // axis_size(mesh, "model"),
                                 axis="model")
        return ([w, w, P(), P(), P(dp), P(dp)], [P(dp, None, "model")] + [P(dp)] * 4,
                {"split": (mesh, *heads, d // n_heads), "acts": acts})

    hs, state = local_region(_slstm_scan, (*(p[k] for k in _SLSTM), x, state), layout)
    return linear_rows(hs, p["wo"]), state


def _to_gates(t: torch.Tensor, mesh) -> torch.Tensor:
    """``t [4·D/m, ...]``: this rank's columns of a ``[..., 4·D]`` tensor
    split over ``model`` (its ``4·D/m`` of the four gates ``[z, i, f, o]``),
    as rows → ``[4, D/m, ...]``: this rank's columns ``[j·D/m, (j + 1)·D/m)``
    of each gate, by one all-to-all over ``model``."""
    from torch.distributed._functional_collectives import all_to_all_single_autograd

    m, r = axis_size(mesh, "model"), axis_index(mesh, "model")
    u = t.shape[0] // 4
    # chunk k of this rank's rows is column block 4r + k of the 4m blocks of
    # u: gate (4r + k) // m, for rank (4r + k) % m; a rank receives its
    # blocks r, r + m, r + 2m, r + 3m in the senders' order, gate by gate
    dest = [(4 * r + k) % m for k in range(4)]
    order = sorted(range(4), key=lambda k: dest[k])
    send = torch.cat([t[k * u:(k + 1) * u] for k in order])
    n_in = [dest.count(j) * u for j in range(m)]
    n_out = [sum(((4 * src + k) % m) == r for k in range(4)) * u for src in range(m)]
    got = all_to_all_single_autograd(send.contiguous(), n_out, n_in,
                                     (mesh, mesh.mesh_dim_names.index("model")))
    return got.reshape(4, u, *t.shape[1:])


def _slstm_scan(w_x, w_h, b, norm, x: torch.Tensor, state: dict, *, split: tuple | None = None,
                acts: bool = False):
    """:func:`slstm_forward` before ``wo`` on one rank → ``(hs [B,S,·]``
    normed, the whole new state).  With ``split = (mesh, h0, nh, e0, el,
    head)`` only heads ``[h0, h0 + nh)`` and columns ``[e0, e0 + el)`` of
    each run (``w_x``, ``w_h`` this rank's columns of ``[D, 4·D]``): the
    weights are brought to those columns (:func:`_to_gates`), or with
    ``acts`` each token's pre-activations ``x @ w_x + h @ w_h + b`` over
    this rank's columns are.

    The input and forget gates enter the cell only through their head
    means, and a mean of products is the product with the mean weights: so
    the projections carry the z and o gates' columns and one mean column of
    i and of f a head (with ``acts``, the means are taken of the
    pre-activations).  The recurrence runs on the state transposed,
    ``[heads, columns, B]``, so that the hidden state gathered over
    ``model`` is already ``h [D, B]``."""
    bsz, s, dmod = x.shape
    n_heads, hd = state["m"].shape[1], state["c"].shape[-1]
    if split is None:
        h0, nh, e0, el, j = 0, n_heads, 0, hd, 0
        wx, wh = w_x.reshape(dmod, 4, dmod), w_h.reshape(dmod, 4, dmod)
        bb = b.reshape(4, dmod)
    else:
        mesh, h0, nh, e0, el, _ = split
        j = axis_index(mesh, "model")
        if not acts:
            wx, wh = (_to_gates(w.T, mesh).permute(2, 0, 1) for w in (w_x, w_h))  # [D, 4, u]
            bb = b.reshape(4, dmod)[:, j * nh * el:(j + 1) * nh * el]
    u = nh * el

    def gates(w):        # [..., 4, u] → [..., 2u + 2nh]: z, o, then i's and f's head means
        means = w[..., 1:3, :].reshape(*w.shape[:-2], 2, nh, el).sum(dim=-1)
        if split is not None:
            means = _head_sum(means, split, n_heads)
        return torch.cat([w[..., 0, :], w[..., 3, :], (means / hd).flatten(-2)], dim=-1)

    cdt = torch.promote_types(torch.promote_types(w_h.dtype, state["h"].dtype), x.dtype)
    if acts:             # this rank's stored columns: 4u of them, [4u·j, 4u·(j + 1))
        gx = (x @ w_x + b[4 * u * j:4 * u * (j + 1)]).to(cdt).permute(1, 2, 0)    # [S, 4u, B]
        wh_t = w_h.to(cdt).T.contiguous()                                         # [4u, D]
        no_w, no_h = gx.new_empty(2 * u + 2 * nh, 0), gx.new_empty(0, bsz)
    else:
        gx = (x @ gates(wx) + gates(bb)).to(cdt).permute(1, 2, 0).contiguous()  # [S, 2u+2nh, B]
        wh_t = gates(wh).to(cdt).T.contiguous()                                  # [2u+2nh, D]
    cols = slice(j * u, (j + 1) * u)
    mine = lambda t: t.reshape(bsz, dmod)[:, cols].T.to(cdt)                  # [u, B]
    # the state packed as one tensor [c; n; h; m] of [3u + nh, B]
    st = torch.cat([mine(state["c"]), mine(state["n"]), mine(state["h"]),
                    state["m"][:, h0:h0 + nh].T.to(cdt)])
    if split is None:
        whole = lambda t: t
    else:
        group = mesh.get_group("model").group_name
        size = axis_size(mesh, "model")
        # the cell waits for the gathered h itself (one dispatch less a token)
        whole = lambda t: torch.ops._c10d_functional_autograd.all_gather_into_tensor(
            t, size, group)
    sts = []
    for gx_t in gx.unbind(0):                 # one token at a time
        if acts:                              # the gate-aligned pre-activations, then the cell
            a = torch.addmm(gx_t, wh_t, _gathered(whole(st[2 * u:3 * u]), True))
            g = gates(_to_gates(a, mesh).permute(2, 0, 1)).T                 # [2u + 2nh, B]
            st = _slstm_cell_op(g.contiguous(), no_w, no_h, st, nh, False)
        else:
            st = _slstm_cell_op(gx_t, wh_t, whole(st[2 * u:3 * u]), st, nh, split is not None)
        sts.append(st)
    hs = torch.stack(sts)[:, 2 * u:3 * u].reshape(s, nh, el, bsz).permute(3, 0, 1, 2)  # [B,S,nh,el]
    c, n, h, m = st[:u], st[u:2 * u], st[2 * u:3 * u], st[3 * u:]
    if split is None:
        hs = rmsnorm(norm, hs.to(state["h"].dtype)).reshape(bsz, s, dmod)
        back = lambda t, ref: t.T.reshape(ref.shape).to(ref.dtype).contiguous()
        return hs.to(x.dtype), {"c": back(c, state["c"]), "n": back(n, state["n"]),
                                "h": back(h, state["h"]),
                                "m": m.T.to(state["m"].dtype).contiguous()}
    hf = hs.float()
    var = _head_sum(hf.square().sum(dim=-1), split, n_heads) / hd
    hs = hf * torch.rsqrt(var + 1e-6)[..., None] * norm["scale"][e0:e0 + el].float()
    hs = hs.to(cdt).reshape(bsz, s, u).to(x.dtype)
    back = lambda t, ref: torch.ops._c10d_functional.wait_tensor(whole(t.contiguous())).T.reshape(
        ref.shape).to(ref.dtype).contiguous()
    mm = gather_over(m, mesh, "model", 0)[::hd // el].T                      # [B, H]
    return hs, {"c": back(c, state["c"]), "n": back(n, state["n"]), "h": back(h, state["h"]),
                "m": mm.to(state["m"].dtype).contiguous()}


def _slstm_cell_math(g, st, nh: int):
    """One sLSTM step on the packed, transposed state: ``g [2u + 2nh, B]``
    (the z and o gates' pre-activations, then the i and f head means),
    ``st = [c; n; h; m]`` (``c, n, h [u, B]``, ``nh`` heads' columns
    head-major; ``m [nh, B]``) → the new ``st``."""
    u, bsz = (st.shape[0] - nh) // 3, st.shape[1]
    heads = lambda t: t.view(nh, u // nh, bsz)
    c, n, m = st[:u], st[u:2 * u], st[3 * u:]
    z, o = torch.tanh(g[:u]), torch.sigmoid(g[u:2 * u])
    i_h = g[2 * u:2 * u + nh]
    lfm = F.logsigmoid(g[2 * u + nh:]) + m                  # log sigmoid(f) + m
    m_new = torch.maximum(lfm, i_h)
    i = torch.exp(i_h - m_new)[:, None]
    f = torch.exp(lfm - m_new)[:, None]
    c = torch.addcmul(f * heads(c), i, heads(z)).view(u, bsz)
    n = torch.addcmul(i, f, heads(n)).view(u, bsz)
    return torch.cat([c, n, o * (c / torch.clamp_min(n, 1.0)), m_new])


def _gathered(h: torch.Tensor, gathered: bool) -> torch.Tensor:
    return torch.ops._c10d_functional.wait_tensor(h) if gathered else h


@torch.library.custom_op("repro_torch::slstm_cell", mutates_args=())
def _slstm_cell_op(gx: torch.Tensor, w_t: torch.Tensor, h: torch.Tensor, st: torch.Tensor,
                   nh: int, gathered: bool) -> torch.Tensor:
    """One token of the recurrence as one operation: ``g = gx + w_t @ h``
    (``h [D, B]`` the whole hidden state, a pending all-gather's output
    when ``gathered``), then :func:`_slstm_cell_math`; ``w_t [·, 0]`` and
    ``h [0, B]`` (an empty product) when ``gx`` already holds the whole
    pre-activations.  Its gradient is one
    more (:func:`_slstm_cell_grad`), and its FLOPs are counted by the
    formulas registered below: a token's trace is a few dispatches instead
    of some fifty."""
    return _slstm_cell_math(gx + w_t @ _gathered(h, gathered), st, nh)


@_slstm_cell_op.register_fake
def _(gx, w_t, h, st, nh, gathered):
    return torch.empty_like(st)


@torch.library.custom_op("repro_torch::slstm_cell_grad", mutates_args=())
def _slstm_cell_grad_op(gx: torch.Tensor, w_t: torch.Tensor, h: torch.Tensor, st: torch.Tensor,
                        st_new: torch.Tensor, grad: torch.Tensor,
                        nh: int) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """The gradient of :func:`_slstm_cell_op` → ``(dgx, dw_t, dh, dst)``
    (``g`` taken again from ``gx``, ``w_t`` and ``h``)."""
    dg, dst = _slstm_cell_grad(gx + w_t @ h, st, st_new, grad, nh)
    return dg, dg @ h.T, w_t.T @ dg, dst


@_slstm_cell_grad_op.register_fake
def _(gx, w_t, h, st, st_new, grad, nh):
    return torch.empty_like(gx), torch.empty_like(w_t), torch.empty_like(h), torch.empty_like(st)


def _slstm_cell_flops(gx, w_t, h, *args, out_shape=None, **kwargs) -> int:
    """``w_t @ h``'s FLOPs (the formulas take shapes)."""
    return 2 * w_t[0] * w_t[1] * h[1]


def _slstm_cell_grad_flops(gx, w_t, h, *args, out_shape=None, **kwargs) -> int:
    return 3 * _slstm_cell_flops(gx, w_t, h)          # g again, then dw_t and dh


def _register_cell_flops() -> None:
    from torch.utils.flop_counter import register_flop_formula

    register_flop_formula(torch.ops.repro_torch.slstm_cell)(_slstm_cell_flops)
    register_flop_formula(torch.ops.repro_torch.slstm_cell_grad)(_slstm_cell_grad_flops)


_register_cell_flops()


def _slstm_cell_grad(g, st, st_new, grad, nh: int):
    """The backward of :func:`_slstm_cell_math` from its inputs, output and
    the output's gradient, as autograd would take it (the maximum's
    gradient split evenly on a tie, the clamp's passed where ``n >= 1``)."""
    u, bsz = (st.shape[0] - nh) // 3, st.shape[1]
    heads = lambda t: t.view(nh, u // nh, bsz)
    c, n, m = st[:u], st[u:2 * u], st[3 * u:]
    c_new, n_new, m_new = st_new[:u], st_new[u:2 * u], st_new[3 * u:]
    gc, gn, gh, gm = grad[:u], grad[u:2 * u], grad[2 * u:3 * u], grad[3 * u:]
    z, o = torch.tanh(g[:u]), torch.sigmoid(g[u:2 * u])
    i_h, f_pre = g[2 * u:2 * u + nh], g[2 * u + nh:]
    lfm = F.logsigmoid(f_pre) + m
    i, f = torch.exp(i_h - m_new), torch.exp(lfm - m_new)
    den = torch.clamp_min(n_new, 1.0)
    r = c_new / den
    dr = gh * o
    dc_h = heads(gc + dr / den)
    dn_h = heads(gn - (dr * r / den) * (n_new >= 1.0))
    di = (dc_h * heads(z) + dn_h).sum(dim=1)                     # [nh, B]
    df = (dc_h * heads(c) + dn_h * heads(n)).sum(dim=1)
    dm_new = gm - di * i - df * f
    tie = (lfm == i_h).to(g.dtype) * 0.5
    dlfm = df * f + dm_new * ((lfm > i_h).to(g.dtype) + tie)
    d_ih = di * i + dm_new * ((i_h > lfm).to(g.dtype) + tie)
    dg = torch.cat([(dc_h * i[:, None]).view(u, bsz) * (1 - z * z), gh * r * o * (1 - o),
                    d_ih, dlfm * torch.sigmoid(-f_pre)])
    f_col = f[:, None]
    dst = torch.cat([(dc_h * f_col).view(u, bsz), (dn_h * f_col).view(u, bsz),
                     torch.zeros_like(gh), dlfm])
    return dg, dst


def _slstm_cell_setup(ctx, inputs, output):
    gx, w_t, h, st, nh, gathered = inputs
    ctx.nh = nh
    ctx.save_for_backward(gx, w_t, h, st, output)


def _slstm_cell_backward(ctx, grad):
    gx, w_t, h, st, st_new = ctx.saved_tensors
    dgx, dw, dh, dst = _slstm_cell_grad_op(gx, w_t, h, st, st_new, grad, ctx.nh)
    return dgx, dw, dh, dst, None, None


_slstm_cell_op.register_autograd(_slstm_cell_backward, setup_context=_slstm_cell_setup)


def slstm_step(p, x: torch.Tensor, state: dict):
    """Single-token decode.  ``x [B, D]`` → ``(y [B, D], state)``: the
    forward over one token (:func:`slstm_forward`)."""
    y, state = slstm_forward(p, x[:, None], state)
    return y[:, 0], state
