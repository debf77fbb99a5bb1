"""Mamba2 (SSD) blocks — the PyTorch port of the Mamba2 half of
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
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.kernels import ops
from repro_torch.models.layers import rmsnorm


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

    def dense(fan_in: int, fan_out: int) -> torch.Tensor:
        return torch.randn((fan_in, fan_out), **kw).mul_(1.0 / math.sqrt(fan_in))

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
    d_inner = p["out_proj"].shape[0]
    d_conv = p["conv_w"].shape[1]
    d_state = (p["conv_w"].shape[0] - d_inner) // 2
    n_heads = p["a_log"].shape[0]
    return {"d_inner": d_inner, "n_heads": n_heads, "head_p": d_inner // n_heads,
            "d_state": d_state, "d_conv": d_conv}


def mamba2_init_state(p, batch: int, dtype=torch.float32) -> dict:
    m = mamba2_meta(p)
    dev = p["out_proj"].device
    return {
        "conv": torch.zeros((batch, m["d_inner"] + 2 * m["d_state"], m["d_conv"] - 1),
                            dtype=dtype, device=dev),
        "ssm": torch.zeros((batch, m["n_heads"], m["head_p"], m["d_state"]),
                           dtype=dtype, device=dev),
    }


def _mamba2_split(p, x: torch.Tensor):
    """in_proj + split.  ``x [B,S,D]`` → z, xc, b, c, dt."""
    m = mamba2_meta(p)
    di, ds, nh = m["d_inner"], m["d_state"], m["n_heads"]
    return torch.split(x @ p["in_proj"], [di, di, ds, ds, nh], dim=-1)


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
    return out, full[:, :, -(dk - 1):]


def mamba2_forward(p, x: torch.Tensor, state: dict | None = None, *, chunk: int = 128):
    """Full-sequence forward.  ``x [B, S, D]`` → ``(y [B, S, D], state)``.

    Chunked SSD: the intra-chunk decayed quadratic form goes through
    :func:`repro_torch.kernels.ops.ssd_chunk`; the inter-chunk state
    ``h [B, H, P, N]`` is carried chunk by chunk.  The tail is zero-padded
    to a whole chunk (dt and log-decay 0, so padded tokens add nothing).
    """
    m = mamba2_meta(p)
    nh, hp, ds = m["n_heads"], m["head_p"], m["d_state"]
    bsz, s, _ = x.shape
    if state is None:
        state = mamba2_init_state(p, bsz, x.dtype)

    z, xc, bmat, cmat, dt = _mamba2_split(p, x)
    xbc = torch.cat([xc, bmat, cmat], dim=-1)
    xbc, conv_state = _causal_conv(p, xbc, state["conv"])
    xc, bmat, cmat = torch.split(xbc, [m["d_inner"], ds, ds], dim=-1)

    # SSD recurrence in float32: exp/cumsum chains underflow in bf16
    in_dtype = x.dtype
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
    return y @ p["out_proj"], {"conv": conv_state, "ssm": h.to(state_dtype)}


def mamba2_step(p, x: torch.Tensor, state: dict):
    """Single-token decode.  ``x [B, D]`` → ``(y [B, D], state)``."""
    m = mamba2_meta(p)
    nh, hp, ds = m["n_heads"], m["head_p"], m["d_state"]
    bsz = x.shape[0]
    z, xc, bmat, cmat, dt = _mamba2_split(p, x[:, None])      # seq dim = 1
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
    return y @ p["out_proj"], {"conv": conv[:, :, 1:], "ssm": h}
