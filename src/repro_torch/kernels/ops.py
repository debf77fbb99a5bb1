"""The port's two decode kernels: wrappers, plain versions and launch counts.

Each wrapper picks by the device of the tensors it is given:

* a **CPU** tensor runs the plain PyTorch version beside it (the CPU tests
  compare it with the JAX reference);
* a **CUDA** tensor launches the hand-written kernel from ``csrc/`` through
  ``ctypes`` on the current stream, after checking device, dtype (fp32),
  shape, contiguity and alignment — anything else raises; there is no
  fallback to the plain version.

Each wrapper counts its kernel launches in ``<wrapper>.launches`` (a plain
integer, incremented once per launch and nowhere else), so a run can show
that its main path went through the kernel.
"""

from __future__ import annotations

import ctypes
import math

import torch
import torch.nn.functional as F

from repro_torch.core.predictor import NEG_INF, group_scores, token_scores
from repro_torch.kernels import _build

_P = ctypes.c_void_p
_I = ctypes.c_int
_FNS: dict[str, ctypes._CFuncPtr] = {}


def _fn(lib: str, name: str, argtypes: list) -> ctypes._CFuncPtr:
    if name not in _FNS:
        fn = getattr(_build.load(lib), name)
        fn.argtypes, fn.restype = argtypes, ctypes.c_int
        _FNS[name] = fn
    return _FNS[name]


def _require_cuda(name: str, tensors: dict[str, torch.Tensor], dtypes: dict) -> torch.device:
    dev = next(iter(tensors.values())).device
    if dev.type != "cuda":
        raise ValueError(f"{name}: tensors must be on the CPU (plain version) or "
                         f"on a CUDA device (kernel), got {dev}")
    for arg, t in tensors.items():
        if t.device != dev:
            raise ValueError(f"{name}: {arg} is on {t.device}, expected {dev}")
        if t.dtype != dtypes[arg]:
            raise ValueError(f"{name}: {arg} must be {dtypes[arg]}, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: {arg} must be contiguous")
        if t.data_ptr() % 16:
            raise ValueError(f"{name}: {arg} must be 16-byte aligned")
    return dev


def _launch(fn, *args) -> None:
    err = fn(*args)
    if err:
        raise RuntimeError(f"{fn.__name__} failed to launch: CUDA error {err}")


# --------------------------------------------------------------------------
# kernel A: low-rank group scoring (replaces kernels/lowrank_score.py)
# --------------------------------------------------------------------------


def lowrank_group_scores_plain(q_lr: torch.Tensor, k_lr: torch.Tensor,
                               valid_len: torch.Tensor, *, group_size: int) -> torch.Tensor:
    """Plain version: per-head scores summed over heads, masked to -1e30 at
    ``pos >= valid_len``, max over each group (the ragged last group is
    padded with -1e30)."""
    b, n, _ = k_lr.shape
    scores = token_scores(q_lr.float(), k_lr.float())
    n_pad = -(-n // group_size) * group_size
    scores = F.pad(scores, (0, n_pad - n), value=NEG_INF)
    return group_scores(scores, group_size, valid_len)


def lowrank_group_scores(q_lr: torch.Tensor, k_lr: torch.Tensor,
                         valid_len: torch.Tensor, *, group_size: int) -> torch.Tensor:
    """Paper Eq. 1 group scores: ``q_lr [B,H,r]`` f32, ``k_lr [B,N,r]`` f32,
    ``valid_len [B]`` int32 → ``[B, ceil(N/G)]`` f32."""
    if k_lr.device.type == "cpu":
        return lowrank_group_scores_plain(q_lr, k_lr, valid_len, group_size=group_size)
    name = "lowrank_group_scores"
    dev = _require_cuda(name, {"q_lr": q_lr, "k_lr": k_lr, "valid_len": valid_len},
                        {"q_lr": torch.float32, "k_lr": torch.float32,
                         "valid_len": torch.int32})
    b, h, r = q_lr.shape
    n = k_lr.shape[1]
    if k_lr.shape != (b, n, r) or valid_len.shape != (b,):
        raise ValueError(f"{name}: shapes q_lr {tuple(q_lr.shape)}, k_lr "
                         f"{tuple(k_lr.shape)}, valid_len {tuple(valid_len.shape)} disagree")
    if r > 256 or group_size < 1:
        raise ValueError(f"{name}: needs rank <= 256 and group_size >= 1")
    out = torch.empty((b, -(-n // group_size)), dtype=torch.float32, device=dev)
    fn = _fn("lowrank_score", "lowrank_group_scores_f32", [_P, _P, _P, _P] + [_I] * 5 + [_P])
    _launch(fn, q_lr.data_ptr(), k_lr.data_ptr(), valid_len.data_ptr(), out.data_ptr(),
            b, h, n, r, group_size, torch.cuda.current_stream(dev).cuda_stream)
    lowrank_group_scores.launches += 1
    return out


lowrank_group_scores.launches = 0


# --------------------------------------------------------------------------
# kernel B: GQA flash-decode over gathered KV (replaces kernels/gather_attention.py)
# --------------------------------------------------------------------------


def gather_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                           mask: torch.Tensor) -> torch.Tensor:
    """Plain version: masked softmax in fp32 with ``p = 0`` on masked tokens
    and the denominator clamped at 1e-30 (a fully masked row gives 0)."""
    b, h, d = q.shape
    hk = k.shape[2]
    qf = q.float().reshape(b, hk, h // hk, d)
    s = torch.einsum("bkrd,btkd->bkrt", qf, k.float()) / math.sqrt(d)
    keep = mask[:, None, None, :]
    s = s.masked_fill(~keep, NEG_INF)
    p = torch.exp(s - s.amax(dim=-1, keepdim=True)).masked_fill(~keep, 0.0)
    denom = p.sum(dim=-1, keepdim=True).clamp_min(1e-30)
    o = torch.einsum("bkrt,btkd->bkrd", p, v.float()) / denom
    return o.reshape(b, h, d).to(q.dtype)


def gather_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     mask: torch.Tensor) -> torch.Tensor:
    """One-token decode attention: ``q [B,H,d]``, ``k/v [B,S,H_kv,d]``
    (token-major, as the KV manager gathers them), ``mask [B,S]`` bool →
    ``[B,H,d]``."""
    if q.device.type == "cpu":
        return gather_attention_plain(q, k, v, mask)
    name = "gather_attention"
    dev = _require_cuda(name, {"q": q, "k": k, "v": v, "mask": mask},
                        {"q": torch.float32, "k": torch.float32, "v": torch.float32,
                         "mask": torch.bool})
    b, h, d = q.shape
    s, hk = k.shape[1], k.shape[2]
    if k.shape != (b, s, hk, d) or v.shape != k.shape or mask.shape != (b, s):
        raise ValueError(f"{name}: shapes q {tuple(q.shape)}, k {tuple(k.shape)}, "
                         f"v {tuple(v.shape)}, mask {tuple(mask.shape)} disagree")
    if h % hk or h // hk > 8 or d % 4 or d > 128:
        raise ValueError(f"{name}: needs H % H_kv == 0, H / H_kv <= 8, "
                         f"head_dim % 4 == 0 and head_dim <= 128")
    out = torch.empty((b, h, d), dtype=torch.float32, device=dev)
    fn = _fn("gather_attention", "gather_attention_f32", [_P] * 5 + [_I] * 5 + [_P])
    _launch(fn, q.data_ptr(), k.data_ptr(), v.data_ptr(), mask.data_ptr(), out.data_ptr(),
            b, h, hk, s, d, torch.cuda.current_stream(dev).cuda_stream)
    gather_attention.launches += 1
    return out


gather_attention.launches = 0
