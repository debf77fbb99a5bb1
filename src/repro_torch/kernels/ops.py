"""The port's three kernels — the two of the decode path and the Mamba2
prefill's SSD term: wrappers, plain versions and launch counts.

Each wrapper picks by the device of the tensors it is given:

* a **CPU** tensor runs the plain PyTorch version beside it (the CPU tests
  compare it with the JAX reference);
* a **CUDA** tensor launches the hand-written kernel from ``csrc/`` through
  ``ctypes`` on the current stream, after checking device, dtype (fp32),
  shape, contiguity and alignment — anything else raises; there is no
  fallback to the plain version.

Each wrapper counts its kernel launches in ``<wrapper>.launches`` (a plain
integer, incremented once per launch and nowhere else), so a run can show
that its main path went through the kernel.  Kernel B's one launch runs
both of its passes (each block's split, then the combine by the last block
of each head group), so a call counts once.
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
    ``valid_len [B]`` int32 → ``[B, ceil(N/G)]`` f32.  The kernel takes any
    rank in one launch (past 256 it goes over the rank in chunks of 256)."""
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
    if group_size < 1:
        raise ValueError(f"{name}: needs group_size >= 1")
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


SPLIT_TOKENS = 32     # kernel B's tokens per split (``kSplit`` in gather_attention.cu)
# kernel B's per-(row, KV head) counters, int32 zeros, one buffer per
# (device, stream): the kernel's last block of each head group sets its
# counter back to 0, so only calls on one stream may share a buffer
_COUNTERS: dict[tuple[int, int], torch.Tensor] = {}


def _split_counters(dev: torch.device, stream: int, n: int) -> torch.Tensor:
    buf = _COUNTERS.get((dev.index, stream))
    if buf is None or buf.numel() < n:
        buf = _COUNTERS[dev.index, stream] = torch.zeros(n, dtype=torch.int32, device=dev)
    return buf


def gather_attention_splits(s: int) -> int:
    """Kernel B's number of token splits for ``S`` tokens: ``ceil(S / 32)``.
    The C entry point refuses any other count."""
    return -(-s // SPLIT_TOKENS)


def gather_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     mask: torch.Tensor) -> torch.Tensor:
    """One-token decode attention: ``q [B,H,d]``, ``k/v [B,S,H_kv,d]``
    (token-major, as the KV manager gathers them), ``mask [B,S]`` bool →
    ``[B,H,d]``.  The kernel takes ``H / H_kv <= 8`` and ``head_dim`` a
    multiple of 4 up to 256.

    On a CUDA tensor it is a split-S flash-decode in one kernel launch: each
    block writes its split's partials ``(m, l, acc)`` into scratch allocated
    here (``[B,H,n_split,d]`` and ``[B,H,n_split,2]``, ``n_split =
    gather_attention_splits(S)``), and the last block of each (row, KV head)
    to finish, found with an integer counter, merges them in split order
    and writes the output.  The call counts once in
    ``gather_attention.launches``."""
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
    if h % hk or h // hk > 8 or d % 4 or d > 256 or s < 1:
        raise ValueError(f"{name}: needs H % H_kv == 0, H / H_kv <= 8, "
                         f"head_dim % 4 == 0, head_dim <= 256 and S >= 1")
    n_split = gather_attention_splits(s)
    stream = torch.cuda.current_stream(dev).cuda_stream
    out = torch.empty((b, h, d), dtype=torch.float32, device=dev)
    pacc = torch.empty((b, h, n_split, d), dtype=torch.float32, device=dev)
    pml = torch.empty((b, h, n_split, 2), dtype=torch.float32, device=dev)
    counter = _split_counters(dev, stream, b * hk)
    fn = _fn("gather_attention", "gather_attention_f32", [_P] * 8 + [_I] * 6 + [_P])
    _launch(fn, q.data_ptr(), k.data_ptr(), v.data_ptr(), mask.data_ptr(), out.data_ptr(),
            pacc.data_ptr(), pml.data_ptr(), counter.data_ptr(), b, h, hk, s, d, n_split,
            stream)
    gather_attention.launches += 1
    return out


gather_attention.launches = 0


def gather_attention_occupancy(rep: int, d: int) -> dict:
    """Kernel B on the current card for ``H / H_kv = rep`` and head_dim
    ``d``: ``blocks_per_sm`` (what its shared memory and registers allow at
    once) and ``smem_bytes``, one block's dynamic shared memory."""
    vals = [ctypes.c_int(0) for _ in range(2)]
    fn = _fn("gather_attention", "gather_attention_occupancy", [_I, _I, _P, _P])
    _launch(fn, rep, d, *(ctypes.addressof(v) for v in vals))
    return dict(zip(("blocks_per_sm", "smem_bytes"), (v.value for v in vals)))


# --------------------------------------------------------------------------
# kernel C: Mamba2 SSD intra-chunk term (replaces kernels/ssd_chunk.py)
# --------------------------------------------------------------------------


def ssd_chunk_plain(xh: torch.Tensor, bm: torch.Tensor, cm: torch.Tensor,
                    dt: torch.Tensor, cum: torch.Tensor) -> torch.Tensor:
    """Plain version: the decayed causal weights in full.  The exponent is
    set to ``-inf`` above the diagonal *before* ``exp``, so an exponent that
    would overflow there never meets the mask as ``inf * 0``."""
    xh, bm, cm, dt, cum = (t.float() for t in (xh, bm, cm, dt, cum))
    q = xh.shape[2]
    causal = torch.ones((q, q), dtype=torch.bool, device=xh.device).tril()
    li = cum[:, :, :, None, :]
    lj = cum[:, :, None, :, :]
    decay = torch.exp(torch.where(causal[None, None, :, :, None], li - lj, float("-inf")))
    cb = torch.einsum("bnis,bnjs->bnij", cm, bm)
    w = cb[..., None] * decay * dt[:, :, None, :, :]
    return torch.einsum("bnijh,bnjhp->bnihp", w, xh)


def _ssd_shapes(xh, bm, cm, dt, cum) -> tuple[int, ...]:
    """The shapes the SSD term takes, checked on either device."""
    name = "ssd_chunk"
    if xh.dim() != 5:
        raise ValueError(f"{name}: xh must be [B, nc, Q, H, P], got {tuple(xh.shape)}")
    b, nc, q, h, p = xh.shape
    n = bm.shape[-1]
    if (bm.shape != (b, nc, q, n) or cm.shape != bm.shape or dt.shape != (b, nc, q, h)
            or cum.shape != dt.shape):
        raise ValueError(f"{name}: shapes xh {tuple(xh.shape)}, bm {tuple(bm.shape)}, "
                         f"cm {tuple(cm.shape)}, dt {tuple(dt.shape)}, "
                         f"cum {tuple(cum.shape)} disagree")
    for arg, t in zip(("xh", "bm", "cm", "dt", "cum"), (xh, bm, cm, dt, cum)):
        if t.dtype != torch.float32:
            raise ValueError(f"{name}: {arg} must be torch.float32, got {t.dtype}")
    return b, nc, q, h, p, n


def ssd_chunk(xh: torch.Tensor, bm: torch.Tensor, cm: torch.Tensor, dt: torch.Tensor,
              cum: torch.Tensor) -> torch.Tensor:
    """Intra-chunk SSD: ``xh [B,nc,Q,H,P]``, ``bm/cm [B,nc,Q,N]``, ``dt/cum
    [B,nc,Q,H]`` (``cum`` the in-chunk cumulative log-decay), all fp32 →
    ``[B,nc,Q,H,P]`` fp32.  The kernel takes ``Q <= 128``, ``P`` a power of
    two from 8 to 64 and ``N <= 128``."""
    b, nc, q, h, p, n = _ssd_shapes(xh, bm, cm, dt, cum)
    if xh.device.type == "cpu":
        return ssd_chunk_plain(xh, bm, cm, dt, cum)
    name = "ssd_chunk"
    f32 = torch.float32
    dev = _require_cuda(name, {"xh": xh, "bm": bm, "cm": cm, "dt": dt, "cum": cum},
                        dict.fromkeys(("xh", "bm", "cm", "dt", "cum"), f32))
    if not (1 <= q <= 128 and p in (8, 16, 32, 64) and 1 <= n <= 128):
        raise ValueError(f"{name}: needs 1 <= Q <= 128, P in (8, 16, 32, 64) and "
                         f"1 <= N <= 128, got Q={q}, P={p}, N={n}")
    out = torch.empty((b, nc, q, h, p), dtype=f32, device=dev)
    fn = _fn("ssd_chunk", "ssd_chunk_f32", [_P] * 6 + [_I] * 5 + [_P])
    _launch(fn, xh.data_ptr(), bm.data_ptr(), cm.data_ptr(), dt.data_ptr(), cum.data_ptr(),
            out.data_ptr(), b * nc, q, h, p, n, torch.cuda.current_stream(dev).cuda_stream)
    ssd_chunk.launches += 1
    return out


ssd_chunk.launches = 0


def ssd_chunk_occupancy(p: int) -> dict:
    """Kernel C on the current card at head width ``p``: ``blocks_per_sm``
    (what its shared memory and registers allow at once), ``heads_per_block``
    (the grid is ``(B * nc, ceil(H / heads_per_block))``) and
    ``smem_bytes``, its dynamic shared memory per block."""
    vals = [ctypes.c_int(0) for _ in range(3)]
    fn = _fn("ssd_chunk", "ssd_chunk_occupancy", [_I, _P, _P, _P])
    _launch(fn, p, *(ctypes.addressof(v) for v in vals))
    return dict(zip(("blocks_per_sm", "heads_per_block", "smem_bytes"), (v.value for v in vals)))
