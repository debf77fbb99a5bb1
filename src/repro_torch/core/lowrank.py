"""Compressed K-cache via joint-head low-rank projection (KVSwap §3.2).

The adapter ``A ∈ R^{(H_k·d) × r}`` is the top-``r`` right singular vectors of
a *calibration* K cache flattened to ``[N, H_k·d]`` — computed offline.  The
in-memory compressed cache is ``K_lr = Flatten(K) · A``.

The SVD runs in numpy (float64) exactly as in the reference, so the same
calibration K gives the same adapter on both sides; only the result is
moved to a tensor on the run's device.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.device import resolve


@dataclasses.dataclass(frozen=True)
class LowRankAdapter:
    """Offline-computed joint-head low-rank adapter for the K cache."""

    a: torch.Tensor       # [H_k * d, r]
    n_kv_heads: int
    head_dim: int

    @property
    def rank(self) -> int:
        return self.a.shape[1]

    @property
    def sigma(self) -> float:
        """Compression ratio σ = H_k·d / r."""
        return self.a.shape[0] / self.a.shape[1]

    @property
    def per_head(self) -> torch.Tensor:
        """A reshaped to ``[H_k, d, r]`` — A_{q(h)} slices of Eq. 1."""
        return self.a.reshape(self.n_kv_heads, self.head_dim, self.rank)

    def nbytes(self) -> int:
        return self.a.numel() * self.a.element_size()


def fit_adapter(k_calib: np.ndarray, *, rank: int, device=None,
                dtype=torch.float32) -> LowRankAdapter:
    """Fit the adapter from a calibration K cache via SVD.

    ``k_calib``: ``[N, H_k, d]`` or ``[B, N, H_k, d]`` (flattened over B·N),
    a numpy array (or anything ``np.asarray`` takes, e.g. a CPU tensor).
    """
    k = np.asarray(k_calib, dtype=np.float64)
    if k.ndim == 4:
        k = k.reshape(-1, k.shape[2], k.shape[3])
    n_kv_heads, head_dim = k.shape[1], k.shape[2]
    k_ftn = k.reshape(-1, n_kv_heads * head_dim)
    rank = min(rank, min(k_ftn.shape))
    # SVD(K_ftn) = U diag(S) V^T ; A = top-r columns of V.
    _, _, vt = np.linalg.svd(k_ftn, full_matrices=False)
    a = torch.as_tensor(np.ascontiguousarray(vt[:rank].T), dtype=dtype,
                        device=resolve(device))
    return LowRankAdapter(a=a, n_kv_heads=n_kv_heads, head_dim=head_dim)


def compress_k(k: torch.Tensor, adapter: LowRankAdapter) -> torch.Tensor:
    """``K_lr = Flatten(K) · A``.  ``k``: ``[..., N, H_k, d]`` → ``[..., N, r]``."""
    *lead, n, hk, d = k.shape
    return k.reshape(*lead, n, hk * d) @ adapter.a.to(k.dtype)


def append_compressed(k_lr: torch.Tensor, new_k: torch.Tensor,
                      adapter: LowRankAdapter) -> torch.Tensor:
    """Append freshly generated tokens' compressed keys (rolling-buffer flush).

    ``k_lr``: ``[B, N, r]``; ``new_k``: ``[B, G, H_k, d]`` → ``[B, N+G, r]``.
    """
    return torch.cat([k_lr, compress_k(new_k, adapter)], dim=-2)


def reconstruction_error(k, adapter: LowRankAdapter) -> float:
    """Relative Frobenius reconstruction error of ``k [N, H_k, d]`` or ``[B,
    N, H_k, d]`` through the adapter, in numpy float64 as the reference
    computes it."""
    k = np.asarray(k, dtype=np.float64)
    if k.ndim == 4:
        k = k.reshape(-1, k.shape[2], k.shape[3])
    flat = k.reshape(k.shape[0], -1)
    a = adapter.a.detach().cpu().numpy().astype(np.float64)
    rec = (flat @ a) @ a.T
    denom = np.linalg.norm(flat) + 1e-12
    return float(np.linalg.norm(flat - rec) / denom)
