"""Kernel B's split-and-combine rule, modelled in numpy on the CPU.

The CUDA kernel (``src/repro_torch/kernels/csrc/gather_attention.cu``) runs
only on a card.  What the CPU can reach is its arithmetic: this file models
its two passes with the split rule the wrapper uses
(``ops.gather_attention_splits``): one ``(m, l, acc)`` per 32-token split,
a split with no valid token written as ``m = -1e30``, ``l = 0``,
``acc = 0``, and the combine in split order with the denominator clamped
at ``1e-30``.  The model is held to the JAX oracle
``repro.kernels.ref.gather_attention_ref`` and to the port's plain version
``ops.gather_attention_plain`` at ragged S, with fully masked splits and
rows.

Tolerance 1e-6 absolute: every value is fp32 on both sides and the outputs
are convex combinations of O(1) values, so the two orders of summation
differ by a few ulps of 1.  The JAX oracle softmaxes a fully masked row to
uniform weights where the kernel and the plain version give 0, so such rows
are held to the plain version alone, and must be exactly 0.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref
from repro_torch.kernels import ops

NEG = np.float32(-1e30)
TOL = 1e-6


def _partial(s, valid, v):
    """One split's (m, l, acc) over its tokens: ``s [T]``, ``valid [T]``, ``v [T, d]``."""
    m = np.max(np.where(valid, s, NEG)).astype(np.float32)
    p = np.where(valid, np.exp(np.where(valid, s - m, 0)), 0).astype(np.float32)
    return m, np.float32(p.sum(dtype=np.float32)), (p[:, None] * v).sum(0, dtype=np.float32)


def _merge(parts):
    """Merge ``(m, l, acc)`` partials in order, as the kernel's combine does."""
    mx = max(m for m, _, _ in parts)
    lsum, acc = np.float32(0), np.zeros_like(parts[0][2])
    for m, l, a in parts:
        w = np.exp(np.float32(m - mx), dtype=np.float32)
        lsum = np.float32(lsum + l * w)
        acc = (acc + w * a).astype(np.float32)
    return mx, lsum, acc


def split_decode_model(q, k, v, mask):
    """Kernel B's two passes in numpy: ``q [B,H,d]``, ``k/v [B,S,H_kv,d]``,
    ``mask [B,S]`` → ``[B,H,d]`` fp32."""
    b, h, d = q.shape
    s_len, hk = k.shape[1], k.shape[2]
    rep = h // hk
    n_split = ops.gather_attention_splits(s_len)
    scale = np.float32(1.0 / np.sqrt(d))
    out = np.zeros((b, h, d), np.float32)
    for bi in range(b):
        for hi in range(h):
            kh = hi // rep
            partials = []                       # pass 1: one (m, l, acc) per split
            for sp in range(n_split):
                lo = sp * ops.SPLIT_TOKENS
                hi_t = min(lo + ops.SPLIT_TOKENS, s_len)
                sc = (k[bi, lo:hi_t, kh] @ q[bi, hi]).astype(np.float32) * scale
                partials.append(_partial(sc, mask[bi, lo:hi_t], v[bi, lo:hi_t, kh]))
            _, lsum, acc = _merge(partials)
            out[bi, hi] = acc / max(lsum, np.float32(1e-30))   # pass 2: combine
    return out


@pytest.mark.parametrize("s", [0, 1, 31, 32, 33, 405, 4101])
def test_split_count(s):
    n = ops.gather_attention_splits(s)
    assert n == -(-s // 32) and ops.SPLIT_TOKENS == 32
    assert n * ops.SPLIT_TOKENS >= s > (n - 1) * ops.SPLIT_TOKENS or s == n == 0


# (b, h, h_kv, d, S): S = 1, one token past a split boundary, many splits,
# ragged; rep = 1, 2, 3, 4, 8; d = 32, 64, 128
SHAPES = [(2, 4, 4, 32, 1), (2, 8, 2, 64, 33), (2, 8, 8, 16, 4101), (3, 16, 8, 128, 301),
          (2, 6, 2, 32, 97), (2, 8, 1, 64, 70), (2, 4, 4, 64, 405), (2, 8, 2, 128, 405)]


@pytest.mark.parametrize("b,h,hk,d,s", SHAPES)
def test_model_matches_oracle_and_plain(b, h, hk, d, s):
    rng = np.random.default_rng(11)
    q = rng.standard_normal((b, h, d)).astype(np.float32)
    k = rng.standard_normal((b, s, hk, d)).astype(np.float32)
    v = rng.standard_normal((b, s, hk, d)).astype(np.float32)
    mask = rng.random((b, s)) > 0.3
    mask[0, -1] = True                          # row 0 keeps a valid token
    mask[0, 32:64] = False                      # a fully masked split in mid-row
    mask[-1] = False                            # a fully masked row
    got = split_decode_model(q, k, v, mask)
    plain = ops.gather_attention_plain(*(torch.from_numpy(a) for a in (q, k, v, mask))).numpy()
    np.testing.assert_allclose(got, plain, rtol=0, atol=TOL)
    assert not got[-1].any() and not plain[-1].any()
    live = mask.any(axis=1)
    oracle = np.asarray(ref.gather_attention_ref(
        jnp.asarray(q), jnp.asarray(k).transpose(0, 2, 1, 3),
        jnp.asarray(v).transpose(0, 2, 1, 3), jnp.asarray(mask)))
    np.testing.assert_allclose(got[live], oracle[live], rtol=0, atol=TOL)


def test_masked_tokens_with_stale_data_weigh_nothing():
    """Masked tokens may hold stale finite data (the device-resident gather
    leaves it there): changing it changes nothing, in the model or plain."""
    rng = np.random.default_rng(12)
    q = rng.standard_normal((2, 4, 32)).astype(np.float32)
    k = rng.standard_normal((2, 100, 2, 32)).astype(np.float32)
    v = rng.standard_normal((2, 100, 2, 32)).astype(np.float32)
    mask = rng.random((2, 100)) > 0.5
    mask[:, 40:72] = False
    k2, v2 = k.copy(), v.copy()
    k2[~mask] = 1e4
    v2[~mask] = -3e3
    for fn in (split_decode_model,
               lambda *a: ops.gather_attention_plain(*map(torch.from_numpy, a)).numpy()):
        np.testing.assert_array_equal(fn(q, k, v, mask), fn(q, k2, v2, mask))
