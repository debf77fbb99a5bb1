"""Kernel C's split-precision tensor-core scheme, modelled in numpy on the CPU.

The CUDA kernel (``src/repro_torch/kernels/csrc/ssd_chunk.cu``) runs only
on a card.  What the CPU can reach is its arithmetic and its division of
work, which this file models:

* each operand of a tensor-core product is split as ``a = hi + lo`` with
  ``hi`` rounded to TF32 as ``cvt.rna.tf32.f32`` rounds (to nearest, ties
  away from zero, 10 mantissa bits kept) and ``lo = a - hi`` in fp32;
* over each 8-wide k-slice the kernel adds, to an fp32 accumulator, first
  one BF16 product (k 0-7: ``lo_a`` times ``b``; k 8-15: ``a`` times
  ``lo_b``; every value rounded to bf16, to nearest even) and then one TF32
  product ``hi_a . hi_b``; a product's own terms are exact and their sum is
  taken here in float64, then rounded into the fp32 accumulator;
* ``cb = C . B^T`` runs over 16-column chunks of N, each two k-slices of
  the columns ``n0 + 4t, n0 + 4t + 1`` and ``n0 + 4t + 2, n0 + 4t + 3``;
* ``y = w . x`` runs over 16-row strips and the 8-wide k-slices on or below
  the diagonal, in order; ``w = cb * exp(cum_i - cum_j) * dt_j`` is formed
  tile by tile in fp32 and a select sets ``j > i`` to 0 in the two
  diagonal tiles of a strip (``exp`` is ``inf`` there under steep decays).

The model runs at one chunk of Zamba2's width (Q = 128, H = 4, P = 64,
N = 64), with steep ``cum`` and a padded tail, and at the kernel's edge
shapes.  It is held to the JAX oracle ``repro.kernels.ref.ssd_chunk_ref``
and to the port's plain version ``ops.ssd_chunk_plain`` within 1e-4 of
``max(1, |y|max)``, the tolerance the card holds the kernel to.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref
from repro_torch.kernels import ops

SSD_TOL = 1e-4          # of max(1, |y|max)
QP = 128                # chunk rows, padded
STRIPS = QP // 16


def tf32_rna(a):
    """fp32 -> TF32 as ``cvt.rna.tf32.f32`` (finite values): add half of the
    dropped 13 bits to the magnitude, then clear them."""
    bits = np.asarray(a, np.float32).view(np.uint32)
    return ((bits + np.uint32(0x1000)) & np.uint32(0xFFFFE000)).view(np.float32)


def bf16_rn(a):
    """fp32 -> bf16 (held in fp32) as ``cvt.rn.bf16x2.f32``: to nearest, ties to even."""
    bits = np.asarray(a, np.float32).view(np.uint32).astype(np.uint64)
    bits = (bits + 0x7FFF + ((bits >> 16) & 1)) & 0xFFFF0000
    return bits.astype(np.uint32).view(np.float32)


def mma(d, a, b):
    """``d + a @ b`` with exact products summed in float64, rounded into fp32."""
    return (d.astype(np.float64) + np.matmul(a.astype(np.float64), b.astype(np.float64))
            ).astype(np.float32)


def mma_split(d, a, b):
    """One k-slice of the kernel's product: the BF16 cross terms, then hi.hi."""
    a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
    ha, hb = tf32_rna(a), tf32_rna(b)
    la, lb = a - ha, b - hb
    cross = np.concatenate([bf16_rn(la), bf16_rn(a)], axis=-1)       # k 0-7 | k 8-15
    cross_b = np.concatenate([bf16_rn(b), bf16_rn(lb)], axis=-2)
    return mma(mma(d, cross, cross_b), ha, hb)


def mma_one_tf32(d, a, b):
    """A single TF32 product: what the split exists to avoid."""
    return mma(d, tf32_rna(a), tf32_rna(b))


def cb_model(c, b, mma_fn=mma_split):
    """``cb [QP, QP]`` from C, B ``[QP, N]``: 16-column chunks, two k-slices each."""
    n = c.shape[1]
    n16 = -(-n // 16) * 16
    c = np.pad(c, ((0, 0), (0, n16 - n)))
    b = np.pad(b, ((0, 0), (0, n16 - n)))
    t = np.arange(4)
    acc = np.zeros((QP, QP), np.float32)
    for n0 in range(0, n16, 16):
        for step in (0, 1):
            cols = np.stack([n0 + 4 * t + 2 * step, n0 + 4 * t + 2 * step + 1], 1).ravel()
            acc = mma_fn(acc, c[:, cols], b[:, cols].T)
    return acc


def ssd_split_model(xh, bm, cm, dt, cum, mma_fn=mma_split):
    """Kernel C's arithmetic in numpy: ``[B,nc,Q,H,P]`` etc. -> ``[B,nc,Q,H,P]``."""
    bsz, nc, q, h, p = xh.shape
    out = np.zeros(xh.shape, np.float32)
    nk_all = -(-q // 8)
    rows = np.arange(QP)
    for bi in range(bsz):
        for ci in range(nc):
            pad = ((0, QP - q), (0, 0))
            cb = cb_model(np.pad(cm[bi, ci], pad), np.pad(bm[bi, ci], pad), mma_fn)
            x = np.pad(xh[bi, ci], ((0, QP - q), (0, 0), (0, 0))).transpose(1, 0, 2)  # [H,QP,P]
            cs = np.pad(cum[bi, ci], pad).T                                           # [H,QP]
            ds = np.pad(dt[bi, ci], pad).T
            y = np.zeros((h, QP, p), np.float32)
            for s in range(STRIPS):
                if 16 * s >= q:
                    continue
                i = slice(16 * s, 16 * s + 16)
                acc = np.zeros((h, 16, p), np.float32)
                for ks in range(min(2 * s + 2, nk_all)):
                    j = slice(8 * ks, 8 * ks + 8)
                    with np.errstate(over="ignore", invalid="ignore"):   # inf above the diagonal
                        decay = np.exp(cs[:, i, None] - cs[:, None, j])
                        w = (cb[None, i, j] * decay * ds[:, None, j]).astype(np.float32)
                    if ks >= 2 * s:                                  # the diagonal tiles
                        w = np.where(rows[j][None, None, :] <= rows[i][None, :, None], w, 0)
                    acc = mma_fn(acc, w, x[:, j])
                y[:, i] = acc
            out[bi, ci] = y[:, :q].transpose(1, 0, 2)
    return out


def ssd_inputs(seed, b, nc, q, h, p, n, *, steep=False, pad=0):
    """Inputs as ``mamba2_forward`` makes them; ``steep``: the log-decay falls
    by up to 45 a token; ``pad``: the last chunk's last tokens are zero."""
    rng = np.random.default_rng(seed)
    xh = rng.standard_normal((b, nc, q, h, p)).astype(np.float32)
    bm = rng.standard_normal((b, nc, q, n)).astype(np.float32)
    cm = rng.standard_normal((b, nc, q, n)).astype(np.float32)
    dt = rng.random((b, nc, q, h)).astype(np.float32)
    ld = -dt * (np.linspace(1.0, 45.0, h, dtype=np.float32) if steep else rng.random(h))
    if pad:
        for a in (xh, bm, cm, dt, ld):
            a[:, -1, q - pad:] = 0
    return xh, bm, cm, dt, np.cumsum(ld, axis=2).astype(np.float32)


def rel_err(got, want) -> float:
    want = np.asarray(want)
    return float(np.abs(got - want).max()) / max(1.0, float(np.abs(want).max()))


def test_tf32_rounds_as_cvt_rna():
    one = np.float32(1.0)
    tie = np.float32(1 + 2.0 ** -11)                 # halfway between 1 and 1 + 2^-10
    vals = np.array([tie, -tie, 1 + 2.0 ** -12, 1 + 3 * 2.0 ** -12, 3.0, -0.0], np.float32)
    got = tf32_rna(vals)
    want = np.array([1 + 2.0 ** -10, -(1 + 2.0 ** -10), one, 1 + 2.0 ** -10, 3.0, -0.0],
                    np.float32)
    np.testing.assert_array_equal(got, want)
    a = np.random.default_rng(0).standard_normal(10_000).astype(np.float32) * 1e3
    h = tf32_rna(a)
    assert not (h.view(np.uint32) & 0x1FFF).any()    # 13 low bits clear: a TF32 value
    assert np.all(np.abs(a - h) <= np.abs(a) * 2.0 ** -11)


def test_bf16_rounds_to_nearest_even():
    vals = np.array([1 + 2.0 ** -8, 1 + 3 * 2.0 ** -8, -(1 + 2.0 ** -8), 1 + 2.0 ** -9], np.float32)
    want = np.array([1.0, 1 + 2.0 ** -6, -1.0, 1.0], np.float32)
    np.testing.assert_array_equal(bf16_rn(vals), want)


def test_split_product_holds_fp32_accuracy():
    """One k-slice: the split product is within 2^-17 of the exact dot
    product's term sizes, the single TF32 product thousands of times worse."""
    rng = np.random.default_rng(1)
    a = rng.standard_normal((64, 16, 8)).astype(np.float32) * 10
    b = rng.standard_normal((64, 8, 8)).astype(np.float32)
    exact = np.matmul(a.astype(np.float64), b.astype(np.float64))
    scale = np.matmul(np.abs(a).astype(np.float64), np.abs(b).astype(np.float64))
    zero = np.zeros((64, 16, 8), np.float32)
    split = np.abs(mma_split(zero, a, b) - exact) / scale
    one = np.abs(mma_one_tf32(zero, a, b) - exact) / scale
    assert split.max() <= 2.0 ** -17
    assert one.mean() > 100 * split.mean()


def test_fragment_layouts_line_up():
    """Lane by lane (g = lane // 4, t = lane % 4), with the k index of a
    slice permuted so position t is column 2t and t + 4 is 2t + 1: the
    accumulator of a cb tile, stored as (c0, c2, c1, c3), is the TF32 A
    operand of the same tile of w, and the BF16 operand's k 2t, 2t+1 and
    2t+8, 2t+9 are the same two columns again."""
    for lane in range(32):
        g, t = divmod(lane, 4)
        acc = [(g, 2 * t), (g, 2 * t + 1), (g + 8, 2 * t), (g + 8, 2 * t + 1)]   # c0..c3
        stored = [acc[0], acc[2], acc[1], acc[3]]
        # TF32 A operand: a0 (g, t), a1 (g+8, t), a2 (g, t+4), a3 (g+8, t+4)
        col = {t: 2 * t, t + 4: 2 * t + 1}
        a_tf32 = [(g, col[t]), (g + 8, col[t]), (g, col[t + 4]), (g + 8, col[t + 4])]
        assert stored == a_tf32
        # BF16 A operand: reg0 (g, k 2t, 2t+1), reg1 (g+8, ...), reg2 (g, k 2t+8, 2t+9), reg3
        bf_cols = {2 * t: 2 * t, 2 * t + 1: 2 * t + 1, 2 * t + 8: 2 * t, 2 * t + 9: 2 * t + 1}
        assert [bf_cols[k] for k in (2 * t, 2 * t + 1)] == [col[t], col[t + 4]]
        assert [bf_cols[k] for k in (2 * t + 8, 2 * t + 9)] == [col[t], col[t + 4]]


@pytest.mark.parametrize("q", [128, 100, 37, 1])
def test_warps_share_the_triangle_evenly(q):
    """Warp w takes strips w // 2 and 7 - w // 2 and one column half: every
    tile on or below the diagonal is multiplied once per column half and
    its cb formed once, and at Q = 128 every warp carries 18 tiles of the
    product and 9 of cb."""
    nk_all = -(-q // 8)
    product, cb = {}, {}
    for warp in range(8):
        pw, half = divmod(warp, 2)
        for s in (pw, STRIPS - 1 - pw):
            if 16 * s >= q:
                continue
            for ks in range(min(2 * s + 2, nk_all)):
                product.setdefault((s, ks), []).append(half)
                if ks % 2 == half:
                    cb.setdefault((s, ks), []).append(warp)
    need = {(s, ks) for s in range(STRIPS) if 16 * s < q
            for ks in range(min(2 * s + 2, nk_all))}
    assert set(product) == need and set(cb) == need
    assert all(sorted(v) == [0, 1] for v in product.values())
    assert all(len(v) == 1 for v in cb.values())
    if q == 128:
        per_warp = [sum(1 for v in product.values() if w % 2 in v) for w in range(2)]
        assert len(need) == 72 and per_warp == [72, 72]
        for warp in range(8):
            pw, half = divmod(warp, 2)
            tiles = [(s, ks) for s in (pw, 7 - pw) for ks in range(2 * s + 2)]
            assert len(tiles) == 18
            assert sum(ks % 2 == half for _, ks in tiles) == 9


@pytest.mark.parametrize("steep,pad", [(False, 0), (True, 0), (False, 37), (True, 11)],
                         ids=["plain", "steep", "pad", "steep-pad"])
def test_model_matches_reference_at_zamba2_width(steep, pad):
    args = ssd_inputs(21, 1, 1, 128, 4, 64, 64, steep=steep, pad=pad)
    got = ssd_split_model(*args)
    assert np.isfinite(got).all()
    if pad:
        assert not got[:, -1, 128 - pad:].any()
    plain = ops.ssd_chunk_plain(*map(torch.from_numpy, args)).numpy()
    oracle = np.asarray(ref.ssd_chunk_ref(*map(jnp.asarray, args)))
    assert rel_err(got, plain) <= SSD_TOL
    assert rel_err(got, oracle) <= SSD_TOL


@pytest.mark.parametrize("shape", [dict(b=2, nc=2, q=1, h=3, p=32, n=12),
                                   dict(b=1, nc=2, q=100, h=3, p=8, n=128, steep=True, pad=5),
                                   dict(b=1, nc=2, q=16, h=2, p=16, n=4),
                                   dict(b=1, nc=1, q=77, h=2, p=16, n=5)],
                         ids=lambda d: "-".join(f"{k}{v}" for k, v in d.items()))
def test_model_matches_reference_at_edges(shape):
    args = ssd_inputs(22, **shape)
    got = ssd_split_model(*args)
    plain = ops.ssd_chunk_plain(*map(torch.from_numpy, args)).numpy()
    oracle = np.asarray(ref.ssd_chunk_ref(*map(jnp.asarray, args)))
    assert np.isfinite(got).all()
    assert rel_err(got, plain) <= SSD_TOL
    assert rel_err(got, oracle) <= SSD_TOL


def test_one_tf32_product_falls_short():
    """With one TF32 product per tile the same model lands tens of times
    farther from the plain version than the split scheme does."""
    args = ssd_inputs(23, 1, 1, 128, 4, 64, 64)
    plain = ops.ssd_chunk_plain(*map(torch.from_numpy, args)).numpy()
    split = rel_err(ssd_split_model(*args), plain)
    one = rel_err(ssd_split_model(*args, mma_fn=mma_one_tf32), plain)
    assert split <= SSD_TOL and one > 30 * split
