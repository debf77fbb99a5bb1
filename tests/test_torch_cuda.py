"""The hand-written CUDA kernels against their plain PyTorch versions, on
the card.

Every case is ``cuda``-marked and skips on a host without a card. The file
imports neither JAX nor the reference package, so the card's machine runs
it without them, with the JAX-only ``tests/conftest.py`` left out:

    PYTHONPATH=src python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py

Tolerances: kernel A folds the head sum before the dot product, so its
scores round differently from the plain per-head sum; they are held to
1e-5 of the row's score scale, and masked groups must be exactly -1e30.
Kernel B's outputs are convex combinations of O(1) values, held to 1e-5.
Kernel C sums up to Q = 128 decayed products in another order than its
plain version, on the tensor cores with each operand split into a TF32 and
a bf16-rounded remainder (each product term held to ~2^-18 of its size;
``tests/test_torch_ssd_split.py`` models the scheme) and with a fast
``exp``: held to 1e-4 of ``max(1, |y|max)``, ten times inside the JAX
package's own bound for its Pallas kernel (1e-3 absolute).  Its gradient
(``ops.SSDChunk``, whose backward is the plain version's VJP) is held to the
same bound against autograd of the plain version, in every SSD case.
"""

import numpy as np
import pytest
import torch

from repro_torch.kernels import ops
from repro_torch.main_path import compare_routes

# group selections that differ between the card and the CPU route of the
# tiny engine (test_engine_card_route_matches_cpu_route)
EXPECTED_FLIPS = 0

SCORE_SHAPES = [(1, 4, 16, 64, 4), (2, 8, 32, 512, 4), (3, 16, 64, 1000, 4),
                (1, 4, 16, 130, 8), (2, 32, 8, 256, 16)]
# kernel A's edges: r = 256, r not a multiple of 4 (scalar path), G = 1, a
# group longer than one 64-token pass
SCORE_EDGES = [(2, 8, 256, 600, 4), (2, 4, 30, 300, 4), (2, 4, 3, 77, 5),
               (2, 16, 64, 1000, 1), (1, 4, 16, 1000, 100)]
# kernel A past rank 256 (the rank in chunks of 256): Llama-3.1-8B's tuned
# shape (rank 512), a last chunk of one float4 (r = 260), the scalar path
# (r = 513), four chunks with a group longer than one pass
SCORE_WIDE = [(4, 32, 512, 4096, 4), (2, 8, 260, 300, 4), (2, 4, 513, 200, 4),
              (1, 8, 1024, 1000, 100)]
# kernel B's edges: S = 1, one token past a 32-token split, many splits;
# rep = 8 at d = 128, 32 and 64, rep = 3, rep = 1
ATTN_EDGES = [(2, 8, 8, 64, 1), (2, 8, 1, 128, 33), (3, 16, 2, 32, 4101),
              (3, 8, 1, 64, 405), (2, 6, 2, 32, 97), (2, 32, 32, 64, 65)]
# past head_dim 128 the kernel goes over the columns in chunks of 128:
# stablelm-12b's d = 160 (H 32, H_kv 8) at the serving path's S and at S = 1,
# d = 256 at rep 8 and rep 1 (the largest shared memory), and a last chunk
# of one and of four float4 columns (d = 132, 144)
ATTN_WIDE = [(4, 32, 8, 160, 405), (2, 32, 8, 160, 1), (2, 16, 2, 256, 300),
             (2, 8, 8, 256, 1), (3, 8, 1, 256, 33), (2, 12, 4, 132, 97), (2, 8, 2, 144, 65)]


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels have no CPU mode)")
    return torch.device("cuda")


def _score_inputs(seed, b, h, r, n):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, h, r)).astype(np.float32)
    k = rng.standard_normal((b, n, r)).astype(np.float32)
    vl = rng.integers(1, n + 1, b).astype(np.int32)
    return q, k, vl


def ssd_inputs(seed, b, nc, q, h, p, n, *, steep=False, pad=0):
    """Kernel C's inputs, as ``mamba2_forward`` makes them: ``cum`` is the
    in-chunk cumulative sum of a non-positive log-decay; ``steep`` makes it
    fall by up to 45 a token (``a_log`` = log 64 at full width), so the
    exponent above the diagonal passes +5000; ``pad`` zeroes the last
    ``pad`` tokens of the last chunk as padding arrives (dt and log-decay 0)."""
    rng = np.random.default_rng(seed)
    xh = rng.standard_normal((b, nc, q, h, p)).astype(np.float32)
    bm = rng.standard_normal((b, nc, q, n)).astype(np.float32)
    cm = rng.standard_normal((b, nc, q, n)).astype(np.float32)
    dt = rng.random((b, nc, q, h)).astype(np.float32)
    ld = -dt * (np.linspace(1.0, 45.0, h, dtype=np.float32) if steep else rng.random(h))
    if pad:
        for t in (xh, bm, cm, dt, ld):
            t[:, -1, q - pad:] = 0
    cum = np.cumsum(ld, axis=2).astype(np.float32)
    return xh, bm, cm, dt, cum


SSD_TOL = 1e-4      # of max(1, |y|max)
SSD_SHAPES = [dict(b=4, nc=16, q=128, h=64, p=64, n=64),          # the main path
              dict(b=1, nc=1, q=16, h=2, p=8, n=4),
              dict(b=2, nc=3, q=64, h=4, p=16, n=16),
              dict(b=1, nc=2, q=128, h=8, p=32, n=64, steep=True),
              dict(b=2, nc=2, q=128, h=9, p=64, n=64, pad=37),
              dict(b=1, nc=1, q=100, h=3, p=8, n=128, steep=True, pad=5),
              dict(b=3, nc=2, q=1, h=9, p=32, n=16),          # Q = 1
              dict(b=2, nc=2, q=128, h=17, p=64, n=12)]       # N = 12: part of a 16-column chunk


@pytest.mark.cuda
class TestCudaKernels:
    """The hand-written kernels against their plain versions on the card."""

    @pytest.mark.parametrize("b,h,r,n,g", SCORE_SHAPES + [(4, 32, 64, 4096, 4)])
    def test_lowrank_group_scores(self, cuda_device, b, h, r, n, g):
        q, k, vl = (torch.from_numpy(a).to(cuda_device) for a in _score_inputs(4, b, h, r, n))
        vl[0] = 0
        self._hold_scores(q, k, vl, g)

    def test_lowrank_group_scores_edges(self, cuda_device):
        """Every edge shape in one case (the card-only cases stay few)."""
        for b, h, r, n, g in SCORE_EDGES:
            q, k, vl = (torch.from_numpy(a).to(cuda_device) for a in _score_inputs(4, b, h, r, n))
            vl[0] = 0
            self._hold_scores(q, k, vl, g)
        for r in (64, 30):                       # valid_len past N, vector and scalar paths
            q, k, _ = (torch.from_numpy(a).to(cuda_device) for a in _score_inputs(8, 2, 8, r, 130))
            vl = torch.tensor([5000, 131], dtype=torch.int32, device=cuda_device)
            got = self._hold_scores(q, k, vl, 4)
            assert float(got.min()) > -1e29, r   # every group has a valid token
        for b, h, r, n, g in SCORE_WIDE:         # past rank 256: one launch each
            q, k, vl = (torch.from_numpy(a).to(cuda_device) for a in _score_inputs(6, b, h, r, n))
            vl[0] = 0
            before = ops.lowrank_group_scores.launches
            self._hold_scores(q, k, vl, g)
            assert ops.lowrank_group_scores.launches == before + 1, r

    @staticmethod
    def _hold_scores(q, k, vl, g):
        got = ops.lowrank_group_scores(q, k, vl, group_size=g)
        want = ops.lowrank_group_scores_plain(q, k, vl, group_size=g)
        masked = want <= -1e29
        shape = (*q.shape, k.shape[1], g)
        assert torch.equal(got[masked], want[masked]), shape
        # folded head sum: 1e-5 of the row's score scale
        scale = want.masked_fill(masked, 0).abs().amax(1, keepdim=True).clamp_min(1)
        assert float(((got - want).abs() / scale).masked_fill(masked, 0).max()) <= 1e-5, shape
        return got

    @pytest.mark.parametrize("b,h,hk,d,s", [(2, 8, 2, 64, 300), (2, 16, 8, 128, 513),
                                            (4, 32, 8, 128, 405), (4, 32, 32, 64, 405),
                                            (1, 4, 4, 32, 1)])
    def test_gather_attention(self, cuda_device, b, h, hk, d, s):
        gen = torch.Generator(device=cuda_device).manual_seed(5)
        q = torch.randn((b, h, d), generator=gen, device=cuda_device)
        k = torch.randn((b, s, hk, d), generator=gen, device=cuda_device)
        v = torch.randn((b, s, hk, d), generator=gen, device=cuda_device)
        mask = torch.rand((b, s), generator=gen, device=cuda_device) > 0.3
        mask[0, :64] = False
        got = ops.gather_attention(q, k, v, mask)
        want = ops.gather_attention_plain(q, k, v, mask)
        assert float((got - want).abs().max()) <= 1e-5

    def test_gather_attention_split_edges(self, cuda_device):
        """Every edge shape of the split design in one case (the card-only
        cases stay few)."""
        gen = torch.Generator(device=cuda_device).manual_seed(9)
        for b, h, hk, d, s in ATTN_EDGES:
            q = torch.randn((b, h, d), generator=gen, device=cuda_device)
            k = torch.randn((b, s, hk, d), generator=gen, device=cuda_device)
            v = torch.randn((b, s, hk, d), generator=gen, device=cuda_device)
            mask = torch.rand((b, s), generator=gen, device=cuda_device) > 0.3
            mask[0, 32:64] = False               # a fully masked split in mid-row
            mask[0, -1] = True
            mask[-1] = False                     # a fully masked row
            k[~mask] = 1e4                       # stale finite data under the mask
            before = ops.gather_attention.launches
            got = ops.gather_attention(q, k, v, mask)
            assert ops.gather_attention.launches == before + 1   # one launch, one count
            want = ops.gather_attention_plain(q, k, v, mask)
            torch.cuda.synchronize()
            shape = (b, h, hk, d, s)
            assert bool(torch.isfinite(got).all()), shape
            assert not bool(got[-1].any()), shape
            scale = max(1.0, float(want.abs().max()))
            assert float((got - want).abs().max()) <= 1e-5 * scale, shape

    def test_gather_attention_wide_head_dim(self, cuda_device):
        """head_dim past 128 (every wide shape in one case: the card-only
        cases stay few), with a fully masked split in mid-row and a fully
        masked row, held to the tolerance of the narrower widths; one launch
        a call, the same bits on a repeated call; d = 260 is refused."""
        for b, h, hk, d, s in ATTN_WIDE:
            gen = torch.Generator(device=cuda_device).manual_seed(d + s)
            q = torch.randn((b, h, d), generator=gen, device=cuda_device)
            k = torch.randn((b, s, hk, d), generator=gen, device=cuda_device)
            v = torch.randn((b, s, hk, d), generator=gen, device=cuda_device)
            mask = torch.rand((b, s), generator=gen, device=cuda_device) > 0.3
            mask[0, 32:64] = False
            mask[0, -1] = True
            mask[-1] = False
            before = ops.gather_attention.launches
            got = ops.gather_attention(q, k, v, mask)
            assert ops.gather_attention.launches == before + 1
            want = ops.gather_attention_plain(q, k, v, mask)
            torch.cuda.synchronize()
            shape = (b, h, hk, d, s)
            assert bool(torch.isfinite(got).all()), shape
            assert not bool(got[-1].any()), shape
            scale = max(1.0, float(want.abs().max()))
            assert float((got - want).abs().max()) <= 1e-5 * scale, shape
            assert torch.equal(ops.gather_attention(q, k, v, mask), got), shape
        t = torch.zeros((1, 2, 260), device=cuda_device)
        kv = torch.zeros((1, 3, 1, 260), device=cuda_device)
        with pytest.raises(ValueError, match="head_dim <= 256"):
            ops.gather_attention(t, kv, kv, torch.ones((1, 3), dtype=torch.bool,
                                                       device=cuda_device))

    def test_gather_attention_is_deterministic_and_resets_its_counters(self, cuda_device):
        """The last block of each head group combines in split order and sets
        its counter back to 0: repeated calls give the same bits."""
        gen = torch.Generator(device=cuda_device).manual_seed(10)
        q = torch.randn((4, 32, 128), generator=gen, device=cuda_device)
        k = torch.randn((4, 405, 8, 128), generator=gen, device=cuda_device)
        v = torch.randn((4, 405, 8, 128), generator=gen, device=cuda_device)
        mask = torch.rand((4, 405), generator=gen, device=cuda_device) > 0.2
        first = ops.gather_attention(q, k, v, mask)
        for _ in range(5):
            assert torch.equal(ops.gather_attention(q, k, v, mask), first)
        torch.cuda.synchronize()
        stream = torch.cuda.current_stream(cuda_device).cuda_stream
        assert not bool(ops._COUNTERS[cuda_device.index or 0, stream].any())

    @pytest.mark.parametrize("shape", SSD_SHAPES,
                             ids=lambda d: "-".join(f"{k}{v}" for k, v in d.items()))
    def test_ssd_chunk(self, cuda_device, shape):
        args = [torch.from_numpy(a).to(cuda_device) for a in ssd_inputs(6, **shape)]
        before = ops.ssd_chunk.launches
        got = ops.ssd_chunk(*args)
        assert ops.ssd_chunk.launches == before + 1
        want = ops.ssd_chunk_plain(*args)
        torch.cuda.synchronize()
        assert bool(torch.isfinite(got).all())
        if shape.get("pad"):
            assert not bool(got[:, -1, shape["q"] - shape["pad"]:].any())
        scale = max(1.0, float(want.abs().max()))
        assert float((got - want).abs().max()) <= SSD_TOL * scale
        # its gradient (``SSDChunk``: kernel C forward, the plain VJP
        # backward) in all five inputs, against autograd of the plain version
        req = [a.clone().requires_grad_() for a in args]
        cot = torch.randn(want.shape, device=cuda_device,
                          generator=torch.Generator(device=cuda_device).manual_seed(7))
        before = ops.ssd_chunk.launches
        grads = torch.autograd.grad(ops.ssd_chunk(*req), req, cot)
        assert ops.ssd_chunk.launches == before + 1          # the forward's launch only
        for g, w in zip(grads, torch.autograd.grad(ops.ssd_chunk_plain(*req), req, cot)):
            assert bool(torch.isfinite(g).all())
            assert float((g - w).abs().max()) <= SSD_TOL * max(1.0, float(w.abs().max()))

    def test_ssd_chunk_is_deterministic(self, cuda_device):
        """A fixed order of accumulation and no atomics: repeated calls at
        the Zamba2 path's shapes give the same bits."""
        args = [torch.from_numpy(a).to(cuda_device)
                for a in ssd_inputs(8, b=4, nc=16, q=128, h=64, p=64, n=64)]
        first = ops.ssd_chunk(*args)
        for _ in range(5):
            assert torch.equal(ops.ssd_chunk(*args), first)

    def test_ssd_chunk_refuses_what_it_cannot_take(self, cuda_device):
        args = [torch.from_numpy(a).to(cuda_device)
                for a in ssd_inputs(7, b=1, nc=1, q=16, h=2, p=8, n=4)]
        with pytest.raises(ValueError, match="contiguous"):
            ops.ssd_chunk(args[0].transpose(3, 4).contiguous().transpose(3, 4), *args[1:])
        big = [torch.from_numpy(a).to(cuda_device)
               for a in ssd_inputs(7, b=1, nc=1, q=256, h=2, p=8, n=4)]
        with pytest.raises(ValueError, match="Q <= 128"):
            ops.ssd_chunk(*big)


@pytest.mark.cuda
def test_engine_card_route_matches_cpu_route(cuda_device):
    """The ``device_resident`` engine on the card (kernels A and B) against
    the same engine on the CPU (their plain versions), on one set of
    ``tiny_cfg``-shaped weights: the greedy tokens are equal, and the group
    selections of every step, layer and row are equal but for
    ``EXPECTED_FLIPS``.  A flip is allowed only as a near-tie: on each side
    the groups it chose lie above the ones it passed over by no more than
    the two sides' scores differ, within kernel A's tolerance of 1e-5 of
    the row's score scale."""
    run = compare_routes(cuda_device)
    assert run["launches_card"]["lowrank_group_scores"] > 0
    assert run["launches_card"]["gather_attention"] > 0
    assert run["tokens_equal"], (run["tokens_card"], run["tokens_cpu"])
    assert run["selections"] == 12 * 2 * 2
    assert len(run["flips"]) == EXPECTED_FLIPS, run["flips"]
    for flip in run["flips"]:
        assert max(flip["gap_a"], flip["gap_b"]) <= max(flip["score_diff"], 1e-5), flip
