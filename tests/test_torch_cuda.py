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
"""

import numpy as np
import pytest
import torch

from repro_torch.kernels import ops

SCORE_SHAPES = [(1, 4, 16, 64, 4), (2, 8, 32, 512, 4), (3, 16, 64, 1000, 4),
                (1, 4, 16, 130, 8), (2, 32, 8, 256, 16)]


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


@pytest.mark.cuda
class TestCudaKernels:
    """The hand-written kernels against their plain versions on the card."""

    @pytest.mark.parametrize("b,h,r,n,g", SCORE_SHAPES + [(4, 32, 64, 4096, 4)])
    def test_lowrank_group_scores(self, cuda_device, b, h, r, n, g):
        q, k, vl = (torch.from_numpy(a).to(cuda_device) for a in _score_inputs(4, b, h, r, n))
        vl[0] = 0
        got = ops.lowrank_group_scores(q, k, vl, group_size=g)
        want = ops.lowrank_group_scores_plain(q, k, vl, group_size=g)
        masked = want <= -1e29
        assert torch.equal(got[masked], want[masked])
        # folded head sum: 1e-5 of the row's score scale
        scale = want.masked_fill(masked, 0).abs().amax(1, keepdim=True).clamp_min(1)
        assert float(((got - want).abs() / scale).masked_fill(masked, 0).max()) <= 1e-5

    @pytest.mark.parametrize("b,h,hk,d,s", [(2, 8, 2, 64, 300), (2, 16, 8, 128, 513),
                                            (4, 32, 8, 128, 405), (1, 4, 4, 32, 1)])
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
