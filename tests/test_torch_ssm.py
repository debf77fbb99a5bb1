"""The port's Mamba2 (``repro_torch.models.ssm``) and kernel C's plain version
against the JAX reference.

Inputs come from numpy seeds and the reference's weights reach the port
through the bridge.  Every comparison is fp32 on both sides:

* the SSD intra-chunk term is a sum of up to Q decayed products, taken in
  another order by XLA and PyTorch: held to 1e-5 of ``max(1, |y|max)``
  (the JAX package holds its own Pallas kernel to 1e-3 absolute);
* ``mamba2_forward`` / ``mamba2_step`` go through in_proj, conv, the
  chunked scan, a norm and out_proj: held to 1e-4 relative and 1e-5
  absolute, as ``test_torch_model.py`` holds the attention blocks — a few
  ulps times the depth of the sums, far below a wrong mask, decay or carry.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref
from repro.kernels.ssd_chunk import ssd_chunk_pallas
from repro.models import ssm as JS
from repro_torch.bridge import params_from_numpy
from repro_torch.kernels import ops
from repro_torch.models import ssm as TS

SSD_TOL = 1e-5                    # of max(1, |y|max)
RTOL, ATOL = 1e-4, 1e-5


def ssd_inputs(seed, b, nc, q, h, p, n, *, steep=False):
    rng = np.random.default_rng(seed)
    xh = rng.standard_normal((b, nc, q, h, p)).astype(np.float32)
    bm = rng.standard_normal((b, nc, q, n)).astype(np.float32)
    cm = rng.standard_normal((b, nc, q, n)).astype(np.float32)
    dt = rng.random((b, nc, q, h)).astype(np.float32)
    # steep: log-decay up to -45 a token, so exp(cum_i - cum_j) overflows above the diagonal
    rate = np.linspace(1.0, 45.0, h, dtype=np.float32) if steep else rng.random(h)
    cum = np.cumsum(-dt * rate, axis=2).astype(np.float32)
    return xh, bm, cm, dt, cum


def close_ssd(got: torch.Tensor, want) -> None:
    want = np.asarray(want)
    assert np.isfinite(got.numpy()).all()
    err = float(np.abs(got.numpy() - want).max())
    assert err <= SSD_TOL * max(1.0, float(np.abs(want).max())), err


class TestSSDChunkPlain:
    @pytest.mark.parametrize("b,nc,q,h,p,n,steep", [
        (1, 2, 16, 2, 8, 4, False),      # the shapes of tests/test_kernels.py
        (2, 3, 32, 4, 16, 16, False),
        (1, 1, 64, 8, 32, 64, False),
        (1, 2, 32, 4, 16, 8, True),      # steep cum: the overflow trap
    ])
    def test_matches_pallas_and_oracle(self, b, nc, q, h, p, n, steep):
        args = ssd_inputs(3, b, nc, q, h, p, n, steep=steep)
        got = ops.ssd_chunk(*(torch.from_numpy(a) for a in args))   # CPU: plain version
        jargs = [jnp.asarray(a) for a in args]
        close_ssd(got, ssd_chunk_pallas(*jargs, interpret=True))
        close_ssd(got, ref.ssd_chunk_ref(*jargs))
        assert ops.ssd_chunk.launches == 0      # the CPU never launches the kernel

    def test_wrapper_refuses_bad_inputs(self):
        args = [torch.from_numpy(a) for a in ssd_inputs(4, 1, 1, 8, 2, 4, 4)]
        with pytest.raises(ValueError, match="float32"):
            ops.ssd_chunk(args[0].double(), *args[1:])
        with pytest.raises(ValueError, match="disagree"):
            ops.ssd_chunk(args[0], args[1][:, :, :4], *args[2:])
        with pytest.raises(ValueError, match=r"\[B, nc, Q, H, P\]"):
            ops.ssd_chunk(args[0][0], *args[1:])
        with pytest.raises(ValueError, match="CUDA device"):
            ops.ssd_chunk(*(a.to("meta") for a in args))


@pytest.fixture(scope="module")
def mamba():
    """Reference Mamba2 weights (d_model 64, 8 heads of P = 16, N = 16), with
    a non-trivial conv bias, dt bias and skip so every term counts."""
    jp = JS.init_mamba2(jax.random.PRNGKey(3), d_model=64, d_state=16, head_p=16)
    rng = np.random.default_rng(5)
    jp = jax.tree_util.tree_map(np.asarray, jp)
    for key in ("conv_b", "dt_bias", "d_skip"):
        jp[key] = (jp[key] + 0.3 * rng.standard_normal(jp[key].shape)).astype(np.float32)
    return jp, params_from_numpy(jp, "cpu")


def carried_state(jp, b, seed):
    rng = np.random.default_rng(seed)
    st = jax.tree_util.tree_map(np.asarray, JS.mamba2_init_state(jp, b))
    return {k: (0.5 * rng.standard_normal(v.shape)).astype(np.float32) for k, v in st.items()}


def close(got: torch.Tensor, want) -> None:
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL, atol=ATOL)


class TestMamba2:
    @pytest.mark.parametrize("use_pallas", [False, True], ids=["jnp", "pallas"])
    @pytest.mark.parametrize("carry", [False, True], ids=["fresh", "carried"])
    def test_forward_matches_reference(self, mamba, use_pallas, carry):
        jp, tp = mamba
        x = np.random.default_rng(6).standard_normal((2, 40, 64)).astype(np.float32)  # 40 = 2.5 chunks
        st = carried_state(jp, 2, 7) if carry else None
        want_y, want_st = JS.mamba2_forward(
            jp, jnp.asarray(x), None if st is None else jax.tree_util.tree_map(jnp.asarray, st),
            chunk=16, use_pallas=use_pallas)
        got_y, got_st = TS.mamba2_forward(
            tp, torch.from_numpy(x), None if st is None else params_from_numpy(st, "cpu"),
            chunk=16)
        close(got_y, want_y)
        close(got_st["conv"], want_st["conv"])
        close(got_st["ssm"], want_st["ssm"])

    def test_step_matches_reference(self, mamba):
        jp, tp = mamba
        x = np.random.default_rng(8).standard_normal((3, 64)).astype(np.float32)
        st = carried_state(jp, 3, 9)
        want_y, want_st = JS.mamba2_step(jp, jnp.asarray(x),
                                         jax.tree_util.tree_map(jnp.asarray, st))
        got_y, got_st = TS.mamba2_step(tp, torch.from_numpy(x), params_from_numpy(st, "cpu"))
        close(got_y, want_y)
        close(got_st["conv"], want_st["conv"])
        close(got_st["ssm"], want_st["ssm"])

    def test_prefill_then_steps_equal_one_prefill(self, mamba):
        """The state handed from a chunked prefill to single steps carries
        on exactly where a longer prefill would."""
        _, tp = mamba
        x = torch.from_numpy(np.random.default_rng(10).standard_normal((2, 23, 64))
                             .astype(np.float32))
        want, _ = TS.mamba2_forward(tp, x, chunk=16)
        y, st = TS.mamba2_forward(tp, x[:, :19], chunk=16)
        ys = [y]
        for t in range(19, 23):
            yt, st = TS.mamba2_step(tp, x[:, t], st)
            ys.append(yt[:, None])
        np.testing.assert_allclose(torch.cat(ys, 1).numpy(), want.numpy(),
                                   rtol=RTOL, atol=ATOL)

    def test_init_matches_reference_layout_and_scales(self):
        want = JS.init_mamba2(jax.random.PRNGKey(0), d_model=64, d_state=16, head_p=16)
        got = TS.init_mamba2(generator=torch.Generator().manual_seed(0), device="cpu",
                             d_model=64, d_state=16, head_p=16)
        assert jax.tree_util.tree_map(lambda a: tuple(a.shape), want) == \
            jax.tree_util.tree_map(lambda t: tuple(t.shape), got)
        for key in ("a_log", "conv_b", "d_skip", "dt_bias"):
            np.testing.assert_allclose(got[key].numpy(), np.asarray(want[key]), rtol=1e-6)
        assert abs(float(got["conv_w"].std()) - 0.1) < 0.02
        assert abs(float(got["in_proj"].std()) * 8.0 - 1.0) < 0.05      # N(0, 1/64)
        assert TS.mamba2_meta(got) == JS.mamba2_meta(want)
