"""Port attention (`clipself_tpu_torch.ops.attention`) vs the JAX package's
XLA attention (`_xla_attention`: f32 logits and softmax), float32 on the
CPU. Same math in another summation order: rtol/atol 1e-5."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from clipself_tpu.ops import attention as jattention
from clipself_tpu_torch.ops import attention

TOL = 1e-5


# 127, 128, 129: the edges of the CUDA kernels' 128-row blocks, where the
# plain version is the bar they are held to on the card
@pytest.mark.parametrize("n", [65, 127, 128, 129, 197, 257])
@pytest.mark.parametrize("d", [32, 64])
def test_plain_matches_xla_attention(n, d):
    rng = np.random.default_rng(n + d)
    q, k, v = (rng.standard_normal((2, n, 3, d)).astype(np.float32) for _ in range(3))
    scale = d ** -0.5
    want = np.asarray(jattention._xla_attention(*(jnp.asarray(t) for t in (q, k, v)), scale))
    got = attention.attention_plain(*(torch.from_numpy(t) for t in (q, k, v)), scale).numpy()
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)


@pytest.mark.parametrize("n", [127, 128, 129])
def test_lse_plain_matches_xla_attention_and_numpy(n):
    """The forward that keeps its LSE (the bar of the training forward on the
    card) at the 128-row block edges: the output against `_xla_attention`,
    the LSE against a float64 log-sum-exp."""
    d, scale = 64, 0.125
    rng = np.random.default_rng(n)
    q, k, v = (rng.standard_normal((2, n, 3, d)).astype(np.float32) for _ in range(3))
    want = np.asarray(jattention._xla_attention(*(jnp.asarray(t) for t in (q, k, v)), scale))
    got, lse = attention.attention_lse_plain(*(torch.from_numpy(t) for t in (q, k, v)), scale)
    np.testing.assert_allclose(got.numpy(), want, rtol=TOL, atol=TOL)
    s = np.einsum("bqhd,bkhd->bhqk", q.astype(np.float64), k.astype(np.float64)) * scale
    want_lse = np.log(np.exp(s - s.max(-1, keepdims=True)).sum(-1)) + s.max(-1)
    np.testing.assert_allclose(lse.numpy(), want_lse, rtol=0, atol=TOL)


def test_multi_head_attention_on_cpu_takes_the_plain_version():
    rng = np.random.default_rng(0)
    # per-head views of a [B, N, W] projection, as the tower passes them
    q, k, v = (torch.from_numpy(rng.standard_normal((2, 33, 64)).astype(np.float32)) for _ in range(3))
    q, k, v = (t.view(2, 33, 2, 32) for t in (q, k, v))
    before = attention.LAUNCHES.count
    got = attention.multi_head_attention(q, k, v, 0.25)
    assert torch.equal(got, attention.attention_plain(q, k, v, 0.25))
    assert attention.LAUNCHES.count == before


def test_wrapper_rejects_devices_other_than_cpu_and_cuda():
    q = torch.empty(1, 4, 2, 16, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        attention.flash_attention(q, q, q, 0.25)
