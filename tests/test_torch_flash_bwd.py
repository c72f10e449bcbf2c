"""The port's flash-attention backward (`clipself_tpu_torch.ops.attention`)
against the JAX package, float32 on the CPU.

`attention_bwd_plain` (the formulas the CUDA backward computes) is held
against the JAX Pallas backward `flash_attention_bwd` run by the Pallas
interpreter, both fed the same O and the row statistics computed in NumPy
(l and m for the Pallas kernel, lse = m + log l for the port). Gradients
through `FlashAttentionFn` are held against `jax.vjp` of the JAX XLA
attention. Same math in another summation order, with exp(S - lse) against
exp(S - m) / l: atol 1e-5 on gradients of standard-normal inputs (|g| < ~2).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from clipself_tpu.ops import attention as jattention
from clipself_tpu.ops.flash_bwd import flash_attention_bwd as jflash_bwd
from clipself_tpu_torch.ops import attention

from torch_threads import capped_threads  # noqa: F401  (module fixture)

TOL = 1e-5


def _stats(q, k, scale, seg=None):
    """(m, l, lse) float32 [B, H, N] of [B, N, H, D] float32 q, k, computed in
    float64; with a segment row, pairs of different segments are masked."""
    s = np.einsum("bqhd,bkhd->bhqk", q.astype(np.float64), k.astype(np.float64)) * scale
    if seg is not None:
        s = np.where(seg[:, None, :, None] == seg[:, None, None, :], s, -np.inf)
    m = s.max(-1)
    l = np.exp(s - m[..., None]).sum(-1)
    return m.astype(np.float32), l.astype(np.float32), (m + np.log(l)).astype(np.float32)


def _out(q, k, v, scale, seg=None):
    s = np.einsum("bqhd,bkhd->bhqk", q.astype(np.float64), k.astype(np.float64)) * scale
    if seg is not None:
        s = np.where(seg[:, None, :, None] == seg[:, None, None, :], s, -np.inf)
    p = np.exp(s - s.max(-1, keepdims=True))
    p /= p.sum(-1, keepdims=True)
    return np.einsum("bhqk,bkhd->bqhd", p, v).astype(np.float32)


def _jax_bwd(q, k, v, o, m, l, do, scale, seg=None):
    """The Pallas backward in interpret mode on [B, N, H, D] inputs."""
    t = lambda a: jnp.asarray(np.swapaxes(a, 1, 2))  # noqa: E731  [B, H, N, D]
    grads = jflash_bwd(
        t(q), t(k), t(v), t(o), jnp.asarray(l), jnp.asarray(m), t(do),
        segment_ids=None if seg is None else jnp.asarray(seg), sm_scale=scale,
        block_q=128, block_k=128, interpret=True,
    )
    return [np.swapaxes(np.asarray(g), 1, 2) for g in grads]


# 80, 88, 104, 112: the large towers' head dims, which the wgmma kernels
# take on two panels
@pytest.mark.parametrize("d", [32, 64, 80, 88, 104, 112])
def test_plain_backward_matches_pallas_interpret_unsegmented(d):
    b, n, h = 2, 256, 2
    scale = d ** -0.5
    rng = np.random.default_rng(d)
    q, k, v, do = (rng.standard_normal((b, n, h, d)).astype(np.float32) for _ in range(4))
    m, l, lse = _stats(q, k, scale)
    o = _out(q, k, v, scale)
    want = _jax_bwd(q, k, v, o, m, l, do, scale)
    got = attention.attention_bwd_plain(
        *(torch.from_numpy(a) for a in (q, k, v, o, lse, do)), scale
    )
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), w, rtol=0, atol=TOL)


def _check_ragged(d, n, valid, seed):
    """The TPU path pads ``valid`` tokens to ``n`` with a segment row (pad
    queries attend pad keys, dO zero on pad rows); the port runs the valid
    tokens as they are. The first ``valid`` rows must agree."""
    b, h = 2, 2
    scale = d ** -0.5
    rng = np.random.default_rng(seed)
    q, k, v, do = (rng.standard_normal((b, n, h, d)).astype(np.float32) for _ in range(4))
    do[:, valid:] = 0.0
    seg = np.broadcast_to((np.arange(n) < valid).astype(np.int32), (b, n)).copy()
    m, l, _ = _stats(q, k, scale, seg)
    want = _jax_bwd(q, k, v, _out(q, k, v, scale, seg), m, l, do, scale, seg)
    qr, kr, vr, dor = (a[:, :valid] for a in (q, k, v, do))
    _, _, lse = _stats(qr, kr, scale)
    got = attention.attention_bwd_plain(
        *(torch.from_numpy(np.ascontiguousarray(a)) for a in (qr, kr, vr, _out(qr, kr, vr, scale), lse, dor)),
        scale,
    )
    for g, w in zip(got, want):
        assert g.shape == (b, valid, h, d)
        np.testing.assert_allclose(g.numpy(), w[:, :valid], rtol=0, atol=TOL)


@pytest.mark.parametrize("d", [32, 64])
def test_plain_backward_ragged_matches_pallas_interpret_segmented(d):
    _check_ragged(d, n=256, valid=200, seed=d + 1)


@pytest.mark.parametrize("valid", [127, 128, 129])
def test_plain_backward_at_block_edges_matches_pallas_interpret(valid):
    """head_dim 64 at the edges of the CUDA backward's 128-key blocks, where
    the plain version is the bar the kernel is held to on the card: one token
    short of a block, a whole block (no padding, no segment row), one token
    into the next."""
    if valid == 128:
        d, scale = 64, 0.125
        rng = np.random.default_rng(valid)
        q, k, v, do = (rng.standard_normal((2, 128, 2, d)).astype(np.float32) for _ in range(4))
        m, l, lse = _stats(q, k, scale)
        o = _out(q, k, v, scale)
        want = _jax_bwd(q, k, v, o, m, l, do, scale)
        got = attention.attention_bwd_plain(
            *(torch.from_numpy(a) for a in (q, k, v, o, lse, do)), scale
        )
        for g, w in zip(got, want):
            np.testing.assert_allclose(g.numpy(), w, rtol=0, atol=TOL)
    else:
        _check_ragged(64, n=256, valid=valid, seed=valid)


def test_lse_plain_matches_numpy_and_the_plain_forward():
    rng = np.random.default_rng(5)
    q, k, v = (rng.standard_normal((2, 65, 3, 32)).astype(np.float32) for _ in range(3))
    out, lse = attention.attention_lse_plain(*(torch.from_numpy(a) for a in (q, k, v)), 0.2)
    np.testing.assert_allclose(lse.numpy(), _stats(q, k, 0.2)[2], rtol=0, atol=TOL)
    np.testing.assert_allclose(
        out.numpy(),
        attention.attention_plain(*(torch.from_numpy(a) for a in (q, k, v)), 0.2).numpy(),
        rtol=0, atol=TOL,
    )


@pytest.mark.parametrize(
    "d,n",
    [(d, n) for d in (32, 64) for n in (65, 127, 128, 129, 197)]
    + [(d, 129) for d in (80, 88, 104, 112)],
)
def test_function_gradients_match_jax_vjp(monkeypatch, d, n):
    """On the CPU the gradient through `flash_attention` is produced by
    `FlashAttentionFn.backward` (its plain backward runs once), not by
    autograd of the plain forward, and equals `jax.vjp` of `_xla_attention`."""
    scale = d ** -0.5
    rng = np.random.default_rng(n * d)
    q, k, v, do = (rng.standard_normal((2, n, 3, d)).astype(np.float32) for _ in range(4))
    _, vjp = jax.vjp(
        lambda *a: jattention._xla_attention(*a, scale), *(jnp.asarray(a) for a in (q, k, v))
    )
    want = vjp(jnp.asarray(do))
    calls = []
    plain_bwd = attention.attention_bwd_plain
    monkeypatch.setattr(
        attention, "attention_bwd_plain", lambda *a: calls.append(1) or plain_bwd(*a)
    )
    qt, kt, vt = (torch.from_numpy(a).requires_grad_() for a in (q, k, v))
    out = attention.flash_attention(qt, kt, vt, scale)
    assert type(out.grad_fn).__name__ == "FlashAttentionFnBackward"
    got = torch.autograd.grad(out, (qt, kt, vt), torch.from_numpy(do))
    assert calls == [1]
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0, atol=TOL)


def test_no_grad_forward_keeps_no_lse(monkeypatch):
    """Under no_grad (teacher, evaluator) the forward takes the LSE-free
    path and records no graph."""
    seen = []
    fwd = attention.flash_attention_fwd
    monkeypatch.setattr(
        attention, "flash_attention_fwd", lambda *a, **kw: seen.append(kw) or fwd(*a, **kw)
    )
    q = torch.randn(1, 9, 2, 16, requires_grad=True)
    with torch.no_grad():
        out = attention.flash_attention(q, q, q, 0.25)
    assert out.grad_fn is None and seen == [{}]
    out = attention.flash_attention(q, q, q, 0.25)
    assert out.grad_fn is not None and seen[-1] == {"return_lse": True}
