"""Port RoPE (`clipself_tpu_torch.models.rope`, `ops.rope_roll`) vs the JAX
package, in float32 on the CPU.

The port's table functions are NumPy copies: pinned bit-equal. The rotation
itself is the same multiplies and adds in float32; XLA may contract a
multiply-add into an FMA where PyTorch does not, so it is pinned at 1e-6
(about 1 ULP at the |x| <= ~5 of a standard normal input). The backward is
the same composition on dy with the rolled tables: the same bar."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from clipself_tpu.models import rope as jrope
from clipself_tpu.ops import rope_roll as jrope_roll
from clipself_tpu_torch.models import rope
from clipself_tpu_torch.ops import rope_roll

TOL = 1e-6


@pytest.mark.parametrize("gh,gw,rope_dim", [(4, 4, 16), (14, 14, 32), (6, 9, 32)])
def test_table_copies_equal_originals(gh, gw, rope_dim):
    for got, want in zip(rope.rope_tables_np(gh, gw, rope_dim), jrope.rope_tables_np(gh, gw, rope_dim)):
        assert np.array_equal(got, want)
    sin = jrope.rope_tables_np(gh, gw, rope_dim)[1]
    for got, want in zip(rope._split_sin_np(sin), jrope._split_sin_np(sin)):
        assert np.array_equal(got, want)
    n = 1 + gh * gw
    for got, want in zip(
        rope.rope_tables_padded_np(gh, gw, rope_dim, 1, n + 3),
        jrope.rope_tables_padded_np(gh, gw, rope_dim, 1, n + 3),
    ):
        assert np.array_equal(got, want)
    for got, want in zip(
        rope.rope_tables_flat_np(gh, gw, 2 * rope_dim, 3, 1, n),
        jrope.rope_tables_flat_np(gh, gw, 2 * rope_dim, 3, 1, n),
    ):
        assert np.array_equal(got, want)


@pytest.mark.parametrize("gh,gw,heads,head_dim", [(4, 4, 2, 32), (14, 14, 2, 64), (5, 7, 3, 16)])
def test_apply_rope_flat_matches_jax(gh, gw, heads, head_dim):
    n = 1 + gh * gw
    x = np.random.default_rng(0).standard_normal((2, n, heads * head_dim)).astype(np.float32)
    want = np.asarray(jrope.apply_rope_flat(jnp.asarray(x), gh, gw, head_dim, 1, 16))
    got = rope.apply_rope_flat(torch.from_numpy(x), gh, gw, head_dim, 1, 16).numpy()
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)


@pytest.mark.parametrize("gh", [8, 14])
def test_plain_matches_jax_pallas_kernel_interpret(monkeypatch, gh):
    """The port's plain rolled RoPE (head tables [N, D]) against the JAX
    Pallas kernel run by the Pallas interpreter (head-tiled tables)."""
    monkeypatch.setattr(jrope_roll, "_INTERPRET", True)
    head_dim, heads = 64, 2
    n = 1 + gh * gh
    cos, sa, sb = jrope.rope_tables_flat_np(gh, gh, head_dim, heads, 1, n)
    a2, b2 = np.roll(sa, 1, -1), np.roll(sb, -1, -1)
    x = np.random.default_rng(1).standard_normal((2, n, heads * head_dim)).astype(np.float32)
    want = np.asarray(
        jrope_roll.rolled_rope(*(jnp.asarray(t) for t in (x, cos, sa, sb, a2, b2)))
    )
    tables = (torch.from_numpy(t[:, :head_dim].copy()) for t in (cos, sa, sb, a2, b2))
    got = rope_roll.rolled_rope(torch.from_numpy(x), *tables).numpy()
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)


@pytest.mark.parametrize("gh", [8, 14])
def test_backward_matches_jax_vjp_of_pallas_kernel_interpret(monkeypatch, gh):
    """The port's RoPE backward (`RolledRopeFn`, plain on the CPU) against
    `jax.vjp` of the JAX custom_vjp, whose backward runs the Pallas kernel
    in the interpreter with the rolled tables."""
    monkeypatch.setattr(jrope_roll, "_INTERPRET", True)
    head_dim, heads = 64, 2
    n = 1 + gh * gh
    cos, sa, sb = jrope.rope_tables_flat_np(gh, gh, head_dim, heads, 1, n)
    a2, b2 = np.roll(sa, 1, -1), np.roll(sb, -1, -1)
    rng = np.random.default_rng(2)
    x = rng.standard_normal((2, n, heads * head_dim)).astype(np.float32)
    dy = rng.standard_normal((2, n, heads * head_dim)).astype(np.float32)
    jt = [jnp.asarray(t) for t in (cos, sa, sb, a2, b2)]
    _, vjp = jax.vjp(lambda x_: jrope_roll.rolled_rope(x_, *jt), jnp.asarray(x))
    (want,) = vjp(jnp.asarray(dy))
    xt = torch.from_numpy(x).requires_grad_()
    tables = (torch.from_numpy(t[:, :head_dim].copy()) for t in (cos, sa, sb, a2, b2))
    y = rope_roll.rolled_rope(xt, *tables)
    assert type(y.grad_fn).__name__ == "RolledRopeFnBackward"
    (got,) = torch.autograd.grad(y, xt, torch.from_numpy(dy))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=TOL, atol=TOL)


@pytest.mark.parametrize("gh,gw,head_dim", [(4, 4, 32), (14, 14, 64), (5, 7, 16)])
def test_backward_tables_keep_the_parity_folding(gh, gw, head_dim):
    """The backward tables are the JAX package's `a_bwd`/`b_bwd`
    (`clipself_tpu/models/rope.py:216-217`) per head, and sit in the kernel's
    slots with the forward's parity: b_bwd (sin_a slot) is zero on odd
    lanes, a_bwd (sin_b slot) on even lanes."""
    n = 1 + gh * gw
    a_bwd, b_bwd = rope.rope_tables_bwd(gh, gw, head_dim, 1, 16, torch.device("cpu"))
    _, sa, sb = jrope.rope_tables_flat_np(gh, gw, head_dim, 3, 1, n)
    np.testing.assert_array_equal(a_bwd.numpy(), np.roll(sa, 1, -1)[:, :head_dim])
    np.testing.assert_array_equal(b_bwd.numpy(), np.roll(sb, -1, -1)[:, :head_dim])
    assert not b_bwd[:, 1::2].any() and not a_bwd[:, 0::2].any()
    assert b_bwd.any() and a_bwd.any()


@pytest.mark.parametrize("gh,gw,heads,head_dim", [(4, 4, 2, 32), (5, 7, 3, 16)])
def test_apply_rope_flat_gradient_goes_through_the_function(monkeypatch, gh, gw, heads, head_dim):
    """A gradient through `apply_rope_flat` comes from `RolledRopeFn`'s
    backward (the rolled-table composition) and equals `jax.vjp` of the JAX
    `apply_rope_flat`."""
    n = 1 + gh * gw
    rng = np.random.default_rng(3)
    x = rng.standard_normal((2, n, heads * head_dim)).astype(np.float32)
    dy = rng.standard_normal((2, n, heads * head_dim)).astype(np.float32)
    _, vjp = jax.vjp(lambda x_: jrope.apply_rope_flat(x_, gh, gw, head_dim, 1, 16), jnp.asarray(x))
    (want,) = vjp(jnp.asarray(dy))
    calls = []
    bwd = rope_roll.rolled_rope_bwd
    monkeypatch.setattr(rope_roll, "rolled_rope_bwd", lambda *a: calls.append(1) or bwd(*a))
    xt = torch.from_numpy(x).requires_grad_()
    y = rope.apply_rope_flat(xt, gh, gw, head_dim, 1, 16)
    assert type(y.grad_fn).__name__ == "RolledRopeFnBackward"
    (got,) = torch.autograd.grad(y, xt, torch.from_numpy(dy))
    assert calls == [1]
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=TOL, atol=TOL)


def test_rope_tables_prefix_rows_are_identity():
    cos, sin_a, sin_b = rope.rope_tables(3, 4, 16, 1, 16, torch.device("cpu"))
    assert cos.shape == (13, 16) and cos.dtype == torch.float32
    assert torch.equal(cos[0], torch.ones(16))
    assert not sin_a[0].any() and not sin_b[0].any()
    # parity folding the CUDA kernel relies on
    assert not sin_a[:, 1::2].any() and not sin_b[:, 0::2].any()


def test_tables_first_built_under_inference_mode_serve_a_training_step():
    """The evaluator may build the cached tables under inference_mode; a
    later training step saves them for its backward, so they must be normal
    tensors."""
    grid = (3, 5, 16, 1, 16, torch.device("cpu"))
    rope.rope_tables.cache_clear()
    rope.rope_tables_bwd.cache_clear()
    with torch.inference_mode():
        rope.apply_rope_flat(torch.randn(1, 16, 32), 3, 5, 16, 1, 16)
    for t in rope.rope_tables(*grid) + rope.rope_tables_bwd(*grid):
        assert not t.is_inference()
    x = torch.randn(1, 16, 32, requires_grad=True)
    rope.apply_rope_flat(x, 3, 5, 16, 1, 16).sum().backward()
    assert x.grad is not None


def test_wrapper_rejects_devices_other_than_cpu_and_cuda():
    x = torch.empty(1, 2, 4, device="meta")
    t = torch.empty(2, 4, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        rope_roll.rolled_rope(x, t, t, t, t, t)
