"""Port RoPE (`clipself_tpu_torch.models.rope`, `ops.rope_roll`) vs the JAX
package, in float32 on the CPU.

The port's table functions are NumPy copies: pinned bit-equal. The rotation
itself is the same multiplies and adds in float32; XLA may contract a
multiply-add into an FMA where PyTorch does not, so it is pinned at 1e-6
(about 1 ULP at the |x| <= ~5 of a standard normal input). The backward is
the same composition on dy with the rolled tables: the same bar.
`rolled_rope_qk` rotates q and k together and `rolled_rope` one tensor, both
from the packed tables: on the CPU they are the same plain composition, so
the first equals two calls of the second bit for bit, and the packed tables
are pinned equal to the three they came from."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from clipself_tpu.models import rope as jrope
from clipself_tpu.ops import rope_roll as jrope_roll
from clipself_tpu_torch.models import rope
from clipself_tpu_torch.ops import rope_roll

from torch_threads import capped_threads  # noqa: F401  (module fixture)

TOL = 1e-6


def _packed_pair(flat, head_dim):
    """(forward, backward) packed tables of one head from the JAX package's
    head-tiled (cos, sin_a, sin_b, a_bwd, b_bwd)."""
    cos, sa, sb, a2, b2 = (torch.from_numpy(t[:, :head_dim].copy()) for t in flat)
    return rope_roll.pack_tables(cos, sa, sb), rope_roll.pack_tables(cos, b2, a2)


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
    tables = _packed_pair((cos, sa, sb, a2, b2), head_dim)
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
    tables = _packed_pair((cos, sa, sb, a2, b2), head_dim)
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


def _qk_case(gh, heads, head_dim, seed):
    """q, k, dq, dk [2, N, heads * head_dim] and the JAX head-tiled tables."""
    n = 1 + gh * gh
    rng = np.random.default_rng(seed)
    q, k, dq, dk = (rng.standard_normal((2, n, heads * head_dim)).astype(np.float32) for _ in range(4))
    cos, sa, sb = jrope.rope_tables_flat_np(gh, gh, head_dim, heads, 1, n)
    return q, k, dq, dk, (cos, sa, sb, np.roll(sa, 1, -1), np.roll(sb, -1, -1))


@pytest.mark.parametrize("gh,heads,head_dim", [(8, 2, 64), (14, 2, 64), (5, 3, 12)])
def test_qk_equals_two_calls_and_jax_pallas_kernel_interpret(monkeypatch, gh, heads, head_dim):
    """`rolled_rope_qk`, forward and gradient, against two `rolled_rope`
    calls (equal) and against the JAX `rolled_rope` and its vjp with the
    Pallas kernel in the interpreter (1e-6), for q and for k."""
    monkeypatch.setattr(jrope_roll, "_INTERPRET", True)
    q, k, dq, dk, flat = _qk_case(gh, heads, head_dim, seed=4)
    packed, packed_bwd = _packed_pair(flat, head_dim)
    qt, kt = (torch.from_numpy(t).requires_grad_() for t in (q, k))
    yq, yk = rope_roll.rolled_rope_qk(qt, kt, packed, packed_bwd)
    gq, gk = torch.autograd.grad((yq, yk), (qt, kt), (torch.from_numpy(dq), torch.from_numpy(dk)))
    jt = [jnp.asarray(t) for t in flat]
    for x, dy, y, g in ((q, dq, yq, gq), (k, dk, yk, gk)):
        xt = torch.from_numpy(x).requires_grad_()
        one = rope_roll.rolled_rope(xt, packed, packed_bwd)
        assert torch.equal(y, one)
        assert torch.equal(g, torch.autograd.grad(one, xt, torch.from_numpy(dy))[0])
        want, vjp = jax.vjp(lambda x_: jrope_roll.rolled_rope(x_, *jt), jnp.asarray(x))
        np.testing.assert_allclose(y.detach().numpy(), np.asarray(want), rtol=TOL, atol=TOL)
        np.testing.assert_allclose(g.numpy(), np.asarray(vjp(jnp.asarray(dy))[0]), rtol=TOL, atol=TOL)


@pytest.mark.parametrize("gh,gw,heads,head_dim", [(4, 4, 2, 32), (14, 14, 2, 64), (5, 7, 3, 16)])
def test_apply_rope_flat_qk_matches_jax(gh, gw, heads, head_dim):
    n = 1 + gh * gw
    rng = np.random.default_rng(5)
    q, k = (rng.standard_normal((2, n, heads * head_dim)).astype(np.float32) for _ in range(2))
    got = rope.apply_rope_flat_qk(torch.from_numpy(q), torch.from_numpy(k), gh, gw, head_dim, 1, 16)
    for x, y in zip((q, k), got):
        want = np.asarray(jrope.apply_rope_flat(jnp.asarray(x), gh, gw, head_dim, 1, 16))
        np.testing.assert_allclose(y.numpy(), want, rtol=TOL, atol=TOL)
        assert torch.equal(y, rope.apply_rope_flat(torch.from_numpy(x), gh, gw, head_dim, 1, 16))


@pytest.mark.parametrize("gh,gw,head_dim", [(4, 4, 32), (14, 14, 64), (5, 7, 16), (3, 4, 12)])
def test_packed_tables_equal_their_sources(gh, gw, head_dim):
    """The packed forward table holds {cos[2i], cos[2i+1], sin_a[2i],
    sin_b[2i+1]}; the packed backward table holds b_bwd in the sin_a slot
    and a_bwd in the sin_b slot. What is not stored is zero in the sources,
    so unpacking gives the three tables back."""
    key = (gh, gw, head_dim, 1, 16, torch.device("cpu"))
    cos, sin_a, sin_b = rope.rope_tables(*key)
    a_bwd, b_bwd = rope.rope_tables_bwd(*key)
    packed, packed_bwd = rope.rope_tables_packed(*key)
    n = 1 + gh * gw
    for table, (c, a, b) in ((packed, (cos, sin_a, sin_b)), (packed_bwd, (cos, b_bwd, a_bwd))):
        assert table.shape == (n, head_dim // 2, 4) and table.dtype == torch.float32
        assert table.is_contiguous() and not table.is_inference()
        assert torch.equal(table[..., 0], c[:, 0::2]) and torch.equal(table[..., 1], c[:, 1::2])
        assert torch.equal(table[..., 2], a[:, 0::2]) and torch.equal(table[..., 3], b[:, 1::2])
        assert not a[:, 1::2].any() and not b[:, 0::2].any()
        for got, want in zip(rope_roll.unpack_tables(table), (c, a, b)):
            assert torch.equal(got, want)
    # the prefix (CLS) row is the identity row, not a branch
    assert torch.equal(packed[0], torch.tensor([1.0, 1.0, 0.0, 0.0]).expand(head_dim // 2, 4))
    assert torch.equal(packed_bwd[0], packed[0])


@pytest.mark.parametrize("gh,gw,heads,head_dim", [(4, 4, 2, 32), (5, 7, 3, 16)])
def test_apply_rope_flat_qk_gradient_goes_through_the_function(monkeypatch, gh, gw, heads, head_dim):
    """Both outputs of `apply_rope_flat_qk` hang on one `RolledRopeFn`, whose
    backward (one call on (dq, dk) with the packed backward table, not
    autograd of the plain version) makes both gradients; they equal
    `jax.vjp` of the JAX `apply_rope_flat`. The gradients arrive as
    non-contiguous views, as the flash backward hands them over."""
    n = 1 + gh * gw
    rng = np.random.default_rng(6)
    q, k = (rng.standard_normal((2, n, heads * head_dim)).astype(np.float32) for _ in range(2))
    d = rng.standard_normal((2, n, 2, heads * head_dim)).astype(np.float32)
    calls = []
    bwd = rope_roll.rolled_rope_bwd
    monkeypatch.setattr(rope_roll, "rolled_rope_bwd", lambda *a: calls.append(1) or bwd(*a))
    plain = rope_roll.rolled_rope_plain
    seen = []  # whether autograd was recording when the plain version ran
    monkeypatch.setattr(
        rope_roll, "rolled_rope_plain", lambda x, *t: seen.append(torch.is_grad_enabled()) or plain(x, *t)
    )
    qt, kt = (torch.from_numpy(t).requires_grad_() for t in (q, k))
    yq, yk = rope.apply_rope_flat_qk(qt, kt, gh, gw, head_dim, 1, 16)
    assert type(yq.grad_fn).__name__ == type(yk.grad_fn).__name__ == "RolledRopeFnBackward"
    assert yq.grad_fn is yk.grad_fn
    dq, dk = torch.from_numpy(d)[:, :, 0], torch.from_numpy(d)[:, :, 1]
    assert not dq.is_contiguous()
    gq, gk = torch.autograd.grad((yq, yk), (qt, kt), (dq, dk))
    assert calls == [1]
    assert seen == [False] * 4  # q and k forward, dq and dk backward: none under autograd
    for x, dy, g in ((q, d[:, :, 0], gq), (k, d[:, :, 1], gk)):
        _, vjp = jax.vjp(lambda x_: jrope.apply_rope_flat(x_, gh, gw, head_dim, 1, 16), jnp.asarray(x))
        np.testing.assert_allclose(g.numpy(), np.asarray(vjp(jnp.asarray(dy))[0]), rtol=TOL, atol=TOL)


def test_qk_gradient_of_one_output_alone():
    """A loss that uses only the rotated q still gets dq from the Function,
    and k a zero gradient."""
    key = (3, 5, 16, 1, 16)
    q, k = (torch.randn(1, 16, 32, requires_grad=True) for _ in range(2))
    yq, _ = rope.apply_rope_flat_qk(q, k, *key)
    dy = torch.randn(1, 16, 32)
    gq, gk = torch.autograd.grad(yq, (q, k), dy)
    q2 = q.detach().requires_grad_()
    (want,) = torch.autograd.grad(rope.apply_rope_flat(q2, *key), q2, dy)
    assert torch.equal(gq, want) and not gk.any()


def test_packed_tables_first_built_under_inference_mode_serve_a_training_step():
    grid = (3, 5, 16, 1, 16, torch.device("cpu"))
    for cached in (rope.rope_tables, rope.rope_tables_bwd, rope.rope_tables_packed):
        cached.cache_clear()
    with torch.inference_mode():
        rope.apply_rope_flat_qk(torch.randn(1, 16, 32), torch.randn(1, 16, 32), 3, 5, 16, 1, 16)
    for t in rope.rope_tables_packed(*grid):
        assert not t.is_inference()
    q, k = (torch.randn(1, 16, 32, requires_grad=True) for _ in range(2))
    yq, yk = rope.apply_rope_flat_qk(q, k, 3, 5, 16, 1, 16)
    (yq.sum() + yk.sum()).backward()
    assert q.grad is not None and k.grad is not None


def test_packed_wrapper_rejects_what_it_does_not_take():
    packed = torch.empty(2, 2, 4, device="meta")
    x = torch.empty(1, 2, 4, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        rope_roll.rolled_rope_qk(x, x, packed, packed)


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
    for cached in (rope.rope_tables, rope.rope_tables_bwd, rope.rope_tables_packed):
        cached.cache_clear()
    with torch.inference_mode():
        rope.apply_rope_flat(torch.randn(1, 16, 32), 3, 5, 16, 1, 16)
    for t in rope.rope_tables(*grid) + rope.rope_tables_bwd(*grid) + rope.rope_tables_packed(*grid):
        assert not t.is_inference()
    x = torch.randn(1, 16, 32, requires_grad=True)
    rope.apply_rope_flat(x, 3, 5, 16, 1, 16).sum().backward()
    assert x.grad is not None


def test_wrapper_rejects_devices_other_than_cpu_and_cuda():
    x = torch.empty(1, 2, 4, device="meta")
    t = torch.empty(2, 2, 4, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        rope_roll.rolled_rope(x, t, t)
