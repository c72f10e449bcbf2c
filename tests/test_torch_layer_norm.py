"""Port fused LayerNorm (`clipself_tpu_torch.ops.layer_norm`) vs the JAX
package, on the CPU, from the same numpy-seeded inputs.

Against the Pallas kernel (`clipself_tpu.ops.layer_norm.fused_layer_norm`,
run by the Pallas interpreter) at shapes its block plan accepts, and against
the XLA branch of the JAX tower's `_FusableLayerNorm` (cast to x's dtype as
its call sites do) at the widths the Pallas plan refuses (170, 341, 2730)
and on strided views. Both sides compute the same float32 formulas; sums run
in another order and XLA may contract a multiply-add. Float32: 1e-5 absolute
on y and dx (values of order 1 to 10), 1e-5 of the largest entry on
dweight and dbias (sums over the rows). Bfloat16: both sides round one
float32 value to bfloat16, so y and dx agree within one bfloat16 ULP
(2^-7 relative, plus 1e-6 where the value vanishes); dweight and dbias stay
float32 sums of the same bfloat16-valued terms: 1e-5 of the largest entry.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from clipself_tpu.models.eva_vit import _FusableLayerNorm
from clipself_tpu.ops import layer_norm as jln
from clipself_tpu_torch.models import eva_vit
from clipself_tpu_torch.ops import layer_norm as ln

from torch_threads import capped_threads  # noqa: F401  (module fixture)

EPS = 1e-6
F32_ABS = 1e-5
SUM_REL = 1e-5
BF16_ULP = 2.0 ** -7

_JDT = {torch.float32: jnp.float32, torch.bfloat16: jnp.bfloat16}


def _inputs(shape, dtype, seed):
    """x and dy of ``shape`` rounded to ``dtype``, weight and bias float32,
    all as float32 numpy arrays."""
    rng = np.random.default_rng(seed)
    w = shape[-1]

    def rounded(a):
        return torch.from_numpy(a.astype(np.float32)).to(dtype).float().numpy()

    x = rounded(rng.standard_normal(shape) * 3 + 0.5)
    dy = rounded(rng.standard_normal(shape))
    weight = (rng.standard_normal(w) * 0.2 + 1.0).astype(np.float32)
    bias = (rng.standard_normal(w) * 0.1).astype(np.float32)
    return x, dy, weight, bias


def _assert_close(got, want, dtype, what):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert got.shape == want.shape, what
    if dtype == torch.float32:
        np.testing.assert_allclose(got, want, rtol=0, atol=F32_ABS, err_msg=what)
    else:
        assert (np.abs(got - want) <= BF16_ULP * np.abs(want) + 1e-6).all(), what


def _assert_sums_close(got, want, what):
    want = np.asarray(want, np.float32)
    np.testing.assert_allclose(
        got.numpy(), want, rtol=0, atol=SUM_REL * np.abs(want).max(), err_msg=what
    )


def _port_forward_and_grads(x, dy, weight, bias, dtype, view=None):
    """y and (dx, dweight, dbias) of the port's `layer_norm`; ``view`` slices
    the input first, so that the op sees a strided view."""
    xt = torch.from_numpy(x).to(dtype)
    if view is not None:
        xt = view(xt)
        assert not xt.is_contiguous()
    xt = xt.detach().requires_grad_()
    wt = torch.from_numpy(weight).requires_grad_()
    bt = torch.from_numpy(bias).requires_grad_()
    y = ln.layer_norm(xt, wt, bt, EPS)
    assert y.dtype == dtype and y.is_contiguous()
    assert type(y.grad_fn).__name__ == "LayerNormFnBackward"
    dyt = torch.from_numpy(dy).to(dtype)
    if view is not None:
        dyt = view(dyt).contiguous()
    grads = torch.autograd.grad(y, (xt, wt, bt), dyt)
    assert grads[0].dtype == dtype and grads[1].dtype == grads[2].dtype == torch.float32
    return y.detach().float(), grads[0].float(), grads[1], grads[2]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("shape", [(2, 8, 128), (1, 256, 256)], ids=["2x8x128", "1x256x256"])
def test_matches_jax_pallas_kernel_interpret(monkeypatch, shape, dtype):
    """Forward and dx, dweight, dbias against the Pallas kernels in the
    interpreter, through `jax.vjp` of the JAX custom_vjp."""
    monkeypatch.setattr(jln, "_INTERPRET", True)
    assert jln.supported(shape[1], shape[2])
    x, dy, weight, bias = _inputs(shape, dtype, seed=shape[1])
    jx, jdy = (jnp.asarray(a, _JDT[dtype]) for a in (x, dy))
    want_y, vjp = jax.vjp(
        lambda x_, s_, b_: jln.fused_layer_norm(x_, s_, b_, EPS),
        jx, jnp.asarray(weight), jnp.asarray(bias),
    )
    want_dx, want_dw, want_db = vjp(jdy)
    assert want_y.dtype == _JDT[dtype]
    y, dx, dw, db = _port_forward_and_grads(x, dy, weight, bias, dtype)
    _assert_close(y, want_y, dtype, "y")
    _assert_close(dx, want_dx, dtype, "dx")
    _assert_sums_close(dw, want_dw, "dweight")
    _assert_sums_close(db, want_db, "dbias")


_VIEWS = {
    "contiguous": None,
    "drop_cls": lambda t: t[:, 1:],  # the dense path's final norm
    "cls_rows": lambda t: t[:, 0],   # the CLS path's final norm
}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize(
    "shape,view",
    [
        ((2, 5, 170), "contiguous"),
        ((1, 7, 341), "contiguous"),
        ((2, 3, 2730), "contiguous"),
        ((2, 6, 128), "drop_cls"),
        ((3, 4, 341), "drop_cls"),
        ((4, 3, 128), "cls_rows"),
    ],
    ids=lambda v: v if isinstance(v, str) else "x".join(map(str, v)),
)
def test_matches_jax_xla_branch(shape, view, dtype):
    """Forward and gradients against the XLA composition of the JAX tower's
    LayerNorm module (`jax.vjp`), which takes these widths and the 2-D CLS
    rows; its float32 output is cast to x's dtype as its call sites do."""
    assert view != "contiguous" or not jln.supported(shape[1], shape[2])
    x, dy, weight, bias = _inputs(shape, dtype, seed=shape[2] + len(view))
    cut = _VIEWS[view] or (lambda t: t)
    jx, jdy = (jnp.asarray(cut(a), _JDT[dtype]) for a in (x, dy))

    def module(x_, s_, b_):
        out = _FusableLayerNorm(epsilon=EPS).apply({"params": {"scale": s_, "bias": b_}}, x_)
        return out.astype(x_.dtype)

    want_y, vjp = jax.vjp(module, jx, jnp.asarray(weight), jnp.asarray(bias))
    want_dx, want_dw, want_db = vjp(jdy)
    y, dx, dw, db = _port_forward_and_grads(x, dy, weight, bias, dtype, view=_VIEWS[view])
    _assert_close(y, want_y, dtype, "y")
    _assert_close(dx, want_dx, dtype, "dx")
    _assert_sums_close(dw, want_dw, "dweight")
    _assert_sums_close(db, want_db, "dbias")


def test_module_gradient_comes_from_the_function_backward(monkeypatch):
    """A gradient through the tower's `LayerNorm` module is made by
    `LayerNormFn.backward` (the kernel's formulas), not by autograd of the
    plain forward, and equals autograd of the plain forward."""
    x, dy, weight, bias = _inputs((2, 5, 96), torch.float32, seed=7)
    calls = []
    bwd = ln.layer_norm_bwd
    monkeypatch.setattr(ln, "layer_norm_bwd", lambda *a, **k: calls.append(k) or bwd(*a, **k))
    mod = eva_vit.LayerNorm(96, EPS)
    with torch.no_grad():
        mod.weight.copy_(torch.from_numpy(weight))
        mod.bias.copy_(torch.from_numpy(bias))
    xt = torch.from_numpy(x).requires_grad_()
    y = mod(xt)
    assert type(y.grad_fn).__name__ == "LayerNormFnBackward"
    got = torch.autograd.grad(y, (xt, mod.weight, mod.bias), torch.from_numpy(dy))
    assert calls == [dict(need_dx=True, need_dwb=True)]
    p = [t.detach().requires_grad_() for t in (xt, mod.weight, mod.bias)]
    want = torch.autograd.grad(ln.layer_norm_plain(*p, EPS), p, torch.from_numpy(dy))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), w.numpy(), rtol=0, atol=1e-5 * w.abs().max().item())


@pytest.mark.parametrize("needs", [(True, False, False), (False, True, False), (False, False, True)],
                         ids=["x", "weight", "bias"])
def test_backward_honours_needs_input_grad(monkeypatch, needs):
    x, dy, weight, bias = _inputs((3, 64), torch.float32, seed=8)
    calls = []
    bwd = ln.layer_norm_bwd
    monkeypatch.setattr(ln, "layer_norm_bwd", lambda *a, **k: calls.append(k) or bwd(*a, **k))
    tensors = [torch.from_numpy(a).requires_grad_(n) for a, n in zip((x, weight, bias), needs)]
    y = ln.layer_norm(*tensors, EPS)
    y.backward(torch.from_numpy(dy))
    assert calls == [dict(need_dx=needs[0], need_dwb=needs[1] or needs[2])]
    ref = ln.layer_norm_bwd_plain(
        *(torch.from_numpy(a) for a in (x, dy)),
        *ln.layer_norm_stats_plain(*(torch.from_numpy(a) for a in (x, weight, bias)), EPS)[1:],
        torch.from_numpy(weight),
    )
    for t, n, want in zip(tensors, needs, ref):
        if n:
            np.testing.assert_array_equal(t.grad.numpy(), want.numpy())
        else:
            assert t.grad is None


def test_forward_without_gradients_writes_no_stats(monkeypatch):
    """Under no_grad, or when no input needs a gradient, `layer_norm` runs
    the stats-free forward outside the Function; otherwise the forward with
    the statistics the backward takes."""
    x, _, weight, bias = (torch.from_numpy(a) for a in _inputs((2, 3, 32), torch.float32, seed=9))
    seen = []
    fwd = ln.layer_norm_fwd

    def spy(*a, return_stats=False):
        seen.append(return_stats)
        return fwd(*a, return_stats=return_stats)

    monkeypatch.setattr(ln, "layer_norm_fwd", spy)
    assert ln.layer_norm(x, weight, bias, EPS).grad_fn is None
    with torch.no_grad():
        assert ln.layer_norm(x, weight.clone().requires_grad_(), bias, EPS).grad_fn is None
    assert seen == [False, False]
    assert ln.layer_norm(x, weight.clone().requires_grad_(), bias, EPS).grad_fn is not None
    assert seen == [False, False, True]


def test_module_returns_the_input_dtype():
    """The module rounds its float32 result once to x's dtype, the value the
    JAX call sites' cast gives."""
    x, _, weight, bias = _inputs((2, 4, 170), torch.bfloat16, seed=10)
    mod = eva_vit.LayerNorm(170, EPS)
    with torch.no_grad():
        mod.weight.copy_(torch.from_numpy(weight))
        mod.bias.copy_(torch.from_numpy(bias))
        got = mod(torch.from_numpy(x).bfloat16())
    assert got.dtype == torch.bfloat16
    want = _FusableLayerNorm(epsilon=EPS).apply(
        {"params": {"scale": jnp.asarray(weight), "bias": jnp.asarray(bias)}},
        jnp.asarray(x, jnp.bfloat16),
    ).astype(jnp.bfloat16)
    _assert_close(got.float(), want, torch.bfloat16, "y")


@pytest.mark.parametrize(
    "make,want",
    [
        (lambda t: t, (24, 24, 0, 8)),                      # contiguous: one run of rows
        (lambda t: t[:, 1:], (18, 3, 32, 8)),               # [6, 3, 8] view of [6, 4, 8]
        (lambda t: t[:, 0], (6, 6, 0, 32)),                 # [6, 8] rows 32 apart
        (lambda t: t.reshape(2, 3, 4, 8), (24, 24, 0, 8)),  # any rank when contiguous
    ],
    ids=["contiguous", "drop_cls", "cls_rows", "rank4"],
)
def test_row_layout_of_views(make, want):
    """What the kernels are told about x's rows: (rows, n_inner,
    stride_outer, stride_inner), row r at (r // n_inner) * stride_outer +
    (r % n_inner) * stride_inner."""
    t = torch.arange(6 * 4 * 8, dtype=torch.float32).reshape(6, 4, 8)
    x = make(t)
    rows, n_inner, s_outer, s_inner = ln._rows(x, "test")
    assert (rows, n_inner, s_outer, s_inner) == want
    flat = x.reshape(-1, 8)
    for r in range(rows):
        start = (r // n_inner) * s_outer + (r % n_inner) * s_inner
        assert t.flatten()[x.storage_offset() + start].item() == flat[r, 0].item()


def test_wrapper_rejects_what_the_kernels_do_not_take():
    x = torch.empty(1, 2, 4, device="meta")
    w = torch.empty(4, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        ln.layer_norm(x, w, w, EPS)
    t = torch.zeros(2, 3, 4, 8)
    with pytest.raises(ValueError, match="unit stride"):
        ln._rows(t.transpose(-1, -2), "test")
    with pytest.raises(ValueError, match="2-D or 3-D view"):
        ln._rows(t[:, :, 1:], "test")


@pytest.mark.parametrize(
    "width,vec,group_warps,chunks",
    [(768, 8, 2, 2), (1024, 8, 2, 2), (2048, 8, 4, 2), (2730, 2, 6, 8), (2731, 1, 6, 15)],
)
def test_backward_plan_at_the_towers_widths(width, vec, group_warps, chunks):
    """bfloat16 rows of the B/16 and L/14 towers (and a ragged width): the
    fewest warps a row that keep a lane within 16 elements of x, as many row
    groups as fill 16 warps, and shared memory a block can have."""
    plan = ln.bwd_plan(torch.bfloat16, width, vec)
    assert (plan.vec, plan.group_warps, plan.chunks) == (vec, group_warps, chunks)
    assert plan.chunks * vec <= ln.BWD_LANE_ELEMS
    assert plan.chunks * 32 * group_warps * vec >= width > (plan.chunks - 1) * 32 * group_warps * vec
    assert plan.groups == 16 // group_warps and plan.threads == 32 * group_warps * plan.groups <= 512
    # the budget is in elements: float32 rows take as many warps
    assert ln.bwd_plan(torch.float32, width, min(vec, 4)).group_warps == group_warps
    assert plan.shared_bytes <= 232448
    # the design that runs: "staged" where a bfloat16 load is 2 bytes, too
    # small for the registers design's copies, and below one row an SM
    assert ln.bwd_design(torch.bfloat16, width, vec, 8194, 132) == ("staged" if vec == 1 else "registers")
    assert ln.bwd_design(torch.float32, width, min(vec, 4), 8194, 132) == "registers"
    assert ln.bwd_design(torch.bfloat16, width, vec, 131, 132) == "staged"  # fewer rows than SMs


def test_backward_plan_blocks_and_width_limit():
    assert ln.bwd_max_blocks(132) == 264
    widest = ln.BWD_MAX_WIDTH
    assert widest >= 3 * 2730
    assert ln.bwd_plan(torch.bfloat16, widest, 8).group_warps == 16
    wide = ln.bwd_plan(torch.float32, widest, 4)
    assert wide.threads == 512 and wide.shared_bytes <= ln.MAX_SHARED_BYTES
    with pytest.raises(ValueError, match="wider than"):
        ln.bwd_plan(torch.bfloat16, widest + 1, 1)
    with pytest.raises(ValueError, match="wider than"):
        ln.bwd_plan(torch.float32, widest + 4, 4)
    with pytest.raises(ValueError, match="do not fit"):
        ln.bwd_plan(torch.bfloat16, 2730, 8)
    # wider rows take the staged design, up to one row of x and dy in its
    # shared memory (the wrapper raises past that)
    assert ln.bwd_design(torch.float32, widest + 4, 4, 8194, 132) == "staged"
    assert (ln.bwd_max_width(torch.float32), ln.bwd_max_width(torch.bfloat16)) == (14527, 19368)


@pytest.mark.parametrize("dtype,vec", [(torch.float32, 4), (torch.float32, 1), (torch.bfloat16, 8), (torch.bfloat16, 2)])
def test_backward_plan_fits_a_block_at_every_width(dtype, vec):
    """Every width the registers design takes (its rings of two rows a group
    and, overlaying them, the groups' sums) fits the shared memory of one
    block, and threads and chunks stay within the kernel's limits."""
    for width in range(vec, ln.BWD_MAX_WIDTH + 1, vec):
        plan = ln.bwd_plan(dtype, width, vec)
        assert plan.shared_bytes <= ln.MAX_SHARED_BYTES
        assert plan.threads <= 32 * ln.BWD_BLOCK_WARPS and plan.chunks * vec <= ln.BWD_LANE_ELEMS
        assert plan.group_warps == 1 or plan.groups <= 15


def test_backward_constants_come_from_the_kernel_source():
    """The plan's constants are read from `csrc/layer_norm.cu`, where the
    kernel sets them, so the two sides cannot disagree."""
    assert (ln.BWD_LANE_ELEMS, ln.BWD_BLOCK_WARPS, ln.BWD_STAGES) == (16, 16, 2)
    assert ln.MAX_SHARED_BYTES == 232448
    with pytest.raises(RuntimeError, match="no constexpr int kNoSuchConstant"):
        ln._kernel_constant("kNoSuchConstant")


def test_backward_vec_follows_rows_and_addresses():
    t = torch.zeros(2, 5, 1024, dtype=torch.bfloat16)
    assert ln.bwd_vec(t, t, t) == 8
    assert ln.bwd_vec(t[:, 1:], t[:, 1:].contiguous(), None) == 8
    odd = torch.zeros(2, 5, 2730, dtype=torch.bfloat16)
    assert ln.bwd_vec(odd, odd, odd) == 2
    assert ln.bwd_vec(t.view(-1)[1:1 + 4 * 1024].view(4, 1024), t[0, :4], None) == 1
    assert ln.bwd_vec(t.float(), t.float(), None) == 4


# (shape, view, blocks): one row; fewer rows than one block's row groups;
# more blocks than rows; many rows a group; the two strided views; two and
# four warps a row (float32 widths 1024 and 2048)
_MIRROR_CASES = [
    ((1, 1, 128), "contiguous", 1),
    ((1, 7, 128), "contiguous", 1),
    ((1, 7, 256), "contiguous", 10),
    ((4, 300, 128), "contiguous", 2),
    ((3, 9, 256), "drop_cls", 3),
    ((6, 5, 128), "cls_rows", 2),
    ((2, 9, 1024), "contiguous", 3),
    ((1, 37, 2048), "contiguous", 2),
]


@pytest.mark.parametrize("shape,view,blocks", _MIRROR_CASES, ids=lambda v: str(v))
def test_plan_mirror_matches_plain_and_jax_pallas_kernel(monkeypatch, shape, view, blocks):
    """The backward with its sums added in the kernel's order (rows strided
    over the grid's row groups, the groups of a block, then the blocks'
    partials eight ways) against the plain backward and the Pallas backward
    in the interpreter, float32: dx within 1e-6, dweight and dbias within
    1e-6 of their largest entry."""
    monkeypatch.setattr(jln, "_INTERPRET", True)
    x, dy, weight, bias = _inputs(shape, torch.float32, seed=sum(shape) + blocks)
    cut = _VIEWS[view] or (lambda t: t)
    xt, dyt = torch.from_numpy(x), torch.from_numpy(dy)
    xt, dyt = cut(xt), cut(dyt).contiguous()
    wt = torch.from_numpy(weight)
    _, mu, rstd = ln.layer_norm_stats_plain(xt, wt, torch.from_numpy(bias), EPS)
    plan = ln.bwd_plan(torch.float32, shape[-1], ln.bwd_vec(xt, dyt, None))
    got = ln.layer_norm_bwd_plan_plain(xt, dyt, mu, rstd, wt, blocks, plan)
    want = ln.layer_norm_bwd_plain(xt, dyt, mu, rstd, wt)
    np.testing.assert_allclose(got[0].numpy(), want[0].numpy(), rtol=0, atol=1e-6)
    for g, w_ in zip(got[1:], want[1:]):
        np.testing.assert_allclose(g.numpy(), w_.numpy(), rtol=0, atol=1e-6 * w_.abs().max().item())

    # the Pallas kernel on the same rows, as [B, N, W] (the CLS rows as [1, B, W])
    jx, jdy = (jnp.asarray(cut(a)[None] if view == "cls_rows" else cut(a)) for a in (x, dy))
    assert jln.supported(jx.shape[1], jx.shape[2])
    _, vjp = jax.vjp(
        lambda x_, s_, b_: jln.fused_layer_norm(x_, s_, b_, EPS), jx, jnp.asarray(weight), jnp.asarray(bias)
    )
    jdx, jdw, jdb = (np.asarray(a, np.float32) for a in vjp(jdy))
    np.testing.assert_allclose(got[0].numpy(), jdx.reshape(got[0].shape), rtol=0, atol=1e-6)
    for g, w_ in zip(got[1:], (jdw, jdb)):
        np.testing.assert_allclose(g.numpy(), w_, rtol=0, atol=1e-6 * np.abs(w_).max())
