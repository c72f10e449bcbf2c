"""The port's CUDA kernels against their plain PyTorch versions, on a CUDA
card. Marked `cuda`: they skip where no card is present. Run on the card:

    python -m pytest --noconftest -m cuda tests/test_torch_kernels_cuda.py -q

Tolerances: RoPE float32 differs from the plain version by the kernel's FMA
(one rounding, 1e-6 at |x| <= ~5), bfloat16 by at most one bf16 ULP of the
result after that (rtol 1.6e-2 is 2 ULP); the backward is the same kernel on
dy with the rolled tables, so it keeps the forward's bars. Attention float32
differs by summation order (1e-4), bfloat16 by the bf16 rounding of the
probabilities (min row cosine 0.9999 against float32); bfloat16 at head_dim
64 runs the wgmma kernels (the other head dims the WMMA ones, float32 the FMA
ones), whose exponentials are `ex2.approx` (two ULP of float32, far below a
bfloat16 rounding), held to the same bars at their tile edges: 64-row
warpgroups, 128-row and 128-key blocks. The header's 64 x 64 x 64 probe sums
64 exact products of bfloat16 values in float32 in another order than
`torch.matmul`: 1e-4 absolute on sums of ~8. The LSE is a sum of
f32 exponentials in another order: 1e-4 absolute on values of ~log(N). The
flash backward float32 sums up to N products per entry in another order,
and dQ through f32 atomics in a run-dependent order: max abs error 1e-4 of
the largest gradient entry, plus 1e-5: at N = 1 the exact dq and dk vanish
and both sides return the f32 rounding noise of dP - di, whose terms are of
size |dO| |V| ~ D (measured 1.0e-6 at D = 128); bfloat16
rounds P and dS to bf16 before their products: min row cosine 0.999 against
float32 on the same bf16-valued inputs. LayerNorm: kernel and plain version
compute the same float32 formulas from the same inputs, the row sums in
another order: float32 y and dx within 1e-5 absolute (values of order 1 to
10); bfloat16 rounds that float32 value once on both sides, so y and dx
agree within one bfloat16 ULP (2^-7 relative) plus the float32 slack;
dweight and dbias are float32 sums over the rows on both sides, within 1e-5
of their largest entry. Greedy NMS: the keep mask is discrete and the kernel's
arithmetic is pinned to single round-to-nearest operations in the plain
version's order, so the two masks must be equal.
"""

import pytest
import torch

from clipself_tpu_torch.models.rope import rope_tables, rope_tables_bwd
from clipself_tpu_torch.detector.data import synthetic_nms_case
from clipself_tpu_torch.ops import attention, hopper_mma_probe, layer_norm, nms, rope_roll

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)


def _min_row_cos(a, b):
    a = a.float().reshape(-1, a.shape[-1])
    b = b.float().reshape(-1, b.shape[-1])
    return torch.nn.functional.cosine_similarity(a, b, dim=-1).min().item()


@pytest.mark.parametrize(
    "dtype,rtol,atol", [(torch.float32, 0.0, 1e-6), (torch.bfloat16, 1.6e-2, 1e-5)]
)
@pytest.mark.parametrize("b,grid,heads", [(2, 8, 12), (3, 14, 2)])
def test_rope_kernel_matches_plain(dev, dtype, rtol, atol, b, grid, heads):
    tables = rope_tables(grid, grid, 64, 1, 16, dev)
    n = 1 + grid * grid
    x = torch.randn(b, n, heads * 64, generator=torch.Generator().manual_seed(0)).to(dev, dtype)
    before = rope_roll.LAUNCHES.count
    got = rope_roll.rolled_rope_fwd(x, *tables)
    assert rope_roll.LAUNCHES.count == before + 1
    want = rope_roll.rolled_rope_plain(x, *tables)
    torch.testing.assert_close(got.float(), want.float(), rtol=rtol, atol=atol)


@pytest.mark.parametrize(
    "dtype,rtol,atol", [(torch.float32, 0.0, 1e-6), (torch.bfloat16, 1.6e-2, 1e-5)]
)
@pytest.mark.parametrize("b,grid,heads", [(2, 8, 12), (3, 14, 2)])
def test_rope_backward_kernel_matches_plain(dev, dtype, rtol, atol, b, grid, heads):
    key = (grid, grid, 64, 1, 16, dev)
    tables, bwd = rope_tables(*key), rope_tables_bwd(*key)
    n = 1 + grid * grid
    gen = torch.Generator().manual_seed(1)
    x = torch.randn(b, n, heads * 64, generator=gen).to(dev, dtype).requires_grad_()
    dy = torch.randn(b, n, heads * 64, generator=gen).to(dev, dtype)
    y = rope_roll.rolled_rope(x, *tables, *bwd)
    assert type(y.grad_fn).__name__ == "RolledRopeFnBackward"
    before = rope_roll.BWD_LAUNCHES.count
    (got,) = torch.autograd.grad(y, x, dy)
    assert rope_roll.BWD_LAUNCHES.count == before + 1
    x2 = x.detach().requires_grad_()
    (want,) = torch.autograd.grad(rope_roll.rolled_rope_plain(x2, *tables), x2, dy)
    torch.testing.assert_close(got.float(), want.float(), rtol=rtol, atol=atol)


@pytest.mark.parametrize("n", [1, 63, 64, 65, 197, 300])
@pytest.mark.parametrize("d", [16, 64, 128])
def test_attention_kernel_matches_plain(dev, n, d):
    gen = torch.Generator().manual_seed(n + d)
    # per-head views of [B, N, 3, H, D]: strided, as a packed projection would be
    qkv = torch.randn(2, n, 3, 3, d, generator=gen).to(dev)
    q, k, v = qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]
    want = attention.attention_plain(q, k, v, d ** -0.5)
    got = attention.flash_attention(q, k, v, d ** -0.5)
    assert got.is_contiguous()
    torch.testing.assert_close(got, want, rtol=0, atol=1e-4)
    got16 = attention.flash_attention(*(t.bfloat16() for t in (q, k, v)), d ** -0.5)
    want32 = attention.attention_plain(*(t.bfloat16().float() for t in (q, k, v)), d ** -0.5)
    cos = torch.nn.functional.cosine_similarity(got16.float(), want32, dim=-1)
    assert cos.min().item() >= 0.9999


@pytest.mark.parametrize("n", [1, 65, 197, 4097])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_attention_lse_matches_plain(dev, n, dtype):
    d = 64
    gen = torch.Generator().manual_seed(n)
    q, k, v = (torch.randn(1, n, 2, d, generator=gen).to(dev, dtype) for _ in range(3))
    out, lse = attention.flash_attention_fwd(q, k, v, d ** -0.5, return_lse=True)
    want_out, want_lse = attention.attention_lse_plain(
        q.float(), k.float(), v.float(), d ** -0.5
    )
    assert lse.shape == (1, 2, n) and lse.dtype == torch.float32
    torch.testing.assert_close(lse, want_lse, rtol=0, atol=1e-4)
    assert _min_row_cos(out, want_out) >= 0.9999


def _bwd_inputs(dev, b, n, h, d, dtype, seed):
    gen = torch.Generator().manual_seed(seed)
    qkv = torch.randn(b, n, 3, h, d, generator=gen).to(dev, dtype)
    q, k, v = qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]  # strided views
    do = torch.randn(b, n, h, d, generator=gen).to(dev, dtype)
    return q, k, v, do


# ragged lengths at three head widths; the full 4097-token length at the
# model's head_dim
_BWD_CASES = [(n, d) for n in (1, 63, 65, 197) for d in (32, 64, 128)] + [(4097, 64)]


@pytest.mark.parametrize("n,d", _BWD_CASES)
def test_flash_backward_f32_matches_plain(dev, n, d):
    scale = d ** -0.5
    q, k, v, do = _bwd_inputs(dev, 2 if n < 4097 else 1, n, 3, d, torch.float32, n + d)
    o, lse = attention.flash_attention_fwd(q, k, v, scale, return_lse=True)
    before = attention.BWD_LAUNCHES.count
    got = attention.flash_attention_bwd(q, k, v, o, lse, do, scale)
    assert attention.BWD_LAUNCHES.count == before + 1
    want = attention.attention_bwd_plain(q, k, v, o, lse, do, scale)
    for g, w in zip(got, want):
        assert g.is_contiguous() and g.shape == q.shape
        assert (g - w).abs().max().item() <= 1e-4 * w.abs().max().item() + 1e-5


@pytest.mark.parametrize("n,d", [c for c in _BWD_CASES if c[0] > 1])
def test_flash_backward_bf16_matches_f32(dev, n, d):
    scale = d ** -0.5
    q, k, v, do = _bwd_inputs(dev, 2 if n < 4097 else 1, n, 3, d, torch.bfloat16, n * d)
    o, lse = attention.flash_attention_fwd(q, k, v, scale, return_lse=True)
    got = attention.flash_attention_bwd(q, k, v, o, lse, do, scale)
    f = [t.float() for t in (q, k, v)]
    o32, lse32 = attention.attention_lse_plain(*f, scale)
    want = attention.attention_bwd_plain(*f, o32, lse32, do.float(), scale)
    for g, w in zip(got, want):
        assert g.dtype == torch.bfloat16 and torch.isfinite(g).all()
        assert _min_row_cos(g, w) >= 0.999


# bfloat16 at head_dim 64: the wgmma kernels at the edges of their tiles (a
# warpgroup's 64 rows, the forward's 128-row and the backward's 128-key
# blocks), the towers' lengths, an odd B * H, and three layouts of q, k, v
_WG_NS = [1, 63, 64, 65, 127, 128, 129, 197, 577, 1601, 4097]
_WG_LAYOUTS = ["separate", "fused", "offset"]


def _wg_qkv(dev, layout, b, n, h, seed):
    """bfloat16 [B, N, H, 64] q, k, v: per-head views of three separate
    [B, N, W] projections (the towers' layout), slices of one fused
    [B, N, 3 W] projection (other strides), or views into one buffer at a
    non-zero storage offset."""
    d, gen = 64, torch.Generator().manual_seed(seed)
    w = h * d
    if layout == "separate":
        return tuple(
            torch.randn(b, n, w, generator=gen).to(dev, torch.bfloat16).view(b, n, h, d)
            for _ in range(3)
        )
    if layout == "fused":
        qkv = torch.randn(b, n, 3 * w, generator=gen).to(dev, torch.bfloat16)
        return tuple(qkv[..., i * w:(i + 1) * w].unflatten(-1, (h, d)) for i in range(3))
    buf = torch.randn(8 + 3 * b * n * w, generator=gen).to(dev, torch.bfloat16)
    out = tuple(
        buf[8 + i * b * n * w: 8 + (i + 1) * b * n * w].view(b, n, h, d) for i in range(3)
    )
    assert out[0].storage_offset() == 8
    return out


@pytest.mark.parametrize("layout", _WG_LAYOUTS)
@pytest.mark.parametrize("n", _WG_NS)
def test_wgmma_forward_and_lse_match_plain(dev, n, layout):
    b, h = (3, 5) if n < 4097 else (1, 3)
    scale = 0.125
    q, k, v = _wg_qkv(dev, layout, b, n, h, seed=n)
    assert attention.kernel_design(q.dtype, 64) == "wgmma"
    before = attention.LAUNCHES.count
    out, lse = attention.flash_attention_fwd(q, k, v, scale, return_lse=True)
    alone = attention.flash_attention_fwd(q, k, v, scale)
    assert attention.LAUNCHES.count == before + 2
    want, want_lse = attention.attention_lse_plain(q.float(), k.float(), v.float(), scale)
    assert out.is_contiguous() and out.dtype == torch.bfloat16 and torch.equal(out, alone)
    assert _min_row_cos(out, want) >= 0.9999
    torch.testing.assert_close(lse, want_lse, rtol=0, atol=1e-4)


@pytest.mark.parametrize("layout", _WG_LAYOUTS)
@pytest.mark.parametrize("n", _WG_NS)
def test_wgmma_backward_matches_f32(dev, n, layout):
    b, h = (3, 5) if n < 4097 else (1, 3)
    scale = 0.125
    q, k, v = _wg_qkv(dev, layout, b, n, h, seed=2 * n)
    do = torch.randn(b, n, h, 64, generator=torch.Generator().manual_seed(n)).to(dev, torch.bfloat16)
    assert attention.kernel_design(q.dtype, 64, backward=True) == "wgmma"
    o, lse = attention.flash_attention_fwd(q, k, v, scale, return_lse=True)
    got = attention.flash_attention_bwd(q, k, v, o, lse, do, scale)
    f = [t.float() for t in (q, k, v)]
    o32, lse32 = attention.attention_lse_plain(*f, scale)
    want = attention.attention_bwd_plain(*f, o32, lse32, do.float(), scale)
    for g, w in zip(got, want):
        assert g.dtype == torch.bfloat16 and g.is_contiguous() and torch.isfinite(g).all()
    if n == 1:  # P = 1: dv = dO, and dq, dk are the rounding noise of dP - di
        assert got[0].abs().max().item() <= 1e-3 and got[1].abs().max().item() <= 1e-3
        assert _min_row_cos(got[2], want[2]) >= 0.999
    else:
        for g, w in zip(got, want):
            assert _min_row_cos(g, w) >= 0.999


def test_wgmma_backward_twice_bounds_the_dq_difference(dev):
    """dQ sums its key blocks' partial tiles in the L2 in whatever order they
    arrive: two runs on the same inputs may differ in the last bits of the f32
    sum, so by at most one bfloat16 rounding of the result; dK and dV have
    no such sum and repeat bit for bit."""
    q, k, v = _wg_qkv(dev, "separate", 2, 4097, 3, seed=11)
    do = torch.randn(q.shape, generator=torch.Generator().manual_seed(12)).to(dev, torch.bfloat16)
    o, lse = attention.flash_attention_fwd(q, k, v, 0.125, return_lse=True)
    first = attention.flash_attention_bwd(q, k, v, o, lse, do, 0.125)
    second = attention.flash_attention_bwd(q, k, v, o, lse, do, 0.125)
    assert torch.equal(first[1], second[1]) and torch.equal(first[2], second[2])
    a, b = first[0].float(), second[0].float()
    assert ((a - b).abs() <= 2.0 ** -7 * torch.maximum(a.abs(), b.abs()) + 1e-6).all()


@pytest.mark.parametrize("mode", sorted(hopper_mma_probe.MODES))
def test_hopper_mma_header_product_matches_matmul(dev, mode):
    """One 64 x 64 x 64 product through each operand form of
    `csrc/hopper_mma.cuh`: descriptors, transpose flags, the swizzled loader
    and the fragment map, apart from any attention logic."""
    gen = torch.Generator().manual_seed(mode)
    a, b = (torch.randn(64, 64, generator=gen).to(dev, torch.bfloat16) for _ in range(2))
    got = hopper_mma_probe.wgmma_probe(a, b, mode)
    a32, b32 = a.float(), b.float()
    want = torch.matmul(*((a32, b32.T), (a32, b32), (a32.T, b32))[mode])
    torch.testing.assert_close(got, want, rtol=0, atol=1e-4)
    torch.testing.assert_close(hopper_mma_probe.wgmma_probe_plain(a, b, mode), want, rtol=0, atol=1e-4)


@pytest.mark.parametrize(
    "dtype,d,design", [(torch.bfloat16, 32, "wmma"), (torch.bfloat16, 128, "wmma"), (torch.float32, 64, "fma")]
)
def test_other_head_dims_and_float32_keep_their_kernels(dev, dtype, d, design):
    """The shape alone picks the kernel: bfloat16 away from head_dim 64 and
    float32 go on through the WMMA and FMA kernels, forward, LSE and
    backward."""
    assert attention.kernel_design(dtype, d) == design
    assert attention.kernel_design(dtype, d, backward=True) == design
    scale = d ** -0.5
    q, k, v, do = _bwd_inputs(dev, 2, 129, 3, d, dtype, seed=d)
    o, lse = attention.flash_attention_fwd(q, k, v, scale, return_lse=True)
    got = attention.flash_attention_bwd(q, k, v, o, lse, do, scale)
    f = [t.float() for t in (q, k, v)]
    o32, lse32 = attention.attention_lse_plain(*f, scale)
    want = attention.attention_bwd_plain(*f, o32, lse32, do.float(), scale)
    torch.testing.assert_close(lse, lse32, rtol=0, atol=1e-4)
    assert _min_row_cos(o, o32) >= 0.9999
    for g, w in zip(got, want):
        assert _min_row_cos(g, w) >= 0.999


def test_flash_attention_function_on_card(dev):
    """A gradient through `flash_attention` on the card comes from the
    Function's backward kernel and equals autograd of the plain version."""
    q, k, v, do = _bwd_inputs(dev, 2, 197, 2, 64, torch.float32, 7)
    q, k, v = (t.detach().requires_grad_() for t in (q, k, v))
    out = attention.flash_attention(q, k, v, 0.125)
    assert type(out.grad_fn).__name__ == "FlashAttentionFnBackward"
    before = attention.BWD_LAUNCHES.count
    got = torch.autograd.grad(out, (q, k, v), do)
    assert attention.BWD_LAUNCHES.count == before + 1
    p = [t.detach().requires_grad_() for t in (q, k, v)]
    want = torch.autograd.grad(attention.attention_plain(*p, 0.125), p, do)
    for g, w in zip(got, want):
        assert (g - w).abs().max().item() <= 1e-4 * w.abs().max().item() + 1e-5


def test_attention_kernel_rejects_what_it_does_not_take(dev):
    q = torch.randn(1, 8, 2, 24, device=dev)
    with pytest.raises(ValueError, match="multiple of 16"):
        attention.flash_attention(q, q, q, 0.2)
    q = torch.randn(1, 8, 2, 16, device=dev, dtype=torch.float16)
    with pytest.raises(TypeError, match="dtype"):
        attention.flash_attention(q, q, q, 0.2)


# (shape of the tensor, view of it that the op sees): the widths of the B/16
# and L/14 towers (768, 1024, the SwiGLU hiddens 2048 and 2730, whose bf16
# rows are only 4-byte aligned), odd widths, and the two strided views of
# the final norm (`t[:, 1:]` of the dense pass, `t[:, 0]` of the CLS pass)
_LN_VIEWS = {"all": lambda t: t, "drop_cls": lambda t: t[:, 1:], "cls_rows": lambda t: t[:, 0]}
_LN_CASES = [
    ((2, 257, 768), "all"), ((2, 257, 1024), "all"), ((2, 257, 2048), "all"),
    ((2, 257, 2730), "all"), ((3, 50, 341), "all"), ((5, 7, 170), "all"), ((1, 1, 2), "all"),
    ((1000, 1024), "all"), ((2, 4097, 1024), "drop_cls"), ((3, 65, 2730), "drop_cls"),
    ((40, 577, 1024), "cls_rows"), ((7, 5, 341), "cls_rows"),
]
_LN_EPS = 1e-6


def _ln_inputs(dev, shape, view, dtype, seed):
    gen = torch.Generator().manual_seed(seed)
    x = _LN_VIEWS[view]((torch.randn(shape, generator=gen) * 3 + 0.5).to(dev, dtype))
    dy = _LN_VIEWS[view](torch.randn(shape, generator=gen).to(dev, dtype)).contiguous()
    weight = (torch.randn(shape[-1], generator=gen) * 0.2 + 1.0).to(dev)
    bias = (torch.randn(shape[-1], generator=gen) * 0.1).to(dev)
    return x, dy, weight, bias


def _assert_ln_close(got, want, dtype):
    assert got.dtype == dtype and got.is_contiguous() and got.shape == want.shape
    got, want = got.float(), want.float()
    slack = 2.0 ** -7 * want.abs() if dtype == torch.bfloat16 else 0.0
    assert ((got - want).abs() <= slack + 1e-5).all()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("shape,view", _LN_CASES, ids=lambda v: v if isinstance(v, str) else "x".join(map(str, v)))
def test_layer_norm_kernels_match_plain(dev, shape, view, dtype):
    """The forward with and without statistics and the backward (all three
    gradients, dx alone, the sums alone), each one launch, against the plain
    versions on the same inputs and the same statistics."""
    x, dy, weight, bias = _ln_inputs(dev, shape, view, dtype, seed=sum(shape))
    assert x.is_contiguous() == (view == "all" or x.shape[0] == 1)
    want_y, want_mu, want_rstd = layer_norm.layer_norm_stats_plain(x, weight, bias, _LN_EPS)
    before = layer_norm.LAUNCHES.count
    y = layer_norm.layer_norm_fwd(x, weight, bias, _LN_EPS)
    y2, mu, rstd = layer_norm.layer_norm_fwd(x, weight, bias, _LN_EPS, return_stats=True)
    assert layer_norm.LAUNCHES.count == before + 2
    torch.cuda.synchronize()
    _assert_ln_close(y, want_y, dtype)
    assert torch.equal(y, y2)
    assert mu.shape == rstd.shape == x.shape[:-1] and mu.dtype == rstd.dtype == torch.float32
    torch.testing.assert_close(mu, want_mu, rtol=0, atol=1e-5)
    torch.testing.assert_close(rstd, want_rstd, rtol=1e-5, atol=0)

    want_dx, want_dw, want_db = layer_norm.layer_norm_bwd_plain(x, dy, mu, rstd, weight)
    before = layer_norm.BWD_LAUNCHES.count
    dx, dw, db = layer_norm.layer_norm_bwd(x, dy, mu, rstd, weight)
    dx_only = layer_norm.layer_norm_bwd(x, dy, mu, rstd, weight, need_dwb=False)
    sums_only = layer_norm.layer_norm_bwd(x, dy, mu, rstd, weight, need_dx=False)
    assert layer_norm.BWD_LAUNCHES.count == before + 3
    torch.cuda.synchronize()
    _assert_ln_close(dx, want_dx, dtype)
    for got, want in ((dw, want_dw), (db, want_db)):
        assert got.dtype == torch.float32 and got.shape == want.shape
        assert (got - want).abs().max().item() <= 1e-5 * want.abs().max().item() + 1e-6
    assert torch.equal(dx_only[0], dx) and dx_only[1] is None and dx_only[2] is None
    assert sums_only[0] is None
    assert torch.equal(sums_only[1], dw) and torch.equal(sums_only[2], db)
    # no atomics: a second launch gives the same bits
    again = layer_norm.layer_norm_bwd(x, dy, mu, rstd, weight)
    assert all(torch.equal(a, b) for a, b in zip(again, (dx, dw, db)))


@pytest.mark.parametrize("recompute", [False, True], ids=["plain", "recompute"])
def test_layer_norm_function_on_card(dev, recompute):
    """A gradient through `layer_norm` on the card comes from the Function's
    backward kernel, also when the forward is run again under
    `torch.utils.checkpoint`, and equals autograd of the plain version."""
    from torch.utils.checkpoint import checkpoint

    x, dy, weight, bias = _ln_inputs(dev, (2, 65, 341), "drop_cls", torch.float32, seed=3)
    leaves = [t.detach().requires_grad_() for t in (x, weight, bias)]
    fwd_before, bwd_before = layer_norm.LAUNCHES.count, layer_norm.BWD_LAUNCHES.count
    if recompute:
        y = checkpoint(layer_norm.layer_norm, *leaves, _LN_EPS, use_reentrant=False)
    else:
        y = layer_norm.layer_norm(*leaves, _LN_EPS)
        assert type(y.grad_fn).__name__ == "LayerNormFnBackward"
    got = torch.autograd.grad(y, leaves, dy)
    assert layer_norm.LAUNCHES.count == fwd_before + (2 if recompute else 1)
    assert layer_norm.BWD_LAUNCHES.count == bwd_before + 1
    p = [t.detach().requires_grad_() for t in leaves]
    want = torch.autograd.grad(layer_norm.layer_norm_plain(*p, _LN_EPS), p, dy)
    for g, w in zip(got, want):
        assert (g - w).abs().max().item() <= 1e-5 * w.abs().max().item() + 1e-6
    with torch.no_grad():
        assert layer_norm.layer_norm(*leaves, _LN_EPS).grad_fn is None


def test_layer_norm_kernel_rejects_what_it_does_not_take(dev):
    x = torch.randn(2, 8, 16, device=dev)
    w = torch.ones(16, device=dev)
    with pytest.raises(TypeError, match="dtype"):
        layer_norm.layer_norm(x.half(), w, w, _LN_EPS)
    with pytest.raises(ValueError, match="contiguous float32"):
        layer_norm.layer_norm(x, w.bfloat16(), w, _LN_EPS)
    with pytest.raises(ValueError, match="unit stride"):
        layer_norm.layer_norm(x.transpose(1, 2), torch.ones(8, device=dev), torch.ones(8, device=dev), _LN_EPS)
    with pytest.raises(ValueError, match="weight on"):
        layer_norm.layer_norm(x, w.cpu(), w, _LN_EPS)


@pytest.mark.parametrize("kind,b,n,thr", [
    ("anchors", 8, 2000, 0.7), ("class_offset", 8, 2000, 0.4), ("anchors", 1, 2000, 0.7),
    ("invalid_tail", 8, 1999, 0.7), ("invalid_any", 3, 777, 0.5), ("plain", 2, 1, 0.5),
    ("none_valid", 2, 300, 0.5), ("identical", 2, 300, 0.5), ("zero_area", 2, 515, 0.5),
    ("duplicates", 2, 300, 0.4), ("plain", 5, 31, 0.3), ("plain", 1, 4096, 0.5),
    ("plain", 2, 300, -0.5),  # even disjoint pairs suppress: no shortcut for empty intersections
])
def test_nms_kernel_equals_plain(dev, kind, b, n, thr):
    boxes, valid = synthetic_nms_case(kind, b, n, seed=n)
    boxes, valid = boxes.to(dev), valid.to(dev)
    before = nms.LAUNCHES.count
    got = nms.nms_keep_mask(boxes, valid, thr)
    torch.cuda.synchronize()
    assert nms.LAUNCHES.count == before + 1
    assert got.dtype == torch.bool and got.shape == (b, n)
    want = nms.nms_keep_mask_plain(boxes, valid, thr)
    assert torch.equal(got, want), f"{(got != want).sum().item()} of {b * n} flags differ"
    assert torch.equal(want.cpu(), nms.nms_keep_mask_plain(boxes.cpu(), valid.cpu(), thr))
    assert not got[~valid].any()
    if kind in ("plain", "anchors", "class_offset"):
        assert got[:, 0].all()  # the best box of an image is always kept
    if thr < 0:
        assert got.sum().item() == b  # and below zero it suppresses every other
    assert nms.LAUNCHES.count == before + 1  # the plain version launched nothing


def test_nms_kernel_single_image_and_views(dev):
    boxes, valid = synthetic_nms_case("anchors", 2, 500, seed=3)
    boxes, valid = boxes.to(dev), valid.to(dev)
    want = nms.nms_keep_mask_plain(boxes, valid, 0.7)
    assert torch.equal(nms.nms_keep_mask(boxes[1], valid[1], 0.7), want[1])  # [N, 4]
    wide = torch.zeros(2, 500, 6, device=dev)
    wide[..., 1:5] = boxes
    assert torch.equal(nms.nms_keep_mask(wide[..., 1:5], valid, 0.7), want)  # a strided view
    assert torch.equal(nms.nms_keep_mask(boxes.double(), valid, 0.7), want)  # read as float32
    assert nms.nms_keep_mask(boxes[:, :0], valid[:, :0], 0.7).shape == (2, 0)


def test_nms_kernel_rejects_what_it_does_not_take(dev):
    boxes, valid = synthetic_nms_case("plain", 1, 64, seed=0)
    boxes, valid = boxes.to(dev), valid.to(dev)
    with pytest.raises(TypeError, match="bool"):
        nms.nms_keep_mask(boxes, valid.float(), 0.5)
    with pytest.raises(ValueError, match="valid on"):
        nms.nms_keep_mask(boxes, valid.cpu(), 0.5)
    with pytest.raises(ValueError, match="leading dims"):
        nms.nms_keep_mask(boxes, valid[:, :-1], 0.5)
    before = nms.LAUNCHES.count
    with pytest.raises(ValueError, match="shared memory"):
        nms.nms_keep_mask(torch.zeros(1, 20000, 4, device=dev), torch.ones(1, 20000, dtype=torch.bool, device=dev), 0.5)
    assert nms.LAUNCHES.count == before
    big = torch.rand(1, 11000, 4, device=dev)  # above 48 KB of shared memory, below the limit
    big[..., 2:] += big[..., :2]
    ok = torch.ones(1, 11000, dtype=torch.bool, device=dev)
    assert torch.equal(nms.nms_keep_mask(big, ok, 0.5), nms.nms_keep_mask_plain(big, ok, 0.5))
