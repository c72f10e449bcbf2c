"""The port's CUDA kernels against their plain PyTorch versions, on a CUDA
card. Marked `cuda`: they skip where no card is present. Run on the card:

    python -m pytest --noconftest -m cuda tests/test_torch_kernels_cuda.py -q

Tolerances: RoPE float32 differs from the plain version by the kernel's FMA
(one rounding, 1e-6 at |x| <= ~5), bfloat16 by at most one bf16 ULP of the
result after that (rtol 1.6e-2 is 2 ULP); the backward is the same kernel on
dy with the rolled tables, so it keeps the forward's bars; one launch on two
tensors (q and k) must give each the bits of a launch of its own. Attention float32
differs by summation order (1e-4), bfloat16 by the bf16 rounding of the
probabilities (min row cosine 0.9999 against float32); bfloat16 at head_dim
64-128 runs the wgmma kernels (below 64 the WMMA ones), whose exponentials
are `ex2.approx` (two ULP of float32, far below a bfloat16 rounding), held to
the same bars at their tile edges: 64-row warpgroups, 128-row and 128-key
blocks, and at head dims 80-112 on tiles of two 64-column panels; float32
runs the "tf32x3" kernels (every product as three TF32 tensor-core products
of a hi + lo split), held to the float32 bars at every head_dim from 8 to
128. The header's probe sums up to 128 exact products of bfloat16 values in
float32 in another order than `torch.matmul`: 1e-4 absolute on sums of
~8-11; its float32 forms (the split products the tf32x3 kernels run) are
held against the float64 product at 2e-6 of sum |a_k b_k| (the split drops
terms of 2^-21 of each product and the tensor cores cut the low bits of
their sums: the first card run read at most 5.2e-7), and one TF32 product
must err at least 50 times as much (it read 1.3e-4 to 4.2e-4). The LSE is a sum of
f32 exponentials in another order: 1e-4 absolute on values of ~log(N). The
flash backward float32 sums up to N products per entry in another order
(a fixed one: two calls give the same bits in every design): max abs error 1e-4 of
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
of their largest entry, and two backward calls give the same bits (no
atomics). Greedy NMS: the keep mask is discrete and the kernel's
arithmetic is pinned to single round-to-nearest operations in the plain
version's order, so the two masks must be equal, and equal to the plain
mirror of the kernels' two phases (bit matrix, block-wise scan). The input
pipeline on the card: `device_prefetch` copies bits, so its batches equal a
plain copy; one B/16 float32 step from files has the loss of the same item
staged by hand (the same kernels on the same inputs: 1e-5).
"""

import pytest
import torch

from clipself_tpu_torch.models.rope import (
    apply_rope_flat_qk, rope_tables, rope_tables_bwd, rope_tables_packed,
)
from clipself_tpu_torch.detector.data import synthetic_nms_case
from clipself_tpu_torch.ops import attention, hopper_mma_probe, layer_norm, nms, rope_roll

from torch_threads import capped_threads  # noqa: F401  (module fixture)

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
    (got,) = rope_roll.rolled_rope_packed((x,), rope_roll.pack_tables(*tables))
    assert rope_roll.LAUNCHES.count == before + 1
    want = rope_roll.rolled_rope_plain(x, *tables)
    torch.testing.assert_close(got.float(), want.float(), rtol=rtol, atol=atol)


@pytest.mark.parametrize(
    "dtype,rtol,atol", [(torch.float32, 0.0, 1e-6), (torch.bfloat16, 1.6e-2, 1e-5)]
)
@pytest.mark.parametrize("b,grid,heads", [(2, 8, 12), (3, 14, 2)])
def test_rope_backward_kernel_matches_plain(dev, dtype, rtol, atol, b, grid, heads):
    key = (grid, grid, 64, 1, 16, dev)
    tables = rope_tables(*key)
    n = 1 + grid * grid
    gen = torch.Generator().manual_seed(1)
    x = torch.randn(b, n, heads * 64, generator=gen).to(dev, dtype).requires_grad_()
    dy = torch.randn(b, n, heads * 64, generator=gen).to(dev, dtype)
    y = rope_roll.rolled_rope(x, *rope_tables_packed(*key))
    assert type(y.grad_fn).__name__ == "RolledRopeFnBackward"
    before = rope_roll.BWD_LAUNCHES.count
    (got,) = torch.autograd.grad(y, x, dy)
    assert rope_roll.BWD_LAUNCHES.count == before + 1
    x2 = x.detach().requires_grad_()
    (want,) = torch.autograd.grad(rope_roll.rolled_rope_plain(x2, *tables), x2, dy)
    torch.testing.assert_close(got.float(), want.float(), rtol=rtol, atol=atol)


_ROPE_TOL = {torch.float32: dict(rtol=0.0, atol=1e-6), torch.bfloat16: dict(rtol=1.6e-2, atol=1e-5)}
# [B, grid, heads, head_dim]: the B/16 and L/14 students, the L/14 teacher's
# and the B/16 crops, the detector's batch; then head dims whose bytes do
# not split into 16-byte spans in one type (20: bfloat16) or in both (6, 10)
_ROPE_SHAPES = [
    (2, 64, 12, 64), (2, 64, 16, 64), (40, 24, 16, 64), (50, 14, 12, 64), (8, 40, 12, 64),
    (3, 5, 3, 20), (2, 7, 5, 6), (1, 4, 2, 10), (2, 3, 1, 16),
]


def _rope_all_tables(dev, grid, head_dim):
    """(cos, sin_a, sin_b), (a_bwd, b_bwd), packed, packed_bwd. The model's
    tables exist for head dims that are multiples of 4; the others get
    the cosines and sines of random angles with the same parity folding."""
    if head_dim % 4 == 0:
        key = (grid, grid, head_dim, 1, 16, dev)
        return rope_tables(*key), rope_tables_bwd(*key), *rope_tables_packed(*key)
    gen = torch.Generator().manual_seed(head_dim)
    theta = (6.2832 * torch.rand(1 + grid * grid, head_dim, generator=gen)).to(dev)
    cos, sin_a, sin_b = torch.cos(theta), -torch.sin(theta), torch.sin(theta)
    sin_a[:, 1::2] = 0.0
    sin_b[:, 0::2] = 0.0
    a_bwd, b_bwd = torch.roll(sin_a, 1, -1), torch.roll(sin_b, -1, -1)
    packed, packed_bwd = rope_roll.pack_tables(cos, sin_a, sin_b), rope_roll.pack_tables(cos, b_bwd, a_bwd)
    return (cos, sin_a, sin_b), (a_bwd, b_bwd), packed, packed_bwd


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("b,grid,heads,head_dim", _ROPE_SHAPES)
def test_rope_one_and_two_tensors_match_plain(dev, dtype, b, grid, heads, head_dim):
    """Forward and backward tables, one tensor and q and k in one launch."""
    tables, (a_bwd, b_bwd), packed, packed_bwd = _rope_all_tables(dev, grid, head_dim)
    n = 1 + grid * grid
    gen = torch.Generator().manual_seed(2)
    q, k = (torch.randn(b, n, heads * head_dim, generator=gen).to(dev, dtype) for _ in range(2))
    for table, plain_tables, back in ((packed, tables, False), (packed_bwd, (tables[0], b_bwd, a_bwd), True)):
        counter = rope_roll.BWD_LAUNCHES if back else rope_roll.LAUNCHES
        before = counter.count
        (one_q,) = rope_roll.rolled_rope_packed((q,), table, backward=back)
        (one_k,) = rope_roll.rolled_rope_packed((k,), table, backward=back)
        two = rope_roll.rolled_rope_packed((q, k), table, backward=back)
        assert counter.count == before + 3  # a launch a call, whatever it holds
        assert torch.equal(two[0], one_q) and torch.equal(two[1], one_k)
        for x, got in zip((q, k), two):
            want = rope_roll.rolled_rope_plain(x, *plain_tables)
            torch.testing.assert_close(got.float(), want.float(), **_ROPE_TOL[dtype])
    wide = 128 // torch.finfo(dtype).bits
    assert rope_roll.kernel_design(dtype, head_dim) == (
        "row-tiled, 16-byte spans" if head_dim % wide == 0 else "row-tiled, pair spans"
    )


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("b,grid,heads,head_dim", [(2, 14, 12, 64), (8, 40, 12, 64), (3, 5, 3, 20)])
def test_rope_qk_function_on_card(dev, dtype, b, grid, heads, head_dim):
    """`apply_rope_flat_qk` under autograd: one forward and one backward
    launch, the gradients handed over as non-contiguous views."""
    n = 1 + grid * grid
    w = heads * head_dim
    gen = torch.Generator().manual_seed(3)
    q, k = (torch.randn(b, n, w, generator=gen).to(dev, dtype).requires_grad_() for _ in range(2))
    d = torch.randn(b, n, 2, w, generator=gen).to(dev, dtype)
    dq, dk = d[:, :, 0], d[:, :, 1]
    assert not dq.is_contiguous()
    fwd, bwd = rope_roll.LAUNCHES.count, rope_roll.BWD_LAUNCHES.count
    yq, yk = apply_rope_flat_qk(q, k, grid, grid, head_dim, 1, 16)
    assert type(yq.grad_fn).__name__ == type(yk.grad_fn).__name__ == "RolledRopeFnBackward"
    gq, gk = torch.autograd.grad((yq, yk), (q, k), (dq, dk))
    assert (rope_roll.LAUNCHES.count, rope_roll.BWD_LAUNCHES.count) == (fwd + 1, bwd + 1)
    tables = rope_tables(grid, grid, head_dim, 1, 16, dev)
    for x, y, dy, g in ((q, yq, dq, gq), (k, yk, dk, gk)):
        x2 = x.detach().requires_grad_()
        want = rope_roll.rolled_rope_plain(x2, *tables)
        (want_g,) = torch.autograd.grad(want, x2, dy)
        torch.testing.assert_close(y.float(), want.float(), **_ROPE_TOL[dtype])
        torch.testing.assert_close(g.float(), want_g.float(), **_ROPE_TOL[dtype])
    # the one-tensor backward takes a view too
    x = q.detach().requires_grad_()
    y = rope_roll.rolled_rope(x, *rope_tables_packed(grid, grid, head_dim, 1, 16, dev))
    (got,) = torch.autograd.grad(y, x, dq)
    torch.testing.assert_close(got.float(), gq.float(), rtol=0.0, atol=0.0)


def test_rope_kernel_rejects_what_it_does_not_take(dev):
    packed, _ = rope_tables_packed(3, 3, 16, 1, 16, dev)
    x = torch.randn(2, 10, 32, device=dev)
    before = rope_roll.LAUNCHES.count
    with pytest.raises(ValueError, match="contiguous"):
        rope_roll.rolled_rope_packed((x.transpose(0, 1),), packed)
    with pytest.raises(ValueError, match="agree"):
        rope_roll.rolled_rope_packed((x, x.bfloat16()), packed)
    with pytest.raises(ValueError, match="one or two"):
        rope_roll.rolled_rope_packed((x, x, x), packed)
    with pytest.raises(ValueError, match="packed table"):
        rope_roll.rolled_rope_packed((x,), packed[:-1])
    with pytest.raises(ValueError, match="table on"):
        rope_roll.rolled_rope_packed((x,), packed.cpu())
    with pytest.raises(ValueError, match="must divide"):
        rope_roll.rolled_rope_packed((x[..., :24].contiguous(),), packed)
    with pytest.raises(TypeError, match="dtype"):
        rope_roll.rolled_rope_packed((x.half(),), packed)
    assert rope_roll.LAUNCHES.count == before


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


# the head dims that are not a multiple of 16 run tiles 16 columns wider
# with zero-filled columns (88: ViT-g-14 and EVA01-g-14; 104: ViT-bigG-14),
# beside the multiples of 16 around them (80: ViT-H-14's 1280 / 16, 96, 112:
# bigE-14); in bfloat16 all of them take the wgmma kernels' two-panel tiles
_PAD_DIMS = (80, 88, 96, 104, 112)


@pytest.mark.parametrize("n", [1, 65, 4097])
@pytest.mark.parametrize("d", _PAD_DIMS)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_forward_and_backward_at_every_head_dim(dev, n, d, dtype):
    """Forward (with its LSE) and backward at the head dims of the large
    towers: float32 within the bars above of the plain version, bfloat16 at
    the bf16 bars against float32 on the same inputs; each call launches
    the kernel."""
    scale = d ** -0.5
    q, k, v, do = _bwd_inputs(dev, 1, n, 2, d, dtype, n + d)
    design = "tf32x3" if dtype == torch.float32 else "wgmma"
    assert attention.kernel_design(dtype, d) == attention.kernel_design(dtype, d, backward=True) == design
    before = (attention.LAUNCHES.count, attention.BWD_LAUNCHES.count)
    o, lse = attention.flash_attention_fwd(q, k, v, scale, return_lse=True)
    got = attention.flash_attention_bwd(q, k, v, o, lse, do, scale)
    assert (attention.LAUNCHES.count, attention.BWD_LAUNCHES.count) == (before[0] + 1, before[1] + 1)
    f = [t.float() for t in (q, k, v)]
    o32, lse32 = attention.attention_lse_plain(*f, scale)
    want = attention.attention_bwd_plain(*f, o32, lse32, do.float(), scale)
    torch.testing.assert_close(lse, lse32, rtol=0, atol=1e-4)
    assert o.shape == q.shape and o.is_contiguous()
    for g in got:
        assert g.shape == q.shape and g.is_contiguous() and torch.isfinite(g).all()
    if dtype == torch.float32:
        torch.testing.assert_close(o, o32, rtol=0, atol=1e-4)
        for g, w in zip(got, want):
            assert (g - w).abs().max().item() <= 1e-4 * w.abs().max().item() + 1e-5
    else:
        assert _min_row_cos(o, o32) >= 0.9999
        if n > 1:  # at one token the exact dq and dk vanish
            for g, w in zip(got, want):
                assert _min_row_cos(g, w) >= 0.999


# bfloat16 at head_dim 64: the wgmma kernels at the edges of their tiles (a
# warpgroup's 64 rows, the forward's 128-row and the backward's 128-key
# blocks), the towers' lengths, an odd B * H, and three layouts of q, k, v
_WG_NS = [1, 63, 64, 65, 127, 128, 129, 197, 577, 1601, 4097]
_WG_LAYOUTS = ["separate", "fused", "offset"]


def _wg_qkv(dev, layout, b, n, h, seed, d=64):
    """bfloat16 [B, N, H, d] q, k, v: per-head views of three separate
    [B, N, W] projections (the towers' layout), slices of one fused
    [B, N, 3 W] projection (other strides), or views into one buffer at a
    non-zero storage offset."""
    gen = torch.Generator().manual_seed(seed)
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


@pytest.mark.parametrize("layout", ["separate", "offset"])
@pytest.mark.parametrize("n", [63, 64, 127, 128, 129, 385])
@pytest.mark.parametrize("d", [72, 104, 120, 128])
def test_wgmma_wide_heads_at_tile_edges(dev, d, n, layout):
    """Head dims past 64 on two-panel tiles (72 and 120 zero-fill a chunk
    of the second panel, 104 two, 128 fills it) at the edges of the
    warpgroups' 64 rows, the 128-row and 128-key blocks and the one- to
    two-warpgroup switch past 384 rows: forward with and without its LSE,
    and the backward twice, equal bit for bit, at the bars above."""
    b, h = 3, 5
    scale = d ** -0.5
    q, k, v = _wg_qkv(dev, layout, b, n, h, seed=n + d, d=d)
    do = torch.randn(b, n, h, d, generator=torch.Generator().manual_seed(n * d)).to(dev, torch.bfloat16)
    assert attention.kernel_design(q.dtype, d) == attention.kernel_design(q.dtype, d, backward=True) == "wgmma"
    out, lse = attention.flash_attention_fwd(q, k, v, scale, return_lse=True)
    assert torch.equal(out, attention.flash_attention_fwd(q, k, v, scale))
    f = [t.float() for t in (q, k, v)]
    want, want_lse = attention.attention_lse_plain(*f, scale)
    assert out.is_contiguous() and out.shape == q.shape
    assert _min_row_cos(out, want) >= 0.9999
    torch.testing.assert_close(lse, want_lse, rtol=0, atol=1e-4)
    first = attention.flash_attention_bwd(q, k, v, out, lse, do, scale)
    second = attention.flash_attention_bwd(q, k, v, out, lse, do, scale)
    grads = attention.attention_bwd_plain(*f, want, want_lse, do.float(), scale)
    for g, again, w in zip(first, second, grads):
        assert torch.equal(g, again) and g.is_contiguous() and torch.isfinite(g).all()
        assert _min_row_cos(g, w) >= 0.999


def test_wgmma_backward_twice_bounds_the_dq_difference(dev):
    """dQ sums its key tiles in ascending order inside one block (the dQ
    pass), so two runs on the same inputs differ by nothing: dQ, dK and dV
    repeat bit for bit."""
    q, k, v = _wg_qkv(dev, "separate", 2, 4097, 3, seed=11)
    do = torch.randn(q.shape, generator=torch.Generator().manual_seed(12)).to(dev, torch.bfloat16)
    o, lse = attention.flash_attention_fwd(q, k, v, 0.125, return_lse=True)
    first = attention.flash_attention_bwd(q, k, v, o, lse, do, 0.125)
    second = attention.flash_attention_bwd(q, k, v, o, lse, do, 0.125)
    for a, b in zip(first, second):
        assert torch.equal(a, b)


# (shape, dtype, design): the B/16 student's backward, the wide towers' head
# dims 88 (zero-filled tiles), 112 and 80 on two-panel tiles, the HF trunk's
# float32 student, each also at n = 65 (one full 64-row tile and a ragged
# one)
_REPEAT_CASES = [
    ((2, 4097, 12, 64), torch.bfloat16, "wgmma"), ((2, 65, 12, 64), torch.bfloat16, "wgmma"),
    ((1, 4097, 16, 88), torch.bfloat16, "wgmma"), ((1, 65, 16, 88), torch.bfloat16, "wgmma"),
    ((1, 4097, 16, 112), torch.bfloat16, "wgmma"), ((1, 65, 16, 80), torch.bfloat16, "wgmma"),
    ((2, 197, 12, 64), torch.float32, "tf32x3"), ((2, 65, 12, 64), torch.float32, "tf32x3"),
]


@pytest.mark.parametrize("shape,dtype,design", _REPEAT_CASES)
def test_flash_backward_repeats_bit_for_bit(dev, shape, dtype, design):
    """Two calls on the same inputs give the same bits of dQ, dK and dV in
    every design (each sum of the kernel runs in a fixed order, dQ's over
    the key tiles in ascending order), and the result keeps its bars
    against the plain version: float32 within 1e-4 of the largest entry
    plus 1e-5, bfloat16 a min row cosine of 0.999 against float32."""
    b, n, h, d = shape
    assert attention.kernel_design(dtype, d, backward=True) == design
    scale = d ** -0.5
    q, k, v, do = _bwd_inputs(dev, b, n, h, d, dtype, seed=n + d)
    o, lse = attention.flash_attention_fwd(q, k, v, scale, return_lse=True)
    first = attention.flash_attention_bwd(q, k, v, o, lse, do, scale)
    second = attention.flash_attention_bwd(q, k, v, o, lse, do, scale)
    for a, b2 in zip(first, second):
        assert torch.equal(a, b2)
    f = [t.float() for t in (q, k, v)]
    if dtype == torch.float32:
        want = attention.attention_bwd_plain(q, k, v, o, lse, do, scale)
        for g, w in zip(first, want):
            assert (g - w).abs().max().item() <= 1e-4 * w.abs().max().item() + 1e-5
    else:
        o32, lse32 = attention.attention_lse_plain(*f, scale)
        want = attention.attention_bwd_plain(*f, o32, lse32, do.float(), scale)
        for g, w in zip(first, want):
            assert _min_row_cos(g, w) >= 0.999


@pytest.mark.parametrize("mode,k,n", hopper_mma_probe.PRODUCTS)
def test_hopper_mma_header_product_matches_matmul(dev, mode, k, n):
    """One product through each operand form of `csrc/hopper_mma.cuh` at
    the widths the attention kernels run it (K-major A and B of one or two
    64-column panels; N from 16 to 128, two products past 64):
    descriptors, transpose flags, the swizzled loader and the fragment map,
    apart from any attention logic."""
    gen = torch.Generator().manual_seed(1000 * mode + k + n)
    a, b = (torch.randn(shape, generator=gen).to(dev, torch.bfloat16)
            for shape in hopper_mma_probe.shapes(mode, k, n))
    got = hopper_mma_probe.wgmma_probe(a, b, mode)
    a32, b32 = a.float(), b.float()
    want = torch.matmul(*((a32, b32.T), (a32, b32), (a32.T, b32))[mode])
    assert got.shape == want.shape == (64, n)
    torch.testing.assert_close(got, want, rtol=0, atol=1e-4)
    torch.testing.assert_close(hopper_mma_probe.wgmma_probe_plain(a, b, mode), want, rtol=0, atol=1e-4)


@pytest.mark.parametrize("n", [1, 65, 197, 4097])
@pytest.mark.parametrize("d", list(range(8, 129, 8)))
def test_float32_flash_at_every_head_dim(dev, n, d):
    """The float32 design (tf32x3) at every head_dim it takes, on strided
    per-head views of a packed [B, N, 3, H, D] projection: the forward with
    and without its LSE within 1e-4 of the plain version (the LSE within
    1e-4), the backward within 1e-4 of the largest gradient entry plus 1e-5
    (the bars above), and two backward calls equal bit for bit."""
    scale = d ** -0.5
    q, k, v, do = _bwd_inputs(dev, 1 if n == 4097 else 2, n, 2, d, torch.float32, seed=1000 + n + d)
    assert not q.is_contiguous()
    assert attention.kernel_design(torch.float32, d) == "tf32x3"
    assert attention.kernel_design(torch.float32, d, backward=True) == "tf32x3"
    o, lse = attention.flash_attention_fwd(q, k, v, scale, return_lse=True)
    alone = attention.flash_attention_fwd(q, k, v, scale)
    want, want_lse = attention.attention_lse_plain(q, k, v, scale)
    assert o.is_contiguous() and torch.equal(o, alone)
    torch.testing.assert_close(o, want, rtol=0, atol=1e-4)
    torch.testing.assert_close(lse, want_lse, rtol=0, atol=1e-4)
    first = attention.flash_attention_bwd(q, k, v, o, lse, do, scale)
    second = attention.flash_attention_bwd(q, k, v, o, lse, do, scale)
    grads = attention.attention_bwd_plain(q, k, v, o, lse, do, scale)
    for g, again, w in zip(first, second, grads):
        assert torch.equal(g, again) and g.is_contiguous() and g.shape == q.shape
        assert (g - w).abs().max().item() <= 1e-4 * w.abs().max().item() + 1e-5


@pytest.mark.parametrize("mode,k,n", hopper_mma_probe.TF32_PRODUCTS)
def test_tf32_split_products_match_float64(dev, mode, k, n):
    """Each float32 form the tf32x3 kernels run (`csrc/hopper_mma_probe.cu`
    modes 3 to 5: the scores' wgmma of a split ldmatrix A fragment against a
    split tile, and a register A fragment under the renumbered contraction
    against B rows of a row-major or a split tile) through the three-product
    split, held against the float64 product at
    2e-6 of sum |a_k b_k|; one TF32 product through the same loads errs at
    least 50 times as much."""
    gen = torch.Generator().manual_seed(5000 + 1000 * mode + k + n)
    a, b = (torch.randn(shape, generator=gen).to(dev) for shape in hopper_mma_probe.tf32_shapes(mode, k, n))
    want = hopper_mma_probe.tf32_probe_plain(a, b, mode)
    mag = hopper_mma_probe.tf32_probe_plain(a.abs(), b.abs(), mode)
    split = ((hopper_mma_probe.tf32_probe(a, b, mode) - want).abs() / mag).max().item()
    one = ((hopper_mma_probe.tf32_probe(a, b, mode, split=False) - want).abs() / mag).max().item()
    assert split <= 2e-6
    assert one >= 50 * split


@pytest.mark.parametrize(
    "dtype,d,design",
    [(torch.bfloat16, 32, "wmma"), (torch.bfloat16, 56, "wmma"), (torch.bfloat16, 72, "wgmma"),
     (torch.bfloat16, 128, "wgmma"), (torch.float32, 64, "tf32x3")],
)
def test_other_head_dims_and_float32_keep_their_kernels(dev, dtype, d, design):
    """The shape alone picks the kernel: bfloat16 below head_dim 64 goes on
    through the WMMA kernels, 64-128 through the wgmma ones (72 on a tile of
    80 columns, 128 on two full panels), float32 through the tf32x3 kernels,
    forward, LSE and backward."""
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
    for d in (20, 136):  # not a multiple of 8; past 128
        q = torch.randn(1, 8, 2, d, device=dev)
        with pytest.raises(ValueError, match="multiple of 8 up to 128"):
            attention.flash_attention(q, q, q, 0.2)
    q = torch.randn(1, 8, 2, 16, device=dev, dtype=torch.float16)
    with pytest.raises(TypeError, match="dtype"):
        attention.flash_attention(q, q, q, 0.2)


# (shape of the tensor, view of it that the op sees): the widths of the B/16
# and L/14 towers (768, 1024, the SwiGLU hiddens 2048 and 2730, whose bf16
# rows are only 4-byte aligned), odd widths, and the two strided views of
# the final norm (`t[:, 1:]` of the dense pass, `t[:, 0]` of the CLS pass);
# for the backward also one row, 8193 rows, fewer rows than one block's row
# groups, and a ragged width (2731: one element a load) that takes six warps
# a row in the registers design (float32; a bfloat16 element is too small
# for its copies, so bfloat16 runs the staged design there, as below one row
# an SM)
_LN_VIEWS = {"all": lambda t: t, "drop_cls": lambda t: t[:, 1:], "cls_rows": lambda t: t[:, 0]}
_LN_CASES = [
    ((2, 257, 768), "all"), ((2, 257, 1024), "all"), ((2, 257, 2048), "all"),
    ((2, 257, 2730), "all"), ((3, 50, 341), "all"), ((5, 7, 170), "all"), ((1, 1, 2), "all"),
    ((1000, 1024), "all"), ((2, 4097, 1024), "drop_cls"), ((3, 65, 2730), "drop_cls"),
    ((40, 577, 1024), "cls_rows"), ((7, 5, 341), "cls_rows"),
    ((1, 1, 1024), "all"), ((8193, 768), "all"), ((3, 2730), "all"), ((2, 150, 2731), "all"),
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


@pytest.mark.parametrize("dtype,design", [(torch.float32, "registers"), (torch.bfloat16, "staged")])
def test_layer_norm_backward_design_of_the_ragged_width(dev, dtype, design):
    x, dy, _, _ = _ln_inputs(dev, (2, 150, 2731), "all", dtype, seed=0)
    plan = layer_norm.bwd_plan(x.dtype, 2731, layer_norm.bwd_vec(x, dy, None))
    assert (plan.vec, plan.group_warps) == (1, 6)
    assert layer_norm.describe_bwd(x, dy, None).startswith(design)


def test_layer_norm_backward_launches_after_a_smaller_set_up(dev):
    """One kernel instantiation set up at a larger shared size, then at a
    smaller one: the larger launch must still be allowed (bf16, 8-element
    loads: 1536 wide takes ~66 KB of shared memory, 1280 ~55 KB)."""
    outs = []
    for width in (1536, 1280, 1536):
        x, dy, weight, bias = _ln_inputs(dev, (2, 100, width), "all", torch.bfloat16, seed=width)
        assert layer_norm.describe_bwd(x, dy, None).startswith("registers")
        _, mu, rstd = layer_norm.layer_norm_fwd(x, weight, bias, _LN_EPS, return_stats=True)
        outs.append(layer_norm.layer_norm_bwd(x, dy, mu, rstd, weight))
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(outs[0], outs[2]))


def test_layer_norm_backward_replays_from_a_cuda_graph(dev):
    """Captured once and replayed, the backward (both launches) gives the
    bits of an eager call; the set-up of its kernels happens once, outside
    the launches that follow."""
    x, dy, weight, bias = _ln_inputs(dev, (2, 257, 2048), "all", torch.bfloat16, seed=11)
    assert layer_norm.describe_bwd(x, dy, None).startswith("registers")
    _, mu, rstd = layer_norm.layer_norm_fwd(x, weight, bias, _LN_EPS, return_stats=True)
    eager = layer_norm.layer_norm_bwd(x, dy, mu, rstd, weight)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        captured = layer_norm.layer_norm_bwd(x, dy, mu, rstd, weight)
    for _ in range(2):
        graph.replay()
        torch.cuda.synchronize()
        assert all(torch.equal(a, b) for a, b in zip(captured, eager))


def test_layer_norm_kernels_set_up_once(dev):
    """The shared-memory attribute and the occupancy query run once for each
    kernel and shared size, never on every launch, forward or backward."""
    for dtype in (torch.float32, torch.bfloat16):
        x, dy, weight, bias = _ln_inputs(dev, (2, 100, 2048), "all", dtype, seed=5)
        _, mu, rstd = layer_norm.layer_norm_fwd(x, weight, bias, _LN_EPS, return_stats=True)
        layer_norm.layer_norm_bwd(x, dy, mu, rstd, weight)
        before = layer_norm.setup_calls()
        for _ in range(3):
            layer_norm.layer_norm_fwd(x, weight, bias, _LN_EPS)
            _, mu, rstd = layer_norm.layer_norm_fwd(x, weight, bias, _LN_EPS, return_stats=True)
            layer_norm.layer_norm_bwd(x, dy, mu, rstd, weight)
            layer_norm.layer_norm_bwd(x, dy, mu, rstd, weight, need_dx=False)
        assert layer_norm.setup_calls() == before


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_layer_norm_backward_takes_rows_wider_than_the_registers_plan(dev, dtype):
    """Rows past BWD_MAX_WIDTH (and more rows than SMs) take the staged
    design, up to its own shared-memory limit, and match the plain version."""
    w = 12000
    assert layer_norm.BWD_MAX_WIDTH < w <= layer_norm.bwd_max_width(dtype)
    x, dy, weight, bias = _ln_inputs(dev, (200, w), "all", dtype, seed=2)
    assert layer_norm.describe_bwd(x, dy, None).startswith("staged")
    _, mu, rstd = layer_norm.layer_norm_fwd(x, weight, bias, _LN_EPS, return_stats=True)
    dx, dw, db = layer_norm.layer_norm_bwd(x, dy, mu, rstd, weight)
    want_dx, want_dw, want_db = layer_norm.layer_norm_bwd_plain(x, dy, mu, rstd, weight)
    torch.cuda.synchronize()
    _assert_ln_close(dx, want_dx, dtype)
    for got, want in ((dw, want_dw), (db, want_db)):
        assert (got - want).abs().max().item() <= 1e-5 * want.abs().max().item() + 1e-6


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_layer_norm_backward_rejects_rows_past_its_width_limit(dev, dtype):
    w = layer_norm.bwd_max_width(dtype) + 1
    x, dy, weight, bias = _ln_inputs(dev, (2, w), "all", dtype, seed=1)
    _, mu, rstd = layer_norm.layer_norm_fwd(x, weight, bias, _LN_EPS, return_stats=True)
    before = layer_norm.BWD_LAUNCHES.count
    with pytest.raises(ValueError, match="wider than"):
        layer_norm.layer_norm_bwd(x, dy, mu, rstd, weight)
    assert layer_norm.BWD_LAUNCHES.count == before


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
    ("plain", 3, 63, 0.5), ("plain", 3, 64, 0.5), ("plain", 3, 65, 0.5), ("invalid_any", 2, 2049, 0.5),
    # more boxes than one block's shared memory could hold: the scan keeps a bit a box
    ("plain", 1, 11068, 0.5), ("class_offset", 1, 20000, 0.4),
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
    if n <= 4096:  # the CPU's plain version and the mirror's [B, N, N] matrices: small cases
        assert torch.equal(want.cpu(), nms.nms_keep_mask_plain(boxes.cpu(), valid.cpu(), thr))
        assert torch.equal(nms.nms_keep_mask_blockwise_plain(boxes, valid, thr), want)
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
    many = nms.MAX_BOXES + 1
    with pytest.raises(ValueError, match="exceed"):
        nms.nms_keep_mask(torch.zeros(1, many, 4, device=dev), torch.ones(1, many, dtype=torch.bool, device=dev), 0.5)
    assert nms.LAUNCHES.count == before


def _launch_counts():
    return {
        "nms": nms.LAUNCHES.count, "flash_attention": attention.LAUNCHES.count,
        "flash_attention_bwd": attention.BWD_LAUNCHES.count, "rope_roll": rope_roll.LAUNCHES.count,
        "rope_roll_bwd": rope_roll.BWD_LAUNCHES.count, "layer_norm": layer_norm.LAUNCHES.count,
        "layer_norm_bwd": layer_norm.BWD_LAUNCHES.count,
    }


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_detector_train_step_on_card(dev, dtype):
    """One tiny detector train step through `make_det_train_step` on the
    card: the trunk's forward kernels and the NMS kernel launch, no backward
    kernel (the trunk is frozen), every metric is finite and every detector
    parameter moves (at a base lr of 1, so that the first update, lr 1e-3,
    moves the temperature of 50 by more than its float32 spacing)."""
    from clipself_tpu_torch.detector import config, fvit, train as det_train
    from clipself_tpu_torch.detector.classes import class_weights
    from clipself_tpu_torch.detector.data import SyntheticDetectionData
    from clipself_tpu_torch.models.factory import create_model

    cfg = config.PRESETS["tiny_test"]
    layers = 4  # EVA02-CLIP-Tiny-Det-Test
    host = SyntheticDetectionData(cfg.num_classes, cfg.image_size, cfg.max_gt, seed=0).batch(2)
    batch = {k: torch.as_tensor(v, device=dev) for k, v in host.items() if k not in ("scale", "image_id")}
    clip = create_model(cfg.clip_model, device=dev, dtype=dtype, seed=0).requires_grad_(False)
    det = fvit.create_detector(cfg, device=dev, seed=1)
    before = {k: v.clone() for k, v in det.state_dict().items()}
    state = det_train.DetTrainState(det, det_train.build_det_optimizer(det, base_lr=1.0))
    gen = torch.Generator().manual_seed(4)
    ce = torch.nn.functional.normalize(torch.randn(cfg.num_classes + 1, cfg.embed_dim, generator=gen), dim=-1).to(dev)
    cw = torch.as_tensor(class_weights("coco", cfg.bg_weight), device=dev)
    step = det_train.make_det_train_step(clip, cfg, ce, cw, torch.Generator(device=dev).manual_seed(0))
    counts = _launch_counts()
    metrics = step(state, batch)
    torch.cuda.synchronize()
    launched = {k: v - counts[k] for k, v in _launch_counts().items()}
    assert launched == {
        "nms": 1, "flash_attention": layers - 1, "flash_attention_bwd": 0, "rope_roll": layers - 1,
        "rope_roll_bwd": 0, "layer_norm": 4 * layers, "layer_norm_bwd": 0,
    }
    assert all(torch.isfinite(v).all() for v in metrics.values()) and metrics["grad_norm"] > 0
    for name, p in det.state_dict().items():
        assert torch.isfinite(p).all() and not torch.equal(p, before[name]), name
    assert all(p.grad is None for p in clip.parameters())


def test_detector_loss_on_card_matches_the_cpu(dev, monkeypatch):
    """The tiny detector loss from the same weights, batch and sampler noise:
    f32 kernels on the card against the plain versions on the CPU, the loss
    within 1e-4 relative and the trainable gradient at cosine >= 0.9999 (the
    bars of `chip_smoke.py`'s detector train parity), with TF32 off for the
    convolutions and products, as `chip_smoke.py` runs."""
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", False)
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", False)
    from clipself_tpu_torch.detector import config, fvit
    from clipself_tpu_torch.detector.classes import class_weights
    from clipself_tpu_torch.detector.data import SyntheticDetectionData
    from clipself_tpu_torch.detector.rpn import num_anchors
    from clipself_tpu_torch.detector.targets import draw_noise
    from clipself_tpu_torch.models.factory import create_model

    cfg = config.PRESETS["tiny_test"]
    host = SyntheticDetectionData(cfg.num_classes, cfg.image_size, cfg.max_gt, seed=2).batch(2)
    noise = draw_noise(torch.Generator().manual_seed(3), 2, num_anchors(cfg), cfg.train_proposals.max_per_img + cfg.max_gt)
    gen = torch.Generator().manual_seed(4)
    ce = torch.nn.functional.normalize(torch.randn(cfg.num_classes + 1, cfg.embed_dim, generator=gen), dim=-1)
    cw = torch.as_tensor(class_weights("coco", cfg.bg_weight))
    out = {}
    for device in ("cpu", dev):
        batch = {k: torch.as_tensor(v, device=device) for k, v in host.items() if k not in ("scale", "image_id")}
        clip = create_model(cfg.clip_model, device=device, dtype=torch.float32, seed=0).requires_grad_(False)
        det = fvit.create_detector(cfg, device=device, seed=1)
        taps, _ = fvit.backbone_taps(clip, batch["images"], cfg, False)
        loss, _ = det.loss(
            taps, batch["gt_boxes"], batch["gt_labels"], batch["gt_valid"],
            type(noise)(*(t.to(device) for t in noise)), ce.to(device), cw.to(device),
        )
        loss.backward()
        out[str(device)] = loss.item(), torch.cat([p.grad.flatten().cpu() for p in det.parameters()])
    (loss_c, g_c), (loss_k, g_k) = out["cpu"], out[str(dev)]
    assert abs(loss_k - loss_c) <= 1e-4 * abs(loss_c)
    assert torch.nn.functional.cosine_similarity(g_k, g_c, dim=0).item() >= 0.9999


@pytest.mark.parametrize("seed", [5, 6])
def test_nms_kernel_equals_plain_over_1203_classes_at_896(dev, seed):
    """The final class-wise NMS of the OV-LVIS L/14 preset: [8, 2000]
    candidates over 1203 classes in the 896^2 frame, each shifted by label x
    span, so the coordinates reach ~1.08e6, where a float32 ULP is 0.125."""
    boxes, valid = synthetic_nms_case("class_offset", 8, 2000, seed=seed, classes=1203, side=896)
    assert boxes.max().item() > 1e6
    boxes, valid = boxes.to(dev), valid.to(dev)
    got = nms.nms_keep_mask(boxes, valid, 0.4)
    want = nms.nms_keep_mask_plain(boxes, valid, 0.4)
    assert torch.equal(got, want), f"{(got != want).sum().item()} of {got.numel()} flags differ"
    assert torch.equal(nms.nms_keep_mask_blockwise_plain(boxes, valid, 0.4), want)
    assert torch.equal(want.cpu(), nms.nms_keep_mask_plain(boxes.cpu(), valid.cpu(), 0.4))


@pytest.mark.parametrize("preset", ["ov_coco_vitl14", "ov_lvis_vitl14"])
def test_l14_detector_predict_batch_on_card(dev, preset):
    """One `predict` batch of an L/14 preset at full size (EVA02-CLIP-L-14-336
    at 896^2, 261888 anchors, two images, bf16): the forward kernels of the 23
    attention blocks and the two NMS calls launch, the detections are finite,
    their labels in range and their boxes inside each image's valid size;
    with the mask head, 28 x 28 probabilities a detection."""
    import numpy as np

    from clipself_tpu_torch.detector import config, fvit
    from clipself_tpu_torch.detector.classes import base_novel_mask, coco_split, lvis_split
    from clipself_tpu_torch.detector.data import SyntheticDetectionData
    from clipself_tpu_torch.detector.evaluate import make_predict_fn
    from clipself_tpu_torch.models.factory import create_model

    cfg = config.PRESETS[preset]
    split = lvis_split() if "lvis" in preset else coco_split()
    host = SyntheticDetectionData(cfg.num_classes, cfg.image_size, cfg.max_gt, seed=0).batch(2)
    host["valid_hw"][1] = (896.0, 600.0)
    clip = create_model(cfg.clip_model, device=dev, dtype=torch.bfloat16, seed=0)
    det = fvit.create_detector(cfg, device=dev, seed=1)
    gen = torch.Generator().manual_seed(4)
    ce = torch.nn.functional.normalize(torch.randn(cfg.num_classes + 1, cfg.embed_dim, generator=gen), dim=-1)
    predict = make_predict_fn(det, clip, cfg, ce.to(dev), torch.as_tensor(base_novel_mask(split=split), device=dev))
    counts = _launch_counts()
    out = predict(torch.as_tensor(host["images"], device=dev), torch.as_tensor(host["valid_hw"], device=dev))
    torch.cuda.synchronize()
    launched = {k: v - counts[k] for k, v in _launch_counts().items()}
    assert launched == {
        "nms": 2, "flash_attention": 23, "flash_attention_bwd": 0, "rope_roll": 23,
        "rope_roll_bwd": 0, "layer_norm": 4 * 24 + 1, "layer_norm_bwd": 0,
    }
    boxes, scores, labels = out[:3]
    live = scores > 0
    assert boxes.shape == (2, 100, 4) and live.any()
    assert torch.isfinite(boxes).all() and torch.isfinite(scores[live]).all()
    assert ((labels[live] >= 0) & (labels[live] < cfg.num_classes)).all()
    assert (boxes[1, :, 2] <= 600.0).all() and (boxes >= 0).all()
    assert len(out) == (4 if cfg.with_mask else 3)
    if cfg.with_mask:
        probs = out[3]
        assert probs.shape == (2, 100, 28, 28) and np.isfinite(probs.float().cpu().numpy()).all()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_text_tower_on_card_matches_the_cpu(dev, dtype):
    """`encode_text` of the tiny text tower (a full-vocabulary variant, so
    that real BPE ids fit) on the card against the plain versions on the CPU
    from the same weights: its LayerNorms launch the kernel, two a block and
    the final one, and nothing else of ours launches (the causal attention
    is plain PyTorch); float32 within 1e-5, bfloat16 at min row cosine
    >= 0.9996, the bar of `chip_smoke.py`'s whole paths."""
    import dataclasses

    from clipself_tpu_torch.core.config import get_model_config
    from clipself_tpu_torch.models.factory import create_model, get_tokenizer

    tiny = get_model_config("EVA02-CLIP-Tiny-Test")
    cfg = dataclasses.replace(tiny, text=dataclasses.replace(tiny.text, vocab_size=49408))
    cpu = create_model(cfg, device="cpu", dtype=torch.float32, seed=0)
    card = create_model(cfg, device=dev, dtype=dtype, seed=0)
    tokens = torch.as_tensor(get_tokenizer(cfg)([
        "a photo of a cat", "This is a photo of the traffic light in the scene.", "x",
    ]))
    counts = _launch_counts()
    with torch.inference_mode():
        got = card.encode_text(tokens.to(dev), normalize=True)
        torch.cuda.synchronize()
        launched = {k: v - counts[k] for k, v in _launch_counts().items()}
        want = cpu.encode_text(tokens, normalize=True)
    layers = cfg.text.layers
    assert launched == {
        "nms": 0, "flash_attention": 0, "flash_attention_bwd": 0, "rope_roll": 0,
        "rope_roll_bwd": 0, "layer_norm": 2 * layers + 1, "layer_norm_bwd": 0,
    }
    if dtype == torch.float32:
        torch.testing.assert_close(got.cpu(), want, rtol=0, atol=1e-5)
    else:
        assert _min_row_cos(got.cpu(), want) >= 0.9996


def test_device_prefetch_gives_the_tensors_of_a_plain_copy(dev):
    """`data/loader.py::device_prefetch`: pinned host batches copied on a
    side stream with `non_blocking`, the compute stream waiting on each
    copy: every batch arrives equal to a plain copy, in order, also when a
    batch's tensors are used after later batches were issued."""
    import numpy as np

    from clipself_tpu_torch.data.loader import device_prefetch

    gen = torch.Generator().manual_seed(0)
    batches = [
        {"images": torch.randn(2, 64, 64, 3, generator=gen),
         "boxes": torch.randn(2, 4, 5, generator=gen).pin_memory(),
         "crops": np.random.default_rng(i).standard_normal((2, 4, 8, 8, 3)).astype(np.float32)}
        for i in range(5)
    ]
    got = []
    for b in device_prefetch(batches, dev):
        assert all(t.device == dev for t in b.values())
        got.append({k: (v * 1).clone() for k, v in b.items()})  # work on the compute stream
    torch.cuda.synchronize()
    assert len(got) == len(batches)
    for want, have in zip(batches, got):
        for k, v in want.items():
            assert torch.equal(have[k].cpu(), torch.as_tensor(v))


def _png(img) -> bytes:
    """An RGB uint8 PNG, every row unfiltered (the test's corpus writer)."""
    import struct
    import zlib

    def chunk(kind, data):
        return struct.pack(">I", len(data)) + kind + data + struct.pack(">I", zlib.crc32(kind + data))

    h, w, _ = img.shape
    raw = b"".join(b"\x00" + img[y].tobytes() for y in range(h))
    return (b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0))
            + chunk(b"IDAT", zlib.compress(raw)) + chunk(b"IEND", b""))


def test_file_data_step_equals_the_same_batch_staged_by_hand(dev, tmp_path):
    """One B/16 step from files (`train.main --train-data`, batch 1, 1024^2,
    20 boxes, float32) has the loss of the same item staged on the card by
    hand and fed to the loss of a model built from the same seed: the
    loader, `device_prefetch` and the trainer change nothing (1e-5)."""
    import json
    from functools import partial

    import numpy as np

    from clipself_tpu_torch.data.datasets import GridDistillDataset
    from clipself_tpu_torch.models.factory import create_model
    from clipself_tpu_torch.train import main as train_main
    from clipself_tpu_torch.train.methods import clipself_loss

    rng = np.random.default_rng(0)
    (tmp_path / "img").mkdir()
    images = []
    for i, (w, h) in enumerate(((640, 480), (480, 640))):
        (tmp_path / "img" / f"{i}.png").write_bytes(_png(rng.integers(0, 256, (h, w, 3), dtype=np.uint8)))
        images.append({"id": i, "file_name": f"{i}.png", "width": w, "height": h})
    (tmp_path / "train.json").write_text(json.dumps({"images": images, "annotations": [], "categories": []}))
    run = train_main.main([
        "--model", "EVA02-CLIP-B-16", "--precision", "fp32", "--device", "cuda",
        "--batch-size", "1", "--det-image-size", "1024", "--max-boxes", "20",
        "--train-data", str(tmp_path / "train.json"), "--train-image-root", str(tmp_path / "img"),
        "--steps-per-epoch", "1", "--epochs", "1", "--workers", "0", "--log-every-n-steps", "1",
        "--logs", str(tmp_path / "logs"), "--name", "files", "--save-frequency", "0",
    ])
    ds = GridDistillDataset(str(tmp_path / "train.json"), str(tmp_path / "img"), det_size=1024,
                            crop_size=224, max_anns=20)
    item = ds[int(np.random.default_rng((0, 0)).permutation(len(ds))[0])]
    batch = {k: torch.as_tensor(v[None], device=dev) for k, v in item.items()}
    model = create_model("EVA02-CLIP-B-16", device=dev, dtype=torch.float32, seed=0)
    loss, _ = partial(clipself_loss, cosine_weight=1.0)(model, model, batch)
    assert abs(run["history"][0]["loss"] - loss.item()) <= 1e-5


def test_region_clip_step_launches_the_dense_pass_kernels_and_no_teacher(dev):
    """One RegionCLIP step (`train/methods.py::regionclip_loss` through
    `make_train_step`, the trainer's `make_regionclip_loss`) at Tiny size: the student's dense pass and its
    backward, no teacher: per attention block (layers - 1, the last block
    takes the value path) one flash forward, one flash backward, one RoPE
    launch each way; every LayerNorm of the tower (4 a block and the final
    one) forward and backward. Its noise draw does not synchronise the
    host; the loss and every updated parameter are finite."""
    from clipself_tpu_torch.models.factory import create_model
    from clipself_tpu_torch.train import methods, optim, step

    model = create_model("EVA02-CLIP-Tiny-Test", device=dev, dtype=torch.float32, seed=0)
    layers = model.cfg.vision.layers
    opt = optim.build_optimizer(model, optim.make_schedule("const", 1e-3, 0, 10),
                                unlocked_groups=layers, num_layers=layers)
    nouns = torch.nn.functional.normalize(torch.randn(128, model.cfg.embed_dim, device=dev), dim=-1)
    gen = torch.Generator().manual_seed(0)
    boxes = torch.zeros(2, 4, 6)
    boxes[..., :2] = torch.rand(2, 4, 2, generator=gen) * 0.5
    boxes[..., 2:4] = boxes[..., :2] + 0.25
    boxes[..., 4] = torch.randint(0, 128, (2, 4), generator=gen).float()
    boxes[:, :3, 5] = 1.0  # the last row padded with a box, label and valid flag 0
    boxes[:, 3] = 0.0
    batch = {"images": torch.randn(2, 64, 64, 3, generator=gen).to(dev), "boxes": boxes.to(dev)}
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        noise = methods.fed_loss_noise(0, 3, 128, dev)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert noise.device.type == "cuda" and noise.shape == (128,)

    counters = {
        "flash_attention": attention.LAUNCHES, "flash_attention_bwd": attention.BWD_LAUNCHES,
        "rope_roll": rope_roll.LAUNCHES, "rope_roll_bwd": rope_roll.BWD_LAUNCHES,
        "layer_norm": layer_norm.LAUNCHES, "layer_norm_bwd": layer_norm.BWD_LAUNCHES,
    }
    before = {k: c.count for k, c in counters.items()}
    state = step.TrainState(model, opt)
    metrics = step.make_train_step(methods.make_regionclip_loss(nouns, 0), None)(state, batch)
    torch.cuda.synchronize()
    got = {k: c.count - before[k] for k, c in counters.items()}
    dense, norms = layers - 1, 4 * layers + 1
    assert got == {"flash_attention": dense, "flash_attention_bwd": dense, "rope_roll": dense,
                   "rope_roll_bwd": dense, "layer_norm": norms, "layer_norm_bwd": norms}
    assert torch.isfinite(metrics["loss"]) and metrics["num_boxes"].item() == 6
    assert all(torch.isfinite(p).all() for p in model.parameters())


def _vit_attention(dev, seed):
    """The OpenCLIP ViT's packed attention at ViT-B-16's width (768, 12
    heads of 64) with seeded weights, float32 parameters on the card."""
    from clipself_tpu_torch.models.open_clip_vit import Attention

    attn = Attention(768, 12)
    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for p in attn.parameters():
            p.copy_(torch.randn(p.shape, generator=gen) * 768 ** -0.5)
    return attn.to(dev)


@pytest.mark.parametrize("n", [197, 4097])
def test_vit_packed_attention_reads_the_projection_in_place(dev, n, monkeypatch):
    """ViT-B-16's q, k and v are strided views of the packed projection
    (row stride 3 x 768): the flash kernel takes them without a copy, once a
    call, and agrees with the plain attention on the same views (bf16: min
    row cosine 0.9999)."""
    import torch.nn.functional as F

    from clipself_tpu_torch.models import open_clip_vit

    attn = _vit_attention(dev, 3)
    x = torch.randn(2, n, 768, generator=torch.Generator().manual_seed(4)).to(dev, torch.bfloat16)
    qkv = F.linear(x, attn.in_proj_weight.bfloat16(), attn.in_proj_bias.bfloat16())
    q, k, v = (t.view(2, n, 12, 64) for t in qkv.split(768, dim=-1))
    assert not q.is_contiguous() and q.stride()[:3] == (n * 2304, 2304, 64)
    attention._check_qkv(q, k, v, "ViT-B-16 views")  # no copy needed
    before = attention.LAUNCHES.count
    with torch.no_grad():
        got = attn(x)
    assert attention.LAUNCHES.count == before + 1
    monkeypatch.setattr(open_clip_vit, "multi_head_attention", attention.attention_masked)
    with torch.no_grad():
        want = attn(x)
    assert attention.LAUNCHES.count == before + 1
    assert _min_row_cos(got, want) >= 0.9999


def test_vit_masked_attention_runs_the_plain_op(dev):
    """With the mask of mask-attention pooling the dispatch takes
    `attention_masked` on the card, as the JAX package takes XLA: no flash
    launch, the plain op's values."""
    from clipself_tpu_torch.models.open_clip_vit import OpenCLIPViT

    attn = _vit_attention(dev, 5)
    gen = torch.Generator().manual_seed(6)
    boxes = torch.rand(2, 20, 4, generator=gen).sort(-1).values[..., [0, 1, 2, 3]]
    boxes = torch.stack([boxes[..., 0], boxes[..., 1], boxes[..., 2], boxes[..., 3]], -1).to(dev)
    mask = OpenCLIPViT.attention_mask(OpenCLIPViT.boxes_to_grid_masks(boxes, 14, 14))
    x = torch.randn(2, mask.shape[-1], 768, generator=gen).to(dev, torch.bfloat16)
    before = attention.LAUNCHES.count
    with torch.no_grad():
        got = attn(x, mask)
        import torch.nn.functional as F

        qkv = F.linear(x, attn.in_proj_weight.bfloat16(), attn.in_proj_bias.bfloat16())
        q, k, v = (t.reshape(2, -1, 12, 64) for t in qkv.split(768, dim=-1))
        want = attn.out_proj(attention.attention_masked(q, k, v, 0.125, mask).reshape(x.shape))
    assert attention.LAUNCHES.count == before
    assert torch.equal(got, want)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_vit_block_forward_backward_on_card(dev, dtype, monkeypatch):
    """One ViT-B-16 block (QuickGELU, LayerScale) over [2, 197, 768] on the
    card, forward and backward through the flash and LayerNorm kernels,
    against the same block on their plain versions in float32: float32
    within 1e-4 (of each gradient's largest entry), bfloat16 at min cosine
    0.999."""
    import dataclasses

    from clipself_tpu_torch.core.config import get_model_config
    from clipself_tpu_torch.models import eva_vit, open_clip_vit
    from clipself_tpu_torch.ops.layer_norm import layer_norm_plain

    cfg = dataclasses.replace(get_model_config("ViT-B-16").vision, quick_gelu=True, ls_init_value=0.5)
    block = open_clip_vit.CLIPBlock(cfg)
    gen = torch.Generator().manual_seed(8)
    with torch.no_grad():
        for p in block.parameters():
            p.add_(torch.randn(p.shape, generator=gen) * 0.03)
    block = block.to(dev)
    x0 = torch.randn(2, 197, 768, generator=gen).to(dev)

    def run(dt):
        x = x0.to(dt).requires_grad_()
        block.zero_grad()
        out = block(x)
        out.float().square().sum().backward()
        return [out.float(), x.grad.float()] + [p.grad.float().clone() for p in block.parameters()]

    before = (attention.LAUNCHES.count, attention.BWD_LAUNCHES.count, layer_norm.BWD_LAUNCHES.count)
    got = run(dtype)
    after = (attention.LAUNCHES.count, attention.BWD_LAUNCHES.count, layer_norm.BWD_LAUNCHES.count)
    assert [a - b for a, b in zip(after, before)] == [1, 1, 2]
    monkeypatch.setattr(open_clip_vit, "multi_head_attention", attention.attention_masked)
    monkeypatch.setattr(eva_vit, "layer_norm", layer_norm_plain)
    want = run(torch.float32)
    for g, w in zip(got, want):
        if dtype == torch.float32:
            assert (g - w).abs().max().item() <= 1e-4 * w.abs().max().item() + 1e-6
        else:
            assert torch.nn.functional.cosine_similarity(g.flatten(), w.flatten(), dim=0) >= 0.999
