"""The port's CUDA kernels against their plain PyTorch versions, on a CUDA
card. Marked `cuda`: they skip where no card is present. Run on the card:

    python -m pytest --noconftest -m cuda tests/test_torch_kernels_cuda.py -q

Tolerances: RoPE float32 differs from the plain version by the kernel's FMA
(one rounding, 1e-6 at |x| <= ~5), bfloat16 by at most one bf16 ULP of the
result after that (rtol 1.6e-2 is 2 ULP); attention float32 by
summation order (1e-4), bfloat16 by the bf16 rounding of the probabilities
(min row cosine 0.9999 against float32).
"""

import pytest
import torch

from clipself_tpu_torch.models.rope import rope_tables
from clipself_tpu_torch.ops import attention, rope_roll

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)


@pytest.mark.parametrize(
    "dtype,rtol,atol", [(torch.float32, 0.0, 1e-6), (torch.bfloat16, 1.6e-2, 1e-5)]
)
@pytest.mark.parametrize("b,grid,heads", [(2, 8, 12), (3, 14, 2)])
def test_rope_kernel_matches_plain(dev, dtype, rtol, atol, b, grid, heads):
    tables = rope_tables(grid, grid, 64, 1, 16, dev)
    n = 1 + grid * grid
    x = torch.randn(b, n, heads * 64, generator=torch.Generator().manual_seed(0)).to(dev, dtype)
    before = rope_roll.LAUNCHES.count
    got = rope_roll.rolled_rope(x, *tables)
    assert rope_roll.LAUNCHES.count == before + 1
    want = rope_roll.rolled_rope_plain(x, *tables)
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


def test_attention_kernel_rejects_what_it_does_not_take(dev):
    q = torch.randn(1, 8, 2, 24, device=dev)
    with pytest.raises(ValueError, match="multiple of 16"):
        attention.flash_attention(q, q, q, 0.2)
    q = torch.randn(1, 8, 2, 16, device=dev, dtype=torch.float16)
    with pytest.raises(TypeError, match="dtype"):
        attention.flash_attention(q, q, q, 0.2)
