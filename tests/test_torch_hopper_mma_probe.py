"""The `csrc/hopper_mma.cuh` probe's wrapper on the CPU: every (mode, K, N)
form it is built at takes its shapes and returns its plain product, the
yardstick the `cuda` test holds the kernel to; other shapes are refused.
Exact: the plain version is the same float32 product (for the float32
forms of the TF32 split, the float64 product rounded to float32)."""

import numpy as np
import pytest
import torch

from clipself_tpu_torch.ops import hopper_mma_probe

from torch_threads import capped_threads  # noqa: F401  (module fixture)


@pytest.mark.parametrize("mode,k,n", hopper_mma_probe.PRODUCTS)
def test_probe_forms_take_their_shapes_on_the_cpu(mode, k, n):
    gen = torch.Generator().manual_seed(1000 * mode + k + n)
    a, b = (torch.randn(shape, generator=gen).to(torch.bfloat16)
            for shape in hopper_mma_probe.shapes(mode, k, n))
    a32, b32 = a.float(), b.float()
    want = torch.matmul(*((a32, b32.T), (a32, b32), (a32.T, b32))[mode])
    got = hopper_mma_probe.wgmma_probe(a, b, mode)
    assert got.shape == (64, n) and got.dtype == torch.float32
    assert torch.equal(got, want)


@pytest.mark.parametrize("mode,shapes", [
    (0, ((64, 72), (64, 72))),   # K not built
    (1, ((64, 64), (64, 24))),   # N not a multiple of 16
    (2, ((32, 64), (64, 64))),   # a not [64, 64]
    (3, ((64, 64), (64, 64))),   # no such mode
])
def test_probe_refuses_forms_it_is_not_built_at(mode, shapes):
    a, b = (torch.zeros(s, dtype=torch.bfloat16) for s in shapes)
    with pytest.raises(ValueError, match="wgmma_probe"):
        hopper_mma_probe.wgmma_probe(a, b, mode)


@pytest.mark.parametrize("mode,k,n", hopper_mma_probe.TF32_PRODUCTS)
def test_tf32_forms_take_their_shapes_on_the_cpu(mode, k, n):
    """Each float32 form of the three-product split takes its shapes: its
    plain version is the float64 product rounded to float32; one TF32
    product (``split=False``) is that product on operands rounded to TF32,
    within 2^-10 of sum |a_k b_k| of it."""
    rng = np.random.default_rng(1000 * mode + k + n)
    a, b = (torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
            for shape in hopper_mma_probe.tf32_shapes(mode, k, n))
    want = (a.double() @ (b.double().T if mode in (3, 6) else b.double())).float()
    got = hopper_mma_probe.tf32_probe(a, b, mode)
    assert got.shape == (64 if mode == 3 else 16, n) and got.dtype == torch.float32
    assert torch.equal(got, want)
    one = hopper_mma_probe.tf32_probe(a, b, mode, split=False)
    mag = hopper_mma_probe.tf32_probe_plain(a.abs(), b.abs(), mode)
    assert 0 < ((one - want).abs() / mag).max().item() <= 2 ** -10


@pytest.mark.parametrize("mode,shapes,dtype", [
    (3, ((64, 20), (32, 20)), torch.float32),   # K not a multiple of 8
    (3, ((64, 136), (32, 136)), torch.float32),  # K past 128
    (3, ((64, 64), (64, 64)), torch.float32),   # N not 16 or 32
    (3, ((16, 64), (32, 64)), torch.float32),   # a not 64 rows
    (4, ((16, 64), (64, 12)), torch.float32),   # N not a multiple of 8
    (4, ((8, 64), (64, 64)), torch.float32),    # a not [16, 64]
    (5, ((16, 24), (24, 64)), torch.float32),   # K not 16 or 32
    (5, ((16, 32), (16, 64)), torch.float32),   # a and b disagree on K
    (6, ((16, 64), (32, 64)), torch.float32),   # b not 64 rows
    (7, ((16, 64), (64, 64)), torch.float32),   # no such mode
    (3, ((64, 64), (32, 64)), torch.bfloat16),  # not float32
])
def test_tf32_probe_refuses_forms_it_is_not_built_at(mode, shapes, dtype):
    a, b = (torch.zeros(s, dtype=dtype) for s in shapes)
    with pytest.raises(ValueError, match="tf32_probe"):
        hopper_mma_probe.tf32_probe(a, b, mode)
