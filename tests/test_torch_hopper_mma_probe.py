"""The `csrc/hopper_mma.cuh` probe's wrapper on the CPU: every (mode, K, N)
form it is built at takes its shapes and returns its plain product, the
yardstick the `cuda` test holds the kernel to; other shapes are refused.
Exact: the plain version is the same float32 product."""

import pytest
import torch

from clipself_tpu_torch.ops import hopper_mma_probe


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
