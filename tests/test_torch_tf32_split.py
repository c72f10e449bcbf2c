"""The arithmetic of the float32 flash kernels' three-product TF32 split
(`csrc/hopper_mma.cuh`, design "tf32x3"), emulated on the CPU with the
port's own helpers (`ops/hopper_mma_probe.py`: TF32 rounding by clearing
mantissa bits, float64 sums of the products): softmax attention forward and
backward of one seeded [1024, 64] head with every product formed as
lo_a hi_b + hi_a lo_b + hi_a hi_b stays within 1e-6 of float64 (read
1.2e-7 to 1.6e-7, at the level of float32 itself: 5e-7 to 8e-7), with lo
rounded to nearest or cut toward zero; one TF32 product errs at least 50
times as much (read 2.2e-4 to 3.2e-4). The card's tensor cores add a
product's terms with less care than float64: that part is held on the card
(`tests/test_torch_kernels_cuda.py`)."""

import numpy as np
import pytest
import torch

from clipself_tpu_torch.ops import hopper_mma_probe as probe

from torch_threads import capped_threads  # noqa: F401  (module fixture)

N, D = 1024, 64


def _inputs():
    rng = np.random.default_rng(20251025)
    return [torch.from_numpy(rng.standard_normal((N, D)).astype(np.float32)) for _ in range(4)]


def _matmul(a, b, how):
    if how == "one":
        return probe.tf32_matmul(a, b, split=False)
    return probe.tf32_matmul(a, b, lo=how)


def _attention(q, k, v, do, how):
    """Forward and backward as the kernels compute them, every product
    through `_matmul`; the softmax and dS elementwise in float32."""
    scale = D ** -0.5
    s = _matmul(q, k.T, how) * scale
    p = torch.exp(s - torch.logsumexp(s, -1, keepdim=True))
    o = _matmul(p, v, how)
    di = (do * o).sum(-1, keepdim=True)
    ds = p * (_matmul(do, v.T, how) - di) * scale
    return o, _matmul(ds, k, how), _matmul(ds.T, q, how), _matmul(p.T, do, how)


def _float64(q, k, v, do):
    q, k, v, do = (t.double() for t in (q, k, v, do))
    scale = D ** -0.5
    p = torch.softmax(q @ k.T * scale, -1)
    o = p @ v
    ds = p * (do @ v.T - (do * o).sum(-1, keepdim=True)) * scale
    return o, ds @ k, ds.T @ q, p.T @ do


def _errors(how):
    q, k, v, do = _inputs()
    return [(g.double() - w).abs().max().item() for g, w in zip(_attention(q, k, v, do, how), _float64(q, k, v, do))]


@pytest.mark.parametrize("lo", ["rna", "cut"])
def test_three_product_split_keeps_float32_accuracy(lo):
    """O, dQ, dK and dV of the split within 1e-6 of float64, and one TF32
    product at least 50 times further off in each."""
    split, one = _errors(lo), _errors("one")
    assert max(split) <= 1e-6
    for s, o in zip(split, one):
        assert o >= 50 * s


def test_tf32_rounding_is_to_nearest_ties_away():
    """`tf32_round` keeps 10 explicit mantissa bits, rounding half a unit
    away from zero as cvt.rna.tf32.f32 does; the split is exact."""
    x = torch.tensor([1 + 2 ** -11, -(1 + 2 ** -11), 1 + 2 ** -12, 1 + 3 * 2 ** -11, 3.0e38])
    want = torch.tensor([1 + 2 ** -10, -(1 + 2 ** -10), 1.0, 1 + 2 ** -9, 3.0e38])
    got = probe.tf32_round(x)
    assert torch.equal(got[:4], want[:4])
    assert (got[4] - want[4]).abs() <= 2 ** -11 * want[4]
    assert torch.equal(probe.tf32_cut(torch.tensor([1 + 2 ** -10 + 2 ** -11])), torch.tensor([1 + 2 ** -10]))
    y = torch.from_numpy(np.random.default_rng(3).standard_normal(4096).astype(np.float32))
    hi, lo = probe.tf32_split(y)
    assert torch.equal(hi.view(torch.int32) & 0x1FFF, torch.zeros(4096, dtype=torch.int32))
    assert ((y - hi).abs() <= 2 ** -11 * y.abs()).all()
    assert ((y.double() - hi.double() - lo.double()).abs() <= 2 ** -22 * y.abs().double()).all()
