"""The port's NxN RoI-align (`clipself_tpu_torch.ops.roi_align.roi_align_nxn`,
`roi_align_nxn_levels`, `detector.roi_head.multilevel_roi_align`) against the
JAX package on the same NumPy maps and boxes from a seed, float32 on the
CPU. Both sides build the same separable weights and contract rows, then
columns; only the order of the float32 sums differs: 1e-5 on values of
order 1.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from clipself_tpu.detector import roi_head as jroi_head
from clipself_tpu.ops import roi_align as jroi
from clipself_tpu_torch.detector import roi_head
from clipself_tpu_torch.ops import roi_align

from torch_threads import capped_threads  # noqa: F401  (module fixture)

TOL = 1e-5


def _boxes(rng, b, m, w, h):
    lo = rng.uniform(-2.0, 0.8, (b, m, 2)) * [w, h]
    ext = rng.uniform(0.0, 0.6, (b, m, 2)) * [w, h]
    boxes = np.concatenate([lo, lo + ext], -1).astype(np.float32)
    boxes[:, 0, 2:] = boxes[:, 0, :2]  # a degenerate roi: zero samples
    boxes[:, 1] = [-50.0, -50.0, -40.0, -40.0]  # wholly outside the map
    return boxes


@pytest.mark.parametrize("out_size", [(1, 1), (2, 3), (7, 7), (14, 14)])
@pytest.mark.parametrize("hw", [(9, 13), (20, 20)])
def test_roi_align_nxn_matches_jax(out_size, hw):
    rng = np.random.default_rng(0)
    h, w = hw
    feats = rng.normal(size=(2, h, w, 5)).astype(np.float32)
    boxes = _boxes(rng, 2, 11, w, h)
    got = roi_align.roi_align_nxn(torch.from_numpy(feats), torch.from_numpy(boxes), out_size)
    want = jroi.roi_align_nxn(jnp.asarray(feats), jnp.asarray(boxes), out_size)
    assert got.shape == (2, 11) + out_size + (5,)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=TOL)


def test_nxn_1x1_is_roi_align_1x1():
    rng = np.random.default_rng(1)
    feats = torch.from_numpy(rng.normal(size=(2, 8, 8, 4)).astype(np.float32))
    boxes = torch.from_numpy(_boxes(rng, 2, 9, 8, 8))
    a = roi_align.roi_align_nxn(feats, boxes, (1, 1))[:, :, 0, 0]
    np.testing.assert_allclose(a.numpy(), roi_align.roi_align_1x1(feats, boxes).numpy(), atol=TOL)


def _pyramid(rng, b, c, sizes):
    return [rng.normal(size=(b, s, s2, c)).astype(np.float32) for s, s2 in sizes]


@pytest.mark.parametrize("sizes,strides,out", [
    ([(32, 32), (16, 16), (8, 8), (4, 4)], (2, 4, 8, 16), 7),
    ([(16, 12), (8, 6), (4, 3), (2, 2)], (3.5, 7, 14, 28), 14),
])
def test_roi_align_nxn_levels_matches_jax(sizes, strides, out):
    rng = np.random.default_rng(2)
    feats = _pyramid(rng, 2, 6, sizes)
    img_w, img_h = sizes[0][1] * strides[0], sizes[0][0] * strides[0]
    boxes = _boxes(rng, 2, 17, img_w, img_h)
    lvl = rng.integers(0, 4, (2, 17))
    got = roi_align.roi_align_nxn_levels(
        [torch.from_numpy(f) for f in feats], torch.from_numpy(boxes), torch.from_numpy(lvl),
        strides, (out, out),
    )
    want = jroi.roi_align_nxn_levels(
        [jnp.asarray(f) for f in feats], jnp.asarray(boxes), jnp.asarray(lvl), strides, (out, out)
    )
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=TOL)
    # and each roi equals the single-level pooling of its own level
    for level in range(4):
        single = roi_align.roi_align_nxn(
            torch.from_numpy(feats[level]), torch.from_numpy(boxes) / float(strides[level]),
            (out, out),
        )
        sel = torch.from_numpy(lvl == level)
        np.testing.assert_allclose(got[sel].numpy(), single[sel].numpy(), rtol=0, atol=TOL)


def test_multilevel_roi_align_matches_jax():
    """Level assignment included: rois from 4 to 400 pixels wide."""
    rng = np.random.default_rng(3)
    feats = _pyramid(rng, 2, 4, [(40, 40), (20, 20), (10, 10), (5, 5)])
    lo = rng.uniform(0, 100, (2, 24, 2))
    side = np.exp(rng.uniform(np.log(4), np.log(400), (2, 24, 1)))
    rois = np.concatenate([lo, lo + side * rng.uniform(0.5, 1.5, (2, 24, 2))], -1).astype(np.float32)
    lv = roi_head.roi_levels(torch.from_numpy(rois), 4, 56.0)
    assert set(lv.unique().tolist()) == {0, 1, 2, 3}
    got = roi_head.multilevel_roi_align(
        [torch.from_numpy(f) for f in feats], torch.from_numpy(rois), (4, 8, 16, 32), 7, 56.0
    )
    want = jroi_head.multilevel_roi_align(
        [jnp.asarray(f) for f in feats], jnp.asarray(rois), (4, 8, 16, 32), 7, 56.0
    )
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=TOL)


def test_bfloat16_map_keeps_bfloat16_intermediate():
    rng = np.random.default_rng(4)
    feats = torch.from_numpy(rng.normal(size=(1, 12, 12, 8)).astype(np.float32))
    boxes = torch.from_numpy(_boxes(rng, 1, 6, 12, 12))
    want = roi_align.roi_align_nxn(feats, boxes, (7, 7))
    got = roi_align.roi_align_nxn(feats.bfloat16(), boxes, (7, 7))
    assert got.dtype == torch.bfloat16
    # bf16 weights, map and y-stage: three roundings of 2^-8 relative each
    np.testing.assert_allclose(got.float().numpy(), want.numpy(), rtol=0, atol=0.06)
