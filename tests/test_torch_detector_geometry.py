"""The port's detector geometry (`clipself_tpu_torch.detector.{config,
anchors, boxes, rpn}`, `ops.interpolate.resize_nhwc`) against the JAX
package on the same NumPy inputs from a seed, float32 on the CPU. The config
presets and the anchors are copies and must be equal; the box functions
repeat the same float32 formulas (1e-5: `exp` and `log` differ in the last
place between the two libraries); proposals keep the same anchors in the
same order.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from clipself_tpu.detector import anchors as janchors
from clipself_tpu.detector import boxes as jboxes
from clipself_tpu.detector import config as jconfig
from clipself_tpu.detector import rpn as jrpn
from clipself_tpu.ops.interpolate import resize_nhwc as jresize_nhwc
from clipself_tpu_torch.detector import anchors, boxes, config, rpn
from clipself_tpu_torch.ops.interpolate import resize_nhwc

from torch_threads import capped_threads  # noqa: F401  (module fixture)

TOL = 1e-5


def _deep(cfg):
    """A config as nested plain dicts (the two packages' classes differ)."""
    return dataclasses.asdict(cfg)


@pytest.mark.parametrize("name", sorted(jconfig.PRESETS))
def test_preset_equals_original(name):
    assert _deep(config.PRESETS[name]) == _deep(jconfig.PRESETS[name])


def test_presets_are_the_same_set():
    assert sorted(config.PRESETS) == sorted(jconfig.PRESETS)
    assert [f.name for f in dataclasses.fields(config.FViTConfig)] == [
        f.name for f in dataclasses.fields(jconfig.FViTConfig)
    ]


@pytest.mark.parametrize("strides,shapes", [
    ((4, 8, 16, 32, 64), [(160, 160), (80, 80), (40, 40), (20, 20), (10, 10)]),
    ((3.5, 7, 14, 28, 56), [(16, 12), (8, 6), (4, 3), (2, 2), (1, 1)]),
])
def test_anchors_equal_original(strides, shapes):
    args = (shapes, strides, (8.0,), (0.5, 1.0, 2.0), 0.0)
    for got, want in zip(anchors.multi_level_anchors(*args), janchors.multi_level_anchors(*args)):
        np.testing.assert_array_equal(got, want)


def _rand_boxes(rng, shape, size=100.0):
    lo = rng.uniform(0, size * 0.8, shape + (2,))
    wh = rng.uniform(1.0, size * 0.3, shape + (2,))
    return np.concatenate([lo, lo + wh], -1).astype(np.float32)


def test_area_iou_iof_match_jax():
    rng = np.random.default_rng(0)
    a, b = _rand_boxes(rng, (13,)), _rand_boxes(rng, (7,))
    a[3, 2:] = a[3, :2]  # a zero-area box
    ta, tb = torch.from_numpy(a), torch.from_numpy(b)
    for name in ("box_iou", "box_iof"):
        got = getattr(boxes, name)(ta, tb).numpy()
        want = np.asarray(getattr(jboxes, name)(jnp.asarray(a), jnp.asarray(b)))
        np.testing.assert_allclose(got, want, rtol=0, atol=TOL)
    np.testing.assert_allclose(
        boxes.box_area(ta).numpy(), np.asarray(jboxes.box_area(jnp.asarray(a))), rtol=1e-6
    )


@pytest.mark.parametrize("stds", [(1.0, 1.0, 1.0, 1.0), (0.1, 0.1, 0.2, 0.2)])
def test_encode_decode_clip_match_jax(stds):
    rng = np.random.default_rng(1)
    src, dst = _rand_boxes(rng, (2, 20)), _rand_boxes(rng, (2, 20))
    means = (0.0, 0.1, 0.0, -0.1)
    got = boxes.encode_boxes(torch.from_numpy(src), torch.from_numpy(dst), means, stds)
    want = jboxes.encode_boxes(jnp.asarray(src), jnp.asarray(dst), means, stds)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=TOL, atol=TOL)
    deltas = rng.normal(scale=2.0, size=(2, 20, 4)).astype(np.float32)
    deltas[0, 0, 2:] = 50.0  # clamped at the ratio limit
    for max_shape in (None, (90, 70)):
        got = boxes.decode_boxes(torch.from_numpy(src), torch.from_numpy(deltas), means, stds, max_shape)
        want = jboxes.decode_boxes(jnp.asarray(src), jnp.asarray(deltas), means, stds, max_shape)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=TOL, atol=1e-4)
    b = np.array([[-5.0, -5.0, 500.0, 30.0]], np.float32)
    np.testing.assert_array_equal(
        boxes.clip_boxes(torch.from_numpy(b), (100, 200)).numpy(),
        np.asarray(jboxes.clip_boxes(jnp.asarray(b), (100, 200))),
    )


@pytest.mark.parametrize("hw,out", [((5, 4), (10, 8)), ((3, 3), (7, 5)), ((4, 4), (4, 4))])
def test_nearest_resize_equals_jax(hw, out):
    rng = np.random.default_rng(2)
    x = rng.normal(size=(2,) + hw + (3,)).astype(np.float32)
    got = resize_nhwc(torch.from_numpy(x), out, method="nearest")
    want = jresize_nhwc(jnp.asarray(x), out, method="nearest")
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_bilinear_resize_nhwc_matches_jax():
    rng = np.random.default_rng(3)
    x = rng.normal(size=(1, 5, 4, 2)).astype(np.float32)
    got = resize_nhwc(torch.from_numpy(x), (9, 7), method="bilinear")
    want = jresize_nhwc(jnp.asarray(x), (9, 7), method="bilinear")
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=TOL)


def _rpn_maps(rng, cfg, b, tied):
    size = cfg.image_size
    shapes = [(int(np.ceil(size / s)),) * 2 for s in cfg.anchors.strides]
    scores = [rng.normal(size=(b,) + hw + (3,)).astype(np.float32) for hw in shapes]
    if tied:  # coarse logits: equal objectness across many anchors
        scores = [np.round(s * 2) / 2 for s in scores]
    deltas = [rng.normal(scale=0.3, size=(b,) + hw + (12,)).astype(np.float32) for hw in shapes]
    return scores, deltas


@pytest.mark.parametrize("tied", [False, True])
@pytest.mark.parametrize("with_valid_hw", [False, True])
def test_rpn_proposals_equal_jax(tied, with_valid_hw):
    cfg, jcfg = config.PRESETS["tiny_test"], jconfig.PRESETS["tiny_test"]
    rng = np.random.default_rng(4)
    scores, deltas = _rpn_maps(rng, cfg, 2, tied)
    out = rpn.flatten_rpn_outputs(
        [torch.from_numpy(s) for s in scores], [torch.from_numpy(d) for d in deltas], cfg
    )
    jout = jrpn.flatten_rpn_outputs(
        [jnp.asarray(s) for s in scores], [jnp.asarray(d) for d in deltas], jcfg
    )
    for g, w in zip(out, jout):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    vhw = np.array([[64.0, 40.0], [50.0, 64.0]], np.float32) if with_valid_hw else None
    got = rpn.rpn_proposals(
        out, (64, 64), 128, 32, 0.7, 2.0, valid_hw=None if vhw is None else torch.from_numpy(vhw)
    )
    want = jrpn.rpn_proposals(
        jout, (64, 64), 128, 32, 0.7, 2.0, valid_hw=None if vhw is None else jnp.asarray(vhw)
    )
    # the same anchors survive in the same order: scores are copies of the
    # sorted sigmoid (1e-6: two libraries' sigmoid), boxes decoded with exp
    np.testing.assert_allclose(got[1].numpy(), np.asarray(want[1]), rtol=0, atol=1e-6)
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]), rtol=0, atol=1e-4)
    assert (got[1].numpy() > -1e9).sum() > 8
