"""The detector at the L/14 presets' geometry, cut to a tiny size, against
the JAX package on the CPU in float32: the Tiny-Det tower with 14-pixel
patches at 112^2 (an 8 x 8 grid, as 896 / 14 = 64), four taps, anchor
strides (3.5, 7, 14, 28, 56) as `ov_coco_vitl14` / `ov_lvis_vitl14` have
them (a 32 x 32 finest level, as 256 x 256 there). Both towers are built
through their package's `create_model` from a `CLIPConfig`; every flax
parameter of the detector is replaced by seeded noise first and carried
over. `predict` (with and without the mask head) keeps the same detections
with boxes and scores within 1e-3, and the whole `FViTDetector.loss` agrees
in loss, metrics (1e-4 relative) and trainable gradients (1e-4 of a
tensor's largest entry): the tolerances of `test_torch_detector_model.py`
and `test_torch_detector_train.py`. This is the CPU's only check of the
fractional stride-3.5 anchors and the 14-pixel patch geometry through the
whole detector.
"""

import dataclasses
import functools
import math

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from clipself_tpu.core.config import get_model_config as jget_model_config
from clipself_tpu.detector import config as jconfig
from clipself_tpu.detector.fvit import FViTDetector as JDetector
from clipself_tpu.detector.fvit import backbone_taps as jbackbone_taps
from clipself_tpu.models.factory import create_model as jax_create_model
from clipself_tpu_torch.core.config import get_model_config
from clipself_tpu_torch.detector import classes, config, fvit, rpn
from clipself_tpu_torch.models.factory import create_model
from clipself_tpu_torch.models.torch_io import (
    detector_state_dict_from_jax,
    load_weights,
    state_dict_from_jax,
)
from test_torch_detector_model import CONV_TOL, _noisy
from test_torch_detector_train import GRAD_REL, LOSS_REL, MASK_CFG, _gt, _loss_noise

from torch_threads import capped_threads  # noqa: F401  (module fixture)

SIDE, PATCH = 112, 14
STRIDES = (3.5, 7, 14, 28, 56)


def _tower(get):
    c = get("EVA02-CLIP-Tiny-Det-Test")
    return dataclasses.replace(c, vision=dataclasses.replace(c.vision, patch_size=PATCH, image_size=SIDE))


def _det_cfg(pkg, with_mask):
    extra = dict(patch_size=PATCH, image_size=SIDE, anchors=pkg.AnchorCfg(strides=STRIDES))
    if with_mask:
        extra.update(MASK_CFG)
    return dataclasses.replace(pkg.PRESETS["tiny_test"], **extra)


def _t(x):
    return torch.from_numpy(np.array(x))


@functools.lru_cache(maxsize=None)
def _towers():
    """Both towers on the same weights, and the JAX taps of two images."""
    rng = np.random.default_rng(41)
    images = rng.normal(size=(2, SIDE, SIDE, 3)).astype(np.float32)
    jclip, clip_params = jax_create_model(_tower(jget_model_config), dtype=jnp.float32, seed=0)
    clip_params = jax.tree.map(np.asarray, clip_params)
    clip = create_model(_tower(get_model_config), device="cpu", dtype=torch.float32, seed=0)
    load_weights(clip, state_dict_from_jax(clip_params))
    jtaps, jdense = jbackbone_taps(jclip, clip_params, jnp.asarray(images), _det_cfg(jconfig, False), True)
    return dict(images=images, clip=clip, jtaps=jtaps, jdense=jdense)


@functools.lru_cache(maxsize=None)
def _case(with_mask):
    cfg, jcfg = _det_cfg(config, with_mask), _det_cfg(jconfig, with_mask)
    tw = _towers()
    rng = np.random.default_rng(42)
    ce = rng.normal(size=(cfg.num_classes + 1, cfg.embed_dim)).astype(np.float32)
    ce /= np.linalg.norm(ce, axis=-1, keepdims=True)
    jdet = JDetector(jcfg, dtype=jnp.float32)
    rois = jnp.asarray([[[4.0, 4.0, 60.0, 60.0]], [[8.0, 8.0, 80.0, 100.0]]])
    params = _noisy(jdet.init(jax.random.PRNGKey(1), tw["jtaps"], rois, jnp.asarray(ce))["params"], 42)
    params["rpn"]["cls"]["bias"] = rng.normal(size=3).astype(np.float32)
    det = fvit.FViTDetector(cfg)
    det.load_state_dict(detector_state_dict_from_jax(params), strict=True)
    return dict(tw, cfg=cfg, jcfg=jcfg, ce=ce, jdet=jdet, params=params, det=det.eval())


def test_patch14_taps_and_anchors_match_jax():
    c = _case(False)
    taps, dense = fvit.backbone_taps(c["clip"], _t(c["images"]), c["cfg"], True)
    assert [tuple(t.shape) for t in taps] == [(2, 8, 8, 64)] * 4 and dense.shape == (2, 8, 8, 32)
    for got, want in zip(taps, c["jtaps"]):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=CONV_TOL)
    np.testing.assert_allclose(dense.numpy(), np.asarray(c["jdense"]), rtol=0, atol=1e-5)
    with torch.no_grad():
        _, smap, dmap = c["det"].features([_t(t) for t in c["jtaps"]])
    assert [s.shape[1] for s in smap] == [32, 16, 8, 4, 2]
    flat = rpn.flatten_rpn_outputs(smap, dmap, c["cfg"])
    assert flat.anchors.shape == (rpn.num_anchors(c["cfg"]), 4) == (3 * 1364, 4)
    # the finest level's anchor centres step by 3.5 pixels (center_offset 0)
    cx = np.unique(np.round(flat.anchors[: 3 * 32 * 32, [0, 2]].mean(-1).numpy(), 3))
    np.testing.assert_allclose(cx, 3.5 * np.arange(32), rtol=0, atol=1e-4)


@pytest.mark.parametrize("with_mask", [False, True], ids=["boxes", "masks"])
def test_patch14_predict_matches_jax(with_mask):
    c = _case(with_mask)
    cfg = c["cfg"]
    bm = classes.base_novel_mask("coco")
    vhw = np.array([[112.0, 84.0], [70.0, 112.0]], np.float32)
    taps = [_t(t) for t in c["jtaps"]]
    with torch.inference_mode():
        got = c["det"].predict(taps, _t(c["jdense"]), _t(c["ce"]), _t(bm), None, _t(vhw))
    want = c["jdet"].apply(
        {"params": c["params"]}, c["jtaps"], c["jdense"], jnp.asarray(c["ce"]), jnp.asarray(bm),
        None, jnp.asarray(vhw), method="predict",
    )
    assert len(got) == len(want) == (4 if with_mask else 3)
    boxes, scores, labels = (np.asarray(x) for x in want[:3])
    assert (scores > 0).sum() >= 4, "the case must produce detections"
    np.testing.assert_array_equal(got[2].numpy(), labels)
    np.testing.assert_allclose(got[1].numpy(), scores, rtol=0, atol=1e-3)
    np.testing.assert_allclose(got[0].numpy(), boxes, rtol=0, atol=1e-3)
    assert (got[0][..., 2].numpy() <= vhw[:, None, 1] + 1e-4).all()
    if with_mask:
        assert got[3].shape == (2, cfg.rcnn_test.max_per_img, 12, 12)
        np.testing.assert_allclose(got[3].numpy(), np.asarray(want[3]), rtol=0, atol=1e-3)


@pytest.mark.parametrize("with_mask", [False, True], ids=["boxes", "masks"])
def test_patch14_loss_and_gradients_match_jax(with_mask):
    c = _case(with_mask)
    cfg, jcfg = c["cfg"], c["jcfg"]
    rng = np.random.default_rng(43)
    gts, labels, valid = _gt(rng, 2, jcfg.max_gt, size=float(SIDE))
    cw = classes.class_weights("coco", jcfg.bg_weight)
    ms = SIDE // 4
    masks = (rng.uniform(size=(2, jcfg.max_gt, ms, ms)) < 0.3).astype(np.uint8) if with_mask else None
    key = jax.random.PRNGKey(17)

    def loss_fn(p):
        return c["jdet"].apply(
            {"params": p}, c["jtaps"], jnp.asarray(gts), jnp.asarray(labels), jnp.asarray(valid), key,
            jnp.asarray(c["ce"]), jnp.asarray(cw), None if masks is None else jnp.asarray(masks),
            method="loss",
        )

    # op by op, not under one `jax.jit`: XLA's fusion of the whole loss on
    # the CPU computes the RPN conv's weight gradient ~1.7e-3 (relative) off
    # the op-by-op value at this geometry, while the op-by-op value and the
    # JAX gradient of the RPN loss alone agree with the port to ~5e-7
    (jloss, jmetrics), jgrads = jax.value_and_grad(loss_fn, has_aux=True)(c["params"])
    want_grads = detector_state_dict_from_jax(jax.tree.map(np.asarray, jgrads))
    det = fvit.FViTDetector(cfg)
    det.load_state_dict(detector_state_dict_from_jax(c["params"]), strict=True)
    noise = _loss_noise(key, 2, rpn.num_anchors(cfg), cfg.train_proposals.max_per_img + cfg.max_gt)
    loss, metrics = det.loss(
        [_t(t) for t in c["jtaps"]], _t(gts), _t(labels), _t(valid), noise, _t(c["ce"]), _t(cw),
        None if masks is None else _t(masks),
    )
    loss.backward()
    assert metrics.keys() == jmetrics.keys() and ("loss_mask" in metrics) == with_mask
    for k, w in jmetrics.items():
        g, w = metrics[k].item(), float(w)
        assert math.isfinite(g) and abs(g - w) <= LOSS_REL * abs(w), (k, g, w)
    assert abs(loss.item() - float(jloss)) <= LOSS_REL * abs(float(jloss))
    assert metrics["num_pos_roi"] > 0 and metrics["rpn_num_pos"] > 0
    for name, p in det.named_parameters():
        want = want_grads[name]
        scale = float(want.abs().max())
        weight = want_grads.get(name[: -len("bias")] + "weight")
        if name.endswith(".bias") and weight is not None:
            scale = max(scale, float(weight.abs().max()))  # see test_torch_detector_train.py
        assert p.grad is not None and scale > 0, name
        err = float((p.grad - want).abs().max())
        assert err <= GRAD_REL * scale, (name, err, scale)
