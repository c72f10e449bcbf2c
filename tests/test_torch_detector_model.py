"""The port's detector modules (`clipself_tpu_torch.detector.{layers, neck,
rpn, roi_head, fvit}`, `EvaViT.forward_taps`) against the JAX package's flax
modules with carried weights, float32 on the CPU, on the same NumPy inputs
from a seed. Every flax parameter (biases and norm scales included) is
replaced by seeded noise first, so a layout or bias mistake cannot hide
behind a zero. Modules with a convolution: 1e-4 (another summation order
over up to 9 x 64 products of order 1); without: 1e-5. The whole `predict`
keeps the same proposals and detections (indices, labels) with boxes and
scores within 1e-3.
"""

import dataclasses
import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from clipself_tpu.detector import config as jconfig
from clipself_tpu.detector import layers as jlayers
from clipself_tpu.detector import neck as jneck
from clipself_tpu.detector import roi_head as jroi_head
from clipself_tpu.detector import rpn as jrpn
from clipself_tpu.detector.fvit import FViTDetector as JDetector
from clipself_tpu.detector.fvit import backbone_taps as jbackbone_taps
from clipself_tpu.models.factory import create_model as jax_create_model
from clipself_tpu_torch.core.config import get_model_config
from clipself_tpu_torch.detector import config, fvit, layers, neck, roi_head, rpn
from clipself_tpu_torch.models.clip import CLIP
from clipself_tpu_torch.models.torch_io import (
    detector_state_dict_from_jax,
    load_weights,
    state_dict_from_jax,
)

from torch_threads import capped_threads  # noqa: F401  (module fixture)

CONV_TOL, TOL = 1e-4, 1e-5


def _noisy(params, seed):
    """The flax tree with every leaf replaced by seeded noise of a size that
    keeps activations of order 1 (kernels ~ 1/sqrt(fan_in), scales ~ 1)."""
    rng = np.random.default_rng(seed)

    def leaf(path, v):
        name = getattr(path[-1], "key", str(path[-1]))
        v = np.asarray(v)
        if name == "kernel":
            fan_in = int(np.prod(v.shape[:-1]))
            return rng.normal(scale=fan_in ** -0.5, size=v.shape).astype(np.float32)
        if name == "scale":
            return rng.uniform(0.5, 1.5, v.shape).astype(np.float32)
        if name == "temperature":
            return np.float32(37.0)
        return rng.normal(scale=0.3, size=v.shape).astype(np.float32)

    return jax.tree_util.tree_map_with_path(leaf, jax.tree.map(np.asarray, params))


def _carry(module, params):
    module.load_state_dict(detector_state_dict_from_jax(params), strict=True)
    return module.eval()


def _close(got, want, tol):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=0, atol=tol)


def _x(rng, *shape):
    return rng.normal(size=shape).astype(np.float32)


@pytest.mark.parametrize("norm,act,kernel", [("gn", True, 3), ("none", True, 3), ("gn", False, 1), ("none", False, 5)])
@pytest.mark.parametrize("hw", [(7, 7), (6, 9)])
def test_conv_norm_matches_flax(norm, act, kernel, hw):
    rng = np.random.default_rng(0)
    x = _x(rng, 2, *hw, 12)
    jmod = jlayers.ConvNorm(48, kernel=kernel, norm=norm, act=act)
    params = _noisy(jmod.init(jax.random.PRNGKey(0), jnp.asarray(x))["params"], 1)
    mod = _carry(layers.ConvNorm(12, 48, kernel=kernel, norm=norm, act=act), params)
    _close(mod(torch.from_numpy(x)), jmod.apply({"params": params}, jnp.asarray(x)), CONV_TOL)


def test_unported_norm_and_even_kernels_are_refused():
    with pytest.raises(ValueError, match="norm kind"):
        layers.make_norm("ln", 8)
    with pytest.raises(ValueError, match="odd"):
        layers.Conv2d(4, 8, kernel=2)


@pytest.mark.parametrize("norm,act", [("gn", True), ("none", False)])
def test_deconv_norm_matches_flax(norm, act):
    """Pins the spatial order of the transposed-conv kernel."""
    rng = np.random.default_rng(2)
    x = _x(rng, 2, 5, 4, 6)
    jmod = jlayers.DeconvNorm(16, norm=norm, act=act)
    params = _noisy(jmod.init(jax.random.PRNGKey(0), jnp.asarray(x))["params"], 3)
    mod = _carry(layers.DeconvNorm(6, 16, norm=norm, act=act), params)
    got = mod(torch.from_numpy(x))
    assert got.shape == (2, 10, 8, 16)
    _close(got, jmod.apply({"params": params}, jnp.asarray(x)), CONV_TOL)


def test_max_pool_matches_flax():
    x = _x(np.random.default_rng(3), 2, 7, 6, 3)
    _close(layers.max_pool_2x2(torch.from_numpy(x)), jlayers.max_pool_2x2(jnp.asarray(x)), 0)


def test_pyramid_and_fpn_match_flax():
    rng = np.random.default_rng(4)
    taps = [_x(rng, 2, 8, 8, 16) for _ in range(4)]
    jtaps = [jnp.asarray(t) for t in taps]
    jpyr = jneck.SimpleFeaturePyramid(width=16)
    p_pyr = _noisy(jpyr.init(jax.random.PRNGKey(0), jtaps)["params"], 5)
    pyr = _carry(neck.SimpleFeaturePyramid(16), p_pyr)
    got = pyr([torch.from_numpy(t) for t in taps])
    want = jpyr.apply({"params": p_pyr}, jtaps)
    assert [g.shape[1] for g in got] == [32, 16, 8, 4]
    for g, w in zip(got, want):
        _close(g, w, CONV_TOL)
    jfpn = jneck.FPN(out_channels=24, num_outs=5)
    p_fpn = _noisy(jfpn.init(jax.random.PRNGKey(0), want)["params"], 6)
    fpn = _carry(neck.FPN(16, num_ins=4, out_channels=24, num_outs=5), p_fpn)
    outs = fpn(got)
    jouts = jfpn.apply({"params": p_fpn}, want)
    assert [o.shape[1] for o in outs] == [32, 16, 8, 4, 2]
    for g, w in zip(outs, jouts):
        _close(g, w, 2 * CONV_TOL)  # two stacked convolutions and the top-down sums


def test_fpn_odd_level_subsamples_like_flax():
    rng = np.random.default_rng(5)
    ins = [_x(rng, 1, 2 * s, 2 * s, 8) for s in (4,)] + [_x(rng, 1, s, s, 8) for s in (4, 2, 1)]
    jfpn = jneck.FPN(out_channels=8, num_outs=6, norm="none")
    p = _noisy(jfpn.init(jax.random.PRNGKey(0), [jnp.asarray(t) for t in ins])["params"], 7)
    fpn = _carry(neck.FPN(8, num_ins=4, out_channels=8, num_outs=6, norm="none"), p)
    for g, w in zip(fpn([torch.from_numpy(t) for t in ins]), jfpn.apply({"params": p}, [jnp.asarray(t) for t in ins])):
        _close(g, w, CONV_TOL)


def test_rpn_head_matches_flax():
    rng = np.random.default_rng(6)
    feats = [_x(rng, 2, s, s, 16) for s in (8, 4, 2)]
    jmod = jrpn.RPNHead(num_anchors=3, feat_channels=16, num_convs=2)
    params = _noisy(jmod.init(jax.random.PRNGKey(0), [jnp.asarray(f) for f in feats])["params"], 8)
    mod = _carry(rpn.RPNHead(3, feat_channels=16, num_convs=2), params)
    got = mod([torch.from_numpy(f) for f in feats])
    want = jmod.apply({"params": params}, [jnp.asarray(f) for f in feats])
    for gs, ws in zip(got, want):
        for g, w in zip(gs, ws):
            _close(g, w, 2 * CONV_TOL)


HEAD_CFG = dict(
    fpn_channels=8, embed_dim=12, num_classes=9, roi_feat_size=7, num_shared_convs=2,
    num_shared_fcs=2, fc_out_channels=20, mask_convs=2, mask_channels=10, mask_roi_size=6,
    with_mask=True,
)


def test_bbox_head_matches_flax():
    """Pins the (y, x, channel) flattening in front of the first fc."""
    rng = np.random.default_rng(7)
    cfg = dataclasses.replace(config.PRESETS["tiny_test"], **HEAD_CFG)
    jcfg = dataclasses.replace(jconfig.PRESETS["tiny_test"], **HEAD_CFG)
    x = _x(rng, 5, 7, 7, 8)
    ce = _x(rng, 10, 12)
    ce /= np.linalg.norm(ce, axis=-1, keepdims=True)
    jmod = jroi_head.FViTBBoxHead(jcfg)
    params = _noisy(jmod.init(jax.random.PRNGKey(0), jnp.asarray(x), jnp.asarray(ce))["params"], 9)
    mod = _carry(roi_head.FViTBBoxHead(cfg), params)
    got = mod(torch.from_numpy(x), torch.from_numpy(ce))
    want = jmod.apply({"params": params}, jnp.asarray(x), jnp.asarray(ce))
    _close(got[0], want[0], 37.0 * CONV_TOL)  # logits carry the temperature, 37
    _close(got[1], want[1], 2 * CONV_TOL)
    _close(got[2], want[2], CONV_TOL)


@pytest.mark.parametrize("with_labels", [False, True])
def test_mask_head_matches_flax(with_labels):
    rng = np.random.default_rng(8)
    cfg = dataclasses.replace(config.PRESETS["tiny_test"], **HEAD_CFG)
    jcfg = dataclasses.replace(jconfig.PRESETS["tiny_test"], **HEAD_CFG)
    x = _x(rng, 4, 6, 6, 8)
    labels = np.array([0, 8, 3, 3])
    jmod = jroi_head.MaskHead(jcfg)
    params = _noisy(jmod.init(jax.random.PRNGKey(0), jnp.asarray(x))["params"], 10)
    mod = _carry(roi_head.MaskHead(cfg), params)
    args = (torch.from_numpy(labels),) if with_labels else ()
    jargs = (jnp.asarray(labels),) if with_labels else ()
    got = mod(torch.from_numpy(x), *args)
    assert got.shape == ((4, 12, 12) if with_labels else (4, 12, 12, 9))
    _close(got, jmod.apply({"params": params}, jnp.asarray(x), *jargs), 2 * CONV_TOL)
    if with_labels:  # the gather is exact: the same channel of the full map
        full = mod(torch.from_numpy(x))
        _close(got, full[torch.arange(4), :, :, torch.from_numpy(labels)].detach(), TOL)


def test_fuse_vlm_scores_matches_jax():
    rng = np.random.default_rng(9)
    cfg, jcfg = config.PRESETS["tiny_test"], jconfig.PRESETS["tiny_test"]
    logits, feats = _x(rng, 2, 6, 66) * 3, _x(rng, 2, 6, 32)
    ce = _x(rng, 66, 32)
    ce /= np.linalg.norm(ce, axis=-1, keepdims=True)
    bm = rng.uniform(size=66) < 0.7
    got = roi_head.fuse_vlm_scores(
        torch.from_numpy(logits), torch.from_numpy(feats), torch.from_numpy(ce), torch.from_numpy(bm), cfg
    )
    for i in range(2):
        want = jroi_head.fuse_vlm_scores(
            jnp.asarray(logits[i]), jnp.asarray(feats[i]), jnp.asarray(ce), jnp.asarray(bm), jcfg
        )
        _close(got[i], want, TOL)


# ---- the tower's taps and the whole predict path -------------------------


def _class_embed(rng, cfg):
    ce = rng.normal(size=(cfg.num_classes + 1, cfg.embed_dim)).astype(np.float32)
    return ce / np.linalg.norm(ce, axis=-1, keepdims=True)


@functools.lru_cache(maxsize=None)
def _whole(name):
    cfg, jcfg = config.PRESETS["tiny_test"], jconfig.PRESETS["tiny_test"]
    if name == "tiny_mask":
        extra = dict(with_mask=True, num_classes=7, mask_roi_size=6, mask_convs=1, mask_channels=16)
        cfg, jcfg = dataclasses.replace(cfg, **extra), dataclasses.replace(jcfg, **extra)
    rng = np.random.default_rng(11)
    images = rng.normal(size=(2, 64, 64, 3)).astype(np.float32)
    ce = _class_embed(rng, cfg)
    jclip, clip_params = jax_create_model(jcfg.clip_model, dtype=jnp.float32, seed=0)
    clip_params = jax.tree.map(np.asarray, clip_params)
    clip = CLIP(get_model_config(cfg.clip_model), torch.float32)
    load_weights(clip, state_dict_from_jax(clip_params))
    jtaps, jdense = jbackbone_taps(jclip, clip_params, jnp.asarray(images), jcfg, True)
    jdet = JDetector(jcfg, dtype=jnp.float32)
    rois = jnp.asarray([[[4.0, 4.0, 30.0, 30.0]], [[8.0, 8.0, 40.0, 50.0]]])
    det_params = _noisy(jdet.init(jax.random.PRNGKey(1), jtaps, rois, jnp.asarray(ce))["params"], 12)
    det = _carry(fvit.FViTDetector(cfg), det_params)
    return dict(
        cfg=cfg, jcfg=jcfg, images=images, ce=ce, clip=clip.eval(), jclip=jclip,
        clip_params=clip_params, jtaps=jtaps, jdense=jdense, jdet=jdet, det_params=det_params,
        det=det,
    )


@pytest.fixture(scope="module")
def whole():
    return _whole("tiny_test")


def test_forward_taps_match_jax(whole):
    w = whole
    taps, dense = fvit.backbone_taps(w["clip"], torch.from_numpy(w["images"]), w["cfg"], True)
    assert len(taps) == 4 and taps[0].shape == (2, 8, 8, 64) and dense.shape == (2, 8, 8, 32)
    for g, want in zip(taps, w["jtaps"]):
        _close(g, want, CONV_TOL)
    _close(dense, w["jdense"], TOL)
    assert not dense.requires_grad
    none_taps, none_dense = w["clip"].visual_taps(torch.from_numpy(w["images"]), (1, 3), False)
    assert len(none_taps) == 2 and none_dense is None
    _close(none_taps[1], w["jtaps"][3], CONV_TOL)


def test_detector_forward_and_features_match_jax(whole):
    w = whole
    taps = [torch.from_numpy(np.array(t)) for t in w["jtaps"]]
    rois = np.array([[[4.0, 4.0, 30.0, 30.0], [0.0, 0.0, 64.0, 64.0]], [[8.0, 8.0, 40.0, 50.0], [30.0, 2.0, 36.0, 9.0]]], np.float32)
    with torch.no_grad():
        got = w["det"](taps, torch.from_numpy(rois), torch.from_numpy(w["ce"]))
        feats, smap, dmap = w["det"].features(taps)
    want = w["jdet"].apply({"params": w["det_params"]}, w["jtaps"], jnp.asarray(rois), jnp.asarray(w["ce"]))
    _close(got[0], want[0], 37.0 * 3 * CONV_TOL)
    _close(got[1], want[1], 3 * CONV_TOL)
    jfeats, jsmap, jdmap = w["jdet"].apply({"params": w["det_params"]}, w["jtaps"], method="features")
    for g, x in zip(feats + smap + dmap, list(jfeats) + list(jsmap) + list(jdmap)):
        _close(g, x, 3 * CONV_TOL)


@pytest.mark.parametrize("name,fusion,with_valid_hw", [
    ("tiny_test", True, True), ("tiny_test", False, False), ("tiny_mask", True, False),
])
def test_predict_matches_jax(name, fusion, with_valid_hw):
    w = _whole(name)
    cfg = w["cfg"]
    rng = np.random.default_rng(13)
    bm = rng.uniform(size=cfg.num_classes + 1) < 0.7
    vhw = np.array([[64.0, 48.0], [40.0, 64.0]], np.float32) if with_valid_hw else None
    taps = [torch.from_numpy(np.array(t)) for t in w["jtaps"]]
    dense = torch.from_numpy(np.array(w["jdense"])) if fusion else None
    with torch.inference_mode():
        _, props, pscores = w["det"].proposals(taps, None, None if vhw is None else torch.from_numpy(vhw))
        got = w["det"].predict(
            taps, dense, torch.from_numpy(w["ce"]), torch.from_numpy(bm), None,
            None if vhw is None else torch.from_numpy(vhw),
        )
    want = w["jdet"].apply(
        {"params": w["det_params"]}, w["jtaps"], w["jdense"] if fusion else None,
        jnp.asarray(w["ce"]), jnp.asarray(bm), None, None if vhw is None else jnp.asarray(vhw),
        method="predict",
    )
    assert len(got) == len(want) == (4 if cfg.with_mask else 3)
    boxes, scores, labels = (np.asarray(x) for x in want[:3])
    assert (scores > 0).sum() >= 4, "the case must produce detections"
    np.testing.assert_array_equal(got[2].numpy(), labels)
    np.testing.assert_allclose(got[1].numpy(), scores, rtol=0, atol=1e-3)
    np.testing.assert_allclose(got[0].numpy(), boxes, rtol=0, atol=1e-3)
    if cfg.with_mask:
        assert got[3].shape == (2, cfg.rcnn_test.max_per_img, 12, 12)
        np.testing.assert_allclose(got[3].numpy(), np.asarray(want[3]), rtol=0, atol=1e-3)
    assert props.shape == (2, 32, 4) and pscores.shape == (2, 32)


def test_proposals_match_jax(whole):
    w = whole
    taps = [torch.from_numpy(np.array(t)) for t in w["jtaps"]]
    with torch.inference_mode():
        _, props, pscores = w["det"].proposals(taps)
    _, smap, dmap = w["jdet"].apply({"params": w["det_params"]}, w["jtaps"], method="features")
    p = w["jcfg"].test_proposals
    jprops, jscores = jrpn.rpn_proposals(
        jrpn.flatten_rpn_outputs(smap, dmap, w["jcfg"]), (64, 64), p.nms_pre, p.max_per_img,
        p.iou_threshold, p.min_bbox_size,
    )
    assert (np.asarray(jscores) > -1e9).sum() >= 8
    np.testing.assert_allclose(pscores.numpy(), np.asarray(jscores), rtol=0, atol=1e-3)
    np.testing.assert_allclose(props.numpy(), np.asarray(jprops), rtol=0, atol=1e-3)


def test_init_weights_distributions():
    cfg = dataclasses.replace(config.PRESETS["tiny_test"], with_mask=True)
    det = fvit.create_detector(cfg, device="cpu", seed=3)
    again = fvit.create_detector(cfg, device="cpu", seed=3)
    other = fvit.create_detector(cfg, device="cpu", seed=4)
    sd, sd2, sd3 = det.state_dict(), again.state_dict(), other.state_dict()
    assert all(torch.equal(sd[k], sd2[k]) for k in sd)
    assert not torch.equal(sd["rpn.cls.weight"], sd3["rpn.cls.weight"])
    assert float(sd["bbox_head.temperature"]) == cfg.learned_temperature
    for name, p in sd.items():
        if name.endswith(".bias"):
            assert not p.any(), name
        elif ".norm" in name or "lateral_norm" in name:
            assert (p == 1).all(), name
    # lecun normal: variance 1 / fan_in (3 x 3 x 32 for an fpn output conv;
    # in x 2 x 2 for a transposed conv), a normal cut at two sigma
    for name, fan_in in (("fpn.fpn_conv_0.conv.weight", 9 * 32), ("pyramid.up2.deconv.weight", 4 * 64),
                         ("bbox_head.shared_fc_0.weight", 7 * 7 * 32)):
        wt = sd[name]
        assert abs(float(wt.std()) * fan_in ** 0.5 - 1.0) < 0.05, name
        assert float(wt.abs().max()) <= 2.0 / 0.8796 * fan_in ** -0.5 + 1e-6
    assert not det.training
