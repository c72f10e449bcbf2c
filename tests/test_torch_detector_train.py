"""The port's detector training path (`clipself_tpu_torch.detector.{targets,
rpn, roi_head, fvit, train}`, `models/torch_io.py::detector_state_dict_to_jax`)
against the JAX package's, float32 on the CPU, preset `tiny_test`.

The samplers' noise is drawn in JAX from the JAX code's own key splits
(`fvit.py:121`, `rpn.py:131`, `targets.py:93-110`, `roi_head.py:229-251`)
and handed to the port, so both sides rank the same draws. Discrete
results (assignments, sample masks and counts, sampled rois, labels, gt
indices, the learning rate) must be EQUAL. The losses on fixed inputs
(the RPN, the RCNN) and their gradients: 1e-5, as the other convolution-free
detector tests. The whole loss (features, proposals, sampling, heads) on
the same taps: the loss and every metric within 1e-4 relative, every
trainable gradient within 1e-4 of its tensor's largest entry (the
convolution tolerance of `test_torch_detector_model.py`). One AdamW step:
parameters within 1e-6 of optax's (relative, for a tensor of magnitude
above 1).
"""

import dataclasses
import functools
import math
import pickle

import numpy as np
import pytest
import torch
import torch.nn.functional as F

import jax
import jax.numpy as jnp
import optax

from clipself_tpu.detector import config as jconfig
from clipself_tpu.detector import roi_head as jroi_head
from clipself_tpu.detector import rpn as jrpn
from clipself_tpu.detector import targets as jtargets
from clipself_tpu.detector import train as jtrain
from clipself_tpu.detector.evaluate import load_detector as jload_detector
from clipself_tpu.detector.fvit import FViTDetector as JDetector
from clipself_tpu.detector.fvit import backbone_taps as jbackbone_taps
from clipself_tpu.models.factory import create_model as jax_create_model
from clipself_tpu_torch.detector import classes, config, fvit, roi_head, rpn, targets, train
from clipself_tpu_torch.detector.evaluate import load_detector
from clipself_tpu_torch.models.torch_io import detector_state_dict_from_jax, detector_state_dict_to_jax
from test_torch_detector_model import _noisy

from torch_threads import capped_threads  # noqa: F401  (module fixture)

TOL, LOSS_REL, GRAD_REL, OPT_TOL = 1e-5, 1e-4, 1e-4, 1e-6
MASK_CFG = dict(with_mask=True, mask_convs=1, mask_channels=16, mask_roi_size=6)


def _cfgs(with_mask=False):
    cfg, jcfg = config.PRESETS["tiny_test"], jconfig.PRESETS["tiny_test"]
    if with_mask:
        cfg, jcfg = dataclasses.replace(cfg, **MASK_CFG), dataclasses.replace(jcfg, **MASK_CFG)
    return cfg, jcfg


def _t(x, dtype=None):
    return torch.from_numpy(np.array(x) if dtype is None else np.array(x, dtype))


def _close(got, want, tol):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=0, atol=tol)


def _gt(rng, b, g, size=64.0, valid_frac=0.7):
    xy = rng.uniform(0, size * 0.6, size=(b, g, 2)).astype(np.float32)
    wh = rng.uniform(8, size * 0.45, size=(b, g, 2)).astype(np.float32)
    boxes = np.concatenate([xy, np.clip(xy + wh, None, size)], -1)
    labels = rng.integers(0, 65, size=(b, g)).astype(np.int32)
    return boxes, labels, rng.uniform(size=(b, g)) < valid_frac


# ---- the JAX code's noise, drawn from its own key splits -----------------


def _rpn_noise(key, b, n):
    """`rpn_loss`: one key an image, split into the sampler's pos and neg."""
    pos, neg = [], []
    for k in jax.random.split(key, b):
        kpos, kneg = jax.random.split(k)
        pos.append(jax.random.uniform(kpos, (n,)))
        neg.append(jax.random.uniform(kneg, (n,)))
    return _t(np.stack(pos)), _t(np.stack(neg))


def _roi_noise(key, b, n):
    """`sample_rois`: one key an image, split into the sampler's key (pos,
    neg) and the gather's."""
    pos, neg, gather = [], [], []
    for k in jax.random.split(key, b):
        ksample, kgather = jax.random.split(k)
        kpos, kneg = jax.random.split(ksample)
        pos.append(jax.random.uniform(kpos, (n,)))
        neg.append(jax.random.uniform(kneg, (n,)))
        gather.append(jax.random.uniform(kgather, (n,)))
    return _t(np.stack(pos)), _t(np.stack(neg)), _t(np.stack(gather))


def _loss_noise(key, b, anchors, rois):
    """`FViTDetector.loss`: the key split three ways (rpn, proposals, rois)."""
    k_rpn, _, k_roi = jax.random.split(key, 3)
    return targets.SampleNoise(*_rpn_noise(k_rpn, b, anchors), *_roi_noise(k_roi, b, rois))


# ---- assignment and sampling ---------------------------------------------


def _assign_case(kind):
    """(boxes [B, N, 4], gts [B, G, 4], valid [B, G]) on an integer grid, so
    that many IoUs tie exactly."""
    rng = np.random.default_rng(1)
    lo = rng.integers(0, 40, size=(2, 60, 2)).astype(np.float32)
    boxes = np.concatenate([lo, lo + rng.integers(4, 24, size=(2, 60, 2))], -1).astype(np.float32)
    boxes[:, 30:40] = boxes[:, 20:30]  # duplicate anchors tie for each gt's best
    gts = boxes[:, [3, 7, 11, 11, 25, 50]] + rng.integers(-2, 3, size=(2, 6, 4)).astype(np.float32)
    valid = np.ones((2, 6), bool)
    if kind == "duplicate_gts":
        gts[:, 3] = gts[:, 2]  # the later of two equal gts claims their anchors
        gts[:, 5] = gts[:, 1]
        valid[1, 4] = False
    elif kind == "no_valid_gt":
        valid[1] = False
    return boxes, gts, valid


@pytest.mark.parametrize("kind", ["ties", "duplicate_gts", "no_valid_gt"])
@pytest.mark.parametrize("low_quality", [True, False])
def test_assign_max_iou_equals_jax(kind, low_quality):
    boxes, gts, valid = _assign_case(kind)
    thr = (0.8, 0.3, 0.2, low_quality)
    got = targets.assign_max_iou(_t(boxes), _t(gts), _t(valid), *thr)
    for i in range(2):
        want = jtargets.assign_max_iou(jnp.asarray(boxes[i]), jnp.asarray(gts[i]), jnp.asarray(valid[i]), *thr)
        for name in ("gt_idx", "max_iou", "pos", "neg"):
            np.testing.assert_array_equal(getattr(got, name)[i].numpy(), np.asarray(getattr(want, name)), name)
    if kind == "no_valid_gt":  # every anchor of the image without gts is negative
        assert got.neg[1].all() and not got.pos[1].any()
    if low_quality and kind == "ties":
        assert got.pos.sum() > (got.max_iou >= 0.8).sum()  # claims added positives
    # shared anchors [N, 4] broadcast against the batch's gts
    shared = targets.assign_max_iou(_t(boxes[0]), _t(gts), _t(valid), *thr)
    want0 = jtargets.assign_max_iou(jnp.asarray(boxes[0]), jnp.asarray(gts[1]), jnp.asarray(valid[1]), *thr)
    np.testing.assert_array_equal(shared.gt_idx[1].numpy(), np.asarray(want0.gt_idx))


@pytest.mark.parametrize("levels", [8, 64, 1 << 24], ids=["8_levels", "64_levels", "continuous"])
@pytest.mark.parametrize("num,frac", [(32, 0.5), (16, 0.25), (200, 0.5)])
def test_random_sample_equals_jax(monkeypatch, levels, num, frac):
    """Noise quantized to a few levels collides often: the masks must keep
    the same entries (ties broken by index) and exactly min(count, cap)."""
    rng = np.random.default_rng(2)
    n = 150
    pos = rng.uniform(size=(2, n)) < 0.3
    neg = ~pos & (rng.uniform(size=(2, n)) < 0.8)
    pos[1, :] = False  # an image without positives: negatives fill the budget
    noise = np.floor(rng.uniform(size=(2, 2, n)) * levels).astype(np.float32) / levels
    a = targets.Assignment(_t(np.zeros((2, n), np.int64)), _t(np.zeros((2, n), np.float32)), _t(pos), _t(neg))
    got = targets.random_sample(a, num, frac, _t(noise[:, 0]), _t(noise[:, 1]))
    for i in range(2):
        draws = [jnp.asarray(noise[i, 0]), jnp.asarray(noise[i, 1])]
        monkeypatch.setattr(jax.random, "uniform", lambda key, shape: draws.pop(0))
        ja = jtargets.Assignment(
            jnp.zeros(n, jnp.int32), jnp.zeros(n), jnp.asarray(pos[i]), jnp.asarray(neg[i])
        )
        want = jtargets.random_sample(jax.random.PRNGKey(0), ja, num, frac)
        monkeypatch.undo()
        assert not draws
        for name in ("pos_mask", "neg_mask", "num_pos", "num_neg"):
            np.testing.assert_array_equal(getattr(got, name)[i].numpy(), np.asarray(getattr(want, name)), name)
    assert (got.pos_mask.sum(-1) == got.num_pos).all() and (got.neg_mask.sum(-1) == got.num_neg).all()
    assert (got.num_pos <= int(num * frac)).all() and (got.num_pos + got.num_neg <= num).all()


@pytest.mark.parametrize("add_gt", [True, False])
def test_sample_rois_equals_jax(add_gt):
    cfg, jcfg = _cfgs()
    sample = dataclasses.replace(cfg.rcnn_sample, add_gt_as_proposals=add_gt)
    cfg = dataclasses.replace(cfg, rcnn_sample=sample)
    jcfg = dataclasses.replace(jcfg, rcnn_sample=dataclasses.replace(jcfg.rcnn_sample, add_gt_as_proposals=add_gt))
    rng = np.random.default_rng(3)
    b, p, g = 2, 32, jcfg.max_gt
    gts, labels, valid = _gt(rng, b, g)
    # proposals near the gts (so that some are positive) and spread ones,
    # with empty slots (score NEG_INF) at the end
    near = gts[:, rng.integers(0, g, p // 2)] + rng.normal(scale=3.0, size=(b, p // 2, 4)).astype(np.float32)
    spread, _, _ = _gt(rng, b, p - p // 2)
    props = np.clip(np.concatenate([near, spread], 1), 0, 64).astype(np.float32)
    scores = rng.uniform(size=(b, p)).astype(np.float32)
    scores[:, -5:] = -1e10
    key = jax.random.PRNGKey(4)
    got = roi_head.sample_rois(
        _t(props), _t(scores), _t(gts), _t(labels), _t(valid), *_roi_noise(key, b, p + g), cfg
    )
    want = jroi_head.sample_rois(
        jnp.asarray(props), jnp.asarray(scores), jnp.asarray(gts), jnp.asarray(labels), jnp.asarray(valid),
        key, jcfg,
    )
    for name in ("rois", "labels", "chosen", "pos", "gt_idx"):
        np.testing.assert_array_equal(getattr(got, name).numpy(), np.asarray(getattr(want, name)), name)
    _close(got.reg_targets, want.reg_targets, TOL)
    assert got.pos.any() and (got.chosen & ~got.pos).any()
    assert got.rois.shape == (b, cfg.rcnn_sample.num, 4)


@pytest.mark.parametrize("step", [0, 1, 125, 249, 250, 1000])
def test_det_lr_schedule_equals_jax(step):
    got = np.float32(train.det_lr_schedule(1e-4)(step))
    want = np.asarray(jtrain.det_lr_schedule(1e-4)(step))
    assert want.dtype == np.float32 and got == want


# ---- the losses on fixed inputs ------------------------------------------


@pytest.mark.parametrize("labels", ["binary", "soft"])
def test_bce_equals_optax(labels):
    """The RPN and mask losses use `F.binary_cross_entropy_with_logits`
    where the JAX code uses optax's: equal within 2 float32 ULPs of
    max(|logit|, 1), the magnitude at which their terms round (measured: 2
    for binary labels, 4 for soft ones)."""
    rng = np.random.default_rng(5)
    x = (rng.normal(size=20000) * rng.choice([1.0, 6.0, 30.0], 20000)).astype(np.float32)
    y = rng.uniform(size=20000).astype(np.float32)
    if labels == "binary":
        y = (y < 0.5).astype(np.float32)
    got = F.binary_cross_entropy_with_logits(_t(x), _t(y), reduction="none").numpy()
    want = np.asarray(optax.sigmoid_binary_cross_entropy(jnp.asarray(x), jnp.asarray(y)))
    ulps = np.abs(got - want) / np.spacing(np.maximum(np.abs(x), 1.0))
    assert ulps.max() <= (2.0 if labels == "binary" else 4.0)


def _rpn_inputs(rng, cfg):
    """Random level maps [B, h, w, A(*4)] of the tiny pyramid, and gts with
    one image without a valid gt."""
    sides = (32, 16, 8, 4, 2)
    smaps = [rng.normal(size=(2, s, s, 3)).astype(np.float32) * 2 for s in sides]
    dmaps = [rng.normal(scale=0.3, size=(2, s, s, 12)).astype(np.float32) for s in sides]
    gts, _, valid = _gt(rng, 2, 5)
    gts[0, 4] = gts[0, 1]  # a duplicate gt
    valid[0] = True
    valid[1] = False
    return smaps, dmaps, gts, valid


def test_rpn_loss_and_gradients_match_jax():
    cfg, jcfg = _cfgs()
    smaps, dmaps, gts, valid = _rpn_inputs(np.random.default_rng(6), cfg)
    key = jax.random.PRNGKey(8)

    def jloss(sm, dm):
        out = jrpn.flatten_rpn_outputs(sm, dm, jcfg)
        return jrpn.rpn_loss(out, jnp.asarray(gts), jnp.asarray(valid), key, jcfg)

    (want, wmetrics), (gs, gd) = jax.value_and_grad(jloss, argnums=(0, 1), has_aux=True)(
        [jnp.asarray(s) for s in smaps], [jnp.asarray(d) for d in dmaps]
    )
    sm = [_t(s).requires_grad_() for s in smaps]
    dm = [_t(d).requires_grad_() for d in dmaps]
    out = rpn.flatten_rpn_outputs(sm, dm, cfg)
    assert out.scores.shape[1] == rpn.num_anchors(cfg)
    got, metrics = rpn.rpn_loss(out, _t(gts), _t(valid), *_rpn_noise(key, 2, out.scores.shape[1]), cfg)
    got.backward()
    _close(got, want, TOL)
    assert metrics.keys() == wmetrics.keys()
    for k in metrics:
        _close(metrics[k], wmetrics[k], TOL)
    assert float(metrics["rpn_num_pos"]) > 0
    for t, w in zip(sm + dm, list(gs) + list(gd)):
        _close(t.grad, w, TOL)


@pytest.mark.parametrize("weighted", [False, True])
def test_rcnn_cls_loss_matches_jax(weighted):
    """With the COCO class weights the novel classes weigh 0: their logits
    are -inf and their rows' CE an inf * 0 that `where` drops; the loss and
    every gradient stay finite."""
    rng = np.random.default_rng(9)
    logits = (rng.normal(size=(40, 66)) * 3).astype(np.float32)
    labels = rng.integers(0, 66, size=40)
    w = classes.class_weights("coco", 0.6)
    labels[:4] = np.flatnonzero(w == 0)[:4]  # novel labels present
    chosen = rng.uniform(size=40) < 0.8
    cw = w if weighted else None

    def jloss(lg):
        return jroi_head.rcnn_cls_loss(lg, jnp.asarray(labels), jnp.asarray(chosen), None if cw is None else jnp.asarray(cw))

    want, wgrad = jax.value_and_grad(jloss)(jnp.asarray(logits))
    lg = _t(logits).requires_grad_()
    got = roi_head.rcnn_cls_loss(lg, _t(labels), _t(chosen), None if cw is None else _t(cw))
    got.backward()
    assert math.isfinite(got.item()) and torch.isfinite(lg.grad).all()
    _close(got, want, TOL)
    _close(lg.grad, wgrad, TOL)


def test_rcnn_reg_loss_matches_jax():
    rng = np.random.default_rng(10)
    deltas, tgt = (rng.normal(size=(2, 40, 4)).astype(np.float32) for _ in range(2))
    pos = rng.uniform(size=40) < 0.3
    chosen = pos | (rng.uniform(size=40) < 0.5)
    want, wgrad = jax.value_and_grad(jroi_head.rcnn_reg_loss)(
        jnp.asarray(deltas[0]), jnp.asarray(tgt[0]), jnp.asarray(pos), jnp.asarray(chosen)
    )
    d = _t(deltas[0]).requires_grad_()
    got = roi_head.rcnn_reg_loss(d, _t(tgt[0]), _t(pos), _t(chosen))
    got.backward()
    _close(got, want, TOL)
    _close(d.grad, wgrad, TOL)


# ---- the whole loss --------------------------------------------------------


def _class_embed(rng, cfg):
    ce = rng.normal(size=(cfg.num_classes + 1, cfg.embed_dim)).astype(np.float32)
    return ce / np.linalg.norm(ce, axis=-1, keepdims=True)


@functools.lru_cache(maxsize=None)
def _loss_case(with_mask):
    """One jitted JAX loss and its gradient on noisy weights and the tiny
    trunk's taps, and the port's detector carrying the same weights."""
    cfg, jcfg = _cfgs(with_mask)
    rng = np.random.default_rng(11)
    images = rng.normal(size=(2, 64, 64, 3)).astype(np.float32)
    jclip, clip_params = jax_create_model(jcfg.clip_model, dtype=jnp.float32, seed=0)
    jtaps, _ = jbackbone_taps(jclip, clip_params, jnp.asarray(images), jcfg, False)
    ce = _class_embed(rng, cfg)
    jdet = JDetector(jcfg, dtype=jnp.float32)
    rois = jnp.asarray([[[4.0, 4.0, 30.0, 30.0]], [[8.0, 8.0, 40.0, 50.0]]])
    params = _noisy(jdet.init(jax.random.PRNGKey(1), jtaps, rois, jnp.asarray(ce))["params"], 12)
    gts, labels, valid = _gt(rng, 2, jcfg.max_gt)
    cw = classes.class_weights("coco", jcfg.bg_weight)
    masks = (rng.uniform(size=(2, jcfg.max_gt, 16, 16)) < 0.3).astype(np.uint8) if with_mask else None
    key = jax.random.PRNGKey(13)

    def loss_fn(p):
        return jdet.apply(
            {"params": p}, jtaps, jnp.asarray(gts), jnp.asarray(labels), jnp.asarray(valid), key,
            jnp.asarray(ce), jnp.asarray(cw), None if masks is None else jnp.asarray(masks),
            method="loss",
        )

    (loss, metrics), grads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(params)
    det = fvit.FViTDetector(cfg)
    det.load_state_dict(detector_state_dict_from_jax(params), strict=True)
    noise = _loss_noise(key, 2, rpn.num_anchors(cfg), cfg.train_proposals.max_per_img + cfg.max_gt)
    return dict(
        cfg=cfg, det=det, taps=[_t(t) for t in jtaps], gts=gts, labels=labels, valid=valid,
        ce=ce, cw=cw, masks=masks, noise=noise, loss=float(loss),
        metrics={k: float(v) for k, v in metrics.items()},
        grads=detector_state_dict_from_jax(jax.tree.map(np.asarray, grads)),
    )


@pytest.mark.parametrize("with_mask", [False, True], ids=["boxes", "masks"])
def test_detector_loss_and_gradients_match_jax(with_mask):
    c = _loss_case(with_mask)
    det = c["det"]
    det.zero_grad(set_to_none=True)
    loss, metrics = det.loss(
        c["taps"], _t(c["gts"]), _t(c["labels"]), _t(c["valid"]), c["noise"], _t(c["ce"]), _t(c["cw"]),
        None if c["masks"] is None else _t(c["masks"]),
    )
    loss.backward()
    assert metrics.keys() == c["metrics"].keys()
    assert ("loss_mask" in metrics) == with_mask
    for k, want in c["metrics"].items():
        got = metrics[k].item()
        assert math.isfinite(got) and abs(got - want) <= LOSS_REL * abs(want), (k, got, want)
    assert abs(loss.item() - c["loss"]) <= LOSS_REL * abs(c["loss"])
    assert metrics["num_pos_roi"] > 0 and metrics["rpn_num_pos"] > 0
    grads = {n: p.grad for n, p in det.named_parameters()}
    assert grads.keys() == c["grads"].keys()
    for name, want in c["grads"].items():
        got = grads[name]
        assert got is not None and torch.isfinite(got).all(), name
        scale = float(want.abs().max())
        assert scale > 0, name  # every parameter reaches the loss
        weight = c["grads"].get(name[: -len("bias")] + "weight")
        if name.endswith(".bias") and weight is not None:
            # a bias in front of a 1x1 conv and a GroupNorm of one channel a
            # group (the pyramid's up4_b and up2 into the tiny FPN's laterals)
            # has a zero gradient in exact arithmetic, since the norm removes
            # any per-channel constant: both sides return rounding noise of
            # ~2e-7 there, so a bias is held to its layer's largest entry
            scale = max(scale, float(weight.abs().max()))
        err = float((got - want).abs().max())
        assert err <= GRAD_REL * scale, (name, err, scale)


def test_proposals_carry_no_gradient():
    c = _loss_case(False)
    feats, l_rpn, _, props, pscores = c["det"].rpn_stage(
        c["taps"], _t(c["gts"]), _t(c["valid"]), c["noise"]
    )
    assert l_rpn.requires_grad and feats[0].requires_grad
    assert not props.requires_grad and not pscores.requires_grad


def test_mask_loss_evaluates_positives_first():
    """The head runs on num * pos_fraction rois, positives first in their
    sampled order (a stable sort of the pos flag)."""
    c = _loss_case(True)
    det, cfg = c["det"], c["cfg"]
    seen = []
    hook = det.mask_head.register_forward_hook(lambda m, args, out: seen.append(args[1]))
    try:
        with torch.no_grad():
            feats, _, _, props, pscores = det.rpn_stage(c["taps"], _t(c["gts"]), _t(c["valid"]), c["noise"])
            det.roi_stage(feats, props, pscores, _t(c["gts"]), _t(c["labels"]), _t(c["valid"]),
                          c["noise"], _t(c["ce"]), _t(c["cw"]), _t(c["masks"]))
            tgt = roi_head.sample_rois(props, pscores, _t(c["gts"]), _t(c["labels"]), _t(c["valid"]),
                                       c["noise"].roi_pos, c["noise"].roi_neg, c["noise"].roi_gather, cfg)
    finally:
        hook.remove()
    mr = int(cfg.rcnn_sample.num * cfg.rcnn_sample.pos_fraction)
    (labels,) = seen
    assert labels.shape == (2 * mr,)
    for i in range(2):
        pos_labels = tgt.labels[i][tgt.pos[i]]
        want = torch.cat([pos_labels, tgt.labels[i][~tgt.pos[i]]])[:mr].clamp(max=cfg.num_classes - 1)
        assert torch.equal(labels[i * mr:(i + 1) * mr], want)


def test_num_anchors_of_the_presets():
    assert rpn.num_anchors(config.PRESETS["ov_coco_vitb16"]) == 102300
    c = _loss_case(False)
    with torch.no_grad():
        _, smap, dmap = c["det"].features(c["taps"])
    assert rpn.flatten_rpn_outputs(smap, dmap, c["cfg"]).scores.shape[1] == rpn.num_anchors(c["cfg"])


# ---- the optimizer, the checkpoint and the CLI ----------------------------


def test_det_optimizer_steps_match_optax():
    """Two updates whose gradient norms (5 and 20) exceed the clip of 1.0, at
    a base lr of 10 so that the first updates (lr 0.01, then 0.04996) and
    the weight decay show far above the tolerance."""
    _, jcfg = _cfgs(True)
    c = _loss_case(True)
    params = jax.tree.map(np.asarray, _noisy(
        JDetector(jcfg).init(jax.random.PRNGKey(2), [jnp.asarray(t.numpy()) for t in c["taps"]],
                             jnp.asarray([[[4.0, 4.0, 30.0, 30.0]], [[8.0, 8.0, 40.0, 50.0]]]),
                             jnp.asarray(c["ce"]))["params"], 14))
    rng = np.random.default_rng(15)
    grad_trees = []
    for norm in (5.0, 20.0):
        g = jax.tree.map(lambda v: rng.normal(size=np.shape(v)).astype(np.float32), params)
        total = float(optax.global_norm(jax.tree.map(jnp.asarray, g)))
        grad_trees.append(jax.tree.map(lambda v: jnp.asarray(v * (norm / total), jnp.float32), g))
    tx = jtrain.build_det_optimizer(10.0, 0.1, 1.0)
    jparams = jax.tree.map(jnp.asarray, params)
    jstate = tx.init(jparams)
    det = fvit.FViTDetector(c["cfg"])
    det.load_state_dict(detector_state_dict_from_jax(params), strict=True)
    opt = train.build_det_optimizer(det, 10.0, 0.1, 1.0)
    named = dict(det.named_parameters())
    for count, g in enumerate(grad_trees):
        updates, jstate = tx.update(g, jstate, jparams)
        jparams = optax.apply_updates(jparams, updates)
        with torch.no_grad():
            for name, gt in detector_state_dict_from_jax(jax.tree.map(np.asarray, g)).items():
                named[name].grad.copy_(gt)
        norm = opt.step(count)
        assert abs(float(norm) - float(optax.global_norm(g))) <= 1e-5 * float(norm)
        want = detector_state_dict_from_jax(jax.tree.map(np.asarray, jparams))
        for name, p in named.items():
            # the temperature (~37) has a float32 spacing of 3.8e-6: relative there
            _close(p, want[name], OPT_TOL * max(1.0, float(want[name].abs().max())))
            assert not p.grad.any()
    moved = float((named["bbox_head.temperature"] - 37.0).abs())
    assert moved > 1e-3  # the temperature decays and steps like every parameter


def test_state_dict_to_jax_inverts_from_jax():
    _, jcfg = _cfgs(True)
    c = _loss_case(True)
    tree = jax.tree.map(np.asarray, _noisy(
        JDetector(jcfg).init(jax.random.PRNGKey(3), [jnp.asarray(t.numpy()) for t in c["taps"]],
                             jnp.asarray([[[4.0, 4.0, 30.0, 30.0]], [[8.0, 8.0, 40.0, 50.0]]]),
                             jnp.asarray(c["ce"]))["params"], 16))
    back = detector_state_dict_to_jax(detector_state_dict_from_jax(tree))
    flat_want = jax.tree_util.tree_flatten_with_path(tree)[0]
    flat_got = dict(jax.tree_util.tree_flatten_with_path(back)[0])
    assert len(flat_got) == len(flat_want)
    for path, v in flat_want:
        np.testing.assert_array_equal(flat_got[path], v)
        assert flat_got[path].dtype == np.float32
    sd = detector_state_dict_from_jax(back)
    for k, v in detector_state_dict_from_jax(tree).items():
        assert torch.equal(sd[k], v)


def _cli(tmp_path, *extra):
    return train.main([
        "--synthetic", "--preset", "tiny_test", "--device", "cpu", "--epochs", "1",
        "--steps-per-epoch", "2", "--log-every", "1", "--output", str(tmp_path), *extra,
    ])


def test_cli_trains_and_writes_a_checkpoint_both_packages_read(tmp_path):
    cfg, jcfg = _cfgs()
    init = fvit.create_detector(cfg, device="cpu", seed=0).state_dict()
    run = _cli(tmp_path)
    hist = run["history"]
    assert [h["step"] for h in hist] == [1, 2] and run["state"].step == 2
    for h in hist:
        assert all(math.isfinite(v) for v in h["metrics"].values())
        assert h["metrics"]["grad_norm"] > 0 and h["step_ms"] > 0
    trained = run["state"].model.state_dict()
    assert all(not torch.equal(trained[k], init[k]) for k in init)  # AdamW moves every tensor
    path = tmp_path / "detector_epoch0.pkl"
    with open(path, "rb") as f:
        blob = pickle.load(f)
    assert blob["epoch"] == 0 and blob["preset"] == cfg.clip_model
    rois = jnp.asarray([[[4.0, 4.0, 30.0, 30.0]]])
    jtaps = [jnp.zeros((1, 8, 8, 64))] * 4
    jparams = JDetector(jcfg).init(jax.random.PRNGKey(0), jtaps, rois, jnp.zeros((66, 32)))["params"]
    jflat = {
        "/".join(getattr(k, "key", str(k)) for k in p): np.shape(v)
        for p, v in jax.tree_util.tree_flatten_with_path(jparams)[0]
    }
    assert {k: v.shape for k, v in blob["params"].items()} == jflat
    det = fvit.FViTDetector(cfg)
    det.load_state_dict(load_detector(str(path)), strict=True)
    for k, v in det.state_dict().items():
        assert torch.equal(v, trained[k]), k
    jtree = jload_detector(str(path))
    for k, v in detector_state_dict_from_jax(jax.tree.map(np.asarray, jtree)).items():
        assert torch.equal(v, trained[k]), k


def test_cli_refuses_what_it_cannot_run(tmp_path):
    with pytest.raises(SystemExit, match="--ann-file and --image-root are required without --synthetic"):
        train.main(["--preset", "tiny_test", "--device", "cpu", "--output", str(tmp_path)])
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: --device cuda is a valid choice here")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train.main(["--synthetic", "--preset", "tiny_test", "--device", "cuda", "--output", str(tmp_path)])


def test_train_step_freezes_the_trunk():
    """One step through `make_det_train_step`: the CLIP trunk has no
    gradients and does not move; the generator's draws advance."""
    from clipself_tpu_torch.models.factory import create_model

    cfg, _ = _cfgs()
    clip = create_model(cfg.clip_model, device="cpu", dtype=torch.float32, seed=0).requires_grad_(False)
    before = {k: v.clone() for k, v in clip.state_dict().items()}
    det = fvit.create_detector(cfg, device="cpu", seed=1)
    state = train.DetTrainState(det, train.build_det_optimizer(det))
    gen = torch.Generator().manual_seed(0)
    rng = np.random.default_rng(17)
    ce = _t(_class_embed(rng, cfg))
    step = train.make_det_train_step(clip, cfg, ce, _t(classes.class_weights("coco", 0.6)), gen)
    gts, labels, valid = _gt(rng, 2, cfg.max_gt)
    batch = {"images": _t(rng.normal(size=(2, 64, 64, 3)).astype(np.float32)), "gt_boxes": _t(gts),
             "gt_labels": _t(labels), "gt_valid": _t(valid)}
    state0 = gen.get_state()
    m = step(state, batch)
    assert state.step == 1 and not torch.equal(gen.get_state(), state0)
    assert all(torch.isfinite(v).all() for v in m.values())
    assert all(p.grad is None for p in clip.parameters())
    assert all(torch.equal(v, before[k]) for k, v in clip.state_dict().items())
