"""The port's detector evaluation (`clipself_tpu_torch.detector.{classes,
eval_ap, data, evaluate}`) against the JAX package, on the CPU in float32.
The NumPy modules are copies and must give equal results; the synthetic data
must give the same arrays from the same seed; `evaluate_detector` at the
tiny test preset, with the JAX weights carried over, must give the same
metrics dict (1e-6: the detections agree to ~1e-5 pixels, far from any IoU
threshold of the matching).
"""

import json
import math

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from clipself_tpu.detector import classes as jclasses
from clipself_tpu.detector import config as jconfig
from clipself_tpu.detector import data as jdata
from clipself_tpu.detector import eval_ap as jeval_ap
from clipself_tpu.detector import evaluate as jevaluate
from clipself_tpu.detector.fvit import FViTDetector as JDetector
from clipself_tpu.detector.fvit import backbone_taps as jbackbone_taps
from clipself_tpu.detector.train import save_detector
from clipself_tpu.models.factory import create_model as jax_create_model
from clipself_tpu_torch.core.config import get_model_config
from clipself_tpu_torch.detector import classes, config, data, eval_ap, evaluate, fvit
from clipself_tpu_torch.models.clip import CLIP
from clipself_tpu_torch.models.torch_io import (
    detector_state_dict_from_jax,
    load_weights,
    state_dict_from_jax,
)

from torch_threads import capped_threads  # noqa: F401  (module fixture)


def test_class_splits_equal_original():
    assert classes.coco_split() == jclasses.coco_split()
    assert classes.lvis_split() == jclasses.lvis_split()
    for name in ("voc", "objects365", "coco"):
        assert classes.transfer_split(name) == jclasses.transfer_split(name)


@pytest.mark.parametrize("dataset", ["coco", "lvis"])
def test_class_weights_and_masks_equal_original(dataset):
    np.testing.assert_array_equal(
        classes.class_weights(dataset, 0.6), jclasses.class_weights(dataset, 0.6)
    )
    got, want = classes.base_novel_mask(dataset), jclasses.base_novel_mask(dataset)
    np.testing.assert_array_equal(got, want)
    assert got[-1] and 0 < got.sum() < len(got)


def test_transfer_mask_is_all_true():
    sp = classes.transfer_split("voc")
    assert classes.base_novel_mask(split=sp).all()


def _random_image(rng, num_classes, n_det, n_gt):
    def boxes(n):
        lo = rng.uniform(0, 80, (n, 2))
        return np.concatenate([lo, lo + rng.uniform(5, 40, (n, 2))], -1).astype(np.float32)

    gt = boxes(n_gt)
    det = np.concatenate([gt[: n_det // 2] + rng.normal(scale=2.0, size=(min(n_det // 2, n_gt), 4)),
                          boxes(n_det - min(n_det // 2, n_gt))]).astype(np.float32)
    gt_labels = rng.integers(0, num_classes, n_gt)
    det_labels = np.concatenate([gt_labels[: n_det // 2], rng.integers(0, num_classes, len(det) - min(n_det // 2, n_gt))])
    return det, rng.uniform(0.01, 1, len(det)).astype(np.float32), det_labels, gt, gt_labels, rng.uniform(size=n_gt) < 0.15


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_detection_evaluator_equals_original(seed):
    rng = np.random.default_rng(seed)
    names = [f"c{i}" for i in range(6)]
    evs = eval_ap.DetectionEvaluator(6), jeval_ap.DetectionEvaluator(6)
    for _ in range(5):
        img = _random_image(rng, 5, 12, 7)  # class 5 has no ground truth: NaN
        for ev in evs:
            ev.add_image(*img)
    kw = dict(class_names=names, base_classes=names[:3], novel_classes=names[3:],
              groups={"rare": names[4:], "frequent": names[:2]})
    got, want = evs[0].summarize(**kw), evs[1].summarize(**kw)
    assert got.keys() == want.keys()
    for k in want:
        assert got[k] == want[k] or (math.isnan(got[k]) and math.isnan(want[k])), k
    assert got["mAP"] > 0


def test_eval_ap_constants_equal_original():
    np.testing.assert_array_equal(eval_ap.IOU_THRS, jeval_ap.IOU_THRS)
    np.testing.assert_array_equal(eval_ap.RECALL_THRS, jeval_ap.RECALL_THRS)


@pytest.mark.parametrize("with_mask", [False, True])
def test_synthetic_data_equals_original(with_mask):
    args = dict(num_classes=65, image_size=32, max_gt=6, seed=3, with_mask=with_mask)
    a, b = data.SyntheticDetectionData(**args), jdata.SyntheticDetectionData(**args)
    for _ in range(2):  # the call counter folds into the seed
        got, want = a.batch(3), b.batch(3)
        assert got.keys() == want.keys()
        for k in want:
            np.testing.assert_array_equal(got[k], want[k])
            assert got[k].dtype == want[k].dtype
    stacked = data.collate(data.synthetic_eval_items(got))
    jstacked = jdata.collate(data.synthetic_eval_items(want))
    assert stacked.keys() == jstacked.keys() == want.keys()
    for k in want:
        np.testing.assert_array_equal(stacked[k], want[k])


def test_synthetic_eval_items():
    batch = data.SyntheticDetectionData(65, image_size=32, max_gt=6, seed=1).batch(4)
    items = data.synthetic_eval_items(batch)
    assert len(items) == 4
    for i, item in enumerate(items):
        n = int(batch["gt_valid"][i].sum())
        assert item["_gt_boxes_full"].shape == (n, 4)
        assert item["_gt_labels_full"].shape == (n,) and item["_gt_ignore_full"].shape == (n,)
        assert not item["_gt_ignore_full"].any()
        np.testing.assert_array_equal(item["_gt_boxes_full"], batch["gt_boxes"][i][batch["gt_valid"][i]])
        assert item["images"].shape == (32, 32, 3) and item["valid_hw"].shape == (2,)


@pytest.fixture(scope="module")
def models():
    cfg, jcfg = config.PRESETS["tiny_test"], jconfig.PRESETS["tiny_test"]
    rng = np.random.default_rng(5)
    ce = rng.normal(size=(cfg.num_classes + 1, cfg.embed_dim)).astype(np.float32)
    ce /= np.linalg.norm(ce, axis=-1, keepdims=True)
    jclip, clip_params = jax_create_model(jcfg.clip_model, dtype=jnp.float32, seed=0)
    clip_params = jax.tree.map(np.asarray, clip_params)
    clip = CLIP(get_model_config(cfg.clip_model), torch.float32).eval()
    load_weights(clip, state_dict_from_jax(clip_params))
    images = jnp.asarray(rng.normal(size=(1, 64, 64, 3)), jnp.float32)
    jtaps, _ = jbackbone_taps(jclip, clip_params, images, jcfg, True)
    jdet = JDetector(jcfg, dtype=jnp.float32)
    rois = jnp.asarray([[[4.0, 4.0, 30.0, 30.0]]])
    det_params = jax.tree.map(
        np.asarray, jdet.init(jax.random.PRNGKey(2), jtaps, rois, jnp.asarray(ce))["params"]
    )
    # biases off zero, so that the detector emits confident, spread-out boxes
    det_params["rpn"]["cls"]["bias"] = rng.normal(size=3).astype(np.float32)
    det_params["rpn"]["reg"]["bias"] = rng.normal(scale=0.3, size=12).astype(np.float32)
    det = fvit.FViTDetector(cfg).eval()
    det.load_state_dict(detector_state_dict_from_jax(det_params), strict=True)
    return dict(cfg=cfg, jcfg=jcfg, ce=ce, clip=clip, jclip=jclip, clip_params=clip_params,
                jdet=jdet, det_params=det_params, det=det)


def _items(cfg, n, seed):
    """Items whose ground truth is the detector's own output on them would
    need a trained detector; random boxes give near-zero AP on both sides,
    so half of the ground truth is taken from the port's detections."""
    batch = data.SyntheticDetectionData(cfg.num_classes, cfg.image_size, cfg.max_gt, seed=seed).batch(n)
    return data.synthetic_eval_items(batch)


def test_evaluate_detector_matches_jax(models):
    m = models
    cfg = m["cfg"]
    items = _items(cfg, 5, seed=7)
    # plant ground truth where the detector fires, so the metrics are not all 0
    predict = evaluate.make_predict_fn(
        m["det"], m["clip"], cfg, torch.from_numpy(m["ce"]),
        torch.from_numpy(classes.base_novel_mask("coco")),
    )
    for item in items:
        boxes, scores, labels = predict(
            torch.from_numpy(item["images"])[None], torch.from_numpy(item["valid_hw"])[None]
        )
        ok = (scores[0] > 0).numpy()
        take = np.where(ok)[0][:3]
        item["_gt_boxes_full"] = np.concatenate([item["_gt_boxes_full"], boxes[0].numpy()[take]])
        item["_gt_labels_full"] = np.concatenate([item["_gt_labels_full"], labels[0].numpy()[take]])
        item["_gt_ignore_full"] = np.zeros(len(item["_gt_boxes_full"]), bool)
    got = evaluate.evaluate_detector(
        m["det"], m["clip"], items, cfg, m["ce"], device="cpu", batch_size=2
    )
    want = jevaluate.evaluate_detector(
        m["jdet"], m["det_params"], m["jclip"], m["clip_params"], items, m["jcfg"], m["ce"],
        batch_size=2,
    )
    assert got.keys() == want.keys() == {"mAP", "AP50", "AP75", "AP50_base", "AP50_novel"}
    assert got["AP50"] > 0.0
    for k in want:
        if math.isnan(want[k]):
            assert math.isnan(got[k]), k
        else:
            assert abs(got[k] - want[k]) <= 1e-6, (k, got[k], want[k])
    # max_images stops early and the padded last batch scores nothing twice
    two = evaluate.evaluate_detector(
        m["det"], m["clip"], items, cfg, m["ce"], device="cpu", batch_size=2, max_images=3
    )
    jtwo = jevaluate.evaluate_detector(
        m["jdet"], m["det_params"], m["jclip"], m["clip_params"], items, m["jcfg"], m["ce"],
        batch_size=2, max_images=3,
    )
    for k in jtwo:
        assert math.isnan(jtwo[k]) and math.isnan(two[k]) or abs(two[k] - jtwo[k]) <= 1e-6


def test_load_detector_reads_a_jax_checkpoint(models, tmp_path):
    m = models
    save_detector(str(tmp_path), m["det_params"], m["jcfg"], epoch=3)
    sd = evaluate.load_detector(str(tmp_path / "detector_epoch3.pkl"))
    det = fvit.FViTDetector(m["cfg"])
    det.load_state_dict(sd, strict=True)
    want = m["det"].state_dict()
    assert sd.keys() == want.keys()
    for k in want:
        assert torch.equal(sd[k], want[k]), k
    # and the JAX package's own loader rebuilds the tree this was made from
    tree = jevaluate.load_detector(str(tmp_path / "detector_epoch3.pkl"))
    again = detector_state_dict_from_jax(jax.tree.map(np.asarray, tree))
    assert all(torch.equal(again[k], want[k]) for k in want)


def test_metrics_json_writes_null_for_nan():
    text = evaluate.metrics_json({"mAP": 0.25, "AP50_novel": float("nan")}, sort_keys=True)
    assert text == '{"AP50_novel": null, "mAP": 0.25}'
    assert json.loads(text) == {"AP50_novel": None, "mAP": 0.25}
