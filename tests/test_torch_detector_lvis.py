"""The port's LVIS protocol and mask AP (`clipself_tpu_torch.detector.
{eval_lvis, evaluate}`) against the JAX package, on the CPU in float32
except where bfloat16 is named.

`LvisEvaluator` is a NumPy copy: on the lvis-api oracle's fixtures of
`tests/test_lvis_eval.py` its summaries must be EQUAL to the original's
(NaN equal to NaN). The mask rasters must be EQUAL, bit for bit, to what
the JAX package gets from `PIL.Image.resize` (a flipped pixel moves mask IoU
and so the AP): `paste_mask` over a seeded sweep of grids, boxes and raster
sizes in float32 and bfloat16, `_resize_bool` at scales binary cannot
represent. `evaluate_detector` with a mask head, the JAX weights carried
over, on the same items (resize scales other than 1, gt masks, overflow
gts, the LVIS fields), must give the same metrics as the JAX function under
the LVIS protocol, the COCO protocol and a transfer split, to the 1e-6 of
`test_torch_detector_eval.py` (the detections agree to ~1e-5 pixels).
"""

import dataclasses
import math

import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st
from PIL import Image

import jax
import jax.numpy as jnp
import ml_dtypes

from clipself_tpu.detector import config as jconfig
from clipself_tpu.detector import eval_lvis as jeval_lvis
from clipself_tpu.detector import evaluate as jevaluate
from clipself_tpu.detector.fvit import FViTDetector as JDetector
from clipself_tpu.detector.fvit import backbone_taps as jbackbone_taps
from clipself_tpu.models.factory import create_model as jax_create_model
from clipself_tpu_torch.core.config import get_model_config
from clipself_tpu_torch.detector import classes, config, data, eval_lvis, evaluate, fvit
from clipself_tpu_torch.models.clip import CLIP
from clipself_tpu_torch.models.torch_io import (
    detector_state_dict_from_jax,
    load_weights,
    state_dict_from_jax,
)
from test_lvis_eval import FREQS, NUM_CATS, _make_dataset
from test_torch_detector_model import _noisy

from torch_threads import capped_threads  # noqa: F401  (module fixture)

METRIC_TOL = 1e-6
MASK_CFG = dict(with_mask=True, num_classes=20, mask_convs=1, mask_channels=16, mask_roi_size=6)


def _assert_equal_metrics(got, want, tol=0.0):
    assert got.keys() == want.keys()
    for k, w in want.items():
        g = got[k]
        if isinstance(w, float) and math.isnan(w):
            assert math.isnan(g), (k, g, w)
        else:
            assert abs(g - w) <= tol, (k, g, w)


# ---- the LVIS evaluator ----------------------------------------------------


def test_eval_lvis_constants_equal_original():
    np.testing.assert_array_equal(eval_lvis.AREA_RNGS, jeval_lvis.AREA_RNGS)
    assert eval_lvis.AREA_LBLS == jeval_lvis.AREA_LBLS
    np.testing.assert_array_equal(eval_lvis.IOU_THRS, jeval_lvis.IOU_THRS)
    np.testing.assert_array_equal(eval_lvis.RECALL_THRS, jeval_lvis.RECALL_THRS)


def _both(num_classes, **kw):
    return eval_lvis.LvisEvaluator(num_classes, **kw), jeval_lvis.LvisEvaluator(num_classes, **kw)


@pytest.mark.parametrize("with_mask", [False, True], ids=["bbox", "segm"])
@pytest.mark.parametrize("seed,max_dets", [(0, 25), (1, 25), (2, 300), (7, 25)])
def test_lvis_evaluator_equals_original(seed, max_dets, with_mask):
    """The oracle's fixtures: the per-image cap (image 0 has ~65 detections),
    federated pos / neg sets, not-exhaustive ignores, area ranges, a class
    with no gt anywhere (-1) and the frequency groups."""
    _, _, per_image = _make_dataset(np.random.default_rng(seed), with_mask=with_mask)
    freq = np.array(["rcf".index(f) for f in FREQS])
    evs = _both(NUM_CATS, freq_index=freq, max_dets=max_dets, with_mask=with_mask)
    for item in per_image:
        item = dict(item)
        if not with_mask:
            item.pop("det_masks"), item.pop("gt_masks")
        for ev in evs:
            ev.add_image(**item)
    got, want = evs[0].summarize(), evs[1].summarize()
    _assert_equal_metrics(got, want)
    assert f"AR@{max_dets}" in got and (with_mask or got["AP"] > 0)


@pytest.mark.parametrize("case", ["federated_dropped", "federated_negative", "not_exhaustive", "gt_ignore", "no_freq"])
def test_lvis_evaluator_edge_cases_equal_original(case):
    box = np.array([[10.0, 10.0, 50.0, 50.0]])
    empty = (np.zeros((0, 4)), np.zeros(0, int))
    kw = {} if case == "no_freq" else {"freq_index": np.array([0, 2])}
    evs = _both(2, **kw)
    for ev in evs:
        ev.add_image(box, np.array([0.9]), np.array([0]), box, np.array([0]))
        if case.startswith("federated"):
            neg = [0] if case == "federated_negative" else [1]
            ev.add_image(box, np.array([0.95]), np.array([0]), *empty, neg_labels=neg)
        elif case == "not_exhaustive":
            dets = np.array([[10.0, 10.0, 50.0, 50.0], [200.0, 200.0, 260.0, 260.0]])
            ev.add_image(dets, np.array([0.9, 0.95]), np.array([1, 1]), box, np.array([1]),
                         not_exhaustive_labels=[1])
        elif case == "gt_ignore":
            gts = np.concatenate([box, box + 100.0])
            ev.add_image(box + 100.0, np.array([0.8]), np.array([1]), gts, np.array([1, 1]),
                         gt_ignore=np.array([False, True]))
        else:
            ev.add_image(box * 3, np.array([0.5]), np.array([1]), box * 3, np.array([1]))
    got, want = evs[0].summarize(), evs[1].summarize()
    _assert_equal_metrics(got, want)
    assert ("APr" in got) == (case != "no_freq")


# ---- mask rasters without PIL --------------------------------------------


@pytest.mark.parametrize("seed", range(4))
def test_resize_bilinear_u8_equals_pil(seed):
    """Up and down in either axis, 1 to ~300 pixels, a 28x28 grid (the mask
    head's) in every other case, and grids of 0 / 127 / 128 / 255 only."""
    rng = np.random.default_rng(seed)
    for trial in range(150):
        ih, iw = (28, 28) if trial % 2 else tuple(rng.integers(1, 40, 2))
        oh, ow = rng.integers(1, 310, 2)
        if trial % 5 == 0:
            img = rng.choice(np.array([0, 127, 128, 255], np.uint8), (ih, iw))
        else:
            img = rng.integers(0, 256, (ih, iw)).astype(np.uint8)
        want = np.asarray(Image.fromarray(img).resize((int(ow), int(oh)), Image.BILINEAR))
        got = evaluate.resize_bilinear_u8(img, (oh, ow))
        assert got.dtype == np.uint8
        np.testing.assert_array_equal(got, want, err_msg=f"{(ih, iw)} -> {(oh, ow)}")
    same = rng.integers(0, 256, (7, 9)).astype(np.uint8)
    out = evaluate.resize_bilinear_u8(same, (7, 9))
    np.testing.assert_array_equal(out, same)
    assert out is not same


def _probs(rng, dtype):
    """28x28 probabilities, a third of them on the values whose x 255 lands
    on or next to 127 / 128 (and 0, 1), in ``dtype`` on both sides: a
    float32 array and tensor, or a bfloat16 NumPy array (the JAX package's
    `np.asarray` of a bfloat16 output) and the tensor of the same values."""
    p = rng.uniform(size=(28, 28)).astype(np.float32)
    edge = np.array([127 / 255, 127.5 / 255, 128 / 255, 0.5, 0.498, 0.502, 0.0, 1.0], np.float32)
    pick = rng.uniform(size=p.shape) < 0.35
    p[pick] = rng.choice(edge, int(pick.sum()))
    t = torch.from_numpy(p).to(getattr(torch, dtype))
    ref = t.float().numpy().astype(ml_dtypes.bfloat16 if dtype == "bfloat16" else np.float32)
    return t, ref


def _box(rng, side):
    """Boxes of 0 to ~224 pixels, some with negative corners, some past the
    raster, some of zero width or height."""
    lo = rng.uniform(-30, side, 2)
    wh = rng.uniform(0, min(224, 1.5 * side), 2)
    if rng.uniform() < 0.15:
        wh[rng.integers(2)] = 0.0
    return np.concatenate([lo, lo + wh]).astype(np.float32)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("seed", range(3))
def test_paste_mask_equals_jax(dtype, seed):
    rng = np.random.default_rng(100 + seed)
    for _ in range(60):
        side = int(rng.integers(1, 230))
        t, ref = _probs(rng, dtype)
        box = _box(rng, side)
        want = jevaluate.paste_mask(ref, box, (side, side))
        got = evaluate.paste_mask(t, box, (side, side))
        np.testing.assert_array_equal(got, want, err_msg=f"box {box.tolist()} side {side}")
        # the NumPy array of the same values pastes the same raster
        np.testing.assert_array_equal(evaluate.paste_mask(ref, box, (side, side)), want)


def test_quantize_probs_equals_numpy_on_every_bfloat16_probability():
    """Every bfloat16 value in [0, 1]: the tensor's product, rounded to
    bfloat16 and truncated, equals NumPy's on the JAX package's bfloat16
    array of the same values."""
    vals = torch.arange(0, 1 << 14, dtype=torch.int16).view(torch.bfloat16)
    vals = vals[(vals >= 0) & (vals <= 1)]
    got = evaluate.quantize_probs(vals)
    want = (vals.float().numpy().astype(ml_dtypes.bfloat16) * 255).astype(np.uint8)
    assert len(got) > 16000
    np.testing.assert_array_equal(got, want)


@settings(max_examples=150, deadline=None)
@given(
    grid=st.integers(1, 30), side=st.integers(1, 240),
    x0=st.floats(-40, 240), y0=st.floats(-40, 240), w=st.floats(0, 230), h=st.floats(0, 230),
    seed=st.integers(0, 2 ** 16),
)
def test_paste_mask_equals_jax_hypothesis(grid, side, x0, y0, w, h, seed):
    p = np.random.default_rng(seed).uniform(size=(grid, grid)).astype(np.float32)
    box = np.array([x0, y0, x0 + w, y0 + h], np.float32)
    np.testing.assert_array_equal(
        evaluate.paste_mask(torch.from_numpy(p), box, (side, side)),
        jevaluate.paste_mask(p, box, (side, side)),
    )


def test_paste_mask_geometry():
    """The JAX package's geometry cases: a uniform grid pastes to exactly
    the box's footprint, clipped to the raster, no wrap; a half / half grid
    splits at the box's midline."""
    ones = np.ones((4, 4), np.float32)
    out = evaluate.paste_mask(ones, np.asarray([2.0, 3.0, 7.0, 6.0]), (10, 10))
    want = np.zeros((10, 10), bool)
    want[3:6, 2:7] = True
    np.testing.assert_array_equal(out, want)
    out = evaluate.paste_mask(ones, np.asarray([-3.0, 8.0, 4.0, 14.0]), (10, 10))
    assert out[:8].sum() == 0 and out[8:, :4].all() and not out[8:, 4:].any()
    half = np.concatenate([np.ones((8, 4), np.float32), np.zeros((8, 4), np.float32)], axis=1)
    out = evaluate.paste_mask(half, np.asarray([0.0, 0.0, 8.0, 8.0]), (10, 10))
    assert out[:8, :3].all() and not out[:8, 5:].any() and out[8:].sum() == 0
    # a zero-width box still pastes one column; a box off the raster nothing
    assert evaluate.paste_mask(ones, np.asarray([4.0, 2.0, 4.0, 6.0]), (10, 10)).sum() == 0
    assert evaluate.paste_mask(ones, np.asarray([4.2, 2.0, 4.2, 6.0]), (10, 10)).sum() == 4
    assert evaluate.paste_mask(ones, np.asarray([12.0, 12.0, 20.0, 20.0]), (10, 10)).sum() == 0


@pytest.mark.parametrize("seed", range(3))
def test_resize_bool_equals_jax(seed):
    """NEAREST at scales binary cannot represent (1/3, 3/7, 5/11), at the
    eval path's stride-4 rasters (160 -> ceil(640 / scale / 4)) and at
    random sizes, up and down."""
    rng = np.random.default_rng(200 + seed)
    cases = [((21, 21), (7, 7)), ((49, 49), (21, 21)), ((33, 33), (15, 15)), ((7, 7), (21, 21))]
    for scale in rng.uniform(0.5, 1.5, 8):
        hs = int(np.ceil(640 / np.float32(scale) / 4))
        cases.append(((160, 160), (hs, hs)))
    cases += [(tuple(rng.integers(1, 300, 2)), tuple(rng.integers(1, 300, 2))) for _ in range(20)]
    for src, dst in cases:
        m = (rng.uniform(size=src) < 0.4).astype(np.uint8)
        got = evaluate._resize_bool(m, dst)
        assert got.dtype == bool
        np.testing.assert_array_equal(got, jevaluate._resize_bool(m, dst), err_msg=f"{src} -> {dst}")


# ---- the whole evaluation against the JAX package --------------------------


def _split20():
    names = [f"c{i}" for i in range(20)]
    return {
        "all": names, "seen": names[:14], "unseen": names[14:],
        "freq_groups": {"rare": names[14:], "common": names[7:14], "frequent": names[:7]},
    }


@pytest.fixture(scope="module")
def mask_models():
    """A 20-class tiny detector with a mask head on noisy weights, both
    packages; the mask logits biased up so that the pasted masks cover most
    of their boxes and mask IoU is not ~0. The JAX `predict` is compiled
    once per (class embedding, base mask) and shared by every call here."""
    cfg = dataclasses.replace(config.PRESETS["tiny_test"], **MASK_CFG)
    jcfg = dataclasses.replace(jconfig.PRESETS["tiny_test"], **MASK_CFG)
    rng = np.random.default_rng(21)
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
    det_params = _noisy(jdet.init(jax.random.PRNGKey(2), jtaps, rois, jnp.asarray(ce))["params"], 22)
    det_params["rpn"]["cls"]["bias"] = rng.normal(size=3).astype(np.float32)
    det_params["mask_head"]["logits"]["bias"] = det_params["mask_head"]["logits"]["bias"] + 3.0
    det = fvit.FViTDetector(cfg).eval()
    det.load_state_dict(detector_state_dict_from_jax(det_params), strict=True)

    compiled = {}
    make = jevaluate.make_predict_fn

    def shared(jdet_, jclip_, cfg_, ce_, bm_):
        key = (id(jdet_), id(jclip_), cfg_, np.asarray(ce_).tobytes(), np.asarray(bm_).tobytes())
        if key not in compiled:
            compiled[key] = make(jdet_, jclip_, cfg_, ce_, bm_)
        return compiled[key]

    jevaluate.make_predict_fn = shared
    yield dict(cfg=cfg, jcfg=jcfg, ce=ce, clip=clip, jclip=jclip, clip_params=clip_params,
               jdet=jdet, det_params=det_params, det=det, compiled=compiled)
    jevaluate.make_predict_fn = make


def _planted_items(m, n, seed):
    """LVIS eval items with gt masks and scales other than 1, half of whose
    ground truth is the port's own detections (box, label and a filled box
    raster at stride 4), so that box and mask AP are not all 0; the first
    item also carries one overflow gt beyond the rasters (ignored, a filled
    box raster)."""
    cfg = m["cfg"]
    batch = data.SyntheticDetectionData(
        cfg.num_classes, cfg.image_size, cfg.max_gt, seed=seed, with_mask=True
    ).batch(n)
    predict = evaluate.make_predict_fn(
        m["det"], m["clip"], cfg, torch.from_numpy(m["ce"]),
        torch.from_numpy(classes.base_novel_mask(split=_split20())),
    )
    boxes, scores, labels, _ = predict(
        torch.from_numpy(batch["images"]), torch.from_numpy(batch["valid_hw"])
    )
    ms = cfg.image_size // 4
    for i in range(n):
        live = np.where(scores[i].numpy() > 0)[0][:3]
        for slot, j in enumerate(live):
            b = boxes[i, j].numpy()
            batch["gt_boxes"][i, slot] = b
            batch["gt_labels"][i, slot] = labels[i, j].item()
            batch["gt_valid"][i, slot] = True
            r = np.zeros((ms, ms), np.uint8)
            r[int(b[1] / 4): int(np.ceil(b[3] / 4)), int(b[0] / 4): int(np.ceil(b[2] / 4))] = 1
            batch["gt_masks"][i, slot] = r
    items = data.synthetic_eval_items(batch, num_classes=cfg.num_classes, seed=seed)
    it = items[0]
    extra = boxes[0, 0].numpy()[None] / it["scale"]
    it["_gt_boxes_full"] = np.concatenate([it["_gt_boxes_full"], extra])
    it["_gt_labels_full"] = np.concatenate([it["_gt_labels_full"], labels[0, :1].numpy()])
    it["_gt_ignore_full"] = np.zeros(len(it["_gt_boxes_full"]), bool)
    it["_gt_areas_full"] = np.concatenate([it["_gt_areas_full"], [50.0]])
    return items


@pytest.mark.parametrize(
    "dataset_name,split",
    [("lvis", "split20"), ("coco", "split20"), ("voc", "voc")],
    ids=["lvis_protocol", "coco_protocol", "transfer_voc"],
)
def test_evaluate_detector_with_masks_matches_jax(mask_models, dataset_name, split):
    m = mask_models
    sp = _split20() if split == "split20" else classes.transfer_split("voc")
    items = _planted_items(m, 5, seed=31)
    timings = {}
    got = evaluate.evaluate_detector(
        m["det"], m["clip"], items, m["cfg"], m["ce"], device="cpu", dataset_name=dataset_name,
        batch_size=2, split=sp, timings=timings,
    )
    want = jevaluate.evaluate_detector(
        m["jdet"], m["det_params"], m["jclip"], m["clip_params"], items, m["jcfg"], m["ce"],
        dataset_name=dataset_name, batch_size=2, split=sp,
    )
    _assert_equal_metrics(got, want, METRIC_TOL)
    if dataset_name == "lvis":
        assert {"AP", "APr", "APc", "APf", "segm_AP", "segm_APr", "segm_AR@300"} <= got.keys()
    else:
        assert {"mAP", "AP50", "AP50_base", "segm_mAP", "segm_AP50"} <= got.keys()
    box_key, segm_key = ("AP50", "segm_AP50")
    assert got[box_key] > 0 and got[segm_key] > 0, got
    assert set(timings) == {"predict", "copy", "paste", "match", "summarize"}
    assert all(v >= 0 for v in timings.values())


def test_evaluate_detector_lvis_default_split(mask_models):
    """``split=None`` with ``dataset_name="lvis"`` takes `lvis_split()` (the
    LVIS protocol, 1203 classes), as the JAX function does."""
    m = mask_models
    cfg = dataclasses.replace(m["cfg"], num_classes=1203)
    det = fvit.create_detector(cfg, device="cpu", seed=3)
    ce = np.random.default_rng(4).normal(size=(1204, cfg.embed_dim)).astype(np.float32)
    ce /= np.linalg.norm(ce, axis=-1, keepdims=True)
    batch = data.SyntheticDetectionData(1203, cfg.image_size, cfg.max_gt, seed=5, with_mask=True).batch(2)
    items = data.synthetic_eval_items(batch, num_classes=1203, seed=5)
    got = evaluate.evaluate_detector(det, m["clip"], items, cfg, ce, device="cpu", dataset_name="lvis")
    assert {"AP", "APr", "APc", "APf", "mAP_rare", "segm_AP", "segm_APf"} <= got.keys()
    text = evaluate.metrics_json(got)
    assert "NaN" not in text


LVIS_KEYS = {"AP", "AP50", "AP75", "APs", "APm", "APl", "AR@300", "APr", "APc", "APf",
             "mAP", "mAP_rare", "mAP_common", "mAP_frequent"}
COCO_KEYS = {"mAP", "AP50", "AP75", "AP50_base", "AP50_novel"}


@pytest.mark.parametrize("preset", ["ov_coco_vitb16", "ov_coco_vitl14", "ov_lvis_vitb16", "ov_lvis_vitl14"])
def test_evaluate_detector_keys_of_every_preset(mask_models, preset):
    """Each detector preset's protocol (vocabulary, mask head) on the tiny
    trunk: no raise, and the JAX function's keys (LVIS AP / APr / APc / APf,
    `segm_` with the mask head; COCO base / novel AP50)."""
    m = mask_models
    p = config.PRESETS[preset]
    cfg = dataclasses.replace(
        config.PRESETS["tiny_test"], num_classes=p.num_classes, with_mask=p.with_mask,
        mask_convs=1, mask_channels=16, mask_roi_size=6,
    )
    name = "lvis" if "lvis" in preset else "coco"
    det = fvit.create_detector(cfg, device="cpu", seed=6)
    ce = np.random.default_rng(7).normal(size=(cfg.num_classes + 1, cfg.embed_dim)).astype(np.float32)
    ce /= np.linalg.norm(ce, axis=-1, keepdims=True)
    batch = data.SyntheticDetectionData(cfg.num_classes, 64, cfg.max_gt, seed=8, with_mask=cfg.with_mask).batch(2)
    items = data.synthetic_eval_items(batch, num_classes=cfg.num_classes, seed=8)
    got = evaluate.evaluate_detector(det, m["clip"], items, cfg, ce, device="cpu", dataset_name=name)
    keys = LVIS_KEYS if name == "lvis" else COCO_KEYS
    want = keys | ({f"segm_{k}" for k in keys} if cfg.with_mask else set())
    assert got.keys() == want


def test_synthetic_lvis_items():
    batch = data.SyntheticDetectionData(20, image_size=32, max_gt=6, seed=1, with_mask=True).batch(4)
    items = data.synthetic_eval_items(batch, num_classes=20, seed=2)
    again = data.synthetic_eval_items(batch, num_classes=20, seed=2)
    for i, (item, it2) in enumerate(zip(items, again)):
        v = batch["gt_valid"][i]
        s = item["scale"]
        assert 0.5 <= s < 1.5 and s == it2["scale"] and item["_neg_labels"] == it2["_neg_labels"]
        np.testing.assert_array_equal(item["_gt_boxes_full"], batch["gt_boxes"][i][v] / s)
        labels = set(item["_gt_labels_full"].tolist())
        assert item["_neg_labels"] == sorted(item["_neg_labels"]) and not labels & set(item["_neg_labels"])
        assert set(item["_nel_labels"]) <= labels and item["_nel_labels"] == sorted(item["_nel_labels"])
        assert item["_gt_areas_full"].shape == (int(v.sum()),)
        assert item["gt_masks"].shape == (6, 8, 8)
    # without a vocabulary the items are those of the scale-1 batch
    plain = data.synthetic_eval_items(batch)
    assert all(it["scale"] == 1.0 and "_neg_labels" not in it for it in plain)


def test_lvis_ground_truth_has_lvis_density():
    """Annotations and distinct classes an image average LVIS v1 train's
    12.68 and 3.59 (the cap at one class a gt takes a little off the
    second), frequent classes come up more than rare ones, and boxes, masks
    and images stay the batch's."""
    batch = data.SyntheticDetectionData(1203, image_size=32, max_gt=100, seed=3, with_mask=True).batch(400)
    got = data.lvis_ground_truth(batch, seed=4)
    again = data.lvis_ground_truth(batch, seed=4)
    n = got["gt_valid"].sum(1)
    assert n.min() >= 1 and abs(n.mean() - 12.68) < 0.5
    for i in range(len(n)):
        assert got["gt_valid"][i, : n[i]].all() and not got["gt_valid"][i, n[i]:].any()
    k = np.array([len(np.unique(got["gt_labels"][i, : n[i]])) for i in range(len(n))])
    assert (k <= n).all() and 3.2 < k.mean() < 3.7
    np.testing.assert_array_equal(got["gt_labels"], again["gt_labels"])
    for key in ("gt_boxes", "gt_masks", "images"):
        assert got[key] is batch[key]
    freq = {g: {classes.lvis_split()["all"].index(c) for c in names}
            for g, names in classes.lvis_split()["freq_groups"].items()}
    labels = np.concatenate([got["gt_labels"][i, : n[i]] for i in range(len(n))])
    share = {g: np.isin(labels, list(c)).mean() for g, c in freq.items()}
    assert share["frequent"] > share["common"] > share["rare"]
