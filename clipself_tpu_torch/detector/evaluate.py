"""Detector evaluation loop: batched prediction -> NumPy COCO AP.

A port of `clipself_tpu/detector/evaluate.py` (mmdet `F-ViT/test.py` +
`CocoDatasetOV.evaluate`): per-image fused detections are rescaled to
original image coordinates and scored with the COCO box protocol, reporting
mAP / AP50 / AP75 and the open-vocabulary base / novel AP50 split. Not
ported yet (ROADMAP.md queue 1 items 2 and 7): the LVIS protocol, mask AP
(its mask pasting needs PIL), `DetectionDataset` and the command line.
"""

from __future__ import annotations

import json
import logging
import math
import pickle
import time
from typing import Optional, Sequence, Union

import numpy as np
import torch

from clipself_tpu_torch.detector.classes import base_novel_mask, coco_split
from clipself_tpu_torch.detector.config import FViTConfig
from clipself_tpu_torch.detector.data import collate
from clipself_tpu_torch.detector.eval_ap import DetectionEvaluator
from clipself_tpu_torch.detector.fvit import FViTDetector, backbone_taps
from clipself_tpu_torch.models.torch_io import detector_state_dict_from_jax


def make_predict_fn(det: FViTDetector, clip_model, cfg: FViTConfig, class_embed, base_mask):
    """predict(images [B, H, W, 3], valid_hw [B, 2]) -> `FViTDetector.predict`
    outputs, with the backbone's taps and dense VLM map from one trunk pass.
    ``class_embed`` and ``base_mask`` are tensors on the models' device."""

    @torch.inference_mode()
    def predict(images: torch.Tensor, valid_hw: torch.Tensor):
        taps, dense = backbone_taps(clip_model, images, cfg, True)
        return det.predict(taps, dense, class_embed, base_mask, None, valid_hw)

    return predict


def evaluate_detector(
    det: FViTDetector,
    clip_model,
    dataset: Sequence[dict],
    cfg: FViTConfig,
    class_embed,
    *,
    device: Union[str, torch.device],
    dataset_name: str = "coco",
    batch_size: int = 8,
    max_images: Optional[int] = None,
    log_every: int = 50,
    split: Optional[dict] = None,
) -> dict:
    """Score ``det`` over ``clip_model`` on a sequence of per-image items
    (`images`, `valid_hw`, `scale`, `_gt_boxes_full`, `_gt_labels_full`,
    `_gt_ignore_full`), both models already on ``device``. ``class_embed``:
    [K+1, D] array of unit rows, background last. Returns the metrics dict of
    `DetectionEvaluator.summarize`; with `cfg.with_mask` the mask
    probabilities are computed and dropped (box AP only)."""
    if split is None:
        if dataset_name != "coco":
            raise NotImplementedError(
                f"dataset {dataset_name!r} without a split: only the COCO registry is wired "
                "(ROADMAP.md queue 1 item 7)"
            )
        split = coco_split()
    elif dataset_name == "lvis" and "freq_groups" in split:
        raise NotImplementedError("the LVIS protocol is not ported (ROADMAP.md queue 1 item 7)")
    device = torch.device(device)
    # base / background rows fuse with alpha, novel with beta (all-True for
    # transfer vocabularies, where every class uses the base exponent)
    bm = torch.as_tensor(base_novel_mask(split=split), device=device)
    ce = torch.as_tensor(np.asarray(class_embed), dtype=torch.float32, device=device)
    predict = make_predict_fn(det, clip_model, cfg, ce, bm)
    ev = DetectionEvaluator(cfg.num_classes, with_mask=False)
    log = logging.getLogger("fvit-eval")

    n = len(dataset) if max_images is None else min(max_images, len(dataset))
    t0 = time.time()
    for start in range(0, n, batch_size):
        real = min(batch_size, n - start)
        # the last partial batch is padded by repeating its final item (the
        # padded copies are not scored): no image is dropped
        items = [dataset[min(start + j, start + real - 1)] for j in range(batch_size)]
        batch = collate(items)
        out = predict(
            torch.as_tensor(batch["images"], device=device),
            torch.as_tensor(batch["valid_hw"], device=device),
        )
        boxes, scores = out[0].float().cpu().numpy(), out[1].float().cpu().numpy()
        labels = out[2].cpu().numpy()
        for bi, item in enumerate(items[:real]):
            ok = scores[bi] > 0.0
            s = float(item["scale"])
            # full (unpadded) gt set in original coordinates; crowd = ignore
            ev.add_image(
                boxes[bi][ok] / s, scores[bi][ok], labels[bi][ok],
                item["_gt_boxes_full"], item["_gt_labels_full"], item["_gt_ignore_full"],
            )
        if (start // batch_size + 1) % log_every == 0:
            log.info(f"eval {start + real}/{n} ({(start + real) / (time.time() - t0):.1f} img/s)")

    return ev.summarize(
        class_names=split["all"], base_classes=split["seen"],
        novel_classes=split["unseen"], groups=split.get("freq_groups"),
    )


def metrics_json(metrics: dict, **dump_kwargs) -> str:
    """The metrics as strict JSON: a NaN (a class group without ground
    truth) is written as ``null``, never as a bare ``NaN`` token."""
    clean = {
        k: (None if isinstance(v, float) and not math.isfinite(v) else v)
        for k, v in metrics.items()
    }
    return json.dumps(clean, allow_nan=False, **dump_kwargs)


def load_detector(path: str) -> dict[str, torch.Tensor]:
    """A detector checkpoint written by either package's `save_detector` (a
    pickle whose `params` maps 'a/b/c' flax paths to arrays) -> the state
    dict of the port's `FViTDetector`, to load with ``strict=True``."""
    with open(path, "rb") as f:
        blob = pickle.load(f)
    tree: dict = {}
    for key, val in blob["params"].items():
        parts = key.split("/")
        node = tree
        for p_ in parts[:-1]:
            node = node.setdefault(p_, {})
        node[parts[-1]] = np.asarray(val)
    return detector_state_dict_from_jax(tree)
