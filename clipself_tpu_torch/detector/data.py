"""Synthetic detection data: fixed-shape random batches and per-image
evaluation items.

`collate` and `SyntheticDetectionData` are copies of
`clipself_tpu/detector/data.py:324-366` with the same generator calls in the
same order, so the same seed gives the same arrays
(`tests/test_torch_detector_eval.py` pins it). `synthetic_eval_items` cuts
one such batch into the per-image items `evaluate_detector` reads, the
format of the JAX package's `DetectionDataset` at eval time (which needs PIL
and COCO files and is not ported yet, ROADMAP.md queue 1 item 2); with a
seed it also draws what an LVIS item carries (annotation areas, the
federated negative and not-exhaustive labels) and a resize scale other than
1. `lvis_ground_truth` redraws a batch's ground truth to LVIS v1's density
(annotations and classes an image). `synthetic_nms_case` makes the
score-ordered candidate boxes that the NMS kernel is checked on
(`chip_smoke.py`, `tests/test_torch_kernels_cuda.py`).
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from clipself_tpu_torch.detector.anchors import grid_anchors
from clipself_tpu_torch.detector.boxes import decode_boxes
from clipself_tpu_torch.detector.classes import lvis_split

# LVIS v1 train has 100,170 images (lvisdataset.org, the v1 release). Its
# annotations and image-class pairs are the sums of `instance_count` and
# `image_count` over `lvis_v1_train_cat_norare_info.json`: 1,270,141 and
# 359,456, so 12.68 annotations over 3.59 classes an image.
LVIS_TRAIN_IMAGES = 100170


def collate(items: list[dict]) -> dict:
    """Stack batchable keys; underscore-prefixed keys (variable-length
    per-image eval metadata) are per-item and skipped."""
    return {
        k: np.stack([it[k] for it in items])
        for k in items[0]
        if not k.startswith("_")
    }


class SyntheticDetectionData:
    """Fixed-shape random detection batches for smoke tests and benches."""

    def __init__(self, num_classes: int, image_size=640, max_gt=20, seed=0, with_mask=False):
        self.num_classes = num_classes
        self.image_size = image_size
        self.max_gt = max_gt
        self.seed = seed
        self.with_mask = with_mask
        self._calls = 0

    def batch(self, batch_size: int) -> dict:
        # fold a call counter into the seed: successive batches differ
        rng = np.random.default_rng((self.seed, self._calls))
        self._calls += 1
        b, g, s = batch_size, self.max_gt, self.image_size
        xy = rng.uniform(0, s * 0.6, size=(b, g, 2)).astype(np.float32)
        wh = rng.uniform(8, s * 0.3, size=(b, g, 2)).astype(np.float32)
        out = {
            "images": rng.normal(size=(b, s, s, 3)).astype(np.float32),
            "gt_boxes": np.concatenate([xy, np.clip(xy + wh, None, s)], -1),
            "gt_labels": rng.integers(0, self.num_classes, size=(b, g)),
            "gt_valid": rng.uniform(size=(b, g)) < 0.7,
            "scale": np.ones((b,), np.float32),
            "image_id": np.arange(b, dtype=np.int64),
            "valid_hw": np.full((b, 2), float(s), np.float32),
        }
        if self.with_mask:
            out["gt_masks"] = (
                rng.uniform(size=(b, g, s // 4, s // 4)) < 0.3
            ).astype(np.uint8)
        return out


def lvis_ground_truth(batch: dict, seed: int) -> dict:
    """A copy of a 1203-class batch whose ground truth has LVIS v1's density
    (`LVIS_TRAIN_IMAGES`): an image holds Poisson(12.68) annotations, at
    least 1 and at most the batch's slots, in its first slots; they cover
    min(annotations, 1 + Poisson(2.59)) distinct classes (3.59 an image on
    average before that cap), drawn without replacement in proportion to
    each class's `image_count`; every class takes one annotation and the
    rest are spread uniformly over them. Only the means are LVIS's, not the
    shapes of the distributions. Boxes and masks stay the batch's."""
    info = lvis_split()["cat_info"]
    image_count = np.array([c["image_count"] for c in info], np.float64)
    per_image = image_count.sum() / LVIS_TRAIN_IMAGES
    anns = sum(c["instance_count"] for c in info) / LVIS_TRAIN_IMAGES
    rng = np.random.default_rng(seed)
    out = dict(batch, gt_valid=np.zeros_like(batch["gt_valid"]), gt_labels=batch["gt_labels"].copy())
    slots = batch["gt_valid"].shape[1]
    for i in range(len(out["gt_valid"])):
        n = int(np.clip(rng.poisson(anns), 1, slots))
        k = min(n, 1 + int(rng.poisson(per_image - 1)))
        present = rng.choice(len(info), size=k, replace=False, p=image_count / image_count.sum())
        out["gt_valid"][i, :n] = True
        out["gt_labels"][i, :n] = np.concatenate([present, rng.choice(present, size=n - k)])
    return out


def synthetic_eval_items(
    batch: dict, num_classes: Optional[int] = None, seed: int = 0
) -> list[dict]:
    """One item per image of a `SyntheticDetectionData.batch`: its batchable
    keys plus the full (unpadded) ground truth in original coordinates under
    `_gt_boxes_full`, `_gt_labels_full`, `_gt_ignore_full` (no crowd
    regions), as `evaluate_detector` reads them.

    With ``num_classes`` (the vocabulary), every key that
    `DetectionDataset.__getitem__` gives an eval item
    (`clipself_tpu/detector/data.py:176-226`) is drawn from ``seed``: a
    `scale` in [0.5, 1.5) (the batch is then the image resized by it, so
    `_gt_boxes_full` is the boxes divided by it), `_gt_areas_full` (an
    annotation's area, 30-100% of its original box's), `_neg_labels` (up to
    8 classes absent from the image) and `_nel_labels` (up to 2 of its
    classes), each sorted; `gt_masks` stay those of the batch. No source in
    the repository gives LVIS's counts of negative and not-exhaustive labels
    an image or its areas against boxes: these three are not LVIS's."""
    rng = None if num_classes is None else np.random.default_rng(seed)
    items = []
    for i in range(len(batch["images"])):
        item = {k: v[i] for k, v in batch.items()}
        valid = item["gt_valid"]
        labels = item["gt_labels"][valid]
        if rng is not None:
            item["scale"] = np.float32(rng.uniform(0.5, 1.5))
        item["_gt_boxes_full"] = item["gt_boxes"][valid] / item["scale"]
        item["_gt_labels_full"] = labels
        item["_gt_ignore_full"] = np.zeros(int(valid.sum()), bool)
        if rng is not None:
            b = item["_gt_boxes_full"].astype(np.float64)
            area = (b[:, 2] - b[:, 0]) * (b[:, 3] - b[:, 1])
            item["_gt_areas_full"] = area * rng.uniform(0.3, 1.0, len(b))
            absent = np.setdiff1d(np.arange(num_classes), labels)
            neg = rng.choice(absent, size=min(8, len(absent)), replace=False)
            item["_neg_labels"] = sorted(int(c) for c in neg)
            present = np.unique(labels)
            nel = rng.choice(present, size=min(2, len(present)), replace=False)
            item["_nel_labels"] = sorted(int(c) for c in nel)
        items.append(item)
    return items


def synthetic_nms_case(
    kind: str, b: int, n: int, seed: int, classes: int = 65, side: int = 640
) -> tuple[torch.Tensor, torch.Tensor]:
    """Score-ordered boxes [b, n, 4] and validity [b, n] of one kind, on the
    CPU, in the ``side`` x ``side`` frame of a preset (640: `ov_coco_vitb16`,
    896: the L/14 presets).

    'anchors': RPN anchors of the stride-16 level decoded with small deltas
    and clipped, so neighbours overlap densely around the RPN's IoU 0.7;
    'plain': boxes spread over the image; 'class_offset': those shifted by
    label x span, as `multiclass_nms` shifts its ``classes`` classes apart
    (65 for OV-COCO, 1203 for OV-LVIS: offsets up to ~1.08e6 at 896, where a
    float32 ULP is 0.125); 'invalid_tail' / 'invalid_any' / 'none_valid':
    anchors or spread boxes with invalid slots; 'identical', 'duplicates'
    (every box twice), 'zero_area' (every third box degenerate): ties and
    empty boxes."""
    gen = torch.Generator().manual_seed(seed)
    valid = torch.ones(b, n, dtype=torch.bool)
    f = side / 640
    if kind in ("anchors", "invalid_tail"):
        grid = side // 16
        anchors = torch.from_numpy(grid_anchors(grid, grid, 16, (8.0,), (0.5, 1.0, 2.0)))
        pick = torch.stack([torch.randperm(len(anchors), generator=gen)[:n] for _ in range(b)])
        deltas = torch.randn(b, n, 4, generator=gen) * 0.1
        boxes = decode_boxes(anchors[pick], deltas, max_shape=(side, side))
    else:
        lo = torch.rand(b, n, 2, generator=gen) * (500 * f)
        boxes = torch.cat([lo, lo + 8 * f + torch.rand(b, n, 2, generator=gen) * (190 * f)], -1)
    if kind == "class_offset":
        label = torch.randint(0, classes, (b, n, 1), generator=gen).float()
        boxes = boxes + label * (boxes.amax(dim=(1, 2), keepdim=True) + 1.0)
    elif kind == "invalid_tail":
        valid[:, n - n // 5:] = False
    elif kind == "invalid_any":
        valid = torch.rand(b, n, generator=gen) < 0.7
    elif kind == "none_valid":
        valid[:] = False
    elif kind == "identical":
        boxes = boxes[:, :1].expand(b, n, 4).contiguous()
    elif kind == "zero_area":
        boxes[:, ::3, 2:] = boxes[:, ::3, :2]
    elif kind == "duplicates":
        boxes = boxes[:, : (n + 1) // 2].repeat_interleave(2, dim=1)[:, :n].contiguous()
    elif kind not in ("plain", "anchors"):
        raise ValueError(f"unknown kind {kind!r}")
    return boxes, valid
