"""Synthetic detection data: fixed-shape random batches and per-image
evaluation items.

`collate` and `SyntheticDetectionData` are copies of
`clipself_tpu/detector/data.py:324-366` with the same generator calls in the
same order, so the same seed gives the same arrays
(`tests/test_torch_detector_eval.py` pins it). `synthetic_eval_items` cuts
one such batch into the per-image items `evaluate_detector` reads, the
format of the JAX package's `DetectionDataset` at eval time (which needs PIL
and COCO files and is not ported yet, ROADMAP.md queue 1 item 2).
`synthetic_nms_case` makes the score-ordered candidate boxes that the NMS
kernel is checked on (`chip_smoke.py`, `tests/test_torch_kernels_cuda.py`).
"""

from __future__ import annotations

import numpy as np
import torch

from clipself_tpu_torch.detector.anchors import grid_anchors
from clipself_tpu_torch.detector.boxes import decode_boxes


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


def synthetic_eval_items(batch: dict) -> list[dict]:
    """One item per image of a `SyntheticDetectionData.batch`: its batchable
    keys plus the full (unpadded) ground truth in original coordinates under
    `_gt_boxes_full`, `_gt_labels_full`, `_gt_ignore_full` (no crowd
    regions), as `evaluate_detector` reads them."""
    items = []
    for i in range(len(batch["images"])):
        item = {k: v[i] for k, v in batch.items()}
        valid = item["gt_valid"]
        item["_gt_boxes_full"] = item["gt_boxes"][valid] / item["scale"]
        item["_gt_labels_full"] = item["gt_labels"][valid]
        item["_gt_ignore_full"] = np.zeros(int(valid.sum()), bool)
        items.append(item)
    return items


def synthetic_nms_case(kind: str, b: int, n: int, seed: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Score-ordered boxes [b, n, 4] and validity [b, n] of one kind, on the
    CPU, in the 640 x 640 frame of the `ov_coco_vitb16` preset.

    'anchors': RPN anchors of the stride-16 level decoded with small deltas
    and clipped, so neighbours overlap densely around the RPN's IoU 0.7;
    'plain': boxes spread over the image; 'class_offset': those shifted by
    label x span, as `multiclass_nms` shifts its 65 classes apart;
    'invalid_tail' / 'invalid_any' / 'none_valid': anchors or spread boxes
    with invalid slots; 'identical', 'duplicates' (every box twice),
    'zero_area' (every third box degenerate): ties and empty boxes."""
    gen = torch.Generator().manual_seed(seed)
    valid = torch.ones(b, n, dtype=torch.bool)
    if kind in ("anchors", "invalid_tail"):
        anchors = torch.from_numpy(grid_anchors(40, 40, 16, (8.0,), (0.5, 1.0, 2.0)))
        pick = torch.stack([torch.randperm(len(anchors), generator=gen)[:n] for _ in range(b)])
        deltas = torch.randn(b, n, 4, generator=gen) * 0.1
        boxes = decode_boxes(anchors[pick], deltas, max_shape=(640, 640))
    else:
        lo = torch.rand(b, n, 2, generator=gen) * 500
        boxes = torch.cat([lo, lo + 8 + torch.rand(b, n, 2, generator=gen) * 190], -1)
    if kind == "class_offset":
        label = torch.randint(0, 65, (b, n, 1), generator=gen).float()
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
