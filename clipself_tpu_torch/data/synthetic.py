"""Seeded synthetic panoptic evaluation batches.

Same batch format as `clipself_tpu/data/datasets.py::COCOPanopticEvalDataset`
and the same generator as the JAX package's evaluator bench (`bench.py`):
images [B, H, W, 3], boxes [B, M, 8] (xyxy in [0, 1], label, valid, 0,
is_thing), crops [B, M, crop, crop, 3], gt_masks [B, M, gh, gw]. The first
``valid_anns`` annotation slots of every image are valid; the rest are
padding, as in real panoptic items (COCO val averages ~13 segments against
the 100-slot pad). All arrays are float32 NumPy.
"""

from __future__ import annotations

import numpy as np


def synthetic_panoptic_batch(
    index: int,
    *,
    batch: int,
    image_size: int,
    max_anns: int,
    valid_anns: int,
    crop_size: int,
    mask_hw: int,
    n_classes: int = 133,
    seed: int = 0,
) -> dict:
    """Batch ``index`` of the stream seeded by ``seed``."""
    b, m = batch, max_anns
    r = np.random.default_rng(seed + index + 1)
    lo = r.uniform(0, 0.5, size=(b, m, 2)).astype(np.float32)
    hi = np.clip(lo + r.uniform(0.05, 0.5, size=(b, m, 2)), 0, 1)
    boxes = np.zeros((b, m, 8), np.float32)
    boxes[..., :4] = np.concatenate([lo, hi], -1)
    boxes[..., 4] = r.integers(0, n_classes, size=(b, m))  # label
    boxes[..., 5] = (np.arange(m) < valid_anns).astype(np.float32)[None, :]  # valid
    boxes[..., 7] = r.integers(0, 2, size=(b, m))  # is_thing
    masks = (r.uniform(size=(b, m, mask_hw, mask_hw)) < 0.2).astype(np.float32)
    return {
        "images": r.standard_normal((b, image_size, image_size, 3)).astype(np.float32),
        "boxes": boxes,
        "crops": r.standard_normal((b, m, crop_size, crop_size, 3)).astype(np.float32),
        "gt_masks": masks,
    }


def class_embeddings(n_classes: int, embed_dim: int, seed: int = 0) -> np.ndarray:
    """Random [n_classes, embed_dim] classifier, as the evaluator bench draws it."""
    return np.random.default_rng(seed).standard_normal((n_classes, embed_dim)).astype(np.float32)
