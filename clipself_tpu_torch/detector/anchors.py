"""Anchor generation for the RPN.

Reproduces mmdet `AnchorGenerator` semantics (reference config:
`F-ViT/configs/ov_coco/...eva_original.py:27-31` — scales=[8],
ratios=[0.5, 1, 2], strides=[4, 8, 16, 32, 64], center_offset=0).

Anchors are static per feature-map shape: plain NumPy arrays, a copy of
`clipself_tpu/detector/anchors.py` that
`tests/test_torch_detector_geometry.py` pins equal to the original.
`detector/rpn.py` caches them per shape and device.
"""

from __future__ import annotations

import numpy as np


def base_anchors(stride: int, scales, ratios, center_offset: float = 0.0) -> np.ndarray:
    """Per-cell anchor templates [A, 4] centered at `center_offset * stride`."""
    scales = np.asarray(scales, np.float32)
    ratios = np.asarray(ratios, np.float32)
    h_ratios = np.sqrt(ratios)
    w_ratios = 1.0 / h_ratios
    # mmdet order: ratios vary fastest within a scale
    ws = (stride * w_ratios[:, None] * scales[None, :]).reshape(-1)
    hs = (stride * h_ratios[:, None] * scales[None, :]).reshape(-1)
    cx = center_offset * stride
    cy = center_offset * stride
    return np.stack([cx - 0.5 * ws, cy - 0.5 * hs, cx + 0.5 * ws, cy + 0.5 * hs], axis=-1)


def grid_anchors(
    feat_h: int, feat_w: int, stride: int, scales, ratios, center_offset: float = 0.0
) -> np.ndarray:
    """All anchors for one level, row-major over cells: [H*W*A, 4]."""
    base = base_anchors(stride, scales, ratios, center_offset)  # [A, 4]
    xs = np.arange(feat_w, dtype=np.float32) * stride
    ys = np.arange(feat_h, dtype=np.float32) * stride
    shift_x, shift_y = np.meshgrid(xs, ys)
    shifts = np.stack(
        [shift_x.ravel(), shift_y.ravel(), shift_x.ravel(), shift_y.ravel()], axis=-1
    )  # [H*W, 4]
    all_anchors = shifts[:, None, :] + base[None, :, :]  # [H*W, A, 4]
    return all_anchors.reshape(-1, 4).astype(np.float32)


def multi_level_anchors(
    feat_shapes: list[tuple[int, int]], strides, scales, ratios, center_offset: float = 0.0
) -> list[np.ndarray]:
    """Anchors for every pyramid level."""
    return [
        grid_anchors(h, w, s, scales, ratios, center_offset)
        for (h, w), s in zip(feat_shapes, strides)
    ]
