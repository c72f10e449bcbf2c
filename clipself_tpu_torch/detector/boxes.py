"""Box geometry primitives: IoU, delta coding, clipping.

A port of `clipself_tpu/detector/boxes.py` (mmdet `DeltaXYWHBBoxCoder` and
`bbox_overlaps` semantics) as plain functions on tensors. All boxes are xyxy.
"""

from __future__ import annotations

import math

import torch

# mmdet clamps dw/dh so exp() cannot overflow (wh_ratio_clip=16/1000)
_MAX_RATIO = abs(math.log(16.0 / 1000.0))


def box_area(boxes: torch.Tensor) -> torch.Tensor:
    """Area of xyxy boxes [..., 4] -> [...]."""
    w = torch.clamp(boxes[..., 2] - boxes[..., 0], min=0.0)
    h = torch.clamp(boxes[..., 3] - boxes[..., 1], min=0.0)
    return w * h


def _pair_inter(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Intersection areas [..., N, M] of a [..., N, 4] and b [..., M, 4]
    (leading dimensions broadcast), one coordinate at a time: the same
    operations as the stacked (x, y) form, without its [..., N, M, 2] pairs."""
    a, b = a[..., :, None, :], b[..., None, :, :]
    w = torch.clamp(torch.minimum(a[..., 2], b[..., 2]) - torch.maximum(a[..., 0], b[..., 0]), min=0.0)
    h = torch.clamp(torch.minimum(a[..., 3], b[..., 3]) - torch.maximum(a[..., 1], b[..., 1]), min=0.0)
    return w * h


def box_iou(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Pairwise IoU. a: [..., N, 4], b: [..., M, 4] -> [..., N, M]."""
    inter = _pair_inter(a, b)
    union = box_area(a)[..., :, None] + box_area(b)[..., None, :] - inter
    return inter / torch.clamp(union, min=1e-6)


def box_iof(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Intersection over the area of `a` (mmdet mode='iof').
    [..., N, 4], [..., M, 4] -> [..., N, M]."""
    return _pair_inter(a, b) / torch.clamp(box_area(a)[..., :, None], min=1e-6)


def _row(values, like: torch.Tensor) -> torch.Tensor:
    return torch.as_tensor(values, dtype=like.dtype, device=like.device)


def encode_boxes(
    src: torch.Tensor,
    dst: torch.Tensor,
    means=(0.0, 0.0, 0.0, 0.0),
    stds=(1.0, 1.0, 1.0, 1.0),
) -> torch.Tensor:
    """Deltas (dx, dy, dw, dh) taking `src` (anchors/rois) to `dst` (gt)."""
    sw = src[..., 2] - src[..., 0]
    sh = src[..., 3] - src[..., 1]
    sx = (src[..., 0] + src[..., 2]) * 0.5
    sy = (src[..., 1] + src[..., 3]) * 0.5
    dw_ = dst[..., 2] - dst[..., 0]
    dh_ = dst[..., 3] - dst[..., 1]
    dx_ = (dst[..., 0] + dst[..., 2]) * 0.5
    dy_ = (dst[..., 1] + dst[..., 3]) * 0.5
    sw = torch.clamp(sw, min=1e-6)
    sh = torch.clamp(sh, min=1e-6)
    dx = (dx_ - sx) / sw
    dy = (dy_ - sy) / sh
    dw = torch.log(torch.clamp(dw_, min=1e-6) / sw)
    dh = torch.log(torch.clamp(dh_, min=1e-6) / sh)
    deltas = torch.stack([dx, dy, dw, dh], dim=-1)
    return (deltas - _row(means, deltas)) / _row(stds, deltas)


def decode_boxes(
    src: torch.Tensor,
    deltas: torch.Tensor,
    means=(0.0, 0.0, 0.0, 0.0),
    stds=(1.0, 1.0, 1.0, 1.0),
    max_shape=None,
) -> torch.Tensor:
    """Apply deltas to `src` boxes; optionally clip to (h, w)."""
    d = deltas * _row(stds, deltas) + _row(means, deltas)
    dx, dy = d[..., 0], d[..., 1]
    dw = torch.clamp(d[..., 2], -_MAX_RATIO, _MAX_RATIO)
    dh = torch.clamp(d[..., 3], -_MAX_RATIO, _MAX_RATIO)
    sw = src[..., 2] - src[..., 0]
    sh = src[..., 3] - src[..., 1]
    sx = (src[..., 0] + src[..., 2]) * 0.5
    sy = (src[..., 1] + src[..., 3]) * 0.5
    cx = sx + dx * sw
    cy = sy + dy * sh
    w = sw * torch.exp(dw)
    h = sh * torch.exp(dh)
    out = torch.stack([cx - w * 0.5, cy - h * 0.5, cx + w * 0.5, cy + h * 0.5], dim=-1)
    if max_shape is not None:
        out = clip_boxes(out, max_shape)
    return out


def clip_boxes(boxes: torch.Tensor, max_shape) -> torch.Tensor:
    """Clip xyxy boxes to an (h, w) image."""
    h, w = max_shape
    x = torch.clamp(boxes[..., 0::2], 0.0, float(w))
    y = torch.clamp(boxes[..., 1::2], 0.0, float(h))
    return torch.stack([x[..., 0], y[..., 0], x[..., 1], y[..., 1]], dim=-1)
