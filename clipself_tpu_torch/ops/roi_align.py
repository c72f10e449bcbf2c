"""1x1 aligned RoI-align over dense feature maps, as separable weights.

A port of `clipself_tpu/ops/roi_align.py` (`_bin_axis_weights`,
`roi_align_weights`, `roi_align_1x1`, `denormalize_boxes`): torchvision
`roi_align(feats, boxes, (1, 1), 1.0, -1, aligned=True)` sampling written as
per-box weights over the grid, followed by one matmul.
"""

from __future__ import annotations

import torch


def _bin_axis_weights(
    lo: torch.Tensor, length: torch.Tensor, size: int, out_bins: int, max_samples: int
) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-bin accumulated bilinear weights along one axis:
    (weights [N, out_bins, size], samples_per_bin [N]). Sample count per bin
    = ceil(bin_extent) (0 for degenerate rois); sample position
    ``lo + bin*bin_extent + (i + 0.5) * bin_extent / grid``; samples outside
    [-1, size] contribute nothing; the high index clamps at the edge."""
    dev = lo.device
    bin_ext = length / out_bins
    grid = torch.ceil(bin_ext)
    num = torch.clamp(grid, 0.0, float(max_samples))
    i = torch.arange(max_samples, dtype=lo.dtype, device=dev)
    bins = torch.arange(out_bins, dtype=lo.dtype, device=dev)
    denom = torch.clamp(grid, min=1.0)
    pos = (
        lo[:, None, None]
        + bins[None, :, None] * bin_ext[:, None, None]
        + (i[None, None, :] + 0.5) * (bin_ext / denom)[:, None, None]
    )
    sample_mask = i[None, None, :] < num[:, None, None]

    outside = (pos < -1.0) | (pos > float(size))
    p = torch.clamp(pos, min=0.0)
    p_low = torch.floor(p)
    at_edge = p_low >= float(size - 1)
    p_low = torch.where(at_edge, torch.full_like(p_low, float(size - 1)), p_low)
    frac = torch.where(at_edge, torch.zeros_like(p), p - p_low)
    idx_low = p_low.to(torch.int64)
    idx_high = torch.clamp(idx_low + 1, max=size - 1)

    valid = (sample_mask & ~outside).to(lo.dtype)
    w_low = (1.0 - frac) * valid
    w_high = frac * valid

    grid_ids = torch.arange(size, device=dev)
    onehot_low = (idx_low[..., None] == grid_ids).to(lo.dtype)
    onehot_high = (idx_high[..., None] == grid_ids).to(lo.dtype)
    weights = torch.einsum("nos,nosg->nog", w_low, onehot_low) + torch.einsum(
        "nos,nosg->nog", w_high, onehot_high
    )
    return weights, num


def roi_align_weights(boxes: torch.Tensor, feat_h: int, feat_w: int) -> torch.Tensor:
    """[N, 4] xyxy boxes in feature-map coordinates -> [N, feat_h*feat_w]
    weights; ``w @ feats.reshape(H*W, C)`` is the 1x1 aligned RoI-align."""
    boxes = boxes.float()
    x0 = boxes[:, 0] - 0.5
    y0 = boxes[:, 1] - 0.5
    x1 = boxes[:, 2] - 0.5
    y1 = boxes[:, 3] - 0.5
    wy, ny = _bin_axis_weights(y0, y1 - y0, feat_h, 1, feat_h)
    wx, nx = _bin_axis_weights(x0, x1 - x0, feat_w, 1, feat_w)
    count = torch.clamp(ny * nx, min=1.0)  # torchvision: max(grid_h*grid_w, 1)
    w2d = wy[:, 0, :, None] * wx[:, 0, None, :] / count[:, None, None]
    return w2d.reshape(boxes.shape[0], feat_h * feat_w)


def roi_align_1x1(feats: torch.Tensor, boxes: torch.Tensor) -> torch.Tensor:
    """feats [B, H, W, C]; boxes [B, M, 4] in feature-map coordinates ->
    [B, M, C] pooled features, in feats' dtype."""
    b, h, w, c = feats.shape
    m = boxes.shape[1]
    weights = roi_align_weights(boxes.reshape(b * m, 4), h, w).reshape(b, m, h * w)
    out = torch.bmm(weights, feats.reshape(b, h * w, c).float())
    return out.to(feats.dtype)


def denormalize_boxes(normed_boxes: torch.Tensor, feat_h: int, feat_w: int) -> torch.Tensor:
    """Scale [0, 1]-normalized xyxy boxes to feature-map coordinates."""
    scale = torch.tensor(
        [feat_w, feat_h, feat_w, feat_h], dtype=torch.float32, device=normed_boxes.device
    )
    return normed_boxes.float() * scale
