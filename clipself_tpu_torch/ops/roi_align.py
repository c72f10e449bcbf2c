"""Aligned RoI-align over dense feature maps, as separable weights.

A port of `clipself_tpu/ops/roi_align.py` (`_bin_axis_weights`,
`roi_align_weights`, `roi_align_1x1`, `roi_align_nxn`,
`roi_align_nxn_levels`, `denormalize_boxes`): torchvision
`roi_align(feats, boxes, (oh, ow), 1.0, -1, aligned=True)` sampling written
as per-box weights over each axis of the grid, followed by matmuls: one for
the 1x1 output, a y-stage and an x-stage for an NxN output.
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


def _inter_dtype(feats: torch.Tensor) -> torch.dtype:
    """The y-stage intermediate [.., M, oh, W, C] is the memory hot spot of
    the detector heads: a bfloat16 map keeps it in bfloat16 (the products
    still accumulate in float32), anything else runs in float32."""
    return torch.bfloat16 if feats.dtype == torch.bfloat16 else torch.float32


def _two_stage(wy: torch.Tensor, wx: torch.Tensor, feats: torch.Tensor) -> torch.Tensor:
    """out[b,m,y,x,c] = sum_h sum_w wy[b,m,y,h] wx[b,m,x,w] feats[b,h,w,c],
    rows first. wy [B, M, oh, H], wx [B, M, ow, W], feats [B, H, W, C], all of
    one dtype -> float32 [B, M, oh, ow, C]."""
    b, h, w, c = feats.shape
    m, oh = wy.shape[1], wy.shape[2]
    t1 = torch.bmm(wy.reshape(b, m * oh, h), feats.reshape(b, h, w * c))
    t1 = t1.reshape(b, m, oh, w, c)
    # the x-stage as a matmul batched over (b, m, y): wx is shared by the oh
    # rows, t1 is read where it lies
    return torch.matmul(wx[:, :, None], t1).float()


def roi_align_nxn(
    feats: torch.Tensor, boxes: torch.Tensor, output_size: tuple[int, int]
) -> torch.Tensor:
    """Batched aligned RoI-align with an output grid (torchvision semantics,
    sampling_ratio=-1, aligned=True). feats [B, H, W, C]; boxes [B, M, 4] xyxy
    in feature coordinates -> [B, M, oh, ow, C] in feats' dtype."""
    b, h, w, c = feats.shape
    m = boxes.shape[1]
    oh, ow = output_size
    max_sy = max(-(-h // oh), 1) + 1
    max_sx = max(-(-w // ow), 1) + 1
    dt = _inter_dtype(feats)
    fb = boxes.reshape(b * m, 4).float()
    x0, y0, x1, y1 = (fb[:, j] - 0.5 for j in range(4))
    wy, ny = _bin_axis_weights(y0, y1 - y0, h, oh, max_sy)  # [B*M, oh, H]
    wx, nx = _bin_axis_weights(x0, x1 - x0, w, ow, max_sx)  # [B*M, ow, W]
    count = torch.clamp(ny * nx, min=1.0)
    out = _two_stage(
        wy.reshape(b, m, oh, h).to(dt), wx.reshape(b, m, ow, w).to(dt), feats.to(dt)
    )
    return (out / count.reshape(b, m, 1, 1, 1)).to(feats.dtype)


def roi_align_nxn_levels(
    feats,
    boxes: torch.Tensor,
    lvl: torch.Tensor,
    strides,
    output_size: tuple[int, int],
) -> torch.Tensor:
    """Multi-level aligned RoI-align over a row-concatenated pyramid.

    Per roi the same as ``roi_align_nxn(feats[l], boxes / strides[l],
    output_size)`` for its level ``l = lvl``, but as ONE two-stage
    contraction: the levels are concatenated along the row axis (columns
    zero-padded to the widest level) and each roi's axis weights are placed
    at its level's row offset, zero elsewhere, so the [M, oh, W, C] y-stage
    intermediate exists once, at the finest level's width. Zero weights
    contribute exact zeros: the result differs from the per-level path only
    by float32 accumulation order.

    feats: list of [B, H_l, W_l, C] maps, finest first; boxes [B, M, 4] xyxy
    in IMAGE coordinates; lvl [B, M] int level of each roi; strides: the
    per-level image-to-feature divisors. Returns [B, M, oh, ow, C], each roi
    divided by its own sample count.
    """
    b, m = boxes.shape[:2]
    oh, ow = output_size
    w_max = max(int(f.shape[2]) for f in feats)
    h_tot = sum(int(f.shape[1]) for f in feats)
    pad = torch.nn.functional.pad
    fcat = torch.cat([pad(f, (0, 0, 0, w_max - int(f.shape[2]))) for f in feats], dim=1)
    dt = _inter_dtype(fcat)

    fb = boxes.reshape(b * m, 4).float()
    fl = lvl.reshape(b * m)
    wy_parts, wx_sum = [], None
    count = torch.ones(b * m, dtype=torch.float32, device=boxes.device)
    for i, f in enumerate(feats):
        hl, wl = int(f.shape[1]), int(f.shape[2])
        bx = fb / float(strides[i])
        x0, y0, x1, y1 = (bx[:, j] - 0.5 for j in range(4))
        max_sy = max(-(-hl // oh), 1) + 1
        max_sx = max(-(-wl // ow), 1) + 1
        wy, ny = _bin_axis_weights(y0, y1 - y0, hl, oh, max_sy)  # [N, oh, hl]
        wx, nx = _bin_axis_weights(x0, x1 - x0, wl, ow, max_sx)  # [N, ow, wl]
        sel = fl == i
        count = torch.where(sel, torch.clamp(ny * nx, min=1.0), count)
        selw = sel.float()[:, None, None]
        wy_parts.append(wy * selw)
        wxp = pad(wx * selw, (0, w_max - wl))
        wx_sum = wxp if wx_sum is None else wx_sum + wxp
    wy_cat = torch.cat(wy_parts, dim=-1).reshape(b, m, oh, h_tot).to(dt)
    wx_cat = wx_sum.reshape(b, m, ow, w_max).to(dt)
    out = _two_stage(wy_cat, wx_cat, fcat.to(dt))
    return (out / count.reshape(b, m, 1, 1, 1)).to(feats[0].dtype)


def denormalize_boxes(normed_boxes: torch.Tensor, feat_h: int, feat_w: int) -> torch.Tensor:
    """Scale [0, 1]-normalized xyxy boxes to feature-map coordinates."""
    scale = torch.tensor(
        [feat_w, feat_h, feat_w, feat_h], dtype=torch.float32, device=normed_boxes.device
    )
    return normed_boxes.float() * scale
