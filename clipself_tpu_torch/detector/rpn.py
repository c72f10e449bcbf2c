"""Region proposal network: head module, targets and loss, proposal decoding.

A port of `clipself_tpu/detector/rpn.py` (mmdet `RPNHead`): a small conv
tower shared across levels, per-anchor sigmoid objectness + box deltas, BCE
+ L1 on 256 randomly sampled anchors an image, and top-k -> decode -> NMS
proposal generation, batched over images.
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from clipself_tpu_torch.detector.anchors import multi_level_anchors
from clipself_tpu_torch.detector.boxes import decode_boxes, encode_boxes
from clipself_tpu_torch.detector.config import AnchorCfg, FViTConfig
from clipself_tpu_torch.detector.layers import Conv2d, ConvNorm
from clipself_tpu_torch.detector.nms import nms, sorted_desc, take
from clipself_tpu_torch.detector.targets import assign_max_iou, random_sample
from clipself_tpu_torch.parallel.mesh import group_sum


class RPNHead(nn.Module):
    """Shared conv tower + objectness / delta 1x1 heads, applied per level.
    mmdet RPNHead convs are norm-free by default."""

    def __init__(self, num_anchors: int, feat_channels: int = 256, num_convs: int = 2,
                 norm: str = "none"):
        super().__init__()
        self.num_convs = num_convs
        for i in range(num_convs):
            setattr(
                self, f"conv_{i}",
                ConvNorm(feat_channels, feat_channels, kernel=3, norm=norm, act=True),
            )
        self.cls = Conv2d(feat_channels, num_anchors, 1)
        self.reg = Conv2d(feat_channels, num_anchors * 4, 1)

    def forward(
        self, feats: Sequence[torch.Tensor]
    ) -> tuple[list[torch.Tensor], list[torch.Tensor]]:
        scores, deltas = [], []
        for x in feats:
            for i in range(self.num_convs):
                x = getattr(self, f"conv_{i}")(x)
            scores.append(self.cls(x))
            deltas.append(self.reg(x))
        return scores, deltas


class RPNOut(NamedTuple):
    scores: torch.Tensor  # [B, N] objectness logits over all levels' anchors
    deltas: torch.Tensor  # [B, N, 4]
    anchors: torch.Tensor  # [N, 4] float32 (shared across the batch)


@functools.lru_cache(maxsize=16)
def _anchors(feat_shapes: tuple, anchors: AnchorCfg, device: torch.device) -> torch.Tensor:
    per_level = multi_level_anchors(
        list(feat_shapes), anchors.strides[: len(feat_shapes)], anchors.scales, anchors.ratios,
        anchors.center_offset,
    )
    return torch.from_numpy(np.concatenate(per_level, axis=0)).to(device)


def num_anchors(cfg: FViTConfig) -> int:
    """Anchors over all levels for square ``cfg.image_size`` images: the
    pyramid makes 4x, 2x, 1x and 1/2x (floor, a 2x2 max pool) of the patch
    grid, and each extra FPN level subsamples the last one by 2 (ceil)."""
    g = cfg.image_size // cfg.patch_size
    sides = [4 * g, 2 * g, g, g // 2]
    while len(sides) < cfg.num_fpn_outs:
        sides.append(-(-sides[-1] // 2))
    per_cell = len(cfg.anchors.scales) * len(cfg.anchors.ratios)
    return per_cell * sum(s * s for s in sides[: cfg.num_fpn_outs])


def flatten_rpn_outputs(
    score_maps: Sequence[torch.Tensor],
    delta_maps: Sequence[torch.Tensor],
    cfg: FViTConfig,
) -> RPNOut:
    """Concatenate per-level map outputs [B, h, w, A(*4)] into flat
    per-anchor tensors, with the matching anchors."""
    feat_shapes = tuple(tuple(s.shape[1:3]) for s in score_maps)
    b = score_maps[0].shape[0]
    scores = torch.cat([s.reshape(b, -1) for s in score_maps], dim=1)
    deltas = torch.cat([d.reshape(b, -1, 4) for d in delta_maps], dim=1)
    return RPNOut(scores, deltas, _anchors(feat_shapes, cfg.anchors, scores.device))


def rpn_loss(
    rpn: RPNOut,
    gt_boxes: torch.Tensor,
    gt_valid: torch.Tensor,
    pos_noise: torch.Tensor,
    neg_noise: torch.Tensor,
    cfg: FViTConfig,
    group=None,
) -> tuple[torch.Tensor, dict]:
    """BCE objectness + L1 box loss on sampled anchors (mmdet RPNHead.loss),
    in float32: a mean over the images of each image's mean over its
    sampled anchors.

    gt_boxes: [B, G, 4]; gt_valid: [B, G] bool; pos_noise, neg_noise: [B, N]
    uniform draws of the anchor sampler (`targets.random_sample`). With
    ``group`` (the data-parallel ranks of a mesh, each holding some images
    of the global batch) the mean is over the group's images: this rank's
    share of it, which the group sums to the global batch's loss.
    """
    a = assign_max_iou(
        rpn.anchors, gt_boxes, gt_valid,
        cfg.rpn_assign.pos_iou_thr, cfg.rpn_assign.neg_iou_thr,
        cfg.rpn_assign.min_pos_iou, cfg.rpn_assign.match_low_quality,
    )
    s = random_sample(a, cfg.rpn_sample.num, cfg.rpn_sample.pos_fraction, pos_noise, neg_noise)
    chosen = s.pos_mask | s.neg_mask
    # BCE with logits over the sampled anchors, averaged over the sample budget
    ce = F.binary_cross_entropy_with_logits(
        rpn.scores.float(), s.pos_mask.float(), reduction="none"
    )
    n_sampled = torch.clamp(chosen.sum(dim=-1), min=1).float()
    loss_cls = (ce * chosen).sum(dim=-1) / n_sampled
    # L1 on positive anchors against the encoded gt deltas
    tgt = encode_boxes(rpn.anchors, take(gt_boxes, a.gt_idx))
    l1 = (rpn.deltas.float() - tgt).abs().sum(dim=-1)
    loss_box = (l1 * s.pos_mask).sum(dim=-1) / n_sampled
    if group is None:
        image_mean = torch.mean
    else:
        images = group_sum(loss_cls.new_tensor(float(loss_cls.shape[0])), group)

        def image_mean(x):
            return x.sum() / images

    metrics = {
        "rpn_loss_cls": image_mean(loss_cls),
        "rpn_loss_bbox": image_mean(loss_box),
        "rpn_num_pos": image_mean(s.num_pos.float()),
    }
    return metrics["rpn_loss_cls"] + metrics["rpn_loss_bbox"], metrics


def rpn_proposals(
    rpn: RPNOut,
    image_hw: tuple[int, int],
    nms_pre: int,
    max_per_img: int,
    iou_threshold: float,
    min_bbox_size: float = 0.0,
    valid_hw: torch.Tensor | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Decode + NMS proposals for every image.

    valid_hw: optional [B, 2] per-image pre-padding (h, w); proposals are
    clipped to it (mmdet clips to `img_shape`, not the padded batch square).
    Returns (boxes [B, P, 4], scores [B, P]); empty slots have score NEG_INF.
    """
    b, n = rpn.scores.shape
    if valid_hw is None:
        valid_hw = torch.tensor(image_hw, dtype=torch.float32, device=rpn.scores.device).expand(b, 2)
    top_s, top_i = sorted_desc(rpn.scores, min(nms_pre, n))
    boxes = decode_boxes(rpn.anchors[top_i], take(rpn.deltas, top_i), max_shape=image_hw)
    lim = valid_hw[:, [1, 0, 1, 0]].to(boxes.dtype)  # x, y, x, y
    boxes = torch.minimum(boxes, lim[:, None, :])
    wh = boxes[..., 2:] - boxes[..., :2]
    ok = (wh[..., 0] > min_bbox_size) & (wh[..., 1] > min_bbox_size)
    out_boxes, out_scores, _ = nms(
        boxes, torch.sigmoid(top_s), iou_threshold, max_per_img, valid=ok
    )
    return out_boxes, out_scores
