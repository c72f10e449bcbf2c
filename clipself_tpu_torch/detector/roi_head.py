"""RoI head: multi-level RoI-align, open-vocabulary bbox head, mask head.

A port of `clipself_tpu/detector/roi_head.py`
(behavioural spec: the reference `F-ViT/models/fvit_head.py`):
  - rois map to FPN levels by
    level = clamp(floor(log2(sqrt(area) / finest_scale + 1e-6)), 0, 3)
    and are pooled 7x7 with aligned RoIAlign;
  - FViTBBoxHead: shared convs + shared fcs, one cls fc / one reg fc;
    classification = L2-normalized cls feature times a fixed text-embedding
    matrix (all classes + background) scaled by a learned temperature;
    class-agnostic box deltas;
  - test-time fusion: softmax detector scores and softmax VLM scores (1x1
    RoI-aligned dense CLIP map against the same embeddings, fixed
    temperature) are geometrically mixed with exponent alpha on base classes
    and beta on novel classes.

Training assigns and samples the proposals (gts appended) into a fixed
budget of rois (`sample_rois`) and scores them with the weighted softmax CE
and the L1 box loss. Pooling runs as one contraction over the
row-concatenated pyramid (`ops/roi_align.py::roi_align_nxn_levels`), the JAX
package's default.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from clipself_tpu_torch.detector.boxes import box_area, decode_boxes, encode_boxes
from clipself_tpu_torch.detector.config import FViTConfig
from clipself_tpu_torch.detector.layers import ConvNorm, Deconv2x2
from clipself_tpu_torch.detector.nms import is_live, multiclass_nms, sorted_desc, take
from clipself_tpu_torch.detector.targets import assign_max_iou, random_sample
from clipself_tpu_torch.models.eva_vit import Dense
from clipself_tpu_torch.ops.roi_align import roi_align_nxn_levels
from clipself_tpu_torch.parallel.mesh import group_sum


def roi_levels(rois: torch.Tensor, num_levels: int, finest_scale: float = 56.0) -> torch.Tensor:
    """Pyramid level of each roi [..., 4] (mmdet SingleRoIExtractor)."""
    scale = torch.sqrt(torch.clamp(box_area(rois), min=1e-6))
    lvl = torch.floor(torch.log2(scale / finest_scale + 1e-6))
    return torch.clamp(lvl, 0, num_levels - 1).to(torch.int64)


def multilevel_roi_align(
    feats: Sequence[torch.Tensor],
    rois: torch.Tensor,
    strides: Sequence[float],
    out_size: int,
    finest_scale: float = 56.0,
) -> torch.Tensor:
    """Pool [B, P, 4] image-space rois from the matching pyramid level.
    Returns [B, P, out, out, C]."""
    lvl = roi_levels(rois, len(feats), finest_scale)
    return roi_align_nxn_levels(feats, rois, lvl, strides, (out_size, out_size))


def _unit_rows(x: torch.Tensor) -> torch.Tensor:
    """Rows of x over their float32 L2 norm (+ 1e-12)."""
    norm = torch.linalg.vector_norm(x.float(), dim=-1, keepdim=True) + 1e-12
    return x / norm.to(x.dtype)


class FViTBBoxHead(nn.Module):
    """ConvFC bbox head with text-embedding classification."""

    def __init__(self, cfg: FViTConfig):
        super().__init__()
        c = self.cfg = cfg
        for i in range(c.num_shared_convs):
            setattr(
                self, f"shared_conv_{i}",
                ConvNorm(c.fpn_channels, c.fpn_channels, kernel=3, norm=c.norm, act=True),
            )
        width = c.roi_feat_size * c.roi_feat_size * c.fpn_channels
        for i in range(c.num_shared_fcs):
            setattr(self, f"shared_fc_{i}", Dense(width, c.fc_out_channels))
            width = c.fc_out_channels
        heads = {}
        for branch, count in (("cls", c.num_cls_fcs), ("reg", c.num_reg_fcs)):
            heads[branch] = width
            for i in range(count):
                setattr(self, f"{branch}_fc_{i}", Dense(heads[branch], c.fc_out_channels))
                heads[branch] = c.fc_out_channels
        # the cls feature must live in the CLIP joint space to dot with text rows
        self.cls_proj = Dense(heads["cls"], c.embed_dim)
        self.fc_reg = Dense(heads["reg"], 4)
        self.temperature = nn.Parameter(torch.tensor(float(c.learned_temperature)))

    def forward(self, x: torch.Tensor, class_embed: torch.Tensor):
        """x: [R, S, S, C] pooled rois; class_embed: [K+1, D] L2-normalized
        rows (all classes + background last).

        Returns (cls_logits [R, K+1] float32, deltas [R, 4] float32,
        cls_feat [R, D] unit rows)."""
        c = self.cfg
        for i in range(c.num_shared_convs):
            x = getattr(self, f"shared_conv_{i}")(x)
        x = x.reshape(x.shape[0], -1)  # (y, x, channel), channels fastest
        for i in range(c.num_shared_fcs):
            x = F.relu(getattr(self, f"shared_fc_{i}")(x))
        x_cls = x_reg = x
        for i in range(c.num_cls_fcs):
            x_cls = F.relu(getattr(self, f"cls_fc_{i}")(x_cls))
        for i in range(c.num_reg_fcs):
            x_reg = F.relu(getattr(self, f"reg_fc_{i}")(x_reg))
        normed = _unit_rows(self.cls_proj(x_cls))
        logits = (normed.float() @ class_embed.float().T) * self.temperature
        deltas = self.fc_reg(x_reg)
        return logits, deltas.float(), normed


class _ClassConv1x1(nn.Module):
    """The mask head's final per-class 1x1 conv, with an exact label-gather
    path: logits[n,y,x,k] = x[n,y,x,:] @ W[k,:] + b[k], so when each roi n
    only ever consumes its own class channel k = labels[n], gathering
    W[labels] first computes the same values without the
    [N, H, W, num_classes] tensor (tens of GB at LVIS's 1203 classes). The
    parameters keep a 1x1 convolution's layout (weight [K, C, 1, 1])."""

    def __init__(self, in_features: int, features: int):
        super().__init__()
        self.weight = nn.Parameter(torch.zeros(features, in_features, 1, 1))
        self.bias = nn.Parameter(torch.zeros(features))

    def forward(self, x: torch.Tensor, labels: Optional[torch.Tensor] = None) -> torch.Tensor:
        w = self.weight[:, :, 0, 0].to(x.dtype)  # [K, C]
        if labels is None:
            return torch.einsum("nyxc,kc->nyxk", x, w) + self.bias.to(x.dtype)
        wsel = w[labels]  # [N, C]
        bsel = self.bias[labels].to(x.dtype)  # [N]
        return torch.einsum("nyxc,nc->nyx", x, wsel) + bsel[:, None, None]


class MaskHead(nn.Module):
    """FCN mask head (mmdet FCNMaskHead semantics): convs, 2x deconv,
    per-class 1x1 mask logits.

    `labels` (optional, [N]): return only each roi's own class channel
    [N, H, W] via the exact weight-gather of `_ClassConv1x1` instead of the
    full [N, H, W, num_classes] map."""

    def __init__(self, cfg: FViTConfig):
        super().__init__()
        c = self.cfg = cfg
        width = c.fpn_channels
        for i in range(c.mask_convs):
            setattr(self, f"conv_{i}", ConvNorm(width, c.mask_channels, kernel=3, norm=c.norm, act=True))
            width = c.mask_channels
        self.upsample = Deconv2x2(width, c.mask_channels)
        self.logits = _ClassConv1x1(c.mask_channels, c.num_classes)

    def forward(self, x: torch.Tensor, labels: Optional[torch.Tensor] = None) -> torch.Tensor:
        for i in range(self.cfg.mask_convs):
            x = getattr(self, f"conv_{i}")(x)
        return self.logits(F.relu(self.upsample(x)), labels)


class RoITargets(NamedTuple):
    rois: torch.Tensor  # [B, R, 4] sampled proposals (image space)
    labels: torch.Tensor  # [B, R] class (num_classes = background)
    chosen: torch.Tensor  # [B, R] bool: sampled (contributes to the cls loss)
    pos: torch.Tensor  # [B, R] bool: positive (contributes to the reg loss)
    reg_targets: torch.Tensor  # [B, R, 4]
    gt_idx: torch.Tensor  # [B, R] assigned gt index (for the mask targets)


def sample_rois(
    proposals: torch.Tensor,
    proposal_scores: torch.Tensor,
    gt_boxes: torch.Tensor,
    gt_labels: torch.Tensor,
    gt_valid: torch.Tensor,
    pos_noise: torch.Tensor,
    neg_noise: torch.Tensor,
    gather_noise: torch.Tensor,
    cfg: FViTConfig,
) -> RoITargets:
    """Assign + sample proposals for the RCNN stage (train cfg
    `configs/ov_coco/...:110-126`; gt boxes are appended as proposals).

    proposals [B, P, 4], proposal_scores [B, P] (NEG_INF = empty slot);
    gt_boxes [B, G, 4], gt_labels [B, G], gt_valid [B, G]; the three noises
    [B, P + G]: the sampler's positives and negatives, then the draw that
    orders the fixed-budget gather."""
    boxes = torch.cat([proposals.float(), gt_boxes.float()], dim=1)
    # SampleCfg.add_gt_as_proposals (mmdet RandomSampler knob): when off, the
    # gt rows stay in the tensor (static shapes) but are invalidated
    gt_rows = gt_valid if cfg.rcnn_sample.add_gt_as_proposals else torch.zeros_like(gt_valid)
    valid_rows = torch.cat([is_live(proposal_scores), gt_rows], dim=1)
    a = assign_max_iou(
        boxes, gt_boxes, gt_valid,
        cfg.rcnn_assign.pos_iou_thr, cfg.rcnn_assign.neg_iou_thr,
        cfg.rcnn_assign.min_pos_iou, cfg.rcnn_assign.match_low_quality,
    )
    a = a._replace(pos=a.pos & valid_rows, neg=a.neg & valid_rows)
    s = random_sample(a, cfg.rcnn_sample.num, cfg.rcnn_sample.pos_fraction, pos_noise, neg_noise)
    labels = torch.where(s.pos_mask, torch.gather(gt_labels.long(), 1, a.gt_idx), cfg.num_classes)
    tgt = encode_boxes(boxes, take(gt_boxes, a.gt_idx), stds=cfg.bbox_stds)
    chosen = s.pos_mask | s.neg_mask
    # fixed-budget gather: the RoI head sees only the sampled `num` rois, not
    # all proposals + gts (the budget is static, so the shapes stay static)
    prio = chosen.float() * 2.0 + s.pos_mask.float()
    prio = prio + gather_noise * 0.5
    _, sel = sorted_desc(prio, cfg.rcnn_sample.num)
    return RoITargets(
        rois=take(boxes, sel),
        labels=torch.gather(labels, 1, sel),
        chosen=torch.gather(chosen, 1, sel),
        pos=torch.gather(s.pos_mask, 1, sel),
        reg_targets=take(tgt, sel),
        gt_idx=torch.gather(a.gt_idx, 1, sel),
    )


def rcnn_cls_loss(
    logits: torch.Tensor,
    labels: torch.Tensor,
    chosen: torch.Tensor,
    class_weight: Optional[torch.Tensor],
    group=None,
) -> torch.Tensor:
    """Weighted softmax CE (reference `CustomCrossEntropyLoss`,
    `F-ViT/models/custom_losses.py:62-111`): classes with ~zero weight get
    -inf logits (excluded from the partition function), the loss is scaled by
    the label's class weight, and averaged over the sampled rois.
    logits [R, K+1] float32, labels [R], chosen [R] bool. With ``group``
    (the data-parallel ranks of a mesh) the average is over the group's
    sampled rois, as XLA divides by the sharded batch's count."""
    if class_weight is not None:
        logits = logits.masked_fill(class_weight < 1e-5, float("-inf"))
    logp = torch.log_softmax(logits, dim=-1)
    ll = torch.gather(logp, 1, labels[:, None])[:, 0]
    if class_weight is None:
        ce = -ll
    else:
        w = class_weight[labels]
        # zero-weight labels (novel classes in the batch) have a -inf
        # log-prob after masking: select before the product is used, so
        # neither the loss nor a gradient sees inf * 0
        ce = torch.where(w > 1e-5, -ll * w, 0.0)
    ce = torch.where(chosen, ce, 0.0)
    return ce.sum() / torch.clamp(group_sum(chosen.sum(), group), min=1)


def rcnn_reg_loss(
    deltas: torch.Tensor, targets: torch.Tensor, pos: torch.Tensor, chosen: torch.Tensor,
    group=None,
) -> torch.Tensor:
    """L1 on positive rois, averaged over all sampled rois (mmdet
    BBoxHead.loss avg_factor semantics), of the ``group``'s global batch as
    in `rcnn_cls_loss`."""
    l1 = (deltas.float() - targets).abs().sum(dim=-1)
    return (l1 * pos).sum() / torch.clamp(group_sum(chosen.sum(), group), min=1)


def fuse_vlm_scores(
    cls_logits: torch.Tensor,
    vlm_feats: torch.Tensor,
    class_embed: torch.Tensor,
    base_mask: torch.Tensor,
    cfg: FViTConfig,
) -> torch.Tensor:
    """Geometric score fusion (reference `fvit_head.py:111-119`).

    cls_logits: [..., R, K+1]; vlm_feats: [..., R, D] (1x1 RoI-pooled dense
    CLIP map, already ~normalized); base_mask: [K+1] bool (True = base / seen
    class). Returns fused probabilities [..., R, K+1]."""
    det = torch.softmax(cls_logits, dim=-1)
    v = vlm_feats / (torch.linalg.vector_norm(vlm_feats.float(), dim=-1, keepdim=True) + 1e-12)
    vlm = torch.softmax((v @ class_embed.float().T) * cfg.vlm_temperature, dim=-1)
    exp = torch.where(base_mask, cfg.alpha, cfg.beta).to(det.dtype)
    return det ** (1.0 - exp) * vlm ** exp


def rcnn_detections(
    rois: torch.Tensor,
    fused_scores: torch.Tensor,
    deltas: torch.Tensor,
    image_hw: tuple[int, int],
    cfg: FViTConfig,
    valid_hw: Optional[torch.Tensor] = None,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Decode class-agnostic boxes and run multiclass NMS, for every image.

    rois [B, R, 4]; fused_scores [B, R, K+1] probabilities (background last,
    dropped here); deltas [B, R, 4]. valid_hw: optional [B, 2] pre-padding
    (h, w) of each image: detections are clipped to it.
    Returns (boxes [B, D, 4], scores [B, D], labels [B, D])."""
    boxes = decode_boxes(rois, deltas, stds=cfg.bbox_stds, max_shape=image_hw)
    if valid_hw is not None:
        hi = valid_hw[:, [1, 0, 1, 0]].to(boxes.dtype)
        boxes = torch.minimum(torch.clamp(boxes, min=0.0), hi[:, None, :])
    return multiclass_nms(
        boxes, fused_scores[..., :-1],
        cfg.rcnn_test.score_thr, cfg.rcnn_test.iou_threshold, cfg.rcnn_test.max_per_img,
    )
