"""F-ViT detector assembly: frozen CLIP backbone + detection heads.

A port of `clipself_tpu/detector/fvit.py` (reference architecture
`F-ViT/models/fvit.py`, `F-ViT/models/evaclip_vit.py`): a frozen distilled
EVA-CLIP ViT is tapped at 4 depths, expanded into a feature pyramid, fed
through FPN + RPN + RoI head. Training scores the RPN on sampled anchors and
the RoI head (and the mask head) on rois sampled from the RPN's proposals;
at test time the dense VLM feature map (final block value path) scores each
detection against the class embeddings and is geometrically fused with the
detector scores.

`FViTDetector` holds the head stack only; the backbone is a port `CLIP`
(`backbone_taps`, run without gradients). Module names follow the flax
param tree, so `models/torch_io.py::detector_state_dict_from_jax` maps it
key for key.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from clipself_tpu_torch.detector.config import FViTConfig
from clipself_tpu_torch.detector.layers import Conv2d, Deconv2x2
from clipself_tpu_torch.detector.neck import FPN, SimpleFeaturePyramid
from clipself_tpu_torch.detector.nms import is_live, take
from clipself_tpu_torch.detector.roi_head import (
    FViTBBoxHead,
    MaskHead,
    RoITargets,
    _ClassConv1x1,
    fuse_vlm_scores,
    multilevel_roi_align,
    rcnn_cls_loss,
    rcnn_detections,
    rcnn_reg_loss,
    sample_rois,
)
from clipself_tpu_torch.detector.rpn import RPNHead, flatten_rpn_outputs, rpn_loss, rpn_proposals
from clipself_tpu_torch.detector.targets import SampleNoise
from clipself_tpu_torch.models.eva_vit import Dense, _lecun_normal
from clipself_tpu_torch.ops.roi_align import roi_align_1x1, roi_align_nxn
from clipself_tpu_torch.parallel.mesh import group_sum


class FViTDetector(nn.Module):
    """Detector head stack (pyramid + FPN + RPN + RoI heads). Parameters are
    float32; activations follow the dtype of the taps it is given."""

    def __init__(self, cfg: FViTConfig):
        super().__init__()
        c = self.cfg = cfg
        num_anchors = len(c.anchors.scales) * len(c.anchors.ratios)
        self.pyramid = SimpleFeaturePyramid(c.backbone_width, norm=c.norm)
        self.fpn = FPN(
            c.backbone_width, num_ins=4, out_channels=c.fpn_channels,
            num_outs=c.num_fpn_outs, norm=c.norm,
        )
        self.rpn = RPNHead(num_anchors, feat_channels=c.fpn_channels, num_convs=c.rpn_convs)
        self.bbox_head = FViTBBoxHead(c)
        if c.with_mask:
            self.mask_head = MaskHead(c)

    @torch.no_grad()
    def init_weights(self, generator: torch.Generator) -> None:
        """Draw the initial weights with flax's default distributions:
        lecun-normal (truncated) kernels with fan-in = inputs x kernel area,
        zero biases, unit norm scales, `temperature` = learned_temperature.
        Parameters must lie on the generator's device."""
        for m in self.modules():
            if isinstance(m, (Conv2d, _ClassConv1x1)):
                _lecun_normal(m.weight, m.weight[0].numel(), generator)
            elif isinstance(m, Deconv2x2):  # weight [in, out, 2, 2]
                _lecun_normal(m.weight, m.weight.shape[0] * 4, generator)
            elif isinstance(m, Dense):
                _lecun_normal(m.weight, m.in_features, generator)
            else:
                continue
            if m.bias is not None:
                m.bias.zero_()
        self.bbox_head.temperature.fill_(float(self.cfg.learned_temperature))

    def _pool(self, feats, rois: torch.Tensor, out_size: int) -> torch.Tensor:
        """[B, P, 4] rois -> [B * P, out, out, C] from the first four levels."""
        c = self.cfg
        pooled = multilevel_roi_align(
            feats[:4], rois, c.anchors.strides[:4], out_size, c.finest_scale
        )
        return pooled.flatten(0, 1)

    def features(self, taps):
        """Backbone taps -> (fpn feats list, rpn score / delta maps)."""
        feats = self.fpn(self.pyramid(taps))
        scores, deltas = self.rpn(feats)
        return feats, scores, deltas

    def forward(self, taps, rois, class_embed):
        """Features + bbox head on given rois [B, P, 4]: (cls logits
        [B * P, K+1], box deltas [B * P, 4])."""
        feats, _, _ = self.features(taps)
        logits, box_deltas, _ = self.bbox_head(
            self._pool(feats, rois, self.cfg.roi_feat_size), class_embed
        )
        return logits, box_deltas

    # ----- training ----------------------------------------------------

    def loss(
        self,
        taps,
        gt_boxes: torch.Tensor,
        gt_labels: torch.Tensor,
        gt_valid: torch.Tensor,
        noise: SampleNoise,
        class_embed: torch.Tensor,
        class_weight: Optional[torch.Tensor] = None,
        gt_masks: Optional[torch.Tensor] = None,
        valid_hw: Optional[torch.Tensor] = None,
        group=None,
    ):
        """Full detection loss (RPN + RCNN [+ mask]): (total, metrics).

        taps: 4 [B, h, w, width] frozen backbone taps. gt_boxes [B, G, 4]
        image-space xyxy; gt_labels [B, G]; gt_valid [B, G]. noise: the
        samplers' draws (`targets.SampleNoise`). gt_masks: [B, G, Hm, Wm]
        binary (stride-4 resolution) when with_mask. The loss is the RPN
        stage followed by the RoI stage on its proposals.

        With ``group`` (the data-parallel ranks of a mesh, each holding its
        rows of the global batch) every mean is the global batch's, as XLA
        computes it under `jax.jit` with a sharded batch: the counts that
        divide (images, sampled rois, mask positives) are summed over the
        group first, so the loss and each metric are this rank's share, and
        their sums over the group are the global batch's."""
        feats, l_rpn, metrics, props, pscores = self.rpn_stage(
            taps, gt_boxes, gt_valid, noise, valid_hw, group
        )
        l_roi, roi_metrics = self.roi_stage(
            feats, props, pscores, gt_boxes, gt_labels, gt_valid, noise, class_embed,
            class_weight, gt_masks, group,
        )
        metrics.update(roi_metrics)
        total = l_rpn + l_roi
        metrics["loss"] = total
        return total, metrics

    def rpn_stage(self, taps, gt_boxes, gt_valid, noise: SampleNoise, valid_hw=None, group=None):
        """Features, the RPN loss and its metrics, and the train-time
        proposals [B, P, 4] with their scores [B, P], decoded without
        gradients (the JAX loss's stop_gradient on the RPN outputs)."""
        c = self.cfg
        feats, smap, dmap = self.features(taps)
        rpn = flatten_rpn_outputs(smap, dmap, c)
        l_rpn, metrics = rpn_loss(rpn, gt_boxes, gt_valid, noise.rpn_pos, noise.rpn_neg, c, group)
        p = c.train_proposals
        with torch.no_grad():
            props, pscores = rpn_proposals(
                rpn, (c.image_size, c.image_size), p.nms_pre, p.max_per_img, p.iou_threshold,
                p.min_bbox_size, valid_hw=valid_hw,
            )
        return feats, l_rpn, metrics, props, pscores

    def roi_stage(
        self, feats, props, pscores, gt_boxes, gt_labels, gt_valid, noise: SampleNoise,
        class_embed, class_weight=None, gt_masks=None, group=None,
    ):
        """The RCNN losses (and the mask loss, with ``cfg.with_mask`` and
        ``gt_masks``) on rois sampled from the proposals: (sum, metrics)."""
        c = self.cfg
        tgt = sample_rois(
            props, pscores, gt_boxes, gt_labels, gt_valid,
            noise.roi_pos, noise.roi_neg, noise.roi_gather, c,
        )
        b = tgt.rois.shape[0]
        logits, deltas, _ = self.bbox_head(self._pool(feats, tgt.rois, c.roi_feat_size), class_embed)
        l_cls = rcnn_cls_loss(
            logits, tgt.labels.reshape(-1), tgt.chosen.reshape(-1), class_weight, group
        )
        l_reg = rcnn_reg_loss(
            deltas, tgt.reg_targets.reshape(-1, 4), tgt.pos.reshape(-1), tgt.chosen.reshape(-1),
            group,
        )
        total = l_cls + l_reg
        images = b if group is None else group_sum(logits.new_tensor(float(b)), group)
        metrics = {"loss_cls": l_cls, "loss_bbox": l_reg, "num_pos_roi": tgt.pos.sum() / images}
        if c.with_mask and gt_masks is not None:
            l_mask = self._mask_loss(feats, tgt, gt_masks, group)
            total = total + l_mask
            metrics["loss_mask"] = l_mask
        return total, metrics

    def _mask_loss(self, feats, tgt: RoITargets, gt_masks: torch.Tensor, group=None) -> torch.Tensor:
        """Per-class BCE mask loss on the positive rois (mmdet FCNMaskHead).

        The mask targets are the gt masks RoI-aligned themselves: each
        image's [G, Hm, Wm] masks are an Hm x Wm map of G channels; pooling a
        roi and selecting its assigned gt's channel is one one-hot einsum.
        The head runs on a fixed positives-first subset of
        ``num * pos_fraction`` rois (a stable sort of the pos flag), which
        holds every positive by the sampler's cap, and each roi evaluates
        only its own class channel (`MaskHead(labels=...)`)."""
        c = self.cfg
        b, r = tgt.rois.shape[:2]
        mr = min(int(c.rcnn_sample.num * c.rcnn_sample.pos_fraction), r)
        order = torch.sort(-tgt.pos.int(), dim=1, stable=True).indices[:, :mr]
        rois = take(tgt.rois, order)
        labels = torch.gather(tgt.labels, 1, order)
        gt_idx = torch.gather(tgt.gt_idx, 1, order)
        pos = torch.gather(tgt.pos, 1, order)

        lab = torch.clamp(labels.reshape(-1), 0, c.num_classes - 1)
        ml = self.mask_head(self._pool(feats, rois, c.mask_roi_size), lab)  # [B * mr, o, o]
        out = c.mask_roi_size * 2
        # the stride of the gt mask raster in image coordinates
        mstride = float(c.image_size) / float(gt_masks.shape[2])
        maps = gt_masks.float().movedim(1, -1)  # [B, Hm, Wm, G]
        tgt_masks = roi_align_nxn(maps, rois / mstride, (out, out))  # [B, mr, o, o, G]
        onehot = F.one_hot(gt_idx, gt_masks.shape[1]).float()  # [B, mr, G]
        tgt_sel = torch.einsum("brxyg,brg->brxy", tgt_masks, onehot)
        tgt_sel = (tgt_sel > 0.5).float().reshape(b * mr, out, out)
        bce = F.binary_cross_entropy_with_logits(ml.float(), tgt_sel, reduction="none")
        posf = pos.reshape(-1).float()
        per_roi = bce.mean(dim=(1, 2))
        return (per_roi * posf).sum() / torch.clamp(group_sum(posf.sum(), group), min=1.0)

    # ----- inference ----------------------------------------------------

    def proposals(self, taps, image_hw=None, valid_hw: Optional[torch.Tensor] = None):
        """Backbone taps -> (fpn feats, proposals [B, P, 4], scores [B, P])
        under the test-time proposal settings."""
        c = self.cfg
        image_hw = image_hw or (c.image_size, c.image_size)
        feats, smap, dmap = self.features(taps)
        p = c.test_proposals
        props, pscores = rpn_proposals(
            flatten_rpn_outputs(smap, dmap, c), image_hw,
            p.nms_pre, p.max_per_img, p.iou_threshold, p.min_bbox_size, valid_hw=valid_hw,
        )
        return feats, props, pscores

    def predict(
        self,
        taps,
        dense_vlm: Optional[torch.Tensor],
        class_embed: torch.Tensor,
        base_mask: torch.Tensor,
        image_hw=None,
        valid_hw: Optional[torch.Tensor] = None,
    ):
        """Test-time detection with VLM score fusion.

        dense_vlm: [B, gh, gw, D] normalized dense CLIP map (None disables
        fusion). valid_hw: optional [B, 2] per-image pre-padding (h, w) to
        clip detections to. Returns (boxes [B, D, 4], scores [B, D],
        labels [B, D] [, mask probs [B, D, 2s, 2s]])."""
        c = self.cfg
        image_hw = image_hw or (c.image_size, c.image_size)
        feats, props, pscores = self.proposals(taps, image_hw, valid_hw)
        b, r = props.shape[:2]
        logits, deltas, _ = self.bbox_head(self._pool(feats, props, c.roi_feat_size), class_embed)
        logits = logits.reshape(b, r, -1)
        deltas = deltas.reshape(b, r, 4)

        if dense_vlm is not None:
            # 1x1 RoI-align on the dense map; boxes in feature coordinates
            patch = float(c.image_size) / float(dense_vlm.shape[1])
            vlm_feats = roi_align_1x1(dense_vlm, props / patch)  # [B, R, D]
            fused = fuse_vlm_scores(logits, vlm_feats, class_embed, base_mask, c)
        else:
            fused = torch.softmax(logits, dim=-1)
        # empty NMS slots (score NEG_INF) must not become detections: zero
        # their probabilities so the score threshold removes them
        fused = torch.where(is_live(pscores)[..., None], fused, torch.zeros_like(fused))
        if valid_hw is not None:
            valid_hw = valid_hw.float()
        boxes, scores, labels = rcnn_detections(props, fused, deltas, image_hw, c, valid_hw)

        if not c.with_mask:
            return boxes, scores, labels
        nd = boxes.shape[1]
        lab = torch.clamp(labels.reshape(-1), 0, c.num_classes - 1)
        # each detection evaluates only its own class channel (exact
        # weight-gather, see MaskHead)
        ml = self.mask_head(self._pool(feats, boxes, c.mask_roi_size), lab)
        probs = torch.sigmoid(ml).reshape(b, nd, ml.shape[1], ml.shape[2])
        return boxes, scores, labels, probs


def create_detector(
    cfg: FViTConfig, *, device, seed: int = 0
) -> FViTDetector:
    """An `FViTDetector` with seeded random weights, in eval mode on
    ``device`` (drawn on the CPU from ``torch.Generator().manual_seed(seed)``;
    `load_state_dict` a converted checkpoint over them)."""
    det = FViTDetector(cfg)
    det.init_weights(torch.Generator().manual_seed(seed))
    return det.to(device).eval()


def backbone_taps(clip_model, images: torch.Tensor, cfg: FViTConfig, with_dense: bool):
    """Run the frozen CLIP visual trunk without gradients and return the
    taps [+ dense VLM map] (reference `EvaCLIPViT.forward`)."""
    with torch.no_grad():
        return clip_model.visual_taps(images, tuple(cfg.out_indices), with_dense)
