"""Detector configuration dataclasses: a copy of
`clipself_tpu/detector/config.py` (pure Python, every preset included;
`tests/test_torch_detector_geometry.py` pins each preset field equal to the
original).

Typed re-design of the reference mmcv python configs
(`F-ViT/configs/ov_coco/fvit_vitb16_upsample_fpn_bs64_3e_ovcoco_eva_original.py`,
`F-ViT/configs/ov_lvis/fvit_vitb16_upsample_fpn_bs64_4x_ovlvis_eva_original.py`).
One dataclass per sub-system; presets mirror the shipped configs.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Optional, Tuple


@dataclass(frozen=True)
class AnchorCfg:
    scales: Tuple[float, ...] = (8.0,)
    ratios: Tuple[float, ...] = (0.5, 1.0, 2.0)
    # feature strides: patch/4, patch/2, patch, 2*patch, 4*patch (may be
    # fractional for patch-14 towers, reference ov_coco L/14 cfg line 32)
    strides: Tuple[float, ...] = (4, 8, 16, 32, 64)
    center_offset: float = 0.0


@dataclass(frozen=True)
class AssignCfg:
    pos_iou_thr: float = 0.7
    neg_iou_thr: float = 0.3
    min_pos_iou: float = 0.3
    match_low_quality: bool = True


@dataclass(frozen=True)
class SampleCfg:
    num: int = 256
    pos_fraction: float = 0.5
    add_gt_as_proposals: bool = False


@dataclass(frozen=True)
class ProposalCfg:
    nms_pre: int = 2000  # total candidates kept before NMS (global top-k)
    max_per_img: int = 1000
    iou_threshold: float = 0.7
    min_bbox_size: float = 0.0


@dataclass(frozen=True)
class RcnnTestCfg:
    score_thr: float = 0.01
    iou_threshold: float = 0.4
    max_per_img: int = 100


@dataclass(frozen=True)
class FViTConfig:
    # backbone (frozen distilled CLIP ViT)
    clip_model: str = "EVA02-CLIP-B-16"
    out_indices: Tuple[int, ...] = (3, 5, 7, 11)
    backbone_width: int = 768  # ViT trunk width
    embed_dim: int = 512  # CLIP joint space / class-embedding dim
    patch_size: int = 16

    # neck
    fpn_channels: int = 256
    num_fpn_outs: int = 5

    # rpn
    rpn_convs: int = 2
    anchors: AnchorCfg = field(default_factory=AnchorCfg)
    rpn_assign: AssignCfg = field(default_factory=AssignCfg)
    rpn_sample: SampleCfg = field(default_factory=SampleCfg)
    train_proposals: ProposalCfg = field(default_factory=lambda: ProposalCfg(max_per_img=1000))
    test_proposals: ProposalCfg = field(default_factory=lambda: ProposalCfg(max_per_img=1000))

    # roi head
    num_classes: int = 65
    roi_feat_size: int = 7
    num_shared_convs: int = 4
    num_shared_fcs: int = 2
    num_cls_fcs: int = 1
    num_reg_fcs: int = 1
    fc_out_channels: int = 512
    bbox_stds: Tuple[float, ...] = (0.1, 0.1, 0.2, 0.2)
    finest_scale: float = 56.0  # roi->level mapping (mmdet SingleRoIExtractor)
    rcnn_assign: AssignCfg = field(
        default_factory=lambda: AssignCfg(0.5, 0.5, 0.5, match_low_quality=False)
    )
    rcnn_sample: SampleCfg = field(
        default_factory=lambda: SampleCfg(num=512, pos_fraction=0.25, add_gt_as_proposals=True)
    )
    rcnn_test: RcnnTestCfg = field(default_factory=RcnnTestCfg)

    # open-vocabulary classification
    learned_temperature: float = 50.0
    vlm_temperature: float = 75.0
    alpha: float = 0.1  # base-class VLM fusion exponent
    beta: float = 0.8  # novel-class VLM fusion exponent
    bg_weight: float = 0.6  # background class-weight in the CE loss

    # mask head (LVIS)
    with_mask: bool = False
    mask_roi_size: int = 14
    mask_convs: int = 4
    mask_channels: int = 256

    # training
    max_gt: int = 100
    image_size: int = 640
    norm: str = "gn"  # deterministic GroupNorm in place of the reference's SyncBN


OV_COCO_VITB16 = FViTConfig()

OV_COCO_VITL14 = FViTConfig(
    clip_model="EVA02-CLIP-L-14-336",
    backbone_width=1024,
    embed_dim=768,
    patch_size=14,
    out_indices=(6, 10, 14, 23),
    anchors=AnchorCfg(strides=(3.5, 7, 14, 28, 56)),
    fc_out_channels=768,
    image_size=896,
)

OV_LVIS_VITB16 = FViTConfig(
    num_classes=1203,
    vlm_temperature=50.0,
    alpha=0.1,
    beta=0.6,
    bg_weight=0.9,
    with_mask=True,
)

# reference `configs/ov_lvis/fvit_vitl14_upsample_fpn_bs64_4x_ovlvis_eva_original.py`:
# L/14-336 tower at 896², learned/vlm temperature 50, beta=0.4 (comment there
# notes 0.6-0.8 trades APr up), bg_weight=0.9, mask head on
OV_LVIS_VITL14 = dataclasses.replace(
    OV_COCO_VITL14,
    num_classes=1203,
    learned_temperature=50.0,
    vlm_temperature=50.0,
    alpha=0.1,
    beta=0.4,
    bg_weight=0.9,
    with_mask=True,
)

# transfer evaluation: all classes fused with the base exponent
# (reference `configs/transfer/fvit_vitl14_upsample_fpn_transfer2voc.py`:
# alpha=0.3; transfer2coco/objects365 analogous)
TRANSFER_VOC_VITL14 = dataclasses.replace(
    OV_COCO_VITL14, num_classes=20, alpha=0.3, beta=0.3
)
TRANSFER_OBJECTS365_VITL14 = dataclasses.replace(
    OV_COCO_VITL14, num_classes=365, alpha=0.3, beta=0.3
)
TRANSFER_COCO_VITL14 = dataclasses.replace(
    OV_COCO_VITL14, num_classes=80, alpha=0.3, beta=0.3
)

# CPU-runnable miniature of the ov_coco pipeline (tests + smoke runs): tiny
# 4-layer EVA trunk, 64px images, full 65-class COCO-OV vocabulary
TINY_TEST = FViTConfig(
    clip_model="EVA02-CLIP-Tiny-Det-Test",
    out_indices=(0, 1, 2, 3),
    backbone_width=64,
    embed_dim=32,
    patch_size=8,
    fpn_channels=32,
    anchors=AnchorCfg(strides=(2, 4, 8, 16, 32)),
    num_classes=65,
    num_shared_convs=1,
    num_shared_fcs=1,
    fc_out_channels=32,
    train_proposals=ProposalCfg(nms_pre=128, max_per_img=32),
    test_proposals=ProposalCfg(nms_pre=128, max_per_img=32),
    rcnn_sample=SampleCfg(num=16, pos_fraction=0.25, add_gt_as_proposals=True),
    rcnn_test=RcnnTestCfg(max_per_img=8),
    max_gt=5,
    image_size=64,
)

PRESETS = {
    "ov_coco_vitb16": OV_COCO_VITB16,
    "tiny_test": TINY_TEST,
    "ov_coco_vitl14": OV_COCO_VITL14,
    "ov_lvis_vitb16": OV_LVIS_VITB16,
    "ov_lvis_vitl14": OV_LVIS_VITL14,
    "transfer_voc_vitl14": TRANSFER_VOC_VITL14,
    "transfer_objects365_vitl14": TRANSFER_OBJECTS365_VITL14,
    "transfer_coco_vitl14": TRANSFER_COCO_VITL14,
}
