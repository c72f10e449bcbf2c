"""Assignment and sampling as fixed-shape masked computation.

A port of `clipself_tpu/detector/targets.py` (mmdet `MaxIoUAssigner` +
`RandomSampler` semantics, reference train cfg
`F-ViT/configs/ov_coco/...eva_original.py:89-126`), with the JAX `vmap` over
images written as a leading batch dimension. Every anchor or proposal gets
an assignment label, and "sampling" selects a static-size subset through
randomised top-k masks: no data-dependent shapes, no host sync.

The JAX sampler draws `jax.random.uniform` noise from split keys, which
torch cannot redraw, so `random_sample` takes the noise as tensors
(`SampleNoise` holds all of one loss's); the training step draws it from a
`torch.Generator` (`draw_noise`). Ranking ties break by index, as
`lax.top_k` does: a stable descending sort (`detector/nms.py::sorted_desc`),
never `torch.topk`.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from clipself_tpu_torch.detector.boxes import box_iou
from clipself_tpu_torch.detector.nms import sorted_desc


class Assignment(NamedTuple):
    gt_idx: torch.Tensor  # [B, N] int64 index of the assigned gt (valid only where pos)
    max_iou: torch.Tensor  # [B, N]
    pos: torch.Tensor  # [B, N] bool
    neg: torch.Tensor  # [B, N] bool


def assign_max_iou(
    boxes: torch.Tensor,
    gt_boxes: torch.Tensor,
    gt_valid: torch.Tensor,
    pos_iou_thr: float,
    neg_iou_thr: float,
    min_pos_iou: float,
    match_low_quality: bool,
) -> Assignment:
    """Max-IoU assignment over padded gt boxes.

    boxes: [B, N, 4] proposals or [N, 4] anchors shared by the batch;
    gt_boxes: [B, G, 4] padded; gt_valid: [B, G] bool.
    """
    iou = box_iou(boxes, gt_boxes)  # [B, N, G]
    iou = torch.where(gt_valid[:, None, :], iou, -1.0)
    max_iou, gt_idx = iou.max(dim=-1)  # the first index of the maximum
    pos = max_iou >= pos_iou_thr
    # mmdet: anchors with no overlapping (or no valid) gt are NEGATIVE, so
    # images whose gts were all cropped away still train background
    neg = max_iou < neg_iou_thr

    if match_low_quality:
        # each gt claims its best-overlapping anchor(s) if IoU >= min_pos_iou;
        # mmdet assigns every anchor tying the per-gt max (gt_max_assign_all)
        gt_best = iou.amax(dim=1, keepdim=True)  # [B, 1, G]
        is_best = (iou == gt_best) & (iou > 0.0) & gt_valid[:, None, :]
        claim = is_best & (gt_best >= min_pos_iou)
        claimed = claim.any(dim=-1)
        # later gts override earlier ones (mmdet iterates gts in order): the
        # largest claiming index
        ids = torch.arange(claim.shape[-1], device=claim.device)
        last = torch.where(claim, ids, -1).amax(dim=-1)
        gt_idx = torch.where(claimed, last, gt_idx)
        pos = pos | claimed
        neg = neg & ~claimed

    return Assignment(gt_idx=gt_idx, max_iou=max_iou, pos=pos, neg=neg)


class SampleResult(NamedTuple):
    pos_mask: torch.Tensor  # [B, N] bool, sampled positives
    neg_mask: torch.Tensor  # [B, N] bool, sampled negatives
    num_pos: torch.Tensor  # [B]
    num_neg: torch.Tensor  # [B]


def random_sample(
    assign: Assignment,
    num: int,
    pos_fraction: float,
    pos_noise: torch.Tensor,
    neg_noise: torch.Tensor,
) -> SampleResult:
    """Random pos / neg subsampling with a fixed budget (mmdet
    `RandomSampler`): up to ``num * pos_fraction`` positives are kept
    (random without replacement), the rest of the budget is filled with
    random negatives. ``pos_noise`` and ``neg_noise``: [B, N] uniform
    [0, 1) draws that rank the candidates."""
    num_pos_max = int(num * pos_fraction)
    # exact top-k masks, not score thresholds: a `>= kth` threshold keeps
    # every entry tied at the k-th score, so a noise collision among more
    # than k candidates could exceed the cap; ties broken by index keep
    # exactly min(count, cap) entries
    pos_score = torch.where(assign.pos, pos_noise, -1.0)
    pos_mask = _topk_mask(pos_score, num_pos_max) & assign.pos
    num_pos = torch.clamp(assign.pos.sum(dim=-1), max=num_pos_max)

    budget = num - num_pos  # a cutoff per image within a static top-k
    neg_score = torch.where(assign.neg, neg_noise, -1.0)
    neg_mask = _topk_mask(neg_score, num, k_dynamic=budget) & assign.neg
    num_neg = torch.minimum(assign.neg.sum(dim=-1), budget)
    return SampleResult(pos_mask=pos_mask, neg_mask=neg_mask, num_pos=num_pos, num_neg=num_neg)


def _topk_mask(
    score: torch.Tensor, k: int, k_dynamic: Optional[torch.Tensor] = None
) -> torch.Tensor:
    """Boolean mask [B, N] of the top-k scores of each row, ties broken by
    index (static k). ``k_dynamic`` ([B], <= k) optionally keeps only the
    first k_dynamic of each row's k ranked entries."""
    mask = torch.zeros_like(score, dtype=torch.bool)
    if k <= 0:
        return mask
    k = min(k, score.shape[-1])
    _, idx = sorted_desc(score, k)
    keep = torch.ones_like(idx, dtype=torch.bool)
    if k_dynamic is not None:
        keep = torch.arange(k, device=score.device) < k_dynamic[:, None]
    return mask.scatter(-1, idx, keep)


class SampleNoise(NamedTuple):
    """The uniform [0, 1) draws of one detection loss: the RPN sampler's
    [B, N] over the anchors, the RoI sampler's and its fixed-budget
    gather's [B, P + G] over proposals and gts."""

    rpn_pos: torch.Tensor
    rpn_neg: torch.Tensor
    roi_pos: torch.Tensor
    roi_neg: torch.Tensor
    roi_gather: torch.Tensor


def draw_noise(
    generator: torch.Generator, batch: int, anchors: int, rois: int
) -> SampleNoise:
    """One loss's noise, float32, on the generator's device, drawn in the
    field order of `SampleNoise`."""
    def uniform(n):
        return torch.rand(batch, n, generator=generator, device=generator.device)

    return SampleNoise(uniform(anchors), uniform(anchors), uniform(rois), uniform(rois), uniform(rois))
