"""Fixed-shape greedy NMS and class-wise NMS, batched over images.

A port of `clipself_tpu/detector/nms.py`, with the JAX `vmap` over images
written out as a leading batch dimension. Candidates are sorted by score
(stable, so that equal scores keep their index order, as `jnp.argsort` and
`lax.top_k` do), `ops/nms.py::nms_keep_mask` gives the keep mask (the CUDA
kernel on the card, its plain version on the CPU), and outputs have a fixed
size: suppressed and empty slots carry score NEG_INF.
"""

from __future__ import annotations

import torch

from clipself_tpu_torch.ops.nms import nms_keep_mask

NEG_INF = -1e10


def is_live(scores: torch.Tensor) -> torch.Tensor:
    """scores > NEG_INF, with NEG_INF rounded to the scores' own type first
    (in bfloat16 the sentinel rounds to a value above -1e10)."""
    return scores > torch.full((), NEG_INF, dtype=scores.dtype, device=scores.device)


def sorted_desc(scores: torch.Tensor, k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """The k largest of each row, descending, the lowest index first among
    equal scores (`lax.top_k`'s order; `torch.topk` promises none)."""
    if k > scores.shape[-1]:
        raise ValueError(f"top {k} of {scores.shape[-1]} scores")
    top_s, top_i = torch.sort(scores, dim=-1, descending=True, stable=True)
    return top_s[..., :k], top_i[..., :k]


def take(t: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """t [B, N, ...] gathered along dim 1 by idx [B, K]."""
    idx = idx.reshape(idx.shape + (1,) * (t.dim() - 2)).expand(idx.shape + t.shape[2:])
    return torch.gather(t, 1, idx)


def nms(
    boxes: torch.Tensor,
    scores: torch.Tensor,
    iou_threshold: float,
    max_out: int,
    valid: torch.Tensor | None = None,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Greedy NMS over up to N boxes an image.

    boxes [B, N, 4] xyxy; scores [B, N]; valid optional [B, N] bool.
    Returns (boxes [B, max_out, 4], scores [B, max_out], indices
    [B, max_out]) sorted by score descending; suppressed and empty slots have
    score NEG_INF, index -1 and a zero box.
    """
    s = scores
    if valid is not None:
        s = torch.where(valid, s, NEG_INF)
    s, order = sorted_desc(s, s.shape[-1])
    b = take(boxes, order)
    keep = nms_keep_mask(b, is_live(s), iou_threshold)
    s_kept = torch.where(keep, s, NEG_INF)
    top_s, top_i = sorted_desc(s_kept, max_out)
    live = is_live(top_s)
    out_boxes = torch.where(live[..., None], take(b, top_i), 0.0)
    out_idx = torch.where(live, take(order, top_i), -1)
    return out_boxes, top_s, out_idx


def multiclass_nms(
    boxes: torch.Tensor,
    scores: torch.Tensor,
    score_thr: float,
    iou_threshold: float,
    max_per_img: int,
    pre_nms: int = 2000,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Class-wise NMS via the coordinate-offset trick (mmcv `batched_nms`
    semantics used by `multiclass_nms`).

    boxes [B, N, 4] (class-shared) or [B, N, C, 4]; scores [B, N, C]
    per-class scores WITHOUT the background column. Returns (boxes
    [B, max_per_img, 4], scores [B, max_per_img], labels [B, max_per_img])
    with empty slots scored NEG_INF, label -1.
    """
    bsz, n, c = scores.shape
    flat_scores = scores.reshape(bsz, n * c)
    flat_scores = torch.where(flat_scores > score_thr, flat_scores, NEG_INF)

    k = min(pre_nms, n * c)
    top_s, top_i = sorted_desc(flat_scores, k)
    cand_labels = top_i % c  # the flat index is roi * C + class
    if boxes.dim() == 3:  # class-shared: candidate roi * C + class has roi's box
        cand_boxes = take(boxes, top_i // c)
    else:
        cand_boxes = take(boxes.reshape(bsz, n * c, 4), top_i)
    # offset boxes per class so cross-class pairs never overlap; the span is
    # each image's own largest coordinate
    span = cand_boxes.amax(dim=(1, 2)) + 1.0
    off_boxes = cand_boxes + (cand_labels.float() * span[:, None])[..., None]
    _, kept_s, kept_i = nms(off_boxes, top_s, iou_threshold, max_per_img)
    found = kept_i >= 0
    safe = torch.clamp(kept_i, min=0)
    out_boxes = torch.where(found[..., None], take(cand_boxes, safe), 0.0)
    out_labels = torch.where(found, take(cand_labels, safe), -1)
    return out_boxes, kept_s, out_labels
