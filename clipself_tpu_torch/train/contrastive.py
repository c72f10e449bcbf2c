"""The contrastive CLIP losses, a port of `clipself_tpu/train/contrastive.py`
(reference `src/open_clip/loss.py:19-215`): the symmetric InfoNCE of
`ClipLoss` over the whole batch, the soft-label distillation of
`DistillClipLoss`, and `create_loss`'s routing by dataset type. Logits and
softmaxes in float32. On one card the batch is the whole batch; the
reference's cross-process gather and `local_loss` (the JAX package's
`local_clip_loss_fn`, a `shard_map` over a mesh) wait for the multi-GPU
slice (ROADMAP.md queue 1 item 9). The shipped CLIPSelf and RegionCLIP
methods compute their own losses; `models/coca.py::coca_loss` calls
`clip_loss`."""

from __future__ import annotations

from typing import Optional

import torch


def _cross_entropy(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Per-row cross-entropy [N] of float32 ``logits`` [N, C] at ``labels``."""
    logp = torch.log_softmax(logits.float(), dim=-1)
    return -torch.gather(logp, 1, labels[:, None])[:, 0]


def _logits(scale: torch.Tensor, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return scale * a.float() @ b.float().T


def clip_loss(
    image_features: torch.Tensor, text_features: torch.Tensor, logit_scale: torch.Tensor
) -> torch.Tensor:
    """Symmetric InfoNCE over the batch (reference `ClipLoss.forward`,
    `loss.py:107-131`): the mean of the image-to-text and text-to-image
    cross-entropies of logit_scale * image @ text^T, row i's label i."""
    logits = _logits(logit_scale, image_features, text_features)
    labels = torch.arange(logits.shape[0], device=logits.device)
    return 0.5 * (_cross_entropy(logits, labels).mean() + _cross_entropy(logits.T, labels).mean())


def distill_clip_loss(
    student_image: torch.Tensor,
    student_text: torch.Tensor,
    teacher_image: torch.Tensor,
    teacher_text: torch.Tensor,
    logit_scale: torch.Tensor,
    dist_logit_scale: Optional[torch.Tensor] = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """(contrastive loss, distillation loss) (reference `DistillClipLoss`,
    `loss.py:176-215`): the student's `clip_loss`, and the cross-entropy of
    the student's logits against the softmax of the teacher's (scaled by
    ``dist_logit_scale``, else ``logit_scale``), averaged over both
    directions."""
    ts = dist_logit_scale if dist_logit_scale is not None else logit_scale
    contrastive = clip_loss(student_image, student_text, logit_scale)
    s_logits = _logits(logit_scale, student_image, student_text)
    t_probs = torch.softmax(_logits(ts, teacher_image, teacher_text), dim=-1)

    def soft_ce(logits, probs):
        return -(probs * torch.log_softmax(logits, dim=-1)).sum(-1).mean()

    distill = 0.5 * (soft_ce(s_logits, t_probs) + soft_ce(s_logits.T, t_probs.T))
    return contrastive, distill


def create_loss(dataset_type: str = "grid_distill"):
    """The loss of a dataset type (reference `factory.py:252-264`): the
    contrastive types get `clip_loss`, every other `distill_clip_loss`."""
    if dataset_type in ("sanity_check", "clipself", "clipself_proposals", "coco_caption"):
        return clip_loss
    return distill_clip_loss
