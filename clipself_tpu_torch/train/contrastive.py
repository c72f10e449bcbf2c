"""The contrastive CLIP losses, a port of `clipself_tpu/train/contrastive.py`
(reference `src/open_clip/loss.py:19-215`): the symmetric InfoNCE of
`ClipLoss` over the whole batch, the soft-label distillation of
`DistillClipLoss`, `local_clip_loss` (the reference's `local_loss` across
processes, the JAX package's `local_clip_loss_fn`) and `create_loss`'s
routing by dataset type. Logits and softmaxes in float32. The shipped
CLIPSelf and RegionCLIP methods compute their own losses;
`models/coca.py::coca_loss` calls `clip_loss`."""

from __future__ import annotations

from typing import Optional

import torch
import torch.distributed as dist


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


class _GatherRows(torch.autograd.Function):
    """The ranks' rows concatenated in rank order; the backward sums the
    gathered gradient over the ranks and keeps this rank's rows."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group, ctx.n = group, x.shape[0]
        parts = [torch.empty_like(x) for _ in range(dist.get_world_size(group))]
        dist.all_gather(parts, x.contiguous(), group=group)
        return torch.cat(parts)

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous().clone()
        dist.all_reduce(g, group=ctx.group)
        r = dist.get_rank(ctx.group)
        return g[r * ctx.n:(r + 1) * ctx.n], None


class _MeanOverRanks(torch.autograd.Function):
    """The mean of a scalar over the ranks. Every rank holds the mean and
    backpropagates the one global loss, so a rank's share of the gradient
    is 1 / n of it."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.n = dist.get_world_size(group)
        x = x.detach().clone()
        dist.all_reduce(x, group=group)
        return x / ctx.n

    @staticmethod
    def backward(ctx, g):
        return g / ctx.n, None


def local_clip_loss(
    image_features: torch.Tensor,
    text_features: torch.Tensor,
    logit_scale: torch.Tensor,
    group=None,
) -> torch.Tensor:
    """`clip_loss` with the reference's ``local_loss`` across the ranks of
    ``group`` (`loss.py:49-63, 107-120`; the JAX package's
    `local_clip_loss_fn`, `clipself_tpu/train/contrastive.py:76-101`): each
    rank scores its own rows against the all-gathered rows of every rank,
    row i's label its index in the gathered batch (i plus the rank times
    the rows a rank), and the loss is the mean over the ranks, on every
    rank. Gradients reach every rank's features through the gather. Each
    rank holds the same number of rows."""
    all_img = _GatherRows.apply(image_features, group)
    all_txt = _GatherRows.apply(text_features, group)
    n = image_features.shape[0]
    rank = dist.get_rank(group)
    labels = torch.arange(n, device=image_features.device) + rank * n
    li = _logits(logit_scale, image_features, all_txt)
    lt = _logits(logit_scale, text_features, all_img)
    loss = 0.5 * (_cross_entropy(li, labels).mean() + _cross_entropy(lt, labels).mean())
    return _MeanOverRanks.apply(loss, group)


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
