"""The training methods' losses (a port of `clipself_tpu/train/methods.py`:
`multiscale_sizes`, `resize_images_for_scale`, `clipself_loss`,
`_fed_class_mask`, `regionclip_loss`).

Ragged per-image box lists are fixed-shape padded arrays with a validity
flag, as in the JAX package: the teacher encodes every padded crop and the
loss masks the padded rows out. Each loss takes the step index that the
train step hands it; the RegionCLIP loss's class sampling takes its uniform
noise as a tensor (`fed_loss_noise` draws it from ``(seed, step)``), where
the JAX loss draws from a key folded with the step.

On a mesh (``group``: the data-like ranks of `parallel/mesh.py`) each rank
holds its rows of the global batch and the losses stay global, as XLA
computes them over the sharded batch: the valid-box count that divides the
loss is summed over the group, and the federated class sampling starts from
the classes that appear anywhere in the global batch (every rank draws the
same noise from ``(seed, step)``). Each rank's loss is its share of the
global loss: the group's sum is the loss of the whole batch.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.distributed as dist
import torch.nn.functional as F

from clipself_tpu_torch.models.clip import CLIP
from clipself_tpu_torch.models.common import l2_normalize
from clipself_tpu_torch.ops.interpolate import resize_2d
from clipself_tpu_torch.parallel.mesh import reduce_sum

# multiscale target sizes per det size (reference clipself.py:17-27)
MULTISCALE_SIZES = {1024: (320, 640, 896, 1024), 896: (336, 448, 672, 896)}


def multiscale_sizes(det_size: int, patch_size: int = 16) -> tuple[int, ...]:
    if det_size in MULTISCALE_SIZES:
        return MULTISCALE_SIZES[det_size]
    # generic ladder for other det sizes; every rung a patch multiple, so the
    # patch grid stays aligned with the [0, 1]-normalized boxes
    def snap(v):
        return max(patch_size, (v // patch_size) * patch_size)

    return tuple(sorted({snap(det_size // 2), snap(det_size * 3 // 4), det_size}))


def resize_images_for_scale(batch: dict, target_size: int) -> dict:
    """Bilinear-resize the [B, S, S, 3] images to ``target_size``; boxes are
    normalized, so they are scale-invariant."""
    if batch["images"].shape[1] == target_size:
        return batch
    out = dict(batch)
    images = batch["images"].permute(0, 3, 1, 2)  # resize the two spatial axes
    images = resize_2d(images, (target_size, target_size), "bilinear")
    out["images"] = images.permute(0, 2, 3, 1).contiguous()
    return out


def clipself_loss(
    model: CLIP,
    teacher: CLIP,
    batch: dict,
    step: int = 0,
    *,
    cosine_weight: float = 1.0,
    extract_type: str = "v2",
    group=None,
) -> tuple[torch.Tensor, dict]:
    """CLIPSelf distillation loss (reference `CLIPSelf.__call__`,
    `clipself.py:7-49`), on tensors on the model's device:

      images: [B, S, S, 3] full images (multiscale-resized if enabled)
      boxes:  [B, M, 5] xyxy normalized + valid flag
      crops:  [B, M, s, s, 3] teacher crops (padded rows arbitrary)

    The teacher's CLS embeddings of the B*M crops carry no gradient; the
    student's RoI features come from its dense map (``extract_type`` 'v2')
    or, on the OpenCLIP ViT, from mask-attention pooling ('v1'). Returns
    the masked mean of 1 - cos in f32, times ``cosine_weight``, and the
    metrics dict. The step index is not used. With ``group``, the mean is
    over the valid boxes of the group's global batch.
    """
    images, boxes, crops = batch["images"], batch["boxes"], batch["crops"]
    b, m = boxes.shape[:2]
    valid = (boxes[..., 4] > 0.5).reshape(b * m).float()
    with torch.no_grad():
        teacher_feats = teacher.encode_image(crops.reshape((b * m,) + tuple(crops.shape[2:])))
    student_feats = model.encode_pseudo_boxes(
        images, boxes[..., :4], extract_type=extract_type
    ).reshape(b * m, -1)
    cos = (
        l2_normalize(student_feats).float() * l2_normalize(teacher_feats).float()
    ).sum(-1)
    n_valid = torch.clamp(_group_sum(valid.sum(), group), min=1.0)
    loss = ((1.0 - cos) * valid).sum() / n_valid * cosine_weight
    return loss, {"loss_cosine": loss.detach(), "num_boxes": valid.sum()}


def _group_sum(x: torch.Tensor, group) -> torch.Tensor:
    """``x`` summed over ``group`` (itself without one); no gradient."""
    return x if group is None else reduce_sum(x, group)


def fed_loss_noise(seed: int, step: int, num_classes: int, device) -> torch.Tensor:
    """The [num_classes] uniform [0, 1) float32 draws of the federated class
    sampling at ``step``, on ``device``, from a generator seeded by
    ``(seed, step)``: a resumed run draws what an unbroken run draws, as
    the JAX step's ``fold_in(PRNGKey(seed), step)`` does (the values are
    not JAX's). No host synchronisation."""
    mixed = np.random.SeedSequence((seed % 2 ** 64, step)).generate_state(1, np.uint64)[0]
    generator = torch.Generator(device=device).manual_seed(int(mixed))
    return torch.rand(num_classes, generator=generator, device=device)


def _fed_class_mask(
    labels: torch.Tensor,
    valid: torch.Tensor,
    num_classes: int,
    num_sample: int,
    noise: torch.Tensor,
    group=None,
) -> torch.Tensor:
    """Federated-loss class selection as a bool [num_classes] mask
    (reference `get_fed_loss_inds`, `region_clip.py:7-16`): every class that
    a valid box carries, plus the ``num_sample`` top classes of a score that
    pins those classes at 2 and gives the others their ``noise``. Ties keep
    the lower index first, as `jax.lax.top_k` does. With ``group`` the
    classes that appear are those of the group's global batch."""
    if num_sample > num_classes:
        raise ValueError(f"num_sample {num_sample} > num_classes {num_classes} (top_k needs k <= n)")
    classes = torch.arange(num_classes, device=labels.device)
    # a label outside [0, C) matches no class, as jax.nn.one_hot gives it a zero row
    appeared = ((labels[:, None] == classes) & valid[:, None]).any(0)
    if group is not None:
        anywhere = appeared.to(torch.int32)
        dist.all_reduce(anywhere, op=dist.ReduceOp.MAX, group=group)
        appeared = anywhere.bool()
    score = torch.where(appeared, torch.full_like(noise, 2.0), noise)
    idx = torch.sort(score, descending=True, stable=True).indices[:num_sample]
    sel = torch.zeros(num_classes, dtype=torch.bool, device=labels.device).index_fill(0, idx, True)
    return sel | appeared


def regionclip_loss(
    model: CLIP,
    teacher,  # unused; signature parity
    batch: dict,
    step: int = 0,
    *,
    noun_embeddings: torch.Tensor,
    noise: torch.Tensor,
    num_sample_cats: int = 100,
    contrast_weight: float = 1.0,
    extract_type: str = "v2",
    group=None,
) -> tuple[torch.Tensor, dict]:
    """RegionCLIP region-text loss (reference `RegionCLIP.__call__`,
    `region_clip.py:28-67`): the student's L2-normalized RoI features
    against fixed noun embeddings, a sigmoid BCE over the classes of
    `_fed_class_mask`, summed over them and averaged over the valid boxes.

      images: [B, S, S, 3]
      boxes:  [B, M, 6] xyxy normalized, class label, valid flag
    noun_embeddings: [C, D] L2-normalized (constant); noise: [C] uniform
    [0, 1) draws of the class sampling; ``extract_type`` as in
    `clipself_loss`. No teacher runs; the step index is not used (the noise
    carries it). ``group`` as in `clipself_loss` and `_fed_class_mask`.
    """
    images, boxes = batch["images"], batch["boxes"]
    b, m = boxes.shape[:2]
    valid = (boxes[..., 5] > 0.5).reshape(b * m)
    labels = boxes[..., 4].to(torch.int64).reshape(b * m)
    feats = model.encode_pseudo_boxes(
        images, boxes[..., :4], normalize=True, extract_type=extract_type
    ).reshape(b * m, -1)
    temp = model.logit_scale.exp().detach()
    nouns = noun_embeddings.float()
    logits = feats.float() @ nouns.T * temp  # [BM, C]
    classes = torch.arange(nouns.shape[0], device=labels.device)
    target = (labels[:, None] == classes).float()
    cls_mask = _fed_class_mask(labels, valid, nouns.shape[0], num_sample_cats, noise, group)
    # optax.sigmoid_binary_cross_entropy: the stable max(x, 0) - x z + log1p(exp(-|x|))
    per_elt = F.binary_cross_entropy_with_logits(logits, target, reduction="none") * cls_mask[None, :]
    per_box = per_elt.sum(-1)
    validf = valid.float()
    n_valid = torch.clamp(_group_sum(validf.sum(), group), min=1.0)
    loss = (per_box * validf).sum() / n_valid * contrast_weight
    return loss, {"loss_contrast": loss.detach(), "num_boxes": validf.sum()}


def make_regionclip_loss(
    noun_embeddings: torch.Tensor, seed: int, *, contrast_weight: float = 1.0,
    extract_type: str = "v2", group=None,
):
    """The trainer's RegionCLIP loss ``loss_fn(model, teacher, batch, step)``:
    `regionclip_loss` with the noise of `fed_loss_noise(seed, step)`, drawn
    on the noun matrix's device (the same on every rank of ``group``)."""
    device = noun_embeddings.device

    def loss_fn(model, teacher, batch, step):
        noise = fed_loss_noise(seed, step, noun_embeddings.shape[0], device)
        return regionclip_loss(
            model, teacher, batch, step, noun_embeddings=noun_embeddings, noise=noise,
            contrast_weight=contrast_weight, extract_type=extract_type, group=group,
        )

    return loss_fn
