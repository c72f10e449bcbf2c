"""The CLIPSelf distillation loss (a port of `clipself_tpu/train/methods.py`:
`multiscale_sizes`, `resize_images_for_scale`, `clipself_loss`; the
RegionCLIP loss is not ported yet, ROADMAP.md queue 1 item 6).

Ragged per-image box lists are fixed-shape padded arrays with a validity
flag, as in the JAX package: the teacher encodes every padded crop and the
loss masks the padded rows out.
"""

from __future__ import annotations

import torch

from clipself_tpu_torch.models.clip import CLIP
from clipself_tpu_torch.models.common import l2_normalize
from clipself_tpu_torch.ops.interpolate import resize_2d

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
    *,
    cosine_weight: float = 1.0,
) -> tuple[torch.Tensor, dict]:
    """CLIPSelf distillation loss (reference `CLIPSelf.__call__`,
    `clipself.py:7-49`), on tensors on the model's device:

      images: [B, S, S, 3] full images (multiscale-resized if enabled)
      boxes:  [B, M, 5] xyxy normalized + valid flag
      crops:  [B, M, s, s, 3] teacher crops (padded rows arbitrary)

    The teacher's CLS embeddings of the B*M crops carry no gradient; the
    student's RoI features come from its dense map. Returns the masked mean
    of 1 - cos in f32, times ``cosine_weight``, and the metrics dict.
    """
    images, boxes, crops = batch["images"], batch["boxes"], batch["crops"]
    b, m = boxes.shape[:2]
    valid = (boxes[..., 4] > 0.5).reshape(b * m).float()
    with torch.no_grad():
        teacher_feats = teacher.encode_image(crops.reshape((b * m,) + tuple(crops.shape[2:])))
    student_feats = model.encode_pseudo_boxes(images, boxes[..., :4]).reshape(b * m, -1)
    cos = (
        l2_normalize(student_feats).float() * l2_normalize(teacher_feats).float()
    ).sum(-1)
    n_valid = torch.clamp(valid.sum(), min=1.0)
    loss = ((1.0 - cos) * valid).sum() / n_valid * cosine_weight
    return loss, {"loss_cosine": loss.detach(), "num_boxes": valid.sum()}
