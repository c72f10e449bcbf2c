"""Zero-shot region classification: per-class mean accuracy on COCO-Panoptic.

A port of `clipself_tpu/eval/zero_shot.py`: for every image, classify (a)
RoI features and (b) mask-pooled features of one shared dense trunk pass, and
(c) the CLIP embeddings of the per-annotation crops, against a fixed
text-embedding matrix; report per-class mean top-1 / top-5 accuracy split by
thing/stuff. Batches are fixed-shape and padded (`COCOPanopticEvalDataset`
format, or `data/synthetic.py`); the annotation axis is bucketed per batch
and all crops of a batch are encoded in one call.
"""

from __future__ import annotations

import json
import math
from typing import Iterable, Union

import numpy as np
import torch

from clipself_tpu_torch.models.clip import CLIP

# `eval_ann_bucket` knob default of the JAX package (core/knobs.py)
DEFAULT_ANN_BUCKET = 25


def _topk_correct(logits: np.ndarray, labels: np.ndarray, k: int = 5) -> np.ndarray:
    """[N, K] logits, [N] labels -> [N, k] bool matrix of top-k hits
    (column 0 is the argmax)."""
    topk = np.argsort(-logits, axis=-1)[:, :k]
    return topk == labels[:, None]


def macc_with_is_thing(
    correct: np.ndarray, is_thing: np.ndarray, labels: np.ndarray, prefix: str
) -> dict:
    """Per-class mean accuracy, thing/stuff x top1/top5
    (reference `macc_with_is_thing`, `zero_shot.py:140-174`)."""

    def _macc(corrects: np.ndarray, cls: np.ndarray) -> float:
        if cls.size == 0:
            return float("nan")
        accs = []
        for lb in range(int(cls.min()), int(cls.max()) + 1):
            sel = corrects[cls == lb]
            if sel.shape[0] == 0:
                continue
            accs.append(np.float16(sel.mean()).item())
        return float(sum(accs) / max(len(accs), 1))

    results = {}
    for group, sel in (("thing", is_thing > 0), ("stuff", is_thing < 1)):
        c = correct[sel]
        lb = labels[sel].astype(np.int64)
        results[f"{prefix}.{group}.macc1"] = _macc(c[:, 0], lb)
        results[f"{prefix}.{group}.macc5"] = _macc(c.sum(-1) > 0, lb)
    return results


def metrics_json(metrics: dict, **dump_kwargs) -> str:
    """The metrics as strict JSON: a NaN (a class group without ground
    truth) is written as ``null``, never as a bare ``NaN`` token."""
    clean = {
        k: (None if isinstance(v, float) and not math.isfinite(v) else v)
        for k, v in metrics.items()
    }
    return json.dumps(clean, allow_nan=False, **dump_kwargs)


def _bucket_width(boxes: np.ndarray, bucket: int) -> int:
    """Smallest multiple of ``bucket`` covering the highest valid annotation
    row (rows past it are pure padding), capped at the padded width."""
    m = boxes.shape[1]
    if bucket <= 0 or m <= bucket:
        return m
    rows = np.nonzero(boxes[..., 5] > 0.5)[-1]
    hi = int(rows.max()) + 1 if rows.size else 1
    return min(-(-hi // bucket) * bucket, m)


@torch.inference_mode()
def batch_logits(
    model: CLIP,
    emb: torch.Tensor,
    images: torch.Tensor,
    boxes4: torch.Tensor,
    crops: torch.Tensor,
    masks: torch.Tensor,
    image_ave_pool: bool = False,
    extract_type: str = "v2",
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(roi, crop, maskpool) float32 logits [B, M, K] of one batch against
    the L2-normalized class embeddings ``emb`` [K, C]. The RoI features
    come by ``extract_type``, the mask features by mask-attention pooling
    when it is 'v1' (`clipself_tpu/eval/zero_shot.py:74-79`). A crop's
    feature is its CLS embedding, or with ``image_ave_pool`` the mean of its
    dense map (`encode_dense(normalize=True)`, as the JAX package calls it),
    L2-normalized in float32 (+1e-12)."""
    rois, maskpool = model.encode_rois_and_masks(
        images, boxes4, masks, normalize=True, extract_type=extract_type,
        mask_attn=extract_type == "v1",
    )
    b, m = crops.shape[:2]
    crop_flat = crops.reshape((b * m,) + tuple(crops.shape[2:]))
    if image_ave_pool:
        cf = model.encode_dense(crop_flat, keep_shape=True, normalize=True).mean(dim=(1, 2))
        norm = torch.linalg.vector_norm(cf.float(), dim=-1, keepdim=True) + 1e-12
        cf = cf / norm.to(cf.dtype)
    else:
        cf = model.encode_image(crop_flat, normalize=True)
    crop_feats = cf.reshape(b, m, -1)
    return tuple(f.float() @ emb.T for f in (rois, crop_feats, maskpool))


def evaluate_zero_shot(
    model: CLIP,
    dataloader: Iterable[dict],
    embeddings: np.ndarray,
    *,
    device: Union[str, torch.device],
    ann_bucket: int = DEFAULT_ANN_BUCKET,
    image_ave_pool: bool = False,
    extract_type: str = "v2",
) -> dict:
    """Run the evaluator over batches of images [B, H, W, 3], boxes [B, M, 8]
    (xyxy normalized, label, valid, _, is_thing), crops [B, M, h, w, 3] and
    gt_masks [B, M, gh, gw]; ``embeddings`` [K, C] is the text classifier
    (L2-normalized here), e.g. from `tools/text_embeddings.py`.
    ``ann_bucket`` = 0 disables bucketing; ``image_ave_pool`` scores each
    crop by its mean dense feature instead of its CLS embedding;
    ``extract_type`` 'v1' scores RoIs and masks by mask-attention pooling
    (the OpenCLIP ViT; the EVA tower has one RoI path)."""
    emb_np = np.array(embeddings, np.float32)
    emb_np /= np.linalg.norm(emb_np, axis=-1, keepdims=True) + 1e-12
    emb = torch.as_tensor(emb_np, device=device)

    def to_device(a) -> torch.Tensor:
        return torch.as_tensor(a, dtype=torch.float32, device=device)

    acc = {k: [] for k in ("rois", "crops", "maskpool")}
    all_labels, all_is_thing = [], []
    for batch in dataloader:
        boxes = np.asarray(batch["boxes"])
        if not (boxes[..., 5] > 0.5).any():
            continue  # fully padded batch: nothing to score
        width = _bucket_width(boxes, int(ann_bucket))
        boxes = boxes[:, :width]
        logits = batch_logits(
            model,
            emb,
            to_device(batch["images"]),
            to_device(boxes[..., :4]),
            to_device(batch["crops"][:, :width]),
            to_device(batch["gt_masks"][:, :width]),
            image_ave_pool,
            extract_type,
        )
        valid = boxes[..., 5].reshape(-1) > 0.5
        labels = boxes[..., 4].reshape(-1)[valid].astype(np.int64)
        for key, lg in zip(("rois", "crops", "maskpool"), logits):
            lg = lg.reshape(-1, emb_np.shape[0]).cpu().numpy()[valid]
            acc[key].append(_topk_correct(lg, labels))
        all_labels.append(labels)
        all_is_thing.append(boxes[..., 7].reshape(-1)[valid])

    if not all_labels:
        return {}
    labels = np.concatenate(all_labels)
    is_thing = np.concatenate(all_is_thing)
    results = {}
    for key in ("rois", "crops", "maskpool"):
        results.update(macc_with_is_thing(np.concatenate(acc[key]), is_thing, labels, key))
    return results
