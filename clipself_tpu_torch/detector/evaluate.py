"""Detector evaluation loop: batched prediction -> NumPy COCO or LVIS AP.

A port of `clipself_tpu/detector/evaluate.py` (mmdet `F-ViT/test.py` +
`CocoDatasetOV.evaluate` / the lvis-api `LVISEval`): per-image fused
detections are rescaled to original image coordinates and scored with the
COCO protocol (mAP / AP50 / AP75 and the open-vocabulary base / novel AP50
split) or, for LVIS with its frequency groups, the LVIS protocol
(`eval_lvis.py`: AP / APr / APc / APf); with a mask head the pasted masks are
scored the same way under `segm_`-prefixed keys. The mask rasters are
computed in NumPy and equal, bit for bit, what the JAX package gets from
`PIL.Image.resize` (`resize_bilinear_u8`, `resize_nearest`).

The `fvit-test` command line scores a detector checkpoint of either package
on a COCO- or LVIS-format annotation file, in bf16:

    python -m clipself_tpu_torch.detector.evaluate --ann-file <json> \
        --image-root <dir> --class-embed <.npy> --detector-checkpoint <.pkl>

``--device`` defaults to `cuda`; without a CUDA device that is an error, not
a CPU run. The metrics are printed and written (``--out``) as strict JSON, a
NaN as ``null`` (`metrics_json`), where the JAX command writes a bare NaN.
"""

from __future__ import annotations

import argparse
import logging
import pickle
import time
from typing import Optional, Sequence, Union

import numpy as np
import torch

from clipself_tpu_torch.detector.classes import base_novel_mask, coco_split, lvis_split, transfer_split
from clipself_tpu_torch.detector.config import PRESETS, FViTConfig
from clipself_tpu_torch.detector.data import DetectionDataset, collate
from clipself_tpu_torch.detector.eval_ap import DetectionEvaluator
from clipself_tpu_torch.detector.eval_lvis import LvisEvaluator
from clipself_tpu_torch.detector.fvit import FViTDetector, backbone_taps, create_detector
from clipself_tpu_torch.eval.zero_shot import metrics_json
from clipself_tpu_torch.data.transforms import resize_bilinear_u8, resize_nearest
from clipself_tpu_torch.models.factory import create_model
from clipself_tpu_torch.models.torch_io import detector_state_dict_from_jax, load_pretrained


def quantize_probs(prob) -> np.ndarray:
    """``(prob * 255)`` truncated to uint8, the product rounded in the
    probabilities' own dtype: a bfloat16 tensor's product rounds to bfloat16
    before the truncation, as NumPy rounds it on the JAX package's bfloat16
    arrays. ``prob``: a tensor (any device) or a NumPy array."""
    if isinstance(prob, torch.Tensor):
        return (prob.cpu() * 255).to(torch.uint8).numpy()
    return (np.asarray(prob) * 255).astype(np.uint8)


def _paste_u8(q: np.ndarray, box, out_hw: tuple[int, int]) -> np.ndarray:
    h, w = out_hw
    out = np.zeros((h, w), bool)
    x0, y0, x1, y1 = box
    x0i, y0i = int(np.floor(x0)), int(np.floor(y0))
    x1i, y1i = int(np.ceil(x1)), int(np.ceil(y1))
    bw, bh = max(x1i - x0i, 1), max(y1i - y0i, 1)
    m = resize_bilinear_u8(q, (bh, bw)).astype(np.float32) / 255.0 > 0.5
    xs0, ys0 = max(x0i, 0), max(y0i, 0)
    xs1, ys1 = min(x1i, w), min(y1i, h)
    if xs1 > xs0 and ys1 > ys0:
        out[ys0:ys1, xs0:xs1] = m[ys0 - y0i : ys1 - y0i, xs0 - x0i : xs1 - x0i]
    return out


def paste_mask(prob, box: np.ndarray, out_hw: tuple[int, int]) -> np.ndarray:
    """Paste a roi-space mask probability grid into a full-image boolean
    raster (mmdet FCNMaskHead.get_seg_masks semantics, 0.5 threshold): the
    grid as uint8 (`quantize_probs`), resized to the box's pixel footprint
    with Pillow's BILINEAR arithmetic, clipped to the raster."""
    return _paste_u8(quantize_probs(prob), box, out_hw)


def _resize_bool(m: np.ndarray, hw: tuple[int, int]) -> np.ndarray:
    """A gt mask raster resized to ``hw`` (NEAREST), as booleans."""
    return resize_nearest((m.astype(np.uint8) * 255) > 127, hw)


def make_predict_fn(det: FViTDetector, clip_model, cfg: FViTConfig, class_embed, base_mask):
    """predict(images [B, H, W, 3], valid_hw [B, 2]) -> `FViTDetector.predict`
    outputs, with the backbone's taps and dense VLM map from one trunk pass.
    ``class_embed`` and ``base_mask`` are tensors on the models' device."""

    @torch.inference_mode()
    def predict(images: torch.Tensor, valid_hw: torch.Tensor):
        taps, dense = backbone_taps(clip_model, images, cfg, True)
        return det.predict(taps, dense, class_embed, base_mask, None, valid_hw)

    return predict


def _evaluators(cfg: FViTConfig, split: dict, use_lvis: bool):
    """(box evaluator, mask evaluator or None) of the split's protocol."""
    if not use_lvis:
        ev_mask = DetectionEvaluator(cfg.num_classes, with_mask=True) if cfg.with_mask else None
        return DetectionEvaluator(cfg.num_classes, with_mask=False), ev_mask
    name_to_grp = {}
    for gi, g in enumerate(("rare", "common", "frequent")):
        for n_ in split["freq_groups"][g]:
            name_to_grp[n_] = gi
    freq_index = np.array([name_to_grp.get(n_, 2) for n_ in split["all"]])
    ev_mask = (
        LvisEvaluator(cfg.num_classes, freq_index=freq_index, with_mask=True)
        if cfg.with_mask
        else None
    )
    return LvisEvaluator(cfg.num_classes, freq_index=freq_index), ev_mask


def _gt_rasters(item: dict, gt_boxes: np.ndarray, gt_ignore: np.ndarray, hs: int, mask_stride: int):
    """(gt rasters, their ignore flags) at hs x hs: the first max_gt gts'
    masks resized, then any overflow gts beyond them as FILLED BOX rasters
    marked ignore, so that they are neither FN nor FP. Not zeros: a zero
    raster could never mask-IoU-match, so a detection segmenting an overflow
    gt would wrongly count as FP instead of being absorbed."""
    gv = item["gt_valid"]
    n_m = int(gv.sum())
    rasters = [_resize_bool(m, (hs, hs)) for m in item["gt_masks"][gv]]
    for b in gt_boxes[n_m:]:
        r = np.zeros((hs, hs), bool)
        x0, y0, x1, y1 = b / mask_stride
        r[int(y0): int(np.ceil(y1)), int(x0): int(np.ceil(x1))] = True
        rasters.append(r)
    return rasters, np.concatenate([gt_ignore[:n_m], np.ones(len(gt_boxes) - n_m, bool)])


def evaluate_detector(
    det: FViTDetector,
    clip_model,
    dataset: Sequence[dict],
    cfg: FViTConfig,
    class_embed,
    *,
    device: Union[str, torch.device],
    dataset_name: str = "coco",
    batch_size: int = 8,
    max_images: Optional[int] = None,
    mask_stride: int = 4,
    log_every: int = 50,
    split: Optional[dict] = None,
    timings: Optional[dict] = None,
) -> dict:
    """Score ``det`` over ``clip_model`` on a sequence of per-image items
    (`images`, `valid_hw`, `scale`, `_gt_boxes_full`, `_gt_labels_full`,
    `_gt_ignore_full`; LVIS also `_gt_areas_full`, `_neg_labels`,
    `_nel_labels`; with `cfg.with_mask` also `gt_valid` and `gt_masks`), both
    models already on ``device``. ``class_embed``: [K+1, D] array of unit
    rows, background last. OV-LVIS (``dataset_name="lvis"`` with a split that
    has `freq_groups`) is scored with the LVIS protocol, everything else with
    the COCO protocol; with `cfg.with_mask` the masks are pasted at stride
    ``mask_stride`` of the original image and scored under `segm_` keys.
    ``timings``: a dict to which the seconds spent in `predict` (synced), in
    the copy back, in pasting masks, in matching an image's detections and
    in the summaries (once a call) are added."""
    if split is None:
        split = coco_split() if dataset_name == "coco" else lvis_split()
    device = torch.device(device)
    # base / background rows fuse with alpha, novel with beta (all-True for
    # transfer vocabularies, where every class uses the base exponent)
    bm = torch.as_tensor(base_novel_mask(split=split), device=device)
    ce = torch.as_tensor(np.asarray(class_embed), dtype=torch.float32, device=device)
    predict = make_predict_fn(det, clip_model, cfg, ce, bm)
    # OV-LVIS is scored with the official LVIS protocol (federated pos/neg
    # image sets, per-image 300-det cap, not-exhaustive ignores), matching the
    # reference's lvis-api LVISEval use (`F-ViT/datasets/lvls_ov.py:120-180`);
    # everything else uses the COCO protocol.
    use_lvis = dataset_name == "lvis" and "freq_groups" in split
    ev, ev_mask = _evaluators(cfg, split, use_lvis)
    log = logging.getLogger("fvit-eval")
    spent = dict.fromkeys(("predict", "copy", "paste", "match", "summarize"), 0.0)
    sync = timings is not None and device.type == "cuda"

    n = len(dataset) if max_images is None else min(max_images, len(dataset))
    t0 = time.time()
    for start in range(0, n, batch_size):
        real = min(batch_size, n - start)
        # the last partial batch is padded by repeating its final item (the
        # padded copies are not scored): no image is dropped
        items = [dataset[min(start + j, start + real - 1)] for j in range(batch_size)]
        batch = collate(items)
        tick = time.perf_counter()
        out = predict(
            torch.as_tensor(batch["images"], device=device),
            torch.as_tensor(batch["valid_hw"], device=device),
        )
        if sync:
            torch.cuda.synchronize(device)
        tock = time.perf_counter()
        spent["predict"] += tock - tick
        boxes, scores = out[0].float().cpu().numpy(), out[1].float().cpu().numpy()
        labels = out[2].cpu().numpy()
        # the probabilities in their own dtype, then quantised as paste_mask does
        probs = quantize_probs(out[3]) if cfg.with_mask else None
        tick = time.perf_counter()
        spent["copy"] += tick - tock
        for bi, item in enumerate(items[:real]):
            ok = scores[bi] > 0.0
            s = float(item["scale"])
            det_boxes = boxes[bi][ok] / s
            det_scores = scores[bi][ok]
            det_labels = labels[bi][ok]
            # full (unpadded) gt set in original coordinates; crowd = ignore
            gt_boxes = item["_gt_boxes_full"]
            gt_labels = item["_gt_labels_full"]
            gt_ignore = item["_gt_ignore_full"]
            if use_lvis:
                lvis_kw = dict(
                    neg_labels=item["_neg_labels"], not_exhaustive_labels=item["_nel_labels"]
                )
                ev.add_image(
                    det_boxes, det_scores, det_labels, gt_boxes, gt_labels,
                    gt_areas=item["_gt_areas_full"], **lvis_kw,
                )
            else:
                ev.add_image(det_boxes, det_scores, det_labels, gt_boxes, gt_labels, gt_ignore)
            if ev_mask is None:
                continue
            tock = time.perf_counter()
            spent["match"] += tock - tick
            hs = int(np.ceil(cfg.image_size / s / mask_stride))
            det_m = [
                _paste_u8(probs[bi][j], boxes[bi][j] / s / mask_stride, (hs, hs))
                for j in np.where(ok)[0]
            ]
            gt_m, ign_m = _gt_rasters(item, gt_boxes, gt_ignore, hs, mask_stride)
            tick = time.perf_counter()
            spent["paste"] += tick - tock
            g = len(ign_m)
            if use_lvis:
                ev_mask.add_image(
                    det_boxes, det_scores, det_labels, gt_boxes[:g], gt_labels[:g],
                    gt_areas=item["_gt_areas_full"][:g], det_masks=det_m, gt_masks=gt_m,
                    gt_ignore=ign_m, **lvis_kw,
                )
            else:
                ev_mask.add_image(
                    det_boxes, det_scores, det_labels, gt_boxes[:g], gt_labels[:g], ign_m,
                    det_masks=det_m, gt_masks=gt_m,
                )
        spent["match"] += time.perf_counter() - tick
        if (start // batch_size + 1) % log_every == 0:
            log.info(f"eval {start + real}/{n} ({(start + real) / (time.time() - t0):.1f} img/s)")

    tick = time.perf_counter()
    if use_lvis:
        metrics = ev.summarize()
        if ev_mask is not None:
            metrics.update({f"segm_{k}": v for k, v in ev_mask.summarize().items()})
    else:
        kw = dict(
            class_names=split["all"], base_classes=split["seen"],
            novel_classes=split["unseen"], groups=split.get("freq_groups"),
        )
        metrics = ev.summarize(**kw)
        if ev_mask is not None:
            metrics.update({f"segm_{k}": v for k, v in ev_mask.summarize(**kw).items()})
    spent["summarize"] += time.perf_counter() - tick
    if timings is not None:
        for k, v in spent.items():
            timings[k] = timings.get(k, 0.0) + v
    return metrics


def load_detector(path: str) -> dict[str, torch.Tensor]:
    """A detector checkpoint written by either package's `save_detector` (a
    pickle whose `params` maps 'a/b/c' flax paths to arrays) -> the state
    dict of the port's `FViTDetector`, to load with ``strict=True``."""
    with open(path, "rb") as f:
        blob = pickle.load(f)
    tree: dict = {}
    for key, val in blob["params"].items():
        parts = key.split("/")
        node = tree
        for p_ in parts[:-1]:
            node = node.setdefault(p_, {})
        node[parts[-1]] = np.asarray(val)
    return detector_state_dict_from_jax(tree)


def parse_args(argv=None):
    p = argparse.ArgumentParser("fvit-test")
    p.add_argument("--preset", default="ov_coco_vitb16", choices=sorted(PRESETS))
    p.add_argument("--dataset", default=None,
                   choices=["coco", "lvis", "voc", "objects365"],
                   help="class-split registry; inferred from --preset when "
                   "omitted. Transfer presets use the full target vocabulary "
                   "(reference configs/transfer/*)")
    p.add_argument("--ann-file", required=True)
    p.add_argument("--image-root", required=True)
    p.add_argument("--class-embed", required=True)
    p.add_argument("--clip-checkpoint", default=None, help="distilled CLIP .pt / .npz")
    p.add_argument("--detector-checkpoint", required=True)
    p.add_argument("--batch-size", type=int, default=8)
    p.add_argument("--max-images", type=int, default=None)
    p.add_argument("--out", default=None)
    p.add_argument("--device", default="cuda", help="torch device, e.g. cuda, cuda:1, cpu")
    return p.parse_args(argv)


def main(argv=None) -> dict:
    """Score ``--detector-checkpoint`` on the annotation file (the JAX
    `fvit-test`, bf16). Returns the metrics."""
    from clipself_tpu_torch.train.main import _device

    args = parse_args(argv)
    device = _device(args.device)
    logging.basicConfig(level=logging.INFO)

    cfg = PRESETS[args.preset]
    is_transfer = args.preset.startswith("transfer_")
    if args.dataset is None:
        if is_transfer:
            args.dataset = args.preset.split("_")[1]
        else:
            args.dataset = "lvis" if "lvis" in args.preset else "coco"
    if is_transfer:
        split = transfer_split(args.dataset)
    elif args.dataset == "coco":
        split = coco_split()
    elif args.dataset == "lvis":
        split = lvis_split()
    else:
        raise SystemExit(f"--dataset {args.dataset} requires a transfer_* preset")
    if len(split["all"]) != cfg.num_classes:
        raise SystemExit(
            f"--dataset {args.dataset} has {len(split['all'])} classes but "
            f"preset {args.preset} expects {cfg.num_classes}"
        )
    clip_model = create_model(cfg.clip_model, device=device, dtype=torch.bfloat16)
    if args.clip_checkpoint:
        load_pretrained(clip_model, args.clip_checkpoint)
    clip_model.requires_grad_(False)
    det = create_detector(cfg, device=device)
    det.load_state_dict(load_detector(args.detector_checkpoint), strict=True)
    ce = np.load(args.class_embed).astype(np.float32)
    k = len(split["all"])
    if ce.shape != (k + 1, cfg.embed_dim):
        raise SystemExit(
            f"--class-embed {args.class_embed} has shape {ce.shape}; "
            f"preset {args.preset} needs ({k + 1}, {cfg.embed_dim}) — "
            f"{k} classes + background"
        )
    ce = ce / np.linalg.norm(ce, axis=-1, keepdims=True)
    ds = DetectionDataset(
        args.ann_file, args.image_root, split["all"],
        image_size=cfg.image_size, max_gt=cfg.max_gt, train=False,
        with_mask=cfg.with_mask,
    )
    metrics = evaluate_detector(
        det, clip_model, ds, cfg, ce, device=device,
        dataset_name=args.dataset, batch_size=args.batch_size,
        max_images=args.max_images, split=split,
    )
    print(metrics_json(metrics, indent=2))
    if args.out:
        with open(args.out, "w") as f:
            f.write(metrics_json(metrics))
    return metrics


if __name__ == "__main__":
    main()
