"""Detection data: COCO-format files to fixed-shape items, and synthetic
batches.

`DetectionDataset` (with `normalize_image`, `rle_decode` and `collate`) is
the port of `clipself_tpu/detector/data.py:24-321` (the reference mmdet
pipeline, `F-ViT/configs/ov_coco/...eva_original.py:150-196`): train items
take a random-ratio keep-ratio resize (0.1-2.0x of the 640 fit), a bounded
random crop and a horizontal flip, eval items a keep-ratio fit padded
bottom-right; both are ImageNet-normalised and padded to ``max_gt`` boxes,
deterministic per (seed, epoch, index). It reads images with
`data/image_io.py::decode_image` (PNG everywhere, JPEG through the native
core where it builds) and resizes and rasterises with Pillow's arithmetic in
NumPy (`data/transforms.py::resize_bilinear`, `resize_bilinear_u8`,
`data/draw.py::polygon`), so every item is EQUAL, key for key and dtype for
dtype, to the JAX package's (`tests/test_torch_detector_data.py`).

`collate` and `SyntheticDetectionData` are copies of
`clipself_tpu/detector/data.py:324-366` with the same generator calls in the
same order, so the same seed gives the same arrays
(`tests/test_torch_detector_eval.py` pins it). `synthetic_eval_items` cuts
one such batch into the per-image items `evaluate_detector` reads, the
format of `DetectionDataset`'s eval items; with a seed it also draws what an
LVIS item carries (annotation areas, the federated negative and
not-exhaustive labels) and a resize scale other than 1. `lvis_ground_truth`
redraws a batch's ground truth to LVIS v1's density (annotations and
classes an image). `synthetic_nms_case` makes the score-ordered candidate
boxes that the NMS kernel is checked on (`chip_smoke.py`,
`tests/test_torch_kernels_cuda.py`).
"""

from __future__ import annotations

import os
from typing import Optional, Sequence

import numpy as np
import torch

from clipself_tpu_torch.data import draw
from clipself_tpu_torch.data.coco import COCOIndex
from clipself_tpu_torch.data.image_io import decode_image
from clipself_tpu_torch.data.transforms import resize_bilinear, resize_bilinear_u8
from clipself_tpu_torch.detector.anchors import grid_anchors
from clipself_tpu_torch.detector.boxes import decode_boxes
from clipself_tpu_torch.detector.classes import lvis_split

# LVIS v1 train has 100,170 images (lvisdataset.org, the v1 release). Its
# annotations and image-class pairs are the sums of `instance_count` and
# `image_count` over `lvis_v1_train_cat_norare_info.json`: 1,270,141 and
# 359,456, so 12.68 annotations over 3.59 classes an image.
LVIS_TRAIN_IMAGES = 100170


IMAGENET_MEAN = np.array([123.675, 116.28, 103.53], np.float32)
IMAGENET_STD = np.array([58.395, 57.12, 57.375], np.float32)


def normalize_image(arr: np.ndarray) -> np.ndarray:
    """The mmdet normalisation of the detector (ImageNet mean and std,
    config lines 166-169), not the CLIP one of the distillation pipelines."""
    return (arr.astype(np.float32) - IMAGENET_MEAN) / IMAGENET_STD


def rle_decode(rle: dict) -> np.ndarray:
    """Decode a COCO RLE segmentation (crowd regions) to a binary [H, W]
    uint8 mask. Handles both uncompressed (counts = list) and the compressed
    LEB128-style string encoding pycocotools produces."""
    h, w = rle["size"]
    counts = rle["counts"]
    if isinstance(counts, str):
        counts = _rle_uncompress(counts)
    mask = np.zeros(h * w, np.uint8)
    pos = 0
    val = 0
    for c in counts:
        if val:
            mask[pos : pos + c] = 1
        pos += c
        val ^= 1
    return mask.reshape(w, h).T  # COCO RLE is column-major


def _rle_uncompress(s: str) -> list[int]:
    """pycocotools' compressed counts string -> run lengths."""
    counts = []
    i = 0
    while i < len(s):
        x = 0
        k = 0
        more = True
        while more:
            c = ord(s[i]) - 48
            x |= (c & 0x1F) << (5 * k)
            more = bool(c & 0x20)
            i += 1
            k += 1
        if x & (1 << (5 * k - 1)):  # sign-extend
            x |= -1 << (5 * k)
        if len(counts) > 2:
            x += counts[-2]
        counts.append(x)
    return counts


class DetectionDataset:
    """COCO-style detection dataset with open-vocabulary class mapping.

    Labels are contiguous indices into `class_names` (the all-classes order
    used by the text-embedding matrix). Annotations whose category name is
    not in `class_names` are dropped. Images are RGB uint8 arrays where the
    JAX package holds PIL images."""

    def __init__(
        self,
        ann_file: str,
        image_root: str,
        class_names: Sequence[str],
        image_size: int = 640,
        max_gt: int = 100,
        train: bool = True,
        ratio_range: tuple[float, float] = (0.1, 2.0),
        min_gt_size: float = 0.01,
        seed: int = 0,
        with_mask: bool = False,
    ):
        self.coco = COCOIndex(ann_file)
        self.image_root = image_root
        self.class_names = list(class_names)
        self.image_size = image_size
        self.max_gt = max_gt
        self.train = train
        self.ratio_range = ratio_range
        self.min_gt_size = min_gt_size
        self.seed = seed
        self.epoch = 0
        self.with_mask = with_mask
        name_to_label = {n: i for i, n in enumerate(self.class_names)}
        self.cat_to_label = {
            cid: name_to_label[c["name"]]
            for cid, c in self.coco.cats.items()
            if c["name"] in name_to_label
        }
        if train:
            # keep images that have at least one mapped annotation
            self.image_ids = [
                i
                for i in self.coco.image_ids
                if any(a["category_id"] in self.cat_to_label for a in self.coco.img_to_anns[i])
            ]
        else:
            self.image_ids = self.coco.image_ids

    def set_epoch(self, epoch: int):
        self.epoch = epoch

    def __len__(self):
        return len(self.image_ids)

    def _rng(self, idx: int) -> np.random.Generator:
        return np.random.default_rng((self.seed, self.epoch, idx))

    def _load(self, image_id, keep_crowd: bool = False):
        img = decode_image(os.path.join(self.image_root, self.coco.file_name(image_id)))
        anns = [
            a
            for a in self.coco.img_to_anns[image_id]
            if a["category_id"] in self.cat_to_label
            and (keep_crowd or not a.get("iscrowd", 0))
        ]
        boxes = np.array(
            [[a["bbox"][0], a["bbox"][1], a["bbox"][0] + a["bbox"][2], a["bbox"][1] + a["bbox"][3]] for a in anns],
            np.float32,
        ).reshape(-1, 4)
        labels = np.array([self.cat_to_label[a["category_id"]] for a in anns], np.int64)
        crowd = np.array([bool(a.get("iscrowd", 0)) for a in anns], bool)
        return img, boxes, labels, crowd, anns

    def _pad_item(self, arr, boxes, labels, scale, image_id, masks=None):
        g = self.max_gt
        out_boxes = np.zeros((g, 4), np.float32)
        out_labels = np.zeros((g,), np.int64)
        out_valid = np.zeros((g,), bool)
        n = min(len(boxes), g)
        out_boxes[:n] = boxes[:n]
        out_labels[:n] = labels[:n]
        out_valid[:n] = True
        item = {
            "images": arr,
            "gt_boxes": out_boxes,
            "gt_labels": out_labels,
            "gt_valid": out_valid,
            "scale": np.float32(scale),
            "image_id": np.int64(image_id if isinstance(image_id, (int, np.integer)) else 0),
        }
        if masks is not None:
            ms = self.image_size // 4
            # uint8 rasters: 4x less host memory and copy to the card than
            # f32; the loss casts on the card
            out_masks = np.zeros((g, ms, ms), np.uint8)
            for i in range(n):
                out_masks[i] = masks[i]
            item["gt_masks"] = out_masks
        return item

    def __getitem__(self, idx: int) -> dict:
        image_id = self.image_ids[idx]
        if self.train:
            # crowd regions are excluded from training targets (mmdet routes
            # them to gt_bboxes_ignore; with fixed-shape targets they drop)
            img, boxes, labels, _, anns = self._load(image_id, keep_crowd=False)
            return self._train_item(idx, image_id, img, boxes, labels, anns)
        # eval: keep-ratio fit, pad bottom-right; crowd gts kept as IGNORE
        img, boxes, labels, crowd, anns = self._load(image_id, keep_crowd=True)
        s = self.image_size
        h0, w0 = img.shape[:2]
        scale = min(s / w0, s / h0)
        nw, nh = int(round(w0 * scale)), int(round(h0 * scale))
        arr = np.zeros((s, s, 3), np.float32)
        arr[:nh, :nw] = normalize_image(resize_bilinear(img, (nw, nh)))
        masks = None
        if self.with_mask:
            # only the first max_gt rasters are kept by _pad_item
            masks = [
                self._rasterize_mask(a, scale, (0, 0), (nh, nw), flip=False)
                for a in anns[: self.max_gt]
            ]
        item = self._pad_item(arr, boxes * scale, labels, scale, image_id, masks)
        # the full (unpadded, original-coordinate) gt set for the evaluator;
        # keys with a leading underscore are skipped by collate()
        item["_gt_boxes_full"] = boxes
        item["_gt_labels_full"] = labels
        item["_gt_ignore_full"] = crowd
        # LVIS protocol fields: annotation (polygon) areas and the image's
        # federated neg / not-exhaustive category sets mapped to contiguous
        # labels (lvis-api `LVISEval._prepare`); plain COCO JSONs lack them
        item["_gt_areas_full"] = np.array(
            [
                a.get("area", (a["bbox"][2] * a["bbox"][3]))
                for a in self.coco.img_to_anns[image_id]
                if a["category_id"] in self.cat_to_label
            ],
            np.float64,
        )
        info = self.coco.imgs[image_id]
        item["_neg_labels"] = sorted(
            self.cat_to_label[c]
            for c in info.get("neg_category_ids", [])
            if c in self.cat_to_label
        )
        item["_nel_labels"] = sorted(
            self.cat_to_label[c]
            for c in info.get("not_exhaustive_category_ids", [])
            if c in self.cat_to_label
        )
        item["valid_hw"] = np.asarray([nh, nw], np.float32)
        return item

    def _train_item(self, idx, image_id, img, boxes, labels, anns):
        rng = self._rng(idx)
        s = self.image_size
        # random-ratio keep-ratio resize: ratio * fit-640 scale
        ratio = rng.uniform(*self.ratio_range)
        h0, w0 = img.shape[:2]
        scale = ratio * min(s / w0, s / h0)
        nw = max(int(round(w0 * scale)), 1)
        nh = max(int(round(h0 * scale)), 1)
        boxes = boxes * scale

        # bounded random crop to at most s x s (the window alone is resized)
        cw, ch = min(nw, s), min(nh, s)
        x0 = int(rng.integers(0, nw - cw + 1))
        y0 = int(rng.integers(0, nh - ch + 1))
        img = resize_bilinear(img, (nw, nh), window=(x0, y0, x0 + cw, y0 + ch))
        boxes = boxes - np.array([x0, y0, x0, y0], np.float32)
        boxes[:, 0::2] = boxes[:, 0::2].clip(0, cw)
        boxes[:, 1::2] = boxes[:, 1::2].clip(0, ch)

        # horizontal flip
        do_flip = rng.uniform() < 0.5
        if do_flip:
            img = img[:, ::-1]
            flipped = boxes.copy()
            flipped[:, 0] = cw - boxes[:, 2]
            flipped[:, 2] = cw - boxes[:, 0]
            boxes = flipped

        # drop degenerate boxes (FilterAnnotations min_gt_bbox_wh)
        wh = boxes[:, 2:] - boxes[:, :2]
        keep = (wh > self.min_gt_size).all(axis=1)
        boxes, labels = boxes[keep], labels[keep]
        kept_anns = [a for a, k in zip(anns, keep) if k] if self.with_mask else None

        arr = np.zeros((s, s, 3), np.float32)
        arr[:ch, :cw] = normalize_image(img)

        masks = None
        if self.with_mask:
            masks = [
                self._rasterize_mask(a, scale, (x0, y0), (ch, cw), flip=do_flip)
                for a in kept_anns
            ]
        item = self._pad_item(arr, boxes, labels, scale, image_id, masks)
        item["valid_hw"] = np.asarray([ch, cw], np.float32)
        return item

    def _rasterize_mask(self, ann, scale, crop_xy, crop_hw, flip: bool = False):
        """Polygon segmentation -> stride-4 binary raster in crop coords
        (mirrored when the hflip augmentation fired, so mask targets stay
        aligned with the flipped image and boxes)."""
        ms = self.image_size // 4
        out = np.zeros((ms, ms), np.float32)
        seg = ann.get("segmentation")
        if isinstance(seg, dict) and "counts" in seg:
            # RLE (crowd regions): decode, then resample to the raster
            full = rle_decode(seg)
            # map original pixels -> raster frame: scale then 1/4
            rw = max(int(round(full.shape[1] * scale / 4.0)), 1)
            rh = max(int(round(full.shape[0] * scale / 4.0)), 1)
            small = resize_bilinear_u8(full * 255, (rh, rw)) > 127
            # place into the (possibly cropped) raster
            ox = int(round(crop_xy[0] / 4.0))
            oy = int(round(crop_xy[1] / 4.0))
            ys, xs = min(rh - oy, ms), min(rw - ox, ms)
            if ys > 0 and xs > 0:
                out[:ys, :xs] = small[oy : oy + ys, ox : ox + xs]
            if flip:
                # mirror about the CROP width (as the polygon and box paths
                # do), not the full raster
                cwr = min(ms, max(int(round(crop_hw[1] / 4.0)), 1))
                out[:, :cwr] = out[:, :cwr][:, ::-1]
            return out
        if not isinstance(seg, list):
            return out
        raster = np.zeros((ms, ms), bool)
        cw = crop_hw[1]
        for poly in seg:
            pts = np.asarray(poly, np.float32).reshape(-1, 2)
            pts = pts * scale - np.asarray(crop_xy, np.float32)
            if flip:
                pts[:, 0] = cw - pts[:, 0]
            pts = pts / 4.0
            if len(pts) >= 3:
                draw.polygon(raster, pts)
        out[:] = raster
        return out


def collate(items: list[dict]) -> dict:
    """Stack batchable keys; underscore-prefixed keys (variable-length
    per-image eval metadata) are per-item and skipped."""
    return {
        k: np.stack([it[k] for it in items])
        for k in items[0]
        if not k.startswith("_")
    }


class SyntheticDetectionData:
    """Fixed-shape random detection batches for smoke tests and benches."""

    def __init__(self, num_classes: int, image_size=640, max_gt=20, seed=0, with_mask=False):
        self.num_classes = num_classes
        self.image_size = image_size
        self.max_gt = max_gt
        self.seed = seed
        self.with_mask = with_mask
        self._calls = 0

    def batch(self, batch_size: int) -> dict:
        # fold a call counter into the seed: successive batches differ
        rng = np.random.default_rng((self.seed, self._calls))
        self._calls += 1
        b, g, s = batch_size, self.max_gt, self.image_size
        xy = rng.uniform(0, s * 0.6, size=(b, g, 2)).astype(np.float32)
        wh = rng.uniform(8, s * 0.3, size=(b, g, 2)).astype(np.float32)
        out = {
            "images": rng.normal(size=(b, s, s, 3)).astype(np.float32),
            "gt_boxes": np.concatenate([xy, np.clip(xy + wh, None, s)], -1),
            "gt_labels": rng.integers(0, self.num_classes, size=(b, g)),
            "gt_valid": rng.uniform(size=(b, g)) < 0.7,
            "scale": np.ones((b,), np.float32),
            "image_id": np.arange(b, dtype=np.int64),
            "valid_hw": np.full((b, 2), float(s), np.float32),
        }
        if self.with_mask:
            out["gt_masks"] = (
                rng.uniform(size=(b, g, s // 4, s // 4)) < 0.3
            ).astype(np.uint8)
        return out


def lvis_ground_truth(batch: dict, seed: int) -> dict:
    """A copy of a 1203-class batch whose ground truth has LVIS v1's density
    (`LVIS_TRAIN_IMAGES`): an image holds Poisson(12.68) annotations, at
    least 1 and at most the batch's slots, in its first slots; they cover
    min(annotations, 1 + Poisson(2.59)) distinct classes (3.59 an image on
    average before that cap), drawn without replacement in proportion to
    each class's `image_count`; every class takes one annotation and the
    rest are spread uniformly over them. Only the means are LVIS's, not the
    shapes of the distributions. Boxes and masks stay the batch's."""
    info = lvis_split()["cat_info"]
    image_count = np.array([c["image_count"] for c in info], np.float64)
    per_image = image_count.sum() / LVIS_TRAIN_IMAGES
    anns = sum(c["instance_count"] for c in info) / LVIS_TRAIN_IMAGES
    rng = np.random.default_rng(seed)
    out = dict(batch, gt_valid=np.zeros_like(batch["gt_valid"]), gt_labels=batch["gt_labels"].copy())
    slots = batch["gt_valid"].shape[1]
    for i in range(len(out["gt_valid"])):
        n = int(np.clip(rng.poisson(anns), 1, slots))
        k = min(n, 1 + int(rng.poisson(per_image - 1)))
        present = rng.choice(len(info), size=k, replace=False, p=image_count / image_count.sum())
        out["gt_valid"][i, :n] = True
        out["gt_labels"][i, :n] = np.concatenate([present, rng.choice(present, size=n - k)])
    return out


def synthetic_eval_items(
    batch: dict, num_classes: Optional[int] = None, seed: int = 0
) -> list[dict]:
    """One item per image of a `SyntheticDetectionData.batch`: its batchable
    keys plus the full (unpadded) ground truth in original coordinates under
    `_gt_boxes_full`, `_gt_labels_full`, `_gt_ignore_full` (no crowd
    regions), as `evaluate_detector` reads them.

    With ``num_classes`` (the vocabulary), every key that
    `DetectionDataset.__getitem__` gives an eval item
    (`clipself_tpu/detector/data.py:176-226`) is drawn from ``seed``: a
    `scale` in [0.5, 1.5) (the batch is then the image resized by it, so
    `_gt_boxes_full` is the boxes divided by it), `_gt_areas_full` (an
    annotation's area, 30-100% of its original box's), `_neg_labels` (up to
    8 classes absent from the image) and `_nel_labels` (up to 2 of its
    classes), each sorted; `gt_masks` stay those of the batch. No source in
    the repository gives LVIS's counts of negative and not-exhaustive labels
    an image or its areas against boxes: these three are not LVIS's."""
    rng = None if num_classes is None else np.random.default_rng(seed)
    items = []
    for i in range(len(batch["images"])):
        item = {k: v[i] for k, v in batch.items()}
        valid = item["gt_valid"]
        labels = item["gt_labels"][valid]
        if rng is not None:
            item["scale"] = np.float32(rng.uniform(0.5, 1.5))
        item["_gt_boxes_full"] = item["gt_boxes"][valid] / item["scale"]
        item["_gt_labels_full"] = labels
        item["_gt_ignore_full"] = np.zeros(int(valid.sum()), bool)
        if rng is not None:
            b = item["_gt_boxes_full"].astype(np.float64)
            area = (b[:, 2] - b[:, 0]) * (b[:, 3] - b[:, 1])
            item["_gt_areas_full"] = area * rng.uniform(0.3, 1.0, len(b))
            absent = np.setdiff1d(np.arange(num_classes), labels)
            neg = rng.choice(absent, size=min(8, len(absent)), replace=False)
            item["_neg_labels"] = sorted(int(c) for c in neg)
            present = np.unique(labels)
            nel = rng.choice(present, size=min(2, len(present)), replace=False)
            item["_nel_labels"] = sorted(int(c) for c in nel)
        items.append(item)
    return items


def synthetic_nms_case(
    kind: str, b: int, n: int, seed: int, classes: int = 65, side: int = 640
) -> tuple[torch.Tensor, torch.Tensor]:
    """Score-ordered boxes [b, n, 4] and validity [b, n] of one kind, on the
    CPU, in the ``side`` x ``side`` frame of a preset (640: `ov_coco_vitb16`,
    896: the L/14 presets).

    'anchors': RPN anchors of the stride-16 level decoded with small deltas
    and clipped, so neighbours overlap densely around the RPN's IoU 0.7;
    'plain': boxes spread over the image; 'class_offset': those shifted by
    label x span, as `multiclass_nms` shifts its ``classes`` classes apart
    (65 for OV-COCO, 1203 for OV-LVIS: offsets up to ~1.08e6 at 896, where a
    float32 ULP is 0.125); 'invalid_tail' / 'invalid_any' / 'none_valid':
    anchors or spread boxes with invalid slots; 'identical', 'duplicates'
    (every box twice), 'zero_area' (every third box degenerate): ties and
    empty boxes."""
    gen = torch.Generator().manual_seed(seed)
    valid = torch.ones(b, n, dtype=torch.bool)
    f = side / 640
    if kind in ("anchors", "invalid_tail"):
        grid = side // 16
        anchors = torch.from_numpy(grid_anchors(grid, grid, 16, (8.0,), (0.5, 1.0, 2.0)))
        pick = torch.stack([torch.randperm(len(anchors), generator=gen)[:n] for _ in range(b)])
        deltas = torch.randn(b, n, 4, generator=gen) * 0.1
        boxes = decode_boxes(anchors[pick], deltas, max_shape=(side, side))
    else:
        lo = torch.rand(b, n, 2, generator=gen) * (500 * f)
        boxes = torch.cat([lo, lo + 8 * f + torch.rand(b, n, 2, generator=gen) * (190 * f)], -1)
    if kind == "class_offset":
        label = torch.randint(0, classes, (b, n, 1), generator=gen).float()
        boxes = boxes + label * (boxes.amax(dim=(1, 2), keepdim=True) + 1.0)
    elif kind == "invalid_tail":
        valid[:, n - n // 5:] = False
    elif kind == "invalid_any":
        valid = torch.rand(b, n, generator=gen) < 0.7
    elif kind == "none_valid":
        valid[:] = False
    elif kind == "identical":
        boxes = boxes[:, :1].expand(b, n, 4).contiguous()
    elif kind == "zero_area":
        boxes[:, ::3, 2:] = boxes[:, ::3, :2]
    elif kind == "duplicates":
        boxes = boxes[:, : (n + 1) // 2].repeat_interleave(2, dim=1)[:, :n].contiguous()
    elif kind not in ("plain", "anchors"):
        raise ValueError(f"unknown kind {kind!r}")
    return boxes, valid
