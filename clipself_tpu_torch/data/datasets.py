"""COCO-style datasets for distillation training and panoptic evaluation (a
port of `clipself_tpu/data/datasets.py` without PIL).

Every item is a dict of padded float32 NumPy arrays (max_anns boxes with
validity flags), equal to the JAX package's item for the same files, seed,
epoch and index: images are read by `data/image_io.py` and transformed by
`data/transforms.py`, which reproduce Pillow's pixels. Randomness is derived
from (seed, epoch, index), so an item does not depend on which worker
process made it. The datasets hold no tensors: worker processes build the
items.

Item schemas:
  GridDistillDataset / ProposalDistillDataset ->
    images [S,S,3], boxes [M,5] (xyxy normalized + valid), crops [M,s,s,3]
  RegionCLIPDataset -> images [S,S,3], boxes [M,6] (xyxy, cls, valid)
  COCOPanopticEvalDataset -> images, boxes [M,8] (xyxy, cls, valid, area,
    isthing), crops, gt_masks [M,S/d,S/d], masked_crops
"""

from __future__ import annotations

import os
from typing import Optional

import numpy as np

from clipself_tpu_torch.core.constants import MASKED_CROP_FILL
from clipself_tpu_torch.data.coco import COCOIndex, COCOPanopticIndex, mask2box, rgb2id
from clipself_tpu_torch.data.image_io import open_image, read_png
from clipself_tpu_torch.data.transforms import (
    RandomCrop,
    RandomHFlip,
    RandomResize,
    crop,
    crop_transform,
    det_transform,
    get_scale,
    image_size,
    resize_mask_longest,
)


class _DistillBase:
    """Shared plumbing: image IO, epoch-aware RNG, fixed-shape templates."""

    def __init__(self, input_filename, image_root, det_size, crop_size, max_anns, seed=0):
        self.coco = COCOIndex(input_filename)
        self.image_root = image_root
        self.det_size = det_size
        self.crop_size = crop_size
        self.max_anns = max_anns
        self.seed = seed
        self.epoch = 0
        self.image_ids = self.coco.image_ids

    def set_epoch(self, epoch: int):
        self.epoch = epoch

    def __len__(self):
        return len(self.image_ids)

    def _rng(self, idx: int) -> np.random.Generator:
        return np.random.default_rng((self.seed, self.epoch, idx))

    def plan_item(self, idx: int):
        """Native-loader plan; None = this dataset/item needs the NumPy path."""
        return None

    def _read(self, idx: int) -> tuple[np.ndarray, int]:
        """Read the image of ``idx``; an unreadable one is replaced by another
        index drawn from a generator of its own (`data.py:94-97`, made
        deterministic), up to 10 tries."""
        rng = self._rng(idx)
        for _ in range(10):
            image_id = self.image_ids[idx]
            name = self.coco.file_name(image_id)
            img = open_image(os.path.join(self.image_root, name))
            if img is not None:
                return img, idx
            idx = int(rng.integers(0, len(self)))
        raise RuntimeError("too many unreadable images")


class GridDistillDataset(_DistillBase):
    """Random M x N grid cells as pseudo-boxes (reference `GridDistillDataset`,
    `data.py:135-281`)."""

    def __init__(
        self,
        input_filename: str,
        image_root: str,
        det_size: int = 1024,
        crop_size: int = 224,
        max_split: int = 16,
        max_anns: int = 20,
        crop_scale: float = 1.0,
        pre_transforms: bool = False,
        train_ratio: float = 1.0,
        seed: int = 0,
    ):
        super().__init__(input_filename, image_root, det_size, crop_size, max_anns, seed)
        self.crop_scale = crop_scale
        # choices {(m, n): ceil(m/2) <= n <= min(2m, max_split)} (data.py:200-205)
        self.choices = [
            (m, n)
            for m in range(1, max_split + 1)
            for n in range((m + 1) // 2, min(m * 2 + 1, max_split + 1))
        ]
        if train_ratio < 1.0:
            rng = np.random.default_rng(seed)
            ids = list(self.image_ids)
            rng.shuffle(ids)
            self.image_ids = ids[: int(len(ids) * train_ratio)]
        if pre_transforms:
            self.pre = [RandomResize((0.5, 2.0)), RandomCrop(det_size), RandomHFlip()]
        else:
            self.pre = None

    @staticmethod
    def _grid_boxes(m: int, n: int) -> np.ndarray:
        """Normalized xyxy boxes of an m-rows x n-cols grid (data.py:210-224)."""
        xs = np.linspace(0, 1, n + 1)
        ys = np.linspace(0, 1, m + 1)
        x0, y0 = np.meshgrid(xs[:-1], ys[:-1])
        x1, y1 = np.meshgrid(xs[1:], ys[1:])
        return np.stack([x0, y0, x1, y1], axis=-1).reshape(-1, 4).astype(np.float32)

    def _plan_grid(self, rng, img_w: int, img_h: int):
        """Sample the grid and produce (pixel boxes, crop windows). Pure
        metadata: usable without decoding the image."""
        m, n = self.choices[int(rng.integers(0, len(self.choices)))]
        normed = self._grid_boxes(m, n)
        order = rng.permutation(len(normed))[: self.max_anns]
        boxes_px = normed[order] * np.asarray([img_w, img_h, img_w, img_h], np.float32)
        crop_windows = boxes_px.copy()
        if self.crop_scale > 1.0:
            cx = (boxes_px[:, 0] + boxes_px[:, 2]) / 2
            cy = (boxes_px[:, 1] + boxes_px[:, 3]) / 2
            bw = boxes_px[:, 2] - boxes_px[:, 0]
            bh = boxes_px[:, 3] - boxes_px[:, 1]
            d = 0.5 * self.crop_scale
            crop_windows = np.stack(
                [
                    np.clip(cx - bw * d, 0, None), np.clip(cy - bh * d, 0, None),
                    np.clip(cx + bw * d, None, img_w), np.clip(cy + bh * d, None, img_h),
                ],
                axis=-1,
            ).astype(np.float32)
        return boxes_px, crop_windows

    def plan_item(self, idx: int) -> Optional[dict]:
        """Native-loader plan: (path, normalized padded-frame boxes, pixel
        crop windows) computed from the COCO JSON's width and height alone.
        None when the item needs the NumPy path (pre_transforms enabled or
        size metadata missing)."""
        if self.pre is not None:
            return None
        image_id = self.image_ids[idx]
        info = self.coco.imgs[image_id]
        img_w, img_h = info.get("width"), info.get("height")
        if not img_w or not img_h:
            return None
        rng = self._rng(idx)
        boxes_px, crop_windows = self._plan_grid(rng, img_w, img_h)
        boxes_out = np.zeros((self.max_anns, 5), np.float32)
        k = len(boxes_px)
        scale = get_scale((img_w, img_h), self.det_size)
        boxes_out[:k, :4] = boxes_px * scale / self.det_size
        boxes_out[:k, 4] = 1.0
        return {
            "path": os.path.join(self.image_root, self.coco.file_name(image_id)),
            "boxes": boxes_out,
            "crop_windows": crop_windows,
        }

    def __getitem__(self, idx: int) -> dict:
        img, idx = self._read(int(idx))
        rng = self._rng(idx)
        if self.pre is not None:
            for t in self.pre:
                img = t(img, rng)
        img_w, img_h = image_size(img)

        m, n = self.choices[int(rng.integers(0, len(self.choices)))]
        normed = self._grid_boxes(m, n)
        order = rng.permutation(len(normed))[: self.max_anns]
        boxes_px = normed[order] * np.asarray([img_w, img_h, img_w, img_h], np.float32)

        crops = np.zeros((self.max_anns, self.crop_size, self.crop_size, 3), np.float32)
        boxes_out = np.zeros((self.max_anns, 5), np.float32)
        for i, box in enumerate(boxes_px):
            x0, y0, x1, y1 = [float(v) for v in box]
            cx0, cy0, cx1, cy1 = x0, y0, x1, y1
            if self.crop_scale > 1.0:
                bw, bh = x1 - x0, y1 - y0
                cx, cy = (x0 + x1) / 2, (y0 + y1) / 2
                d = 0.5 * self.crop_scale
                cx0, cy0 = max(cx - bw * d, 0), max(cy - bh * d, 0)
                cx1, cy1 = min(cx + bw * d, img_w), min(cy + bh * d, img_h)
            crops[i] = crop_transform(crop(img, (cx0, cy0, cx1, cy1)), self.crop_size)
            boxes_out[i, :4] = (x0, y0, x1, y1)
            boxes_out[i, 4] = 1.0

        images = det_transform(img, self.det_size)
        scale = get_scale((img_w, img_h), self.det_size)
        boxes_out[:, :4] *= scale / self.det_size  # scale then normalize by padded size

        return {"images": images, "boxes": boxes_out, "crops": crops}


class ProposalDistillDataset(_DistillBase):
    """Region-proposal pseudo-boxes with 1.5x-expanded teacher crops
    (reference `ProposalDistillDataset`, `data.py:30-132`)."""

    def __init__(
        self,
        input_filename: str,
        image_root: str,
        det_size: int = 1024,
        crop_size: int = 224,
        max_anns: int = 20,
        min_size: float = 8.0,
        max_size: float = 1024.0,
        seed: int = 0,
    ):
        super().__init__(input_filename, image_root, det_size, crop_size, max_anns, seed)
        self.min_size = min_size
        self.max_size = max_size

    def __getitem__(self, idx: int) -> dict:
        img, idx = self._read(int(idx))
        rng = self._rng(idx)
        img_w, img_h = image_size(img)
        anns = self.coco.img_to_anns.get(self.image_ids[idx], [])

        boxes_out = np.zeros((self.max_anns, 5), np.float32)
        crops = np.zeros((self.max_anns, self.crop_size, self.crop_size, 3), np.float32)
        order = rng.permutation(len(anns))[: self.max_anns]
        num_valid = 0
        for i, ann_i in enumerate(order):
            x, y, w, h = anns[ann_i]["bbox"]
            if w * h < self.min_size**2 or w * h > self.max_size**2:
                continue
            num_valid += 1
            cx, cy = x + w * 0.5, y + h * 0.5
            cx0, cy0 = max(cx - w * 0.75, 0), max(cy - h * 0.75, 0)
            cx1, cy1 = min(cx + w * 0.75, img_w), min(cy + h * 0.75, img_h)
            crops[i] = crop_transform(crop(img, (cx0, cy0, cx1, cy1)), self.crop_size)
            boxes_out[i] = (x, y, x + w, y + h, 1.0)
        if num_valid == 0:
            # top-left-quarter fallback (data.py:122-124)
            boxes_out[0] = (0, 0, img_w / 4, img_h / 4, 1.0)
            crops[0] = crop_transform(crop(img, (0, 0, img_w // 4, img_h // 4)), self.crop_size)

        images = det_transform(img, self.det_size)
        scale = get_scale((img_w, img_h), self.det_size)
        boxes_out[:, :4] *= scale / self.det_size

        return {"images": images, "boxes": boxes_out, "crops": crops}


class RegionCLIPDataset(_DistillBase):
    """Region-noun pseudo-label pairs (reference `COCORegionCLIPDataset`,
    `data.py:390-459`). Its trainer is not ported yet (ROADMAP.md queue 1
    item 6)."""

    def __init__(
        self,
        input_filename: str,
        image_root: str,
        det_size: int = 1024,
        max_anns: int = 20,
        train_ratio: float = 1.0,
        seed: int = 0,
    ):
        super().__init__(input_filename, image_root, det_size, 0, max_anns, seed)
        # only images that have annotations (data.py:397)
        self.image_ids = [i for i in self.coco.image_ids if self.coco.img_to_anns.get(i)]
        if train_ratio < 1.0:
            rng = np.random.default_rng(seed)
            ids = list(self.image_ids)
            rng.shuffle(ids)
            self.image_ids = ids[: int(len(ids) * train_ratio)]
        cat_ids = sorted(self.coco.cats.keys())
        self.cat_id2label = {c: i for i, c in enumerate(cat_ids)}

    def __getitem__(self, idx: int) -> dict:
        img, idx = self._read(int(idx))
        img_w, img_h = image_size(img)
        anns = self.coco.img_to_anns.get(self.image_ids[idx], [])

        boxes_out = np.zeros((self.max_anns, 6), np.float32)
        for i, ann in enumerate(anns[: self.max_anns]):
            x, y, w, h = ann["bbox"]
            boxes_out[i] = (x, y, x + w, y + h, self.cat_id2label[ann["category_id"]], 1.0)

        images = det_transform(img, self.det_size)
        scale = get_scale((img_w, img_h), self.det_size)
        boxes_out[:, :4] *= scale / self.det_size

        return {"images": images, "boxes": boxes_out}


class COCOPanopticEvalDataset:
    """Zero-shot region-classification eval data (reference
    `COCOPanopticDataset`, `data.py:284-387`).

    Things get 1.5x-expanded bbox crops; stuff gets tight mask boxes. Masks
    are downsampled by the patch size with ResizeLongest geometry. A masked
    crop (background = gray 114) is also produced. The segment PNGs are
    read by `image_io.read_png`.
    """

    def __init__(
        self,
        input_filename: str,
        image_root: str,
        segm_root: str,
        embed_path: Optional[str] = None,
        det_size: int = 1024,
        crop_size: int = 224,
        downsample_factor: int = 16,
        min_size: float = 8.0,
        max_size: float = 1024.0,
        max_anns: Optional[int] = None,
    ):
        self.coco = COCOPanopticIndex(input_filename)
        self.image_root = image_root
        self.segm_root = segm_root
        self.det_size = det_size
        self.crop_size = crop_size
        self.downsample_factor = downsample_factor
        self.mask_size = det_size // downsample_factor
        self.min_size = min_size
        self.max_size = max_size
        self.embeddings = np.load(embed_path) if embed_path else None
        self.image_ids = self.coco.image_ids
        if max_anns is None:
            num_annos = [len(a) for a in self.coco.img_to_anns.values()] or [1]
            max_anns = min(max(num_annos), 100)
        self.max_anns = max_anns
        cat_ids = sorted(self.coco.cats.keys())
        self.cat_id2label = {c: i for i, c in enumerate(cat_ids)}

    def __len__(self):
        return len(self.image_ids)

    def set_epoch(self, epoch: int):
        pass

    def __getitem__(self, idx: int) -> dict:
        image_id = self.image_ids[int(idx)]
        info = self.coco.imgs[image_id]
        path = os.path.join(self.image_root, info["file_name"])
        img = open_image(path)
        if img is None:
            # eval must not silently swap items (it would skew mAcc); fail
            # loudly instead of the train datasets' resample-on-failure
            raise RuntimeError(f"unreadable eval image: {path}")
        segm_map = rgb2id(read_png(os.path.join(self.segm_root, info["segm_file"])))
        img_w, img_h = image_size(img)

        M = self.max_anns
        boxes = np.zeros((M, 8), np.float32)
        crops = np.zeros((M, self.crop_size, self.crop_size, 3), np.float32)
        masked_crops = np.zeros((M, self.crop_size, self.crop_size, 3), np.float32)
        gt_masks = np.zeros((M, self.mask_size, self.mask_size), np.float32)

        for i, ann in enumerate(self.coco.img_to_anns.get(image_id, [])[:M]):
            cat = self.coco.cats[ann["category_id"]]
            is_thing = cat.get("isthing", 1)
            if is_thing > 0:
                x, y, w, h = ann["bbox"]
                cx, cy = x + w * 0.5, y + h * 0.5
                x0, y0 = max(cx - w * 0.75, 0), max(cy - h * 0.75, 0)
                x1, y1 = min(cx + w * 0.75, img_w), min(cy + h * 0.75, img_h)
            else:
                tight = mask2box(segm_map == ann["id"])
                if tight is None:
                    continue
                x0, y0, x1, y1 = tight
                x, y, w, h = x0, y0, x1 - x0, y1 - y0
            if w * h < self.min_size**2 or w * h > self.max_size**2:
                continue
            segment = segm_map == ann["id"]
            crops[i] = crop_transform(crop(img, (x0, y0, x1, y1)), self.crop_size)
            masked = img.copy()
            masked[~segment] = MASKED_CROP_FILL
            masked_crops[i] = crop_transform(crop(masked, (x0, y0, x1, y1)), self.crop_size)
            gt_masks[i] = resize_mask_longest(segment.astype(np.float32), self.mask_size)
            boxes[i] = (
                x, y, x + w, y + h,
                self.cat_id2label[ann["category_id"]], 1.0, w * h, is_thing,
            )

        images = det_transform(img, self.det_size)
        scale = get_scale((img_w, img_h), self.det_size)
        boxes[:, :4] *= scale / self.det_size

        return {
            "images": images,
            "boxes": boxes,
            "crops": crops,
            "gt_masks": gt_masks,
            "masked_crops": masked_crops,
        }
