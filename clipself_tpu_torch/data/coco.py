"""Minimal COCO / COCO-Panoptic JSON indexes (a copy of
`clipself_tpu/data/coco.py`).

Self-contained replacements for the pycocotools/panopticapi surface the
reference consumes (`src/training/data.py:13-15`, `coco_api.py:65-113`):
image/annotation/category indexes plus the panoptic conventions
(`segments_info` flattening, `segm_file` derivation, RGB->segment-id
decoding). Pure stdlib + numpy.
"""

from __future__ import annotations

import json
from collections import defaultdict

import numpy as np


class COCOIndex:
    """Index over a COCO instances/proposals-style JSON."""

    def __init__(self, path: str):
        with open(path) as f:
            data = json.load(f)
        self.dataset = data
        self.imgs = {img["id"]: img for img in data.get("images", [])}
        self.anns = {ann["id"]: ann for ann in data.get("annotations", [])}
        self.cats = {cat["id"]: cat for cat in data.get("categories", [])}
        self.img_to_anns = defaultdict(list)
        for ann in data.get("annotations", []):
            self.img_to_anns[ann["image_id"]].append(ann)

    @property
    def image_ids(self) -> list:
        return list(self.imgs.keys())

    def file_name(self, image_id) -> str:
        info = self.imgs[image_id]
        if "file_name" in info:
            return info["file_name"]
        # fall back to the coco_url convention (reference data.py:87-92)
        url = info["coco_url"].split("/")
        return f"{url[-2]}/{url[-1]}"


class COCOPanopticIndex(COCOIndex):
    """Panoptic JSON: annotations carry `segments_info` lists; flatten them to
    per-segment annotation records and derive `segm_file`
    (reference `coco_api.py:65-113`)."""

    def __init__(self, path: str):
        with open(path) as f:
            data = json.load(f)
        self.dataset = data
        self.imgs = {img["id"]: img for img in data.get("images", [])}
        self.cats = {cat["id"]: cat for cat in data.get("categories", [])}
        self.img_to_anns = defaultdict(list)
        self.anns = {}
        for pann in data.get("annotations", []):
            image_id = pann["image_id"]
            segm_file = pann["file_name"]
            self.imgs[image_id]["segm_file"] = segm_file
            for seg in pann["segments_info"]:
                record = dict(seg)
                record["image_id"] = image_id
                record["segm_file"] = segm_file
                self.anns[record["id"]] = record
                self.img_to_anns[image_id].append(record)


def rgb2id(color: np.ndarray) -> np.ndarray:
    """Panoptic PNG RGB -> segment id (id = R + G*256 + B*256^2)."""
    color = color.astype(np.uint32)
    return color[..., 0] + 256 * color[..., 1] + 256 * 256 * color[..., 2]


def mask2box(mask: np.ndarray):
    """Tight bbox (x0, y0, x1, y1) of a binary mask
    (reference `src/training/utils.py:25-30`); None for empty masks."""
    ys, xs = np.where(mask)
    if len(ys) == 0:
        return None
    return float(xs.min()), float(ys.min()), float(xs.max() + 1), float(ys.max() + 1)
