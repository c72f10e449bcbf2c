"""Synthetic-but-real-format detection datasets for recipe-shape drives (the
port's copy of `clipself_tpu/tools/synth_det_data.py`, without PIL).

    python -m clipself_tpu_torch.tools.synth_det_data --dataset coco --root <dir>

Writes a COCO-format (or LVIS-format, with polygon segmentations and the
federated `neg_category_ids` / `not_exhaustive_category_ids` image fields)
annotation JSON plus PNGs: solid colour-keyed shapes on dark noise, one
colour per category, at the reference's training shapes (640 px, the
65 / 1203-class vocabularies), so that `detector/train.py` and
`detector/evaluate.py` can overfit them on the card.

The same arguments draw the same generator calls in the same order as the
JAX tool, so the annotation JSON is EQUAL to its. Rectangles are EQUAL,
pixel for pixel, to PIL's `ImageDraw.rectangle`. An ellipse is drawn as the
32-vertex polygon its annotation carries (`data/draw.py::polygon`, Pillow's
polygon fill), not with PIL's ellipse rasteriser, which is not copied: the
LVIS-format images differ from the JAX tool's at the ellipses' rims. PNGs
are written with filter type 0 (`data/image_io.py::encode_png`).
"""

from __future__ import annotations

import json
import os

import numpy as np

from clipself_tpu_torch.data import draw
from clipself_tpu_torch.data.image_io import encode_png


def _palette(k: int, rng: np.random.Generator) -> np.ndarray:
    """k visually-distinct bright colors (deterministic)."""
    cols = rng.integers(64, 256, size=(k, 3))
    # saturate a (per-color) random channel so every color is bright
    cols[np.arange(k), rng.integers(0, 3, size=k)] = 255
    return cols.astype(np.uint8)


def write_synth_det(
    root: str,
    class_names: list[str],
    gt_class_indices: list[int],
    n_images: int = 8,
    size: int = 640,
    boxes_per_image: int = 3,
    lvis_format: bool = False,
    ellipses: bool = False,
    seed: int = 7,
) -> tuple[str, str]:
    """Write a synthetic detection set; returns (ann_file, image_dir).

    gt_class_indices: contiguous indices into class_names actually drawn
    (use base/frequent classes so the training class-weight vector keeps
    them). Categories are emitted for the FULL vocabulary (ids = index+1)
    so the dataset's name->label map matches the class-embedding order.
    ellipses: draw filled ellipses (as their polygon segmentation) instead
    of rectangles. boxes_per_image: at most 4 (shapes are placed in distinct
    quadrants so nothing occludes).
    """
    if not 1 <= boxes_per_image <= 4:
        raise ValueError(
            f"boxes_per_image must be in [1, 4] (one 2x2 grid cell each, "
            f"no occlusion); got {boxes_per_image}"
        )

    rng = np.random.default_rng(seed)
    colors = _palette(len(gt_class_indices), np.random.default_rng(seed + 1))
    img_dir = os.path.join(root, "imgs")
    os.makedirs(img_dir, exist_ok=True)
    images, anns = [], []
    aid = 1
    for i in range(n_images):
        arr = rng.integers(0, 40, size=(size, size, 3), dtype=np.uint8)
        # non-overlapping cells: split the image into a 2x2 grid, drop boxes
        # into distinct cells so nothing occludes
        cells = [(0, 0), (1, 0), (0, 1), (1, 1)]
        rng.shuffle(cells)
        half = size // 2
        margin = max(half // 16, 2)
        for j in range(boxes_per_image):
            cx, cy = cells[j]
            ci = int(rng.integers(0, len(gt_class_indices)))
            w = int(rng.integers(int(0.25 * half), int(0.7 * half)))
            h = int(rng.integers(int(0.25 * half), int(0.7 * half)))
            x0 = cx * half + int(rng.integers(margin, half - w - margin + 1))
            y0 = cy * half + int(rng.integers(margin, half - h - margin + 1))
            x1, y1 = x0 + w, y0 + h
            if ellipses:
                # polygon approximation of the ellipse (32 vertices)
                t = np.linspace(0, 2 * np.pi, 32, endpoint=False)
                px = (x0 + x1) / 2 + (w / 2) * np.cos(t)
                py = (y0 + y1) / 2 + (h / 2) * np.sin(t)
                mask = draw.polygon(np.zeros((size, size), bool), np.stack([px, py], -1))
                arr[mask] = colors[ci]
                poly = np.stack([px, py], -1).reshape(-1).tolist()
                area = float(np.pi * (w / 2) * (h / 2))
            else:
                draw.rectangle(arr, [x0, y0, x1, y1], colors[ci])
                poly = [x0, y0, x1, y0, x1, y1, x0, y1]
                area = float(w * h)
            ann = {
                "id": aid,
                "image_id": i,
                "category_id": gt_class_indices[ci] + 1,
                "bbox": [x0, y0, w, h],
                "area": area,
                "iscrowd": 0,
                "segmentation": [poly],
            }
            anns.append(ann)
            aid += 1
        fname = f"{i}.png"
        with open(os.path.join(img_dir, fname), "wb") as f:
            f.write(encode_png(arr))
        info = {"id": i, "file_name": fname, "width": size, "height": size}
        if lvis_format:
            info["neg_category_ids"] = []
            info["not_exhaustive_category_ids"] = []
        images.append(info)
    ann_blob = {
        "images": images,
        "annotations": anns,
        "categories": [
            {"id": c + 1, "name": n} for c, n in enumerate(class_names)
        ],
    }
    ann_file = os.path.join(root, "instances.json")
    with open(ann_file, "w") as f:
        json.dump(ann_blob, f)
    return ann_file, img_dir


def gt_classes(dataset: str, n: int) -> list[int]:
    """The ``n`` classes a set draws: every k-th class that training
    weights (base / non-rare); novel classes are zero-weighted in training
    and fuse VLM-dominated at test time, which an overfit with a random
    backbone cannot learn."""
    from clipself_tpu_torch.detector.classes import class_weights

    w = class_weights(dataset, 1.0)[:-1]
    usable = [i for i, wi in enumerate(w) if wi > 0]
    return usable[:: max(len(usable) // n, 1)][:n]


def main(argv=None):
    import argparse

    from clipself_tpu_torch.detector.classes import coco_split, lvis_split

    p = argparse.ArgumentParser("synth-det-data")
    p.add_argument("--dataset", choices=["coco", "lvis"], default="coco")
    p.add_argument("--root", required=True)
    p.add_argument("--n-images", type=int, default=8)
    p.add_argument("--size", type=int, default=640)
    p.add_argument("--boxes-per-image", type=int, default=3)
    p.add_argument("--n-gt-classes", type=int, default=6)
    p.add_argument("--seed", type=int, default=7)
    args = p.parse_args(argv)

    split = coco_split() if args.dataset == "coco" else lvis_split()
    gt = gt_classes(args.dataset, args.n_gt_classes)
    ann, imgs = write_synth_det(
        args.root, split["all"], gt, n_images=args.n_images, size=args.size,
        boxes_per_image=args.boxes_per_image,
        lvis_format=args.dataset == "lvis", ellipses=args.dataset == "lvis",
        seed=args.seed,
    )
    print(json.dumps({"ann_file": ann, "image_dir": imgs, "gt_classes": gt}))
    return ann, imgs


if __name__ == "__main__":
    main()
