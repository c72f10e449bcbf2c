"""Open-vocabulary class-split registry: a NumPy copy of
`clipself_tpu/detector/classes.py`, pinned equal to the original by
`tests/test_torch_detector_eval.py`.

Reads the JAX package's vendored public dataset metadata by path
(`clipself_tpu/detector/metadata/*.json`, mirroring `F-ViT/datasets/*.json`): OV-COCO 48 seen / 17 unseen of 65, and
OV-LVIS 866 seen / 337 rare-unseen of 1203 with per-class image frequencies
(`F-ViT/models/custom_losses.py:11-19,98-111`).
"""

from __future__ import annotations

import json
from pathlib import Path

import numpy as np

_META = Path(__file__).resolve().parents[2] / "clipself_tpu" / "detector" / "metadata"


def _load(name: str):
    with open(_META / f"{name}.json") as f:
        return json.load(f)


def coco_split() -> dict:
    all_names = _load("mscoco_65_classes")
    seen = _load("mscoco_seen_classes")
    unseen = _load("mscoco_unseen_classes")
    return {"all": all_names, "seen": seen, "unseen": unseen}


def lvis_split() -> dict:
    all_names = _load("lvis_v1_all_classes")
    seen = _load("lvis_v1_seen_classes")
    unseen = _load("lvis_v1_unseen_classes")
    info = sorted(_load("lvis_v1_train_cat_norare_info"), key=lambda c: c["id"])
    groups = {"rare": [], "common": [], "frequent": []}
    key = {"r": "rare", "c": "common", "f": "frequent"}
    for c in info:
        groups[key[c["frequency"]]].append(c["name"])
    return {"all": all_names, "seen": seen, "unseen": unseen, "freq_groups": groups, "cat_info": info}


def transfer_split(dataset: str) -> dict:
    """Class lists for transfer evaluation (reference `configs/transfer/*`:
    a trained detector is evaluated on another vocabulary with EVERY class
    fused by the base exponent alpha — `FViTBBoxHead` transfer variant,
    `fvit_head.py:284-347`). All classes are treated as 'seen'."""
    names = {
        "voc": _load("voc_classes"),
        "objects365": _load("objects365v1_fix_classes"),
        "coco": _load("mscoco_all_classes"),
    }[dataset]
    return {"all": names, "seen": list(names), "unseen": []}


def preset_split(preset: str) -> tuple[str, dict]:
    """(dataset name, class split) of a detector preset, as the JAX
    package's `fvit-test` infers them: a transfer preset's vocabulary,
    OV-LVIS for the LVIS presets, OV-COCO otherwise."""
    if preset.startswith("transfer_"):
        name = preset.split("_")[1]
        return name, transfer_split(name)
    if "lvis" in preset:
        return "lvis", lvis_split()
    return "coco", coco_split()


def class_weights(dataset: str, bg_weight: float) -> np.ndarray:
    """Training CE class-weight vector [K+1] (background last).

    COCO: 1.0 for seen, 0.0 for unseen (reference ov_coco config lines 3-8).
    LVIS: 1.0 where the no-rare training set has any image of the class, else
    0.0 (reference `CustomCrossEntropyLoss.__init__`,
    `custom_losses.py:108-111` with freq (count>0)).
    """
    if dataset == "coco":
        sp = coco_split()
        seen = set(sp["seen"])
        w = [1.0 if n in seen else 0.0 for n in sp["all"]]
    elif dataset == "lvis":
        sp = lvis_split()
        counts = {c["name"]: c["image_count"] for c in sp["cat_info"]}
        w = [1.0 if counts.get(n, 0) > 0 else 0.0 for n in sp["all"]]
    else:
        raise ValueError(dataset)
    return np.asarray(w + [bg_weight], np.float32)


def base_novel_mask(dataset: str = None, split: dict = None) -> np.ndarray:
    """[K+1] bool — True for base (seen) classes and background (reference
    `FViTBBoxHead.__init__`, `fvit_head.py:38-44`: background is appended to
    the seen list). Pass `split` directly for transfer vocabularies (where
    seen == all, so the mask is all-True)."""
    sp = split if split is not None else (
        coco_split() if dataset == "coco" else lvis_split()
    )
    seen = set(sp["seen"])
    return np.asarray([n in seen for n in sp["all"]] + [True])
