"""Prompt-ensemble text embeddings (ViLD templates): the class matrices of
the zero-shot evaluator (`evaluate_zero_shot(embeddings=)`), the F-ViT
detector (`detector/train.py --class-embed`, K classes and background) and
RegionCLIP's noun embeddings.

A port of `clipself_tpu/tools/text_embeddings.py` (reference
`tools/generate_text_embeddings.py`): for each category, format the ViLD
templates (with the "This is " prefix rule), encode them with the text
tower, L2-normalize each prompt, average, L2-normalize again (+1e-12), and
stack the rows in the order of the categories. The template strings are
ViLD's public prompt set (data, not code).

CLI (float32 weights; seeded random ones unless ``--pretrained`` names a
reference `.pt` checkpoint, loaded by `models/torch_io.py::load_weights`;
``--device`` defaults to `cuda`, and without a CUDA device that is an error):
  python -m clipself_tpu_torch.tools.text_embeddings \\
      --model EVA02-CLIP-B-16 --pretrained ckpt.pt \\
      --classes-json clipself_tpu/detector/metadata/mscoco_65_classes.json \\
      --add-background --out coco_65_bg.npy
"""

from __future__ import annotations

import argparse
import json
import time
from typing import Optional

import numpy as np
import torch

from clipself_tpu_torch.core.config import get_model_config
from clipself_tpu_torch.models.factory import create_model, get_tokenizer
from clipself_tpu_torch.models.torch_io import load_weights

VILD_TEMPLATES = [
    "There is {article} {} in the scene.",
    "There is the {} in the scene.",
    "a photo of {article} {} in the scene.",
    "a photo of the {} in the scene.",
    "a photo of one {} in the scene.",
    "itap of {article} {}.",
    "itap of my {}.",
    "itap of the {}.",
    "a photo of {article} {}.",
    "a photo of my {}.",
    "a photo of the {}.",
    "a photo of one {}.",
    "a photo of many {}.",
    "a good photo of {article} {}.",
    "a good photo of the {}.",
    "a bad photo of {article} {}.",
    "a bad photo of the {}.",
    "a photo of a nice {}.",
    "a photo of the nice {}.",
    "a photo of a cool {}.",
    "a photo of the cool {}.",
    "a photo of a weird {}.",
    "a photo of the weird {}.",
    "a photo of a small {}.",
    "a photo of the small {}.",
    "a photo of a large {}.",
    "a photo of the large {}.",
    "a photo of a clean {}.",
    "a photo of the clean {}.",
    "a photo of a dirty {}.",
    "a photo of the dirty {}.",
    "a bright photo of {article} {}.",
    "a bright photo of the {}.",
    "a dark photo of {article} {}.",
    "a dark photo of the {}.",
    "a photo of a hard to see {}.",
    "a photo of the hard to see {}.",
    "a low resolution photo of {article} {}.",
    "a low resolution photo of the {}.",
    "a cropped photo of {article} {}.",
    "a cropped photo of the {}.",
    "a close-up photo of {article} {}.",
    "a close-up photo of the {}.",
    "a jpeg corrupted photo of {article} {}.",
    "a jpeg corrupted photo of the {}.",
    "a blurry photo of {article} {}.",
    "a blurry photo of the {}.",
    "a pixelated photo of {article} {}.",
    "a pixelated photo of the {}.",
    "a black and white photo of the {}.",
    "a black and white photo of {article} {}.",
    "a plastic {}.",
    "the plastic {}.",
    "a toy {}.",
    "the toy {}.",
    "a plushie {}.",
    "the plushie {}.",
    "a cartoon {}.",
    "the cartoon {}.",
    "an embroidered {}.",
    "the embroidered {}.",
    "a painting of the {}.",
    "a painting of a {}.",
]

SINGLE_TEMPLATE = ["a photo of {article} {}."]


def article(name: str) -> str:
    return "an" if name[0] in "aeiou" else "a"


def processed_name(name: str, rm_dot: bool = False) -> str:
    res = name.replace("_", " ").replace("/", " or ").lower()
    if rm_dot:
        res = res.rstrip(".")
    return res


def category_prompts(category: str, templates=None) -> list[str]:
    templates = templates or VILD_TEMPLATES
    texts = [
        t.format(processed_name(category, rm_dot=True), article=article(category))
        for t in templates
    ]
    return [
        "This is " + t if t.startswith("a") or t.startswith("the") else t for t in texts
    ]


@torch.inference_mode()
def build_text_embeddings(
    model,
    categories: list[str],
    templates=None,
    batch_size: int = 64,
    timings: Optional[dict] = None,
) -> np.ndarray:
    """[num_categories, embed_dim] float32 prompt-ensemble embeddings
    (per-prompt L2 norm -> mean -> L2 norm) of a port `CLIP`, computed on
    the model's device, each category's prompts in batches of at most
    ``batch_size``. All prompts are tokenized first and copied to the
    device at once, so that the host's launches run ahead of the device.
    ``timings``, if given, gains the host seconds spent tokenizing under
    "tokenize"."""
    t0 = time.perf_counter()
    prompts = [category_prompts(cat, templates) for cat in categories]
    tokens = get_tokenizer(model.cfg)([p for ps in prompts for p in ps])
    if timings is not None:
        timings["tokenize"] = timings.get("tokenize", 0.0) + time.perf_counter() - t0
    tokens = torch.as_tensor(tokens, device=model.logit_scale.device)
    rows, start = [], 0
    for ps in prompts:
        emb = torch.cat([
            model.encode_text(tokens[i : min(i + batch_size, start + len(ps))], normalize=True)
            for i in range(start, start + len(ps), batch_size)
        ]).float()
        start += len(ps)
        mean = emb.mean(0)
        rows.append(mean / (torch.linalg.vector_norm(mean) + 1e-12))
    return torch.stack(rows).cpu().numpy()


def main(argv=None) -> np.ndarray:
    from clipself_tpu_torch.train.main import _device

    parser = argparse.ArgumentParser()
    parser.add_argument("--model", default="EVA02-CLIP-B-16")
    parser.add_argument("--pretrained", default=None, help="reference-layout .pt checkpoint")
    parser.add_argument("--ann", default=None, help="COCO-style JSON with categories")
    parser.add_argument(
        "--classes-json", default=None,
        help="plain JSON list of class names (e.g. detector metadata lists)",
    )
    parser.add_argument(
        "--add-background", action="store_true",
        help="append a 'background' embedding row (detector class matrices, "
        "reference F-ViT/tools/dump_coco_openclip_feature.py:20-22)",
    )
    parser.add_argument("--out", required=True, help="output .npy path")
    parser.add_argument("--device", default="cuda", help="torch device, e.g. cuda, cuda:1, cpu")
    args = parser.parse_args(argv)

    if args.classes_json:
        with open(args.classes_json) as f:
            cats = json.load(f)
    elif args.ann:
        with open(args.ann) as f:
            data = json.load(f)
        cats = [c["name"] for c in sorted(data["categories"], key=lambda c: c["id"])]
    else:
        parser.error("one of --ann / --classes-json is required")
    if args.add_background:
        cats = list(cats) + ["background"]
    device = _device(args.device)
    model = create_model(get_model_config(args.model), device=device, dtype=torch.float32)
    if args.pretrained:
        load_weights(model, args.pretrained)
    emb = build_text_embeddings(model, cats)
    np.save(args.out, emb)
    print(f"saved {emb.shape} embeddings to {args.out}")
    return emb


if __name__ == "__main__":
    main()
