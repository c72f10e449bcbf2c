"""Where the device time of the main paths goes, by kernel class.

    python -m clipself_tpu_torch.tools.profile_paths \\
        --model EVA02-CLIP-L-14-336 --det-image-size 896 --eval-batch 1
    python -m clipself_tpu_torch.tools.profile_paths --path detector

``--path clip`` (the default) runs the distill step (batch 2, 20 boxes, every block unlocked, bf16, AdamW,
seeded random weights, one synthetic batch staged on the device; not with
``--eval-only``) and the zero-shot evaluator (13 valid of 100 annotations, bucket 25) of one model
(an EVA02 config, a plain OpenCLIP / OpenAI ViT: `--extract-type v1`
pools its RoI features, and the evaluator's masks, by mask attention, whose
plain attention's device time is reported under its own host range; a
ResNet; a timm tower or an HF trunk, trained with the image tower
unlocked; `--model hf-vit-b16-224` is `chip_smoke.py`'s HF ViT-B/16: the
`hf-vit-tiny-test` adapter with its trunk at ViTConfig's defaults, 224^2
crops, embed 512, float32 trunk: run it with `--det-image-size 224`),
each first without the profiler (host clock around a synchronised window:
ms per step or batch, images/s, peak memory) and then under
`torch.profiler` for ``--steps`` steps or batches, and prints for each a
table of kernel classes: ms per step, share of the kernel time, launches per
step; then the kernel time against the window (the device's idle share,
under the profiler and derived for the unprofiled run). The first line
names the card and its power limit; with ``--json`` the last line is the
tables as one JSON object. `--device cpu` rehearses the control flow at a
small model; it has no device time to report and says so.

``--path detector`` runs the F-ViT detector of ``--preset`` (default
`ov_coco_vitb16`: EVA02-CLIP-B/16 at 640^2) on one synthetic batch of
``--det-batch`` images the same way, twice: `predict` alone on images staged
on the device (backbone taps, heads, both NMS passes; with the preset's mask
head its mask probabilities), and `evaluate_detector` over the same images
as host items (adds the copy to the device, the mask pasting and the NumPy
matching) under the preset's protocol: OV-COCO, or OV-LVIS (`lvis_split()`,
items with gt masks, the LVIS fields and LVIS v1's annotations and classes
an image, `detector/data.py::lvis_ground_truth`) for the LVIS presets, or the
transfer vocabulary; the host's seconds by stage are printed after it.

``--path text`` runs `tools/text_embeddings.py::build_text_embeddings` of
``--model``'s text tower in bf16 over the 65 OV-COCO classes and a
background row (66 calls of 63 prompts, tokenizing included) the same way,
prompts/s in place of images/s.

``--path detector_train`` runs the detector's train step of ``--preset``
(`detector/train.py::make_det_train_step`: frozen trunk taps, the loss, its
backward into the heads, clipping, AdamW at the recipe's settings) on one
synthetic batch of ``--det-batch`` images staged on the device, the same
way. It takes the OV-COCO and OV-LVIS presets; a transfer preset is only
evaluated.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import subprocess
import time
from functools import partial

import torch

from clipself_tpu_torch.core.config import get_model_config
from clipself_tpu_torch.data.loader import SyntheticDistillData
from clipself_tpu_torch.data.synthetic import class_embeddings, synthetic_panoptic_batch
from clipself_tpu_torch.detector.classes import base_novel_mask, class_weights, coco_split, preset_split
from clipself_tpu_torch.detector.config import PRESETS
from clipself_tpu_torch.detector.data import (
    SyntheticDetectionData,
    lvis_ground_truth,
    synthetic_eval_items,
)
from clipself_tpu_torch.detector.evaluate import evaluate_detector, make_predict_fn
from clipself_tpu_torch.detector.fvit import create_detector
from clipself_tpu_torch.detector.train import DetTrainState, build_det_optimizer, make_det_train_step
from clipself_tpu_torch.eval.zero_shot import evaluate_zero_shot
from clipself_tpu_torch.models.clip import dense_stride
from clipself_tpu_torch.models.factory import create_model
from clipself_tpu_torch.train.methods import clipself_loss
from clipself_tpu_torch.train.optim import build_optimizer, make_schedule
from clipself_tpu_torch.tools.text_embeddings import build_text_embeddings, category_prompts
from clipself_tpu_torch.train.step import TrainState, make_train_step

# kernel class: substrings of the kernel's name, first match wins
CLASSES = (
    ("flash_attention_bwd kernel", ("flash_bwd_kernel", "flash_bwd_dkdv_", "flash_bwd_dq_")),
    (
        "flash backward di pass, dQ cast",
        ("flash_bwd_di_kernel", "f32_to_bf16_kernel", "dq_tiles_to_bf16_kernel"),
    ),
    ("flash_attention forward kernel", ("flash_fwd_kernel", "flash_fwd_wgmma_kernel", "flash_fwd_x3_kernel")),
    ("layer_norm forward kernel", ("layer_norm_fwd_kernel",)),
    ("layer_norm backward kernel and its reduce", ("layer_norm_bwd",)),
    ("rope_roll kernel", ("rope_roll_kernel",)),
    ("nms bit-matrix kernel", ("nms_matrix_kernel",)),
    ("nms scan kernel", ("nms_scan_kernel",)),
    ("convolutions (cuDNN)", ("cudnn", "conv2d", "fprop", "dgrad", "implicit_gemm", "nchwToNhwc", "nhwcToNchw",
                              "depthwise")),
    ("GroupNorm", ("GroupNorm", "group_norm", "RowwiseMoments", "ComputeInternalGradients",
                   "BackwardFusedParams", "GammaBeta")),
    ("sorts", ("sort", "Sort", "radix", "Radix")),
    ("gathers and index selections", ("gather", "index", "scatter")),
    ("GEMMs (cuBLAS)", ("nvjet", "gemm", "cutlass", "xmma", "cublas", "gemv")),
    ("AdamW multi-tensor kernels", ("multi_tensor_apply",)),
    ("softmax", ("softmax", "Softmax", "SoftMax")),
    ("GELU and sigmoid", ("gelu", "Gelu", "sigmoid")),
    ("reductions", ("reduce_kernel",)),
    ("dtype casts and copies", ("copy", "Memcpy", "direct_copy", "CatArrayBatchedCopy")),
    ("memsets and fills", ("Memset", "FillFunctor")),
    ("elementwise", ("elementwise", "vectorized")),
)


# host ranges whose device time is reported beside the classes
MASKED_RANGE = "plain masked attention"
RANGES = (MASKED_RANGE,)


def classify(name: str) -> str:
    for label, keys in CLASSES:
        if any(k in name for k in keys):
            return label
    return "other"


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def measure(fn, n: int, device: torch.device, images: int) -> dict:
    """``fn`` run ``n`` times unprofiled, then ``n`` times under the
    profiler; returns the table and the totals."""
    fn()  # warm-up
    _sync(device)
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    _sync(device)
    wall_ms = (time.perf_counter() - t0) * 1e3 / n
    out = {"wall_ms": wall_ms, "images_per_sec": images / wall_ms * 1e3}
    if device.type != "cuda":
        out["device"] = "not measured (no CUDA device)"
        return out
    out["peak_gib"] = torch.cuda.max_memory_allocated(device) / 2 ** 30
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        for _ in range(n):
            fn()
        _sync(device)
        profiled_ms = (time.perf_counter() - t0) * 1e3 / n
    table: dict[str, list] = {}
    other: dict[str, float] = {}
    events = prof.key_averages()
    # a host range (`Optimizer.step#AdamW.step`, ...) is mirrored onto the
    # device's timeline under the same name: it spans kernels, it is not one
    host_names = {ev.key for ev in events if ev.device_type == torch.autograd.DeviceType.CPU}
    for ev in events:
        device_us = getattr(ev, "self_device_time_total", 0) or 0
        if ev.device_type != torch.autograd.DeviceType.CUDA or device_us <= 0:
            continue
        if ev.key in host_names:
            continue
        label = classify(ev.key)
        row = table.setdefault(label, [0.0, 0])
        row[0] += device_us / 1e3 / n
        row[1] += ev.count / n
        if label == "other":
            other[ev.key] = other.get(ev.key, 0.0) + device_us / 1e3 / n
    kernel_ms = sum(r[0] for r in table.values())
    if kernel_ms <= 0:
        raise RuntimeError("the profiler recorded no device time")
    # the device time under each host range of RANGES (its kernels are also
    # in their classes above)
    ranges = {
        ev.key: (getattr(ev, "device_time_total", 0) or 0) / 1e3 / n for ev in events
        if ev.key in RANGES and ev.device_type == torch.autograd.DeviceType.CPU
    }
    out.update(
        ranges=ranges,
        profiled_wall_ms=profiled_ms, kernel_ms=kernel_ms,
        launches=sum(r[1] for r in table.values()),
        idle_share_profiled=1 - kernel_ms / profiled_ms,
        idle_share_derived=1 - kernel_ms / wall_ms,
        classes={
            k: {"ms": v[0], "share": v[0] / kernel_ms, "launches": v[1]}
            for k, v in sorted(table.items(), key=lambda kv: -kv[1][0])
        },
        # the largest kernels that no class names, with their ms
        other=dict(sorted(other.items(), key=lambda kv: -kv[1])[:3]),
    )
    return out


def report(title: str, unit: str, res: dict, items: str = "images") -> None:
    if "classes" not in res:
        print(f"{title}: ran on the CPU ({res['wall_ms']:.3f} ms per {unit} of host time); "
              f"device time {res['device']}", flush=True)
        return
    print(f"{title}: {res['wall_ms']:.3f} ms per {unit} unprofiled, "
          f"{res['images_per_sec']:.3f} {items}/s", flush=True)
    print(
        f"  peak memory {res['peak_gib']:.3f} GiB; under the profiler {res['profiled_wall_ms']:.3f} "
        f"ms per {unit}, kernel time {res['kernel_ms']:.3f} ms, {res['launches']:.0f} kernels per "
        f"{unit}; idle share {res['idle_share_profiled']:.1%} under the profiler, "
        f"{res['idle_share_derived']:.1%} derived for the unprofiled run",
        flush=True,
    )
    print(f"  | kernel class | ms / {unit} | share of kernel time | launches / {unit} |")
    print("  |---|---|---|---|")
    for label, row in res["classes"].items():
        print(f"  | {label} | {row['ms']:.3f} | {row['share']:.1%} | {row['launches']:.0f} |")
    for name, ms in res["other"].items():
        print(f"  other: {ms:.3f} ms {name[:120]}")
    for name, ms in res["ranges"].items():
        print(f"  under the range '{name}': {ms:.3f} ms of device time per {unit} (counted in the classes above)")


def main(argv=None) -> dict:
    p = argparse.ArgumentParser("clipself_tpu_torch path profiler")
    p.add_argument("--path", default="clip", choices=["clip", "detector", "detector_train", "text"])
    p.add_argument("--preset", default="ov_coco_vitb16", choices=sorted(PRESETS))
    p.add_argument("--det-batch", type=int, default=8)
    p.add_argument("--model", default="EVA02-CLIP-B-16")
    p.add_argument("--det-image-size", type=int, default=1024)
    p.add_argument("--batch-size", type=int, default=2)
    p.add_argument("--max-boxes", type=int, default=20)
    p.add_argument("--eval-batch", type=int, default=2)
    p.add_argument("--max-anns", type=int, default=100)
    p.add_argument("--valid-anns", type=int, default=13)
    p.add_argument("--steps", type=int, default=5)
    p.add_argument("--grad-checkpointing", action="store_true")
    p.add_argument("--eval-only", action="store_true",
                   help="--path clip: the evaluator alone, no distill step")
    p.add_argument("--extract-type", default="v2", choices=["v1", "v2"],
                   help="the OpenCLIP ViT's RoI features (and the evaluator's masks at v1)")
    p.add_argument("--device", default="cuda")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--json", action="store_true")
    args = p.parse_args(argv)
    if args.path == "detector_train" and preset_split(args.preset)[0] not in ("coco", "lvis"):
        p.error(f"--path detector_train: {args.preset} is a transfer preset, which is only "
                "evaluated (detectors train on OV-COCO or OV-LVIS)")
    device = torch.device(args.device)
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("--device cuda: no CUDA device is available")
        print(subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, check=True, timeout=60,
        ).stdout.strip().splitlines()[0], flush=True)
    if args.path == "detector":
        out = profile_detector(args, device)
    elif args.path == "detector_train":
        out = profile_detector_train(args, device)
    elif args.path == "text":
        out = profile_text(args, device)
    else:
        out = profile_clip(args, device)
    if args.json:
        print(json.dumps(out), flush=True)
    return out


def profile_text(args, device: torch.device) -> dict:
    model = create_model(args.model, device=device, dtype=torch.bfloat16, seed=args.seed)
    names = coco_split()["all"] + ["background"]
    prompts = sum(len(category_prompts(c)) for c in names)
    res = measure(lambda: build_text_embeddings(model, names), args.steps, device, prompts)
    report(f"{args.model} text embeddings: {len(names)} classes, {prompts} prompts, bf16",
           "class matrix", res, items="prompts")
    return {"model": args.model, "text": res}


@contextlib.contextmanager
def masked_attention_range():
    """Run the OpenCLIP ViT's masked attention calls (mask-attention
    pooling, plain PyTorch) inside the host range `MASKED_RANGE`."""
    from clipself_tpu_torch.models import open_clip_vit

    inner = open_clip_vit.multi_head_attention

    def wrapped(q, k, v, scale, mask=None):
        if mask is None:
            return inner(q, k, v, scale)
        with torch.profiler.record_function(MASKED_RANGE):
            return inner(q, k, v, scale, mask)

    open_clip_vit.multi_head_attention = wrapped
    try:
        yield
    finally:
        open_clip_vit.multi_head_attention = inner


def profile_clip(args, device: torch.device) -> dict:
    with masked_attention_range():
        return _profile_clip(args, device)


# `chip_smoke.py`'s HF ViT-B/16 (`hf_vit_config` there): no registry entry
HF_VIT_B16 = "hf-vit-b16-224"


def model_config(name: str):
    """The registry's config, or `HF_VIT_B16`: `hf-vit-tiny-test` with its
    trunk at ViTConfig's defaults (ViT-B/16: 12 layers of 12 heads, width
    768) at 224^2 and embed 512."""
    if name != HF_VIT_B16:
        return get_model_config(name)
    cfg = get_model_config("hf-vit-tiny-test")
    vision = dataclasses.replace(cfg.vision, image_size=224, hf_trunk_kwargs="{}")
    return dataclasses.replace(cfg, name=HF_VIT_B16, embed_dim=512, vision=vision)


def _profile_clip(args, device: torch.device) -> dict:
    cfg = model_config(args.model)
    v = cfg.vision
    out = {"model": args.model, "image": args.det_image_size}

    model = create_model(cfg, device=device, dtype=torch.bfloat16, seed=args.seed,
                         grad_checkpointing=args.grad_checkpointing)
    if not args.eval_only:  # the distill step
        teacher = create_model(cfg, device=device, dtype=torch.bfloat16, seed=args.seed)
        teacher.requires_grad_(False)
        # every lock group: a ResNet has five (stem, layer1..4), a ViT a block
        # each; a timm tower or an HF trunk trains only unlocked
        # (`--no-lock-image`)
        unlocked = 5 if v.resnet_layers else v.layers
        whole = bool(v.timm_model_name or v.hf_trunk_name)
        optimizer = build_optimizer(
            model, make_schedule("cosine", 1e-5, 1, 1000), wd=0.1,
            unlocked_groups=unlocked, num_layers=v.layers, lock_image=not whole,
        )
        state = TrainState(model, optimizer)
        step_fn = make_train_step(
            partial(clipself_loss, cosine_weight=1.0, extract_type=args.extract_type), teacher
        )
        host = SyntheticDistillData(
            batch_size=args.batch_size, det_size=args.det_image_size, crop_size=v.image_size,
            max_anns=args.max_boxes, seed=args.seed,
        ).batch
        batch = {k: torch.as_tensor(a, device=device) for k, a in host.items()}
        out["train"] = measure(lambda: step_fn(state, batch), args.steps, device, args.batch_size)
        report(
            f"{args.model} distill step, batch {args.batch_size} at {args.det_image_size}px, "
            f"{args.max_boxes} boxes, crops {v.image_size}px, "
            f"{'the image tower' if whole else f'{unlocked} lock groups'} unlocked, bf16, "
            f"extract type {args.extract_type}"
            + (", block recomputation" if args.grad_checkpointing else ""),
            "step", out["train"],
        )
        del state, optimizer, step_fn, teacher, batch
    model.requires_grad_(False)

    # the evaluator
    host = synthetic_panoptic_batch(
        0, batch=args.eval_batch, image_size=args.det_image_size, max_anns=args.max_anns,
        valid_anns=args.valid_anns, crop_size=v.image_size,
        mask_hw=args.det_image_size // dense_stride(v), seed=args.seed,
    )
    ebatch = {k: (a if k == "boxes" else torch.as_tensor(a, device=device)) for k, a in host.items()}
    emb = class_embeddings(133, cfg.embed_dim, seed=args.seed)
    out["eval"] = measure(
        lambda: evaluate_zero_shot(model, [ebatch], emb, device=device, extract_type=args.extract_type),
        args.steps, device, args.eval_batch,
    )
    report(
        f"{args.model} zero-shot evaluator, {args.eval_batch} images a batch at "
        f"{args.det_image_size}px, {args.valid_anns} valid of {args.max_anns} anns, crops "
        f"{v.image_size}px, extract type {args.extract_type}",
        "batch", out["eval"],
    )
    return out


def profile_detector(args, device: torch.device) -> dict:
    cfg = PRESETS[args.preset]
    clip = create_model(cfg.clip_model, device=device, dtype=torch.bfloat16, seed=args.seed)
    det = create_detector(cfg, device=device, seed=args.seed + 1)
    emb = class_embeddings(cfg.num_classes + 1, cfg.embed_dim, seed=args.seed)
    emb /= (emb ** 2).sum(-1, keepdims=True) ** 0.5
    host = SyntheticDetectionData(
        cfg.num_classes, cfg.image_size, cfg.max_gt, seed=args.seed, with_mask=cfg.with_mask
    ).batch(args.det_batch)
    name, split = preset_split(args.preset)
    if name == "lvis":
        host = lvis_ground_truth(host, args.seed)
    items = synthetic_eval_items(
        host, num_classes=cfg.num_classes if name == "lvis" else None, seed=args.seed
    )
    images = torch.as_tensor(host["images"], device=device)
    valid_hw = torch.as_tensor(host["valid_hw"], device=device)
    bm = base_novel_mask(split=split)
    predict = make_predict_fn(
        det, clip, cfg, torch.as_tensor(emb, device=device), torch.as_tensor(bm, device=device)
    )
    what = (f"F-ViT {args.preset} ({cfg.clip_model}), {args.det_batch} images a batch at "
            f"{cfg.image_size}px, {cfg.test_proposals.max_per_img} proposals, "
            f"{cfg.num_classes} classes{', mask head' if cfg.with_mask else ''}, bf16")
    out = {"preset": args.preset, "image": cfg.image_size}
    out["predict"] = measure(lambda: predict(images, valid_hw), args.steps, device, args.det_batch)
    report(f"{what}: predict on staged images", "batch", out["predict"])
    timings = {}
    out["evaluate"] = measure(
        lambda: evaluate_detector(det, clip, items, cfg, emb, device=device, dataset_name=name,
                                  batch_size=args.det_batch, split=split, timings=timings),
        args.steps, device, args.det_batch,
    )
    report(f"{what}: evaluate_detector ({name} protocol) from host items", "batch", out["evaluate"])
    # ``timings`` summed every call of `measure`: its warm-up, the unprofiled
    # and the profiled runs (the last at the profiler's pace)
    calls = 2 * args.steps + 1
    out["host_ms"] = {k: v / calls * 1e3 for k, v in timings.items()}
    print(
        f"{what}: evaluate_detector ms a batch by stage, mean of its {calls} calls: "
        + json.dumps({k: round(v, 3) for k, v in out["host_ms"].items()}),
        flush=True,
    )
    return out


def profile_detector_train(args, device: torch.device) -> dict:
    cfg = PRESETS[args.preset]
    clip = create_model(cfg.clip_model, device=device, dtype=torch.bfloat16, seed=args.seed)
    clip.requires_grad_(False)
    det = create_detector(cfg, device=device, seed=args.seed + 1)
    emb = class_embeddings(cfg.num_classes + 1, cfg.embed_dim, seed=args.seed)
    emb /= (emb ** 2).sum(-1, keepdims=True) ** 0.5
    cw = torch.as_tensor(class_weights(preset_split(args.preset)[0], cfg.bg_weight), device=device)
    host = SyntheticDetectionData(
        cfg.num_classes, cfg.image_size, cfg.max_gt, seed=args.seed, with_mask=cfg.with_mask
    ).batch(args.det_batch)
    batch = {
        k: torch.as_tensor(v, device=device) for k, v in host.items() if k not in ("scale", "image_id")
    }
    state = DetTrainState(det, build_det_optimizer(det))
    step_fn = make_det_train_step(
        clip, cfg, torch.as_tensor(emb, device=device), cw,
        torch.Generator(device=device).manual_seed(args.seed),
    )
    out = {"preset": args.preset, "image": cfg.image_size}
    out["train"] = measure(lambda: step_fn(state, batch), args.steps, device, args.det_batch)
    report(
        f"F-ViT {args.preset} train step ({cfg.clip_model} frozen), {args.det_batch} images at "
        f"{cfg.image_size}px staged on the device, {cfg.rpn_sample.num} anchors and "
        f"{cfg.rcnn_sample.num} rois sampled an image, bf16, AdamW",
        "step", out["train"],
    )
    return out


if __name__ == "__main__":
    main()
